"""PyTorch port: the launch plans of K4 (``cuda_icp.loop_plan``) and K5
(``cuda_gn.gn_plan``), pure functions of the shapes that the wrappers
launch with. The kernels themselves run only on the card
(``chip_smoke.py`` phase 3)."""
import pytest

from ptudes_tpu_torch.ops import cuda_gn, cuda_icp


@pytest.mark.parametrize("n, c, staged", [
    (2048, 32, True),    # the bench path (bench_config)
    (8192, 80, False),   # the CLI shapes (cli_config)
    (2048, 48, True),
    (4096, 32, False),
    (1024, 80, True),
])
def test_loop_plan_stages_what_fits(n, c, staged):
    plan = cuda_icp.loop_plan(n, c)
    assert plan.staged is staged
    assert plan.cluster >= 8
    if staged:
        assert plan.smem_bytes == (4 * c + 11) * plan.points_per_cta * 4
        assert plan.smem_bytes + cuda_icp.STATIC_SMEM <= 232448
    else:
        assert plan.smem_bytes == 0
        assert (4 * c + 11) * plan.points_per_cta * 4 > 232448 - 8192


def test_loop_plan_bench_shapes():
    plan = cuda_icp.loop_plan(2048, 32)
    assert (plan.cluster, plan.points_per_cta) == (8, 256)
    assert plan.smem_bytes == 142336  # 128 KB candidates, 8 KB feat, 3 KB src


@pytest.mark.parametrize("n", [1, 5, 2048, 2050, 2051, 8191, 8192])
@pytest.mark.parametrize("c", [32, 80])
def test_loop_plan_ranges_cover_the_points(n, c):
    plan = cuda_icp.loop_plan(n, c)
    assert plan.points_per_cta % 4 == 0
    ranges = plan.ranges(n)
    assert len(ranges) == plan.cluster
    pos = 0
    for start, count in ranges:
        assert 0 <= count <= plan.points_per_cta
        if count:
            assert start == pos
        pos += count
    assert pos == n


def test_loop_plan_rejects_unsupported_shapes():
    for kw in (dict(n=0, c=32), dict(n=2048, c=0), dict(n=-1, c=-1)):
        with pytest.raises(ValueError, match="loop_plan"):
            cuda_icp.loop_plan(**kw)


@pytest.mark.parametrize("c", [1, 7, 32, 80])
def test_gn_row_groups_are_contiguous_and_cover(c):
    ranges = cuda_gn.gn_plan(8192, c).row_ranges
    assert len(ranges) == cuda_gn.GN_GROUPS
    assert ranges[0][0] == 0 and ranges[-1][1] == c
    for (a0, a1), (b0, b1) in zip(ranges, ranges[1:]):
        assert a0 <= a1 == b0 <= b1
    assert sum(k1 - k0 for k0, k1 in ranges) == c


@pytest.mark.parametrize("n", [1, 31, 32, 33, 2048, 8192, 8193])
def test_gn_grid_covers_the_points(n):
    plan = cuda_gn.gn_plan(n, 80)
    assert cuda_gn.GN_THREADS == cuda_gn.GN_TILE * cuda_gn.GN_GROUPS == 256
    assert plan.blocks * cuda_gn.GN_TILE >= n
    assert (plan.blocks - 1) * cuda_gn.GN_TILE < n
