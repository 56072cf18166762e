"""PyTorch port: the kernel wrappers' launch counters and the build's
refusal to fall back.

Each wrapper sends CPU tensors to its plain twin (same result, counter
left at 0) and launches only for CUDA tensors; a missing ``nvcc`` makes the
build raise instead of quietly using the twins.
"""
import dataclasses

import numpy as np
import pytest
import torch

from ptudes_tpu_torch import config, kernels
from ptudes_tpu_torch.geom import se3
from ptudes_tpu_torch.models import esekf
from ptudes_tpu_torch.ops import (cuda_ekf, cuda_gather, cuda_gn, cuda_icp,
                                  cuda_voxel, hashmap, icp, voxel)

torch.set_num_threads(2)


def _ekf_inputs():
    rng = np.random.default_rng(0)
    cfg = config.bench_config().ekf
    s = esekf.init_state(cfg, "cpu")
    k = 12
    imus = esekf.Imu(
        torch.tensor(rng.normal(0, 1, (k, 3)) + [0, 0, 9.78],
                     dtype=torch.float32),
        torch.tensor(rng.normal(0, 0.3, (k, 3)), dtype=torch.float32),
        torch.arange(1, k + 1, dtype=torch.float32) * 0.01)
    return cfg, s, imus, torch.arange(k) < 10


def _same(a, b):
    for x, y in zip(a, b):
        if isinstance(x, tuple):
            _same(x, y)
        else:
            assert torch.equal(x, y)


def _icp_inputs():
    rng = np.random.default_rng(1)
    pts = torch.tensor(rng.uniform(-5, 5, (4000, 3)) * [1, 1, 0.02],
                       dtype=torch.float32)
    m = hashmap.insert_deduped(
        hashmap.create(1 << 12, 8, "cpu"), pts,
        torch.ones(len(pts), dtype=torch.bool), voxel_size=0.3,
        new_capacity=len(pts))
    src = pts[:256] + 0.01
    mask = torch.ones(256, dtype=torch.bool)
    cand = icp.gather_candidates(m, src, voxel_size=0.3, neighborhood=7,
                                 n_voxels=4, fit_planes=False)
    return src, mask, cand, m


def test_wrappers_take_the_twin_on_cpu_and_count_nothing():
    kernels.reset_launches()
    cfg, s, imus, valid = _ekf_inputs()
    twin = dataclasses.replace(cfg, predict_batch="unroll")
    _same(cuda_ekf.predict_block(s, imus, valid, cfg=cfg, want_twist=True),
          esekf.process_imu_batch(s, imus, valid, cfg=twin, want_twist=True))
    s1 = esekf.process_imu_batch(s, imus, valid, cfg=twin)
    pose = se3.exp_twist(torch.tensor([0.01, 0.0, 0.02, 0.1, 0.0, 0.0]))
    mc = esekf.default_meas_cov(cfg, "cpu")
    _same(cuda_ekf.update_pose(s1, pose, mc),
          esekf.process_pose(s1, pose, cfg=dataclasses.replace(
              cfg, update_form="xla"), meas_cov=mc))

    src, mask, cand, m = _icp_inputs()
    prepped = cuda_gn.prep_with_plane(cand, mask, src, 0.6)
    _same(prepped, cuda_gn.prep_with_plane_torch(cand, mask, src, 0.6))
    args = (src, prepped, torch.eye(4), torch.tensor(0.1),
            torch.tensor(0.25), 1e-4)
    kw = dict(plane_min_quality=0.2, max_iterations=5, prior_rot_weight=0.01,
              prior_trans_weight=0.01)
    _same(cuda_icp.icp_loop(*args, **kw), cuda_icp.icp_loop_torch(*args, **kw))
    gn_args = (torch.eye(4), src, cuda_gn.prep_candidates(cand, mask),
               torch.tensor(0.1), torch.tensor(0.25))
    _same(cuda_gn.gn_prepped(*gn_args, plane_min_quality=0.2),
          cuda_gn.gn_prepped_torch(*gn_args, plane_min_quality=0.2))
    g_kw = dict(voxel_size=0.3, max_probes=1, neighborhood=7, n_voxels=4,
                plane_radius=0.6)
    _same(cuda_gather.gather_prep_fused(m, src, mask, torch.eye(4), **g_kw),
          cuda_gather.gather_prep_fused_torch(m, src, mask, torch.eye(4),
                                              **g_kw))
    ptq = torch.cat([src.T, torch.zeros(5, 256)])
    _same([cuda_gn.plane_moments(ptq, *prepped[1:], 0.36)],
          [cuda_gn.plane_moments_torch(ptq, *prepped[1:], 0.36)])
    grid_mask = torch.arange(256) % 7 != 0
    _same([cuda_voxel.grid_prededup(src, grid_mask, 0.15, (8, 32))],
          [voxel.window_prededup_mask(src, grid_mask, 0.15, (8, 32))])
    _same([cuda_voxel.voxel_key(src, grid_mask, 0.45)],
          [voxel.sort_key(src, grid_mask, 0.45)])
    assert kernels.LAUNCHES == {name: 0 for name in kernels.KERNELS}


def test_other_devices_raise():
    cfg, s, imus, valid = _ekf_inputs()
    meta = esekf.EkfState(*[x.to("meta") for x in s])
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_ekf.predict_block(meta, imus, valid, cfg=cfg)
    with pytest.raises(ValueError, match="unsupported device"):
        src, mask, cand, _ = _icp_inputs()
        cuda_gn.gn_prepped(torch.eye(4), src.to("meta"),
                           cuda_gn.prep_candidates(cand, mask),
                           torch.tensor(0.1), torch.tensor(0.25),
                           plane_min_quality=0.2)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.ptr(torch.zeros(3), "x")
    with pytest.raises(ValueError, match="int32 CUDA tensor"):
        kernels.ptr(torch.zeros(3, dtype=torch.int32), "x", torch.int32)
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_gn.plane_moments(*[torch.zeros(8, 4, device="meta")] * 5, 0.36)


def test_missing_nvcc_raises_instead_of_falling_back(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path / "no-bin"))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(kernels, "NVCC_DEFAULT", str(tmp_path / "nvcc"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.find_nvcc()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.build(build_dir=str(tmp_path / "build"))
    assert not (tmp_path / "build").exists() or not any(
        (tmp_path / "build").rglob("*.so"))
    monkeypatch.setattr(kernels, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(kernels, "_lib", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.lib()
    assert kernels.LAUNCHES == {name: 0 for name in kernels.KERNELS}


def test_build_is_keyed_by_the_sources():
    h = kernels.source_hash()
    assert len(h) == 16 and h == kernels.source_hash()
    names = {p.rsplit("/", 1)[-1] for p in kernels.sources()}
    assert {"ekf_predict.cu", "ekf_update.cu", "gn_prep.cu",
            "icp_loop.cu", "gn_iter.cu", "gather_fused.cu",
            "plane_moments.cu", "voxel_grid.cu", "common.cuh"} <= names
    assert set(kernels.KERNELS) == set(kernels.LAUNCHES)
    assert {f"ptudes_{name}" for name in kernels.KERNELS} \
        == set(kernels._SIGNATURES)
