"""PyTorch port: ``models.sim.make_world`` (the structured point-cloud
world: ground, perimeter walls, box faces) against the JAX package's, bit
for bit, for two seeds and sizes."""
import numpy as np
import pytest

from ptudes_tpu.models import sim as jsim
from ptudes_tpu_torch.models import sim


@pytest.mark.parametrize("seed,n,extent", [(0, 60000, 40.0),
                                           (7, 9001, 25.0)])
def test_make_world_matches_jax(seed, n, extent):
    """The same draws in the same order: the arrays are equal bit for bit
    (float32, [n, 3]); the world has points on the ground, on the walls
    and above both."""
    got = sim.make_world(seed, n=n, extent=extent)
    want = jsim.make_world(seed, n=n, extent=extent)
    assert got.dtype == want.dtype == np.float32
    assert got.shape == (n, 3)
    np.testing.assert_array_equal(got, want)
    assert (np.abs(got[:, 2]) < 0.1).sum() > n // 4
    assert (np.abs(got[:, :2]).max(1) > extent - 0.1).sum() > n // 2
