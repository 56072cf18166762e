"""PyTorch port: the batched driver with the other guesses and KISS's
deskew (``parallel.batched`` at tests/test_batched.py's configuration,
the candidate-refresh loop and the ``"assoc"`` predict): ``guess="kiss"``
(the constant-velocity guess), ``guess="gt"`` (the bags' ground-truth
poses as ``guess_pose``) and ``deskew_mode="kiss"`` (the constant-velocity
deskew), each on that file's two bags (32 x 256, 8 scans) within 1e-4 m
of the port's own ``run_sequence`` per bag with ``map_points`` equal at
every scan, and within 0.02 m of JAX's ``run_sequence_batched``.
"""
import pytest
import torch

from ptudes_tpu_torch.parallel import batched
from test_torch_batched_refresh import (check_against,
                                        port_default_config, run_both)

torch.set_num_threads(2)


@pytest.mark.parametrize("kw", [dict(guess="kiss"), dict(guess="gt"),
                                dict(deskew_mode="kiss")],
                         ids=["guess-kiss", "guess-gt", "deskew-kiss"])
def test_batched_guess_and_deskew_forms(kw):
    """One configuration of the driver beside JAX's: the port's batched
    run against its single runs (1e-4 m, ``map_points`` and iteration
    counts equal) and against JAX's batched run (0.02 m)."""
    batched.check_config(port_default_config(**kw))
    out, singles, jposes, counts = run_both(kw, kw,
                                            gt=kw.get("guess") == "gt")
    check_against(out, singles, jposes, counts,
                  ", ".join(f"{k}={v}" for k, v in kw.items()))
