"""The plain reference of the benchmark's check: scans run op by op through
``plainlio``, a frozen copy of the port's plain PyTorch path (its twins of
the kernels, the eager loops, no CUDA graph), which imports nothing of the
program, of JAX or of the JAX package.

:func:`run` takes what the benchmark made (the configuration file's
pipeline, the sensor LUT, a recording's range images and IMU samples) and
either starts from a fresh state of its own or from a state handed to it as
the JAX package's ``LioState`` leaves (the layout the program's checkpoints
share with the JAX package), and returns each scan's outputs as numpy.
With ``tf32`` the same run takes TF32 matrix products: the check's control.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from .plainlio import config as pconfig
from .plainlio.models import esekf, kiss, lio
from .plainlio.ops import hashmap
from .plainlio.ops.projection import XyzLut

# the JAX flatten order of LioState, the dtypes of its leaves
LEAF_DTYPES = (torch.int32, torch.int32, torch.float32, torch.float32,
               torch.float32, torch.int32, torch.int32, torch.float32,
               torch.float32, torch.float32, torch.float32, torch.float32,
               torch.float32, torch.float32, torch.float32, torch.bool)

FIELDS = ("kiss_pose", "ekf_pose", "ekf_vel", "ekf_bias_gyr",
          "ekf_bias_acc", "ekf_grav", "ekf_cov_diag")
AUX = ("map_points", "num_corr", "iterations", "source_count")


def pipeline_config(d: dict) -> pconfig.PipelineConfig:
    """A configuration file's ``pipeline`` as the reference's configuration,
    every kernel form replaced by its plain twin."""
    top = {k: v for k, v in d.items() if k not in ("kiss", "cap", "ekf")}
    cfg = pconfig.PipelineConfig(
        kiss=pconfig.KissConfig(**d["kiss"]),
        cap=pconfig.Capacity(**d["cap"]), ekf=pconfig.EkfConfig(**d["ekf"]),
        **top)
    return pconfig.twin_config(cfg)


def state_from_leaves(leaves, device) -> lio.LioState:
    """A state from the 16 leaves of the JAX package's ``LioState``
    (copies)."""
    if len(leaves) != len(LEAF_DTYPES):
        raise ValueError(f"{len(leaves)} leaves, a LioState has "
                         f"{len(LEAF_DTYPES)}")
    t = [torch.as_tensor(x).to(device=device, dtype=dt, copy=True)
         for x, dt in zip(leaves, LEAF_DTYPES)]
    return lio.LioState(
        kiss=kiss.KissState(hashmap.VoxelHashMap(t[0], t[1]), *t[2:7]),
        ekf=esekf.EkfState(*t[7:]))


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """TF32 products inside (the control), float32 otherwise."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.set_float32_matmul_precision("high" if tf32 else "highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


def run(pipeline: dict, lut, scans, scan_ts, imu_lacc, imu_avel, imu_ts, *,
        prev_scan_ts=None, time_origin=None, start=None, boot: int = 0,
        device="cpu", tf32: bool = False) -> dict[str, np.ndarray]:
    """The reference's outputs of ``scans`` [S, H, W] (stamped ``scan_ts``)
    with the IMU samples in each scan's window, as the program's batcher
    windows them (``prev_scan_ts``, ``time_origin``): the first ``boot``
    scans insert the whole frame, the rest take the configuration's steady
    insert. ``start``: the leaves of the state before the first scan, or
    None for a fresh state. Returns each field of :data:`FIELDS` and
    :data:`AUX` stacked over the scans, as float64 numpy."""
    cfg = pipeline_config(pipeline)
    dev = torch.device(device)
    lut_t = XyzLut(*(torch.as_tensor(np.asarray(x, np.float32), device=dev)
                     for x in lut))
    with torch.no_grad(), matmul_precision(tf32):
        state = (lio.init_state(cfg, dev) if start is None
                 else state_from_leaves(start, dev))
        batches = lio.build_batches(
            cfg, scans, scan_ts, imu_lacc, imu_avel, imu_ts,
            time_origin=time_origin, prev_scan_ts=prev_scan_ts, device=dev)
        boot_step = lio.make_scan_step(lut_t, cfg, insert_overflow=True)
        steady_step = lio.make_scan_step(
            lut_t, cfg, insert_overflow=cfg.steady_insert_mode)
        rows = []
        for i in range(len(scan_ts)):
            step = boot_step if i < boot else steady_step
            state, row = step(state, lio.scan_at(batches, i))
            rows.append(row)
        out = lio.unpack_out(torch.stack(rows))
    res = {f: getattr(out, f).double().cpu().numpy() for f in FIELDS}
    res.update({f: getattr(out.aux, f).double().cpu().numpy() for f in AUX})
    return res

