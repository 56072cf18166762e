"""Where the device time of K1 (``csrc/ekf_predict.cu``) goes, on one CUDA
card: the kernel rebuilt with stages taken out, timed with
``torch.profiler`` at K = 0, 12, 16 and 64 IMU samples (all valid).

    python3 tools/exp_ekf_stages.py

Each variant is the committed source built by ``nvcc`` into a temporary
directory with ``-DPTUDES_SKIP=<mask>`` (``csrc/common.cuh:ptudes::Stage``):
as committed; without the covariance products (the lane sums, the stores
and the barriers stay); without the covariance steps. Prints each
variant's mean device us per launch over 50 launches, then a step's cost
from K = 16 to 64 split into the products, the rest of the covariance
step and the nav (warp 0's chains, which the covariance waits for).
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from exp_gn_stages import device_us  # noqa: E402

# the bits of csrc/common.cuh:ptudes::Stage
COV_MATH, COV_STEPS = 64, 128
VARIANTS = {"as committed": 0, "no covariance products": COV_MATH,
            "no covariance steps": COV_STEPS}
STEPS = (0, 12, 16, 64)


def build_all(out_dir: str) -> dict:
    """Every variant as its own library, compiled in parallel."""
    from ptudes_tpu_torch import kernels

    nvcc = kernels.find_nvcc()
    src = os.path.join(ROOT, "ptudes_tpu_torch", "csrc", "ekf_predict.cu")
    jobs = {}
    for v, mask in VARIANTS.items():
        lib = os.path.join(out_dir, f"ekf_predict_{mask}.so")
        jobs[v] = (lib, subprocess.Popen(
            [nvcc, *kernels.NVCC_FLAGS[:6], f"-DPTUDES_SKIP={mask}",
             "-shared", "-o", lib, src], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    fns = {}
    for v, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on ekf_predict ({v}):\n"
                             f"{log[-3000:]}")
        fn = ctypes.CDLL(lib).ptudes_ekf_predict
        fn.argtypes = kernels._SIGNATURES["ptudes_ekf_predict"]
        fn.restype = ctypes.c_int
        fns[v] = fn
    return fns


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("exp_ekf_stages: no CUDA device")
    import chip_smoke as cs
    from ptudes_tpu_torch import config
    from ptudes_tpu_torch.ops import cuda_ekf

    dev = torch.device("cuda", 0)
    print(cs.card_line(), flush=True)
    cfg = config.bench_config().ekf
    rng = np.random.default_rng(0)
    s = cs.generic_ekf_state(cfg, dev, rng)
    scal = cuda_ekf.predict_scal(s)
    cov = s.cov.float().contiguous()
    out = torch.empty(32, device=dev)
    cov_out = torch.empty((18, 18), device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    us = {}
    with tempfile.TemporaryDirectory() as tmp:
        fns = build_all(tmp)
        for k in STEPS:
            imu = torch.tensor(np.concatenate([
                rng.normal(0, 1, (k, 3)) + [0, 0, 9.78],
                rng.normal(0, 0.3, (k, 3)),
                0.2 + np.arange(1, k + 1)[:, None] * 0.01,
                np.ones((k, 1))], 1), dtype=torch.float32,
                device=dev).contiguous()
            for v, fn in fns.items():
                def k1(fn=fn, imu=imu, k=k):
                    if fn(scal.data_ptr(), imu.data_ptr(), cov.data_ptr(),
                          out.data_ptr(), cov_out.data_ptr(), None, k,
                          cfg.acc_bias_std, cfg.gyr_bias_std, cfg.acc_vrw,
                          cfg.gyr_arw, 1, stream) != 0:
                        raise SystemExit("ekf_predict launch failed")
                us[(v, k)] = device_us(k1)
                print(f"K1 K={k} {v}: {us[(v, k)]:.2f} us", flush=True)

    def per_step(v):
        return (us[(v, 64)] - us[(v, 16)]) / 48

    whole, no_math, no_cov = (per_step(v) for v in VARIANTS)
    print(f"K1 a step (K = 16 to 64): {whole:.3f} us = products "
          f"{whole - no_math:.3f} + the rest of the covariance step "
          f"{no_math - no_cov:.3f} + the nav {no_cov:.3f}", flush=True)


if __name__ == "__main__":
    main()
