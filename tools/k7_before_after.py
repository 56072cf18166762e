"""K7 (``csrc/plane_moments.cu``) against another body of the same kernel,
on one CUDA card.

    mkdir -p _archive/k7 && git archive <rev> ptudes_tpu_torch/csrc \
        | tar -x -C _archive/k7
    python tools/k7_before_after.py \
        _archive/k7/ptudes_tpu_torch/csrc/plane_moments.cu

The given source is built with the port's ``nvcc`` flags into a library of
its own, with the headers beside it (the same revision's). At ``chip_smoke.py`` phase 3's shapes
(the bench scene, N = 2048, C = 32; the CLI scene, N = 8192, C = 80) both
bodies are held to the plain twin (count row exact, rows 1-9 within 1e-5
of each row's largest magnitude) and timed on the device with
``chip_smoke.kernel_us`` in the order other, current, current, other.
Prints one JSON line: each kernel's device us a launch beside the bound,
with the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from ptudes_tpu_torch import kernels  # noqa: E402
from ptudes_tpu_torch.ops import cuda_gn  # noqa: E402

REPS = 100


def build_other(src: str, out_dir: str):
    """``src`` built into a library of its own; its K7 entry point."""
    lib = os.path.join(out_dir, "libk7_other.so")
    subprocess.run([kernels.find_nvcc(), *kernels.NVCC_FLAGS, "-shared",
                    "-o", lib, src], check=True, capture_output=True,
                   timeout=kernels.NVCC_TIMEOUT_S)
    fn = ctypes.CDLL(lib).ptudes_plane_moments
    fn.argtypes = kernels._SIGNATURES["ptudes_plane_moments"]
    fn.restype = ctypes.c_int
    return fn


def launcher(fn):
    """The other body with the current wrapper's contract."""
    def call(ptq, cx, cy, cz, inf, r2):
        c, n = cx.shape
        out = torch.empty((cuda_gn.MOMENT_ROWS, n), device=ptq.device)
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*(x.data_ptr() for x in (ptq, cx, cy, cz, inf, out)), n, c,
                 float(np.float32(r2)), stream)
        if err:
            raise RuntimeError(f"the other K7 failed to launch: {err}")
        return out
    return call


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    kernels.lib()
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        other = launcher(build_other(sys.argv[1], tmp))
        for name, args in cs.plane_moments_inputs(dev):
            op = cuda_gn.plane_moments_torch(*args)
            forms = {"other": lambda a=args: other(*a),
                     "current": lambda a=args: cuda_gn.plane_moments(*a)}
            row = {}
            for form, fn in forms.items():
                rel = cs.plane_moments_error(fn(), op, f"{form} {name}")
                cs.check(rel <= 1e-5, f"{form} {name}: rows 1-9 rel {rel}")
                row[f"{form}_rel"] = rel
            for form in ("other", "current", "current", "other"):
                row.setdefault(f"{form}_us", []).append(
                    cs.kernel_us(forms[form], "plane_moments", REPS))
            ptq, cx, cy, cz, inf, _ = args
            n, c = ptq.shape[1], cx.shape[0]
            row["bound_us"] = cs.bound(cs.nbytes(
                ptq[:3], cx, cy, cz, inf, op), 20 * n * c)["bound_ms"] * 1e3
            row.update(n=n, c=c)
            res[name] = row
    print(json.dumps(dict(k7_before_after=res, card=cs.card_line())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
