"""K1's device time with and without the filter history, for comparing
two checkouts on one card.

    python3 tools/exp_k1_history.py [--root DIR] [--tag NAME]

Imports ``ptudes_tpu_torch`` and ``chip_smoke`` from ``DIR`` (default: this
checkout; give another checkout, e.g. an older commit unpacked with ``git
archive``, to time its K1), builds its kernels there, and times K1 alone
with ``chip_smoke.kernel_us`` (``torch.profiler``'s device records) at
K = 0, 12 and 16 on ``chip_smoke.generic_ekf_state``, with two invalid
samples at the end of the block: without the history and, where the
wrapper takes ``log``, with it. Prints one JSON line with the card's name
and power limit. Run the checkouts in turns in one call (A, B, B, A):
times differ between cards.
"""
from __future__ import annotations

import argparse
import inspect
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=ROOT,
                    help="checkout whose K1 to time (default: this one)")
    ap.add_argument("--tag", default="", help="label for the JSON line")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        sys.exit("exp_k1_history: no CUDA device")
    import chip_smoke as cs
    from ptudes_tpu_torch import config, kernels
    from ptudes_tpu_torch.models import esekf
    from ptudes_tpu_torch.ops import cuda_ekf

    dev = torch.device("cuda", 0)
    kernels.build()
    kernels.lib()
    cfg = config.bench_config().ekf
    rng = np.random.default_rng(0)
    s = cs.generic_ekf_state(cfg, dev, rng)
    has_log = "log" in inspect.signature(cuda_ekf.predict_block).parameters
    us = {}
    for k in (0, 12, 16):
        imus = esekf.Imu(
            lacc=torch.tensor(rng.normal(0, 1, (k, 3)) + [0, 0, 9.78],
                              dtype=torch.float32, device=dev),
            avel=torch.tensor(rng.normal(0, 0.3, (k, 3)),
                              dtype=torch.float32, device=dev),
            ts=torch.tensor(0.2 + np.arange(1, k + 1) * 0.01,
                            dtype=torch.float32, device=dev))
        valid = torch.arange(k, device=dev) < k - 2
        for log in (False, True) if has_log else (False,):
            kw = dict(log=True) if log else {}

            def call(imus=imus, valid=valid, kw=kw):
                return cuda_ekf.predict_block(s, imus, valid, cfg=cfg,
                                              want_twist=True, **kw)

            us[f"{'history' if log else 'plain'}_k{k}"] = cs.kernel_us(
                call, "ekf_predict", 50)
    print(json.dumps({"tag": args.tag, "root": args.root,
                      "card": cs.card_line(), "device_us": us}), flush=True)


if __name__ == "__main__":
    main()
