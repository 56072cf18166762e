"""ptudes-tpu on PyTorch and CUDA: the loosely coupled LIO main path for one
NVIDIA Hopper card (sm_90a).

The package mirrors ``ptudes_tpu``'s module names so each function has an
obvious counterpart, but imports neither JAX nor ``ptudes_tpu``: the machine
with the card has no JAX. Plain tensor code is PyTorch; the JAX package's
seven TPU kernels (EKF predict, EKF update, ICP candidate prep, the whole
ICP Gauss-Newton loop, one GN build, the fused candidate gather, the patch
moments) are hand-written CUDA C++ under ``csrc/``, built with ``nvcc`` on
first use (``kernels``). Every kernel has a plain PyTorch twin that the CPU
tests run and ``chip_smoke.py`` compares it with on the card.
"""
import torch as _torch

# Geometry and state estimation are precision-critical (pose chains at
# 100 m lever arms, 18x18 EKF covariances, the 6x6 GN systems): f32 matmuls
# and convolutions must not drop to TF32's ~10 mantissa bits on the card.
# Mirrors ptudes_tpu/__init__.py forcing "highest" matmul precision.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

__version__ = "0.1.0"

GRAV = 9.782940329221166
"""Gravity constant, numerically identical to ``ptudes_tpu.GRAV``."""
