"""A frozen copy of ``ptudes_tpu_torch``'s plain PyTorch path: the
single-stream scan step with the kernels' twins, as the benchmark's plain
reference runs it. It imports nothing of the program, of JAX or of the
JAX package."""
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
