"""Visualization (``ptudes_tpu.viz``): matplotlib graphs, cloud
accumulation and PLY, the flyby camera, the raw-stream player and the EKF
debug scene export. Host-side numpy, apart from the debug scene, which
drives the scan step on the device."""
from . import cloud, fly, graphs

__all__ = ["cloud", "fly", "graphs"]
