"""K5, one GN build (``csrc/gn_iter.cu``, one launch a GN iteration) over
``n`` source points with ``c`` candidates each: the source, the plane
features and the lane-major candidates read once, the pose in and the
44-float system out; ~8 operations a candidate and ~120 a point."""
SYMBOL = "gn_iter_kernel"


def n_bytes(n: int, c: int) -> int:
    return n * 12 + (8 + 4 * c) * n * 4 + 16 * 4 + 44 * 4


def flops(n: int, c: int) -> int:
    return n * (8 * c + 120)
