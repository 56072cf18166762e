"""K4, the whole frozen-candidate GN loop of one scan (``csrc/icp_loop.cu``)
over ``n`` source points with ``c`` candidates each: the source, the plane
features and the lane-major candidates read once, the guess in and the
20-float result out; each of the scan's ``iterations`` costs ~8
operations a candidate and ~120 a point."""
SYMBOL = "icp_loop_kernel"


def n_bytes(n: int, c: int) -> int:
    return n * 12 + (8 + 4 * c) * n * 4 + 16 * 4 + 20 * 4


def flops(n: int, c: int, iterations: int) -> int:
    return iterations * n * (8 * c + 120)
