"""K7, the patch moments (``csrc/plane_moments.cu``) of ``n`` query points
over ``c`` candidates each: the query rows [3, n] and the lane-major
candidates [4, c, n] in, the moment rows [16, n] out; ten sums under a
radius mask, ~20 operations a candidate."""
SYMBOL = "plane_moments_kernel"


def n_bytes(n: int, c: int) -> int:
    return n * 12 + 4 * c * n * 4 + 16 * n * 4


def flops(n: int, c: int) -> int:
    return 20 * n * c
