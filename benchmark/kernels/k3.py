"""K3, the candidate prep (``csrc/gn_prep.cu``) of ``n`` source points with
``c`` candidates each: the candidates' points and valid flags, the query
points and the source mask in; the plane features [8, n] and the
lane-major candidates [4, c, n] out; ~20 operations a candidate and ~150
a point for the plane fit."""
SYMBOL = "gn_prep_kernel"


def n_bytes(n: int, c: int) -> int:
    return n * c * 12 + n * c + n * 12 + n + (8 + 4 * c) * n * 4


def flops(n: int, c: int) -> int:
    return n * (20 * c + 150)
