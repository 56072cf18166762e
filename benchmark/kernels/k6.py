"""K6, the fused candidate gather and prep (``csrc/gather_fused.cu``) of
``n`` points with ``c`` candidates each from a ``neighborhood`` of voxels:
the points and mask in, the features and lane-major candidates out, and
each probed 32-byte meta row and each sector of stored points read once
(``probed_rows``, ``sectors``: they depend on the map; 0 gives the least
bound); ~8 operations a neighbour, ~26 a candidate and ~150 a point."""
SYMBOL = "gather_fused_kernel"


def n_bytes(n: int, c: int, probed_rows: int = 0, sectors: int = 0) -> int:
    return n * 12 + n + (8 + 4 * c) * n * 4 + 32 * (probed_rows + sectors)


def flops(n: int, c: int, neighborhood: int) -> int:
    return n * (8 * neighborhood + 26 * c + 150)
