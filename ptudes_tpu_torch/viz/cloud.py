"""Point-cloud accumulation and export (``ptudes_tpu.viz.cloud``).

The reference's 3D viewers are OpenGL (ouster PointViz). This module
provides the compute-side equivalents: a growable accumulation cloud (reference ``PointCloud``,
``src/ptudes/viz_utils.py:20-132``; ``ScansAccumulator`` map building) and
PLY export so any external viewer (CloudCompare, MeshLab, Open3D) can
render the registered maps and trajectories.
"""
from __future__ import annotations

import numpy as np


class AccumCloud:
    """Growable point buffer with per-point keys (colors) and a point cap
    with random-ratio subsampling — the reference's 1.5M-point map cap
    (``src/ptudes/cli/flyby.py:106-116``)."""

    def __init__(self, max_points: int = 1_500_000, seed: int = 0):
        self._xyz = np.zeros((1024, 3), np.float32)
        self._key = np.zeros((1024,), np.float32)
        self._n = 0
        self._max = max_points
        self._rng = np.random.default_rng(seed)
        self.ratio = 1.0

    def __len__(self) -> int:
        return self._n

    @property
    def points(self) -> np.ndarray:
        return self._xyz[:self._n]

    @property
    def keys(self) -> np.ndarray:
        return self._key[:self._n]

    def _grow(self, need: int) -> None:
        cap = len(self._xyz)
        while cap < need:
            cap = int(cap * 1.3) + 1024  # reference grow factor (:20-132)
        if cap != len(self._xyz):
            self._xyz = np.resize(self._xyz, (cap, 3))
            self._key = np.resize(self._key, (cap,))

    def add(self, pts: np.ndarray, keys: np.ndarray | None = None) -> None:
        pts = np.asarray(pts, np.float32).reshape(-1, 3)
        if self.ratio < 1.0:
            sel = self._rng.uniform(size=len(pts)) < self.ratio
            pts = pts[sel]
            keys = keys[sel] if keys is not None else None
        if self._n + len(pts) > self._max:
            # lower the keep ratio so the final size targets the cap
            self.ratio = max(0.05, self.ratio * 0.7)
            keep = self._max - self._n
            if keep <= 0:
                return
            pts = pts[:keep]
            keys = keys[:keep] if keys is not None else None
        self._grow(self._n + len(pts))
        self._xyz[self._n:self._n + len(pts)] = pts
        self._key[self._n:self._n + len(pts)] = (
            keys if keys is not None else np.linalg.norm(pts, axis=-1))
        self._n += len(pts)


def save_ply(path: str, pts: np.ndarray,
             colors: np.ndarray | None = None) -> None:
    """Binary little-endian PLY writer (no deps)."""
    pts = np.asarray(pts, np.float32).reshape(-1, 3)
    n = len(pts)
    with open(path, "wb") as f:
        hdr = ["ply", "format binary_little_endian 1.0",
               f"element vertex {n}",
               "property float x", "property float y", "property float z"]
        if colors is not None:
            hdr += ["property uchar red", "property uchar green",
                    "property uchar blue"]
        hdr += ["end_header"]
        f.write(("\n".join(hdr) + "\n").encode())
        if colors is None:
            f.write(pts.astype("<f4").tobytes())
        else:
            c = np.asarray(colors, np.uint8).reshape(-1, 3)
            rec = np.zeros(n, dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)])
            rec["xyz"] = pts
            rec["rgb"] = c
            f.write(rec.tobytes())


def load_ply(path: str) -> np.ndarray:
    """Minimal reader for the files :func:`save_ply` writes."""
    with open(path, "rb") as f:
        n = 0
        has_color = False
        while True:
            line = f.readline().decode().strip()
            if line.startswith("element vertex"):
                n = int(line.split()[-1])
            if line.startswith("property uchar"):
                has_color = True
            if line == "end_header":
                break
        if has_color:
            rec = np.frombuffer(
                f.read(), dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)],
                count=n)
            return rec["xyz"].copy()
        return np.frombuffer(f.read(), "<f4", count=n * 3).reshape(n, 3).copy()


def map_to_points(vmap_, voxel_size: float) -> np.ndarray:
    """Every stored point of a ``hashmap.VoxelHashMap`` as numpy [K, 3]
    f32, in slot order (reference ``local_map_points``,
    ``src/ptudes/kiss.py:160-161``). Points are stored voxel-quantized
    (``ops.hashmap.pack_points``); they decode against each slot's
    representative (``ops.hashmap.stored_points``)."""
    from ..ops import hashmap

    counts = vmap_.meta[:, 1].cpu().numpy()
    pts = hashmap.stored_points(vmap_, voxel_size).cpu().numpy()
    ppv = pts.shape[1]
    mask = np.arange(ppv)[None, :] < counts[:, None]
    return pts[mask]
