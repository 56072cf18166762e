"""The table of peaks a roofline share is taken against: one NVIDIA H100's
published rates (NVIDIA's data sheet, SXM part, at its 700 W limit)."""
from __future__ import annotations

# card name (torch.cuda.get_device_name) -> (HBM bytes/s, f32 FLOP/s
# outside the tensor cores)
PEAKS = {"NVIDIA H100 80GB HBM3": (3.35e12, 67e12)}
DEFAULT = "NVIDIA H100 80GB HBM3"


def bound_s(n_bytes: float, flops: float, kind: str | None = None) -> float:
    """The least time the card could take for work of ``n_bytes`` moved
    and ``flops`` f32 operations: the larger of the two over the peaks."""
    bw, fl = PEAKS.get(kind or DEFAULT, PEAKS[DEFAULT])
    return max(n_bytes / bw, flops / fl)
