"""Published dense peaks by card (NVIDIA's data sheets, at the full power limit).

(float32 outside the tensor cores, bf16 in them, memory bytes/s). The share
of a peak is stated against these, with the card's power limit beside it.
A card not listed has no peak here, and no share is reported for it.
"""

from __future__ import annotations

PEAKS = {
    "H100 PCIe": (51e12, 756e12, 2.0e12),
    "H100": (67e12, 989e12, 3.35e12),  # SXM, "NVIDIA H100 80GB HBM3"
}


def peaks(device_name: str):
    """(f32 FLOP/s, bf16 FLOP/s, bytes/s) of ``device_name``, or None."""
    for key in sorted(PEAKS, key=len, reverse=True):
        if key in device_name:
            return PEAKS[key]
    return None
