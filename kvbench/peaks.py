"""Published peaks of the cards the benchmark runs on, by the name
``torch.cuda.get_device_name()`` gives.

NVIDIA H100 (SXM5) data sheet: 3.35 TB/s of HBM3 bandwidth, at the full
700 W power limit.  The data sheet gives no rate for the int32 compares
the conflict kernels do (its TOPS are the int8 tensor cores'), so a
kernel's roofline here is its bytes bound alone.
"""

from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12,
                              "power_limit_w": 700.0},
}


def hbm_bytes_per_s(device_name: str) -> float | None:
    p = PEAKS.get(device_name)
    return None if p is None else p["hbm_bytes_per_s"]
