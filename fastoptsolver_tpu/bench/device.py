"""What a measurement ran on: the card's identity, its published peaks, and
the refusal to measure anything but a GPU.

Every number bench.py and chip_smoke.py print is named with the device JAX
reports (``platform``, ``device_kind``, device count) and with the card's
name and power limit as ``nvidia-smi`` reads them — a card set below its
maximum power runs slower under load. A run that finds no GPU fails: a CPU
timing is never reported under a device metric.
"""
from __future__ import annotations

import subprocess

NVIDIA_SMI_QUERY = (
    "nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
)

# Published peaks, keyed by JAX's ``device_kind``. Source: NVIDIA H100 Tensor
# Core GPU data sheet, SXM5 part, dense rates (no sparsity), at the full
# 700 W power limit. f32 is the rate outside the tensor cores; the solvers
# pin f32 matmuls to HIGHEST, so TF32 is listed only as the tensor-core rate
# a reduced-precision default would reach.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_bytes_per_s": 3.35e12,
        "f32_flop_per_s": 67e12,
        "tf32_flop_per_s": 495e12,
        "source": "NVIDIA H100 data sheet, SXM5, dense, 700 W",
    },
}


def peaks_for(device_kind: str) -> dict:
    """The peaks row for ``device_kind``; an unknown device is an error, not
    a default."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device_kind {device_kind!r}; add a row "
            f"with its source to PEAKS (known: {sorted(PEAKS)})"
        ) from None


def parse_nvidia_smi(text: str) -> list[dict]:
    """Parse ``name, power.limit`` CSV rows (one per card) as
    :data:`NVIDIA_SMI_QUERY` prints them."""
    cards = []
    for line in text.strip().splitlines():
        name, sep, power = line.rpartition(",")
        if not sep or not name.strip():
            raise ValueError(f"unexpected nvidia-smi line: {line!r}")
        cards.append({"name": name.strip(), "power_limit": power.strip()})
    if not cards:
        raise ValueError("nvidia-smi printed no card")
    return cards


def query_nvidia_smi() -> str:
    """Run :data:`NVIDIA_SMI_QUERY` in a subprocess (JAX never sees it) and
    return its output; raise ``RuntimeError`` when there is no such card."""
    try:
        out = subprocess.run(
            NVIDIA_SMI_QUERY, capture_output=True, text=True, timeout=60,
            check=True,
        )
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"nvidia-smi found no NVIDIA card: {e}") from e
    return out.stdout.strip()


def require_gpu(devices) -> dict:
    """``{platform, kind, count}`` of ``devices``; raise ``RuntimeError``
    unless JAX found a GPU (no fallback to another platform)."""
    dev = devices[0]
    if dev.platform != "gpu":
        raise RuntimeError(
            f"JAX found no GPU (platform {dev.platform!r}, {dev.device_kind!r});"
            " refusing to measure"
        )
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(devices)}
