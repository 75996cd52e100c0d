"""The accelerator a measurement runs on: refuse anything but an NVIDIA
GPU, and name the card with its power limit.

A time taken on the CPU backend says nothing about the card, so the
measuring entry points (bench.py, chip_smoke.py) stop instead of
falling back. nvidia-smi runs in a child process that stays off JAX.
"""

from __future__ import annotations

import subprocess
from typing import List

SMI_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"]


def require_gpu(what: str, platform: str) -> None:
    """Exit non-zero, naming the platform found, unless it is "gpu"."""
    if platform != "gpu":
        raise SystemExit(
            f"{what}: needs an NVIDIA GPU, but JAX found the platform "
            f"{platform!r}; nothing was measured")


def card_lines() -> List[str]:
    """One "<name>, <power limit>" line per card, as nvidia-smi prints
    them (e.g. "NVIDIA H100 80GB HBM3, 700.00 W")."""
    r = subprocess.run(SMI_QUERY, capture_output=True, text=True,
                       timeout=60, check=True)
    return [line.strip() for line in r.stdout.splitlines() if line.strip()]
