"""The card: the check that the cell's cards are there, and what a result
says of them."""

from __future__ import annotations

import subprocess
import sys

import torch


class NoCard(SystemExit):
    pass


def require(chips: int) -> torch.device:
    """The first card, or exit 2 with a message and no result."""
    if not torch.cuda.is_available():
        print("benchmark: no CUDA device; a run measures the card only", file=sys.stderr)
        raise NoCard(2)
    if torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} cards, {torch.cuda.device_count()} "
              f"visible", file=sys.stderr)
        raise NoCard(2)
    return torch.device("cuda", 0)


def describe(device: torch.device, chips: int, peak_bytes: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": chips,
                "memory_peak_bytes": int(peak_bytes)}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips, "memory_peak_bytes": int(peak_bytes)}


def power_limit() -> str:
    """``name, power.limit`` from nvidia-smi, or '' where it cannot say."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=20)
    except (OSError, subprocess.SubprocessError):
        return ""
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""
