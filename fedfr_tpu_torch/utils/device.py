"""Device selection for the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = "cuda") -> torch.device:
    """The torch device an entry point runs on: ``cuda`` unless the caller
    asks for ``cpu``.  Raises when CUDA is asked for and absent; nothing
    carries on on the CPU in its place."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (config "
            "runtime.device='cpu') to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
