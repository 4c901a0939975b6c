"""Operations and bytes from call shapes, and the card's published peaks.

One file a model (``<config's roofline>.py``: ``forward_flops(cfg)`` and
``stem_dgrad_flops(cfg)``) and one a kernel (``max_sim.py``,
``roc_hist.py``: ``least_seconds(shape, peaks)``); ``step.py`` prices a
local training step from a model's file.  None of them reads the measured
program.
"""

from __future__ import annotations

import importlib
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


def peaks() -> dict:
    return json.loads((HERE / "peaks.json").read_text())


def model(name: str):
    """The roofline module of a configuration, found by name."""
    return importlib.import_module(f"{__name__}.{name}")
