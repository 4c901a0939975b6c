"""Per-layer metric readers, one file a metric, named as in BENCHMARK.json.

Each ``<name>.py`` has ``read(record) -> float | None``: ``record`` is what
the cell's driver kept of the traced run: ``window_s``; ``lead``, the
untraced lead's ``seconds``, ``images`` and (training) the port's
``spans``; ``traced_s``, the traced part's seconds, with its ``calls`` and
``trace`` (``harness/trace.py``); the configuration and counts.
A reader that finds nothing to read returns None and the metric is left
out of the result."""

from __future__ import annotations

import importlib.util
from pathlib import Path

HERE = Path(__file__).resolve().parent


def reader(name: str):
    path = HERE / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
