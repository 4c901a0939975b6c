"""The benchmark's own ranges and records around the port's calls.

``SpanRecorder`` is the port's ``SpanTimer`` (it still synchronises at each
span's end, as the program does) that also keeps each span's host interval
and opens a profiler range of the span's name, so a traced run sees the
port's spans.  ``wrap`` puts a callable of the port's module namespace
inside a ``bench/<name>`` range and hands each call's arguments and result
to a recorder; ``unwrap`` restores every original."""

from __future__ import annotations

import contextlib
import functools
import time
from typing import Callable, List, Tuple

import torch

from fedfr_tpu_torch.utils.profiling import SpanTimer


class SpanRecorder(SpanTimer):
    def __init__(self, device=None):
        super().__init__(device)
        self.intervals: List[Tuple[str, float, float]] = []

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            with torch.profiler.record_function(name), super().span(name):
                yield
        finally:
            self.intervals.append((name, t0, time.perf_counter()))


class Patches:
    def __init__(self):
        self._saved: List[Tuple[object, str, object]] = []

    def wrap(self, owner, attr: str, range_name: str,
             record: Callable = None) -> None:
        original = getattr(owner, attr)

        @functools.wraps(original)
        def wrapped(*args, **kwargs):
            with torch.profiler.record_function(range_name):
                out = original(*args, **kwargs)
            if record is not None:
                record(args, kwargs, out)
            return out

        self._saved.append((owner, attr, original))
        setattr(owner, attr, wrapped)

    def replace(self, owner, attr: str, new) -> None:
        """Put ``new`` in ``owner.attr`` until ``unwrap`` (a planted fault)."""
        self._saved.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, new)

    def unwrap(self) -> None:
        for owner, attr, original in reversed(self._saved):
            setattr(owner, attr, original)
        self._saved.clear()
