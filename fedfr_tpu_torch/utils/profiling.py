"""Profiling and timing hooks: phase spans and the profiler trace.

The port's counterpart of ``fedfr_tpu/utils/profiling.py``:

* ``SpanTimer`` — named wall-clock spans with running totals, with the JAX
  package's API and ``report`` line.  A span ends with
  ``torch.cuda.synchronize`` of every CUDA device it was given (a run's
  whole mesh), the counterpart of the JAX server's completion barrier
  (``fedfr_tpu/federated/server.py:182-191``): PyTorch returns before the
  devices finish, so without it a span would time only the enqueue, or
  end before the other cards finish.  The barrier costs one idle gap per
  span end.
* ``torch_trace(log_dir, device)`` — a ``torch.profiler`` trace (host
  activity, plus the device's on CUDA) written as a Chrome trace under
  ``log_dir``; the counterpart of ``xla_trace``.  Open the JSON in
  ``chrome://tracing`` or Perfetto.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Dict, Iterator, Optional, Sequence, Union

import torch

from ..parallel.mesh import synchronize

logger = logging.getLogger("fedfr_tpu_torch.profiling")

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def torch_trace(log_dir: Optional[str],
                device: Union[str, torch.device] = "cuda") -> Iterator:
    """Profile the block into ``<log_dir>/trace.json`` and yield the
    profiler; with no ``log_dir`` a no-op that yields None."""
    if not log_dir:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    with prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


class SpanTimer:
    """Named wall-clock spans with running totals.  ``device``: a device or
    a list of them; every CUDA device among them is synchronized at each
    span's end, so that a span holds the device work it enqueued."""

    def __init__(self, device: Union[None, str, torch.device,
                                     Sequence[Union[str, torch.device]]] = None):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self.devices = ([] if device is None else [device]
                        if isinstance(device, (str, torch.device)) else list(device))

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            synchronize(self.devices)
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self, log=logger) -> None:
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            log.info("span %-24s total %8.2fs  calls %5d  avg %7.3fs",
                     name, self.totals[name], self.counts[name],
                     self.totals[name] / max(self.counts[name], 1))
