"""The traced run: ``torch.profiler`` over the window and what is read off it.

``Trace`` is started by the window when its untraced lead ends
(``harness/window.py``) and stopped when the window closes.  ``summary()``
reads the raw events once:

* ``busy_s``: the union of the device's operations (kernels, copies,
  sets), clipped to the traced part of the window;
* ``device_ops``: device seconds by operation name;
* ``idle_gaps``: seconds the device sat idle, by what the host's main
  thread was doing at the gap's start (its innermost annotated range, the
  port's span or the benchmark's range, and its last runtime call);
* ``range_device_s``: device seconds of the operations launched from
  inside each annotated range (a launch is matched to its device operation
  by the profiler's correlation id, and to a range by thread and time).
"""

from __future__ import annotations

import bisect
import threading
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

RANGE_PREFIXES = ("phase/", "bench/")


class Trace:
    """The profiler over the window, recording on the host only the
    annotated ranges (``record_function``), not every operator: an
    operator-level host trace costs sphere64's launch-heavy step about as
    much host time as the step itself.  The device's operations and the
    runtime's launches (which carry the correlation ids) are recorded
    whole."""

    def __init__(self, enabled: bool, device: torch.device):
        self.enabled = enabled
        self.device = device
        self.results = None
        self.active = False
        self.main_thread = threading.get_native_id()

    def start(self) -> None:
        if not self.enabled:
            return
        from torch._C._autograd import _enable_profiler, _prepare_profiler
        from torch._C._profiler import RecordScope
        p = torch.autograd.profiler.profile(
            use_device="cuda" if self.device.type == "cuda" else None, use_kineto=True)
        try:
            config = p.config(create_trace_id=False)
        except TypeError:
            config = p.config()
        acts = p.kineto_activities
        _prepare_profiler(config, acts)
        _enable_profiler(config, acts, {RecordScope.USER_SCOPE})
        self.active = True

    def stop(self) -> None:
        if self.active:
            from torch._C._autograd import _disable_profiler
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.results = _disable_profiler()
            self.active = False

    def summary(self) -> Optional[dict]:
        if self.results is None:
            return None
        return summarize(self.results.events(), self.main_thread)


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def _innermost(spans: List[Tuple[int, int, str]], starts: List[int], t: int) -> str:
    """The name of the shortest span holding ``t`` ('' if none); ``spans``
    sorted by start, ``starts`` their starts."""
    best, best_len = "", None
    i = bisect.bisect_right(starts, t)
    for s, e, name in reversed(spans[max(0, i - 64):i]):
        if s <= t < e and (best_len is None or e - s < best_len):
            best, best_len = name, e - s
    return best


def summarize(events, main_thread: int, top: int = 10) -> dict:
    cuda = torch.autograd.DeviceType.CUDA
    dev: List[Tuple[int, int, str, int]] = []
    launches: Dict[int, Tuple[int, int]] = {}
    ranges: List[Tuple[int, int, str, int]] = []
    host_ops: List[Tuple[int, int, str]] = []
    for ev in events:
        start, end = ev.start_ns(), ev.end_ns()
        if ev.device_type() == cuda:
            if not ev.is_user_annotation():
                dev.append((start, end, ev.name(), ev.correlation_id()))
            continue
        name = ev.name()
        thread = ev.start_thread_id()
        if name.startswith(RANGE_PREFIXES):
            ranges.append((start, end, name, thread))
        elif name.startswith("cuda"):
            if ev.correlation_id():
                launches[ev.correlation_id()] = (start, thread)
            host_ops.append((start, end, name, thread))
    threads = {t for _, _, _, t in ranges}
    if main_thread not in threads and ranges:
        # the profiler may number threads otherwise: take the thread that
        # opened the most ranges, the loop's own
        counts = defaultdict(int)
        for _, _, _, t in ranges:
            counts[t] += 1
        main_thread = max(counts, key=counts.get)
    host_ops = [(s, e, n) for s, e, n, t in host_ops if t == main_thread]
    busy = _union([(s, e) for s, e, _, _ in dev])
    busy_ns = sum(e - s for s, e in busy)
    by_op: Dict[str, float] = defaultdict(float)
    for s, e, name, _ in dev:
        by_op[name] += (e - s) * 1e-9
    # what the host did at each idle gap's start
    main_ranges = sorted((s, e, n) for s, e, n, t in ranges if t == main_thread)
    host_ops.sort()
    r_starts = [s for s, _, _ in main_ranges]
    o_starts = [s for s, _, _ in host_ops]
    gaps: Dict[str, float] = defaultdict(float)
    for (s0, e0), (s1, _) in zip(busy, busy[1:]):
        label = _innermost(main_ranges, r_starts, e0) or "outside any range"
        i = bisect.bisect_right(o_starts, e0)
        op = host_ops[i - 1][2] if i else ""
        gaps[f"{label} > after {op}" if op else label] += (s1 - e0) * 1e-9
    # device time of the operations launched from inside each range
    by_thread = defaultdict(list)
    for s, e, n, t in sorted(ranges):
        by_thread[t].append((s, e, n))
    starts = {t: [s for s, _, _ in v] for t, v in by_thread.items()}
    range_s: Dict[str, float] = defaultdict(float)
    for s, e, _, corr in dev:
        launch = launches.get(corr)
        if launch is None:
            continue
        t_launch, thread = launch
        spans = by_thread.get(thread)
        if not spans:
            continue
        i = bisect.bisect_right(starts[thread], t_launch)
        for rs, re_, rn in spans[max(0, i - 64):i]:
            if rs <= t_launch < re_:
                range_s[rn] += (e - s) * 1e-9
    return {
        "busy_s": busy_ns * 1e-9,
        "device_ops": sorted(by_op.items(), key=lambda kv: -kv[1])[:top],
        "idle_gaps": sorted(gaps.items(), key=lambda kv: -kv[1])[:top],
        "range_device_s": dict(range_s),
    }
