"""The measured window: when it starts and stops, and each step's period.

``Window.step()`` is called at the start of every unit of timed work (a
training step; the eval leg calls ``poll`` before each candidate).  It
records a CUDA event on the current stream, so a step's period runs from
its start on the device to the next step's start and a stall or host gap
lands in the step that waits for it.  Once ``seconds`` have passed on the
host clock since ``open`` it raises ``StopWindow`` before the step runs;
``close`` then waits for the device and ends the window.

In a traced run the window is split in two.  The profiler records every
kernel launch, which slows a launch-bound step by a fifth or more, so the
host-clock readings of a traced run (``mfu.*``, the round loop's share)
come from its untraced lead, the first ``1 - TRACED_SHARE`` of the
seconds, and only the device-trace readings from the traced rest.  At the
lead's end the window waits for the device, notes the lead's seconds and
the work done in it, and starts the profiler."""

from __future__ import annotations

import os
import time
from pathlib import Path
from typing import List, Optional

import torch

TRACED_SHARE = 0.5


def _cpu_times() -> Optional[List[int]]:
    """The machine's CPU times from /proc/stat (user, nice, system, idle,
    iowait, irq, softirq, steal), or None where it cannot say."""
    try:
        return [int(x) for x in Path("/proc/stat").read_text().split("\n", 1)[0].split()[1:9]]
    except (OSError, ValueError):
        return None


def host_load(a, b, own_s: float, wall_s: float) -> Optional[dict]:
    """Over the window: the cores this process kept busy, and where the
    machine's /proc/stat counts (a sandbox may count nothing) the share of
    its CPU time stolen by its hypervisor and the share busy (this process
    and any other).  A host-paced cell slows where either share grows."""
    if wall_s <= 0:
        return None
    out = {"own_cores": own_s / wall_s}
    if a is not None and b is not None and len(a) == len(b) == 8:
        d = [y - x for x, y in zip(a, b)]
        total = sum(d)
        if total > 0:
            out.update(steal_share=d[7] / total,
                       busy_share=(d[0] + d[1] + d[2] + d[5] + d[6]) / total)
    return out


class StopWindow(Exception):
    """Raised by ``Window.step`` once the window's time is up."""


class Window:
    def __init__(self, seconds: float, device: torch.device, trace=None):
        self.seconds = float(seconds)
        self.device = device
        self.cuda = device.type == "cuda"
        self.trace = trace if trace is not None and trace.enabled else None
        self.t0: Optional[float] = None
        self.t1: Optional[float] = None
        self.t_trace: Optional[float] = None
        self.lead: Optional[dict] = None  # {"seconds", "count"} of the untraced lead
        self.events: List = []
        self.host_marks: List[float] = []
        self.steps = 0
        self.host: Optional[dict] = None  # ``host_load`` over the window

    @property
    def is_open(self) -> bool:
        return self.t0 is not None and self.t1 is None

    @property
    def is_traced(self) -> bool:
        """Whether the profiler is on, in the window's traced part."""
        return self.t_trace is not None and self.t1 is None

    @property
    def traced_s(self) -> Optional[float]:
        """The traced part's seconds, once the window has closed."""
        if self.t_trace is None or self.t1 is None:
            return None
        return self.t1 - self.t_trace

    def _mark(self) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.events.append(ev)
        self.host_marks.append(time.perf_counter())

    def open(self) -> None:
        self._cpu0, self._own0 = _cpu_times(), sum(os.times()[:2])
        self.t0 = time.perf_counter()

    def expired(self) -> bool:
        return time.perf_counter() - self.t0 >= self.seconds

    def poll(self, done: int) -> None:
        """Start the profiler once the untraced lead has passed; ``done`` is
        the units of work completed so far, the lead's count."""
        if self.trace is None or self.t_trace is not None:
            return
        if time.perf_counter() - self.t0 < self.seconds * (1.0 - TRACED_SHARE):
            return
        if self.cuda:
            torch.cuda.synchronize(self.device)
        self.lead = {"seconds": time.perf_counter() - self.t0, "count": done}
        self.trace.start()
        self.t_trace = time.perf_counter()

    def step(self) -> None:
        if self.expired():
            raise StopWindow()
        self.poll(self.steps)
        self._mark()
        self.steps += 1

    def close(self) -> float:
        """End the window after the device has finished, and stop the
        profiler; the window's seconds."""
        if self.steps:
            self._mark()
        if self.cuda:
            torch.cuda.synchronize(self.device)
        self.t1 = time.perf_counter()
        self.host = host_load(self._cpu0, _cpu_times(), sum(os.times()[:2]) - self._own0,
                              self.t1 - self.t0)
        if self.trace is not None:
            self.trace.stop()
        return self.t1 - self.t0

    def periods_ms(self) -> List[float]:
        """Each step's period: from its start to the next step's start (the
        last step's to the window's end), on the device's clock where there
        is a card."""
        if self.cuda:
            return [a.elapsed_time(b) for a, b in zip(self.events, self.events[1:])]
        marks = self.host_marks
        return [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
