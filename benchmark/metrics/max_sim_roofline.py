"""The mining call's share of its roofline, in %: the least time of every
``max_similarity`` call of the window at its shapes
(``roofline/max_sim.py``) over the device time of all operations launched
inside the benchmark's ``bench/max_sim`` range around those calls."""

from benchmark.roofline import max_sim, peaks


def read(record):
    calls = record.get("calls", {}).get("bench/max_sim") or []
    trace = record.get("trace") or {}
    device_s = trace.get("range_device_s", {}).get("bench/max_sim", 0.0)
    if not calls or device_s <= 0:
        return None
    pk = peaks()
    return 100.0 * sum(max_sim.least_seconds(c, pk) for c in calls) / device_s
