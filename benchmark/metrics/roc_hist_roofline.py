"""The ROC's share of its roofline, in %: the least time of every histogram
of the window at its shapes (``roofline/roc_hist.py``) over the device time
of all operations launched inside the benchmark's ``bench/roc_hist`` range
around ``client_roc`` (the target-first reorder, the kernel's operand copy
and the kernel)."""

from benchmark.roofline import peaks, roc_hist


def read(record):
    calls = record.get("calls", {}).get("bench/roc_hist") or []
    trace = record.get("trace") or {}
    device_s = trace.get("range_device_s", {}).get("bench/roc_hist", 0.0)
    if not calls or device_s <= 0:
        return None
    pk = peaks()
    return 100.0 * sum(roc_hist.least_seconds(c, pk) for c in calls) / device_s
