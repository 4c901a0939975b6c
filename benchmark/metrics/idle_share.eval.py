"""Share of the traced part of the window in which no operation ran on the
device, in %: 1 - the union of the device's operations over its seconds."""


def read(record):
    trace = record.get("trace")
    traced = record.get("traced_s")
    if not trace or not traced or trace.get("busy_s", 0) <= 0:
        return None
    return 100.0 * max(0.0, 1.0 - trace["busy_s"] / traced)
