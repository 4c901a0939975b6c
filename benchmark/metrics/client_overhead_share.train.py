"""Share of the traced run's untraced lead outside the port's
``phase/local_train`` spans: the round loop's own time (mining, the copies
into and out of the work modules, the loaders' start, the per-epoch sync),
in %."""


def read(record):
    lead = record.get("lead")
    if not lead or lead["seconds"] <= 0:
        return None
    spans = [(a, b) for n, a, b in lead["spans"] if n == "phase/local_train"]
    if not spans:
        return None
    inside = sum(b - a for a, b in spans)
    return 100.0 * max(0.0, lead["seconds"] - inside) / lead["seconds"]
