"""The eval leg's share of the card's bf16 peak, in %: the forward FLOPs of
an image's embed (``roofline/step.py``) times the veri images of the
candidates of the traced run's untraced lead, over the lead's seconds and
the peak (the profiler would slow the candidates it records)."""

from benchmark.roofline import model, peaks, step


def read(record):
    lead = record.get("lead")
    if not lead or not lead["images"] or lead["seconds"] <= 0:
        return None
    cfg = record["config"]
    flops = step.embed_flops(model(cfg["roofline"]), cfg)
    return 100.0 * flops * lead["images"] / lead["seconds"] / peaks()["bf16_flops_per_s"]
