"""The training step's share of the card's bf16 peak, in %: the model FLOPs
of an image's step (``roofline/step.py``, nothing recomputed counted)
times the images of the traced run's untraced lead, over the lead's
seconds and the peak (the profiler would slow the steps it records)."""

from benchmark.roofline import model, peaks, step


def read(record):
    lead = record.get("lead")
    if not lead or not lead["images"] or lead["seconds"] <= 0:
        return None
    cfg = record["config"]
    flops = step.step_flops(model(cfg["roofline"]), cfg, record["n_local"], record["n_public"])
    return 100.0 * flops * lead["images"] / lead["seconds"] / peaks()["bf16_flops_per_s"]
