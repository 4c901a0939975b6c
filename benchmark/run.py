"""One run of one cell of ``BENCHMARK.json``.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Finds the cell's configuration (``benchmark/configs/<config>.json``), its
traffic (``benchmark/traffic/<traffic>.json``, whose ``driver`` names the
module of ``benchmark/drivers/`` that runs it) and its limits
(``benchmark/limits/<cell>.json``) by name; runs set-up, the window and the
check; and prints, as the last line of standard output, one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device``, with
``--trace 1`` ``breakdown``, and last ``checked``: each number compared
beside its limit, which also end standard error.  Exits non-zero with no
result where the cell's cards are missing, or where JAX or the JAX package
was loaded.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time
from pathlib import Path
from types import SimpleNamespace

T_IMPORT = time.perf_counter()

from .harness import env  # noqa: E402

env.prepare()


from .harness import device as device_mod  # noqa: E402
from .harness.imports import forbidden_loaded  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def process_age() -> float:
    """Seconds since this process started (its start time in /proc), or
    since this module was imported where /proc cannot say."""
    try:
        ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return uptime - ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - T_IMPORT


def load_cell(name: str, bench: dict) -> SimpleNamespace:
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"benchmark: no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    config = json.loads((HERE / "configs" / f"{cell['config']}.json").read_text())
    traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    limits = json.loads((HERE / "limits" / f"{name}.json").read_text())
    return SimpleNamespace(cell=cell, config=config, traffic=traffic, limits=limits)


def metrics_of(cell: dict, bench: dict, end_to_end: dict, trace: bool, record: dict,
               setup_s: float) -> dict:
    """The cell's end-to-end metrics, or with ``trace`` its per-layer ones
    (each read by its own reader; one that finds nothing is left out)."""
    from .metrics import reader
    name = cell["name"]
    e2e = {m["name"]: m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])}
    if not trace:
        values = dict(end_to_end, setup_s=setup_s)
        return {k: {"value": float(values[k]), "unit": m["unit"]}
                for k, m in e2e.items() if values.get(k) is not None}
    out = {}
    for m in bench["per_layer"]:
        if m["moves"] not in e2e or name not in m.get("workloads", [name]):
            continue
        value = reader(m["name"])(record)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def breakdown(record: dict):
    t = record.get("trace")
    if not t:
        return None
    # kernel names are cut to their first 160 characters (templates run long)
    return {"device_ops": [[n[:160], s] for n, s in t["device_ops"]],
            "idle_gaps": [[n[:160], s] for n, s in t["idle_gaps"]]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = load_cell(args.workload, bench)
    dev = device_mod.require(int(cell.cell["chips"]))
    power = device_mod.power_limit()
    driver = importlib.import_module(f"{__package__}.drivers.{cell.traffic['driver']}")
    ctx = SimpleNamespace(device=dev, seed=args.seed, seconds=args.seconds,
                          trace=bool(args.trace), fault=None, **vars(cell))
    result = driver.run(ctx)
    setup_s = process_age() - (time.perf_counter() - result.setup_done)
    bad = forbidden_loaded()
    if bad:
        print(f"benchmark: the run loaded {', '.join(bad)}; no result", file=sys.stderr)
        return 3
    checked = result.checked
    correct = all(v["value"] <= v["limit"] for v in checked.values())
    line = {"correct": correct, "attempted": result.attempted, "failed": result.failed,
            "metrics": metrics_of(cell.cell, bench, result.end_to_end, bool(args.trace),
                                  result.record, setup_s),
            "device": device_mod.describe(dev, int(cell.cell["chips"]), result.peak_bytes)}
    if args.trace:
        t = result.record.get("trace") or {}
        line["device"].update(busy_s=t.get("busy_s", 0.0),
                              window_s=result.record.get("traced_s") or 0.0)
        bd = breakdown(result.record)
        if bd:
            line["breakdown"] = bd
    line["checked"] = checked
    print(json.dumps({"card": power, "setup_s": setup_s, "window_s": result.record["window_s"],
                      "steps_or_candidates": result.attempted,
                      "traced_s": result.record.get("traced_s"),
                      "lead": {k: v for k, v in (result.record.get("lead") or {}).items()
                               if k != "spans"},
                      "extra": {k: result.record[k] for k in ("periods_ms", "client_runs",
                                                              "candidate_seconds",
                                                              "setup_stages", "host")
                                if k in result.record}}), file=sys.stderr)
    for k, v in checked.items():
        print(f"checked {k} = {v['value']!r} (limit {v['limit']!r})", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except device_mod.NoCard as e:
        sys.exit(e.code)
