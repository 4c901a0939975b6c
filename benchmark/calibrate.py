"""The readings that a cell's limits are set from, in one process.

    python3 -m benchmark.calibrate --workload <cell> --seeds a,b,... \
        [--control-seeds c,d,e] [--seconds 1]

For each seed it runs the cell as ``benchmark.run`` does, with a short
window (the training check reads set-up's steps and needs none; the eval
check one candidate), and prints one JSON line: each number compared as
the program gives it, and on the control seeds also the control's and the
planted faults' readings (``controls`` of the cell's driver).  Not part of
a run: ``benchmark.run`` never calls it.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
from types import SimpleNamespace

from .harness import env

env.prepare()

import torch  # noqa: E402

from . import run as run_mod  # noqa: E402
from .harness import device as device_mod  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=1.0)
    args = p.parse_args(argv)
    bench = json.loads((run_mod.ROOT / "BENCHMARK.json").read_text())
    cell = run_mod.load_cell(args.workload, bench)
    dev = device_mod.require(int(cell.cell["chips"]))
    driver = importlib.import_module(f"{__package__}.drivers.{cell.traffic['driver']}")
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    seeds = [int(s) for s in args.seeds.split(",")] + sorted(controls)
    for seed in dict.fromkeys(seeds):
        t0 = time.perf_counter()
        ctx = SimpleNamespace(device=dev, seed=seed, seconds=args.seconds, trace=False,
                              fault=None, controls=seed in controls, **vars(cell))
        result = driver.run(ctx)
        line = {"workload": args.workload, "seed": seed,
                "numbers": result.record["numbers"],
                "seconds": time.perf_counter() - t0}
        if "controls" in result.record:
            line["controls"] = result.record["controls"]
        print(json.dumps(line), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except device_mod.NoCard as e:
        sys.exit(e.code)
