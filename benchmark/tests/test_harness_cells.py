"""BENCHMARK.json keeps to its contract, and every cell, configuration and
metric resolves to its files by name."""

from __future__ import annotations

import importlib
import json
import math
import re
from pathlib import Path

import pytest

from benchmark.metrics import reader

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16 and 1 <= len(BENCH["command"]) <= 32
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_text():
    names = ([c["name"] for c in BENCH["configs"]] + CELLS + [m["name"] for m in METRICS]
             + [w["traffic"] for w in BENCH["workloads"]]
             + [k for c in BENCH["configs"] for k in c["reduced"]])
    assert all(NAME.match(n) for n in names), names
    assert len(set(CELLS)) == len(CELLS)
    assert len({m["name"] for m in METRICS}) == len(METRICS)
    assert all(UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") for m in METRICS)
    texts = ([w["why"] for w in BENCH["workloads"]] + [c["why"] for c in BENCH["configs"]]
             + [c["source"] for c in BENCH["configs"]] + [m["layer"] for m in BENCH["per_layer"]]
             + BENCH["command"])
    assert all(1 <= len(t) <= 200 and "\n" not in t and "\t" not in t for t in texts)


def test_bounds_and_sources():
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in BENCH["end_to_end"])
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert "bound" not in m


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_to_its_files(cell):
    w = next(w for w in BENCH["workloads"] if w["name"] == cell)
    config = next(c for c in BENCH["configs"] if c["name"] == w["config"])
    cfg = json.loads((ROOT / config["file"]).read_text())
    traffic = json.loads((ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads((ROOT / "benchmark" / "limits" / f"{cell}.json").read_text())
    assert w["chips"] in (1, 4)
    assert cfg["name"] == config["name"] and set(config["reduced"]) <= set(cfg)
    importlib.import_module(f"benchmark.drivers.{traffic['driver']}")
    importlib.import_module(f"benchmark.reference.{cfg['reference']}")
    importlib.import_module(f"benchmark.roofline.{cfg['roofline']}")
    assert limits and all(math.isfinite(v) and v >= 0 for v in limits.values())
    e2e = [m["name"] for m in BENCH["end_to_end"] if cell in m.get("workloads", [cell])]
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = [m for m in BENCH["per_layer"] if cell in m.get("workloads", [cell])]
    assert layer and all(m["moves"] in e2e for m in layer)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_per_layer_metric_has_a_reader_that_reads_nothing_from_nothing(metric):
    assert reader(metric)({}) is None


def test_every_config_is_used_and_has_its_own_file():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    assert all(f.startswith(tuple(p + "/" for p in BENCH["paths"])) for f in files)
    assert all(re.match(r"^[A-Za-z0-9_./-]{1,200}$", p) and not p.endswith("_torch")
               for p in BENCH["paths"])
    four = [w for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(BENCH["workloads"]) // 4)
