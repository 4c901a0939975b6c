"""A run loads neither JAX nor the JAX package, fails without a card and
without the port, and the reference reads nothing of the port."""

from __future__ import annotations

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark.harness.imports import forbidden_loaded

ROOT = Path(__file__).resolve().parents[2]


def test_the_check_compares_whole_top_level_names():
    assert forbidden_loaded(["jax.numpy", "torch"]) == ["jax"]
    assert forbidden_loaded(["fedfr_tpu.models", "fedfr_tpu_torch"]) == ["fedfr_tpu"]
    assert forbidden_loaded(["fedfr_tpu_torch.ops", "flaxible", "jaxtyping"]) == []
    assert forbidden_loaded(["flax.linen", "jaxlib"]) == ["flax", "jaxlib"]


def test_a_run_loads_no_jax():
    code = ("import sys; import benchmark.run, benchmark.drivers.round_train, "
            "benchmark.drivers.round_eval, benchmark.calibrate; "
            "from benchmark.harness.imports import forbidden_loaded; "
            "print(forbidden_loaded())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_reference_imports_nothing_of_the_program():
    for path in (ROOT / "benchmark" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            assert not any(n.split(".")[0] in ("fedfr_tpu", "fedfr_tpu_torch", "jax")
                           for n in names), (path.name, names)


def test_no_card_no_result(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                          "sphere64.round-train", "--seed", str(2 ** 33 + 5), "--seconds", "1"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_the_benchmark_alone_has_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                          "sphere64.round-train", "--seed", "7", "--seconds", "1"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
def test_each_cell_runs_correct_on_the_card(card):
    import json
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", w["name"],
                              "--seed", str(2 ** 31 + 99), "--seconds", "5"],
                             cwd=ROOT, capture_output=True, text=True, timeout=600)
        assert out.returncode == 0, out.stderr[-2000:]
        assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
