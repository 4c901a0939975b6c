"""The benchmark's own operation counts agree with the program's measured
count (``count_flops`` on the port's modules) and with the bounds on
record."""

from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

from benchmark.roofline import max_sim, model, peaks, roc_hist, step
from fedfr_tpu_torch.federated.trainer import make_branch_train_step, init_client_state
from fedfr_tpu_torch.models import BCEModule, build_backbone
from fedfr_tpu_torch.utils.flops import count_flops

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def config(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())


@pytest.mark.parametrize("name,gflop", [("sphere64", 13.79), ("iresnet100", 24.18)])
def test_forward_formula_matches_the_record_and_count_flops(name, gflop):
    cfg = config(name)
    formula = model(cfg["roofline"]).forward_flops(cfg)
    assert round(formula / 1e9, 2) == gflop == cfg["gflop_per_image"]["count_flops_forward"]
    torch.manual_seed(0)
    net = build_backbone(cfg["network"], cfg["embedding_size"], False, cfg["image_size"]).eval()
    with torch.no_grad():
        counted = count_flops(net, torch.zeros(1, 3, cfg["image_size"], cfg["image_size"]))
    assert abs(counted - formula) / formula < 1e-6


def test_step_formula_matches_count_flops_on_the_port_step():
    """sphere64's branch step at the cell's head sizes (100 local and 6,000
    global FC rows), counted on two images."""
    cfg = config("sphere64")
    e, size = cfg["embedding_size"], cfg["image_size"]
    torch.manual_seed(0)
    nets = [build_backbone("sphnet", e, False, size) for _ in range(3)]
    for n in nets[1:]:
        n.eval().requires_grad_(False)
    state = init_client_state(nets[0], 0.01 * torch.randn(6100, e), BCEModule(e, 100), 1e-3)
    run = make_branch_train_step(num_local=100)
    imgs = torch.randint(0, 256, (2, size, size, 3), dtype=torch.uint8)
    counted = count_flops(run, state, nets[1], nets[2], imgs, torch.tensor([1, 500]),
                          torch.ones(2, dtype=torch.bool), 1e-3, torch.zeros(2, dtype=torch.bool))
    formula = step.step_flops(model("sphere64"), cfg, 100, 6000)
    assert abs(counted / 2 - formula) / formula < 1e-6
    assert abs(formula / 1e9 - cfg["gflop_per_image"]["step"]) < 1e-3


def test_kernel_bounds_match_the_record():
    pk = peaks()
    assert round(max_sim.least_seconds((420_671, 6_500, 512), pk) * 1e3, 3) == 2.831
    assert round(roc_hist.least_seconds((4_000, 160_000, 512), pk) * 1e3, 2) == 9.66
    assert roc_hist.pairs(4_000, 160_000) == 4_000 * 160_000 - 4_000 * 4_001 // 2
