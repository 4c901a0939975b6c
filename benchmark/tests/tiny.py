"""A cell at a size a CPU test can hold: the port's sphnet20 or iresnet18 at
16x16, E=16, a universe of 2 clients x 4 identities, 12 public identities
and 32 veri images.  The measured path is the cells' own, driven by the
same drivers, with the harness's look for a card skipped."""

from __future__ import annotations

import json
from pathlib import Path
from types import SimpleNamespace

import torch

BENCH = Path(__file__).resolve().parents[1]

UNIVERSE = {"imgs_min": 20, "imgs_max": 22, "public_ids": 12, "public_imgs": 200,
            "public_imgs_min": 15, "public_imgs_max": 18, "veri_ids": 8, "veri_imgs": 4}

NETS = {
    "sphnet20": {"network": "sphnet20", "reference": "sphere64", "roofline": "sphere64",
                 "layers": [1, 2, 4, 1]},
    "iresnet18": {"network": "iresnet18", "reference": "iresnet100",
                  "roofline": "iresnet100", "layers": [2, 2, 2, 2]},
}

# set from CPU readings of this size: bf16 trunk against the fp32 reference
# (loss ~1e-3, leaf gaps <= 0.06, rows ~0.011, iresnet18's running
# statistics 0.022 and heads' change 0.016) and the controls (fp8 rows
# ~0.10, half a batch >= 0.23 on every step number, running statistics or
# heads left unchanged 1.0)
LIMITS = {"train": {"loss_gap": 0.05, "grad_gap": 0.15, "update_gap": 0.15,
                    "mine_embed_gap": 0.05, "mine_set_gap": 0.01},
          "train_bn": {"loss_gap": 0.05, "grad_gap": 0.15, "update_gap": 0.15,
                       "update_gap_head": 0.1, "stats_gap": 0.1, "mine_embed_gap": 0.05,
                       "mine_set_gap": 0.01},
          "eval": {"embed_gap": 0.05, "hist_moved": 0.01, "tpr_gap": 0.0}}


def ctx(net: str = "sphnet20", kind: str = "train", seed: int = 2 ** 31 + 12345,
        seconds: float = 1.0, fault=None):
    config = dict(NETS[net], name=net, filters=[64, 128, 256, 512], embedding_size=16,
                  image_size=16, trunk_dtype="bfloat16", head_dtype="float32", dropout=0.0,
                  hn_threshold=-1.0, hn_cap=40)
    name = "round-train" if kind == "train" else "round-eval"
    traffic = json.loads((BENCH / "traffic" / f"{name}.json").read_text())
    traffic.update(clients=2, ids_per_client=4, eval_batch=16, universe_keys=UNIVERSE)
    if kind == "train":
        traffic.update(public_classes=12, public_images=200, combined_batch=16,
                       local_epochs=1, mining_sample_rows=8)
    else:
        traffic.update(candidates=2, embed_sample_rows=8)
    return SimpleNamespace(device=torch.device("cpu"), seed=seed, seconds=seconds,
                           trace=False, fault=fault, config=config, traffic=traffic,
                           limits=LIMITS["train_bn" if kind == "train" and net == "iresnet18"
                                         else kind],
                           cell={"name": f"tiny.{name}"})


def correct(checked) -> bool:
    return all(v["value"] <= v["limit"] for v in checked.values())
