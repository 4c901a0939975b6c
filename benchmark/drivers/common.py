"""What every driver shares: the port's configuration from a cell's files,
the reference's modules, host copies and the result a run returns."""

from __future__ import annotations

import copy
import dataclasses
import importlib
import math
from typing import Dict, List, Optional

import torch

from fedfr_tpu_torch.config import FedFRConfig
from fedfr_tpu_torch.data.synthetic import parse_synth_spec
from fedfr_tpu_torch.models import build_backbone

from ..harness.seeding import derive


@dataclasses.dataclass
class RunResult:
    """What a driver hands back to ``run.py``."""
    end_to_end: Dict[str, float]
    setup_done: float                 # perf_counter at the window's start
    peak_bytes: int
    attempted: int
    failed: int
    checked: Dict[str, Dict[str, float]]
    record: Dict                      # what the per-layer readers read


def program_seed(seed: int) -> int:
    """The seed the port's own config takes: its per-client formulas
    multiply it by 1,000,003 twice, and torch takes 64 bits."""
    return derive(seed, "program", bits=24)


def port_config(config: Dict, traffic: Dict, seed: int, device) -> FedFRConfig:
    """The port's ``FedFRConfig`` of run.sh's flags at the cell's sizes."""
    cfg = FedFRConfig()
    cfg.runtime.device = str(device)
    cfg.runtime.seed = program_seed(seed)
    cfg.model.network = config["network"]
    cfg.model.embedding_size = int(config["embedding_size"])
    cfg.model.bf16 = config["trunk_dtype"] == "bfloat16"
    cfg.model.dropout = float(config.get("dropout", 0.0))
    cfg.data.image_size = int(config["image_size"])
    cfg.data.num_clients = int(traffic["clients"])
    cfg.data.num_ids = int(traffic["clients"]) * int(traffic["ids_per_client"])
    cfg.data.rec_root = universe_spec(traffic, seed)
    cfg.data.eval_batch_size = int(traffic["eval_batch"])
    cfg.data.public_batch_size = int(traffic["eval_batch"])
    if "combined_batch" in traffic:
        cfg.data.combined_batch_size = int(traffic["combined_batch"])
        cfg.fed.local_epochs = int(traffic["local_epochs"])
        cfg.optim.train_decay = int(traffic["train_decay"])
        cfg.optim.lr = float(traffic["lr"])
        cfg.optim.momentum = float(traffic["momentum"])
        cfg.optim.weight_decay = float(traffic["weight_decay"])
        cfg.fed.cache_contrastive = bool(traffic["cache_contrastive"])
        for k, v in traffic["loss"].items():
            setattr(cfg.loss, k, v)
    cfg.fed.hn_threshold = float(config.get("hn_threshold", cfg.fed.hn_threshold))
    cfg.fed.hn_cap = int(config.get("hn_cap", cfg.fed.hn_cap))
    cfg.fed.bce_local = cfg.fed.contrastive = cfg.fed.return_all = True
    cfg.fed.add_pretrained_data = cfg.fed.combine_dataset = True
    return cfg


def universe_spec(traffic: Dict, seed: int) -> str:
    """The ``synth:`` universe of the traffic file, its seed from ours."""
    keys = dict(traffic.get("universe_keys", {}))
    keys["seed"] = program_seed(seed)
    return "synth:" + ",".join(f"{k}={v}" for k, v in sorted(keys.items()))


def reference(config: Dict):
    return importlib.import_module(f"benchmark.reference.{config['reference']}")


def build_on(cfg: FedFRConfig, device, state: Dict[str, torch.Tensor]) -> torch.nn.Module:
    """The port's backbone built on ``device`` and loaded with ``state``."""
    with torch.device(device):
        net = build_backbone(cfg.model.network, cfg.model.embedding_size, cfg.model.bf16,
                             cfg.data.image_size, dropout=cfg.model.dropout)
    net.load_state_dict(state)
    return net


def to_host(t: torch.Tensor) -> torch.Tensor:
    """A copy on the host that does not wait for the device (pinned, on the
    current stream), so the device holds nothing more for the check."""
    if t.device.type != "cuda":
        return t.detach().clone()
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t.detach(), non_blocking=True)
    return out


def without_contrastive(cfg: FedFRConfig) -> FedFRConfig:
    """``cfg`` with the MOON term off: a ``Client`` built so skips drawing
    its random last-round model on the host, which the benchmark replaces
    by one drawn on the card from the seed."""
    c = copy.deepcopy(cfg)
    c.fed.contrastive = False
    return c


def percentile(values: List[float], q: float) -> Optional[float]:
    """The q-th percentile by the nearest rank: the smallest value with at
    least q% of the values at or below it."""
    if not values:
        return None
    v = sorted(values)
    rank = max(1, -(-len(v) * q // 100))
    return float(v[int(rank) - 1])


def universe(cfg: FedFRConfig) -> dict:
    """The universe's spec as the port completes it from its config."""
    spec = parse_synth_spec(cfg.data.rec_root)
    spec.update(clients=cfg.data.num_clients, image_size=cfg.data.image_size,
                seed=cfg.runtime.seed,
                ids_per_client=max(1, cfg.data.num_ids // cfg.data.num_clients))
    return spec


def with_limits(ctx, numbers: Dict) -> Dict[str, Dict[str, float]]:
    """The numbers the cell compares (its limits file's), each beside its
    limit; one the check could not give counts as infinite."""
    return {k: {"value": float(numbers.get(k, math.inf)), "limit": float(v)}
            for k, v in ctx.limits.items()}
