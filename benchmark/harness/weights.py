"""Weights made on the device from the seed, in a few large draws.

A reference model (``benchmark/reference/<name>.py``) gives the names and
shapes (built on the meta device, so nothing is allocated) and its
``init_rule(name, shape)`` says how each is drawn: ``("normal", std)`` or
``("const", value)``.  All leaves of one std come from one ``randn`` of
their summed size on the device, in fp32, the type they are served in.
The measured program and the reference load the same state dict."""

from __future__ import annotations

from collections import defaultdict
from typing import Dict

import torch

from .seeding import generator


def make_state(net_cls, cfg: Dict, init_rule, seed: int, tag: str,
               device) -> Dict[str, torch.Tensor]:
    with torch.device("meta"):
        shapes = {k: (tuple(v.shape), v.dtype) for k, v in net_cls(cfg).state_dict().items()}
    gen = generator(seed, tag, device)
    out: Dict[str, torch.Tensor] = {}
    normal = defaultdict(list)
    for name, (shape, dtype) in shapes.items():
        kind, value = init_rule(name, shape)
        if kind == "normal":
            normal[value].append(name)
        else:
            out[name] = torch.full(shape, value, dtype=dtype, device=device)
    for std in sorted(normal):
        names = normal[std]
        sizes = [torch.Size(shapes[n][0]).numel() for n in names]
        flat = torch.randn(sum(sizes), generator=gen, device=device).mul_(std)
        for n, part in zip(names, torch.split(flat, sizes)):
            out[n] = part.view(shapes[n][0])
    return {k: out[k] for k in shapes}


def rows(n: int, e: int, std: float, seed: int, tag: str, device) -> torch.Tensor:
    return torch.randn(n, e, generator=generator(seed, tag, device), device=device).mul_(std)


def unit_rows(n: int, e: int, seed: int, tag: str, device, dtype=torch.float32):
    x = torch.randn(n, e, generator=generator(seed, tag, device), device=device)
    return (x / x.norm(dim=1, keepdim=True)).to(dtype)


def bce_state(fc_local: torch.Tensor) -> Dict[str, torch.Tensor]:
    """FedFR's BCE start: identity converter, rows = the local FC rows."""
    e = fc_local.shape[1]
    dev = fc_local.device
    return {"converter.0.weight": torch.eye(e, device=dev),
            "converter.0.bias": torch.zeros(e, device=dev),
            "weight": fc_local.clone(), "bias": torch.zeros(fc_local.shape[0], device=dev)}
