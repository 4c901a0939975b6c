"""Carry weights from the JAX package into the port.

Takes the JAX package's variables as **numpy** trees (``jax.device_get`` of
its ``{'params': ..., 'batch_stats': ...}`` dicts; nothing here imports jax)
and returns the port's state_dicts of CPU tensors, in the reference key
layout the port's modules use.  The port's own counterpart of
``fedfr_tpu/utils/torch_interop.py``, in one direction.

Layout conversions:
* conv kernels: HWIO -> OIHW
* dense kernels: (in, out) -> (out, in)
* the flatten boundary before sphnet's embedding fc: the NHWC package
  flattens (h*W*C + w*C + c), the port flattens NCHW (c*H*W + h*W + w), so
  the fc kernel's input axis is permuted.
* BatchNorm: scale/bias + mean/var -> weight/bias + running_mean/running_var.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np
import torch

from .models.sphnet import SPH_LAYERS

Tree = Dict[str, Any]
StateDict = Dict[str, torch.Tensor]


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))  # a writable copy


def _conv(k) -> torch.Tensor:
    return _t(np.asarray(k).transpose(3, 2, 0, 1))  # HWIO -> OIHW


def _dense(k) -> torch.Tensor:
    return _t(np.asarray(k).T)


def _dense_flat(k, channels: int) -> torch.Tensor:
    """fc over a flattened NHWC feature map -> fc over the NCHW flatten."""
    k = np.asarray(k)
    hw = math.isqrt(k.shape[0] // channels)
    if hw * hw * channels != k.shape[0]:
        raise ValueError(f"fc in-dim {k.shape[0]} is not {channels} x h x h")
    out = k.shape[1]
    return _t(k.reshape(hw, hw, channels, out).transpose(3, 2, 0, 1)
              .reshape(out, channels * hw * hw))


def _unscan_sphnet(params: Tree, depth: int) -> Tree:
    """scan_blocks layout (blocks stacked on axis 0) -> unrolled params."""
    out = dict(params)
    for stage, blocks in enumerate(SPH_LAYERS[depth], start=1):
        stacked = out.pop(f"layer{stage}_blocks")["block"]
        for b in range(blocks):
            out[f"layer{stage}_block{b}"] = {
                sub: {k: np.asarray(v)[b] for k, v in stacked[sub].items()}
                for sub in ("conv1", "prelu1", "conv2", "prelu2")}
    return out


def sphnet_state_dict(variables: Tree, depth: int = 64) -> StateDict:
    """JAX ``SphNet`` variables (plain or ``scan_blocks``) -> the port's
    ``SphNet`` state_dict."""
    p = variables["params"]
    if any(k.endswith("_blocks") for k in p):
        p = _unscan_sphnet(p, depth)
    sd: StateDict = {}
    for stage, blocks in enumerate(SPH_LAYERS[depth], start=1):
        sd[f"layer{stage}.0.weight"] = _conv(p[f"layer{stage}_conv"]["kernel"])
        sd[f"layer{stage}.0.bias"] = _t(p[f"layer{stage}_conv"]["bias"])
        sd[f"layer{stage}.1.weight"] = _t(p[f"layer{stage}_prelu"]["alpha"])
        for b in range(blocks):
            fb = p[f"layer{stage}_block{b}"]
            tb = f"layer{stage}.{2 + b}"
            sd[f"{tb}.conv1.weight"] = _conv(fb["conv1"]["kernel"])
            sd[f"{tb}.prelu1.weight"] = _t(fb["prelu1"]["alpha"])
            sd[f"{tb}.conv2.weight"] = _conv(fb["conv2"]["kernel"])
            sd[f"{tb}.prelu2.weight"] = _t(fb["prelu2"]["alpha"])
    sd["fc.weight"] = _dense_flat(p["fc"]["kernel"], 512)
    sd["fc.bias"] = _t(p["fc"]["bias"])
    return sd


def toy_state_dict(variables: Tree) -> StateDict:
    """JAX ``ToyNet`` variables -> the port's ``ToyNet`` state_dict."""
    p, st = variables["params"], variables["batch_stats"]
    return {
        "conv1.weight": _conv(p["conv1"]["kernel"]),
        "bn1.weight": _t(p["bn1"]["scale"]),
        "bn1.bias": _t(p["bn1"]["bias"]),
        "bn1.running_mean": _t(st["bn1"]["mean"]),
        "bn1.running_var": _t(st["bn1"]["var"]),
        "bn1.num_batches_tracked": torch.tensor(0, dtype=torch.long),
        "conv2.weight": _conv(p["conv2"]["kernel"]),
        "fc.weight": _dense(p["fc"]["kernel"]),
        "fc.bias": _t(p["fc"]["bias"]),
    }


def backbone_state_dict(network: str, variables: Tree) -> StateDict:
    if network == "toy":
        return toy_state_dict(variables)
    if network in ("sphnet", "sphnet20"):
        return sphnet_state_dict(variables, 20 if network == "sphnet20" else 64)
    raise NotImplementedError(f"no interop for '{network}' yet")


def bce_state_dict(variables: Tree) -> StateDict:
    """JAX ``BCEModule`` variables (Linear converter) -> the port's
    ``BCEModule`` state_dict."""
    p = variables["params"]
    dense = p["converter"]["dense"]
    return {"weight": _t(p["weight"]), "bias": _t(p["bias"]),
            "converter.0.weight": _dense(dense["kernel"]),
            "converter.0.bias": _t(dense["bias"])}


def client_state(network: str, fc_local, bce_vars: Optional[Tree],
                 last_backbone: Optional[Tree]) -> Dict[str, Any]:
    """A JAX client's host state -> the port ``Client``'s attributes
    (``fc_local``, ``bce_state``, ``last_backbone``)."""
    return {
        "fc_local": _t(fc_local),
        "bce_state": None if bce_vars is None else bce_state_dict(bce_vars),
        "last_backbone": (None if last_backbone is None
                          else backbone_state_dict(network, last_backbone)),
    }
