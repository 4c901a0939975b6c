"""Carry weights from the JAX package into the port.

Takes the JAX package's variables as **numpy** trees (``jax.device_get`` of
its ``{'params': ..., 'batch_stats': ...}`` dicts; nothing here imports jax)
and returns the port's state_dicts of CPU tensors, in the reference key
layout the port's modules use.  The port's own counterpart of
``fedfr_tpu/utils/torch_interop.py``, in one direction.

Layout conversions:
* conv kernels: HWIO -> OIHW
* dense kernels: (in, out) -> (out, in)
* the flatten boundary before the embedding fc: the NHWC package
  flattens (h*W*C + w*C + c), the port flattens NCHW (c*H*W + h*W + w), so
  the fc kernel's input axis is permuted.
* BatchNorm: scale/bias + mean/var -> weight/bias + running_mean/running_var.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import numpy as np
import torch

from .models.iresnet import IRES_FILTERS, IRES_LAYERS
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


def _unscan_iresnet(variables: Tree, depth: int) -> Tree:
    """scan_blocks layout (each stage's blocks after the first stacked on
    axis 0, in ``params`` and ``batch_stats`` alike) -> unrolled variables."""
    def unstack(tree, i):
        if isinstance(tree, dict):
            return {k: unstack(v, i) for k, v in tree.items()}
        return np.asarray(tree)[i]

    out = {}
    for coll, src in variables.items():
        dst = {k: v for k, v in src.items() if not k.endswith("_blocks")}
        for stage, blocks in enumerate(IRES_LAYERS[depth], start=1):
            if blocks > 1:
                stacked = src[f"layer{stage}_blocks"]["block"]
                for b in range(1, blocks):
                    dst[f"layer{stage}_block{b}"] = unstack(stacked, b - 1)
        out[coll] = dst
    return out


def iresnet_state_dict(variables: Tree, depth: int) -> StateDict:
    """JAX ``IResNet`` variables (plain or ``scan_blocks``) -> the port's
    ``IResNet`` state_dict (the BN1d ``features`` scale, which the JAX
    module does not have, is 1)."""
    if any(k.endswith("_blocks") for k in variables["params"]):
        variables = _unscan_iresnet(variables, depth)
    p, st = variables["params"], variables["batch_stats"]
    sd: StateDict = {}

    def bn(key, bp, bs):
        sd[f"{key}.weight"] = _t(bp["scale"])
        sd[f"{key}.bias"] = _t(bp["bias"])
        sd[f"{key}.running_mean"] = _t(bs["mean"])
        sd[f"{key}.running_var"] = _t(bs["var"])
        sd[f"{key}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)

    sd["conv1.weight"] = _conv(p["conv1"]["kernel"])
    bn("bn1", p["bn1"], st["bn1"])
    sd["prelu.weight"] = _t(p["prelu"]["alpha"])
    for stage, blocks in enumerate(IRES_LAYERS[depth], start=1):
        for b in range(blocks):
            name, tb = f"layer{stage}_block{b}", f"layer{stage}.{b}"
            bp, bs = p[name], st[name]
            bn(f"{tb}.bn1", bp["bn1"], bs["bn1"])
            sd[f"{tb}.conv1.weight"] = _conv(bp["conv1"]["kernel"])
            bn(f"{tb}.bn2", bp["bn2"], bs["bn2"])
            sd[f"{tb}.prelu.weight"] = _t(bp["prelu"]["alpha"])
            sd[f"{tb}.conv2.weight"] = _conv(bp["conv2"]["kernel"])
            bn(f"{tb}.bn3", bp["bn3"], bs["bn3"])
            if b == 0:  # every stage's head block is strided
                sd[f"{tb}.downsample.0.weight"] = _conv(bp["ds_conv"]["kernel"])
                bn(f"{tb}.downsample.1", bp["ds_bn"], bs["ds_bn"])
    bn("bn2", p["bn2"], st["bn2"])
    sd["fc.weight"] = _dense_flat(p["fc"]["kernel"], IRES_FILTERS[-1])
    sd["fc.bias"] = _t(p["fc"]["bias"])
    bn("features", {"scale": np.ones_like(p["features"]["bias"]),
                    "bias": p["features"]["bias"]}, st["features"])
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
    if network.startswith("iresnet"):
        return iresnet_state_dict(variables, int(network[len("iresnet"):]))
    raise ValueError(f"unknown backbone '{network}'")


def bce_state_dict(variables: Tree) -> StateDict:
    """JAX ``BCEModule`` variables (Linear or BottleBlock converter) -> the
    port's ``BCEModule`` state_dict."""
    p = variables["params"]
    sd = {"weight": _t(p["weight"]), "bias": _t(p["bias"])}
    conv = p["converter"]
    if "dense" in conv:  # the Linear converter
        sd["converter.0.weight"] = _dense(conv["dense"]["kernel"])
        sd["converter.0.bias"] = _t(conv["dense"]["bias"])
        return sd
    for i in range(1, 5):
        for j, sub in ((0, "dense1"), (2, "dense2")):
            sd[f"converter.br{i}.{j}.weight"] = _dense(conv[f"br{i}_{sub}"]["kernel"])
            sd[f"converter.br{i}.{j}.bias"] = _t(conv[f"br{i}_{sub}"]["bias"])
    sd["converter.concat_fc.weight"] = _dense(conv["concat_fc"]["kernel"])
    sd["converter.concat_fc.bias"] = _t(conv["concat_fc"]["bias"])
    return sd


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
