"""Read the weights files the port evaluates and fine-tunes.

* ``.pth`` — a ``torch.save`` of a state_dict in the reference key layout:
  the port's own exports, the reference's, and the JAX package's
  (``pretrain.py`` writes ``backbone.pth`` for sphnet/iresnet).
* ``.npz`` — the JAX package's native format, a flat npz of a variable
  tree: ``pretrain.py``'s ``backbone.npz`` for nets with no torch layout
  (toy, or another input size) and ``Server.save_client_checkpoints``'s
  ``bce_module.npz`` for a BottleBlock converter.  The port's copy of the
  format's reader (``fedfr_tpu/utils/checkpoint.py:23-84``): keys are the
  tree's path joined by ``/``, list indices are written ``#<i>`` (bare
  digits in older files), and dict keys that look like either are escaped
  with a leading ``=``.  The tree then goes through ``interop``.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..interop import backbone_state_dict, bce_state_dict

StateDict = Dict[str, torch.Tensor]


def _unflatten(flat: Dict[str, np.ndarray]) -> Any:
    root: Dict[str, Any] = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def convert(node):
        if not isinstance(node, dict):
            return node
        keys = list(node)
        if keys and all(k.startswith("#") and k[1:].isdigit() for k in keys):
            return [convert(node[k]) for k in sorted(keys, key=lambda k: int(k[1:]))]
        if keys and all(k.isdigit() for k in keys):
            return [convert(node[k]) for k in sorted(keys, key=int)]
        return {k[1:] if k.startswith("=") else k: convert(v)
                for k, v in node.items()}

    return convert(root)


def load_native(path: str) -> Any:
    """A JAX-package ``.npz`` -> its tree of numpy arrays."""
    with np.load(path if path.endswith(".npz") else path + ".npz") as z:
        return _unflatten({k: z[k] for k in z.files})


def load_pth(path: str):
    """A ``.pth`` of tensors (a state_dict, or one tensor: ``fc.pth``, the
    pretrain labels, the ``preCos_init_AN.pth`` cache), on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)


def load_backbone_state(network: str, path: str) -> StateDict:
    """A backbone's weights file (``.pth`` or ``.npz``) -> the port's
    state_dict for ``network``, on the CPU."""
    if path.endswith(".npz"):
        return backbone_state_dict(network, load_native(path))
    return load_pth(path)


def load_bce_state(path: str) -> StateDict:
    """A BCE module's weights file (``.pth`` or ``.npz``) -> the port's
    ``BCEModule`` state_dict, on the CPU."""
    if path.endswith(".npz"):
        return bce_state_dict(load_native(path))
    return load_pth(path)

