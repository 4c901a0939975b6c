""".bin pair-set verification (LFW/AgeDB/CFP protocol).

The port's counterpart of ``fedfr_tpu/evalsuite/verification.py``
(reference eval/verification.py:199-282): loads the pickled (bins, issame)
pair set, embeds the original and the horizontally flipped images, sums the
two embeddings, l2-normalises, and runs the 10-fold evaluation
(``ops/kfold.py``).  The flip happens on the device; the fold math runs on
the host in fp64, as in the JAX package.  The embed runs over a mesh's
``data`` axis (``federated/embed.py::ShardedEmbed``; default the auto
layout, every visible GPU of a run on the card).
"""

from __future__ import annotations

import logging
import os
import pickle
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..data import codec
from ..federated.embed import ShardedEmbed
from ..ops.kfold import evaluate
from ..parallel.mesh import Mesh, auto_data_mesh
from ..utils.device import resolve_device

_BIN_CACHE_FORMAT = "fedfr_tpu.bin_cache.v1"  # the JAX package's cache format


def _resize_short(img: np.ndarray, size: int) -> np.ndarray:
    """Resize so the SHORTER side equals ``size``, preserving aspect ratio
    (reference mx.image.resize_short, eval/verification.py:218-220; mxnet's
    default interp=2 is bicubic)."""
    import cv2

    h, w = img.shape[:2]
    if h <= w:
        new_h, new_w = size, max(int(round(w * size / h)), 1)
    else:
        new_h, new_w = max(int(round(h * size / w)), 1), size
    return cv2.resize(img, (new_w, new_h), interpolation=cv2.INTER_CUBIC)


def load_bin(path: str, image_size: Tuple[int, int] = (112, 112),
             use_cache: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """Decode a .bin pair set -> (N, H, W, 3) uint8 NHWC + (N/2,) issame.

    Images whose size differs from ``image_size`` are resize-short'ed like
    the reference (eval/verification.py:218-220).  The decoded set is cached
    to ``<path without .bin>.pkl`` (reference verification.py:207-230) in
    the JAX package's cache format, so either package reuses the other's; a
    .pkl in an unrecognized format is ignored and rewritten.
    """
    cache_path = path[: -len(".bin")] + ".pkl" if path.endswith(".bin") else path + ".pkl"
    if use_cache and os.path.exists(cache_path):
        try:
            with open(cache_path, "rb") as f:
                cached = pickle.load(f)
            if (isinstance(cached, dict)
                    and cached.get("format") == _BIN_CACHE_FORMAT
                    and tuple(cached["image_size"]) == tuple(image_size)):
                return cached["data"], cached["issame"]
        except (OSError, EOFError, pickle.UnpicklingError, AttributeError,
                KeyError, ValueError, TypeError, ImportError):
            pass  # corrupt/foreign cache: decode the .bin
    with open(path, "rb") as f:
        try:
            bins, issame_list = pickle.load(f)
        except UnicodeDecodeError:  # py2 pickles
            f.seek(0)
            bins, issame_list = pickle.load(f, encoding="bytes")
    n = len(issame_list) * 2
    data = np.empty((n, image_size[0], image_size[1], 3), dtype=np.uint8)
    for i in range(n):
        img = codec.decode(bytes(bins[i]))
        if img.shape[:2] != tuple(image_size):
            img = _resize_short(img, image_size[0])
            if img.shape[:2] != tuple(image_size):
                raise ValueError(
                    f"bin image {i} is {img.shape[:2]} after resize-short; "
                    f"non-square sources cannot fill {image_size} (the "
                    f"reference fails on these too, verification.py:214-226)")
        data[i] = img
    issame = np.asarray(issame_list, dtype=bool)
    if use_cache:
        try:
            with open(cache_path, "wb") as f:
                pickle.dump({"format": _BIN_CACHE_FORMAT, "data": data,
                             "issame": issame, "image_size": tuple(image_size)},
                            f, pickle.HIGHEST_PROTOCOL)
        except OSError:  # read-only data dir: the cache is best-effort
            pass
    return data, issame


@torch.no_grad()
def test_bin(model: nn.Module, data: np.ndarray, issame: np.ndarray,
             batch_size: int = 128, nfolds: int = 10, device="cuda",
             mesh: Optional[Mesh] = None):
    """Embed + evaluate one pair set (reference verification.py:234-282).

    ``model`` lives on ``device`` and runs in eval mode, over ``mesh``'s
    ``data`` axis (default ``auto_data_mesh(device)``).  The last window
    is the reference's full-size window ending at N (padded at the front by
    repeating its first image when N < ``batch_size``).  Returns
    (accuracy-flip mean, std, xnorm, embeddings, inference seconds).
    """
    device = resolve_device(device)
    embed = ShardedEmbed(model, mesh if mesh is not None else auto_data_mesh(device))
    n = data.shape[0]
    emb_lists = []
    infer_time = 0.0
    for flip in (False, True):
        out: Optional[np.ndarray] = None
        for start in range(0, n, batch_size):
            end = min(start + batch_size, n)
            batch = data[end - batch_size: end] if end - batch_size >= 0 else data[:end]
            if batch.shape[0] < batch_size:
                pad = np.repeat(batch[:1], batch_size - batch.shape[0], axis=0)
                batch = np.concatenate([pad, batch])
            placed = embed.place(batch)
            t0 = time.time()
            feats = embed.embed(placed, flip).cpu().numpy()
            infer_time += time.time() - t0
            if out is None:
                out = np.zeros((n, feats.shape[1]), dtype=np.float64)
            count = end - start
            out[start:end] = feats[batch_size - count:]
        emb_lists.append(out)

    xnorm = float(np.mean([np.linalg.norm(e, axis=1).mean() for e in emb_lists]))
    emb = emb_lists[0] + emb_lists[1]
    emb = emb / np.maximum(np.linalg.norm(emb, axis=1, keepdims=True), 1e-12)
    _, _, accuracy, _, _, _ = evaluate(emb, issame, nfolds)
    return float(accuracy.mean()), float(accuracy.std()), xnorm, emb, infer_time


class BinVerificationCallback:
    """Per-round verification over the configured .bin targets with
    best-accuracy tracking (reference CallBackVerification,
    utils/utils_callbacks.py:13-67).

    ``net`` is an eval module that this callback owns: each call loads the
    state to be evaluated into it.  Targets whose ``<name>.bin`` is missing
    from ``data_dir`` are skipped, as in the JAX package.
    """

    def __init__(self, net: nn.Module, targets: List[str], data_dir: str,
                 batch_size: int = 128, logger: Optional[logging.Logger] = None,
                 image_size: Tuple[int, int] = (112, 112), device="cuda",
                 mesh: Optional[Mesh] = None):
        self.net = net.eval().requires_grad_(False)
        self.batch_size = batch_size
        self.device = device
        self.mesh = mesh
        self.sets = []
        self.names: List[str] = []
        self.highest: List[Tuple[int, float]] = []
        self.logger = logger
        for name in targets:
            path = os.path.join(data_dir, name + ".bin")
            if os.path.exists(path):
                self.sets.append(load_bin(path, image_size))
                self.names.append(name)
                self.highest.append((0, 0.0))

    def __call__(self, round_idx: int, state: Dict[str, torch.Tensor]) -> List[float]:
        self.net.load_state_dict(state)
        accs = []
        for i, (data, issame) in enumerate(self.sets):
            acc, std, xnorm, _, _ = test_bin(self.net, data, issame,
                                             self.batch_size, device=self.device,
                                             mesh=self.mesh)
            if self.logger:
                self.logger.info("[%s][%d]XNorm: %f", self.names[i], round_idx, xnorm)
                self.logger.info("[%s][%d]Accuracy-Flip: %1.5f+-%1.5f",
                                 self.names[i], round_idx, acc, std)
            if acc > self.highest[i][1]:
                self.highest[i] = (round_idx, acc)
            if self.logger:
                self.logger.info("[%s][%d]Accuracy-Highest: %1.5f",
                                 self.names[i], self.highest[i][0], self.highest[i][1])
            accs.append(acc)
        return accs

    def is_best(self, round_idx: int) -> bool:
        """True when this round set a new best on the LAST val target, as the
        reference gates its best-model checkpoint on ``highest_acc_list[-1]``
        (server.py:142)."""
        return bool(self.highest) and self.highest[-1][0] == round_idx
