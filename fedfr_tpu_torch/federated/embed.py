"""Batched embedding extraction and feature-space utilities.

Counterpart of ``fedfr_tpu/federated/embed.py``: one eval-mode forward
reused across mining and FC initialization, fed by the background decode +
prefetch pipeline.  Features stay on the device.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..data.datasets import BatchLoader
from ..data.pipeline import prefetched, to_device_batch
from ..models.heads import l2_normalize
from ..ops.max_sim import max_cosine_similarity
from ..utils.device import resolve_device
from .state import normalize_images


@torch.no_grad()
def embed_dataset(model: nn.Module, dataset, batch_size: int = 512,
                  flip_test: bool = False, l2norm: bool = True,
                  device: Optional[Union[str, torch.device]] = "cuda",
                  num_workers: int = 6, prefetch: int = 2,
                  converter: Optional[nn.Module] = None
                  ) -> Tuple[torch.Tensor, np.ndarray]:
    """Embed every active item of a record dataset in dataset order ->
    ((N, E) float32 features on ``device``, (N,) int64 labels).

    ``model`` must already live on ``device``; it runs in eval mode.
    ``flip_test`` sums the embeddings of the image and its horizontal
    mirror (reference local_all.py:209-215).  ``converter`` (a BCE module's
    personalized transformation layer) maps the backbone's features in
    fp32 before anything else, as the JAX package's embed with
    ``bce_params`` does (reference local_all.py:354-359).
    """
    device = resolve_device(device)
    param = next(model.parameters())
    if param.device.type != device.type:
        raise ValueError(f"model is on {param.device}, embedding asked on {device}")
    model.eval()

    def embed(u8):
        f = model(normalize_images(u8)).float()
        return f if converter is None else converter(f)
    n = len(dataset)
    chunks = []
    labels_out = np.empty(n, dtype=np.int64)
    pos = 0
    with BatchLoader(dataset, batch_size, shuffle=False, drop_last=False,
                     num_workers=num_workers) as loader:
        # only the images go to the device; labels and the mask stay on the
        # host, so the loop never waits for the device
        batches = ((to_device_batch((imgs,), device)[0], labels, valid)
                   for imgs, labels, valid in loader.epoch())
        for imgs, labels, valid in prefetched(batches, prefetch):
            nvalid = int(valid.sum())
            f = embed(imgs)
            if flip_test:
                f = f + embed(imgs.flip(2))
            chunks.append(f[:nvalid])
            labels_out[pos:pos + nvalid] = labels[:nvalid]
            pos += nvalid
    feats = torch.cat(chunks)
    if l2norm:
        feats = l2_normalize(feats, dim=1)
    return feats, labels_out


@torch.no_grad()
def embed_flip_caches(models: Sequence[nn.Module], dataset, batch_size: int = 512,
                      device: Optional[Union[str, torch.device]] = "cuda",
                      num_workers: int = 6, prefetch: int = 2) -> List[torch.Tensor]:
    """Per-(image, orientation) features of FROZEN models: one (N, 2, E)
    tensor on ``device`` per entry of ``models``, axis 1 = [original,
    h-flipped], in dataset order, un-normalized.

    Backs the cached-contrastive train step (``trainer.py``): the MOON
    global and last-round models are fixed for a whole local run and run in
    eval mode, so the client embeds its combined dataset once per run and
    the step gathers rows by (position, flip) in place of two frozen
    forwards per step.  Every model reads one pass over the data, so each
    batch is decoded and copied to the device once.  The input is the
    step's own: ``normalize_images`` of the uint8 batch, mirrored on the W
    axis of NHWC (``train_preprocess`` with the flip applied).

    The JAX package pads the row count to a multiple of 8,192 to bound XLA
    recompiles across the mined datasets' sizes; PyTorch compiles nothing
    per shape, so the caches here hold exactly N rows.
    """
    device = resolve_device(device)
    for model in models:
        model.eval()
    chunks: List[List[torch.Tensor]] = [[] for _ in models]
    with BatchLoader(dataset, batch_size, shuffle=False, drop_last=False,
                     num_workers=num_workers) as loader:
        batches = ((to_device_batch((imgs,), device)[0], valid)
                   for imgs, _labels, valid in loader.epoch())
        for u8, valid in prefetched(batches, prefetch):
            nvalid = int(valid.sum())
            x, xf = normalize_images(u8), normalize_images(u8.flip(2))
            for chunk, model in zip(chunks, models):
                chunk.append(torch.stack([model(x), model(xf)], dim=1)[:nvalid])
    return [torch.cat(c) for c in chunks]


def class_mean_features(feats: torch.Tensor, labels: np.ndarray,
                        num_classes: int, normalize_before: bool = False
                        ) -> torch.Tensor:
    """Per-class mean embedding (FC initialization, reference client.py:159-188)."""
    f = l2_normalize(feats, dim=1) if normalize_before else feats
    idx = torch.as_tensor(labels, device=f.device, dtype=torch.long)
    out = torch.zeros(num_classes, f.shape[1], dtype=torch.float32, device=f.device)
    out.index_add_(0, idx, f.float())
    counts = torch.bincount(idx, minlength=num_classes).clamp_min(1)
    return out / counts[:, None].to(out.dtype)


def max_similarity(local_feats: torch.Tensor, public_feats: torch.Tensor
                   ) -> torch.Tensor:
    """(n_public,) max cos-sim of each public image to ANY local image.

    Both inputs must be l2-normalized, float32 or bfloat16.  On the card
    this is the mining kernel (``ops/max_sim.py``, bf16 operands, fp32
    sums); on the CPU its plain version, in fp32 on the operands as given.
    """
    return max_cosine_similarity(public_feats.contiguous(),
                                 local_feats.contiguous())


def hard_negative_mask(local_feats: torch.Tensor, public_feats: torch.Tensor,
                       threshold: float) -> torch.Tensor:
    """Boolean mask over public images with cos-sim > threshold to ANY local
    image (feature-based hard-negative mining, reference client.py:191-224)."""
    return max_similarity(local_feats, public_feats) > threshold
