"""Batched embedding extraction and feature-space utilities.

Counterpart of ``fedfr_tpu/federated/embed.py``: one eval-mode forward
reused across mining, FC initialization and the evals, fed by the
background decode + prefetch pipeline.  Features stay on the device.

Every embed runs over a mesh's ``data`` axis (``ShardedEmbed``, JAX's
``make_sharded_embed_fn``): one replica of the model on each device of the
axis, each batch split into contiguous blocks over them, the outputs
gathered on the model's own device in row order.  With no mesh given the
layout is JAX's ``auto_embed_fn``'s: every visible GPU when a run on the
card sees more than one (``auto_data_mesh``), else the model's device
alone.
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
from ..parallel.mesh import Mesh, auto_data_mesh
from ..utils.device import resolve_device
from .state import normalize_images


class ShardedEmbed:
    """Data-parallel eval-mode embedding over a mesh axis (JAX
    ``make_sharded_embed_fn``; the reference's nn.DataParallel).

    ``model`` (and ``converter``, a BCE module's personalized
    transformation layer) live on the caller's device; ``mesh.replicas``
    places their current weights on every device of ``axis`` once, at
    construction, so build one per pass over the data.  ``place(u8)`` pads
    a batch whose size the axis does not divide by repeating its first
    row, splits it into equal contiguous blocks and copies each to its
    device (a host batch through pinned memory); ``embed(blocks, flip)``
    runs each block's forward on its device and returns the (B, E) fp32
    features on the caller's device, in row order, pad rows dropped.
    Without a mesh it is the caller's device alone."""

    def __init__(self, model: nn.Module, mesh: Optional[Mesh] = None,
                 axis: str = "data", converter: Optional[nn.Module] = None):
        self.home = next(model.parameters()).device
        if mesh is None:
            self.devices, self.nets, self.converters = [self.home], [model], [converter]
        else:
            self.devices = mesh.axis_devices(axis)
            self.nets = mesh.replicas(model, axis)
            self.converters = (mesh.replicas(converter, axis) if converter is not None
                               else [None] * len(self.devices))
        for net in self.nets:
            net.eval()

    def place(self, u8) -> Tuple[List[torch.Tensor], int]:
        """(the per-device blocks of a (B, H, W, C) uint8 batch, B)."""
        b, nd = u8.shape[0], len(self.devices)
        pad = -b % nd
        if pad:
            rep = (pad,) + (1,) * (u8.ndim - 1)
            u8 = (torch.cat([u8, u8[:1].repeat(rep)]) if isinstance(u8, torch.Tensor)
                  else np.concatenate([u8, np.tile(u8[:1], rep)]))
        step = (b + pad) // nd
        return [to_device_batch((u8[d * step:(d + 1) * step],), dev)[0]
                for d, dev in enumerate(self.devices)], b

    def forward(self, d: int, x: torch.Tensor) -> torch.Tensor:
        """Device ``d``'s replica on normalized images ``x`` (fp32 out)."""
        f = self.nets[d](x).float()
        return f if self.converters[d] is None else self.converters[d](f)

    def gather(self, outs: Sequence[torch.Tensor], b: int) -> torch.Tensor:
        """The blocks' outputs on the caller's device, in row order."""
        if len(outs) == 1:
            return outs[0][:b]
        return torch.cat([o.to(self.home, non_blocking=True) for o in outs])[:b]

    @torch.no_grad()
    def embed(self, placed: Tuple[List[torch.Tensor], int],
              flip: bool = False) -> torch.Tensor:
        blocks, b = placed
        return self.gather([self.forward(d, normalize_images(x.flip(2) if flip else x))
                            for d, x in enumerate(blocks)], b)

    def __call__(self, u8) -> torch.Tensor:
        return self.embed(self.place(u8))


def _check_model(model: nn.Module, device: torch.device) -> None:
    param = next(model.parameters())
    if param.device.type != device.type:
        raise ValueError(f"model is on {param.device}, embedding asked on {device}")


@torch.no_grad()
def embed_dataset(model: nn.Module, dataset, batch_size: int = 512,
                  flip_test: bool = False, l2norm: bool = True,
                  device: Optional[Union[str, torch.device]] = "cuda",
                  num_workers: int = 6, prefetch: int = 2,
                  converter: Optional[nn.Module] = None,
                  mesh: Optional[Mesh] = None) -> Tuple[torch.Tensor, np.ndarray]:
    """Embed every active item of a record dataset in dataset order ->
    ((N, E) float32 features on ``device``, (N,) int64 labels).

    ``model`` must already live on ``device``; it runs in eval mode, over
    ``mesh``'s ``data`` axis (default ``auto_data_mesh(device)``).
    ``flip_test`` sums the embeddings of the image and its horizontal
    mirror (reference local_all.py:209-215).  ``converter`` (a BCE module's
    personalized transformation layer) maps the backbone's features in
    fp32 before anything else, as the JAX package's embed with
    ``bce_params`` does (reference local_all.py:354-359).
    """
    device = resolve_device(device)
    _check_model(model, device)
    embed = ShardedEmbed(model, mesh if mesh is not None else auto_data_mesh(device),
                         converter=converter)
    n = len(dataset)
    chunks = []
    labels_out = np.empty(n, dtype=np.int64)
    pos = 0
    with BatchLoader(dataset, batch_size, shuffle=False, drop_last=False,
                     num_workers=num_workers, pin_memory=device.type == "cuda") as loader:
        # only the images go to the devices; labels and the mask stay on
        # the host, so the loop never waits for the device
        batches = ((embed.place(imgs), labels, valid)
                   for imgs, labels, valid in loader.epoch())
        for placed, labels, valid in prefetched(batches, prefetch):
            nvalid = int(valid.sum())
            f = embed.embed(placed)
            if flip_test:
                f = f + embed.embed(placed, flip=True)
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
                      num_workers: int = 6, prefetch: int = 2,
                      mesh: Optional[Mesh] = None) -> List[torch.Tensor]:
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
    per shape, so the caches here hold exactly N rows.  The models run over
    ``mesh``'s ``data`` axis (default ``auto_data_mesh(device)``) and the
    caches come back on ``device``.
    """
    device = resolve_device(device)
    mesh = mesh if mesh is not None else auto_data_mesh(device)
    embeds = []
    for model in models:
        _check_model(model, device)
        embeds.append(ShardedEmbed(model, mesh))
    chunks: List[List[torch.Tensor]] = [[] for _ in models]
    with BatchLoader(dataset, batch_size, shuffle=False, drop_last=False,
                     num_workers=num_workers, pin_memory=device.type == "cuda") as loader:
        batches = ((embeds[0].place(imgs), valid)
                   for imgs, _labels, valid in loader.epoch())
        for (blocks, b), valid in prefetched(batches, prefetch):
            nvalid = int(valid.sum())
            xs = [(normalize_images(u8), normalize_images(u8.flip(2))) for u8 in blocks]
            for chunk, emb in zip(chunks, embeds):
                outs = [torch.stack([emb.nets[d](x), emb.nets[d](xf)], dim=1)
                        for d, (x, xf) in enumerate(xs)]
                chunk.append(emb.gather(outs, b)[:nvalid])
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
