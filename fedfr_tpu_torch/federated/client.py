"""Client: local trainer for one federated participant (PyTorch).

Counterpart of ``fedfr_tpu/federated/client.py`` (reference client.py:116-582)
for the joint public-data objective (mining by image features or by FC
rows; the MOON term recomputed or gathered from per-run caches) and the
plain objective over the client's own data.  Between rounds a client keeps its
local FC, its BCE state_dict and its last-round backbone state_dict on the
device; a local run loads them into modules that every client shares (the
server's work modules), trains, and copies the results back out.  Its
``timer`` (the server's ``SpanTimer`` once the server holds it) times its
phases as ``phase/mining``, ``phase/contrastive_cache`` and
``phase/local_train`` (one span per local epoch of the joint objective, its
loss fetch included).
"""

from __future__ import annotations

import copy
import logging
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from ..config import FedFRConfig
from ..data.datasets import BatchLoader, CombinedDataset, FaceRecordDataset
from ..data.pipeline import DevicePrefetcher
from ..models import BCEModule, build_backbone, l2_normalize
from ..utils.device import resolve_device
from ..utils.optim import step_lr
from ..parallel.mesh import Mesh, synchronize
from ..utils.profiling import SpanTimer
from .embed import (class_mean_features, embed_dataset, embed_flip_caches,
                    max_similarity)
from .trainer import (branch_step_for, init_client_state, make_plain_train_step,
                      use_cached_contrastive)

logger = logging.getLogger("fedfr_tpu_torch.client")

StateDict = Dict[str, torch.Tensor]
FlipFn = Callable[[int, torch.Tensor], object]


def _loader_seed(seed: int, round_seed: int, cid: int) -> int:
    """Per-(round, client) loader shuffle seed (the JAX package's formula,
    so both packages shuffle a client's data alike)."""
    return seed + 1_000_003 * round_seed + cid


def _flip_seed(seed: int, round_seed: int, cid: int) -> int:
    """Per-(round, client) seed of the augmentation flip generator."""
    return (seed * 1_000_003 + round_seed) * 1_000_003 + cid + 7


def _dropout_seed(seed: int, round_seed: int, cid: int) -> int:
    """Per-(round, client) seed of the dropout generator (a stream apart
    from the flip's)."""
    return _flip_seed(seed, round_seed, cid) + 500_009


def warn_if_collapsed(cfg: FedFRConfig, cid: int, cos_trace, fc_rows: int) -> bool:
    """The collapsed-feature diagnostic of the JAX client
    (``fedfr_tpu/federated/client.py:359-376``): with every pair cosine
    equal (e.g. an exploded pretrained backbone), the CosFace CE pins at
    s*m + log(C-1) and its gradient cancels, so the run learns nothing.
    ``cos_trace`` is the running mean of the CosFace term after each local
    epoch, from the sums the loop already fetches.  Logs the warning and
    returns True when the trace is flat at that value."""
    if not (cfg.loss.loss == "CosFace" and len(cos_trace) >= 2
            and abs(cos_trace[-1] - cos_trace[0]) < 1e-3):
        return False
    sat = (cfg.loss.margin_s * cfg.loss.margin_m
           + float(np.log(max(int(fc_rows) - 1, 1))))
    if abs(cos_trace[-1] - sat) >= 0.1:
        return False
    logger.warning(
        "client %d: cos loss pinned at the all-equal-cosine "
        "saturation value %.3f for %d epochs — features look "
        "collapsed; check the pretrained backbone (feature-norm "
        "explosion upstream, e.g. too-high pretrain lr)",
        cid, sat, len(cos_trace))
    return True


def _detached(module: nn.Module) -> StateDict:
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


class Client:
    """One participant.

    ``backbone`` and ``bce_module`` are the modules a local run trains and
    ``last_net`` the frozen module the last-round model runs in; a server
    shares one of each among all its clients.  Its embeds (mining, FC
    init, the contrastive caches) run over ``mesh``'s ``data`` axis
    (default ``mesh.auto_data_mesh``).  ``flip_fn(step_no, images)``,
    when given, returns the (B,) flip mask of each step in place of the
    client's own seeded generator (the parity tests inject the JAX
    package's masks through it).
    """

    def __init__(self, cid: int, cfg: FedFRConfig, dataset: FaceRecordDataset,
                 backbone: nn.Module, bce_module: Optional[nn.Module], *,
                 last_net: Optional[nn.Module] = None,
                 device=None, flip_fn: Optional[FlipFn] = None,
                 mesh: Optional[Mesh] = None):
        self.cid = cid
        self.cfg = cfg
        self.dataset = dataset
        self.backbone = backbone
        self.bce_module = bce_module
        self.device = resolve_device(cfg.runtime.device if device is None else device)
        self.num_classes = int(dataset.num_classes or 0)
        self.dataset_size = len(dataset)
        # the client's global identity range in the local verification set
        self.id_base = int(dataset.id_base or cid * self.num_classes)
        self.target_ids = list(range(self.id_base, self.id_base + self.num_classes))
        self.flip_fn = flip_fn
        self.mesh = mesh
        self.last_net = last_net
        if cfg.fed.contrastive and last_net is None:
            self.last_net = copy.deepcopy(backbone).eval().requires_grad_(False)

        # seeded per-client initial state, drawn on the CPU so it is the
        # same on every device
        E, seed, dev = cfg.model.embedding_size, cfg.runtime.seed, self.device
        gen = torch.Generator().manual_seed(seed + 1000 + cid)
        # FC_module init: N(0, 0.01) rows (client.py:66)
        self.fc_local = (0.01 * torch.randn(self.num_classes, E, generator=gen)).to(dev)
        self.bce_state: Optional[StateDict] = None
        if cfg.fed.bce_local:
            bce = BCEModule(E, self.num_classes, cfg.model.converter_layers,
                            m=cfg.loss.bce_margin, r=cfg.loss.bce_scale,
                            t=cfg.loss.bce_t,
                            generator=torch.Generator().manual_seed(seed + 2000 + cid))
            self.bce_state = {k: v.to(dev) for k, v in bce.state_dict().items()}
        # MOON "last model": randomly initialized at client creation
        # (client.py:153), replaced by the trained backbone each round
        self.last_backbone: Optional[StateDict] = None
        if cfg.fed.contrastive:
            net = build_backbone(cfg.model.network, E, cfg.model.bf16,
                                 cfg.data.image_size,
                                 generator=torch.Generator().manual_seed(seed + 3000 + cid))
            self.last_backbone = {k: v.to(dev) for k, v in net.state_dict().items()}

        self.last_loss = 0.0
        self.mined = 0  # public images above the mining threshold, last run
        self.trained_backbone: Optional[StateDict] = None
        self.global_fc: Optional[torch.Tensor] = None
        self.timer = SpanTimer()  # the server's, once it holds the client

    # ------------------------------------------------------------- FC init

    def init_fc_from_means(self, global_net: nn.Module,
                           normalize_before: bool = False) -> None:
        """Mean-embedding FC initialization (reference data_update_fc,
        client.py:159-188)."""
        feats, labels = embed_dataset(global_net, self.dataset,
                                      self.cfg.data.eval_batch_size,
                                      l2norm=False, device=self.device,
                                      num_workers=self.cfg.data.num_workers,
                                      mesh=self.mesh)
        self.fc_local = class_mean_features(feats, labels, self.num_classes,
                                            normalize_before)

    def init_bce_from_fc(self) -> None:
        """BCE weight := local FC rows (reference server.py:128-133)."""
        if self.bce_state is not None:
            self.bce_state = dict(self.bce_state, weight=self.fc_local.clone())

    # ------------------------------------------------------------ training

    def select_hard_negatives(self, global_net: nn.Module,
                              public_dataset: FaceRecordDataset,
                              public_feats: torch.Tensor,
                              public_labels: np.ndarray) -> FaceRecordDataset:
        """Feature-based mining (client.py:191-224): embed the local set with
        the current global model, keep public images whose max cos-sim to
        any local image exceeds the threshold."""
        local_feats, _ = embed_dataset(global_net, self.dataset,
                                       self.cfg.data.eval_batch_size,
                                       l2norm=True, device=self.device,
                                       num_workers=self.cfg.data.num_workers,
                                       mesh=self.mesh)
        scores = max_similarity(local_feats, public_feats).cpu().numpy()
        mask = scores > self.cfg.fed.hn_threshold
        cap = self.cfg.fed.hn_cap
        if cap and int(mask.sum()) > cap:
            # bounded-cost variant (DESIGN.md deviation 8): keep only the cap
            # HARDEST images (highest max cos-sim), ties by image index
            over = np.nonzero(mask)[0]
            keep = over[np.argsort(scores[over], kind="stable")[::-1][:cap]]
            mask = np.zeros_like(mask)
            mask[keep] = True
            logger.info("client %d: mining capped at %d hardest (of %d above "
                        "threshold)", self.cid, cap, len(over))
        imgidx = np.nonzero(mask)[0] + 1  # record keys are 1-based
        self.mined = len(imgidx)
        num_ids = len(np.unique(public_labels[mask])) if mask.any() else 0
        logger.info("client %d: %d imgs (%d IDs) hard negative @ > %.2f",
                    self.cid, len(imgidx), num_ids, self.cfg.fed.hn_threshold)
        if len(imgidx) == 0:
            imgidx = np.array([1])
        return public_dataset.subset(imgidx)

    def select_hard_negatives_fc(self, pretrained_fc: torch.Tensor,
                                 public_dataset: FaceRecordDataset,
                                 public_labels: np.ndarray,
                                 threshold: float = 0.2) -> FaceRecordDataset:
        """FC-row mining (reference choose_hard_negative, client.py:227-267):
        the fp32 cosine similarity between the client's FC rows and the
        global FC's selects the public identities above ``threshold`` for
        any local row; every public image of those identities is kept.  A
        (100, E) x (E, C_pub) product outside any kernel of the TPU
        package, so a plain ``torch.matmul``."""
        local = l2_normalize(self.fc_local.float(), dim=1)
        public = l2_normalize(pretrained_fc.to(local.device).float(), dim=1)
        sim = torch.matmul(local, public.t())
        ids = np.unique(torch.nonzero(sim > threshold)[:, 1].cpu().numpy())
        logger.info("client %d: %d IDs are hard negative (FC-based)",
                    self.cid, len(ids))
        imgidx = np.nonzero(np.isin(public_labels, ids))[0] + 1
        self.mined = len(imgidx)
        if len(imgidx) == 0:
            imgidx = np.array([1])
        return public_dataset.subset(imgidx)

    def prepare_local_run(self, global_net: nn.Module, public_dataset,
                          pretrained_fc: torch.Tensor,
                          public_feats: Optional[torch.Tensor],
                          public_labels: np.ndarray, round_seed: int = 0):
        """Mining + combined loader + initial train state for one local run.

        Mining follows ``fed.hn_strategy`` (JAX client.py:194-211): FC rows,
        else image features where the round embedded the public set, else
        the whole public set.  Returns (combined dataset, loader, state,
        last_net): ``state`` holds the shared work modules loaded with this
        run's starting weights.
        """
        cfg = self.cfg
        with self.timer.span("phase/mining"):
            if cfg.fed.hn_strategy == "fc":
                public_subset = self.select_hard_negatives_fc(
                    pretrained_fc, public_dataset, public_labels,
                    threshold=cfg.fed.hn_fc_threshold)
            elif public_feats is not None:
                public_subset = self.select_hard_negatives(
                    global_net, public_dataset, public_feats, public_labels)
            else:
                public_subset = public_dataset
        combined = CombinedDataset(self.dataset, public_subset)
        self.dataset_size = len(combined)  # FedAvg weight (client.py:303)

        loader = BatchLoader(combined, cfg.data.combined_batch_size, shuffle=True,
                             seed=_loader_seed(cfg.runtime.seed, round_seed, self.cid),
                             drop_last=True, num_workers=cfg.data.num_workers)

        self.backbone.load_state_dict(global_net.state_dict())
        bce = None
        if self.bce_state is not None:
            self.bce_module.load_state_dict(self.bce_state)
            bce = self.bce_module
        # fc = [local ; global] (client.py:313)
        fc = torch.cat([self.fc_local, pretrained_fc.to(self.device)])
        state = init_client_state(self.backbone, fc, bce, cfg.optim.lr,
                                  cfg.optim.momentum, cfg.optim.weight_decay)
        last_net = global_net
        if self.last_backbone is not None:
            self.last_net.load_state_dict(self.last_backbone)
            last_net = self.last_net
        return combined, loader, state, last_net

    def finalize_local_run(self, state, avg_loss: float) -> None:
        """Keep the trained state (client.py:468-508); the optimizer's
        momentum is dropped (the reference builds a fresh SGD per run)."""
        self.keep_local_run(_detached(state.backbone), state.fc.detach(),
                            _detached(state.bce) if state.bce is not None else None,
                            avg_loss)

    def keep_local_run(self, backbone: StateDict, fc: torch.Tensor,
                       bce: Optional[StateDict], avg_loss: float) -> None:
        """``finalize_local_run`` on a run's trained tensors (the lockstep
        round hands them over unstacked): the backbone state_dict, the
        [local ; global] FC rows and the BCE state_dict, owned by the
        client from here on."""
        if not np.isfinite(avg_loss):
            logger.warning(
                "client %d: NON-FINITE loss %r — the local run diverged and "
                "FedAvg will propagate it to the global model (sphere nets "
                "typically need lr <= 0.001, reference run.sh:2)",
                self.cid, avg_loss)
        self.fc_local = fc[: self.num_classes].clone()
        self.global_fc = fc[self.num_classes:].clone()
        self.bce_state = bce
        self.trained_backbone = backbone
        if self.last_backbone is not None:
            self.last_backbone = self.trained_backbone
        self.last_loss = float(avg_loss)

    def draw_flip(self, step_no: int, imgs: torch.Tensor,
                  gen: torch.Generator) -> torch.Tensor:
        """The (B,) flip mask of step ``step_no``: ``flip_fn``'s, or one
        uniform draw an image from the run's flip generator ``gen``."""
        if self.flip_fn is not None:
            return torch.as_tensor(np.asarray(self.flip_fn(step_no, imgs)),
                                   dtype=torch.bool, device=imgs.device)
        return torch.rand(imgs.shape[0], generator=gen, device=imgs.device) < 0.5

    def build_flip_caches(self, global_net: nn.Module, last_net: nn.Module,
                          combined) -> list:
        """The cached-contrastive step's (N, 2, E) feature caches of the
        global and the last model over ``combined``, built once per local
        run at ``eval_batch_size``; logs the build's seconds."""
        tic = time.perf_counter()
        caches = embed_flip_caches([global_net, last_net], combined,
                                   self.cfg.data.eval_batch_size,
                                   device=self.device,
                                   num_workers=self.cfg.data.num_workers,
                                   prefetch=self.cfg.data.prefetch, mesh=self.mesh)
        synchronize([self.device] + (self.mesh.distinct_devices()
                                     if self.mesh is not None else []))
        logger.info("client %d: contrastive caches of %d imgs built in %.3f s",
                    self.cid, len(combined), time.perf_counter() - tic)
        return caches

    def generators(self, round_seed: int, device=None):
        """This run's flip generator (None when ``flip_fn`` injects the
        masks) and dropout generator (None without dropout), on ``device``
        (default the client's): a member that trains on another card draws
        there from the same seeds, and Philox gives the same stream on any
        card."""
        cfg = self.cfg
        device = self.device if device is None else device
        gen = dropout_gen = None
        if self.flip_fn is None:
            gen = torch.Generator(device=device).manual_seed(
                _flip_seed(cfg.runtime.seed, round_seed, self.cid))
        if cfg.model.dropout > 0:
            dropout_gen = torch.Generator(device=device).manual_seed(
                _dropout_seed(cfg.runtime.seed, round_seed, self.cid))
        return gen, dropout_gen

    def train_with_public_data(self, global_net: nn.Module, public_dataset,
                               pretrained_fc: torch.Tensor,
                               public_feats: Optional[torch.Tensor],
                               public_labels: np.ndarray,
                               local_epochs: int, train_decay: int,
                               step_fn=None, round_seed: int = 0) -> Dict[str, float]:
        """One local run of the joint objective (client.py:287-508).  Under
        ``use_cached_contrastive`` the frozen models' features are cached
        before the first step and ``step_fn`` must be the cached step."""
        cfg = self.cfg
        combined, base_loader, state, last_net = self.prepare_local_run(
            global_net, public_dataset, pretrained_fc, public_feats,
            public_labels, round_seed)
        loader = DevicePrefetcher(base_loader, self.device, depth=cfg.data.prefetch)
        if len(loader) == 0:  # fail before the cache build below
            base_loader.close()
            raise ValueError(
                f"client {self.cid}: combined dataset ({len(combined)} imgs) "
                f"smaller than the batch size {cfg.data.combined_batch_size}")
        use_cache = use_cached_contrastive(cfg)
        if use_cache:
            with self.timer.span("phase/contrastive_cache"):
                g_cache, l_cache = self.build_flip_caches(global_net, last_net,
                                                          combined)
        if step_fn is None:
            step_fn = branch_step_for(cfg, self.num_classes, use_cache)

        gen, dropout_gen = self.generators(round_seed)
        # the loss sums stay on the device: one host sync per epoch; the
        # reported loss is the mean over every step of the run (reference
        # AverageMeter semantics, client.py:349-352,404)
        acc = torch.zeros(4, device=self.device)
        n_steps = 0
        sums = np.zeros(4, np.float32)  # stays zero if local_epochs == 0
        cos_trace = []
        try:
            for epoch in range(local_epochs):
                lr = step_lr(cfg.optim.lr, epoch, train_decay, cfg.optim.lr_gamma)
                tic = time.perf_counter()
                epoch_steps = 0
                with self.timer.span("phase/local_train"):
                    for batch in loader.epoch(with_positions=use_cache):
                        imgs, labels, valid = batch[:3]
                        flip = self.draw_flip(n_steps, imgs, gen)
                        if use_cache:
                            state, metrics = step_fn(state, g_cache, l_cache, imgs,
                                                     labels, valid, batch[3], lr,
                                                     flip, dropout_gen=dropout_gen)
                        else:
                            state, metrics = step_fn(state, global_net, last_net,
                                                     imgs, labels, valid, lr, flip,
                                                     dropout_gen=dropout_gen)
                        acc += torch.stack(metrics)
                        n_steps += 1
                        epoch_steps += 1
                    sums = acc.cpu().numpy()  # the epoch's one host sync
                speed = (epoch_steps * cfg.data.combined_batch_size
                         / max(time.perf_counter() - tic, 1e-9))
                mean = sums / max(n_steps, 1)
                cos_trace.append(float(mean[1]))
                logger.info("client %d epoch %d/%d lr %.5f loss %.3f "
                            "(cos %.3f bce %.3f con %.3f) %.1f samples/sec",
                            self.cid, epoch + 1, local_epochs, lr,
                            mean[0], mean[1], mean[2], mean[3], speed)
        finally:
            base_loader.close()  # even on a mid-run failure
        warn_if_collapsed(cfg, self.cid, cos_trace, state.fc.shape[0])
        self.finalize_local_run(state, sums[0] / max(n_steps, 1))
        return {"loss": self.last_loss, "steps": n_steps,
                "dataset_size": self.dataset_size}

    # ------------------------------------------------------ plain objective

    def prepare_plain_run(self, global_net: nn.Module, round_seed: int = 0):
        """Loader + initial train state for one plain local run (JAX
        client.py:380-390): the client's own data at ``data.batch_size``,
        shuffled, the last batch padded and masked; the state is the work
        backbone loaded with the global weights and the client's own FC."""
        cfg = self.cfg
        loader = BatchLoader(self.dataset, cfg.data.batch_size, shuffle=True,
                             seed=_loader_seed(cfg.runtime.seed, round_seed, self.cid),
                             drop_last=False, num_workers=cfg.data.num_workers)
        self.backbone.load_state_dict(global_net.state_dict())
        state = init_client_state(self.backbone, self.fc_local, None, cfg.optim.lr,
                                  cfg.optim.momentum, cfg.optim.weight_decay)
        return loader, state

    def finalize_plain_run(self, state, avg_loss: float) -> None:
        """Keep a plain run's state (reference client.py:566-570): the whole
        trained FC is the local FC, and the FedAvg weight is the client's
        own set."""
        self.keep_plain_run(_detached(state.backbone), state.fc.detach(), avg_loss)

    def keep_plain_run(self, backbone: StateDict, fc: torch.Tensor,
                       avg_loss: float) -> None:
        """``finalize_plain_run`` on a plain run's trained tensors."""
        if not np.isfinite(avg_loss):
            logger.warning("client %d: NON-FINITE loss %r in plain local "
                           "training", self.cid, avg_loss)
        self.fc_local = fc.clone()
        self.trained_backbone = backbone
        self.last_loss = float(avg_loss)
        self.dataset_size = len(self.dataset)

    def train(self, global_net: nn.Module, local_epochs: int, lr: float,
              step_fn=None, round_seed: int = 0) -> Dict[str, float]:
        """Plain CosFace-only local training (reference client.py:511-571):
        a constant ``lr``, the loss averaged over every step of the run."""
        cfg = self.cfg
        base_loader, state = self.prepare_plain_run(global_net, round_seed)
        loader = DevicePrefetcher(base_loader, self.device, depth=cfg.data.prefetch)
        if step_fn is None:
            step_fn = make_plain_train_step(margin=cfg.loss.loss, s=cfg.loss.margin_s,
                                            m=cfg.loss.margin_m)
        gen, dropout_gen = self.generators(round_seed)
        loss_acc = torch.zeros((), device=self.device)
        n_steps = 0
        try:
            with self.timer.span("phase/local_train"):
                for _ in range(local_epochs):
                    for imgs, labels, valid in loader.epoch():
                        flip = self.draw_flip(n_steps, imgs, gen)
                        state, loss = step_fn(state, imgs, labels, valid, lr, flip,
                                              dropout_gen=dropout_gen)
                        loss_acc += loss  # on-device running sum
                        n_steps += 1
        finally:
            base_loader.close()
        self.finalize_plain_run(state, float(loss_acc) / max(n_steps, 1))
        return {"loss": self.last_loss, "steps": n_steps,
                "dataset_size": self.dataset_size}
