"""Server: the federated coordinator (PyTorch).

Counterpart of ``fedfr_tpu/federated/server.py`` (reference server.py:68-371)
for the sequential training round: it holds the global backbone, dispatches
the sampled clients each round, aggregates with dataset-size-weighted FedAvg
over every state entry (BN statistics included) and averages the shared
global FC.

Evaluation is injected, as in the JAX package: ``eval_callback(server)``
is what ``test()`` runs after a round (the ``.bin`` verification), and
``local_eval_callback(server, client, epoch=None, variables=None)`` runs
after each candidate client's local run, plus once per candidate before
its first run with ``epoch=-1`` and the global model's state (the
pretrain baseline).  ``fedfr_tpu_torch/train.py`` builds both.

With ``runtime.pretrained_root`` it starts from the pretraining outputs
there, as the JAX ``Server`` does (server.py:58-76,125-172): the global
backbone from ``backbone.pth`` (a reference-layout state_dict) or
``backbone.npz`` (a JAX variable tree), the public labels from
``preCos_pretrain_labels.pth``, the global FC from ``fc.pth`` unless
``fed.init_fc`` asks for the mean-embedding init, and with ``fed.init_fc``
the clients' local FCs from the ``preCos_init_AN.pth`` cache (every
client's rows stacked in client order).  A missing file falls back to what
the JAX ``Server`` does without it.

The round's phases are timed under the JAX package's span names in
``self.timer`` (a ``utils/profiling.SpanTimer`` shared with the clients,
synchronizing the card at each span's end): ``phase/public_embed`` and
``phase/aggregate`` here, ``phase/mining``, ``phase/contrastive_cache`` and
``phase/local_train`` in the clients; the CLI adds its own.

Every switch of the JAX sequential ``train_round`` is here: the joint
public-data objective with feature or FC-row mining and the MOON term
recomputed or cached, the plain objective (``fed.add_pretrained_data``
off), and SpreadOut after the aggregation.  Not ported yet (ROADMAP queue
A): the client-parallel and lockstep rounds.
"""

from __future__ import annotations

import copy
import logging
import os
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..config import FedFRConfig
from ..data.datasets import AllClientData
from ..models import BCEModule, build_backbone
from ..parallel.fedavg import (fedavg_on_fc, spreadout, spreadout_loss,
                               streaming_weighted_average)
from ..utils.checkpoint import load_backbone_state, load_pth
from ..utils.device import resolve_device
from ..utils.profiling import SpanTimer
from .client import Client
from .embed import class_mean_features, embed_dataset
from .trainer import branch_step_for, make_plain_train_step, use_cached_contrastive

logger = logging.getLogger("fedfr_tpu_torch.server")


def _host_state(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu() for k, v in state.items()}


class Server:
    def __init__(self, cfg: FedFRConfig, data: AllClientData,
                 eval_callback: Optional[Callable] = None,
                 local_eval_callback: Optional[Callable] = None):
        self.cfg = cfg
        self.data = data
        self.device = resolve_device(cfg.runtime.device)
        self.eval_callback = eval_callback
        self.local_eval_callback = local_eval_callback
        self.rng = np.random.default_rng(cfg.runtime.seed)

        # the global model, frozen: mining, the public embed and the MOON
        # "global" term read it; aggregation writes it
        net = build_backbone(cfg.model.network, cfg.model.embedding_size,
                             cfg.model.bf16, cfg.data.image_size,
                             generator=torch.Generator().manual_seed(cfg.runtime.seed),
                             dropout=cfg.model.dropout,
                             freeze_bn=cfg.model.freeze_bn)
        path = self._pretrained("backbone.pth") or self._pretrained("backbone.npz")
        if path:
            net.load_state_dict(load_backbone_state(cfg.model.network, path))
            logger.info("loaded pretrained backbone from %s", path)
        else:
            logger.info("train from scratch")
        self.global_net = net.to(self.device).eval().requires_grad_(False)
        # work modules every client's local run loads its weights into
        self.backbone = copy.deepcopy(self.global_net).requires_grad_(True)
        self.last_net = copy.deepcopy(self.global_net)
        self.bce_module = BCEModule(cfg.model.embedding_size,
                                    data.train_class_sizes[0],
                                    cfg.model.converter_layers,
                                    m=cfg.loss.bce_margin, r=cfg.loss.bce_scale,
                                    t=cfg.loss.bce_t).to(self.device)

        self.timer = SpanTimer(self.device)  # per-phase round breakdown
        self.clients: List[Client] = [
            Client(cid, cfg, data.client(cid), self.backbone, self.bce_module,
                   last_net=self.last_net, device=self.device)
            for cid in range(cfg.data.num_clients)]
        for c in self.clients:
            c.timer = self.timer

        # clients sampled for per-round local verification (server.py:107);
        # drawn here as in the JAX package so the sampling stream matches
        self.local_candidates = sorted(
            self.rng.permutation(cfg.data.num_clients)[
                : cfg.fed.num_local_eval_clients].tolist())

        self.local_epoch = cfg.fed.local_epochs
        self.train_decay = cfg.optim.train_decay
        self.global_round = 0
        self.global_epoch = 0
        self.current_client_list: List[int] = []

        # pretrained (public) FC + labels
        self.pretrained_fc: Optional[torch.Tensor] = None
        self.pretrained_labels: Optional[np.ndarray] = None
        if cfg.fed.add_pretrained_data:
            self._init_pretrain_fc()
        if cfg.fed.init_fc:
            self.initialize_local_fcs()
        if cfg.fed.bce_local:
            for c in self.clients:
                c.init_bce_from_fc()
        self._branch_step = None
        self._plain_step = None

    def _pretrained(self, name: str) -> str:
        """``<pretrained_root>/<name>`` if there is such a file, else ''."""
        root = self.cfg.runtime.pretrained_root
        path = os.path.join(root, name) if root else ""
        return path if path and os.path.exists(path) else ""

    def _embed(self, dataset, batch_size: int, l2norm: bool):
        return embed_dataset(self.global_net, dataset, batch_size,
                             l2norm=l2norm, device=self.device,
                             num_workers=self.cfg.data.num_workers,
                             prefetch=self.cfg.data.prefetch)

    # ------------------------------------------------------------- FC init

    def _init_pretrain_fc(self) -> None:
        """The public labels and the global FC: from ``pretrained_root``
        where it has them (``fc.pth`` only without ``fed.init_fc``), else
        the public set's labels and the mean-embedding init over it
        (server.py:182-240)."""
        path = self._pretrained("preCos_pretrain_labels.pth")
        if path:
            self.pretrained_labels = load_pth(path).numpy().astype(np.int64)
            logger.info("loaded pretrain labels %s", self.pretrained_labels.shape)
        else:
            self.pretrained_labels = self.data.public_dataset.all_labels().astype(np.int64)
        path = self._pretrained("fc.pth")
        if path and not self.cfg.fed.init_fc:
            self.pretrained_fc = load_pth(path).float().to(self.device)
            logger.info("loaded pretrained perfect FC %s",
                        tuple(self.pretrained_fc.shape))
            return
        feats, labels = self._embed(self.data.public_dataset,
                                    self.cfg.data.public_batch_size, l2norm=False)
        self.pretrained_fc = class_mean_features(feats, labels,
                                                 int(labels.max()) + 1)
        logger.info("generated pretrain FC %s", tuple(self.pretrained_fc.shape))

    def initialize_local_fcs(self) -> None:
        """Every client's local FC (server.py:157-180): the rows of the
        ``preCos_init_AN.pth`` cache in ``pretrained_root``, split across
        the clients in order, or else the mean-embedding init."""
        path = self._pretrained("preCos_init_AN.pth")
        if path:
            init = load_pth(path).float()
            logger.info("preload clients FC init %s", tuple(init.shape))
            start = 0
            for c in self.clients:
                c.fc_local = init[start:start + c.num_classes].to(self.device)
                start += c.num_classes
            return
        for c in self.clients:
            c.init_fc_from_means(self.global_net)
            logger.info("client %d FC initialized", c.cid)

    # ------------------------------------------------------------ rounds

    def generate_public_features(self) -> torch.Tensor:
        """Per-round embed of the whole public set for HN mining
        (server.py:242-263); the features stay on the device.  Mining is
        their only reader, so on the card they are cast to bf16 once per
        round, not once per client: at a width that is a multiple of 64
        (the reference 512) that is the mining kernel's layout, which it
        reads without a copy.  On the CPU they stay fp32."""
        with self.timer.span("phase/public_embed"):
            feats, _ = self._embed(self.data.public_dataset,
                                   self.cfg.data.public_batch_size, l2norm=True)
            if feats.is_cuda:
                feats = feats.to(torch.bfloat16)
        logger.info("round %d: public features %s embedded", self.global_round,
                    tuple(feats.shape))
        return feats

    def sample_clients(self) -> List[int]:
        n = self.cfg.data.num_clients
        k = int(round(self.cfg.fed.client_sampled_ratio * n))
        return sorted(self.rng.choice(n, size=k, replace=False).tolist())

    def _check_uniform_classes(self) -> None:
        """The shared branch step bakes ``num_local`` from client 0 (the
        reweight split of local vs global logit columns depends on it); a
        client with another local class count would split at the wrong
        boundary.  The reference assumes uniform 100-ID clients."""
        counts = {c.num_classes for c in self.clients}
        if len(counts) > 1:
            raise ValueError(
                f"clients have ragged local class counts {sorted(counts)}; "
                f"the joint branch objective requires uniform shards "
                f"(reference split_FL.py relabels every client 0..99)")

    def train_round(self) -> Dict[str, float]:
        """One sequential round (JAX server.py:312-414): the public embed
        where feature mining reads it, each sampled client's local run of
        the joint or the plain objective, FedAvg, the global FC's FedAvg
        under ``return_all`` and SpreadOut under ``fed.spreadout``."""
        cfg = self.cfg
        if not self.current_client_list:
            self.current_client_list = self.sample_clients()
        public_feats = None
        if cfg.fed.add_pretrained_data and cfg.fed.hn_strategy != "fc":
            # FC-row mining reads no image features: no public embed then
            public_feats = self.generate_public_features()

        # adaptive local-epoch schedule (server.py:278-280)
        if cfg.fed.adaptive_local_epoch and self.global_round != 0:
            self.local_epoch = max(4, self.local_epoch - 2)
            self.train_decay = max(1, int(3 / 4 * self.local_epoch))

        if cfg.fed.add_pretrained_data:
            self._check_uniform_classes()
            if self._branch_step is None:
                self._branch_step = branch_step_for(
                    cfg, self.clients[0].num_classes, use_cached_contrastive(cfg))
        elif self._plain_step is None:
            # no reweighting: the reference applies reweight_cosface only in
            # the public-data branch (client.py:269-285)
            self._plain_step = make_plain_train_step(
                margin=cfg.loss.loss, s=cfg.loss.margin_s, m=cfg.loss.margin_m)

        models, fcs, sizes, losses = [], [], [], []
        for pos, cid in enumerate(self.current_client_list):
            client = self.clients[cid]
            logger.info("round %d [%d/%d] client %d training", self.global_round,
                        pos + 1, len(self.current_client_list), cid)
            if (self.local_eval_callback is not None and self.global_round == 0
                    and cid in self.local_candidates):
                # pretrain baseline entry, epoch -1 (client.py:331-333): the
                # client has no trained state yet, so the global model
                self.local_eval_callback(self, client, epoch=-1,
                                         variables=self.global_net.state_dict())
            if cfg.fed.add_pretrained_data:
                stats = client.train_with_public_data(
                    self.global_net, self.data.public_dataset, self.pretrained_fc,
                    public_feats, self.pretrained_labels, self.local_epoch,
                    self.train_decay, step_fn=self._branch_step,
                    round_seed=self.global_round)
            else:
                stats = client.train(self.global_net, self.local_epoch, cfg.optim.lr,
                                     step_fn=self._plain_step,
                                     round_seed=self.global_round)
            losses.append(stats["loss"])
            sizes.append(stats["dataset_size"])
            models.append(client.trained_backbone)
            if cfg.fed.return_all and client.global_fc is not None:
                fcs.append(client.global_fc)
            if self.local_eval_callback is not None and cid in self.local_candidates:
                self.local_eval_callback(self, client)

        logger.info("round %d avg client loss %.5f", self.global_round,
                    float(np.mean(losses)))
        with self.timer.span("phase/aggregate"):
            # FedAvg over every state entry, BN stats included (server.py:322-338)
            self.global_net.load_state_dict(streaming_weighted_average(models, sizes))
            if cfg.fed.return_all and fcs:
                self.pretrained_fc = fedavg_on_fc(self.pretrained_fc,
                                                  torch.stack(fcs), sizes, p=1.0)
            if cfg.fed.spreadout:
                self.spread_out()
        return {"avg_loss": float(np.mean(losses))}

    def spread_out(self) -> None:
        """SpreadOut over the sampled clients' local FCs (server.py:340-371):
        their rows concatenated in client order, ``spreadout`` at 10x the
        base lr, split back.  Logs the objective before and after."""
        cfg = self.cfg
        clients = [self.clients[cid] for cid in self.current_client_list]
        fc_all = torch.cat([c.fc_local for c in clients])
        out = spreadout(fc_all, margin=cfg.fed.spreadout_margin,
                        iters=cfg.fed.spreadout_iters, lr=cfg.optim.lr * 10,
                        momentum=cfg.optim.momentum,
                        weight_decay=cfg.optim.weight_decay,
                        mode=cfg.fed.spreadout_mode)
        # the objective in fp64, so that a small drop is not lost in the
        # fp32 sum over N(N-1) pairs
        logger.info("round %d spreadout over %d rows: objective %.9e -> %.9e",
                    self.global_round, fc_all.shape[0],
                    *(float(spreadout_loss(fc.double(), cfg.fed.spreadout_margin,
                                           cfg.fed.spreadout_mode))
                      for fc in (fc_all, out)))
        start = 0
        for c in clients:
            c.fc_local = out[start:start + c.num_classes]
            start += c.num_classes

    def advance_round(self) -> None:
        """Counter bookkeeping after a round (reference train.py:87-88); clears
        the round's client sample so the next round draws a fresh one."""
        self.global_epoch += self.local_epoch
        self.global_round += 1
        self.current_client_list = []

    # --------------------------------------------------------- checkpoints

    def save_round_checkpoint(self, output_dir: str) -> str:
        """The round's global backbone as ``backbone_<round>.pth``: a
        ``torch.save`` of its state_dict (reference key layout), on the CPU."""
        os.makedirs(output_dir, exist_ok=True)
        path = os.path.join(output_dir, f"backbone_{self.global_round}.pth")
        torch.save(_host_state(self.global_net.state_dict()), path)
        return path

    def save_client_checkpoints(self, output_dir: str) -> None:
        """``clients/client_<c>/backbone.pth`` and ``bce_module.pth`` of every
        client trained in this process (reference client.py:484-495)."""
        for c in self.clients:
            if c.trained_backbone is None:
                continue
            cdir = os.path.join(output_dir, "clients", f"client_{c.cid}")
            os.makedirs(cdir, exist_ok=True)
            torch.save(_host_state(c.trained_backbone),
                       os.path.join(cdir, "backbone.pth"))
            if c.bce_state is not None:
                torch.save(_host_state(c.bce_state),
                           os.path.join(cdir, "bce_module.pth"))

    def test(self) -> Optional[Dict]:
        """The round's evaluation: whatever ``eval_callback`` returns, or
        None without one."""
        if self.eval_callback is not None:
            return self.eval_callback(self)
        return None
