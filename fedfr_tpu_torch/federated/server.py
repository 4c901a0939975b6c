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
off), and SpreadOut after the aggregation.

``train_round_parallel(mesh)`` is the JAX ``Server.train_round_parallel``
(server.py:416-728): the sampled clients in groups of K = ``fed.lockstep``
x the mesh's ``client`` axis (the lockstep clamped to the sample), device
d of the axis holding members [d*L, (d+1)*L) of a group in a stacked state
of its own (its own replicas of the global and last-round models and its
own stacked step, ``parallel/client_parallel.py``), every device's step
dispatched in turn from this one process; both objectives and the cached
MOON step.  Without a mesh it is one device.  A client whose epoch is
shorter than the group's longest wraps around its reshuffled loader, as
in the JAX package; with equal epochs the round equals the sequential one.

``devices`` (default: every visible GPU of a run on the card, else the
CPU) is the run's device list: every embed runs over its ``data`` axis
(``self.data_mesh``) and every span ends with all of them synchronized.
Mining, aggregation and the clients' state between rounds stay on
``self.device``.
"""

from __future__ import annotations

import contextlib
import copy
import logging
import os
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..config import FedFRConfig
from ..data.datasets import AllClientData
from ..data.pipeline import prefetched, to_device_batch
from ..models import BCEModule, build_backbone
from ..models.iresnet import draw_dropout_keep
from ..parallel import client_parallel as cp
from ..parallel.fedavg import (fedavg_on_fc, spreadout, spreadout_loss, stack_trees,
                               streaming_weighted_average)
from ..parallel.mesh import Mesh, as_device, data_mesh, make_mesh, visible_devices
from ..utils.checkpoint import load_backbone_state, load_pth
from ..utils.device import resolve_device
from ..utils.optim import step_lr
from ..utils.profiling import SpanTimer
from .client import Client, _detached
from .embed import class_mean_features, embed_dataset
from .trainer import (branch_objective_kwargs, branch_step_for, make_plain_train_step,
                      use_cached_contrastive)

logger = logging.getLogger("fedfr_tpu_torch.server")


def _host_state(state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu() for k, v in state.items()}


def _to(state: Optional[Dict[str, torch.Tensor]], device) -> Optional[Dict[str, torch.Tensor]]:
    return None if state is None else {k: v.to(device) for k, v in state.items()}


class Server:
    def __init__(self, cfg: FedFRConfig, data: AllClientData,
                 eval_callback: Optional[Callable] = None,
                 local_eval_callback: Optional[Callable] = None,
                 devices: Optional[List] = None):
        self.cfg = cfg
        self.data = data
        self.device = resolve_device(cfg.runtime.device)
        self.devices = [as_device(d) for d in (devices if devices
                                               else visible_devices(self.device))]
        self.data_mesh = data_mesh(devices=self.devices)
        self.eval_callback = eval_callback
        self.local_eval_callback = local_eval_callback
        self.rng = np.random.default_rng(cfg.runtime.seed)

        # the global model, frozen: mining, the public embed and the MOON
        # "global" term read it; aggregation writes it
        net = build_backbone(cfg.model.network, cfg.model.embedding_size,
                             cfg.model.bf16, cfg.data.image_size,
                             generator=torch.Generator().manual_seed(cfg.runtime.seed),
                             dropout=cfg.model.dropout,
                             freeze_bn=cfg.model.freeze_bn,
                             remat=cfg.model.remat_blocks)
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

        self.timer = SpanTimer(self.devices)  # per-phase round breakdown
        self.clients: List[Client] = [
            Client(cid, cfg, data.client(cid), self.backbone, self.bce_module,
                   last_net=self.last_net, device=self.device, mesh=self.data_mesh)
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
        self._parallel_step = None
        self._parallel_plain_step = None
        self._group_nets: Dict[tuple, torch.nn.Module] = {}
        self._lockstep_warned = False

    def _pretrained(self, name: str) -> str:
        """``<pretrained_root>/<name>`` if there is such a file, else ''."""
        root = self.cfg.runtime.pretrained_root
        path = os.path.join(root, name) if root else ""
        return path if path and os.path.exists(path) else ""

    def _embed(self, dataset, batch_size: int, l2norm: bool):
        return embed_dataset(self.global_net, dataset, batch_size,
                             l2norm=l2norm, device=self.device,
                             num_workers=self.cfg.data.num_workers,
                             prefetch=self.cfg.data.prefetch, mesh=self.data_mesh)

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
        self._round_start()
        public_feats = None
        if cfg.fed.add_pretrained_data and cfg.fed.hn_strategy != "fc":
            # FC-row mining reads no image features: no public embed then
            public_feats = self.generate_public_features()

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
        self._aggregate(models, fcs, sizes)
        return {"avg_loss": float(np.mean(losses))}

    def _aggregate(self, models, fcs, sizes) -> None:
        """The round's end: FedAvg over every state entry, BN stats included
        (server.py:322-338), the global FC's FedAvg under ``return_all`` and
        SpreadOut under ``fed.spreadout``."""
        cfg = self.cfg
        with self.timer.span("phase/aggregate"):
            self.global_net.load_state_dict(streaming_weighted_average(models, sizes))
            if cfg.fed.return_all and fcs:
                self.pretrained_fc = fedavg_on_fc(self.pretrained_fc,
                                                  torch.stack(fcs), sizes, p=1.0)
            if cfg.fed.spreadout:
                self.spread_out()

    # ----------------------------------------------------- lockstep rounds

    def _client_mesh(self, mesh: Optional[Mesh]) -> Mesh:
        """``mesh``, or one client-axis slot on ``self.device`` without
        one.  A member trains on one device, so a mesh whose ``data`` or
        ``model`` axis holds more than one device is refused."""
        if mesh is None:
            return make_mesh((1, 1, 1), [self.device])
        if mesh.shape["data"] > 1 or mesh.shape["model"] > 1:
            raise ValueError(f"the client-parallel round places each member on one "
                             f"device; mesh {mesh.shape} splits a member over its "
                             f"data or model axis")
        return mesh

    def _lockstep_group_size(self, mesh: Optional[Mesh] = None) -> int:
        """Clients per lockstep group (JAX server.py:289-310): the client
        axis's size (1 without a mesh) x ``fed.lockstep``, the lockstep
        clamped so that one group never exceeds the sampled count (an
        oversized one would burn the excess slots on padded duplicate
        compute every round); warns once a run."""
        axis = self._client_mesh(mesh).shape["client"]
        lockstep = max(1, self.cfg.fed.lockstep)
        n = max(1, len(self.current_client_list))
        max_useful = -(-n // axis)  # the smallest lockstep covering n
        if lockstep > max_useful:
            log = logger.debug if self._lockstep_warned else logger.warning
            self._lockstep_warned = True
            log("lockstep %d oversized for %d sampled clients on a %d-wide "
                "client axis (padded duplicate compute); clamping to %d",
                lockstep, n, axis, max_useful)
            lockstep = max_useful
        return axis * lockstep

    def _group_net(self, role: str, k: int, slot: int = 0,
                   device: Optional[torch.device] = None) -> torch.nn.Module:
        """Client-axis slot ``slot``'s K-client stacked copy of the work
        backbone (``train``) or of the last-round model's module
        (``last``) on ``device`` (default ``self.device``), built once a
        run (two slots on one device each have their own)."""
        key = (role, k, slot)
        if key not in self._group_nets:
            module = self.backbone if role == "train" else self.last_net
            self._group_nets[key] = cp.stack_module(module, k).to(
                self.device if device is None else device)
        return self._group_nets[key]

    @staticmethod
    def _stack_slots(parts: list, pad: int, mesh: Mesh) -> list:
        """Per-client state_dicts or tensors of a group's real members, pad
        slots repeating member 0 (their results are discarded after the
        run), stacked and split over the client axis
        (``shard_stacked_tree``): slot d holds members [d*L, (d+1)*L) on
        its device."""
        parts = list(parts) + [parts[0]] * pad
        if isinstance(parts[0], dict):
            return cp.shard_stacked_tree(mesh, stack_trees(parts))
        return [s["t"] for s in cp.shard_stacked_tree(mesh, {"t": torch.stack(parts)})]

    def _group_draws(self, group: List[int], pad: int, step_no: int, imgs, gens: list):
        """One dispatch's flip masks and, with dropout, keep masks, one (B,)
        and one (B, D) tensor a slot on the slot's device (``imgs[k]``,
        member k's batch, gives both): each real member draws from its own
        generators (the JAX ``_group_keys``) as its sequential run would; a
        pad slot repeats slot 0's masks and draws nothing."""
        flips = [self.clients[cid].draw_flip(step_no, imgs[k], gens[k][0])
                 for k, cid in enumerate(group)]
        flips += [flips[0].to(imgs[k].device) for k in range(len(group), len(group) + pad)]
        keeps = None
        if self.cfg.model.dropout > 0:
            shape = (imgs[0].shape[0], self.backbone.fc.in_features)
            keeps = [draw_dropout_keep(shape, self.cfg.model.dropout, g[1], imgs[k].device)
                     for k, g in enumerate(gens)]
            keeps += [keeps[0].to(imgs[k].device)
                      for k in range(len(group), len(group) + pad)]
        return flips, keeps

    @staticmethod
    def _slot_draws(flips: list, keeps: Optional[list], d: int, step: int):
        """Slot ``d``'s stacked (L, B) flips and (L*B, D) keep masks."""
        sl = slice(d * step, (d + 1) * step)
        return torch.stack(flips[sl]), (torch.cat(keeps[sl]) if keeps else None)

    @contextlib.contextmanager
    def _group_feed(self, group: List[int], loaders: list, pad: int,
                    batch_size: int, devices: List[torch.device],
                    with_positions: bool = False):
        """The device batch feed of one lockstep group (JAX server.py:232-274):
        per-client iterators in lockstep, each wrapping around its loader
        (a fresh shuffle every pass) so that every member yields the group's
        ``local_epoch x`` longest-epoch steps, pad slots repeating slot 0's
        batch, an empty-loader guard (an empty loader would never yield),
        and the feed and loaders shut down on every exit path.  Yields
        (feed, steps per epoch); each item of the feed holds, for each
        client-axis slot of ``devices``, its L members' stacked (L, B, ...)
        batch on its device (JAX ``batch_shard``)."""
        try:
            if min(len(l) for l in loaders) == 0:
                empty = [cid for cid, l in zip(group, loaders) if len(l) == 0]
                raise ValueError(f"clients {empty}: dataset smaller than the "
                                 f"batch size {batch_size}")
            steps_per_epoch = max(len(l) for l in loaders)
            step = (len(group) + pad) // len(devices)

            def cycling(loader):
                while True:
                    yield from loader.epoch(with_positions=with_positions)

            iters = [cycling(l) for l in loaders]

            def device_batches():
                for _ in range(self.local_epoch * steps_per_epoch):
                    batches = [next(it) for it in iters]
                    batches += [batches[0]] * pad
                    yield [to_device_batch(cp.stack_client_batches(
                        batches[d * step:(d + 1) * step]), dev)
                        for d, dev in enumerate(devices)]

            feed = prefetched(device_batches(), depth=max(1, self.cfg.data.prefetch))
            try:
                yield feed, steps_per_epoch
            finally:
                feed.close()  # joins the producer even on error
        finally:
            for l in loaders:
                l.close()

    def _round_start(self) -> None:
        """What every round path does first: the client sample (unless the
        caller drew it) and the adaptive local-epoch schedule
        (server.py:278-280)."""
        cfg = self.cfg
        if not self.current_client_list:
            self.current_client_list = self.sample_clients()
        if cfg.fed.adaptive_local_epoch and self.global_round != 0:
            self.local_epoch = max(4, self.local_epoch - 2)
            self.train_decay = max(1, int(3 / 4 * self.local_epoch))

    def _baselines(self, todo: List[int]) -> None:
        """The candidates' pretrain baseline entries, epoch -1, before any
        group trains (client.py:331-333)."""
        if self.local_eval_callback is not None and self.global_round == 0:
            for cid in todo:
                if cid in self.local_candidates:
                    self.local_eval_callback(self, self.clients[cid], epoch=-1,
                                             variables=self.global_net.state_dict())

    def _slot_members(self, states: list, n_real: int) -> list:
        """The real members' trained (backbone, fc, bce) out of each slot's
        stacked state, in member order, copied to ``self.device`` (where
        the clients keep their state and FedAvg runs)."""
        out = []
        for state in states:
            n = min(n_real - len(out), state.fc.shape[0])
            if n > 0:
                out += [(_to(b, self.device), fc.to(self.device), _to(bce, self.device))
                        for b, fc, bce in cp.group_client_states(state, n)]
        return out

    def train_round_parallel(self, mesh: Optional[Mesh] = None) -> Dict[str, float]:
        """One round with the sampled clients trained K at a time in lockstep
        over ``mesh``'s client axis (JAX server.py:416-632): per group, each
        real member's mining and starting state (and under
        ``use_cached_contrastive`` its frozen feature caches, built over the
        data mesh and copied to its slot's device), taken out of the shared
        work modules before the next member's preparation; then
        ``local_epoch`` x the longest member's steps, each a stacked step on
        every slot's device; then each member's trained state, its local
        eval, and FedAvg as the sequential round.  The plain objective goes
        to ``_train_round_parallel_plain``."""
        cfg = self.cfg
        if not cfg.fed.add_pretrained_data:
            return self._train_round_parallel_plain(mesh)
        self._round_start()
        public_feats = None
        if cfg.fed.hn_strategy != "fc":
            # FC-row mining reads no image features: no public embed then
            public_feats = self.generate_public_features()
        mesh = self._client_mesh(mesh)
        devs = cp.client_sharding(mesh)
        K = self._lockstep_group_size(mesh)
        L = K // len(devs)
        self._check_uniform_classes()
        use_cache = use_cached_contrastive(cfg)
        if self._parallel_step is None:
            self._parallel_step = cp.make_parallel_branch_step(
                self.backbone, self.bce_module, cached_contrastive=use_cache,
                **branch_objective_kwargs(cfg, self.clients[0].num_classes))
        step_fn = self._parallel_step
        nets = [self._group_net("train", L, d, dev) for d, dev in enumerate(devs)]
        last_nets = None
        if cfg.fed.contrastive and not use_cache:
            last_nets = [self._group_net("last", L, d, dev).eval()
                         for d, dev in enumerate(devs)]
        # the global model on every slot's device, this round's weights
        global_nets = mesh.replicas(self.global_net, "client")

        models, fcs, sizes, losses = [], [], [], []
        todo = list(self.current_client_list)
        self._baselines(todo)
        for g0 in range(0, len(todo), K):
            group = todo[g0:g0 + K]
            pad = K - len(group)
            slot_dev = [devs[k // L] for k in range(K)]
            # prepare only the REAL members (a pad reusing client 0's
            # preparation would rerun its mining and advance its loader)
            loaders, backbones, fc_rows, bces, lasts, caches = [], [], [], [], [], []
            for k, cid in enumerate(group):
                client = self.clients[cid]
                combined, loader, state, member_last = client.prepare_local_run(
                    self.global_net, self.data.public_dataset, self.pretrained_fc,
                    public_feats, self.pretrained_labels, round_seed=self.global_round)
                loaders.append(loader)
                # the work modules hold this member's starting state only
                # until the next member's preparation: take it out now
                backbones.append(_detached(state.backbone))
                fc_rows.append(state.fc.detach().clone())
                bces.append(_detached(state.bce) if state.bce is not None else None)
                if use_cache:
                    with self.timer.span("phase/contrastive_cache"):
                        # built over the data mesh, kept on the member's
                        # device only: the group cache is never assembled
                        caches.append([c.to(slot_dev[k]) for c in client.build_flip_caches(
                            self.global_net, member_last, combined)])
                elif last_nets is not None:
                    lasts.append(_detached(member_last))
            states = []
            for net, backbone in zip(nets, self._stack_slots(backbones, pad, mesh)):
                net.load_state_dict(backbone)
            for d, (fc, bce) in enumerate(zip(
                    self._stack_slots(fc_rows, pad, mesh),
                    self._stack_slots(bces, pad, mesh) if bces[0] is not None
                    else [None] * len(devs))):
                states.append(cp.init_group_state(nets[d], fc, bce, cfg.optim.lr,
                                                  cfg.optim.momentum, cfg.optim.weight_decay))
            del backbones, fc_rows, bces
            if use_cache:
                # (L, nmax, 2, E) a slot: its members' caches zero-padded to
                # the slot's longest (gathers never reach pad rows)
                g_stacked, l_stacked = [], []
                for d, dev in enumerate(devs):
                    pairs = [caches[k] if k < len(group) else caches[0]
                             for k in range(d * L, (d + 1) * L)]
                    nmax = max(c.shape[0] for pair in pairs for c in pair)
                    g_stacked.append(torch.stack([torch.nn.functional.pad(
                        p[0], (0, 0, 0, 0, 0, nmax - p[0].shape[0])).to(dev) for p in pairs]))
                    l_stacked.append(torch.stack([torch.nn.functional.pad(
                        p[1], (0, 0, 0, 0, 0, nmax - p[1].shape[0])).to(dev) for p in pairs]))
                del caches
            elif last_nets is not None:
                for net, last in zip(last_nets, self._stack_slots(lasts, pad, mesh)):
                    net.load_state_dict(last)
                del lasts
            gens = [self.clients[cid].generators(self.global_round, slot_dev[k])
                    for k, cid in enumerate(group)]

            accs = [torch.zeros(L, 4, device=dev) for dev in devs]
            step_no = 0
            with self._group_feed(group, loaders, pad, cfg.data.combined_batch_size,
                                  devs, with_positions=use_cache) as (feed, steps_per_epoch):
                with self.timer.span("phase/local_train"):
                    for epoch in range(self.local_epoch):
                        lr = step_lr(cfg.optim.lr, epoch, self.train_decay,
                                     cfg.optim.lr_gamma)
                        for _ in range(steps_per_epoch):
                            slots = next(feed)
                            flips, keeps = self._group_draws(
                                group, pad, step_no, [x for b in slots for x in b[0]], gens)
                            for d, batch in enumerate(slots):
                                imgs, labels, valid = batch[:3]
                                flip, keep = self._slot_draws(flips, keeps, d, L)
                                if use_cache:
                                    states[d], metrics = step_fn(
                                        states[d], g_stacked[d], l_stacked[d], imgs, labels,
                                        valid, batch[3], lr, flip, dropout_keep=keep)
                                else:
                                    states[d], metrics = step_fn(
                                        states[d], global_nets[d],
                                        None if last_nets is None else last_nets[d],
                                        imgs, labels, valid, lr, flip, dropout_keep=keep)
                                # on-device running sums: the reported loss is
                                # the all-step mean, as on the sequential path
                                accs[d] += torch.stack(metrics, dim=1)
                            step_no += 1
                        logger.info("parallel group %s epoch %d/%d done",
                                    group, epoch + 1, self.local_epoch)
            sums = np.concatenate([a.cpu().numpy() for a in accs])
            if use_cache:
                del g_stacked, l_stacked
            for (backbone, fc, bce), cid, loss_sum in zip(
                    self._slot_members(states, len(group)), group, sums[:, 0]):
                client = self.clients[cid]
                client.keep_local_run(backbone, fc, bce, loss_sum / max(step_no, 1))
                losses.append(client.last_loss)
                sizes.append(client.dataset_size)
                models.append(client.trained_backbone)
                if cfg.fed.return_all and client.global_fc is not None:
                    fcs.append(client.global_fc)
                if self.local_eval_callback is not None and cid in self.local_candidates:
                    self.local_eval_callback(self, client)
            del states

        logger.info("round %d (parallel) avg client loss %.5f",
                    self.global_round, float(np.mean(losses)))
        self._aggregate(models, fcs, sizes)
        return {"avg_loss": float(np.mean(losses))}

    def _train_round_parallel_plain(self, mesh: Optional[Mesh] = None) -> Dict[str, float]:
        """The plain objective's lockstep round (JAX server.py:634-728): the
        same groups, slots, feed and wrap-around over each member's own
        data at ``data.batch_size``, a constant lr, no FC averaging."""
        cfg = self.cfg
        self._round_start()
        mesh = self._client_mesh(mesh)
        devs = cp.client_sharding(mesh)
        K = self._lockstep_group_size(mesh)
        L = K // len(devs)
        if len({self.clients[cid].num_classes
                for cid in self.current_client_list}) > 1:
            raise ValueError("plain client-parallel requires uniform local "
                             "class counts (ragged FC rows cannot stack); "
                             "run sequentially")
        if self._parallel_plain_step is None:
            self._parallel_plain_step = cp.make_parallel_plain_step(
                self.backbone, margin=cfg.loss.loss, s=cfg.loss.margin_s,
                m=cfg.loss.margin_m)
        step_fn = self._parallel_plain_step
        nets = [self._group_net("train", L, d, dev) for d, dev in enumerate(devs)]

        models, sizes, losses = [], [], []
        todo = list(self.current_client_list)
        self._baselines(todo)
        lr = cfg.optim.lr  # constant over the run (client.py:528-530)
        for g0 in range(0, len(todo), K):
            group = todo[g0:g0 + K]
            pad = K - len(group)
            loaders, backbones, fc_rows = [], [], []
            for cid in group:
                loader, state = self.clients[cid].prepare_plain_run(
                    self.global_net, round_seed=self.global_round)
                loaders.append(loader)
                backbones.append(_detached(state.backbone))
                fc_rows.append(state.fc.detach().clone())
            for net, backbone in zip(nets, self._stack_slots(backbones, pad, mesh)):
                net.load_state_dict(backbone)
            states = [cp.init_group_state(net, fc, None, cfg.optim.lr, cfg.optim.momentum,
                                          cfg.optim.weight_decay)
                      for net, fc in zip(nets, self._stack_slots(fc_rows, pad, mesh))]
            del backbones, fc_rows
            gens = [self.clients[cid].generators(self.global_round, devs[k // L])
                    for k, cid in enumerate(group)]

            accs = [torch.zeros(L, device=dev) for dev in devs]
            step_no = 0
            with self._group_feed(group, loaders, pad, cfg.data.batch_size, devs) as (
                    feed, steps_per_epoch):
                with self.timer.span("phase/local_train"):
                    for _ in range(self.local_epoch * steps_per_epoch):
                        slots = next(feed)
                        flips, keeps = self._group_draws(
                            group, pad, step_no, [x for b in slots for x in b[0]], gens)
                        for d, (imgs, labels, valid) in enumerate(slots):
                            flip, keep = self._slot_draws(flips, keeps, d, L)
                            states[d], loss = step_fn(states[d], imgs, labels, valid, lr,
                                                      flip, dropout_keep=keep)
                            accs[d] += loss
                        step_no += 1
            sums = np.concatenate([a.cpu().numpy() for a in accs])
            for (backbone, fc, _), cid, loss_sum in zip(
                    self._slot_members(states, len(group)), group, sums):
                client = self.clients[cid]
                client.keep_plain_run(backbone, fc, float(loss_sum) / max(step_no, 1))
                losses.append(client.last_loss)
                sizes.append(client.dataset_size)
                models.append(client.trained_backbone)
                if self.local_eval_callback is not None and cid in self.local_candidates:
                    self.local_eval_callback(self, client)
            del states

        logger.info("round %d (parallel plain) avg client loss %.5f",
                    self.global_round, float(np.mean(losses)))
        self._aggregate(models, [], sizes)
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
