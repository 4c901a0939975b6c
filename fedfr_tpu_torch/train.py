"""FedFR federated training CLI of the PyTorch port.

The counterpart of the repository's ``train.py``: the same flags, the same
config, and the same round loop (sample, ``train_round``, ``test``, exports,
``advance_round``), with the ``.bin`` verification and the per-client 1:1
eval attached as that CLI attaches them.  run.sh's own command line:

    python -m fedfr_tpu_torch.train --pretrained_root './pretrain' \
        --network 'sphnet' --output_dir './ckpt/FedFR' --loss 'CosFace' \
        --batch_size 64 --num_client 40 --client_sampled_ratio 1.0 \
        --lr 0.001 --total_round 20 --local_epoch 10 --rec_root DATA \
        --val_root VAL --local_rec DATA/local_veri_4000 --fedface \
        --add_pretrained_data --combine_dataset --contrastive_bb \
        --return_all --BCE_local --adaptive_local_epoch

It runs on the GPU (``--device cuda``, the default, raising without one);
``--device cpu`` runs it on the CPU with the kernels' plain versions.

Exports are PyTorch's own: ``backbone_<round>.pth`` (at the
``--round_ckpt_every`` cadence and at the final round), ``backbone.pth``
(the best round on the last ``.bin`` target) and
``clients/client_<c>/{backbone,bce_module}.pth`` (at the
``--client_ckpt_every`` cadence, and once at the end if the cadence missed
the final round), each a ``torch.save`` of a state_dict in the reference
key layout.  A copy of the source goes to ``<output_dir>/code`` at setup.
The resume state goes to ``<output_dir>/rounds/round_<K>.pt`` (+
``.meta.json``) after each round on the ``--round_ckpt_every`` cadence and
after the final round, with the ``.bin`` best table; ``--resume`` starts
from the newest complete one (``utils/checkpoint.py::RoundCheckpointer``;
``--round_ckpt_keep``, ``--round_ckpt_async``, ``--round_ckpt_bg_fetch``).

``--rec_root synth:...`` (and ``--local_rec synth:...``) runs on the
device-generated universe of ``data/synthetic.py``, no data files needed.
After each round training.log gets the phase-span report (``span <name>
total ... calls ... avg ...``: the server's ``phase/*`` spans, cumulative)
and a ``memory: device in_use ... MB peak ... MB | host maxrss ... MB``
line; at the end the CLI's own spans (``train_round``, ``eval``).
``--profile`` writes a ``torch.profiler`` trace of round 0 to
``<output_dir>/torch_trace/trace.json``.
On a host with more than one GPU the run takes every visible GPU
(``CUDA_VISIBLE_DEVICES`` limits them), as the JAX CLI takes every device:
each embed runs over all of them (the data axis), each client's 1:1 ROC
splits its rows over them, and the clients train over them
(``Server.train_round_parallel`` on ``make_mesh()``, every device on the
client axis; training.log says "client-parallel training over N devices
x lockstep L"), one process driving every card.  ``--lockstep L`` (L > 1)
stacks L clients a device, one stacked step a dispatch, also on one card;
``--remat`` checkpoints the backbone's residual blocks (their activations
recomputed in the backward), in either round.  The memory line then reads
each device's in-use and peak MB.
"""

from __future__ import annotations

import argparse
import copy
import logging
import os
import resource
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import torch

from .config import FedFRConfig
from .data.datasets import AllClientData
from .evalsuite.local_eval import LocalVerificationCallback
from .evalsuite.verification import BinVerificationCallback
from .federated.server import Server
from .parallel.mesh import Mesh, as_device, make_mesh, visible_devices
from .utils.checkpoint import RoundCheckpointer
from .utils.device import resolve_device
from .utils.logging import init_logging
from .utils.profiling import SpanTimer, torch_trace
from .utils.snapshot import snapshot_source


def build_parser() -> argparse.ArgumentParser:
    """Every flag of the repository's train.py, plus ``--device``."""
    p = argparse.ArgumentParser(description="FedFR training, PyTorch port")
    p.add_argument("--network", type=str, default="sphnet")
    p.add_argument("--loss", type=str, default="CosFace")
    p.add_argument("--output_dir", default="./ckpt/FL_FedFR")
    p.add_argument("--batch_size", default=64, type=int)
    p.add_argument("--com_batch_size", default=256, type=int)
    p.add_argument("--public_batch_size", default=512, type=int)
    p.add_argument("--eval_batch_size", default=512, type=int)
    p.add_argument("--local_epoch", default=1, type=int)
    p.add_argument("--total_round", default=16, type=int)
    p.add_argument("--num_client", default=10, type=int)
    p.add_argument("--num_ids", default=4000, type=int)
    p.add_argument("--client_sampled_ratio", default=1.0, type=float)
    p.add_argument("--pretrained_root", default="",
                   help="pretraining outputs: backbone.pth/.npz, fc.pth, "
                        "preCos_pretrain_labels.pth, preCos_init_AN.pth")
    p.add_argument("--lr", type=float, default=0.1)
    p.add_argument("--aggr_alg", default="FedAvg")
    p.add_argument("--spreadout", action="store_true")
    p.add_argument("--init_fc", action="store_true")
    p.add_argument("--add_pretrained_data", action="store_true",
                   help="the joint public-data objective (else the plain "
                        "objective over each client's own data)")
    p.add_argument("--contrastive_bb", action="store_true")
    p.add_argument("--cache_contrastive", action="store_true",
                   help="embed the frozen MOON models' features once per "
                        "(client, round) and gather them per step in place "
                        "of two frozen forwards (same arithmetic)")
    p.add_argument("--lockstep", type=int, default=1,
                   help="clients trained together in lockstep, one stacked "
                        "step a dispatch (1: the sequential round)")
    p.add_argument("--return_all", action="store_true")
    p.add_argument("--combine_dataset", action="store_true")
    p.add_argument("--BCE_local", action="store_true")
    p.add_argument("--BCE_detach", action="store_true")
    p.add_argument("--adaptive_local_epoch", action="store_true")
    p.add_argument("--reweight_cosface", action="store_true")
    p.add_argument("--hn_strategy", default="feature", choices=["feature", "fc"],
                   help="hard-negative mining: image features, or FC rows")
    p.add_argument("--HN_threshold", default=0.4, type=float,
                   help="feature-mining cosine threshold (config.py:28)")
    p.add_argument("--HN_cap", default=0, type=int,
                   help="cap the mined set at the N hardest public images "
                        "(0 = uncapped reference semantics)")
    p.add_argument("--rec_root", default="", help="dataset root")
    p.add_argument("--val_root", default="", help=".bin verification dir")
    p.add_argument("--local_rec", default="", help="local_veri_4000 dir")
    p.add_argument("--val_targets", default="agedb_30")
    p.add_argument("--num_workers", default=6, type=int)
    p.add_argument("--no_native_loader", action="store_true",
                   help="decode rec splits on the Python path (codec.decode on "
                        "a thread pool) instead of the native reader")
    p.add_argument("--seed", default=100, type=int)
    p.add_argument("--embedding_size", default=512, type=int)
    p.add_argument("--image_size", default=112, type=int)
    p.add_argument("--resume", action="store_true",
                   help="start from the newest complete round state in "
                        "<output_dir>/rounds")
    p.add_argument("--profile", action="store_true",
                   help="write a torch.profiler trace of the first round to "
                        "<output_dir>/torch_trace")
    p.add_argument("--scan_blocks", action="store_true",
                   help="no effect here: a JAX compile option; the port's "
                        "modules have one layout")
    p.add_argument("--remat", action="store_true",
                   help="checkpoint the residual blocks: recompute their "
                        "activations in the backward (less activation memory)")
    p.add_argument("--freeze_bn", action="store_true",
                   help="iresnet: BatchNorm in inference mode while training")
    p.add_argument("--dropout", type=float, default=0.0,
                   help="backbone dropout before the embedding fc (iresnet "
                        "only, as in the JAX package)")
    p.add_argument("--converter_layer", type=int, default=1,
                   help="BCE transformation layer: 1=linear, else BottleBlock")
    p.add_argument("--device_cache", action="store_true",
                   help="no effect here: the port keeps every state on "
                        "the device")
    p.add_argument("--client_ckpt_every", type=int, default=1,
                   help="save per-client artifacts every N rounds (0 = never)")
    p.add_argument("--round_ckpt_every", type=int, default=1,
                   help="save backbone_%%d.pth and the resume state every N "
                        "rounds (0 = never; the final round always exports)")
    p.add_argument("--round_ckpt_keep", type=int, default=0,
                   help="keep only the newest N resume states (0 = all)")
    p.add_argument("--round_ckpt_async", action="store_true",
                   help="write the resume state in a background thread")
    p.add_argument("--round_ckpt_bg_fetch", action="store_true",
                   help="also copy the resume state to the host in that "
                        "thread (implies --round_ckpt_async)")
    # dead reference flags, accepted as no-ops so verbatim reference
    # commands run (reference train.py:109-123)
    p.add_argument("--fedface", action="store_true", help="no-op (reference dead flag)")
    p.add_argument("--BCE_tune", action="store_true", help="no-op (reference dead flag)")
    p.add_argument("--save_fc_iter", type=int, default=40,
                   help="no-op (reference dead flag)")
    p.add_argument("--lr_step", default="1000", help="no-op (reference dead flag)")
    p.add_argument("--local_rank", type=int, default=0,
                   help="no-op (reference hardcodes rank 0, train.py:42)")
    p.add_argument("--data_ratio", type=float, default=0.5,
                   help="no-op (reference dead flag, never read)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="torch device of the run (cpu: the kernels' plain "
                        "versions)")
    return p


# flags whose path the port does not have yet, each with its ROADMAP item:
# none is left, every flag of the repository's train.py runs
UNPORTED: Dict[str, Callable] = {}


def check_flags(args) -> None:
    """Raise on every flag whose path the port does not have yet."""
    bad = [name for name, on in UNPORTED.items() if on(args)]
    if bad:
        raise NotImplementedError(
            "not ported to the PyTorch package yet: " + ", ".join(bad))


def build_config(args) -> FedFRConfig:
    cfg = FedFRConfig()
    cfg.data.rec_root = args.rec_root
    cfg.data.val_root = args.val_root
    cfg.data.local_veri_dir = args.local_rec
    cfg.data.num_clients = args.num_client
    cfg.data.num_ids = args.num_ids
    cfg.data.batch_size = args.batch_size
    cfg.data.combined_batch_size = args.com_batch_size
    cfg.data.public_batch_size = args.public_batch_size
    cfg.data.eval_batch_size = args.eval_batch_size
    cfg.data.num_workers = args.num_workers
    cfg.data.use_native_loader = not args.no_native_loader
    cfg.model.network = args.network
    cfg.loss.loss = args.loss
    cfg.optim.lr = args.lr
    cfg.fed.total_rounds = args.total_round
    cfg.fed.local_epochs = args.local_epoch
    cfg.fed.client_sampled_ratio = args.client_sampled_ratio
    cfg.fed.spreadout = args.spreadout
    cfg.fed.init_fc = args.init_fc
    cfg.fed.add_pretrained_data = args.add_pretrained_data
    cfg.fed.combine_dataset = args.combine_dataset
    cfg.fed.contrastive = args.contrastive_bb
    cfg.fed.return_all = args.return_all
    cfg.fed.bce_local = args.BCE_local
    cfg.fed.bce_detach = args.BCE_detach
    cfg.fed.adaptive_local_epoch = args.adaptive_local_epoch
    cfg.fed.reweight_cosface = args.reweight_cosface
    cfg.fed.hn_strategy = args.hn_strategy
    cfg.fed.hn_threshold = args.HN_threshold
    cfg.fed.hn_cap = args.HN_cap
    cfg.fed.aggr_alg = args.aggr_alg
    cfg.runtime.output_dir = args.output_dir
    cfg.runtime.pretrained_root = args.pretrained_root
    cfg.runtime.seed = args.seed
    cfg.runtime.device = args.device
    cfg.model.embedding_size = args.embedding_size
    cfg.model.scan_blocks = args.scan_blocks
    cfg.data.image_size = args.image_size
    cfg.model.freeze_bn = args.freeze_bn
    cfg.model.dropout = args.dropout
    cfg.model.remat_blocks = args.remat
    cfg.model.converter_layers = args.converter_layer
    cfg.runtime.device_cache = args.device_cache
    cfg.runtime.client_ckpt_every = args.client_ckpt_every
    cfg.runtime.round_ckpt_every = args.round_ckpt_every
    cfg.runtime.round_ckpt_keep = args.round_ckpt_keep
    cfg.runtime.round_ckpt_async = args.round_ckpt_async
    cfg.runtime.round_ckpt_bg_fetch = args.round_ckpt_bg_fetch
    cfg.fed.cache_contrastive = args.cache_contrastive
    cfg.fed.lockstep = max(1, args.lockstep or 1)
    if args.val_targets:
        cfg.runtime.val_targets = args.val_targets.split(",")
    return cfg


def attach_callbacks(cfg: FedFRConfig, server: Server, data: AllClientData,
                     logger: logging.Logger, spent: Dict[str, float]):
    """Build the ``.bin`` and local 1:1 callbacks and hook them into
    ``server`` as train.py:105-159 does.  Both evaluate in one eval module
    of their own (a copy of the global model and of the BCE module), into
    which they load the state to be evaluated; the modules the clients train
    in are never touched.  The local eval runs in the server's
    ``phase/local_eval`` span and its seconds add up in
    ``spent["local_eval"]``.  Returns (bin callback or None, local callback
    or None)."""
    eval_net = copy.deepcopy(server.global_net)
    eval_bce = copy.deepcopy(server.bce_module).eval().requires_grad_(False)

    bin_cb = None
    if cfg.data.val_root:
        bin_cb = BinVerificationCallback(
            eval_net, cfg.runtime.val_targets, cfg.data.val_root,
            batch_size=cfg.data.eval_batch_size, logger=logger,
            image_size=(cfg.data.image_size, cfg.data.image_size),
            device=server.device, mesh=server.data_mesh)

    local_cb = None
    if cfg.data.local_veri_dir and (data.synthetic_universe is not None
                                    or os.path.exists(cfg.data.local_veri_dir)):
        local_cb = LocalVerificationCallback(
            eval_net, eval_bce, data.veri_dataset(cfg.data.local_veri_dir),
            cfg.runtime.output_dir, batch_size=cfg.data.eval_batch_size,
            device=server.device, num_workers=cfg.data.num_workers,
            prefetch=cfg.data.prefetch, mesh=server.data_mesh)

    def eval_callback(server):
        if bin_cb is None:
            return None
        accs = bin_cb(server.global_round, server.global_net.state_dict())
        if bin_cb.is_best(server.global_round):
            torch.save({k: v.detach().cpu() for k, v in
                        server.global_net.state_dict().items()},
                       os.path.join(cfg.runtime.output_dir, "backbone.pth"))
            logger.info("Save server model, round %d", server.global_round)
        return {"acc": accs}

    def local_eval_callback(server, client, epoch=None, variables=None):
        if local_cb is None:
            return
        if variables is None:
            variables = client.trained_backbone
        if variables is None:
            return
        if epoch is None:
            # last local-epoch index, matching the reference's log numbering
            # (client.py:483 passes the loop-final epoch)
            epoch = server.global_epoch + server.local_epoch - 1
        bce_state = (client.bce_state if client.bce_state is not None
                     and epoch != -1 else None)
        t0 = time.perf_counter()
        with server.timer.span("phase/local_eval"):
            local_cb.veri_test(variables, epoch, client.target_ids, client.cid,
                               bce_state)
        spent["local_eval"] += time.perf_counter() - t0

    server.eval_callback = eval_callback
    server.local_eval_callback = local_eval_callback
    return bin_cb, local_cb


@dataclass
class Training:
    """One CLI run: what ``setup`` builds and ``run_round`` advances."""

    cfg: FedFRConfig
    logger: logging.Logger
    server: Server
    bin_cb: Optional[BinVerificationCallback]
    local_cb: Optional[LocalVerificationCallback]
    spent: Dict[str, float]  # seconds by phase, filled by the callbacks
    ckpt: RoundCheckpointer  # the resume state
    timer: SpanTimer  # the CLI's own spans: train_round, eval
    trace_dir: Optional[str] = None  # --profile: round 0's trace goes here
    mesh: Optional[Mesh] = None  # the rounds run Server.train_round_parallel(mesh)

    @property
    def done(self) -> bool:
        return self.server.global_round >= self.cfg.fed.total_rounds


def setup(args, devices: Optional[List] = None) -> Training:
    """The run's config, logging, data, server, callbacks and resume
    state.  ``devices``: the run's device list (default every visible GPU
    once each, or the CPU under ``--device cpu``; a device may repeat, as
    two shards of one card)."""
    check_flags(args)
    cfg = build_config(args)
    resolve_device(cfg.runtime.device)  # no GPU and no --device cpu: raise now
    devices = [as_device(d) for d in (devices if devices
                                      else visible_devices(cfg.runtime.device))]
    os.makedirs(cfg.runtime.output_dir, exist_ok=True)
    logger = init_logging(cfg.runtime.output_dir)
    logger.info("config: %s", cfg.to_json())
    snapshot_source(cfg.runtime.output_dir)  # reference train.py:50-51
    if args.scan_blocks or args.device_cache:
        logger.info("--scan_blocks and --device_cache have no effect here: "
                    "the port's modules have one layout and its states stay "
                    "on the device")
    data = AllClientData(cfg, include_public=cfg.fed.add_pretrained_data)
    server = Server(cfg, data, devices=devices)
    spent = {"local_eval": 0.0}
    bin_cb, local_cb = attach_callbacks(cfg, server, data, logger, spent)
    logger.info("local veri candidates %s", server.local_candidates)
    ckpt = RoundCheckpointer(os.path.join(cfg.runtime.output_dir, "rounds"),
                             keep=cfg.runtime.round_ckpt_keep,
                             async_write=cfg.runtime.round_ckpt_async,
                             bg_fetch=cfg.runtime.round_ckpt_bg_fetch)
    if args.resume:
        t0 = time.perf_counter()
        if ckpt.latest() is None:
            logger.info("--resume: no complete round state in %s, starting "
                        "at round 0", ckpt.directory)
        else:
            restored = ckpt.restore(server)
            if server.device.type == "cuda":
                torch.cuda.synchronize(server.device)
            logger.info("resumed at round %d (restore %.3f s)", restored,
                        time.perf_counter() - t0)
            # the best table too, so that the first round after the resume
            # cannot pass for the best one and overwrite backbone.pth
            best = ckpt.last_extra.get("best")
            if bin_cb is not None and best and len(best) == len(bin_cb.highest):
                bin_cb.highest = [tuple(b) for b in best]
    # the JAX CLI's client-parallel round (train.py:176-187): every device
    # on the client axis, K = --lockstep x devices clients a group
    mesh = None
    if cfg.fed.client_parallel and (len(devices) > 1 or cfg.fed.lockstep > 1):
        mesh = make_mesh(devices=devices)
        logger.info("client-parallel training over %d devices x lockstep %d "
                    "(%s objective)", mesh.shape["client"], cfg.fed.lockstep,
                    "branch" if cfg.fed.add_pretrained_data else "plain")
    trace_dir = None
    if args.profile:
        trace_dir = os.path.join(cfg.runtime.output_dir, "torch_trace")
        logger.info("profiling first round to %s", trace_dir)
    logger.info("=== Start Federated learning ===")
    return Training(cfg, logger, server, bin_cb, local_cb, spent, ckpt,
                    SpanTimer(server.devices), trace_dir, mesh)


def log_memory(logger: logging.Logger, devices) -> Dict[str, float]:
    """The JAX CLI's per-round memory line (train.py:238-262): each card's
    allocated and peak allocated MB (``torch.cuda``), the host's peak RSS;
    returns the numbers (``device_*`` the first device's, ``devices`` each
    card's by name; None on the CPU, where they are not measured)."""
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e3
    cards = [d for d in dict.fromkeys(as_device(d) for d in devices) if d.type == "cuda"]
    if not cards:
        logger.info("memory: device in_use not measured (cpu) | host maxrss "
                    "%.0f MB", rss)
        return {"device_in_use_mb": None, "device_peak_mb": None,
                "host_maxrss_mb": rss, "devices": {}}
    per = {str(d): (torch.cuda.memory_allocated(d) / 1e6,
                    torch.cuda.max_memory_allocated(d) / 1e6) for d in cards}
    if len(per) == 1:
        text = "in_use %.0f MB peak %.0f MB" % next(iter(per.values()))
    else:
        text = ", ".join("%s in_use %.0f MB peak %.0f MB" % (name, *v)
                         for name, v in per.items())
    logger.info("memory: device %s | host maxrss %.0f MB", text, rss)
    first = next(iter(per.values()))
    return {"device_in_use_mb": first[0], "device_peak_mb": first[1],
            "host_maxrss_mb": rss,
            "devices": {name: {"in_use_mb": v[0], "peak_mb": v[1]}
                        for name, v in per.items()}}


def run_round(t: Training) -> Dict:
    """One round of train.py:199-227: sample, train (with the candidates'
    local eval), test, export, advance.  Returns the round's numbers."""
    cfg, server, logger = t.cfg, t.server, t.logger
    rnd = server.global_round
    server.current_client_list = clients = server.sample_clients()
    logger.info("====== Round %d ======", rnd)
    t.spent["local_eval"] = 0.0
    traced = t.trace_dir is not None and rnd == 0
    with torch_trace(t.trace_dir if traced else None, server.device):
        t0 = time.perf_counter()
        with t.timer.span("train_round"):  # the span ends synchronized
            stats = (server.train_round_parallel(t.mesh) if t.mesh is not None
                     else server.train_round())
        train_s = time.perf_counter() - t0
    if traced:
        logger.info("round %d trace written to %s", rnd, t.trace_dir)
    t0 = time.perf_counter()
    with t.timer.span("eval"), server.timer.span("phase/bin_eval"):
        result = server.test()
    bin_s = time.perf_counter() - t0

    out = cfg.runtime.output_dir
    rce = cfg.runtime.round_ckpt_every
    # the final round always exports, whatever the cadence (the
    # post-training evals read it)
    if (rce and rnd % rce == 0) or rnd == cfg.fed.total_rounds - 1:
        with server.timer.span("phase/torch_export"):
            server.save_round_checkpoint(out)
    cce = cfg.runtime.client_ckpt_every
    if cce and rnd % cce == 0:
        server.save_client_checkpoints(out)
    server.advance_round()
    # the resume state, on the JAX CLI's cadence (train.py:230-238): after
    # advance_round, so round_<K> is the next round to run
    ckpt_s = None
    if rce and (rnd % rce == 0 or rnd == cfg.fed.total_rounds - 1):
        t0 = time.perf_counter()
        with server.timer.span("phase/round_ckpt"):
            t.ckpt.save(server, extra={
                "best": [list(h) for h in t.bin_cb.highest] if t.bin_cb else []})
        ckpt_s = time.perf_counter() - t0
    local_s = t.spent["local_eval"]
    logger.info("round %d: train_round %.3f s (of which local eval %.3f s), "
                "bin eval %.3f s, resume-state save %s s", rnd, train_s, local_s,
                bin_s, "none" if ckpt_s is None else f"{ckpt_s:.3f}")
    server.timer.report(logger)  # the cumulative per-phase breakdown
    memory = log_memory(logger, server.devices)
    return {"round": rnd, "clients": clients, "avg_loss": stats["avg_loss"],
            "train_round_s": train_s, "local_eval_s": local_s,
            "bin_eval_s": bin_s, "ckpt_save_s": ckpt_s,
            "acc": result["acc"] if result else None,
            "spans": dict(server.timer.totals), "memory": memory}


def finish(t: Training) -> None:
    """After the last round: join the resume state's writer, then the
    per-client exports, if the cadence did not capture the final round (the
    post-training personalized evals need every client's backbone and
    converter)."""
    cfg, server = t.cfg, t.server
    t.ckpt.wait()
    t.timer.report(t.logger)
    cce = cfg.runtime.client_ckpt_every
    if t.done and not (cce and (cfg.fed.total_rounds - 1) % cce == 0):
        trained = [c.cid for c in server.clients if c.trained_backbone is not None]
        missing = [c.cid for c in server.clients if c.trained_backbone is None]
        if not trained:
            t.logger.warning("no trained client states in this process "
                             "(resumed after completion?): final per-client "
                             "checkpoints not written")
        else:
            t.logger.info("saving final per-client checkpoints (%d clients)",
                          len(trained))
            if missing:
                t.logger.warning(
                    "clients %s were not trained in this process (resume "
                    "after restart with partial sampling?): their final "
                    "checkpoints are missing and local_all --backbone multi "
                    "will fail for them", missing)
            with t.timer.span("final_client_ckpt"):
                server.save_client_checkpoints(cfg.runtime.output_dir)
    t.logger.info("training done")


def main(args) -> List[Dict]:
    t = setup(args)
    history = []
    try:
        while not t.done:
            history.append(run_round(t))
    finally:
        # join an outstanding resume-state write even when a round raises
        t.ckpt.wait()
    finish(t)
    return history


if __name__ == "__main__":
    main(build_parser().parse_args())
