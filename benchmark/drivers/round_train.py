"""The training leg of run.sh's round, through the port's client path.

Set-up builds what ``Server.__init__`` builds for a round (the global
model, the shared work modules, 40 clients of the ``synth:`` universe) with
weights, FC rows, BCE states and public features drawn on the card from the
seed, then starts client 0's local run through
``Client.train_with_public_data``: its mining (the embed of its images and
the ``max_sim`` kernel) and its first ``checked_steps`` steps, which the
reference follows afterwards.  The window opens at the next step of that
same run and goes on client after client, as ``Server.train_round``'s loop
does, until the benchmark's wrapper of the step stops it; a client may be
cut mid-run.  Nothing is built or first run inside the window: every
kernel and shape it uses ran in set-up.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from fedfr_tpu_torch.data.datasets import AllClientData
from fedfr_tpu_torch.federated import client as client_mod
from fedfr_tpu_torch.federated.client import Client
from fedfr_tpu_torch.federated.trainer import branch_step_for
from fedfr_tpu_torch.models import BCEModule
from fedfr_tpu_torch.parallel.mesh import data_mesh

from ..harness import weights as W
from ..harness.hooks import Patches, SpanRecorder
from ..harness.seeding import derive
from ..harness.trace import Trace
from ..harness.window import StopWindow, Window
from ..reference import compare, precision, synth
from ..reference.objective import follow_steps
from . import common

FAULTS = ("unchanged", "half_batch", "altered_answer", "heads_unchanged")


def _params(state) -> Dict[str, torch.Tensor]:
    out = {f"backbone.{k}": v for k, v in state.backbone.named_parameters()}
    out["fc"] = state.fc
    if state.bce is not None:
        out.update({f"bce.{k}": v for k, v in state.bce.named_parameters()})
    return out


def _stats(state) -> Dict[str, torch.Tensor]:
    """The trained backbone's floating buffers: BatchNorm's running means
    and variances, which the step updates."""
    return {f"backbone.{k}": v for k, v in state.backbone.named_buffers()
            if v.is_floating_point()}


class Recorder:
    """What set-up keeps for the check, and the window's counts."""

    def __init__(self, checked: int):
        self.checked = checked
        self.i = 0
        self.batches: List = []
        self.losses: List[torch.Tensor] = []
        self.start: Dict[str, torch.Tensor] = {}
        self.buf1: Dict[str, torch.Tensor] = {}
        self.end: Dict[str, torch.Tensor] = {}
        self.stats_start: Dict[str, torch.Tensor] = {}
        self.stats_end: Dict[str, torch.Tensor] = {}
        self.setup_peak = 0
        self.mining: Optional[dict] = None
        self.mined_keys: Optional[np.ndarray] = None
        self.calls: List = []
        self.stages: Dict[str, float] = {}  # set-up's milestones, perf_counter


def _program(ctx, rec: Recorder, window: Window):
    """Set-up and the window; returns what the check and the result need.
    Everything of the program dies with this function's frame."""
    dev, config, traffic, seed = ctx.device, ctx.config, ctx.traffic, ctx.seed
    fault = ctx.fault
    cfg = common.port_config(config, traffic, seed, dev)
    ref = common.reference(config)
    e = cfg.model.embedding_size
    data = AllClientData(cfg)
    public = data.public_dataset
    public_labels = public.all_labels().astype(np.int64)
    n_local = int(traffic["ids_per_client"])
    n_public = int(traffic["public_classes"])
    if int(public_labels.max()) + 1 != n_public:
        raise ValueError("the traffic's public_classes disagrees with its universe")

    rec.stages["universe"] = time.perf_counter()
    # the global model and the work modules, as Server.__init__ builds them
    gstate = W.make_state(ref.Net, config, ref.init_rule, seed, "global", dev)
    global_net = common.build_on(cfg, dev, gstate).eval().requires_grad_(False)
    backbone = common.build_on(cfg, dev, gstate).requires_grad_(True)
    last_net = common.build_on(cfg, dev, gstate).eval().requires_grad_(False)
    bce_module = BCEModule(e, n_local, cfg.model.converter_layers, m=cfg.loss.bce_margin,
                           r=cfg.loss.bce_scale, t=cfg.loss.bce_t).to(dev)
    pretrained_fc = W.rows(n_public, e, 0.01, seed, "fc/global", dev)
    public_feats = W.unit_rows(len(public), e, seed, "public", dev,
                               torch.bfloat16 if dev.type == "cuda" else torch.float32)
    timer = SpanRecorder([dev])
    mesh = data_mesh(devices=[dev])
    init_cfg = common.without_contrastive(cfg)
    clients = []
    for cid in range(cfg.data.num_clients):
        c = Client(cid, init_cfg, data.client(cid), backbone, bce_module,
                   last_net=last_net, device=dev, mesh=mesh)
        c.cfg = cfg
        c.timer = timer
        c.fc_local = W.rows(n_local, e, 0.01, seed, f"fc/local/{cid}", dev)
        c.bce_state = W.bce_state(c.fc_local)
        c.last_backbone = W.make_state(ref.Net, config, ref.init_rule, seed, f"last/{cid}", dev)
        clients.append(c)

    rec.stages["clients"] = time.perf_counter()
    inner = branch_step_for(cfg, n_local, False)

    def step(state, gnet, lnet, imgs, labels, valid, lr, flip, dropout_gen=None):
        i = rec.i
        if i == 0:
            rec.stages["mined"] = time.perf_counter()
            rec.start = {k: common.to_host(v) for k, v in _params(state).items()}
            rec.stats_start = {k: common.to_host(v) for k, v in _stats(state).items()}
            if fault == "stats_unchanged":
                for m in state.backbone.modules():
                    if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                        m.momentum = 0.0
        if i == rec.checked:
            rec.end = {k: common.to_host(v) for k, v in _params(state).items()}
            rec.stats_end = {k: common.to_host(v) for k, v in _stats(state).items()}
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
                rec.setup_peak = torch.cuda.max_memory_allocated(dev)
                torch.cuda.reset_peak_memory_stats(dev)
            window.open()
        if window.is_open:
            window.step()
        if i < rec.checked:
            rec.batches.append(tuple(common.to_host(t) for t in (imgs, labels, valid, flip)))
        if fault == "half_batch":
            valid = valid.clone()
            valid[valid.shape[0] // 2:] = False
        if fault == "unchanged":
            lr = 0.0
        if fault == "heads_unchanged":  # the FC rows and the BCE module kept
            heads = [v for k, v in _params(state).items() if not k.startswith("backbone.")]
            kept = [v.detach().clone() for v in heads]
        state, metrics = inner(state, gnet, lnet, imgs, labels, valid, lr, flip,
                               dropout_gen=dropout_gen)
        if fault == "heads_unchanged":
            with torch.no_grad():
                for v, k in zip(heads, kept):
                    v.copy_(k)
        if i < rec.checked:
            rec.losses.append(torch.stack(metrics).detach().clone())
        if i == 0:
            bufs = state.opt.state
            rec.buf1 = {k: common.to_host(bufs[p]["momentum_buffer"])
                        for k, p in _params(state).items() if p in bufs}
        rec.i += 1
        return state, metrics

    def on_max_sim(args, kwargs, out):
        local, pub = args[0], args[1]
        if window.is_traced:
            rec.calls.append((pub.shape[0], local.shape[0], local.shape[1]))
        if rec.mining is None:
            rec.mining = {"local": common.to_host(local), "scores": common.to_host(out)}

    patches = Patches()
    patches.wrap(client_mod, "max_similarity", "bench/max_sim", on_max_sim)
    first = clients[0]
    original_prepare = first.prepare_local_run

    def prepare(*args, **kwargs):
        combined, loader, state, lnet = original_prepare(*args, **kwargs)
        if rec.mined_keys is None:
            rec.mined_keys = np.asarray(combined.public.imgidx).copy()
            if fault == "altered_answer":  # the hardest swapped for the easiest
                keys = combined.public.imgidx.copy()
                keys[0] = int(np.argmin(rec.mining["scores"].numpy())) + 1
                combined.public.imgidx = keys
                rec.mined_keys = keys.copy()
        return combined, loader, state, lnet

    first.prepare_local_run = prepare
    # the mining embeds of the clients the window can reach end on a batch
    # of their own size: warm those shapes here
    bs = cfg.data.eval_batch_size
    with torch.no_grad():
        for c in clients[1:1 + int(traffic["warm_clients"])]:
            rest = len(c.dataset) % bs
            if rest:
                global_net(torch.zeros(rest, 3, cfg.data.image_size, cfg.data.image_size,
                                       device=dev))
    epochs = cfg.fed.local_epochs
    runs = 0
    try:
        cid = 0
        while True:
            clients[cid % len(clients)].train_with_public_data(
                global_net, public, pretrained_fc, public_feats, public_labels, epochs,
                cfg.optim.train_decay, step_fn=step, round_seed=0)
            runs += 1
            cid += 1
    except StopWindow:
        pass
    finally:
        patches.unwrap()
    window_s = window.close()
    peak_window = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    return {"cfg": cfg, "window_s": window_s, "peak_window": peak_window,
            "spans": timer.intervals, "runs": runs, "n_local": n_local,
            "n_public": n_public, "n_public_images": len(public_labels)}


def run(ctx) -> common.RunResult:
    dev = ctx.device
    rec = Recorder(int(ctx.traffic["checked_steps"]))
    trace = Trace(ctx.trace, dev)
    window = Window(ctx.seconds, dev, trace)
    got = _program(ctx, rec, window)
    cfg, window_s = got["cfg"], got["window_s"]
    peak = max(rec.setup_peak, got["peak_window"])
    steps = window.steps
    images = steps * cfg.data.combined_batch_size
    periods = window.periods_ms()
    end_to_end = {
        "train_img_per_s": images / window_s if window_s > 0 else 0.0,
        "step_ms_p95": common.percentile(periods, 95),
        "peak_mem_gib": got["peak_window"] / 2 ** 30,
    }
    record = {
        "window_s": window_s, "steps": steps, "images": images,
        "traced_s": window.traced_s, "lead": lead_of(window, cfg, got["spans"]),
        "calls": {"bench/max_sim": rec.calls}, "trace": trace.summary(),
        "n_local": got["n_local"], "n_public": got["n_public"], "config": ctx.config,
        "client_runs": got["runs"], "host": window.host,
        "periods_ms": {"n": len(periods), **{f"p{q}": common.percentile(periods, q)
                                              for q in (50, 90, 95, 99, 100)}},
        "setup_stages": {k: round(window.t0 - v, 3) for k, v in rec.stages.items()},
    }
    losses = [l.tolist() for l in rec.losses]
    failed = 0 if all(math.isfinite(x[0]) for x in losses) else 1
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
    args = (ctx, cfg, rec, losses, common.universe(cfg), got["n_local"], got["n_public"],
            got["n_public_images"])
    record["numbers"] = check(*args)
    checked = common.with_limits(ctx, record["numbers"])
    if getattr(ctx, "controls", False):
        record["controls"] = controls(*args)
    return common.RunResult(end_to_end=end_to_end, setup_done=window.t0, peak_bytes=peak,
                            attempted=steps, failed=failed, checked=checked, record=record)


def lead_of(window: Window, cfg, spans) -> Optional[dict]:
    """The traced run's untraced lead: its seconds, the images of its steps
    and the port's spans clipped to it (what the host-clock readers read)."""
    if window.lead is None:
        return None
    t0, t1 = window.t0, window.t0 + window.lead["seconds"]
    return {"seconds": window.lead["seconds"],
            "images": window.lead["count"] * cfg.data.combined_batch_size,
            "spans": [(n, max(a, t0), min(b, t1)) for n, a, b in spans if b > t0 and a < t1]}


def reference_weights(ctx, n_local: int, n_public: int, cid: int = 0) -> Dict:
    """The benchmark's weights of client ``cid``'s first run, drawn again."""
    ref = common.reference(ctx.config)
    dev, seed, e = ctx.device, ctx.seed, int(ctx.config["embedding_size"])
    fc_local = W.rows(n_local, e, 0.01, seed, f"fc/local/{cid}", dev)
    return {"global": W.make_state(ref.Net, ctx.config, ref.init_rule, seed, "global", dev),
            "last": W.make_state(ref.Net, ctx.config, ref.init_rule, seed, f"last/{cid}", dev),
            "fc": torch.cat([fc_local, W.rows(n_public, e, 0.01, seed, "fc/global", dev)]),
            "bce": W.bce_state(fc_local)}


def loss_settings(cfg, traffic) -> Dict:
    p = dict(traffic["loss"])
    p.update(momentum=cfg.optim.momentum, weight_decay=cfg.optim.weight_decay)
    return p


def reference_steps(ctx, cfg, rec: Recorder, n_local: int, n_public: int,
                    cast: str = "exact", drop_half: bool = False) -> Dict:
    """The reference's first steps on the program's batches, from the
    benchmark's weights; ``cast`` and ``drop_half`` make the control and a
    planted fault."""
    dev = ctx.device
    ref = common.reference(ctx.config)
    weights = reference_weights(ctx, n_local, n_public)
    batches = [tuple(t.to(dev) for t in b) for b in rec.batches]
    out = follow_steps(ref.Net, ctx.config, weights, batches, float(ctx.traffic["lr"]),
                       loss_settings(cfg, ctx.traffic), dev,
                       cast=None if cast == "exact" else precision.CASTS[cast],
                       drop_half=drop_half)
    out["change"] = {k: out["end"][k] - out["start"][k] for k in out["end"]}
    out["stats_change"] = {k: out["stats_end"][k] - out["stats_start"][k]
                           for k in out["stats_end"]}
    out["gstate"] = weights["global"]
    return out


def program_steps(ctx, cfg, rec: Recorder, losses) -> Dict:
    """The program's side: its losses, the first gradient as its optimizer
    got it (the momentum buffer after one step less the weight decay of the
    start), each leaf's change and each running statistic's change over the
    checked steps."""
    dev, wd = ctx.device, cfg.optim.weight_decay
    start = {k: v.to(dev) for k, v in rec.start.items()}
    return {"losses": losses,
            "grads": {k: rec.buf1[k].to(dev) - wd * start[k] for k in rec.buf1},
            "change": {k: rec.end[k].to(dev) - start[k] for k in rec.end},
            "stats_change": {k: rec.stats_end[k].to(dev) - rec.stats_start[k].to(dev)
                             for k in rec.stats_end}}


def step_numbers(side: Dict, ref: Dict) -> Dict[str, float]:
    """The step's numbers; a cell's limits file says which it compares.
    ``*_head`` take the worst leaf over the heads' leaves alone;
    ``stats_gap`` / ``stats_gap_med`` the worst and the median running
    statistic's change (a net with BatchNorm only)."""
    counted, _ = compare.counted_leaves(ref["grads"])
    heads = compare.head_leaves(counted)
    grad = compare.worst_leaf_gap(side["grads"], ref["grads"], counted)
    update = compare.worst_leaf_gap(side["change"], ref["change"], counted)
    grad_head = compare.worst_leaf_gap(side["grads"], ref["grads"], heads)
    update_head = compare.worst_leaf_gap(side["change"], ref["change"], heads)
    out = {"loss_gap": compare.loss_gap(side["losses"], ref["losses"]),
           "grad_gap": grad[0], "update_gap": update[0],
           "grad_gap_med": compare.median_leaf_gap(side["grads"], ref["grads"], counted),
           "update_gap_med": compare.median_leaf_gap(side["change"], ref["change"], counted),
           "grad_gap_head": grad_head[0], "update_gap_head": update_head[0],
           "grad_worst_leaf": grad[1], "update_worst_leaf": update[1],
           "grad_worst_head": grad_head[1], "update_worst_head": update_head[1]}
    if ref["stats_change"]:
        moved, _ = compare.counted_leaves(ref["stats_change"])
        stats = compare.worst_leaf_gap(side["stats_change"], ref["stats_change"], moved)
        out.update(stats_gap=stats[0], stats_worst=stats[1],
                   stats_gap_med=compare.median_leaf_gap(side["stats_change"],
                                                         ref["stats_change"], moved))
    return out


def check(ctx, cfg, rec: Recorder, losses, spec: dict, n_local: int, n_public: int,
          n_public_images: int) -> Dict:
    """Every number of the check (the limits file picks those compared)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = reference_steps(ctx, cfg, rec, n_local, n_public)
    numbers = step_numbers(program_steps(ctx, cfg, rec, losses), ref)
    numbers.update(mining_numbers(ctx, rec, ref["gstate"], spec, n_public_images))
    return numbers


def mining_numbers(ctx, rec: Recorder, gstate, spec: dict, n_public_images: int,
                   cast: str = "exact") -> Dict:
    """Client 0's mining: a sample of its local embeddings against the
    reference model on images the reference makes itself, and the mined set
    against the reference's scores from the program's local embeddings (the
    step that follows from the program's own state).  With ``cast`` the
    reference at that precision stands in the program's place (the
    control): its embeddings, and its mined set from scores of operands
    rounded so."""
    dev, cfgd = ctx.device, ctx.config
    ref = common.reference(cfgd)
    local = rec.mining["local"].to(dev).float()
    n = local.shape[0]
    k = min(int(ctx.traffic["mining_sample_rows"]), n)
    rng = np.random.default_rng(derive(ctx.seed, "mining-sample"))
    pos = np.sort(rng.choice(n, size=k, replace=False))
    vecs, _ = synth.client_vectors(spec, 0, pos)
    imgs = synth.generate(vecs, spec, dev)
    net = ref.Net(cfgd).to(dev)
    net.load_state_dict(gstate)
    net.eval()
    rows = {}
    with torch.no_grad():
        x = (imgs.float() * (1.0 / 127.5) - 1.0).permute(0, 3, 1, 2)
        for c in {"exact", cast}:
            net.cast = precision.CASTS[c]
            f = net(x)
            rows[c] = f / f.norm(dim=1, keepdim=True).clamp_min(1e-12)
    side_rows = rows[cast] if cast != "exact" else local[torch.as_tensor(pos, device=dev)]
    embed_gap = compare.row_gap(side_rows, rows["exact"])
    e = local.shape[1]
    pub = W.unit_rows(n_public_images, e, ctx.seed, "public", dev,
                      torch.bfloat16 if dev.type == "cuda" else torch.float32).float()
    q = precision.CASTS[cast]
    scores = torch.empty(pub.shape[0], device=dev)
    side_scores = torch.empty(pub.shape[0], device=dev)
    with torch.no_grad():
        for s in range(0, pub.shape[0], 65536):
            scores[s:s + 65536] = (pub[s:s + 65536] @ local.t()).amax(1)
            if cast != "exact":
                side_scores[s:s + 65536] = (q(pub[s:s + 65536]) @ q(local).t()).amax(1)
    thr, cap = float(cfgd["hn_threshold"]), int(cfgd["hn_cap"])
    keys = rec.mined_keys
    if cast != "exact":
        ss = side_scores.cpu().numpy()
        over = np.flatnonzero(ss > thr)
        keys = over[np.argsort(ss[over], kind="stable")[::-1][:cap]] + 1
    set_gap = compare.mined_set_gap(keys, scores.cpu().numpy(), cap, thr)
    return {"mine_embed_gap": embed_gap, "mine_set_gap": set_gap}


def controls(ctx, cfg, rec: Recorder, losses, spec: dict, n_local: int, n_public: int,
             n_public_images: int) -> Dict[str, Dict[str, float]]:
    """Readings that set the limits' upper ends: the control (the reference
    in fp8 in the program's place) and the planted faults (half of each
    batch left out, in the reference in the program's place; a state left
    unchanged, parameters or running statistics, reads 1 on ``update_gap``
    or ``stats_gap`` by its measure and needs no run)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = reference_steps(ctx, cfg, rec, n_local, n_public)
    out = {}
    ctl = reference_steps(ctx, cfg, rec, n_local, n_public, cast="fp8")
    out["control"] = step_numbers(ctl, ref)
    out["control"].update(mining_numbers(ctx, rec, ref["gstate"], spec, n_public_images,
                                         cast="fp8"))
    half = reference_steps(ctx, cfg, rec, n_local, n_public, drop_half=True)
    out["half_batch"] = step_numbers(half, ref)
    return out
