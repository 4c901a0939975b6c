"""The local 1:1 eval leg of run.sh's round, through the port's eval path.

Set-up draws each of the round's candidates (clients sampled from the
seed) a backbone and a BCE state on the card from the seed and the
candidate's index, builds ``LocalVerificationCallback`` over the ``synth:``
universe's 160,000-image veri split, and warms its shapes: a ``veri_test``
on a view of one full embed batch and the veri set's remainder batch.  The window runs candidates whole,
one ``veri_test`` each (load the state, embed the veri set through the BCE
converter, the 4,000 x 160,000 ROC, the TPR table), cycling through them;
none starts once ``--seconds`` have passed.
"""

from __future__ import annotations

import math
import shutil
import tempfile
import time
from typing import Dict, List

import numpy as np
import torch

from fedfr_tpu_torch.data.datasets import AllClientData
from fedfr_tpu_torch.evalsuite import local_eval as local_eval_mod
from fedfr_tpu_torch.federated import embed as embed_mod
from fedfr_tpu_torch.evalsuite.local_eval import LocalVerificationCallback
from fedfr_tpu_torch.models import BCEModule
from fedfr_tpu_torch.ops import roc_histogram as roc_mod
from fedfr_tpu_torch.parallel.mesh import data_mesh

from ..harness import weights as W
from ..harness.hooks import Patches
from ..harness.seeding import derive
from ..harness.trace import Trace
from ..harness.window import Window
from ..reference import compare, precision, roc, synth
from . import common

FAULTS = ("half_batch", "altered_answer")
CAPTURED = 2  # the candidates whose outputs are kept; the check samples one


def candidate_state(ctx, k: int, n_local: int) -> Dict:
    """Candidate ``k``'s backbone and BCE state, drawn from the seed: the
    converter near the identity, its rows N(0, 0.01)."""
    ref = common.reference(ctx.config)
    dev, seed, e = ctx.device, ctx.seed, int(ctx.config["embedding_size"])
    bce = W.bce_state(W.rows(n_local, e, 0.01, seed, f"candidate/{k}/rows", dev))
    bce["converter.0.weight"] += W.rows(e, e, 0.01, seed, f"candidate/{k}/converter", dev)
    return {"backbone": W.make_state(ref.Net, ctx.config, ref.init_rule, seed,
                                     f"candidate/{k}", dev), "bce": bce}


def candidates(ctx, n_clients: int) -> List[int]:
    rng = np.random.default_rng(derive(ctx.seed, "candidates"))
    return sorted(rng.permutation(n_clients)[: int(ctx.traffic["candidates"])].tolist())


def _program(ctx, window: Window, kept: Dict, calls: List, done: List):
    dev, config, traffic = ctx.device, ctx.config, ctx.traffic
    cfg = common.port_config(config, traffic, ctx.seed, dev)
    n_local = int(traffic["ids_per_client"])
    data = AllClientData(cfg, include_public=False)
    veri = data.veri_dataset("")
    cids = candidates(ctx, cfg.data.num_clients)
    states = [candidate_state(ctx, k, n_local) for k in range(len(cids))]
    net = common.build_on(cfg, dev, states[0]["backbone"])
    bce = BCEModule(cfg.model.embedding_size, n_local, cfg.model.converter_layers).to(dev)
    out_dir = tempfile.mkdtemp(prefix="fedfr-bench-eval-")
    cb = LocalVerificationCallback(net, bce, veri, out_dir, batch_size=cfg.data.eval_batch_size,
                                   device=dev, num_workers=cfg.data.num_workers,
                                   prefetch=cfg.data.prefetch, mesh=data_mesh(devices=[dev]))
    current = {"k": -1}
    # the captured candidates' embeddings go to host buffers made here, so
    # the window allocates no pinned memory
    e = cfg.model.embedding_size
    buffers = [torch.empty((len(veri), e), pin_memory=dev.type == "cuda")
               for _ in range(CAPTURED)]

    def on_embed(args, kwargs, out):
        feats, labels = out
        if current["k"] < CAPTURED and window.is_open:
            host = buffers[current["k"]]
            host.copy_(feats, non_blocking=True)
            kept.setdefault(current["k"], {})["feats"] = host

    def on_hist(args, kwargs, out):
        feats = args[0]
        if window.is_traced:
            calls.append((int(args[2]), feats.shape[0], feats.shape[1]))
        if window.is_open and current["k"] < CAPTURED:
            kept.setdefault(current["k"], {})["hist"] = np.asarray(out).copy()

    patches = Patches()
    patches.wrap(local_eval_mod, "embed_dataset", "bench/embed", on_embed)
    patches.wrap(local_eval_mod, "client_roc", "bench/roc_hist")
    patches.wrap(roc_mod, "pairwise_roc_histogram", "bench/roc_hist_call", on_hist)
    if ctx.fault == "half_batch":  # each batch embedded on its first half alone
        original_embed = embed_mod.ShardedEmbed.embed

        def half(self, placed, flip=False):
            blocks, b = placed
            blocks = [torch.cat([x[: (x.shape[0] + 1) // 2]] * 2)[: x.shape[0]] for x in blocks]
            return original_embed(self, (blocks, b), flip)

        patches.replace(embed_mod.ShardedEmbed, "embed", half)
    try:
        # warm-up: the window's two embed batch sizes (a full batch and the
        # veri set's remainder) and one ROC launch
        bs = cfg.data.eval_batch_size
        warm = veri.subset(veri.imgidx[: bs + len(veri) % bs])
        cb.dataset = warm
        cb.veri_test(states[0]["backbone"], 0, list(range(n_local)), cids[0], states[0]["bce"])
        cb.dataset = veri
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            kept["setup_peak"] = torch.cuda.max_memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        window.open()
        k = 0
        while not window.expired():
            window.poll(len(done))
            slot = k % len(cids)
            cid = cids[slot]
            current["k"] = k
            ids = list(range(cid * n_local, (cid + 1) * n_local))
            t0 = time.perf_counter()
            table = cb.veri_test(states[slot]["backbone"], 0, ids, cid, states[slot]["bce"])
            if ctx.fault == "altered_answer":
                table = list(table)
                table[0] += 1.0
            done.append({"k": k, "slot": slot, "cid": cid, "table": table,
                         "seconds": time.perf_counter() - t0})
            k += 1
        window_s = window.close()
    finally:
        patches.unwrap()
        shutil.rmtree(out_dir, ignore_errors=True)
    peak_window = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    return {"cfg": cfg, "window_s": window_s, "peak_window": peak_window,
            "n_veri": len(veri), "cids": cids}


def run(ctx) -> common.RunResult:
    dev = ctx.device
    trace = Trace(ctx.trace, dev)
    window = Window(ctx.seconds, dev, trace)
    kept, calls, done = {}, [], []
    got = _program(ctx, window, kept, calls, done)
    cfg, window_s = got["cfg"], got["window_s"]
    images = len(done) * got["n_veri"]
    end_to_end = {"eval_img_per_s": images / window_s if window_s > 0 else 0.0,
                  "peak_mem_gib": got["peak_window"] / 2 ** 30}
    lead = window.lead and {"seconds": window.lead["seconds"],
                            "images": window.lead["count"] * got["n_veri"]}
    record = {"window_s": window_s, "images": images, "candidates": len(done),
              "traced_s": window.traced_s, "lead": lead, "host": window.host,
              "calls": {"bench/roc_hist": calls}, "trace": trace.summary(),
              "config": ctx.config, "n_local": int(ctx.traffic["ids_per_client"]),
              "candidate_seconds": [d["seconds"] for d in done]}
    failed = sum(1 for d in done if not all(math.isfinite(x) for x in d["table"]))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
    record["numbers"] = check(ctx, cfg, kept, done, got["n_veri"])
    checked = common.with_limits(ctx, record["numbers"])
    if getattr(ctx, "controls", False):
        record["controls"] = controls(ctx, cfg, kept, done, got["n_veri"])
    return common.RunResult(end_to_end=end_to_end, setup_done=window.t0,
                            peak_bytes=max(kept.get("setup_peak", 0), got["peak_window"]),
                            attempted=len(done), failed=failed, checked=checked,
                            record=record)


def _pick(ctx, cfg, kept: Dict, done: List, n_veri: int):
    """The candidate the check reads, drawn from the seed among the
    captured ones the window completed, and the sampled veri rows."""
    have = [d for d in done if d["k"] in kept and "feats" in kept[d["k"]]]
    if not have:
        return None
    rng = np.random.default_rng(derive(ctx.seed, "eval-sample"))
    pick = have[int(rng.integers(len(have)))]
    k = min(int(ctx.traffic["embed_sample_rows"]), n_veri)
    pos = np.sort(rng.choice(n_veri, size=k, replace=False))
    return pick, pos


def reference_rows(ctx, cfg, slot: int, pos: np.ndarray, cast: str = "exact") -> torch.Tensor:
    """The reference's unit embeddings (backbone, then the BCE converter) of
    the veri images at ``pos``, made by the reference itself."""
    dev = ctx.device
    spec = common.universe(cfg)
    vecs, _ = synth.veri_vectors(spec, pos)
    imgs = synth.generate(vecs, spec, dev)
    ref = common.reference(ctx.config)
    state = candidate_state(ctx, slot, int(ctx.traffic["ids_per_client"]))
    net = ref.Net(ctx.config).to(dev)
    net.load_state_dict(state["backbone"])
    net.cast = precision.CASTS[cast]
    net.eval()
    conv = state["bce"]
    with torch.no_grad():
        x = (imgs.float() * (1.0 / 127.5) - 1.0).permute(0, 3, 1, 2)
        f = net(x) @ conv["converter.0.weight"].t() + conv["converter.0.bias"]
    return f / f.norm(dim=1, keepdim=True).clamp_min(1e-12)


def reference_hist(ctx, cfg, pick, feats, n_veri: int, tf32: bool = False) -> np.ndarray:
    n_local = int(ctx.traffic["ids_per_client"])
    _, labels = synth.veri_vectors(common.universe(cfg), np.arange(n_veri))
    lo = pick["cid"] * n_local
    return roc.histogram(feats.to(ctx.device), labels, lo, lo + n_local, tf32=tf32)


def check(ctx, cfg, kept: Dict, done: List, n_veri: int) -> Dict[str, float]:
    """One candidate of the window: a sample of its embeddings against the
    reference on images the reference makes itself; its histogram against
    the reference's from the program's embeddings, and its TPR table
    against the reference's from the program's histogram (each a step that
    follows from the program's own state; the table's is exact)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    got = _pick(ctx, cfg, kept, done, n_veri)
    if got is None:
        return {}
    pick, pos = got
    feats = kept[pick["k"]]["feats"]
    rows = reference_rows(ctx, cfg, pick["slot"], pos)
    hist = reference_hist(ctx, cfg, pick, feats, n_veri)
    return {"embed_gap": compare.row_gap(feats[torch.as_tensor(pos)].to(ctx.device), rows),
            "hist_moved": compare.hist_moved(kept[pick["k"]]["hist"], hist),
            "tpr_gap": compare.table_gap(pick["table"], roc.tpr_table(kept[pick["k"]]["hist"]))}


def controls(ctx, cfg, kept: Dict, done: List, n_veri: int) -> Dict:
    """Readings that set the limits' upper ends: the control (the reference
    in its lower precisions in the program's place: fp8 embeddings, TF32
    cosines) and the planted faults (each batch embedded on its first half;
    an answer altered reads its alteration, 1.0 on ``tpr_gap``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pick, pos = _pick(ctx, cfg, kept, done, n_veri)
    feats = kept[pick["k"]]["feats"]
    exact = reference_rows(ctx, cfg, pick["slot"], pos)
    hist = reference_hist(ctx, cfg, pick, feats, n_veri)
    tf32 = reference_hist(ctx, cfg, pick, feats, n_veri, tf32=True)
    batch = int(ctx.traffic["eval_batch"])
    half = pos - np.where(pos % batch >= (batch + 1) // 2, (batch + 1) // 2, 0)
    return {"control": {"embed_gap": compare.row_gap(
                            reference_rows(ctx, cfg, pick["slot"], pos, "fp8"), exact),
                        "hist_moved": compare.hist_moved(tf32, hist),
                        "tpr_gap": compare.table_gap(roc.tpr_table(tf32), roc.tpr_table(tf32))},
            "half_batch": {"embed_gap": compare.row_gap(
                reference_rows(ctx, cfg, pick["slot"], half), exact)}}
