"""The convergence chain of the port: split -> pretrain -> train -> local_all
on a learnable synthetic identity set, the counterpart of the repository's
``experiments/convergence_tpu.py``.

    python -m fedfr_tpu_torch.convergence --work_dir DIR \\
        [--network sphnet20 --embed 64 --image_size 112 ...] [--device cpu]

It takes that harness's flags and defaults, plus ``--device`` (``cuda`` by
default, raising without a GPU; ``cpu`` on request), and runs every stage
in this process through the port's own entry points, with the harness's
arguments:

1. ``gen_source``: ``3 * num_ids`` identities of ``imgs_per_id`` raw
   images each (a 4x4-block base pattern a identity, noise, contrast and
   brightness jitter, a spatial shift), the harness's bytes;
2. ``data/split.py``: ``split_fl`` and ``split_pretrain`` (``PUB_IDS``
   public IDs, renamed to ``split_pretrain_6000``), and an agedb-style
   ``.bin`` of 64 pairs from the veri split (``make_bin``);
3. ``fedfr_tpu_torch.pretrain.main`` (batch 16, ``--pretrain_epochs``,
   ``--pretrain_lr``; none at ``--pretrain_epochs 0``, and then the
   training starts from random weights);
4. ``fedfr_tpu_torch.train.main`` with every FedFR mechanism
   (``--add_pretrained_data --combine_dataset --contrastive_bb
   --return_all --BCE_local --spreadout --init_fc``), batch 8, combined 16,
   public and eval batches 32;
5. ``fedfr_tpu_torch.local_all.main --backbone multi --task 1:1``.

On the card the chain runs both hand-written kernels: the mining kernel
once a client a round, the ROC kernel once a local-eval candidate a round,
once more for each candidate's epoch -1 baseline, and once a client in
``local_all``.  The summary, one JSON line, holds the harness's figures
(the ``.bin`` accuracy a round and the mean local TPR@1e-1 and @1e-3 at
the baseline and after the last round) and adds each round's XNorm,
average client loss and mean TPRs, ``local_all``'s mean TPR table, the
pretrained backbone's median feature norm over the public set, the
collapsed-feature warnings logged, each stage's wall seconds and the
kernels' launches in each stage.  ``learning_criteria`` applies the
repository's convergence test's two criteria to it.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import re
import shutil
import tempfile
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from . import local_all as local_all_cli
from . import pretrain as pretrain_cli
from . import train as train_cli
from .data import codec, write_split
from .data.datasets import FaceRecordDataset
from .data.split import split_fl, split_pretrain
from .federated.embed import embed_dataset
from .ops import max_sim as max_sim_mod
from .ops import roc_hist as roc_hist_mod
from .utils.device import resolve_device

IMG = 112
NUM_CLIENTS = 8
NUM_IDS = 32          # the FL pool, 4 a client
PUB_IDS = 16          # the public pool
IMGS_PER_ID = 10
TEST_IMGS = 4
ROUNDS = 5
LOCAL_EPOCH = 2
EMBED = 64
NETWORK = "sphnet20"
BIN_PAIRS = 64

XNORM_RE = re.compile(r"\[agedb_30\]\[(\d+)\]XNorm: (\S+)")
ACC_RE = re.compile(r"\[agedb_30\]\[(\d+)\]Accuracy-Flip: ([0-9.]+)")
LOSS_RE = re.compile(r"round (\d+) (?:\(parallel(?: plain)?\) )?avg client loss (\S+)")
TPR_RE = re.compile(r"Epoch (-?\d+), TPR \(-1 to -6\) = (\[[^\]]*\])")
MEAN_RE = re.compile(r"Mean \(-6 to -1\):\n\[([^\]]*)\]")
COLLAPSE_TEXT = "features look collapsed"  # federated/client.py warn_if_collapsed


def make_identity_image(rng: np.random.Generator, base: np.ndarray,
                        noise: int = 18) -> np.ndarray:
    """One image of an identity: its coarse base pattern plus noise and a
    per-image nuisance (contrast and brightness jitter, a spatial shift), so
    that a backbone pretrained on other identities does not solve the task
    and training has room to improve."""
    img = base + rng.integers(-noise, noise + 1, base.shape)
    scale = 0.75 + 0.5 * rng.random()          # contrast
    offset = rng.integers(-20, 21)             # brightness
    img = img.astype(np.float64) * scale + offset
    h = base.shape[0]
    dy, dx = rng.integers(-h // 8, h // 8 + 1, 2)  # shift
    img = np.roll(img, (int(dy), int(dx)), axis=(0, 1))
    return np.clip(img, 0, 255).astype(np.uint8)


def gen_source(src_dir: str, total_ids: int = 3 * NUM_IDS, seed: int = 100,
               image_size: int = IMG, imgs_per_id: int = IMGS_PER_ID) -> None:
    """The source rec ``src_dir/train.{idx,rec}``: ``total_ids`` identities
    of ``imgs_per_id`` raw payloads each, from one seeded generator."""
    rng = np.random.default_rng(seed)
    payloads, labels = [], []
    for pid in range(total_ids):
        block = rng.integers(30, 226, size=(4, 4, 3))
        base = np.kron(block, np.ones((image_size // 4, image_size // 4, 1), dtype=np.int64))
        for _ in range(imgs_per_id):
            payloads.append(codec.encode_raw(make_identity_image(rng, base)))
            labels.append(pid)
    os.makedirs(src_dir, exist_ok=True)
    write_split(os.path.join(src_dir, "train.idx"), os.path.join(src_dir, "train.rec"),
                payloads, labels, num_classes=total_ids)


def make_bin(out_path: str, veri_dir: str, n_pairs: int = BIN_PAIRS, seed: int = 3) -> None:
    """An agedb-style pair ``.bin`` from the veri split: even pairs two
    images of one identity, odd pairs two identities."""
    veri = FaceRecordDataset(veri_dir, prefix="test", use_native=False)
    lbls = veri.all_labels()
    rng = np.random.default_rng(seed)
    by_id: Dict[int, List[int]] = {}
    for i, lb in enumerate(lbls):
        by_id.setdefault(int(lb), []).append(i)
    bins, issame = [], []
    ids = sorted(by_id)
    for p in range(n_pairs):
        if p % 2 == 0:
            pid = ids[rng.integers(len(ids))]
            a, b = rng.choice(by_id[pid], size=2, replace=False)
            issame.append(True)
        else:
            p1, p2 = rng.choice(len(ids), size=2, replace=False)
            a = rng.choice(by_id[ids[p1]])
            b = rng.choice(by_id[ids[p2]])
            issame.append(False)
        bins.append(veri.reader.read_idx(int(veri.imgidx[a]))[1])
        bins.append(veri.reader.read_idx(int(veri.imgidx[b]))[1])
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "wb") as f:
        pickle.dump((bins, issame), f)


def parse_progression(run_dir: str):
    """((round, .bin accuracy) a round, (epoch, TPR table) a local-eval
    line) from ``run_dir/training.log``; epoch -1 is a baseline."""
    with open(os.path.join(run_dir, "training.log")) as f:
        log = f.read()
    agedb = [(int(m.group(1)), float(m.group(2))) for m in ACC_RE.finditer(log)]
    tprs = [(int(m.group(1)), json.loads(m.group(2))) for m in TPR_RE.finditer(log)]
    return agedb, tprs


def build_parser() -> argparse.ArgumentParser:
    """The harness's flags and defaults (convergence_tpu.py:124-150), plus
    ``--device``."""
    ap = argparse.ArgumentParser(description="FedFR convergence chain, PyTorch port")
    ap.add_argument("--work_dir", default=os.path.join(tempfile.gettempdir(), "conv_exp"),
                    help="emptied first; the data, roots and run go here")
    ap.add_argument("--network", default=NETWORK)
    ap.add_argument("--embed", type=int, default=EMBED,
                    help="embedding size (512 = flagship sphere64 scale)")
    ap.add_argument("--image_size", type=int, default=IMG)
    ap.add_argument("--num_clients", type=int, default=NUM_CLIENTS)
    ap.add_argument("--num_ids", type=int, default=NUM_IDS)
    ap.add_argument("--rounds", type=int, default=ROUNDS)
    ap.add_argument("--scan_blocks", action="store_true", default=True,
                    help="passed on to both CLIs, where it has no effect")
    ap.add_argument("--local_epoch", type=int, default=LOCAL_EPOCH)
    ap.add_argument("--imgs_per_id", type=int, default=IMGS_PER_ID)
    ap.add_argument("--pretrain_epochs", type=int, default=4,
                    help="0: no pretraining, the rounds start from random weights")
    ap.add_argument("--pretrain_lr", default="0.01",
                    help="0.01 suits sphnet20/E64; sphere64 at E512 needs 0.001")
    ap.add_argument("--lr", default="0.001", help="federated lr (run.sh's 0.001)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="torch device of every stage")
    return ap


def chain_paths(work_dir: str, num_ids: int) -> Dict[str, str]:
    out = os.path.join(work_dir, "out")
    return {"src": os.path.join(work_dir, "src"), "out": out,
            "pre": os.path.join(work_dir, "pre"), "run": os.path.join(work_dir, "run"),
            "val": os.path.join(work_dir, "val"),
            "veri": os.path.join(out, f"local_veri_{num_ids}"),
            "gallery": os.path.join(out, f"local_gallery_{num_ids}"),
            "public": os.path.join(out, "split_pretrain_6000", "client_0000")}


def prepare_data(paths: Dict[str, str], *, image_size: int, num_clients: int,
                 num_ids: int, imgs_per_id: int, pub_ids: int = PUB_IDS,
                 n_pairs: int = BIN_PAIRS) -> None:
    """Stages 1-2: the source rec, the FL and public splits, the ``.bin``."""
    gen_source(paths["src"], total_ids=3 * num_ids, image_size=image_size,
               imgs_per_id=imgs_per_id)
    split_fl(paths["src"], paths["out"], num_client=num_clients, num_id=num_ids,
             min_imgs=imgs_per_id, max_imgs=imgs_per_id, test_imgs=TEST_IMGS)
    root = split_pretrain(paths["src"], paths["out"], num_id=pub_ids,
                          min_imgs=imgs_per_id, max_imgs=imgs_per_id)
    os.rename(root, os.path.join(paths["out"], "split_pretrain_6000"))
    make_bin(os.path.join(paths["val"], "agedb_30.bin"), paths["veri"], n_pairs=n_pairs)


def pretrain_argv(paths: Dict[str, str], args) -> List[str]:
    argv = ["--data_dir", paths["public"], "--output_dir", paths["pre"],
            "--network", args.network, "--embedding_size", str(args.embed),
            "--image_size", str(args.image_size), "--batch_size", "16",
            "--num_epoch", str(args.pretrain_epochs), "--lr", str(args.pretrain_lr),
            "--device", args.device]
    return argv + (["--scan_blocks"] if args.scan_blocks else [])


def train_argv(paths: Dict[str, str], args, pretrained: bool = True,
               extra: Sequence[str] = ()) -> List[str]:
    """The harness's training command (convergence_tpu.py:188-199); later
    flags in ``extra`` override it."""
    argv = ["--network", args.network,
            "--embedding_size", str(args.embed), "--image_size", str(args.image_size),
            "--output_dir", paths["run"], "--batch_size", "8",
            "--com_batch_size", "16", "--public_batch_size", "32",
            "--eval_batch_size", "32", "--local_epoch", str(args.local_epoch),
            "--total_round", str(args.rounds), "--num_client", str(args.num_clients),
            "--num_ids", str(args.num_ids), "--lr", str(args.lr),
            "--add_pretrained_data", "--combine_dataset", "--contrastive_bb",
            "--return_all", "--BCE_local", "--spreadout", "--init_fc",
            "--rec_root", paths["out"], "--local_rec", paths["veri"],
            "--val_root", paths["val"], "--num_workers", "2", "--device", args.device]
    if pretrained:
        argv += ["--pretrained_root", paths["pre"]]
    return argv + (["--scan_blocks"] if args.scan_blocks else []) + list(extra)


def local_all_argv(paths: Dict[str, str], args) -> List[str]:
    return ["--backbone", "multi", "--task", "1:1", "--ckpt_path", paths["run"],
            "--data_dir", paths["veri"], "--gallery_data_dir", paths["gallery"],
            "--num_client", str(args.num_clients), "--num_ids", str(args.num_ids),
            "--network", args.network, "--embedding_size", str(args.embed),
            "--device", args.device]


def launches() -> Dict[str, int]:
    """The two kernels' launch counts so far (on the CPU they stay 0)."""
    return {"max_sim": max_sim_mod.max_sim_launches,
            "roc_hist": roc_hist_mod.roc_hist_launches}


def median_feature_norm(net: torch.nn.Module, data_dir: str, device: torch.device,
                        batch_size: int = 32) -> float:
    """The median L2 norm of ``net``'s features over the rec at
    ``data_dir``."""
    feats, _ = embed_dataset(net, FaceRecordDataset(data_dir), batch_size,
                             l2norm=False, device=device, num_workers=2)
    return float(feats.float().norm(dim=1).median())


class Stages:
    """Wall seconds and kernel launches of each stage, as they ran."""

    def __init__(self):
        self.seconds: Dict[str, float] = {}
        self.launches: Dict[str, Dict[str, int]] = {}

    def run(self, name: str, fn, *a, **kw):
        before, t0 = launches(), time.perf_counter()
        out = fn(*a, **kw)
        self.seconds[name] = time.perf_counter() - t0
        self.launches[name] = {k: v - before[k] for k, v in launches().items()}
        return out


def summarize(run_dir: str, num_clients: int) -> Dict[str, object]:
    """The harness's summary (convergence_tpu.py:205-225), unrounded, and
    per round: XNorm, average client loss, the candidates' mean TPR@1e-1
    and @1e-3 (grouped by their epoch), with the collapse warnings."""
    agedb, tprs = parse_progression(run_dir)
    with open(os.path.join(run_dir, "training.log")) as f:
        log = f.read()
    baseline = [t for e, t in tprs if e == -1]
    trained = [t for e, t in tprs if e >= 0]
    by_epoch: Dict[int, list] = {}
    for e, t in tprs:
        if e >= 0:
            by_epoch.setdefault(e, []).append(t)

    def mean(rows, col):
        return float(np.mean([t[col] for t in rows])) if rows else None

    summary = {
        "agedb_per_round": agedb,
        "local_tpr_at_1e-1_baseline_mean": mean(baseline, 0),
        "local_tpr_at_1e-1_trained_mean": mean(trained[-num_clients:], 0),
        "local_tpr_at_1e-3_baseline_mean": mean(baseline, 2),
        "local_tpr_at_1e-3_trained_mean": mean(trained[-num_clients:], 2),
        "xnorm_per_round": [float(m.group(2)) for m in XNORM_RE.finditer(log)],
        "avg_loss_per_round": [float(m.group(2)) for m in LOSS_RE.finditer(log)],
        "local_tpr_per_round": [[mean(rows, 0), mean(rows, 2)]
                                for _, rows in sorted(by_epoch.items())],
        "collapse_warnings": log.count(COLLAPSE_TEXT),
    }
    path = os.path.join(run_dir, "local_log.txt")
    m = MEAN_RE.search(open(path).read()) if os.path.exists(path) else None
    summary["local_all_mean_tpr"] = ([float(v) for v in m.group(1).split()]
                                     if m else None)
    return summary


def learning_criteria(summary: Dict[str, object]) -> Dict[str, object]:
    """The repository's convergence test's two criteria
    (tests/test_convergence.py:142-148): the last round's ``.bin`` accuracy
    is at least round 0's (``not_worse``), and either it gained more than
    0.02 or the last round's mean local TPR@1e-1 exceeds the baseline's by
    more than 2.0 (``learned``)."""
    accs = [a for _, a in summary["agedb_per_round"]]
    base = summary["local_tpr_at_1e-1_baseline_mean"]
    trained = summary["local_tpr_at_1e-1_trained_mean"]
    tpr = base is not None and trained is not None
    return {"not_worse": bool(accs[-1] >= accs[0]),
            "learned": bool(accs[-1] > accs[0] + 0.02 or (tpr and trained > base + 2.0)),
            "acc_gain": accs[-1] - accs[0], "tpr_gain": trained - base if tpr else None}


def run_chain(args, devices: Optional[Sequence] = None, *, pub_ids: int = PUB_IDS,
              n_pairs: int = BIN_PAIRS, pretrain_extra: Sequence[str] = (),
              train_extra: Sequence[str] = (),
              pretrained_root: Optional[str] = None) -> Dict[str, object]:
    """Every stage in this process (pretraining over ``devices``, default
    every visible GPU); returns the summary with each stage's seconds and
    launches, the pretrained median feature norm (None without
    pretraining) and the criteria.  ``pretrain_extra`` and ``train_extra``
    flags override the two commands'; ``pretrained_root``, a root an
    earlier chain of the same data pretrained, stands in for stage 3."""
    device = resolve_device(args.device)
    paths = chain_paths(args.work_dir, args.num_ids)
    if pretrained_root:
        paths["pre"] = pretrained_root
    if os.path.exists(args.work_dir):
        shutil.rmtree(args.work_dir)
    os.makedirs(args.work_dir)
    stages = Stages()
    stages.run("data", prepare_data, paths, image_size=args.image_size,
               num_clients=args.num_clients, num_ids=args.num_ids,
               imgs_per_id=args.imgs_per_id, pub_ids=pub_ids, n_pairs=n_pairs)
    norm = None
    pretrained = bool(pretrained_root) or args.pretrain_epochs > 0
    if pretrained and not pretrained_root:
        out = stages.run("pretrain", pretrain_cli.main, pretrain_cli.build_parser().parse_args(
            pretrain_argv(paths, args) + list(pretrain_extra)), devices)
        norm = median_feature_norm(out["state"].backbone.module, paths["public"], device)
    train_args = train_cli.build_parser().parse_args(
        train_argv(paths, args, pretrained, train_extra))
    stages.run("train", train_cli.main, train_args)
    stages.run("local_all", local_all_cli.main,
               local_all_cli.build_parser().parse_args(local_all_argv(paths, args)))
    summary = summarize(paths["run"], args.num_clients)
    summary.update(pretrained_median_feature_norm=norm, stage_seconds=stages.seconds,
                   launches=stages.launches, criteria=learning_criteria(summary))
    return summary


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    summary = run_chain(build_parser().parse_args(argv))
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
