"""Public-set pretraining with the Partial FC: the port's counterpart of the
repository's ``pretrain.py``, on one device.

    python -m fedfr_tpu_torch.pretrain --data_dir .../split_pretrain_6000/client_0000 \
        --network sphnet --output_dir ./pretrain --num_epoch 16 \
        --batch_size 512 --lr 0.05 --sample_rate 1.0

It takes every flag of ``pretrain.py`` plus ``--device`` (``cuda`` by
default, raising without a GPU; ``cpu`` on request).  ``--data_dir`` is a
rec root or a ``synth:`` spec (the public set of ``build_fl_synthetic``;
the spec's ``image_size``/``seed`` must agree with the flags).

The margin-softmax FC holds every public class (``parallel/partial_fc.py``:
the full softmax, or ``--sample_rate < 1`` sampled classes) in fp32; the
backbone's trunk runs in bf16 under autocast unless ``--fp32``.  One
``torch.optim.SGD`` over the backbone and one over the FC, momentum and
weight decay as the JAX package's SGD; the learning rate is ``lr * 0.1 **
#{m : m - 1 <= epoch}`` over ``--lr_steps``.

Randomness follows the JAX CLI's key chain through ``ops/threefry.py``
(JAX's PRNG, bit for bit): ``key = PRNGKey(seed + 7)``, per step
``fold_in(fold_in(key, epoch), step)`` split into the flip's key and the
sampling key (``flip = uniform(prng, (B,)) < 0.5``, the sample from
``fold_in(srng, 0)``), so that both CLIs consume the same numbers.  The
initial weights are the port's own (seeded ``torch.Generator``s); iresnet's
dropout draws from a ``torch.Generator`` seeded per (seed, epoch).

After every ``--save_every`` epochs and after the last: ``backbone.pth``
(the state_dict in the reference key layout, which ``Server`` loads; also
for ``toy``, where the JAX CLI writes ``backbone.npz``), ``fc.pth`` (the
real classes' rows) and ``preCos_pretrain_labels.pth``, then the resume
state ``pretrain_state.pt`` (backbone with its BN statistics, FC weight,
both optimizers' momentum buffers, the epoch).  ``--resume`` continues
from it, replaying the loader's permutation draws of the epochs already
trained.  ``pretrain.log`` carries the JAX CLI's lines.

Sharding the FC over more than one GPU is not ported (ROADMAP B.2 item 4).
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .data.datasets import BatchLoader, FaceRecordDataset
from .data.pipeline import DevicePrefetcher
from .data.synthetic import (build_fl_synthetic, explicit_synth_keys,
                             is_synth_spec, parse_synth_spec)
from .federated.state import train_preprocess
from .models import build_backbone
from .models.iresnet import IResNet
from .ops import threefry
from .parallel.partial_fc import (num_sampled, pad_classes, partial_fc_loss,
                                  sampled_partial_fc_loss)
from .utils.device import resolve_device
from .utils.logging import AverageMeter, ThroughputLogger, init_logging
from .utils.snapshot import snapshot_source

STATE_FILE = "pretrain_state.pt"
N_SHARDS = 1  # one device holds every class row (ROADMAP B.2 item 4: more)


def _positive_int(text: str) -> int:
    value = int(text)
    if value < 1:
        raise argparse.ArgumentTypeError(f"must be >= 1, got {value}")
    return value


def build_parser() -> argparse.ArgumentParser:
    """Every flag of the repository's pretrain.py, plus ``--device``."""
    p = argparse.ArgumentParser(description="Partial-FC pretraining, PyTorch port")
    p.add_argument("--data_dir", required=True)
    p.add_argument("--output_dir", default="./pretrain")
    p.add_argument("--network", default="sphnet")
    p.add_argument("--loss", default="CosFace")
    p.add_argument("--embedding_size", type=int, default=512)
    p.add_argument("--image_size", type=int, default=112)
    p.add_argument("--batch_size", type=int, default=512)
    p.add_argument("--num_epoch", type=int, default=16)
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--lr_steps", default="6,14")
    p.add_argument("--scale", type=float, default=64.0)
    p.add_argument("--margin", type=float, default=0.4)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--weight_decay", type=float, default=5e-4)
    p.add_argument("--sample_rate", type=float, default=1.0)
    p.add_argument("--num_workers", type=int, default=6)
    p.add_argument("--log_every", type=int, default=50)
    p.add_argument("--seed", type=int, default=100)
    p.add_argument("--dropout", type=float, default=0.0,
                   help="backbone dropout before the embedding fc (iresnet)")
    p.add_argument("--fp32", action="store_true")
    p.add_argument("--scan_blocks", action="store_true",
                   help="no effect here: a JAX compile option; the port's "
                        "modules have one layout")
    p.add_argument("--save_every", type=_positive_int, default=1,
                   help="save artifacts + resume state every N >= 1 epochs "
                        "(always saves the final epoch); 1 matches the "
                        "reference's per-epoch cadence")
    p.add_argument("--resume", action="store_true",
                   help="resume from pretrain_state.pt (weight + momentum, "
                        "PartialFC partial_fc.py:41-54 parity)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="torch device of the run")
    return p


def public_dataset(args, device: torch.device):
    """The pretraining set: the public split of a ``synth:`` spec (its
    ``image_size`` and ``seed`` set from the flags, a contradicting spec
    key raising as in ``pretrain.py:52-67``), else the rec at
    ``--data_dir``."""
    if is_synth_spec(args.data_dir):
        spec = parse_synth_spec(args.data_dir)
        explicit = explicit_synth_keys(args.data_dir)
        for k, v in (("image_size", args.image_size), ("seed", args.seed)):
            if k in explicit and spec[k] != v:
                raise ValueError(f"synth spec sets {k}={spec[k]} but the CLI "
                                 f"passes {k}={v}; drop one of the two")
            spec[k] = v
        return build_fl_synthetic(spec, device)["public"]
    return FaceRecordDataset(args.data_dir)


def initial_state(args, num_classes: int) -> Tuple[nn.Module, torch.Tensor]:
    """The run's starting weights on the CPU: the backbone from a generator
    seeded with ``seed`` (``toy``, which takes none, from the global RNG
    seeded so, inside a fork that leaves the caller's stream alone) and the
    FC ``0.01 * N(0, 1)`` (fp32) from one seeded with ``seed + 1``."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(args.seed)
        backbone = build_backbone(args.network, args.embedding_size,
                                  bf16=not args.fp32, image_size=args.image_size,
                                  generator=torch.Generator().manual_seed(args.seed),
                                  dropout=args.dropout)
    weight = 0.01 * torch.randn(num_classes, args.embedding_size,
                                generator=torch.Generator().manual_seed(args.seed + 1))
    return backbone, weight


def training_state(args, num_classes: int, device: torch.device):
    """(backbone, FC weight, its real row count, the backbone's SGD, the
    FC's SGD) on ``device``, from ``initial_state``; the FC padded to the
    shard count (one shard: no padding)."""
    backbone, weight = initial_state(args, num_classes)
    weight, num_valid = pad_classes(weight, N_SHARDS)
    backbone = backbone.to(device)
    weight = nn.Parameter(weight.to(device))
    opt = torch.optim.SGD(backbone.parameters(), lr=args.lr,
                          momentum=args.momentum, weight_decay=args.weight_decay)
    wopt = torch.optim.SGD([weight], lr=args.lr, momentum=args.momentum,
                           weight_decay=args.weight_decay)
    return backbone, weight, num_valid, opt, wopt


def step_key(key: threefry.Key, epoch: int, step: int) -> threefry.Key:
    """The step's key: ``fold_in(fold_in(key, epoch), step)``
    (``pretrain.py:180``), stable across a resume."""
    return threefry.fold_in(threefry.fold_in(key, epoch), step)


def make_train_step(args, num_valid: int, num_sample: Optional[int]) -> Callable:
    """``step(backbone, weight, opt, wopt, u8, labels, lr, key,
    dropout_gen=None) -> loss`` (a detached device scalar): the flip from
    the step key's first half, the forward in train mode, the full or
    (``num_sample``) sampled Partial-FC loss from its second half, one SGD
    step on each optimizer.  Updates the modules in place."""

    def loss_of(feats, labels, weight, srng):
        if num_sample is None:
            return partial_fc_loss(feats, labels, weight, args.loss, args.scale,
                                   args.margin, num_valid=num_valid)
        return sampled_partial_fc_loss(srng, feats, labels, weight, num_sample,
                                       args.loss, args.scale, args.margin,
                                       num_valid=num_valid)

    def step(backbone: nn.Module, weight: nn.Parameter, opt, wopt,
             u8: torch.Tensor, labels: torch.Tensor, lr: float,
             key: threefry.Key, dropout_gen: Optional[torch.Generator] = None):
        prng, srng = threefry.split(key)
        flip = threefry.uniform_at(
            prng, torch.arange(u8.shape[0], device=u8.device)) < 0.5
        backbone.train()
        x = train_preprocess(flip, u8)
        feats = (backbone(x) if dropout_gen is None
                 else backbone(x, dropout_gen=dropout_gen))
        loss = loss_of(feats, labels, weight, srng)
        for o in (opt, wopt):
            for group in o.param_groups:
                group["lr"] = lr
            o.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        wopt.step()
        return loss.detach()

    return step


def _dropout_gen(args, backbone: nn.Module, epoch: int,
                 device: torch.device) -> Optional[torch.Generator]:
    """iresnet's dropout generator for ``epoch`` (None without dropout)."""
    if not (isinstance(backbone, IResNet) and backbone.dropout > 0):
        return None
    return torch.Generator(device=device).manual_seed(
        (args.seed * 1_000_003 + epoch) * 1_000_003 + 500_009)


def _host(t: torch.Tensor) -> torch.Tensor:
    return t.detach().cpu().contiguous()


def save_outputs(out_dir: str, backbone: nn.Module, weight: torch.Tensor,
                 num_valid: int, labels_all: np.ndarray, opt, wopt,
                 epoch: int) -> None:
    """The epoch's artefacts (``backbone.pth``, ``fc.pth``,
    ``preCos_pretrain_labels.pth``), then the resume state, written to a
    temporary name and renamed, so that a crash never leaves a partial
    one."""
    sd = {k: _host(v) for k, v in backbone.state_dict().items()}
    torch.save(sd, os.path.join(out_dir, "backbone.pth"))
    torch.save(_host(weight[:num_valid]), os.path.join(out_dir, "fc.pth"))
    torch.save(torch.from_numpy(labels_all.astype(np.int64)),
               os.path.join(out_dir, "preCos_pretrain_labels.pth"))
    path = os.path.join(out_dir, STATE_FILE)
    torch.save({"backbone": sd, "weight": _host(weight),
                "opt": opt.state_dict(), "wopt": wopt.state_dict(),
                "epoch": epoch}, path + ".tmp")
    os.replace(path + ".tmp", path)


def main(args) -> Dict[str, object]:
    """Run the pretraining; returns the run's figures: the logged losses
    ``[(global_step, loss)]``, the epochs trained with their seconds and
    learning rates, the save seconds, the first epoch and the class and
    sample counts."""
    device = resolve_device(args.device)
    logger = init_logging(args.output_dir, log_name="pretrain.log")
    snapshot_source(args.output_dir)  # provenance (reference train.py:50-51)
    if args.scan_blocks:
        logger.info("--scan_blocks has no effect here: the port's modules "
                    "have one layout")
    logger.info("partial-FC over %d model shards", N_SHARDS)

    dataset = public_dataset(args, device)
    num_classes = int(dataset.num_classes)
    labels_all = dataset.all_labels()
    logger.info("public set: %d imgs / %d ids", len(dataset), num_classes)

    backbone, weight, num_valid, opt, wopt = training_state(args, num_classes, device)
    num_sample = (num_sampled(args.sample_rate, weight.shape[0], N_SHARDS)
                  if args.sample_rate < 1.0 else None)
    step = make_train_step(args, num_valid, num_sample)

    state_path = os.path.join(args.output_dir, STATE_FILE)
    start_epoch = 0
    if args.resume and os.path.exists(state_path):
        st = torch.load(state_path, map_location="cpu", weights_only=True)
        backbone.load_state_dict(st["backbone"])
        with torch.no_grad():
            weight.copy_(st["weight"])
        opt.load_state_dict(st["opt"])
        wopt.load_state_dict(st["wopt"])
        start_epoch = int(st["epoch"]) + 1
        logger.info("resumed pretraining at epoch %d", start_epoch)

    milestones = [int(m) for m in args.lr_steps.split(",") if m]
    base_loader = BatchLoader(dataset, args.batch_size, shuffle=True,
                              seed=args.seed, drop_last=True,
                              num_workers=args.num_workers)
    # a resumed run continues the uninterrupted run's shuffle stream
    for _ in range(start_epoch):
        base_loader.rng.permutation(len(dataset))
    loader = DevicePrefetcher(base_loader, device)
    meter = AverageMeter()
    steps_per_epoch = len(base_loader)
    tlog = ThroughputLogger(args.log_every, args.num_epoch * steps_per_epoch,
                            args.batch_size, logger)
    key = threefry.prng_key(args.seed + 7)
    sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" else (lambda: None)
    out = {"losses": [], "epochs": [], "epoch_s": [], "lr": [], "save_s": [],
           "start_epoch": start_epoch, "num_classes": num_classes,
           "num_sample": num_sample, "steps_per_epoch": steps_per_epoch}
    gstep = start_epoch * steps_per_epoch
    try:
        for epoch in range(start_epoch, args.num_epoch):
            lr = args.lr * (0.1 ** sum(1 for m in milestones if m - 1 <= epoch))
            dropout_gen = _dropout_gen(args, backbone, epoch, device)
            t0 = time.perf_counter()
            for step_in_epoch, (u8, labels, _valid) in enumerate(loader.epoch()):
                loss = step(backbone, weight, opt, wopt, u8, labels, lr,
                            step_key(key, epoch, step_in_epoch), dropout_gen)
                gstep += 1
                if gstep % args.log_every == 0:
                    meter.update(float(loss))
                    out["losses"].append((gstep, meter.val))
                tlog(gstep, meter, epoch)
            sync()
            out["epochs"].append(epoch)
            out["epoch_s"].append(time.perf_counter() - t0)
            out["lr"].append(lr)
            logger.info("epoch %d done, lr %.5f", epoch, lr)

            # every --save_every epochs and always on the final one
            if (epoch + 1) % args.save_every != 0 and epoch != args.num_epoch - 1:
                continue
            t0 = time.perf_counter()
            save_outputs(args.output_dir, backbone, weight, num_valid,
                         labels_all, opt, wopt, epoch)
            out["save_s"].append(time.perf_counter() - t0)
            logger.info("epoch %d artefacts and resume state saved in %.3f s",
                        epoch, out["save_s"][-1])
    finally:
        base_loader.close()
    logger.info("pretraining done")
    return out


if __name__ == "__main__":
    main(build_parser().parse_args())
