"""Public-set pretraining with the class-sharded Partial FC: the port's
counterpart of the repository's ``pretrain.py``, on every GPU of one host.

    python -m fedfr_tpu_torch.pretrain --data_dir .../split_pretrain_6000/client_0000 \
        --network sphnet --output_dir ./pretrain --num_epoch 16 \
        --batch_size 512 --lr 0.05 --sample_rate 1.0

It takes every flag of ``pretrain.py`` plus ``--device`` (``cuda`` by
default, raising without a GPU; ``cpu`` on request).  ``--data_dir`` is a
rec root or a ``synth:`` spec (the public set of ``build_fl_synthetic``;
the spec's ``image_size``/``seed`` must agree with the flags).

The run's devices (``main(args, devices)``; by default every visible GPU,
which ``CUDA_VISIBLE_DEVICES`` limits, or the CPU) form the mesh's
``model`` axis, W shards, as the JAX CLI's ``model_mesh()`` does
(``pretrain.py:48-50``; a device may repeat): pretrain.log says
"partial-FC over W model shards".  Every shard holds a batch shard and a
class shard.  The FC is padded to a multiple of W rows and split into W
fp32 parameter shards, each with its own SGD (``parallel/partial_fc.py``:
the full softmax, or ``--sample_rate < 1`` with ``int(rate * C_pad // W)``
sampled rows a shard).  The batch (``--batch_size`` must be a multiple of
W) is split into W contiguous shards, and the backbone is data-parallel
(``parallel/data_parallel.py``): one replica a shard, BatchNorm over the
whole batch, the gradients summed onto the first device, one SGD step there
and the replicas refreshed from it.  The trunk runs in bf16 under autocast
unless ``--fp32``.  Momentum and weight decay are the JAX package's SGD's;
the learning rate is ``lr * 0.1 ** #{m : m - 1 <= epoch}`` over
``--lr_steps``.  One shard is the plain one-device step.

Randomness follows the JAX CLI's key chain through ``ops/threefry.py``
(JAX's PRNG, bit for bit): ``key = PRNGKey(seed + 7)``, per step
``fold_in(fold_in(key, epoch), step)`` split into the flip's key and the
sampling key (``flip = uniform(prng, (B,)) < 0.5`` over the whole batch,
shard d's sample from ``fold_in(srng, d)``), so that both CLIs consume the
same numbers.  The initial weights are the port's own (seeded
``torch.Generator``s); iresnet's dropout draws from one ``torch.Generator``
a shard, seeded per (seed, epoch, shard).

After every ``--save_every`` epochs and after the last: ``backbone.pth``
(the state_dict in the reference key layout, which ``Server`` loads; also
for ``toy``, where the JAX CLI writes ``backbone.npz``), ``fc.pth`` (the
real classes' rows, gathered) and ``preCos_pretrain_labels.pth``, then the
resume state ``pretrain_state.pt`` (backbone with its BN statistics, the
gathered padded FC weight, both optimizers' momentum, the FC's gathered in
shard order, the epoch).  ``--resume`` continues from it on the same W, replaying the
loader's permutation draws of the epochs already trained; a state padded
for another W raises.  ``pretrain.log`` carries the JAX CLI's lines.
"""

from __future__ import annotations

import argparse
import os
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

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
from .parallel.data_parallel import DataParallel
from .parallel.mesh import (DeviceLike, Mesh, as_device, model_mesh, shard_over,
                            synchronize, visible_devices)
from .parallel.partial_fc import (num_sampled, pad_classes, sharded_partial_fc_loss,
                                  sharded_sampled_partial_fc_loss)
from .utils.device import resolve_device
from .utils.logging import AverageMeter, ThroughputLogger, init_logging
from .utils.snapshot import snapshot_source

STATE_FILE = "pretrain_state.pt"


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
    p.add_argument("--no_native_loader", action="store_true",
                   help="decode rec splits on the Python path (codec.decode on "
                        "a thread pool) instead of the native reader")
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
    return FaceRecordDataset(args.data_dir, use_native=not args.no_native_loader)


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


@dataclass
class PretrainState:
    """The run's trainable state over the mesh's ``model`` axis: the
    data-parallel backbone (shard 0's module holds the state, ``opt`` its
    SGD), the FC's W class shards of ``C_pad / W`` rows with one SGD each,
    and the real class count."""

    mesh: Mesh
    backbone: DataParallel
    weights: List[nn.Parameter]
    num_valid: int
    opt: torch.optim.SGD
    wopts: List[torch.optim.SGD]

    @property
    def devices(self) -> List[torch.device]:
        return self.mesh.axis_devices("model")

    def full_weight(self) -> torch.Tensor:
        """The padded (C_pad, E) FC gathered on the CPU."""
        return torch.cat([_host(w) for w in self.weights])


def training_state(args, num_classes: int,
                   devices: Sequence[DeviceLike]) -> PretrainState:
    """The state of a run over ``devices`` (the ``model`` axis, W shards)
    from ``initial_state``: the FC padded to a multiple of W rows and split
    into W parameter shards, each on its device."""
    mesh = model_mesh(devices=devices)
    devs = mesh.axis_devices("model")
    backbone, weight = initial_state(args, num_classes)
    weight, num_valid = pad_classes(weight, len(devs))
    c_local = weight.shape[0] // len(devs)
    backbone = backbone.to(devs[0])
    weights = [nn.Parameter(weight[d * c_local:(d + 1) * c_local].to(dev, copy=True))
               for d, dev in enumerate(devs)]
    opt = torch.optim.SGD(backbone.parameters(), lr=args.lr,
                          momentum=args.momentum, weight_decay=args.weight_decay)
    wopts = [torch.optim.SGD([w], lr=args.lr, momentum=args.momentum,
                             weight_decay=args.weight_decay) for w in weights]
    return PretrainState(mesh, DataParallel(backbone, devs), weights, num_valid,
                         opt, wopts)


def step_key(key: threefry.Key, epoch: int, step: int) -> threefry.Key:
    """The step's key: ``fold_in(fold_in(key, epoch), step)``
    (``pretrain.py:180``), stable across a resume."""
    return threefry.fold_in(threefry.fold_in(key, epoch), step)


def make_train_step(args, num_valid: int, num_sample: Optional[int]) -> Callable:
    """``step(state, u8, labels, lr, key, dropout_gens=None) -> loss`` (a
    detached scalar on the first device): the flip over the whole batch
    from the step key's first half, the batch split into the W shards, the
    data-parallel forward in train mode, the full or (``num_sample`` rows a
    shard) sampled Partial-FC loss from its second half, the backbone's
    gradients summed onto the first device, one SGD step on each optimizer,
    the replicas refreshed.  Updates the state in place."""

    def loss_of(feats, labels, weights, srng):
        if num_sample is None:
            return sharded_partial_fc_loss(feats, labels, weights, args.loss,
                                           args.scale, args.margin, num_valid=num_valid)
        return sharded_sampled_partial_fc_loss(srng, feats, labels, weights, num_sample,
                                               args.loss, args.scale, args.margin,
                                               num_valid=num_valid)

    def step(state: PretrainState, u8: torch.Tensor, labels: torch.Tensor, lr: float,
             key: threefry.Key, dropout_gens: Optional[List[torch.Generator]] = None):
        prng, srng = threefry.split(key)
        flip = threefry.uniform_at(
            prng, torch.arange(u8.shape[0], device=u8.device)) < 0.5
        mesh, net = state.mesh, state.backbone
        net.train()
        xs = [train_preprocess(f, x) for f, x in zip(shard_over(mesh, flip, "model"),
                                                     shard_over(mesh, u8, "model"))]
        kwargs = (None if dropout_gens is None
                  else [{"dropout_gen": g} for g in dropout_gens])
        feats = net(xs, kwargs)
        loss = loss_of(feats, shard_over(mesh, labels, "model"), state.weights, srng)
        optimizers = [state.opt] + state.wopts
        for o in optimizers:
            for group in o.param_groups:
                group["lr"] = lr
            o.zero_grad(set_to_none=True)
        net.zero_grad()
        loss.backward()
        net.reduce_grads()
        for o in optimizers:
            o.step()
        net.broadcast()
        return loss.detach()

    return step


def _dropout_gens(args, state: PretrainState,
                  epoch: int) -> Optional[List[torch.Generator]]:
    """iresnet's dropout generators for ``epoch``, one a shard (None
    without dropout)."""
    net = state.backbone.module
    if not (isinstance(net, IResNet) and net.dropout > 0):
        return None
    return [torch.Generator(device=dev).manual_seed(
        (args.seed * 1_000_003 + epoch) * 1_000_003 + 500_009 + d)
        for d, dev in enumerate(state.devices)]


def _host(t: torch.Tensor) -> torch.Tensor:
    return t.detach().cpu().contiguous()


def _wopt_state(wopts: Sequence[torch.optim.SGD]) -> dict:
    """The FC shards' SGD states as one SGD state over the gathered
    weight: the momentum buffers concatenated in shard order."""
    sds = [o.state_dict() for o in wopts]
    bufs = [sd["state"].get(0, {}).get("momentum_buffer") for sd in sds]
    state = ({} if any(b is None for b in bufs)
             else {0: {"momentum_buffer": torch.cat([_host(b) for b in bufs])}})
    return {"state": state, "param_groups": sds[0]["param_groups"]}


def _load_wopts(wopts: Sequence[torch.optim.SGD], sd: dict) -> None:
    """``_wopt_state``'s inverse: each shard's rows of the momentum."""
    buf = sd["state"].get(0, {}).get("momentum_buffer")
    for d, o in enumerate(wopts):
        rows = o.param_groups[0]["params"][0].shape[0]
        state = ({} if buf is None
                 else {0: {"momentum_buffer": buf[d * rows:(d + 1) * rows].clone()}})
        o.load_state_dict({"state": state, "param_groups": sd["param_groups"]})


def save_outputs(out_dir: str, state: PretrainState, labels_all: np.ndarray,
                 epoch: int) -> None:
    """The epoch's artefacts (``backbone.pth``, ``fc.pth``,
    ``preCos_pretrain_labels.pth``), then the resume state, written to a
    temporary name and renamed, so that a crash never leaves a partial
    one."""
    sd = {k: _host(v) for k, v in state.backbone.module.state_dict().items()}
    weight = state.full_weight()
    torch.save(sd, os.path.join(out_dir, "backbone.pth"))
    torch.save(weight[:state.num_valid].clone(), os.path.join(out_dir, "fc.pth"))
    torch.save(torch.from_numpy(labels_all.astype(np.int64)),
               os.path.join(out_dir, "preCos_pretrain_labels.pth"))
    path = os.path.join(out_dir, STATE_FILE)
    torch.save({"backbone": sd, "weight": weight, "opt": state.opt.state_dict(),
                "wopt": _wopt_state(state.wopts), "epoch": epoch}, path + ".tmp")
    os.replace(path + ".tmp", path)


def load_resume_state(path: str, state: PretrainState) -> int:
    """Load the resume state at ``path`` into ``state``; returns its
    epoch.  The saved FC must have the padded row count of this run's
    shard count, as the JAX CLI's sharded state must."""
    st = torch.load(path, map_location="cpu", weights_only=True)
    rows = sum(w.shape[0] for w in state.weights)
    if st["weight"].shape[0] != rows:
        raise ValueError(
            f"{path} holds an FC of {st['weight'].shape[0]} padded rows, but "
            f"{state.num_valid} classes over {len(state.weights)} model shards pad to "
            f"{rows}: resume on the shard count that wrote it")
    state.backbone.module.load_state_dict(st["backbone"])
    state.backbone.broadcast()
    c_local = state.weights[0].shape[0]
    with torch.no_grad():
        for d, w in enumerate(state.weights):
            w.copy_(st["weight"][d * c_local:(d + 1) * c_local])
    state.opt.load_state_dict(st["opt"])
    _load_wopts(state.wopts, st["wopt"])
    return int(st["epoch"])


def main(args, devices: Optional[Sequence[DeviceLike]] = None) -> Dict[str, object]:
    """Run the pretraining over ``devices`` (default: every visible GPU,
    or the CPU under ``--device cpu``; a device may repeat); returns the
    run's figures: the logged losses ``[(global_step, loss)]``, the seconds
    before the first epoch, the epochs trained with their seconds and
    learning rates, the save seconds, the first epoch, the class, sample and
    shard counts, and the final ``PretrainState`` (``state``)."""
    t_start = time.perf_counter()
    device = resolve_device(args.device)
    devices = [as_device(d) for d in (devices if devices else visible_devices(device))]
    shards = len(devices)
    if args.batch_size % shards:
        raise ValueError(f"--batch_size {args.batch_size} does not split into {shards} "
                         f"equal model shards (the batch is sharded over the mesh, "
                         f"pretrain.py:183); use a multiple of {shards}")
    logger = init_logging(args.output_dir, log_name="pretrain.log")
    snapshot_source(args.output_dir)  # provenance (reference train.py:50-51)
    if args.scan_blocks:
        logger.info("--scan_blocks has no effect here: the port's modules "
                    "have one layout")
    logger.info("partial-FC over %d model shards", shards)

    dataset = public_dataset(args, devices[0])
    num_classes = int(dataset.num_classes)
    labels_all = dataset.all_labels()
    logger.info("public set: %d imgs / %d ids", len(dataset), num_classes)

    state = training_state(args, num_classes, devices)
    c_pad = sum(w.shape[0] for w in state.weights)
    num_sample = (num_sampled(args.sample_rate, c_pad, shards)
                  if args.sample_rate < 1.0 else None)
    step = make_train_step(args, state.num_valid, num_sample)

    state_path = os.path.join(args.output_dir, STATE_FILE)
    start_epoch = 0
    if args.resume and os.path.exists(state_path):
        start_epoch = load_resume_state(state_path, state) + 1
        logger.info("resumed pretraining at epoch %d", start_epoch)

    milestones = [int(m) for m in args.lr_steps.split(",") if m]
    base_loader = BatchLoader(dataset, args.batch_size, shuffle=True,
                              seed=args.seed, drop_last=True,
                              num_workers=args.num_workers)
    # a resumed run continues the uninterrupted run's shuffle stream
    for _ in range(start_epoch):
        base_loader.rng.permutation(len(dataset))
    loader = DevicePrefetcher(base_loader, devices[0])
    meter = AverageMeter()
    steps_per_epoch = len(base_loader)
    tlog = ThroughputLogger(args.log_every, args.num_epoch * steps_per_epoch,
                            args.batch_size, logger)
    key = threefry.prng_key(args.seed + 7)
    out = {"losses": [], "epochs": [], "epoch_s": [], "lr": [], "save_s": [],
           "start_epoch": start_epoch, "num_classes": num_classes,
           "num_sample": num_sample, "num_shards": shards,
           "steps_per_epoch": steps_per_epoch, "state": state}
    gstep = start_epoch * steps_per_epoch
    out["setup_s"] = time.perf_counter() - t_start
    try:
        for epoch in range(start_epoch, args.num_epoch):
            lr = args.lr * (0.1 ** sum(1 for m in milestones if m - 1 <= epoch))
            dropout_gens = _dropout_gens(args, state, epoch)
            t0 = time.perf_counter()
            for step_in_epoch, (u8, labels, _valid) in enumerate(loader.epoch()):
                loss = step(state, u8, labels, lr, step_key(key, epoch, step_in_epoch),
                            dropout_gens)
                gstep += 1
                if gstep % args.log_every == 0:
                    meter.update(float(loss))
                    out["losses"].append((gstep, meter.val))
                tlog(gstep, meter, epoch)
            synchronize(devices)
            out["epochs"].append(epoch)
            out["epoch_s"].append(time.perf_counter() - t0)
            out["lr"].append(lr)
            logger.info("epoch %d done, lr %.5f", epoch, lr)

            # every --save_every epochs and always on the final one
            if (epoch + 1) % args.save_every != 0 and epoch != args.num_epoch - 1:
                continue
            t0 = time.perf_counter()
            save_outputs(args.output_dir, state, labels_all, epoch)
            out["save_s"].append(time.perf_counter() - t0)
            logger.info("epoch %d artefacts and resume state saved in %.3f s",
                        epoch, out["save_s"][-1])
    finally:
        base_loader.close()
    logger.info("pretraining done")
    return out


if __name__ == "__main__":
    main(build_parser().parse_args())
