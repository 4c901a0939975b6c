"""Post-training personalized evaluation CLI of the PyTorch port.

The counterpart of the repository's ``local_all.py`` (reference
local_all.py:224-454), with its flags plus ``--device``:

    python -m fedfr_tpu_torch.local_all --backbone multi --task 1:1 \\
        --ckpt_path ./ckpt/FedFR --data_dir DATA/local_veri_4000 \\
        --num_client 40 --num_ids 4000 --network sphnet

* ``--backbone multi``: for each client, its backbone
  ``clients/client_<c>/backbone[_<epoch>].pth`` (or ``.npz``) and, where
  there is one, its ``bce_module[_<epoch>].pth`` (or ``.npz``), whose
  converter maps the backbone's features before they are normalized.
* ``--backbone single``: one global ``backbone_<epoch>.pth`` (or ``.npz``).
* ``--task 1:1``: each client's TPR@FPR table over the local veri set, from
  the ROC-histogram kernel (``evalsuite.local_eval.local_11_roc``; one
  launch per client on the card).
* ``--task 1:n``: per-client galleries of class-mean features from
  ``--gallery_data_dir`` (``local_gallery_<N>``, global labels, as
  ``split_dataset/split_FL.py`` writes it) and the open-set TPIR@FPIR.

On a host with more than one GPU the embeds and the 1:1 histograms run
over every visible GPU (the mesh's ``data`` axis, ``parallel/mesh.py::
auto_data_mesh``), as the JAX CLI's run over every device.

A ``synth:`` spec as ``--data_dir`` (the training run's string) evaluates
on the device-generated universe: the veri set is its veri split and each
client's 1:n gallery is its own train images, as ``split_FL.py`` routes
them (JAX local_all.py:44-70); the spec and the flags must agree on the
clients and their IDs, and the veri split must cover ``--num_ids``.

``.pth`` files are the port's and the reference's state_dicts; ``.npz``
files are the JAX package's variable trees.  The means are appended to
``<ckpt_path>/local_log.txt`` in the JAX CLI's format, beside the per-client
lines, which ``parse_log.py`` reads.  It runs on the GPU (``--device
cuda``, the default, raising without one) unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .data.datasets import FaceRecordDataset
from .data.synthetic import build_fl_synthetic, is_synth_spec, parse_synth_spec
from .evalsuite.local_eval import (client_query_mask, local_11_roc,
                                   mean_tpr_tables, open_set_identification)
from .federated.embed import class_mean_features, embed_dataset
from .models import BCEModule, build_backbone
from .utils.checkpoint import load_backbone_state, load_bce_state
from .utils.device import resolve_device

FARS = (1e-6, 1e-5, 1e-4, 1e-3)


def build_parser() -> argparse.ArgumentParser:
    """Every flag of the repository's local_all.py, plus ``--device``."""
    p = argparse.ArgumentParser(description="FedFR personalized eval, PyTorch port")
    p.add_argument("--backbone", type=str, default="multi",
                   choices=["multi", "single"])
    p.add_argument("--task", default="1:1", choices=["1:1", "1:n"])
    p.add_argument("--ckpt_path")
    p.add_argument("--data_dir", type=str, default="")
    p.add_argument("--gallery_data_dir", type=str, default="")
    p.add_argument("--epoch", type=int, default=-1)
    p.add_argument("--num_client", type=int, default=40)
    p.add_argument("--num_ids", type=int, default=4000,
                   help="total FL identities (reference convention: 4000)")
    p.add_argument("--embedding_size", type=int, default=512)
    p.add_argument("--network", default="sphnet")
    p.add_argument("--gpu", type=str, nargs="+", default=None,
                   help="accepted for reference-command compatibility")
    p.add_argument("--fp16", action="store_true",
                   help="reference-compat alias (bf16 trunk is default)")
    p.add_argument("--batch_size", type=int, default=512)
    p.add_argument("--fp32", action="store_true")
    p.add_argument("--no_native_loader", action="store_true",
                   help="decode rec splits on the Python path (codec.decode on "
                        "a thread pool) instead of the native reader")
    p.add_argument("--converter_layer", type=int, default=1,
                   help="BCE transformation layer used in training: "
                        "1=linear, else BottleBlock")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="torch device (cpu: the kernels' plain versions)")
    return p


def _existing(base: str, stem: str) -> Optional[str]:
    """``<base>/<stem>.pth``, else ``<base>/<stem>.npz``, else None."""
    for ext in (".pth", ".npz"):
        path = os.path.join(base, stem + ext)
        if os.path.exists(path):
            return path
    return None


def _append(log_dir: str, text: str) -> None:
    with open(os.path.join(log_dir, "local_log.txt"), "a") as f:
        f.write(text)


def synth_universe(args, device) -> Dict[str, object]:
    """The ``synth:`` universe of ``--data_dir``, after JAX's two checks:
    the spec's clients and IDs per client equal the flags', and its veri
    split covers every client's ID range."""
    spec = parse_synth_spec(args.data_dir)
    for key, val in (("clients", args.num_client),
                     ("ids_per_client", args.num_ids // args.num_client)):
        if spec[key] != val:
            raise ValueError(
                f"synth spec has {key}={spec[key]} but the CLI flags imply "
                f"{key}={val}; they must agree (identity alignment with the "
                "trained checkpoints depends on it)")
    if spec["veri_ids"] < args.num_ids:
        raise ValueError(
            f"synth spec veri_ids={spec['veri_ids']} does not cover "
            f"num_ids={args.num_ids}; every client's global ID range must "
            "appear in the veri split")
    return build_fl_synthetic(spec, device)


def main(args) -> Dict[str, List]:
    """Run the evaluation; returns the per-client tables (1:1) or TPIR
    lists (1:n) under ``per_client`` and their mean under ``mean``."""
    device = resolve_device(args.device)
    # a Namespace of the JAX CLI's flags alone reads natively
    native = not getattr(args, "no_native_loader", False)
    universe = None
    if is_synth_spec(args.data_dir):
        universe = synth_universe(args, device)
        veri = universe["veri"]
        image_size = veri.image_size
    else:
        veri = FaceRecordDataset(args.data_dir, prefix="test", use_native=native)
        image_size = veri.read(0)[0].shape[0]
    ids_per_client = args.num_ids // args.num_client
    net = build_backbone(args.network, args.embedding_size, bf16=not args.fp32,
                         image_size=image_size).to(device).eval()
    bce = BCEModule(args.embedding_size, ids_per_client,
                    converter_layers=args.converter_layer).to(device).eval()
    log_dir = args.ckpt_path
    suffix = "" if args.epoch == -1 else f"_{args.epoch}"

    def embed(dataset, converter=None) -> Tuple[torch.Tensor, np.ndarray]:
        return embed_dataset(net, dataset, args.batch_size, device=device,
                             converter=converter)

    def load_client(c: int):
        """Load client c's backbone (and converter, if it has one) into the
        eval modules; returns the converter or None."""
        base = os.path.join(args.ckpt_path, "clients", f"client_{c}")
        path = _existing(base, f"backbone{suffix}")
        if path is None:
            raise FileNotFoundError(f"no backbone checkpoint in {base}")
        net.load_state_dict(load_backbone_state(args.network, path))
        path = _existing(base, f"bce_module{suffix}")
        if path is None:
            return None
        bce.load_state_dict(load_bce_state(path))
        return bce.converter

    def one_to_n(feats, labels, gallery_means, start, end):
        mask = client_query_mask(labels, start, end)
        res, _ = open_set_identification(feats.cpu().numpy(),
                                         gallery_means.cpu().numpy(), mask)
        return res

    per_client = []
    if args.backbone == "single":
        if args.task == "1:1":
            _append(log_dir, "1:1 at Epoch : %d\n" % args.epoch)
        path = _existing(args.ckpt_path, f"backbone_{args.epoch}")
        if path is None:
            raise FileNotFoundError(f"no backbone_{args.epoch} checkpoint in "
                                    f"{args.ckpt_path}")
        net.load_state_dict(load_backbone_state(args.network, path))
        feats, labels = embed(veri)
        if args.task == "1:n":
            if universe is not None:
                # every client's train images under their global labels
                parts = [(embed(d), d.id_base) for d in universe["clients"]]
                gfeats = torch.cat([f for (f, _), _ in parts])
                glabels = np.concatenate([lb + base for (_, lb), base in parts])
            else:
                gfeats, glabels = embed(FaceRecordDataset(
                    args.gallery_data_dir, prefix="test", use_native=native))
            gallery_means = class_mean_features(gfeats, glabels, args.num_ids)
        for c in range(args.num_client):
            start, end = c * ids_per_client, (c + 1) * ids_per_client
            if args.task == "1:1":
                per_client.append(local_11_roc(feats, labels, start, end,
                                               epoch=args.epoch, output_dir=log_dir))
            else:
                per_client.append(one_to_n(feats, labels,
                                           gallery_means[start:end], start, end))
    else:
        if args.task == "1:n" and universe is None:
            gallery = FaceRecordDataset(args.gallery_data_dir, prefix="test",
                                        use_native=native)
            gallery_labels = gallery.all_labels()
        for c in range(args.num_client):
            print(f"Process client {c}...")
            converter = load_client(c)
            feats, labels = embed(veri, converter)
            start, end = c * ids_per_client, (c + 1) * ids_per_client
            if args.task == "1:1":
                per_client.append(local_11_roc(feats, labels, start, end,
                                               epoch=args.epoch, output_dir=log_dir))
                continue
            if universe is not None:
                # client c's train images are its gallery, labelled locally
                gfeats, glabels = embed(universe["clients"][c], converter)
                gal_base = 0
            else:
                keep = (gallery_labels >= start) & (gallery_labels < end)
                gfeats, glabels = embed(gallery.subset(np.nonzero(keep)[0] + 1),
                                        converter)
                gal_base = start  # rec gallery labels are global
            gallery_means = class_mean_features(gfeats, glabels - gal_base,
                                                ids_per_client)
            per_client.append(one_to_n(feats, labels, gallery_means, start, end))

    if args.task == "1:1":
        mean = mean_tpr_tables(per_client)
        print("-" * 40)
        print("1:1 average results (-6 to -1):")
        print("%r" % ["%.2f" % v for v in mean])
        _append(log_dir, "Mean (-6 to -1):\n[" + "".join("%.2f " % v for v in mean)
                + "]\n")
    else:
        mean = [float(v) for v in np.mean(np.asarray(per_client), axis=0)]
        print("-" * 40)
        print("1:n average results:")
        print("Far: %r" % ["%.1e" % far for far in FARS])
        print("Pr : %r" % ["%.5f" % pr for pr in mean])
        _append(log_dir, "1:n at Epoch : %d\n" % args.epoch
                + "Far: %r\n" % ["%.1e" % far for far in FARS]
                + "Pr : %r\n" % ["%.5f" % pr for pr in mean])
    return {"per_client": per_client, "mean": mean}


if __name__ == "__main__":
    main(build_parser().parse_args())
