"""IJB-C evaluation CLI of the PyTorch port: the counterpart of the
repository's ``ijbc_all.py``, with its flags plus ``--device``.

    python -m fedfr_tpu_torch.ijbc_all --model-prefix ckpt/backbone_5.pth \
        --root-path /data/IJBC --result-dir ckpt --epoch 5 --batch-size 256 \
        --network sphnet --job both

``--model-prefix`` is a port ``.pth`` (a state_dict in the reference key
layout) or a JAX ``.npz``.  The aligned images come from
``<root-path>/IJBC_imgs.npy`` when it exists, else from the loose crops
(cv2 needed).  It runs on ``cuda`` by default (raising without a GPU) with
the device engine; ``--device cpu`` runs the host engine on the CPU.  On
a host with more than one GPU the embed runs over every visible GPU (the
mesh's ``data`` axis); the device engine's scoring stays on the first.
Appends ``<result-dir>/ijbc-1:1/log.txt`` (the TPR@FPR table; the scores go
to ``ijbc.npy``) and ``<result-dir>/ijbc-1:n/log.txt`` (top-k, TPIR@FPIR).
"""

from __future__ import annotations

import argparse
from typing import Dict

import numpy as np
import torch
from torch import nn

from .evalsuite.ijbc import run_ijbc
from .models import build_backbone
from .utils.checkpoint import load_backbone_state
from .utils.device import resolve_device


def build_parser() -> argparse.ArgumentParser:
    """Every flag of the repository's ijbc_all.py, plus ``--device``."""
    p = argparse.ArgumentParser(description="do ijb test, PyTorch port")
    p.add_argument("--model-prefix", default="", help="path to load model")
    p.add_argument("--root-path", default="", type=str)
    p.add_argument("--result-dir", default=".", type=str)
    p.add_argument("--epoch", type=int, default=0)
    p.add_argument("--batch-size", default=128, type=int)
    p.add_argument("--network", default="sphnet", type=str)
    p.add_argument("--embedding_size", default=512, type=int)
    p.add_argument("--job", default="1:1", type=str, help="1:1 or 1:n or both")
    p.add_argument("--target", default="IJBC", type=str)
    p.add_argument("--load_feature", default="",
                   help="path to pre-forwarded features (.npy)")
    p.add_argument("--use_flip_test", action="store_true")
    p.add_argument("--fp32", action="store_true")
    p.add_argument("--engine", default="auto", choices=["auto", "device", "host"],
                   help="scoring engine: device keeps the features on the card "
                        "end to end (the default on cuda), host is the numpy "
                        "pipeline (the default on cpu)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="torch device of the run")
    return p


def load_model(network: str, embedding_size: int, path: str, fp32: bool,
               device: torch.device) -> nn.Module:
    """The backbone of ``path`` (``.pth`` or ``.npz``) on ``device``, in
    eval mode."""
    net = build_backbone(network, embedding_size, bf16=not fp32)
    net.load_state_dict(load_backbone_state(network, path))
    return net.to(device).eval()


def main(args) -> Dict[str, object]:
    device = resolve_device(args.device)
    preloaded = np.load(args.load_feature) if args.load_feature else None
    model = (None if preloaded is not None else
             load_model(args.network, args.embedding_size, args.model_prefix,
                        args.fp32, device))
    results = run_ijbc(model, args.root_path, args.result_dir, epoch=args.epoch,
                       job=args.job, batch_size=args.batch_size,
                       use_flip_test=args.use_flip_test, target=args.target,
                       preloaded_feats=preloaded, engine=args.engine, device=device)
    print(results)
    return results


if __name__ == "__main__":
    main(build_parser().parse_args())
