"""Multi-epoch IJB-C eval of the PyTorch port (the counterpart of the
repository's ``ijbc_conti.py``): in process over ``--epoch e1 e2 ...``,
reading ``<ckpt_dir>/backbone_<e>.pth`` (or ``.npz``), with the model built
once and the aligned-image cache (``<root_path>/IJBC_imgs.npy``) reused
across the epochs.

    python -m fedfr_tpu_torch.ijbc_conti --ckpt_dir ckpt --root_path /data/IJBC \
        --epoch 10 15 19 --job 1:1

Each epoch appends to ``<ckpt_dir>/ijbc-1:1/log.txt`` (and ``ijbc-1:n``).
``--gpu`` is accepted and ignored (the reference's device list); the run
takes ``--device`` (``cuda`` by default, raising without a GPU).
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List

from .evalsuite.ijbc import run_ijbc
from .models import build_backbone
from .utils.checkpoint import load_backbone_state
from .utils.device import resolve_device


def build_parser() -> argparse.ArgumentParser:
    """Every flag of the repository's ijbc_conti.py, plus ``--device``."""
    p = argparse.ArgumentParser(description="multi-epoch IJB-C, PyTorch port")
    p.add_argument("--ckpt_dir")
    p.add_argument("--root_path", default="")
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--job", default="1:1")
    p.add_argument("--epoch", type=int, nargs="+")
    p.add_argument("--network", default="sphnet")
    p.add_argument("--embedding_size", type=int, default=512)
    p.add_argument("--engine", default="auto", choices=["auto", "device", "host"],
                   help="scoring engine (see fedfr_tpu_torch.ijbc_all)")
    p.add_argument("--gpu", type=str, nargs="+", default=None,
                   help="accepted for reference-command compatibility; the "
                        "device is --device")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="torch device of the run")
    return p


def main(args) -> List[Dict[str, object]]:
    device = resolve_device(args.device)
    model = build_backbone(args.network, args.embedding_size).to(device).eval()
    out = []
    for e in args.epoch:
        path = os.path.join(args.ckpt_dir, f"backbone_{e}.pth")
        if not os.path.exists(path):
            path = os.path.join(args.ckpt_dir, f"backbone_{e}.npz")
        model.load_state_dict(load_backbone_state(args.network, path))
        print(f"=== epoch {e}: {path} ===")
        out.append(run_ijbc(model, args.root_path, args.ckpt_dir, epoch=e,
                            job=args.job, batch_size=args.batch_size,
                            engine=args.engine, device=device))
    return out


if __name__ == "__main__":
    main(build_parser().parse_args())
