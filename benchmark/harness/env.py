"""Where a run keeps its caches, set before anything is built.

The port's CUDA kernels build with nvcc into ``build/kernels/`` inside the
checkout (``fedfr_tpu_torch/ops/_build.py``, a fixed path, so only a
checkout's first run compiles).  PyTorch's own caches are pointed inside
the checkout as well, at fixed paths; nothing goes to a fixed ``/tmp``
path.  ``USE_FLAX=0`` keeps a library from loading JAX by itself."""

from __future__ import annotations

import os
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def prepare() -> None:
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(build / "inductor")
    os.environ["USE_FLAX"] = "0"
