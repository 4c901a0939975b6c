"""Build the port's CUDA kernels from the sources in ``fedfr_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` exposes plain C functions and is compiled by ``nvcc``
into its own shared library under ``build/kernels/`` at the repository root,
then loaded with ``ctypes``.  A library is named by a hash of its source and
flags, so an edited source builds anew and an unchanged one is reused.
Nothing here runs at import: the first launch builds, or a caller builds
every kernel at once with ``build_kernels`` (one ``nvcc`` per source, all
started together).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
build_seconds: Dict[str, float] = {}
ptxas_info: Dict[str, str] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                       "port's CUDA kernels cannot be built")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build_kernels(names: Iterable[str]) -> Dict[str, ctypes.CDLL]:
    """Build (where not built yet) and load every named kernel library.

    The ``nvcc`` runs start together and are all waited for; a failed run
    raises with nvcc's stderr.
    """
    with _lock:
        todo = [n for n in names if n not in _libs]
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name in todo:
            out = _target(name)
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.PIPE, text=True),
                           tmp, out, time.perf_counter())
        failures = []
        for name, (proc, tmp, out, t0) in procs.items():
            stdout, stderr = proc.communicate()
            build_seconds[name] = time.perf_counter() - t0
            ptxas_info[name] = stderr
            if proc.returncode != 0:
                failures.append(f"nvcc failed for csrc/{name}.cu "
                                f"(exit {proc.returncode}):\n{stdout}{stderr}")
            else:
                os.replace(tmp, out)  # atomic: a concurrent build sees all or none
        if failures:
            raise RuntimeError("\n".join(failures))
        for name in todo:
            _libs[name] = ctypes.CDLL(str(_target(name)))
        return {n: _libs[n] for n in names}


def load_kernel(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    lib = _libs.get(name)
    return lib if lib is not None else build_kernels([name])[name]
