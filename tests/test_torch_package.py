"""Package rules of the PyTorch port: no JAX, nothing of ``fedfr_tpu``, and
entry points that run on CUDA unless asked for the CPU."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "fedfr_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "fedfr_tpu")


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def test_import_loads_no_jax_and_no_fedfr_tpu():
    """Importing every module of the port, in a fresh interpreter, adds no
    jax/flax and no fedfr_tpu module to sys.modules."""
    modules = []
    for p in sorted(PORT.rglob("*.py")):
        parts = p.relative_to(REPO).with_suffix("").parts
        modules.append(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    code = ("import importlib, json, sys\n"
            "before = set(sys.modules)\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "print(json.dumps(sorted(set(sys.modules) - before)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                         capture_output=True, text=True, timeout=120)
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert "fedfr_tpu_torch.federated.server" in loaded
    assert [m for m in loaded if _forbidden(m)] == []


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO)) for p in list(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]))
def test_source_imports_no_jax_and_no_fedfr_tpu(path):
    tree = ast.parse((REPO / path).read_text(), filename=path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    assert [n for n in names if _forbidden(n)] == []


def test_entry_points_raise_without_cuda(monkeypatch):
    """With no GPU and no device='cpu', Server and embed_dataset raise;
    nothing carries on on the CPU."""
    from fedfr_tpu_torch.config import FedFRConfig
    from fedfr_tpu_torch.federated import Server, embed_dataset
    from fedfr_tpu_torch.models import ToyNet

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = FedFRConfig()
    assert cfg.runtime.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Server(cfg, data=None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        embed_dataset(ToyNet(8), dataset=None)


def test_unported_options_raise():
    from fedfr_tpu_torch.config import FedFRConfig
    from fedfr_tpu_torch.federated import Server

    cfg = FedFRConfig()
    cfg.runtime.device = "cpu"
    cfg.fed.spreadout = True
    with pytest.raises(NotImplementedError, match="spreadout"):
        Server(cfg, data=None)
