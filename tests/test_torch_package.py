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

import torch_threads  # noqa: F401  (each xdist worker's share of the cores)

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


def _imports(tree):
    """(module name, enclosing function or None) of every absolute import."""
    found = []

    def visit(node, func):
        for child in ast.iter_child_nodes(node):
            inner = (child.name if isinstance(child, (ast.FunctionDef,
                                                      ast.AsyncFunctionDef))
                     else func)
            if isinstance(child, ast.Import):
                found.extend((a.name, func) for a in child.names)
            elif isinstance(child, ast.ImportFrom) and child.level == 0:
                found.append((child.module or "", func))
            visit(child, inner)

    visit(tree, None)
    return found


# imports of pandas, scikit-learn or cv2 that earlier slices keep on optional
# paths the card never takes: the rec codec's guarded JPEG decoder (raw
# payloads need none; PIL is its fallback), the .bin loader's resize of
# images that are not 112x112 already, and PCA before the k-fold threshold
# sweep (pca > 0; the reference's default is 0); and the smoke's JPEG
# encoder for its native-reader phase, imported only where the machine has
# cv2 (else PIL)
OPTIONAL_IMPORTS = {
    "chip_smoke.py": [("cv2", "jpeg_encoder")],
    "fedfr_tpu_torch/data/codec.py": [("cv2", None)],
    "fedfr_tpu_torch/evalsuite/verification.py": [("cv2", "_resize_short")],
    "fedfr_tpu_torch/ops/kfold.py": [("sklearn", "calculate_roc")],
}


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO)) for p in list(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]))
def test_source_imports_no_pandas_or_sklearn_and_cv2_only_in_align_face(path):
    """The card's machine has neither pandas nor scikit-learn, and the
    port's rec reading no longer needs cv2 (the native reader carries its
    own JPEG decoder): the port reads the IJB-C meta files and draws the ROC
    in numpy, and imports cv2 for IJB-C only inside ``align_face`` (aligning
    loose crops); the optional imports are listed in OPTIONAL_IMPORTS."""
    found = _imports(ast.parse((REPO / path).read_text(), filename=path))
    got = [(m.split(".")[0], func) for m, func in found
           if m.split(".")[0] in ("pandas", "sklearn", "cv2")]
    want = {"fedfr_tpu_torch/evalsuite/align.py": [("cv2", "align_face")],
            **OPTIONAL_IMPORTS}.get(path, [])
    assert got == want


@pytest.mark.parametrize("module", ["pretrain", "ijbc_all", "ijbc_conti"])
def test_slice_9_entry_points_default_to_cuda_and_raise_without_it(module, monkeypatch,
                                                                   tmp_path):
    """``python -m fedfr_tpu_torch.{pretrain,ijbc_all,ijbc_conti}`` run on
    ``cuda`` unless ``--device cpu``, and raise with no GPU before any
    work."""
    import importlib

    cli = importlib.import_module(f"fedfr_tpu_torch.{module}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = {"pretrain": ["--data_dir", "synth:", "--output_dir", str(tmp_path)],
            "ijbc_all": ["--root-path", str(tmp_path)],
            "ijbc_conti": ["--ckpt_dir", str(tmp_path), "--epoch", "0"]}[module]
    args = cli.build_parser().parse_args(argv)
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(args)
    assert os.listdir(tmp_path) == []


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


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    import chip_smoke

    root = str(tmp_path_factory.mktemp("torch_package"))
    chip_smoke.write_fl_split(root, 2, 3, imgs_per_id=4, pub_ids=4, pub_imgs=2,
                              size=16, seed=0, veri_imgs=2)
    return root


@pytest.mark.parametrize("option", ["plain", "spreadout", "fc", "cache_contrastive"])
def test_unported_options_raise(option, tiny_root):
    """The four ``Server`` options that raised before the paths of the
    plain objective, SpreadOut, FC-row mining and the cached contrastive
    step were ported: the server now builds on the CPU under each, with a
    global FC exactly when the joint objective needs one."""
    from fedfr_tpu_torch.config import FedFRConfig
    from fedfr_tpu_torch.data import AllClientData
    from fedfr_tpu_torch.federated import Server

    cfg = FedFRConfig()
    cfg.runtime.device = "cpu"
    cfg.data.rec_root = tiny_root
    cfg.data.num_clients, cfg.data.num_ids = 2, 6
    cfg.data.image_size, cfg.data.num_workers = 16, 1
    cfg.model.network, cfg.model.embedding_size = "toy", 8
    cfg.fed.add_pretrained_data = option != "plain"
    cfg.fed.spreadout = option == "spreadout"
    cfg.fed.hn_strategy = "fc" if option == "fc" else "feature"
    cfg.fed.cache_contrastive = option == "cache_contrastive"
    server = Server(cfg, AllClientData(cfg))
    assert len(server.clients) == 2
    assert (server.pretrained_fc is None) == (option == "plain")


def test_check_flags_accepts_lockstep_and_remat():
    """``--lockstep 2`` and ``--remat`` (ROADMAP queue A item 13) pass the
    training CLI's flag check, alone and together."""
    from fedfr_tpu_torch import train as train_cli

    parser = train_cli.build_parser()
    for argv in (["--lockstep", "2"], ["--remat"], ["--lockstep", "2", "--remat"]):
        train_cli.check_flags(parser.parse_args(argv))


def test_client_parallel_imports_no_jax_and_no_fedfr_tpu():
    """``parallel/client_parallel.py``, imported alone in a fresh
    interpreter, names and loads no jax and nothing of ``fedfr_tpu``."""
    path = PORT / "parallel" / "client_parallel.py"
    tree = ast.parse(path.read_text(), filename=str(path))
    assert [m for m, _ in _imports(tree) if _forbidden(m)] == []
    code = ("import json, sys\n"
            "import fedfr_tpu_torch.parallel.client_parallel\n"
            "print(json.dumps(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                         capture_output=True, text=True, timeout=120)
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert "fedfr_tpu_torch.parallel.client_parallel" in loaded
    assert [m for m in loaded if _forbidden(m)] == []


def test_xdist_worker_runs_torch_on_its_share_of_the_cores():
    """``tests/torch_threads.py``: under pytest-xdist each worker's torch
    runs ``cores // workers`` intra-op threads, at least one."""
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if not workers:
        pytest.skip("not under pytest-xdist: torch keeps its default")
    share = max(1, len(os.sched_getaffinity(0)) // int(workers))
    assert torch.get_num_threads() == share
