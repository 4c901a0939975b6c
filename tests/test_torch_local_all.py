"""The port's post-training eval CLI (``python -m fedfr_tpu_torch.local_all``)
against the repository's ``local_all.py``, on the CPU.

Both CLIs read the same exports: per-client toy backbones written by the
JAX package's own npz writer, Linear BCE converters written by its torch
bridge, and a global ``backbone_0.npz``, over data written by
chip_smoke.py's writers (local_veri and local_gallery in split_FL.py's
layout).  The per-client 1:1 TPR tables and their mean agree within the
eval tolerance of tests/test_torch_eval.py, 100 / n_pos + 0.01 (a
positive pair moving one bin), and
the 1:n TPIR lists within 1e-6; with dyadic features (every dot exact in
fp32) put in place of both CLIs' embeddings, ``local_log.txt`` is byte for
byte the same.  Then a round trip on the port's own ``.pth`` exports from
toy and iresnet18 (dropout, freeze_bn, BottleBlock) CPU runs of its
training CLI.
"""

import argparse
import os
import re
import shutil

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import chip_smoke
import local_1n as jax_local_1n
import local_all as jax_local_all
import parse_log
from fedfr_tpu.federated import embed as jembed
from fedfr_tpu.models import BCEModule as JBCE
from fedfr_tpu.models.factory import ToyNet as JToy
from fedfr_tpu.utils import torch_interop as ti
from fedfr_tpu.utils.checkpoint import save_native

from fedfr_tpu_torch import local_1n, local_all
from fedfr_tpu_torch import train as train_cli

import torch_threads  # noqa: F401  (each xdist worker's share of the cores)

CLIENTS, IDS, IMG, EMB, VERI = 2, 3, 16, 16, 6
N_POS = IDS * VERI * (VERI - 1) // 2   # positive pairs of one client's targets
TPR_TOL = 100.0 / N_POS + 0.01
NUMBER = re.compile(r"-?\d+(\.\d+)?(e-?\d+)?")


@pytest.fixture(autouse=True)
def _fp32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("local_all"))
    chip_smoke.write_fl_split(root, CLIENTS, IDS, imgs_per_id=8, pub_ids=6,
                              pub_imgs=5, size=IMG, seed=0, veri_imgs=VERI)
    return root


@pytest.fixture(scope="module")
def jax_exports(tmp_path_factory):
    """clients/client_<c>/{backbone.npz, bce_module.pth} and backbone_0.npz,
    written by the JAX package's writers."""
    out = str(tmp_path_factory.mktemp("jax_exports"))
    jnet = JToy(embedding_size=EMB)
    jbce = JBCE(hidden=EMB, n_class=IDS)
    x0 = jnp.zeros((1, IMG, IMG, 3))
    rng = np.random.default_rng(3)
    for c in range(CLIENTS):
        cdir = os.path.join(out, "clients", f"client_{c}")
        os.makedirs(cdir)
        save_native(jax.device_get(jnet.init(jax.random.PRNGKey(10 + c), x0)),
                    os.path.join(cdir, "backbone.npz"))
        bvars = jax.tree_util.tree_map(np.array, jbce.init(
            jax.random.PRNGKey(20 + c), jnp.zeros((1, EMB)),
            jnp.zeros((1,), jnp.int32)))
        bvars["params"]["converter"]["dense"]["kernel"] += (
            0.3 * rng.standard_normal((EMB, EMB)).astype(np.float32))
        ti.save_pth(ti.bce_to_torch(bvars), os.path.join(cdir, "bce_module.pth"))
    save_native(jax.device_get(jnet.init(jax.random.PRNGKey(30), x0)),
                os.path.join(out, "backbone_0.npz"))
    return out


def _args(data_root, ckpt, backbone, task, epoch=-1, network="toy",
          converter_layer=1):
    n = CLIENTS * IDS
    return argparse.Namespace(
        backbone=backbone, task=task, ckpt_path=ckpt,
        data_dir=os.path.join(data_root, f"local_veri_{n}"),
        gallery_data_dir=os.path.join(data_root, f"local_gallery_{n}"),
        epoch=epoch, num_client=CLIENTS, num_ids=n, embedding_size=EMB,
        network=network, gpu=None, fp16=False, batch_size=16, fp32=True,
        converter_layer=converter_layer, device="cpu")


def _run_both(data_root, jax_exports, tmp_path, backbone, task, epoch):
    """Both CLIs on copies of the same exports; returns their local_log
    lines (JAX, port) and the port's result."""
    logs = []
    result = None
    for side in ("jax", "port"):
        ckpt = str(tmp_path / side)
        shutil.copytree(jax_exports, ckpt)
        args = _args(data_root, ckpt, backbone, task, epoch)
        if side == "jax":
            jax_local_all.main(args)
        else:
            result = local_all.main(args)
        with open(os.path.join(ckpt, "local_log.txt")) as f:
            logs.append(f.read().splitlines())
    return logs[0], logs[1], result


def _numbers(line):
    return [float(m.group(0)) for m in NUMBER.finditer(line)]


CASES = [("multi", "1:1", -1), ("single", "1:1", 0), ("multi", "1:n", -1)]
IDS_OF = ["multi-1:1", "single-1:1", "multi-1:n"]


@pytest.mark.parametrize("backbone,task,epoch", CASES, ids=IDS_OF)
def test_local_all_matches_jax(data_root, jax_exports, tmp_path, backbone,
                               task, epoch):
    jlines, lines, result = _run_both(data_root, jax_exports, tmp_path,
                                      backbone, task, epoch)
    assert len(lines) == len(jlines) > 0
    for got, want in zip(lines, jlines):
        # the same line, apart from the numbers
        assert NUMBER.sub("#", got) == NUMBER.sub("#", want)
        a, b = _numbers(got), _numbers(want)
        assert len(a) == len(b)
        if got.startswith(("Target label", "1:1 at", "1:n at", "Far")):
            assert a == b
        elif got.startswith("Pr"):
            np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
        else:  # per-client tables and their mean: percentages
            np.testing.assert_allclose(a[1:] if got.startswith("Epoch") else a,
                                       b[1:] if want.startswith("Epoch") else b,
                                       atol=TPR_TOL, rtol=0)
            if got.startswith("Epoch"):
                assert a[0] == b[0] == epoch
    if task == "1:1":
        per_client = parse_log.parse(os.path.join(str(tmp_path / "port"),
                                                  "local_log.txt"))
        assert sorted(per_client) == [c * IDS for c in range(CLIENTS)]
        assert len(result["per_client"]) == CLIENTS and len(result["mean"]) == 6
        assert lines[-2] == "Mean (-6 to -1):"
    else:
        assert len(result["mean"]) == 4 and lines[-3] == f"1:n at Epoch : {epoch}"


def _dyadic_feats(n):
    """(n, EMB) unit rows with four entries of +-1/2 each: every dot is a
    multiple of 1/4, exact in fp32."""
    rng = np.random.default_rng(5)
    f = np.zeros((n, EMB), np.float32)
    for i in range(n):
        f[i, rng.choice(EMB, 4, replace=False)] = rng.choice([-0.5, 0.5], 4)
    return f


@pytest.mark.parametrize("backbone,task,epoch", CASES, ids=IDS_OF)
def test_local_all_identical_on_dyadic_features(data_root, jax_exports, tmp_path,
                                                monkeypatch, backbone, task, epoch):
    """Dyadic features in place of both CLIs' embeddings (the same rows for
    every model and converter): local_log.txt is byte-equal."""
    def feats_for(dataset):
        labels = np.asarray(dataset.all_labels(), np.int64)
        return _dyadic_feats(len(labels)), labels

    def jax_embed(embed_fn, variables, dataset, batch_size, **kw):
        f, labels = feats_for(dataset)
        return f, labels

    def port_embed(model, dataset, batch_size, **kw):
        f, labels = feats_for(dataset)
        return torch.from_numpy(f), labels

    monkeypatch.setattr(jembed, "embed_dataset", jax_embed)
    monkeypatch.setattr(local_all, "embed_dataset", port_embed)
    jlines, lines, _ = _run_both(data_root, jax_exports, tmp_path, backbone,
                                 task, epoch)
    assert lines == jlines


def test_local_1n_evaluation_matches_jax():
    rng = np.random.default_rng(8)
    q = rng.standard_normal((50, 8)).astype(np.float32)
    g = rng.standard_normal((5, 8)).astype(np.float32)
    mask = np.where(rng.random(50) < 0.6, rng.integers(0, 5, 50), -1)
    assert local_1n.evaluation(q, g, mask) == jax_local_1n.evaluation(q, g, mask)


def test_synth_data_dir_raises(tmp_path):
    """A synth: data dir whose spec contradicts the flags raises, as in the
    JAX CLI (tests/test_torch_synthetic.py runs it on agreeing ones)."""
    args = _args("unused", str(tmp_path), "multi", "1:1")
    args.data_dir = "synth:clients=3"
    with pytest.raises(ValueError, match="clients=3"):
        local_all.main(args)


def test_parser_accepts_every_flag_of_local_all_py():
    import ast
    from pathlib import Path

    tree = ast.parse((Path(__file__).resolve().parent.parent / "local_all.py").read_text())
    flags = [a.value for node in ast.walk(tree)
             if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
             and node.func.attr == "add_argument"
             for a in node.args if isinstance(a, ast.Constant)]
    accepted = local_all.build_parser()._option_string_actions
    assert len(flags) >= 14 and [f for f in flags if f not in accepted] == []
    assert local_all.build_parser().parse_args([]).device == "cuda"


@pytest.mark.parametrize("network,extra", [
    ("toy", []),
    ("iresnet18", ["--dropout", "0.2", "--freeze_bn", "--converter_layer", "2"]),
], ids=["toy", "iresnet18-bottle"])
def test_round_trip_on_port_exports(data_root, tmp_path, network, extra):
    """One round of the port's training CLI on the CPU, then its local_all
    on the round's .pth exports: 1:1 and 1:n per client, 1:1 on the global
    backbone_0.pth; every local_log.txt line parses."""
    out = str(tmp_path / "run")
    argv = chip_smoke.round_args(data_root, CLIENTS, IDS, device="cpu",
                                 network=network, embedding=EMB, image_size=IMG,
                                 batch=8, local_epochs=1, rounds=1, eval_batch=16)
    argv[argv.index("--output_dir") + 1] = out
    train_cli.main(train_cli.build_parser().parse_args(
        argv + ["--num_workers", "2", "--lr", "0.01"] + extra))
    layer = 2 if extra else 1
    bce = torch.load(os.path.join(out, "clients", "client_0", "bce_module.pth"))
    assert ("converter.concat_fc.weight" in bce) == (layer == 2)
    for backbone, task, epoch in CASES:
        res = local_all.main(_args(data_root, out, backbone, task, epoch,
                                   network=network, converter_layer=layer))
        assert np.all(np.isfinite(res["mean"]))
    with open(os.path.join(out, "local_log.txt")) as f:
        lines = f.read().splitlines()
    assert lines.count("Mean (-6 to -1):") == 2 and lines.count("1:n at Epoch : -1") == 1
    assert sorted(parse_log.parse(os.path.join(out, "local_log.txt"))) == [0, IDS]
