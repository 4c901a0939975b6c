"""Training from ``pretrained_root``: the port's ``Server`` against the JAX
package's, on the CPU.

Pretraining outputs are written inside the test, each by the JAX package's
own writer: a toy ``backbone.npz`` (``save_native``, what ``pretrain.py``
writes for a net with no torch layout), a sphnet20 ``backbone.pth``
(``torch_interop``), ``fc.pth``, the public labels and a
``preCos_init_AN.pth`` cache.  On the same root both servers hold equal
global weights, FC and labels and log the same "loaded ..." lines; under
``init_fc`` both ignore ``fc.pth`` and split the cache across the clients.
One toy round from the root matches ``Server.train_round`` at
test_torch_round.py's tolerances (losses rtol 1e-4, weights and global FC
atol 1e-4, mined sizes exact), and the npz reader restores what the JAX
writer wrote.  The collapsed-feature warning fires on a pinned CosFace
trace, with the JAX client's text, and stays silent otherwise.
"""

import ast
import contextlib
import inspect
import logging
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import chip_smoke
from fedfr_tpu.config import FedFRConfig as JConfig
from fedfr_tpu.data.datasets import AllClientData as JData
from fedfr_tpu.federated import Server as JServer
from fedfr_tpu.federated import client as jclient
from fedfr_tpu.federated.client import _run_key
from fedfr_tpu.federated.state import flip_mask
from fedfr_tpu.models import SphNet as JSphNet
from fedfr_tpu.models.factory import ToyNet as JToy
from fedfr_tpu.utils import torch_interop as ti
from fedfr_tpu.utils.checkpoint import save_native

from fedfr_tpu_torch import interop
from fedfr_tpu_torch.config import FedFRConfig
from fedfr_tpu_torch.data import AllClientData
from fedfr_tpu_torch.federated import Server
from fedfr_tpu_torch.federated.client import warn_if_collapsed
from fedfr_tpu_torch.utils.checkpoint import load_native

import torch_threads  # noqa: F401  (each xdist worker's share of the cores)

CLIENTS, IDS, IMG, EMB, PUB_IDS, PUB_IMGS = 2, 3, 16, 16, 6, 5
LOADED = ("loaded ", "preload ", "generated pretrain FC", "train from scratch")


@pytest.fixture(autouse=True)
def _fp32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _np_tree(t):
    return jax.tree_util.tree_map(np.array, t)


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("pretrained_data"))
    chip_smoke.write_fl_split(root, CLIENTS, IDS, imgs_per_id=8, pub_ids=PUB_IDS,
                              pub_imgs=PUB_IMGS, size=IMG, seed=0, veri_imgs=6)
    return root


def _write_heads(pre, rng):
    """fc.pth over the public IDs, the public labels and the client FC
    cache, through the JAX package's ``save_pth``."""
    ti.save_pth(torch.from_numpy(rng.standard_normal((PUB_IDS, EMB)).astype(np.float32)),
                os.path.join(pre, "fc.pth"))
    ti.save_pth(torch.from_numpy(np.repeat(np.arange(PUB_IDS), PUB_IMGS).astype(np.int64)),
                os.path.join(pre, "preCos_pretrain_labels.pth"))
    ti.save_pth(torch.from_numpy(
        rng.standard_normal((CLIENTS * IDS, EMB)).astype(np.float32)),
        os.path.join(pre, "preCos_init_AN.pth"))


@pytest.fixture(scope="module")
def toy_root(tmp_path_factory):
    pre = str(tmp_path_factory.mktemp("pretrained_toy"))
    jvars = _np_tree(JToy(embedding_size=EMB).init(
        jax.random.PRNGKey(41), jnp.zeros((1, IMG, IMG, 3))))
    rng = np.random.default_rng(41)
    jvars["batch_stats"]["bn1"]["mean"] = (0.1 * rng.standard_normal(16)).astype(np.float32)
    jvars["batch_stats"]["bn1"]["var"] = rng.uniform(0.5, 2, 16).astype(np.float32)
    save_native(jvars, os.path.join(pre, "backbone.npz"))
    _write_heads(pre, rng)
    return pre


@pytest.fixture(scope="module")
def sphnet_root(tmp_path_factory):
    pre = str(tmp_path_factory.mktemp("pretrained_sphnet"))
    jvars = _np_tree(JSphNet(depth=20, embedding_size=EMB, bf16=False).init(
        jax.random.PRNGKey(42), jnp.zeros((1, 112, 112, 3))))
    ti.save_pth(ti.backbone_to_torch("sphnet20", jvars),
                os.path.join(pre, "backbone.pth"))
    _write_heads(pre, np.random.default_rng(42))
    return pre


def _configure(cfg, data_root, pre, network="toy", init_fc=False):
    cfg.data.rec_root = data_root
    cfg.data.num_clients = CLIENTS
    cfg.data.num_ids = CLIENTS * IDS
    cfg.data.image_size = IMG if network == "toy" else 112
    cfg.data.combined_batch_size = 8
    cfg.data.public_batch_size = 16
    cfg.data.eval_batch_size = 16
    cfg.data.num_workers = 2
    cfg.model.network = network
    cfg.model.embedding_size = EMB
    cfg.model.bf16 = False
    cfg.optim.lr = 0.01
    cfg.fed.local_epochs = 2
    cfg.fed.client_parallel = False
    cfg.fed.init_fc = init_fc
    cfg.runtime.pretrained_root = pre
    return cfg


@contextlib.contextmanager
def _messages(name):
    """The INFO-and-above messages logged to ``name`` inside the block."""
    records = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append(record)

    logger = logging.getLogger(name)
    handler, level = Keep(), logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    try:
        yield records
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)


def _servers(data_root, pre, network="toy", init_fc=False):
    """(port Server, JAX Server, port load messages, JAX load messages)."""
    jcfg = _configure(JConfig(), data_root, pre, network, init_fc)
    cfg = _configure(FedFRConfig(), data_root, pre, network, init_fc)
    cfg.runtime.device = "cpu"
    with _messages("fedfr_tpu.server") as jrec:
        jserver = JServer(jcfg, JData(jcfg))
    with _messages("fedfr_tpu_torch.server") as rec:
        server = Server(cfg, AllClientData(cfg))

    def loaded(records):
        return [r.getMessage() for r in records if r.getMessage().startswith(LOADED)]
    return server, jserver, loaded(rec), loaded(jrec)


@pytest.mark.parametrize("network", ["toy", "sphnet20"], ids=["toy-npz", "sphnet20-pth"])
def test_server_loads_pretrained_root_like_jax(data_root, toy_root, sphnet_root,
                                               network):
    pre = toy_root if network == "toy" else sphnet_root
    server, jserver, msgs, jmsgs = _servers(data_root, pre, network)
    assert msgs == jmsgs
    name = "backbone.npz" if network == "toy" else "backbone.pth"
    assert msgs[0] == f"loaded pretrained backbone from {os.path.join(pre, name)}"
    assert [m.split(" (")[0] for m in msgs[1:]] == [
        "loaded pretrain labels", "loaded pretrained perfect FC"]
    want = interop.backbone_state_dict(network, _np_tree(jserver.federated_vars))
    got = server.global_net.state_dict()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=k)
    np.testing.assert_array_equal(server.pretrained_fc.numpy(),
                                  np.asarray(jserver.pretrained_fc))
    np.testing.assert_array_equal(server.pretrained_labels, jserver.pretrained_labels)


def test_init_fc_ignores_fc_pth_and_preloads_the_client_cache(data_root, toy_root):
    server, jserver, msgs, jmsgs = _servers(data_root, toy_root, init_fc=True)
    assert msgs == jmsgs
    assert [m.split(" (")[0] for m in msgs] == [
        "loaded pretrained backbone from " + os.path.join(toy_root, "backbone.npz"),
        "loaded pretrain labels", "generated pretrain FC",
        "preload clients FC init"]
    fc_pth = torch.load(os.path.join(toy_root, "fc.pth"))
    assert not torch.equal(server.pretrained_fc, fc_pth)
    np.testing.assert_allclose(server.pretrained_fc.numpy(),
                               np.asarray(jserver.pretrained_fc), atol=1e-5, rtol=0)
    cache = torch.load(os.path.join(toy_root, "preCos_init_AN.pth"))
    for c, jc in zip(server.clients, jserver.clients):
        rows = cache[c.cid * IDS:(c.cid + 1) * IDS]
        torch.testing.assert_close(c.fc_local, rows, rtol=0, atol=0)
        np.testing.assert_array_equal(np.asarray(jc.fc_local), rows.numpy())
        torch.testing.assert_close(c.bce_state["weight"], rows, rtol=0, atol=0)


def test_round_from_pretrained_root_matches_jax(data_root, toy_root):
    server, jserver, _, _ = _servers(data_root, toy_root)
    # mine about half the public set: a threshold between two middle scores
    from fedfr_tpu.federated.embed import embed_dataset, max_similarity
    pub, _ = embed_dataset(jserver._embed_fn, jserver.federated_vars,
                           jserver.data.public_dataset, 16)
    loc, _ = embed_dataset(jserver._embed_fn, jserver.federated_vars,
                           jserver.clients[0].dataset, 16)
    scores = np.sort(max_similarity(loc, pub, backend="xla"))
    threshold = float(scores[len(scores) // 2 - 1] + scores[len(scores) // 2]) / 2
    jserver.cfg.fed.hn_threshold = server.cfg.fed.hn_threshold = threshold
    for c, jc in zip(server.clients, jserver.clients):
        state = interop.client_state("toy", jc.fc_local, _np_tree(jc.bce_vars),
                                     _np_tree(jc.last_backbone))
        c.fc_local, c.bce_state, c.last_backbone = (
            state["fc_local"], state["bce_state"], state["last_backbone"])

        def flip_fn(step_no, imgs, cid=c.cid):
            key = jax.random.fold_in(_run_key(jserver.cfg.runtime.seed, 0, cid),
                                     step_no)
            return np.asarray(flip_mask(key, imgs.shape[0]))
        c.flip_fn = flip_fn

    for s in (jserver, server):
        s.current_client_list = s.sample_clients()
    jstats = jserver.train_round()
    with _messages("fedfr_tpu_torch.client") as rec:
        stats = server.train_round()
    assert not [r for r in rec if "pinned" in r.getMessage()]
    for c, jc in zip(server.clients, jserver.clients):
        assert c.dataset_size == jc.dataset_size
        assert 0 < c.dataset_size - len(c.dataset) < PUB_IDS * PUB_IMGS
        np.testing.assert_allclose(c.last_loss, jc.last_loss, rtol=1e-4)
    np.testing.assert_allclose(stats["avg_loss"], jstats["avg_loss"], rtol=1e-4)
    want = interop.toy_state_dict(_np_tree(jserver.federated_vars))
    for k, v in server.global_net.state_dict().items():
        if v.is_floating_point():
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=1e-4,
                                       rtol=0, err_msg=k)
    np.testing.assert_allclose(server.pretrained_fc.numpy(),
                               np.asarray(jserver.pretrained_fc), atol=1e-4)


def test_npz_reader_restores_the_jax_writer(tmp_path):
    """Nested dicts, lists, and dict keys that look like list indices."""
    tree = {"params": {"a": np.arange(3.0), "b": [np.ones(2), {"c": np.zeros(1)}]},
            "clients": {"0": np.array([1]), "12": np.array([2]), "#x": np.array(3),
                        "=y": np.array(4)}}
    save_native(tree, str(tmp_path / "t.npz"))
    got = load_native(str(tmp_path / "t.npz"))
    assert set(got) == {"params", "clients"}
    assert set(got["clients"]) == {"0", "12", "#x", "=y"}
    assert isinstance(got["params"]["b"], list)
    np.testing.assert_array_equal(got["params"]["b"][1]["c"], np.zeros(1))
    np.testing.assert_array_equal(got["clients"]["12"], np.array([2]))


def _jax_warning_text():
    """The format string of the JAX client's collapsed-feature warning."""
    tree = ast.parse(inspect.getsource(jclient))
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "warning" and node.args
                and isinstance(node.args[0], ast.Constant)
                and "saturation" in str(node.args[0].value)):
            return node.args[0].value
    raise LookupError("no saturation warning in the JAX client")


def test_collapse_warning_fires_on_a_pinned_trace():
    cfg = FedFRConfig()
    rows = 106                     # 100 local + 6 public classes
    sat = cfg.loss.margin_s * cfg.loss.margin_m + float(np.log(rows - 1))
    with _messages("fedfr_tpu_torch.client") as rec:
        assert warn_if_collapsed(cfg, 3, [sat + 0.02, sat + 0.0205, sat + 0.0201], rows)
    assert len(rec) == 1 and rec[0].levelno == logging.WARNING
    assert rec[0].msg == _jax_warning_text()
    assert rec[0].getMessage().startswith(
        f"client 3: cos loss pinned at the all-equal-cosine saturation value "
        f"{sat:.3f} for 3 epochs")


@pytest.mark.parametrize("trace,loss", [
    ([20.0, 15.0, 11.0], "CosFace"),   # learning
    ([5.0, 5.0005], "CosFace"),        # flat, far from saturation
    ([None], "CosFace"),               # one epoch: no trace yet
    (["sat", "sat"], "ArcFace"),       # the check is CosFace's
], ids=["learning", "flat-unsaturated", "one-epoch", "arcface"])
def test_collapse_warning_stays_silent(trace, loss):
    cfg = FedFRConfig()
    cfg.loss.loss = loss
    rows = 106
    sat = cfg.loss.margin_s * cfg.loss.margin_m + float(np.log(rows - 1))
    trace = [sat if v in ("sat", None) else v for v in trace]
    with _messages("fedfr_tpu_torch.client") as rec:
        assert not warn_if_collapsed(cfg, 0, trace, rows)
    assert rec == []
