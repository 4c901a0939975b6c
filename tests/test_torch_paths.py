"""The sequential round's remaining paths, the port against the JAX package.

On a tiny rec split (toy backbone, fp32 on both sides, TF32 off), the JAX
``Server``'s initial global model, global FC and client states are carried
into the port (``fedfr_tpu_torch.interop``) and the JAX steps' flip masks
are injected through ``Client.flip_fn``, as ``test_torch_round.py`` does.

* two rounds under each of ``fed.spreadout``, ``fed.hn_strategy='fc'``,
  ``fed.cache_contrastive`` and the plain objective
  (``add_pretrained_data=False``): per-client losses at rtol 1e-4, mined
  sizes exact, the aggregated global model, the global FC and every
  client's FC rows at atol 1e-4;
* ``spreadout`` alone (mean and sum) at atol 1e-5; ``select_hard_negatives_fc``
  keeps the JAX record keys; ``embed_flip_caches`` at atol 1e-5;
* one cached step against one recompute step of the port, from the same
  state and batch: losses at rtol 1e-6, weights at atol 1e-6 (JAX
  ``tests/test_federated.py:664-680``).
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from fedfr_tpu.config import FedFRConfig as JConfig
from fedfr_tpu.data.datasets import AllClientData as JData
from fedfr_tpu.data.datasets import CombinedDataset as JCombined
from fedfr_tpu.federated import Server as JServer
from fedfr_tpu.federated.client import _run_key
from fedfr_tpu.federated.embed import embed_flip_caches as jax_flip_caches
from fedfr_tpu.federated.state import flip_mask
from fedfr_tpu.parallel.fedavg import spreadout as jax_spreadout

from fedfr_tpu_torch import interop
from fedfr_tpu_torch.config import FedFRConfig
from fedfr_tpu_torch.data import AllClientData
from fedfr_tpu_torch.data.datasets import CombinedDataset
from fedfr_tpu_torch.federated import Server
from fedfr_tpu_torch.federated.embed import embed_flip_caches
from fedfr_tpu_torch.federated.trainer import init_client_state, make_branch_train_step
from fedfr_tpu_torch.models import BCEModule, ToyNet
from fedfr_tpu_torch.parallel.fedavg import spreadout

import torch_threads  # noqa: F401  (each xdist worker's share of the cores)

CLIENTS, IDS, IMG, E, PUB_IDS, PUB_IMGS = 2, 3, 16, 16, 6, 5


@pytest.fixture(autouse=True)
def _no_tf32():
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = old


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """2 clients x 3 IDs x 8 images and a 6-ID x 5-image public split,
    written by chip_smoke.py's own writer."""
    root = str(tmp_path_factory.mktemp("torch_paths"))
    chip_smoke.write_fl_split(root, CLIENTS, IDS, imgs_per_id=8, pub_ids=PUB_IDS,
                              pub_imgs=PUB_IMGS, size=IMG, seed=3, veri_imgs=2)
    return root


def _configure(cfg, root, fed):
    cfg.data.rec_root = root
    cfg.data.num_clients = CLIENTS
    cfg.data.num_ids = CLIENTS * IDS
    cfg.data.image_size = IMG
    cfg.data.batch_size = 8
    cfg.data.combined_batch_size = 8
    cfg.data.public_batch_size = 16
    cfg.data.eval_batch_size = 16
    cfg.data.num_workers = 2
    cfg.model.network = "toy"
    cfg.model.embedding_size = E
    cfg.model.bf16 = False
    cfg.optim.lr = 0.01
    cfg.fed.local_epochs = 1
    cfg.fed.adaptive_local_epoch = False
    cfg.fed.client_parallel = False
    for k, v in fed.items():
        setattr(cfg.fed, k, v)
    return cfg


def _np_tree(t):
    return jax.tree_util.tree_map(np.array, t)


def _pair(root, fed):
    """A JAX server and a port server with the same config, the port
    carrying the JAX server's initial state and flip stream."""
    jcfg = _configure(JConfig(), root, fed)
    jserver = JServer(jcfg, JData(jcfg))
    cfg = _configure(FedFRConfig(), root, fed)
    cfg.runtime.device = "cpu"
    server = Server(cfg, AllClientData(cfg))
    server.global_net.load_state_dict(
        interop.toy_state_dict(_np_tree(jserver.federated_vars)))
    if jserver.pretrained_fc is not None:
        server.pretrained_fc = torch.tensor(np.asarray(jserver.pretrained_fc, np.float32))
    assert (server.pretrained_fc is None) == (jserver.pretrained_fc is None)
    for c, jc in zip(server.clients, jserver.clients):
        state = interop.client_state("toy", jc.fc_local, _np_tree(jc.bce_vars),
                                     _np_tree(jc.last_backbone))
        c.fc_local, c.bce_state, c.last_backbone = (
            state["fc_local"], state["bce_state"], state["last_backbone"])

        def flip_fn(step_no, imgs, cid=c.cid):
            key = jax.random.fold_in(_run_key(jcfg.runtime.seed,
                                              server.global_round, cid), step_no)
            return np.asarray(flip_mask(key, imgs.shape[0]))
        c.flip_fn = flip_fn
    return jserver, server


def _assert_state_close(sd, jvars, atol):
    want = interop.toy_state_dict(_np_tree(jvars))
    for k, v in sd.items():
        if v.is_floating_point():
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=atol,
                                       rtol=0, err_msg=k)


def _fc_threshold(jserver):
    """A threshold between two middle per-identity scores of client 0's
    FC-row mining, so that it keeps a strict subset."""
    a = np.asarray(jserver.clients[0].fc_local, np.float64)
    b = np.asarray(jserver.pretrained_fc, np.float64)
    sim = (a / np.linalg.norm(a, axis=1, keepdims=True)) @ (
        b / np.linalg.norm(b, axis=1, keepdims=True)).T
    best = np.sort(sim.max(axis=0))
    return float(best[len(best) // 2 - 1] + best[len(best) // 2]) / 2


@pytest.mark.parametrize("fed", [
    {"spreadout": True},
    {"hn_strategy": "fc"},
    {"cache_contrastive": True},
    {"add_pretrained_data": False, "bce_local": False},
], ids=["spreadout", "fc_mining", "cache_contrastive", "plain"])
def test_two_rounds_match_jax_server(root, fed):
    jserver, server = _pair(root, fed)
    if fed.get("hn_strategy") == "fc":
        jserver.cfg.fed.hn_fc_threshold = server.cfg.fed.hn_fc_threshold = \
            _fc_threshold(jserver)
    mined = []
    for rnd in range(2):
        for s in (jserver, server):
            s.current_client_list = s.sample_clients()
        assert server.current_client_list == jserver.current_client_list
        jstats = jserver.train_round()
        stats = server.train_round()
        for c, jc in zip(server.clients, jserver.clients):
            assert c.dataset_size == jc.dataset_size, (rnd, c.cid)
            np.testing.assert_allclose(c.last_loss, jc.last_loss, rtol=1e-4,
                                       err_msg=f"round {rnd} client {c.cid}")
            np.testing.assert_allclose(c.fc_local.numpy(), np.asarray(jc.fc_local),
                                       atol=1e-4, rtol=0)
            mined.append(c.dataset_size - len(c.dataset))
        np.testing.assert_allclose(stats["avg_loss"], jstats["avg_loss"], rtol=1e-4)
        _assert_state_close(server.global_net.state_dict(),
                            jserver.federated_vars, atol=1e-4)
        if server.pretrained_fc is not None:
            np.testing.assert_allclose(server.pretrained_fc.numpy(),
                                       np.asarray(jserver.pretrained_fc), atol=1e-4)
        for s in (jserver, server):
            s.advance_round()
    if fed.get("hn_strategy") == "fc":
        assert any(0 < m < PUB_IDS * PUB_IMGS for m in mined), mined
    if "add_pretrained_data" in fed:
        assert mined == [0] * (2 * CLIENTS)  # each client's own set only
        assert server.pretrained_fc is None


@pytest.mark.parametrize("mode,lr", [("mean", 0.1), ("sum", 1e-4)])
def test_spreadout_matches_jax(mode, lr):
    rng = np.random.default_rng(0)
    # three clients' rows, clustered so that many pairs exceed the margin
    fc = (rng.normal(size=(1, 64)) + 0.8 * rng.normal(size=(300, 64))).astype(np.float32)
    kw = dict(margin=0.4, iters=5, lr=lr, momentum=0.9, weight_decay=5e-4, mode=mode)
    want = np.asarray(jax_spreadout(jnp.asarray(fc), **kw))
    got = spreadout(torch.tensor(fc), **kw).numpy()
    assert np.abs(want - fc).max() > 1e-3  # the rows moved
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.fixture(scope="module")
def jax_server(root):
    jcfg = _configure(JConfig(), root, {})
    return JServer(jcfg, JData(jcfg))


def test_select_hard_negatives_fc_matches_jax(root, jax_server):
    jc = jax_server.clients[0]
    threshold = _fc_threshold(jax_server)
    cfg = _configure(FedFRConfig(), root, {})
    cfg.runtime.device = "cpu"
    data = AllClientData(cfg)
    server = Server(cfg, data)
    client = server.clients[0]
    client.fc_local = torch.tensor(np.asarray(jc.fc_local))
    labels = jax_server.pretrained_labels
    want = jc.select_hard_negatives_fc(np.asarray(jax_server.pretrained_fc),
                                       jax_server.data.public_dataset, labels,
                                       threshold=threshold)
    got = client.select_hard_negatives_fc(
        torch.tensor(np.asarray(jax_server.pretrained_fc)), data.public_dataset,
        labels, threshold=threshold)
    assert 0 < len(got.imgidx) < PUB_IDS * PUB_IMGS
    np.testing.assert_array_equal(got.imgidx, want.imgidx)
    assert client.mined == len(got.imgidx)
    # nothing above the threshold keeps record 1
    empty = client.select_hard_negatives_fc(
        torch.tensor(np.asarray(jax_server.pretrained_fc)), data.public_dataset,
        labels, threshold=1.5)
    assert list(empty.imgidx) == [1] and client.mined == 0


def test_embed_flip_caches_match_jax(root, jax_server):
    jc = jax_server.clients[1]
    jcombined = JCombined(jc.dataset, jax_server.data.public_dataset.subset(
        np.arange(3, 20)))
    want = jax_flip_caches(jax_server._embed_fn,
                           [jax_server.federated_vars, jc.last_backbone],
                           jcombined, 16, pad_to_multiple=1)
    cfg = _configure(FedFRConfig(), root, {})
    data = AllClientData(cfg)
    combined = CombinedDataset(data.client(1), data.public_dataset.subset(
        np.arange(3, 20)))
    nets = []
    for v in (jax_server.federated_vars, jc.last_backbone):
        net = ToyNet(E)
        net.load_state_dict(interop.toy_state_dict(_np_tree(v)))
        nets.append(net)
    got = embed_flip_caches(nets, combined, 16, device="cpu", num_workers=2)
    for g, w in zip(got, want):
        assert g.shape == (len(combined), 2, E)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=0)


def test_cached_step_matches_recompute_step(root):
    """One step from the same state and batch: the cached step's gathers
    give the recompute step's frozen features, so the same losses and the
    same updated weights."""
    cfg = _configure(FedFRConfig(), root, {})
    data = AllClientData(cfg)
    gen = torch.Generator().manual_seed(0)
    with torch.random.fork_rng():
        torch.manual_seed(0)
        global_net, last_net, student = (ToyNet(E).eval() for _ in range(3))
    combined = CombinedDataset(data.client(0), data.public_dataset)
    caches = embed_flip_caches([global_net, last_net], combined, 16, device="cpu",
                               num_workers=2)
    idx = torch.tensor([3, 7, 1, 9, 30, 0, 12, 33], dtype=torch.int32)
    items = [combined.read(int(i)) for i in idx]
    imgs = torch.from_numpy(np.stack([it[0] for it in items]))
    labels = torch.tensor([it[1] for it in items], dtype=torch.int32)
    valid = torch.ones(8, dtype=torch.bool)
    flip = torch.tensor([True, False, True, True, False, False, True, False])
    num_classes = combined.num_classes
    fc = 0.01 * torch.randn(num_classes, E, generator=gen)
    bce = BCEModule(E, num_classes, 1, generator=gen)
    kw = dict(num_local=IDS, num_clients=CLIENTS)
    step = make_branch_train_step(**kw)
    cstep = make_branch_train_step(cached_contrastive=True, **kw)

    def fresh():
        import copy
        return init_client_state(copy.deepcopy(student), fc, copy.deepcopy(bce), 0.1)

    s1, m1 = step(fresh(), global_net, last_net, imgs, labels, valid, 0.1, flip)
    s2, m2 = cstep(fresh(), caches[0], caches[1], imgs, labels, valid, idx, 0.1, flip)
    assert float(m1.con_loss) > 0
    np.testing.assert_allclose(float(m2.con_loss), float(m1.con_loss), rtol=1e-6)
    np.testing.assert_allclose(float(m2.loss), float(m1.loss), rtol=1e-6)
    for (k, a), b in zip(s1.backbone.state_dict().items(),
                         s2.backbone.state_dict().values()):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-6, rtol=0, err_msg=k)
    np.testing.assert_allclose(s2.fc.detach().numpy(), s1.fc.detach().numpy(),
                               atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="contrastive=True"):
        make_branch_train_step(cached_contrastive=True, contrastive=False)
    with pytest.raises(ValueError, match="FedProx"):
        make_branch_train_step(cached_contrastive=True, fedprox_mu=0.1)
