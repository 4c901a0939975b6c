"""The port's multi-device half on the CPU, against the JAX package's mesh.

The JAX side runs on the 8-device virtual CPU mesh of ``tests/conftest.py``;
the port's meshes name the one CPU device W times (a mesh is an explicit
device list that may repeat a device), which runs every line of the
sharding code:

* ``make_mesh`` / ``data_mesh`` / ``model_mesh``: the shapes and errors of
  JAX's, and the placements (``shard_over``, ``replicated``, the client
  axis's ``shard_stacked_tree`` / ``replicate_tree``, ``parallel_fedavg``);
* the data-axis embed (``ShardedEmbed``) over W in {2, 3} with a batch W
  does not divide: within 1e-5 of JAX's ``make_sharded_embed_fn`` on a
  W-device ``data_mesh`` and 1e-6 of the port's one-device embed;
* ``pairwise_roc_histogram_sharded`` over W in {1, 2, 3, 8}: equal to
  JAX's (``use_pallas=False``) exactly on dyadic inputs, and to the
  port's one-shard histogram, with ragged N, shards with no rows, t = 0
  and t = N;
* ``Server.train_round_parallel`` over 2 devices x lockstep 2 with 5
  clients (groups [0-3] and [4 + 3 pad slots], the pads over both
  devices), the branch objective (recomputed and cached MOON) and the
  plain one: against JAX's ``train_round_parallel`` on a (2, 1, 1) mesh at
  1e-4 (``tests/test_torch_lockstep.py``'s bounds); against the port's
  one-device round at ``--lockstep 4``, the losses and the aggregate at
  1e-6 (a 4-wide stacked step sums in another order than a 2-wide one);
  and bit for bit against the one-device round at ``--lockstep 2``, whose
  stacked steps are as wide as each device's, every client's state
  included: the mesh itself changes no number;
* the clamp of ``_lockstep_group_size(mesh)``, warned once.
"""

import importlib
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from fedfr_tpu.config import FedFRConfig as JConfig
from fedfr_tpu.data.datasets import AllClientData as JData
from fedfr_tpu.federated import Server as JServer
from fedfr_tpu.federated.client import _run_key
from fedfr_tpu.federated.embed import make_sharded_embed_fn
from fedfr_tpu.federated.state import flip_mask
from fedfr_tpu.models import build_backbone as jbuild_backbone
from fedfr_tpu.ops.roc_histogram import \
    pairwise_roc_histogram_sharded as jax_sharded_histogram
from fedfr_tpu.parallel import mesh as jmesh

from fedfr_tpu_torch import interop
from fedfr_tpu_torch.config import FedFRConfig
from fedfr_tpu_torch.data import AllClientData
from fedfr_tpu_torch.federated import Server
from fedfr_tpu_torch.federated.embed import ShardedEmbed, embed_dataset
from fedfr_tpu_torch.models import build_backbone
from fedfr_tpu_torch.ops import roc_hist
from fedfr_tpu_torch.parallel import client_parallel as cp
from fedfr_tpu_torch.parallel import mesh
from fedfr_tpu_torch.parallel.fedavg import stack_trees, streaming_weighted_average

import torch_threads  # noqa: F401  (each xdist worker's share of the cores)

rh = importlib.import_module("fedfr_tpu_torch.ops.roc_histogram")

CLIENTS, IDS, IMG, E, PUB_IDS, PUB_IMGS = 5, 2, 16, 16, 4, 4


def _cpus(w):
    return ["cpu"] * w


@pytest.fixture(autouse=True)
def _no_tf32():
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


@pytest.fixture(autouse=True)
def _port_log_reaches_caplog(monkeypatch):
    """An in-process CLI run earlier in the same worker (``init_logging``)
    leaves the port's root logger with ``propagate=False``, and caplog's
    handler sits on the root logger: let the server's records through."""
    monkeypatch.setattr(logging.getLogger("fedfr_tpu_torch"), "propagate", True)


# ------------------------------------------------------------------ meshes

@pytest.mark.parametrize("shape", [None, (8, 1, 1), (1, 8, 1), (2, 2, 2), (1, 1, 8)])
def test_make_mesh_shapes_match_jax(shape):
    got = mesh.make_mesh(shape, _cpus(8))
    want = jmesh.make_mesh(shape, jax.devices())
    assert got.shape == dict(want.shape) and got.axis_names == want.axis_names
    assert got.size == want.devices.size == 8


@pytest.mark.parametrize("shape", [(3, 1, 1), (2, 2, 1), (16, 1, 1)])
def test_make_mesh_rejects_a_shape_that_does_not_cover(shape):
    with pytest.raises(ValueError, match="does not cover"):
        jmesh.make_mesh(shape, jax.devices())
    with pytest.raises(ValueError, match="does not cover"):
        mesh.make_mesh(shape, _cpus(8))


@pytest.mark.parametrize("n", [None, 1, 3, 8])
def test_data_and_model_meshes_match_jax(n):
    assert mesh.data_mesh(n, _cpus(8)).shape == dict(jmesh.data_mesh(n).shape)
    assert mesh.model_mesh(n, _cpus(8)).shape == dict(jmesh.model_mesh(n).shape)


def test_default_mesh_is_every_visible_device():
    """Without a GPU the default device list is the CPU alone; one host is
    one slice group."""
    if torch.cuda.is_available():
        pytest.skip("the CPU's default list")
    assert mesh.make_mesh().shape == {"client": 1, "data": 1, "model": 1}
    assert mesh.visible_devices("cpu") == [torch.device("cpu")]
    assert mesh.group_by_slice(_cpus(3)) == [[torch.device("cpu")] * 3]


def test_placements_split_and_replicate():
    m = mesh.data_mesh(devices=_cpus(3))
    x = torch.arange(14.0).reshape(7, 2)
    shards = mesh.shard_over(m, x)
    assert [s.shape[0] for s in shards] == [3, 3, 1]
    assert torch.equal(torch.cat(shards), x)
    assert [s.shape[0] for s in mesh.shard_over(m, x[:2])] == [1, 1, 0]
    assert all(r is x for r in mesh.replicated(m, x))


def test_client_axis_placements_and_parallel_fedavg():
    """``shard_stacked_tree`` splits the member axis over the client axis
    and ``parallel_fedavg`` over those shards equals the streaming FedAvg
    of the members in order, bit for bit."""
    m = mesh.make_mesh(devices=_cpus(2))
    gen = torch.Generator().manual_seed(1)
    members = [{"w": torch.randn(3, 4, generator=gen), "b": torch.randn(4, generator=gen)}
               for _ in range(4)]
    shards = cp.shard_stacked_tree(m, stack_trees(members))
    assert [s["w"].shape[0] for s in shards] == [2, 2]
    assert len(cp.replicate_tree(m, members[0])) == 2
    assert cp.client_sharding(m) == [torch.device("cpu")] * 2
    weights = [3, 1, 4, 1]
    got = cp.parallel_fedavg(shards, weights, "cpu")
    want = streaming_weighted_average(members, weights)
    assert all(torch.equal(got[k], want[k]) for k in want)
    with pytest.raises(ValueError):
        cp.shard_stacked_tree(mesh.make_mesh(devices=_cpus(3)), stack_trees(members))


# ------------------------------------------------------------------ embed

def _toy_pair(seed=0):
    """The JAX toy backbone's variables and the port's toy net holding them."""
    jnet = jbuild_backbone("toy", E)
    jvars = jnet.init(jax.random.PRNGKey(seed), jnp.zeros((1, IMG, IMG, 3)), train=False)
    net = build_backbone("toy", E, bf16=False)
    net.load_state_dict(interop.toy_state_dict(jax.tree_util.tree_map(np.array, jvars)))
    return jnet, jvars, net.eval()


@pytest.mark.parametrize("w", [2, 3])
def test_sharded_embed_matches_jax_and_one_device(w):
    jnet, jvars, net = _toy_pair()
    u8 = np.random.default_rng(w).integers(0, 256, (3 * w + 1, IMG, IMG, 3), dtype=np.uint8)
    got = ShardedEmbed(net, mesh.data_mesh(devices=_cpus(w)))(u8)
    want = np.asarray(make_sharded_embed_fn(jnet, jmesh.data_mesh(w))(jvars, jnp.asarray(u8)))
    one = ShardedEmbed(net)(u8)
    assert got.shape == (u8.shape[0], E)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.numpy(), one.numpy(), atol=1e-6, rtol=0)


def test_embed_dataset_over_a_mesh_matches_one_device(tmp_path):
    """A whole pass (flip test on, a last batch that 3 does not divide)."""
    chip_smoke.write_fl_split(str(tmp_path), 1, 3, imgs_per_id=7, pub_ids=2, pub_imgs=2,
                              size=IMG, seed=5, veri_imgs=2)
    cfg = FedFRConfig()
    cfg.data.rec_root, cfg.data.num_clients, cfg.data.num_ids = str(tmp_path), 1, 3
    data = AllClientData(cfg, include_public=False)
    _, _, net = _toy_pair(1)
    kw = dict(batch_size=8, flip_test=True, device="cpu", num_workers=1)
    got, labels = embed_dataset(net, data.client(0), mesh=mesh.data_mesh(devices=_cpus(3)), **kw)
    want, want_labels = embed_dataset(net, data.client(0), **kw)
    assert got.shape == (21, E)
    np.testing.assert_array_equal(labels, want_labels)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=0)


# -------------------------------------------------------------------- ROC

def _dyadic(n, e, seed):
    rng = np.random.default_rng(seed)
    vals = np.array([0.0, 0.125, -0.125, 0.25, -0.25], np.float32)
    return vals[rng.integers(0, 5, size=(n, e))], (np.arange(n) // 3).astype(np.int32)


@pytest.mark.parametrize("n,t", [(301, 40), (301, 0), (301, 301), (5, 3), (130, 129)],
                         ids=["ragged", "no_targets", "all_targets", "empty_shards",
                              "targets_span_shards"])
@pytest.mark.parametrize("w", [1, 2, 3, 8])
def test_sharded_histogram_matches_jax_exactly(n, t, w):
    """JAX's sharded histogram fails to trace with no target rows (a
    slice of 0 rows), so t = 0 is held to zeros and the one-shard port."""
    feats, labels = _dyadic(n, 16, seed=n + t + w)
    m = mesh.data_mesh(devices=_cpus(w))
    got = rh.pairwise_roc_histogram_sharded(m, torch.from_numpy(feats),
                                            torch.from_numpy(labels), t)
    one = roc_hist.roc_histogram(torch.from_numpy(feats), torch.from_numpy(labels), t)
    if t > 0:
        want = np.asarray(jax_sharded_histogram(jmesh.data_mesh(w), feats, labels, t,
                                                use_pallas=False))
        np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, one)
    assert int(got.sum()) == t * n - t * (t + 1) // 2


def test_client_roc_over_a_mesh_matches_one_device():
    rng = np.random.default_rng(2)
    feats = torch.from_numpy(rng.standard_normal((200, 16)).astype(np.float32))
    feats = feats / feats.norm(dim=1, keepdim=True)
    labels = np.arange(200) // 10
    assert rh.client_roc(feats, labels, 3, 8, mesh.data_mesh(devices=_cpus(3))) == \
        rh.client_roc(feats, labels, 3, 8)


# ------------------------------------------------------------------ round

@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """5 clients x 2 IDs x 8 images and a 4-ID x 4-image public split."""
    root = str(tmp_path_factory.mktemp("torch_mesh"))
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
    cfg.fed.hn_threshold = -1.0  # keep every public image: equal epochs
    for k, v in fed.items():
        setattr(cfg.fed, k, v)
    return cfg


def _port_server(root, fed, devices=None):
    cfg = _configure(FedFRConfig(), root, fed)
    cfg.runtime.device = "cpu"
    torch.manual_seed(0)  # the toy net draws its init from the global RNG
    return Server(cfg, AllClientData(cfg, include_public=cfg.fed.add_pretrained_data),
                  devices=devices)


def _np_tree(t):
    return jax.tree_util.tree_map(np.array, t)


def _carry(jserver, server, jcfg):
    """The JAX server's initial state and flip stream into the port's."""
    server.global_net.load_state_dict(interop.toy_state_dict(_np_tree(jserver.federated_vars)))
    if jserver.pretrained_fc is not None:
        server.pretrained_fc = torch.tensor(np.asarray(jserver.pretrained_fc, np.float32))
    for c, jc in zip(server.clients, jserver.clients):
        state = interop.client_state("toy", jc.fc_local, _np_tree(jc.bce_vars),
                                     _np_tree(jc.last_backbone))
        c.fc_local, c.bce_state, c.last_backbone = (
            state["fc_local"], state["bce_state"], state["last_backbone"])

        def flip_fn(step_no, imgs, cid=c.cid):
            key = jax.random.fold_in(_run_key(jcfg.runtime.seed, server.global_round, cid),
                                     step_no)
            return np.asarray(flip_mask(key, imgs.shape[0]))
        c.flip_fn = flip_fn


OBJECTIVES = {
    "branch": {"lockstep": 2},
    "cache_contrastive": {"lockstep": 2, "cache_contrastive": True},
    "plain": {"lockstep": 2, "add_pretrained_data": False, "bce_local": False},
}


@pytest.mark.parametrize("name", list(OBJECTIVES))
def test_round_over_two_devices_matches_jax_and_one_device(root, name, caplog):
    caplog.set_level(logging.INFO, logger="fedfr_tpu_torch.server")
    fed = OBJECTIVES[name]
    jcfg = _configure(JConfig(), root, fed)
    jserver = JServer(jcfg, JData(jcfg, include_public=jcfg.fed.add_pretrained_data))
    server = _port_server(root, fed, devices=_cpus(2))
    one = _port_server(root, dict(fed, lockstep=4))
    same_width = _port_server(root, fed)
    for s in (server, one, same_width):
        _carry(jserver, s, jcfg)
    for s in (jserver, server, one, same_width):
        s.current_client_list = s.sample_clients()
    assert server.current_client_list == jserver.current_client_list == list(range(CLIENTS))
    pmesh = mesh.make_mesh(devices=_cpus(2))
    assert server._lockstep_group_size(pmesh) == 4
    jstats = jserver.train_round_parallel(jmesh.make_mesh((2, 1, 1), jax.devices()[:2]))
    stats = server.train_round_parallel(pmesh)
    ostats = one.train_round_parallel()
    wstats = same_width.train_round_parallel()
    if fed.get("add_pretrained_data", True):
        groups = [r.getMessage() for r in caplog.records
                  if r.getMessage().startswith("parallel group")]
        assert groups[:2] == ["parallel group [0, 1, 2, 3] epoch 1/1 done",
                              "parallel group [4] epoch 1/1 done"]

    # against JAX: losses and FC rows per client, the aggregate
    assert [c.dataset_size for c in server.clients] == [
        jc.dataset_size for jc in jserver.clients]
    for c, jc in zip(server.clients, jserver.clients):
        np.testing.assert_allclose(c.last_loss, jc.last_loss, rtol=1e-4,
                                   err_msg=f"client {c.cid}")
        np.testing.assert_allclose(c.fc_local.numpy(), np.asarray(jc.fc_local),
                                   atol=1e-4, rtol=0)
    np.testing.assert_allclose(stats["avg_loss"], jstats["avg_loss"], rtol=1e-4)
    want = interop.toy_state_dict(_np_tree(jserver.federated_vars))
    for k, v in server.global_net.state_dict().items():
        if v.is_floating_point():
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=1e-4, rtol=0,
                                       err_msg=k)
    if server.pretrained_fc is not None:
        np.testing.assert_allclose(server.pretrained_fc.numpy(),
                                   np.asarray(jserver.pretrained_fc), atol=1e-4)

    # against the port's one-device round at --lockstep 4: losses, aggregate
    assert stats["avg_loss"] == pytest.approx(ostats["avg_loss"], rel=1e-6)
    ref = one.global_net.state_dict()
    for k, v in server.global_net.state_dict().items():
        np.testing.assert_allclose(v.double().numpy(), ref[k].double().numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    if server.pretrained_fc is not None:
        np.testing.assert_allclose(server.pretrained_fc.numpy(), one.pretrained_fc.numpy(),
                                   rtol=1e-6, atol=1e-6)
    for c, co in zip(server.clients, one.clients):
        assert c.last_loss == pytest.approx(co.last_loss, rel=1e-6)

    # against the one-device round of the same stacked width: bit for bit
    assert stats["avg_loss"] == wstats["avg_loss"]
    ref = same_width.global_net.state_dict()
    assert all(torch.equal(v, ref[k]) for k, v in server.global_net.state_dict().items())
    for c, cw in zip(server.clients, same_width.clients):
        assert c.last_loss == cw.last_loss and torch.equal(c.fc_local, cw.fc_local)
        assert all(torch.equal(c.trained_backbone[k], v) for k, v in cw.trained_backbone.items())
        for k, v in (cw.bce_state or {}).items():
            assert torch.equal(c.bce_state[k], v), k


def test_lockstep_clamp_over_the_client_axis_warns_once(root, caplog):
    """An oversized lockstep is clamped to ceil(sampled / axis) clients a
    device, as JAX's ``_lockstep_group_size(mesh)``, with one warning a run."""
    caplog.set_level(logging.DEBUG, logger="fedfr_tpu_torch.server")
    fed = {"lockstep": 10}
    server = _port_server(root, fed, devices=_cpus(2))
    jcfg = _configure(JConfig(), root, fed)
    jserver = JServer(jcfg, JData(jcfg))
    for s in (server, jserver):
        s.current_client_list = s.sample_clients()
    pmesh = mesh.make_mesh(devices=_cpus(2))
    jm = jmesh.make_mesh((2, 1, 1), jax.devices()[:2])
    assert server._lockstep_group_size(pmesh) == jserver._lockstep_group_size(jm) == 6
    assert server._lockstep_group_size(pmesh) == 6
    clamps = [r for r in caplog.records
              if r.name == "fedfr_tpu_torch.server" and "oversized" in r.getMessage()]
    assert [r.levelno for r in clamps] == [logging.WARNING, logging.DEBUG]
    assert "on a 2-wide client axis" in clamps[0].getMessage()
    with pytest.raises(ValueError, match="data or model axis"):
        server._lockstep_group_size(mesh.make_mesh((1, 2, 1), _cpus(2)))
