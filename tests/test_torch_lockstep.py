"""The lockstep (client-parallel) round of the port and ``--remat``.

On a tiny rec split (3 clients, toy backbone, fp32 on both sides, TF32
off):

* the port's ``Server.train_round_parallel`` against its own sequential
  ``train_round`` with equal epochs (JAX ``tests/test_federated.py:188-390,
  681``): all clients in one group, lockstep 2 over 3 clients (a padded
  group), the cached MOON step, the plain objective, the adaptive-epoch
  schedule and the oversized-lockstep clamp with its single warning; the
  losses at rel 1e-5, JAX's own bound (``test_federated.py:234-245``), and
  the global state, the global FC, every client's FC rows and BCE weights
  at rtol = atol = ``FP32_TOL`` (see there); one step of each in float64
  at 1e-10;
* the same rounds, and one where a client has more images than the others
  (its peers wrap around their loaders), against the JAX package's
  ``Server.train_round_parallel`` on a one-device mesh, with the JAX
  initial state carried over (``fedfr_tpu_torch.interop``) and the JAX
  flip masks injected through ``Client.flip_fn``: losses at rtol 1e-4,
  mined sizes equal, weights at atol 1e-4 (``tests/test_torch_round.py``);
* iresnet18's lockstep step with ``--dropout`` and ``--freeze_bn``
  against the sequential step, each member's draws from its own
  generators, and ``--remat`` in the lockstep step equal to the step
  without it (``tests/test_torch_remat.py`` holds ``--remat`` alone).
"""

import logging
import os

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from fedfr_tpu.config import FedFRConfig as JConfig
from fedfr_tpu.data.datasets import AllClientData as JData
from fedfr_tpu.federated import Server as JServer
from fedfr_tpu.federated.client import _run_key
from fedfr_tpu.federated.state import flip_mask
from fedfr_tpu.parallel.mesh import make_mesh

from fedfr_tpu_torch import interop
from fedfr_tpu_torch.config import FedFRConfig
from fedfr_tpu_torch.data import AllClientData, codec, write_split
from fedfr_tpu_torch.federated import Server
from fedfr_tpu_torch.models import build_backbone
from fedfr_tpu_torch.parallel.client_parallel import stack_module
from fedfr_tpu_torch.parallel.fedavg import stack_trees, unstack_tree

import torch_threads  # noqa: F401  (each xdist worker's share of the cores)

CLIENTS, IDS, IMG, E, PUB_IDS, PUB_IMGS = 3, 3, 16, 16, 6, 5


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


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """3 clients x 3 IDs x 8 images and a 6-ID x 5-image public split,
    written by chip_smoke.py's own writer."""
    root = str(tmp_path_factory.mktemp("torch_lockstep"))
    chip_smoke.write_fl_split(root, CLIENTS, IDS, imgs_per_id=8, pub_ids=PUB_IDS,
                              pub_imgs=PUB_IMGS, size=IMG, seed=3, veri_imgs=2)
    return root


@pytest.fixture(scope="module")
def ragged_root(root, tmp_path_factory):
    """``root`` with client 2's split rewritten at 16 images an ID: its
    combined set gives more steps an epoch than its peers'."""
    out = str(tmp_path_factory.mktemp("torch_lockstep_ragged"))
    chip_smoke.write_fl_split(out, CLIENTS, IDS, imgs_per_id=8, pub_ids=PUB_IDS,
                              pub_imgs=PUB_IMGS, size=IMG, seed=3, veri_imgs=2)
    rng = np.random.default_rng(11)
    d = os.path.join(out, "split_train_i%04dc%04d" % (CLIENTS * IDS, CLIENTS),
                     "client_0002")
    payloads, labels = [], []
    for i in range(IDS):
        base = rng.integers(0, 200, size=(IMG, IMG, 3))
        for _ in range(16):
            img = np.clip(base + rng.integers(-30, 30, size=(IMG, IMG, 3)), 0, 255)
            payloads.append(codec.encode_raw(img.astype(np.uint8)))
            labels.append(i)
    write_split(os.path.join(d, "train.idx"), os.path.join(d, "train.rec"),
                payloads, labels, num_classes=IDS, id_base=2 * IDS)
    return out


def _configure(cfg, root, fed, network="toy", image_size=IMG):
    cfg.data.rec_root = root
    cfg.data.num_clients = CLIENTS
    cfg.data.num_ids = CLIENTS * IDS
    cfg.data.image_size = image_size
    cfg.data.batch_size = 8
    cfg.data.combined_batch_size = 8
    cfg.data.public_batch_size = 16
    cfg.data.eval_batch_size = 16
    cfg.data.num_workers = 2
    cfg.model.network = network
    cfg.model.embedding_size = E
    cfg.model.bf16 = False
    cfg.optim.lr = 0.01
    cfg.fed.local_epochs = 1
    cfg.fed.adaptive_local_epoch = False
    cfg.fed.hn_threshold = -1.0  # keep every public image: equal epochs
    for k, v in fed.items():
        if hasattr(cfg.fed, k):
            setattr(cfg.fed, k, v)
        else:
            setattr(cfg.model, k, v)
    return cfg


def _port_server(root, fed, **kw):
    cfg = _configure(FedFRConfig(), root, fed, **kw)
    cfg.runtime.device = "cpu"
    torch.manual_seed(0)  # the toy net draws its init from the global RNG
    return Server(cfg, AllClientData(cfg, include_public=cfg.fed.add_pretrained_data))


# The stacked round runs each client's objective under ``torch.func.vmap``:
# the BCE linear becomes a batched matmul where the sequential step runs one
# ``mm``, and the two add their products in other orders.  In float64 one
# step of each agrees within 1e-14
# (``test_lockstep_step_matches_sequential_float64`` holds them at 1e-10),
# so the fp32 gap between the rounds is rounding.  Its worst over the cases
# below is FP32_GAP: 2.15e-6 in an FC row of the plain objective, 1.5e-6 to
# 1.7e-6 in one BCE weight element (~0.4) of the others.  JAX holds its own
# rounds at 1e-6; the port's are held at FP32_TOL_FACTOR x FP32_GAP.
FP32_GAP = 2.2e-6
FP32_TOL_FACTOR = 3.0
FP32_TOL = FP32_TOL_FACTOR * FP32_GAP


def _assert_rounds_equal(seq, par, atol=1e-6):
    """JAX's bounds between its sequential and its parallel round."""
    want = seq.global_net.state_dict()
    for k, v in par.global_net.state_dict().items():
        np.testing.assert_allclose(v.double().numpy(), want[k].double().numpy(),
                                   rtol=atol, atol=atol, err_msg=k)
    if seq.pretrained_fc is not None:
        np.testing.assert_allclose(par.pretrained_fc.numpy(), seq.pretrained_fc.numpy(),
                                   rtol=atol, atol=atol)
    for cs, cp in zip(seq.clients, par.clients):
        assert cp.dataset_size == cs.dataset_size
        assert cp.last_loss == pytest.approx(cs.last_loss, rel=1e-5)
        np.testing.assert_allclose(cp.fc_local.numpy(), cs.fc_local.numpy(),
                                   rtol=atol, atol=atol)
        for k, v in (cs.bce_state or {}).items():
            np.testing.assert_allclose(cp.bce_state[k].numpy(), v.numpy(),
                                       rtol=atol, atol=atol, err_msg=k)


def _both_rounds(root, fed, lockstep, **kw):
    seq = _port_server(root, fed, **kw)
    par = _port_server(root, dict(fed, lockstep=lockstep), **kw)
    seq.train_round()
    par.train_round_parallel()
    return seq, par


@pytest.mark.parametrize("fed,lockstep", [
    ({}, CLIENTS),
    ({"spreadout": True}, 2),
    ({"cache_contrastive": True}, 2),
    ({"add_pretrained_data": False, "bce_local": False}, 2),
], ids=["one_group", "padded_group_spreadout", "cache_contrastive", "plain"])
def test_lockstep_round_matches_sequential(root, fed, lockstep, caplog):
    caplog.set_level(logging.INFO, logger="fedfr_tpu_torch.server")
    seq, par = _both_rounds(root, fed, lockstep)
    _assert_rounds_equal(seq, par, atol=FP32_TOL)
    groups = [r.getMessage() for r in caplog.records
              if r.getMessage().startswith("parallel group")]
    if fed.get("add_pretrained_data", True):
        # one line per group and epoch, the groups in sampled order
        want = [[0, 1, 2]] if lockstep == CLIENTS else [[0, 1], [2]]
        assert groups == [f"parallel group {g} epoch 1/1 done" for g in want]
        assert any("(parallel) avg client loss" in r.getMessage() for r in caplog.records)
    else:
        assert any("(parallel plain) avg client loss" in r.getMessage()
                   for r in caplog.records)


def test_lockstep_plain_round_applies_adaptive_epochs(root):
    """Past round 0 the plain lockstep round decays local_epoch as every
    other round path does (reference server.py:278-280; JAX
    test_federated.py:375): 6 -> 4 epochs."""
    fed = {"adaptive_local_epoch": True, "lockstep": 2, "add_pretrained_data": False,
           "bce_local": False}
    server = _port_server(root, fed)
    server.local_epoch, server.global_round = 6, 1
    stats = server.train_round_parallel()
    assert server.local_epoch == 4 and server.train_decay == 3
    assert np.isfinite(stats["avg_loss"])


def test_oversized_lockstep_clamps_once(root, caplog):
    """An oversized lockstep is clamped to the sampled count with one
    warning a run (JAX test_federated.py:323), and the clamped round equals
    the sequential one."""
    caplog.set_level(logging.DEBUG, logger="fedfr_tpu_torch.server")
    seq, par = _both_rounds(root, {}, 10 * CLIENTS)
    _assert_rounds_equal(seq, par, atol=FP32_TOL)
    par.current_client_list = par.sample_clients()
    assert par._lockstep_group_size() == CLIENTS
    clamps = [r for r in caplog.records if "oversized" in r.getMessage()]
    assert [r.levelno for r in clamps] == [logging.WARNING, logging.DEBUG]


def _members(fed, network="iresnet18"):
    """Two members of a lockstep group, ``network`` at 16x16 (fp32), with
    ``fed``'s dropout and freeze_bn: one global model and each member's FC
    rows, BCE weights, last-round model, batch, flips and dropout seed."""
    from fedfr_tpu_torch.models import BCEModule

    K, B = 2, 8
    torch.manual_seed(0)
    kw = dict(image_size=IMG, bf16=False, dropout=fed.get("dropout", 0.0),
              freeze_bn=fed.get("freeze_bn", False))
    return {
        "work": build_backbone(network, E, **kw),
        "global": build_backbone(network, E, **kw).eval().requires_grad_(False),
        "last": build_backbone(network, E, **kw).eval().requires_grad_(False),
        "lasts": [build_backbone(network, E, **kw).state_dict() for _ in range(K)],
        "bce": BCEModule(E, IDS), "bces": [BCEModule(E, IDS).state_dict() for _ in range(K)],
        "fcs": [torch.randn(IDS + PUB_IDS, E) for _ in range(K)],
        "imgs": torch.randint(0, 256, (K, B, IMG, IMG, 3), dtype=torch.uint8),
        "labels": torch.randint(0, IDS + PUB_IDS, (K, B)),
        "valid": torch.ones(K, B, dtype=torch.bool), "flips": torch.rand(K, B) < 0.5,
        "gen": (lambda i: torch.Generator().manual_seed(30 + i)
                if fed.get("dropout") else None),
    }


OBJECTIVE = dict(num_local=IDS, num_clients=CLIENTS)


def _sequential_steps(mb):
    """Each member's sequential branch step from the global model:
    [(state_dict with ``fc`` and ``bce.*``, metrics)]."""
    from fedfr_tpu_torch.federated.trainer import init_client_state, make_branch_train_step

    step, out = make_branch_train_step(**OBJECTIVE), []
    for i in range(2):
        mb["work"].load_state_dict(mb["global"].state_dict())
        mb["bce"].load_state_dict(mb["bces"][i])
        mb["last"].load_state_dict(mb["lasts"][i])
        state = init_client_state(mb["work"], mb["fcs"][i], mb["bce"], 0.01)
        _, m = step(state, mb["global"], mb["last"], mb["imgs"][i], mb["labels"][i],
                    mb["valid"][i], 0.01, mb["flips"][i], dropout_gen=mb["gen"](i))
        sd = dict(mb["work"].state_dict(), fc=state.fc.detach(),
                  **{f"bce.{k}": v for k, v in mb["bce"].state_dict().items()})
        out.append(({k: v.clone() for k, v in sd.items()}, m))
    return out


def _lockstep_step(mb, remat=False):
    """The members' K=2 lockstep step (``remat`` on the stacked blocks):
    (stacked state_dict with ``fc`` and ``bce.*``, metrics)."""
    from fedfr_tpu_torch.models.iresnet import draw_dropout_keep
    from fedfr_tpu_torch.parallel.client_parallel import (init_group_state,
                                                          make_parallel_branch_step)

    work = mb["work"]
    net = stack_module(work, 2)
    net.load_state_dict(stack_trees([mb["global"].state_dict()] * 2))
    for mod in net.modules():
        if hasattr(mod, "remat"):
            mod.remat = remat
    last = stack_module(mb["last"], 2).eval()
    last.load_state_dict(stack_trees(mb["lasts"]))
    state = init_group_state(net, torch.stack(mb["fcs"]), stack_trees(mb["bces"]), 0.01)
    keep = None
    if getattr(work, "dropout", 0.0):
        keep = torch.cat([draw_dropout_keep((8, work.fc.in_features), work.dropout,
                                            mb["gen"](i), "cpu") for i in range(2)])
    _, m = make_parallel_branch_step(work, mb["bce"], **OBJECTIVE)(
        state, mb["global"], last, mb["imgs"], mb["labels"], mb["valid"], 0.01,
        mb["flips"], dropout_keep=keep)
    return dict(net.state_dict(), fc=state.fc.detach(),
                **{f"bce.{k}": v.detach() for k, v in state.bce.items()}), m


@pytest.mark.parametrize("fed", [{"dropout": 0.3}, {"dropout": 0.3, "freeze_bn": True}],
                         ids=["dropout", "dropout_freeze_bn"])
def test_lockstep_iresnet_step_matches_sequential(fed):
    """iresnet18's lockstep step against the sequential one: each member's
    dropout masks (its own generator's draws) and ``freeze_bn`` (the BN
    leaves follow the work module's eval mode, so the running statistics
    stay as they were).  The loss terms and the BN running statistics at
    1e-5.  A train-mode BN leaf sums in another order than the native
    kernel, and a pre-activation within that rounding of 0 takes the other
    PReLU slope, so the updated weights are held at 1e-5 where BN is
    frozen."""
    mb = _members(fed)
    seq = _sequential_steps(mb)
    stacked, m = _lockstep_step(mb)
    for i, (sd, mi) in enumerate(seq):
        for name in mi._fields:
            assert float(getattr(m, name)[i]) == pytest.approx(
                float(getattr(mi, name)), rel=1e-5, abs=1e-6), name
        for k, v in sd.items():
            if "running" in k or fed.get("freeze_bn"):
                np.testing.assert_allclose(stacked[k][i].double().numpy(),
                                           v.double().numpy(), rtol=1e-5, atol=1e-5,
                                           err_msg=k)
    if fed.get("freeze_bn"):
        start = build_backbone("iresnet18", E, image_size=IMG, bf16=False)
        assert all(torch.equal(stacked[k][i], v) for i in range(2)
                   for k, v in start.state_dict().items() if "running" in k)


def _double(mb):
    """``mb``'s modules, FC rows, BCE weights and last-round models in
    float64."""
    def cast(sd):
        return {k: v.double() if v.is_floating_point() else v for k, v in sd.items()}

    for k in ("work", "global", "last", "bce"):
        mb[k].double()
    mb["lasts"], mb["bces"] = [cast(sd) for sd in mb["lasts"]], [cast(sd) for sd in mb["bces"]]
    mb["fcs"] = [fc.double() for fc in mb["fcs"]]


@pytest.mark.parametrize("network,fed", [
    ("toy", {}), ("iresnet18", {}), ("iresnet18", {"dropout": 0.3}),
    ("iresnet18", {"freeze_bn": True}),
], ids=["toy", "iresnet18", "iresnet18_dropout", "iresnet18_freeze_bn"])
def test_lockstep_step_matches_sequential_float64(network, fed, monkeypatch):
    """One lockstep step against the members' sequential steps with every
    float in float64 (the modules, FC rows and BCE weights cast to double,
    and ``Tensor.float``, the port's casts at the input, in the heads and in
    the losses, made ``Tensor.double``): every updated tensor, the FC rows
    and BCE weights included, and every loss term agree at 1e-10.  So what
    the fp32 rounds differ by (``FP32_GAP``) is rounding."""
    mb = _members(fed, network)
    _double(mb)
    monkeypatch.setattr(torch.Tensor, "float", torch.Tensor.double)
    seq = _sequential_steps(mb)
    stacked, m = _lockstep_step(mb)
    assert stacked["fc"].dtype == stacked["bce.weight"].dtype == torch.float64
    for i, (sd, mi) in enumerate(seq):
        for name in mi._fields:
            assert getattr(m, name).dtype == torch.float64
            assert float(getattr(m, name)[i]) == pytest.approx(
                float(getattr(mi, name)), rel=1e-10, abs=1e-10), name
        assert stacked.keys() == sd.keys()
        for k, v in sd.items():
            np.testing.assert_allclose(stacked[k][i].double().numpy(), v.double().numpy(),
                                       rtol=1e-10, atol=1e-10, err_msg=k)


def test_lockstep_remat_step_equals_lockstep_step(root):
    """``--remat`` in the lockstep step changes nothing: iresnet18 with BN
    in train mode, every updated tensor (the BN running statistics and
    ``num_batches_tracked`` included, which a second update in the
    recompute would move) and every loss term equal to the step without
    it; and the server's stacked work net under ``--remat`` checkpoints
    every block."""
    mb = _members({})
    (plain, mp), (remat, mr) = _lockstep_step(mb), _lockstep_step(mb, remat=True)
    for k, v in plain.items():
        assert torch.equal(remat[k], v), k
    assert all(torch.equal(a, b) for a, b in zip(mp, mr))
    server = _port_server(root, {"lockstep": 2, "remat_blocks": True}, network="iresnet18")
    flags = [b.remat for b in server._group_net("train", 2).modules() if hasattr(b, "remat")]
    assert len(flags) == 8 and all(flags)


def test_group_draws_follow_each_member_stream(root):
    """The server's per-dispatch draws: member k's flips and dropout masks
    are the ones its sequential run draws at that step (its own
    generators, in order), and a pad slot repeats slot 0's without drawing."""
    server = _port_server(root, {"lockstep": 2, "dropout": 0.3}, network="iresnet18")
    imgs = torch.zeros(2, 8, IMG, IMG, 3, dtype=torch.uint8)
    gens = [server.clients[c].generators(0) for c in (0, 1)]
    draws = [server._group_draws([0, 1], 0, s, imgs, gens) for s in range(2)]
    pad_gens = [server.clients[2].generators(0)]
    pads = [server._group_draws([2], 1, s, imgs, pad_gens) for s in range(2)]
    d = server.backbone.fc.in_features
    for cid, k in ((0, 0), (1, 1)):
        gen, dgen = server.clients[cid].generators(0)
        for s, (flips, keep) in enumerate(draws):
            assert torch.equal(flips[k], torch.rand(8, generator=gen) < 0.5)
            assert torch.equal(keep[k], torch.rand((8, d), generator=dgen) >= 0.3)
    gen, dgen = server.clients[2].generators(0)
    for flips, keep in pads:
        assert torch.equal(flips[0], torch.rand(8, generator=gen) < 0.5)
        assert torch.equal(flips[1], flips[0]) and torch.equal(keep[1], keep[0])
        assert torch.equal(keep[0], torch.rand((8, d), generator=dgen) >= 0.3)


def test_stack_trees_round_trip_and_stacked_keys():
    net = build_backbone("iresnet18", E, bf16=False, image_size=IMG)
    states = [{k: v + i for k, v in net.state_dict().items()} for i in range(3)]
    twin = stack_module(net, 3)
    assert twin.state_dict().keys() == net.state_dict().keys()
    twin.load_state_dict(stack_trees(states))
    back = unstack_tree(twin.state_dict(), 2)
    assert len(back) == 2
    for got, want in zip(back, states):
        assert all(torch.equal(got[k], want[k]) for k in want)


# ------------------------------------------------------------- against JAX

def _np_tree(t):
    return jax.tree_util.tree_map(np.array, t)


def _pair(root, fed):
    """A JAX server and a port server with the same config, the port
    carrying the JAX server's initial state and flip stream."""
    jcfg = _configure(JConfig(), root, fed)
    jserver = JServer(jcfg, JData(jcfg, include_public=jcfg.fed.add_pretrained_data))
    server = _port_server(root, fed)
    server.global_net.load_state_dict(
        interop.toy_state_dict(_np_tree(jserver.federated_vars)))
    if jserver.pretrained_fc is not None:
        server.pretrained_fc = torch.tensor(np.asarray(jserver.pretrained_fc, np.float32))
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


@pytest.mark.parametrize("fed,ragged", [
    ({"lockstep": CLIENTS}, False),
    ({"lockstep": 2}, False),
    ({"lockstep": 2, "cache_contrastive": True}, False),
    ({"lockstep": 2, "add_pretrained_data": False, "bce_local": False}, False),
    ({"lockstep": 2}, True),
], ids=["one_group", "padded_group", "cache_contrastive", "plain", "wrap_around"])
def test_lockstep_round_matches_jax(root, ragged_root, fed, ragged):
    jserver, server = _pair(ragged_root if ragged else root, fed)
    mesh = make_mesh((1, 1, 1), devices=jax.devices()[:1])
    for s in (jserver, server):
        s.current_client_list = s.sample_clients()
    assert server.current_client_list == jserver.current_client_list
    jstats = jserver.train_round_parallel(mesh)
    stats = server.train_round_parallel()
    sizes = [c.dataset_size for c in server.clients]
    assert sizes == [jc.dataset_size for jc in jserver.clients]
    if ragged:  # client 2's epoch is longer: its peers wrap around
        assert sizes[2] > sizes[0] == sizes[1]
    for c, jc in zip(server.clients, jserver.clients):
        np.testing.assert_allclose(c.last_loss, jc.last_loss, rtol=1e-4,
                                   err_msg=f"client {c.cid}")
        np.testing.assert_allclose(c.fc_local.numpy(), np.asarray(jc.fc_local),
                                   atol=1e-4, rtol=0)
    np.testing.assert_allclose(stats["avg_loss"], jstats["avg_loss"], rtol=1e-4)
    want = interop.toy_state_dict(_np_tree(jserver.federated_vars))
    for k, v in server.global_net.state_dict().items():
        if v.is_floating_point():
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=1e-4,
                                       rtol=0, err_msg=k)
    if server.pretrained_fc is not None:
        np.testing.assert_allclose(server.pretrained_fc.numpy(),
                                   np.asarray(jserver.pretrained_fc), atol=1e-4)
