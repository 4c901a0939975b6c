"""The eval leg of the port against the JAX package, on the CPU.

* the ROC histogram (``roc_histogram_plain`` and the port's
  ``pairwise_roc_histogram``) against the Pallas kernel in interpret mode
  and ``pairwise_roc_histogram_device``, on the shapes of
  tests/test_pallas.py:34-83 and the empty target.  Dyadic entries make
  every dot exact in fp32, so those histograms are equal.  On random unit
  rows a different fp32 sum order can move a pair by one bin
  (roc_histogram.py:274-276), so: equal pos and neg totals, an L1 bin
  difference of at most 2 x the pairs whose fp64 similarity lies within
  1e-6 of a bin edge, and TPR tables within 100 / n_pos + 0.01 (one
  positive pair moving one bin);
* the numpy copies (kfold, openset, the TPR table, the local-eval helpers)
  bit-equal on the same inputs, and ``local_log.txt`` byte for byte;
* ``load_bin`` equal arrays; ``test_bin`` on a toy backbone carried over by
  ``interop``: embeddings atol 1e-5, accuracy within 1e-6;
* the slice as a whole: two toy rounds of the port's ``Server`` with the
  callbacks its CLI attaches, against the JAX ``Server`` with the callbacks
  train.py attaches.  After training the embeddings differ by ~1e-4 (the
  round parity of tests/test_torch_round.py), so a pair may cross a bin
  edge or a threshold: bin accuracy within one pair per fold, TPR tables
  (the epoch -1 baseline included) within 100 / n_pos + 0.01, the same
  local_log.txt lines apart from the numbers.  Fed the same (JAX) features,
  both ``client_roc``s give equal tables.
"""

import logging
import os
import pickle
import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fedfr_tpu.config import FedFRConfig as JConfig
from fedfr_tpu.data import codec as jcodec
from fedfr_tpu.data.datasets import AllClientData as JData
from fedfr_tpu.evalsuite import local_eval as jle
from fedfr_tpu.evalsuite import openset as jopenset
from fedfr_tpu.evalsuite import verification as jver
from fedfr_tpu.federated import Server as JServer
from fedfr_tpu.federated.client import _run_key
from fedfr_tpu.federated.embed import embed_dataset as j_embed
from fedfr_tpu.federated.embed import make_embed_fn
from fedfr_tpu.federated.state import flip_mask
from fedfr_tpu.models.factory import ToyNet as JToy
from fedfr_tpu.ops import kfold as jkfold
from fedfr_tpu.ops import roc_histogram as jroc
from fedfr_tpu.ops.pallas_kernels import roc_histogram as j_roc_kernel

from fedfr_tpu_torch import interop
from fedfr_tpu_torch import train as train_cli
from fedfr_tpu_torch.config import FedFRConfig
from fedfr_tpu_torch.data import AllClientData, codec, write_split
from fedfr_tpu_torch.evalsuite import local_eval as tle
from fedfr_tpu_torch.evalsuite import openset as topenset
from fedfr_tpu_torch.evalsuite import verification as tver
from fedfr_tpu_torch.federated import Server
from fedfr_tpu_torch.models import ToyNet
from fedfr_tpu_torch.ops import kfold as tkfold
from fedfr_tpu_torch.ops import roc_hist
from fedfr_tpu_torch.ops import roc_histogram as troc

import torch_threads  # noqa: F401  (each xdist worker's share of the cores)

NUM_BINS = 2001


def _np_tree(t):
    return jax.tree_util.tree_map(np.array, t)


def _unit(rng, n, e):
    x = rng.standard_normal((n, e)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _dyadic(rng, n, e):
    return rng.choice(np.array([0, 0.125, -0.125, 0.25, -0.25], np.float32),
                      size=(n, e))


def _near_edge_pairs(feats, target_size):
    """Pairs (i < target_size, i < j) whose fp64 similarity lies within 1e-6
    of a bin edge."""
    f = np.asarray(feats, np.float64)
    x = (f[:target_size] @ f.T + 1.0) * 1000.0
    near = np.abs(x - np.round(x)) < 1e-3
    i = np.arange(target_size)[:, None]
    j = np.arange(len(f))[None, :]
    return int((near & (i < j)).sum())


def _tpr_tol(hist):
    return 100.0 / max(int(np.asarray(hist).reshape(NUM_BINS, 2)[:, 0].sum()), 1) + 0.01


def _assert_hist_close(got, want, feats, target_size):
    got = np.asarray(got).reshape(NUM_BINS, 2)
    want = np.asarray(want).reshape(NUM_BINS, 2)
    np.testing.assert_array_equal(got.sum(0), want.sum(0))
    assert np.abs(got - want).sum() <= 2 * _near_edge_pairs(feats, target_size)
    np.testing.assert_allclose(troc.tpr_at_fpr_table(got),
                               jroc.tpr_at_fpr_table(want), rtol=0,
                               atol=_tpr_tol(want))


# ------------------------------------------------------------ the histogram

@pytest.mark.parametrize("kind", ["dyadic", "unit"])
@pytest.mark.parametrize("n,ts,tile_i,tile_j", [
    (100, 37, 16, 32),   # tests/test_pallas.py:44
    (64, 64, 16, 32),
    (50, 3, 16, 32),
    (100, 30, 14, 22),   # tests/test_pallas.py:71, non-lcm tiles
    (40, 0, 16, 32),     # tests/test_pallas.py:56, the empty target
])
def test_histogram_matches_pallas_interpret(n, ts, tile_i, tile_j, kind):
    rng = np.random.default_rng(n + ts)
    f = _dyadic(rng, n, 16) if kind == "dyadic" else _unit(rng, n, 16)
    labels = rng.integers(0, 7, n).astype(np.int32)
    want = np.asarray(j_roc_kernel(f, labels, ts, tile_i=tile_i, tile_j=tile_j,
                                   interpret=True))
    want_xla = np.asarray(jroc.pairwise_roc_histogram_device(
        f, labels, ts, tile_i=tile_i, tile_j=tile_j))
    ft, lt = torch.from_numpy(f), torch.from_numpy(labels)
    got = roc_hist.roc_histogram(ft, lt, ts)
    assert got.dtype == torch.int64 and got.shape == (2 * NUM_BINS,)
    # the wrapper takes the plain version on the CPU
    assert torch.equal(got, roc_hist.roc_histogram_plain(ft, lt, ts))
    pair = troc.pairwise_roc_histogram(ft, lt, ts)
    assert pair.shape == (NUM_BINS, 2) and pair.dtype == np.int64
    np.testing.assert_array_equal(pair.reshape(-1), got.numpy())
    assert got.sum() == ts * n - ts * (ts + 1) // 2
    if kind == "dyadic":
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got.numpy(), want_xla)
    else:
        _assert_hist_close(got.numpy(), want, f, ts)
        _assert_hist_close(got.numpy(), want_xla, f, ts)


def test_plain_histogram_tiling_is_neutral():
    """Ragged tiles of the plain version count the same pairs (dyadic, so
    every dot is exact whatever the tiling)."""
    rng = np.random.default_rng(5)
    f = torch.from_numpy(_dyadic(rng, 301, 16))
    labels = torch.from_numpy(rng.integers(0, 9, 301).astype(np.int32))
    ref = roc_hist.roc_histogram_plain(f, labels, 123)
    for ti, tj in [(7, 9), (123, 301), (1, 1000), (64, 5)]:
        assert torch.equal(roc_hist.roc_histogram_plain(f, labels, 123, ti, tj), ref)
    assert torch.equal(roc_hist.roc_histogram_plain(f, labels, 1000), roc_hist.
                       roc_histogram_plain(f, labels, 301))  # T clamps to N


def test_roc_histogram_wrapper_rejects_bad_inputs():
    f = torch.zeros(10, 4)
    labels = torch.zeros(10, dtype=torch.int32)
    with pytest.raises(TypeError):
        roc_hist.roc_histogram(f.double(), labels, 3)
    with pytest.raises(TypeError):
        roc_hist.roc_histogram(f, labels.long(), 3)
    with pytest.raises(ValueError):
        roc_hist.roc_histogram(f[0], labels, 3)
    with pytest.raises(ValueError):
        roc_hist.roc_histogram(torch.zeros(10, 8)[:, ::2], labels, 3)
    with pytest.raises(ValueError):
        roc_hist.roc_histogram(f, labels[:9], 3)


def test_reorder_target_first_matches_jax():
    rng = np.random.default_rng(8)
    feats = rng.standard_normal((30, 4)).astype(np.float32)
    labels = rng.integers(0, 9, 30)
    jf, jl, jt = jroc.reorder_target_first(feats, labels, 3, 6)
    f, l, t = troc.reorder_target_first(torch.from_numpy(feats), labels, 3, 6)
    assert t == jt
    assert l.dtype == torch.int32
    np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(l.numpy(), np.asarray(jl))


def test_tpr_table_and_roc_curves_match_jax():
    rng = np.random.default_rng(2)
    hist = rng.integers(0, 1000, size=(NUM_BINS, 2)).astype(np.int64)
    for a, b in zip(troc.roc_from_histogram(hist), jroc.roc_from_histogram(hist)):
        np.testing.assert_array_equal(a, b)
    assert troc.tpr_at_fpr_table(hist) == jroc.tpr_at_fpr_table(hist)
    assert troc.tpr_at_fpr_table(hist, (-2, -3)) == jroc.tpr_at_fpr_table(hist, (-2, -3))


def test_client_roc_matches_jax():
    """Dyadic features: every pair bins alike, so the tables are equal."""
    rng = np.random.default_rng(4)
    feats = _dyadic(rng, 90, 16)
    labels = np.repeat(np.arange(9), 10)
    rng.shuffle(labels)
    for start, end in [(0, 3), (3, 6), (8, 9)]:
        want = jroc.client_roc(feats, labels, start, end, tile_i=8, tile_j=16)
        assert troc.client_roc(torch.from_numpy(feats), labels, start, end) == want


# ------------------------------------------------------------ numpy copies

def test_kfold_copy_is_bit_equal():
    rng = np.random.default_rng(6)
    emb = _unit(rng, 120, 8).astype(np.float64)
    issame = rng.random(60) > 0.5
    for got, want in zip(tkfold.evaluate(emb, issame, 10),
                         jkfold.evaluate(emb, issame, 10)):
        np.testing.assert_array_equal(got, want)
    for n, k in [(60, 10), (7, 3), (5, 1)]:
        for (a, b), (c, d) in zip(tkfold.kfold_indices(n, k), jkfold.kfold_indices(n, k)):
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, d)
    with pytest.raises(ValueError):
        tkfold.kfold_indices(3, 10)


def test_openset_and_local_helpers_are_bit_equal():
    rng = np.random.default_rng(3)
    q, g = 50, 10
    qf, gf = _unit(rng, q, 8), _unit(rng, g, 8)
    mask = np.where(rng.random(q) < 0.7, rng.integers(0, g, q), -1)
    sim = qf @ gf.T
    got = topenset.openset_thresholds(sim, mask, (1e-2, 1e-1, 0.5))
    want = jopenset.openset_thresholds(sim, mask, (1e-2, 1e-1, 0.5))
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    assert (tle.open_set_identification(qf, gf, mask)
            == jle.open_set_identification(qf, gf, mask))
    assert (tle.open_set_identification(qf, gf, mask, recall_denominator=7)
            == jle.open_set_identification(qf, gf, mask, recall_denominator=7))
    labels = rng.integers(0, 20, 100)
    np.testing.assert_array_equal(tle.client_query_mask(labels, 5, 10),
                                  jle.client_query_mask(labels, 5, 10))
    tables = rng.uniform(0, 100, (7, 6)).round(2).tolist()
    assert tle.mean_tpr_tables(tables) == jle.mean_tpr_tables(tables)


def test_local_log_is_byte_equal(tmp_path):
    rows = [(0, 100, -1, [80.0, 70.5, 60.25, 50.0, 40.0, 30.0]),
            (0, 100, 9, [95.0, 90.0, 85.0, 80.0, 75.0, 0.0]),
            (100, 200, 13, [100.0, 99.99, 0.01, 0.0, 0.0, 0.0])]
    for start, end, epoch, table in rows:
        tle.append_local_log(str(tmp_path / "t"), start, end, epoch, table)
        jle.append_local_log(str(tmp_path / "j"), start, end, epoch, table)
    got = (tmp_path / "t" / "local_log.txt").read_bytes()
    assert got == (tmp_path / "j" / "local_log.txt").read_bytes()
    assert got.startswith(b"Target label from 0 to 99\nEpoch -1, TPR (-1 to -6) = [80.0,")


# ------------------------------------------------------------ .bin sets

def test_load_bin_matches_jax(tmp_path):
    """Raw payloads at the target size and JPEGs that need resize-short."""
    rng = np.random.default_rng(5)
    bins, issame = [], []
    for i in range(6):
        for _ in range(2):
            if i < 3:
                bins.append(codec.encode_raw(rng.integers(0, 255, (16, 16, 3), dtype=np.uint8)))
            else:
                bins.append(jcodec.encode_jpeg(rng.integers(0, 255, (20, 20, 3),
                                                            dtype=np.uint8)))
        issame.append(bool(i % 2))
    path = str(tmp_path / "pairs.bin")
    with open(path, "wb") as f:
        pickle.dump((bins, issame), f)
    data, same = tver.load_bin(path, (16, 16), use_cache=False)
    jdata, jsame = jver.load_bin(path, (16, 16), use_cache=False)
    np.testing.assert_array_equal(data, jdata)
    np.testing.assert_array_equal(same, jsame)
    # the cache round trip
    data2, _ = tver.load_bin(path, (16, 16))
    os.remove(path)
    data3, same3 = tver.load_bin(path, (16, 16))
    np.testing.assert_array_equal(data3, data)
    np.testing.assert_array_equal(same3, same)


def test_bin_verification_matches_jax():
    """80 images (40 pairs), batch 24: the last window slides back to end at
    N.  Embeddings atol 1e-5, accuracy within 1e-6."""
    rng = np.random.default_rng(12)
    data = rng.integers(0, 255, (80, 16, 16, 3)).astype(np.uint8)
    issame = rng.random(40) > 0.5
    jnet = JToy(embedding_size=8)
    jvars = _np_tree(jnet.init(jax.random.PRNGKey(3), jnp.zeros((1, 16, 16, 3))))
    want = jver.test_bin(make_embed_fn(jnet), jvars, data, issame, batch_size=24)
    net = ToyNet(embedding_size=8)
    net.load_state_dict(interop.toy_state_dict(jvars))
    got = tver.test_bin(net, data, issame, batch_size=24, device="cpu")
    np.testing.assert_allclose(got[3], want[3], atol=1e-5, rtol=0)
    assert abs(got[0] - want[0]) <= 1e-6 and abs(got[1] - want[1]) <= 1e-6
    assert abs(got[2] - want[2]) <= 1e-5


# ------------------------------------------------------------ the slice

NUM_CLIENTS, IDS, IMG, PUB_IDS, VERI_IMGS, BIN_PAIRS = 2, 3, 16, 6, 6, 200


@pytest.fixture(scope="module")
def eval_root(tmp_path_factory):
    """The round data of tests/test_torch_round.py, plus a local_veri split
    (the ``test`` prefix, global labels, the train identities' patterns) and
    a val/agedb_30.bin of BIN_PAIRS pairs."""
    root = tmp_path_factory.mktemp("torch_eval")
    rng = np.random.default_rng(7)

    def noisy(base):
        return np.clip(base + rng.integers(-40, 40, size=base.shape), 0, 255).astype(np.uint8)

    def write(d, prefix, payloads, labels, num_classes, id_base):
        os.makedirs(d, exist_ok=True)
        write_split(os.path.join(d, f"{prefix}.idx"), os.path.join(d, f"{prefix}.rec"),
                    payloads, labels, num_classes=num_classes, id_base=id_base)

    split = root / ("split_train_i%04dc%04d" % (NUM_CLIENTS * IDS, NUM_CLIENTS))
    bases = rng.integers(0, 200, size=(NUM_CLIENTS * IDS, IMG, IMG, 3))
    for c in range(NUM_CLIENTS):
        payloads, labels = [], []
        for i in range(IDS):
            for _ in range(8):
                payloads.append(codec.encode_raw(noisy(bases[c * IDS + i])))
                labels.append(i)
        write(str(split / ("client_%04d" % c)), "train", payloads, labels, IDS, c * IDS)
    pub = rng.integers(0, 200, size=(PUB_IDS, IMG, IMG, 3))
    write(str(root / "split_pretrain_6000" / "client_0000"), "train",
          [codec.encode_raw(noisy(pub[i])) for i in range(PUB_IDS) for _ in range(5)],
          [i for i in range(PUB_IDS) for _ in range(5)], PUB_IDS, None)
    write(str(root / "local_veri"), "test",
          [codec.encode_raw(noisy(b)) for b in bases for _ in range(VERI_IMGS)],
          [g for g in range(NUM_CLIENTS * IDS) for _ in range(VERI_IMGS)],
          NUM_CLIENTS * IDS, None)
    bins, issame = [], []
    for k in range(BIN_PAIRS):
        a, b = rng.integers(0, 200, size=(2, IMG, IMG, 3))
        same = k % 2 == 0
        bins += [codec.encode_raw(noisy(a)), codec.encode_raw(noisy(a if same else b))]
        issame.append(same)
    os.makedirs(root / "val")
    with open(root / "val" / "agedb_30.bin", "wb") as f:
        pickle.dump((bins, issame), f)
    return str(root)


def _configure(cfg, root, out):
    cfg.data.rec_root = root
    cfg.data.val_root = os.path.join(root, "val")
    cfg.data.local_veri_dir = os.path.join(root, "local_veri")
    cfg.data.num_clients = NUM_CLIENTS
    cfg.data.num_ids = NUM_CLIENTS * IDS
    cfg.data.image_size = IMG
    cfg.data.combined_batch_size = 8
    cfg.data.public_batch_size = 16
    cfg.data.eval_batch_size = 16
    cfg.data.num_workers = 2
    cfg.model.network = "toy"
    cfg.model.embedding_size = 16
    cfg.model.bf16 = False
    cfg.optim.lr = 0.01
    cfg.fed.local_epochs = 1
    cfg.fed.client_parallel = False
    cfg.runtime.output_dir = out
    cfg.runtime.val_targets = ["agedb_30"]
    return cfg


def _attach_jax_callbacks(cfg, server, data):
    """The callbacks as train.py:105-159 builds them."""
    bin_cb = jver.BinVerificationCallback(
        server._embed_fn, cfg.runtime.val_targets, cfg.data.val_root,
        batch_size=cfg.data.eval_batch_size,
        image_size=(cfg.data.image_size, cfg.data.image_size))
    local_cb = jle.LocalVerificationCallback(
        server.backbone, server.bce_module, data.veri_dataset(cfg.data.local_veri_dir),
        cfg.runtime.output_dir, batch_size=cfg.data.eval_batch_size,
        plain_embed_fn=server._embed_fn)

    def eval_callback(server):
        return {"acc": bin_cb(server.global_round, server.federated_vars)}

    def local_eval_callback(server, client, epoch=None, variables=None):
        if variables is None:
            variables = client.trained_backbone
        if variables is None:
            return
        if epoch is None:
            epoch = server.global_epoch + server.local_epoch - 1
        bce_params = (client.bce_vars["params"] if client.bce_vars is not None
                      and epoch != -1 else None)
        local_cb.veri_test(variables, epoch, client.target_ids, client.cid, bce_params)

    server.eval_callback = eval_callback
    server.local_eval_callback = local_eval_callback
    return bin_cb, local_cb


_LINE = re.compile(r"(Target label from \d+ to \d+|Epoch -?\d+, TPR \(-1 to -6\) = )(.*)")


def test_two_rounds_with_eval_match_jax(eval_root, tmp_path):
    jcfg = _configure(JConfig(), eval_root, str(tmp_path / "jax"))
    jcfg.fed.hn_threshold = -1.0  # mine the whole public set on both sides
    jdata = JData(jcfg)
    jserver = JServer(jcfg, jdata)
    jbin, jlocal = _attach_jax_callbacks(jcfg, jserver, jdata)

    cfg = _configure(FedFRConfig(), eval_root, str(tmp_path / "port"))
    cfg.fed.hn_threshold = -1.0
    cfg.runtime.device = "cpu"
    data = AllClientData(cfg)
    server = Server(cfg, data)
    spent = {"local_eval": 0.0}
    bin_cb, local_cb = train_cli.attach_callbacks(
        cfg, server, data, logging.getLogger("test_torch_eval"), spent)

    # carry the JAX server's initial state into the port (test_torch_round.py)
    server.global_net.load_state_dict(
        interop.toy_state_dict(_np_tree(jserver.federated_vars)))
    server._init_pretrain_fc()
    assert server.local_candidates == jserver.local_candidates == [0, 1]
    for c, jc in zip(server.clients, jserver.clients):
        assert c.target_ids == jc.target_ids
        state = interop.client_state("toy", jc.fc_local, _np_tree(jc.bce_vars),
                                     _np_tree(jc.last_backbone))
        c.fc_local, c.bce_state, c.last_backbone = (
            state["fc_local"], state["bce_state"], state["last_backbone"])

        def flip_fn(step_no, imgs, cid=c.cid):
            key = jax.random.fold_in(_run_key(jcfg.runtime.seed,
                                              server.global_round, cid), step_no)
            return np.asarray(flip_mask(key, imgs.shape[0]))
        c.flip_fn = flip_fn

    fold = BIN_PAIRS // 10
    for rnd in range(2):
        for s in (jserver, server):
            s.current_client_list = s.sample_clients()
        jserver.train_round()
        server.train_round()
        want, got = jserver.test(), server.test()
        assert len(got["acc"]) == len(want["acc"]) == 1
        assert abs(got["acc"][0] - want["acc"][0]) <= 1.0 / fold + 1e-12, (rnd, got, want)
        for s in (jserver, server):
            s.advance_round()
    assert spent["local_eval"] > 0
    assert bin_cb.names == jbin.names == ["agedb_30"]

    n_pos = IDS * VERI_IMGS * (VERI_IMGS - 1) // 2  # target pairs of one identity x IDS
    tol = 100.0 / n_pos + 0.01
    for cid in (0, 1):
        recs, jrecs = local_cb.client_record[cid], jlocal.client_record[cid]
        assert [e for e, _ in recs] == [e for e, _ in jrecs] == [-1, 0, 4]
        for (_, table), (_, jtable) in zip(recs, jrecs):
            np.testing.assert_allclose(table, jtable, rtol=0, atol=tol)
        path = os.path.join("clients", f"client_{cid}", "local_log.txt")
        lines = open(os.path.join(cfg.runtime.output_dir, path)).read().splitlines()
        jlines = open(os.path.join(jcfg.runtime.output_dir, path)).read().splitlines()
        assert len(lines) == len(jlines) == 6
        for a, b in zip(lines, jlines):
            ma, mb = _LINE.fullmatch(a), _LINE.fullmatch(b)
            assert ma and mb and ma.group(1) == mb.group(1)

    # fed the same features, both client_rocs give equal tables
    jc = jserver.clients[1]
    feats, labels = j_embed(make_embed_fn(jserver.backbone, jserver.bce_module),
                            jc.trained_backbone, jdata.veri_dataset(jcfg.data.local_veri_dir),
                            16, bce_params=jc.bce_vars["params"])
    feats = np.asarray(feats)
    start, end = jc.target_ids[0], jc.target_ids[-1] + 1
    jf, jl, tsize = jroc.reorder_target_first(feats, labels, start, end)
    f, l, _ = troc.reorder_target_first(torch.from_numpy(feats), labels, start, end)
    hist = troc.pairwise_roc_histogram(f, l, tsize)
    jhist = jroc.pairwise_roc_histogram(np.asarray(jf), np.asarray(jl), tsize)
    assert np.abs(hist - jhist).sum() <= 2 * _near_edge_pairs(np.asarray(jf), tsize)
    assert (troc.client_roc(torch.from_numpy(feats), labels, start, end)
            == jroc.client_roc(feats, labels, start, end))
