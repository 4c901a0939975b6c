"""IJB-C: the port's ``evalsuite/ijbc.py``, ``evalsuite/align.py`` and the
``fedfr_tpu_torch.ijbc_all`` / ``ijbc_conti`` CLIs against the JAX package,
on the CPU.

* the whole eval (``run_ijbc``, both jobs) with the host and the device
  engine against the JAX ``run_ijbc`` on the same toy weights carried by
  ``interop``, on a copy of the miniature layout of
  ``tests/test_ijbc_pipeline.py``: equal tables and ranks, scores within
  2e-6, and the same aligned-image cache;
* aggregation (host and device engines, the ``choose_templates`` subset and
  the empty subset) within 1e-5 of the JAX host oracle, pair scores within
  2e-6; two device aggregations bitwise equal;
* ``roc_curve`` equal to scikit-learn's and ``tpr_at_fpr`` to the JAX one on
  random, tied and all-equal scores;
* the numpy readers give the pandas path's arrays;
* ``align_face`` equals the JAX one bitwise;
* ``ijbc_conti`` over two exports writes the JAX CLI's log;
* chip_smoke.py's synthetic-root writer at miniature counts writes the JAX
  writer's files and drives ``run_ijbc`` through both jobs;
* without cv2 and without the cache, the embedding raises naming the cache.
"""

import argparse
import importlib.util
import os
import shutil
import sys

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
import ijbc_conti as jax_conti  # noqa: E402
from fedfr_tpu.evalsuite import align as jalign  # noqa: E402
from fedfr_tpu.evalsuite import ijbc as jijbc  # noqa: E402
from fedfr_tpu.federated.embed import auto_embed_fn  # noqa: E402
from fedfr_tpu.models import build_backbone as jax_backbone  # noqa: E402
from fedfr_tpu.utils.checkpoint import save_native  # noqa: E402

from fedfr_tpu_torch import ijbc_all, ijbc_conti, interop  # noqa: E402
from fedfr_tpu_torch.evalsuite import align as talign  # noqa: E402
from fedfr_tpu_torch.evalsuite import ijbc  # noqa: E402
from fedfr_tpu_torch.models import build_backbone  # noqa: E402

import torch_threads  # noqa: F401  (each xdist worker's share of the cores)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_SUBJECTS = 4


@pytest.fixture(autouse=True)
def _fp32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _write_miniature(root) -> None:
    """tests/test_ijbc_pipeline.py:22-89's layout: per subject one gallery
    template (1 image) and one probe template (2 images, 2 medias), solid
    colour loose crops with noise, canonical-ish landmarks."""
    meta = root / "meta" / "IJBC_meta"
    crop = root / "loose_crop"
    meta.mkdir(parents=True)
    crop.mkdir()
    rng = np.random.default_rng(0)
    base_lmk = np.array([[45, 60], [85, 60], [65, 80], [50, 100], [80, 100]],
                        np.float32)
    names, tids, mids, lines = [], [], [], []
    tid = img_id = 0
    gallery, probes = [], []
    for s in range(N_SUBJECTS):
        color = rng.integers(40, 255, 3)
        for t_kind in ("g", "p"):
            for k in range(1 if t_kind == "g" else 2):
                name = f"img_{img_id}.jpg"
                img = np.zeros((150, 120, 3), np.uint8)
                img[:] = color
                noise = rng.integers(0, 30, (150, 120, 3))
                img = np.clip(img.astype(int) + noise, 0, 255).astype(np.uint8)
                cv2.imwrite(str(crop / name), img)
                lmk = base_lmk + rng.normal(0, 1.0, (5, 2)).astype(np.float32)
                score = 0.9 + 0.05 * rng.random()
                lines.append(name + " " + " ".join(
                    f"{v:.3f}" for v in lmk.reshape(-1)) + f" {score:.4f}")
                names.append(name)
                tids.append(tid)
                mids.append(1000 + img_id if t_kind == "g" else 2000 + k)
                img_id += 1
            (gallery if t_kind == "g" else probes).append((tid, s))
            tid += 1
    with open(meta / "ijbc_face_tid_mid.txt", "w") as f:
        for n, t, m in zip(names, tids, mids):
            f.write(f"{n} {t} {m}\n")
    with open(meta / "ijbc_name_5pts_score.txt", "w") as f:
        f.write("\n".join(lines) + "\n")
    with open(meta / "ijbc_template_pair_label.txt", "w") as f:
        for pt, ps in probes:
            for gt, gs in gallery:
                f.write(f"{pt} {gt} {int(ps == gs)}\n")
    for name, rows in (("gallery_G1", gallery[: N_SUBJECTS // 2]),
                       ("gallery_G2", gallery[N_SUBJECTS // 2:]),
                       ("probe_mixed", probes)):
        with open(meta / f"ijbc_1N_{name}.csv", "w") as f:
            f.write("TEMPLATE_ID,SUBJECT_ID\n")
            for t, s in rows:
                f.write(f"{t},{s}\n")


@pytest.fixture(scope="module")
def ijbc_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_ijbc")
    _write_miniature(root)
    return str(root)


def _toy_pair(seed: int, emb: int = 32, size: int = 112):
    """JAX toy variables (host numpy) and the port's ToyNet holding them."""
    variables = jax.device_get(jax_backbone("toy", emb).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, size, size, 3)), train=False))
    net = build_backbone("toy", emb)
    net.load_state_dict(interop.backbone_state_dict("toy", variables))
    return variables, net.eval()


def _scores(result_dir):
    return np.load(os.path.join(result_dir, "ijbc-1:1", "ijbc.npy"))


@pytest.mark.parametrize("engine", ["host", "device"])
def test_run_ijbc_matches_jax(engine, ijbc_root, tmp_path):
    """Both jobs; the port aligns a fresh copy of the loose crops itself, so
    its cache is held against the JAX package's too."""
    variables, net = _toy_pair(0)
    jres = jijbc.run_ijbc(auto_embed_fn(jax_backbone("toy", 32)), variables,
                          ijbc_root, str(tmp_path / "jax"), epoch=3, job="both",
                          batch_size=4, engine="host")
    own = tmp_path / "root"
    shutil.copytree(ijbc_root, own, ignore=shutil.ignore_patterns("IJBC_imgs.npy"))
    tres = ijbc.run_ijbc(net, str(own), str(tmp_path / "port"), epoch=3, job="both",
                         batch_size=4, engine=engine, device="cpu")
    np.testing.assert_array_equal(np.load(own / "IJBC_imgs.npy"),
                                  np.load(os.path.join(ijbc_root, "IJBC_imgs.npy")))
    assert tres["tpr_at_fpr"] == jres["tpr_at_fpr"]
    assert tres["rank"] == jres["rank"] and tres["rank"]["top1"] == 1.0
    assert tres["tpir_at_fpir"] == jres["tpir_at_fpir"]
    np.testing.assert_allclose(_scores(tmp_path / "port"), _scores(tmp_path / "jax"),
                               atol=2e-6)
    for job in ("1:1", "1:n"):
        got = open(tmp_path / "port" / f"ijbc-{job}" / "log.txt").read()
        assert got == open(tmp_path / "jax" / f"ijbc-{job}" / "log.txt").read()
    assert set(tres["seconds"]) >= {"embed", "aggregate", "score_pairs", "one_to_n"}


def test_ijbc_all_cli_auto_engine_and_load_feature(ijbc_root, tmp_path):
    """The CLI on a .pth export (auto: the host engine on the CPU), then the
    same features through --load_feature on the device engine."""
    _, net = _toy_pair(1)
    path = str(tmp_path / "backbone_7.pth")
    torch.save(net.state_dict(), path)
    base = ["--model-prefix", path, "--root-path", ijbc_root, "--network", "toy",
            "--embedding_size", "32", "--batch-size", "4", "--job", "both",
            "--device", "cpu"]
    args = ijbc_all.build_parser().parse_args(base + ["--result-dir", str(tmp_path / "a")])
    assert args.engine == "auto"
    first = ijbc_all.main(args)
    feats = ijbc.image_features(net, ijbc_root, 4, engine="host", device="cpu")
    np.save(tmp_path / "feats.npy", feats)
    second = ijbc_all.main(ijbc_all.build_parser().parse_args(base + [
        "--result-dir", str(tmp_path / "b"), "--engine", "device",
        "--load_feature", str(tmp_path / "feats.npy")]))
    assert first["tpr_at_fpr"] == second["tpr_at_fpr"]
    assert first["rank"] == second["rank"]
    np.testing.assert_allclose(_scores(tmp_path / "b"), _scores(tmp_path / "a"), atol=2e-6)


def _random_case(seed=11, n=400, dim=16, n_tmpl=37):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((n, dim), dtype=np.float32)
    templates = rng.integers(0, n_tmpl, n).astype(np.int64)
    templates[:n_tmpl] = np.arange(n_tmpl)
    medias = rng.integers(0, 4, n).astype(np.int64)
    return rng, feats, templates, medias


@pytest.mark.parametrize("subset", ["all", "chosen", "empty"])
def test_aggregation_matches_jax_oracle(subset):
    rng, feats, templates, medias = _random_case()
    args = ()
    if subset == "chosen":
        choose = np.unique(templates)[::3]
        args = (choose, choose * 7)
    elif subset == "empty":
        args = (np.array([100, 101], np.int64), np.array([7, 8], np.int64))
    ref = jijbc.image_to_template_features(feats, templates, medias, *args)
    host = ijbc.image_to_template_features(feats, templates, medias, *args)
    dev = ijbc.image_to_template_features_device(torch.from_numpy(feats), templates,
                                                 medias, *args)
    again = ijbc.image_to_template_features_device(torch.from_numpy(feats), templates,
                                                   medias, *args)
    for got in (host, dev):
        for a, b in zip(got[1:], ref[1:]):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(host[0], ref[0])
    np.testing.assert_allclose(dev[0].numpy(), ref[0], atol=1e-5)
    assert torch.equal(dev[0], again[0])
    if subset == "empty":
        assert not dev[0].any()


def test_pair_scores_match_jax_oracle():
    rng, feats, templates, medias = _random_case()
    tf, ut = jijbc.image_to_template_features(feats, templates, medias)
    tf_d, _ = ijbc.image_to_template_features_device(torch.from_numpy(feats),
                                                     templates, medias)
    p1 = ut[rng.integers(0, len(ut), 1000)]
    p2 = ut[rng.integers(0, len(ut), 1000)]
    ref = jijbc.pair_scores(tf, ut, p1, p2)
    np.testing.assert_array_equal(ijbc.pair_scores(tf, ut, p1, p2), ref)
    np.testing.assert_allclose(ijbc.pair_scores_device(tf_d, ut, p1, p2, chunk=128),
                               ref, atol=2e-6)


def _score_cases():
    rng = np.random.default_rng(5)
    labels = rng.integers(0, 2, 2000)
    return {
        "random": (labels, rng.standard_normal(2000).astype(np.float32)),
        "tied": (labels, np.round(rng.standard_normal(2000), 1).astype(np.float32)),
        "all_equal": (labels, np.full(2000, 0.25, np.float32)),
        "few_levels": (labels, rng.integers(0, 4, 2000).astype(np.float32)),
        "separable": (labels, labels + 0.01 * rng.random(2000).astype(np.float32)),
    }


@pytest.mark.parametrize("case", sorted(_score_cases()))
def test_tpr_at_fpr_matches_sklearn(case):
    from sklearn.metrics import roc_curve

    labels, scores = _score_cases()[case]
    for got, want in zip(ijbc.roc_curve(labels, scores), roc_curve(labels, scores)):
        np.testing.assert_array_equal(got, want)
    assert ijbc.tpr_at_fpr(labels, scores) == jijbc.tpr_at_fpr(labels, scores)


def test_readers_match_pandas_path(tmp_path):
    pytest.importorskip("pandas")
    rng = np.random.default_rng(2)
    n = 500
    tid_mid = tmp_path / "tid_mid.txt"
    tid_mid.write_text("".join(f"img_{i}.jpg {t} {m}\n" for i, (t, m) in enumerate(
        rng.integers(0, 10**6, (n, 2)))))
    pairs = tmp_path / "pairs.txt"
    pairs.write_bytes(chip_smoke.int_lines([rng.integers(0, 23124, n),
                                            rng.integers(0, 23124, n),
                                            rng.integers(0, 2, n)]))
    csv = tmp_path / "g1.csv"
    csv.write_text("TEMPLATE_ID,SUBJECT_ID\n" + "".join(
        f"{a},{b}\n" for a, b in rng.integers(0, 10**5, (n, 2))))
    for fn, path in ((ijbc.read_template_media_list, tid_mid),
                     (ijbc.read_template_pair_list, pairs),
                     (ijbc.read_template_subject_id_list, csv)):
        got = fn(str(path))
        want = getattr(jijbc, fn.__name__)(str(path))
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.dtype == np.int64
            np.testing.assert_array_equal(a, b)


def test_align_face_matches_jax():
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (150, 120, 3)).astype(np.uint8)
    for lmk in (np.array([[45, 60], [85, 60], [65, 80], [50, 100], [80, 100]],
                         np.float32) + rng.normal(0, 2, (5, 2)).astype(np.float32),
                rng.uniform(20, 110, (68, 2)).astype(np.float32)):
        np.testing.assert_array_equal(talign.align_face(img, lmk),
                                      jalign.align_face(img, lmk))
        np.testing.assert_array_equal(talign.umeyama(talign.landmarks5(lmk),
                                                     talign.ARCFACE_SRC),
                                      jalign.umeyama(jalign.landmarks5(lmk),
                                                     jalign.ARCFACE_SRC))


def test_ijbc_conti_writes_the_jax_clis_log(ijbc_root, tmp_path):
    """Two exports as the JAX package's .npz: both CLIs, in process, write
    the same ijbc-1:1 log; the port's model is built once."""
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir()
    for e in (0, 1):
        variables, _ = _toy_pair(e, emb=16)
        save_native(variables, str(jdir / f"backbone_{e}.npz"))
    shutil.copytree(jdir, tdir)
    jax_conti.main(argparse.Namespace(ckpt_dir=str(jdir), root_path=ijbc_root,
                                      batch_size=8, job="both", epoch=[0, 1],
                                      network="toy", embedding_size=16, gpu=None))
    out = ijbc_conti.main(ijbc_conti.build_parser().parse_args([
        "--ckpt_dir", str(tdir), "--root_path", ijbc_root, "--batch_size", "8",
        "--job", "both", "--epoch", "0", "1", "--network", "toy",
        "--embedding_size", "16", "--gpu", "0", "1", "--device", "cpu"]))
    assert len(out) == 2
    for job in ("1:1", "1:n"):
        got = open(tdir / f"ijbc-{job}" / "log.txt").read()
        assert got == open(jdir / f"ijbc-{job}" / "log.txt").read()
        assert got.count("Epoch ") == 2


def _jax_writer():
    spec = importlib.util.spec_from_file_location(
        "posttrain_eval_tpu", os.path.join(REPO, "experiments", "posttrain_eval_tpu.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_synth_root_writer_matches_jax_and_drives_run_ijbc(tmp_path):
    pytest.importorskip("pandas")
    synth = ("synth:clients=2,ids_per_client=2,public_ids=4,public_imgs=20,"
             "veri_ids=4,veri_imgs=2,image_size=32,block=8,noise=5")
    counts = dict(n_subjects=6, n_probe_templates=18, n_images=300, n_pairs=600)
    jroot, troot = str(tmp_path / "jax"), str(tmp_path / "port")
    _jax_writer().build_synth_ijbc_root(jroot, synth, **counts)
    seconds = chip_smoke.write_synth_ijbc_root(troot, synth, batch=64, device="cpu",
                                               **counts)
    assert set(seconds) == {"meta_s", "images_s"}
    meta = os.path.join("meta", "IJBC_meta")
    for name in sorted(os.listdir(os.path.join(jroot, meta))):
        with open(os.path.join(troot, meta, name), "rb") as a, \
                open(os.path.join(jroot, meta, name), "rb") as b:
            assert a.read() == b.read(), name
    np.testing.assert_array_equal(np.load(os.path.join(troot, "IJBC_imgs.npy")),
                                  np.load(os.path.join(jroot, "IJBC_imgs.npy")))
    _, net = _toy_pair(0, size=32)
    res = ijbc.run_ijbc(net, troot, str(tmp_path / "res"), epoch=0, job="both",
                        batch_size=32, device="cpu")
    assert len(res["tpr_at_fpr"]) == 6
    assert set(res["rank"]) == {"top1", "top5", "top10"}
    assert res["rank"]["top1"] > 0.4  # the block identities are distinct


def test_no_cv2_and_no_cache_raises_naming_the_cache(ijbc_root, tmp_path, monkeypatch):
    own = tmp_path / "root"
    shutil.copytree(ijbc_root, own, ignore=shutil.ignore_patterns("IJBC_imgs.npy"))
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="IJBC_imgs.npy"):
        ijbc.run_ijbc(build_backbone("toy", 8), str(own), str(tmp_path / "r"),
                      device="cpu")
