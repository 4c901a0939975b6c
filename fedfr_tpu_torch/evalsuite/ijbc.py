"""IJB-C generic evaluation: 1:1 verification and 1:n open-set identification.

The port's counterpart of ``fedfr_tpu/evalsuite/ijbc.py`` (an in-process,
vectorized form of the reference's ijbc_all.py), in the same order:

* meta readers for the tid/mid list, the template pairs and the
  gallery/probe csvs (ijbc_all.py:113-135), in numpy alone: the protocol's
  pair list is 15,658,489 lines and ``np.loadtxt`` with an integer dtype
  parses it in C (pandas, which the JAX package reads it with, is not a
  dependency of the port);
* the host engine: media-mean then template-sum aggregation with f64
  accumulation and chunked pair scoring, in numpy, as the JAX package's;
* the device engine, on torch tensors that stay on the device: the two
  segment sums are ``torch.segment_reduce`` over rows sorted by segment, so
  that they are deterministic (``index_add_`` on CUDA accumulates with
  atomics in no fixed order, and the TPR@FPR=1e-6 point reacts to small
  shifts); the pair scores a chunked gather and a row dot in fp32, with no
  tensor-core product (the JAX package passes ``Precision.HIGHEST``);
* ``tpr_at_fpr``: scikit-learn's ``roc_curve`` (with its default
  ``drop_intermediate=True``) ported to numpy, then the closest-FPR TPR
  (ijbc_all.py:561-590); the 1:n top-k and TPIR@FPIR (ijbc_all.py:367-427)
  on the host, with ``openset.openset_thresholds``;
* ``extract_ijbc_features`` (align + embed) and ``run_ijbc``, the whole job
  with the reference's ``log.txt`` and ``.npy`` outputs.

None of this is a Pallas kernel in the JAX package, and none is a
hand-written kernel here.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..data.pipeline import prefetched
from ..federated.embed import ShardedEmbed
from ..parallel.mesh import Mesh, auto_data_mesh
from ..utils.device import resolve_device
from ..utils.table import ascii_table
from .align import align_face
from .openset import openset_thresholds

logger = logging.getLogger("fedfr_tpu_torch.ijbc")

Feats = Union[np.ndarray, torch.Tensor]


# --------------------------------------------------------------- meta readers

def _read_int_columns(path: str, usecols: Sequence[int], delimiter=None,
                      skiprows: int = 0) -> List[np.ndarray]:
    """Integer columns of a whitespace- or comma-separated table (int64)."""
    arr = np.loadtxt(path, dtype=np.int64, usecols=tuple(usecols),
                     delimiter=delimiter, skiprows=skiprows, ndmin=2)
    return [arr[:, i] for i in range(len(usecols))]


def read_template_media_list(path: str) -> Tuple[np.ndarray, np.ndarray]:
    t, m = _read_int_columns(path, (1, 2))
    return t, m


def read_template_pair_list(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    p1, p2, label = _read_int_columns(path, (0, 1, 2))
    return p1, p2, label


def read_template_subject_id_list(path: str) -> Tuple[np.ndarray, np.ndarray]:
    t, s = _read_int_columns(path, (0, 1), delimiter=",", skiprows=1)
    return t, s


def read_image_list(path: str) -> Tuple[List[str], np.ndarray, np.ndarray]:
    """name_5pts_score lines -> (names, (N,5,2) landmarks, (N,) faceness)."""
    names: List[str] = []
    lmks: List[np.ndarray] = []
    scores: List[float] = []
    with open(path) as f:
        for line in f:
            parts = line.strip().split(" ")
            if not parts or not parts[0]:
                continue
            names.append(parts[0])
            vals = np.array([float(x) for x in parts[1:-1]], np.float32)
            lmks.append(vals.reshape(5, 2))
            scores.append(float(parts[-1]))
    return names, np.stack(lmks), np.asarray(scores, np.float32)


# ------------------------------------------------------- the host engine

def _chosen(templates: np.ndarray, choose_templates: Optional[np.ndarray],
            choose_ids: Optional[np.ndarray]):
    if choose_templates is not None:
        unique_templates, first_idx = np.unique(choose_templates, return_index=True)
        unique_ids = choose_ids[first_idx] if choose_ids is not None else None
    else:
        unique_templates = np.unique(templates)
        unique_ids = None
    return unique_templates, unique_ids


def _with_ids(out, unique_templates, unique_ids):
    if unique_ids is not None:
        return out, unique_templates, unique_ids
    return out, unique_templates


def image_to_template_features(img_feats: np.ndarray, templates: np.ndarray,
                               medias: np.ndarray,
                               choose_templates: Optional[np.ndarray] = None,
                               choose_ids: Optional[np.ndarray] = None):
    """Media-mean then template-sum aggregation, l2-normalized, on the host.

    Images sharing (template, media) are averaged; the distinct medias of a
    template are summed (ijbc_all.py:242-257), with f64 accumulation (the
    strict TPR@FPR=1e-6 point is sensitive to small score shifts) and the
    rows cast per chunk of groups.  Returns (template_feats,
    unique_templates[, unique_subject_ids]).
    """
    unique_templates, unique_ids = _chosen(templates, choose_templates, choose_ids)
    keep = np.isin(templates, unique_templates)
    feats = img_feats[keep]
    tmpl = templates[keep]
    med = medias[keep]
    if len(tmpl) == 0:  # no image rows for any chosen template
        out = np.zeros((len(unique_templates), img_feats.shape[1]))
        return _with_ids(out, unique_templates, unique_ids)

    # stage 1: mean over (template, media) groups (sort + add.reduceat)
    dim = feats.shape[1]
    pair_code = tmpl.astype(np.int64) * (med.max() + 1) + med
    order = np.argsort(pair_code, kind="stable")
    sorted_code = pair_code[order]
    starts = np.flatnonzero(np.r_[True, sorted_code[1:] != sorted_code[:-1]])
    codes = sorted_code[starts]
    counts = np.diff(np.r_[starts, len(sorted_code)])
    f32sorted = np.asarray(feats, np.float32)[order]
    bounds = np.r_[starts, len(sorted_code)]
    sums = np.empty((len(starts), dim), np.float64)
    group_chunk = 4096
    for g0 in range(0, len(starts), group_chunk):
        g1 = min(g0 + group_chunk, len(starts))
        row0, row1 = bounds[g0], bounds[g1]
        sums[g0:g1] = np.add.reduceat(
            f32sorted[row0:row1].astype(np.float64), starts[g0:g1] - row0,
            axis=0)
    media_feats = sums / counts[:, None]
    media_tmpl = (codes // (med.max() + 1)).astype(np.int64)

    # stage 2: sum over each template's medias (codes are sorted, and the
    # template id is the code's high part, so media_tmpl is sorted)
    t_index = np.searchsorted(unique_templates, media_tmpl)
    out = np.zeros((len(unique_templates), dim), np.float64)
    seg_starts = np.flatnonzero(np.r_[True, t_index[1:] != t_index[:-1]])
    out[t_index[seg_starts]] = np.add.reduceat(media_feats, seg_starts, axis=0)

    norms = np.linalg.norm(out, axis=1, keepdims=True)
    out = out / np.maximum(norms, 1e-12)
    return _with_ids(out, unique_templates, unique_ids)


def template_rows(unique_templates: np.ndarray, p1: np.ndarray,
                  p2: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The rows of the template matrix that the pairs' template ids name."""
    t2id = np.zeros(unique_templates.max() + 1, dtype=np.int64)
    t2id[unique_templates] = np.arange(len(unique_templates))
    return t2id[p1], t2id[p2]


def pair_scores(template_feats: np.ndarray, unique_templates: np.ndarray,
                p1: np.ndarray, p2: np.ndarray,
                batch: int = 100000) -> np.ndarray:
    """Cosine scores for template pairs on the host, chunked, fp32 gathers
    (ijbc_all.py:300-326)."""
    i1, i2 = template_rows(unique_templates, p1, p2)
    tf32 = np.ascontiguousarray(template_feats, dtype=np.float32)
    score = np.zeros(len(p1), np.float32)
    for s in range(0, len(p1), batch):
        e = min(s + batch, len(p1))
        score[s:e] = np.einsum("ij,ij->i", tf32[i1[s:e]], tf32[i2[s:e]])
    return score


# ------------------------------------------------------- the device engine

def image_to_template_features_device(img_feats: torch.Tensor, templates: np.ndarray,
                                      medias: np.ndarray,
                                      choose_templates: Optional[np.ndarray] = None,
                                      choose_ids: Optional[np.ndarray] = None):
    """The same aggregation on ``img_feats``' device, in fp32, returning a
    tensor there.  The index arithmetic runs on the host (small integer
    vectors); the kept rows are gathered in segment order and reduced by
    two ``segment_reduce`` sums, each output row summed in one fixed order,
    so two runs give the same bits."""
    unique_templates, unique_ids = _chosen(templates, choose_templates, choose_ids)
    dev = img_feats.device
    n_tmpl, dim = len(unique_templates), img_feats.shape[1]
    rows = np.flatnonzero(np.isin(templates, unique_templates))
    if len(rows) == 0:
        out = torch.zeros(n_tmpl, dim, dtype=torch.float32, device=dev)
        return _with_ids(out, unique_templates, unique_ids)
    med_base = int(medias.max()) + 1
    pair_code = templates[rows].astype(np.int64) * med_base + medias[rows]
    codes, inverse, counts = np.unique(pair_code, return_inverse=True,
                                       return_counts=True)
    order = rows[np.argsort(inverse, kind="stable")]
    t_index = np.searchsorted(unique_templates, codes // med_base)
    medias_per_tmpl = np.bincount(t_index, minlength=n_tmpl)

    def on_dev(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    feats = img_feats.float().index_select(0, on_dev(order))
    counts_t = on_dev(counts)
    sums = torch.segment_reduce(feats, "sum", lengths=counts_t, axis=0)
    media_feats = sums / counts_t[:, None].float()
    out = torch.segment_reduce(media_feats, "sum", lengths=on_dev(medias_per_tmpl),
                               axis=0)
    out = out / torch.linalg.vector_norm(out, dim=1, keepdim=True).clamp_min(1e-12)
    return _with_ids(out, unique_templates, unique_ids)


def row_dot_scores(tf: torch.Tensor, i1: torch.Tensor, i2: torch.Tensor,
                   chunk: int = 1 << 18) -> torch.Tensor:
    """``(tf[i1] * tf[i2]).sum(1)`` on ``tf``'s device, per chunk of rows:
    two row gathers and an fp32 row dot (a multiply and a sum: no matrix
    product, so TF32 never enters)."""
    score = torch.empty(len(i1), dtype=torch.float32, device=tf.device)
    for s in range(0, len(i1), chunk):
        e = min(s + chunk, len(i1))
        score[s:e] = (tf.index_select(0, i1[s:e]) * tf.index_select(0, i2[s:e])).sum(1)
    return score


def pair_scores_device(template_feats: torch.Tensor, unique_templates: np.ndarray,
                       p1: np.ndarray, p2: np.ndarray,
                       chunk: int = 1 << 18) -> np.ndarray:
    """Cosine scores for template pairs on the feature matrix's device
    (``row_dot_scores`` over int32 row indices); returns the (P,) fp32
    scores on the host."""
    dev = template_feats.device
    i1, i2 = (torch.from_numpy(i.astype(np.int32)).to(dev)
              for i in template_rows(unique_templates, p1, p2))
    return row_dot_scores(template_feats.float().contiguous(), i1, i2,
                          chunk).cpu().numpy()


# ------------------------------------------------------------------- metrics

def roc_curve(labels: np.ndarray, scores: np.ndarray) -> Tuple[np.ndarray, np.ndarray,
                                                               np.ndarray]:
    """scikit-learn's ``roc_curve(labels, scores)`` at its defaults
    (positive label 1, ``drop_intermediate=True``): (fpr, tpr, thresholds)
    with thresholds decreasing from ``inf``.  Scores are sorted in
    decreasing order and one point is kept per distinct score (the counts
    at a tie's last row), so ties do not depend on the sort's order; then
    the points collinear with their neighbours are dropped, then (0, 0) is
    prepended."""
    y = (np.asarray(labels) == 1).astype(np.float64)
    s = np.asarray(scores)
    order = np.argsort(s, kind="stable")[::-1]
    s, y = s[order], y[order]
    idx = np.r_[np.nonzero(np.diff(s))[0], y.size - 1]
    tps = np.cumsum(y)[idx]
    fps = 1 + idx.astype(np.float64) - tps
    thresholds = s[idx]
    if fps.shape[0] > 2:
        keep = np.nonzero(np.r_[True, np.logical_or(np.diff(fps, 2), np.diff(tps, 2)),
                                True])[0]
        fps, tps, thresholds = fps[keep], tps[keep], thresholds[keep]
    tps = np.r_[0.0, tps]
    fps = np.r_[0.0, fps]
    thresholds = np.r_[np.inf, thresholds.astype(np.float64)]
    fpr = fps / fps[-1] if fps[-1] > 0 else np.full(fps.shape, np.nan)
    tpr = tps / tps[-1] if tps[-1] > 0 else np.full(tps.shape, np.nan)
    return fpr, tpr, thresholds


def tpr_at_fpr(labels: np.ndarray, scores: np.ndarray,
               x_labels: Sequence[float] = (1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 1e-1)
               ) -> List[float]:
    """ROC sweep + closest-FPR TPR selection x100 (ijbc_all.py:572-585)."""
    fpr, tpr, _ = roc_curve(labels, scores)
    fpr = np.flipud(fpr)
    tpr = np.flipud(tpr)
    out = []
    for x in x_labels:
        idx = int(np.argmin(np.abs(fpr - x)))
        out.append(float("%.2f" % (tpr[idx] * 100)))
    return out


def identification_1n(probe_feats: np.ndarray, gallery_feats: np.ndarray,
                      mask: np.ndarray, fars: Sequence[float] = (0.01, 0.1)
                      ) -> Tuple[Dict[str, float], Dict[float, float]]:
    """Open-set 1:n on the host: top-1/5/10 + TPIR@FPIR (ijbc_all.py:367-427)."""
    q = probe_feats.shape[0]
    sim = probe_feats @ gallery_feats.T
    mask = np.asarray(mask)
    # only ranks 1..10 are reported: a partial top-k, not a full argsort
    kmax = min(10, sim.shape[1])
    if kmax < sim.shape[1]:
        part = np.argpartition(-sim, kmax - 1, axis=1)[:, :kmax]
    else:
        part = np.broadcast_to(np.arange(kmax), sim.shape).copy()
    part_order = np.argsort(np.take_along_axis(-sim, part, axis=1), axis=1)
    order = np.take_along_axis(part, part_order, axis=1)
    rank = {}
    for k in (1, 5, 10):
        hits = (order[:, :min(k, kmax)] == mask[:, None]).any(axis=1)
        rank[f"top{k}"] = float(hits.mean())
    # the ranks above consumed sim; nothing reads it afterwards
    pos_sims, ths = openset_thresholds(sim, mask, fars, inplace=True)
    pr = {far: float(np.sum(pos_sims > th)) / q for far, th in zip(fars, ths)}
    return rank, pr


def gen_mask(query_ids: np.ndarray, reg_ids: np.ndarray) -> np.ndarray:
    """Probe subject -> gallery position; every probe must match exactly one
    gallery entry (ijbc_all.py:356-365)."""
    pos = {int(sid): i for i, sid in enumerate(reg_ids)}
    counts: Dict[int, int] = {}
    for sid in reg_ids:
        counts[int(sid)] = counts.get(int(sid), 0) + 1
    out = np.empty(len(query_ids), dtype=np.int64)
    for i, qid in enumerate(query_ids):
        if counts.get(int(qid), 0) != 1:
            raise RuntimeError(f"RegIdsError with id = {qid}, duplicate = "
                               f"{counts.get(int(qid), 0)}")
        out[i] = pos[int(qid)]
    return out


# ------------------------------------------------------------------ pipeline

def aligned_images(root_path: str, cache_path: Optional[str], target: str = "IJBC"):
    """(aligned uint8 NHWC images, (N,) faceness): the cache at
    ``cache_path`` (``<target>_imgs.npy``, memory-mapped) when it exists,
    else the loose crops aligned on a thread pool (cv2) and, best effort,
    written to the cache."""
    meta_dir = os.path.join(root_path, f"meta/{target}_meta")
    names, lmks, faceness = read_image_list(
        os.path.join(meta_dir, f"{target.lower()}_name_5pts_score.txt"))
    n = len(names)
    if cache_path and os.path.exists(cache_path):
        return np.load(cache_path, mmap_mode="r"), faceness
    from concurrent.futures import ThreadPoolExecutor

    imgs = np.empty((n, 112, 112, 3), np.uint8)
    img_dir = os.path.join(root_path, "loose_crop")

    def align_one(i: int) -> None:
        imgs[i] = align_face(os.path.join(img_dir, names[i]), lmks[i])

    try:
        align_one(0)
    except ImportError as e:
        raise ImportError(
            f"aligning the loose crops of {root_path} needs cv2 (opencv); "
            f"without it, provide the aligned-image cache {cache_path}") from e
    # cv2 releases the GIL inside imread/warpAffine, so threads scale
    with ThreadPoolExecutor(max_workers=min(32, os.cpu_count() or 4)) as pool:
        list(pool.map(align_one, range(1, n), chunksize=256))
    if cache_path:
        try:  # best effort, like the .bin decode cache
            np.save(cache_path, imgs)
        except OSError as e:
            logger.warning("could not write alignment cache %s: %s", cache_path, e)
    return imgs, faceness


@torch.no_grad()
def extract_ijbc_features(model: nn.Module, root_path: str, batch_size: int = 256,
                          use_flip_test: bool = False,
                          cache_path: Optional[str] = None, target: str = "IJBC",
                          return_device: bool = False,
                          device: Union[str, torch.device] = "cuda",
                          mesh: Optional[Mesh] = None):
    """Align and embed the image list (ijbc_all.py:142-223) with ``model``
    (already on ``device``, run in eval mode, over ``mesh``'s ``data`` axis,
    default the auto layout): fixed-size uint8 batches (the last padded by
    repeating its first image, then cut), copied to the devices by a
    background thread; ``use_flip_test`` appends the embedding of the
    W-mirrored image.  Returns ((N, E or 2E) fp32 features, on ``device``
    with ``return_device``, else on the host; (N,) faceness)."""
    device = resolve_device(device)
    imgs, faceness = aligned_images(root_path, cache_path, target)
    n = len(faceness)
    embed = ShardedEmbed(model, mesh if mesh is not None else auto_data_mesh(device))

    def batches():
        for s in range(0, n, batch_size):
            e = min(s + batch_size, n)
            batch = np.array(imgs[s:e])
            if e - s < batch_size:
                batch = np.concatenate([batch, np.repeat(batch[:1], batch_size - (e - s), 0)])
            yield s, e, embed.place(batch)

    chunks: List[torch.Tensor] = []
    host_feats = None
    for s, e, placed in prefetched(batches(), 2):
        f = embed.embed(placed)
        if use_flip_test:
            f = torch.cat([f, embed.embed(placed, flip=True)], dim=1)
        if return_device:
            chunks.append(f[: e - s])
        else:
            if host_feats is None:
                host_feats = np.empty((n, f.shape[1]), np.float32)
            host_feats[s:e] = f[: e - s].cpu().numpy()
        if (s // batch_size) % 100 == 0:
            logger.info("embedded %d/%d", e, n)
    if return_device:
        return torch.cat(chunks), faceness
    return host_feats, faceness


def image_features(model: nn.Module, root_path: str, batch_size: int = 256,
                   use_norm_score: bool = True, use_detector_score: bool = True,
                   use_flip_test: bool = False, target: str = "IJBC",
                   engine: str = "host",
                   device: Union[str, torch.device] = "cuda") -> Feats:
    """The image features the aggregation reads (ijbc_all.py:512-531):
    embedded through the aligned-image cache, the flip halves summed, l2
    normalised unless ``use_norm_score``, scaled by faceness under
    ``use_detector_score``; a tensor on the device for the device engine,
    else a host array."""
    on_dev = engine == "device"
    feats, faceness = extract_ijbc_features(
        model, root_path, batch_size, use_flip_test,
        cache_path=os.path.join(root_path, f"{target}_imgs.npy"), target=target,
        return_device=on_dev, device=device)
    if on_dev:
        feats = feats.float()
        faceness = torch.from_numpy(faceness).to(feats.device)
    if use_flip_test:
        half = feats.shape[1] // 2
        feats = feats[:, :half] + feats[:, half:]
    if not use_norm_score:
        if on_dev:
            feats = feats / torch.linalg.vector_norm(feats, dim=1, keepdim=True).clamp_min(1e-12)
        else:
            feats = feats / np.maximum(np.linalg.norm(feats, axis=1, keepdims=True), 1e-12)
    if use_detector_score:
        feats = feats * faceness[:, None]
    return feats


def run_ijbc(model: Optional[nn.Module], root_path: str, result_dir: str,
             epoch: int = 0, job: str = "1:1", batch_size: int = 256,
             use_norm_score: bool = True, use_detector_score: bool = True,
             use_flip_test: bool = False, target: str = "IJBC",
             preloaded_feats: Optional[np.ndarray] = None, engine: str = "auto",
             device: Union[str, torch.device] = "cuda") -> Dict[str, object]:
    """The whole IJB-C job of the reference CLI (ijbc_all.py:429-628):
    ``job`` "1:1", "1:n" or "both"; appends ``<result_dir>/<target>-1:1/log.txt``
    (the TPR@FPR table) and writes ``<target>.npy`` (the pair scores), and
    appends ``<target>-1:n/log.txt`` (top-k, TPIR@FPIR).

    ``engine``: "device" keeps the features on the card from the embedding
    to the pair scores; "host" is the numpy pipeline; "auto" picks the
    device engine on a CUDA device and the host engine on the CPU.
    ``preloaded_feats`` (pre-forwarded image features, ``--load_feature``)
    skip the embedding and its score adjustments, as in the JAX package.
    The results also hold ``seconds`` by stage (each ending synchronized).
    """
    device = resolve_device(device)
    if engine == "auto":
        engine = "device" if device.type == "cuda" else "host"
    sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" else (lambda: None)
    seconds: Dict[str, float] = {}
    meta_dir = os.path.join(root_path, f"meta/{target}_meta")
    t0 = time.perf_counter()
    templates, medias = read_template_media_list(
        os.path.join(meta_dir, f"{target.lower()}_face_tid_mid.txt"))
    seconds["read_media"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    if preloaded_feats is not None:
        img_feats: Feats = preloaded_feats
        if engine == "device":
            img_feats = torch.from_numpy(np.ascontiguousarray(preloaded_feats)).to(device)
    else:
        img_feats = image_features(model, root_path, batch_size, use_norm_score,
                                   use_detector_score, use_flip_test, target,
                                   engine, device)
    sync()
    seconds["embed"] = time.perf_counter() - t0

    aggregate = (image_to_template_features_device if engine == "device"
                 else image_to_template_features)
    results: Dict[str, object] = {}
    if job in ("1:1", "both"):
        t0 = time.perf_counter()
        p1, p2, label = read_template_pair_list(
            os.path.join(meta_dir, f"{target.lower()}_template_pair_label.txt"))
        seconds["read_pairs"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        tfeats, utemplates = aggregate(img_feats, templates, medias)
        sync()
        seconds["aggregate"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        score = (pair_scores_device if engine == "device" else pair_scores)(
            tfeats, utemplates, p1, p2)
        seconds["score_pairs"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        table = tpr_at_fpr(label, score)
        seconds["roc"] = time.perf_counter() - t0
        results["tpr_at_fpr"] = table
        save_dir = os.path.join(result_dir, f"{target.lower()}-1:1")
        os.makedirs(save_dir, exist_ok=True)
        np.save(os.path.join(save_dir, f"{target.lower()}.npy"), score)
        x_labels = [1e-6, 1e-5, 1e-4, 1e-3, 1e-2, 1e-1]
        tbl = ascii_table(["Methods"] + [str(x) for x in x_labels],
                          [[f"{target.lower()}-{target}"] + [f"{v:.2f}" for v in table]])
        with open(os.path.join(save_dir, "log.txt"), "a") as f:
            f.write(f"Epoch {epoch} : \n{tbl}\n")
        logger.info("\n%s", tbl)

    if job in ("1:n", "both"):
        t0 = time.perf_counter()
        g1t, g1s = read_template_subject_id_list(
            os.path.join(meta_dir, f"{target.lower()}_1N_gallery_G1.csv"))
        g2t, g2s = read_template_subject_id_list(
            os.path.join(meta_dir, f"{target.lower()}_1N_gallery_G2.csv"))
        gallery_t = np.concatenate([g1t, g2t])
        gallery_s = np.concatenate([g1s, g2s])
        probe_t, probe_s = read_template_subject_id_list(
            os.path.join(meta_dir, f"{target.lower()}_1N_probe_mixed.csv"))
        gfeats, _, gids = aggregate(img_feats, templates, medias, gallery_t, gallery_s)
        pfeats, _, pids = aggregate(img_feats, templates, medias, probe_t, probe_s)
        mask = gen_mask(pids, gids)

        def host(x: Feats) -> np.ndarray:
            x = x.cpu().numpy() if isinstance(x, torch.Tensor) else x
            return x.astype(np.float32, copy=False)

        # the open-set heap logic stays on the host, as in the JAX package
        rank, pr = identification_1n(host(pfeats), host(gfeats), mask)
        seconds["one_to_n"] = time.perf_counter() - t0
        results["rank"] = rank
        results["tpir_at_fpir"] = pr
        save_dir = os.path.join(result_dir, f"{target.lower()}-1:n")
        os.makedirs(save_dir, exist_ok=True)
        with open(os.path.join(save_dir, "log.txt"), "a") as f:
            f.write(f"Epoch {epoch} : \n")
            for r, v in rank.items():
                f.write(f"{r} : {v:.5f}\n")
            for far, v in pr.items():
                f.write(f"far = {far:.4f}  pr = {v:.5f}\n")
    results["seconds"] = seconds
    return results
