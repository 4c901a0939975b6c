"""K-fold pair-verification math (insightface protocol).

The port's numpy-only copy of ``fedfr_tpu/ops/kfold.py`` (the port imports
nothing of ``fedfr_tpu``).  Vectorized re-implementation of the reference's
eval/verification.py:41-197: 10-fold threshold sweep for accuracy on
squared-L2 distances, and
VAL@FAR=target via slinear interpolation of the per-fold FAR curve.  The
threshold sweep is a broadcasted comparison (T x N) instead of the reference's
per-threshold python loop; fold splits replicate sklearn KFold(shuffle=False)
contiguous blocks.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def kfold_indices(n: int, n_splits: int) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Contiguous K-fold splits (sklearn KFold(shuffle=False) semantics).

    First ``n % n_splits`` folds have size ``n//n_splits + 1``.  With
    n_splits <= 1 train == test == everything (reference LFold, :41-51).
    """
    idx = np.arange(n)
    if n_splits <= 1:
        return [(idx, idx)]
    if n < n_splits:
        # empty test folds would divide by zero downstream and report NaN
        # accuracy silently; fail loudly like sklearn's KFold
        raise ValueError(f"cannot split {n} pairs into {n_splits} folds")
    sizes = np.full(n_splits, n // n_splits, dtype=int)
    sizes[: n % n_splits] += 1
    out = []
    start = 0
    for size in sizes:
        test = idx[start:start + size]
        train = np.concatenate([idx[:start], idx[start + size:]])
        out.append((train, test))
        start += size
    return out


def _confusion_counts(dist: np.ndarray, issame: np.ndarray,
                      thresholds: np.ndarray) -> Tuple[np.ndarray, np.ndarray,
                                                       np.ndarray, np.ndarray]:
    """(T,) tp/fp/tn/fn for predict = dist < threshold, all thresholds at once."""
    pred = dist[None, :] < thresholds[:, None]          # (T, N)
    same = issame[None, :]
    tp = np.sum(pred & same, axis=1)
    fp = np.sum(pred & ~same, axis=1)
    fn = np.sum(~pred & same, axis=1)
    tn = np.sum(~pred & ~same, axis=1)
    return tp, fp, tn, fn


def calculate_roc(thresholds: np.ndarray, emb1: np.ndarray, emb2: np.ndarray,
                  issame: np.ndarray, nrof_folds: int = 10, pca: int = 0
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-threshold TPR/FPR (fold-averaged) + per-fold accuracy at the
    fold-best threshold (reference calculate_roc, verification.py:54-106).

    ``pca > 0`` fits a per-fold PCA on the training pairs, transforms and
    re-normalizes both embedding sets, and computes distances in that space
    (verification.py:76-88; unused by the FedFR path, kept for protocol
    completeness).
    """
    n = min(len(issame), emb1.shape[0])
    issame = np.asarray(issame, bool)
    if pca == 0:
        dist_full = np.sum((emb1 - emb2) ** 2, axis=1)

    folds = kfold_indices(n, nrof_folds)
    tprs = np.zeros((len(folds), len(thresholds)))
    fprs = np.zeros((len(folds), len(thresholds)))
    accuracy = np.zeros(len(folds))
    for k, (train, test) in enumerate(folds):
        if pca > 0:
            from sklearn.decomposition import PCA

            model = PCA(n_components=pca)
            model.fit(np.concatenate([emb1[train], emb2[train]], axis=0))
            e1 = model.transform(emb1)
            e2 = model.transform(emb2)
            e1 = e1 / np.maximum(np.linalg.norm(e1, axis=1, keepdims=True), 1e-12)
            e2 = e2 / np.maximum(np.linalg.norm(e2, axis=1, keepdims=True), 1e-12)
            dist = np.sum((e1 - e2) ** 2, axis=1)
        else:
            dist = dist_full
        tp, fp, tn, fn = _confusion_counts(dist[train], issame[train], thresholds)
        acc_train = (tp + tn) / len(train)
        best = int(np.argmax(acc_train))
        tp, fp, tn, fn = _confusion_counts(dist[test], issame[test], thresholds)
        with np.errstate(invalid="ignore", divide="ignore"):
            tprs[k] = np.where(tp + fn > 0, tp / np.maximum(tp + fn, 1), 0.0)
            fprs[k] = np.where(fp + tn > 0, fp / np.maximum(fp + tn, 1), 0.0)
        accuracy[k] = (tp[best] + tn[best]) / len(test)
    return tprs.mean(axis=0), fprs.mean(axis=0), accuracy


def _interp_threshold(far_train: np.ndarray, thresholds: np.ndarray,
                      target: float) -> float:
    """threshold(FAR=target) with scipy interp1d 'slinear' plateau semantics
    (verification.py:150-152): the interval is [last FAR < target,
    first FAR >= target], linearly interpolated."""
    j = int(np.searchsorted(far_train, target, side="left"))
    if j == 0:
        return float(thresholds[0])
    if j >= len(far_train):
        return float(thresholds[-1])
    f0, f1 = far_train[j - 1], far_train[j]
    t0, t1 = thresholds[j - 1], thresholds[j]
    if f1 == f0:
        return float(t1)
    w = (target - f0) / (f1 - f0)
    return float(t0 + w * (t1 - t0))


def calculate_val(thresholds: np.ndarray, emb1: np.ndarray, emb2: np.ndarray,
                  issame: np.ndarray, far_target: float, nrof_folds: int = 10
                  ) -> Tuple[float, float, float]:
    """VAL (TAR) at FAR=far_target, fold-averaged (verification.py:124-176)."""
    n = min(len(issame), emb1.shape[0])
    dist = np.sum((emb1 - emb2) ** 2, axis=1)
    issame = np.asarray(issame, bool)

    folds = kfold_indices(n, nrof_folds)
    val = np.zeros(len(folds))
    far = np.zeros(len(folds))
    for k, (train, test) in enumerate(folds):
        tp, fp, tn, fn = _confusion_counts(dist[train], issame[train], thresholds)
        n_diff = max(np.sum(~issame[train]), 1)
        far_train = fp / n_diff
        if np.max(far_train) >= far_target:
            threshold = _interp_threshold(far_train, thresholds, far_target)
        else:
            threshold = 0.0
        pred = dist[test] < threshold
        same = issame[test]
        n_same = max(np.sum(same), 1)
        n_diff = max(np.sum(~same), 1)
        val[k] = np.sum(pred & same) / n_same
        far[k] = np.sum(pred & ~same) / n_diff
    return float(val.mean()), float(val.std()), float(far.mean())


def evaluate(embeddings: np.ndarray, issame: np.ndarray, nrof_folds: int = 10
             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, float, float, float]:
    """Full protocol: embeddings interleaved (pair = rows 2i, 2i+1)
    (verification.py:179-197)."""
    emb1 = embeddings[0::2]
    emb2 = embeddings[1::2]
    thresholds = np.arange(0, 4, 0.01)
    tpr, fpr, accuracy = calculate_roc(thresholds, emb1, emb2, issame, nrof_folds)
    thresholds = np.arange(0, 4, 0.001)
    val, val_std, far = calculate_val(thresholds, emb1, emb2, issame, 1e-3, nrof_folds)
    return tpr, fpr, accuracy, val, val_std, far
