"""5-landmark similarity-transform face alignment (IJB-C preprocessing).

The port's copy of ``fedfr_tpu/evalsuite/align.py``: the reference's
skimage.SimilarityTransform + cv2.warpAffine path (ijbc_all.py:55-90) with
an in-house Umeyama estimation; warping stays on cv2, which is imported
inside ``align_face`` only (it is needed to align loose crops, not to
evaluate from the aligned-image cache).  The canonical 112x112 landmark
template is the standard arcface one with the +8px x-shift the reference
applies (ijbc_all.py:55-62).
"""

from __future__ import annotations

from typing import Union

import numpy as np

ARCFACE_SRC = np.array(
    [[30.2946 + 8.0, 51.6963],
     [65.5318 + 8.0, 51.5014],
     [48.0252 + 8.0, 71.7366],
     [33.5493 + 8.0, 92.3655],
     [62.7299 + 8.0, 92.2041]], dtype=np.float32)


def umeyama(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Least-squares similarity transform (Umeyama 1991) src -> dst.

    Returns the 2x3 matrix [sR | t] suitable for cv2.warpAffine.
    """
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    n, d = src.shape
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    src_c = src - mu_s
    dst_c = dst - mu_d
    cov = dst_c.T @ src_c / n
    U, S, Vt = np.linalg.svd(cov)
    sgn = np.ones(d)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        sgn[-1] = -1
    R = U @ np.diag(sgn) @ Vt
    var_s = (src_c ** 2).sum() / n
    scale = (S * sgn).sum() / var_s if var_s > 0 else 1.0
    t = mu_d - scale * R @ mu_s
    M = np.empty((2, 3), np.float64)
    M[:, :2] = scale * R
    M[:, 2] = t
    return M


def landmarks5(landmark: np.ndarray) -> np.ndarray:
    """68-point -> 5-point reduction (ijbc_all.py:69-79)."""
    landmark = np.asarray(landmark, np.float32)
    if landmark.shape[0] == 5:
        return landmark
    lm5 = np.zeros((5, 2), np.float32)
    lm5[0] = (landmark[36] + landmark[39]) / 2
    lm5[1] = (landmark[42] + landmark[45]) / 2
    lm5[2] = landmark[30]
    lm5[3] = landmark[48]
    lm5[4] = landmark[54]
    return lm5


def align_face(img_bgr: Union[np.ndarray, str], landmark: np.ndarray,
               image_size: int = 112) -> np.ndarray:
    """Warp a BGR image (or the image file at that path, read by cv2) to
    the canonical crop; returns HWC uint8 RGB."""
    import cv2

    if isinstance(img_bgr, str):
        img_bgr = cv2.imread(img_bgr)
    M = umeyama(landmarks5(landmark), ARCFACE_SRC)
    warped = cv2.warpAffine(img_bgr, M, (image_size, image_size), borderValue=0.0)
    return cv2.cvtColor(warped, cv2.COLOR_BGR2RGB)
