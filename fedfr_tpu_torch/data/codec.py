"""Image payload codecs for record datasets (a copy of
``fedfr_tpu/data/codec.py`` without the JPEG encoder).

Real FedFR recs carry JPEG payloads decoded via mxnet (reference
dataset.py:220 ``mx.image.imdecode``).  Here decoding is pluggable:

* JPEG/PNG via cv2 (libjpeg-turbo) when present, else PIL;
* ``FRAW`` — a trivial raw-tensor payload used by synthetic fixtures and by
  the offline split tools when re-encoding is undesirable.

All decoders return HWC uint8 RGB, matching the reference's decode output.
"""

from __future__ import annotations

import struct

import numpy as np

try:
    import cv2  # type: ignore

    _HAS_CV2 = True
except Exception:  # pragma: no cover
    _HAS_CV2 = False

_RAW_MAGIC = b"FRAW"


def encode_raw(img: np.ndarray) -> bytes:
    """Encode an HWC uint8 image as a raw payload (no compression)."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    h, w, c = img.shape
    return _RAW_MAGIC + struct.pack("<HHH", h, w, c) + img.tobytes()


def decode(payload: bytes) -> np.ndarray:
    """Decode a record payload into an HWC uint8 RGB image."""
    if payload[:4] == _RAW_MAGIC:
        h, w, c = struct.unpack("<HHH", payload[4:10])
        return np.frombuffer(payload, dtype=np.uint8, offset=10).reshape(h, w, c).copy()
    if _HAS_CV2:
        arr = np.frombuffer(payload, dtype=np.uint8)
        img = cv2.imdecode(arr, cv2.IMREAD_COLOR)
        if img is None:
            raise ValueError("cv2 failed to decode payload")
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    # PIL fallback
    import io

    from PIL import Image

    with Image.open(io.BytesIO(payload)) as im:
        return np.asarray(im.convert("RGB"))

