"""Offline FL and public-set splits: the port's copy of the repository's
``split_dataset/split_FL.py`` and ``split_dataset/split_pretrain.py``.

From a source MS1M-style rec (``train.rec``/``train.idx``) ``split_fl``
writes

* ``local_veri_<N>``: each sampled ID's first ``test_imgs`` images
  (``test.rec`` + ``idx_id_pair.txt``),
* ``local_gallery_<N>``: the remaining images of each ID (``test.rec``),
* ``split_train_i<N>c<C>/client_%04d``: each client's ``train.rec``,
  relabelled 0..K-1, with the client's global ID base in the header,

and ``split_pretrain`` writes the public set ``split_pretrain_<N>/client_%04d``
(relabelled 0..K-1 unless ``dis_relabel``).  Both read and write through
the port's ``data/recordio.py`` and cache the identity index in
``<output_dir>/ID2idx.pickle``, keyed on the source rec's path and size.

The files are byte for byte the scripts' from the same source rec.  Each
script seeds ``random`` (and numpy, which it never draws from) with 100 at
import and shuffles the identity list once, so a run of either script as
its own process draws ``random.Random(100).shuffle``; each function here
draws that from a generator of its own, and leaves the caller's ``random``
stream alone.  The first half of the shuffled IDs feeds the FL pool, the
last half the public set.
"""

from __future__ import annotations

import logging
import os
import pickle
import random
from collections import OrderedDict, defaultdict
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

from .recordio import IRHeader, IndexedRecordReader, IndexedRecordWriter, pack

SEED = 100  # split_FL.py:32-33, split_pretrain.py:26-27
ID_CACHE = "ID2idx.pickle"

logger = logging.getLogger("fedfr_tpu_torch.split")


def build_id_index(reader: IndexedRecordReader, cache_path: str) -> Dict[float, List[int]]:
    """Identity -> its record keys (split_FL.py:36-63), from the cache at
    ``cache_path`` when it was built from the same source rec (absolute
    path and size), else read from the rec and cached there."""
    src = getattr(reader, "rec_path", None) or ""
    src_key = (os.path.abspath(src),
               os.path.getsize(src) if src and os.path.exists(src) else -1)
    if os.path.exists(cache_path):
        with open(cache_path, "rb") as f:
            cached = pickle.load(f)
        if isinstance(cached, dict) and cached.get("src_key") == list(src_key):
            return cached["id_dict"]
    header, _ = reader.read_idx(0)
    n = (int(np.asarray(header.label).reshape(-1)[0]) - 1 if header.flag > 0
         else len(reader.keys) - 1)
    id_dict = defaultdict(list)
    for key in range(1, n + 1):
        h, _ = reader.read_idx(key)
        id_dict[h.scalar_label].append(key)
    with open(cache_path, "wb") as f:
        pickle.dump({"src_key": list(src_key), "id_dict": id_dict}, f, protocol=5)
    return id_dict


def _source(data_dir: str, output_dir: str):
    os.makedirs(output_dir, exist_ok=True)
    reader = IndexedRecordReader(os.path.join(data_dir, "train.idx"),
                                 os.path.join(data_dir, "train.rec"))
    return reader, build_id_index(reader, os.path.join(output_dir, ID_CACHE))


def _shuffled_ids(id_dict) -> list:
    ids = list(id_dict.keys())
    random.Random(SEED).shuffle(ids)  # split_FL.py:98, split_pretrain.py:47
    return ids


def _copy_records(reader: IndexedRecordReader, writer: IndexedRecordWriter,
                  relabel: Iterable[Tuple[int, Sequence[int]]], txt=None) -> int:
    """Copy each ``(new_id, keys)``'s records from ``reader`` with the new
    label, keys 1, 2, ... (split_FL.py:66-80); returns the next key."""
    img_idx = 1
    for new_id, rec_keys in relabel:
        for key in rec_keys:
            _, payload = reader.read_idx(key)
            writer.write_idx(img_idx, pack(IRHeader(0, float(new_id), img_idx, 0), payload))
            if txt is not None:
                txt.write("%d %d\n" % (img_idx, new_id))
            img_idx += 1
    return img_idx


def _write_header(writer: IndexedRecordWriter, flag: int, values) -> None:
    writer.write_idx(0, pack(IRHeader(flag, np.asarray([float(v) for v in values]), 0, 0),
                             b""))
    writer.close()


def _writer(d: str, prefix: str) -> IndexedRecordWriter:
    os.makedirs(d, exist_ok=True)
    return IndexedRecordWriter(os.path.join(d, f"{prefix}.idx"),
                               os.path.join(d, f"{prefix}.rec"))


def split_fl(data_dir: str, output_dir: str, num_client: int = 40, num_id: int = 4000,
             min_imgs: int = 101, max_imgs: int = 109,
             test_imgs: int = 40) -> Dict[str, object]:
    """``split_FL.py``'s main (its flags, its defaults): the veri, gallery
    and per-client train splits of the first half of the shuffled IDs with
    ``min_imgs..max_imgs`` images, the first ``num_id`` of them.  Returns
    the three output paths and the counts the script prints."""
    reader, id_dict = _source(data_dir, output_dir)
    ids = _shuffled_ids(id_dict)
    candidates = ids[: int(len(ids) * 0.5)]
    samp = [i for i in candidates if max_imgs + 1 > len(id_dict[i]) > min_imgs - 1][:num_id]
    if len(samp) < num_id:
        raise ValueError(f"only {len(samp)} IDs satisfy the image-count filter")
    test_dict, train_dict = OrderedDict(), OrderedDict()
    for relabel, src_id in enumerate(samp):
        test_dict[relabel] = id_dict[src_id][:test_imgs]
        train_dict[relabel] = id_dict[src_id][test_imgs:]

    out: Dict[str, object] = {}
    veri_dir = os.path.join(output_dir, f"local_veri_{num_id}")
    w = _writer(veri_dir, "test")
    with open(os.path.join(veri_dir, "idx_id_pair.txt"), "w") as txt:
        txt.write("idx id\n")
        img_idx = _copy_records(reader, w, test_dict.items(), txt)
    _write_header(w, 2, (img_idx, len(test_dict)))
    out.update(veri_dir=veri_dir, veri_imgs=img_idx - 1)

    gal_dir = os.path.join(output_dir, f"local_gallery_{num_id}")
    w = _writer(gal_dir, "test")
    img_idx = _copy_records(reader, w, train_dict.items())
    _write_header(w, 2, (img_idx, len(train_dict)))
    out.update(gallery_dir=gal_dir, gallery_imgs=img_idx - 1)

    train_root = os.path.join(output_dir, "split_train_i%04dc%04d" % (num_id, num_client))
    per_client = num_id // num_client
    client_imgs = []
    for c in range(num_client):
        start = c * per_client
        w = _writer(os.path.join(train_root, "client_%04d" % c), "train")
        img_idx = _copy_records(reader, w, [(new_id, train_dict[start + new_id])
                                            for new_id in range(per_client)])
        _write_header(w, 3, (img_idx, per_client, start))
        client_imgs.append(img_idx - 1)
    out.update(train_root=train_root, client_imgs=client_imgs)
    reader.close()
    logger.info("split_fl: %d veri and %d gallery images of %d IDs, clients %s",
                out["veri_imgs"], out["gallery_imgs"], num_id, client_imgs)
    return out


def split_pretrain(data_dir: str, output_dir: str, num_client: int = 1,
                   num_id: int = 6000, min_imgs: int = 61, max_imgs: int = 79,
                   dis_relabel: bool = False) -> str:
    """``split_pretrain.py``'s main (its flags, its defaults): the public
    set from the last half of the shuffled IDs with ``min_imgs..max_imgs``
    images, the first ``num_id`` of them over ``num_client`` recs.  Returns
    the root ``split_pretrain_<N>``."""
    reader, id_dict = _source(data_dir, output_dir)
    ids = _shuffled_ids(id_dict)
    candidates = ids[len(ids) - int(len(ids) * 0.5):]
    samp = [i for i in candidates if max_imgs + 1 > len(id_dict[i]) > min_imgs - 1]
    if len(samp) < num_id:
        raise ValueError(f"only {len(samp)} IDs qualify")
    samp = samp[:num_id]
    root = os.path.join(output_dir, f"split_pretrain_{len(samp)}")
    start = 0
    for c in range(num_client):
        k = len(samp) // num_client + int((len(samp) % num_client) > c)
        client_ids = samp[start:start + k]
        start += k
        w = _writer(os.path.join(root, "client_%04d" % c), "train")
        img_idx = _copy_records(reader, w, [(src_id if dis_relabel else new_id, id_dict[src_id])
                                            for new_id, src_id in enumerate(client_ids)])
        _write_header(w, 2, (img_idx, len(client_ids)))
        logger.info("split_pretrain: public client %d: %d imgs, %d IDs", c,
                    img_idx - 1, len(client_ids))
    reader.close()
    return root

