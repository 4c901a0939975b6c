"""Record-backed face datasets and the per-client dataset map.

The port's copy of ``fedfr_tpu/data/datasets.py`` for rec roots:

* ``FaceRecordDataset`` — one split rec (client shard / public set / veri set)
  with an optional active index subset (used by hard-negative mining, which
  mirrors ``dataset.imgidx`` surgery at reference client.py:217).
* ``CombinedDataset`` — local + public view with public labels shifted by the
  local class count (reference dataset.py:170-187).
* ``BatchLoader`` — the same seeded numpy shuffle as the JAX package, so a
  client sees its batches in the same order on both sides.
* ``AllClientData`` — the client shards + public train set
  (reference dataset.py:73-142), and the local verification split; on a
  ``synth:`` root the device-generated universe of ``data/synthetic.py``.

A rec split is decoded by the native reader (``fedfr_tpu_torch/native``:
C++ threads, its own JPEG decoder) where its first record is one the reader
decodes and square; else on the Python path (``codec.decode`` on a host
thread pool), with one log line that says why (``use_native=False`` chooses
the Python path).  Where a later record fails natively, the split and every
view of it go on on the Python path for good, as the JAX package's reader
does: one warning names the key and the reason, ``native.counters``
counts the switch, and the batch that failed is decoded again on the Python
path, so every image is cv2's.  Augmentation (random hflip) and
normalization run on the device inside the train step, so the host only
moves uint8 bytes.  ``synth:`` batches are generated on the device: the host
moves only a few int32 words per image.
"""

from __future__ import annotations

import logging
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Tuple

import numpy as np
import torch

from . import codec
from .. import native as native_mod
from ..native import NativeReader
from .recordio import IndexedRecordReader, SplitMeta, read_split_meta
from .synthetic import (build_fl_synthetic, explicit_synth_keys,
                        is_synth_spec, parse_synth_spec, synth_device_batch)

logger = logging.getLogger("fedfr_tpu_torch.data")
_switch_lock = threading.Lock()


def native_threads() -> int:
    """The native reader's decode threads: every core this process may run
    on (the JAX package takes 8)."""
    return len(os.sched_getaffinity(0))


class FaceRecordDataset:
    """A single indexed rec split: images keyed 1..N with integer labels."""

    def __init__(self, root_dir: str, prefix: str = "train",
                 use_native: bool = True):
        idx_path = os.path.join(root_dir, f"{prefix}.idx")
        rec_path = os.path.join(root_dir, f"{prefix}.rec")
        self.reader = IndexedRecordReader(idx_path, rec_path)
        self.meta: SplitMeta = read_split_meta(self.reader)
        # active record keys; hard-negative mining installs a subset
        self.imgidx: np.ndarray = np.arange(1, self.meta.num_images + 1)
        self._labels: Optional[np.ndarray] = None
        # the native reader, or None on the Python path; one box shared with
        # every subset view, so that a switch holds for all of them
        self._plane: List[Optional[NativeReader]] = [None]
        if use_native and self.meta.num_images > 0:
            self._plane[0] = self._open_native(idx_path, rec_path)

    def _open_native(self, idx_path: str, rec_path: str) -> Optional[NativeReader]:
        """The native reader where the split's first record is one it
        decodes (FRAW, or a JPEG of a kind it supports) and is square (JAX
        datasets.py ``_try_native``); else None, logged with the reason.  A
        failed build raises."""
        reader = NativeReader(idx_path, rec_path, threads=native_threads())
        try:
            h, w = reader.probe(int(self.imgidx[0]))
        except IOError as e:
            why = str(e)
        else:
            if h == w:
                reader.image_size = h
                return reader
            why = f"its images are {h}x{w}, not square"
        reader.close()
        logger.info("%s: read on the Python path (%s)", rec_path, why)
        return None

    @property
    def _native(self) -> Optional[NativeReader]:
        return self._plane[0]

    def _switch_to_python(self, reader: NativeReader, err: IOError) -> None:
        """A record ``reader`` rejects after the split opened natively: the
        split goes on on the Python path for good (JAX datasets.py:62-72),
        with one warning and one count however many threads hit it."""
        with _switch_lock:
            if self._plane[0] is not reader:
                return
            self._plane[0] = None
        native_mod.count_switch()
        logger.warning("%s; the split goes on on the Python path (cv2) for good", err)

    @property
    def native(self) -> bool:
        """Whether the native reader decodes this split."""
        return self._native is not None

    @property
    def image_size(self) -> Optional[int]:
        return self._native.image_size if self._native is not None else None

    @property
    def num_classes(self) -> Optional[int]:
        return self.meta.num_classes

    @property
    def id_base(self) -> Optional[int]:
        return self.meta.id_base

    def __len__(self) -> int:
        return len(self.imgidx)

    def read(self, pos: int) -> Tuple[np.ndarray, int]:
        """Decode active item ``pos`` -> (HWC uint8 image, label)."""
        key = int(self.imgidx[pos])
        reader = self._native
        if reader is not None:
            try:
                imgs, labels = reader.read_batch([key])
                return imgs[0], int(labels[0])
            except IOError as e:
                self._switch_to_python(reader, e)
        return self._read_python(key)

    def _read_python(self, key: int) -> Tuple[np.ndarray, int]:
        header, payload = self.reader.read_idx(key)
        return codec.decode(payload), int(header.scalar_label)

    def read_batch(self, positions: np.ndarray, out: Optional[np.ndarray] = None,
                   rows: Optional[np.ndarray] = None):
        """Native threaded batch decode of active items ``positions`` ->
        ((N, S, S, 3) u8, (N,) int32 labels); None on the Python path.
        ``out`` receives the images, item i at row ``rows[i]`` where given.
        A batch that fails natively switches the split to the Python path
        and is decoded there, in the same layout."""
        reader = self._native
        if reader is None:
            return None
        keys = self.imgidx[np.asarray(positions)]
        try:
            return reader.read_batch(keys, out, rows)
        except IOError as e:
            self._switch_to_python(reader, e)
        items = [self._read_python(int(k)) for k in keys]
        imgs = np.stack([img for img, _ in items])
        if out is None:
            out = imgs
        else:
            out[np.arange(len(keys)) if rows is None else rows] = imgs
        return out, np.array([label for _, label in items], dtype=np.int32)

    def all_labels(self) -> np.ndarray:
        """Labels of the active subset, from header-only reads of the full
        split (cached)."""
        if self._labels is None:
            n = self.meta.num_images
            if self._native is not None:
                self._labels = self._native.read_labels(np.arange(1, n + 1))
            else:
                labels = np.empty(n, dtype=np.int32)
                for key in range(1, n + 1):
                    labels[key - 1] = int(self.reader.read_header(key).scalar_label)
                self._labels = labels
        return self._labels[self.imgidx - 1]

    def subset(self, imgidx: np.ndarray) -> "FaceRecordDataset":
        """A shallow view over the same readers with a restricted key set."""
        view = object.__new__(FaceRecordDataset)
        view.reader = self.reader
        view.meta = self.meta
        view.imgidx = np.asarray(imgidx)
        view._labels = self._labels
        view._plane = self._plane
        return view


class CombinedDataset:
    """Local shard followed by public shard with shifted labels.

    Indices ``< len(local)`` map to the local split with labels
    0..C_local-1; the rest map to the public split with labels shifted by
    ``C_local`` (reference dataset.py:170-187).
    """

    def __init__(self, local: FaceRecordDataset, public: FaceRecordDataset):
        self.local = local
        self.public = public
        self.local_len = len(local)
        self.shift = int(local.num_classes or 0)
        self.num_classes = (local.num_classes or 0) + (public.num_classes or 0)
        if self.is_device_synthetic:
            assert (local.seed == public.seed
                    and local.image_size == public.image_size
                    and local.noise == public.noise
                    and local.block == public.block
                    and local.expr == public.expr
                    and local.shift_div == public.shift_div
                    and local.device == public.device), \
                "combined synthetic splits must share one universe"

    @property
    def is_device_synthetic(self) -> bool:
        return (getattr(self.local, "is_device_synthetic", False)
                and getattr(self.public, "is_device_synthetic", False))

    def __len__(self) -> int:
        return self.local_len + len(self.public)

    def read(self, pos: int) -> Tuple[np.ndarray, int]:
        if pos < self.local_len:
            return self.local.read(pos)
        img, label = self.public.read(pos - self.local_len)
        return img, label + self.shift

    @property
    def native(self) -> bool:
        """Whether the native reader decodes both parts (of one image size)."""
        return (getattr(self.local, "native", False) and getattr(self.public, "native", False)
                and self.local.image_size == self.public.image_size)

    @property
    def image_size(self) -> Optional[int]:
        return self.local.image_size if self.native else None

    def read_batch(self, positions: np.ndarray, out: Optional[np.ndarray] = None):
        """Each part's items through its native reader, straight into their
        rows of one batch, public labels shifted (JAX datasets.py:189-215);
        None unless both parts are native.  A part that fails natively, or
        that another view of its split switched to the Python path since
        the check, decodes its rows on the Python path and stays there."""
        s = self.image_size
        if s is None:
            return None
        positions = np.asarray(positions)
        n = len(positions)
        if out is None:
            out = np.empty((n, s, s, 3), dtype=np.uint8)
        labels = np.empty(n, dtype=np.int32)
        is_local = positions < self.local_len
        for sel, ds, off, shift in ((is_local, self.local, 0, 0),
                                    (~is_local, self.public, self.local_len, self.shift)):
            rows = np.flatnonzero(sel)
            if not len(rows):
                continue
            got = ds.read_batch(positions[rows] - off, out, rows)
            if got is None:
                items = [ds.read(int(p)) for p in positions[rows] - off]
                out[rows] = np.stack([img for img, _ in items])
                got = out, np.array([label for _, label in items], dtype=np.int32)
            labels[rows] = got[1] + shift
        return out, labels

    def device_batch(self, positions: np.ndarray):
        """A mixed local + public batch of two splits of one ``synth:``
        universe as ONE generator launch (JAX datasets.py:159-188) ->
        (u8 NHWC images on the device, host int32 labels)."""
        positions = np.asarray(positions)
        is_local = positions < self.local_len
        n = len(positions)
        keys, gids, bgids, dseeds = (np.empty(n, np.int32) for _ in range(4))
        bw = np.empty(n, np.float32)
        labels = np.empty(n, np.int32)
        for sel, ds, off, shift in ((is_local, self.local, 0, 0),
                                    (~is_local, self.public, self.local_len,
                                     self.shift)):
            if not sel.any():
                continue
            k, g, bg, w, dseed, lb = ds.synth_vectors(positions[sel] - off)
            keys[sel], gids[sel], bgids[sel], bw[sel], dseeds[sel] = k, g, bg, w, dseed
            labels[sel] = lb + shift
        return synth_device_batch(self.local, (keys, gids, bgids, bw, dseeds)), labels


class BatchLoader:
    """Seeded, epoch-based batch iterator with threaded host decode.

    Produces fixed-shape ``(B, H, W, C) uint8`` image batches and ``(B,)
    int32`` labels (NHWC, as the JAX package's loader yields them; the train
    step moves channels first on the device).  With ``drop_last=False`` the
    final partial batch is padded by repeating its first item and a validity
    mask is returned.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 seed: int = 100, drop_last: bool = False,
                 num_workers: int = 6, pin_memory: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.rng = np.random.default_rng(seed)
        self.num_workers = max(1, num_workers)
        # native batches decode straight into pinned memory (PyTorch's
        # caching host allocator), for a consumer that copies them to a card
        self.pin_memory = pin_memory
        self._pool: Optional[ThreadPoolExecutor] = None

    @property
    def pool(self) -> ThreadPoolExecutor:
        """Decode thread pool, created on first use."""
        if self._pool is None:
            self._pool = ThreadPoolExecutor(max_workers=self.num_workers)
        return self._pool

    def close(self) -> None:
        """Shut the decode pool down deterministically."""
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)
            self._pool = None

    def __enter__(self) -> "BatchLoader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _native_batch(self, idx: np.ndarray):
        """The native batch decode, or None where the split went on the
        Python path since the caller's check (another view switched it)."""
        if not self.pin_memory:
            return self.dataset.read_batch(idx)
        s = self.dataset.image_size
        if s is None:
            return None
        imgs = torch.empty((len(idx), s, s, 3), dtype=torch.uint8, pin_memory=True)
        got = self.dataset.read_batch(idx, imgs.numpy())
        return None if got is None else (imgs, got[1])

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def epoch(self, with_positions: bool = False):
        """Yield (images u8 NHWC, labels i32, valid bool) for one epoch.

        A ``synth:`` dataset yields its images as a tensor on its device
        (one generator launch a batch); a native record dataset as host
        numpy from one batch decode, or as a pinned CPU tensor under
        ``pin_memory``; a record dataset on the Python path as host numpy
        from the decode pool; the plane is asked a batch, so a split that
        switches to the Python path mid-epoch goes on there.
        ``with_positions`` appends the batch's
        dataset positions (int32; pad slots repeat the first position, as
        the images do), which the cached-contrastive step gathers its
        frozen features by.
        """
        n = len(self.dataset)
        order = self.rng.permutation(n) if self.shuffle else np.arange(n)
        bs = self.batch_size
        synthetic = getattr(self.dataset, "is_device_synthetic", False)
        for b in range(len(self)):
            idx = order[b * bs: (b + 1) * bs]
            valid = np.ones(bs, dtype=bool)
            if len(idx) < bs:
                valid[len(idx):] = False
                idx = np.concatenate([idx, np.full(bs - len(idx), idx[0])])
            pos = (idx.astype(np.int32),) if with_positions else ()
            if synthetic:
                imgs, labels = self.dataset.device_batch(idx)
                yield (imgs, labels, valid) + pos
                continue
            got = self._native_batch(idx) if getattr(self.dataset, "native", False) else None
            if got is not None:
                yield got + (valid,) + pos
                continue
            items = list(self.pool.map(self.dataset.read, idx))
            imgs = np.stack([it[0] for it in items])
            labels = np.array([it[1] for it in items], dtype=np.int32)
            yield (imgs, labels, valid) + pos


class AllClientData:
    """All client shards + the public train split (reference
    dataset.py:73-142).

    A ``cfg.data.rec_root`` of the form ``synth:key=value,...`` builds the
    device-generated universe of ``data/synthetic.py`` on
    ``cfg.runtime.device`` instead of reading rec files.  The CLI's flags
    fill in the spec keys the string leaves at their defaults (``clients``,
    ``ids_per_client`` from ``num_ids``, ``image_size``, ``seed``); a key
    the spec sets that contradicts its flag raises ``ValueError``, as in the
    JAX package, since a silent override would build another universe than
    an earlier run given the same string.
    """

    def __init__(self, cfg, include_public: bool = True):
        self.cfg = cfg
        self.synthetic_universe = None
        self.public_dataset = None
        if is_synth_spec(cfg.data.rec_root):
            spec = parse_synth_spec(cfg.data.rec_root)
            explicit = explicit_synth_keys(cfg.data.rec_root)
            overrides = {"clients": cfg.data.num_clients,
                         "image_size": cfg.data.image_size,
                         "seed": cfg.runtime.seed}
            if cfg.data.num_ids:
                overrides["ids_per_client"] = max(
                    1, cfg.data.num_ids // cfg.data.num_clients)
            for k, v in overrides.items():
                if k in explicit and spec[k] != v:
                    raise ValueError(
                        f"synth spec sets {k}={spec[k]} but the CLI config "
                        f"implies {k}={v}; drop one of the two")
                spec[k] = v
            self.synthetic_universe = build_fl_synthetic(spec, cfg.runtime.device)
            self.client_datasets = self.synthetic_universe["clients"]
            if include_public:
                self.public_dataset = self.synthetic_universe["public"]
        else:
            native = cfg.data.use_native_loader
            self.client_datasets = [
                FaceRecordDataset(os.path.join(cfg.data.split_dir, "client_%04d" % c),
                                  use_native=native)
                for c in range(cfg.data.num_clients)]
            if include_public:
                self.public_dataset = FaceRecordDataset(cfg.data.public_dir,
                                                        use_native=native)
        self.train_class_sizes = [int(d.num_classes or 0)
                                  for d in self.client_datasets]

    def client(self, cid: int):
        return self.client_datasets[cid]

    def veri_dataset(self, veri_dir: str):
        """The local-verification split: the universe's veri split under a
        ``synth:`` root, else the ``test`` rec at ``veri_dir``
        (``local_veri_4000``, labelled with global identity IDs)."""
        if self.synthetic_universe is not None:
            return self.synthetic_universe["veri"]
        return FaceRecordDataset(veri_dir, prefix="test",
                                 use_native=self.cfg.data.use_native_loader)
