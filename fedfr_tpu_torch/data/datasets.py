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
  (reference dataset.py:73-142), and the local verification split.

Decoding runs on a host thread pool; augmentation (random hflip) and
normalization run on the device inside the train step, so the host only moves
uint8 bytes.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Tuple

import numpy as np

from . import codec
from .recordio import IndexedRecordReader, SplitMeta, read_split_meta


class FaceRecordDataset:
    """A single indexed rec split: images keyed 1..N with integer labels."""

    def __init__(self, root_dir: str, prefix: str = "train"):
        idx_path = os.path.join(root_dir, f"{prefix}.idx")
        rec_path = os.path.join(root_dir, f"{prefix}.rec")
        self.reader = IndexedRecordReader(idx_path, rec_path)
        self.meta: SplitMeta = read_split_meta(self.reader)
        # active record keys; hard-negative mining installs a subset
        self.imgidx: np.ndarray = np.arange(1, self.meta.num_images + 1)
        self._labels: Optional[np.ndarray] = None

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
        header, payload = self.reader.read_idx(int(self.imgidx[pos]))
        return codec.decode(payload), int(header.scalar_label)

    def all_labels(self) -> np.ndarray:
        """Labels of the active subset, from header-only reads of the full
        split (cached)."""
        if self._labels is None:
            n = self.meta.num_images
            labels = np.empty(n, dtype=np.int32)
            for key in range(1, n + 1):
                labels[key - 1] = int(self.reader.read_header(key).scalar_label)
            self._labels = labels
        return self._labels[self.imgidx - 1]

    def subset(self, imgidx: np.ndarray) -> "FaceRecordDataset":
        """A shallow view over the same reader with a restricted key set."""
        view = object.__new__(FaceRecordDataset)
        view.reader = self.reader
        view.meta = self.meta
        view.imgidx = np.asarray(imgidx)
        view._labels = self._labels
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

    def __len__(self) -> int:
        return self.local_len + len(self.public)

    def read(self, pos: int) -> Tuple[np.ndarray, int]:
        if pos < self.local_len:
            return self.local.read(pos)
        img, label = self.public.read(pos - self.local_len)
        return img, label + self.shift


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
                 num_workers: int = 6):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.rng = np.random.default_rng(seed)
        self.num_workers = max(1, num_workers)
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

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def epoch(self, with_positions: bool = False):
        """Yield (images u8 NHWC, labels i32, valid bool) for one epoch.

        ``with_positions`` appends the batch's dataset positions (int32; pad
        slots repeat the first position, as the images do), which the
        cached-contrastive step gathers its frozen features by.
        """
        n = len(self.dataset)
        order = self.rng.permutation(n) if self.shuffle else np.arange(n)
        bs = self.batch_size
        for b in range(len(self)):
            idx = order[b * bs: (b + 1) * bs]
            valid = np.ones(bs, dtype=bool)
            if len(idx) < bs:
                valid[len(idx):] = False
                idx = np.concatenate([idx, np.full(bs - len(idx), idx[0])])
            items = list(self.pool.map(self.dataset.read, idx))
            imgs = np.stack([it[0] for it in items])
            labels = np.array([it[1] for it in items], dtype=np.int32)
            yield (imgs, labels, valid) + ((idx.astype(np.int32),) if with_positions else ())


class AllClientData:
    """All client shards + the public train split (reference dataset.py:73-142).

    Rec roots only: the JAX package's ``synth:`` device-generated universes
    are not ported.
    """

    def __init__(self, cfg):
        if cfg.data.rec_root.startswith("synth:"):
            raise NotImplementedError(
                "synth: roots are not ported to the PyTorch package yet "
                "(ROADMAP queue A); write a rec split instead")
        self.cfg = cfg
        self.client_datasets: List[FaceRecordDataset] = [
            FaceRecordDataset(os.path.join(cfg.data.split_dir, "client_%04d" % c))
            for c in range(cfg.data.num_clients)]
        self.public_dataset = FaceRecordDataset(cfg.data.public_dir)
        self.train_class_sizes = [int(d.num_classes or 0)
                                  for d in self.client_datasets]

    def client(self, cid: int) -> FaceRecordDataset:
        return self.client_datasets[cid]

    def veri_dataset(self, veri_dir: str) -> FaceRecordDataset:
        """The local-verification split (``local_veri_4000``): the ``test``
        rec at ``veri_dir``, labelled with global identity IDs."""
        return FaceRecordDataset(veri_dir, prefix="test")
