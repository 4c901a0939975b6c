"""Pure-Python MXNet-compatible indexed RecordIO codec.

The reference framework stores every dataset (client train splits, the public
pretrain set, local verification/gallery sets) as MXNet indexed RecordIO pairs
(``train.rec``/``train.idx``) and reads them through ``mx.recordio``
(reference: dataset.py:190-226, split_dataset/split_FL.py:109-126).  This
module re-implements the on-disk format from scratch so the rebuild has zero
mxnet dependency while staying byte-compatible with recs produced by the
reference tooling.

Format (little is documented upstream; layout below is the de-facto wire
format):

``.rec``: a sequence of records, each::

    uint32 magic   = 0xced7230a
    uint32 lrecord = (cflag << 29) | length      # cflag: continuation flag
    byte   data[length]
    byte   pad[(-length) % 4]                    # pad to 4-byte boundary

``.idx``: ASCII lines ``"<key>\t<byte offset of record start>"``.

Each data payload produced by ``pack()`` starts with an IRHeader::

    struct IRHeader { uint32 flag; float label; uint64 id; uint64 id2; }

packed with ``struct('IfQQ')``.  If ``flag > 0`` the scalar ``label`` field is
unused and a float32 array of ``flag`` labels immediately follows the struct.
Record 0 of a split rec is a metadata header whose label array is
``[num_images + 1, num_classes(, id_base)]`` (reference dataset.py:199-207).
"""

from __future__ import annotations

import os
import struct
import numbers
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

_MAGIC = 0xCED7230A
_IR_FORMAT = "IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)
_LEN_MASK = (1 << 29) - 1


@dataclass
class IRHeader:
    """Mirror of mxnet's record header (flag, label, id, id2)."""

    flag: int
    label: Union[float, np.ndarray]
    id: int
    id2: int

    @property
    def scalar_label(self) -> float:
        if isinstance(self.label, numbers.Number):
            return float(self.label)
        return float(np.asarray(self.label).reshape(-1)[0])


def pack(header: IRHeader, data: bytes) -> bytes:
    """Serialize a header + payload into one record body (pre-framing)."""
    label = header.label
    if isinstance(label, numbers.Number):
        hdr = struct.pack(_IR_FORMAT, header.flag, float(label), header.id, header.id2)
        return hdr + data
    label_arr = np.asarray(label, dtype=np.float32).reshape(-1)
    hdr = struct.pack(_IR_FORMAT, len(label_arr), 0.0, header.id, header.id2)
    return hdr + label_arr.tobytes() + data


def unpack(record: bytes) -> Tuple[IRHeader, bytes]:
    """Parse a record body into (IRHeader, payload bytes)."""
    flag, label, rid, rid2 = struct.unpack(_IR_FORMAT, record[:_IR_SIZE])
    body = record[_IR_SIZE:]
    if flag > 0:
        labels = np.frombuffer(body[: flag * 4], dtype=np.float32)
        body = body[flag * 4:]
        return IRHeader(flag, labels, rid, rid2), body
    return IRHeader(flag, label, rid, rid2), body


def _frame(body: bytes) -> bytes:
    n = len(body)
    if n > _LEN_MASK:
        # the wire format stores length in 29 bits (mxnet splits larger
        # payloads into continuation records, which this writer does not
        # emit) — fail loudly instead of writing a corrupt frame
        raise ValueError(f"record body {n} bytes exceeds the 29-bit frame "
                         f"limit ({_LEN_MASK} bytes)")
    pad = (-n) % 4
    return struct.pack("<II", _MAGIC, n) + body + b"\x00" * pad


class IndexedRecordWriter:
    """Writes ``.rec``/``.idx`` pairs compatible with mxnet's indexed reader."""

    def __init__(self, idx_path: str, rec_path: str):
        self._rec = open(rec_path, "wb")
        self._idx = open(idx_path, "w")
        self._offset = 0

    def write_idx(self, key: int, body: bytes) -> None:
        framed = _frame(body)
        self._idx.write(f"{key}\t{self._offset}\n")
        self._rec.write(framed)
        self._offset += len(framed)

    def close(self) -> None:
        self._rec.close()
        self._idx.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class IndexedRecordReader:
    """Random-access reader over a ``.rec``/``.idx`` pair.

    Thread-safe for concurrent ``read_idx`` via pread-style offsets; holds the
    file open with a single descriptor.
    """

    def __init__(self, idx_path: str, rec_path: str):
        self.rec_path = rec_path
        self._fd = os.open(rec_path, os.O_RDONLY)
        self._offsets: Dict[int, int] = {}
        with open(idx_path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                key_s, off_s = line.split("\t")
                self._offsets[int(key_s)] = int(off_s)

    @property
    def keys(self) -> List[int]:
        return list(self._offsets.keys())

    def read_record(self, key: int) -> bytes:
        off = self._offsets[key]
        head = os.pread(self._fd, 8, off)
        magic, lrec = struct.unpack("<II", head)
        if magic != _MAGIC:
            raise IOError(f"bad record magic {magic:#x} at offset {off}")
        if lrec >> 29:  # multi-part continuation record (cflag != 0)
            raise IOError(
                f"record at offset {off} uses mxnet continuation framing "
                f"(cflag {lrec >> 29}), which this reader does not support")
        length = lrec & _LEN_MASK
        return os.pread(self._fd, length, off + 8)

    def read_idx(self, key: int) -> Tuple[IRHeader, bytes]:
        return unpack(self.read_record(key))

    def read_header(self, key: int) -> IRHeader:
        """Header-only read: preads the 8-byte frame + IRHeader (+ label
        array when flag > 0) instead of the whole record — a label scan
        over a multi-GB rec touches ~36 bytes/record instead of the full
        JPEG payloads."""
        off = self._offsets[key]
        head = os.pread(self._fd, 8 + _IR_SIZE, off)
        magic, lrec = struct.unpack("<II", head[:8])
        if magic != _MAGIC:
            raise IOError(f"bad record magic {magic:#x} at offset {off}")
        flag, label, rid, rid2 = struct.unpack(_IR_FORMAT, head[8:])
        if flag > 0:
            body = os.pread(self._fd, flag * 4, off + 8 + _IR_SIZE)
            return IRHeader(flag, np.frombuffer(body, dtype=np.float32),
                            rid, rid2)
        return IRHeader(flag, label, rid, rid2)

    def close(self) -> None:
        if self._fd >= 0:
            os.close(self._fd)
            self._fd = -1

    def __del__(self):  # pragma: no cover - GC path
        try:
            self.close()
        except Exception:
            # interpreter teardown may have unloaded os.close already
            pass


@dataclass
class SplitMeta:
    """Metadata of a split rec (record-0 header, reference dataset.py:199-207)."""

    num_images: int
    num_classes: Optional[int]
    id_base: Optional[int]


def read_split_meta(reader: IndexedRecordReader) -> SplitMeta:
    header, _ = reader.read_idx(0)
    if header.flag <= 0:
        raise ValueError("rec file has no split header record (flag==0)")
    vals = [int(v) for v in np.asarray(header.label).reshape(-1)]
    num_images = vals[0] - 1  # header stores num_images + 1
    num_classes = vals[1] if len(vals) > 1 else None
    id_base = vals[2] if len(vals) > 2 else None
    return SplitMeta(num_images, num_classes, id_base)


def write_split(
    idx_path: str,
    rec_path: str,
    payloads: Sequence[bytes],
    labels: Sequence[float],
    num_classes: int,
    id_base: Optional[int] = None,
) -> None:
    """Write a full split rec: data records keyed 1..N plus header record 0.

    Mirrors the layout produced by the reference's offline split generators
    (split_dataset/split_FL.py:109-126,183).
    """
    assert len(payloads) == len(labels)
    with IndexedRecordWriter(idx_path, rec_path) as w:
        key = 1
        for payload, label in zip(payloads, labels):
            w.write_idx(key, pack(IRHeader(0, float(label), key, 0), payload))
            key += 1
        meta: List[float] = [float(key), float(num_classes)]
        if id_base is not None:
            meta.append(float(id_base))
        w.write_idx(0, pack(IRHeader(len(meta), np.asarray(meta), 0, 0), b""))
