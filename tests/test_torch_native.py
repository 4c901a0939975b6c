"""The port's native reader (``fedfr_tpu_torch/native``) on the CPU.

* its JPEG decoder against two references, byte for byte: the port's
  ``codec.decode`` (cv2, libjpeg-turbo) and the JAX package's
  libjpeg-linked ``NativeReader`` (that half skips where the JAX package's
  library does not build), over cv2 payloads at three qualities, every
  sampling it reads, restart intervals, progressive and optimized coding,
  PIL payloads, grayscale, four sizes, flat and saturated images, and FRAW;
  a bounded ``hypothesis`` property over size, quality, sampling, restart
  interval and progressive against cv2;
* labels (scalar and array) against the Python header reads, 1 and 8
  threads alike, and an ``IOError`` naming the key for an unsupported frame,
  a truncated payload, a wrong image size, a continuation record and an
  unknown key;
* the build: g++ alone (no ``-ljpeg``), no libjpeg mapped by a process that
  loads only the port's library, a failed build raises;
* the datasets on it: the native ``BatchLoader`` epoch against the Python
  path's and the JAX package's, ``CombinedDataset.read_batch``, a
  ``subset`` view, a PNG split on the Python path with its log line, a
  split whose later record the reader rejects going on with cv2 (one
  warning, one counted switch), a record neither plane decodes that
  raises, a toy round of the training CLI over a JPEG
  root with the plane on and off (``test_torch_native_card.py`` holds the
  card's half: a native batch in pinned memory).
"""

import io
import logging
import os
import struct
import subprocess
import sys
import tempfile
import zlib

import cv2
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

import chip_smoke
from fedfr_tpu.data.datasets import BatchLoader as JaxBatchLoader
from fedfr_tpu.data.datasets import FaceRecordDataset as JaxFaceRecordDataset
from fedfr_tpu.native import NativeReader as JaxNativeReader
from fedfr_tpu.native import load_library as jax_load_library
from fedfr_tpu_torch import local_all as local_all_cli
from fedfr_tpu_torch import native
from fedfr_tpu_torch import pretrain as pretrain_cli
from fedfr_tpu_torch import train as train_cli
from fedfr_tpu_torch.data import codec, write_split
from fedfr_tpu_torch.data.datasets import BatchLoader, CombinedDataset, FaceRecordDataset
from fedfr_tpu_torch.data.recordio import (IndexedRecordReader, IndexedRecordWriter,
                                           IRHeader, pack)

import torch_threads  # noqa: F401  (each xdist worker's share of the cores)

HAVE_JAX_NATIVE = jax_load_library() is not None
SAMPLING = {"420": 0x221111, "422": 0x211111, "444": 0x111111, "440": 0x121111}


def _image(rng, size, kind="smooth"):
    if kind == "flat":
        return np.full((size, size, 3), rng.integers(0, 256, 3), np.uint8)
    if kind == "saturated":  # black and white blocks: the IDCT's range limit
        return (rng.integers(0, 2, (size, size, 3)) * 255).astype(np.uint8)
    y, x = np.mgrid[:size, :size]
    base = np.stack([(x * 7 + y * 3) % 256, (x * y) % 256, (255 - x * 5) % 256], -1)
    return np.clip(base + rng.normal(0, 20, base.shape), 0, 255).astype(np.uint8)


def _cv2(img, quality=95, sampling="420", restart=0, progressive=False, optimize=False):
    params = [cv2.IMWRITE_JPEG_QUALITY, quality]
    if img.ndim == 3:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]]
        img = img[..., ::-1]
    if restart:
        params += [cv2.IMWRITE_JPEG_RST_INTERVAL, restart]
    if progressive:
        params += [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]
    if optimize:
        params += [cv2.IMWRITE_JPEG_OPTIMIZE, 1]
    ok, buf = cv2.imencode(".jpg", img, params)
    assert ok
    return buf.tobytes()


def _pil(img, **kw):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", **kw)
    return buf.getvalue()


def _write(d, payloads, labels=None, prefix="train"):
    os.makedirs(d, exist_ok=True)
    labels = list(range(len(payloads))) if labels is None else labels
    write_split(os.path.join(d, f"{prefix}.idx"), os.path.join(d, f"{prefix}.rec"),
                payloads, labels, num_classes=max(labels) + 1)
    return os.path.join(d, f"{prefix}.idx"), os.path.join(d, f"{prefix}.rec")


def _reader(d, size, threads=4, prefix="train"):
    return native.NativeReader(os.path.join(d, f"{prefix}.idx"),
                               os.path.join(d, f"{prefix}.rec"), size, threads=threads)


# name -> (size, payload maker over an rng)
CASES = {
    "cv2_q95_420": (112, lambda r: _cv2(_image(r, 112), 95)),
    "cv2_q75_420": (112, lambda r: _cv2(_image(r, 112), 75)),
    "cv2_q50_420": (112, lambda r: _cv2(_image(r, 112), 50)),
    "cv2_444": (112, lambda r: _cv2(_image(r, 112), 90, "444")),
    "cv2_422": (112, lambda r: _cv2(_image(r, 112), 90, "422")),
    "cv2_440": (112, lambda r: _cv2(_image(r, 112), 90, "440")),
    "cv2_restart": (112, lambda r: _cv2(_image(r, 112), 90, restart=3)),
    "cv2_progressive": (112, lambda r: _cv2(_image(r, 112), 90, progressive=True)),
    "cv2_progressive_restart_422": (40, lambda r: _cv2(_image(r, 40), 80, "422", restart=2,
                                                       progressive=True)),
    "cv2_optimize": (112, lambda r: _cv2(_image(r, 112), 90, optimize=True)),
    "pil_420": (112, lambda r: _pil(_image(r, 112), quality=95)),
    "pil_444": (112, lambda r: _pil(_image(r, 112), quality=85, subsampling=0)),
    "pil_progressive": (112, lambda r: _pil(_image(r, 112), quality=80, progressive=True)),
    "gray": (112, lambda r: _cv2(_image(r, 112)[..., 0], 90)),
    "gray_progressive": (40, lambda r: _cv2(_image(r, 40)[..., 1], 90, progressive=True)),
    "size_40": (40, lambda r: _cv2(_image(r, 40), 95)),
    "size_20": (20, lambda r: _cv2(_image(r, 20), 95)),
    "size_16": (16, lambda r: _cv2(_image(r, 16), 95)),
    "size_17_422": (17, lambda r: _cv2(_image(r, 17), 95, "422")),
    "flat": (112, lambda r: _cv2(_image(r, 112, "flat"), 95)),
    "saturated_q95": (112, lambda r: _cv2(_image(r, 112, "saturated"), 95)),
    "saturated_q10": (40, lambda r: _cv2(_image(r, 40, "saturated"), 10, "444")),
    "fraw": (112, lambda r: codec.encode_raw(_image(r, 112))),
}


@pytest.mark.parametrize("name", list(CASES))
def test_native_decode_equals_cv2_and_jax_native(name, tmp_path):
    size, make = CASES[name]
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    payloads = [make(rng) for _ in range(6)]
    idx, rec = _write(str(tmp_path), payloads)
    keys = np.arange(1, 7)
    got, labels = _reader(str(tmp_path), size).read_batch(keys)
    np.testing.assert_array_equal(labels, np.arange(6))
    for i, p in enumerate(payloads):
        np.testing.assert_array_equal(got[i], codec.decode(p), err_msg=f"{name} image {i}")
    if HAVE_JAX_NATIVE:
        ref, _ = JaxNativeReader(idx, rec, image_size=size).read_batch(keys)
        np.testing.assert_array_equal(got, ref)


@settings(max_examples=40, deadline=None, database=None)
@given(size=st.integers(1, 72), quality=st.integers(1, 100),
       sampling=st.sampled_from(sorted(SAMPLING)), restart=st.integers(0, 5),
       progressive=st.booleans(), seed=st.integers(0, 2**16))
def test_native_decode_property_against_cv2(size, quality, sampling, restart, progressive,
                                            seed):
    rng = np.random.default_rng(seed)
    payload = _cv2(_image(rng, size, ("smooth", "saturated")[seed % 2]), quality, sampling,
                   restart, progressive)
    with tempfile.TemporaryDirectory() as d:
        _write(d, [payload])
        got, _ = _reader(d, size).read_batch([1])
    np.testing.assert_array_equal(got[0], codec.decode(payload))


def test_labels_equal_the_python_header_reads(tmp_path):
    """Scalar labels and array labels (flag > 0: the first float) read
    natively, alone and with the images, equal the port's Python reads."""
    d = str(tmp_path)
    img = codec.encode_raw(np.zeros((8, 8, 3), np.uint8))
    idx, rec = os.path.join(d, "train.idx"), os.path.join(d, "train.rec")
    with IndexedRecordWriter(idx, rec) as w:
        w.write_idx(1, pack(IRHeader(0, 7.0, 1, 0), img))
        w.write_idx(2, pack(IRHeader(0, 3.9, 2, 0), img))
        w.write_idx(3, pack(IRHeader(2, np.array([12.0, 5.0]), 3, 0), img))
        w.write_idx(4, pack(IRHeader(1, np.array([-2.5]), 4, 0), img))
    reader = IndexedRecordReader(idx, rec)
    want = [int(reader.read_header(k).scalar_label) for k in (1, 2, 3, 4)]
    assert want == [7, 3, 12, -2]
    r = native.NativeReader(idx, rec, 8)
    assert r.num_keys() == 4
    assert r.read_labels([1, 2, 3, 4]).tolist() == want
    assert r.read_batch([4, 3, 2, 1])[1].tolist() == want[::-1]


def test_one_and_eight_threads_give_the_same_bytes(tmp_path):
    rng = np.random.default_rng(3)
    payloads = [_cv2(_image(rng, 40), 90, ("420", "444")[i % 2], progressive=i % 3 == 0)
                for i in range(64)]
    _write(str(tmp_path), payloads)
    keys = np.random.default_rng(4).permutation(64) + 1
    one = _reader(str(tmp_path), 40, threads=1).read_batch(keys)
    eight = _reader(str(tmp_path), 40, threads=8).read_batch(keys)
    np.testing.assert_array_equal(one[0], eight[0])
    np.testing.assert_array_equal(one[1], eight[1])


def _sof_patched(payload, offset, value):
    """The payload with one byte of its SOF0 segment replaced (offset 0: the
    marker's code)."""
    at = payload.index(b"\xff\xc0") + 1
    b = bytearray(payload)
    b[at + offset] = value
    return bytes(b)


@pytest.mark.parametrize("name,reason", [
    ("arithmetic", "arithmetic coding"),
    ("lossless", "lossless frame"),
    ("12bit", "12-bit samples"),
    ("cmyk", "4 components"),
    ("sampling_411", "sampling factors"),
    ("truncated", "ends early"),
    ("no_eoi", "before its EOI"),
    ("png", "a PNG payload"),
    ("wrong_size", "the reader expects 16x16"),
])
def test_rejected_payloads_raise_naming_the_key(name, reason, tmp_path):
    rng = np.random.default_rng(5)
    good = _cv2(_image(rng, 16), 90)
    bad = {
        "arithmetic": lambda: _sof_patched(good, 0, 0xC9),
        "lossless": lambda: _sof_patched(good, 0, 0xC3),
        "12bit": lambda: _sof_patched(good, 3, 12),
        "cmyk": lambda: _cmyk_payload(),
        "sampling_411": lambda: cv2.imencode(
            ".jpg", _image(rng, 16), [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, 0x411111])[1].tobytes(),
        "truncated": lambda: good[:(good.index(b"\xff\xda") + len(good)) // 2],
        "no_eoi": lambda: good[:-2],
        "png": lambda: cv2.imencode(".png", _image(rng, 16))[1].tobytes(),
        "wrong_size": lambda: _cv2(_image(rng, 24), 90),
    }[name]()
    _write(str(tmp_path), [good, good, bad])
    r = _reader(str(tmp_path), 16)
    r.read_batch([1, 2])
    with pytest.raises(IOError, match=f"key 3: cannot decode: .*{reason}"):
        r.read_batch([1, 3, 2])
    if name == "wrong_size":  # the probe learns the size
        assert r.probe(3) == (24, 24)
    else:
        with pytest.raises(IOError, match=f"key 3: .*{reason}"):
            r.probe(3)


def _cmyk_payload():
    buf = io.BytesIO()
    Image.new("CMYK", (16, 16), (10, 20, 30, 40)).save(buf, format="JPEG")
    return buf.getvalue()


def test_continuation_record_and_unknown_key_raise(tmp_path):
    d = str(tmp_path)
    idx, rec = os.path.join(d, "train.idx"), os.path.join(d, "train.rec")
    body = pack(IRHeader(0, 1.0, 1, 0), codec.encode_raw(np.zeros((4, 4, 3), np.uint8)))
    with open(rec, "wb") as f:
        f.write(struct.pack("<II", 0xCED7230A, (1 << 29) | len(body)) + body)
    with open(idx, "w") as f:
        f.write("5\t0\n")
    r = native.NativeReader(idx, rec, 4)
    with pytest.raises(IOError, match="key 5: .*continuation record"):
        r.read_batch([5])
    with pytest.raises(IOError, match="key 5: .*continuation record"):
        r.read_labels([5])
    with pytest.raises(IOError, match="key 6: .*no such key"):
        r.read_batch([6])


def test_build_links_no_libjpeg():
    cmd = native.build_command(native.library_path())
    assert cmd[:5] == ["g++", "-O3", "-std=c++17", "-shared", "-fPIC"]
    assert cmd[-1] == "-lpthread" and not any("jpeg" in a for a in cmd)
    path = native.build_library()
    assert path.parent.parts[-2:] == ("build", "native") and path.name.startswith("recio-")
    maps = subprocess.run(
        [sys.executable, "-c", "import ctypes, sys; ctypes.CDLL(sys.argv[1]); "
         "print(open('/proc/self/maps').read())", str(path)],
        capture_output=True, text=True, check=True).stdout
    assert str(path) in maps and "libjpeg" not in maps


def test_failed_build_raises_with_the_compiler_error(tmp_path, monkeypatch):
    bad = tmp_path / "recio.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed for recio.cpp.*error"):
        native.build_library()
    rng = np.random.default_rng(0)
    _write(str(tmp_path / "split"), [codec.encode_raw(_image(rng, 8))])
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        FaceRecordDataset(str(tmp_path / "split"))  # no silent Python path
    assert not list((tmp_path / "build").glob("*.so"))


# ---------------------------------------------------------------- datasets

@pytest.fixture(scope="module")
def jpeg_split(tmp_path_factory):
    rng = np.random.default_rng(8)
    d = str(tmp_path_factory.mktemp("jpeg_split"))
    payloads = [_cv2(_image(rng, 24), 90, ("420", "422", "444")[i % 3]) for i in range(45)]
    labels = [i // 5 for i in range(45)]
    os.makedirs(d, exist_ok=True)
    write_split(os.path.join(d, "train.idx"), os.path.join(d, "train.rec"), payloads,
                labels, num_classes=9, id_base=0)
    return d


@pytest.mark.parametrize("with_positions", [False, True])
def test_native_loader_epoch_equals_python_path_and_jax(jpeg_split, with_positions):
    ds = FaceRecordDataset(jpeg_split)
    py = FaceRecordDataset(jpeg_split, use_native=False)
    assert ds.native and not py.native and ds.image_size == 24
    jax_ds = JaxFaceRecordDataset(jpeg_split)
    epochs = []
    for loader in (BatchLoader(ds, 8, seed=3, num_workers=2),
                   BatchLoader(py, 8, seed=3, num_workers=2),
                   JaxBatchLoader(jax_ds, 8, seed=3, num_workers=2)):
        with loader:
            epochs.append([list(b) for e in range(2)
                           for b in loader.epoch(with_positions=with_positions)])
    before = dict(native.counters)
    assert len(epochs[0]) == 2 * 6
    for other in epochs[1:]:
        assert len(other) == len(epochs[0])
        for a, b in zip(epochs[0], other):
            assert len(a) == len(b) == 3 + with_positions
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
                assert x.dtype == y.dtype
    assert before["batches"] >= 12
    np.testing.assert_array_equal(ds.all_labels(), py.all_labels())


def test_combined_read_batch_shifts_labels_and_subset_keeps_the_reader(jpeg_split,
                                                                      tmp_path):
    rng = np.random.default_rng(9)
    _write(str(tmp_path), [_cv2(_image(rng, 24), 85) for _ in range(12)],
           [i // 3 for i in range(12)])
    public = FaceRecordDataset(jpeg_split)
    view = public.subset(np.array([40, 3, 17, 9, 22]))
    assert view.native and view._native is public._native
    local = FaceRecordDataset(str(tmp_path))
    combined = CombinedDataset(local, view)
    assert combined.native and combined.shift == 4
    positions = np.array([0, 13, 12, 5, 16, 14, 11])
    imgs, labels = combined.read_batch(positions)
    py = CombinedDataset(FaceRecordDataset(str(tmp_path), use_native=False),
                         FaceRecordDataset(jpeg_split, use_native=False).subset(
                             np.array([40, 3, 17, 9, 22])))
    for i, p in enumerate(positions):
        img, label = py.read(int(p))
        np.testing.assert_array_equal(imgs[i], img)
        assert labels[i] == label
    # local labels i // 3; public keys 40, 3, 17, 9, 22 hold labels 7, 0, 3,
    # 1, 4, shifted by the 4 local classes
    assert labels.tolist() == [0, 4 + 0, 4 + 7, 1, 4 + 4, 4 + 3, 3]


def test_png_split_opens_on_the_python_path_with_its_log_line(tmp_path, caplog):
    rng = np.random.default_rng(10)
    _write(str(tmp_path), [cv2.imencode(".png", _image(rng, 12))[1].tobytes()
                           for _ in range(4)])
    with caplog.at_level(logging.INFO, logger="fedfr_tpu_torch.data"):
        ds = FaceRecordDataset(str(tmp_path))
    assert not ds.native and ds.read_batch([0, 1]) is None
    assert "read on the Python path" in caplog.text and "a PNG payload" in caplog.text
    with BatchLoader(ds, 4, shuffle=False, num_workers=2) as loader:
        imgs, labels, valid = next(loader.epoch())
    assert imgs.shape == (4, 12, 12, 3) and valid.all()


def test_a_native_split_raises_on_a_later_bad_record(tmp_path):
    """A later record that neither plane decodes still raises, as in the
    JAX package: the split switches to the Python path (one count), and
    cv2's decode of the batch raises there."""
    rng = np.random.default_rng(11)
    good = [_cv2(_image(rng, 16), 90) for _ in range(5)]
    _write(str(tmp_path), good + [good[0][:100]])
    ds = FaceRecordDataset(str(tmp_path))
    assert ds.native
    native.zero_counters()
    with BatchLoader(ds, 3, shuffle=False) as loader:
        batches = loader.epoch()
        next(batches)
        with pytest.raises(ValueError, match="cv2 failed to decode"):
            next(batches)
    assert not ds.native and native.counters["switches"] == 1


def _cut_entropy(payload):
    """``payload`` with its entropy-coded data cut to half, then its EOI:
    libjpeg decodes it with a warning, the native reader rejects it."""
    sos = payload.index(b"\xff\xda")
    return payload[:sos + (len(payload) - sos) // 2] + b"\xff\xd9"


@pytest.mark.parametrize("combined", [False, True], ids=["split", "combined"])
@pytest.mark.parametrize("bad", ["cmyk", "entropy_cut_short"])
def test_a_later_record_the_reader_rejects_is_read_by_cv2(tmp_path, caplog, monkeypatch,
                                                          bad, combined):
    """A split whose first records decode natively and whose 6th the native
    reader rejects (a CMYK JPEG; entropy data cut short), read as the JAX
    package reads it (datasets.py:62-72): two epochs give cv2's bytes for
    every record, the batch that failed included, the split (and its
    subset views) stays on the Python path, with one warning naming the
    key and the reason and one switch counted.  ``combined``: the split is
    the public part of a ``CombinedDataset``, whose native batch decodes
    the failing part's rows again on the Python path."""
    monkeypatch.setattr(logging.getLogger("fedfr_tpu_torch"), "propagate", True)
    rng = np.random.default_rng(12)
    good = [_cv2(_image(rng, 16), 90) for _ in range(8)]
    payload = _cmyk_payload() if bad == "cmyk" else _cut_entropy(good[5])
    d = str(tmp_path / "public")
    _write(d, good[:5] + [payload] + good[5:], [i // 3 for i in range(9)])
    ds, py = FaceRecordDataset(d), FaceRecordDataset(d, use_native=False)
    view = ds.subset(np.arange(1, 10))
    assert ds.native and view.native and not py.native
    if combined:
        _write(str(tmp_path / "local"), good[:4], [0, 0, 1, 1])
        ds = CombinedDataset(FaceRecordDataset(str(tmp_path / "local")), ds)
        py = CombinedDataset(FaceRecordDataset(str(tmp_path / "local"), use_native=False), py)
        assert ds.native
    native.zero_counters()
    epochs = []
    with caplog.at_level(logging.WARNING, logger="fedfr_tpu_torch.data"):
        for dataset in (ds, py):
            with BatchLoader(dataset, 4, shuffle=False, num_workers=2) as loader:
                epochs.append([b for e in range(2) for b in loader.epoch()])
    assert len(epochs[0]) == len(epochs[1]) == 2 * (4 if combined else 3)
    for a, b in zip(*epochs):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    warned = [r for r in caplog.records if r.levelno == logging.WARNING]
    assert len(warned) == 1 and native.counters["switches"] == 1
    assert "key 6: cannot decode" in warned[0].getMessage()
    assert ("4 components" if bad == "cmyk" else "ends early") in warned[0].getMessage()
    assert "Python path" in warned[0].getMessage()
    assert not view.native and view.read_batch([0]) is None


@pytest.mark.parametrize("reader", ["loader", "combined"])
def test_a_split_switched_since_the_check_is_read_on_the_python_path(tmp_path, reader):
    """A split that another view (a prefetch thread's, say) switches to the
    Python path between a batch's check of the plane and its read: the
    ``BatchLoader``'s batch, or a ``CombinedDataset`` part's rows, decoded
    by cv2, the labels as on the native path."""
    rng = np.random.default_rng(13)
    good = [_cv2(_image(rng, 16), 90) for _ in range(6)]
    _write(str(tmp_path / "local"), good[:4], [0, 0, 1, 1])
    _write(str(tmp_path / "public"), good, [0, 0, 1, 1, 2, 2])
    parts = [FaceRecordDataset(str(tmp_path / d)) for d in ("local", "public")]
    py = [FaceRecordDataset(str(tmp_path / d), use_native=False) for d in ("local", "public")]
    read_batch = parts[1].read_batch

    def switched(*a, **kw):
        parts[1]._plane[0] = None  # what another view's switch leaves
        return read_batch(*a, **kw)

    parts[1].read_batch = switched
    if reader == "loader":
        assert parts[1].native
        with BatchLoader(parts[1], 4, shuffle=False, num_workers=2) as loader:
            got = [b[:2] for b in loader.epoch()]
        with BatchLoader(py[1], 4, shuffle=False, num_workers=2) as loader:
            want = [b[:2] for b in loader.epoch()]
        for (gi, gl), (wi, wl) in zip(got, want, strict=True):
            np.testing.assert_array_equal(gi, wi)
            assert gl.tolist() == wl.tolist()
    else:
        ds, py_ds = CombinedDataset(*parts), CombinedDataset(*py)
        assert ds.native
        positions = np.array([5, 0, 9, 3, 4])
        imgs, labels = ds.read_batch(positions)
        want = [py_ds.read(int(p)) for p in positions]
        np.testing.assert_array_equal(imgs, np.stack([img for img, _ in want]))
        assert labels.tolist() == [label for _, label in want]
        assert parts[0].native
    assert not parts[1].native


@pytest.fixture(scope="module")
def jpeg_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("jpeg_root"))
    chip_smoke.write_fl_split(root, 2, 3, imgs_per_id=8, pub_ids=6, pub_imgs=5, size=16,
                              seed=0, veri_imgs=6, encode=chip_smoke.jpeg_encoder())
    chip_smoke.write_bin(os.path.join(root, "val", "agedb_30.bin"), n_pairs=20, size=16,
                         seed=1)
    return root


@pytest.fixture(scope="module")
def jpeg_rounds(jpeg_root, tmp_path_factory):
    """One toy round of the training CLI over the JPEG root on each plane:
    plane -> (output dir, history, the native counters after it)."""
    out = tmp_path_factory.mktemp("jpeg_rounds")
    runs = {}
    for plane in ("native", "python"):
        argv = chip_smoke.round_args(jpeg_root, 2, 3, device="cpu", network="toy",
                                     embedding=16, image_size=16, batch=8, local_epochs=1,
                                     rounds=1, eval_batch=16, out_name=plane)
        argv[argv.index("--output_dir") + 1] = str(out / plane)
        argv += ["--num_workers", "2", "--lr", "0.01"]
        if plane == "python":
            argv.append("--no_native_loader")
        native.zero_counters()
        torch.manual_seed(0)  # the toy net's initial weights
        history = train_cli.main(train_cli.build_parser().parse_args(argv))
        runs[plane] = (str(out / plane), history, dict(native.counters))
    return runs


def test_toy_round_over_a_jpeg_root_is_the_same_on_both_planes(jpeg_rounds):
    _, a, counted = jpeg_rounds["native"]
    _, b, none = jpeg_rounds["python"]
    # the public embed, the mined subset's training, the local eval
    assert counted["batches"] > 0 and counted["images"] >= 30 + 2 * 24
    assert counted["entropy_s"] > 0 and counted["reconstruct_s"] > 0
    assert none["batches"] == 0
    assert [h["avg_loss"] for h in a] == [h["avg_loss"] for h in b]
    assert [h["acc"] for h in a] == [h["acc"] for h in b]


def test_local_all_and_pretrain_are_the_same_on_both_planes(jpeg_rounds, jpeg_root,
                                                            tmp_path):
    """``--no_native_loader`` of the eval and pretraining CLIs: the same
    results on the Python path, with no native batch."""
    ckpt = jpeg_rounds["native"][0]
    got = {}
    for flag in ([], ["--no_native_loader"]):
        native.zero_counters()
        res = local_all_cli.main(local_all_cli.build_parser().parse_args([
            "--backbone", "multi", "--task", "1:1", "--ckpt_path", ckpt,
            "--data_dir", os.path.join(jpeg_root, "local_veri_6"), "--num_client", "2",
            "--num_ids", "6", "--network", "toy", "--embedding_size", "16",
            "--batch_size", "16", "--device", "cpu", *flag]))
        torch.manual_seed(0)
        pre = pretrain_cli.main(pretrain_cli.build_parser().parse_args([
            "--data_dir", os.path.join(jpeg_root, "split_pretrain_6000", "client_0000"),
            "--output_dir", str(tmp_path / f"pre{len(flag)}"), "--network", "toy",
            "--embedding_size", "16", "--image_size", "16", "--batch_size", "8",
            "--num_epoch", "1", "--log_every", "1", "--num_workers", "2", "--device", "cpu",
            *flag]))
        got[bool(flag)] = (res, pre["losses"], native.counters["batches"])
    (res_n, loss_n, batches_n), (res_p, loss_p, batches_p) = got[False], got[True]
    assert batches_n > 0 and batches_p == 0
    np.testing.assert_array_equal(res_n["mean"], res_p["mean"])
    assert loss_n == loss_p and len(loss_n) > 0
