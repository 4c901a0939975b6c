"""The port's native data plane: ctypes bindings of ``native/recio.cpp``.

The counterpart of ``fedfr_tpu/native``: an mmap'd rec, its idx table, and
a batch decode on C++ threads straight into an NHWC uint8 buffer.  The
library carries its own JPEG decoder (byte for byte libjpeg's default
decode), so it needs g++ and nothing else: no libjpeg, cv2 or PIL.

It is built at first use with ``g++ -O3 -std=c++17 -shared -fPIC
-lpthread`` into ``build/native/recio-<hash of source and flags>.so`` at the
repository root, one compile at a time across processes (an exclusive file
lock; the result is moved into place by an atomic rename).  A failed build
raises with g++'s stderr; there is no fallback.

``counters`` count what the plane did (batches and images decoded, the
seconds of each decode stage summed over the threads, and the splits that
switched to the Python path after a later record failed, ``switches``), so
that a run can show which plane read its data; ``zero_counters`` sets them
to 0.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

SRC = Path(__file__).resolve().parent / "recio.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
GXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]
LIBS = ["-lpthread"]
REASON_BYTES = 512

counters: Dict[str, float] = {"batches": 0, "images": 0, "entropy_s": 0.0,
                              "reconstruct_s": 0.0, "switches": 0}
build_seconds: Optional[float] = None
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def zero_counters() -> None:
    with _lock:
        counters.update(batches=0, images=0, entropy_s=0.0, reconstruct_s=0.0, switches=0)


def count_switch() -> None:
    """Count one split that went on on the Python path."""
    with _lock:
        counters["switches"] += 1


def build_command(out: Path) -> list:
    return ["g++", *GXX_FLAGS, str(SRC), "-o", str(out), *LIBS]


def library_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes()
                            + " ".join(GXX_FLAGS + LIBS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"recio-{digest}.so"


def build_library() -> Path:
    """Build the library where it is not built yet; returns its path."""
    global build_seconds
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "recio.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # one compile at a time
        if out.exists():  # another process built it while this one waited
            return out
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(build_command(tmp), capture_output=True, text=True)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed for {SRC.name} (exit {proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
        build_seconds = time.perf_counter() - t0
    return out


def load_library() -> ctypes.CDLL:
    """The loaded library, built at first use."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build_library()))
        c_long_p = ctypes.POINTER(ctypes.c_long)
        c_int_p = ctypes.POINTER(ctypes.c_int)
        lib.recio_open.restype = ctypes.c_void_p
        lib.recio_open.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
        lib.recio_close.restype = None
        lib.recio_close.argtypes = [ctypes.c_void_p]
        lib.recio_num_keys.restype = ctypes.c_long
        lib.recio_num_keys.argtypes = [ctypes.c_void_p]
        lib.recio_read_labels.restype = ctypes.c_int
        lib.recio_read_labels.argtypes = [ctypes.c_void_p, c_long_p, ctypes.c_long, c_int_p]
        lib.recio_batch_decode.restype = ctypes.c_int
        lib.recio_batch_decode.argtypes = [
            ctypes.c_void_p, c_long_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, c_int_p, ctypes.c_int, c_long_p, ctypes.POINTER(ctypes.c_longlong)]
        lib.recio_probe.restype = ctypes.c_int
        lib.recio_probe.argtypes = [ctypes.c_void_p, ctypes.c_long, c_int_p, c_int_p]
        lib.recio_last_error.restype = ctypes.c_int
        lib.recio_last_error.argtypes = [c_long_p, ctypes.c_char_p, ctypes.c_int]
        _lib = lib
        return lib


def _raise_last(lib: ctypes.CDLL, rec_path: str, what: str):
    key = ctypes.c_long(0)
    reason = ctypes.create_string_buffer(REASON_BYTES)
    lib.recio_last_error(ctypes.byref(key), reason, REASON_BYTES)
    raise IOError(f"{rec_path} key {key.value}: {what}: {reason.value.decode()}")


def _keys(keys) -> np.ndarray:
    return np.ascontiguousarray(keys, dtype=np.int64)


class NativeReader:
    """Batch-decoding reader over one rec/idx pair (images of
    ``image_size`` x ``image_size``, decoded on ``threads`` C++ threads; the
    call releases the GIL)."""

    def __init__(self, idx_path: str, rec_path: str, image_size: int = 112,
                 threads: int = 8):
        self.lib = load_library()
        self.rec_path = rec_path
        self.handle = self.lib.recio_open(idx_path.encode(), rec_path.encode())
        if not self.handle:
            raise IOError(f"cannot open {rec_path} with its index {idx_path}")
        self.image_size = image_size
        self.threads = max(1, int(threads))

    def close(self) -> None:
        if getattr(self, "handle", None):
            self.lib.recio_close(self.handle)
            self.handle = None

    def __del__(self):  # pragma: no cover - GC path
        try:
            self.close()
        except Exception:
            pass

    def num_keys(self) -> int:
        return int(self.lib.recio_num_keys(self.handle))

    def probe(self, key: int) -> Tuple[int, int]:
        """Decode record ``key`` once -> its (height, width); raises IOError
        with the reason where the reader cannot read it."""
        h, w = ctypes.c_int(0), ctypes.c_int(0)
        if self.lib.recio_probe(self.handle, int(key), ctypes.byref(h), ctypes.byref(w)):
            _raise_last(self.lib, self.rec_path, "cannot decode")
        return h.value, w.value

    def read_labels(self, keys) -> np.ndarray:
        keys = _keys(keys)
        out = np.empty(len(keys), dtype=np.int32)
        if self.lib.recio_read_labels(
                self.handle, keys.ctypes.data_as(ctypes.POINTER(ctypes.c_long)), len(keys),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_int))):
            _raise_last(self.lib, self.rec_path, "cannot read the label")
        return out

    def read_batch(self, keys, out: Optional[np.ndarray] = None,
                   rows: Optional[np.ndarray] = None):
        """keys (N,) record ids -> ((N, S, S, 3) uint8 images, (N,) int32
        labels).  ``out``, where given, is a C-contiguous (M, S, S, 3) uint8
        array (pinned memory, say) that receives image i at row ``rows[i]``
        (row i where ``rows`` is None; then M = N), and is returned."""
        keys = _keys(keys)
        n, s = len(keys), self.image_size
        if out is None:
            out = np.empty((n, s, s, 3), dtype=np.uint8)
        if (out.dtype != np.uint8 or out.shape[1:] != (s, s, 3)
                or not out.flags.c_contiguous):
            raise ValueError(f"out must be a C-contiguous uint8 array of images "
                             f"{(s, s, 3)}, not {out.dtype} {out.shape}")
        row_ptr = None
        if rows is not None:
            rows = _keys(rows)
            if len(rows) != n or (n and (rows.min() < 0 or rows.max() >= len(out))):
                raise ValueError(f"rows must give {n} rows of out's {len(out)}")
            row_ptr = rows.ctypes.data_as(ctypes.POINTER(ctypes.c_long))
        elif len(out) != n:
            raise ValueError(f"out holds {len(out)} images, the batch {n}")
        labels = np.empty(n, dtype=np.int32)
        stage_ns = (ctypes.c_longlong * 2)()
        if self.lib.recio_batch_decode(
                self.handle, keys.ctypes.data_as(ctypes.POINTER(ctypes.c_long)), n,
                out.ctypes.data, s, s, labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
                self.threads, row_ptr, stage_ns):
            _raise_last(self.lib, self.rec_path, "cannot decode")
        with _lock:
            counters["batches"] += 1
            counters["images"] += n
            counters["entropy_s"] += stage_ns[0] * 1e-9
            counters["reconstruct_s"] += stage_ns[1] * 1e-9
        return out, labels
