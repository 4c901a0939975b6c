"""Logging setup and throughput meters (the port's copy of
``fedfr_tpu/utils/logging.py``: ``init_logging``, ``AverageMeter`` and
``ThroughputLogger``, with the same log texts; reference
utils/utils_logging.py, utils/utils_callbacks.py:70-112)."""

from __future__ import annotations

import logging
import os
import sys
import time


class AverageMeter:
    """Running average (reference utils_logging.py:6-27)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0
        self.avg = 0.0

    def update(self, val: float, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


def init_logging(output_dir: str, name: str = "fedfr_tpu_torch",
                 log_name: str = "training.log") -> logging.Logger:
    """stdout (INFO) + ``<output_dir>/training.log`` (DEBUG), both in the
    reference's ``Training: <time>-<message>`` format.  The file is appended
    to, and a second call in one process re-points it."""
    root = logging.getLogger(name)
    root.setLevel(logging.DEBUG)
    root.propagate = False
    fmt = logging.Formatter("Training: %(asctime)s-%(message)s")
    for h in list(root.handlers):
        if isinstance(h, logging.FileHandler):
            root.removeHandler(h)
            h.close()
    if not any(isinstance(h, logging.StreamHandler)
               and not isinstance(h, logging.FileHandler)
               for h in root.handlers):
        hs = logging.StreamHandler(sys.stdout)
        hs.setLevel(logging.INFO)
        hs.setFormatter(fmt)
        root.addHandler(hs)
    os.makedirs(output_dir, exist_ok=True)
    hf = logging.FileHandler(os.path.join(output_dir, log_name), mode="a")
    hf.setLevel(logging.DEBUG)
    hf.setFormatter(fmt)
    root.addHandler(hf)
    return root


class ThroughputLogger:
    """samples/sec + ETA logging (reference CallBackLogging,
    utils_callbacks.py:70-112): every ``frequent`` global steps after the
    first such step, one ``Speed ... samples/sec   Loss ...`` line, then the
    meter is reset."""

    def __init__(self, frequent: int, total_step: int, batch_size: int,
                 logger: logging.Logger):
        self.frequent = frequent
        self.total_step = max(total_step, 1)
        self.batch_size = batch_size
        self.logger = logger
        self.time_start = time.time()
        self.tic = 0.0
        self.init = False

    def __call__(self, global_step: int, loss: AverageMeter, epoch: int):
        if global_step > 0 and global_step % self.frequent == 0:
            if self.init:
                elapsed = max(time.time() - self.tic, 1e-9)
                speed = self.frequent * self.batch_size / elapsed
                time_now = (time.time() - self.time_start) / 3600
                time_total = time_now / ((global_step + 1) / self.total_step)
                eta = time_total - time_now
                self.logger.info(
                    "Speed %.2f samples/sec   Loss %.4f   Epoch: %d   "
                    "Global Step: %d   Required: %1.f hours",
                    speed, loss.avg, epoch, global_step, eta)
                loss.reset()
                self.tic = time.time()
            else:
                self.init = True
                self.tic = time.time()
