"""Logging setup (the port's copy of ``init_logging`` from
``fedfr_tpu/utils/logging.py``; reference utils/utils_logging.py:30-43)."""

from __future__ import annotations

import logging
import os
import sys


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
