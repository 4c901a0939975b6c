"""Experiment provenance: copy the running source tree into the output dir.

The port's counterpart of ``fedfr_tpu/utils/snapshot.py`` (the reference's
copytree of its own code into ``output_dir/code``, train.py:50-51), so that
every run records the code that produced it.
"""

from __future__ import annotations

import os
import shutil

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def snapshot_source(output_dir: str) -> str:
    """Copy the repository root's ``*.py`` files and the ``fedfr_tpu_torch``
    and ``split_dataset`` packages to ``output_dir/code``, without caches,
    compiled objects or build directories.  An existing snapshot is
    replaced.  Returns the snapshot's path."""
    dest = os.path.join(output_dir, "code")
    if os.path.exists(dest):
        shutil.rmtree(dest)
    os.makedirs(dest)
    for entry in sorted(os.listdir(REPO_ROOT)):
        if entry.endswith(".py"):
            shutil.copy2(os.path.join(REPO_ROOT, entry), os.path.join(dest, entry))
    for pkg in ("fedfr_tpu_torch", "split_dataset"):
        src = os.path.join(REPO_ROOT, pkg)
        if os.path.isdir(src):
            shutil.copytree(src, os.path.join(dest, pkg),
                            ignore=shutil.ignore_patterns(
                                "__pycache__", "*.pyc", "*.so", "*.o", "build"))
    return dest
