"""The check that a run loaded neither JAX nor the JAX package.

Names are compared by their whole top-level part (before the first dot):
``fedfr_tpu_torch`` is the measured port, ``fedfr_tpu`` the JAX package."""

from __future__ import annotations

import sys
from typing import Iterable, List, Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "fedfr_tpu")


def forbidden_loaded(modules: Optional[Iterable[str]] = None) -> List[str]:
    """The forbidden top-level names among ``modules`` (default: the
    process's ``sys.modules``), sorted."""
    names = sys.modules.keys() if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & set(FORBIDDEN))
