"""Model-FLOP counting, the port's counterpart of ``fedfr_tpu/utils/flops.py``.

``count_flops(fn, *args)`` runs ``fn(*args)`` once under
``torch.utils.flop_counter.FlopCounterMode`` and sums the FLOPs of the
convolutions (forward and backward) and matrix products only, at 2 FLOPs
per multiply-accumulate, as the JAX package's jaxpr walk counts
``conv_general_dilated`` and ``dot_general``; elementwise work is left out
(<1% for these models).  It runs the call for real, so give it small
inputs on the CPU or the call's own inputs on the card.  The benchmark's
MFU divides this count by a step's time and the card's peak.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

_aten = torch.ops.aten
COUNTED = {_aten.convolution, _aten._convolution, _aten.convolution_backward,
           _aten.mm, _aten.addmm, _aten.bmm, _aten.baddbmm}


def count_flops(fn, *args, **kwargs) -> float:
    """Total conv + matmul FLOPs of one call of ``fn(*args, **kwargs)``."""
    mode = FlopCounterMode(display=False)
    with mode:
        fn(*args, **kwargs)
    counts = mode.get_flop_counts().get("Global", {})
    return float(sum(n for op, n in counts.items()
                     if getattr(op, "overloadpacket", op) in COUNTED))
