"""Each pytest-xdist worker's share of the cores for torch's intra-op pool.

The port's test files (``tests/test_torch_*.py``) import this module.  Under
xdist every worker's torch would otherwise keep its default of one thread
per core: six workers ran 48 threads on 8 cores, and sphnet20's many small
convs took one phase of ``test_torch_convergence.py`` 594 s against 47 s on
one thread.  Outside xdist torch keeps its default.  XLA's pool is left
alone: its flags are read when the backend starts, and the JAX package's
reference numbers come from it.
"""

import os

import torch

_WORKERS = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
if _WORKERS:
    torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // int(_WORKERS)))
