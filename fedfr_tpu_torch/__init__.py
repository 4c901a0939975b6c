"""fedfr_tpu_torch — the PyTorch/CUDA port of ``fedfr_tpu`` for NVIDIA Hopper.

It imports torch and numpy, never jax, and nothing of ``fedfr_tpu``.  Its
entry points (``Server``, ``Client``, ``embed_dataset`` and the kernel
wrappers) run on ``cuda`` unless the caller asks for ``cpu``.

Layout (each module beside its ``fedfr_tpu`` counterpart):
    config.py   FedFRConfig (+ runtime.device)
    data/       RecordIO codec, datasets, pinned host->device prefetch
    models/     sphnet, toy, cosine/BCE heads (reference state_dict keys)
    ops/        margins, losses, the hard-negative mining kernel wrapper
    csrc/       hand-written CUDA kernels (built at first use)
    federated/  train step, embedding/mining, Client, Server
    parallel/   FedAvg over state_dicts, FC averaging
    utils/      device selection, SGD/StepLR
    interop.py  JAX-package variables (numpy trees) -> the port's state_dicts
"""

__version__ = "0.1.0"
