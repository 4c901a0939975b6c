"""fedfr_tpu_torch — the PyTorch/CUDA port of ``fedfr_tpu`` for NVIDIA Hopper.

It imports torch and numpy, never jax, and nothing of ``fedfr_tpu``.  Its
entry points (the training CLI ``python -m fedfr_tpu_torch.train``, the
post-training eval CLI ``python -m fedfr_tpu_torch.local_all``, the
pretraining CLI ``python -m fedfr_tpu_torch.pretrain``, the IJB-C CLIs
``python -m fedfr_tpu_torch.ijbc_all`` / ``ijbc_conti``, ``Server``,
``Client``, ``embed_dataset``, the eval callbacks and the kernel wrappers)
run on ``cuda`` unless the caller asks for ``cpu``.

Layout (each module beside its ``fedfr_tpu`` counterpart):
    config.py   FedFRConfig (+ runtime.device)
    data/       RecordIO codec, datasets, pinned host->device prefetch
    models/     sphnet, iresnet, toy, cosine/BCE heads, the BottleBlock
                converter (reference state_dict keys)
    ops/        margins, losses, k-fold math, the mining and ROC-histogram
                kernel wrappers, the per-client ROC
    csrc/       hand-written CUDA kernels (built at first use)
    federated/  train step, embedding/mining, Client, Server
    evalsuite/  .bin verification, per-client 1:1 eval, open-set math,
                IJB-C (meta readers, host and device engines, alignment)
    parallel/   FedAvg over state_dicts, FC averaging, the Partial FC
    utils/      device selection, SGD/StepLR, logging, weights files
                (.pth and the JAX package's .npz), the source snapshot
    interop.py  JAX-package variables (numpy trees) -> the port's state_dicts
    train.py    the training CLI (train.py's flags, .pth exports)
    local_all.py  the post-training personalized 1:1 and 1:n eval CLI
    local_1n.py   the open-set 1:n helper ``evaluation``
    pretrain.py   public-set pretraining with the Partial FC (pretrain.py's flags)
    ijbc_all.py   the IJB-C 1:1 / 1:n eval CLI; ijbc_conti.py over several epochs
"""

__version__ = "0.1.0"
