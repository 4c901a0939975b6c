"""Learning-rate schedule (counterpart of ``fedfr_tpu/utils/optim.py``).

The JAX package's pure SGD transform is written to match
torch.optim.SGD(momentum, weight_decay, dampening=0, nesterov=False), the
reference's only optimizer (client.py:335), so the port uses
``torch.optim.SGD`` itself (``federated/trainer.py``).
"""

from __future__ import annotations


def step_lr(base_lr: float, epoch_in_run: int, step_size: int, gamma: float = 0.1) -> float:
    """StepLR within one local run (fresh each round, reference client.py:348)."""
    return base_lr * (gamma ** (epoch_in_run // step_size))
