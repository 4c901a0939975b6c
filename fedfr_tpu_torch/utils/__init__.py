from .device import resolve_device
from .optim import step_lr

__all__ = ["resolve_device", "step_lr"]
