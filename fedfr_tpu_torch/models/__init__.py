from .bottle import BottleBlock
from .factory import ToyNet, build_backbone
from .heads import BCEModule, LinearConverter, cosine_logits, l2_normalize
from .iresnet import IBasicBlock, IResNet
from .layers import PReLU
from .sphnet import SphNet, SphereBlock

__all__ = [
    "build_backbone",
    "BCEModule",
    "BottleBlock",
    "IBasicBlock",
    "IResNet",
    "LinearConverter",
    "cosine_logits",
    "l2_normalize",
    "PReLU",
    "SphNet",
    "SphereBlock",
    "ToyNet",
]
