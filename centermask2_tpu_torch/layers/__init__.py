from .blocks import (
    GN_EPS,
    Conv2d,
    ConvNormAct,
    ConvTranspose2d,
    FrozenBatchNorm,
    GroupNorm,
    Linear,
    Scale,
    SpatialAttention,
    eSEModule,
    get_norm,
    hsigmoid,
    max_pool2d_ceil,
    reset_parameters,
)
from .deform import DeformConvBlock

__all__ = [
    "GN_EPS", "Conv2d", "ConvNormAct", "ConvTranspose2d", "DeformConvBlock",
    "FrozenBatchNorm", "GroupNorm", "Linear", "Scale", "SpatialAttention",
    "eSEModule", "get_norm", "hsigmoid", "max_pool2d_ceil",
    "reset_parameters",
]
