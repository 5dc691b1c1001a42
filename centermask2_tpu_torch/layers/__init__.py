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

__all__ = [
    "GN_EPS", "Conv2d", "ConvNormAct", "ConvTranspose2d",
    "FrozenBatchNorm", "GroupNorm", "Linear", "Scale", "SpatialAttention",
    "eSEModule", "get_norm", "hsigmoid", "max_pool2d_ceil",
    "reset_parameters",
]
