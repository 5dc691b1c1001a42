from .blocks import (
    BN_EPS,
    GN_EPS,
    BatchNorm,
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
    no_stat_updates,
    reset_parameters,
)
from .deform import DeformConvBlock
from . import prepared

__all__ = [
    "BN_EPS", "GN_EPS", "BatchNorm", "Conv2d", "ConvNormAct",
    "ConvTranspose2d", "DeformConvBlock", "FrozenBatchNorm", "GroupNorm", "Linear", "Scale", "SpatialAttention",
    "eSEModule", "get_norm", "hsigmoid", "max_pool2d_ceil",
    "no_stat_updates", "prepared", "reset_parameters",
]
