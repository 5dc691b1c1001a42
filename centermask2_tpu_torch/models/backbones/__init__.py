from .fpn import FPN, upsample_nearest_2x
from .vovnet import FEATURE_STRIDES, STAGE_SPECS, OSAModule, VoVNet, feature_channels

__all__ = ["FPN", "upsample_nearest_2x", "FEATURE_STRIDES", "STAGE_SPECS",
           "OSAModule", "VoVNet", "feature_channels"]
