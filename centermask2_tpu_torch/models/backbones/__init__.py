from .fpn import FPN, TOP_BLOCKS, upsample_nearest_2x
from .mobilenet import (MOBILENET_FEATURE_CHANNELS, InvertedResidual,
                        MobileNetV2)
from .resnet import (RESNET_FEATURE_STRIDES, RESNET_STAGE_BLOCKS,
                     BottleneckBlock, ResNet, resnet_feature_channels)
from .vovnet import (FEATURE_STRIDES, STAGE_SPECS, DWConvBlock, OSAModule,
                     VoVNet, feature_channels)

__all__ = ["FPN", "TOP_BLOCKS", "upsample_nearest_2x",
           "MOBILENET_FEATURE_CHANNELS", "InvertedResidual", "MobileNetV2",
           "RESNET_FEATURE_STRIDES", "RESNET_STAGE_BLOCKS", "BottleneckBlock",
           "ResNet", "resnet_feature_channels", "FEATURE_STRIDES",
           "STAGE_SPECS", "DWConvBlock", "OSAModule", "VoVNet",
           "feature_channels"]
