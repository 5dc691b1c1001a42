from .head import FCOSHead, Tower
from .losses import (
    assign_targets_single_image,
    compute_ctrness_targets,
    fcos_losses,
    level_metadata,
)
from .outputs import (
    DecodedProposals,
    compute_locations,
    decode_batch,
    decode_single_image,
)

__all__ = ["FCOSHead", "Tower", "DecodedProposals", "compute_locations",
           "decode_batch", "decode_single_image",
           "assign_targets_single_image", "compute_ctrness_targets",
           "fcos_losses", "level_metadata"]
