from .head import FCOSHead, Tower
from .outputs import (
    DecodedProposals,
    compute_locations,
    decode_batch,
    decode_single_image,
)

__all__ = ["FCOSHead", "Tower", "DecodedProposals", "compute_locations",
           "decode_batch", "decode_single_image"]
