"""centermask2_tpu_torch: the PyTorch/CUDA port of centermask2_tpu.

CenterMask single-image inference (V-39-eSE and the other standard VoVNet
bodies) on an NVIDIA GPU, with the JAX package's two TPU kernels
rewritten by hand in CUDA C++ for Hopper (``csrc/``). The JAX package
``centermask2_tpu`` is the reference this package is held against; this
package imports nothing of it.
"""

from .config import CfgNode, get_cfg
from .models.meta import CenterMask, InferenceOutputs, build_centermask

__all__ = ["CfgNode", "get_cfg", "CenterMask", "InferenceOutputs",
           "build_centermask"]
