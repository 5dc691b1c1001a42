from .meta import CenterMask, InferenceOutputs, build_centermask

__all__ = ["CenterMask", "InferenceOutputs", "build_centermask"]
