from . import rle
from .coco_eval import COCOEval, COCOEvaluator, COCOGt

__all__ = ["rle", "COCOEval", "COCOEvaluator", "COCOGt"]
