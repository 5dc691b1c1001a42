from . import rle
from .cityscapes_eval import (CityscapesInstanceEvaluator,
                              CityscapesSemSegEvaluator)
from .coco_eval import COCOEval, COCOEvaluator, COCOGt

__all__ = ["rle", "COCOEval", "COCOEvaluator", "COCOGt",
           "CityscapesInstanceEvaluator", "CityscapesSemSegEvaluator"]
