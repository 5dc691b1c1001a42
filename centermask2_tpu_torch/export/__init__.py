from .aot import (compile_inference, export_serialized, inference_flops,
                  load_serialized)
from .captured import CapturedInference, CudaGraphs, supports_graphs

__all__ = ["compile_inference", "export_serialized",
           "inference_flops", "load_serialized", "CapturedInference",
           "CudaGraphs", "supports_graphs"]
