"""mobilenet_tpu — a MobileNet-V1 inference framework in JAX.

A ground-up rebuild of the capabilities of
anerisheth19/CNN-MobileNet-V1-implementation-on-AWS-FPGA-using-OpenCL
(see SURVEY.md for the component-by-component mapping), for NVIDIA GPUs:
  - all 28 layers as one jitted XLA program (no per-layer host dispatch)
  - depthwise 3x3 as XLA grouped convs, pointwise 1x1 as matmuls with fused
    BatchNorm+ReLU epilogues; a fused dw+pw Pallas kernel (Triton route) for
    the large-image V1 blocks on the GPU
  - INT8 fixed-point path with per-layer requantization
  - batch-256 throughput mode and 64-stream micro-batching server
  - C++ `cpu_ref` golden oracle with a NumPy twin for per-layer verification
"""

from .config import ALPHAS, RESOLUTIONS, ModelConfig
from .models import mobilenet_v1

__version__ = "0.1.0"

__all__ = ["ModelConfig", "ALPHAS", "RESOLUTIONS", "mobilenet_v1"]
