"""Model configuration for the MobileNet-V1 stack.

The reference (anerisheth19/CNN-MobileNet-V1-implementation-on-AWS-FPGA-using-
OpenCL) hard-codes layer shapes as compile-time constants because HLS bitstreams
require static shapes (SURVEY.md SS5 "Config / flag system"). The JAX
equivalent is a frozen dataclass: each (alpha, resolution, batch, dtype) tuple is
one jit cache entry, mirroring one FPGA bitstream.

Layer table citations: SURVEY.md SS2 "The model itself (the 28 layers)" -- verified
against keras applications/mobilenet.py:192-217 and haiku nets/mobilenetv1.py:106-108.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

# The 13 depthwise-separable blocks: (stride, pointwise out_channels at alpha=1.0).
# 28 layers total = 1 standard conv + 13 dw + 13 pw + 1 FC (BASELINE.json:5).
BLOCK_DEFS: Tuple[Tuple[int, int], ...] = (
    (1, 64),
    (2, 128),
    (1, 128),
    (2, 256),
    (1, 256),
    (2, 512),
    (1, 512),
    (1, 512),
    (1, 512),
    (1, 512),
    (1, 512),
    (2, 1024),
    (1, 1024),
)

STEM_CHANNELS = 32  # first 3x3 conv, stride 2 (mobilenet.py:192)

# The sweep the reference benchmarks (BASELINE.json:8).
ALPHAS = (0.25, 0.5, 0.75, 1.0)
RESOLUTIONS = (128, 160, 192, 224)


def scaled_channels(base: int, alpha: float) -> int:
    """Width-multiplier channel scaling, matching keras int(filters * alpha)
    (mobilenet.py:319,383)."""
    return int(base * alpha)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Static description of one MobileNet-V1 variant.

    Frozen + hashable so it can be a jit static argument. One instance is the
    analog of one compiled FPGA bitstream (SURVEY.md SS5).
    """

    alpha: float = 1.0
    resolution: int = 224
    num_classes: int = 1000
    relu6: bool = True  # TF-slim checkpoints use ReLU6 (SURVEY.md SS2)
    bn_eps: float = 1e-3  # keras mobilenet BN epsilon
    compute_dtype: str = "float32"  # "float32" | "bfloat16"

    def __post_init__(self):
        if self.alpha not in ALPHAS:
            raise ValueError(f"alpha must be one of {ALPHAS}, got {self.alpha}")
        if self.resolution % 32 != 0:
            raise ValueError(f"resolution must be divisible by 32, got {self.resolution}")

    @property
    def stem_channels(self) -> int:
        return scaled_channels(STEM_CHANNELS, self.alpha)

    @property
    def block_channels(self) -> Tuple[int, ...]:
        """Pointwise output channels per block after alpha scaling."""
        return tuple(scaled_channels(c, self.alpha) for _, c in BLOCK_DEFS)

    @property
    def block_strides(self) -> Tuple[int, ...]:
        return tuple(s for s, _ in BLOCK_DEFS)

    @property
    def feature_channels(self) -> int:
        """Channels entering the classifier head (1024 at alpha=1)."""
        return self.block_channels[-1]

    @property
    def final_spatial(self) -> int:
        """Spatial size before global average pool (7 for 224)."""
        return self.resolution // 32

    def layer_shapes(self):
        """Yield (name, kind, in_ch, out_ch, stride, in_hw) for all conv layers.

        kind is one of {"conv", "dw", "pw"}. Useful for the golden harness and
        the cpu_ref oracle (SURVEY.md SS3.6).
        """
        hw = self.resolution // 2
        yield ("conv1", "conv", 3, self.stem_channels, 2, self.resolution)
        c_in = self.stem_channels
        for i, ((stride, _), c_out) in enumerate(zip(BLOCK_DEFS, self.block_channels)):
            yield (f"block{i:02d}_dw", "dw", c_in, c_in, stride, hw)
            if stride == 2:
                hw //= 2
            yield (f"block{i:02d}_pw", "pw", c_in, c_out, 1, hw)
            c_in = c_out

    def variant_name(self) -> str:
        return f"mobilenet_v1_{self.alpha:g}_{self.resolution}"


# Preprocessing for TF-family weights: scale to [-1, 1] (mobilenet.py:418-422,
# mode='tf'); BASELINE.json:5 calls this "mean/scale normalization".
PREPROCESS_SCALE = 1.0 / 127.5
PREPROCESS_OFFSET = -1.0
