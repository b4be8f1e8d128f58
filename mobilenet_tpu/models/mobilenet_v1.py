"""MobileNet-V1 forward pass: all 28 layers as ONE jittable JAX program.

This replaces the reference's per-layer host dispatch loop (SURVEY.md SS3.1:
28 clEnqueueNDRangeKernel round-trips) with a single compiled XLA program —
"All 28 layers execute as one compiled program with no host round-trips
between layers" (BASELINE.json:5).

Layer schedule citation: SURVEY.md SS2 layer table (keras mobilenet.py:192-227,
haiku mobilenetv1.py:106-155).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp

from .. import platform
from ..config import ModelConfig
from ..ops import conv as ops


def forward(
    params: Dict[str, Any],
    x: jax.Array,
    config: ModelConfig,
    *,
    collect: bool = False,
) -> Any:
    """Run the 28-layer network on a folded-BN params pytree.

    Args:
      params: folded pytree from checkpoints.io.fold_bn (w/b per conv layer).
      x: (N, H, W, 3) preprocessed images, NHWC, in [-1, 1].
      config: static model config (jit static arg).
      collect: also return every post-activation tensor, keyed by layer name —
        the per-layer oracle tap (reference analog: per-layer clEnqueueReadBuffer
        in verify mode, SURVEY.md SS3.2).

    Returns:
      logits (N, num_classes), or (logits, {layer_name: activation}) if collect.
    """
    acts: Dict[str, jax.Array] = {}
    relu6 = config.relu6

    y = ops.conv2d_same(x, params["conv1"]["w"], 2, bias=params["conv1"]["b"], relu6=relu6)
    if collect:
        acts["conv1"] = y
    y = _run_blocks(params, y, config, relu6, acts if collect else None)
    pooled = ops.global_avg_pool(y)
    if collect:
        acts["pool"] = pooled
    logits = ops.fc(pooled, params["fc"]["w"], params["fc"]["b"])
    if collect:
        acts["logits"] = logits
        return logits, acts
    return logits


def separable_block(blk, y, stride: int, relu6: bool) -> jax.Array:
    """One dw3x3 -> pw1x1 block: the fused Hopper kernel where the platform
    module says it serves (ops/block_triton.py), XLA's grouped conv and
    matmul otherwise."""
    if platform.block_kernel_serves(int(y.shape[1]), y.dtype):
        from ..ops.block_triton import separable_block as kernel  # noqa: PLC0415

        return kernel(y, blk["dw"]["w"], blk["dw"]["b"], blk["pw"]["w"],
                      blk["pw"]["b"], stride, relu6)
    y = ops.depthwise_conv_xla(y, blk["dw"]["w"], stride,
                               bias=blk["dw"]["b"], relu6=relu6)
    return ops.pointwise_conv(y, blk["pw"]["w"], bias=blk["pw"]["b"],
                              relu6=relu6)


def _run_blocks(params, y, config, relu6, acts=None, start: int = 0,
                stop: Optional[int] = None):
    """The 13 dw/pw blocks [start, stop). `acts` (verify mode) collects
    every dw and pw output, so those blocks run unfused on XLA."""
    stop = len(config.block_strides) if stop is None else stop
    for i in range(start, stop):
        blk, stride = params["blocks"][i], config.block_strides[i]
        if acts is None:
            y = separable_block(blk, y, stride, relu6)
            continue
        y = ops.depthwise_conv_xla(y, blk["dw"]["w"], stride,
                                   bias=blk["dw"]["b"], relu6=relu6)
        acts[f"block{i:02d}_dw"] = y
        y = ops.pointwise_conv(y, blk["pw"]["w"], bias=blk["pw"]["b"], relu6=relu6)
        acts[f"block{i:02d}_pw"] = y
    return y


def predict_probs_u8(params, images_u8, config: ModelConfig, *,
                     dtype=jnp.float32) -> jax.Array:
    """uint8 NHWC images -> probabilities, preprocessing in the same program."""
    from ..ops import preprocess as prep  # noqa: PLC0415

    x = prep.preprocess(images_u8, config.resolution, dtype)
    return predict_probs(params, x, config)


def predict_probs(params, x, config: ModelConfig) -> jax.Array:
    """logits -> softmax probabilities (host does only top-k; SURVEY.md SS3.4)."""
    return jax.nn.softmax(forward(params, x, config).astype(jnp.float32), axis=-1)
