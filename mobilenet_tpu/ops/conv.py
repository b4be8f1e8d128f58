"""XLA-path convolution ops (NHWC, channels-last).

These replace the reference's OpenCL-C device kernels (SURVEY.md SS2 C3-C6):
  - conv2d_same      <- __kernel void conv      (3x3 standard, stem)
  - depthwise_conv   <- __kernel void dw_conv   (3x3 per-channel)
  - pointwise_conv   <- __kernel void pw_conv   (1x1 = per-pixel matmul)
  - global_avg_pool / fc <- __kernel void avg_pool / fc

BatchNorm is folded into conv weights + a per-channel bias at load time
(checkpoints/folding), so every op here takes an optional bias and fuses
bias-add + ReLU(6) — the "fused BatchNorm+ReLU epilogue" of BASELINE.json:5.
XLA fuses these elementwise epilogues into the conv/matmul automatically.

Padding follows TF/XLA 'SAME' semantics, which match the keras reference
(ZeroPadding2D (0,1) before stride-2 convs — mobilenet.py:320,385): for
stride 2, kernel 3, even input, XLA SAME pads (lo=0, hi=1).
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax

_DIMS = ("NHWC", "HWIO", "NHWC")


def _precision(x: jax.Array):
    """True-fp32 passes for the float32 verify path (the accuracy gate of
    BASELINE.json:5 requires real fp32 — a default-precision f32 matmul or
    conv may run in TF32 on the GPU); default precision for the bf16
    throughput path."""
    return lax.Precision.HIGHEST if x.dtype == jnp.float32 else None


def apply_activation(y: jax.Array, relu6: bool) -> jax.Array:
    """ReLU or ReLU6 (clip-at-6 is the TF-slim convention, SURVEY.md SS2)."""
    zero = jnp.asarray(0, y.dtype)
    if relu6:
        return jnp.clip(y, zero, jnp.asarray(6, y.dtype))
    return jnp.maximum(y, zero)


# Named activations for the V3 family (keras mobilenet_v3.py:542-553):
# hard_sigmoid = relu6(x + 3) / 6; hard_swish = x * hard_sigmoid(x). The
# bool `relu6` interface stays for V1/V2; `act=` overrides it when given.
def apply_act_named(y: jax.Array, act: str) -> jax.Array:
    zero = jnp.asarray(0, y.dtype)
    six = jnp.asarray(6, y.dtype)
    if act == "relu":
        return jnp.maximum(y, zero)
    if act == "relu6":
        return jnp.clip(y, zero, six)
    if act == "hsigmoid":
        return jnp.clip(y + jnp.asarray(3, y.dtype), zero, six) * jnp.asarray(
            1.0 / 6.0, y.dtype)
    if act == "hswish":
        return y * (jnp.clip(y + jnp.asarray(3, y.dtype), zero, six)
                    * jnp.asarray(1.0 / 6.0, y.dtype))
    raise ValueError(f"unknown activation {act!r}")


def bias_act(y: jax.Array, bias: Optional[jax.Array], relu6: Optional[bool],
             act: Optional[str] = None) -> jax.Array:
    if bias is not None:
        y = y + bias.astype(y.dtype)
    if act is not None:
        return apply_act_named(y, act)
    if relu6 is not None:
        y = apply_activation(y, relu6)
    return y


def conv2d_same(
    x: jax.Array,
    w: jax.Array,
    stride: int,
    bias: Optional[jax.Array] = None,
    relu6: Optional[bool] = None,
    act: Optional[str] = None,
) -> jax.Array:
    """Standard conv, NHWC x HWIO -> NHWC, SAME padding.

    Used for the stem 3x3 s2 conv (layer 1 of 28, mobilenet.py:192).
    """
    y = lax.conv_general_dilated(
        x,
        w.astype(x.dtype),
        window_strides=(stride, stride),
        padding="SAME",
        dimension_numbers=_DIMS,
        precision=_precision(x),
        preferred_element_type=jnp.float32 if x.dtype == jnp.float32 else None,
    )
    return bias_act(y, bias, relu6, act).astype(x.dtype)


def depthwise_conv_xla(
    x: jax.Array,
    w: jax.Array,
    stride: int,
    bias: Optional[jax.Array] = None,
    relu6: Optional[bool] = None,
    act: Optional[str] = None,
) -> jax.Array:
    """Depthwise kxk via XLA grouped conv. w: (k, k, 1, C) HWIO; k in {3, 5}
    (5 is the V3 family's late-stage kernel, keras mobilenet_v3.py:421-519;
    SAME padding equals keras's explicit correct_pad+valid at every even
    input size, which resolution % 32 == 0 guarantees at each stride-2
    point).

    Reference analog: the dw_conv OpenCL kernel (SURVEY.md SS2 C4). Every
    family's depthwise layers run here, except the V1 blocks that the fused
    kernel (ops/block_triton.py) serves on the GPU.
    """
    c = x.shape[-1]
    assert w.shape[2:] == (1, c) and w.shape[0] == w.shape[1] in (3, 5), (
        w.shape, c)
    y = lax.conv_general_dilated(
        x,
        w.astype(x.dtype),
        window_strides=(stride, stride),
        padding="SAME",
        dimension_numbers=_DIMS,
        feature_group_count=c,
        precision=_precision(x),
        preferred_element_type=jnp.float32 if x.dtype == jnp.float32 else None,
    )
    return bias_act(y, bias, relu6, act).astype(x.dtype)


def pointwise_conv(
    x: jax.Array,
    w: jax.Array,
    bias: Optional[jax.Array] = None,
    relu6: Optional[bool] = None,
    act: Optional[str] = None,
) -> jax.Array:
    """Pointwise 1x1 conv as an explicit matmul: (N*H*W, Cin) @ (Cin, Cout).

    Reference analog: the pw_conv OpenCL kernel (SURVEY.md SS2 C5): a matmul
    with the BN+ReLU epilogue fused by XLA.
    w: (Cin, Cout) — already squeezed from (1, 1, Cin, Cout).
    """
    n, h, ww, cin = x.shape
    cout = w.shape[-1]
    y = jnp.dot(
        x.reshape(n * h * ww, cin),
        w.astype(x.dtype),
        precision=_precision(x),
        preferred_element_type=jnp.float32,
    )
    y = bias_act(y, bias, relu6, act)
    return y.reshape(n, h, ww, cout).astype(x.dtype)


def global_avg_pool(x: jax.Array) -> jax.Array:
    """7x7 (or res/32) global average pool -> (N, C). mobilenet.py:220."""
    return jnp.mean(x.astype(jnp.float32), axis=(1, 2)).astype(x.dtype)


def fc(
    x: jax.Array,
    w: jax.Array,
    bias: Optional[jax.Array] = None,
) -> jax.Array:
    """Classifier FC 1024->1000 (mobilenet.py:224-227). x: (N, C), w: (C, classes)."""
    y = jnp.dot(
        x, w.astype(x.dtype), precision=_precision(x), preferred_element_type=jnp.float32
    )
    if bias is not None:
        y = y + bias.astype(y.dtype)
    return y.astype(x.dtype)


@partial(jax.jit, static_argnames=())
def softmax(logits: jax.Array) -> jax.Array:
    return jax.nn.softmax(logits.astype(jnp.float32), axis=-1)
