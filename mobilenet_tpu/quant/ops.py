"""Device-side INT8 ops with per-layer requantization (BASELINE.json:10).

Semantics contract (shared bit-for-bit with cpu_ref.cpp and quant/oracle.py):
  acc: exact int32 accumulation (pw/fc are s8 x s8 -> s32 dot_generals;
       dw/conv1 accumulate integers exactly in float32)
  requant: v = float32(acc) * m[oc]; ReLU in-domain (v<0 -> 0, v>six_q -> six_q);
           round-half-to-even; clamp to [-128, 127]; cast int8.

jnp.round == np.rint == C nearbyintf(FE_TONEAREST): all round-half-to-even, so
the device path is EXACTLY equal to the oracles — the int8 analog of the
reference's "bit-matching ... per layer" gate (SURVEY.md SS7 hard parts).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from ..ops.conv import _DIMS


def requantize(acc_i32: jax.Array, m: jax.Array, six_q, relu6: bool = True) -> jax.Array:
    """int32 accumulator -> int8 output in the next layer's scale."""
    v = acc_i32.astype(jnp.float32) * m.astype(jnp.float32)
    v = jnp.maximum(v, 0.0)
    if relu6:
        v = jnp.minimum(v, jnp.float32(six_q))
        if float(six_q) < 127.5:
            # In-domain ReLU6 bounds round(v) to [0, 127] (six_q is 127.0 for
            # the fixed 6/127 hidden scale): the final clip is provably
            # redundant — fewer ops per element, bit-identical.
            return jnp.round(v).astype(jnp.int8)
    r = jnp.round(v)  # round-half-to-even, matches nearbyintf
    return jnp.clip(r, -128, 127).astype(jnp.int8)


def pointwise_i8(x_i8: jax.Array, w_i8: jax.Array, bias_i32: jax.Array,
                 m: jax.Array, six_q, relu6: bool = True) -> jax.Array:
    """Pointwise int8 matmul: (N*H*W, Cin)s8 @ (Cin, Cout)s8 -> s32."""
    n, h, w, cin = x_i8.shape
    cout = w_i8.shape[1]
    acc = lax.dot_general(
        x_i8.reshape(n * h * w, cin),
        w_i8,
        dimension_numbers=(((1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32,
    )
    acc = acc + bias_i32[None, :]
    return requantize(acc, m, six_q, relu6).reshape(n, h, w, cout)


def depthwise_i8_xla(x_i8: jax.Array, w_i8: jax.Array, bias_i32: jax.Array,
                     m: jax.Array, six_q, stride: int, relu6: bool = True) -> jax.Array:
    """Depthwise int8 fallback: explicit 9-tap f32 FMAs — exact integers.

    Products are <= 127*127 and the 9-tap sum + bias stays far below 2^24, so
    float32 tap accumulation is exact integer arithmetic in ANY order. The
    taps are written as shifted slices, not lax.conv, so no backend's
    grouped-conv algorithm choice can touch the arithmetic.
    """
    from ..oracle.numpy_ref import same_pad  # noqa: PLC0415 (shared semantics)

    n, h, w, c = x_i8.shape
    h_out, w_out = -(-h // stride), -(-w // stride)
    lo_h, hi_h = same_pad(h, stride, 3)
    lo_w, hi_w = same_pad(w, stride, 3)
    xp = jnp.pad(x_i8.astype(jnp.float32),
                 ((0, 0), (lo_h, hi_h), (lo_w, hi_w), (0, 0)))
    wf = w_i8.astype(jnp.float32)
    acc = jnp.zeros((n, h_out, w_out, c), jnp.float32)
    for dy in range(3):
        for dx in range(3):
            patch = xp[:, dy : dy + h_out * stride : stride,
                       dx : dx + w_out * stride : stride, :]
            acc = acc + patch * wf[dy, dx, 0]
    acc_i32 = acc.astype(jnp.int32) + bias_i32
    return requantize(acc_i32, m, six_q, relu6)


def conv3x3_s2_acc(x_q: jax.Array, w_i8: jax.Array) -> jax.Array:
    """Exact int32 accumulator of the 3x3 stride-2 SAME stem conv.

    x_q holds integers |x| <= 127 (int8, or bfloat16 carrying them). Both
    operands are exact in float32, each product <= 16129 is exact, and the
    27-term sums stay far below 2^24, so a float32 conv yields the exact
    integer in ANY accumulation order. The operands stay float32 at HIGHEST
    precision: a bf16 conv whose output a backend rounds to bf16 would not
    be exact."""
    y = lax.conv_general_dilated(
        x_q.astype(jnp.float32),
        w_i8.astype(jnp.float32),
        window_strides=(2, 2),
        padding="SAME",
        dimension_numbers=_DIMS,
        precision=lax.Precision.HIGHEST,
    )
    return y.astype(jnp.int32)


def conv1_i8(x_i8: jax.Array, w_i8: jax.Array, bias_i32: jax.Array,
             m: jax.Array, six_q, relu6: bool = True) -> jax.Array:
    """Stem 3x3 s2 conv with exact int semantics (conv3x3_s2_acc), then the
    shared requant."""
    return requantize(conv3x3_s2_acc(x_i8, w_i8) + bias_i32, m, six_q, relu6)


def avgpool_i8(x_i8: jax.Array) -> jax.Array:
    """Global average pool in the quantized domain: exact integer sum, exact
    float32 mean, round-half-even back to int8 (same scale)."""
    n, h, w, c = x_i8.shape
    acc = jnp.sum(x_i8.astype(jnp.int32), axis=(1, 2)).astype(jnp.float32)
    v = acc * jnp.float32(1.0 / (h * w))
    return jnp.clip(jnp.round(v), -128, 127).astype(jnp.int8)


def fc_i8_logits(x_i8: jax.Array, w_i8: jax.Array, s_in, s_w: jax.Array,
                 b_f32: jax.Array) -> jax.Array:
    """Classifier: int8 matmul -> int32 -> float32 logits (logits stay float)."""
    acc = lax.dot_general(
        x_i8, w_i8,
        dimension_numbers=(((1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32,
    )
    scale = jnp.float32(s_in) * s_w.astype(jnp.float32)
    return acc.astype(jnp.float32) * scale[None, :] + b_f32[None, :]


def quantize_input_dev(x_f: jax.Array, s_in, out_dtype=jnp.int8) -> jax.Array:
    """Preprocessed [-1,1] activations -> quantized input (device twin of
    quantize.quantize_input). out_dtype=bfloat16 stores the SAME integers
    (|q| <= 127 is exact in bf16)."""
    v = x_f.astype(jnp.float32) / jnp.float32(s_in)
    return jnp.clip(jnp.round(v), -127, 127).astype(out_dtype)
