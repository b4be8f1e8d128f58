"""Quantization-aware training (QAT) for the int8 fixed-point scheme.

The reference stack is inference-only (SURVEY.md SS5) and its int8 path is
post-training quantized with compile-time fixed-point formats
(BASELINE.json:10); training is this rebuild's extension (models/train.py),
and QAT closes the loop between the two: train WITH the deployment
quantizer in the graph, so the exported int8 model (quant/quantize.py) is
the function the optimizer actually optimized.

Design — EXACT integer-domain simulation with straight-through gradients.

Standard QAT fake-quantizes in real units (dequantized floats); that only
tracks the deployed integer arithmetic to f32 roundoff, because scaled
activations are not exactly representable. This module instead carries the
QUANTIZED integers themselves in float32 — the same exact-f32-integer trick
the device int8 path uses for its dw taps (quant/ops.py) — so the QAT
forward's activations equal the int8 oracle's BIT-FOR-BIT (the repo's int8
invariant), while the STE shadows carry real-unit gradients:

  value path (exact ints in f32)          gradient shadow (real units / scales)
  q_x  = clip(rint(x/s_in), +-127)        x / s_in
  w_q  = clip(rint(w/s_w[oc]), +-127)     w / s_w[oc]         (s_w stop-grad)
  b_q  = rint(b / (s_in*s_w[oc]))         b / (s_in*s_w[oc])
  acc  = conv(q_x, w_q) + b_q             exact while |values| < 2^24
  q_y  = rint(clamp(acc*m, 0, six_q))     acc*m               (m stop-grad)

Because every scale constant is stop-gradiented, the gradient shadow is
mathematically the plain float network divided by constants that cancel
layer to layer — i.e. gradients are IDENTICAL to textbook real-units STE
QAT — while the forward value is the deployed int8 network exactly.

Exactness preconditions (same family as quant/ops.py): every f32-carried
integer must stay below 2^24. Products are <= 127*127; the worst
accumulation is pointwise at alpha=1.0 (Cin=1024: 1024*16129 = 16.52e6 <
2^24 = 16.78e6), and the dw bias bound is already guarded host-side
(quantize._quant_layer). The depthwise conv is written as 9 shifted-slice
FMAs, not lax grouped conv, for the same bit-reliability reason as
qops.depthwise_i8_xla — and slices/adds are trivially differentiable.

Gated in tests/test_qat.py: EXACT per-layer equality vs quant/oracle
.forward_all, descending loss, finite nonzero grads, and post-QAT export
through quantize() keeping the int8 EXACT verify gate green.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from ..config import ModelConfig
from ..oracle.numpy_ref import same_pad
from ..ops import conv as ops
from .quantize import ACT_HIDDEN_SCALE, ACT_IN_SCALE

# six_q for the fixed 6/127 hidden activation scale: 6 / (6/127) = 127.
_HIDDEN_SIX_Q = 127.0


def _ste(shadow: jax.Array, value: jax.Array) -> jax.Array:
    """Value of `value`, gradient of `shadow` (straight-through)."""
    return shadow + lax.stop_gradient(value - shadow)


def fq_input(x: jax.Array, s_in: float = float(ACT_IN_SCALE)) -> jax.Array:
    """[-1,1] floats -> integer-domain input (twin of quantize.quantize_input)."""
    v = x.astype(jnp.float32) / jnp.float32(s_in)
    return _ste(v, jnp.clip(jnp.round(v), -127, 127))


def fq_weight(w: jax.Array, out_axis: int) -> Tuple[jax.Array, jax.Array]:
    """Per-output-channel integer weights (twin of quantize._quant_weight).

    Returns (w_q carrying exact ints in f32, s_w broadcast-shaped, stop-grad).
    """
    wf = w.astype(jnp.float32)
    red = tuple(i for i in range(wf.ndim) if i != out_axis)
    absmax = jnp.maximum(jnp.max(jnp.abs(wf), axis=red), 1e-12)
    shape = [1] * wf.ndim
    shape[out_axis] = -1
    s_w = lax.stop_gradient((absmax / jnp.float32(127.0))
                            .reshape(shape).astype(jnp.float32))
    v = wf / s_w
    return _ste(v, jnp.clip(jnp.round(v), -127, 127)), s_w


def fq_bias(b: jax.Array, acc_scale: jax.Array) -> jax.Array:
    """Accumulator-unit bias (twin of quantize bias_i32), STE'd."""
    acc = lax.stop_gradient(acc_scale.reshape(-1).astype(jnp.float32))
    v = b.astype(jnp.float32) / acc
    return _ste(v, jnp.round(v))


def fq_requant(acc: jax.Array, m: jax.Array, six_q: float = _HIDDEN_SIX_Q,
               relu6: bool = True) -> jax.Array:
    """Integer accumulator -> next layer's integers (twin of qops.requantize)."""
    v = acc * lax.stop_gradient(m.reshape(-1).astype(jnp.float32))
    v = jnp.maximum(v, 0.0)
    if relu6:
        v = jnp.minimum(v, jnp.float32(six_q))
    return _ste(v, jnp.round(v))


def _dw3x3_taps(x: jax.Array, w: jax.Array, stride: int) -> jax.Array:
    """Depthwise 3x3 as 9 shifted-slice FMAs — exact integers AND
    differentiable (the qops.depthwise_i8_xla construction)."""
    n, h, wd, c = x.shape
    h_out, w_out = -(-h // stride), -(-wd // stride)
    lo_h, hi_h = same_pad(h, stride, 3)
    lo_w, hi_w = same_pad(wd, stride, 3)
    xp = jnp.pad(x, ((0, 0), (lo_h, hi_h), (lo_w, hi_w), (0, 0)))
    acc = jnp.zeros((n, h_out, w_out, c), jnp.float32)
    for dy in range(3):
        for dx in range(3):
            patch = xp[:, dy : dy + h_out * stride : stride,
                       dx : dx + w_out * stride : stride, :]
            acc = acc + patch * w[dy, dx, 0]
    return acc


def qat_forward(
    params: Dict[str, Any],
    x: jax.Array,
    config: ModelConfig,
    *,
    collect: bool = False,
) -> Any:
    """MobileNet-V1 forward with the deployment quantizer in the graph.

    Mirrors quant/oracle.forward_all layer for layer; with collect=True the
    taps use the oracle's layer names and hold the SAME integers (as f32).
    Always the differentiable f32 route — this is a TRAINING graph.
    Logits are real-unit floats (the int8 head keeps float logits too).
    """
    assert config.relu6, "the int8 fixed-point scheme requires ReLU6 bounds"
    acts: Dict[str, jax.Array] = {}
    s_in = jnp.float32(ACT_IN_SCALE)
    s_h = jnp.float32(ACT_HIDDEN_SCALE)

    q = fq_input(x)
    w_q, s_w = fq_weight(params["conv1"]["w"], out_axis=3)
    b_q = fq_bias(params["conv1"]["b"], s_in * s_w)
    acc = ops.conv2d_same(q, w_q, 2) + b_q  # f32 HIGHEST: exact ints (27 taps)
    q = fq_requant(acc, s_in * s_w / s_h)
    if collect:
        acts["conv1"] = q

    for i, stride in enumerate(config.block_strides):
        blk = params["blocks"][i]
        w_q, s_w = fq_weight(blk["dw"]["w"], out_axis=3)
        b_q = fq_bias(blk["dw"]["b"], s_h * s_w)
        acc = _dw3x3_taps(q, w_q, stride) + b_q
        q = fq_requant(acc, s_h * s_w / s_h)
        if collect:
            acts[f"block{i:02d}_dw"] = q
        w_q, s_w = fq_weight(blk["pw"]["w"], out_axis=1)
        b_q = fq_bias(blk["pw"]["b"], s_h * s_w)
        n, hh, ww, cin = q.shape
        acc = jnp.dot(q.reshape(n * hh * ww, cin), w_q,
                      precision=lax.Precision.HIGHEST)  # ints < 2^24: exact
        acc = (acc + b_q).reshape(n, hh, ww, -1)
        q = fq_requant(acc, s_h * s_w / s_h)
        if collect:
            acts[f"block{i:02d}_pw"] = q

    # Pool: exact integer sum, f32 mean, round-half-even (qops.avgpool_i8).
    n, hh, ww, c = q.shape
    v = jnp.sum(q, axis=(1, 2)) * jnp.float32(1.0 / (hh * ww))
    pooled = _ste(v, jnp.clip(jnp.round(v), -128, 127))
    if collect:
        acts["pool"] = pooled
    # Classifier: integer matmul, float logits (twin of qops.fc_i8_logits).
    w_q, s_w = fq_weight(params["fc"]["w"], out_axis=1)
    acc = jnp.dot(pooled, w_q, precision=lax.Precision.HIGHEST)
    scale = s_h * s_w.reshape(-1)
    logits = acc * scale[None, :] + params["fc"]["b"].astype(jnp.float32)[None, :]
    if collect:
        acts["logits"] = logits
        return logits, acts
    return logits


def fq_requant_linear(acc: jax.Array, m: jax.Array) -> jax.Array:
    """Signed linear requant (twin of quant/v2._requant_linear): no ReLU,
    round-half-even FIRST then clamp [-128, 127] — the order matters at the
    127.5 boundary, where clamp-then-round would round half-even to 128.
    The gradient shadow is the clamped pre-round value (clipped STE)."""
    v = acc * lax.stop_gradient(m.reshape(-1).astype(jnp.float32))
    shadow = jnp.clip(v, -128.0, 127.0)
    return _ste(shadow, jnp.clip(jnp.round(v), -128, 127))


def qat_forward_v2(
    params: Dict[str, Any],
    x: jax.Array,
    config,
    s_blk,
    *,
    collect: bool = False,
) -> Any:
    """MobileNet-V2 QAT forward (twin of quant/v2.forward_all_v2_i8).

    `s_blk` is the frozen per-block bottleneck scale list from
    quant.v2.calibrate_v2 — QAT follows the standard calibrate-then-freeze
    convention: activation ranges are pinned before training so the
    exported model (quantize_v2 with the same calibration seed/images)
    shares them. Residual adds are saturating integer adds on one shared
    group scale, exactly like the deployed path.

    Exact-f32-integer status: guaranteed for every reduction whose worst
    case stays under 2^24 (<= 1040 lanes: all dw taps, alpha<=1.0
    expansions up to 960). The V2 fc (1280 lanes at alpha 1.0) exceeds the
    WORST-CASE bound; its exactness on real weight/activation magnitudes is
    gated empirically by tests/test_qat.py's deterministic seeded run.
    """
    assert config.relu6, "the int8 fixed-point scheme requires ReLU6 bounds"
    acts: Dict[str, jax.Array] = {}
    s_in = jnp.float32(ACT_IN_SCALE)
    s_h = jnp.float32(ACT_HIDDEN_SCALE)

    q = fq_input(x)
    w_q, s_w = fq_weight(params["conv1"]["w"], out_axis=3)
    b_q = fq_bias(params["conv1"]["b"], s_in * s_w)
    acc = ops.conv2d_same(q, w_q, 2) + b_q
    q = fq_requant(acc, s_in * s_w / s_h)
    if collect:
        acts["conv1"] = q

    s_prev = s_h  # scale of the activation entering the next block
    for i, ((t, cin, cout, stride), blk) in enumerate(
            zip(config.block_defs, params["blocks"])):
        z = q
        if "exp" in blk:
            w_q, s_w = fq_weight(blk["exp"]["w"], out_axis=1)
            b_q = fq_bias(blk["exp"]["b"], s_prev * s_w)
            n, hh, ww, ci = z.shape
            acc = jnp.dot(z.reshape(n * hh * ww, ci), w_q,
                          precision=lax.Precision.HIGHEST)
            acc = (acc + b_q).reshape(n, hh, ww, -1)
            z = fq_requant(acc, s_prev * s_w / s_h)
            if collect:
                acts[f"block{i:02d}_exp"] = z
        w_q, s_w = fq_weight(blk["dw"]["w"], out_axis=3)
        b_q = fq_bias(blk["dw"]["b"], s_h * s_w)
        acc = _dw3x3_taps(z, w_q, stride) + b_q
        z = fq_requant(acc, s_h * s_w / s_h)
        if collect:
            acts[f"block{i:02d}_dw"] = z
        s_out = jnp.float32(s_blk[i])
        w_q, s_w = fq_weight(blk["prj"]["w"], out_axis=1)
        b_q = fq_bias(blk["prj"]["b"], s_h * s_w)
        n, hh, ww, ci = z.shape
        acc = jnp.dot(z.reshape(n * hh * ww, ci), w_q,
                      precision=lax.Precision.HIGHEST)
        acc = (acc + b_q).reshape(n, hh, ww, -1)
        out = fq_requant_linear(acc, s_h * s_w / s_out)
        if collect:
            acts[f"block{i:02d}_prj"] = out
        if stride == 1 and cin == cout:
            # Saturating int8 residual add on the shared group scale: both
            # operands carry exact ints, the sum is exact, clip is the
            # (gradient-gated) saturation — quant/v2._res_add's twin.
            out = jnp.clip(out + q, -128, 127)
            if collect:
                acts[f"block{i:02d}_out"] = out
        q = out
        s_prev = s_out

    w_q, s_w = fq_weight(params["conv_last"]["w"], out_axis=1)
    b_q = fq_bias(params["conv_last"]["b"], s_prev * s_w)
    n, hh, ww, ci = q.shape
    acc = jnp.dot(q.reshape(n * hh * ww, ci), w_q,
                  precision=lax.Precision.HIGHEST)
    acc = (acc + b_q).reshape(n, hh, ww, -1)
    q = fq_requant(acc, s_prev * s_w / s_h)
    if collect:
        acts["conv_last"] = q

    n, hh, ww, c = q.shape
    v = jnp.sum(q, axis=(1, 2)) * jnp.float32(1.0 / (hh * ww))
    pooled = _ste(v, jnp.clip(jnp.round(v), -128, 127))
    if collect:
        acts["pool"] = pooled
    w_q, s_w = fq_weight(params["fc"]["w"], out_axis=1)
    acc = jnp.dot(pooled, w_q, precision=lax.Precision.HIGHEST)
    scale = s_h * s_w.reshape(-1)
    logits = acc * scale[None, :] + params["fc"]["b"].astype(jnp.float32)[None, :]
    if collect:
        acts["logits"] = logits
        return logits, acts
    return logits


def _dwk_taps(x: jax.Array, w: jax.Array, stride: int, k: int) -> jax.Array:
    """Depthwise kxk (k in {3,5}) shifted-slice FMAs — exact ints,
    differentiable (generalizes _dw3x3_taps for the V3 family)."""
    n, h, wd, c = x.shape
    h_out, w_out = -(-h // stride), -(-wd // stride)
    lo_h, hi_h = same_pad(h, stride, k)
    lo_w, hi_w = same_pad(wd, stride, k)
    xp = jnp.pad(x, ((0, 0), (lo_h, hi_h), (lo_w, hi_w), (0, 0)))
    acc = jnp.zeros((n, h_out, w_out, c), jnp.float32)
    for dy in range(k):
        for dx in range(k):
            patch = xp[:, dy : dy + h_out * stride : stride,
                       dx : dx + w_out * stride : stride, :]
            acc = acc + patch * w[dy, dx, 0]
    return acc


def fq_requant_named(acc: jax.Array, a: jax.Array, inv_s: float,
                     act: str) -> jax.Array:
    """Named-activation requant (twin of quant/v3._requant_named_np):
    accumulator -> REAL units via `a` -> activation -> quantize at 1/s_out.
    The same f32 op order as the oracle (including the FOLDED_REQUANT
    single-multiplier order, read from quant/v3 at trace time), so values
    match bit-for-bit; the gradient shadow is the clamped pre-round value
    (clipped STE — for the folded relu the clip lower bound 0 IS the relu,
    so gradients still stop below zero exactly as the max did)."""
    from . import v3 as _v3

    av = lax.stop_gradient(a.reshape(-1).astype(jnp.float32))
    if _v3.FOLDED_REQUANT:
        if act == "hswish":
            v = acc * av
            t = _v3.hsig_num(v)
            w = (v * t) * (jnp.float32(inv_s) * jnp.float32(1.0 / 6.0))
            shadow = jnp.clip(w, -128.0, 127.0)
            return _ste(shadow, jnp.clip(jnp.round(w), -128, 127))
        assert act in ("relu", "linear"), act
        w = acc * (av * jnp.float32(inv_s))
        lo = jnp.float32(0.0) if act == "relu" else jnp.float32(-128.0)
        shadow = jnp.clip(w, lo, 127.0)
        return _ste(shadow, jnp.clip(jnp.round(w), lo, 127))
    v = acc * av
    if act == "relu":
        v = jnp.maximum(v, jnp.float32(0.0))
    elif act == "hswish":
        g = _v3.hsig_num(v) * jnp.float32(1.0 / 6.0)
        v = v * g
    else:
        assert act == "linear", act
    w = v * jnp.float32(inv_s)
    shadow = jnp.clip(w, -128.0, 127.0)
    return _ste(shadow, jnp.clip(jnp.round(w), -128, 127))


def _fq_pool_sat(q: jax.Array) -> jax.Array:
    """Integer-domain global pool: exact sum, f32 mean, rint, clip."""
    n, hh, ww, c = q.shape
    v = jnp.sum(q, axis=(1, 2)) * jnp.float32(1.0 / (hh * ww))
    return _ste(v, jnp.clip(jnp.round(v), -128, 127))


def _fq_se(z: jax.Array, se: Dict[str, Any], s_dw: float, s_g1: float) -> jax.Array:
    """Quantized squeeze-excite gate (twin of quant/v3._se_i8_np): integer
    matmuls, f32 only elementwise; gradients reach both SE weight pairs and
    z (through the product AND the pooled path)."""
    from . import v3 as _v3

    pooled = _fq_pool_sat(z)
    w1_q, s_w1 = fq_weight(se["w1"], out_axis=1)
    b1_q = fq_bias(se["b1"], jnp.float32(s_dw) * s_w1)
    acc1 = jnp.dot(pooled, w1_q, precision=lax.Precision.HIGHEST) + b1_q
    g1 = fq_requant_named(acc1, jnp.float32(s_dw) * s_w1, 1.0 / s_g1, "relu")
    w2_q, s_w2 = fq_weight(se["w2"], out_axis=1)
    b2_q = fq_bias(se["b2"], jnp.float32(s_g1) * s_w2)
    acc2 = jnp.dot(g1, w2_q, precision=lax.Precision.HIGHEST) + b2_q
    v = acc2 * lax.stop_gradient(
        (jnp.float32(s_g1) * s_w2).reshape(-1))  # real units (s_out = 1)
    gate = _v3.hsig_num(v) * jnp.float32(1.0 / 6.0)
    out = z * gate[:, None, None, :]
    return _ste(out, jnp.clip(jnp.round(out), -128, 127))


def _fq_pw_acc(q: jax.Array, w_q: jax.Array, b_q: jax.Array) -> jax.Array:
    n, hh, ww, ci = q.shape
    acc = jnp.dot(q.reshape(n * hh * ww, ci), w_q,
                  precision=lax.Precision.HIGHEST)
    return (acc + b_q).reshape(n, hh, ww, -1)


def qat_forward_v3(
    params: Dict[str, Any],
    x: jax.Array,
    config,
    cal: Dict[str, Any],
    *,
    collect: bool = False,
) -> Any:
    """MobileNet-V3 QAT forward (twin of quant/v3.forward_all_v3_i8).

    `cal` is the frozen calibration dict from quant.v3.calibrate_v3
    (activation scale per named tap; calibrate-then-freeze, like V2).
    Weight scales stay live (last-value), activation scales are pinned —
    so exporting with quantize_v3 at the same calibration seed reproduces
    the deployed constants. Hard-swish and the SE gate run through the
    same f32 real-units detour as the oracle, bit-for-bit.
    """
    acts: Dict[str, jax.Array] = {}
    s_in = float(ACT_IN_SCALE)

    q = fq_input(x)
    w_q, s_w = fq_weight(params["conv1"]["w"], out_axis=3)
    b_q = fq_bias(params["conv1"]["b"], jnp.float32(s_in) * s_w)
    acc = ops.conv2d_same(q, w_q, 2) + b_q
    s_c1 = float(cal["conv1"])
    q = fq_requant_named(acc, jnp.float32(s_in) * s_w, 1.0 / s_c1,
                         config.head_act)
    if collect:
        acts["conv1"] = q

    s_prev = s_c1
    for i, (bd, blk) in enumerate(zip(config.block_defs, params["blocks"])):
        c = cal["blocks"][i]
        z, s = q, s_prev
        if bd.has_expand:
            w_q, s_w = fq_weight(blk["exp"]["w"], out_axis=1)
            b_q = fq_bias(blk["exp"]["b"], jnp.float32(s) * s_w)
            z = fq_requant_named(_fq_pw_acc(z, w_q, b_q),
                                 jnp.float32(s) * s_w,
                                 1.0 / float(c["exp"]), bd.act)
            s = float(c["exp"])
            if collect:
                acts[f"block{i:02d}_exp"] = z
        w_q, s_w = fq_weight(blk["dw"]["w"], out_axis=3)
        b_q = fq_bias(blk["dw"]["b"], jnp.float32(s) * s_w)
        acc = _dwk_taps(z, w_q, bd.stride, bd.kernel) + b_q
        s_dw = float(c["dw"])
        z = fq_requant_named(acc, jnp.float32(s) * s_w, 1.0 / s_dw, bd.act)
        if collect:
            acts[f"block{i:02d}_dw"] = z
        if bd.se_mid:
            z = _fq_se(z, blk["se"], s_dw, float(c["g1"]))
            if collect:
                acts[f"block{i:02d}_se"] = z
        s_out = float(cal["s_blk"][i])
        w_q, s_w = fq_weight(blk["prj"]["w"], out_axis=1)
        b_q = fq_bias(blk["prj"]["b"], jnp.float32(s_dw) * s_w)
        out = fq_requant_named(_fq_pw_acc(z, w_q, b_q),
                               jnp.float32(s_dw) * s_w, 1.0 / s_out,
                               "linear")
        if collect:
            acts[f"block{i:02d}_prj"] = out
        if bd.has_res:
            out = jnp.clip(out + q, -128, 127)
            if collect:
                acts[f"block{i:02d}_out"] = out
        q = out
        s_prev = s_out

    w_q, s_w = fq_weight(params["conv_last"]["w"], out_axis=1)
    b_q = fq_bias(params["conv_last"]["b"], jnp.float32(s_prev) * s_w)
    s_cl = float(cal["conv_last"])
    q = fq_requant_named(_fq_pw_acc(q, w_q, b_q),
                         jnp.float32(s_prev) * s_w, 1.0 / s_cl,
                         config.head_act)
    if collect:
        acts["conv_last"] = q

    pooled = _fq_pool_sat(q)
    if collect:
        acts["pool"] = pooled
    w_q, s_w = fq_weight(params["head"]["w"], out_axis=1)
    b_q = fq_bias(params["head"]["b"], jnp.float32(s_cl) * s_w)
    acc = jnp.dot(pooled, w_q, precision=lax.Precision.HIGHEST) + b_q
    s_head = float(cal["head"])
    h = fq_requant_named(acc, jnp.float32(s_cl) * s_w, 1.0 / s_head,
                         config.head_act)
    if collect:
        acts["head"] = h
    w_q, s_w = fq_weight(params["fc"]["w"], out_axis=1)
    acc = jnp.dot(h, w_q, precision=lax.Precision.HIGHEST)
    scale = jnp.float32(s_head) * s_w.reshape(-1)
    logits = acc * scale[None, :] + params["fc"]["b"].astype(jnp.float32)[None, :]
    if collect:
        acts["logits"] = logits
        return logits, acts
    return logits


def make_qat_trainer_v3(config, folded_init: Dict[str, Any],
                        lr: float = 1e-2, momentum: float = 0.9,
                        weight_decay: float = 4e-5,
                        n_calib: int = 32, calib_seed: int = 1234):
    """V3 QAT trainer: calibrate-then-freeze the named-activation scales
    from the initial params, then train against them. Returns
    (init_fn, step_fn, cal)."""
    from .v3 import calibrate_v3  # noqa: PLC0415

    cal = calibrate_v3(folded_init, config, n_images=n_calib,
                       seed=calib_seed)
    init_fn, step_fn = _make_trainer(
        lambda p, x: qat_forward_v3(p, x, config, cal),
        lr, momentum, weight_decay)
    return init_fn, step_fn, cal


def _make_trainer(forward_fn, lr, momentum, weight_decay):
    import optax  # noqa: PLC0415

    tx = optax.chain(
        optax.add_decayed_weights(weight_decay),
        optax.sgd(lr, momentum=momentum),
    )

    def init_fn(params):
        return tx.init(params)

    def step_fn(params, opt_state, images, labels):
        def loss_fn(p):
            logits = forward_fn(p, images)
            logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
            nll = -jnp.take_along_axis(logp, labels[:, None], axis=-1)[:, 0]
            return jnp.mean(nll), logits

        (loss, logits), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        top1 = jnp.mean((jnp.argmax(logits, -1) == labels).astype(jnp.float32))
        return params, opt_state, loss, top1

    return init_fn, step_fn


def make_qat_trainer(config: ModelConfig, lr: float = 1e-2,
                     momentum: float = 0.9, weight_decay: float = 4e-5):
    """Optax SGD-momentum QAT trainer over the folded parameterization.

    Same shape as models.train.make_optax_trainer — (init_fn, step_fn), both
    jittable/shardable with the parallel.mesh layouts — but the loss runs
    qat_forward, so gradients flow through the STE quantizers and the
    optimizer sees the deployed int8 arithmetic. The trained pytree exports
    with quant.quantize() unchanged.
    """
    return _make_trainer(lambda p, x: qat_forward(p, x, config),
                         lr, momentum, weight_decay)


def make_qat_trainer_v2(config, folded_init: Dict[str, Any],
                        lr: float = 1e-2, momentum: float = 0.9,
                        weight_decay: float = 4e-5,
                        n_calib: int = 32, calib_seed: int = 1234):
    """V2 QAT trainer: calibrates the bottleneck group scales ONCE from the
    initial params (calibrate-then-freeze), then trains against them.
    Returns (init_fn, step_fn, s_blk); export the result with
    quantize_v2(..., n_calib=n_calib, seed=calib_seed) ONLY if the trained
    activations still fit the frozen ranges — the faithful export is
    quantize_v2 on the INITIAL calibration, which s_blk lets callers pin
    (quant.v2.quantize_v2 accepts the same seed/images so re-calibration on
    the trained weights reproduces the deployment scheme)."""
    from .v2 import calibrate_v2  # noqa: PLC0415

    s_blk = tuple(float(s) for s in
                  calibrate_v2(folded_init, config, n_images=n_calib,
                               seed=calib_seed))
    init_fn, step_fn = _make_trainer(
        lambda p, x: qat_forward_v2(p, x, config, s_blk),
        lr, momentum, weight_decay)
    return init_fn, step_fn, s_blk
