"""INT8 MobileNet-V3: calibrated named-activation scheme, exact twins.

V1's fixed-point scheme (quantize.py) keys every hidden scale on ReLU6's
[0, 6] bound; V2 (v2.py) calibrates only the linear projections. V3 breaks
both assumptions everywhere — unbounded ReLU, hard-swish, and a mid-block
squeeze-excite gate — so this module is the "own calibrated scheme" those
files' boundary message pointed at:

  - EVERY activation scale is calibrated: s_tap = absmax/127 over the fp32
    oracle's taps on the structured calibration set (runtime.eval.
    synth_images — the same family the eval gate uses). Residual-connected
    runs share one group scale exactly like V2 (scale_groups), so the
    residual stays a saturating int8 add.
  - Named-activation requant, EXACT by construction: both paths compute
    the same f32 op order with the same float32 constants. The canonical
    (FOLDED_REQUANT, round-5) order folds the two scale multiplies into
    ONE precomputed per-channel multiplier — V1/V2's single-`m` design
    (quant/ops.requantize), one full-width elementwise pass fewer per
    requant:
      relu:   m  = f32(a) * f32(inv_s);  q = clamp(rint(acc*m),    0, 127)
      linear: m  = f32(a) * f32(inv_s);  q = clamp(rint(acc*m), -128, 127)
      hswish: v  = f32(acc) * a[oc]      (real units — needed for the gate)
              m6 = f32(inv_s) * f32(1/6)
              q  = clamp(rint((v * clip(v+3,0,6)) * m6), -128, 127)
    (relu's max(v,0) lives in the clip lower bound: m > 0, so acc*m < 0
    rounds <= 0 and clips to the 0 the max produced — proved bit-equal in
    round 5.) FOLDED_REQUANT=False keeps the pre-fold two-mul order
    (v = acc*a; act(v); clamp(rint(v*inv_s))) as the raced-option twin.
    Either way np.rint == jnp.round == round-half-even and elementwise
    f32 is IEEE on both sides — so the gate is EXACT equality per layer,
    like V1/V2. The f32 detour through real units is what makes
    hard-swish exact: it is how deployed int8 stacks handle non-monotone
    activations, with the oracle twin pinning the bit pattern.
  - The SE gate is quantized so its matmuls stay ORDER-INDEPENDENT
    integer arithmetic (f32 matmuls would break exactness — accumulation
    order differs between device and NumPy): pooled rides the dw scale
    (exact int sum, one f32 mean, rint), both SE convs are int8 with
    int32 accumulation, the mid activation gets its own calibrated scale,
    and only the final hard-sigmoid + channel scale are elementwise f32.
    Accuracy cost of the extra quantization shows up in `cli eval`'s
    agreement number, never in the exactness gate.
  - dw kernels are k in {3, 5}: 25-tap f32 integer accumulation is still
    exact (25 * 127^2 + bias << 2^24); the bias-bound guard scales with
    k^2.

Device path: XLA ops (int8 matmuls, exact-f32-integer dw taps, and the
exact float32 stem conv of quant/ops.conv3x3_s2_acc).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np

from ..models.mobilenet_v3 import V3Config
from ..oracle import numpy_ref
from .quantize import ACT_IN_SCALE, _quant_weight

# Canonical requant order: ONE precomputed multiplier for relu/linear
# (m = f32(a)*f32(inv_s)) and a folded m6 = inv_s/6 for hswish — one
# elementwise multiply fewer per named requant than the two-mul order
# (module docstring). The oracle, the device path and QAT read this same
# knob, so each setting is a complete, self-consistent scheme gated EXACT
# end to end.
FOLDED_REQUANT = True

# ---------------------------------------------------------------------------
# host-side quantization
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class QLayerN:
    """One named-activation quantized layer: int8 weights + constants.
    `a` maps the int32 accumulator to REAL f32 units; `inv_s` quantizes
    the activated value into the consumer's scale."""

    w_i8: np.ndarray
    bias_i32: np.ndarray
    a: np.ndarray          # (Cout,) f32 = s_in * s_w
    inv_s: np.float32      # 1 / s_out
    s_out: np.float32


def _quant_named(w, b, out_axis, s_in, s_out, *, k_taps: int = 0) -> QLayerN:
    w_i8, s_w = _quant_weight(np.asarray(w, np.float32), out_axis)
    a = (np.float32(s_in) * s_w).astype(np.float32)
    bias_i32 = np.clip(np.rint(np.asarray(b, np.float32) / a),
                       -(2 ** 31) + 1, 2 ** 31 - 1).astype(np.int32)
    if k_taps and np.abs(bias_i32).max(initial=0) > (
            2 ** 24 - 2 * k_taps * 127 * 127):
        raise ValueError(
            "quantized dw bias exceeds the exact-f32-integer accumulation "
            f"bound for k_taps={k_taps} "
            f"(|bias_i32|_max = {np.abs(bias_i32).max()})")
    return QLayerN(w_i8=w_i8, bias_i32=bias_i32, a=a,
                   inv_s=np.float32(1.0 / np.float32(s_out)),
                   s_out=np.float32(s_out))


def scale_groups_v3(config: V3Config) -> List[int]:
    """Group id per block output (V2's rule): block i joins block i-1's
    group when its residual adds onto it; scales are shared per group so
    the residual add needs no rescale."""
    gids: List[int] = []
    for i, bd in enumerate(config.block_defs):
        if i > 0 and bd.has_res:
            gids.append(gids[-1])
        else:
            gids.append(gids[-1] + 1 if gids else 0)
    return gids


def _scale_of(arr: np.ndarray) -> np.float32:
    return np.float32(max(float(np.abs(arr).max()), 1e-6) / 127.0)


def calibrate_v3(folded: Dict[str, Any], config: V3Config, *,
                 n_images: int = 32, seed: int = 1234) -> Dict[str, Any]:
    """Activation scales from the fp32 oracle's taps on structured
    synthetic images. Returns {conv1, blocks: [{exp?, dw, g1?}], s_blk,
    conv_last, head} — SE's mid activation (g1) is derived host-side from
    the dw tap so the oracle needs no extra taps."""
    from ..runtime.eval import synth_images

    imgs = synth_images(config, n_images, seed)
    x = (np.stack(imgs).astype(np.float32) / 127.5) - 1.0
    _, acts = numpy_ref.forward_all_v3(folded, x, config)

    gids = scale_groups_v3(config)
    absmax = {g: 0.0 for g in gids}
    blocks: List[Dict[str, np.float32]] = []
    for i, (bd, blk) in enumerate(zip(config.block_defs, folded["blocks"])):
        ent: Dict[str, np.float32] = {}
        if bd.has_expand:
            ent["exp"] = _scale_of(acts[f"block{i:02d}_exp"])
        dw_tap = acts[f"block{i:02d}_dw"]
        ent["dw"] = _scale_of(dw_tap)
        if bd.se_mid:
            pooled = dw_tap.astype(np.float32).mean(axis=(1, 2))
            g1 = np.maximum(
                pooled @ np.asarray(blk["se"]["w1"], np.float32)
                + np.asarray(blk["se"]["b1"], np.float32), 0.0)
            ent["g1"] = _scale_of(g1)
        blocks.append(ent)
        g = gids[i]
        for tap in (f"block{i:02d}_prj", f"block{i:02d}_out"):
            if tap in acts:
                absmax[g] = max(absmax[g], float(np.abs(acts[tap]).max()))
    s_blk = [np.float32(max(absmax[g], 1e-6) / 127.0) for g in gids]
    return {
        "conv1": _scale_of(acts["conv1"]),
        "blocks": blocks,
        "s_blk": s_blk,
        "conv_last": _scale_of(acts["conv_last"]),
        "head": _scale_of(acts["head"]),
    }


@dataclasses.dataclass
class V3QuantizedParams:
    """Full quantized V3 model (weights + scales), host-side numpy."""

    conv1: QLayerN
    blocks: List[Dict[str, Any]]
    conv_last: QLayerN
    head: QLayerN
    fc_w_i8: np.ndarray
    fc_s_w: np.ndarray
    fc_b_f32: np.ndarray
    s_head: np.float32
    config: Any = None


def quantize_v3(folded: Dict[str, Any], config: V3Config, *,
                n_calib: int = 32, seed: int = 1234) -> V3QuantizedParams:
    """Fold-BN fp32 V3 pytree -> int8 model with calibrated constants."""
    cal = calibrate_v3(folded, config, n_images=n_calib, seed=seed)
    conv1 = _quant_named(folded["conv1"]["w"], folded["conv1"]["b"],
                         out_axis=3, s_in=ACT_IN_SCALE, s_out=cal["conv1"])
    blocks: List[Dict[str, Any]] = []
    s_in_blk = cal["conv1"]
    for i, (bd, blk) in enumerate(zip(config.block_defs, folded["blocks"])):
        ent: Dict[str, Any] = {}
        c = cal["blocks"][i]
        s = s_in_blk
        if bd.has_expand:
            ent["exp"] = _quant_named(blk["exp"]["w"], blk["exp"]["b"],
                                      out_axis=1, s_in=s, s_out=c["exp"])
            s = c["exp"]
        ent["dw"] = _quant_named(blk["dw"]["w"], blk["dw"]["b"], out_axis=3,
                                 s_in=s, s_out=c["dw"],
                                 k_taps=bd.kernel * bd.kernel)
        if bd.se_mid:
            # pooled rides the dw scale; w2's output lands in REAL units
            # (the hard-sigmoid needs them), so its "s_out" is 1.0.
            ent["se1"] = _quant_named(blk["se"]["w1"], blk["se"]["b1"],
                                      out_axis=1, s_in=c["dw"],
                                      s_out=c["g1"])
            ent["se2"] = _quant_named(blk["se"]["w2"], blk["se"]["b2"],
                                      out_axis=1, s_in=c["g1"], s_out=1.0)
        ent["prj"] = _quant_named(blk["prj"]["w"], blk["prj"]["b"],
                                  out_axis=1, s_in=c["dw"],
                                  s_out=cal["s_blk"][i])
        blocks.append(ent)
        s_in_blk = cal["s_blk"][i]
    conv_last = _quant_named(folded["conv_last"]["w"],
                             folded["conv_last"]["b"], out_axis=1,
                             s_in=s_in_blk, s_out=cal["conv_last"])
    head = _quant_named(folded["head"]["w"], folded["head"]["b"],
                        out_axis=1, s_in=cal["conv_last"],
                        s_out=cal["head"])
    fc_w_i8, fc_s_w = _quant_weight(
        np.asarray(folded["fc"]["w"], np.float32), out_axis=1)
    return V3QuantizedParams(
        conv1=conv1, blocks=blocks, conv_last=conv_last, head=head,
        fc_w_i8=fc_w_i8, fc_s_w=fc_s_w,
        fc_b_f32=np.asarray(folded["fc"]["b"], np.float32),
        s_head=cal["head"], config=config)


# ---------------------------------------------------------------------------
# NumPy golden twin (exact)
# ---------------------------------------------------------------------------


def _requant_named_np(acc_i32, a, inv_s, act):
    if FOLDED_REQUANT:
        if act == "hswish":
            v = acc_i32.astype(np.float32) * np.asarray(a, np.float32)
            t = np.clip(v + np.float32(3.0), 0.0, 6.0)
            q = np.rint((v * t) * (np.float32(inv_s) * np.float32(1.0 / 6.0)))
            return np.clip(q, -128, 127).astype(np.int8)
        assert act in ("relu", "linear"), act
        m = np.asarray(a, np.float32) * np.float32(inv_s)
        q = np.rint(acc_i32.astype(np.float32) * m)
        lo = 0 if act == "relu" else -128
        return np.clip(q, lo, 127).astype(np.int8)
    v = acc_i32.astype(np.float32) * np.asarray(a, np.float32)
    if act == "relu":
        v = np.maximum(v, np.float32(0.0))
    elif act == "hswish":
        g = np.clip(v + np.float32(3.0), 0.0, 6.0) * np.float32(1.0 / 6.0)
        v = v * g
    else:
        assert act == "linear", act
    q = np.rint(v * np.float32(inv_s))
    return np.clip(q, -128, 127).astype(np.int8)


def _dwk_acc_np(x_i8, w_i8, stride, k):
    lo_h, hi_h = numpy_ref.same_pad(x_i8.shape[1], stride, k)
    lo_w, hi_w = numpy_ref.same_pad(x_i8.shape[2], stride, k)
    h_out = -(-x_i8.shape[1] // stride)
    w_out = -(-x_i8.shape[2] // stride)
    xp = np.pad(x_i8.astype(np.int32),
                ((0, 0), (lo_h, hi_h), (lo_w, hi_w), (0, 0)))
    acc = np.zeros((x_i8.shape[0], h_out, w_out, x_i8.shape[3]), np.int32)
    wi = w_i8.astype(np.int32)
    for dy in range(k):
        for dx in range(k):
            acc += xp[:, dy : dy + h_out * stride : stride,
                      dx : dx + w_out * stride : stride, :] * wi[dy, dx, 0]
    return acc


def _conv3x3_acc_np(x_i8, w_i8, stride):
    lo_h, hi_h = numpy_ref.same_pad(x_i8.shape[1], stride, 3)
    lo_w, hi_w = numpy_ref.same_pad(x_i8.shape[2], stride, 3)
    h_out = -(-x_i8.shape[1] // stride)
    w_out = -(-x_i8.shape[2] // stride)
    xp = np.pad(x_i8.astype(np.int64),
                ((0, 0), (lo_h, hi_h), (lo_w, hi_w), (0, 0)))
    cout = w_i8.shape[3]
    acc = np.zeros((x_i8.shape[0], h_out, w_out, cout), np.int64)
    wi = w_i8.astype(np.int64)
    for dy in range(3):
        for dx in range(3):
            patch = xp[:, dy : dy + h_out * stride : stride,
                       dx : dx + w_out * stride : stride, :]
            acc += patch @ wi[dy, dx]
    return acc.astype(np.int32)


def _pw_acc_np(x_i8, w_i8):
    return (x_i8.astype(np.int64) @ w_i8.astype(np.int64)).astype(np.int32)


def _se_i8_np(z_i8, se1: QLayerN, se2: QLayerN):
    """Quantized SE gate: int sums/matmuls, f32 only elementwise."""
    hw = z_i8.shape[1] * z_i8.shape[2]
    sum32 = z_i8.astype(np.int32).sum(axis=(1, 2))
    pooled = np.clip(np.rint(sum32.astype(np.float32)
                             * np.float32(1.0 / hw)),
                     -128, 127).astype(np.int8)
    g1 = _requant_named_np(_pw_acc_np(pooled, se1.w_i8) + se1.bias_i32,
                           se1.a, se1.inv_s, "relu")
    acc2 = _pw_acc_np(g1, se2.w_i8) + se2.bias_i32
    v = acc2.astype(np.float32) * se2.a.astype(np.float32)  # real units
    gate = np.clip(v + np.float32(3.0), 0.0, 6.0) * np.float32(1.0 / 6.0)
    out = np.rint(z_i8.astype(np.float32) * gate[:, None, None, :])
    return np.clip(out, -128, 127).astype(np.int8)


def forward_all_v3_i8(q: V3QuantizedParams, x_i8: np.ndarray,
                      config: V3Config):
    """Full int8 golden V3 forward; layer names match the device path."""
    from .oracle import avgpool_i8, fc_i8_logits

    acts: Dict[str, np.ndarray] = {}
    c1 = q.conv1
    y = _requant_named_np(_conv3x3_acc_np(x_i8, c1.w_i8, 2) + c1.bias_i32,
                          c1.a, c1.inv_s, config.head_act)
    acts["conv1"] = y
    for i, (bd, blk) in enumerate(zip(config.block_defs, q.blocks)):
        z = y
        if bd.has_expand:
            e = blk["exp"]
            z = _requant_named_np(_pw_acc_np(z, e.w_i8) + e.bias_i32,
                                  e.a, e.inv_s, bd.act)
            acts[f"block{i:02d}_exp"] = z
        d = blk["dw"]
        z = _requant_named_np(
            _dwk_acc_np(z, d.w_i8, bd.stride, bd.kernel) + d.bias_i32,
            d.a, d.inv_s, bd.act)
        acts[f"block{i:02d}_dw"] = z
        if bd.se_mid:
            z = _se_i8_np(z, blk["se1"], blk["se2"])
            acts[f"block{i:02d}_se"] = z
        p = blk["prj"]
        out = _requant_named_np(_pw_acc_np(z, p.w_i8) + p.bias_i32,
                                p.a, p.inv_s, "linear")
        acts[f"block{i:02d}_prj"] = out
        if bd.has_res:
            out = np.clip(out.astype(np.int32) + y.astype(np.int32),
                          -128, 127).astype(np.int8)
            acts[f"block{i:02d}_out"] = out
        y = out
    cl = q.conv_last
    y = _requant_named_np(_pw_acc_np(y, cl.w_i8) + cl.bias_i32,
                          cl.a, cl.inv_s, config.head_act)
    acts["conv_last"] = y
    pooled = avgpool_i8(y)
    acts["pool"] = pooled
    hd = q.head
    h = _requant_named_np(_pw_acc_np(pooled, hd.w_i8) + hd.bias_i32,
                          hd.a, hd.inv_s, config.head_act)
    acts["head"] = h
    logits = fc_i8_logits(h, q.fc_w_i8, q.s_head, q.fc_s_w, q.fc_b_f32)
    acts["logits"] = logits
    return logits, acts


# ---------------------------------------------------------------------------
# device path (XLA route; exact twin of the oracle above)
# ---------------------------------------------------------------------------


def _as_device_tree_v3(q: V3QuantizedParams) -> Dict[str, Any]:
    import jax.numpy as jnp

    def layer(l: QLayerN):
        return {"w": jnp.asarray(l.w_i8), "b": jnp.asarray(l.bias_i32),
                "a": jnp.asarray(l.a), "inv_s": float(l.inv_s)}

    return {
        "conv1": layer(q.conv1),
        "blocks": [{k: layer(v) for k, v in blk.items()}
                   for blk in q.blocks],
        "conv_last": layer(q.conv_last),
        "head": layer(q.head),
        "fc": {"w": jnp.asarray(q.fc_w_i8), "s_w": jnp.asarray(q.fc_s_w),
               "b": jnp.asarray(q.fc_b_f32)},
        "s_head": float(q.s_head),
    }


def hsig_num(v):
    """clip(v + 3, 0, 6) on the device, equal bit for bit to the oracle's
    expression for every float32 v, with the clamp BEFORE the add: when v is
    itself a product (acc * a), a GPU backend may fuse `v + 3` with that
    multiply into one FMA, which rounds once where the oracle rounds twice
    and breaks int8 exactness. A clamp between them leaves nothing to fuse.
    (v in [-3, 3]: the same add; v > 3: both give 6; v < -3: both give 0.)"""
    import jax.numpy as jnp

    return jnp.clip(v, jnp.float32(-3.0), jnp.float32(3.0)) + jnp.float32(3.0)


def _requant_named_dev(acc_i32, a, inv_s, act):
    """Device twin of _requant_named_np; reads FOLDED_REQUANT at trace
    time (module docstring)."""
    import jax.numpy as jnp

    if FOLDED_REQUANT:
        if act == "hswish":
            v = acc_i32.astype(jnp.float32) * a.astype(jnp.float32)
            t = hsig_num(v)
            q = jnp.round(
                (v * t) * (jnp.float32(inv_s) * jnp.float32(1.0 / 6.0)))
            return jnp.clip(q, -128, 127).astype(jnp.int8)
        assert act in ("relu", "linear"), act
        m = a.astype(jnp.float32) * jnp.float32(inv_s)
        q = jnp.round(acc_i32.astype(jnp.float32) * m)
        lo = jnp.float32(0.0) if act == "relu" else -128
        return jnp.clip(q, lo, 127).astype(jnp.int8)
    v = acc_i32.astype(jnp.float32) * a.astype(jnp.float32)
    if act == "relu":
        v = jnp.maximum(v, jnp.float32(0.0))
    elif act == "hswish":
        g = hsig_num(v) * jnp.float32(1.0 / 6.0)
        v = v * g
    else:
        assert act == "linear", act
    q = jnp.round(v * jnp.float32(inv_s))  # round-half-even == np.rint
    return jnp.clip(q, -128, 127).astype(jnp.int8)


def _pw_acc_dev(x_i8, w_i8, bias_i32):
    import jax.numpy as jnp
    from jax import lax

    shp = x_i8.shape
    acc = lax.dot_general(
        x_i8.reshape(-1, shp[-1]), w_i8,
        dimension_numbers=(((1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32) + bias_i32[None, :]
    return acc.reshape(shp[:-1] + (w_i8.shape[1],))


def _dwk_acc_dev(x_i8, w_i8, stride, k):
    """k-tap f32 integer dw accumulation (exact: each product <= 127^2 is
    exact in f32 and the k^2-tap partial sums stay below 2^24 in any order;
    the depthwise_i8_xla argument, k-generalized).

    Stride 2 splits the padded input into its four (row, col) parity planes
    once, so every tap is a dense slice of one plane instead of a strided
    one: out(i,j) = sum xp[2i+dy, 2j+dx] w[dy,dx] and the plane
    (dy%2, dx%2) holds xp[2i+dy] at row i + dy//2."""
    import jax.numpy as jnp

    n, h, w, c = x_i8.shape
    h_out, w_out = -(-h // stride), -(-w // stride)
    lo_h, hi_h = numpy_ref.same_pad(h, stride, k)
    lo_w, hi_w = numpy_ref.same_pad(w, stride, k)
    wf = w_i8.astype(jnp.float32)
    if stride == 2:
        # pad rows/cols to EVEN totals so the parity reshape is legal;
        # extra zeros sit past every tap's reach
        hp, wp = h + lo_h + hi_h, w + lo_w + hi_w
        xp = jnp.pad(x_i8.astype(jnp.float32),
                     ((0, 0), (lo_h, hi_h + hp % 2),
                      (lo_w, hi_w + wp % 2), (0, 0)))
        hp, wp = hp + hp % 2, wp + wp % 2
        xr = xp.reshape(n, hp // 2, 2, wp // 2, 2, c)
        acc = jnp.zeros((n, h_out, w_out, c), jnp.float32)
        for dy in range(k):
            for dx in range(k):
                plane = xr[:, :, dy % 2, :, dx % 2, :]
                oy, ox = dy // 2, dx // 2
                acc = acc + (plane[:, oy : oy + h_out, ox : ox + w_out, :]
                             * wf[dy, dx, 0])
        return acc.astype(jnp.int32)
    xp = jnp.pad(x_i8.astype(jnp.float32),
                 ((0, 0), (lo_h, hi_h), (lo_w, hi_w), (0, 0)))
    acc = jnp.zeros((n, h_out, w_out, c), jnp.float32)
    for dy in range(k):
        for dx in range(k):
            patch = xp[:, dy : dy + h_out, dx : dx + w_out, :]
            acc = acc + patch * wf[dy, dx, 0]
    return acc.astype(jnp.int32)


def _se_acc_dev(x_i8, w_i8, bias_i32):
    """The SE gate's (N, C) x (C, Cr) integer matmul, accumulated in float32
    at HIGHEST precision: operands |v| <= 127 are exact in float32, products
    <= 127^2 too, and sums over C * 127^2 < 2^24 hold the exact integer in
    any order. On the GPU an s8 x s8 -> s32 dot this small, fused with its
    neighbours, returned wrong sums (V3-Small block 0, PERF.md); the float32
    form leaves no integer GEMM to fuse. Wider contractions keep the int8
    dot."""
    import jax.numpy as jnp
    from jax import lax

    if int(w_i8.shape[0]) * 127 * 127 >= 2 ** 24:
        return _pw_acc_dev(x_i8, w_i8, bias_i32)
    acc = jnp.dot(x_i8.astype(jnp.float32), w_i8.astype(jnp.float32),
                  precision=lax.Precision.HIGHEST)
    return acc.astype(jnp.int32) + bias_i32


def _se_i8_dev(z_i8, se1, se2):
    import jax.numpy as jnp

    hw = z_i8.shape[1] * z_i8.shape[2]
    sum32 = jnp.sum(z_i8.astype(jnp.int32), axis=(1, 2))
    pooled = jnp.clip(jnp.round(sum32.astype(jnp.float32)
                                * jnp.float32(1.0 / hw)),
                      -128, 127).astype(jnp.int8)
    g1 = _requant_named_dev(_se_acc_dev(pooled, se1["w"], se1["b"]),
                            se1["a"], se1["inv_s"], "relu")
    acc2 = _se_acc_dev(g1, se2["w"], se2["b"])
    v = acc2.astype(jnp.float32) * se2["a"].astype(jnp.float32)
    gate = hsig_num(v) * jnp.float32(1.0 / 6.0)
    out = jnp.round(z_i8.astype(jnp.float32) * gate[:, None, None, :])
    return jnp.clip(out, -128, 127).astype(jnp.int8)


def forward_v3_i8(dev: Dict[str, Any], x_q, config: V3Config, *,
                  collect: bool = False):
    """INT8 V3 forward on XLA ops. x_q: int8 at s_in = 1/127, or bfloat16
    carrying the same integers. Exactly equal to forward_all_v3_i8 per
    layer."""
    from . import ops as qops

    acts: Dict[str, Any] = {}
    c1 = dev["conv1"]
    y = _requant_named_dev(qops.conv3x3_s2_acc(x_q, c1["w"]) + c1["b"],
                           c1["a"], c1["inv_s"], config.head_act)
    if collect:
        acts["conv1"] = y

    for i, (bd, blk) in enumerate(zip(config.block_defs, dev["blocks"])):
        y = block_v3_i8(blk, y, bd, acts if collect else None,
                        f"block{i:02d}")
    cl = dev["conv_last"]
    y = _requant_named_dev(_pw_acc_dev(y, cl["w"], cl["b"]),
                           cl["a"], cl["inv_s"], config.head_act)
    if collect:
        acts["conv_last"] = y
    pooled = qops.avgpool_i8(y)
    if collect:
        acts["pool"] = pooled
    hd = dev["head"]
    h = _requant_named_dev(_pw_acc_dev(pooled, hd["w"], hd["b"]),
                           hd["a"], hd["inv_s"], config.head_act)
    if collect:
        acts["head"] = h
    logits = qops.fc_i8_logits(h, dev["fc"]["w"], dev["s_head"],
                               dev["fc"]["s_w"], dev["fc"]["b"])
    if collect:
        acts["logits"] = logits
        return logits, acts
    return logits


# ---------------------------------------------------------------------------
# verify gate + pipeline adapters
# ---------------------------------------------------------------------------


def block_v3_i8(blk, y, bd, acts: Optional[Dict[str, Any]] = None,
                name: str = ""):
    """One int8 V3 bottleneck on XLA ops (device twin of the oracle's
    block): expand (when present), dw kxk, quantized SE (when present),
    linear projection, saturating residual add. `acts` collects the taps
    {name}_exp/_dw/_se/_prj/_out."""
    import jax.numpy as jnp

    def tap(kind, v):
        if acts is not None:
            acts[f"{name}_{kind}"] = v

    z = y
    if bd.has_expand:
        e = blk["exp"]
        z = _requant_named_dev(_pw_acc_dev(z, e["w"], e["b"]),
                               e["a"], e["inv_s"], bd.act)
        tap("exp", z)
    d = blk["dw"]
    z = _requant_named_dev(
        _dwk_acc_dev(z, d["w"], bd.stride, bd.kernel) + d["b"],
        d["a"], d["inv_s"], bd.act)
    tap("dw", z)
    if bd.se_mid:
        z = _se_i8_dev(z, blk["se1"], blk["se2"])
        tap("se", z)
    p = blk["prj"]
    out = _requant_named_dev(_pw_acc_dev(z, p["w"], p["b"]),
                             p["a"], p["inv_s"], "linear")
    tap("prj", out)
    if bd.has_res:
        out = jnp.clip(out.astype(jnp.int32) + y.astype(jnp.int32),
                       -128, 127).astype(jnp.int8)
        tap("out", out)
    return out


def verify_int8_v3(config: V3Config, folded: Dict[str, Any],
                   x_f32: np.ndarray, *, n_calib: int = 32) -> bool:
    """Per-layer EXACT-equality gate: device int8 V3 vs the NumPy oracle.
    int8 taps must be bit-identical; float taps (logits) within 1e-5."""
    import jax.numpy as jnp

    from .quantize import quantize_input

    q = quantize_v3(folded, config, n_calib=n_calib)
    x_i8 = quantize_input(x_f32)
    _, ref = forward_all_v3_i8(q, x_i8, config)
    dev = _as_device_tree_v3(q)
    _, acts = forward_v3_i8(dev, jnp.asarray(x_i8), config, collect=True)
    ok = True
    for name, r in ref.items():
        a = np.asarray(acts[name])
        if r.dtype == np.int8:
            n_bad = int((a != r).sum())
            good = n_bad == 0
            print(f"[{'OK ' if good else 'FAIL'}] {name:<14} "
                  f"int8 exact: {'equal' if good else f'{n_bad} mismatches'}")
        else:
            err = float(np.abs(a - r).max())
            good = err < 1e-5
            print(f"[{'OK ' if good else 'FAIL'}] {name:<14} "
                  f"max_abs={err:.2e}")
        ok = ok and good
    if ok:
        print(f"VERIFY OK: all {len(ref)} layers EXACT "
              f"(int8 numpy oracle, {config.variant_name()})")
    return ok


def make_int8_infer_v3(q: V3QuantizedParams, config: V3Config):
    """Compiled int8 V3 entry: uint8 images -> float32 logits."""
    import jax
    import jax.numpy as jnp

    from ..ops import preprocess as prep
    from . import ops as qops

    dev = _as_device_tree_v3(q)

    def infer(images_u8):
        x = prep.preprocess(images_u8, config.resolution, jnp.float32)
        x_q = qops.quantize_input_dev(x, ACT_IN_SCALE)
        return forward_v3_i8(dev, x_q, config)

    return jax.jit(infer), dev


class Int8PipelineV3:
    """Pipeline-shaped adapter over the int8 V3 network (run_batch(uint8)
    -> probs + .config — the V3 twin of Int8PipelineV2, incl. optional
    data-parallel sharding via jit propagation)."""

    def __init__(self, config: V3Config, *, seed: int = 0, params=None,
                 mesh=None):
        import jax
        import jax.numpy as jnp

        from ..checkpoints import default_folded
        from ..ops import preprocess as prep
        from . import ops as qops

        self.config = config
        if mesh is not None:
            from ..runtime.pipeline import _require_dp_only_mesh

            _require_dp_only_mesh(mesh)
        self.mesh = mesh
        folded = params if params is not None else default_folded(
            config, seed=seed)
        self.q = quantize_v3(folded, config)
        dev = _as_device_tree_v3(self.q)
        self._in_sharding = None
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            from ..parallel.mesh import DATA_AXIS

            dev = jax.tree.map(
                lambda a: (jax.device_put(jnp.asarray(a),
                                          NamedSharding(mesh, P()))
                           if hasattr(a, "dtype") else a), dev)
            self._in_sharding = NamedSharding(mesh, P(DATA_AXIS))
        self._dev = dev
        cfg = config

        def probs(images_u8):
            x = prep.preprocess(images_u8, cfg.resolution, jnp.float32)
            x_q = qops.quantize_input_dev(x, ACT_IN_SCALE)
            logits = forward_v3_i8(dev, x_q, cfg)
            return jax.nn.softmax(logits, axis=-1)

        self._probs = jax.jit(probs)

    def run_batch(self, images_u8):
        import jax
        import jax.numpy as jnp

        imgs = jnp.asarray(images_u8)
        if self._in_sharding is not None:
            imgs = jax.device_put(imgs, self._in_sharding)
        return np.asarray(self._probs(imgs))
