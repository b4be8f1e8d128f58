"""INT8 MobileNet-V2: quantization, exact NumPy oracle, and device forward.

V1's fixed-point scheme (quantize.py) leans on ReLU6 bounding every hidden
activation, which fixes every activation scale at 6/127 with no data
calibration — exactly like the reference FPGA's compile-time formats. V2
breaks that assumption in one place: the bottleneck PROJECTION is LINEAR
(unbounded, signed) and feeds residual adds. The scheme here extends V1's
minimally:

  - every ReLU6 activation (conv1, expansion, dw, conv_last) keeps the
    fixed 6/127 scale — same constants, same requant arithmetic as V1;
  - bottleneck activations get per-SCALE-GROUP calibrated symmetric scales:
    a scale group is a residual-connected run (the producer block plus
    every block whose residual adds onto it — same Cout, stride 1), and
    its scale is absmax/127 over ALL the group's projection and post-add
    activations on a deterministic structured calibration set
    (runtime.eval.synth_images — the eval-gate families). Sharing one
    scale per group makes the residual a plain saturating int8 add:
    out_i8 = clamp(requant(prj_acc) + y_i8), exact on both paths.
  - projection requant is LINEAR: v = f32(acc)*m; round-half-even;
    clamp [-128, 127]. No ReLU, no six_q.

As with V1, all scale arithmetic happens host-side in float32 and the
device path, the NumPy oracle here, and any kernel twin share the
constants verbatim, so the acceptance gate is EXACT equality per layer
(the int8 analog of BASELINE.json:5's bit-match contract).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np

from ..models.mobilenet_v2 import V2Config
from ..oracle import numpy_ref
from .quantize import (ACT_HIDDEN_SCALE, ACT_IN_SCALE, QuantLayer,
                       _quant_layer, _quant_weight)


# ---------------------------------------------------------------------------
# calibration + quantization (host side)
# ---------------------------------------------------------------------------

def scale_groups(config: V2Config) -> List[int]:
    """Group id per block OUTPUT (len 17). Block i joins block i-1's group
    when its residual adds onto it (stride 1, Cin == Cout); otherwise it
    starts a new group. Scales are shared within a group so the residual
    add needs no rescale."""
    gids: List[int] = []
    for i, (t, cin, cout, stride) in enumerate(config.block_defs):
        if i > 0 and stride == 1 and cin == cout:
            gids.append(gids[-1])
        else:
            gids.append(gids[-1] + 1 if gids else 0)
    return gids


def calibrate_v2(folded: Dict[str, Any], config: V2Config, *,
                 n_images: int = 32, seed: int = 1234) -> List[np.float32]:
    """Per-block bottleneck output scales from the fp32 oracle's taps on
    structured synthetic images. Returns s_blk (len 17), group-shared."""
    from ..runtime.eval import synth_images

    imgs = synth_images(config, n_images, seed)
    x = (np.stack(imgs).astype(np.float32) / 127.5) - 1.0
    _, acts = numpy_ref.forward_all_v2(folded, x, config)
    gids = scale_groups(config)
    absmax = {g: 0.0 for g in gids}
    for i, g in enumerate(gids):
        for tap in (f"block{i:02d}_prj", f"block{i:02d}_out"):
            if tap in acts:
                absmax[g] = max(absmax[g], float(np.abs(acts[tap]).max()))
    return [np.float32(max(absmax[g], 1e-6) / 127.0) for g in gids]


@dataclasses.dataclass
class V2QuantizedParams:
    """Full quantized V2 model (weights + scales), host-side numpy."""

    conv1: QuantLayer
    blocks: List[Dict[str, QuantLayer]]
    conv_last: QuantLayer
    fc_w_i8: np.ndarray
    fc_s_w: np.ndarray
    fc_b_f32: np.ndarray
    s_blk: List[np.float32]  # bottleneck scale per block output
    config: Any = None


def quantize_v2(folded: Dict[str, Any], config: V2Config, *,
                n_calib: int = 32, seed: int = 1234) -> V2QuantizedParams:
    """Fold-BN fp32 V2 pytree -> int8 model with per-layer requant
    constants. The projection layers' `m` maps the int32 accumulator to
    the calibrated group scale; their `six_q` is unused (linear)."""
    s_blk = calibrate_v2(folded, config, n_images=n_calib, seed=seed)
    conv1 = _quant_layer(folded["conv1"]["w"], folded["conv1"]["b"],
                         out_axis=3, s_in=ACT_IN_SCALE,
                         s_out=ACT_HIDDEN_SCALE)
    blocks: List[Dict[str, QuantLayer]] = []
    s_in_blk = ACT_HIDDEN_SCALE  # block 0's dw consumes conv1's output
    for i, blk in enumerate(folded["blocks"]):
        qblk: Dict[str, QuantLayer] = {}
        if "exp" in blk:
            qblk["exp"] = _quant_layer(blk["exp"]["w"], blk["exp"]["b"],
                                       out_axis=1, s_in=s_in_blk,
                                       s_out=ACT_HIDDEN_SCALE)
        qblk["dw"] = _quant_layer(blk["dw"]["w"], blk["dw"]["b"], out_axis=3,
                                  s_in=ACT_HIDDEN_SCALE,
                                  s_out=ACT_HIDDEN_SCALE,
                                  f32_bias_bound=True)
        qblk["prj"] = _quant_layer(blk["prj"]["w"], blk["prj"]["b"],
                                   out_axis=1, s_in=ACT_HIDDEN_SCALE,
                                   s_out=s_blk[i])
        blocks.append(qblk)
        s_in_blk = s_blk[i]
    conv_last = _quant_layer(folded["conv_last"]["w"],
                             folded["conv_last"]["b"], out_axis=1,
                             s_in=s_in_blk, s_out=ACT_HIDDEN_SCALE)
    fc_w_i8, fc_s_w = _quant_weight(
        np.asarray(folded["fc"]["w"], np.float32), out_axis=1)
    return V2QuantizedParams(
        conv1=conv1, blocks=blocks, conv_last=conv_last,
        fc_w_i8=fc_w_i8, fc_s_w=fc_s_w,
        fc_b_f32=np.asarray(folded["fc"]["b"], np.float32),
        s_blk=s_blk, config=config,
    )


# ---------------------------------------------------------------------------
# NumPy golden twin (exact)
# ---------------------------------------------------------------------------

def _requant_linear(acc_i32: np.ndarray, m: np.ndarray) -> np.ndarray:
    """Signed linear requant: no ReLU, round-half-even, clamp [-128, 127]."""
    v = acc_i32.astype(np.float32) * m.astype(np.float32)
    return np.clip(np.rint(v), -128, 127).astype(np.int8)


def _res_add(prj_i8: np.ndarray, y_i8: np.ndarray) -> np.ndarray:
    """Saturating int8 residual add (operands share one group scale)."""
    return np.clip(prj_i8.astype(np.int32) + y_i8.astype(np.int32),
                   -128, 127).astype(np.int8)


def pw_i8_linear(x, w, bias_i32, m):
    acc = x.astype(np.int64) @ w.astype(np.int64)
    return _requant_linear(acc.astype(np.int32) + bias_i32, m)


def forward_all_v2_i8(q: V2QuantizedParams, x_i8: np.ndarray,
                      config: V2Config):
    """Full int8 golden V2 forward; layer names match the device path."""
    from .oracle import avgpool_i8, conv3x3_i8, dw3x3_i8, fc_i8_logits, pw_i8

    relu6 = config.relu6
    acts: Dict[str, np.ndarray] = {}
    c1 = q.conv1
    y = conv3x3_i8(x_i8, c1.w_i8, c1.bias_i32, c1.m, c1.six_q, 2, relu6)
    acts["conv1"] = y
    for i, ((t, cin, cout, stride), blk) in enumerate(
            zip(config.block_defs, q.blocks)):
        z = y
        if "exp" in blk:
            e = blk["exp"]
            z = pw_i8(z, e.w_i8, e.bias_i32, e.m, e.six_q, relu6)
            acts[f"block{i:02d}_exp"] = z
        d = blk["dw"]
        z = dw3x3_i8(z, d.w_i8, d.bias_i32, d.m, d.six_q, stride, relu6)
        acts[f"block{i:02d}_dw"] = z
        p = blk["prj"]
        out = pw_i8_linear(z, p.w_i8, p.bias_i32, p.m)
        acts[f"block{i:02d}_prj"] = out
        if stride == 1 and cin == cout:
            out = _res_add(out, y)
            acts[f"block{i:02d}_out"] = out
        y = out
    cl = q.conv_last
    y = pw_i8(y, cl.w_i8, cl.bias_i32, cl.m, cl.six_q, relu6)
    acts["conv_last"] = y
    pooled = avgpool_i8(y)
    acts["pool"] = pooled
    logits = fc_i8_logits(pooled, q.fc_w_i8, ACT_HIDDEN_SCALE, q.fc_s_w,
                          q.fc_b_f32)
    acts["logits"] = logits
    return logits, acts


# ---------------------------------------------------------------------------
# device path (XLA route; exact twin of the oracle above)
# ---------------------------------------------------------------------------

def _as_device_tree_v2(q: V2QuantizedParams) -> Dict[str, Any]:
    import jax.numpy as jnp

    def layer(l: QuantLayer):
        return {"w": jnp.asarray(l.w_i8), "b": jnp.asarray(l.bias_i32),
                "m": jnp.asarray(l.m), "six_q": float(l.six_q)}

    return {
        "conv1": layer(q.conv1),
        "blocks": [{k: layer(v) for k, v in blk.items()} for blk in q.blocks],
        "conv_last": layer(q.conv_last),
        "fc": {"w": jnp.asarray(q.fc_w_i8), "s_w": jnp.asarray(q.fc_s_w),
               "b": jnp.asarray(q.fc_b_f32)},
    }


def forward_v2_i8(dev: Dict[str, Any], x_i8, config: V2Config, *,
                  collect: bool = False):
    """INT8 V2 forward on XLA ops: int8 matmuls + exact-integer dw taps.

    x_i8: int8 at s_in = 1/127, or bfloat16 carrying the same integers
    (quantize_input_dev). Exactly equal to forward_all_v2_i8 per layer and
    at the logits.
    """
    from . import ops as qops

    relu6 = config.relu6
    acts: Dict[str, Any] = {}
    c1 = dev["conv1"]
    y = qops.conv1_i8(x_i8, c1["w"], c1["b"], c1["m"], c1["six_q"], relu6)
    if collect:
        acts["conv1"] = y
    for i, ((t, cin, cout, stride), blk) in enumerate(
            zip(config.block_defs, dev["blocks"])):
        y = block_v2_i8(blk, y, stride, stride == 1 and cin == cout, relu6,
                        acts if collect else None, f"block{i:02d}")
    cl = dev["conv_last"]
    y = qops.pointwise_i8(y, cl["w"], cl["b"], cl["m"], cl["six_q"], relu6)
    if collect:
        acts["conv_last"] = y
    pooled = qops.avgpool_i8(y)
    if collect:
        acts["pool"] = pooled
    logits = qops.fc_i8_logits(pooled, dev["fc"]["w"], ACT_HIDDEN_SCALE,
                               dev["fc"]["s_w"], dev["fc"]["b"])
    if collect:
        acts["logits"] = logits
        return logits, acts
    return logits


def block_v2_i8(blk, y, stride: int, has_res: bool, relu6: bool = True,
                acts: Optional[Dict[str, Any]] = None, name: str = ""):
    """One int8 bottleneck on XLA ops (device twin of the oracle's block):
    expand (when present), dw, linear projection, saturating residual add.
    `acts` collects the taps {name}_exp/_dw/_prj/_out."""
    import jax.numpy as jnp

    from . import ops as qops

    def tap(kind, v):
        if acts is not None:
            acts[f"{name}_{kind}"] = v

    z = y
    if "exp" in blk:
        e = blk["exp"]
        z = qops.pointwise_i8(z, e["w"], e["b"], e["m"], e["six_q"], relu6)
        tap("exp", z)
    d = blk["dw"]
    z = qops.depthwise_i8_xla(z, d["w"], d["b"], d["m"], d["six_q"], stride,
                              relu6)
    tap("dw", z)
    p = blk["prj"]
    out = _pw_i8_linear_dev(z, p["w"], p["b"], p["m"])
    tap("prj", out)
    if has_res:
        out = jnp.clip(out.astype(jnp.int32) + y.astype(jnp.int32),
                       -128, 127).astype(jnp.int8)
        tap("out", out)
    return out


def _pw_i8_linear_dev(x_i8, w_i8, bias_i32, m):
    """Linear pointwise requant (device twin of pw_i8_linear)."""
    import jax.numpy as jnp
    from jax import lax

    n, h, w, cin = x_i8.shape
    cout = w_i8.shape[1]
    acc = lax.dot_general(
        x_i8.reshape(n * h * w, cin), w_i8,
        dimension_numbers=(((1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32,
    ) + bias_i32[None, :]
    v = acc.astype(jnp.float32) * m.astype(jnp.float32)
    out = jnp.clip(jnp.round(v), -128, 127).astype(jnp.int8)
    return out.reshape(n, h, w, cout)


def verify_int8_v2(config: V2Config, folded: Dict[str, Any],
                   x_f32: np.ndarray, *, n_calib: int = 32) -> bool:
    """Per-layer EXACT-equality gate: device int8 V2 vs the NumPy oracle.
    int8 outputs must be bit-identical; float taps (logits) within 1e-5.
    (cpu_ref has no int8 V2 twin — the V1 int8 C++ oracle pins the requant
    semantics these paths share verbatim; documented in the module doc.)"""
    import jax.numpy as jnp

    from .quantize import quantize_input

    q = quantize_v2(folded, config, n_calib=n_calib)
    x_i8 = quantize_input(x_f32)
    _, ref = forward_all_v2_i8(q, x_i8, config)
    dev = _as_device_tree_v2(q)
    _, acts = forward_v2_i8(dev, jnp.asarray(x_i8), config, collect=True)
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
            print(f"[{'OK ' if good else 'FAIL'}] {name:<14} max_abs={err:.2e}")
        ok = ok and good
    if ok:
        print(f"VERIFY OK: all {len(ref)} layers EXACT (int8 numpy oracle, v2)")
    return ok


def make_int8_infer_v2(q: V2QuantizedParams, config: V2Config):
    """Compiled int8 V2 entry: uint8 images -> float32 logits (preprocess +
    input quantization fused into the program, mirroring make_int8_infer)."""
    import jax
    import jax.numpy as jnp

    from ..ops import preprocess as prep
    from . import ops as qops

    dev = _as_device_tree_v2(q)

    def infer(images_u8):
        x = prep.preprocess(images_u8, config.resolution, jnp.float32)
        x_q = qops.quantize_input_dev(x, ACT_IN_SCALE)
        return forward_v2_i8(dev, x_q, config)

    return jax.jit(infer), dev


class Int8PipelineV2:
    """Pipeline-shaped adapter over the int8 V2 network: the same
    `run_batch(uint8) -> probs` + `.config` surface MicroBatchServer needs
    (the V2 twin of quant.model.Int8Pipeline). With `mesh`, the batch shards
    over its 'data' axis — the int8 V2 route is pure XLA ops, so jit's
    sharding propagation partitions it with no shard_map plumbing; the
    quantized constants are replicated like the float pipeline's weights."""

    def __init__(self, config: V2Config, *, seed: int = 0, params=None,
                 mesh=None):
        import jax
        import jax.numpy as jnp

        from ..checkpoints.v2 import fold_bn_v2, init_params_v2
        from ..ops import preprocess as prep
        from . import ops as qops

        self.config = config
        if mesh is not None:
            from ..runtime.pipeline import _require_dp_only_mesh

            _require_dp_only_mesh(mesh)
        self.mesh = mesh
        folded = params if params is not None else fold_bn_v2(
            init_params_v2(config, seed=seed), eps=config.bn_eps)
        self.q = quantize_v2(folded, config)
        dev = _as_device_tree_v2(self.q)
        self._in_sharding = None
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            from ..parallel.mesh import DATA_AXIS

            dev = jax.tree.map(
                lambda a: jax.device_put(jnp.asarray(a),
                                         NamedSharding(mesh, P())), dev)
            self._in_sharding = NamedSharding(mesh, P(DATA_AXIS))
        self._dev = dev
        cfg = config

        def probs(images_u8):
            x = prep.preprocess(images_u8, cfg.resolution, jnp.float32)
            x_q = qops.quantize_input_dev(x, ACT_IN_SCALE)
            logits = forward_v2_i8(dev, x_q, cfg)
            return jax.nn.softmax(logits, axis=-1)

        self._probs = jax.jit(probs)

    def run_batch(self, images_u8):
        import jax
        import jax.numpy as jnp

        imgs = jnp.asarray(images_u8)
        if self._in_sharding is not None:
            imgs = jax.device_put(imgs, self._in_sharding)
        return np.asarray(self._probs(imgs))
