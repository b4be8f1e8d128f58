"""MobileNet-V3 (Large/Small/minimalistic): the third model family.

The reference implements MobileNet-V1 only; V3 (Howard et al. 2019,
arXiv:1905.02244) completes the MobileNet line on the same ops:
inverted residuals with squeeze-excite gates, mixed 3x3/5x5 depthwise
kernels, and the hard-swish family of activations. Layer schedule verified
against the on-disk keras source, the same citation style as V1/V2:
/opt/venv/.../keras/src/applications/mobilenet_v3.py — stacks at :421-452
(Small) / :488-519 (Large), `_depth` at :561-568, `_se_block` at :571-590,
`_inverted_res_block` at :593-661, activations at :542-553, stem/head in
MobileNetV3 at :313-372.

Every block runs on XLA: expand/project as matmuls with fused epilogues,
the grouped depthwise conv (k in {3,5}), and SE as a (N,C)x(C,Cr) matmul
pair around a global pool.

Padding note: keras pads stride-2 dw convs explicitly (correct_pad +
valid); at EVEN input sizes that equals TF 'SAME', and resolution % 32 == 0
guarantees even inputs at every stride-2 point — so SAME everywhere here,
bit-matching keras semantics for every legal resolution.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp

from ..ops import conv as ops
from .mobilenet_v2 import make_divisible  # bit-identical to keras _depth

# Per-block rows: (exp_ratio, cout_base, kernel, stride, se, act) where
# kernel is "k" for the config-dependent late kernel (5, or 3 when
# minimalistic) and act "hs" degrades to "relu" when minimalistic.
# keras mobilenet_v3.py:488-519 (Large) / :421-452 (Small).
V3_LARGE_ROWS: Tuple[Tuple[float, int, str, int, bool, str], ...] = (
    (1.0, 16, "3", 1, False, "relu"),
    (4.0, 24, "3", 2, False, "relu"),
    (3.0, 24, "3", 1, False, "relu"),
    (3.0, 40, "k", 2, True, "relu"),
    (3.0, 40, "k", 1, True, "relu"),
    (3.0, 40, "k", 1, True, "relu"),
    (6.0, 80, "3", 2, False, "hs"),
    (2.5, 80, "3", 1, False, "hs"),
    (2.3, 80, "3", 1, False, "hs"),
    (2.3, 80, "3", 1, False, "hs"),
    (6.0, 112, "3", 1, True, "hs"),
    (6.0, 112, "3", 1, True, "hs"),
    (6.0, 160, "k", 2, True, "hs"),
    (6.0, 160, "k", 1, True, "hs"),
    (6.0, 160, "k", 1, True, "hs"),
)
V3_SMALL_ROWS: Tuple[Tuple[float, int, str, int, bool, str], ...] = (
    (1.0, 16, "3", 2, True, "relu"),
    (72.0 / 16, 24, "3", 2, False, "relu"),
    (88.0 / 24, 24, "3", 1, False, "relu"),
    (4.0, 40, "k", 2, True, "hs"),
    (6.0, 40, "k", 1, True, "hs"),
    (6.0, 40, "k", 1, True, "hs"),
    (3.0, 48, "k", 1, True, "hs"),
    (3.0, 48, "k", 1, True, "hs"),
    (6.0, 96, "k", 2, True, "hs"),
    (6.0, 96, "k", 1, True, "hs"),
    (6.0, 96, "k", 1, True, "hs"),
)

SE_RATIO = 0.25  # keras mobilenet_v3.py:311


@dataclasses.dataclass(frozen=True)
class V3BlockDef:
    """Fully resolved static block shape (all channels alpha-scaled)."""

    cin: int
    cexp: int          # expansion channels: _depth(cin * exp_ratio)
    cout: int
    kernel: int        # 3 or 5
    stride: int
    se_mid: int        # 0 = no SE; else _depth(cexp * 0.25)
    act: str           # "relu" | "hswish"
    has_expand: bool   # block 0 has no expand conv (keras :602 `if block_id`)

    @property
    def has_res(self) -> bool:
        return self.stride == 1 and self.cin == self.cout


@dataclasses.dataclass(frozen=True)
class V3Config:
    """Static description of one MobileNet-V3 variant (frozen + hashable,
    the one-bitstream-per-config analog, like ModelConfig / V2Config)."""

    variant: str = "large"          # "large" | "small"
    alpha: float = 1.0
    resolution: int = 224
    minimalistic: bool = False      # kernel 3 / relu / no SE (keras :305-311)
    num_classes: int = 1000
    bn_eps: float = 1e-3
    compute_dtype: str = "float32"

    def __post_init__(self):
        if self.variant not in ("large", "small"):
            raise ValueError(f"variant must be large|small, got {self.variant}")
        if self.resolution % 32 != 0:
            raise ValueError(
                f"resolution must be divisible by 32, got {self.resolution} "
                "(guarantees even inputs at every stride-2 point, where "
                "keras's explicit padding equals SAME)")
        if self.alpha <= 0:
            raise ValueError(f"alpha must be positive, got {self.alpha}")

    @property
    def stem_channels(self) -> int:
        return 16  # fixed, NOT alpha-scaled (keras :316 Conv2D(16, ...))

    @property
    def block_defs(self) -> Tuple[V3BlockDef, ...]:
        rows = V3_LARGE_ROWS if self.variant == "large" else V3_SMALL_ROWS
        late_k = 3 if self.minimalistic else 5
        out = []
        cin = self.stem_channels
        for i, (t, c_base, k, stride, se, act) in enumerate(rows):
            cexp = make_divisible(cin * t)
            cout = make_divisible(c_base * self.alpha)
            se_on = se and not self.minimalistic
            out.append(V3BlockDef(
                cin=cin,
                cexp=cexp,
                cout=cout,
                kernel=late_k if k == "k" else 3,
                stride=stride,
                se_mid=make_divisible(cexp * SE_RATIO) if se_on else 0,
                act="relu" if (act == "relu" or self.minimalistic) else "hswish",
                has_expand=i > 0,
            ))
            cin = cout
        return tuple(out)

    @property
    def last_conv_channels(self) -> int:
        # _depth(last_block_out * 6), keras :330
        return make_divisible(self.block_defs[-1].cout * 6)

    @property
    def last_point_channels(self) -> int:
        base = 1280 if self.variant == "large" else 1024
        if self.alpha > 1.0:  # keras :335-336
            return make_divisible(base * self.alpha)
        return base

    @property
    def head_act(self) -> str:
        return "relu" if self.minimalistic else "hswish"

    @property
    def final_spatial(self) -> int:
        return self.resolution // 32

    def variant_name(self) -> str:
        mini = "min_" if self.minimalistic else ""
        return f"mobilenet_v3_{self.variant}_{mini}{self.alpha:g}_{self.resolution}"


def se_apply(z: jax.Array, se: Dict[str, Any]) -> jax.Array:
    """Squeeze-excite gate (keras _se_block :571-590): global pool ->
    1x1 conv(+bias)+relu -> 1x1 conv(+bias)+hard_sigmoid -> scale.
    The two convs act on a (N, C) vector — matmuls at the stack's
    precision discipline (HIGHEST for fp32: a default-precision f32 matmul
    may run in TF32 or bf16 passes, which would blow the V3_TOL gate at K
    up to 960)."""
    from ..ops.conv import _precision  # noqa: PLC0415

    prec = _precision(z)
    pooled = jnp.mean(z.astype(jnp.float32), axis=(1, 2)).astype(z.dtype)
    g = jnp.dot(pooled, se["w1"].astype(z.dtype), precision=prec,
                preferred_element_type=jnp.float32) + se["b1"].astype(
                    jnp.float32)
    g = jnp.maximum(g, 0.0)
    g = jnp.dot(g.astype(z.dtype), se["w2"].astype(z.dtype), precision=prec,
                preferred_element_type=jnp.float32) + se["b2"].astype(
                    jnp.float32)
    g = ops.apply_act_named(g, "hsigmoid").astype(z.dtype)
    return z * g[:, None, None, :]


def head_matmul(pooled: jax.Array, head: Dict[str, Any],
                act: str) -> jax.Array:
    """Post-pool head conv_2 as a precision-disciplined matmul
    (keras :345-356; shared with the pp stage body)."""
    from ..ops.conv import _precision  # noqa: PLC0415

    h = jnp.dot(pooled, head["w"].astype(pooled.dtype),
                precision=_precision(pooled),
                preferred_element_type=jnp.float32) + head["b"].astype(
                    jnp.float32)
    return ops.apply_act_named(h, act).astype(pooled.dtype)


def forward_v3(
    params: Dict[str, Any],
    x: jax.Array,
    config: V3Config,
    *,
    collect: bool = False,
) -> Any:
    """Run MobileNet-V3 on a folded-BN params pytree (checkpoints.v3).

    x: (N, H, W, 3) preprocessed images in [-1, 1] (keras Rescaling
    1/127.5 - 1, :313-315 — the same TF normalization as V1/V2).

    collect=True returns (logits, {name: activation}) with per-layer oracle
    taps: conv1, block{i:02d}_exp/_dw/_se/_prj/_out, conv_last, pool, head,
    logits.
    """
    acts: Dict[str, jax.Array] = {}

    y = ops.conv2d_same(x, params["conv1"]["w"], 2,
                        bias=params["conv1"]["b"], act=config.head_act)
    if collect:
        acts["conv1"] = y

    y = run_blocks_v3(params, y, config, acts=acts if collect else None)
    y = ops.pointwise_conv(y, params["conv_last"]["w"],
                           bias=params["conv_last"]["b"], act=config.head_act)
    if collect:
        acts["conv_last"] = y
    pooled = ops.global_avg_pool(y)
    if collect:
        acts["pool"] = pooled
    # Head conv_2 runs AFTER the pool on a (N, C) vector (keras :345-356):
    # 1x1 conv with bias (no BN) + activation — a matmul at the
    # stack's precision discipline (fp32 -> HIGHEST, like ops.conv.fc).
    h = head_matmul(pooled, params["head"], config.head_act)
    if collect:
        acts["head"] = h
    logits = ops.fc(h, params["fc"]["w"], params["fc"]["b"])
    if collect:
        acts["logits"] = logits
        return logits, acts
    return logits


def run_blocks_v3(params, y, config: V3Config, *,
                  start: int = 0, stop: Optional[int] = None,
                  acts: Optional[Dict[str, Any]] = None) -> jax.Array:
    """Run V3 bottlenecks [start, stop) on activation `y` — forward_v3's
    block loop, exposed for stage-partitioned runners (parallel/pp.py)."""
    stop = len(config.block_defs) if stop is None else stop
    for i in range(start, stop):
        y = bottleneck(params["blocks"][i], y, config.block_defs[i], acts,
                       f"block{i:02d}")
    return y


def bottleneck(blk, y, bd: V3BlockDef,
               acts: Optional[Dict[str, Any]] = None,
               name: str = "") -> jax.Array:
    """One V3 bottleneck: expand (when present), dw kxk, SE (when present),
    linear projection, residual. `acts` collects the taps
    {name}_exp/_dw/_se/_prj/_out."""
    def tap(kind, v):
        if acts is not None:
            acts[f"{name}_{kind}"] = v

    z = y
    if bd.has_expand:
        z = ops.pointwise_conv(z, blk["exp"]["w"], bias=blk["exp"]["b"],
                               act=bd.act)
        tap("exp", z)
    z = ops.depthwise_conv_xla(z, blk["dw"]["w"], bd.stride,
                               bias=blk["dw"]["b"], act=bd.act)
    tap("dw", z)
    if bd.se_mid:
        z = se_apply(z, blk["se"])
        tap("se", z)
    out = ops.pointwise_conv(z, blk["prj"]["w"], bias=blk["prj"]["b"])
    tap("prj", out)
    if bd.has_res:
        out = out + y
        tap("out", out)
    return out


def predict_probs_v3(params, x, config: V3Config) -> jax.Array:
    return jax.nn.softmax(
        forward_v3(params, x, config).astype(jnp.float32), axis=-1)


def predict_probs_v3_u8(params, images_u8, config: V3Config, *,
                        dtype=jnp.float32) -> jax.Array:
    """uint8 NHWC at any size -> probs (device resize/normalize, like V1)."""
    from ..ops import preprocess as prep  # noqa: PLC0415

    x = prep.preprocess(images_u8, config.resolution, dtype)
    return predict_probs_v3(params, x, config)
