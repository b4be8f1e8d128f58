"""MobileNet-V2: the second model family, built on the same ops.

The reference implements MobileNet-V1 only; V2 (Sandler et al. 2018,
inverted residuals + linear bottlenecks) demonstrates that the framework's
kernels, oracles, runtime, and parallelism generalize beyond one network.
Layer schedule verified against keras applications/mobilenet_v2.py (the
(t, c, n, s) table at :96-110, `_make_divisible` at :505-513) — the same
citation style as config.py's V1 table.

Every block runs on XLA: expand 1x1 as a matmul with a fused bias+ReLU6
epilogue (ops.conv.pointwise_conv), the grouped depthwise conv, a linear
projection matmul, and the residual add.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp

from ..ops import conv as ops

# (expansion t, base channels c, repeats n, first stride s) —
# keras mobilenet_v2.py:96-110 / the paper's Table 2.
V2_T_C_N_S: Tuple[Tuple[int, int, int, int], ...] = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)

V2_ALPHAS = (0.35, 0.5, 0.75, 1.0, 1.3, 1.4)  # keras pretrained grid


def make_divisible(v: float, divisor: int = 8,
                   min_value: Optional[int] = None) -> int:
    """Channel rounding, bit-for-bit the keras/TF `_make_divisible`."""
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


@dataclasses.dataclass(frozen=True)
class V2Config:
    """Static description of one MobileNet-V2 variant (frozen + hashable,
    the one-bitstream-per-config analog — same contract as V1's
    ModelConfig)."""

    alpha: float = 1.0
    resolution: int = 224
    num_classes: int = 1000
    bn_eps: float = 1e-3
    compute_dtype: str = "float32"

    def __post_init__(self):
        if self.alpha not in V2_ALPHAS:
            raise ValueError(f"alpha must be one of {V2_ALPHAS}, got {self.alpha}")
        if self.resolution % 32 != 0:
            raise ValueError(
                f"resolution must be divisible by 32, got {self.resolution}")

    @property
    def relu6(self) -> bool:  # V2 always uses ReLU6 (paper §3.2)
        return True

    @property
    def stem_channels(self) -> int:
        return make_divisible(32 * self.alpha)

    @property
    def block_defs(self) -> Tuple[Tuple[int, int, int, int], ...]:
        """Expanded per-block (t, cin, cout, stride), len == 17."""
        out = []
        cin = self.stem_channels
        for t, c, n, s in V2_T_C_N_S:
            cout = make_divisible(c * self.alpha)
            for j in range(n):
                out.append((t, cin, cout, s if j == 0 else 1))
                cin = cout
        return tuple(out)

    @property
    def last_channels(self) -> int:
        # keras: alpha scales the last conv only upward (alpha > 1.0)
        if self.alpha > 1.0:
            return make_divisible(1280 * self.alpha)
        return 1280

    @property
    def final_spatial(self) -> int:
        return self.resolution // 32

    def variant_name(self) -> str:
        return f"mobilenet_v2_{self.alpha:g}_{self.resolution}"


def forward_v2(
    params: Dict[str, Any],
    x: jax.Array,
    config: V2Config,
    *,
    collect: bool = False,
) -> Any:
    """Run MobileNet-V2 on a folded-BN params pytree (checkpoints.v2).

    x: (N, H, W, 3) preprocessed images in [-1, 1] (same TF-family
    normalization as V1 — keras mobilenet_v2 uses preprocess mode='tf').

    collect=True returns (logits, {layer_name: activation}) with the per
    -layer oracle taps: conv1, block{i:02d}_exp/_dw/_prj (and _out where a
    residual applies), conv_last, pool, logits — the V2 twin of V1's
    load-bearing layer names (CLAUDE.md invariants).
    """
    acts: Dict[str, jax.Array] = {}

    y = ops.conv2d_same(x, params["conv1"]["w"], 2,
                        bias=params["conv1"]["b"], relu6=True)
    if collect:
        acts["conv1"] = y

    y = run_blocks_v2(params, y, config, acts=acts if collect else None)
    y = ops.pointwise_conv(y, params["conv_last"]["w"],
                           bias=params["conv_last"]["b"], relu6=True)
    if collect:
        acts["conv_last"] = y
    pooled = ops.global_avg_pool(y)
    if collect:
        acts["pool"] = pooled
    logits = ops.fc(pooled, params["fc"]["w"], params["fc"]["b"])
    if collect:
        acts["logits"] = logits
        return logits, acts
    return logits


def run_blocks_v2(params, y, config: V2Config, *,
                  start: int = 0, stop: Optional[int] = None,
                  acts: Optional[Dict[str, Any]] = None) -> jax.Array:
    """Run inverted-residual blocks [start, stop) on activation `y` —
    forward_v2's block loop, exposed for stage-partitioned runners
    (parallel/pp.py)."""
    stop = len(config.block_defs) if stop is None else stop
    for i in range(start, stop):
        t, cin, cout, stride = config.block_defs[i]
        y = inverted_residual(params["blocks"][i], y, stride,
                              stride == 1 and cin == cout, acts,
                              f"block{i:02d}")
    return y


def inverted_residual(blk, y, stride: int, has_res: bool,
                      acts: Optional[Dict[str, Any]] = None,
                      name: str = "") -> jax.Array:
    """One bottleneck: expand 1x1 + ReLU6 (absent when t == 1, keras :432),
    dw3x3 + ReLU6, linear 1x1 projection, residual add. `acts` collects the
    taps {name}_exp/_dw/_prj/_out."""
    def tap(kind, v):
        if acts is not None:
            acts[f"{name}_{kind}"] = v

    z = y
    if "exp" in blk:
        z = ops.pointwise_conv(z, blk["exp"]["w"], bias=blk["exp"]["b"],
                               relu6=True)
        tap("exp", z)
    z = ops.depthwise_conv_xla(z, blk["dw"]["w"], stride,
                               bias=blk["dw"]["b"], relu6=True)
    tap("dw", z)
    out = ops.pointwise_conv(z, blk["prj"]["w"], bias=blk["prj"]["b"],
                             relu6=None)
    tap("prj", out)
    if has_res:
        out = out + y  # inverted residual (paper Fig. 3)
        tap("out", out)
    return out


def predict_probs_v2(params, x, config: V2Config) -> jax.Array:
    return jax.nn.softmax(
        forward_v2(params, x, config).astype(jnp.float32), axis=-1)


def predict_probs_v2_u8(params, images_u8, config: V2Config, *,
                        dtype=jnp.float32) -> jax.Array:
    """uint8 NHWC at any size -> probs (device resize/normalize, like V1)."""
    from ..ops import preprocess as prep  # noqa: PLC0415

    x = prep.preprocess(images_u8, config.resolution, dtype)
    return predict_probs_v2(params, x, config)
