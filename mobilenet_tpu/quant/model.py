"""INT8 MobileNet-V1 forward: the quantized twin of models/mobilenet_v1.py.

One jitted program, int8 activations end-to-end, per-layer requantization
(BASELINE.json:10). Layer names in collect mode match the fp32 pipeline and
the oracles.
"""

from __future__ import annotations

from typing import Any, Dict

import jax
import jax.numpy as jnp
import numpy as np

from ..config import ModelConfig
from . import ops as qops
from .quantize import QuantizedParams


def _as_device_tree(q: QuantizedParams) -> Dict[str, Any]:
    """Move quantized constants into jnp arrays (HBM once)."""

    def layer(l):
        return {
            "w": jnp.asarray(l.w_i8),
            "b": jnp.asarray(l.bias_i32),
            "m": jnp.asarray(l.m),
            "six_q": float(l.six_q),
        }

    return {
        "conv1": layer(q.conv1),
        "blocks": [{"dw": layer(b["dw"]), "pw": layer(b["pw"])} for b in q.blocks],
        "fc": {
            "w": jnp.asarray(q.fc_w_i8),
            "s_w": jnp.asarray(q.fc_s_w),
            "b": jnp.asarray(q.fc_b_f32),
        },
    }


def forward_i8(
    dev: Dict[str, Any],
    x_i8: jax.Array,
    config: ModelConfig,
    *,
    collect: bool = False,
):
    """x_i8: (N, H, W, 3) quantized input at s_in = 1/127 — int8, or bfloat16
    holding the same integers (the production stem path; conv1 reads either
    and the results are bit-identical). Returns float32 logits."""
    acts: Dict[str, jax.Array] = {}
    relu6 = config.relu6

    c1 = dev["conv1"]
    y = qops.conv1_i8(x_i8, c1["w"], c1["b"], c1["m"], c1["six_q"], relu6)
    if collect:
        acts["conv1"] = y

    for i, (blk, stride) in enumerate(zip(dev["blocks"], config.block_strides)):
        d = blk["dw"]
        y = qops.depthwise_i8_xla(y, d["w"], d["b"], d["m"], d["six_q"], stride, relu6)
        if collect:
            acts[f"block{i:02d}_dw"] = y
        p = blk["pw"]
        y = qops.pointwise_i8(y, p["w"], p["b"], p["m"], p["six_q"], relu6)
        if collect:
            acts[f"block{i:02d}_pw"] = y

    pooled = qops.avgpool_i8(y)
    if collect:
        acts["pool"] = pooled
    from .quantize import ACT_HIDDEN_SCALE  # noqa: PLC0415

    logits = qops.fc_i8_logits(pooled, dev["fc"]["w"], ACT_HIDDEN_SCALE,
                               dev["fc"]["s_w"], dev["fc"]["b"])
    if collect:
        acts["logits"] = logits
        return logits, acts
    return logits


class Int8Pipeline:
    """Pipeline-shaped adapter over the int8 network: exposes the
    `run_batch(uint8) -> probs` + `.config` surface MicroBatchServer needs,
    so multi-stream serving can run the quantized path (the reference served
    its fixed-point FPGA pipeline; SURVEY.md SS2 C7/C12)."""

    def __init__(self, config: ModelConfig, *, seed: int = 0, params=None,
                 mesh=None):
        """`mesh`: optional jax.sharding.Mesh with a 'data' axis — batches
        shard across it (data-parallel int8 serving, mirroring the fp32
        InferencePipeline's mesh wiring; quantized constants replicated)."""
        from ..checkpoints import fold_bn, init_params
        from .quantize import quantize

        self.config = config
        if mesh is not None:
            from ..runtime.pipeline import _require_dp_only_mesh

            _require_dp_only_mesh(mesh)
        self.mesh = mesh
        folded = params if params is not None else fold_bn(
            init_params(config, seed=seed), eps=config.bn_eps)
        self.q = quantize(folded, config)
        self._infer, self._dev = make_int8_infer(self.q, config, mesh=mesh)
        # softmax folded into the jitted program (jit-of-jit inlines) — no
        # per-batch eager dispatches on the serving hot path.
        self._probs = jax.jit(
            lambda imgs: jax.nn.softmax(self._infer(imgs), axis=-1))

    def run_batch(self, images_u8):
        return np.asarray(self._probs(jnp.asarray(images_u8)))


def make_int8_infer(q: QuantizedParams, config: ModelConfig, *, mesh=None):
    """Compiled int8 entry: uint8 images -> float32 logits, preprocessing and
    input quantization fused into the same program. With `mesh`, the batch
    shards over its 'data' axis (int8 data-parallel serving — the reference
    served its fixed-point pipeline multi-stream, SURVEY.md SS2 C7/C12)."""
    from ..ops import preprocess as prep
    from .quantize import ACT_IN_SCALE

    dev = _as_device_tree(q)

    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        # Replicate the (tiny) quantized constants on every chip; six_q is a
        # static python float, keep it out of device_put.
        rep = NamedSharding(mesh, P())
        dev = jax.tree.map(
            lambda x: jax.device_put(x, rep) if isinstance(x, jax.Array) else x,
            dev,
        )

    def infer(images_u8):
        x = prep.preprocess(images_u8, config.resolution, jnp.float32)
        x_q = qops.quantize_input_dev(x, ACT_IN_SCALE)
        return forward_i8(dev, x_q, config)

    if mesh is None:
        return jax.jit(infer), dev

    # Data-parallel over the mesh: each device runs the full int8 network on
    # its batch shard. Mirrors runtime/pipeline.py's fp32 mesh wiring.
    from jax import shard_map
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..parallel.mesh import DATA_AXIS

    batch_spec = P(DATA_AXIS, None, None, None)
    sharded = shard_map(
        infer, mesh=mesh, in_specs=(batch_spec,),
        out_specs=P(DATA_AXIS), check_vma=False,
    )

    def entry(images_u8):
        images_u8 = jax.device_put(images_u8, NamedSharding(mesh, batch_spec))
        return sharded(images_u8)

    return jax.jit(entry), dev
