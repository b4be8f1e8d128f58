"""GPipe-style pipeline parallelism over a "pipe" mesh axis.

The reference is a single-FPGA stack (SURVEY.md SS2 "Parallelism
strategies") — its closest analog is the layer-pipelined dataflow INSIDE the
bitstream. Here the 28-layer program splits into S
contiguous stages, one per device on a 1-D "pipe" mesh, and streams M
microbatches through them with the classic GPipe schedule: at step t device
d runs stage d on microbatch t-d, and stage boundaries shift one hop along
the ring with a single `lax.ppermute` per step. The whole
schedule is ONE jitted `lax.scan` of M+S-1 steps inside `shard_map` — no
host round-trips, no data-dependent control flow.

Heterogeneous stages in an SPMD program: every device executes the same
scanned step, selecting its stage body with `lax.switch(axis_index)`.
Because CNN activation shapes change across stages (spatial downsampling,
channel growth), the inter-stage boundary is a fixed (b, L) float32 buffer
with L = max boundary size; each stage body unflattens its statically-known
input shape and re-pads its output. f32 boundaries are exact: the
single-device bf16 path's inter-block values are bf16, and bf16->f32->bf16
round-trips losslessly, so pp logits match `mobilenet_v1.forward` to
numerical tolerance (~1e-6 f32 — XLA schedules the convs differently at
microbatch size, so reassociation differs; the buffer itself is lossless).

Stage balance is by analytic MAC count over 15 units (stem, 13 separable
blocks, head) — the same per-layer cost model `utils/profiling` uses — with
a contiguous greedy partition. Parameters are replicated over the pipe axis
(MobileNet-V1 1.0 is ~17 MB in bf16 — per-stage weight sharding would save
bytes that don't matter at this scale; the schedule, not the memory, is
what pp demonstrates here).

The pipelined forward is differentiable: `pp_train_step` takes `jax.grad`
straight through scan + switch + ppermute (the transpose of a shift is the
reverse shift) and cross-replica param cotangents reduce via the replicated
in_spec, giving pipeline-parallel training with zero extra schedule code.

All three model families ride the same schedule: a per-family unit
adapter (`_units_for`) supplies the unit count (stem + blocks + head),
entering shapes, MAC costs, and a `run(p, y, start, stop)` stage body —
the scan/switch/ppermute machinery is family-agnostic.

Tested against the single-device forward on the 8-device virtual CPU mesh
(tests/test_pp.py); compiled+executed in the driver's multi-chip dryrun.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import ModelConfig
from ..ops import conv as cops

PIPE_AXIS = "pipe"

# unit indexing: 0 = stem conv, 1 + i = separable block i (13), 14 = head
N_UNITS = 15


def make_pipe_mesh(n_stages: int, devices=None) -> Mesh:
    """1-D ("pipe",) mesh over the first n_stages devices."""
    devices = list(devices or jax.devices())
    if n_stages > len(devices):
        raise ValueError(
            f"make_pipe_mesh: need {n_stages} devices, have {len(devices)} "
            f"on '{jax.default_backend()}'")
    return Mesh(np.asarray(devices[:n_stages]), (PIPE_AXIS,))


def _unit_in_shapes(config: ModelConfig,
                    params: Dict[str, Any]) -> List[Tuple[int, int, int]]:
    """Per-sample activation shape ENTERING each unit (len == N_UNITS).

    Spatial sizes use TF-SAME ceil division — the whole stack's convention."""
    res = config.resolution
    shapes = [(res, res, 3)]
    hw = -(-res // 2)  # stem is stride 2
    c = int(params["conv1"]["w"].shape[3])
    for i, stride in enumerate(config.block_strides):
        shapes.append((hw, hw, c))
        hw = -(-hw // stride)
        c = int(params["blocks"][i]["pw"]["w"].shape[1])
    shapes.append((hw, hw, c))  # entering the head
    return shapes


def _unit_costs(config: ModelConfig, params: Dict[str, Any]) -> List[float]:
    """Analytic MACs per unit — the stage-balance weight."""
    shapes = _unit_in_shapes(config, params)
    costs = [0.0] * N_UNITS
    h, w, _ = shapes[1]
    costs[0] = h * w * 9 * 3 * float(params["conv1"]["w"].shape[3])
    for i, stride in enumerate(config.block_strides):
        cin = int(params["blocks"][i]["pw"]["w"].shape[0])
        cout = int(params["blocks"][i]["pw"]["w"].shape[1])
        hin = shapes[1 + i][0]
        hout = -(-hin // stride)
        costs[1 + i] = float(hout * hout) * (9.0 * cin + cin * cout)
    hh, _, cc = shapes[14]
    costs[14] = float(hh * hh * cc + cc * config.num_classes)
    return costs


def _v1_units(config, params):
    """V1 family adapter: (n_units, in_shapes, costs, run). `run(p, y,
    start, stop)` executes units [start, stop) — unit 0 = stem, 1..n-2 =
    blocks, n-1 = head (emits (b, nc) f32 logits)."""
    from ..models import mobilenet_v1 as mv1  # noqa: PLC0415

    shapes = _unit_in_shapes(config, params)
    costs = _unit_costs(config, params)
    relu6 = config.relu6
    n = N_UNITS

    def run(p, y, start, stop):
        u = start
        if u == 0:
            y = cops.conv2d_same(y, p["conv1"]["w"], 2,
                                 bias=p["conv1"]["b"], relu6=relu6)
            u = 1
        blk_stop = min(stop, n - 1) - 1
        if blk_stop > u - 1:
            y = mv1._run_blocks(p, y, config, relu6, None,
                                start=u - 1, stop=blk_stop)
        if stop == n:
            pooled = cops.global_avg_pool(y)
            y = cops.fc(pooled, p["fc"]["w"],
                        p["fc"]["b"]).astype(jnp.float32)
        return y

    return n, shapes, costs, run


def _v2_units(config, params):
    """V2 family adapter (stem + 17 inverted-residual blocks + head)."""
    from ..models import mobilenet_v2 as mv2  # noqa: PLC0415

    defs = config.block_defs
    n = len(defs) + 2
    res = config.resolution
    shapes = [(res, res, 3)]
    hw = -(-res // 2)
    c = int(params["conv1"]["w"].shape[3])
    for i, (_, _, _, stride) in enumerate(defs):
        shapes.append((hw, hw, c))
        hw = -(-hw // stride)
        c = int(params["blocks"][i]["prj"]["w"].shape[1])
    shapes.append((hw, hw, c))
    costs = [0.0] * n
    h0 = shapes[1][0]
    costs[0] = h0 * h0 * 9 * 3 * float(params["conv1"]["w"].shape[3])
    for i, (_, _, _, stride) in enumerate(defs):
        hin, _, cin_a = shapes[1 + i]
        blk = params["blocks"][i]
        e = int(blk["exp"]["w"].shape[1]) if "exp" in blk else cin_a
        hout = -(-hin // stride)
        exp_macs = hin * hin * cin_a * e if "exp" in blk else 0
        costs[1 + i] = float(
            exp_macs + hout * hout * (9 * e
                                      + e * int(blk["prj"]["w"].shape[1])))
    hh, _, cc = shapes[n - 1]
    cl = int(params["conv_last"]["w"].shape[1])
    costs[n - 1] = float(hh * hh * cc * cl + cl * config.num_classes)

    def run(p, y, start, stop):
        u = start
        if u == 0:
            y = cops.conv2d_same(y, p["conv1"]["w"], 2,
                                 bias=p["conv1"]["b"], relu6=True)
            u = 1
        blk_stop = min(stop, n - 1) - 1
        if blk_stop > u - 1:
            y = mv2.run_blocks_v2(p, y, config, start=u - 1, stop=blk_stop)
        if stop == n:
            y = cops.pointwise_conv(y, p["conv_last"]["w"],
                                    bias=p["conv_last"]["b"], relu6=True)
            pooled = cops.global_avg_pool(y)
            y = cops.fc(pooled, p["fc"]["w"],
                        p["fc"]["b"]).astype(jnp.float32)
        return y

    return n, shapes, costs, run


def _v3_units(config, params):
    """V3 family adapter (stem + bottlenecks + conv_last/pool/head/fc)."""
    from ..models import mobilenet_v3 as mv3  # noqa: PLC0415

    defs = config.block_defs
    n = len(defs) + 2
    res = config.resolution
    shapes = [(res, res, 3)]
    hw = -(-res // 2)
    c = int(params["conv1"]["w"].shape[3])
    for i, bd in enumerate(defs):
        shapes.append((hw, hw, c))
        hw = -(-hw // bd.stride)
        c = int(params["blocks"][i]["prj"]["w"].shape[1])
    shapes.append((hw, hw, c))
    costs = [0.0] * n
    h0 = shapes[1][0]
    costs[0] = h0 * h0 * 9 * 3 * float(params["conv1"]["w"].shape[3])
    for i, bd in enumerate(defs):
        hin, _, cin_a = shapes[1 + i]
        blk = params["blocks"][i]
        e = int(blk["exp"]["w"].shape[1]) if "exp" in blk else cin_a
        hout = -(-hin // bd.stride)
        exp_macs = hin * hin * cin_a * e if "exp" in blk else 0
        costs[1 + i] = float(
            exp_macs
            + hout * hout * (bd.kernel * bd.kernel * e
                             + e * int(blk["prj"]["w"].shape[1]))
            + (2 * e * bd.se_mid if bd.se_mid else 0))
    hh, _, cc = shapes[n - 1]
    cl = int(params["conv_last"]["w"].shape[1])
    costs[n - 1] = float(hh * hh * cc * cl
                         + cl * int(params["head"]["w"].shape[1])
                         + int(params["head"]["w"].shape[1])
                         * config.num_classes)
    act = config.head_act

    def run(p, y, start, stop):
        u = start
        if u == 0:
            y = cops.conv2d_same(y, p["conv1"]["w"], 2,
                                 bias=p["conv1"]["b"], act=act)
            u = 1
        blk_stop = min(stop, n - 1) - 1
        if blk_stop > u - 1:
            y = mv3.run_blocks_v3(p, y, config, start=u - 1, stop=blk_stop)
        if stop == n:
            y = cops.pointwise_conv(y, p["conv_last"]["w"],
                                    bias=p["conv_last"]["b"], act=act)
            pooled = cops.global_avg_pool(y)
            h = mv3.head_matmul(pooled, p["head"], act)
            y = cops.fc(h, p["fc"]["w"], p["fc"]["b"]).astype(jnp.float32)
        return y

    return n, shapes, costs, run


def _units_for(config, params):
    """Family dispatch: the per-unit decomposition pp schedules over."""
    from ..models.mobilenet_v2 import V2Config  # noqa: PLC0415
    from ..models.mobilenet_v3 import V3Config  # noqa: PLC0415

    if isinstance(config, V2Config):
        return _v2_units(config, params)
    if isinstance(config, V3Config):
        return _v3_units(config, params)
    return _v1_units(config, params)


def plan_stages(config, params: Dict[str, Any],
                n_stages: int) -> List[Tuple[int, int]]:
    """Contiguous [start, stop) unit ranges, MAC-balanced greedily.

    Every stage gets >= 1 unit; trailing stages are never starved (the
    greedy target re-divides the remaining mass each cut). Works for all
    three families (unit count = stem + blocks + head per family)."""
    n_units, _, costs, _ = _units_for(config, params)
    if not 1 <= n_stages <= n_units:
        raise ValueError(
            f"n_stages must be in [1, {n_units}], got {n_stages}")
    bounds: List[Tuple[int, int]] = []
    start = 0
    for s in range(n_stages):
        stages_left = n_stages - s
        if stages_left == 1:
            bounds.append((start, n_units))
            break
        target = sum(costs[start:]) / stages_left
        stop, acc = start, 0.0
        # leave at least one unit for each remaining stage
        max_stop = n_units - (stages_left - 1)
        while stop < max_stop:
            nxt = acc + costs[stop]
            if stop > start and nxt > target and (nxt - target) > (target - acc):
                break
            acc = nxt
            stop += 1
        stop = max(stop, start + 1)
        bounds.append((start, stop))
        start = stop
    assert bounds[-1][1] == n_units and len(bounds) == n_stages, bounds
    return bounds


def forward_pp(
    params: Dict[str, Any],
    x: jax.Array,
    config,  # ModelConfig | V2Config | V3Config
    mesh: Mesh,
    *,
    n_microbatches: Optional[int] = None,
) -> jax.Array:
    """Pipeline-parallel forward: logits (N, num_classes), replicated.

    `x` is the full preprocessed batch (N, H, W, 3); it is split into M
    microbatches of N/M (M defaults to 2*S — the GPipe bubble is
    (S-1)/(M+S-1), so M >= 2S keeps it under a third). `params` may live
    anywhere; they are replicated over the pipe axis here. Each stage runs
    its blocks exactly as mobilenet_v1._run_blocks does.
    """
    S = mesh.shape[PIPE_AXIS]
    N = int(x.shape[0])
    M = int(n_microbatches or min(2 * S, N))
    if N % M:
        raise ValueError(f"batch {N} not divisible by n_microbatches={M}")
    b = N // M
    nc = config.num_classes
    n_units, shapes, _, run_units = _units_for(config, params)
    bounds = plan_stages(config, params, S)
    # fixed inter-stage buffer: max over live boundaries (and the logits row)
    L = max([int(np.prod(shapes[bounds[s][0]])) for s in range(1, S)] + [nc])
    act_dtype = x.dtype

    def _stage_body(s: int):
        start, stop = bounds[s]

        def body(p, buf_in, x_mb):
            if start == 0:
                y = x_mb
            else:
                h, w, c = shapes[start]
                y = buf_in[:, : h * w * c].reshape(b, h, w, c).astype(act_dtype)
            y = run_units(p, y, start, stop)
            flat = (y if stop == n_units  # head already emits (b, nc) f32
                    else y.reshape(b, -1).astype(jnp.float32))
            pad = L - flat.shape[1]
            return jnp.pad(flat, ((0, 0), (0, pad))) if pad else flat

        return body

    stage_bodies = [_stage_body(s) for s in range(S)]
    perm = [(i, i + 1) for i in range(S - 1)]

    def local_fn(p, x_all):
        s_idx = lax.axis_index(PIPE_AXIS)
        is_last = s_idx == S - 1

        def step(carry, t):
            buf, out = carry
            x_mb = lax.dynamic_index_in_dim(
                x_all, jnp.clip(t, 0, M - 1), axis=0, keepdims=False)
            buf_out = lax.switch(s_idx, stage_bodies, p, buf, x_mb)
            # the last stage emitted microbatch t-(S-1)'s logits this step
            m_out = t - (S - 1)
            valid = (m_out >= 0) & is_last
            idx = jnp.clip(m_out, 0, M - 1)
            cur = lax.dynamic_index_in_dim(out, idx, axis=0, keepdims=False)
            new = jnp.where(valid, buf_out[:, :nc], cur)
            out = lax.dynamic_update_index_in_dim(out, new, idx, axis=0)
            buf_next = (lax.ppermute(buf_out, PIPE_AXIS, perm)
                        if perm else buf_out)
            return (buf_next, out), None

        buf0 = jnp.zeros((b, L), jnp.float32)
        out0 = jnp.zeros((M, b, nc), jnp.float32)
        (_, out), _ = lax.scan(step, (buf0, out0), jnp.arange(M + S - 1))
        # only the last stage wrote logits; psum replicates them ring-wide
        return lax.psum(out, PIPE_AXIS)

    sharded = jax.shard_map(
        local_fn, mesh=mesh,
        in_specs=(P(), P()),
        out_specs=P(),
        check_vma=False,
    )
    rep = NamedSharding(mesh, P())
    p_rep = jax.tree.map(lambda a: jax.device_put(jnp.asarray(a), rep), params)
    x_all = jax.device_put(x.reshape(M, b, *x.shape[1:]), rep)
    out = sharded(p_rep, x_all)
    return out.reshape(N, nc)


def pp_train_step(
    params: Dict[str, Any],
    x: jax.Array,
    labels: jax.Array,
    config,  # ModelConfig | V2Config | V3Config
    mesh: Mesh,
    *,
    lr: float = 1e-3,
    n_microbatches: Optional[int] = None,
):
    """One SGD step through the PIPELINED forward.

    jax.grad transposes the whole schedule: the scan runs backward, the
    boundary ppermute reverses direction (cotangents flow last->first
    stage), and the replicated params in_spec psums per-stage weight
    cotangents across the ring. Loss is mean softmax cross-entropy in f32,
    matching models/train.sgd_train_step.
    """

    def loss_fn(p):
        logits = forward_pp(p, x, config, mesh,
                            n_microbatches=n_microbatches)
        logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
        nll = -jnp.take_along_axis(logp, labels[:, None], axis=-1)
        return jnp.mean(nll)

    loss, grads = jax.value_and_grad(loss_fn)(params)
    new_params = jax.tree.map(
        lambda w, g: (w - lr * g.astype(w.dtype)).astype(w.dtype),
        params, grads)
    return new_params, loss
