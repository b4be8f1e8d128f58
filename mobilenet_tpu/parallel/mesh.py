"""Device mesh + sharding layouts for multi-chip scaling.

The reference is a single-FPGA stack with no distributed backend (SURVEY.md SS2
"Parallelism strategies" table); its only transport is PCIe DMA. Here scaling
is jax.sharding over a Mesh with XLA collectives (NCCL over NVLink on GPUs):

  - data parallelism: batch dimension sharded over the "data" axis (the analog
    of the reference's batch-256 throughput mode, scaled across chips)
  - tensor parallelism: pointwise/FC weight output channels sharded over
    "model" — the natural TP axis for a CNN (SURVEY.md SS2: "channel-sharded
    pointwise matmul"); depthwise is per-channel so it shards along with them
    for free, with XLA inserting all-gathers where a pw layer needs full Cin.

Single-chip remains the contract configuration (BASELINE.json:2 is per-chip);
this module exists so the same program scales when a mesh is available, and is
exercised on the 8-device virtual CPU mesh in tests (SURVEY.md SS4).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"
MODEL_AXIS = "model"


def make_mesh(
    n_devices: Optional[int] = None, model_parallel: int = 1
) -> Mesh:
    """Create a (data, model) mesh over the first n devices."""
    devices = jax.devices()
    n = n_devices or len(devices)
    if n > len(devices):
        raise ValueError(
            f"make_mesh: need {n} devices, have {len(devices)} on the "
            f"'{jax.default_backend()}' backend (provision a virtual CPU mesh "
            f"via jax_platforms='cpu' + jax_num_cpu_devices before any backend "
            f"initialization, as tests/conftest.py does)"
        )
    if n % model_parallel:
        raise ValueError(f"{n} devices not divisible by model_parallel={model_parallel}")
    grid = np.asarray(devices[:n]).reshape(n // model_parallel, model_parallel)
    return Mesh(grid, (DATA_AXIS, MODEL_AXIS))


def param_shardings(params: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """NamedSharding pytree for a folded params pytree — all 3 families
    (detected by tree keys: `head` => V3, `conv_last` => V2).

    Channel-TP layout, V1: every per-channel tensor shards its channel
    axis over MODEL_AXIS; pw weights shard Cout (their Cin arrives sharded
    from the previous layer — XLA inserts the all-gather); fc shards Cin.

    V2/V3 shard the EXPANDED dim — the widest tensors and where the dw
    work lives: expand shards Cout, dw shards along, the projection shards its Cin CONTRACTION (so
    GSPMD inserts one psum per block and block outputs/residuals stay
    replicated). V3's SE shards w1's contraction and w2's output over the
    same axis; the squeeze vector (Se) stays replicated.
    """

    def ns(spec):
        return NamedSharding(mesh, spec)

    if "head" in params or "conv_last" in params:  # V2 / V3 bottlenecks
        out: Dict[str, Any] = {
            "conv1": {"w": ns(P(None, None, None, MODEL_AXIS)),
                      "b": ns(P(MODEL_AXIS))},
            "blocks": [],
            "conv_last": {"w": ns(P(None, MODEL_AXIS)),
                          "b": ns(P(MODEL_AXIS))},
            "fc": {"w": ns(P(MODEL_AXIS, None)) if "head" not in params
                   else ns(P(None, None)), "b": ns(P(None))},
        }
        for blk in params["blocks"]:
            ent = {
                "dw": {"w": ns(P(None, None, None, MODEL_AXIS)),
                       "b": ns(P(MODEL_AXIS))},
                # projection: Cin (the expanded dim) is the sharded
                # CONTRACTION -> GSPMD psums; output replicated for the
                # residual add.
                "prj": {"w": ns(P(MODEL_AXIS, None)), "b": ns(P(None))},
            }
            if "exp" in blk:
                ent["exp"] = {"w": ns(P(None, MODEL_AXIS)),
                              "b": ns(P(MODEL_AXIS))}
            if "se" in blk:
                ent["se"] = {"w1": ns(P(MODEL_AXIS, None)),
                             "b1": ns(P(None)),
                             "w2": ns(P(None, MODEL_AXIS)),
                             "b2": ns(P(MODEL_AXIS))}
            out["blocks"].append(ent)
        if "head" in params:  # V3 tail: conv_last sharded -> head psums
            out["head"] = {"w": ns(P(MODEL_AXIS, None)), "b": ns(P(None))}
        return out

    out = {
        "conv1": {"w": ns(P(None, None, None, MODEL_AXIS)), "b": ns(P(MODEL_AXIS))},
        "blocks": [],
        "fc": {"w": ns(P(MODEL_AXIS, None)), "b": ns(P(None))},
    }
    for _ in params["blocks"]:
        out["blocks"].append(
            {
                "dw": {"w": ns(P(None, None, None, MODEL_AXIS)), "b": ns(P(MODEL_AXIS))},
                "pw": {"w": ns(P(None, MODEL_AXIS)), "b": ns(P(MODEL_AXIS))},
            }
        )
    return out


def batch_sharding(mesh: Mesh, rank: int = 4) -> NamedSharding:
    """Shard the leading batch axis over DATA_AXIS (DP)."""
    return NamedSharding(mesh, P(DATA_AXIS, *([None] * (rank - 1))))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_params(params: Dict[str, Any], mesh: Mesh) -> Dict[str, Any]:
    """Place a host params pytree onto the mesh with the TP layout."""
    shardings = param_shardings(params, mesh)
    return jax.tree.map(
        lambda x, s: jax.device_put(jax.numpy.asarray(x), s), params, shardings
    )
