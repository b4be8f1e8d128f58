"""Inference runtime: the JAX replacement for the OpenCL host runtime.

Reference analog (SURVEY.md SS1 L3, SS2 C1/C2/C12):
  - clCreateContext/Queue/Buffer + weight DMA  -> jax.device_put(params) once
  - per-layer clSetKernelArg + clEnqueueNDRangeKernel loop -> ONE jitted program
  - ping-pong cl_mem double buffering + events -> JAX async dispatch: device_put
    of batch n+1 overlaps compute of batch n; block_until_ready only on the
    final output (SURVEY.md SS3.5)

Each (config, batch shape, dtype) pair is one jit cache entry — the analog
of one compiled FPGA bitstream.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import ModelConfig
from ..checkpoints import fold_bn, init_params, to_device
from ..models import mobilenet_v1
from ..models.mobilenet_v2 import V2Config
from ..models.mobilenet_v3 import V3Config


def _require_dp_only_mesh(mesh) -> None:
    """The pipelines implement DATA-parallel serving only: params are
    replicated and the whole network runs per-shard under shard_map. A mesh
    with a model axis > 1 is rejected rather than silently run as DP.
    Channel-TP inference goes through parallel.mesh.shard_params +
    models.mobilenet_v1.forward (GSPMD; tests/test_sharding.py)."""
    from ..parallel.mesh import DATA_AXIS

    extra = {name: size for name, size in mesh.shape.items()
             if name != DATA_AXIS and size > 1}
    if extra:
        raise ValueError(
            f"pipeline meshes are data-parallel only (axis '{DATA_AXIS}'); "
            f"got non-trivial axes {extra}. For channel-TP use "
            "parallel.mesh.shard_params + mobilenet_v1.forward (GSPMD).")


class InferencePipeline:
    """Owns HBM-resident weights + compiled entry points for one model variant."""

    def __init__(
        self,
        config: ModelConfig,
        params: Optional[Dict[str, Any]] = None,
        *,
        seed: int = 0,
        dtype: Any = None,
        mesh: Any = None,
    ):
        """`mesh`: optional jax.sharding.Mesh with a 'data' axis — batches
        shard across it (data-parallel serving; params replicated, the
        network runs per-shard under shard_map). One device when None."""
        self.config = config
        # The runtime is model-family-agnostic after entry construction:
        # a V2Config routes the MobileNet-V2 forward (models.mobilenet_v2)
        # through the same HBM-resident-params + compiled-entry machinery.
        self.is_v2 = isinstance(config, V2Config)
        self.is_v3 = isinstance(config, V3Config)
        if dtype is None:
            dtype = jnp.bfloat16 if config.compute_dtype == "bfloat16" else jnp.float32
        self.dtype = dtype
        if mesh is not None:
            _require_dp_only_mesh(mesh)
        self.mesh = mesh
        if params is not None:
            host_params = params
        elif self.is_v2:
            from ..checkpoints.v2 import fold_bn_v2, init_params_v2

            host_params = fold_bn_v2(
                init_params_v2(config, seed=seed), eps=config.bn_eps)
        elif self.is_v3:
            from ..checkpoints.v3 import fold_bn_v3, init_params_v3

            host_params = fold_bn_v3(
                init_params_v3(config, seed=seed), eps=config.bn_eps)
        else:
            host_params = fold_bn(
                init_params(config, seed=seed), eps=config.bn_eps)
        # Weights -> HBM once (the clCreateBuffer+WriteBuffer(weights) analog).
        self.params = to_device(host_params, dtype=self.dtype)
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            # Replicate the (tiny, ~17MB) weights on every device.
            self.params = jax.tree.map(
                lambda x: jax.device_put(x, NamedSharding(mesh, P())), self.params
            )
        self._entries: Dict[Any, Any] = {}

    # -- compiled entries ---------------------------------------------------

    def _entry(self, kind: str):
        key = kind
        if key in self._entries:
            return self._entries[key]
        cfg = self.config

        if self.is_v3:
            from ..models import mobilenet_v3 as fam

            fwd, u8_fn, f_fn = (fam.forward_v3, fam.predict_probs_v3_u8,
                                fam.predict_probs_v3)
        elif self.is_v2:
            from ..models import mobilenet_v2 as fam

            fwd, u8_fn, f_fn = (fam.forward_v2, fam.predict_probs_v2_u8,
                                fam.predict_probs_v2)
        else:
            fwd, u8_fn, f_fn = (mobilenet_v1.forward,
                                mobilenet_v1.predict_probs_u8,
                                mobilenet_v1.predict_probs)
        if kind == "probs_u8":
            # uint8 NHWC -> probs; preprocessing fused into the same XLA
            # program (BASELINE.json:5).
            def fn(params, images_u8):
                return u8_fn(params, images_u8, cfg, dtype=self.dtype)
        elif kind == "probs_f":
            def fn(params, x):
                return f_fn(params, x.astype(self.dtype), cfg)
        elif kind == "collect":
            def fn(params, x):
                return fwd(params, x.astype(self.dtype), cfg, collect=True)
        else:
            raise KeyError(kind)

        if self.mesh is not None:
            # Data-parallel over the mesh: each device runs the full network
            # on its batch shard (shard_map keeps any custom kernel local —
            # the SPMD partitioner cannot split an opaque custom call).
            from jax import shard_map
            from jax.sharding import NamedSharding, PartitionSpec as P

            from ..parallel.mesh import DATA_AXIS

            mesh = self.mesh
            sharded = shard_map(
                fn, mesh=mesh,
                in_specs=(P(), P(DATA_AXIS)),
                out_specs=P(DATA_AXIS),
                check_vma=False,
            )

            def entry_fn(params, batch):
                batch = jax.device_put(
                    batch, NamedSharding(mesh, P(DATA_AXIS, None, None, None))
                )
                return sharded(params, batch)

            jitted = jax.jit(entry_fn)
        else:
            jitted = jax.jit(fn)
        self._entries[key] = jitted
        return jitted

    # -- user-facing paths ----------------------------------------------------

    def classify(self, image_u8: np.ndarray, top_k: int = 5):
        """Single-image path (SURVEY.md SS3.4). image_u8: (H, W, 3) uint8.
        Exactly 2 host<->device crossings: input in, probs out."""
        batch = jnp.asarray(image_u8[None])
        probs = np.asarray(self._entry("probs_u8")(self.params, batch)[0])
        idx = np.argsort(-probs)[:top_k]
        return [(int(i), float(probs[i])) for i in idx]

    def run_batch(self, images_u8) -> np.ndarray:
        return np.asarray(self._entry("probs_u8")(self.params, jnp.asarray(images_u8)))

    def run_preprocessed(self, x) -> jax.Array:
        return self._entry("probs_f")(self.params, x)

    def activations(self, x):
        """Per-layer tap for the verify harness (SURVEY.md SS3.6)."""
        logits, acts = self._entry("collect")(self.params, jnp.asarray(x))
        return np.asarray(logits), {k: np.asarray(v) for k, v in acts.items()}

    # -- throughput mode ------------------------------------------------------

    def benchmark(
        self,
        batch_size: int = 256,
        steps: int = 40,
        warmup: int = 5,
        from_uint8: bool = True,
    ) -> Dict[str, float]:
        """Batch-N throughput and batch-1 latency, timed on the host clock
        around work that ends in `block_until_ready`.

        images_per_sec: device-resident input (transfers excluded).
        e2e_images_per_sec: each step ships its batch from the host;
        device_put of batch n+1 overlaps compute of batch n (the OpenCL
        ping-pong analog, BASELINE.json:11).
        p50/p99_latency_ms: one batch of max(1, devices) images per call.
        """
        cfg = self.config
        res = cfg.resolution
        rng = np.random.default_rng(0)
        if from_uint8:
            host_batches = [
                rng.integers(0, 256, (batch_size, res, res, 3), dtype=np.uint8)
                for _ in range(2)
            ]
            entry = self._entry("probs_u8")
        else:
            host_batches = [
                rng.uniform(-1, 1, (batch_size, res, res, 3)).astype(np.float32)
                for _ in range(2)
            ]
            entry = self._entry("probs_f")

        if self.mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P
            from ..parallel.mesh import DATA_AXIS

            device = NamedSharding(self.mesh, P(DATA_AXIS, None, None, None))
            n_dev = self.mesh.devices.size
        else:
            device = jax.devices()[0]
            n_dev = 1

        dev_batch = jax.device_put(host_batches[0], device)
        out = entry(self.params, dev_batch)
        out.block_until_ready()  # compile
        for _ in range(warmup):
            out = entry(self.params, dev_batch)
        out.block_until_ready()
        t0 = time.perf_counter()
        for _ in range(steps):
            out = entry(self.params, dev_batch)
        out.block_until_ready()
        dt = time.perf_counter() - t0

        e2e_steps = max(4, steps // 8)
        t0 = time.perf_counter()
        for i in range(e2e_steps):
            nxt = jax.device_put(host_batches[i % 2], device)
            out = entry(self.params, nxt)
        out.block_until_ready()
        e2e_dt = time.perf_counter() - t0

        lat_batch = jax.device_put(host_batches[0][:max(1, n_dev)], device)
        entry(self.params, lat_batch).block_until_ready()
        lats = []
        for _ in range(30):
            t = time.perf_counter()
            entry(self.params, lat_batch).block_until_ready()
            lats.append(time.perf_counter() - t)
        return {
            "images_per_sec": steps * batch_size / dt,
            "e2e_images_per_sec": e2e_steps * batch_size / e2e_dt,
            "batch_size": batch_size,
            "steps": steps,
            "wall_s": dt,
            "p50_latency_ms": float(np.percentile(lats, 50) * 1e3),
            "p99_latency_ms": float(np.percentile(lats, 99) * 1e3),
        }
