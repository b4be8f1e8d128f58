"""Multi-stream serving: 64 concurrent image streams -> micro-batcher -> device.

Reference analog: SURVEY.md SS3.3 / C12 — 64 in-flight OpenCL streams with
double-buffered host->HBM DMA (BASELINE.json:11). Here:
  - each stream is an asyncio producer; requests land in one queue
  - the micro-batcher drains up to `max_batch` requests (or waits at most
    `max_delay_ms`), pads to a fixed batch so there is exactly ONE jit entry,
    and dispatches on a dedicated executor thread (JAX async dispatch overlaps
    the next batch's host->HBM transfer with current compute)
  - per-stream error isolation + request timeouts (SURVEY.md SS5 "failure
    detection": a bad request fails its own future, never the server)

Also exposes a newline-delimited-JSON TCP front end (`serve_tcp`) and an
in-process 64-stream load test (`selftest`) that reports img/s and p50/p99.
"""

from __future__ import annotations

import asyncio
import base64
import dataclasses
import json
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional

import numpy as np

from ..config import ModelConfig


def _is_retryable_device_error(e: BaseException) -> bool:
    """Only device/runtime failures are worth retrying; deterministic errors
    (shape/value errors raised by the pipeline) must fail fast instead of
    burning backoff sleeps. jaxlib surfaces device faults as XlaRuntimeError
    (a RuntimeError subclass, re-exported as jax.errors.JaxRuntimeError);
    the string markers cover errors that arrive re-wrapped by an executor
    with only their gRPC status text intact."""
    try:
        from jax.errors import JaxRuntimeError  # noqa: PLC0415

        if isinstance(e, JaxRuntimeError):
            return True
    except ImportError:
        pass
    markers = ("FAILED_PRECONDITION", "UNAVAILABLE", "DEADLINE_EXCEEDED",
               "RESOURCE_EXHAUSTED", "INTERNAL", "ABORTED")
    return isinstance(e, RuntimeError) and any(m in str(e) for m in markers)


@dataclasses.dataclass
class ServerStats:
    requests: int = 0
    batches: int = 0
    errors: int = 0
    retries: int = 0
    batch_fill: float = 0.0
    # batch-bucket size -> number of dispatches routed to it (latency
    # tiering observability: light load should land in small buckets)
    bucket_counts: Dict[int, int] = dataclasses.field(default_factory=dict)

    def reset_window(self):
        """Zero the per-window counters (batches/fill/buckets) so a load
        probe can report per-phase stats; cumulative error/retry counts are
        kept — they are failure-detection state, not load metrics."""
        self.requests = 0
        self.batches = 0
        self.batch_fill = 0.0
        self.bucket_counts.clear()


def default_buckets(max_batch: int, mesh=None) -> List[int]:
    """The serving batch tiers precompiled for a `max_batch`-stream server:
    {1, max_batch//8, max_batch}, each rounded up to a multiple of the
    data-parallel width when a mesh is given (every bucket must shard evenly).
    Shared by MicroBatchServer and `cli warmup` so what warmup compiles is
    exactly what serving dispatches."""
    cand = {1, max(1, max_batch // 8), max_batch}
    if mesh is not None:
        dp = int(mesh.devices.size)
        cand = {max(dp, -(-b // dp) * dp) for b in cand}
    return sorted(cand)


class MicroBatchServer:
    """Micro-batching inference server over an InferencePipeline."""

    def __init__(
        self,
        pipeline,
        max_batch: int = 64,
        max_delay_ms: float = 3.0,
        request_timeout_s: float = 30.0,
        device_retries: int = 1,
        retry_backoff_s: float = 0.5,
        batch_buckets: Optional[List[int]] = None,
    ):
        """`device_retries`: how many times a failed DEVICE dispatch is
        retried before the batch's requests fail; only device/runtime error
        types retry (_is_retryable_device_error) — deterministic shape/value
        errors fail fast on the first attempt. Backoff is exponential:
        retry_backoff_s * 2**attempt. 0 turns retries off, so every device
        failure reaches the caller and the error counter (what a
        measurement run wants).

        `batch_buckets`: fixed batch sizes to precompile; each dispatch pads
        to the SMALLEST bucket that fits the drained requests, so one lone
        request at light load pays ~bucket-1 compute + transfer instead of a
        full max_batch pad (the round-2 weakness: a padded-64 dispatch ships
        64x res^2 bytes and ~2.4 ms device time for one image). Default:
        {1, max_batch//8, max_batch}. The largest bucket must equal
        max_batch; at saturation everything lands there, so peak throughput
        is unchanged."""
        self.pipeline = pipeline
        self.max_batch = max_batch
        self.max_delay_ms = max_delay_ms
        self.request_timeout_s = request_timeout_s
        self.device_retries = device_retries
        self.retry_backoff_s = retry_backoff_s
        self.queue: asyncio.Queue = asyncio.Queue()
        self.stats = ServerStats()
        self._executor = ThreadPoolExecutor(max_workers=1)  # one device stream
        self._task: Optional[asyncio.Task] = None
        self._closed = False
        res = pipeline.config.resolution
        if batch_buckets is None:
            batch_buckets = default_buckets(
                max_batch, getattr(pipeline, "mesh", None))
        buckets = sorted(set(int(b) for b in batch_buckets))
        if not buckets or buckets[-1] != max_batch or buckets[0] < 1:
            raise ValueError(
                f"batch_buckets {buckets} must be >=1 and end at "
                f"max_batch={max_batch} (a full drain must fit a bucket)")
        self.batch_buckets = buckets
        # Pre-compile every bucket entry so first requests don't pay a
        # compile (one jit cache entry per bucket — the multi-bitstream
        # analog).
        self._pad_templates = {
            b: np.zeros((b, res, res, 3), np.uint8) for b in buckets
        }
        for b in buckets:
            self.pipeline.run_batch(self._pad_templates[b])

    def stats_dict(self) -> Dict[str, Any]:
        """Live counters for the TCP `{"cmd": "stats"}` probe (the
        reference's printf-timing observability analog, SURVEY.md SS5)."""
        s = self.stats
        return {
            "requests": s.requests,
            "batches": s.batches,
            "errors": s.errors,
            "retries": s.retries,
            "mean_batch_fill": s.batch_fill / max(s.batches, 1),
            "bucket_counts": {str(k): v
                              for k, v in sorted(s.bucket_counts.items())},
            "buckets": list(self.batch_buckets),
        }

    async def start(self):
        self._task = asyncio.create_task(self._batcher_loop())

    async def close(self):
        self._closed = True
        if self._task:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
        self._executor.shutdown(wait=False)

    async def submit(self, image_u8: np.ndarray, top_k: int = 5):
        """One request from one stream. Returns top-k [(class, prob)]."""
        if image_u8.ndim != 3 or image_u8.shape[-1] != 3:
            raise ValueError(f"expected HWC RGB image, got {image_u8.shape}")
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        await self.queue.put((image_u8, top_k, fut))
        return await asyncio.wait_for(fut, timeout=self.request_timeout_s)

    async def _batcher_loop(self):
        loop = asyncio.get_running_loop()
        while not self._closed:
            first = await self.queue.get()
            batch = [first]
            deadline = loop.time() + self.max_delay_ms / 1e3
            while len(batch) < self.max_batch:
                timeout = deadline - loop.time()
                if timeout <= 0:
                    break
                try:
                    batch.append(await asyncio.wait_for(self.queue.get(), timeout))
                except asyncio.TimeoutError:
                    break
            await self._run_batch(loop, batch)

    async def _run_batch(self, loop, batch: List[Any]):
        res = self.pipeline.config.resolution
        # Smallest precompiled bucket that fits this drain (latency tiering).
        bucket = next(b for b in self.batch_buckets if b >= len(batch))
        images = self._pad_templates[bucket].copy()
        valid: List[int] = []
        for i, (img, _, fut) in enumerate(batch):
            try:
                if img.shape[:2] != (res, res):
                    raise ValueError(
                        f"image must be pre-sized to {res}x{res} (host decode path)"
                    )
                images[i] = img
                valid.append(i)
            except Exception as e:  # per-stream error isolation
                self.stats.errors += 1
                if not fut.done():
                    fut.set_exception(e)

        def run():
            return self.pipeline.run_batch(images)

        try:
            for attempt in range(self.device_retries + 1):
                try:
                    probs = await loop.run_in_executor(self._executor, run)
                    break
                except Exception as e:
                    if (attempt == self.device_retries
                            or not _is_retryable_device_error(e)):
                        raise
                    self.stats.retries += 1
                    await asyncio.sleep(self.retry_backoff_s * 2 ** attempt)
        except Exception as e:
            for i in valid:
                fut = batch[i][2]
                if not fut.done():
                    fut.set_exception(e)
            self.stats.errors += len(valid)
            return
        self.stats.batches += 1
        self.stats.requests += len(valid)
        self.stats.batch_fill += len(batch) / self.max_batch
        self.stats.bucket_counts[bucket] = (
            self.stats.bucket_counts.get(bucket, 0) + 1)
        for i in valid:
            _, top_k, fut = batch[i]
            p = probs[i]
            idx = np.argsort(-p)[:top_k]
            if not fut.done():
                fut.set_result([(int(j), float(p[j])) for j in idx])


# ---------------------------------------------------------------------------
# TCP front end: newline-delimited JSON requests
#   {"id": any, "shape": [H,W,3], "image_b64": <raw uint8 bytes>}
# response: {"id": any, "top": [[class, prob], ...]} or {"id":..., "error":...}
# ---------------------------------------------------------------------------


async def make_tcp_server(server: MicroBatchServer, host: str, port: int):
    """Bind the NDJSON front end; port=0 binds an ephemeral port (tests).
    Returns the asyncio.Server (caller drives serve_forever / close)."""

    async def handle(reader, writer):
        while True:
            line = await reader.readline()
            if not line:
                break
            req = None
            try:
                req = json.loads(line)
                if req.get("cmd") == "stats":  # observability probe
                    writer.write((json.dumps(
                        {"id": req.get("id"), "stats": server.stats_dict()}
                    ) + "\n").encode())
                    await writer.drain()
                    continue
                img = np.frombuffer(
                    base64.b64decode(req["image_b64"]), np.uint8
                ).reshape(req["shape"])
                kw = {}
                if req.get("variant") is not None:
                    # only MultiVariantServer accepts this; on a single-
                    # variant server the TypeError is echoed as the error
                    kw["variant"] = req["variant"]
                top = await server.submit(img, **kw)
                resp = {"id": req.get("id"), "top": top}
            except Exception as e:
                # Echo the request id whenever the JSON itself parsed, so a
                # client multiplexing requests on one connection can correlate
                # the failure; null only when json.loads failed.
                rid = req.get("id") if isinstance(req, dict) else None
                resp = {"id": rid, "error": str(e)}
            writer.write((json.dumps(resp) + "\n").encode())
            await writer.drain()
        writer.close()

    # asyncio's default 64 KiB line limit rejects any realistic image frame
    # (one 128x128x3 b64 payload is already ~65.5 KB); size for a 224x224
    # uint8 image with b64 + JSON overhead, with headroom.
    return await asyncio.start_server(handle, host, port, limit=32 * 1024 * 1024)


async def serve_tcp(server: MicroBatchServer, host: str, port: int):
    srv = await make_tcp_server(server, host, port)
    async with srv:
        await srv.serve_forever()


# ---------------------------------------------------------------------------
# 64-stream in-process load test (SURVEY.md SS3.5 serve mode metrics)
# ---------------------------------------------------------------------------


async def selftest(server: MicroBatchServer, streams: int = 64,
                   requests_per_stream: int = 8) -> Dict[str, float]:
    res = server.pipeline.config.resolution
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (8, res, res, 3), dtype=np.uint8)
    latencies: List[float] = []

    async def one_stream(sid: int):
        for k in range(requests_per_stream):
            t0 = time.perf_counter()
            await server.submit(frames[(sid + k) % len(frames)])
            latencies.append(time.perf_counter() - t0)

    t0 = time.perf_counter()
    await asyncio.gather(*(one_stream(s) for s in range(streams)))
    wall = time.perf_counter() - t0
    n = streams * requests_per_stream
    return {
        "streams": streams,
        "requests": n,
        "images_per_sec": n / wall,
        "p50_latency_ms": float(np.percentile(latencies, 50) * 1e3),
        "p99_latency_ms": float(np.percentile(latencies, 99) * 1e3),
        "mean_batch_fill": server.stats.batch_fill / max(server.stats.batches, 1),
        "bucket_counts": {str(k): v for k, v
                          in sorted(server.stats.bucket_counts.items())},
        "errors": server.stats.errors,
    }


class MultiVariantServer:
    """Route requests across several model variants served from ONE process.

    The reference is one-bitstream-per-configuration (SURVEY.md SS5) —
    switching variants means reprogramming the FPGA. Here a variant is
    just another set of compiled entries + HBM-resident weights, so one
    process can serve a latency tier (e.g. 0.25-128) and an accuracy tier
    (1.0-224) side by side: each variant keeps its own MicroBatchServer
    (its own buckets, batcher and stats; the single device executes them
    all), and a request opts in with an optional "variant" field, falling
    back to the default variant otherwise.
    """

    def __init__(self, servers: Dict[str, MicroBatchServer],
                 default: Optional[str] = None):
        if not servers:
            raise ValueError("MultiVariantServer needs at least one variant")
        self.servers = dict(servers)
        self.default = default or next(iter(self.servers))
        if self.default not in self.servers:
            raise ValueError(
                f"default variant {self.default!r} not among "
                f"{sorted(self.servers)}")

    async def start(self):
        for s in self.servers.values():
            await s.start()

    async def close(self):
        for s in self.servers.values():
            await s.close()

    async def submit(self, image_u8: np.ndarray, top_k: int = 5,
                     variant: Optional[str] = None):
        name = variant or self.default
        try:
            server = self.servers[name]
        except KeyError:
            raise ValueError(
                f"unknown variant {name!r}; serving {sorted(self.servers)}"
            ) from None
        return await server.submit(image_u8, top_k=top_k)

    def stats_dict(self) -> Dict[str, Any]:
        return {
            "default": self.default,
            "variants": {n: s.stats_dict() for n, s in self.servers.items()},
        }


async def selftest_multi(server: "MultiVariantServer", streams: int = 64,
                         requests_per_stream: int = 8) -> Dict[str, Any]:
    """Concurrent MIXED load across every served variant: stream s pins to
    variant s % n_variants and all streams are in flight together, so the
    device interleaves batches of different configs — the scenario the
    reference cannot express at all (one bitstream per config, SURVEY.md SS5).
    Reports aggregate throughput plus per-variant p50/p99."""
    names = sorted(server.servers)
    rng = np.random.default_rng(0)
    frames = {
        n: rng.integers(0, 256, (8, s.pipeline.config.resolution,
                                 s.pipeline.config.resolution, 3),
                        dtype=np.uint8)
        for n, s in server.servers.items()
    }
    lat: Dict[str, List[float]] = {n: [] for n in names}
    errors_before = sum(s.stats.errors for s in server.servers.values())

    async def one_stream(sid: int):
        name = names[sid % len(names)]
        for k in range(requests_per_stream):
            t0 = time.perf_counter()
            await server.submit(frames[name][(sid + k) % 8], variant=name)
            lat[name].append(time.perf_counter() - t0)

    t0 = time.perf_counter()
    await asyncio.gather(*(one_stream(s) for s in range(streams)))
    wall = time.perf_counter() - t0
    n = streams * requests_per_stream
    return {
        "mode": "mixed-variants",
        "streams": streams,
        "requests": n,
        "images_per_sec": n / wall,
        "per_variant_p50_ms": {
            name: float(np.percentile(v, 50) * 1e3)
            for name, v in lat.items() if v
        },
        "per_variant_p99_ms": {
            name: float(np.percentile(v, 99) * 1e3)
            for name, v in lat.items() if v
        },
        "errors": sum(s.stats.errors for s in server.servers.values())
                  - errors_before,
    }


def build_pipeline(cfg, seed, mesh, params, int8):
    if int8:
        # Quantized serving — the reference's multi-stream mode ran its
        # fixed-point FPGA pipeline (SURVEY.md SS2 C7/C12). Model family
        # dispatches on the config type, like InferencePipeline.
        from ..models.mobilenet_v2 import V2Config

        if isinstance(cfg, V2Config):
            from ..quant.v2 import Int8PipelineV2

            return Int8PipelineV2(cfg, seed=seed, mesh=mesh, params=params)
        from ..models.mobilenet_v3 import V3Config

        if isinstance(cfg, V3Config):
            from ..quant.v3 import Int8PipelineV3

            return Int8PipelineV3(cfg, seed=seed, mesh=mesh, params=params)
        from ..quant.model import Int8Pipeline

        return Int8Pipeline(cfg, seed=seed, mesh=mesh, params=params)
    from .pipeline import InferencePipeline

    return InferencePipeline(cfg, seed=seed, mesh=mesh, params=params)


def build_server(cfgs: Dict[str, ModelConfig], streams: int, *, seed: int = 0,
                 mesh=None, params=None, int8: bool = False,
                 multi: bool = False):
    """Build the serving object for `cfgs` ({variant_name: ModelConfig}).

    `multi=True` (any --variants deployment, even a single-entry list) always
    wraps in MultiVariantServer: its clients name variants in requests, which
    a bare MicroBatchServer.submit would reject with a TypeError. Returns
    (server, {name: MicroBatchServer}) — the dict gives selftests/stat
    readers per-variant access either way."""
    servers = {
        name: MicroBatchServer(
            build_pipeline(c, seed, mesh, params, int8), max_batch=streams)
        for name, c in cfgs.items()
    }
    if multi:
        return MultiVariantServer(servers), servers
    if len(servers) != 1:
        raise ValueError("multiple configs require multi=True")
    return next(iter(servers.values())), servers


def serve_main(alpha: float, res: int, dtype: str, streams: int, port: int,
               seed: int = 0, selftest_only: bool = True, int8: bool = False,
               dp: int = 1, params=None, variants=None, model: str = "v1",
               minimalistic: bool = False):
    """`dp`: data-parallel width — batches shard over a `dp`-device mesh
    (shard_map; params replicated). 1 = one device.

    `variants`: optional list of "alpha:res" (or "v2:alpha:res") strings —
    serve SEVERAL model variants from one process (MultiVariantServer),
    across model FAMILIES if named; the first is the default, requests pick
    one with a "variant" field named like "mobilenet_v1_0.25_128" or
    "mobilenet_v2_1.0_224". alpha/res/model are ignored when set."""
    mesh = None
    if dp > 1:
        from ..parallel.mesh import make_mesh

        if streams % dp != 0:
            raise ValueError(
                f"--streams ({streams}) must be a multiple of --dp ({dp}): "
                "the padded micro-batch shards evenly over the mesh")
        mesh = make_mesh(dp, model_parallel=1)

    def _make_cfg(model_name, a, r):
        if model_name == "v2":
            from ..models.mobilenet_v2 import V2Config

            return V2Config(alpha=float(a), resolution=int(r),
                            compute_dtype=dtype)
        if model_name in ("v3", "v3small"):
            from ..models.mobilenet_v3 import V3Config

            return V3Config(variant="large" if model_name == "v3" else "small",
                            alpha=float(a), resolution=int(r),
                            minimalistic=minimalistic,
                            compute_dtype=dtype)
        return ModelConfig(alpha=float(a), resolution=int(r),
                           compute_dtype=dtype)

    if variants:
        if params is not None:
            raise ValueError(
                "--ckpt applies to a single variant; multi-variant serving "
                "uses each variant's default weight set")
        pairs = []
        for v in variants:
            parts = v.split(":")
            if len(parts) == 3:  # "v2:alpha:res" — family-qualified
                m, a, r = parts
            else:
                (a, r), m = parts, "v1"
            pairs.append(_make_cfg(m, a, r))
        cfgs = {c.variant_name(): c for c in pairs}
    else:
        cfg = _make_cfg(model, alpha, res)
        cfgs = {cfg.variant_name(): cfg}

    async def run():
        server, servers = build_server(
            cfgs, streams, seed=seed, mesh=mesh, params=params, int8=int8,
            multi=bool(variants))
        await server.start()
        for name, sub in servers.items():
            stats = await selftest(
                sub, streams=max(1, streams // len(servers)))
            if variants:
                stats["variant"] = name
            print(json.dumps(stats))
        if variants and len(servers) > 1:
            # The multi-variant point: all variants under concurrent load
            # from ONE process (per-variant selftests above are sequential).
            for sub in servers.values():
                sub.stats.reset_window()
            print(json.dumps(await selftest_multi(server, streams=streams)))
        if not selftest_only:
            print(f"serving on tcp://0.0.0.0:{port} "
                  f"(variants: {sorted(cfgs)})")
            await serve_tcp(server, "0.0.0.0", port)
        await server.close()

    asyncio.run(run())
