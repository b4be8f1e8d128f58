"""Micro-batching server tests (64-stream serve mode, SURVEY.md SS3.3/3.5)."""

import asyncio

import numpy as np
import pytest

from mobilenet_tpu import ModelConfig
from mobilenet_tpu.runtime.pipeline import InferencePipeline
from mobilenet_tpu.runtime.serving import MicroBatchServer, selftest


@pytest.fixture(scope="module")
def pipe():
    return InferencePipeline(ModelConfig(alpha=0.25, resolution=128), seed=0)


def test_selftest_64_streams(pipe):
    async def run():
        server = MicroBatchServer(pipe, max_batch=16, max_delay_ms=5.0)
        await server.start()
        stats = await selftest(server, streams=64, requests_per_stream=2)
        await server.close()
        return stats

    stats = asyncio.run(run())
    assert stats["requests"] == 128
    assert stats["errors"] == 0
    assert stats["images_per_sec"] > 0
    # micro-batching must actually batch: with 64 concurrent streams and
    # max_batch 16, mean fill should be well above a single request per batch.
    assert stats["mean_batch_fill"] > 0.3


def test_per_stream_error_isolation(pipe):
    async def run():
        server = MicroBatchServer(pipe, max_batch=8, max_delay_ms=2.0)
        await server.start()
        good = np.zeros((128, 128, 3), np.uint8)
        bad = np.zeros((64, 64, 3), np.uint8)  # wrong size -> per-request error

        results = await asyncio.gather(
            server.submit(good), server.submit(bad), server.submit(good),
            return_exceptions=True,
        )
        await server.close()
        return results

    r = asyncio.run(run())
    assert not isinstance(r[0], Exception)
    assert isinstance(r[1], Exception)
    assert not isinstance(r[2], Exception)
    assert len(r[0]) == 5  # top-5


def test_results_match_direct_batch(pipe):
    async def run():
        server = MicroBatchServer(pipe, max_batch=4, max_delay_ms=2.0)
        await server.start()
        rng = np.random.default_rng(0)
        img = rng.integers(0, 256, (128, 128, 3), dtype=np.uint8)
        out = await server.submit(img, top_k=3)
        await server.close()
        return img, out

    img, out = asyncio.run(run())
    probs = pipe.run_batch(img[None])[0]
    idx = np.argsort(-probs)[:3]
    assert [c for c, _ in out] == [int(i) for i in idx]


def test_int8_serving_selftest():
    """Quantized multi-stream serving (reference analog: the FPGA fixed-point
    pipeline under the 64-stream host loop, SURVEY.md SS2 C7/C12)."""
    from mobilenet_tpu.quant.model import Int8Pipeline

    pipe = Int8Pipeline(ModelConfig(alpha=0.25, resolution=128), seed=0)

    async def run():
        server = MicroBatchServer(pipe, max_batch=8, max_delay_ms=5.0)
        await server.start()
        stats = await selftest(server, streams=16, requests_per_stream=2)
        await server.close()
        return stats

    stats = asyncio.run(run())
    assert stats["requests"] == 32
    assert stats["errors"] == 0


def test_dp_serving_over_mesh():
    """Data-parallel serving: a mesh-backed pipeline behind the micro-batcher
    (the multi-chip analog of the reference's multi-stream mode). Results
    must match the single-device pipeline on the same requests."""
    from mobilenet_tpu.parallel.mesh import make_mesh

    cfg = ModelConfig(alpha=0.25, resolution=64, compute_dtype="float32")
    mesh = make_mesh(8, model_parallel=1)
    dp_pipe = InferencePipeline(cfg, seed=0, mesh=mesh)
    ref_pipe = InferencePipeline(cfg, seed=0)
    img = np.random.default_rng(3).integers(0, 256, (64, 64, 3), dtype=np.uint8)

    async def run():
        server = MicroBatchServer(dp_pipe, max_batch=8, max_delay_ms=2.0)
        await server.start()
        top = await server.submit(img)
        stats = await selftest(server, streams=16, requests_per_stream=2)
        await server.close()
        return top, stats

    top, stats = asyncio.run(run())
    assert stats["errors"] == 0
    want = ref_pipe.classify(img)
    assert [c for c, _ in top] == [c for c, _ in want]


def test_dp_serving_int8_over_mesh():
    from mobilenet_tpu.parallel.mesh import make_mesh
    from mobilenet_tpu.quant.model import Int8Pipeline

    cfg = ModelConfig(alpha=0.25, resolution=64)
    mesh = make_mesh(8, model_parallel=1)
    dp_pipe = Int8Pipeline(cfg, seed=0, mesh=mesh)
    ref_pipe = Int8Pipeline(cfg, seed=0)
    img = np.random.default_rng(4).integers(0, 256, (64, 64, 3), dtype=np.uint8)

    async def run():
        server = MicroBatchServer(dp_pipe, max_batch=8, max_delay_ms=2.0)
        await server.start()
        top = await server.submit(img)
        await server.close()
        return top

    top = asyncio.run(run())
    # int8 is exact integer arithmetic: DP sharding must not change anything.
    probs = ref_pipe.run_batch(img[None])[0]
    idx = np.argsort(-probs)[:5]
    assert [c for c, _ in top] == [int(i) for i in idx]


def test_batch_bucket_selection_light_load(pipe):
    """One lone request must dispatch in the SMALLEST bucket, not pad to
    max_batch (round-3 latency tiering, VERDICT.md weak #1)."""

    async def run():
        server = MicroBatchServer(pipe, max_batch=16, max_delay_ms=1.0,
                                  batch_buckets=[1, 4, 16])
        await server.start()
        img = np.zeros((128, 128, 3), np.uint8)
        await server.submit(img)
        # a 3-request burst fits bucket 4
        await asyncio.gather(*(server.submit(img) for _ in range(3)))
        stats = server.stats
        await server.close()
        return stats

    stats = asyncio.run(run())
    assert stats.bucket_counts.get(1) == 1
    # the burst may drain as one batch of 3 (bucket 4) or split across
    # batches; either way nothing lands in bucket 16
    assert 16 not in stats.bucket_counts
    assert sum(stats.bucket_counts.values()) == stats.batches


def test_stats_reset_window(pipe):
    """reset_window zeroes per-window load counters but keeps cumulative
    failure-detection state, so a load probe's per-phase mean_batch_fill
    is per-phase (not accumulated across load levels)."""

    async def run():
        server = MicroBatchServer(pipe, max_batch=16, max_delay_ms=1.0,
                                  batch_buckets=[1, 16])
        await server.start()
        img = np.zeros((128, 128, 3), np.uint8)
        await server.submit(img)
        server.stats.errors = 3  # stand-in for prior-window failures
        server.stats.reset_window()
        assert server.stats.batches == 0
        assert server.stats.batch_fill == 0.0
        assert server.stats.bucket_counts == {}
        assert server.stats.errors == 3  # cumulative state survives
        await server.submit(img)
        stats = server.stats
        await server.close()
        return stats

    stats = asyncio.run(run())
    assert stats.batches == 1
    assert stats.bucket_counts.get(1) == 1


def test_batch_bucket_validation(pipe):
    with pytest.raises(ValueError, match="batch_buckets"):
        MicroBatchServer(pipe, max_batch=16, batch_buckets=[1, 8])  # no 16


def test_batch_buckets_respect_dp_mesh():
    """Default buckets over a DP mesh must all shard evenly (no bucket-1
    entry that an 8-device shard_map would reject)."""
    from mobilenet_tpu.parallel.mesh import make_mesh

    cfg = ModelConfig(alpha=0.25, resolution=64, compute_dtype="float32")
    mesh = make_mesh(8, model_parallel=1)
    dp_pipe = InferencePipeline(cfg, seed=0, mesh=mesh)

    async def run():
        server = MicroBatchServer(dp_pipe, max_batch=16, max_delay_ms=1.0)
        buckets = server.batch_buckets
        await server.start()
        img = np.zeros((64, 64, 3), np.uint8)
        top = await server.submit(img)
        await server.close()
        return buckets, top

    buckets, top = asyncio.run(run())
    assert all(b % 8 == 0 for b in buckets)
    assert buckets[-1] == 16
    assert len(top) == 5


def test_serve_main_streams_dp_mismatch():
    from mobilenet_tpu.runtime.serving import serve_main

    with pytest.raises(ValueError, match="multiple of --dp"):
        serve_main(alpha=0.25, res=64, dtype="float32", streams=6, port=0, dp=4)


def test_device_retry_recovers_transient_failure():
    """A transient device error (e.g. the chip's FailedPrecondition storm)
    is retried; requests succeed on the second attempt."""

    class FlakyPipeline:
        def __init__(self, inner):
            self._inner = inner
            self._fails = 0  # armed after the server's warm-up call
            self.config = inner.config

        def run_batch(self, images):
            if self._fails > 0:
                self._fails -= 1
                raise RuntimeError("FAILED_PRECONDITION: device halted")
            return self._inner.run_batch(images)

    cfg = ModelConfig(alpha=0.25, resolution=64, compute_dtype="float32")
    flaky = FlakyPipeline(InferencePipeline(cfg, seed=0))
    img = np.zeros((64, 64, 3), np.uint8)

    async def run():
        server = MicroBatchServer(flaky, max_batch=4, max_delay_ms=1.0,
                                  retry_backoff_s=0.01)
        flaky._fails = 1
        await server.start()
        top = await server.submit(img)
        stats = server.stats
        await server.close()
        return top, stats

    top, stats = asyncio.run(run())
    assert len(top) == 5
    assert stats.retries == 1
    assert stats.errors == 0


def test_device_retry_exhaustion_fails_requests():
    class DeadPipeline:
        def __init__(self, cfg):
            self.config = cfg
            self.dead = False  # armed after the server's warm-up call

        def run_batch(self, images):
            if self.dead:
                raise RuntimeError("FAILED_PRECONDITION: device halted")
            return np.zeros((len(images), 1000), np.float32)

    cfg = ModelConfig(alpha=0.25, resolution=64, compute_dtype="float32")
    img = np.zeros((64, 64, 3), np.uint8)

    async def run():
        dead = DeadPipeline(cfg)
        server = MicroBatchServer(dead, max_batch=4,
                                  max_delay_ms=1.0, retry_backoff_s=0.01)
        dead.dead = True
        await server.start()
        with pytest.raises(RuntimeError, match="FAILED_PRECONDITION"):
            await server.submit(img)
        stats = server.stats
        await server.close()
        return stats

    stats = asyncio.run(run())
    assert stats.errors == 1


def test_multi_variant_server_routes_and_defaults():
    """MultiVariantServer: requests route by variant name; no variant ->
    default (the first); unknown variants fail their own request only."""
    from mobilenet_tpu.runtime.serving import MultiVariantServer

    cfg_a = ModelConfig(alpha=0.25, resolution=128)
    cfg_b = ModelConfig(alpha=0.25, resolution=64)
    pa = InferencePipeline(cfg_a, seed=0)
    pb = InferencePipeline(cfg_b, seed=0)

    async def run():
        mv = MultiVariantServer({
            cfg_a.variant_name(): MicroBatchServer(pa, max_batch=4,
                                                   max_delay_ms=1.0),
            cfg_b.variant_name(): MicroBatchServer(pb, max_batch=4,
                                                   max_delay_ms=1.0),
        })
        await mv.start()
        # serve-path images are pre-sized per variant (host decode path)
        img_a = np.zeros((128, 128, 3), np.uint8)
        img_b = np.zeros((64, 64, 3), np.uint8)
        t_default = await mv.submit(img_a)
        t_b = await mv.submit(img_b, variant=cfg_b.variant_name())
        with pytest.raises(ValueError, match="unknown variant"):
            await mv.submit(img_a, variant="nope")
        # routing is observable in the per-variant stats
        sa = mv.servers[cfg_a.variant_name()].stats.requests
        sb = mv.servers[cfg_b.variant_name()].stats.requests
        await mv.close()
        return t_default, t_b, sa, sb

    t_default, t_b, sa, sb = asyncio.run(run())
    assert len(t_default) == 5 and len(t_b) == 5
    assert sa == 1 and sb == 1  # default went to the first variant


def test_multi_variant_tcp_roundtrip():
    """The NDJSON front end routes the optional "variant" field."""
    import base64
    import json as _json

    from mobilenet_tpu.runtime.serving import (
        MicroBatchServer, MultiVariantServer, make_tcp_server)

    cfg_a = ModelConfig(alpha=0.25, resolution=64)
    cfg_b = ModelConfig(alpha=0.25, resolution=128)
    pa = InferencePipeline(cfg_a, seed=0)
    pb = InferencePipeline(cfg_b, seed=0)

    async def run():
        mv = MultiVariantServer({
            cfg_a.variant_name(): MicroBatchServer(pa, max_batch=2,
                                                   max_delay_ms=1.0),
            cfg_b.variant_name(): MicroBatchServer(pb, max_batch=2,
                                                   max_delay_ms=1.0),
        })
        await mv.start()
        srv = await make_tcp_server(mv, "127.0.0.1", 0)
        port = srv.sockets[0].getsockname()[1]
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        img_a = np.zeros((64, 64, 3), np.uint8)    # default variant res
        img_b = np.zeros((128, 128, 3), np.uint8)  # cfg_b res
        for rid, img, variant in [(1, img_a, None),
                                  (2, img_b, cfg_b.variant_name()),
                                  (3, img_a, "bogus")]:
            req = {"id": rid, "shape": list(img.shape),
                   "image_b64": base64.b64encode(img.tobytes()).decode()}
            if variant:
                req["variant"] = variant
            writer.write((_json.dumps(req) + "\n").encode())
        await writer.drain()
        resps = [_json.loads(await reader.readline()) for _ in range(3)]
        writer.close()
        srv.close()
        await srv.wait_closed()
        await mv.close()
        return {r["id"]: r for r in resps}

    by_id = asyncio.run(run())
    assert "top" in by_id[1] and "top" in by_id[2]
    assert "unknown variant" in by_id[3]["error"]

def test_selftest_multi_mixed_concurrent_load():
    """selftest_multi drives every variant concurrently from one process;
    per-variant latencies are reported and both sub-servers see traffic."""
    from mobilenet_tpu.runtime.serving import (
        MultiVariantServer, selftest_multi)

    cfg_a = ModelConfig(alpha=0.25, resolution=64)
    cfg_b = ModelConfig(alpha=0.25, resolution=128)
    pa = InferencePipeline(cfg_a, seed=0)
    pb = InferencePipeline(cfg_b, seed=0)

    async def run():
        mv = MultiVariantServer({
            cfg_a.variant_name(): MicroBatchServer(pa, max_batch=4,
                                                   max_delay_ms=1.0),
            cfg_b.variant_name(): MicroBatchServer(pb, max_batch=4,
                                                   max_delay_ms=1.0),
        })
        await mv.start()
        stats = await selftest_multi(mv, streams=4, requests_per_stream=2)
        per_variant = {n: s.stats.requests for n, s in mv.servers.items()}
        await mv.close()
        return stats, per_variant

    stats, per_variant = asyncio.run(run())
    assert stats["errors"] == 0
    assert stats["requests"] == 8
    assert set(stats["per_variant_p50_ms"]) == set(per_variant)
    assert all(v == 4 for v in per_variant.values())  # 2 streams x 2 reqs


def test_build_server_single_entry_variants_wraps_multi():
    """A single-entry --variants list still serves a MultiVariantServer:
    clients of a --variants deployment name the variant in requests."""
    from mobilenet_tpu.runtime.serving import MultiVariantServer, build_server

    cfg = ModelConfig(alpha=0.25, resolution=64)
    name = cfg.variant_name()

    async def run():
        server, servers = build_server({name: cfg}, streams=2, multi=True)
        assert isinstance(server, MultiVariantServer)
        await server.start()
        img = np.zeros((64, 64, 3), np.uint8)
        top = await server.submit(img, variant=name)  # named request works
        await server.close()
        return top

    assert len(asyncio.run(run())) == 5


def test_warmup_bucket_parity_with_server():
    """cli warmup's default batch list is exactly the buckets the production
    MicroBatchServer precompiles (shared default_buckets), incl. dp rounding."""
    from types import SimpleNamespace

    from mobilenet_tpu.runtime.serving import default_buckets

    cfg = ModelConfig(alpha=0.25, resolution=64)
    pipe = InferencePipeline(cfg, seed=0)
    server = MicroBatchServer(pipe, max_batch=64)
    assert default_buckets(64) == server.batch_buckets == [1, 8, 64]
    # dp rounding: every bucket a multiple of the mesh width
    fake_mesh = SimpleNamespace(devices=np.zeros(4))
    assert default_buckets(64, fake_mesh) == [4, 8, 64]


def test_tcp_stats_probe():
    """{"cmd": "stats"} on the NDJSON front end returns live counters —
    per-variant when serving a MultiVariantServer."""
    import base64
    import json as _json

    from mobilenet_tpu.runtime.serving import (
        MicroBatchServer, MultiVariantServer, make_tcp_server)

    cfg = ModelConfig(alpha=0.25, resolution=64)
    name = cfg.variant_name()
    pipe = InferencePipeline(cfg, seed=0)

    async def run():
        mv = MultiVariantServer(
            {name: MicroBatchServer(pipe, max_batch=2, max_delay_ms=1.0)})
        await mv.start()
        srv = await make_tcp_server(mv, "127.0.0.1", 0)
        port = srv.sockets[0].getsockname()[1]
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        img = np.zeros((64, 64, 3), np.uint8)
        req = {"id": 1, "shape": list(img.shape),
               "image_b64": base64.b64encode(img.tobytes()).decode()}
        writer.write((_json.dumps(req) + "\n").encode())
        writer.write((_json.dumps({"id": 2, "cmd": "stats"}) + "\n").encode())
        await writer.drain()
        r1 = _json.loads(await reader.readline())
        r2 = _json.loads(await reader.readline())
        writer.close()
        srv.close()
        await srv.wait_closed()
        await mv.close()
        return r1, r2

    r1, r2 = asyncio.run(run())
    assert "top" in r1
    v = r2["stats"]["variants"][name]
    assert v["requests"] == 1 and v["errors"] == 0
    assert v["buckets"] == [1, 2]
