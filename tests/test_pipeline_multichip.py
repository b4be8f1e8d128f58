"""Data-parallel inference pipeline over the 8-device virtual CPU mesh:
the multi-device serving path (params replicated, batch sharded, the network
local per shard via shard_map)."""

import numpy as np

from mobilenet_tpu import ModelConfig
from mobilenet_tpu.parallel import mesh as pmesh
from mobilenet_tpu.runtime.pipeline import InferencePipeline


def test_dp_pipeline_matches_single_device():
    cfg = ModelConfig(alpha=0.25, resolution=128)
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, (16, 128, 128, 3), dtype=np.uint8)

    single = InferencePipeline(cfg, seed=0)
    mesh = pmesh.make_mesh(8, model_parallel=1)
    multi = InferencePipeline(cfg, seed=0, mesh=mesh)

    p_single = single.run_batch(imgs)
    p_multi = multi.run_batch(imgs)
    assert p_multi.shape == (16, 1000)
    np.testing.assert_allclose(p_multi, p_single, atol=1e-5, rtol=1e-4)


def test_dp_pipeline_benchmark_runs():
    cfg = ModelConfig(alpha=0.25, resolution=128)
    mesh = pmesh.make_mesh(8, model_parallel=1)
    pipe = InferencePipeline(cfg, seed=0, mesh=mesh)
    stats = pipe.benchmark(batch_size=16, steps=2, warmup=1)
    assert stats["images_per_sec"] > 0


def test_int8_dp_pipeline_bit_exact_vs_single_device():
    """INT8 DP over the mesh must be bit-identical to single-device int8 —
    the per-shard network is the same integer program (SURVEY.md SS2 C7+C12:
    the reference served its fixed-point pipeline multi-stream)."""
    from mobilenet_tpu.quant.model import Int8Pipeline

    cfg = ModelConfig(alpha=0.25, resolution=128)
    rng = np.random.default_rng(1)
    imgs = rng.integers(0, 256, (16, 128, 128, 3), dtype=np.uint8)

    single = Int8Pipeline(cfg, seed=0)
    mesh = pmesh.make_mesh(8, model_parallel=1)
    multi = Int8Pipeline(cfg, seed=0, mesh=mesh)

    p_single = single.run_batch(imgs)
    p_multi = multi.run_batch(imgs)
    assert p_multi.shape == (16, 1000)
    np.testing.assert_array_equal(p_multi, p_single)


def test_make_mesh_clear_error_when_devices_short():
    import pytest

    with pytest.raises(ValueError, match="need 16 devices, have 8"):
        pmesh.make_mesh(16)
