"""Round-3 feature tests: TP guard, structured synthetic eval images,
warmup."""

import numpy as np
import pytest

from mobilenet_tpu import ModelConfig


# ---------------------------------------------------------------------------
# TP guard: pipelines reject model-parallel meshes instead of silently DP-ing
# ---------------------------------------------------------------------------


def test_pipeline_rejects_tp_mesh():
    from mobilenet_tpu.parallel.mesh import make_mesh
    from mobilenet_tpu.runtime.pipeline import InferencePipeline

    cfg = ModelConfig(alpha=0.25, resolution=64, compute_dtype="float32")
    mesh = make_mesh(8, model_parallel=2)
    with pytest.raises(ValueError, match="data-parallel only"):
        InferencePipeline(cfg, seed=0, mesh=mesh)


def test_int8_pipeline_rejects_tp_mesh():
    from mobilenet_tpu.parallel.mesh import make_mesh
    from mobilenet_tpu.quant.model import Int8Pipeline

    cfg = ModelConfig(alpha=0.25, resolution=64)
    mesh = make_mesh(8, model_parallel=4)
    with pytest.raises(ValueError, match="data-parallel only"):
        Int8Pipeline(cfg, seed=0, mesh=mesh)


def test_pipeline_accepts_dp_mesh():
    from mobilenet_tpu.parallel.mesh import make_mesh
    from mobilenet_tpu.runtime.pipeline import InferencePipeline

    cfg = ModelConfig(alpha=0.25, resolution=64, compute_dtype="float32")
    mesh = make_mesh(8, model_parallel=1)  # trivial model axis is fine
    pipe = InferencePipeline(cfg, seed=0, mesh=mesh)
    img = np.zeros((8, 64, 64, 3), np.uint8)
    assert pipe.run_batch(img).shape == (8, 1000)


# ---------------------------------------------------------------------------
# structured synthetic images
# ---------------------------------------------------------------------------


def test_synth_structured_deterministic_and_diverse():
    from mobilenet_tpu.runtime.eval import synth_images

    cfg = ModelConfig(alpha=0.25, resolution=64)
    a = synth_images(cfg, 8, seed=3)
    b = synth_images(cfg, 8, seed=3)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert all(im.shape == (64, 64, 3) and im.dtype == np.uint8 for im in a)
    # the four families must actually differ in texture: a gradient's
    # per-row variance is far below iid noise's
    noise, grad = a[0], a[1]
    assert np.std(np.diff(grad.astype(int), axis=1)) < \
        np.std(np.diff(noise.astype(int), axis=1)) / 2
    # legacy pure-noise mode reproduces the old recordings' family
    legacy = synth_images(cfg, 4, seed=3, structured=False)
    rng = np.random.default_rng(3)
    np.testing.assert_array_equal(
        legacy[0], rng.integers(0, 256, (64, 64, 3), dtype=np.uint8))


def test_eval_structured_images_agree():
    from mobilenet_tpu.runtime.eval import evaluate_agreement, synth_images

    cfg = ModelConfig(alpha=0.25, resolution=64, compute_dtype="float32")
    images = synth_images(cfg, 8, seed=11)
    report = evaluate_agreement(cfg, images, batch_size=4, tie_margin=1e-3)
    assert report["top1_agreement_tie_aware"] == 1.0


def test_cli_warmup_precompiles_and_exits_clean(monkeypatch, capsys):
    """`cli warmup` drives one real forward per requested batch and reports
    per-batch compile/cache status (production cold-start bounding)."""
    import sys as _sys

    from mobilenet_tpu import cli

    argv = ["cli", "--backend", "cpu", "warmup", "--alpha", "0.25",
            "--res", "64", "--batches", "2,1"]
    monkeypatch.setattr(_sys, "argv", argv)
    cli.main()
    out = capsys.readouterr().out
    assert "warm batch    1" in out and "warm batch    2" in out
    assert "WARMUP OK: mobilenet_v1_0.25_64 bfloat16 batches=[1, 2]" in out
