"""Profiling / metrics / debug subsystem tests (SURVEY.md SS5)."""

import json

import jax.numpy as jnp
import numpy as np

from mobilenet_tpu import ModelConfig
from mobilenet_tpu.checkpoints import fold_bn, init_params, to_device
from mobilenet_tpu.utils import debug, profiling


def test_flops_model_matches_paper():
    # ~569M MACs for 1.0-224 (arXiv:1704.04861; BASELINE.md "Model cost").
    macs = profiling.flops_per_image(ModelConfig(alpha=1.0, resolution=224))
    assert 5.3e8 < macs < 6.1e8


def test_cost_analysis_reports_flops():
    costs = profiling.cost_analysis(
        lambda a, b: jnp.dot(a, b), jnp.ones((256, 256)), jnp.ones((256, 256))
    )
    assert costs.get("flops", 0) >= 2 * 256**3 * 0.9


def test_checked_forward_flags_nan():
    cfg = ModelConfig(alpha=0.25, resolution=128)
    params = to_device(fold_bn(init_params(cfg, seed=0), eps=cfg.bn_eps))
    x = jnp.zeros((1, 128, 128, 3), jnp.float32)
    err, logits = debug.checked_forward(params, x, cfg)
    err.throw()  # clean input: no error
    assert logits.shape == (1, 1000)

    bad = params.copy()
    bad["fc"] = dict(bad["fc"], w=bad["fc"]["w"] * jnp.nan)
    err, _ = debug.checked_forward(bad, x, cfg)
    got = None
    try:
        err.throw()
    except Exception as e:
        got = e
    assert got is not None, "NaN weights must trip float_checks"


def test_assert_finite_tree():
    debug.assert_finite_tree({"a": np.ones(3)})
    try:
        debug.assert_finite_tree({"a": np.array([1.0, np.inf])})
        raise SystemError("should have raised")
    except AssertionError:
        pass


def test_run_report_json():
    from mobilenet_tpu.runtime.metrics import build_report
    from mobilenet_tpu.runtime.pipeline import InferencePipeline

    pipe = InferencePipeline(ModelConfig(alpha=0.25, resolution=128), seed=0)
    stats = {"images_per_sec": 1000.0, "p50_latency_ms": 1.0,
             "p99_latency_ms": 2.0, "batch_size": 8, "wall_s": 1.0}
    report = build_report(pipe, stats)
    doc = json.loads(report.to_json())
    assert doc["variant"] == "mobilenet_v1_0.25_128"
    assert doc["model_macs_per_image"] > 1e7
    assert doc["device_kind"] == "cpu"
    assert doc["mfu"] is None  # no GPU peak applies on the CPU


def test_bench_profile_flag(tmp_path):
    """cli bench --profile captures a trace directory (SURVEY SS5 tracing)."""
    import json
    import os

    from mobilenet_tpu import cli

    prof = str(tmp_path / "trace")
    out_lines = []
    import builtins
    real_print = builtins.print
    try:
        builtins.print = lambda *a, **k: out_lines.append(" ".join(map(str, a)))
        cli.main(["--backend", "cpu", "bench", "--alpha", "0.25", "--res", "64",
                  "--batch", "2", "--steps", "1", "--profile", prof])
    finally:
        builtins.print = real_print
    stats = json.loads(out_lines[-1])
    assert stats["profile_dir"] == prof
    assert os.path.isdir(prof) and os.listdir(prof)  # trace files written


