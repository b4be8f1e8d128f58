"""Native C++ oracle vs NumPy twin: must agree BIT-FOR-BIT (same accumulation
order, no FMA). This pins the golden ground truth both ways (SURVEY.md SS7
stage 1)."""

import numpy as np
import pytest

from mobilenet_tpu import ModelConfig, cpu_ref
from mobilenet_tpu.checkpoints import fold_bn, init_params
from mobilenet_tpu.oracle import numpy_ref


@pytest.fixture(scope="module")
def lib():
    cpu_ref.build()
    return cpu_ref


@pytest.mark.parametrize("stride", [1, 2])
def test_dw_bitexact(lib, rng, stride):
    x = rng.uniform(-2, 2, (2, 14, 14, 32)).astype(np.float32)
    w = rng.normal(0, 0.5, (3, 3, 1, 32)).astype(np.float32)
    b = rng.normal(0, 0.1, (32,)).astype(np.float32)
    got = lib.dw3x3(x, w, b, stride, relu6=True)
    ref = numpy_ref.depthwise_ref(x, w, stride, b, relu6=True)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("stride", [1, 2])
def test_conv_bitexact(lib, rng, stride):
    x = rng.uniform(-2, 2, (2, 16, 16, 3)).astype(np.float32)
    w = rng.normal(0, 0.5, (3, 3, 3, 16)).astype(np.float32)
    b = rng.normal(0, 0.1, (16,)).astype(np.float32)
    got = lib.conv3x3(x, w, b, stride, relu6=True)
    ref = numpy_ref.conv2d_ref(x, w, stride, b, relu6=True)
    np.testing.assert_array_equal(got, ref)


def test_pw_close(lib, rng):
    # NumPy pw uses BLAS dot (its own order); C++ is cin-major. Not bit-equal,
    # but must be within fp32 reduction noise.
    x = rng.uniform(-2, 2, (1, 7, 7, 256)).astype(np.float32)
    w = rng.normal(0, 0.1, (256, 128)).astype(np.float32)
    b = rng.normal(0, 0.1, (128,)).astype(np.float32)
    got = lib.pw(x, w, b, relu6=True)
    ref = numpy_ref.pointwise_ref(x, w, b, relu6=True)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


def test_full_forward_matches_numpy_twin(lib):
    cfg = ModelConfig(alpha=0.25, resolution=128)
    folded = fold_bn(init_params(cfg, seed=3), eps=cfg.bn_eps)
    rng = np.random.default_rng(11)
    x = rng.uniform(-1, 1, (1, 128, 128, 3)).astype(np.float32)
    logits_c, acts_c = lib.forward_all(folded, x, cfg)
    logits_np, acts_np = numpy_ref.forward_all(folded, x, cfg)
    # dw/conv layers bit-exact; pw within reduction noise -> full path drifts
    # by fp32 noise only.
    np.testing.assert_array_equal(acts_c["conv1"], acts_np["conv1"])
    np.testing.assert_array_equal(acts_c["block00_dw"], acts_np["block00_dw"])
    np.testing.assert_allclose(logits_c, logits_np, atol=1e-4, rtol=1e-3)
    assert np.argmax(logits_c) == np.argmax(logits_np)


@pytest.mark.parametrize("module", ["cpu_ref", "native_io"])
def test_build_without_compiler_is_a_clear_error(module, monkeypatch):
    """A missing g++ surfaces as a RuntimeError naming the cause when the
    library is built, never as a crash at import."""
    import importlib
    import subprocess

    mod = importlib.import_module(f"mobilenet_tpu.{module}")

    def no_compiler(*a, **k):
        raise FileNotFoundError("g++")

    monkeypatch.setattr(subprocess, "run", no_compiler)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        mod.build(force=True)
