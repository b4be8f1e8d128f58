"""INT8 path tests: exact bit-match between device pipeline (CPU backend),
NumPy int8 twin, and native C++ int8 oracle
(BASELINE.json:10; SURVEY.md SS4 'INT8 path vs quantized oracle')."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mobilenet_tpu import ModelConfig, cpu_ref
from mobilenet_tpu.checkpoints import fold_bn, init_params
from mobilenet_tpu.quant import oracle as qoracle
from mobilenet_tpu.quant import ops as qops
from mobilenet_tpu.quant import quantize, quantize_input
from mobilenet_tpu.quant.verify import verify_int8


@pytest.fixture(scope="module")
def setup():
    cfg = ModelConfig(alpha=0.25, resolution=128)
    folded = fold_bn(init_params(cfg, seed=5), eps=cfg.bn_eps)
    q = quantize(folded, cfg)
    rng = np.random.default_rng(21)
    x = rng.uniform(-1, 1, (2, 128, 128, 3)).astype(np.float32)
    return cfg, folded, q, x


def test_device_vs_numpy_oracle_exact(setup):
    cfg, folded, q, x = setup
    assert verify_int8(cfg, folded, x, oracle="numpy")


def test_device_vs_cpp_oracle_exact(setup):
    cfg, folded, q, x = setup
    cpu_ref.build()
    assert verify_int8(cfg, folded, x, oracle="cpp")


def test_int8_top1_close_to_fp32(setup):
    """Accuracy gate: int8 top-1 should agree with fp32 on most inputs
    (exact agreement is not required by quantization, but gross divergence
    means broken scales)."""
    from mobilenet_tpu.models import mobilenet_v1
    from mobilenet_tpu.checkpoints import to_device
    from mobilenet_tpu.quant.model import _as_device_tree, forward_i8

    cfg, folded, q, x = setup
    rng = np.random.default_rng(3)
    xb = rng.uniform(-1, 1, (16, 128, 128, 3)).astype(np.float32)

    fp = jax.jit(lambda p, v: mobilenet_v1.forward(p, v, cfg))(
        to_device(folded), jnp.asarray(xb)
    )
    dev = _as_device_tree(q)
    qi = jax.jit(lambda v: forward_i8(dev, v, cfg))(jnp.asarray(quantize_input(xb)))
    top1_fp = np.argmax(np.asarray(fp), -1)
    top1_q = np.argmax(np.asarray(qi), -1)
    agreement = float((top1_fp == top1_q).mean())
    assert agreement >= 0.75, f"int8/fp32 top-1 agreement too low: {agreement}"


def test_requant_rounding_half_to_even():
    # acc * m landing exactly on .5 must round to even (nearbyintf semantics).
    acc = jnp.asarray([[1, 3, 5, -1, -3]], jnp.int32)
    m = jnp.asarray([0.5, 0.5, 0.5, 0.5, 0.5], jnp.float32)
    out = qops.requantize(acc, m, six_q=127.0, relu6=True)
    # 0.5->0, 1.5->2, 2.5->2, negatives clamp to 0 by ReLU
    np.testing.assert_array_equal(np.asarray(out)[0], [0, 2, 2, 0, 0])


@pytest.mark.parametrize("stride,h,c", [(1, 16, 8), (2, 16, 8), (1, 15, 24), (2, 14, 64)])
def test_depthwise_i8_xla_exact(rng, stride, h, c):
    """The int8 dw op must be integer-exact for any shape/stride; it is
    written as explicit taps so no grouped-conv algorithm choice can touch
    the arithmetic."""
    import jax.numpy as jnp

    from mobilenet_tpu.quant import ops as qops
    from mobilenet_tpu.quant import oracle as qoracle

    xi = rng.integers(-127, 128, (2, h, h, c)).astype(np.int8)
    w = rng.integers(-127, 128, (3, 3, 1, c)).astype(np.int8)
    b = rng.integers(-5000, 5000, (c,)).astype(np.int32)
    m = rng.uniform(0.001, 0.01, (c,)).astype(np.float32)
    six_q = np.float32(127.0)
    ref = qoracle.dw3x3_i8(xi, w, b, m, six_q, stride)
    got = np.asarray(qops.depthwise_i8_xla(
        jnp.asarray(xi), jnp.asarray(w), jnp.asarray(b), jnp.asarray(m),
        float(six_q), stride, True))
    np.testing.assert_array_equal(got, ref)


def test_bf16_quantized_input_bit_identical(setup):
    """quantize_input_dev(out_dtype=bfloat16) carries the same integers as
    the int8 input — the stem reads either and the logits must be
    BIT-IDENTICAL."""
    from mobilenet_tpu.quant.model import _as_device_tree, forward_i8
    from mobilenet_tpu.quant.quantize import ACT_IN_SCALE

    cfg, folded, q, x = setup
    dev = _as_device_tree(q)
    xj = jnp.asarray(x)
    q_i8 = np.asarray(jax.jit(
        lambda v: qops.quantize_input_dev(v, ACT_IN_SCALE))(xj))
    q_bf = np.asarray(jax.jit(
        lambda v: qops.quantize_input_dev(v, ACT_IN_SCALE,
                                          out_dtype=jnp.bfloat16))(xj))
    np.testing.assert_array_equal(q_i8.astype(np.float32),
                                  q_bf.astype(np.float32))
    ref = np.asarray(jax.jit(lambda v: forward_i8(dev, v, cfg))(
        jnp.asarray(q_i8)))
    got = np.asarray(jax.jit(lambda v: forward_i8(dev, v, cfg))(
        jnp.asarray(q_bf)))
    np.testing.assert_array_equal(ref, got)


