"""Property-based fuzz over the framework's core numerical invariants
(hypothesis). Complements the fixed-shape oracle tests: these assert the
CONTRACTS — exact int8 arithmetic, oracle twin bit-agreement,
preprocessing range — on randomized shapes and values.
"""

import numpy as np
from hypothesis import given, settings, strategies as st

SHORT = settings(max_examples=20, deadline=None)


@SHORT
@given(st.integers(2, 16), st.integers(2, 16))
def test_quantize_input_properties(h, w):
    """Host input quantization: symmetric, clipped to ±127, round-half-even."""
    from mobilenet_tpu.quant.quantize import ACT_IN_SCALE, quantize_input

    rng = np.random.default_rng(h * 97 + w)
    x = rng.uniform(-2, 2, (1, h, w, 3)).astype(np.float32)
    q = quantize_input(x)
    assert q.dtype == np.int8
    assert q.min() >= -127 and q.max() <= 127
    # Exact definition: clip(rint(x / s))
    want = np.clip(np.rint(x / ACT_IN_SCALE), -127, 127).astype(np.int8)
    np.testing.assert_array_equal(q, want)
    # Symmetry: negating the input negates the code (no zero-point offset).
    np.testing.assert_array_equal(quantize_input(-x), -q)


@SHORT
@given(st.integers(4, 12), st.sampled_from([8, 16, 32]),
       st.sampled_from([1, 2]))
def test_oracle_twins_bit_identical_dw(h, c, stride):
    """NumPy and C++ fp32 depthwise oracles must agree bit-for-bit."""
    from mobilenet_tpu import cpu_ref
    from mobilenet_tpu.oracle import numpy_ref

    rng = np.random.default_rng(h * 31 + c + stride)
    x = rng.uniform(-1, 1, (2, h, h, c)).astype(np.float32)
    w = rng.normal(0, 0.4, (3, 3, 1, c)).astype(np.float32)
    b = rng.normal(0, 0.2, c).astype(np.float32)
    ref_np = numpy_ref.depthwise_ref(x, w, stride, b, True)
    ref_cpp = cpu_ref.dw3x3(x, w.reshape(3, 3, c), bias=b, stride=stride,
                            relu6=True)
    np.testing.assert_array_equal(ref_np, ref_cpp)


@SHORT
@given(st.integers(2, 8), st.sampled_from([8, 16]), st.sampled_from([8, 24]))
def test_oracle_twins_close_pw(h, cin, cout):
    """NumPy pw uses BLAS reduction order, C++ is cin-major — not bit-equal
    by design (tests/test_cpu_ref.py); must stay within reduction noise."""
    from mobilenet_tpu import cpu_ref
    from mobilenet_tpu.oracle import numpy_ref

    rng = np.random.default_rng(h + cin * 3 + cout)
    x = rng.uniform(-1, 1, (2, h, h, cin)).astype(np.float32)
    w = rng.normal(0, 0.5, (cin, cout)).astype(np.float32)
    b = rng.normal(0, 0.2, cout).astype(np.float32)
    np.testing.assert_allclose(
        numpy_ref.pointwise_ref(x, w, b, True),
        cpu_ref.pw(x, w, bias=b, relu6=True), atol=1e-5, rtol=1e-5)


@SHORT
@given(st.integers(4, 10), st.sampled_from([8, 16]), st.sampled_from([1, 2]))
def test_int8_oracle_twins_exact(h, c, stride):
    """Int8 dw: NumPy vs C++ oracle EXACT equality on random quantized data."""
    from mobilenet_tpu import cpu_ref
    from mobilenet_tpu.quant import oracle as qoracle

    rng = np.random.default_rng(h * 13 + c + stride)
    x = rng.integers(-127, 128, (1, h, h, c)).astype(np.int8)
    w = rng.integers(-127, 128, (3, 3, c)).astype(np.int8)
    bias = rng.integers(-1000, 1000, c).astype(np.int32)
    m = rng.uniform(1e-4, 1e-2, c).astype(np.float32)
    # NumPy oracle takes six_q = 6/s_out directly; C++ takes s_out and
    # derives the same clip (quantize.py:76).
    s_out = np.float32(6.0 / 127.0)
    six_q = np.float32(6.0) / s_out
    got_np = qoracle.dw3x3_i8(x, w.reshape(3, 3, 1, c), bias, m, six_q,
                              stride, True)
    got_cpp = cpu_ref.dw3x3_i8(x, w, bias, m, float(s_out), stride=stride,
                               relu6=True)
    np.testing.assert_array_equal(got_np, got_cpp)


@SHORT
@given(st.integers(8, 48), st.integers(8, 48), st.sampled_from([32, 64]))
def test_preprocess_range_and_shape(h, w, res):
    """On-device preprocessing: any input size -> (res, res), values in
    [-1, 1] for uint8 input."""
    from mobilenet_tpu.ops import preprocess as prep

    rng = np.random.default_rng(h * 7 + w + res)
    img = rng.integers(0, 256, (1, h, w, 3), dtype=np.uint8)
    out = np.asarray(prep.preprocess(img, res, np.float32))
    assert out.shape == (1, res, res, 3)
    assert out.min() >= -1.0 - 1e-6 and out.max() <= 1.0 + 1e-6


