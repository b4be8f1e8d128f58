"""Every block kind on its one route, XLA, against the oracles: float blocks
against the NumPy oracle within a stated tolerance, int8 blocks against the
int8 oracle bit for bit.

The shape grids are those the removed fused kernels were tested at (V1
separable blocks, V2 inverted residuals, V3 SE / 5x5 / stride-2 bottlenecks,
the narrow stride-2 expand blocks, and the int8 twins of each), so every
geometry those kernels covered is still checked on the route that runs it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mobilenet_tpu.models import mobilenet_v2 as mv2
from mobilenet_tpu.models import mobilenet_v3 as mv3
from mobilenet_tpu.ops import conv as ops
from mobilenet_tpu.oracle import numpy_ref
from mobilenet_tpu.quant import oracle as qoracle
from mobilenet_tpu.quant import ops as qops
from mobilenet_tpu.quant import v2 as qv2
from mobilenet_tpu.quant import v3 as qv3
from mobilenet_tpu.quant.quantize import ACT_HIDDEN_SCALE, _quant_layer
from mobilenet_tpu.utils import golden

# Float32 block gate: one block's reductions reassociate against the
# oracle's fixed order (MM_TOL, utils/golden.py); SE adds a pool and two
# small matmuls, hard-swish one multiply per element (V3_TOL's reasoning
# at one block instead of a whole network).
BLOCK_TOL = golden.MM_TOL
SE_BLOCK_TOL = (1e-3, 1e-3)

# (n, h, cin, cout, stride): V1 separable blocks.
V1_SHAPES = [
    (2, 112, 32, 64, 1), (2, 112, 64, 128, 2), (1, 56, 128, 128, 1),
    (1, 28, 256, 512, 2), (4, 14, 512, 512, 1), (4, 7, 1024, 1024, 1),
    (2, 16, 8, 16, 1), (2, 8, 16, 32, 2), (1, 4, 256, 256, 1),
    (2, 16, 32, 32, 2), (1, 14, 24, 48, 2),
]
# (n, h, cin, e, cout, stride, residual): V2 inverted residuals.
V2_SHAPES = [
    (2, 14, 64, 384, 64, 1, True), (2, 14, 96, 576, 160, 2, False),
    (2, 7, 160, 960, 320, 1, False), (1, 8, 160, 960, 160, 1, True),
    (2, 28, 24, 144, 32, 2, False), (2, 16, 16, 96, 24, 2, False),
    (2, 9, 64, 384, 96, 1, False), (2, 112, 16, 96, 24, 2, False),
    (2, 56, 24, 144, 24, 1, True), (1, 48, 24, 144, 24, 1, True),
    (1, 16, 16, 64, 32, 2, False), (2, 32, 16, 64, 32, 2, False),
    (1, 16, 64, 128, 128, 2, False), (2, 16, 32, 64, 64, 2, False),
    (1, 32, 8, 32, 16, 2, False), (1, 16, 16, 96, 32, 2, False),
]
# (n, h, cin, e, cout, k, stride, se_mid, act, residual): V3 bottlenecks.
V3_SHAPES = [
    (2, 14, 64, 384, 64, 3, 1, 0, "relu", True),
    (2, 28, 24, 72, 40, 5, 2, 24, "relu", False),
    (2, 14, 40, 120, 40, 5, 1, 32, "relu", True),
    (2, 14, 112, 672, 160, 5, 2, 168, "hswish", False),
    (2, 8, 160, 960, 160, 5, 1, 240, "hswish", True),
    (2, 14, 80, 184, 80, 3, 1, 0, "hswish", True),
    (2, 9, 48, 144, 48, 5, 1, 40, "hswish", True),
    (2, 8, 40, 120, 40, 5, 1, 32, "hswish", True),
    (1, 16, 40, 120, 40, 5, 1, 32, "relu", True),
    (2, 8, 24, 72, 40, 5, 1, 24, "hswish", False),
    (1, 8, 40, 112, 80, 3, 1, 0, "hswish", False),
    (1, 8, 16, 64, 24, 5, 1, 16, "relu", False),
    (2, 112, 16, 64, 24, 3, 2, 0, "relu", False),
    (2, 56, 24, 144, 24, 3, 1, 0, "relu", True),
    (1, 48, 24, 72, 24, 3, 1, 0, "hswish", True),
]
# No-expand blocks (V2/V3 block 0): (n, h, c, cout, stride, se_mid, act).
NO_EXPAND_SHAPES = [
    (2, 32, 16, 16, 1, 0, "relu"), (1, 80, 16, 16, 1, 0, "relu"),
    (1, 24, 16, 16, 2, 8, "relu"), (1, 16, 32, 32, 2, 16, "relu"),
    (1, 112, 16, 16, 2, 8, "relu"), (2, 112, 32, 16, 1, 0, "relu"),
]


def _w(rng, shape, scale):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _v2_block(rng, cin, e, cout):
    blk = {}
    if e is not None:
        blk["exp"] = {"w": _w(rng, (cin, e), 1 / np.sqrt(cin)),
                      "b": _w(rng, (e,), 0.1)}
    c = cin if e is None else e
    blk["dw"] = {"w": _w(rng, (3, 3, 1, c), 0.3), "b": _w(rng, (c,), 0.1)}
    blk["prj"] = {"w": _w(rng, (c, cout), 1 / np.sqrt(c)),
                  "b": _w(rng, (cout,), 0.1)}
    return blk


def _v3_block(rng, cin, e, cout, k, se_mid):
    blk = _v2_block(rng, cin, e, cout)
    c = cin if e is None else e
    blk["dw"]["w"] = _w(rng, (k, k, 1, c), 0.3)
    if se_mid:
        blk["se"] = {"w1": _w(rng, (c, se_mid), 1 / np.sqrt(c)),
                     "b1": _w(rng, (se_mid,), 0.1),
                     "w2": _w(rng, (se_mid, c), 1 / np.sqrt(se_mid)),
                     "b2": _w(rng, (c,), 0.1)}
    return blk


def _bd(cin, e, cout, k, stride, se_mid, act):
    return mv3.V3BlockDef(cin=cin, cexp=e or cin, cout=cout, kernel=k,
                          stride=stride, se_mid=se_mid,
                          act="hswish" if act == "hswish" else "relu",
                          has_expand=e is not None)


def _v3_oracle(blk, x, bd):
    z = x
    if bd.has_expand:
        z = numpy_ref.pointwise_ref_any(z, blk["exp"]["w"], blk["exp"]["b"],
                                        act=bd.act)
    z = numpy_ref.depthwise_ref_any(z, blk["dw"]["w"], bd.stride,
                                    bias=blk["dw"]["b"], act=bd.act)
    if bd.se_mid:
        z = numpy_ref.se_ref(z, blk["se"])
    out = numpy_ref.pointwise_ref_any(z, blk["prj"]["w"], blk["prj"]["b"])
    return out + x if bd.has_res else out


def _check(got, ref, tol):
    rep = golden.compare_activations({"y": np.asarray(got)}, {"y": ref},
                                     tols={"y": tol})[0]
    assert rep.ok, rep


# -- float32 routes vs the NumPy oracle ------------------------------------


@pytest.mark.parametrize("n,h,cin,cout,stride", V1_SHAPES)
def test_v1_block_vs_oracle(n, h, cin, cout, stride):
    from mobilenet_tpu.models import mobilenet_v1

    rng = np.random.default_rng(h * 7 + cin)
    x = rng.uniform(0, 6, (n, h, h, cin)).astype(np.float32)
    blk = {"dw": {"w": _w(rng, (3, 3, 1, cin), 0.3), "b": _w(rng, (cin,), .1)},
           "pw": {"w": _w(rng, (cin, cout), 1 / np.sqrt(cin)),
                  "b": _w(rng, (cout,), .1)}}
    got = jax.jit(lambda b, v: mobilenet_v1.separable_block(
        b, v, stride, True))(blk, jnp.asarray(x))
    y = numpy_ref.depthwise_ref(x, blk["dw"]["w"], stride, blk["dw"]["b"],
                                relu6=True)
    ref = numpy_ref.pointwise_ref(y, blk["pw"]["w"], blk["pw"]["b"],
                                  relu6=True)
    _check(got, ref, BLOCK_TOL)


@pytest.mark.parametrize("n,h,cin,e,cout,stride,res", V2_SHAPES)
def test_v2_block_vs_oracle(n, h, cin, e, cout, stride, res):
    rng = np.random.default_rng(h * 11 + e)
    cout = cin if res else cout
    x = rng.uniform(-3, 3, (n, h, h, cin)).astype(np.float32)
    blk = _v2_block(rng, cin, e, cout)
    got = jax.jit(lambda b, v: mv2.inverted_residual(b, v, stride, res))(
        blk, jnp.asarray(x))
    z = numpy_ref.pointwise_ref(x, blk["exp"]["w"], blk["exp"]["b"],
                                relu6=True)
    z = numpy_ref.depthwise_ref(z, blk["dw"]["w"], stride, blk["dw"]["b"],
                                relu6=True)
    ref = numpy_ref.pointwise_ref(z, blk["prj"]["w"], blk["prj"]["b"])
    _check(got, ref + x if res else ref, BLOCK_TOL)


@pytest.mark.parametrize("n,h,cin,e,cout,k,stride,se,act,res", V3_SHAPES)
def test_v3_block_vs_oracle(n, h, cin, e, cout, k, stride, se, act, res):
    rng = np.random.default_rng(h * 13 + e + k)
    cout = cin if res else cout
    x = rng.uniform(-3, 3, (n, h, h, cin)).astype(np.float32)
    blk = _v3_block(rng, cin, e, cout, k, se)
    bd = _bd(cin, e, cout, k, stride, se, act)
    assert bd.has_res == res
    got = jax.jit(lambda b, v: mv3.bottleneck(b, v, bd))(blk, jnp.asarray(x))
    _check(got, _v3_oracle(blk, x, bd), SE_BLOCK_TOL if se else BLOCK_TOL)


@pytest.mark.parametrize("n,h,c,cout,stride,se,act", NO_EXPAND_SHAPES)
def test_no_expand_block_vs_oracle(n, h, c, cout, stride, se, act):
    rng = np.random.default_rng(h + c + stride)
    x = rng.uniform(0, 6, (n, h, h, c)).astype(np.float32)
    blk = _v3_block(rng, c, None, cout, 3, se)
    bd = _bd(c, None, cout, 3, stride, se, act)
    got = jax.jit(lambda b, v: mv3.bottleneck(b, v, bd))(blk, jnp.asarray(x))
    _check(got, _v3_oracle(blk, x, bd), SE_BLOCK_TOL if se else BLOCK_TOL)


# -- int8 routes vs the int8 oracle (bit-exact) -----------------------------


def _q_hidden(rng, w_shape, out_axis, k_taps=0):
    c = w_shape[out_axis]
    return _quant_layer(_w(rng, w_shape, 0.3), _w(rng, (c,), 0.1), out_axis,
                        ACT_HIDDEN_SCALE, ACT_HIDDEN_SCALE,
                        f32_bias_bound=bool(k_taps))


def _dev(layer):
    return {"w": jnp.asarray(layer.w_i8), "b": jnp.asarray(layer.bias_i32),
            "m": jnp.asarray(layer.m), "six_q": float(layer.six_q)}


@pytest.mark.parametrize("n,h,cin,cout,stride", V1_SHAPES)
def test_v1_int8_block_exact(n, h, cin, cout, stride):
    rng = np.random.default_rng(h * 3 + cin)
    d = _q_hidden(rng, (3, 3, 1, cin), 3, k_taps=9)
    p = _q_hidden(rng, (cin, cout), 1)
    x = rng.integers(0, 128, (n, h, h, cin)).astype(np.int8)
    mid = qoracle.dw3x3_i8(x, d.w_i8, d.bias_i32, d.m, d.six_q, stride)
    ref = qoracle.pw_i8(mid, p.w_i8, p.bias_i32, p.m, p.six_q)

    def block(v):
        dd, pp = _dev(d), _dev(p)
        y = qops.depthwise_i8_xla(v, dd["w"], dd["b"], dd["m"], dd["six_q"],
                                  stride)
        return qops.pointwise_i8(y, pp["w"], pp["b"], pp["m"], pp["six_q"])

    np.testing.assert_array_equal(np.asarray(jax.jit(block)(x)), ref)


@pytest.mark.parametrize("n,h,cin,e,cout,stride,res", V2_SHAPES)
def test_v2_int8_block_exact(n, h, cin, e, cout, stride, res):
    rng = np.random.default_rng(h * 5 + e)
    cout = cin if res else cout
    s_blk = np.float32(0.05)
    exp = _q_hidden(rng, (cin, e), 1)
    d = _q_hidden(rng, (3, 3, 1, e), 3, k_taps=9)
    prj = _quant_layer(_w(rng, (e, cout), 0.3), _w(rng, (cout,), 0.1), 1,
                       ACT_HIDDEN_SCALE, s_blk)
    x = rng.integers(-127, 128, (n, h, h, cin)).astype(np.int8)
    z = qoracle.pw_i8(x, exp.w_i8, exp.bias_i32, exp.m, exp.six_q)
    z = qoracle.dw3x3_i8(z, d.w_i8, d.bias_i32, d.m, d.six_q, stride)
    ref = qv2.pw_i8_linear(z, prj.w_i8, prj.bias_i32, prj.m)
    if res:
        ref = qv2._res_add(ref, x)
    blk = {"exp": _dev(exp), "dw": _dev(d), "prj": _dev(prj)}
    got = jax.jit(lambda v: qv2.block_v2_i8(blk, v, stride, res))(
        jnp.asarray(x))
    np.testing.assert_array_equal(np.asarray(got), ref)


def _qn(rng, w_shape, out_axis, s_in, s_out, k_taps=0):
    c = w_shape[out_axis]
    return qv3._quant_named(_w(rng, w_shape, 0.3), _w(rng, (c,), 0.1),
                            out_axis, np.float32(s_in), np.float32(s_out),
                            k_taps=k_taps)


def _dev_n(layer):
    return {"w": jnp.asarray(layer.w_i8), "b": jnp.asarray(layer.bias_i32),
            "a": jnp.asarray(layer.a), "inv_s": float(layer.inv_s)}


def _v3_int8_case(rng, n, h, cin, e, cout, k, stride, se, act):
    bd = _bd(cin, e, cout, k, stride, se, act)
    q = {}
    c = cin
    if e is not None:
        q["exp"] = _qn(rng, (cin, e), 1, 0.05, 0.06)
        c = e
    q["dw"] = _qn(rng, (k, k, 1, c), 3, 0.06 if e else 0.05, 0.07,
                  k_taps=k * k)
    if se:
        q["se1"] = _qn(rng, (c, se), 1, 0.07, 0.04)
        q["se2"] = _qn(rng, (se, c), 1, 0.04, 1.0)
    q["prj"] = _qn(rng, (c, cout), 1, 0.07, 0.05)
    x = rng.integers(-127, 128, (n, h, h, cin)).astype(np.int8)
    z = x
    if e is not None:
        z = qv3._requant_named_np(qv3._pw_acc_np(z, q["exp"].w_i8)
                                  + q["exp"].bias_i32, q["exp"].a,
                                  q["exp"].inv_s, bd.act)
    z = qv3._requant_named_np(
        qv3._dwk_acc_np(z, q["dw"].w_i8, stride, k) + q["dw"].bias_i32,
        q["dw"].a, q["dw"].inv_s, bd.act)
    if se:
        z = qv3._se_i8_np(z, q["se1"], q["se2"])
    ref = qv3._requant_named_np(qv3._pw_acc_np(z, q["prj"].w_i8)
                                + q["prj"].bias_i32, q["prj"].a,
                                q["prj"].inv_s, "linear")
    if bd.has_res:
        ref = np.clip(ref.astype(np.int32) + x.astype(np.int32),
                      -128, 127).astype(np.int8)
    blk = {name: _dev_n(layer) for name, layer in q.items()}
    got = jax.jit(lambda v: qv3.block_v3_i8(blk, v, bd))(jnp.asarray(x))
    np.testing.assert_array_equal(np.asarray(got), ref)


@pytest.mark.parametrize("n,h,cin,e,cout,k,stride,se,act,res", V3_SHAPES)
def test_v3_int8_block_exact(n, h, cin, e, cout, k, stride, se, act, res):
    rng = np.random.default_rng(h * 17 + e + k)
    _v3_int8_case(rng, n, h, cin, e, cin if res else cout, k, stride, se, act)


@pytest.mark.parametrize("n,h,c,cout,stride,se,act", NO_EXPAND_SHAPES)
def test_no_expand_int8_block_exact(n, h, c, cout, stride, se, act):
    rng = np.random.default_rng(h * 19 + c)
    _v3_int8_case(rng, n, h, c, None, cout, 3, stride, se, act)


@pytest.mark.parametrize("h,cin", [(16, 3), (15, 3), (32, 3), (9, 8)])
def test_stem_conv_exact_accumulator(h, cin):
    """conv3x3_s2_acc: the float32 stem conv returns the exact int32 sums
    for |x|, |w| <= 127 (the int8 stem of all three families)."""
    rng = np.random.default_rng(h + cin)
    x = rng.integers(-127, 128, (2, h, h, cin)).astype(np.int8)
    w = rng.integers(-127, 128, (3, 3, cin, 16)).astype(np.int8)
    got = np.asarray(jax.jit(qops.conv3x3_s2_acc)(jnp.asarray(x),
                                                   jnp.asarray(w)))
    np.testing.assert_array_equal(got, qv3._conv3x3_acc_np(x, w, 2))


def test_depthwise_conv_xla_matches_oracle_at_k5():
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (2, 10, 10, 24)).astype(np.float32)
    w = _w(rng, (5, 5, 1, 24), 0.3)
    got = ops.depthwise_conv_xla(jnp.asarray(x), jnp.asarray(w), 2)
    ref = numpy_ref.depthwise_ref_any(x, w, 2)
    _check(got, ref, BLOCK_TOL)


def test_hard_sigmoid_numerator_matches_oracle_expression():
    """qv3.hsig_num (clamp, then add) equals the oracle's clip(v + 3, 0, 6)
    bit for bit, edge values included."""
    rng = np.random.default_rng(0)
    v = np.concatenate([
        rng.normal(0, 4, 100_000).astype(np.float32),
        np.float32([-3, 3, -6, 6, 0, -0.0, 1e-30, -1e-30, 2.9999998,
                    3.0000002, -2.9999998, -3.0000002, 1e30, -1e30]),
        np.nextafter(np.float32(3), np.float32(9), dtype=np.float32)[None],
        np.nextafter(np.float32(-3), np.float32(-9), dtype=np.float32)[None]])
    got = np.asarray(jax.jit(qv3.hsig_num)(jnp.asarray(v)))
    want = np.clip(v + np.float32(3.0), 0.0, 6.0)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("c,cr", [(16, 8), (72, 24), (960, 240), (1100, 8)])
def test_se_gate_accumulator_exact(c, cr):
    """The SE gate's integer matmul (float32 form up to the 2^24 bound, the
    int8 dot beyond it) returns the exact int32 sums."""
    rng = np.random.default_rng(c)
    x = rng.integers(-127, 128, (3, c)).astype(np.int8)
    w = rng.integers(-127, 128, (c, cr)).astype(np.int8)
    b = rng.integers(-5000, 5000, (cr,)).astype(np.int32)
    got = np.asarray(jax.jit(qv3._se_acc_dev)(jnp.asarray(x), jnp.asarray(w),
                                              jnp.asarray(b)))
    np.testing.assert_array_equal(got, qv3._pw_acc_np(x, w) + b)


# bf16 routes (the served dtype) against the oracle run on the bf16-rounded
# inputs: every layer stores bf16 (8 mantissa bits), so a block's output is
# off by a few bf16 steps at its scale, and a V2/V3 block has three stores.
BF16_BLOCK_TOL = (5e-2, 2e-2)


def _bf16(tree):
    return jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), tree)


def _f32(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


@pytest.mark.parametrize("n,h,cin,cout,stride", V1_SHAPES)
def test_v1_block_bf16_vs_oracle(n, h, cin, cout, stride):
    from mobilenet_tpu.models import mobilenet_v1

    rng = np.random.default_rng(h * 7 + cin + 1)
    x = rng.uniform(0, 6, (n, h, h, cin)).astype(np.float32)
    blk = _bf16({"dw": {"w": _w(rng, (3, 3, 1, cin), 0.3),
                        "b": _w(rng, (cin,), .1)},
                 "pw": {"w": _w(rng, (cin, cout), 1 / np.sqrt(cin)),
                        "b": _w(rng, (cout,), .1)}})
    xb = jnp.asarray(x, jnp.bfloat16)
    got = jax.jit(lambda b, v: mobilenet_v1.separable_block(
        b, v, stride, True))(blk, xb)
    assert got.dtype == jnp.bfloat16
    r, xr = _f32(blk), np.asarray(xb, np.float32)
    y = numpy_ref.depthwise_ref(xr, r["dw"]["w"], stride, r["dw"]["b"],
                                relu6=True)
    ref = numpy_ref.pointwise_ref(y, r["pw"]["w"], r["pw"]["b"], relu6=True)
    _check(np.asarray(got, np.float32), ref, BF16_BLOCK_TOL)


@pytest.mark.parametrize("n,h,cin,e,cout,stride,res", V2_SHAPES)
def test_v2_block_bf16_vs_oracle(n, h, cin, e, cout, stride, res):
    rng = np.random.default_rng(h * 11 + e + 1)
    cout = cin if res else cout
    x = rng.uniform(-3, 3, (n, h, h, cin)).astype(np.float32)
    blk = _bf16(_v2_block(rng, cin, e, cout))
    xb = jnp.asarray(x, jnp.bfloat16)
    got = jax.jit(lambda b, v: mv2.inverted_residual(b, v, stride, res))(
        blk, xb)
    r, xr = _f32(blk), np.asarray(xb, np.float32)
    z = numpy_ref.pointwise_ref(xr, r["exp"]["w"], r["exp"]["b"], relu6=True)
    z = numpy_ref.depthwise_ref(z, r["dw"]["w"], stride, r["dw"]["b"],
                                relu6=True)
    ref = numpy_ref.pointwise_ref(z, r["prj"]["w"], r["prj"]["b"])
    _check(np.asarray(got, np.float32), ref + xr if res else ref,
           BF16_BLOCK_TOL)


@pytest.mark.parametrize("n,h,cin,e,cout,k,stride,se,act,res", V3_SHAPES)
def test_v3_block_bf16_vs_oracle(n, h, cin, e, cout, k, stride, se, act, res):
    rng = np.random.default_rng(h * 13 + e + k + 1)
    cout = cin if res else cout
    x = rng.uniform(-3, 3, (n, h, h, cin)).astype(np.float32)
    blk = _bf16(_v3_block(rng, cin, e, cout, k, se))
    bd = _bd(cin, e, cout, k, stride, se, act)
    xb = jnp.asarray(x, jnp.bfloat16)
    got = jax.jit(lambda b, v: mv3.bottleneck(b, v, bd))(blk, xb)
    ref = _v3_oracle(_f32(blk), np.asarray(xb, np.float32), bd)
    _check(np.asarray(got, np.float32), ref, BF16_BLOCK_TOL)


@pytest.mark.parametrize("n,h,c,cout,stride,se,act", NO_EXPAND_SHAPES)
def test_no_expand_block_bf16_vs_oracle(n, h, c, cout, stride, se, act):
    rng = np.random.default_rng(h + c + stride + 1)
    x = rng.uniform(0, 6, (n, h, h, c)).astype(np.float32)
    blk = _bf16(_v3_block(rng, c, None, cout, 3, se))
    bd = _bd(c, None, cout, 3, stride, se, act)
    xb = jnp.asarray(x, jnp.bfloat16)
    got = jax.jit(lambda b, v: mv3.bottleneck(b, v, bd))(blk, xb)
    ref = _v3_oracle(_f32(blk), np.asarray(xb, np.float32), bd)
    _check(np.asarray(got, np.float32), ref, BF16_BLOCK_TOL)
