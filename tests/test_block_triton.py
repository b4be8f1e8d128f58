"""The fused dw3x3 + pw1x1 Triton kernel (ops/block_triton.py) in the Pallas
interpreter against the NumPy oracle, its tiling and padding, and the
platform rule that chooses it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mobilenet_tpu import ModelConfig, platform
from mobilenet_tpu.ops import block_triton
from mobilenet_tpu.oracle import numpy_ref
from mobilenet_tpu.utils import golden

# (n, h, cin, cout, stride): the MobileNet-V1 block grid at alpha 1.0 and
# 0.25, the narrow 8-64-channel blocks, stride-2 blocks at every spatial
# tier, and channel counts that are not powers of two (alpha 0.75).
SHAPES = [
    (1, 112, 32, 64, 1),
    (1, 112, 64, 128, 2),
    (1, 56, 128, 128, 1),
    (1, 28, 256, 512, 2),
    (2, 14, 512, 512, 1),
    (2, 7, 1024, 1024, 1),
    (2, 16, 8, 16, 1),
    (2, 8, 16, 32, 2),
    (1, 4, 256, 256, 1),
    (2, 56, 64, 64, 1),
    (1, 32, 16, 32, 1),
    (2, 8, 64, 128, 1),
    (1, 112, 32, 32, 1),
    (2, 32, 32, 64, 2),
    (2, 16, 16, 32, 2),
    (1, 64, 8, 16, 2),
    (1, 16, 64, 128, 2),
    (1, 64, 8, 8, 1),
    (1, 16, 64, 64, 2),
    (1, 8, 256, 256, 2),
    (2, 14, 64, 64, 1),
    (1, 16, 32, 32, 2),
    (1, 14, 24, 48, 2),
    (1, 28, 96, 96, 1),
    (2, 7, 192, 384, 2),
    (1, 9, 40, 72, 1),
]


def _params(rng, cin, cout):
    dw = (rng.normal(size=(3, 3, 1, cin)) * 0.3).astype(np.float32)
    db = (rng.normal(size=cin) * 0.1).astype(np.float32)
    pw = (rng.normal(size=(cin, cout)) / np.sqrt(cin)).astype(np.float32)
    pb = (rng.normal(size=cout) * 0.1).astype(np.float32)
    return dw, db, pw, pb


def _oracle(args, stride, relu6=True):
    x, dw, db, pw, pb = [np.asarray(a, np.float32) for a in args]
    y = numpy_ref.depthwise_ref(x, dw, stride, bias=db, relu6=relu6)
    return numpy_ref.pointwise_ref(y, pw, bias=pb, relu6=relu6)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("n,h,cin,cout,stride", SHAPES)
def test_kernel_vs_oracle(n, h, cin, cout, stride, dtype):
    rng = np.random.default_rng(n * 1000 + h * 10 + stride)
    x = rng.uniform(0, 6, (n, h, h, cin)).astype(np.float32)
    args = [jnp.asarray(a, dtype) for a in (x, *_params(rng, cin, cout))]
    got = block_triton.separable_block(*args, stride, True, interpret=True)
    assert got.shape == (n, -(-h // stride), -(-h // stride), cout)
    assert got.dtype == jnp.dtype(dtype)
    tol = golden.KERNEL_BF16_TOL if dtype == "bfloat16" else golden.KERNEL_F32_TOL
    rep = golden.compare_activations(
        {"k": np.asarray(got, np.float32)}, {"k": _oracle(args, stride)},
        tols={"k": tol})[0]
    assert rep.ok, rep


@pytest.mark.parametrize("relu6", [True, False])
def test_kernel_plain_relu(relu6):
    rng = np.random.default_rng(3)
    x = rng.uniform(-3, 9, (2, 12, 12, 32)).astype(np.float32)
    args = [jnp.asarray(a) for a in (x, *_params(rng, 32, 48))]
    got = np.asarray(block_triton.separable_block(*args, 1, relu6,
                                                  interpret=True))
    ref = _oracle(args, 1, relu6)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=3e-4)
    assert (got.max() > 6.0) == (not relu6)


@pytest.mark.parametrize("cin,cout,n_pix", [
    (8, 16, 64), (32, 64, 25088), (1024, 1024, 12544), (24, 48, 49),
    (96, 96, 1), (512, 512, 50176), (3, 5, 7)])
def test_tiles_are_legal(cin, cout, n_pix):
    bm, bk, bn = block_triton.block_tiles(cin, cout, n_pix)
    for b in (bm, bk, bn):
        assert b >= 16 and b & (b - 1) == 0  # pl.dot: powers of two >= 16
    assert bk <= 64 and bn <= 128


def test_padded_channels_stay_out_of_the_result():
    """cin/cout that are not whole blocks are zero-padded inside the
    wrapper; the result has exactly cout channels and matches the oracle."""
    rng = np.random.default_rng(5)
    x = rng.uniform(0, 6, (1, 10, 10, 20)).astype(np.float32)
    args = [jnp.asarray(a) for a in (x, *_params(rng, 20, 36))]
    got = np.asarray(block_triton.separable_block(*args, 2, True,
                                                  interpret=True))
    assert got.shape == (1, 5, 5, 36)
    np.testing.assert_allclose(got, _oracle(args, 2), atol=1e-4, rtol=3e-4)


def test_kernel_rule_is_off_on_cpu():
    assert platform.accelerator() == "cpu"
    assert not platform.block_kernel_serves(112, jnp.bfloat16)


@pytest.mark.parametrize("h,dtype,want", [
    (112, jnp.bfloat16, True), (56, jnp.bfloat16, True),
    (28, jnp.bfloat16, False), (7, jnp.bfloat16, False),
    (112, jnp.float32, False)])
def test_kernel_rule_on_gpu(monkeypatch, h, dtype, want):
    monkeypatch.setattr(platform, "accelerator", lambda: "gpu")
    assert platform.block_kernel_serves(h, dtype) is want


def test_forward_routes_blocks_through_the_kernel(monkeypatch):
    """With the platform rule on, V1's forward runs the kernel (here in the
    interpreter) and its logits match the XLA route."""
    from mobilenet_tpu.checkpoints import default_folded, to_device
    from mobilenet_tpu.models import mobilenet_v1

    cfg = ModelConfig(alpha=0.25, resolution=64)
    params = to_device(default_folded(cfg, seed=1))
    x = jnp.asarray(np.random.default_rng(2).uniform(-1, 1, (2, 64, 64, 3)),
                    jnp.float32)
    ref = np.asarray(jax.jit(lambda p, v: mobilenet_v1.forward(p, v, cfg))(
        params, x))
    calls = []
    kernel = block_triton.separable_block

    def interpreted(*args):
        calls.append(args[0].shape)
        return kernel(*args, interpret=True)

    monkeypatch.setattr(platform, "block_kernel_serves",
                        lambda h, dtype: h >= 16)
    monkeypatch.setattr(block_triton, "separable_block", interpreted)
    got = np.asarray(jax.jit(lambda p, v: mobilenet_v1.forward(p, v, cfg))(
        params, x))
    assert [s[1] for s in calls] == [32, 32, 16, 16]
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=2e-3)


@pytest.mark.gpu
def test_kernel_compiled_on_gpu(gpu):
    """The kernel as Triton compiles it for the card, at the V1 1.0-224
    block shapes it serves."""
    import chip_smoke

    chip_smoke.phase_kernel(chip_smoke.kernel_shapes())



def _v1_block_shapes(alpha, res, min_h=0):
    cfg = ModelConfig(alpha=alpha, resolution=res)
    hw, cin, out = res // 2, cfg.stem_channels, []
    for stride, cout in zip(cfg.block_strides, cfg.block_channels):
        if hw >= min_h:
            out.append((1, hw, cin, cout, stride))
        hw, cin = -(-hw // stride), cout
    return out


# Every V1 block at alpha 0.5 and 0.75 (channel counts that are not powers
# of two), and the blocks the GPU rule serves at the other resolutions.
SWEEP = (_v1_block_shapes(0.5, 224) + _v1_block_shapes(0.75, 224)
         + _v1_block_shapes(1.0, 160, 56) + _v1_block_shapes(1.0, 192, 56))


@pytest.mark.parametrize("n,h,cin,cout,stride", SWEEP)
def test_kernel_v1_width_sweep_bf16(n, h, cin, cout, stride):
    rng = np.random.default_rng(h * 31 + cin + stride)
    x = rng.uniform(0, 6, (n, h, h, cin)).astype(np.float32)
    args = [jnp.asarray(a, jnp.bfloat16)
            for a in (x, *_params(rng, cin, cout))]
    got = block_triton.separable_block(*args, stride, True, interpret=True)
    rep = golden.compare_activations(
        {"k": np.asarray(got, np.float32)}, {"k": _oracle(args, stride)},
        tols={"k": golden.KERNEL_BF16_TOL})[0]
    assert rep.ok, rep
