"""INT8 MobileNet-V3: the calibrated named-activation scheme.

V3 is the family V1's fixed-scale and V2's projection-only calibration
cannot cover — unbounded ReLU, hard-swish, and a mid-block SE gate. These
tests pin quant/v3.py's three exactness arguments on the CPU backend
(CLAUDE.md invariants: int8 -> EXACT equality):
  - named-activation requant twins (f32 real-units detour, round-half-even)
  - the fully-quantized SE gate (integer matmuls, f32 only elementwise)
  - residual scale groups (V2's rule on the V3 schedule)
"""

import numpy as np
import pytest

from mobilenet_tpu.checkpoints.v3 import fold_bn_v3, init_params_v3
from mobilenet_tpu.models.mobilenet_v3 import V3Config
from mobilenet_tpu.quant.quantize import quantize_input
from mobilenet_tpu.quant.v3 import (_requant_named_dev, _requant_named_np,
                                    forward_all_v3_i8, forward_v3_i8,
                                    _as_device_tree_v3, quantize_v3,
                                    scale_groups_v3, verify_int8_v3)


@pytest.fixture(scope="module")
def qsetup():
    cfg = V3Config(variant="small", alpha=1.0, resolution=96)
    folded = fold_bn_v3(init_params_v3(cfg, seed=0), eps=cfg.bn_eps)
    q = quantize_v3(folded, cfg, n_calib=8)
    rng = np.random.default_rng(11)
    x = rng.uniform(-1, 1, (2, 96, 96, 3)).astype(np.float32)
    return cfg, folded, q, x


def test_scale_groups_follow_v3_residual_chains():
    cfg = V3Config(variant="large", alpha=1.0, resolution=224)
    gids = scale_groups_v3(cfg)
    assert len(gids) == 15
    defs = cfg.block_defs
    for i in range(1, 15):
        if defs[i].has_res:
            assert gids[i] == gids[i - 1], i
        else:
            assert gids[i] == gids[i - 1] + 1, i
    # V3-Large chains: 4,5 on 3; 7-9 on 6; 11 on 10; 13,14 on 12
    assert gids[4] == gids[5] == gids[3]
    assert gids[7] == gids[8] == gids[9] == gids[6]
    assert gids[11] == gids[10]
    assert gids[13] == gids[14] == gids[12]


def test_requant_named_twins_bit_equal():
    """NumPy and device requant must agree bit-for-bit across the named
    activations, including half-way rounding cases (round-half-even)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    acc = rng.integers(-2 ** 20, 2 ** 20, (64, 32), dtype=np.int32)
    # exercise exact .5 boundaries too
    acc[0, :] = np.arange(-16, 16) * 1000 + 500
    a = (rng.uniform(0.5, 2.0, (32,)) * 1e-3).astype(np.float32)
    inv_s = np.float32(37.5)
    for act in ("relu", "hswish", "linear"):
        got_np = _requant_named_np(acc, a, inv_s, act)
        got_dev = np.asarray(_requant_named_dev(
            jnp.asarray(acc), jnp.asarray(a), float(inv_s), act))
        np.testing.assert_array_equal(got_np, got_dev)


def test_hswish_requant_is_signed():
    """hard-swish dips to -0.375 — the requant must keep negatives (a
    relu-clamped twin would zero them and still 'agree' on positives)."""
    acc = np.array([[-3_000_000, -1_000_000, 2_000_000]], np.int32)
    a = np.full((3,), 1e-6, np.float32)   # real units: -3, -1, 2
    out = _requant_named_np(acc, a, np.float32(127.0), "hswish")
    # hswish(-3) = 0, hswish(-1) = -1*(2/6) = -0.333.., hswish(2) = 1.666..
    assert out[0, 0] == 0
    assert out[0, 1] < 0
    assert out[0, 2] > 0


def test_device_exact_vs_oracle_small(qsetup):
    cfg, folded, q, x = qsetup
    assert verify_int8_v3(cfg, folded, x, n_calib=8)


def test_device_exact_vs_oracle_large_minimalistic():
    """Minimalistic Large: relu-only, no SE — the scheme's no-SE path."""
    cfg = V3Config(variant="large", alpha=1.0, resolution=96,
                   minimalistic=True)
    folded = fold_bn_v3(init_params_v3(cfg, seed=1), eps=cfg.bn_eps)
    rng = np.random.default_rng(5)
    x = rng.uniform(-1, 1, (1, 96, 96, 3)).astype(np.float32)
    assert verify_int8_v3(cfg, folded, x, n_calib=4)


def test_int8_top1_tracks_fp32(qsetup):
    """Accuracy (not exactness): the calibrated scheme must track the fp32
    model's decisions on in-distribution inputs — top-1 agreement and a
    high logit correlation, or the calibration is mis-scaled."""
    import jax.numpy as jnp

    from mobilenet_tpu.models.mobilenet_v3 import forward_v3

    cfg, folded, q, _ = qsetup
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, (16, 96, 96, 3)).astype(np.float32)
    lf = np.asarray(forward_v3(folded, jnp.asarray(x), cfg))
    li, _ = forward_all_v3_i8(q, quantize_input(x), cfg)
    agree = (lf.argmax(-1) == li.argmax(-1)).mean()
    assert agree >= 0.9, agree
    assert np.corrcoef(lf.ravel(), li.ravel())[0, 1] > 0.99


def test_se_gate_bounds(qsetup):
    """The quantized SE output must stay within the dw tap's int8 range
    (gate in [0,1] shrinks magnitudes) and actually gate (not identity)."""
    cfg, folded, q, x = qsetup
    _, acts = forward_all_v3_i8(q, quantize_input(x), cfg)
    se_taps = [k for k in acts if k.endswith("_se")]
    assert se_taps  # V3-Small has SE from block 0
    for k in se_taps:
        dw = acts[k.replace("_se", "_dw")].astype(np.int32)
        se = acts[k].astype(np.int32)
        assert np.abs(se).max() <= np.abs(dw).max()
        assert (se != dw).any(), k  # the gate does something


def test_pipeline_and_collect_names(qsetup):
    """Int8PipelineV3.run_batch returns probs; collect-mode names follow
    the load-bearing layer-name contract (CLAUDE.md invariants)."""
    import jax.numpy as jnp

    from mobilenet_tpu.quant.v3 import Int8PipelineV3

    cfg, folded, q, x = qsetup
    pipe = Int8PipelineV3(cfg, params=folded)
    rng = np.random.default_rng(1)
    imgs = rng.integers(0, 256, (2, 96, 96, 3), dtype=np.uint8)
    probs = pipe.run_batch(imgs)
    assert probs.shape == (2, cfg.num_classes)
    np.testing.assert_allclose(probs.sum(-1), 1.0, atol=1e-3)
    dev = _as_device_tree_v3(q)
    _, acts = forward_v3_i8(dev, jnp.asarray(quantize_input(x)), cfg,
                            collect=True)
    assert "conv1" in acts and "logits" in acts and "head" in acts
    assert "block00_dw" in acts and "block00_se" in acts

@pytest.mark.parametrize("k,stride,h", [(3, 2, 12), (5, 2, 12), (3, 1, 9),
                                        (5, 1, 9), (3, 2, 14), (5, 2, 10)])
def test_dwk_eo_split_matches_numpy(k, stride, h):
    """The even/odd parity-split device dw accumulation (the stride-2
    relayout fix, 2026-08-20) is bit-equal to the numpy oracle's naive
    strided taps, for both carriers and both kernel sizes."""
    import jax.numpy as jnp

    from mobilenet_tpu.quant.v3 import _dwk_acc_dev, _dwk_acc_np

    rng = np.random.default_rng(0)
    x = rng.integers(-127, 128, (2, h, h, 8)).astype(np.int8)
    w = rng.integers(-127, 128, (k, k, 1, 8)).astype(np.int8)
    want = _dwk_acc_np(x, w, stride, k)
    for carrier in (jnp.int8, jnp.bfloat16):
        got = np.asarray(_dwk_acc_dev(jnp.asarray(x).astype(carrier),
                                      jnp.asarray(w), stride, k))
        np.testing.assert_array_equal(got, want)


