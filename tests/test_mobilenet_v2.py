"""MobileNet-V2 model family: config fidelity, oracle gates, checkpoints.

The V2 stack reuses the V1 ops, so these tests pin (a) the keras-verified
layer schedule, (b) per-layer agreement with BOTH oracles under the
documented V2 gate, and (c) checkpoint roundtripping through the
layout-agnostic npz format.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mobilenet_tpu import cpu_ref
from mobilenet_tpu.checkpoints.io import load_npz, save_npz
from mobilenet_tpu.checkpoints.v2 import fold_bn_v2, init_params_v2
from mobilenet_tpu.models.mobilenet_v2 import (
    V2Config, forward_v2, make_divisible, predict_probs_v2_u8)
from mobilenet_tpu.oracle import numpy_ref
from mobilenet_tpu.utils import golden


@pytest.fixture(scope="module")
def setup():
    cfg = V2Config(alpha=1.0, resolution=96)
    params = fold_bn_v2(init_params_v2(cfg, seed=0), eps=cfg.bn_eps)
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, (2, 96, 96, 3)).astype(np.float32)
    return cfg, params, x


def test_config_matches_keras_table():
    """Channel schedule bit-for-bit vs keras mobilenet_v2.py at alpha=1.0."""
    cfg = V2Config(alpha=1.0, resolution=224)
    assert cfg.stem_channels == 32 and cfg.last_channels == 1280
    assert [d[2] for d in cfg.block_defs] == [
        16, 24, 24, 32, 32, 32, 64, 64, 64, 64, 96, 96, 96, 160, 160, 160, 320]
    assert [d[3] for d in cfg.block_defs] == [
        1, 2, 1, 2, 1, 1, 2, 1, 1, 1, 1, 1, 1, 2, 1, 1, 1]
    # t=1 on block 0 only; expansion = 6x elsewhere
    assert [d[0] for d in cfg.block_defs] == [1] + [6] * 16
    assert cfg.final_spatial == 7


def test_make_divisible_keras_semantics():
    # reference values from keras _make_divisible(v, 8)
    assert make_divisible(32 * 0.35) == 16   # 11.2 -> 8 -> bump (8 < 10.08)
    assert make_divisible(16 * 0.35) == 8
    assert make_divisible(24 * 0.75) == 24   # 18 -> 16 < 0.9*18 -> bump to 24
    assert make_divisible(96 * 0.5) == 48
    assert make_divisible(1280 * 1.4) == 1792
    # alpha <= 1.0 keeps the 1280 head
    assert V2Config(alpha=0.5, resolution=224).last_channels == 1280
    assert V2Config(alpha=1.4, resolution=224).last_channels == 1792


def test_bad_config_rejected():
    with pytest.raises(ValueError):
        V2Config(alpha=0.2, resolution=224)
    with pytest.raises(ValueError):
        V2Config(alpha=1.0, resolution=100)


@pytest.mark.parametrize("oracle", ["numpy", "cpp"])
def test_per_layer_oracle_gate(setup, oracle):
    """All 64 taps within the documented V2 gate vs both oracles."""
    cfg, params, x = setup
    _, acts = jax.jit(
        lambda p, x: forward_v2(p, x, cfg, collect=True))(params, jnp.asarray(x))
    acts = {k: np.asarray(v) for k, v in acts.items()}
    fwd = (numpy_ref.forward_all_v2 if oracle == "numpy"
           else cpu_ref.forward_all_v2)
    _, ref = fwd(params, x, cfg)
    assert len(ref) == 64  # conv1 + 16 exp + 17 dw + 17 prj + 10 out + head(3)
    tols = {name: golden.V2_TOL for name in ref}
    reports = golden.compare_activations(acts, ref, tols=tols)
    golden.assert_all_match(reports)


def test_residual_blocks_present(setup):
    """The 10 stride-1 cin==cout blocks carry residuals (taps prove it)."""
    cfg, params, x = setup
    _, acts = forward_v2(params, jnp.asarray(x), cfg, collect=True)
    outs = [k for k in acts if k.endswith("_out")]
    assert len(outs) == 10
    # residual output differs from the raw projection
    assert not np.allclose(np.asarray(acts["block02_out"]),
                           np.asarray(acts["block02_prj"]))


def test_bf16_top1_agrees_fp32(setup):
    cfg, params, x = setup
    p16 = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), params)
    lg32 = np.asarray(forward_v2(params, jnp.asarray(x), cfg))
    lg16 = np.asarray(forward_v2(p16, jnp.asarray(x, jnp.bfloat16), cfg),
                      np.float32)
    assert np.array_equal(np.argmax(lg32, -1), np.argmax(lg16, -1))


def test_u8_entry_and_resize(setup):
    """uint8 any-size input -> device resize/normalize -> probs."""
    cfg, params, _ = setup
    imgs = np.random.default_rng(5).integers(
        0, 256, (2, 160, 120, 3), dtype=np.uint8)
    probs = np.asarray(predict_probs_v2_u8(params, jnp.asarray(imgs), cfg))
    assert probs.shape == (2, cfg.num_classes)
    np.testing.assert_allclose(probs.sum(-1), 1.0, atol=1e-5)


def test_npz_roundtrip(tmp_path, setup):
    """The flat npz format handles V2's optional-exp layout unchanged."""
    cfg, params, x = setup
    path = str(tmp_path / "v2.npz")
    save_npz(path, params)
    loaded = load_npz(path)
    lg_a = np.asarray(forward_v2(params, jnp.asarray(x), cfg))
    lg_b = np.asarray(forward_v2(loaded, jnp.asarray(x), cfg))
    np.testing.assert_array_equal(lg_a, lg_b)


def test_alpha_scaling_shapes():
    """0.35 and 1.4 widths run end-to-end with rounded channels."""
    for alpha in (0.35, 1.4):
        cfg = V2Config(alpha=alpha, resolution=96)
        params = fold_bn_v2(init_params_v2(cfg, seed=0), eps=cfg.bn_eps)
        x = jnp.asarray(
            np.random.default_rng(0).uniform(-1, 1, (1, 96, 96, 3)),
            jnp.float32)
        lg = forward_v2(params, x, cfg)
        assert lg.shape == (1, cfg.num_classes)


def test_cli_v2_verify_and_bench():
    """--model v2 mirrors the CLI flows (in-process, CPU backend active)."""
    import json

    from mobilenet_tpu import cli

    with pytest.raises(SystemExit) as e:
        cli.main(["verify", "--model", "v2", "--alpha", "1.0", "--res", "96",
                  "--batch", "1"])
    assert e.value.code == 0
    # invalid v2 alpha gets the V2Config error via a clean nonzero exit
    with pytest.raises(SystemExit) as e:
        cli.main(["bench", "--model", "v2", "--alpha", "0.25", "--res", "96",
                  "--batch", "1", "--steps", "1"])
    assert e.value.code not in (0, None)


def test_pipeline_v2_routes_by_config_type(setup):
    """InferencePipeline(V2Config) serves the V2 forward (runtime reuse)."""
    from mobilenet_tpu.runtime.pipeline import InferencePipeline

    cfg, params, x = setup
    pipe = InferencePipeline(cfg, params=params, dtype=jnp.float32)
    probs = pipe.run_batch(
        np.random.default_rng(0).integers(0, 256, (2, 96, 96, 3),
                                          dtype=np.uint8))
    assert probs.shape == (2, cfg.num_classes)
    lg, acts = pipe.activations(x)
    assert "conv_last" in acts and lg.shape == (2, cfg.num_classes)
