"""MobileNet-V3 family: config-vs-keras schedule, per-layer oracle gates
(both oracles), SE/hard-swish semantics, CLI flows, and family parity
(train/eval/serve) — the V3 twin of test_mobilenet_v2.py."""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mobilenet_tpu.checkpoints.v3 import fold_bn_v3, init_params_v3
from mobilenet_tpu.models.mobilenet_v3 import (V3Config, forward_v3,
                                               se_apply)
from mobilenet_tpu.oracle import numpy_ref
from mobilenet_tpu.runtime.pipeline import InferencePipeline
from mobilenet_tpu.utils import golden


@pytest.fixture(scope="module", params=["large", "small"])
def setup(request):
    cfg = V3Config(variant=request.param, alpha=1.0, resolution=96)
    folded = fold_bn_v3(init_params_v3(cfg, seed=0), eps=cfg.bn_eps)
    rng = np.random.default_rng(7)
    x = rng.uniform(-1, 1, (2, 96, 96, 3)).astype(np.float32)
    return cfg, folded, x


def test_config_matches_keras_table():
    """Channel/kernel/stride schedule vs the keras source
    (mobilenet_v3.py:488-519 Large / :421-452 Small, _depth :561-568)."""
    lg = V3Config(variant="large", alpha=1.0, resolution=224)
    defs = lg.block_defs
    assert len(defs) == 15
    assert defs[0].cin == 16 and not defs[0].has_expand
    assert defs[0].cexp == 16 and defs[0].cout == 16  # t=1 block
    assert [d.cout for d in defs] == [
        16, 24, 24, 40, 40, 40, 80, 80, 80, 80, 112, 112, 160, 160, 160]
    assert [d.stride for d in defs] == [
        1, 2, 1, 2, 1, 1, 2, 1, 1, 1, 1, 1, 2, 1, 1]
    assert [d.kernel for d in defs] == [
        3, 3, 3, 5, 5, 5, 3, 3, 3, 3, 3, 3, 5, 5, 5]
    # expansion channels use _depth(cin * t): block 7 is t=2.5 on cin=80
    assert defs[7].cexp == 200
    assert defs[8].cexp == 184  # t=2.3 on 80 -> _depth(184) = 184
    # SE present exactly where keras puts it
    assert [bool(d.se_mid) for d in defs] == [
        False, False, False, True, True, True, False, False, False, False,
        True, True, True, True, True]
    assert defs[3].se_mid == 24  # _depth(72 * 0.25) = _depth(18) = 24
    assert defs[4].se_mid == 32  # _depth(120 * 0.25) = _depth(30) = 32
    assert [d.act for d in defs[:6]] == ["relu"] * 6
    assert [d.act for d in defs[6:]] == ["hswish"] * 9
    assert lg.last_conv_channels == 960 and lg.last_point_channels == 1280

    sm = V3Config(variant="small", alpha=1.0, resolution=224)
    sdefs = sm.block_defs
    assert len(sdefs) == 11
    assert [d.cout for d in sdefs] == [
        16, 24, 24, 40, 40, 40, 48, 48, 96, 96, 96]
    assert sdefs[0].se_mid == 8  # _depth(16 * 0.25) = 8
    assert sdefs[1].cexp == 72 and sdefs[2].cexp == 88
    assert sm.last_conv_channels == 576 and sm.last_point_channels == 1024

    mini = V3Config(variant="large", alpha=1.0, resolution=224,
                    minimalistic=True)
    assert all(d.kernel == 3 and d.se_mid == 0 and d.act == "relu"
               for d in mini.block_defs)


def test_bad_config_rejected():
    with pytest.raises(ValueError):
        V3Config(variant="medium")
    with pytest.raises(ValueError):
        V3Config(resolution=100)
    with pytest.raises(ValueError):
        V3Config(alpha=0.0)


@pytest.mark.parametrize("oracle", ["numpy", "cpp"])
def test_per_layer_oracle_gate(setup, oracle):
    cfg, folded, x = setup
    pipe = InferencePipeline(cfg, params=folded, dtype=np.float32)
    _, acts = pipe.activations(x)
    if oracle == "cpp":
        from mobilenet_tpu import cpu_ref

        _, ref = cpu_ref.forward_all_v3(folded, x, cfg)
    else:
        _, ref = numpy_ref.forward_all_v3(folded, x, cfg)
    reports = golden.compare_activations(
        acts, ref, tols={n: golden.V3_TOL for n in ref})
    golden.assert_all_match(reports)
    n_expected = {"large": 67, "small": 52}[cfg.variant]
    assert len(reports) == n_expected


def test_hard_swish_formula():
    """hswish/hsigmoid match the keras definition (mobilenet_v3.py:546-553)
    on both the device op and the numpy oracle."""
    from mobilenet_tpu.ops.conv import apply_act_named

    v = np.linspace(-5, 5, 41).astype(np.float32)
    expect_hsig = np.clip(v + 3.0, 0.0, 6.0) / 6.0
    np.testing.assert_allclose(
        np.asarray(apply_act_named(jnp.asarray(v), "hsigmoid")),
        expect_hsig, atol=1e-7)
    np.testing.assert_allclose(
        np.asarray(apply_act_named(jnp.asarray(v), "hswish")),
        v * expect_hsig, atol=1e-6)
    np.testing.assert_allclose(
        numpy_ref.act_named_ref(v, "hswish"), v * expect_hsig, atol=1e-6)
    # relu is UNBOUNDED (V3 uses plain relu, not relu6)
    assert float(np.asarray(
        apply_act_named(jnp.asarray(np.float32([8.0])), "relu"))[0]) == 8.0


def test_se_gate_semantics():
    """SE must scale channels by hsigmoid(fc2(relu(fc1(pool)))) — checked
    against a literal NumPy transcription."""
    rng = np.random.default_rng(3)
    z = rng.normal(0, 1, (2, 4, 4, 8)).astype(np.float32)
    se = {
        "w1": rng.normal(0, 0.5, (8, 4)).astype(np.float32),
        "b1": rng.normal(0, 0.1, (4,)).astype(np.float32),
        "w2": rng.normal(0, 0.5, (4, 8)).astype(np.float32),
        "b2": rng.normal(0, 0.1, (8,)).astype(np.float32),
    }
    got = np.asarray(se_apply(jnp.asarray(z), jax.tree.map(jnp.asarray, se)))
    pooled = z.mean((1, 2))
    g = np.maximum(pooled @ se["w1"] + se["b1"], 0)
    g = np.clip(g @ se["w2"] + se["b2"] + 3.0, 0, 6.0) / 6.0
    np.testing.assert_allclose(got, z * g[:, None, None, :], atol=1e-5)


def test_residual_taps_present(setup):
    cfg, folded, x = setup
    _, acts = numpy_ref.forward_all_v3(folded, x, cfg)
    res_blocks = [i for i, d in enumerate(cfg.block_defs) if d.has_res]
    assert res_blocks, "schedule must contain residual blocks"
    for i in res_blocks:
        assert f"block{i:02d}_out" in acts
    se_blocks = [i for i, d in enumerate(cfg.block_defs) if d.se_mid]
    for i in se_blocks:
        assert f"block{i:02d}_se" in acts


def test_bf16_top1_agrees_fp32(setup):
    cfg, folded, x = setup
    p32 = InferencePipeline(cfg, params=folded, dtype=np.float32)
    p16 = InferencePipeline(cfg, params=folded, dtype=jnp.bfloat16)
    a = np.asarray(p32.run_preprocessed(jnp.asarray(x)))
    b = np.asarray(p16.run_preprocessed(jnp.asarray(x)))
    assert (np.argmax(a, -1) == np.argmax(b, -1)).all()


def test_u8_entry_and_resize(setup):
    cfg, folded, _ = setup
    pipe = InferencePipeline(cfg, params=folded)
    rng = np.random.default_rng(0)
    probs = pipe.run_batch(
        rng.integers(0, 256, (2, 130, 140, 3), dtype=np.uint8))
    assert probs.shape == (2, 1000)
    np.testing.assert_allclose(probs.sum(-1), 1.0, atol=1e-3)


def test_npz_roundtrip(tmp_path, setup):
    from mobilenet_tpu.checkpoints import load_npz, save_npz

    cfg, folded, x = setup
    path = str(tmp_path / "v3.npz")
    save_npz(path, folded)
    re = load_npz(path)
    l1, _ = numpy_ref.forward_all_v3(folded, x, cfg)
    l2, _ = numpy_ref.forward_all_v3(re, x, cfg)
    np.testing.assert_array_equal(l1, l2)


def test_alpha_scaling_shapes():
    cfg = V3Config(variant="small", alpha=0.75, resolution=96)
    folded = fold_bn_v3(init_params_v3(cfg, seed=0), eps=cfg.bn_eps)
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, (1, 96, 96, 3)).astype(np.float32)
    logits, _ = numpy_ref.forward_all_v3(folded, x, cfg)
    assert logits.shape == (1, 1000)
    # alpha < 1 scales block channels but NOT last_point (keras :335)
    assert cfg.last_point_channels == 1024


def test_train_v3_descends():
    from mobilenet_tpu.models.train import sgd_train_step

    cfg = V3Config(variant="small", alpha=1.0, resolution=96)
    params = jax.tree.map(
        jnp.asarray, fold_bn_v3(init_params_v3(cfg, 0), eps=cfg.bn_eps))
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.uniform(-1, 1, (8, 96, 96, 3)), jnp.float32)
    y = jnp.asarray(rng.integers(0, 1000, (8,)), jnp.int32)
    step = jax.jit(lambda p, x, y: sgd_train_step(p, x, y, cfg, lr=3e-3))
    p1, l1 = step(params, x, y)
    p2, _ = step(p1, x, y)
    _, l3 = step(p2, x, y)
    assert float(l3) < float(l1)


def test_eval_v3_agreement():
    from mobilenet_tpu.runtime.eval import evaluate_agreement, synth_images

    cfg = V3Config(variant="small", alpha=1.0, resolution=96)
    images = synth_images(cfg, 8, seed=1)
    report = evaluate_agreement(cfg, images, batch_size=4, tie_margin=1e-3)
    assert report["top1_agreement_tie_aware"] == 1.0


def test_serving_v3_selftest():
    from mobilenet_tpu.runtime.serving import MicroBatchServer, selftest

    pipe = InferencePipeline(V3Config(variant="small", resolution=96), seed=0)

    async def run():
        server = MicroBatchServer(pipe, max_batch=8, max_delay_ms=5.0)
        await server.start()
        stats = await selftest(server, streams=16, requests_per_stream=2)
        await server.close()
        return stats

    stats = asyncio.run(run())
    assert stats["requests"] == 32 and stats["errors"] == 0


def test_cli_v3_verify_and_classify(tmp_path, capsys):
    from PIL import Image

    from mobilenet_tpu import cli

    rng = np.random.default_rng(0)
    img_path = str(tmp_path / "t.png")
    Image.fromarray(
        rng.integers(0, 256, (120, 130, 3), dtype=np.uint8)).save(img_path)
    with pytest.raises(SystemExit) as e:
        cli.main(["--backend", "cpu", "verify", "--model", "v3small",
                  "--alpha", "1.0", "--res", "96", "--batch", "1"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    assert "VERIFY OK" in out and "mobilenet_v3_small" in out
    cli.main(["--backend", "cpu", "classify", img_path, "--model", "v3small",
              "--alpha", "1.0", "--res", "96"])
    assert "top-1" in capsys.readouterr().out


def test_cli_v3_int8_verify_exact(capsys):
    """The int8 V3 EXACT-equality gate through the CLI (quant/v3.py —
    the calibrated scheme that replaced the round-3 rejection message)."""
    from mobilenet_tpu import cli

    with pytest.raises(SystemExit) as e:
        cli.main(["--backend", "cpu", "verify", "--model", "v3small",
                  "--alpha", "1.0", "--res", "96", "--int8", "--batch", "1"])
    out = capsys.readouterr().out
    assert e.value.code == 0, out
    assert "EXACT" in out and "int8" in out


def test_flops_model_matches_published_mac_counts():
    """Analytic MAC model vs the published MAdds (paper Table 3 / keras
    docs): V1 1.0-224 569M, V2 1.0-224 300.8M, V3-Large 219M (ours counts
    conv MACs only -> slightly under), V3-Small 56M. A wrong stride/width
    in any family's schedule would miss these by >10%."""
    from mobilenet_tpu.config import ModelConfig
    from mobilenet_tpu.models.mobilenet_v2 import V2Config
    from mobilenet_tpu.models.mobilenet_v3 import V3Config
    from mobilenet_tpu.utils.profiling import flops_per_image

    assert abs(flops_per_image(ModelConfig(alpha=1.0, resolution=224))
               / 569e6 - 1) < 0.01
    assert abs(flops_per_image(V2Config(alpha=1.0, resolution=224))
               / 300.8e6 - 1) < 0.01
    assert abs(flops_per_image(V3Config(variant="large", resolution=224))
               / 219e6 - 1) < 0.02
    assert abs(flops_per_image(V3Config(variant="small", resolution=224))
               / 56e6 - 1) < 0.02


def test_cli_v3_export_roundtrip(tmp_path, capsys):
    """export --model v3small writes raw/folded/int8; the folded file
    reloads through --ckpt with identical logits (C9 portability, all
    families)."""
    import jax.numpy as jnp

    from mobilenet_tpu import cli
    from mobilenet_tpu.checkpoints import load_npz
    from mobilenet_tpu.checkpoints.v3 import fold_bn_v3, init_params_v3
    from mobilenet_tpu.models.mobilenet_v3 import V3Config, forward_v3

    out = str(tmp_path / "exp")
    cli.main(["--backend", "cpu", "export", "--model", "v3small",
              "--res", "96", "--out", out])
    assert "exported" in capsys.readouterr().out
    cfg = V3Config(variant="small", alpha=1.0, resolution=96)
    folded = fold_bn_v3(init_params_v3(cfg, seed=0), eps=cfg.bn_eps)
    re = load_npz(f"{out}/mobilenet_v3_small_1_96_folded.npz")
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.uniform(-1, 1, (1, 96, 96, 3)), jnp.float32)
    np.testing.assert_array_equal(
        np.asarray(forward_v3(re, x, cfg)),
        np.asarray(forward_v3(folded, x, cfg)))


