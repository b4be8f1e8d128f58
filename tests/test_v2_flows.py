"""MobileNet-V2 family parity across the framework's flows: training,
serving (fp + int8 + DP), sweep plumbing — everything the V1
family gets, the V2 family must mirror (the '--int8 mirrors every flow'
standard from CLAUDE.md, applied to --model v2)."""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np

from mobilenet_tpu.checkpoints.v2 import fold_bn_v2, init_params_v2
from mobilenet_tpu.models.mobilenet_v2 import V2Config
from mobilenet_tpu.models.train import (
    cross_entropy_loss, make_optax_trainer, sgd_train_step,
)
from mobilenet_tpu.runtime.pipeline import InferencePipeline
from mobilenet_tpu.runtime.serving import MicroBatchServer, selftest


def _setup_v2():
    cfg = V2Config(alpha=0.35, resolution=96)
    params = jax.tree.map(
        jnp.asarray, fold_bn_v2(init_params_v2(cfg, seed=0), eps=cfg.bn_eps))
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.uniform(-1, 1, (8, 96, 96, 3)), jnp.float32)
    y = jnp.asarray(rng.integers(0, 1000, (8,)), jnp.int32)
    return cfg, params, x, y


def test_v2_sgd_step_descends():
    cfg, params, x, y = _setup_v2()
    step = jax.jit(lambda p, x, y: sgd_train_step(p, x, y, cfg, lr=1e-2))
    p1, l1 = step(params, x, y)
    p2, _ = step(p1, x, y)
    _, l3 = step(p2, x, y)
    assert float(l3) < float(l1)


def test_v2_optax_trainer_descends():
    # lr 3e-3: V2's residual chains diverge at V1's 5e-2 on random init
    cfg, params, x, y = _setup_v2()
    init_fn, step_fn = make_optax_trainer(cfg, lr=3e-3)
    opt_state = init_fn(params)
    step = jax.jit(step_fn)
    losses = []
    for _ in range(4):
        params, opt_state, loss, top1 = step(params, opt_state, x, y)
        losses.append(float(loss))
        assert 0.0 <= float(top1) <= 1.0
    assert losses[-1] < losses[0]


def test_v2_grad_nonzero():
    cfg, params, x, y = _setup_v2()
    loss, grads = jax.value_and_grad(cross_entropy_loss)(params, x, y, cfg)
    assert np.isfinite(float(loss))
    gnorm = sum(float(jnp.sum(g**2)) for g in jax.tree.leaves(grads))
    assert gnorm > 0


def test_v2_serving_selftest():
    pipe = InferencePipeline(V2Config(alpha=0.35, resolution=96), seed=0)

    async def run():
        server = MicroBatchServer(pipe, max_batch=8, max_delay_ms=5.0)
        await server.start()
        stats = await selftest(server, streams=16, requests_per_stream=2)
        await server.close()
        return stats

    stats = asyncio.run(run())
    assert stats["requests"] == 32
    assert stats["errors"] == 0


def test_v2_int8_serving_selftest():
    from mobilenet_tpu.quant.v2 import Int8PipelineV2

    pipe = Int8PipelineV2(V2Config(alpha=0.35, resolution=96), seed=0)

    async def run():
        server = MicroBatchServer(pipe, max_batch=8, max_delay_ms=5.0)
        await server.start()
        stats = await selftest(server, streams=16, requests_per_stream=2)
        await server.close()
        return stats

    stats = asyncio.run(run())
    assert stats["requests"] == 32
    assert stats["errors"] == 0


def test_v2_int8_dp_serving_matches_single_device():
    """Int8PipelineV2 over a DP mesh: jit sharding propagation partitions
    the pure-XLA int8 route; probs must match the single-device pipeline
    EXACTLY (int8 network; the float softmax inherits identical logits)."""
    from mobilenet_tpu.parallel.mesh import make_mesh
    from mobilenet_tpu.quant.v2 import Int8PipelineV2

    cfg = V2Config(alpha=0.35, resolution=96)
    mesh = make_mesh(4, model_parallel=1)
    rng = np.random.default_rng(3)
    imgs = rng.integers(0, 256, (8, 96, 96, 3), dtype=np.uint8)
    p_dp = Int8PipelineV2(cfg, seed=0, mesh=mesh).run_batch(imgs)
    p_1 = Int8PipelineV2(cfg, seed=0).run_batch(imgs)
    np.testing.assert_array_equal(p_dp, p_1)


def test_v2_multivariant_cross_family():
    """One process serving V1 AND V2 variants side by side (build_server
    multi=True) — the cross-family case serve_main's 'v2:alpha:res'
    variant syntax builds."""
    from mobilenet_tpu import ModelConfig
    from mobilenet_tpu.runtime.serving import build_server

    v1 = ModelConfig(alpha=0.25, resolution=96)
    v2 = V2Config(alpha=0.35, resolution=96)
    cfgs = {c.variant_name(): c for c in (v1, v2)}

    async def run():
        server, servers = build_server(cfgs, 8, seed=0, multi=True)
        await server.start()
        rng = np.random.default_rng(0)
        img = rng.integers(0, 256, (96, 96, 3), dtype=np.uint8)
        out = {}
        for name in cfgs:
            out[name] = await server.submit(img, variant=name)
        await server.close()
        return out

    out = asyncio.run(run())
    assert set(out) == set(cfgs)
    for top in out.values():
        assert len(top) == 5 and all(p >= 0 for _, p in top)


def test_v2_sweep_cli_row(capsys):
    """`cli sweep --model v2` builds V2 configs and emits per-variant rows."""
    from mobilenet_tpu import cli

    cli.main(["--backend", "cpu", "sweep", "--model", "v2",
              "--alphas", "0.35", "--resolutions", "96",
              "--batch", "2", "--steps", "2"])
    out = capsys.readouterr().out
    assert "mobilenet_v2_0.35_96" in out


def test_v2_eval_agreement_float():
    """End-to-end top-1 agreement gate for the V2 family (float path,
    numpy oracle, tie-aware like the V1 gate)."""
    from mobilenet_tpu.runtime.eval import evaluate_agreement, synth_images

    cfg = V2Config(alpha=0.35, resolution=96)
    images = synth_images(cfg, 8, seed=1)
    report = evaluate_agreement(cfg, images, batch_size=4, tie_margin=1e-3)
    assert report["n_images"] == 8
    assert report["top1_agreement_tie_aware"] == 1.0


def test_v2_eval_agreement_int8_exact():
    """int8 V2 eval: device logits are EXACT vs the int8 oracle, so raw
    top-1 agreement must be 1.0 with a strict (0) tie margin."""
    from mobilenet_tpu.runtime.eval import evaluate_agreement, synth_images

    cfg = V2Config(alpha=0.35, resolution=96)
    images = synth_images(cfg, 4, seed=2)
    report = evaluate_agreement(cfg, images, batch_size=4, int8=True,
                                tie_margin=0.0)
    assert report["top1_agreement"] == 1.0


def test_v2_train_cli_smoke(capsys):
    from mobilenet_tpu import cli

    cli.main(["--backend", "cpu", "train", "--model", "v2",
              "--alpha", "0.35", "--res", "96", "--batch", "4",
              "--steps", "2", "--lr", "0.05"])
    out = capsys.readouterr().out
    assert '"loss"' in out
