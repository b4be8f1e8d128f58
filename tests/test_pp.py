"""Pipeline parallelism (parallel/pp.py) on the virtual CPU mesh.

The GPipe schedule runs as one scanned shard_map program; these tests pin
the stage-planning invariants and the end-to-end equivalence of the
pipelined forward/train step against the single-device program.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mobilenet_tpu import ModelConfig
from mobilenet_tpu.checkpoints import fold_bn, init_params
from mobilenet_tpu.models import mobilenet_v1 as mv1
from mobilenet_tpu.models.train import sgd_train_step
from mobilenet_tpu.parallel import pp


@pytest.fixture(scope="module")
def setup():
    cfg = ModelConfig(alpha=0.25, resolution=64)
    params = fold_bn(init_params(cfg, seed=0), eps=cfg.bn_eps)
    rng = np.random.default_rng(7)
    x = jnp.asarray(rng.uniform(-1, 1, (8, 64, 64, 3)), jnp.float32)
    return cfg, params, x


def test_plan_stages_partition(setup):
    cfg, params, _ = setup
    for s in (1, 2, 4, 8, pp.N_UNITS):
        bounds = pp.plan_stages(cfg, params, s)
        assert len(bounds) == s
        assert bounds[0][0] == 0 and bounds[-1][1] == pp.N_UNITS
        for (a, b), (c, d) in zip(bounds, bounds[1:]):
            assert b == c and b > a and d > c  # contiguous, non-empty
    with pytest.raises(ValueError):
        pp.plan_stages(cfg, params, pp.N_UNITS + 1)


def test_plan_stages_balanced(setup):
    """No stage should carry more than half the total MACs at S=4."""
    cfg, params, _ = setup
    costs = pp._unit_costs(cfg, params)
    bounds = pp.plan_stages(cfg, params, 4)
    loads = [sum(costs[a:b]) for a, b in bounds]
    assert max(loads) < 0.5 * sum(costs), loads


@pytest.mark.parametrize("n_stages,n_micro", [(2, 4), (4, 8), (8, 8)])
def test_forward_pp_matches_single_device(setup, n_stages, n_micro):
    cfg, params, x = setup
    mesh = pp.make_pipe_mesh(n_stages)
    lg_pp = np.asarray(
        pp.forward_pp(params, x, cfg, mesh, n_microbatches=n_micro))
    lg_1 = np.asarray(mv1.forward(params, x, cfg))
    np.testing.assert_allclose(lg_pp, lg_1, atol=2e-5, rtol=1e-4)


def test_forward_pp_bad_microbatch_count(setup):
    cfg, params, x = setup
    mesh = pp.make_pipe_mesh(2)
    with pytest.raises(ValueError, match="not divisible"):
        pp.forward_pp(params, x, cfg, mesh, n_microbatches=3)


def test_pp_train_step_matches_single_device(setup):
    """grad through scan+switch+ppermute == single-device grad."""
    cfg, params, x = setup
    labels = jnp.asarray(
        np.random.default_rng(3).integers(0, cfg.num_classes, (8,)), jnp.int32)
    mesh = pp.make_pipe_mesh(4)
    new_pp, loss_pp = jax.jit(
        lambda p, x, y: pp.pp_train_step(p, x, y, cfg, mesh))(
            params, x, labels)
    new_1, loss_1 = jax.jit(
        lambda p, x, y: sgd_train_step(p, x, y, cfg, lr=1e-3))(
            params, x, labels)
    assert abs(float(loss_pp) - float(loss_1)) < 1e-6
    deltas = jax.tree.map(
        lambda a, b: float(np.abs(np.asarray(a) - np.asarray(b)).max()),
        new_pp, new_1)
    assert max(jax.tree.leaves(deltas)) < 1e-6


@pytest.mark.parametrize("family", ["v2", "v3"])
def test_forward_pp_family_matches_single_device(family):
    """The GPipe schedule over the V2/V3 families (stage bodies via the
    per-family unit adapters) must match the single-device forward."""
    import jax.numpy as jnp

    if family == "v2":
        from mobilenet_tpu.checkpoints.v2 import fold_bn_v2, init_params_v2
        from mobilenet_tpu.models.mobilenet_v2 import V2Config, forward_v2

        cfg = V2Config(alpha=1.0, resolution=96)
        params = fold_bn_v2(init_params_v2(cfg, seed=0), eps=cfg.bn_eps)
        fwd = forward_v2
    else:
        from mobilenet_tpu.checkpoints.v3 import fold_bn_v3, init_params_v3
        from mobilenet_tpu.models.mobilenet_v3 import V3Config, forward_v3

        cfg = V3Config(variant="small", alpha=1.0, resolution=96)
        params = fold_bn_v3(init_params_v3(cfg, seed=0), eps=cfg.bn_eps)
        fwd = forward_v3
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.uniform(-1, 1, (8, 96, 96, 3)), jnp.float32)
    mesh = pp.make_pipe_mesh(4)
    got = np.asarray(pp.forward_pp(params, x, cfg, mesh, n_microbatches=4))
    want = np.asarray(fwd(params, x, cfg))
    np.testing.assert_allclose(got, want, atol=5e-5, rtol=1e-4)


def test_pp_train_step_family_runs():
    """pp_train_step differentiates through the scanned schedule for the
    V3 family too (grad of switch + ppermute + family stage bodies)."""
    import jax.numpy as jnp

    from mobilenet_tpu.checkpoints.v3 import fold_bn_v3, init_params_v3
    from mobilenet_tpu.models.mobilenet_v3 import V3Config

    cfg = V3Config(variant="small", alpha=1.0, resolution=96)
    params = fold_bn_v3(init_params_v3(cfg, seed=0), eps=cfg.bn_eps)
    rng = np.random.default_rng(4)
    x = jnp.asarray(rng.uniform(-1, 1, (8, 96, 96, 3)), jnp.float32)
    labels = jnp.asarray(rng.integers(0, 1000, (8,)))
    mesh = pp.make_pipe_mesh(4)
    new_params, loss = pp.pp_train_step(params, x, labels, cfg, mesh,
                                        n_microbatches=4)
    assert np.isfinite(float(loss))
    # params actually moved
    a = np.asarray(jax.tree.leaves(params)[0])
    b = np.asarray(jax.tree.leaves(new_params)[0])
    assert (a != b).any()


def test_plan_stages_family_unit_counts():
    from mobilenet_tpu.checkpoints.v2 import fold_bn_v2, init_params_v2
    from mobilenet_tpu.checkpoints.v3 import fold_bn_v3, init_params_v3
    from mobilenet_tpu.models.mobilenet_v2 import V2Config
    from mobilenet_tpu.models.mobilenet_v3 import V3Config

    cfg2 = V2Config(alpha=1.0, resolution=96)
    p2 = fold_bn_v2(init_params_v2(cfg2, seed=0), eps=cfg2.bn_eps)
    bounds = pp.plan_stages(cfg2, p2, 4)
    assert bounds[0][0] == 0 and bounds[-1][1] == 19  # stem + 17 + head
    cfg3 = V3Config(variant="large", alpha=1.0, resolution=96)
    p3 = fold_bn_v3(init_params_v3(cfg3, seed=0), eps=cfg3.bn_eps)
    bounds = pp.plan_stages(cfg3, p3, 4)
    assert bounds[0][0] == 0 and bounds[-1][1] == 17  # stem + 15 + head
