"""Training step for MobileNet-V1 (fine-tune / from-scratch on the folded form).

The reference stack is inference-only (SURVEY.md SS5 "Checkpoint / resume": the
one-way weight export), so training is an extension of this rebuild: a jittable
SGD step over the folded parameterization (conv weight + per-channel bias; BN
affine is absorbed — training these is equivalent to training conv+frozen-BN).
Used by __graft_entry__.dryrun_multichip to validate the multi-chip dp+tp
sharding compiles and executes.

Training runs in float32 on the XLA route, which is differentiable; the
fused block kernel (ops/block_triton.py) has no VJP and serves only bfloat16
inference (platform.block_kernel_serves).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import jax
import jax.numpy as jnp

from . import mobilenet_v1


def model_forward(params: Dict[str, Any], images: jax.Array, config) -> jax.Array:
    """Differentiable forward for ANY model family config: dispatches on the
    config type the way the runtime does (runtime/pipeline.py)."""
    from .mobilenet_v2 import V2Config  # noqa: PLC0415
    from .mobilenet_v3 import V3Config  # noqa: PLC0415

    if isinstance(config, V2Config):
        from . import mobilenet_v2  # noqa: PLC0415

        return mobilenet_v2.forward_v2(params, images, config)
    if isinstance(config, V3Config):
        from . import mobilenet_v3  # noqa: PLC0415

        return mobilenet_v3.forward_v3(params, images, config)
    return mobilenet_v1.forward(params, images, config)


def cross_entropy_loss(
    params: Dict[str, Any], images: jax.Array, labels: jax.Array, config
) -> jax.Array:
    logits = model_forward(params, images, config)
    logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
    nll = -jnp.take_along_axis(logp, labels[:, None], axis=-1)[:, 0]
    return jnp.mean(nll)


def sgd_train_step(
    params: Dict[str, Any],
    images: jax.Array,
    labels: jax.Array,
    config,
    lr: float = 1e-2,
) -> Tuple[Dict[str, Any], jax.Array]:
    """One SGD step: returns (updated params, loss)."""
    loss, grads = jax.value_and_grad(cross_entropy_loss)(params, images, labels, config)
    new_params = jax.tree.map(lambda p, g: p - lr * g.astype(p.dtype), params, grads)
    return new_params, loss


def make_optax_trainer(config, lr: float = 1e-2,
                       momentum: float = 0.9, weight_decay: float = 4e-5):
    """Optax SGD-momentum trainer (MobileNet paper hyperparameter style:
    weight decay 4e-5) for any model-family config (`model_forward`).
    Returns (init_fn, step_fn); both jittable and shardable with the
    parallel.mesh layouts.

    accuracy-reporting variant: step_fn returns (params, opt_state, loss, top1).
    """
    import optax  # noqa: PLC0415

    tx = optax.chain(
        optax.add_decayed_weights(weight_decay),
        optax.sgd(lr, momentum=momentum),
    )

    def init_fn(params):
        return tx.init(params)

    def step_fn(params, opt_state, images, labels):
        def loss_fn(p):
            logits = model_forward(p, images, config)
            logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
            nll = -jnp.take_along_axis(logp, labels[:, None], axis=-1)[:, 0]
            return jnp.mean(nll), logits

        (loss, logits), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        top1 = jnp.mean((jnp.argmax(logits, -1) == labels).astype(jnp.float32))
        return params, opt_state, loss, top1

    return init_fn, step_fn
