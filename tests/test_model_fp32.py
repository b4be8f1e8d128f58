"""End-to-end float32 model vs. the NumPy golden oracle.

Rebuild of the reference's verify mode (SURVEY.md SS3.2/SS3.6): every one of the
28 layers' activations is compared per-layer against the oracle, reporting the
first divergence; plus top-1 agreement (BASELINE.json:5 accuracy gate).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from mobilenet_tpu import ModelConfig
from mobilenet_tpu.checkpoints import fold_bn, init_params, to_device
from mobilenet_tpu.models import mobilenet_v1
from mobilenet_tpu.oracle import numpy_ref
from mobilenet_tpu.utils import golden

import jax


def _run_case(alpha, resolution, batch=2, seed=0):
    cfg = ModelConfig(alpha=alpha, resolution=resolution)
    params = init_params(cfg, seed=seed)
    folded = fold_bn(params, eps=cfg.bn_eps)
    rng = np.random.default_rng(seed + 7)
    x = rng.uniform(-1, 1, size=(batch, resolution, resolution, 3)).astype(np.float32)

    dev_params = to_device(folded)
    fwd = jax.jit(
        lambda p, x: mobilenet_v1.forward(p, x, cfg, collect=True),
    )
    logits, acts = fwd(dev_params, jnp.asarray(x))
    logits_ref, acts_ref = numpy_ref.forward_all(folded, x, cfg)

    reports = golden.compare_activations(
        {k: np.asarray(v) for k, v in acts.items()}, acts_ref
    )
    golden.assert_all_match(reports)
    # Top-1 agreement — the accuracy gate.
    np.testing.assert_array_equal(
        np.argmax(np.asarray(logits), -1), np.argmax(logits_ref, -1)
    )


@pytest.mark.parametrize(
    "alpha,resolution",
    [(0.25, 128), (0.5, 160), (1.0, 224)],
)
def test_per_layer_golden_match(alpha, resolution):
    _run_case(alpha, resolution)


def test_all_28_layers_present():
    cfg = ModelConfig(alpha=0.25, resolution=128)
    params = to_device(fold_bn(init_params(cfg, seed=1)))
    x = jnp.zeros((1, 128, 128, 3), jnp.float32)
    _, acts = mobilenet_v1.forward(params, x, cfg, collect=True)
    conv_layers = [k for k in acts if k.startswith(("conv1", "block"))]
    # 1 stem + 13 dw + 13 pw = 27 conv layers; + FC (logits) = 28 (BASELINE.json:5)
    assert len(conv_layers) == 27
    assert "logits" in acts and "pool" in acts
    assert acts["logits"].shape == (1, 1000)


def test_layer_shape_table():
    cfg = ModelConfig(alpha=1.0, resolution=224)
    table = list(cfg.layer_shapes())
    assert len(table) == 27
    assert table[0] == ("conv1", "conv", 3, 32, 2, 224)
    assert table[-1] == ("block12_pw", "pw", 1024, 1024, 1, 7)
    # Spatial sizes follow SURVEY.md SS2 layer table.
    dw_hw = [t[5] for t in table if t[1] == "dw"]
    assert dw_hw == [112, 112, 56, 56, 28, 28, 14, 14, 14, 14, 14, 14, 7]


