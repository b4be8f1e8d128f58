"""Independent importer gate against REAL keras.applications models.

Every other importer test hand-writes the .h5 it then reads back, which only
round-trips the builder's belief about the keras layout. These tests instead
instantiate the canonical `keras.applications` model (weights=None), perturb
its BN statistics and biases away from identity, save through KERAS'S OWN
writer, import via the repo importers, and compare forward LOGITS keras-CPU
vs our-CPU on the same input. That independently validates both the importer
mapping (naming/transposition/ordering) and our layer schedule (ReLU6,
padding, stride placement, SE, head) against the reference implementation —
reference analog C9 "weight export/loader" + L0 golden check, SURVEY.md SS2.

Tolerance: both sides are float32 on CPU but run different conv backends
(TF/oneDNN vs XLA) with different reduction orders; measured max|logit diff|
is ~1e-5..1e-4 on these configs, gated at 5e-3 absolute with top-1 equality.
"""

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")

BATCH = 4
ATOL = 5e-3


def _randomize(model, seed):
    """Push BN stats and biases away from identity so folding is exercised;
    keep keras's own glorot kernels (already non-trivial). Mild magnitudes so
    activations stay sane through the deepest (V3) chains."""
    rng = np.random.default_rng(seed)
    for v in model.weights:
        path = v.path if hasattr(v, "path") else v.name
        shape = tuple(v.shape)
        if "moving_variance" in path:
            v.assign(rng.uniform(0.8, 1.2, shape).astype(np.float32))
        elif "moving_mean" in path:
            v.assign(rng.normal(0.0, 0.05, shape).astype(np.float32))
        elif "gamma" in path:
            v.assign(rng.uniform(0.9, 1.1, shape).astype(np.float32))
        elif "beta" in path:
            v.assign(rng.normal(0.0, 0.05, shape).astype(np.float32))
        elif "bias" in path:
            v.assign(rng.normal(0.0, 0.02, shape).astype(np.float32))


def _gate(keras_logits, ours, label):
    ours = np.asarray(ours, np.float32)
    assert ours.shape == keras_logits.shape
    diff = float(np.max(np.abs(ours - keras_logits)))
    assert diff < ATOL, f"{label}: max|logit diff| {diff:.2e} >= {ATOL}"
    assert (ours.argmax(-1) == keras_logits.argmax(-1)).all(), label


def _input(res, seed=7):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1.0, 1.0, (BATCH, res, res, 3)).astype(np.float32)


def test_keras_real_v1(tmp_path):
    from tensorflow.keras import applications

    from mobilenet_tpu.checkpoints import fold_bn
    from mobilenet_tpu.checkpoints.io import import_keras_h5
    from mobilenet_tpu.config import ModelConfig
    from mobilenet_tpu.models import mobilenet_v1

    cfg = ModelConfig(alpha=0.25, resolution=128)
    m = applications.MobileNet(alpha=0.25, input_shape=(128, 128, 3),
                               weights=None, classifier_activation=None)
    _randomize(m, seed=11)
    path = str(tmp_path / "v1.weights.h5")
    m.save_weights(path)

    x = _input(128)
    keras_logits = np.asarray(m(x, training=False))

    params = fold_bn(import_keras_h5(path, cfg), eps=cfg.bn_eps)
    ours = mobilenet_v1.forward(params, x, cfg)
    _gate(keras_logits, ours, "v1 0.25-128")


def test_keras_real_v2(tmp_path):
    from tensorflow.keras import applications

    from mobilenet_tpu.checkpoints.v2 import fold_bn_v2, import_keras_h5_v2
    from mobilenet_tpu.models.mobilenet_v2 import V2Config, forward_v2

    cfg = V2Config(alpha=0.35, resolution=128)
    m = applications.MobileNetV2(alpha=0.35, input_shape=(128, 128, 3),
                                 weights=None, classifier_activation=None)
    _randomize(m, seed=12)
    path = str(tmp_path / "v2.weights.h5")
    m.save_weights(path)

    x = _input(128)
    keras_logits = np.asarray(m(x, training=False))

    params = fold_bn_v2(import_keras_h5_v2(path, cfg), eps=cfg.bn_eps)
    ours = forward_v2(params, x, cfg)
    _gate(keras_logits, ours, "v2 0.35-128")


def test_keras_real_v3small(tmp_path):
    from tensorflow.keras import applications

    from mobilenet_tpu.checkpoints.v3 import fold_bn_v3, import_keras_h5_v3
    from mobilenet_tpu.models.mobilenet_v3 import V3Config, forward_v3

    cfg = V3Config(variant="small", alpha=1.0, resolution=224)
    m = applications.MobileNetV3Small(input_shape=(224, 224, 3), weights=None,
                                      classifier_activation=None,
                                      include_preprocessing=False)
    _randomize(m, seed=13)
    path = str(tmp_path / "v3s.weights.h5")
    m.save_weights(path)

    x = _input(224)
    keras_logits = np.asarray(m(x, training=False))

    params = fold_bn_v3(import_keras_h5_v3(path, cfg), eps=cfg.bn_eps)
    ours = forward_v3(params, x, cfg)
    _gate(keras_logits, ours, "v3small 1.0-224")
