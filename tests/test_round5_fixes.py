"""Round-5 fixes: the keras-3 wrong-family diagnostics (ADVICE r4 items
1-2) and the folded int8 requant order."""

import numpy as np
import pytest


class TestKeras3LayoutDiagnostics:
    """A wrong-family keras-3 store must raise the diagnostic ValueError,
    not a bare KeyError (ADVICE r4 items 1-2)."""

    def test_v2_importer_missing_dense(self):
        from mobilenet_tpu.checkpoints.v2 import _import_keras3_v2
        from mobilenet_tpu.models.mobilenet_v2 import V2Config

        store = {"conv2d": [], "depthwise_conv2d": [],
                 "batch_normalization": []}  # a V1-shaped store: no Dense
        with pytest.raises(ValueError, match="unrecognized keras-3 layout"):
            _import_keras3_v2(store, V2Config(alpha=1.0, resolution=224))

    def test_v1_importer_unrecognized_bases(self):
        from mobilenet_tpu import ModelConfig
        from mobilenet_tpu.checkpoints.io import _import_keras3_v1

        store = {"my_custom_conv": [[np.zeros((3, 3, 3, 32))]]}
        with pytest.raises(ValueError, match="found classes"):
            _import_keras3_v1(store, ModelConfig(alpha=1.0, resolution=224))

    def test_v3_importer_unrecognized_bases(self):
        from mobilenet_tpu.checkpoints.v3 import _import_keras3_v3
        from mobilenet_tpu.models.mobilenet_v3 import V3Config

        with pytest.raises(ValueError, match="unrecognized keras-3 layout"):
            _import_keras3_v3({"dense": []},
                              V3Config(variant="large", alpha=1.0,
                                       resolution=224))


class TestFoldedRequant:
    """Round-5 FOLDED_REQUANT scheme (VERDICT r4 #3): the single-multiplier
    requant order. The oracle, the device path and QAT read
    quant/v3.FOLDED_REQUANT together, so each knob setting is a
    self-consistent EXACT scheme; these
    tests pin the cross-setting identities and the per-setting exactness."""

    def _acc_a(self, rng, n=512, c=96):
        acc = rng.integers(-60_000, 60_000, size=(n, c)).astype(np.int32)
        a = (rng.uniform(1e-4, 5e-3, size=(c,))).astype(np.float32)
        return acc, a

    def test_inv_s_one_is_bit_identical_across_knob(self, monkeypatch):
        """m = a*1.0 == a exactly in IEEE, so a layer with inv_s = 1.0
        keeps IDENTICAL integers under either order."""
        import mobilenet_tpu.quant.v3 as v3

        rng = np.random.default_rng(0)
        acc, a = self._acc_a(rng)
        outs = {}
        for knob in (True, False):
            monkeypatch.setattr(v3, "FOLDED_REQUANT", knob)
            for act in ("relu", "linear"):
                outs[(knob, act)] = v3._requant_named_np(
                    acc, a, np.float32(1.0), act)
        for act in ("relu", "linear"):
            np.testing.assert_array_equal(outs[(True, act)],
                                          outs[(False, act)])

    @pytest.mark.parametrize("knob", [True, False])
    @pytest.mark.parametrize("act", ["relu", "hswish", "linear"])
    def test_dev_twin_exact_per_setting(self, monkeypatch, knob, act):
        import jax.numpy as jnp

        import mobilenet_tpu.quant.v3 as v3

        monkeypatch.setattr(v3, "FOLDED_REQUANT", knob)
        rng = np.random.default_rng(1)
        acc, a = self._acc_a(rng)
        inv_s = np.float32(37.5)
        want = v3._requant_named_np(acc, a, inv_s, act)
        got = np.asarray(v3._requant_named_dev(
            jnp.asarray(acc), jnp.asarray(a), float(inv_s), act))
        np.testing.assert_array_equal(got, want)

    def test_qat_taps_track_the_knob(self, monkeypatch):
        """fq_requant_named returns the oracle's integers under BOTH knob
        settings (the QAT fake-quant forward is bit-equal to deployment)."""
        import jax.numpy as jnp

        import mobilenet_tpu.quant.v3 as v3
        from mobilenet_tpu.quant.qat import fq_requant_named

        rng = np.random.default_rng(3)
        acc, a = self._acc_a(rng, n=128, c=64)
        inv_s = np.float32(11.0)
        for knob in (True, False):
            monkeypatch.setattr(v3, "FOLDED_REQUANT", knob)
            for act in ("relu", "hswish", "linear"):
                want = v3._requant_named_np(acc, a, inv_s, act)
                got = np.asarray(fq_requant_named(
                    jnp.asarray(acc, jnp.float32), jnp.asarray(a),
                    float(inv_s), act)).astype(np.int8)
                np.testing.assert_array_equal(got, want, err_msg=f"{knob} {act}")


