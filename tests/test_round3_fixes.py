"""Round-3 advisor-fix regression tests.

Covers ADVICE.md round 2: retry narrowed to device errors (serving.py) and
margin-aware eval ties (runtime/eval.py).
"""

import asyncio

import numpy as np
import pytest

from mobilenet_tpu import ModelConfig


# ---------------------------------------------------------------------------
# serving: deterministic errors must NOT be retried
# ---------------------------------------------------------------------------


def test_deterministic_error_not_retried():
    from mobilenet_tpu.runtime.serving import MicroBatchServer

    class BadShapePipeline:
        def __init__(self, cfg):
            self.config = cfg
            self.armed = False
            self.calls = 0

        def run_batch(self, images):
            self.calls += 1
            if self.armed:
                raise ValueError("operands could not be broadcast")
            return np.zeros((len(images), 1000), np.float32)

    cfg = ModelConfig(alpha=0.25, resolution=64, compute_dtype="float32")
    img = np.zeros((64, 64, 3), np.uint8)

    async def run():
        pipe = BadShapePipeline(cfg)
        server = MicroBatchServer(pipe, max_batch=4, max_delay_ms=1.0,
                                  device_retries=3, retry_backoff_s=0.01)
        pipe.armed = True
        calls_before = pipe.calls
        await server.start()
        with pytest.raises(ValueError):
            await server.submit(img)
        stats = server.stats
        calls = pipe.calls - calls_before
        await server.close()
        return stats, calls

    stats, calls = asyncio.run(run())
    assert stats.retries == 0  # ValueError fails fast, no backoff burned
    assert calls == 1


def test_retryable_predicate():
    from mobilenet_tpu.runtime.serving import _is_retryable_device_error

    assert _is_retryable_device_error(RuntimeError("FAILED_PRECONDITION: x"))
    assert _is_retryable_device_error(RuntimeError("UNAVAILABLE: socket"))
    assert not _is_retryable_device_error(ValueError("bad shape"))
    assert not _is_retryable_device_error(RuntimeError("plain failure"))
    from jax.errors import JaxRuntimeError

    assert _is_retryable_device_error(JaxRuntimeError("device halted"))


# ---------------------------------------------------------------------------
# eval: margin-aware near-tie handling
# ---------------------------------------------------------------------------


def test_eval_reports_tie_aware_agreement():
    from mobilenet_tpu.runtime.eval import evaluate_agreement, synth_images

    cfg = ModelConfig(alpha=0.25, resolution=64, compute_dtype="float32")
    images = synth_images(cfg, 4, seed=3)
    report = evaluate_agreement(cfg, images, batch_size=2, tie_margin=1e-3)
    assert report["top1_agreement"] == 1.0
    assert report["top1_agreement_tie_aware"] == 1.0
    assert report["near_ties"] == 0
    assert report["tie_margin"] == 1e-3


def test_eval_near_tie_classification(monkeypatch):
    """Force a device/oracle flip on a near-tied pair of logits and check it
    counts as a near-tie, while a decisive flip stays a mismatch."""
    import mobilenet_tpu.runtime.eval as ev

    cfg = ModelConfig(alpha=0.25, resolution=64, compute_dtype="float32")
    images = ev.synth_images(cfg, 2, seed=7)

    real_scores = ev._oracle_scores

    def flipped_scores(folded, q, batch, config, **kw):
        g = real_scores(folded, q, batch, config, **kw)
        for row in range(g.shape[0]):
            order = np.argsort(-g[row])
            if row == 0:  # make oracle top-2 a near tie (device will differ)
                g[row, order[1]] = g[row, order[0]] - 1e-6
                g[row, [order[0], order[1]]] = g[row, [order[1], order[0]]]
            else:  # decisive flip: swap top-1 with a far-away class
                g[row, [order[0], order[5]]] = g[row, [order[5], order[0]]]
        return g

    monkeypatch.setattr(ev, "_oracle_scores", flipped_scores)
    report = ev.evaluate_agreement(cfg, images, batch_size=2, tie_margin=1e-3)
    assert report["top1_agreement"] < 1.0
    assert report["near_ties"] == 1
    mism = {m["index"]: m for m in report["mismatches"]}
    assert mism[0]["near_tie"] is True
    assert mism[1]["near_tie"] is False
    assert report["top1_agreement_tie_aware"] == 0.5


def test_eval_int8_forces_strict_tie_margin(monkeypatch, capsys):
    """`cli eval --int8` must gate on EXACT top-1 agreement: int8 logits are
    bit-identical to the oracle by contract, so a near-tie credit would let
    a real int8 defect pass (review finding, round 3)."""
    import sys as _sys

    from mobilenet_tpu import cli
    from mobilenet_tpu.runtime import eval as reval

    seen = {}
    real = reval.evaluate_agreement

    def spy(cfg, images, **kw):
        seen.update(kw)
        return real(cfg, images, **kw)

    monkeypatch.setattr(reval, "evaluate_agreement", spy)
    argv = ["cli", "--backend", "cpu", "eval", "--alpha", "0.25", "--res",
            "64", "--int8", "--n", "2", "--batch", "2",
            "--tie-margin", "0.5"]
    monkeypatch.setattr(_sys, "argv", argv)
    with pytest.raises(SystemExit) as e:
        cli.main()
    assert e.value.code == 0
    assert seen["tie_margin"] == 0.0  # --tie-margin 0.5 overridden for int8


