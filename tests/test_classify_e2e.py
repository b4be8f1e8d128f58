"""End-to-end single-image classify with a real encoded image (the
reference's primary mode, BASELINE.json:7 / SURVEY.md SS3.4).

Exercises decode_image_host -> cli.main classify -> top-k, asserting the CLI
output matches the numpy oracle run on the identically-preprocessed input.
The decoded uint8 image goes straight to the jitted entry (one on-device
resize in float — no host resize, no lossy uint8 round-trip).
"""

import json
import re

import numpy as np
import pytest
from PIL import Image

from mobilenet_tpu import ModelConfig
from mobilenet_tpu import cli
from mobilenet_tpu.checkpoints import fold_bn, init_params
from mobilenet_tpu.ops import preprocess as prep
from mobilenet_tpu.oracle import numpy_ref

ALPHA, RES = 0.25, 64


@pytest.fixture(scope="module")
def png_path(tmp_path_factory):
    # Non-square on purpose: the on-device resize path must handle it.
    rng = np.random.default_rng(7)
    arr = rng.integers(0, 256, (96, 80, 3), dtype=np.uint8)
    path = tmp_path_factory.mktemp("img") / "fixture.png"
    Image.fromarray(arr).save(path)
    return str(path)


def _parse_topk(out: str):
    rows = re.findall(r"top-\d+: class (\d+)\s+p=([0-9.]+)", out)
    return [(int(c), float(p)) for c, p in rows]


def _oracle_topk(img_u8: np.ndarray, k: int = 5):
    cfg = ModelConfig(alpha=ALPHA, resolution=RES)
    folded = fold_bn(init_params(cfg, seed=0), eps=cfg.bn_eps)
    # Same on-device preprocessing (resize isn't an oracle layer), then the
    # pure-NumPy forward.
    x = np.asarray(prep.preprocess(img_u8[None], RES, np.float32))
    logits, _ = numpy_ref.forward_all(folded, x, cfg)
    e = np.exp(logits[0] - logits[0].max())
    probs = e / e.sum()
    idx = np.argsort(-probs)[:k]
    return [(int(i), float(probs[i])) for i in idx]


def test_classify_cli_matches_oracle(png_path, capsys):
    cli.main(["classify", png_path, "--alpha", str(ALPHA), "--res", str(RES),
              "--dtype", "float32"])
    got = _parse_topk(capsys.readouterr().out)
    assert len(got) == 5

    from mobilenet_tpu.ops.preprocess import decode_image_host

    img = decode_image_host(png_path)
    assert img.shape == (96, 80, 3)  # PIL decode preserves HWC
    want = _oracle_topk(img)
    assert [c for c, _ in got] == [c for c, _ in want]
    np.testing.assert_allclose(
        [p for _, p in got], [p for _, p in want], atol=2e-4)


def test_classify_cli_int8_smoke(png_path, capsys):
    cli.main(["classify", png_path, "--alpha", str(ALPHA), "--res", str(RES),
              "--int8"])
    got = _parse_topk(capsys.readouterr().out)
    assert len(got) == 5
    assert all(0 <= c < 1000 and 0 <= p <= 1 for c, p in got)


def test_classify_cli_jpeg_decode(tmp_path, capsys):
    rng = np.random.default_rng(3)
    arr = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
    path = tmp_path / "fixture.jpg"
    Image.fromarray(arr).save(path, quality=90)
    cli.main(["classify", str(path), "--alpha", str(ALPHA), "--res", str(RES)])
    assert len(_parse_topk(capsys.readouterr().out)) == 5


def test_verify_cli_honors_ckpt(tmp_path, capsys):
    """verify --ckpt must gate the GIVEN weights (previously ignored)."""
    from mobilenet_tpu.checkpoints import save_npz

    cfg = ModelConfig(alpha=ALPHA, resolution=RES)
    folded = fold_bn(init_params(cfg, seed=42), eps=cfg.bn_eps)
    path = tmp_path / "folded.npz"
    save_npz(str(path), folded)
    with pytest.raises(SystemExit) as ei:
        cli.main(["verify", "--alpha", str(ALPHA), "--res", str(RES),
                  "--oracle", "numpy", "--ckpt", str(path)])
    assert ei.value.code == 0
    assert "VERIFY OK" in capsys.readouterr().out


def test_verify_alpha075_keeps_unpadded_shapes(capsys):
    """ADVICE r1 (medium): verify must keep UNPADDED channel shapes so
    activations line up with the oracle at alpha=0.75 channel counts
    (24/48/96). Exit 0 = per-layer report ran, no shape mismatch."""
    with pytest.raises(SystemExit) as ei:
        cli.main(["verify", "--alpha", "0.75", "--res", "64",
                  "--oracle", "numpy"])
    assert ei.value.code == 0
    out = capsys.readouterr().out
    assert "conv1" in out and "VERIFY OK" in out


def test_verify_pipeline_unpadded_even_when_padding_backend():
    """The collect/verify entry must see the oracle's channel widths: the
    pipeline never pads channels."""
    from mobilenet_tpu.runtime.pipeline import InferencePipeline

    cfg = ModelConfig(alpha=0.75, resolution=64)
    pipe = InferencePipeline(cfg, seed=0, dtype=np.float32)
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
    _, acts = pipe.activations(x)
    assert acts["conv1"].shape[-1] == 24  # int(32 * 0.75), unpadded


def test_benchmark_warmup_zero():
    """warmup=0 used to NameError on an unbound loop variable."""
    from mobilenet_tpu.runtime.pipeline import InferencePipeline

    pipe = InferencePipeline(ModelConfig(alpha=ALPHA, resolution=RES), seed=0)
    stats = pipe.benchmark(batch_size=2, steps=1, warmup=0)
    assert stats["images_per_sec"] > 0
