"""End-to-end accuracy agreement gate (runtime/eval.py + `cli eval`).

The reference's acceptance check was top-1 accuracy identical to the CPU
reference on sample images (SURVEY.md §4, BASELINE.json:5). These tests run
the gate on the sw_emu tier: device pipeline (CPU backend) vs
the NumPy/C++ golden oracles.
"""

import json

import numpy as np
import pytest
from PIL import Image

from mobilenet_tpu import ModelConfig, cli
from mobilenet_tpu.runtime.eval import (
    evaluate_agreement,
    load_dir_images,
    synth_images,
)

CFG = ModelConfig(alpha=0.25, resolution=64, compute_dtype="float32")


def test_synth_fp32_full_agreement():
    images = synth_images(CFG, 8, seed=5)
    report = evaluate_agreement(CFG, images, batch_size=4)
    assert report["n_images"] == 8
    assert report["top1_agreement"] == 1.0
    assert report["mismatches"] == []
    assert report["top5_overlap"] >= 0.9  # ULP ties may swap ranks 4/5


def test_synth_int8_exact_agreement():
    # int8 device logits are exact integers -> agreement must be total.
    images = synth_images(CFG, 6, seed=9)
    report = evaluate_agreement(CFG, images, int8=True, batch_size=3)
    assert report["top1_agreement"] == 1.0
    assert report["top5_overlap"] == 1.0


def test_dir_mode_mixed_shapes(tmp_path):
    # Mixed sizes exercise the per-shape jit grouping + on-device resize.
    rng = np.random.default_rng(2)
    for i, shape in enumerate([(80, 64), (64, 80), (80, 64)]):
        arr = rng.integers(0, 256, (*shape, 3), dtype=np.uint8)
        Image.fromarray(arr).save(tmp_path / f"img{i}.png")
    (tmp_path / "notes.txt").write_text("not an image")
    images = load_dir_images(str(tmp_path))
    assert len(images) == 3
    report = evaluate_agreement(CFG, images, batch_size=2)
    assert report["top1_agreement"] == 1.0


def test_dir_mode_no_images_raises(tmp_path):
    (tmp_path / "notes.txt").write_text("not an image")
    with pytest.raises(ValueError, match="no decodable images"):
        load_dir_images(str(tmp_path))


def test_cli_eval_gate(capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["eval", "--alpha", "0.25", "--res", "64",
                  "--dtype", "float32", "--n", "4", "--batch", "2"])
    assert e.value.code == 0
    report = json.loads(capsys.readouterr().out)
    assert report["top1_agreement"] == 1.0


def test_cli_eval_cpp_oracle(capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["eval", "--alpha", "0.25", "--res", "64",
                  "--dtype", "float32", "--n", "2", "--batch", "2",
                  "--oracle", "cpp"])
    assert e.value.code == 0
    report = json.loads(capsys.readouterr().out)
    assert report["oracle"] == "cpp"
    assert report["top1_agreement"] == 1.0
