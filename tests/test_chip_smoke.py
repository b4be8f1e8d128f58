"""chip_smoke.py on the CPU: each phase at a tiny size (alpha 0.25, res 64
or 96) for its control flow, and the script's refusal to run without a GPU
or outside the repository."""

import os
import shutil
import subprocess
import sys

import jax.numpy as jnp
import pytest

import chip_smoke
from mobilenet_tpu import platform

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_check_raises_on_failure():
    chip_smoke.check(True, "fine")
    with pytest.raises(chip_smoke.CheckFailed, match="broken"):
        chip_smoke.check(False, "broken")


def test_phase_device_reports_the_backend(capsys):
    plat, kind, count = chip_smoke.phase_device(require_gpu=False)
    assert (plat, kind, count) == ("cpu", "cpu", 8)
    assert "[device] devices=" in capsys.readouterr().out


def test_phase_device_requires_a_gpu():
    with pytest.raises(chip_smoke.CheckFailed, match="no GPU"):
        chip_smoke.phase_device()


@pytest.fixture(scope="module")
def tiny_pipe():
    return chip_smoke.phase_v1_bf16(alpha=0.25, res=64, batch=8, n_cmp=4)


def test_phase_v1_bf16_tiny(tiny_pipe, capsys):
    assert tiny_pipe.config.resolution == 64
    assert tiny_pipe.dtype == jnp.bfloat16


def test_phase_v1_layers_tiny(capsys):
    chip_smoke.phase_v1_layers(alpha=0.25, res=64)
    assert "29 layers vs NumPy oracle" in capsys.readouterr().out


def test_phase_serving_tiny(tiny_pipe, capsys):
    chip_smoke.phase_serving(tiny_pipe, streams=4, per_stream=2, max_batch=4)
    out = capsys.readouterr().out
    assert "errors=0 retries=0" in out and "8 answers from 4 streams" in out


def test_phase_v1_int8_tiny(capsys):
    chip_smoke.phase_v1_int8(alpha=0.25, res=64, n=2)
    assert "all bit-exact" in capsys.readouterr().out


def test_phase_families_tiny(capsys):
    chip_smoke.phase_families(res=96, alpha_v2=0.35, alpha_v3=0.75,
                              n_bf16=2, n_int8=1, n_calib=4)
    out = capsys.readouterr().out
    for name in ("v2", "v3_large", "v3_small"):
        assert f"[{name}] bf16 vs f32 logits" in out
        assert f"[{name}_int8]" in out


def test_phase_kernel_interpreted(capsys):
    chip_smoke.phase_kernel([(16, 16, 8, 16, 1), (16, 16, 16, 32, 2)],
                            interpret=True)
    assert capsys.readouterr().out.count("[kernel]") == 4  # bf16 + f32 each


def test_phase_kernel_refuses_an_empty_shape_list():
    with pytest.raises(chip_smoke.CheckFailed, match="serves no V1 block"):
        chip_smoke.phase_kernel([])


def test_kernel_shapes_follow_the_platform_rule(monkeypatch):
    assert chip_smoke.kernel_shapes() == []  # CPU: XLA everywhere
    monkeypatch.setattr(platform, "accelerator", lambda: "gpu")
    assert chip_smoke.kernel_shapes() == [
        (112, 112, 32, 64, 1), (112, 112, 64, 128, 2),
        (56, 56, 128, 128, 1), (56, 56, 128, 256, 2)]


@pytest.mark.parametrize("argv", [[], ["--cards", "4"]])
def test_main_fails_without_gpu(argv, capsys):
    assert chip_smoke.main(argv) == 1
    out = capsys.readouterr()
    assert '"ok"' not in out.out and "no GPU" in out.err


def test_script_exits_nonzero_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_script_alone_exits_nonzero(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_exact_layers_reports_a_mismatch():
    import numpy as np

    ref = {"a": np.zeros(4, np.int8), "logits": np.zeros(2, np.float32)}
    chip_smoke._exact_layers("t", ref, dict(ref))
    bad = dict(ref, a=np.ones(4, np.int8))
    with pytest.raises(chip_smoke.CheckFailed, match="1 int8 layers differ"):
        chip_smoke._exact_layers("t", ref, bad)


def test_bf16_check_rejects_a_wrong_forward():
    """A bf16 forward that is off by O(1) of the logits' scale fails the
    family tolerance."""
    import numpy as np

    from mobilenet_tpu import ModelConfig
    from mobilenet_tpu.checkpoints import default_folded
    from mobilenet_tpu.models import mobilenet_v1

    cfg = ModelConfig(alpha=0.25, resolution=64)

    def broken(p, v, c):
        out = mobilenet_v1.forward(p, v, c)
        return out * 1.5 if out.dtype == jnp.bfloat16 else out

    x = np.random.default_rng(0).uniform(-1, 1, (2, 64, 64, 3)).astype(
        np.float32)
    with pytest.raises(chip_smoke.CheckFailed, match="bf16 logits off"):
        chip_smoke._bf16_vs_f32("t", "v1", broken, default_folded(cfg), x,
                                cfg)
