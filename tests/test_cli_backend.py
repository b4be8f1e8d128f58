"""--backend flag routing (the documented CPU and GPU recipes, README.md).

In-process: under pytest the CPU backend is already initialized (conftest),
so --backend cpu must be a no-op and --backend gpu must fail clearly.
Subprocess: a fresh process with --backend cpu must actually route to CPU —
asserted via the backend field in bench's JSON — and --backend gpu in a
process with no GPU must exit non-zero.
"""

import json
import os
import subprocess
import sys

import pytest

from mobilenet_tpu import cli, platform

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_backend_cpu_noop_when_already_cpu():
    platform.select_backend("cpu")  # must not raise


def test_backend_gpu_errors_without_gpu():
    with pytest.raises(SystemExit, match="no GPU"):
        platform.select_backend("gpu")


def test_backend_cpu_routes_in_fresh_process():
    out = subprocess.run(
        [sys.executable, "-m", "mobilenet_tpu.cli", "--backend", "cpu",
         "bench", "--alpha", "0.25", "--res", "64", "--batch", "2",
         "--steps", "1"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    stats = json.loads(out.stdout.strip().splitlines()[-1])
    assert stats["backend"] == "cpu"
    assert stats["images_per_sec"] > 0


def test_backend_gpu_exits_nonzero_in_fresh_process():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-m", "mobilenet_tpu.cli", "--backend", "gpu",
         "bench", "--alpha", "0.25", "--res", "64", "--batch", "2",
         "--steps", "1"],
        cwd=REPO, capture_output=True, text=True, timeout=300, env=env,
    )
    assert out.returncode != 0
    assert "no GPU" in out.stderr
    assert out.stdout.strip() == ""


@pytest.mark.parametrize(
    "argv,match",
    [
        (["--backend", "cpu", "classify", "/tmp/definitely_missing.jpg",
          "--alpha", "0.25", "--res", "64"], "classify"),
        (["--backend", "cpu", "bench", "--alpha", "0.3", "--res", "64",
          "--batch", "2", "--steps", "1"], "alpha must be one of"),
    ],
)
def test_user_input_errors_exit_cleanly(argv, match):
    """Bad image paths / off-grid configs exit with a one-line message, not
    a traceback (SystemExit carries the cause)."""
    with pytest.raises(SystemExit, match=match):
        cli.main(argv)
