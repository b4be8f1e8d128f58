"""mobilenet_tpu.platform: the accelerator, the --backend flag, the compile
cache rule, the peak table, and bench.py's refusal to run without a GPU."""

import os
import subprocess
import sys

import jax
import pytest

from mobilenet_tpu import platform

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cache_config():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_accelerator_here_is_cpu():
    assert platform.accelerator() == "cpu"


def test_cache_dir_default_is_fixed_inside_checkout(monkeypatch, cache_config):
    monkeypatch.delenv(platform.CACHE_ENV, raising=False)
    path = platform.enable_compile_cache()
    assert path == platform.DEFAULT_CACHE_DIR == os.path.join(REPO,
                                                              ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    assert platform.enable_compile_cache() == path  # no pid, time or temp


def test_cache_dir_from_environment(monkeypatch, tmp_path, cache_config):
    monkeypatch.setenv(platform.CACHE_ENV, str(tmp_path))
    assert platform.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == str(tmp_path)


def test_default_cache_dir_is_gitignored():
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_cache_lands_in_env_dir_in_fresh_process(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(tmp_path))
    code = ("import jax; from mobilenet_tpu import platform; "
            "jax.config.update('jax_persistent_cache_min_compile_time_secs', 0);"
            "jax.config.update('jax_persistent_cache_min_entry_size_bytes', -1);"
            "print(platform.enable_compile_cache()); "
            "jax.jit(lambda x: x * 2 + 1)(jax.numpy.ones(3)).block_until_ready()")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == str(tmp_path)
    assert os.listdir(tmp_path)


def test_peak_of_h100():
    p = platform.peak("NVIDIA H100 80GB HBM3")
    assert p.bf16_flops == 989e12
    assert p.int8_ops == 1979e12
    assert p.hbm_bytes_per_s == 3.35e12
    assert "data sheet" in p.source


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA A100-SXM4-80GB", "",
                                  "NVIDIA H100 PCIe"])
def test_peak_of_unknown_device_raises(kind):
    with pytest.raises(KeyError, match="no published peak"):
        platform.peak(kind)


def test_select_backend_rejects_other_names():
    with pytest.raises(SystemExit, match="must be one of"):
        platform.select_backend("rocm")


def test_bench_exits_nonzero_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "bench.py"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no GPU" in out.stderr


def test_accelerator_rejects_other_platforms(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "rocm")
    with pytest.raises(RuntimeError, match="unsupported JAX platform"):
        platform.accelerator()


def test_empty_cache_env_means_default(monkeypatch, cache_config):
    monkeypatch.setenv(platform.CACHE_ENV, "")
    assert platform.enable_compile_cache() == platform.DEFAULT_CACHE_DIR


@pytest.mark.parametrize("kind", sorted(platform.PEAKS))
def test_every_peak_names_its_source(kind):
    p = platform.peak(kind)
    assert p.source and p.bf16_flops > 0 and p.hbm_bytes_per_s > 0
    assert p.int8_ops >= p.bf16_flops
