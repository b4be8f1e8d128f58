"""The accelerator the program runs on, and what the program reads off it.

Every platform decision lives here and is made when it is asked for, never
at import:

  - accelerator(): "gpu" or "cpu";
  - select_backend(): the CLI's --backend flag;
  - enable_compile_cache(): JAX's persistent compilation cache;
  - peak(): published peak rates, keyed by `device_kind`;
  - block_kernel_serves(): whether the fused depthwise+pointwise kernel
    (ops/block_triton.py) runs a separable block, or XLA does.
"""

from __future__ import annotations

import os
from typing import NamedTuple

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# One fixed path inside the checkout: the cache key includes the path, so a
# directory that moves between runs never hits.
DEFAULT_CACHE_DIR = os.path.join(REPO_ROOT, ".jax_cache")
CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"

ACCELERATORS = ("cpu", "gpu")


def accelerator() -> str:
    """"gpu" when JAX's default backend is a CUDA card, else "cpu"."""
    import jax

    platform = jax.default_backend()
    if platform not in ACCELERATORS:
        raise RuntimeError(f"unsupported JAX platform {platform!r}")
    return platform


def select_backend(backend: str) -> None:
    """Route --backend {cpu,gpu}. `jax_platforms` is fixed once a backend
    initializes, so this runs before any JAX operation."""
    import jax
    from jax._src import xla_bridge

    if backend not in ACCELERATORS:
        raise SystemExit(f"--backend must be one of {ACCELERATORS}")
    current = jax.config.jax_platforms  # None = auto-detect
    if backend == "cpu":
        if current == "cpu":
            return
        if (xla_bridge.backends_are_initialized()
                and jax.default_backend() != "cpu"):
            raise SystemExit(
                "--backend cpu: a non-CPU JAX backend is already initialized "
                "in this process; run from a fresh process")
        jax.config.update("jax_platforms", "cpu")
        return
    # gpu: an explicitly configured other platform (JAX_PLATFORMS=cpu) is
    # authoritative; otherwise ask JAX what it found.
    if current not in (None, "", "cuda", "gpu") or jax.default_backend() != "gpu":
        raise SystemExit(
            f"--backend gpu: no GPU available (jax_platforms={current!r}, "
            f"devices={[d.platform for d in jax.devices()]})")


def enable_compile_cache() -> str:
    """Keep compiled programs across processes. JAX_COMPILATION_CACHE_DIR,
    when set, names the directory and no other is set here; otherwise the
    cache lives at DEFAULT_CACHE_DIR. Returns the directory."""
    import jax

    path = os.environ.get(CACHE_ENV) or DEFAULT_CACHE_DIR
    jax.config.update("jax_compilation_cache_dir", path)
    return path


class Peak(NamedTuple):
    bf16_flops: float       # dense tensor-core rate, FLOP/s
    int8_ops: float         # dense tensor-core rate, OP/s
    hbm_bytes_per_s: float
    source: str


PEAKS = {
    "NVIDIA H100 80GB HBM3": Peak(
        989e12, 1979e12, 3.35e12,
        "NVIDIA H100 Tensor Core GPU data sheet, SXM5, dense, 700 W"),
}


def peak(device_kind: str) -> Peak:
    """Published peaks of `device_kind`; a device not in PEAKS is an error,
    never a default."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(
            f"no published peak for device_kind {device_kind!r}; add it to "
            "mobilenet_tpu.platform.PEAKS with its source") from None


def block_kernel_serves(h: int, dtype) -> bool:
    """True when the fused Triton block kernel runs a separable block whose
    input is h pixels high.

    Only on the GPU (the CPU runs XLA; the kernel's interpreter is for
    tests), only in bfloat16 (the float32 path is the verify path), and
    only at input spatial sizes of 56 and up, the narrow-channel blocks
    where the kernel beat XLA on an H100 (PERF.md, "Kernel decisions")."""
    import jax.numpy as jnp

    return (h >= 56 and jnp.dtype(dtype) == jnp.bfloat16
            and accelerator() == "gpu")
