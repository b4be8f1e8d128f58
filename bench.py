#!/usr/bin/env python
"""Throughput benchmark: ONE JSON line with the headline metric.

Metric: MobileNet-V1 1.0-224 bf16 images/sec on one GPU at batch 256
(device-resident input), with batch-1 latency alongside. The line names the
platform, device_kind, device count and power limit it was measured on. MFU
is model FLOPs per second over the bf16 peak of that device_kind
(mobilenet_tpu.platform.PEAKS). With no GPU the script exits non-zero and
prints no result.
"""

import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reports them (a child
    process that never touches JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    import jax

    from mobilenet_tpu import ModelConfig, platform
    from mobilenet_tpu.runtime.pipeline import InferencePipeline
    from mobilenet_tpu.utils.profiling import flops_per_image

    if platform.accelerator() != "gpu":
        print(f"bench.py: no GPU (JAX backend {jax.default_backend()!r})",
              file=sys.stderr)
        return 1
    platform.enable_compile_cache()
    dev = jax.devices()[0]
    peak = platform.peak(dev.device_kind)
    card = power_limit()

    cfg = ModelConfig(alpha=1.0, resolution=224, compute_dtype="bfloat16")
    batch = 256
    pipe = InferencePipeline(cfg, seed=0)
    stats = pipe.benchmark(batch_size=batch, steps=40)
    img_s = stats["images_per_sec"]
    flops = 2.0 * flops_per_image(cfg)
    print(json.dumps({
        "metric": "mobilenet_v1_1.0_224_bf16_images_per_sec_batch256",
        "value": round(img_s, 1),
        "unit": "images/sec",
        "e2e_images_per_sec_with_host_transfer": round(
            stats["e2e_images_per_sec"], 1),
        "p50_latency_ms": round(stats["p50_latency_ms"], 3),
        "p99_latency_ms": round(stats["p99_latency_ms"], 3),
        "ms_per_batch": round(batch / img_s * 1e3, 3),
        "mfu": round(img_s * flops / peak.bf16_flops, 5),
        "peak_source": peak.source,
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "card": card,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
