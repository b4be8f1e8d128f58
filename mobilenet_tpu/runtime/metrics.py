"""Structured run metrics (SURVEY.md SS5 'Metrics / logging / observability').

Reference analog: printf timing + top-k dumps. Rebuild: one JSON document per
run — throughput, latency percentiles, compile time, XLA cost-model
FLOPs/bytes, config identity — suitable for regression tracking (the
PROGRESS-style bench artifacts).
"""

from __future__ import annotations

import dataclasses
import json
import platform as host_platform
import time
from typing import Any, Dict, Optional

import jax


@dataclasses.dataclass
class RunReport:
    variant: str
    dtype: str
    batch_size: int
    images_per_sec: float
    p50_latency_ms: float
    p99_latency_ms: float
    backend: str = ""
    device_kind: str = ""
    compile_seconds: Optional[float] = None
    xla_flops: Optional[float] = None
    xla_bytes_accessed: Optional[float] = None
    model_macs_per_image: Optional[float] = None
    mfu: Optional[float] = None  # None off the GPU: not measured
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)
    timestamp: float = dataclasses.field(default_factory=time.time)

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["host"] = host_platform.node()
        return json.dumps(d)


def build_report(pipeline, stats: Dict[str, float], *,
                 compile_seconds: Optional[float] = None,
                 with_cost_analysis: bool = False) -> RunReport:
    from .. import platform
    from ..utils.profiling import flops_per_image

    cfg = pipeline.config
    macs = flops_per_image(cfg)
    imgs = stats["images_per_sec"]
    kind = jax.devices()[0].device_kind
    mfu = None
    if platform.accelerator() == "gpu":
        # model FLOP/s over the device's published bf16 peak
        mfu = round(imgs * macs * 2 / platform.peak(kind).bf16_flops, 5)

    report = RunReport(
        variant=cfg.variant_name(),
        dtype=str(jax.numpy.dtype(pipeline.dtype).name),
        batch_size=int(stats.get("batch_size", 0)),
        images_per_sec=round(imgs, 1),
        p50_latency_ms=round(stats.get("p50_latency_ms", 0.0), 3),
        p99_latency_ms=round(stats.get("p99_latency_ms", 0.0), 3),
        backend=jax.default_backend(),
        device_kind=kind,
        compile_seconds=compile_seconds,
        model_macs_per_image=macs,
        mfu=mfu,
        extra={k: v for k, v in stats.items()
               if k not in {"images_per_sec", "p50_latency_ms", "p99_latency_ms",
                            "batch_size"}},
    )
    if with_cost_analysis:
        try:
            from ..utils.profiling import cost_analysis
            import numpy as np

            res = cfg.resolution
            dummy = jax.numpy.zeros((int(stats.get("batch_size", 1)), res, res, 3),
                                    jax.numpy.uint8)
            costs = cost_analysis(
                lambda p, x: pipeline._entry("probs_u8")(p, x), pipeline.params, dummy
            )
            report.xla_flops = costs.get("flops")
            report.xla_bytes_accessed = costs.get("bytes accessed")
        except Exception:  # cost model optional; never fail a bench run
            pass
    return report
