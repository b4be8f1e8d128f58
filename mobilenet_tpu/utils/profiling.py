"""Tracing / profiling subsystem.

Reference analog (SURVEY.md SS5): OpenCL event profiling
(CL_QUEUE_PROFILING_ENABLE + clGetEventProfilingInfo) and SDAccel profile
summaries around each enqueue. JAX equivalents:
  - `trace(path)` — jax.profiler context manager producing Perfetto/XProf
    traces of the compiled steps
  - `cost_analysis(fn, *args)` — XLA's per-executable FLOP/byte model
    (the static analog of the kernel-time report)
  - `CompileClock` — wall-clock of trace+compile per entry (the analog of
    bitstream load time, SURVEY.md SS3.1)
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, Optional

import jax


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a device trace viewable in XProf/TensorBoard/Perfetto."""
    with jax.profiler.trace(log_dir):
        yield


def cost_analysis(fn, *args, **kwargs) -> Dict[str, float]:
    """Lower+compile `fn` and return XLA's cost model numbers.

    Keys of interest: 'flops', 'bytes accessed', plus per-memory-space
    breakdown.
    """
    lowered = jax.jit(fn).lower(*args, **kwargs)
    compiled = lowered.compile()
    costs = compiled.cost_analysis()
    if isinstance(costs, (list, tuple)):
        costs = costs[0] if costs else {}
    return dict(costs or {})


class CompileClock:
    """Measure trace+compile wall time of a jitted entry (the 'bitstream
    load' of this stack)."""

    def __init__(self):
        self.seconds: Optional[float] = None

    def compile(self, fn, *args, **kwargs):
        t0 = time.perf_counter()
        compiled = jax.jit(fn).lower(*args, **kwargs).compile()
        self.seconds = time.perf_counter() - t0
        return compiled


def flops_per_image(config) -> float:
    """Analytic MAC model — the roofline denominator for every family
    (V1: the 28 layers of SURVEY.md SS2; V2/V3: the keras schedules the
    model modules encode). Returns MACs (multiply 2x for FLOPs)."""
    from ..models.mobilenet_v2 import V2Config
    from ..models.mobilenet_v3 import V3Config

    if isinstance(config, V2Config):
        return _flops_v2(config)
    if isinstance(config, V3Config):
        return _flops_v3(config)
    total = 0
    for _, kind, cin, cout, stride, hw in config.layer_shapes():
        out_hw = hw // stride
        if kind == "conv":
            total += out_hw * out_hw * 9 * cin * cout
        elif kind == "dw":
            total += out_hw * out_hw * 9 * cin
        else:
            total += out_hw * out_hw * cin * cout
    total += config.feature_channels * config.num_classes
    return float(total)


def _flops_v2(config) -> float:
    """MACs of one MobileNet-V2 image: stem + t-expand/dw/project blocks
    + conv_last + fc. Expansion width is exactly t*cin (keras rounds only
    output channels)."""
    hw = config.resolution // 2
    total = hw * hw * 9 * 3 * config.stem_channels
    for t, cin, cout, stride in config.block_defs:
        e = int(round(t * cin))
        if t != 1:
            total += hw * hw * cin * e          # expand at INPUT spatial
        out_hw = hw // stride
        total += out_hw * out_hw * 9 * e        # dw 3x3
        total += out_hw * out_hw * e * cout     # linear project
        hw = out_hw
    total += hw * hw * config.block_defs[-1][2] * config.last_channels
    total += config.last_channels * config.num_classes
    return float(total)


def _flops_v3(config) -> float:
    """MACs of one MobileNet-V3 image: stem + bottlenecks (expand/dw kxk/
    SE/project) + conv_last + post-pool head + fc. SE adds 2*Cexp*Se MACs
    per image (two tiny matmuls on the pooled vector)."""
    hw = config.resolution // 2
    total = hw * hw * 9 * 3 * config.stem_channels
    for bd in config.block_defs:
        if bd.has_expand:
            total += hw * hw * bd.cin * bd.cexp
        out_hw = hw // bd.stride
        total += out_hw * out_hw * bd.kernel * bd.kernel * bd.cexp
        if bd.se_mid:
            total += 2 * bd.cexp * bd.se_mid
        total += out_hw * out_hw * bd.cexp * bd.cout
        hw = out_hw
    total += hw * hw * config.block_defs[-1].cout * config.last_conv_channels
    total += config.last_conv_channels * config.last_point_channels
    total += config.last_point_channels * config.num_classes
    return float(total)
