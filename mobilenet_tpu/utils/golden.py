"""Per-layer golden comparison harness.

Reference analog: the verify run (SURVEY.md SS3.2) — FPGA path with per-layer
readback compared elementwise against the C golden dumps. Here: the jitted JAX
pipeline with collect=True compared against the oracle (NumPy twin or C++
cpu_ref), reporting the first divergent layer.

Tolerance policy (SURVEY.md SS7 'Bit-matching float32 per layer'): XLA convs and
device matmuls reassociate float32 accumulation relative to the oracle's fixed tap
order, so the float32 gate is elementwise |diff| <= atol + rtol*|ref| with
tight constants (abs error stays ~1e-6 at activation scale O(1..6)); max-ULP is
reported alongside as a diagnostic. The INT8 path, where requantization is
deterministic, uses an EXACT gate (quant.py oracle == device output bit-for-bit).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

# (atol, rtol) per layer kind — float32 verify path. The comparison is
# full-path (both sides run all preceding layers), so per-layer reassociation
# noise compounds with depth: measured max_abs at alpha=1.0/224 is ~2.5e-5 by
# block 12 (~50 ULP at ReLU6 scale 6, i.e. rel ~4e-6). Real defects (wrong
# padding, stride, BN fold) produce O(1e-1..1) errors — far above this gate.
DW_TOL = (1e-4, 1e-4)  # 9-tap depthwise, fixed-order oracle
MM_TOL = (1e-4, 3e-4)  # K-deep conv/pointwise/fc reductions (K up to 1024)

# MobileNet-V2 gate: linear bottlenecks + residual chains carry reassociation
# noise UNCLIPPED (V1's ReLU6 re-bounds every layer; V2's projections don't),
# so full-path noise compounds ~4x deeper — measured worst max_abs 3.9e-4 at
# ReLU6 scale 6 by block 16 (alpha=1.0/96, both oracles). 1e-3 keeps 2.5x
# headroom over the worst observed while staying >=100x below real-defect
# scale (wrong pad/stride/fold produce O(1e-1..1)).
V2_TOL = (1e-3, 1e-3)

# MobileNet-V3 gate: V2's unclipped-linear story plus unbounded ReLU
# (unclipped activations grow past 6) and hard-swish (one extra multiply
# per activation, and the SE gate injects a pool-reduction product into
# every channel). Activation magnitudes reach O(30) on the seeded weight
# set, so the absolute term dominates when values are large; the V2-style
# relative term covers the rest. Measured worst full-path divergence on
# the seeded set (device fp32 vs both oracles, large/small 1.0/96-224):
# within V2's envelope scaled by the larger activations — 3e-3/1e-3 keeps
# >=2x headroom while staying >=30x below real-defect scale.
V3_TOL = (3e-3, 1e-3)

# bf16 device logits vs the float32 reference of the same weights on the
# same device (chip_smoke.py): max |bf16 - f32| <= BF16_LOGITS_REL * the
# reference's max |logit|. bf16 keeps 8 mantissa bits, and every layer
# stores its output in bf16, so the rounding compounds with depth in
# proportion to the logits' scale; a wrong padding, stride or fold is off by
# O(1) of that scale. V2/V3 carry unclipped linear bottlenecks and
# residual sums, so their rounding compounds further than V1's. Values and
# measured basis: PERF.md, "Tolerances".
BF16_LOGITS_REL = {"v1": 3e-2, "v2": 1.5e-1, "v3": 1.2e-1}

# The fused block kernel (ops/block_triton.py) vs the NumPy oracle at one
# block: bf16 output is stored in bf16, whose step at ReLU6's top (4..6) is
# 2^-5 = 0.031, and the depthwise tile is rounded to bf16 before the dot;
# float32 sums in another order than the oracle (MM_TOL's reasoning).
KERNEL_BF16_TOL = (4e-2, 1e-2)
KERNEL_F32_TOL = MM_TOL

# Measured bf16 top-1 flip class for `cli eval` tie-awareness: relative
# oracle-logit margins under which a device-bf16 top-1 flip is rounding,
# not defect. V1 1.0-224 on chip: 0 flips in 256 (class << 1e-3). V3-Large
# 1.0-224 on chip: flips at rel margin 1.3% (2026-08-18 campaign), i.e.
# within the 4.2% bf16-vs-fp32 logits class above. int8 is bit-exact by
# contract — its tie margin is forced to 0 in cmd_eval.
BF16_TIE_MARGIN = {"v1": 1e-3, "v2": 3e-2, "v3": 3e-2}


def max_ulp_diff(a: np.ndarray, b: np.ndarray) -> int:
    """Max distance in representable float32 steps between two arrays."""
    a32 = np.asarray(a, np.float32)
    b32 = np.asarray(b, np.float32)
    ai = a32.view(np.int32).astype(np.int64)
    bi = b32.view(np.int32).astype(np.int64)
    # Map the sign-magnitude float ordering onto a monotone integer line.
    ai = np.where(ai < 0, np.int64(-0x80000000) - ai, ai)
    bi = np.where(bi < 0, np.int64(-0x80000000) - bi, bi)
    return int(np.max(np.abs(ai - bi))) if a32.size else 0


@dataclasses.dataclass
class LayerReport:
    name: str
    max_abs: float
    max_rel: float
    max_ulp: int
    excess: float  # max(|diff| - (atol + rtol|ref|)); <= 0 means pass
    atol: float
    rtol: float

    @property
    def ok(self) -> bool:
        return self.excess <= 0.0

    def __str__(self) -> str:
        flag = "OK " if self.ok else "FAIL"
        return (
            f"[{flag}] {self.name:14s} max_abs={self.max_abs:.3e} "
            f"max_rel={self.max_rel:.3e} ulp={self.max_ulp} "
            f"(gate atol={self.atol:g} rtol={self.rtol:g})"
        )


def _tol_for(name: str) -> Tuple[float, float]:
    return DW_TOL if name.endswith("_dw") else MM_TOL


def compare_activations(
    got: Dict[str, np.ndarray],
    golden: Dict[str, np.ndarray],
    tols: Optional[Dict[str, Tuple[float, float]]] = None,
) -> List[LayerReport]:
    reports: List[LayerReport] = []
    for name, ref in golden.items():
        if name not in got:
            raise KeyError(f"pipeline did not produce layer {name!r}")
        test = np.asarray(got[name], np.float32)
        ref = np.asarray(ref, np.float32)
        if test.shape != ref.shape:
            raise AssertionError(f"{name}: shape {test.shape} vs golden {ref.shape}")
        diff = np.abs(test - ref)
        absref = np.abs(ref)
        atol, rtol = (tols or {}).get(name, _tol_for(name))
        reports.append(
            LayerReport(
                name=name,
                max_abs=float(diff.max()) if diff.size else 0.0,
                max_rel=float((diff / np.maximum(absref, 1e-6)).max()) if diff.size else 0.0,
                max_ulp=max_ulp_diff(test, ref),
                excess=float((diff - (atol + rtol * absref)).max()) if diff.size else 0.0,
                atol=atol,
                rtol=rtol,
            )
        )
    return reports


def first_divergence(reports: List[LayerReport]) -> Optional[LayerReport]:
    for r in reports:
        if not r.ok:
            return r
    return None


def assert_all_match(reports: List[LayerReport]) -> None:
    bad = first_divergence(reports)
    if bad is not None:
        lines = "\n".join(str(r) for r in reports)
        raise AssertionError(f"first divergence at {bad.name}:\n{lines}")
