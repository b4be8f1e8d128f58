"""INT8 fixed-point quantization pass (SURVEY.md SS2 C7, BASELINE.json:10).

Scheme (mirrors FPGA fixed-point practice):
  - symmetric int8 everywhere, zero-point 0
  - activations: ReLU6 bounds every hidden activation to [0, 6], so hidden
    activation scales are FIXED at s = 6/127 — no data calibration needed
    (the analog of the reference's compile-time fixed-point formats).
    The preprocessed input lives in [-1, 1] -> s_in = 1/127.
  - weights: per-output-channel symmetric, s_w[oc] = max|w[..,oc]| / 127
  - bias: int32 in accumulator units, b_i32 = rint(b_f32 / (s_in * s_w[oc]))
  - requantization between layers: out_i8 = clamp(rint(acc_i32 * m[oc])) with
    m[oc] = s_in * s_w[oc] / s_out, ReLU6 applied in the quantized domain as
    clamp to six_q = 6/s_out (precomputed float32, shared verbatim with the
    C++ oracle so the paths agree BIT-FOR-BIT).

All scale arithmetic is done in float32 on the host so the device path, the
NumPy int8 twin, and cpu_ref's int8 kernels use identical constants.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import numpy as np

from ..config import ModelConfig

ACT_IN_SCALE = np.float32(1.0 / 127.0)  # preprocessed input in [-1, 1]
ACT_HIDDEN_SCALE = np.float32(6.0 / 127.0)  # every ReLU6 output


@dataclasses.dataclass
class QuantLayer:
    """One quantized conv layer: int8 weights + requant constants."""

    w_i8: np.ndarray  # same layout as the fp32 weight
    bias_i32: np.ndarray  # (Cout,) accumulator-unit bias
    m: np.ndarray  # (Cout,) float32 requant multiplier
    s_in: np.float32
    s_out: np.float32
    six_q: np.float32  # 6/s_out, the in-domain ReLU6 clip


def _quant_weight(w: np.ndarray, out_axis: int):
    red = tuple(i for i in range(w.ndim) if i != out_axis)
    absmax = np.maximum(np.abs(w).max(axis=red), 1e-12).astype(np.float32)
    s_w = (absmax / np.float32(127.0)).astype(np.float32)
    shape = [1] * w.ndim
    shape[out_axis] = -1
    w_i8 = np.clip(np.rint(w / s_w.reshape(shape)), -127, 127).astype(np.int8)
    return w_i8, s_w


def _quant_layer(w, b, out_axis, s_in, s_out, f32_bias_bound=False) -> QuantLayer:
    w_i8, s_w = _quant_weight(np.asarray(w, np.float32), out_axis)
    acc_scale = (np.float32(s_in) * s_w).astype(np.float32)
    bias_i32 = np.clip(
        np.rint(np.asarray(b, np.float32) / acc_scale), -(2**31) + 1, 2**31 - 1
    ).astype(np.int32)
    # Exact-f32-integer precondition, DW LAYERS ONLY: the QAT graph adds
    # the bias into the f32 tap accumulator (quant/qat.py), which
    # reproduces i32 bit-for-bit ONLY while every partial sum stays below
    # 2^24 (tap sums <= 9*127*127).
    # pw/fc/conv1 add bias in native int32 and carry no such bound. Guard
    # host-side, once, so a degenerate checkpoint (tiny weight scale -> huge
    # accumulator-unit bias) fails loudly instead of silently breaking the
    # int8 EXACT-equality gate.
    if f32_bias_bound and np.abs(bias_i32).max(initial=0) > 2**24 - 2 * 9 * 127 * 127:
        raise ValueError(
            "quantized dw bias exceeds the exact-f32-integer accumulation "
            f"bound (|bias_i32|_max = {np.abs(bias_i32).max()}); this "
            "checkpoint's weight scale is degenerate for the int8 fixed-point path"
        )
    m = (acc_scale / np.float32(s_out)).astype(np.float32)
    six_q = np.float32(6.0) / np.float32(s_out)
    return QuantLayer(
        w_i8=w_i8, bias_i32=bias_i32, m=m,
        s_in=np.float32(s_in), s_out=np.float32(s_out), six_q=six_q,
    )


@dataclasses.dataclass
class QuantizedParams:
    """Full quantized model (weights + scales), host-side numpy."""

    conv1: QuantLayer
    blocks: List[Dict[str, QuantLayer]]
    fc_w_i8: np.ndarray  # (C, classes)
    fc_s_w: np.ndarray  # (classes,) per-column weight scale
    fc_b_f32: np.ndarray  # (classes,) float bias (logits stay float)
    config: Any = None


def quantize(folded_params: Dict[str, Any], config: ModelConfig) -> QuantizedParams:
    """Fold-BN fp32 pytree -> int8 model with per-layer requant constants."""
    conv1 = _quant_layer(
        folded_params["conv1"]["w"], folded_params["conv1"]["b"],
        out_axis=3, s_in=ACT_IN_SCALE, s_out=ACT_HIDDEN_SCALE,
    )
    blocks = []
    for blk in folded_params["blocks"]:
        blocks.append(
            {
                "dw": _quant_layer(
                    blk["dw"]["w"], blk["dw"]["b"], out_axis=3,
                    s_in=ACT_HIDDEN_SCALE, s_out=ACT_HIDDEN_SCALE,
                    f32_bias_bound=True,
                ),
                "pw": _quant_layer(
                    blk["pw"]["w"], blk["pw"]["b"], out_axis=1,
                    s_in=ACT_HIDDEN_SCALE, s_out=ACT_HIDDEN_SCALE,
                ),
            }
        )
    fc_w_i8, fc_s_w = _quant_weight(
        np.asarray(folded_params["fc"]["w"], np.float32), out_axis=1
    )
    return QuantizedParams(
        conv1=conv1,
        blocks=blocks,
        fc_w_i8=fc_w_i8,
        fc_s_w=fc_s_w,
        fc_b_f32=np.asarray(folded_params["fc"]["b"], np.float32),
        config=config,
    )


def quantize_input(x_f32: np.ndarray) -> np.ndarray:
    """Preprocessed [-1,1] float input -> int8 at s_in (host twin)."""
    return np.clip(np.rint(np.asarray(x_f32, np.float32) / ACT_IN_SCALE), -127, 127).astype(
        np.int8
    )
