"""INT8 fixed-point subsystem: quantization pass, device ops with per-layer
requantization (XLA), exact NumPy/C++ oracles, verification
(reference analog: C7, SURVEY.md SS2; BASELINE.json:10)."""

from .quantize import QuantizedParams, quantize, quantize_input

__all__ = ["quantize", "quantize_input", "QuantizedParams"]
