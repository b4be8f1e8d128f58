"""INT8 verification: device path vs oracles with an EXACT equality gate
(deterministic integer arithmetic — the true "bit-match" tier, SURVEY.md SS7).
"""

from __future__ import annotations

from typing import Any, Dict

import jax
import jax.numpy as jnp
import numpy as np

from ..config import ModelConfig
from . import model as qmodel
from . import oracle as qoracle
from .quantize import QuantizedParams, quantize, quantize_input


def verify_int8(config: ModelConfig, folded_params: Dict[str, Any],
                x_f32: np.ndarray, oracle: str = "numpy") -> bool:
    """Run device int8 pipeline and oracle; every layer must match exactly."""
    q = quantize(folded_params, config)
    x_i8 = quantize_input(x_f32)

    dev = qmodel._as_device_tree(q)
    logits_d, acts_d = jax.jit(
        lambda x: qmodel.forward_i8(dev, x, config, collect=True)
    )(jnp.asarray(x_i8))

    if oracle == "cpp":
        from .. import cpu_ref
        logits_o, acts_o = _cpp_forward_all(q, x_i8, config)
    else:
        logits_o, acts_o = qoracle.forward_all(q, x_i8, config)

    ok = True
    for name, ref in acts_o.items():
        got = np.asarray(acts_d[name])
        if name == "logits":
            match = np.array_equal(got, np.asarray(ref, np.float32))
        else:
            match = np.array_equal(got, ref)
        n_bad = int((got != ref).sum()) if not match else 0
        print(f"[{'OK ' if match else 'FAIL'}] {name:14s} exact "
              f"{'' if match else f'({n_bad} mismatches)'}")
        ok &= match
    print("INT8 VERIFY", "OK" if ok else "FAILED", f"({oracle} oracle)")
    return ok


def _cpp_forward_all(q: QuantizedParams, x_i8: np.ndarray, config: ModelConfig):
    """Native C++ int8 oracle full forward (cpu_ref int8 kernels)."""
    from .. import cpu_ref

    relu6 = config.relu6
    acts: Dict[str, np.ndarray] = {}
    c1 = q.conv1
    y = cpu_ref.conv3x3_i8(x_i8, c1.w_i8, c1.bias_i32, c1.m, c1.s_out, 2, relu6)
    acts["conv1"] = y
    for i, (blk, stride) in enumerate(zip(q.blocks, config.block_strides)):
        d = blk["dw"]
        y = cpu_ref.dw3x3_i8(y, d.w_i8, d.bias_i32, d.m, d.s_out, stride, relu6)
        acts[f"block{i:02d}_dw"] = y
        p = blk["pw"]
        y = cpu_ref.pw_i8(y, p.w_i8, p.bias_i32, p.m, p.s_out, relu6)
        acts[f"block{i:02d}_pw"] = y
    pooled = qoracle.avgpool_i8(y)
    acts["pool"] = pooled
    from .quantize import ACT_HIDDEN_SCALE

    logits = qoracle.fc_i8_logits(pooled, q.fc_w_i8, ACT_HIDDEN_SCALE, q.fc_s_w,
                                  q.fc_b_f32)
    acts["logits"] = logits
    return logits, acts
