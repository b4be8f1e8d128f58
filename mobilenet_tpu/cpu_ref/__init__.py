"""ctypes binding for the native C++ golden oracle (cpu_ref.cpp).

Builds libcpuref.so on first use (g++ -O2 -ffp-contract=off; no FMA so the
float32 results are bit-identical to the NumPy twin in oracle/numpy_ref.py).
pybind11 is not available in this image, hence ctypes (task environment note).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Any, Dict, Optional

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "cpu_ref.cpp")
_LIB = os.path.join(_DIR, "libcpuref.so")

_lib: Optional[ctypes.CDLL] = None

_F32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_I8 = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
_I32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_c = ctypes.c_int
_c64 = ctypes.c_int64
_cf = ctypes.c_float


def build(force: bool = False) -> str:
    """Compile cpu_ref.cpp -> libcpuref.so (cached by mtime)."""
    if (
        not force
        and os.path.exists(_LIB)
        and os.path.getmtime(_LIB) >= os.path.getmtime(_SRC)
    ):
        return _LIB
    cmd = [
        "g++", "-O2", "-shared", "-fPIC", "-std=c++17",
        "-ffp-contract=off",  # no FMA: bit-match the NumPy twin
        _SRC, "-o", _LIB,
    ]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError:
        raise RuntimeError(
            "cpu_ref build failed: g++ not found (the C++17 oracle needs it; "
            "the NumPy oracle, --oracle numpy, does not)") from None
    if proc.returncode != 0:
        raise RuntimeError(
            f"cpu_ref build failed ({' '.join(cmd)}):\n{proc.stderr}")
    return _LIB


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(build())
    lib.conv3x3_f32.argtypes = [_F32, _F32, ctypes.c_void_p, _F32] + [_c] * 8
    lib.dw3x3_f32.argtypes = [_F32, _F32, ctypes.c_void_p, _F32] + [_c] * 7
    lib.pw_f32.argtypes = [_F32, _F32, ctypes.c_void_p, _F32, _c64] + [_c] * 4
    lib.avgpool_f32.argtypes = [_F32, _F32] + [_c] * 4
    lib.fc_f32.argtypes = [_F32, _F32, ctypes.c_void_p, _F32] + [_c] * 3
    lib.dwka_f32.argtypes = [_F32, _F32, ctypes.c_void_p, _F32] + [_c] * 7
    lib.pwa_f32.argtypes = [_F32, _F32, ctypes.c_void_p, _F32, _c64] + [_c] * 3
    lib.conv3x3a_f32.argtypes = [_F32, _F32, ctypes.c_void_p, _F32] + [_c] * 7
    lib.dw3x3_i8.argtypes = [_I8, _I8, ctypes.c_void_p, _F32, _cf, _I8] + [_c] * 6
    lib.pw_i8.argtypes = [_I8, _I8, ctypes.c_void_p, _F32, _cf, _I8, _c64] + [_c] * 3
    lib.conv3x3_i8.argtypes = [_I8, _I8, ctypes.c_void_p, _F32, _cf, _I8] + [_c] * 7
    _lib = lib
    return lib


def _bias_ptr(bias, dtype):
    if bias is None:
        return None
    arr = np.ascontiguousarray(bias, dtype)
    return arr.ctypes.data_as(ctypes.c_void_p), arr  # keep arr alive


def _out_hw(size: int, stride: int) -> int:
    return -(-size // stride)


def conv3x3(x, w, bias=None, stride=1, relu6=True, apply_act=True):
    x = np.ascontiguousarray(x, np.float32)
    w = np.ascontiguousarray(w, np.float32)
    n, h, wd, cin = x.shape
    cout = w.shape[3]
    out = np.empty((n, _out_hw(h, stride), _out_hw(wd, stride), cout), np.float32)
    bp = _bias_ptr(bias, np.float32)
    _load().conv3x3_f32(x, w, bp[0] if bp else None, out, n, h, wd, cin, cout,
                        stride, int(relu6), int(apply_act))
    return out


def dw3x3(x, w, bias=None, stride=1, relu6=True, apply_act=True):
    x = np.ascontiguousarray(x, np.float32)
    w = np.ascontiguousarray(w, np.float32)  # (3,3,1,C)
    n, h, wd, c = x.shape
    out = np.empty((n, _out_hw(h, stride), _out_hw(wd, stride), c), np.float32)
    bp = _bias_ptr(bias, np.float32)
    _load().dw3x3_f32(x, w, bp[0] if bp else None, out, n, h, wd, c,
                      stride, int(relu6), int(apply_act))
    return out


def pw(x, w, bias=None, relu6=True, apply_act=True):
    x = np.ascontiguousarray(x, np.float32)
    w = np.ascontiguousarray(w, np.float32)  # (Cin, Cout)
    shape = x.shape
    cin, cout = w.shape
    pixels = int(np.prod(shape[:-1]))
    out = np.empty(shape[:-1] + (cout,), np.float32)
    bp = _bias_ptr(bias, np.float32)
    _load().pw_f32(x.reshape(pixels, cin), w, bp[0] if bp else None,
                   out.reshape(pixels, cout), pixels, cin, cout,
                   int(relu6), int(apply_act))
    return out


_ACT_KINDS = {None: 0, "relu": 1, "relu6": 2, "hswish": 3, "hsigmoid": 4}


def conv3x3a(x, w, bias=None, stride=1, act=None):
    """Stem conv with a NAMED activation (V3: hswish)."""
    x = np.ascontiguousarray(x, np.float32)
    w = np.ascontiguousarray(w, np.float32)
    n, h, wd, cin = x.shape
    cout = w.shape[3]
    out = np.empty((n, _out_hw(h, stride), _out_hw(wd, stride), cout),
                   np.float32)
    bp = _bias_ptr(bias, np.float32)
    _load().conv3x3a_f32(x, w, bp[0] if bp else None, out, n, h, wd, cin,
                         cout, stride, _ACT_KINDS[act])
    return out


def dwk(x, w, bias=None, stride=1, act=None):
    """Depthwise kxk (k from w.shape; V3 uses 3 and 5), named activation."""
    x = np.ascontiguousarray(x, np.float32)
    w = np.ascontiguousarray(w, np.float32)  # (k,k,1,C)
    n, h, wd, c = x.shape
    k = int(w.shape[0])
    out = np.empty((n, _out_hw(h, stride), _out_hw(wd, stride), c), np.float32)
    bp = _bias_ptr(bias, np.float32)
    _load().dwka_f32(x, w, bp[0] if bp else None, out, n, h, wd, c, k,
                     stride, _ACT_KINDS[act])
    return out


def pwa(x, w, bias=None, act=None):
    """Pointwise matmul with a NAMED activation (V3 expand/project/head)."""
    x = np.ascontiguousarray(x, np.float32)
    w = np.ascontiguousarray(w, np.float32)
    shape = x.shape
    cin, cout = w.shape
    pixels = int(np.prod(shape[:-1]))
    out = np.empty(shape[:-1] + (cout,), np.float32)
    bp = _bias_ptr(bias, np.float32)
    _load().pwa_f32(x.reshape(pixels, cin), w, bp[0] if bp else None,
                    out.reshape(pixels, cout), pixels, cin, cout,
                    _ACT_KINDS[act])
    return out


def avgpool(x):
    x = np.ascontiguousarray(x, np.float32)
    n, h, wd, c = x.shape
    out = np.empty((n, c), np.float32)
    _load().avgpool_f32(x, out, n, h, wd, c)
    return out


def fc(x, w, bias=None):
    x = np.ascontiguousarray(x, np.float32)
    w = np.ascontiguousarray(w, np.float32)
    n, c = x.shape
    classes = w.shape[1]
    out = np.empty((n, classes), np.float32)
    bp = _bias_ptr(bias, np.float32)
    _load().fc_f32(x, w, bp[0] if bp else None, out, n, c, classes)
    return out


def dw3x3_i8(x, w, bias_i32, m, s_out, stride=1, relu6=True):
    x = np.ascontiguousarray(x, np.int8)
    w = np.ascontiguousarray(w, np.int8)
    n, h, wd, c = x.shape
    out = np.empty((n, _out_hw(h, stride), _out_hw(wd, stride), c), np.int8)
    bp = _bias_ptr(bias_i32, np.int32)
    _load().dw3x3_i8(x, w, bp[0] if bp else None,
                     np.ascontiguousarray(m, np.float32), float(s_out), out,
                     n, h, wd, c, stride, int(relu6))
    return out


def pw_i8(x, w, bias_i32, m, s_out, relu6=True):
    x = np.ascontiguousarray(x, np.int8)
    w = np.ascontiguousarray(w, np.int8)
    shape = x.shape
    cin, cout = w.shape
    pixels = int(np.prod(shape[:-1]))
    out = np.empty(shape[:-1] + (cout,), np.int8)
    bp = _bias_ptr(bias_i32, np.int32)
    _load().pw_i8(x.reshape(pixels, cin), w, bp[0] if bp else None,
                  np.ascontiguousarray(m, np.float32), float(s_out),
                  out.reshape(pixels, cout), pixels, cin, cout, int(relu6))
    return out


def conv3x3_i8(x, w, bias_i32, m, s_out, stride=1, relu6=True):
    x = np.ascontiguousarray(x, np.int8)
    w = np.ascontiguousarray(w, np.int8)
    n, h, wd, cin = x.shape
    cout = w.shape[3]
    out = np.empty((n, _out_hw(h, stride), _out_hw(wd, stride), cout), np.int8)
    bp = _bias_ptr(bias_i32, np.int32)
    _load().conv3x3_i8(x, w, bp[0] if bp else None,
                       np.ascontiguousarray(m, np.float32), float(s_out), out,
                       n, h, wd, cin, cout, stride, int(relu6))
    return out


def forward_all(params: Dict[str, Any], x: np.ndarray, config) -> Any:
    """Native-oracle full forward, layer names matching the JAX pipeline.
    Twin of oracle/numpy_ref.forward_all (SURVEY.md SS3.6)."""
    relu6 = config.relu6
    acts: Dict[str, np.ndarray] = {}
    y = conv3x3(x, params["conv1"]["w"], params["conv1"]["b"], 2, relu6)
    acts["conv1"] = y
    for i, (blk, stride) in enumerate(zip(params["blocks"], config.block_strides)):
        y = dw3x3(y, blk["dw"]["w"], blk["dw"]["b"], stride, relu6)
        acts[f"block{i:02d}_dw"] = y
        y = pw(y, blk["pw"]["w"], blk["pw"]["b"], relu6)
        acts[f"block{i:02d}_pw"] = y
    pooled = avgpool(y)
    acts["pool"] = pooled
    logits = fc(pooled, params["fc"]["w"], params["fc"]["b"])
    acts["logits"] = logits
    return logits, acts


def forward_all_v3(params: Dict[str, Any], x: np.ndarray, config) -> Any:
    """Native-oracle MobileNet-V3 forward (C++ primitives,
    -ffp-contract=off), layer names matching forward_v3(collect=True).
    Twin of oracle/numpy_ref.forward_all_v3; config is a V3Config. The SE
    gate's scale multiply and the residual adds are plain NumPy f32
    elementwise ops (same status as V2's residual adds)."""
    acts: Dict[str, np.ndarray] = {}
    head_act = config.head_act
    y = conv3x3a(x, params["conv1"]["w"], params["conv1"]["b"], 2, head_act)
    acts["conv1"] = y
    for i, (bd, blk) in enumerate(zip(config.block_defs, params["blocks"])):
        z = y
        if bd.has_expand:
            z = pwa(z, blk["exp"]["w"], blk["exp"]["b"], bd.act)
            acts[f"block{i:02d}_exp"] = z
        z = dwk(z, blk["dw"]["w"], blk["dw"]["b"], bd.stride, bd.act)
        acts[f"block{i:02d}_dw"] = z
        if bd.se_mid:
            se = blk["se"]
            pooled = avgpool(z)
            g = pwa(pooled, se["w1"], se["b1"], "relu")
            g = pwa(g, se["w2"], se["b2"], "hsigmoid")
            z = (z * g[:, None, None, :]).astype(np.float32)
            acts[f"block{i:02d}_se"] = z
        out = pwa(z, blk["prj"]["w"], blk["prj"]["b"], None)
        acts[f"block{i:02d}_prj"] = out
        if bd.has_res:
            out = (out + y).astype(np.float32)
            acts[f"block{i:02d}_out"] = out
        y = out
    y = pwa(y, params["conv_last"]["w"], params["conv_last"]["b"], head_act)
    acts["conv_last"] = y
    pooled = avgpool(y)
    acts["pool"] = pooled
    h = pwa(pooled, params["head"]["w"], params["head"]["b"], head_act)
    acts["head"] = h
    logits = fc(h, params["fc"]["w"], params["fc"]["b"])
    acts["logits"] = logits
    return logits, acts


def forward_all_v2(params: Dict[str, Any], x: np.ndarray, config) -> Any:
    """Native-oracle MobileNet-V2 forward (C++ primitives, -ffp-contract=off),
    layer names matching models.mobilenet_v2.forward_v2(collect=True).
    Twin of oracle/numpy_ref.forward_all_v2; config is a V2Config."""
    acts: Dict[str, np.ndarray] = {}
    y = conv3x3(x, params["conv1"]["w"], params["conv1"]["b"], 2, True)
    acts["conv1"] = y
    for i, ((t, cin, cout, stride), blk) in enumerate(
            zip(config.block_defs, params["blocks"])):
        z = y
        if "exp" in blk:
            z = pw(z, blk["exp"]["w"], blk["exp"]["b"], relu6=True)
            acts[f"block{i:02d}_exp"] = z
        z = dw3x3(z, blk["dw"]["w"], blk["dw"]["b"], stride, True)
        acts[f"block{i:02d}_dw"] = z
        out = pw(z, blk["prj"]["w"], blk["prj"]["b"], apply_act=False)
        acts[f"block{i:02d}_prj"] = out
        if stride == 1 and cin == cout:
            out = (out + y).astype(np.float32)
            acts[f"block{i:02d}_out"] = out
        y = out
    y = pw(y, params["conv_last"]["w"], params["conv_last"]["b"], relu6=True)
    acts["conv_last"] = y
    pooled = avgpool(y)
    acts["pool"] = pooled
    logits = fc(pooled, params["fc"]["w"], params["fc"]["b"])
    acts["logits"] = logits
    return logits, acts
