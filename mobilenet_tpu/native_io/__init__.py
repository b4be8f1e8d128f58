"""Native C++ image decode (reference C10 analog — host-side C/C++ image
preprocessing, SURVEY.md §2). Self-compiles decode.cpp against the system
libjpeg/libpng via ctypes on first use, mirroring cpu_ref's build pattern.

`decode_image(path)` returns an (H, W, 3) uint8 RGB array. Resize +
normalize + layout stay on device (ops/preprocess.py). If the native build
is unavailable (no g++ or headers), `available()` is False and callers fall
back to PIL (ops.preprocess.decode_image_host does this automatically).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "decode.cpp")
_LIB = os.path.join(_DIR, "libnativeio.so")
_lib: Optional[ctypes.CDLL] = None
_build_failed = False

_ERRORS = {
    1: "cannot open file or unrecognized format (not JPEG/PNG)",
    2: "corrupt image data",
    3: "out of memory",
    4: "unexpected decoded layout",
}


def build(force: bool = False) -> str:
    """Compile decode.cpp -> libnativeio.so (cached by mtime)."""
    if (
        not force
        and os.path.exists(_LIB)
        and os.path.getmtime(_LIB) >= os.path.getmtime(_SRC)
    ):
        return _LIB
    cmd = [
        "g++", "-O2", "-shared", "-fPIC", "-std=c++17", "-pthread",
        _SRC, "-o", _LIB, "-ljpeg", "-lpng",
    ]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError:
        raise RuntimeError("native_io build failed: g++ not found") from None
    if proc.returncode != 0:
        raise RuntimeError(
            f"native_io build failed ({' '.join(cmd)}):\n{proc.stderr}")
    return _LIB


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(build())
    lib.mnv1_decode_image.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_ubyte)),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.mnv1_decode_image.restype = ctypes.c_int
    lib.mnv1_free.argtypes = [ctypes.POINTER(ctypes.c_ubyte)]
    lib.mnv1_decode_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_ubyte)),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.mnv1_decode_batch.restype = ctypes.c_int
    _lib = lib
    return lib


def available() -> bool:
    """True when the native decoder builds/loads on this machine."""
    global _build_failed
    if _build_failed:
        return False
    try:
        _load()
        return True
    except Exception:
        _build_failed = True
        return False


def decode_image(path: str) -> np.ndarray:
    """Decode a JPEG/PNG file to an (H, W, 3) uint8 RGB array (native)."""
    lib = _load()
    out = ctypes.POINTER(ctypes.c_ubyte)()
    h = ctypes.c_int()
    w = ctypes.c_int()
    rc = lib.mnv1_decode_image(os.fspath(path).encode(), ctypes.byref(out),
                               ctypes.byref(h), ctypes.byref(w))
    if rc != 0:
        raise ValueError(
            f"native decode failed for {path!r}: {_ERRORS.get(rc, rc)}")
    try:
        n = h.value * w.value * 3
        arr = np.ctypeslib.as_array(out, shape=(n,)).copy()
    finally:
        lib.mnv1_free(out)
    return arr.reshape(h.value, w.value, 3)


def decode_batch(paths, threads: int = 0, strict: bool = True):
    """Decode many JPEG/PNG files concurrently on a native thread pool.

    The host-side staging analog of the reference's multi-image ingest
    (SURVEY.md §2 C10/C12): decode throughput is what feeds the 64-stream
    serving path and directory eval, and a Python-level loop serializes on
    the GIL around every libjpeg call — the pool in decode.cpp does not.

    Returns a list of (H, W, 3) uint8 arrays aligned with `paths`. With
    strict=True (default) any failure raises with per-file detail; with
    strict=False failed entries are returned as None.
    """
    lib = _load()
    n = len(paths)
    if n == 0:
        return []
    enc = [os.fspath(p).encode() for p in paths]
    c_paths = (ctypes.c_char_p * n)(*enc)
    outs = (ctypes.POINTER(ctypes.c_ubyte) * n)()
    hs = (ctypes.c_int * n)()
    ws = (ctypes.c_int * n)()
    rcs = (ctypes.c_int * n)()
    failures = lib.mnv1_decode_batch(
        c_paths, n, threads, outs, hs, ws, rcs)
    images = []
    errors = []
    try:
        for i in range(n):
            if rcs[i] != 0:
                images.append(None)
                errors.append(
                    f"{paths[i]!r}: {_ERRORS.get(rcs[i], rcs[i])}")
                continue
            size = hs[i] * ws[i] * 3
            images.append(
                np.ctypeslib.as_array(outs[i], shape=(size,))
                .copy().reshape(hs[i], ws[i], 3))
    finally:
        for i in range(n):
            if outs[i]:
                lib.mnv1_free(outs[i])
    assert len(errors) == failures, (errors, failures)
    if strict and errors:
        raise ValueError(
            f"native batch decode: {len(errors)}/{n} failed: "
            + "; ".join(errors[:5]))
    return images
