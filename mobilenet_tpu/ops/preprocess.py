"""On-device image preprocessing, fused into the jitted graph.

Reference analog: C10 (SURVEY.md SS2) — host-side decode/resize/normalize. The
rebuild keeps JPEG *decode* on host (no device decode op — SURVEY.md SS7) and
moves resize + mean/scale normalization + layout on device, inside the same XLA
program as the model ("Image preprocessing ... fuses into the same XLA graph",
BASELINE.json:5).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import PREPROCESS_OFFSET, PREPROCESS_SCALE


def normalize(images_u8: jax.Array, dtype=jnp.float32) -> jax.Array:
    """uint8 NHWC -> dtype in [-1, 1] (TF mode, mobilenet.py:418-422)."""
    x = images_u8.astype(jnp.float32) * PREPROCESS_SCALE + PREPROCESS_OFFSET
    return x.astype(dtype)


def resize_bilinear(images: jax.Array, resolution: int) -> jax.Array:
    """Resize NHWC to (resolution, resolution) on device."""
    n, h, w, c = images.shape
    if h == resolution and w == resolution:
        return images
    return jax.image.resize(
        images, (n, resolution, resolution, c), method="bilinear", antialias=False
    )


def preprocess(images_u8: jax.Array, resolution: int, dtype=jnp.float32) -> jax.Array:
    """Full on-device preprocessing: uint8 NHWC of any square-ish size ->
    normalized float NHWC at model resolution. Jit-safe (static shapes)."""
    x = images_u8.astype(jnp.float32)
    x = resize_bilinear(x, resolution)
    x = x * PREPROCESS_SCALE + PREPROCESS_OFFSET
    return x.astype(dtype)


def decode_image_host(path: str, backend: str = "auto"):
    """Host-side decode -> uint8 HWC RGB numpy array. The only host stage,
    mirroring SURVEY.md SS7 'decode on host'.

    backend: "native" = the C++ libjpeg/libpng decoder (native_io/ — the
    reference's C10 preprocessing was host C/C++), "pil" = PIL, "auto" =
    native when it builds on this machine, PIL otherwise."""
    import numpy as np  # noqa: PLC0415

    if backend not in ("auto", "native", "pil"):
        raise ValueError(f"unknown decode backend {backend!r}")
    if backend != "pil":
        from .. import native_io  # noqa: PLC0415

        if backend == "native":
            return native_io.decode_image(path)
        if native_io.available():
            try:
                return native_io.decode_image(path)
            except ValueError:
                pass  # format the native decoder doesn't handle (bmp/gif/
                #       webp/...) or corrupt data: let PIL try below
    from PIL import Image  # noqa: PLC0415

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), dtype=np.uint8)
