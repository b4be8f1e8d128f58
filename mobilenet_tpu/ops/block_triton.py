"""Fused depthwise 3x3 + pointwise 1x1 block for Hopper (Pallas on Triton).

XLA runs a separable block as two programs: a grouped convolution that
writes the depthwise output to device memory, and a GEMM that reads it back.
This kernel keeps the depthwise tile in registers and feeds it straight to
the tensor cores, so that round trip through memory goes away.

Each program owns BM output pixels (flattened over batch and space) and BN
output channels, and walks the input channels in chunks of BK:

  - nine masked gathers load each pixel's 3x3 neighbourhood for the chunk
    (the masks are the zero padding of TF 'SAME');
  - the depthwise sum accumulates in float32, then bias and ReLU(6);
  - the tile, cast to the weight dtype, multiplies the BK x BN slice of the
    pointwise weight with `pl.dot` into a float32 accumulator.

Programs share nothing and run in any order. Block sizes are powers of two;
masks cover channel counts and pixel counts that are not.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu


def _pow2_at_least(n: int, lo: int) -> int:
    p = lo
    while p < n:
        p *= 2
    return p


def block_tiles(cin: int, cout: int, n_pixels: int):
    """(BM, BK, BN): `pl.dot` needs every dimension >= 16. BM drops to 32
    when 64-pixel blocks would leave some of the H100's 132 SMs idle."""
    bk = min(64, _pow2_at_least(cin, 16))
    bn = min(128, _pow2_at_least(cout, 16))
    bm = 64 if n_pixels >= 64 * 132 else 32
    return bm, bk, bn


def _same_pad_lo(size: int, stride: int) -> int:
    out = -(-size // stride)
    total = max((out - 1) * stride + 3 - size, 0)
    return total // 2


def _act(y, relu6):
    y = jnp.maximum(y, 0.0)
    return jnp.minimum(y, 6.0) if relu6 else y


def _kernel(x_ref, dww_ref, dwb_ref, pww_ref, pwb_ref, o_ref, *,
            h, w, h_out, w_out, n_pix, cin, cout, stride, relu6,
            bm, bk, bn):
    pid_m = pl.program_id(0)
    pid_n = pl.program_id(1)
    pix = pid_m * bm + jnp.arange(bm)
    pix_ok = pix < n_pix
    img = pix // (h_out * w_out)
    rem = pix % (h_out * w_out)
    ho = rem // w_out
    wo = rem % w_out
    top = _same_pad_lo(h, stride)
    left = _same_pad_lo(w, stride)

    # Row of each tap in the (N*H*W, Cin) input; masked taps read row 0.
    taps = []
    for dy in range(3):
        hi = ho * stride + dy - top
        for dx in range(3):
            wi = wo * stride + dx - left
            ok = pix_ok & (hi >= 0) & (hi < h) & (wi >= 0) & (wi < w)
            taps.append((jnp.where(ok, (img * h + hi) * w + wi, 0), ok))

    cols = pid_n * bn + jnp.arange(bn)
    col_ok = cols < cout
    f32 = jnp.float32
    prec = lax.Precision.HIGHEST if pww_ref.dtype == f32 else None

    def chunk(kc, acc):
        kk = kc * bk + jnp.arange(bk)
        k_ok = kk < cin
        dw = jnp.zeros((bm, bk), f32)
        for t, (row, ok) in enumerate(taps):
            xv = plgpu.load(x_ref.at[row[:, None], kk[None, :]],
                            mask=ok[:, None] & k_ok[None, :], other=0)
            wv = plgpu.load(dww_ref.at[t, kk], mask=k_ok, other=0)
            dw += xv.astype(f32) * wv.astype(f32)[None, :]
        b = plgpu.load(dwb_ref.at[kk], mask=k_ok, other=0)
        a = _act(dw + b.astype(f32)[None, :], relu6).astype(pww_ref.dtype)
        wp = plgpu.load(pww_ref.at[kk[:, None], cols[None, :]],
                        mask=k_ok[:, None] & col_ok[None, :], other=0)
        return acc + pl.dot(a, wp, precision=prec)

    acc = lax.fori_loop(0, -(-cin // bk), chunk, jnp.zeros((bm, bn), f32))
    b = plgpu.load(pwb_ref.at[cols], mask=col_ok, other=0)
    out = _act(acc + b.astype(f32)[None, :], relu6)
    plgpu.store(o_ref.at[pl.ds(pid_m * bm, bm), pl.ds(pid_n * bn, bn)],
                out.astype(o_ref.dtype),
                mask=pix_ok[:, None] & col_ok[None, :])


@functools.partial(jax.jit, static_argnames=("stride", "relu6", "interpret"))
def separable_block(x, dw_w, dw_b, pw_w, pw_b, stride: int,
                    relu6: bool = True, interpret: bool = False):
    """dw3x3(+bias, ReLU(6)) -> pw1x1(+bias, ReLU(6)), TF 'SAME' padding.

    x: (N, H, W, Cin); dw_w: (3, 3, 1, Cin); dw_b: (Cin,);
    pw_w: (Cin, Cout); pw_b: (Cout,). Returns (N, Ho, Wo, Cout) in x.dtype.
    `interpret` runs the kernel in the Pallas interpreter (tests only).
    """
    n, h, w, cin = x.shape
    cout = pw_w.shape[1]
    h_out, w_out = -(-h // stride), -(-w // stride)
    n_pix = n * h_out * w_out
    bm, bk, bn = block_tiles(cin, cout, n_pix)
    # Every block-sized window stays inside its array: channels and pixels
    # round up to whole blocks, and the extra rows and columns are cut off.
    cin_p = -(-cin // bk) * bk
    cout_p = -(-cout // bn) * bn
    pix_p = -(-n_pix // bm) * bm
    dt = x.dtype
    xs = x.reshape(n * h * w, cin)
    dww = dw_w.reshape(9, cin).astype(dt)
    dwb, pww, pwb = dw_b.astype(dt), pw_w.astype(dt), pw_b.astype(dt)
    if cin_p != cin:
        xs = jnp.pad(xs, ((0, 0), (0, cin_p - cin)))
        dww = jnp.pad(dww, ((0, 0), (0, cin_p - cin)))
        dwb = jnp.pad(dwb, (0, cin_p - cin))
        pww = jnp.pad(pww, ((0, cin_p - cin), (0, 0)))
    if cout_p != cout:
        pww = jnp.pad(pww, ((0, 0), (0, cout_p - cout)))
        pwb = jnp.pad(pwb, (0, cout_p - cout))
    kernel = functools.partial(
        _kernel, h=h, w=w, h_out=h_out, w_out=w_out, n_pix=n_pix, cin=cin,
        cout=cout, stride=stride, relu6=relu6, bm=bm, bk=bk, bn=bn)
    out = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((pix_p, cout_p), dt),
        grid=(pix_p // bm, cout_p // bn),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=2),
        interpret=interpret,
        name="separable_block",
    )(xs, dww, dwb, pww, pwb)
    return out[:n_pix, :cout].reshape(n, h_out, w_out, cout)
