#!/usr/bin/env python
"""End-to-end check that the system runs on an NVIDIA GPU, in one process.

    python chip_smoke.py             # one card: the phases below
    python chip_smoke.py --cards 4   # four cards: DP serving, GSPMD
                                     # channel-TP and GPipe, each against
                                     # its one-card result, and nothing else

One card:
  1. device      JAX's devices and the card's name and power limit
  2. v1_bf16     MobileNet-V1 1.0-224 bf16 through InferencePipeline: the
                 batch-256 and batch-1 entries compiled, their memory
                 analysis, bf16 logits vs a float32 reference on the card
  3. v1_layers   float32 per-layer gate against the NumPy oracle
  4. serving     MicroBatchServer (device_retries=0) answering 16 streams
  5. v1_int8     the int8 pipeline, bit-exact per layer against its oracle
  6. families    V2, V3-Large, V3-Small: bf16 vs float32, int8 bit-exact
  7. kernel      the fused block kernel at every V1 block shape it serves,
                 against the NumPy oracle in bf16 and float32

Weights are random, made from a seed; images are seeded uint8 tensors. Any
failed check exits non-zero. The last line of standard output is one JSON
object naming the device. With no GPU the script exits non-zero before any
result is printed.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402


class CheckFailed(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def card_line() -> str:
    """nvidia-smi's name and power limit (a child process, never JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def _images(n: int, res: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, 256, (n, res, res, 3), dtype=np.uint8)


def _to_x(images_u8: np.ndarray) -> np.ndarray:
    """The repo's preprocessing at model resolution, on the host."""
    from mobilenet_tpu.oracle import numpy_ref

    return np.stack([numpy_ref.preprocess_ref(im) for im in images_u8])


# -- phases -----------------------------------------------------------------


def phase_device(require_gpu: bool = True):
    import jax

    from mobilenet_tpu import platform

    devs = jax.devices()
    log("device", f"devices={devs} kind={devs[0].device_kind} "
                  f"count={len(devs)}")
    if require_gpu and platform.accelerator() != "gpu":
        raise CheckFailed(f"no GPU: JAX backend is {jax.default_backend()!r}")
    if require_gpu:
        log("device", f"card: {card_line()}")
    return devs[0].platform, devs[0].device_kind, len(devs)


def _memory(compiled) -> str:
    m = compiled.memory_analysis()
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "generated_code_size_in_bytes")
    return " ".join(f"{f.split('_size')[0]}={getattr(m, f, None)}"
                    for f in fields)


def _bf16_vs_f32(name, family, fwd, folded, x, cfg):
    """bf16 logits vs the float32 reference on the same device; returns
    (max_abs, rel, top1_agree)."""
    import jax
    import jax.numpy as jnp

    from mobilenet_tpu.checkpoints import to_device
    from mobilenet_tpu.utils import golden

    p16 = to_device(folded, dtype=jnp.bfloat16)
    p32 = to_device(folded, dtype=jnp.float32)
    lg16 = np.asarray(jax.jit(lambda p, v: fwd(p, v, cfg))(
        p16, jnp.asarray(x, jnp.bfloat16)), np.float32)
    with jax.default_matmul_precision("highest"):
        lg32 = np.asarray(jax.jit(lambda p, v: fwd(p, v, cfg))(
            p32, jnp.asarray(x, jnp.float32)), np.float32)
    check(bool(np.isfinite(lg16).all()), f"{name}: non-finite bf16 logits")
    diff = float(np.abs(lg16 - lg32).max())
    scale = float(np.abs(lg32).max())
    rel = golden.BF16_LOGITS_REL[family]
    tol = rel * scale
    agree = int((lg16.argmax(-1) == lg32.argmax(-1)).sum())
    srt = np.sort(lg32, axis=-1)
    margin = srt[:, -1] - srt[:, -2]
    flips = lg16.argmax(-1) != lg32.argmax(-1)
    hard = int((flips & (margin > tol)).sum())
    log(name, f"bf16 vs f32 logits: max_abs={diff:.5f} "
              f"({diff / max(scale, 1e-9):.5f} of max|logit| {scale:.4f}), "
              f"tolerance {rel} x max|logit| = {tol:.5f}; "
              f"top-1 agree {agree}/{len(x)}, flips beyond a near-tie "
              f"margin of {tol:.5f}: {hard}")
    check(diff <= tol, f"{name}: bf16 logits off by {diff} > {tol}")
    check(hard == 0, f"{name}: {hard} top-1 flips that are not near-ties")
    return diff, diff / max(scale, 1e-9), agree


def phase_v1_bf16(alpha=1.0, res=224, batch=256, n_cmp=8, seed=0):
    import jax

    from mobilenet_tpu import ModelConfig
    from mobilenet_tpu.checkpoints import default_folded
    from mobilenet_tpu.models import mobilenet_v1
    from mobilenet_tpu.runtime.pipeline import InferencePipeline

    cfg = ModelConfig(alpha=alpha, resolution=res, compute_dtype="bfloat16")
    pipe = InferencePipeline(cfg, seed=seed)
    entry = pipe._entry("probs_u8")
    for b in (batch, 1):
        t0 = time.perf_counter()
        compiled = entry.lower(pipe.params, jax.ShapeDtypeStruct(
            (b, res, res, 3), np.uint8)).compile()
        log("v1_bf16", f"batch {b}: compiled in {time.perf_counter() - t0:.1f}"
                       f" s; memory {_memory(compiled)}")
    probs = pipe.run_batch(_images(batch, res, seed + 1))
    check(probs.shape == (batch, cfg.num_classes), f"probs shape {probs.shape}")
    check(bool(np.isfinite(probs).all()), "non-finite batch probs")
    check(bool(np.allclose(probs.sum(-1), 1.0, atol=1e-3)),
          "batch probs do not sum to 1")
    top = pipe.classify(_images(1, res, seed + 2)[0], top_k=5)
    check(len(top) == 5 and all(np.isfinite(p) for _, p in top),
          f"classify returned {top}")
    log("v1_bf16", f"run_batch({batch}) finite, rows sum to 1; "
                   f"classify top-1 {top[0]}")
    x = _to_x(_images(n_cmp, res, seed + 3))
    _bf16_vs_f32("v1_bf16", "v1", mobilenet_v1.forward,
                 default_folded(cfg, seed=seed), x, cfg)
    return pipe


def phase_v1_layers(alpha=1.0, res=224, n=2, seed=0):
    from mobilenet_tpu import ModelConfig
    from mobilenet_tpu.checkpoints import default_folded
    from mobilenet_tpu.oracle import numpy_ref
    from mobilenet_tpu.runtime.pipeline import InferencePipeline
    from mobilenet_tpu.utils import golden

    cfg = ModelConfig(alpha=alpha, resolution=res)
    folded = default_folded(cfg, seed=seed)
    x = np.random.default_rng(seed + 4).uniform(
        -1, 1, (n, res, res, 3)).astype(np.float32)
    _, acts = InferencePipeline(cfg, params=folded,
                                dtype=np.float32).activations(x)
    _, ref = numpy_ref.forward_all(folded, x, cfg)
    reports = golden.compare_activations(acts, ref)
    worst = max(reports, key=lambda r: r.max_abs)
    bad = golden.first_divergence(reports)
    log("v1_layers", f"{len(reports)} layers vs NumPy oracle, tolerances "
                     f"dw {golden.DW_TOL} mm {golden.MM_TOL}; worst max_abs "
                     f"{worst.max_abs:.3e} at {worst.name}")
    check(bad is None, f"float32 layer {bad and bad.name} diverges: {bad}")


def phase_serving(pipe, streams=16, per_stream=4, max_batch=16, seed=0):
    from mobilenet_tpu.runtime.serving import MicroBatchServer

    res = pipe.config.resolution
    images = _images(streams * per_stream, res, seed + 5)

    async def run():
        server = MicroBatchServer(pipe, max_batch=max_batch,
                                  device_retries=0)
        await server.start()

        async def stream(s):
            return [await server.submit(images[s * per_stream + j], top_k=2)
                    for j in range(per_stream)]

        try:
            answers = await asyncio.gather(*[stream(s)
                                             for s in range(streams)])
        finally:
            await server.close()
        return [a for per in answers for a in per], server.stats_dict()

    answers, stats = asyncio.run(run())
    ref = pipe.run_batch(images)
    ref_top = ref.argmax(-1)
    srt = np.sort(ref, axis=-1)
    margin = srt[:, -1] - srt[:, -2]
    got_top = np.array([a[0][0] for a in answers])
    flips = got_top != ref_top
    # a flip between two bucket sizes is rounding only when the reference's
    # top two probabilities are within bf16 rounding of each other
    hard = int((flips & (margin > 1e-2 * srt[:, -1])).sum())
    log("serving", f"{len(answers)} answers from {streams} streams; "
                   f"requests={stats['requests']} errors={stats['errors']} "
                   f"retries={stats['retries']} buckets={stats['bucket_counts']}"
                   f"; top-1 == run_batch for {int((~flips).sum())}/"
                   f"{len(answers)}, near-tie flips {int(flips.sum()) - hard}")
    check(stats["errors"] == 0 and stats["retries"] == 0,
          f"serving errors/retries: {stats}")
    check(len(answers) == streams * per_stream == stats["requests"],
          "not every request was answered")
    check(hard == 0, f"{hard} served answers disagree with run_batch")


def _exact_layers(name, ref, got):
    bad = [k for k, r in ref.items()
           if (r.dtype == np.int8 and not np.array_equal(np.asarray(got[k]), r))
           or (r.dtype != np.int8
               and float(np.abs(np.asarray(got[k]) - r).max()) > 1e-5)]
    log(name, f"{len(ref)} layers vs int8 oracle: "
              f"{'all bit-exact' if not bad else f'MISMATCH at {bad[:4]}'} "
              f"(float logits within 1e-5)")
    check(not bad, f"{name}: {len(bad)} int8 layers differ from the oracle, "
                   f"first {bad[0] if bad else None}")


def phase_v1_int8(alpha=1.0, res=224, n=4, seed=0):
    import jax
    import jax.numpy as jnp

    from mobilenet_tpu import ModelConfig
    from mobilenet_tpu.checkpoints import default_folded
    from mobilenet_tpu.quant import model as qmodel
    from mobilenet_tpu.quant import oracle as qoracle
    from mobilenet_tpu.quant import quantize, quantize_input

    cfg = ModelConfig(alpha=alpha, resolution=res)
    q = quantize(default_folded(cfg, seed=seed), cfg)
    x_i8 = quantize_input(_to_x(_images(n, res, seed + 6)))
    _, ref = qoracle.forward_all(q, x_i8, cfg)
    dev = qmodel._as_device_tree(q)
    _, got = jax.jit(lambda v: qmodel.forward_i8(dev, v, cfg, collect=True))(
        jnp.asarray(x_i8))
    _exact_layers("v1_int8", ref, got)


def phase_families(res=224, alpha_v2=1.0, alpha_v3=1.0, n_bf16=8, n_int8=2,
                   seed=0, n_calib=32):
    import jax
    import jax.numpy as jnp

    from mobilenet_tpu.checkpoints import default_folded
    from mobilenet_tpu.models import mobilenet_v2 as mv2
    from mobilenet_tpu.models import mobilenet_v3 as mv3
    from mobilenet_tpu.quant import quantize_input
    from mobilenet_tpu.quant import v2 as qv2
    from mobilenet_tpu.quant import v3 as qv3
    from mobilenet_tpu.runtime.pipeline import InferencePipeline

    fams = [
        ("v2", mv2.V2Config(alpha=alpha_v2, resolution=res,
                            compute_dtype="bfloat16"), mv2.forward_v2),
        ("v3_large", mv3.V3Config(variant="large", alpha=alpha_v3,
                                  resolution=res, compute_dtype="bfloat16"),
         mv3.forward_v3),
        ("v3_small", mv3.V3Config(variant="small", alpha=alpha_v3,
                                  resolution=res, compute_dtype="bfloat16"),
         mv3.forward_v3),
    ]
    for name, cfg, fwd in fams:
        folded = default_folded(cfg, seed=seed)
        pipe = InferencePipeline(cfg, params=folded)
        probs = pipe.run_batch(_images(n_bf16, res, seed + 7))
        check(probs.shape == (n_bf16, cfg.num_classes)
              and bool(np.isfinite(probs).all()), f"{name}: bad probs")
        x = _to_x(_images(n_bf16, res, seed + 8))
        _bf16_vs_f32(name, name[:2], fwd, folded, x, cfg)
        x_i8 = quantize_input(x[:n_int8])
        if name == "v2":
            q = qv2.quantize_v2(folded, cfg, n_calib=n_calib)
            _, ref = qv2.forward_all_v2_i8(q, x_i8, cfg)
            dev = qv2._as_device_tree_v2(q)
            run = lambda v: qv2.forward_v2_i8(dev, v, cfg, collect=True)  # noqa: E731
        else:
            q = qv3.quantize_v3(folded, cfg, n_calib=n_calib)
            _, ref = qv3.forward_all_v3_i8(q, x_i8, cfg)
            dev = qv3._as_device_tree_v3(q)
            run = lambda v: qv3.forward_v3_i8(dev, v, cfg, collect=True)  # noqa: E731
        _, got = jax.jit(run)(jnp.asarray(x_i8))
        _exact_layers(f"{name}_int8", ref, got)


def kernel_shapes(alpha=1.0, res=224):
    """(h, w, cin, cout, stride) of every V1 block the kernel serves."""
    import jax.numpy as jnp

    from mobilenet_tpu import ModelConfig, platform

    cfg = ModelConfig(alpha=alpha, resolution=res)
    hw, cin, out = res // 2, cfg.stem_channels, []
    for stride, cout in zip(cfg.block_strides, cfg.block_channels):
        if platform.block_kernel_serves(hw, jnp.bfloat16):
            out.append((hw, hw, cin, cout, stride))
        hw, cin = -(-hw // stride), cout
    return out


def phase_kernel(shapes, n=2, seed=0, interpret=False):
    import jax.numpy as jnp

    from mobilenet_tpu.ops.block_triton import separable_block
    from mobilenet_tpu.oracle import numpy_ref
    from mobilenet_tpu.utils import golden

    check(bool(shapes), "the kernel serves no V1 block shape")
    rng = np.random.default_rng(seed + 9)
    for h, w, cin, cout, stride in shapes:
        x = rng.uniform(0, 6, (n, h, w, cin)).astype(np.float32)
        dw = (rng.normal(size=(3, 3, 1, cin)) * 0.3).astype(np.float32)
        db = (rng.normal(size=cin) * 0.1).astype(np.float32)
        pw = (rng.normal(size=(cin, cout)) / np.sqrt(cin)).astype(np.float32)
        pb = (rng.normal(size=cout) * 0.1).astype(np.float32)
        for dt, tol in ((jnp.bfloat16, golden.KERNEL_BF16_TOL),
                        (jnp.float32, golden.KERNEL_F32_TOL)):
            args = [jnp.asarray(a, dt) for a in (x, dw, db, pw, pb)]
            ref_in = [np.asarray(a, np.float32) for a in args]
            ref = numpy_ref.pointwise_ref(
                numpy_ref.depthwise_ref(ref_in[0], ref_in[1], stride,
                                        bias=ref_in[2], relu6=True),
                ref_in[3], bias=ref_in[4], relu6=True)
            got = np.asarray(separable_block(*args, stride, True,
                                             interpret=interpret), np.float32)
            rep = golden.compare_activations({"k": got}, {"k": ref},
                                             tols={"k": tol})[0]
            log("kernel", f"{h}x{w}x{cin}->{cout} s{stride} "
                          f"{jnp.dtype(dt).name}: max_abs={rep.max_abs:.3e} "
                          f"tolerance atol={tol[0]} rtol={tol[1]}")
            check(rep.ok, f"kernel {h}x{w}x{cin}->{cout} s{stride} "
                          f"{jnp.dtype(dt).name}: {rep}")


# -- four cards -------------------------------------------------------------


def phase_dp(n_dev=4, alpha=1.0, res=224, batch=256, seed=0):
    """Data-parallel serving: the pipeline over a (n_dev, 1) mesh, and
    `cli serve --dp`'s server over it, against one card."""
    from mobilenet_tpu import ModelConfig
    from mobilenet_tpu.parallel.mesh import make_mesh
    from mobilenet_tpu.runtime.pipeline import InferencePipeline

    cfg = ModelConfig(alpha=alpha, resolution=res, compute_dtype="bfloat16")
    one = InferencePipeline(cfg, seed=seed)
    dp = InferencePipeline(cfg, seed=seed, mesh=make_mesh(n_dev, 1))
    images = _images(batch, res, seed + 10)
    p1, pd = one.run_batch(images), dp.run_batch(images)
    diff = float(np.abs(p1 - pd).max())
    agree = int((p1.argmax(-1) == pd.argmax(-1)).sum())
    log("dp", f"{n_dev}-device DP vs one device, batch {batch} bf16: "
              f"max |probs diff| {diff:.3e}, top-1 agree {agree}/{batch}")
    check(diff <= 1e-2, f"DP probs differ by {diff}")
    srt = np.sort(p1, axis=-1)
    near = (srt[:, -1] - srt[:, -2]) <= 1e-2 * srt[:, -1]
    check(bool(((p1.argmax(-1) == pd.argmax(-1)) | near).all()),
          "DP top-1 differs beyond near-ties")
    phase_serving(dp, streams=4 * n_dev, per_stream=4, max_batch=4 * n_dev,
                  seed=seed)


def phase_tp(n_dev=4, alpha=1.0, res=224, batch=8, seed=0):
    """Channel tensor parallelism through GSPMD (parallel.mesh.shard_params)
    in float32, against one card."""
    import jax
    import jax.numpy as jnp

    from mobilenet_tpu import ModelConfig
    from mobilenet_tpu.checkpoints import default_folded, to_device
    from mobilenet_tpu.models import mobilenet_v1
    from mobilenet_tpu.parallel import mesh as pmesh
    from mobilenet_tpu.utils import golden

    cfg = ModelConfig(alpha=alpha, resolution=res)
    folded = default_folded(cfg, seed=seed)
    x = jnp.asarray(_to_x(_images(batch, res, seed + 11)))
    fwd = jax.jit(lambda p, v: mobilenet_v1.forward(p, v, cfg))
    ref = np.asarray(fwd(to_device(folded), x))
    mesh = pmesh.make_mesh(n_dev, model_parallel=n_dev)
    got = np.asarray(fwd(pmesh.shard_params(folded, mesh),
                         jax.device_put(x, pmesh.batch_sharding(mesh))))
    rep = golden.compare_activations({"logits": got}, {"logits": ref})[0]
    log("tp", f"{n_dev}-way channel TP vs one device, float32 logits: "
              f"max_abs={rep.max_abs:.3e} (tolerance {golden.MM_TOL})")
    check(rep.ok, f"TP logits: {rep}")


def phase_pp(n_dev=4, alpha=1.0, res=224, batch=8, seed=0):
    """GPipe over n_dev stages: forward and one SGD step, against one card."""
    import jax
    import jax.numpy as jnp

    from mobilenet_tpu import ModelConfig
    from mobilenet_tpu.checkpoints import default_folded, to_device
    from mobilenet_tpu.models import mobilenet_v1
    from mobilenet_tpu.models.train import sgd_train_step
    from mobilenet_tpu.parallel import pp
    from mobilenet_tpu.utils import golden

    cfg = ModelConfig(alpha=alpha, resolution=res)
    params = to_device(default_folded(cfg, seed=seed))
    x = jnp.asarray(_to_x(_images(batch, res, seed + 12)))
    y = jnp.asarray(np.random.default_rng(seed).integers(
        0, cfg.num_classes, (batch,)), jnp.int32)
    mesh = pp.make_pipe_mesh(n_dev)
    lg_pp = np.asarray(pp.forward_pp(params, x, cfg, mesh))
    lg_1 = np.asarray(jax.jit(
        lambda p, v: mobilenet_v1.forward(p, v, cfg))(params, x))
    rep = golden.compare_activations({"logits": lg_pp}, {"logits": lg_1})[0]
    new_pp, loss_pp = jax.jit(
        lambda p, v, t: pp.pp_train_step(p, v, t, cfg, mesh))(params, x, y)
    new_1, loss_1 = jax.jit(
        lambda p, v, t: sgd_train_step(p, v, t, cfg, lr=1e-3))(params, x, y)
    w_diff = max(float(jnp.abs(a - b).max()) for a, b in zip(
        jax.tree.leaves(new_pp), jax.tree.leaves(new_1)))
    d_loss = abs(float(loss_pp) - float(loss_1))
    log("pp", f"{n_dev}-stage GPipe vs one device: logits max_abs="
              f"{rep.max_abs:.3e} (tolerance {golden.MM_TOL}); SGD step: "
              f"|loss diff|={d_loss:.3e}, max |weight diff|={w_diff:.3e}")
    check(rep.ok, f"PP logits: {rep}")
    check(d_loss <= 1e-4 and w_diff <= 1e-5,
          f"PP SGD step differs: loss {d_loss}, weights {w_diff}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1,
                    help="4: only the multi-card paths, on four cards")
    args = ap.parse_args(argv)

    import jax

    from mobilenet_tpu import platform

    t0 = time.perf_counter()
    try:
        plat, kind, count = phase_device()
        platform.enable_compile_cache()
        if args.cards == 4:
            check(count >= 4, f"--cards 4 needs four devices, found {count}")
            phase_dp()
            phase_tp()
            phase_pp()
            count = 4
        else:
            pipe = phase_v1_bf16()
            phase_v1_layers()
            phase_serving(pipe)
            phase_v1_int8()
            phase_families()
            phase_kernel(kernel_shapes())
    except CheckFailed as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    log("done", f"all phases passed in {time.perf_counter() - t0:.1f} s "
                f"(JAX {jax.__version__})")
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": plat, "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
