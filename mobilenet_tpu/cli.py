"""Command-line interface: classify / verify / bench / sweep / serve.

Reference analog: L5, the host main() taking image path + weight dir +
.awsxclbin path (SURVEY.md SS1). Here the "bitstream" is a jit cache entry, the
"weight dir" is an .npz checkpoint (or the seeded reference weight set), and
verify/bench/serve expose the reference's golden, throughput, and multi-stream
modes (SURVEY.md SS3.2/3.3).

Usage:
  python -m mobilenet_tpu.cli classify IMAGE [--alpha A --res R --ckpt F]
  python -m mobilenet_tpu.cli verify  [--alpha A --res R --int8]
  python -m mobilenet_tpu.cli bench   [--alpha A --res R --batch N --dtype D]
  python -m mobilenet_tpu.cli sweep   [--batch N]
  python -m mobilenet_tpu.cli serve   [--streams 64 --port 8000]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def _make_config(args, dtype=None):
    """ModelConfig (v1) / V2Config / V3Config per --model; same flag
    surface. --model v3 = V3-Large, v3small = V3-Small; --minimalistic
    selects the kernel-3/relu/no-SE V3 variants."""
    compute_dtype = args.dtype if dtype is None else dtype
    model = getattr(args, "model", "v1")
    if model == "v2":
        from .models.mobilenet_v2 import V2Config

        return V2Config(alpha=args.alpha, resolution=args.res,
                        compute_dtype=compute_dtype)
    if model in ("v3", "v3small"):
        from .models.mobilenet_v3 import V3Config

        return V3Config(variant="large" if model == "v3" else "small",
                        alpha=args.alpha, resolution=args.res,
                        minimalistic=getattr(args, "minimalistic", False),
                        compute_dtype=compute_dtype)
    from .config import ModelConfig

    return ModelConfig(alpha=args.alpha, resolution=args.res,
                       compute_dtype=compute_dtype)


def _build_pipeline(args, dtype=None):
    from .checkpoints import load_npz
    from .runtime.pipeline import InferencePipeline

    cfg = _make_config(args, dtype)
    params = load_npz(args.ckpt) if getattr(args, "ckpt", None) else None
    return InferencePipeline(cfg, params=params, seed=args.seed)


def cmd_classify(args):
    from .ops.preprocess import decode_image_host

    cfg = _make_config(args)
    # Host decode only; the raw uint8 image goes straight to the jitted
    # entry, which resizes + normalizes in float ON DEVICE (SURVEY.md SS3.4)
    # — one resize, no lossy uint8 round-trip.
    img = decode_image_host(args.image)
    if getattr(args, "int8", False):
        from .checkpoints import load_npz

        params = load_npz(args.ckpt) if getattr(args, "ckpt", None) else None
        model = getattr(args, "model", "v1")
        if model != "v1":
            import jax
            import jax.numpy as jnp

            from .checkpoints import default_folded

            if model == "v2":
                from .quant.v2 import (make_int8_infer_v2 as mk,
                                       quantize_v2 as qz)
            else:
                from .quant.v3 import (make_int8_infer_v3 as mk,
                                       quantize_v3 as qz)
            folded = params if params is not None else default_folded(
                cfg, seed=args.seed)
            infer, _ = mk(qz(folded, cfg), cfg)
            logits = infer(jnp.asarray(img[None]))
            probs = np.asarray(jax.nn.softmax(logits, axis=-1))[0]
        else:
            from .quant.model import Int8Pipeline

            qpipe = Int8Pipeline(cfg, seed=args.seed, params=params)
            probs = qpipe.run_batch(img[None])[0]
        idx = np.argsort(-probs)[: args.top_k]
        top = [(int(i), float(probs[i])) for i in idx]
    else:
        top = _build_pipeline(args).classify(img, top_k=args.top_k)
    for rank, (cls, prob) in enumerate(top, 1):
        print(f"top-{rank}: class {cls}  p={prob:.4f}")


def _verify_v2(args) -> bool:
    """Per-layer golden gate for the MobileNet-V2 family (V2_TOL — linear
    bottlenecks carry reassociation noise unclipped, utils/golden.py)."""
    from .checkpoints import load_npz
    from .checkpoints.v2 import fold_bn_v2, init_params_v2
    from .models.mobilenet_v2 import V2Config
    from .runtime.pipeline import InferencePipeline
    from .utils import golden

    cfg = V2Config(alpha=args.alpha, resolution=args.res)
    folded = (load_npz(args.ckpt) if getattr(args, "ckpt", None)
              else fold_bn_v2(init_params_v2(cfg, seed=args.seed),
                              eps=cfg.bn_eps))
    rng = np.random.default_rng(args.seed + 1)
    x = rng.uniform(
        -1, 1, (args.batch, cfg.resolution, cfg.resolution, 3)).astype(np.float32)
    if args.int8:
        from .quant.v2 import verify_int8_v2

        return verify_int8_v2(cfg, folded, x)
    pipe = InferencePipeline(cfg, params=folded, dtype=np.float32)
    _, acts = pipe.activations(x)
    if args.oracle == "cpp":
        from . import cpu_ref

        _, ref = cpu_ref.forward_all_v2(folded, x, cfg)
    else:
        from .oracle import numpy_ref

        _, ref = numpy_ref.forward_all_v2(folded, x, cfg)
    reports = golden.compare_activations(
        acts, ref, tols={n: golden.V2_TOL for n in ref})
    for r in reports:
        print(r)
    bad = golden.first_divergence(reports)
    if bad is None:
        print(f"VERIFY OK: all {len(reports)} layers match "
              f"({args.oracle} oracle, v2)")
        return True
    print(f"VERIFY FAILED at {bad.name}")
    return False


def _verify_v3(args) -> bool:
    """Per-layer golden gate for the MobileNet-V3 family (V3_TOL —
    unbounded relu/hard-swish activations, utils/golden.py)."""
    from .checkpoints import default_folded, load_npz
    from .runtime.pipeline import InferencePipeline
    from .utils import golden

    cfg = _make_config(args, dtype="float32")
    folded = (load_npz(args.ckpt) if getattr(args, "ckpt", None)
              else default_folded(cfg, seed=args.seed))
    rng = np.random.default_rng(args.seed + 1)
    x = rng.uniform(
        -1, 1, (args.batch, cfg.resolution, cfg.resolution, 3)).astype(
            np.float32)
    if args.int8:
        from .quant.v3 import verify_int8_v3

        return verify_int8_v3(cfg, folded, x)
    pipe = InferencePipeline(cfg, params=folded, dtype=np.float32)
    _, acts = pipe.activations(x)
    if args.oracle == "cpp":
        from . import cpu_ref

        _, ref = cpu_ref.forward_all_v3(folded, x, cfg)
    else:
        from .oracle import numpy_ref

        _, ref = numpy_ref.forward_all_v3(folded, x, cfg)
    reports = golden.compare_activations(
        acts, ref, tols={n: golden.V3_TOL for n in ref})
    for r in reports:
        print(r)
    bad = golden.first_divergence(reports)
    if bad is None:
        print(f"VERIFY OK: all {len(reports)} layers match "
              f"({args.oracle} oracle, {cfg.variant_name()})")
        return True
    print(f"VERIFY FAILED at {bad.name}")
    return False


def cmd_verify(args):
    """Per-layer golden verification (SURVEY.md SS3.6). Exit 1 on divergence."""
    model = getattr(args, "model", "v1")
    if model == "v2":
        sys.exit(0 if _verify_v2(args) else 1)
    if model in ("v3", "v3small"):
        sys.exit(0 if _verify_v3(args) else 1)
    from . import cpu_ref
    from .checkpoints import fold_bn, init_params
    from .config import ModelConfig
    from .oracle import numpy_ref
    from .utils import golden

    cfg = ModelConfig(alpha=args.alpha, resolution=args.res)
    if getattr(args, "ckpt", None):
        # Verify a trained/imported FOLDED checkpoint: the oracle runs on the
        # same weights (previously --ckpt was silently ignored).
        from .checkpoints import load_npz

        folded = load_npz(args.ckpt)
    else:
        folded = fold_bn(init_params(cfg, seed=args.seed), eps=cfg.bn_eps)
    rng = np.random.default_rng(args.seed + 1)
    x = rng.uniform(-1, 1, (args.batch, cfg.resolution, cfg.resolution, 3)).astype(
        np.float32
    )

    if args.int8:
        from .quant import verify as qverify

        ok = qverify.verify_int8(cfg, folded, x, oracle=args.oracle)
        sys.exit(0 if ok else 1)

    from .runtime.pipeline import InferencePipeline

    pipe = InferencePipeline(cfg, params=folded, dtype=np.float32)
    _, acts = pipe.activations(x)
    if args.oracle == "cpp":
        _, acts_ref = cpu_ref.forward_all(folded, x, cfg)
    else:
        _, acts_ref = numpy_ref.forward_all(folded, x, cfg)
    reports = golden.compare_activations(acts, acts_ref)
    for r in reports:
        print(r)
    bad = golden.first_divergence(reports)
    if bad is None:
        print(f"VERIFY OK: all {len(reports)} layers match ({args.oracle} oracle)")
        sys.exit(0)
    print(f"VERIFY FAILED at {bad.name}")
    sys.exit(1)


def cmd_eval(args):
    """End-to-end top-1 agreement vs the golden CPU oracle (the reference's
    accuracy acceptance check, BASELINE.json:5 / SURVEY.md §4). Exit 1 when
    agreement falls below --min-agreement."""
    from .runtime.eval import evaluate_agreement, load_dir_images, synth_images

    cfg = _make_config(args)
    if args.dir:
        images = load_dir_images(args.dir)
    else:
        images = synth_images(cfg, args.n, args.seed + 1,
                              structured=(args.synth == "structured"))
    params = None
    if getattr(args, "ckpt", None):
        from .checkpoints import load_npz

        params = load_npz(args.ckpt)
    # INT8 is bit-exact by contract (CLAUDE.md invariants): its logits equal
    # the oracle's exactly, so a top-1 flip is a real defect, never a float
    # rounding near-tie — force the strict gate regardless of --tie-margin.
    # Float defaults are (family, dtype)-calibrated: the bf16 top-1 flip
    # class is measured per family (golden.BF16_TIE_MARGIN — V3-Large-224
    # flips at rel margin 1.3% on chip, within its 4.2% bf16 logits class).
    if getattr(args, "int8", False):
        tie_margin = 0.0
    elif args.tie_margin is not None:
        tie_margin = args.tie_margin
    elif args.dtype == "bfloat16":
        from .utils import golden

        fam = {"v1": "v1", "v2": "v2", "v3": "v3", "v3small": "v3"}[
            getattr(args, "model", "v1")]
        tie_margin = golden.BF16_TIE_MARGIN[fam]
    else:
        tie_margin = 1e-3
    report = evaluate_agreement(
        cfg, images, params=params, seed=args.seed,
        int8=getattr(args, "int8", False), oracle=args.oracle,
        batch_size=args.batch, top_k=args.top_k, tie_margin=tie_margin,
    )
    # Gate on the UNROUNDED tie-aware agreement (== raw agreement when
    # --tie-margin 0); round only for display. Near-tie flips are rounding
    # artifacts of the float device path, not accuracy failures — the raw
    # number is still reported for the record.
    ok = report["top1_agreement_tie_aware"] >= args.min_agreement
    display = {k: (round(v, 4) if isinstance(v, float) else v)
               for k, v in report.items()}
    print(json.dumps(display))
    sys.exit(0 if ok else 1)


def _profile_ctx(args):
    """--profile DIR wraps the timed loop in a device trace (SURVEY.md SS5:
    the OpenCL-event-profiling analog); view with XProf/TensorBoard/Perfetto."""
    import contextlib

    profile_dir = getattr(args, "profile", None)
    if profile_dir:
        from .utils.profiling import trace as _trace

        return profile_dir, _trace(profile_dir)
    return None, contextlib.nullcontext()


def cmd_bench(args):
    if getattr(args, "int8", False):
        return _bench_int8(args)
    import jax

    pipe = _build_pipeline(args)
    profile_dir, ctx = _profile_ctx(args)
    with ctx:
        stats = pipe.benchmark(batch_size=args.batch, steps=args.steps)
    stats.update(
        variant=pipe.config.variant_name(),
        dtype=str(np.dtype(pipe.dtype).name),
        backend=jax.default_backend(),
        device_kind=jax.devices()[0].device_kind,
    )
    if profile_dir:
        stats["profile_dir"] = profile_dir
    print(json.dumps(stats))


def _bench_int8(args):
    """INT8 fixed-point throughput (the FPGA quantized-path analog,
    BASELINE.json:10): uint8 images -> quantize -> int8 network."""
    from .config import ModelConfig

    if getattr(args, "model", "v1") in ("v2", "v3", "v3small"):
        return _bench_int8_family(args)
    cfg = ModelConfig(alpha=args.alpha, resolution=args.res)
    profile_dir, ctx = _profile_ctx(args)  # --int8 mirrors every bench flag
    with ctx:
        stats = _int8_throughput(cfg, args.batch, args.steps, args.seed,
                                 ckpt=getattr(args, "ckpt", None))
    if profile_dir:
        stats["profile_dir"] = profile_dir
    print(json.dumps(stats))


def _bench_int8_family(args):
    """INT8 MobileNet-V2/V3 throughput (XLA int8 routes; quant/v2.py,
    quant/v3.py)."""
    import jax
    import jax.numpy as jnp

    from .checkpoints import load_npz

    cfg = _make_config(args, dtype="float32")
    ckpt = getattr(args, "ckpt", None)
    from .checkpoints import default_folded

    folded = load_npz(ckpt) if ckpt else default_folded(cfg, seed=args.seed)
    if getattr(args, "model", "v1") == "v2":
        from .quant.v2 import make_int8_infer_v2, quantize_v2

        infer, _ = make_int8_infer_v2(quantize_v2(folded, cfg), cfg)
    else:
        from .quant.v3 import make_int8_infer_v3, quantize_v3

        infer, _ = make_int8_infer_v3(quantize_v3(folded, cfg), cfg)
    rng = np.random.default_rng(0)
    img = jax.device_put(jnp.asarray(rng.integers(
        0, 256, (args.batch, cfg.resolution, cfg.resolution, 3),
        dtype=np.uint8)))
    dt = _time_steps(infer, img, args.steps)
    row = {
        "variant": cfg.variant_name(), "dtype": "int8",
        "images_per_sec": round(args.steps * args.batch / dt, 1),
        "batch_size": args.batch, "steps": args.steps,
        "backend": jax.default_backend(),
    }
    print(json.dumps(row))
    return row


def _time_steps(fn, x, steps: int, warmup: int = 3) -> float:
    """Seconds for `steps` calls of fn(x), after a compile call and
    `warmup` calls, ending in block_until_ready."""
    import time

    out = fn(x)
    out.block_until_ready()
    for _ in range(warmup):
        out = fn(x)
    out.block_until_ready()
    t0 = time.perf_counter()
    for _ in range(steps):
        out = fn(x)
    out.block_until_ready()
    return time.perf_counter() - t0


def _int8_throughput(cfg, batch, steps, seed, ckpt=None, latency=True):
    """int8 throughput (+ optional batch-1 p50) for one config.

    Built on Int8Pipeline so bench measures exactly what classify/serve
    --int8 run (one construction path for quantization)."""
    import time

    import jax
    import jax.numpy as jnp

    from .checkpoints import load_npz
    from .quant.model import Int8Pipeline

    pipe = Int8Pipeline(cfg, seed=seed,
                        params=load_npz(ckpt) if ckpt else None)
    infer = pipe._infer
    rng = np.random.default_rng(0)
    img = jax.device_put(jnp.asarray(rng.integers(
        0, 256, (batch, cfg.resolution, cfg.resolution, 3), dtype=np.uint8)))
    dt = _time_steps(infer, img, steps)
    stats = {
        "variant": cfg.variant_name(),
        "dtype": "int8",
        "images_per_sec": round(steps * batch / dt, 1),
        "batch_size": batch,
        "steps": steps,
    }
    if latency:
        lat = []
        one = img[:1]
        infer(one).block_until_ready()
        for _ in range(20):
            t = time.perf_counter()
            infer(one).block_until_ready()
            lat.append(time.perf_counter() - t)
        stats["p50_latency_ms"] = round(float(np.percentile(lat, 50) * 1e3), 3)
    return stats


def cmd_sweep(args):
    """The alpha x resolution grid of BASELINE.json:8 (filterable so long
    sweeps can run in chunks)."""
    from .config import ALPHAS, RESOLUTIONS, ModelConfig
    from .runtime.pipeline import InferencePipeline

    model = getattr(args, "model", "v1")
    is_v2 = model == "v2"
    if is_v2:
        from .models.mobilenet_v2 import V2_ALPHAS, V2Config

        default_alphas, make_cfg = V2_ALPHAS, (
            lambda a, r: V2Config(alpha=a, resolution=r,
                                  compute_dtype=args.dtype))
    elif model in ("v3", "v3small"):
        from .models.mobilenet_v3 import V3Config

        default_alphas = (0.75, 1.0)  # the keras pretrained V3 grid
        make_cfg = lambda a, r: V3Config(  # noqa: E731
            variant="large" if model == "v3" else "small",
            alpha=a, resolution=r,
            minimalistic=getattr(args, "minimalistic", False),
            compute_dtype=args.dtype)
    else:
        default_alphas = ALPHAS
        make_cfg = lambda a, r: ModelConfig(  # noqa: E731
            alpha=a, resolution=r, compute_dtype=args.dtype)
    alphas = ([float(a) for a in args.alphas.split(",")] if args.alphas
              else default_alphas)
    resolutions = ([int(r) for r in args.resolutions.split(",")]
                   if args.resolutions else RESOLUTIONS)
    results = []
    for alpha in alphas:
        for res in resolutions:
            cfg = make_cfg(alpha, res)
            if getattr(args, "int8", False):
                if model != "v1":
                    # _bench_int8_family prints its own row
                    row = _bench_int8_family(argparse.Namespace(
                        alpha=alpha, res=res, batch=args.batch,
                        steps=args.steps, seed=args.seed,
                        ckpt=getattr(args, "ckpt", None), model=model,
                        minimalistic=getattr(args, "minimalistic", False)))
                else:
                    row = _int8_throughput(cfg, args.batch, args.steps,
                                           args.seed,
                                           ckpt=getattr(args, "ckpt", None),
                                           latency=False)
                    print(json.dumps(row), flush=True)
                results.append(row)
                continue
            pipe = InferencePipeline(cfg, seed=args.seed)
            stats = pipe.benchmark(batch_size=args.batch, steps=args.steps)
            row = {
                "variant": cfg.variant_name(),
                "images_per_sec": round(stats["images_per_sec"], 1),
                "p50_latency_ms": round(stats["p50_latency_ms"], 3),
            }
            results.append(row)
            print(json.dumps(row), flush=True)
    return results


def cmd_train(args):
    """Training-loop driver on synthetic data (overfit smoke): exercises the
    jittable SGD-momentum step end-to-end. The reference stack is
    inference-only; training is an extension (models/train.py)."""
    import jax
    import jax.numpy as jnp

    from .checkpoints import default_folded, load_npz, save_npz, to_device
    from .models.train import make_optax_trainer

    # training runs in fp32 regardless of --dtype (gradient stability)
    cfg = _make_config(args, dtype="float32")
    folded = (load_npz(args.ckpt) if getattr(args, "ckpt", None)
              else default_folded(cfg, seed=args.seed))
    params = to_device(folded)
    if getattr(args, "qat", False):
        from .models.mobilenet_v2 import V2Config  # noqa: PLC0415
        from .models.mobilenet_v3 import V3Config  # noqa: PLC0415
        from .quant import qat  # noqa: PLC0415

        if isinstance(cfg, V2Config):
            init_fn, step_fn, _ = qat.make_qat_trainer_v2(cfg, folded, lr=args.lr)
        elif isinstance(cfg, V3Config):
            init_fn, step_fn, _ = qat.make_qat_trainer_v3(cfg, folded, lr=args.lr)
        else:
            init_fn, step_fn = qat.make_qat_trainer(cfg, lr=args.lr)
    else:
        init_fn, step_fn = make_optax_trainer(cfg, lr=args.lr)
    opt_state = init_fn(params)
    step = jax.jit(step_fn)

    rng = np.random.default_rng(0)
    n_cls = min(cfg.num_classes, 16)
    images = jnp.asarray(rng.uniform(
        -1, 1, (args.batch, cfg.resolution, cfg.resolution, 3)).astype(np.float32))
    labels = jnp.asarray(rng.integers(0, n_cls, (args.batch,)), jnp.int32)

    for i in range(args.steps):
        params, opt_state, loss, top1 = step(params, opt_state, images, labels)
        print(json.dumps({"step": i, "loss": round(float(loss), 4),
                          "top1": round(float(top1), 4)}), flush=True)
    if args.out:
        save_npz(args.out, jax.device_get(params))
        print(f"saved trained folded checkpoint to {args.out}")


def cmd_export(args):
    """Weight export (reference analog: C9, SURVEY.md SS2): raw -> folded ->
    int8 flat .npz files with documented layouts. All three families."""
    import os

    from .checkpoints import fold_bn, init_params, load_npz, save_npz
    from .config import ModelConfig
    from .quant import quantize

    model = getattr(args, "model", "v1")
    sources = [s for s in ("from_keras", "from_tf_slim", "ckpt")
               if getattr(args, s, None)]
    if len(sources) > 1:
        sys.exit(f"--{' / --'.join(s.replace('_', '-') for s in sources)} "
                 "are mutually exclusive (each names a weight source); "
                 "pass exactly one")
    if model != "v1":
        if getattr(args, "from_tf_slim", None):
            sys.exit("--from-tf-slim imports the V1 TF-slim layout only; "
                     "V2/V3 import keras .h5 (--from-keras) or --ckpt")
        return _export_family(args, model)
    cfg = ModelConfig(alpha=args.alpha, resolution=args.res)
    if getattr(args, "from_keras", None):
        from .checkpoints.io import import_keras_h5

        raw = import_keras_h5(args.from_keras, cfg)
    elif getattr(args, "from_tf_slim", None):
        from .checkpoints.io import import_tf_slim

        raw = import_tf_slim(args.from_tf_slim, cfg)
    elif args.ckpt:
        raw = load_npz(args.ckpt)
    else:
        raw = init_params(cfg, seed=args.seed)
    folded = fold_bn(raw, eps=cfg.bn_eps)
    q = quantize(folded, cfg)

    os.makedirs(args.out, exist_ok=True)
    save_npz(os.path.join(args.out, f"{cfg.variant_name()}_raw.npz"), raw)
    save_npz(os.path.join(args.out, f"{cfg.variant_name()}_folded.npz"), folded)
    qtree = {
        "conv1": {"w_i8": q.conv1.w_i8, "bias_i32": q.conv1.bias_i32, "m": q.conv1.m},
        "blocks": [
            {
                "dw": {"w_i8": b["dw"].w_i8, "bias_i32": b["dw"].bias_i32, "m": b["dw"].m},
                "pw": {"w_i8": b["pw"].w_i8, "bias_i32": b["pw"].bias_i32, "m": b["pw"].m},
            }
            for b in q.blocks
        ],
        "fc": {"w_i8": q.fc_w_i8, "s_w": q.fc_s_w, "b": q.fc_b_f32},
    }
    save_npz(os.path.join(args.out, f"{cfg.variant_name()}_int8.npz"), qtree)
    print(f"exported raw/folded/int8 checkpoints to {args.out}")


def _export_family(args, model):
    """V2/V3 export: raw + folded + int8 (the family quant constants —
    QuantLayer's w_i8/bias_i32/m for V2, QLayerN's w_i8/bias_i32/a/inv_s
    for V3; scales ride along so a loader can requant without re-running
    calibration)."""
    import os

    from .checkpoints import load_npz, save_npz

    cfg = _make_config(args, dtype="float32")
    if model == "v2":
        from .checkpoints.v2 import (fold_bn_v2, import_keras_h5_v2,
                                     init_params_v2)
        from .quant.v2 import quantize_v2

        if getattr(args, "from_keras", None):
            raw = import_keras_h5_v2(args.from_keras, cfg)
        elif getattr(args, "ckpt", None):
            raw = load_npz(args.ckpt)
        else:
            raw = init_params_v2(cfg, seed=args.seed)
        folded = fold_bn_v2(raw, eps=cfg.bn_eps)
        q = quantize_v2(folded, cfg)
        lay = lambda l: {"w_i8": l.w_i8, "bias_i32": l.bias_i32,  # noqa: E731
                         "m": l.m}
        qtree = {
            "conv1": lay(q.conv1),
            "blocks": [{k: lay(v) for k, v in b.items()} for b in q.blocks],
            "conv_last": lay(q.conv_last),
            "fc": {"w_i8": q.fc_w_i8, "s_w": q.fc_s_w, "b": q.fc_b_f32},
            "s_blk": np.asarray(q.s_blk, np.float32),
        }
    else:
        from .checkpoints.v3 import (fold_bn_v3, import_keras_h5_v3,
                                     init_params_v3)
        from .quant.v3 import quantize_v3

        if getattr(args, "from_keras", None):
            raw = import_keras_h5_v3(args.from_keras, cfg)
        elif getattr(args, "ckpt", None):
            raw = load_npz(args.ckpt)
        else:
            raw = init_params_v3(cfg, seed=args.seed)
        folded = fold_bn_v3(raw, eps=cfg.bn_eps)
        q = quantize_v3(folded, cfg)
        lay = lambda l: {"w_i8": l.w_i8, "bias_i32": l.bias_i32,  # noqa: E731
                         "a": l.a, "inv_s": np.float32(l.inv_s)}
        qtree = {
            "conv1": lay(q.conv1),
            "blocks": [{k: lay(v) for k, v in b.items()} for b in q.blocks],
            "conv_last": lay(q.conv_last),
            "head": lay(q.head),
            "fc": {"w_i8": q.fc_w_i8, "s_w": q.fc_s_w, "b": q.fc_b_f32},
            "s_head": np.float32(q.s_head),
        }
    os.makedirs(args.out, exist_ok=True)
    save_npz(os.path.join(args.out, f"{cfg.variant_name()}_raw.npz"), raw)
    save_npz(os.path.join(args.out, f"{cfg.variant_name()}_folded.npz"),
             folded)
    save_npz(os.path.join(args.out, f"{cfg.variant_name()}_int8.npz"), qtree)
    print(f"exported raw/folded/int8 checkpoints to {args.out}")


def cmd_serve(args):
    from .runtime.serving import serve_main

    params = None
    if getattr(args, "ckpt", None):
        from .checkpoints import load_npz

        params = load_npz(args.ckpt)
    serve_main(
        alpha=args.alpha, res=args.res, dtype=args.dtype,
        streams=args.streams, port=args.port, seed=args.seed,
        int8=getattr(args, "int8", False), dp=args.dp, params=params,
        variants=(args.variants.split(",") if args.variants else None),
        selftest_only=not args.tcp, model=getattr(args, "model", "v1"),
        minimalistic=getattr(args, "minimalistic", False),
    )


def cmd_warmup(args):
    """Precompile a config's serving entries so production cold-start is
    bounded by this one command: the persistent compile cache
    (platform.enable_compile_cache) then serves every later pipeline/server
    at dispatch speed. The reference analog is loading the FPGA bitstream once
    per configuration before traffic (SURVEY.md SS5 one-bitstream-per-config
    flow); here one jit entry per (variant, batch, dtype) is the bitstream.

    Bucket parity with serving is structural, not copied: the default batch
    list comes from the same `default_buckets(--streams, mesh)` the server
    itself uses, the pipeline from the same `build_pipeline` (incl. --dp
    mesh sharding — a dp-sharded jit entry is a different compile than the
    unsharded one)."""
    import time as _time

    import numpy as np  # noqa: PLC0415

    from .runtime.serving import build_pipeline, default_buckets

    cfg = _make_config(args)  # any family; build_pipeline dispatches
    params = None
    if getattr(args, "ckpt", None):
        from .checkpoints import load_npz

        params = load_npz(args.ckpt)
    mesh = None
    if args.dp > 1:
        from .parallel.mesh import make_mesh

        mesh = make_mesh(args.dp, model_parallel=1)
    pipe = build_pipeline(cfg, args.seed, mesh, params, args.int8)
    batches = (
        {int(b) for b in args.batches.split(",")} if args.batches
        else set(default_buckets(args.streams, mesh))
    )
    if args.batch is not None:  # an explicitly requested extra entry
        batches.add(int(args.batch))
    batches = sorted(batches)
    res = cfg.resolution
    for b in batches:
        img = np.zeros((b, res, res, 3), np.uint8)
        t0 = _time.perf_counter()
        pipe.run_batch(img)  # returns host probs: the compile is done
        print(f"warm batch {b:4d}: {_time.perf_counter() - t0:6.1f}s "
              f"({'cached' if _time.perf_counter() - t0 < 5 else 'compiled'})",
              flush=True)
    print(f"WARMUP OK: {cfg.variant_name()} "
          f"{'int8' if args.int8 else args.dtype} batches={batches}"
          f"{f' dp={args.dp}' if args.dp > 1 else ''}")


def main(argv=None):
    p = argparse.ArgumentParser(prog="mobilenet_tpu")
    p.add_argument(
        "--backend", default=None, choices=["cpu", "gpu"],
        help="require this JAX backend (cpu = sw_emu tier; gpu exits "
             "non-zero when no GPU is present; default: JAX's choice)",
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp, batch_default=256, model_flag=False):
        sp.add_argument("--alpha", type=float, default=1.0)
        sp.add_argument("--res", type=int, default=224)
        sp.add_argument("--dtype", default="bfloat16", choices=["float32", "bfloat16"])
        sp.add_argument("--seed", type=int, default=0)
        sp.add_argument("--ckpt", default=None, help=".npz checkpoint path")
        sp.add_argument("--batch", type=int, default=batch_default)
        if model_flag:
            sp.add_argument(
                "--model", default="v1",
                choices=["v1", "v2", "v3", "v3small"],
                help="model family: v1 (the reference network, default), "
                     "v2 (inverted residuals; alphas 0.35-1.4), v3 "
                     "(V3-Large: +SE/hard-swish) or v3small")
            sp.add_argument(
                "--minimalistic", action="store_true",
                help="V3 only: the kernel-3/relu/no-SE minimalistic variant")

    sp = sub.add_parser("classify")
    sp.add_argument("image")
    sp.add_argument("--top-k", type=int, default=5)
    sp.add_argument("--int8", action="store_true",
                    help="classify with the INT8 fixed-point path")
    common(sp, 1, model_flag=True)
    sp.set_defaults(fn=cmd_classify)

    sp = sub.add_parser("verify")
    sp.add_argument("--int8", action="store_true")
    sp.add_argument("--oracle", default="cpp", choices=["cpp", "numpy"])
    common(sp, 2, model_flag=True)
    # per-layer verify is an fp32 gate against float32 oracles
    sp.set_defaults(fn=cmd_verify, dtype="float32")

    sp = sub.add_parser("eval")
    sp.add_argument("--dir", default=None,
                    help="directory of images to evaluate (default: synthetic)")
    sp.add_argument("--n", type=int, default=32,
                    help="synthetic image count when --dir is not given")
    sp.add_argument("--synth", default="structured",
                    choices=["structured", "noise"],
                    help="synthetic family: structured (noise + gradients + "
                         "patches + blobs; stresses resize/normalize) or "
                         "pure noise (reproduces round-1/2 recordings)")
    sp.add_argument("--top-k", type=int, default=5)
    sp.add_argument("--int8", action="store_true",
                    help="evaluate the INT8 fixed-point path")
    sp.add_argument("--oracle", default="numpy", choices=["cpp", "numpy"])
    sp.add_argument("--min-agreement", type=float, default=1.0,
                    help="exit 1 below this top-1 agreement fraction")
    sp.add_argument("--tie-margin", type=float, default=None,
                    help="relative oracle-logit margin under which a top-1 "
                         "flip counts as a near-tie, not a mismatch (the "
                         "float path is tolerance-gated vs the oracle, so "
                         "true ties can flip within rounding; 0 = strict). "
                         "Default: 1e-3 for fp32, the measured per-family "
                         "bf16 flip class for bf16 (golden.BF16_TIE_MARGIN)")
    common(sp, 16, model_flag=True)
    # The gate compares against a float32 oracle with a default threshold of
    # 1.0 — run the device side in float32 too (like verify). A bf16 eval is
    # legal but should pair with a sub-1.0 --min-agreement: near-tie logits
    # can flip top-1 within bf16 rounding.
    sp.set_defaults(fn=cmd_eval, dtype="float32")

    sp = sub.add_parser("bench")
    sp.add_argument("--steps", type=int, default=40)
    sp.add_argument("--int8", action="store_true",
                    help="benchmark the INT8 fixed-point path")
    sp.add_argument("--profile", metavar="DIR", default=None,
                    help="capture a device trace of the timed loop to DIR "
                         "(XProf/TensorBoard/Perfetto)")
    common(sp, model_flag=True)
    sp.set_defaults(fn=cmd_bench)

    sp = sub.add_parser("sweep")
    sp.add_argument("--steps", type=int, default=20)
    sp.add_argument("--alphas", default=None, help="comma list, e.g. 0.25,0.5")
    sp.add_argument("--resolutions", default=None, help="comma list, e.g. 128,224")
    sp.add_argument("--int8", action="store_true",
                    help="sweep the INT8 fixed-point path")
    common(sp, 256, model_flag=True)
    sp.set_defaults(fn=cmd_sweep)

    sp = sub.add_parser("train")
    sp.add_argument("--steps", type=int, default=10)
    sp.add_argument("--lr", type=float, default=1e-2)
    sp.add_argument("--out", default=None, help="save trained .npz here")
    sp.add_argument("--qat", action="store_true",
                    help="quantization-aware training: the int8 deployment "
                         "quantizer runs in the graph (quant/qat.py; all "
                         "three families — V2/V3 calibrate-then-freeze)")
    common(sp, 32, model_flag=True)
    sp.set_defaults(fn=cmd_train)

    sp = sub.add_parser("export")
    sp.add_argument("--out", default="checkpoints_out")
    sp.add_argument("--from-keras", metavar="H5",
                    help="convert a keras MobileNet .h5 checkpoint")
    sp.add_argument("--from-tf-slim", metavar="CKPT_PREFIX",
                    help="convert a TF-slim MobilenetV1 checkpoint prefix")
    common(sp, 1, model_flag=True)
    sp.set_defaults(fn=cmd_export)

    sp = sub.add_parser("serve")
    sp.add_argument("--streams", type=int, default=64)
    sp.add_argument("--port", type=int, default=8000)
    sp.add_argument("--int8", action="store_true",
                    help="serve the INT8 fixed-point path")
    sp.add_argument("--dp", type=int, default=1,
                    help="data-parallel width: shard micro-batches over a "
                         "dp-device mesh (1 = single chip)")
    sp.add_argument("--variants", default=None,
                    help='serve several variants from one process, e.g. '
                         '"0.25:128,1.0:224" (first = default; requests '
                         'route with a "variant" field)')
    sp.add_argument("--tcp", action="store_true",
                    help="after the selftest, bind the NDJSON TCP front end "
                         "on --port and serve until killed")
    common(sp, 32, model_flag=True)
    sp.set_defaults(fn=cmd_serve)

    sp = sub.add_parser("warmup")
    sp.add_argument("--int8", action="store_true",
                    help="warm the INT8 fixed-point entries")
    sp.add_argument("--batches", default=None,
                    help="comma list of batch sizes to precompile (default: "
                         "the exact serving buckets for --streams/--dp)")
    sp.add_argument("--streams", type=int, default=64,
                    help="the --streams the production server will run with "
                         "(determines its bucket sizes)")
    sp.add_argument("--dp", type=int, default=1,
                    help="match `serve --dp N`: dp-sharded jit entries are "
                         "distinct compiles from the unsharded ones")
    common(sp, None, model_flag=True)
    sp.set_defaults(fn=cmd_warmup)

    args = p.parse_args(argv)
    from . import platform

    if args.backend:
        platform.select_backend(args.backend)
    platform.enable_compile_cache()
    try:
        args.fn(args)
    except (FileNotFoundError, ValueError) as e:
        # User-input errors (bad image/ckpt path, off-grid alpha/resolution)
        # get a clean one-line exit instead of a traceback — but ValueErrors
        # raised from inside jax/jaxlib (reshape mismatches, Pallas BlockSpec
        # errors, ...) are internal bugs whose stack must survive: re-raise
        # those in full rather than misreporting them as user errors.
        import traceback as _tb

        frames = _tb.extract_tb(e.__traceback__)
        # Match the jax/jaxlib PACKAGE directories, not any path that merely
        # contains a "jax*" component (a user at /home/jaxon/... must still
        # get the clean one-line exit).
        jax_dirs = (f"{os.sep}jax{os.sep}", f"{os.sep}jaxlib{os.sep}")
        if any(d in (f.filename or "") for f in frames for d in jax_dirs):
            raise
        raise SystemExit(f"mobilenet_tpu {args.cmd}: {e}") from e


if __name__ == "__main__":
    main()
