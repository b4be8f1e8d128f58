"""Checkpoint subsystem: weight init, BN folding, save/load, importers.

Reference analog: C9 "Weight export / loader" (SURVEY.md SS2) — offline export of
pretrained TF MobileNet-V1 weights into flat files + host-side fread. Here the
on-disk format is a documented .npz (name -> array, NHWC/HWIO layouts), loaded
into a JAX pytree and placed in device memory once via jax.device_put (the
equivalent of clCreateBuffer + clEnqueueWriteBuffer(weights), SURVEY.md SS1 L3).

No pretrained weights exist in this environment and there is no network
(SURVEY.md SS7 stage 1), so `init_params` ships a seeded-random "reference weight
set"; `import_keras_h5` converts real checkpoints when available.
"""

from __future__ import annotations

import io
import os
from typing import Any, Dict

import jax
import jax.numpy as jnp
import numpy as np

from ..config import ModelConfig

Params = Dict[str, Any]


def _he_std(fan_in: int) -> float:
    return float(np.sqrt(2.0 / fan_in))


def init_params(config: ModelConfig, seed: int = 0) -> Params:
    """Deterministic, seeded 'reference weight set' with non-trivial BN stats.

    BN parameters are drawn away from identity (gamma in [0.5,1.5], running
    var in [0.5,1.5]) so BN folding is actually exercised by the golden tests.
    Returned arrays are float32 numpy — the canonical host-side weight store.
    """
    rng = np.random.default_rng(seed)

    def bn(c):
        return {
            "gamma": rng.uniform(0.5, 1.5, size=(c,)).astype(np.float32),
            "beta": rng.uniform(-0.2, 0.2, size=(c,)).astype(np.float32),
            "mean": rng.normal(0.0, 0.3, size=(c,)).astype(np.float32),
            "var": rng.uniform(0.5, 1.5, size=(c,)).astype(np.float32),
        }

    c1 = config.stem_channels
    params: Params = {
        "conv1": {
            "w": (rng.standard_normal((3, 3, 3, c1)) * _he_std(27)).astype(np.float32),
            "bn": bn(c1),
        },
        "blocks": [],
        "fc": {},
    }
    c_in = c1
    for c_out in config.block_channels:
        params["blocks"].append(
            {
                "dw": {
                    "w": (rng.standard_normal((3, 3, 1, c_in)) * _he_std(9)).astype(np.float32),
                    "bn": bn(c_in),
                },
                "pw": {
                    "w": (rng.standard_normal((c_in, c_out)) * _he_std(c_in)).astype(np.float32),
                    "bn": bn(c_out),
                },
            }
        )
        c_in = c_out
    params["fc"] = {
        "w": (rng.standard_normal((c_in, config.num_classes)) * _he_std(c_in)).astype(
            np.float32
        ),
        "b": np.zeros((config.num_classes,), dtype=np.float32),
    }
    return params


def fold_bn(params: Params, eps: float = 1e-3) -> Params:
    """Fold BatchNorm into conv weights + per-channel bias (float32, on host).

    y = gamma * (conv(x) - mean) / sqrt(var + eps) + beta
      = conv(x) * s + b,   s = gamma / sqrt(var + eps),  b = beta - mean * s

    The conv weight's output-channel axis absorbs s; b becomes the fused bias.
    This mirrors the reference's pre-folded BN option (SURVEY.md SS1 L1) and is
    what makes the pw conv a pure matmul + bias + ReLU (BASELINE.json:5).
    Folding is done in float64 then cast, so the folded path and oracles agree.
    """

    def fold(w: np.ndarray, bnp: Dict[str, np.ndarray], out_axis: int):
        s64 = bnp["gamma"].astype(np.float64) / np.sqrt(
            bnp["var"].astype(np.float64) + eps
        )
        b64 = bnp["beta"].astype(np.float64) - bnp["mean"].astype(np.float64) * s64
        shape = [1] * w.ndim
        shape[out_axis] = -1
        w_f = (w.astype(np.float64) * s64.reshape(shape)).astype(np.float32)
        return w_f, b64.astype(np.float32)

    out: Params = {"blocks": []}
    w, b = fold(params["conv1"]["w"], params["conv1"]["bn"], out_axis=3)
    out["conv1"] = {"w": w, "b": b}
    for blk in params["blocks"]:
        # dw HWIO weight is (3,3,1,C): output channel == axis 3.
        dw_w, dw_b = fold(blk["dw"]["w"], blk["dw"]["bn"], out_axis=3)
        pw_w, pw_b = fold(blk["pw"]["w"], blk["pw"]["bn"], out_axis=1)
        out["blocks"].append({"dw": {"w": dw_w, "b": dw_b}, "pw": {"w": pw_w, "b": pw_b}})
    out["fc"] = {"w": np.asarray(params["fc"]["w"]), "b": np.asarray(params["fc"]["b"])}
    return out


def to_device(params: Params, dtype=jnp.float32, device=None) -> Params:
    """Move a host pytree into HBM once (SURVEY.md SS3.4 'weights -> HBM, once')."""

    def put(x):
        arr = jnp.asarray(x, dtype=dtype if np.asarray(x).dtype == np.float32 else None)
        return jax.device_put(arr, device) if device is not None else arr

    return jax.tree.map(put, params)


# ---------------------------------------------------------------------------
# On-disk format: flat .npz, keys are slash-joined paths ("blocks/3/dw/w").
# ---------------------------------------------------------------------------


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    flat: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            flat.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            flat.update(_flatten(v, f"{prefix}{i}/"))
    else:
        flat[prefix[:-1]] = np.asarray(tree)
    return flat


def _unflatten(flat: Dict[str, np.ndarray]) -> Any:
    root: Dict[str, Any] = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def listify(node):
        if isinstance(node, dict):
            if node and all(k.isdigit() for k in node):
                return [listify(node[str(i)]) for i in range(len(node))]
            return {k: listify(v) for k, v in node.items()}
        return node

    return listify(root)


def save_npz(path: str, params: Params) -> None:
    flat = _flatten(params)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        np.savez(f, **flat)


def load_npz(path: str) -> Params:
    with np.load(path) as data:
        return _unflatten({k: data[k] for k in data.files})


def _keras3_store(path: str):
    """Read a keras-3 `.weights.h5` into {class_base: [per-layer var lists]}.

    Keras 3 `save_weights` keys layers by CLASS-default names in creation
    order (`layers/conv2d_14/vars/0`), NOT by the canonical application-layer
    names — verified empirically against keras 3.13 by stamping each weight
    with a unique constant and reading the file back. Within one file the
    numeric suffix is strictly increasing in creation order, so sorting each
    class's groups by suffix recovers the model's layer schedule; the
    per-family mappers below walk that schedule. BatchNormalization vars are
    [gamma, beta, moving_mean, moving_variance]; conv vars are
    [kernel(, bias)]. Returns None when the file is not keras-3 layout
    (no top-level "layers" group — i.e. a legacy named .h5).
    """
    import re  # noqa: PLC0415

    import h5py  # noqa: PLC0415  (optional dependency, gated)

    with h5py.File(path, "r") as f:
        if "layers" not in f:
            return None
        entries = []
        for name in f["layers"]:
            m = re.fullmatch(r"(.*?)(?:_(\d+))?", name)
            base, idx = m.group(1), int(m.group(2) or 0)
            grp = f["layers"][name]
            if "vars" not in grp or len(grp["vars"]) == 0:
                continue  # weightless layers (activations, pads, reshapes)
            arrs = [np.asarray(grp["vars"][str(i)])
                    for i in range(len(grp["vars"]))]
            entries.append((base, idx, arrs))
    store: Dict[str, list] = {}
    for base, _idx, arrs in sorted(entries, key=lambda e: (e[0], e[1])):
        store.setdefault(base, []).append(arrs)
    return store


def _k3_bn(v):
    return {"gamma": v[0], "beta": v[1], "mean": v[2], "var": v[3]}


def _k3_classes(store, *bases):
    """Fetch class-base lists from a keras-3 store, raising the same
    diagnostic ValueError the count-mismatch path uses when a class is
    absent entirely (e.g. a V1 file — no Dense layer — fed to the V2
    importer, or a writer that keys by canonical layer names instead of
    keras class defaults). Without this, `store["dense"]` raised a bare
    KeyError (round-4 ADVICE.md items 1-2)."""
    missing = [b for b in bases if b not in store]
    if missing:
        raise ValueError(
            f"unrecognized keras-3 layout: expected layer classes "
            f"{list(bases)} but {missing} are absent; found classes "
            f"{sorted(store)} — wrong model family, or a .weights.h5 whose "
            "layers carry custom (non-class-default) names")
    return tuple(store[b] for b in bases)


def _import_keras3_v1(store, config: ModelConfig) -> Params:
    """Map a keras-3 store onto the V1 pytree. Creation order (keras
    mobilenet.py): Conv2D = [conv1, pw_1..pw_13, conv_preds]; DepthwiseConv2D
    = [dw_1..dw_13]; BatchNormalization = [conv1_bn] + [dw_i_bn, pw_i_bn]*13.
    """
    convs, dws, bns = _k3_classes(
        store, "conv2d", "depthwise_conv2d", "batch_normalization")
    n = len(config.block_channels)
    if len(convs) != n + 2 or len(dws) != n or len(bns) != 2 * n + 1:
        raise ValueError(
            f"keras-3 store shape mismatch: {len(convs)} convs/{len(dws)} dw/"
            f"{len(bns)} bn vs expected {n + 2}/{n}/{2 * n + 1} — wrong model "
            "family or truncated file")
    params: Params = {"conv1": {"w": convs[0][0], "bn": _k3_bn(bns[0])},
                      "blocks": []}
    for i in range(n):
        params["blocks"].append({
            "dw": {"w": dws[i][0].transpose(0, 1, 3, 2),
                   "bn": _k3_bn(bns[1 + 2 * i])},
            "pw": {"w": convs[1 + i][0][0, 0], "bn": _k3_bn(bns[2 + 2 * i])},
        })
    preds = convs[n + 1]
    params["fc"] = {"w": preds[0].reshape(config.feature_channels, -1),
                    "b": preds[1]}
    return params


def import_keras_h5(path: str, config: ModelConfig) -> Params:
    """Convert a keras MobileNet .h5 checkpoint into our pytree.

    Two on-disk layouts are understood:
    - legacy named .h5 (the format canonical pretrained artifacts ship in;
      keras <3 `save_weights`): conv1, conv1_bn, conv_dw_{i}, conv_dw_{i}_bn,
      conv_pw_{i}, conv_pw_{i}_bn, conv_preds (mobilenet.py:316-415);
    - keras-3 `.weights.h5` (what this environment's keras 3.13 writes):
      class-default names in creation order, see `_keras3_store`.
    Keras dw kernels are (3,3,C,1) HWOI-per-channel; we transpose to (3,3,1,C).
    Validated against a real `keras.applications.MobileNet` forward in
    tests/test_keras_real.py.
    """
    import h5py  # noqa: PLC0415  (optional dependency, gated)

    store = _keras3_store(path)
    if store is not None:
        return _import_keras3_v1(store, config)

    def bn_of(g):
        return {
            "gamma": np.asarray(g["gamma:0"]),
            "beta": np.asarray(g["beta:0"]),
            "mean": np.asarray(g["moving_mean:0"]),
            "var": np.asarray(g["moving_variance:0"]),
        }

    with h5py.File(path, "r") as f:
        mw = f["model_weights"] if "model_weights" in f else f

        def grp(name):
            g = mw[name]
            return g[name] if name in g else g

        params: Params = {
            "conv1": {"w": np.asarray(grp("conv1")["kernel:0"]), "bn": bn_of(grp("conv1_bn"))},
            "blocks": [],
        }
        for i in range(1, 14):
            dw_k = np.asarray(grp(f"conv_dw_{i}")["depthwise_kernel:0"])  # (3,3,C,1)
            pw_k = np.asarray(grp(f"conv_pw_{i}")["kernel:0"])  # (1,1,Cin,Cout)
            params["blocks"].append(
                {
                    "dw": {"w": dw_k.transpose(0, 1, 3, 2), "bn": bn_of(grp(f"conv_dw_{i}_bn"))},
                    "pw": {"w": pw_k[0, 0], "bn": bn_of(grp(f"conv_pw_{i}_bn"))},
                }
            )
        preds = grp("conv_preds")
        params["fc"] = {
            "w": np.asarray(preds["kernel:0"]).reshape(config.feature_channels, -1),
            "b": np.asarray(preds["bias:0"]),
        }
    return params


def import_tf_slim(path: str, config: ModelConfig) -> Params:
    """Convert a TF-slim MobileNet-V1 checkpoint into our pytree.

    TF-slim checkpoints are the canonical pretrained-weight source for the
    FPGA-port genre (SURVEY.md SS2 C9 / SS7 "TF-slim checkpoints, the usual
    source for FPGA ports, are ReLU6"). Variable naming
    (tensorflow/models research/slim mobilenet_v1.py):

        MobilenetV1/Conv2d_0/weights                       (3,3,3,C1)
        MobilenetV1/Conv2d_0/BatchNorm/{gamma,beta,moving_mean,moving_variance}
        MobilenetV1/Conv2d_{i}_depthwise/depthwise_weights (3,3,C,1)
        MobilenetV1/Conv2d_{i}_depthwise/BatchNorm/...
        MobilenetV1/Conv2d_{i}_pointwise/weights           (1,1,Cin,Cout)
        MobilenetV1/Conv2d_{i}_pointwise/BatchNorm/...
        MobilenetV1/Logits/Conv2d_1c_1x1/{weights,biases}  (1,1,Cf,1001)

    Slim classifiers carry 1001 classes (index 0 = background); when
    config.num_classes == 1000 the background column is dropped, the standard
    ImageNet mapping. `path` is the checkpoint PREFIX (as for
    tf.train.load_checkpoint), e.g. ".../mobilenet_v1_1.0_224.ckpt".
    Gated: needs tensorflow on disk (CPU build suffices; reader only).
    """
    from tensorflow.python.training import py_checkpoint_reader  # noqa: PLC0415

    r = py_checkpoint_reader.NewCheckpointReader(path)

    def t(name):
        return np.asarray(r.get_tensor(f"MobilenetV1/{name}"), np.float32)

    def bn_of(scope):
        return {
            "gamma": t(f"{scope}/BatchNorm/gamma"),
            "beta": t(f"{scope}/BatchNorm/beta"),
            "mean": t(f"{scope}/BatchNorm/moving_mean"),
            "var": t(f"{scope}/BatchNorm/moving_variance"),
        }

    params: Params = {
        "conv1": {"w": t("Conv2d_0/weights"), "bn": bn_of("Conv2d_0")},
        "blocks": [],
    }
    for i in range(1, 14):
        dw_k = t(f"Conv2d_{i}_depthwise/depthwise_weights")  # (3,3,C,1)
        pw_k = t(f"Conv2d_{i}_pointwise/weights")  # (1,1,Cin,Cout)
        params["blocks"].append(
            {
                "dw": {"w": dw_k.transpose(0, 1, 3, 2),
                       "bn": bn_of(f"Conv2d_{i}_depthwise")},
                "pw": {"w": pw_k[0, 0],
                       "bn": bn_of(f"Conv2d_{i}_pointwise")},
            }
        )
    fc_w = t("Logits/Conv2d_1c_1x1/weights")[0, 0]  # (Cf, 1001 or 1000)
    fc_b = t("Logits/Conv2d_1c_1x1/biases")
    if fc_w.shape[1] == config.num_classes + 1:
        fc_w, fc_b = fc_w[:, 1:], fc_b[1:]  # drop slim's background class
    params["fc"] = {"w": fc_w, "b": fc_b}
    return params
