"""INT8 MobileNet-V2: calibration, residual-chain scale groups, and the
EXACT-equality gate (device XLA route vs the NumPy oracle twin).

V2 extends V1's fixed-point scheme at exactly one point — the LINEAR
bottleneck projection needs calibrated signed scales, shared per residual
chain so the add is a plain saturating int8 add (quant/v2.py module doc).
These tests pin the scheme host-side and the exactness contract on the
CPU backend (CLAUDE.md invariants: int8 -> EXACT equality).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from mobilenet_tpu.checkpoints.v2 import fold_bn_v2, init_params_v2
from mobilenet_tpu.models.mobilenet_v2 import V2Config
from mobilenet_tpu.oracle import numpy_ref
from mobilenet_tpu.quant.quantize import quantize_input
from mobilenet_tpu.quant.v2 import (_as_device_tree_v2, _res_add,
                                    forward_all_v2_i8, forward_v2_i8,
                                    quantize_v2, scale_groups,
                                    verify_int8_v2)


@pytest.fixture(scope="module")
def qsetup():
    cfg = V2Config(alpha=1.0, resolution=96)
    folded = fold_bn_v2(init_params_v2(cfg, seed=0), eps=cfg.bn_eps)
    q = quantize_v2(folded, cfg, n_calib=8)
    rng = np.random.default_rng(7)
    x = rng.uniform(-1, 1, (2, 96, 96, 3)).astype(np.float32)
    return cfg, folded, q, x


def test_scale_groups_follow_residual_chains():
    cfg = V2Config(alpha=1.0, resolution=224)
    gids = scale_groups(cfg)
    # chains (keras table): [1], [2,3(res on 2)] -> wait: residual blocks
    # join their producer's group; stride/channel changes start new groups.
    assert len(gids) == 17
    # block2 (res on block1's out), blocks 4,5 (on 3), 7-9 (on 6), 11,12
    # (on 10... block10 changes channels 64->96 so 11,12 chain on 10? no:
    # block10 cout=96 != cin=64 -> new group; 11,12 res -> join 10's group)
    assert gids[2] == gids[1]
    assert gids[4] == gids[5] == gids[3]
    assert gids[7] == gids[8] == gids[9] == gids[6]
    assert gids[11] == gids[12] == gids[10]
    assert gids[14] == gids[15] == gids[13]
    assert gids[16] != gids[15]
    # within-group scales are shared
    q = quantize_v2(fold_bn_v2(init_params_v2(
        V2Config(alpha=1.0, resolution=96), seed=0), eps=1e-3),
        V2Config(alpha=1.0, resolution=96), n_calib=4)
    g = scale_groups(V2Config(alpha=1.0, resolution=96))
    for i in range(17):
        for j in range(17):
            if g[i] == g[j]:
                assert q.s_blk[i] == q.s_blk[j]


def test_exact_equality_all_layers(qsetup):
    cfg, _folded, q, x = qsetup
    x_i8 = quantize_input(x)
    _, ref = forward_all_v2_i8(q, x_i8, cfg)
    _, acts = forward_v2_i8(_as_device_tree_v2(q), jnp.asarray(x_i8), cfg,
                            collect=True)
    assert len(ref) == 64  # conv1 + 16 exp + 17 dw + 17 prj + 10 res +
    #                        conv_last + pool + logits
    for name, r in ref.items():
        a = np.asarray(acts[name])
        if r.dtype == np.int8:
            np.testing.assert_array_equal(a, r, err_msg=name)
        else:
            np.testing.assert_allclose(a, r, atol=1e-5, err_msg=name)


def test_verify_gate_passes(qsetup):
    cfg, folded, _q, x = qsetup
    assert verify_int8_v2(cfg, folded, x, n_calib=8)


def test_int8_top1_tracks_fp32(qsetup):
    cfg, folded, q, _x = qsetup
    from mobilenet_tpu.runtime.eval import synth_images

    imgs = synth_images(cfg, 8, 99)
    xf = (np.stack(imgs).astype(np.float32) / 127.5) - 1.0
    lg32, _ = numpy_ref.forward_all_v2(folded, xf, cfg)
    lg8, _ = forward_all_v2_i8(q, quantize_input(xf), cfg)
    agree = (np.argmax(lg8, -1) == np.argmax(lg32, -1)).mean()
    assert agree >= 0.75, agree  # random-init weights: top-1 mostly tracks


def test_residual_add_saturates():
    a = np.full((4,), 100, np.int8)
    b = np.full((4,), 100, np.int8)
    out = _res_add(a, b)
    assert out.dtype == np.int8 and (out == 127).all()
    out2 = _res_add(np.full((4,), -100, np.int8), np.full((4,), -100, np.int8))
    assert (out2 == -128).all()


def test_prj_requant_is_signed(qsetup):
    """The linear projection must emit NEGATIVE int8 values (a ReLU'd
    requant would zero them — the V1 requant is ReLU-always)."""
    cfg, _folded, q, x = qsetup
    _, ref = forward_all_v2_i8(q, quantize_input(x), cfg)
    assert min(int(ref[f"block{i:02d}_prj"].min()) for i in range(17)) < 0


def test_cli_verify_and_bench_int8_v2(capsys):
    import sys

    from mobilenet_tpu import cli

    argv = sys.argv
    try:
        sys.argv = ["cli", "--backend", "cpu", "verify", "--model", "v2",
                    "--alpha", "1.0", "--res", "96", "--int8", "--batch", "1"]
        with pytest.raises(SystemExit) as e:
            cli.main()
        assert e.value.code == 0
        assert "EXACT (int8 numpy oracle, v2)" in capsys.readouterr().out
        sys.argv = ["cli", "--backend", "cpu", "bench", "--model", "v2",
                    "--alpha", "1.0", "--res", "96", "--int8",
                    "--batch", "4", "--steps", "2"]
        cli.main()
        out = capsys.readouterr().out
        assert '"dtype": "int8"' in out and "mobilenet_v2" in out
    finally:
        sys.argv = argv
