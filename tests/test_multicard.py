"""The four-card paths of `chip_smoke.py --cards 4` on four virtual CPU
devices: data-parallel serving, GSPMD channel tensor parallelism and the
GPipe pipeline, each against its one-device result."""

import chip_smoke


def test_dp_serving_four_devices(capsys):
    chip_smoke.phase_dp(n_dev=4, alpha=0.25, res=64, batch=8)
    out = capsys.readouterr().out
    assert "4-device DP vs one device" in out and "errors=0 retries=0" in out


def test_channel_tp_four_devices(capsys):
    chip_smoke.phase_tp(n_dev=4, alpha=0.25, res=64, batch=4)
    assert "4-way channel TP" in capsys.readouterr().out


def test_gpipe_four_stages(capsys):
    chip_smoke.phase_pp(n_dev=4, alpha=0.25, res=64, batch=8)
    assert "4-stage GPipe" in capsys.readouterr().out
