"""The port's command line, ``radio_mapper_tpu_torch.cli.main([...,
'--device', 'cpu'])``, against the JAX package's
``radio_mapper_tpu.cli.main([... '--backend', 'cpu'])``, in process.

The JAX side runs ``simulate`` and ``wideband`` on the routing the TPU
runs (safe mode, fused pair stage, fused FFT + detect; the CPU default
is another algorithm), as ``tests/test_torch_pipeline.py`` does. The
step outputs are recorded where each CLI calls its pipeline, so they are
compared unrounded.

Tolerances and why: ``simulate``'s pair lags within 1e-3 samples and
its fix within 0.5 m (the limits of ``tests/test_torch_pipeline.py``),
and the printed error under 100 m (``tests/test_cli_tools.py``);
``wideband``'s active subchannel equal and its fix within 0.5 m;
``stream``'s best subchannel equal and fixes within 0.5 m; ``adsb
--source selftest`` the same frames; ``demod`` raw and nbfm for 0.05 s
and ``--watch`` with two frequencies: int16 PCM within 2 LSB (float32
audio ~1e-6 apart, scaled to ±32000); ``scan``: the same CSV rows
apart from values and timestamps, dB within 1e-3 (unrounded) and the
printed values within 0.01 (one rounding step). ``--device cuda`` raises
on a machine without a card, for every subcommand.
"""

import re
import wave

import numpy as np
import pytest
import torch

from radio_mapper_tpu import cli as jcli
from radio_mapper_tpu.models import pipeline as jpipe
from radio_mapper_tpu.models import streaming_tdoa as jstream
from radio_mapper_tpu.models import wideband as jwb
from radio_mapper_tpu.ops import detect as jdetect
from radio_mapper_tpu.ops import safe as jsafe
from radio_mapper_tpu.ops import split_complex as jsc
from radio_mapper_tpu.tools import power_scan as jscan

from radio_mapper_tpu_torch import cli
from radio_mapper_tpu_torch.models import pipeline, streaming_tdoa, wideband
from radio_mapper_tpu_torch.tools import power_scan
from radio_mapper_tpu_torch.testing import cap_cpu_threads

cap_cpu_threads()

WIDEBAND = ["wideband", "--buoys", "8", "--subchannels", "8", "--sub-block", "1024", "--max-lag", "64",
            "--rate", "4096000", "--active-sub", "3", "--seed", "1"]


def _jax_main(argv, fused=False):
    """The reference's CLI on the CPU; ``fused`` forces the TPU routing."""
    if not fused:
        return jcli.main(["--backend", "cpu", *argv])
    jsafe.set_safe_mode(True)
    jsc.set_gcc_fused("on")
    jdetect.set_fused_detect("on")
    try:
        return jcli.main(["--backend", "cpu", *argv])
    finally:
        jdetect.set_fused_detect("auto")
        jsc.set_gcc_fused("auto")
        jsafe.set_safe_mode(None)


def _record(monkeypatch, cls, name, sink, jitted=False):
    """Wrap ``cls.name`` so every output it returns lands in ``sink``."""
    orig = getattr(cls, name)

    if jitted:  # ``jit_*`` returns a step function
        def wrapper(self, *a, **kw):
            fn = orig(self, *a, **kw)
            return lambda *x: sink.append(fn(*x)) or sink[-1]
    else:
        def wrapper(self, *a, **kw):
            sink.append(orig(self, *a, **kw))
            return sink[-1]

    monkeypatch.setattr(cls, name, wrapper)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_simulate(monkeypatch, capsys):
    ours, ref = [], []
    _record(monkeypatch, pipeline.TDOAPipeline, "step_split", ours)
    _record(monkeypatch, jpipe.TDOAPipeline, "jit_step_split", ref, jitted=True)
    cli.main(["--device", "cpu", "simulate", "--seed", "4"])
    out = capsys.readouterr().out
    _jax_main(["simulate", "--seed", "4"], fused=True)
    jout = capsys.readouterr().out
    assert len(ours) == len(ref) == 1
    np.testing.assert_allclose(_np(ours[0].correlation.lag_samples), _np(ref[0].correlation.lag_samples), atol=1e-3)
    np.testing.assert_allclose(_np(ours[0].fix.position_enu), _np(ref[0].fix.position_enu), atol=0.5)
    lines, jlines = out.splitlines(), jout.splitlines()
    assert [ln.split(":")[0] for ln in lines] == [ln.split(":")[0] for ln in jlines]
    assert lines[0] == jlines[0]  # the true emitter
    err = float(re.search(r"^error: ([0-9.]+) m", out, re.M).group(1))
    assert err < 100.0


def test_wideband(monkeypatch, capsys):
    ours, ref = [], []
    _record(monkeypatch, wideband.WidebandTDOAPipeline, "step_split", ours)
    _record(monkeypatch, jwb.WidebandTDOAPipeline, "jit_step_split", ref, jitted=True)
    cli.main(["--device", "cpu", *WIDEBAND])
    out = capsys.readouterr().out
    _jax_main(WIDEBAND, fused=True)
    jout = capsys.readouterr().out
    active = lambda s: [ln for ln in s.splitlines() if "<- active" in ln]
    assert len(active(out)) == 1 and active(out)[0].split(":")[0] == active(jout)[0].split(":")[0]
    w, jw = _np(ours[0].weights).mean(-1), _np(ref[0].weights).mean(-1)
    assert int(w.argmax()) == int(jw.argmax()) == 3
    np.testing.assert_allclose(_np(ours[0].fixes_enu)[3], _np(ref[0].fixes_enu)[3], atol=0.5)
    assert out.splitlines()[0] == jout.splitlines()[0]


def test_stream(monkeypatch, capsys):
    ours, ref = [], []
    _record(monkeypatch, streaming_tdoa.StreamingTDOA, "step", ours)
    _record(monkeypatch, jstream.StreamingTDOA, "jit_step", ref, jitted=True)
    argv = ["stream", "--blocks", "2"]
    cli.main(["--device", "cpu", *argv])
    out = capsys.readouterr().out
    _jax_main(argv)
    jout = capsys.readouterr().out
    best = lambda s: [int(m) for m in re.findall(r"best subchannel (\d+)", s)]
    assert best(out) == best(jout) and len(best(out)) == 2
    for (_, o), (_, r), b in zip(ours, ref, best(out)):
        np.testing.assert_allclose(_np(o.fixes_enu)[b], _np(r.fixes_enu)[b], atol=0.5)


def test_adsb_selftest(capsys):
    for extra in ([], ["--no-crc"]):
        cli.main(["--device", "cpu", "adsb", "--source", "selftest", *extra])
        out = capsys.readouterr().out
        _jax_main(["adsb", "--source", "selftest", *extra])
        assert out == capsys.readouterr().out == "*8d4840d6202cc371c32ce0576098;\n"


@pytest.mark.parametrize("mode", ["raw", "nbfm"])
def test_demod_single(tmp_path, capsys, mode):
    ours, ref = tmp_path / "ours.pcm", tmp_path / "ref.pcm"
    argv = ["demod", "--mode", mode, "--source", "sim", "--seconds", "0.05"]
    cli.main(["--device", "cpu", *argv, "--output", str(ours)])
    out = capsys.readouterr().out
    _jax_main([*argv, "--output", str(ref)])
    jout = capsys.readouterr().out
    assert out.replace(str(ours), "X") == jout.replace(str(ref), "X")
    a, b = np.fromfile(ours, np.int16), np.fromfile(ref, np.int16)
    assert a.size == b.size > 0
    assert np.abs(a.astype(np.int32) - b).max() <= 2
    if mode == "raw":
        assert a.size == 2 * int(0.05 * 1_024_000)


def test_demod_watch(tmp_path, capsys):
    argv = ["demod", "--watch", "--source", "sim", "--mode", "nbfm", "--frequency", "121.5", "121.9",
            "--squelch", "0.05", "--seconds", "0.3", "--dwell", "0.1"]
    cli.main(["--device", "cpu", *argv, "--output", str(tmp_path / "ours")])
    out = capsys.readouterr().out
    _jax_main([*argv, "--output", str(tmp_path / "ref")])
    jout = capsys.readouterr().out
    assert out.replace("ours", "X") == jout.replace("ref", "X")
    for f in ("121.5000", "121.9000"):
        pcm = []
        for who in ("ours", "ref"):
            with wave.open(str(tmp_path / f"{who}.{f}MHz.wav")) as w:
                pcm.append(np.frombuffer(w.readframes(w.getnframes()), np.int16).astype(np.int32))
        assert pcm[0].size == pcm[1].size
        if pcm[0].size:
            assert np.abs(pcm[0] - pcm[1]).max() <= 2
    assert "121.5000 MHz: 3 open" in out and "121.9000 MHz: 0 open" in out


def test_demod_squelch_hop_scan(tmp_path, capsys):
    argv = ["demod", "--mode", "nbfm", "--source", "sim", "--frequency", "121.3", "121.5",
            "--squelch", "0.05", "--seconds", "0.4", "--dwell", "0.05"]
    cli.main(["--device", "cpu", *argv, "--output", str(tmp_path / "a.pcm")])
    out = capsys.readouterr().out
    _jax_main([*argv, "--output", str(tmp_path / "b.pcm")])
    jout = capsys.readouterr().out
    assert out.replace("a.pcm", "X") == jout.replace("b.pcm", "X")
    a, b = np.fromfile(tmp_path / "a.pcm", np.int16), np.fromfile(tmp_path / "b.pcm", np.int16)
    assert a.size == b.size and (a.size == 0 or np.abs(a.astype(np.int32) - b).max() <= 2)


def test_scan(monkeypatch, capsys):
    ours, ref = [], []
    for mod, sink in ((power_scan, ours), (jscan, ref)):
        orig = mod.run_scan
        monkeypatch.setattr(mod, "run_scan", lambda *a, _o=orig, _s=sink, **k: _s.append(_o(*a, **k)) or _s[-1])
    argv = ["scan", "120.5", "122.5", "--source", "sim", "--integration", "0.05"]
    cli.main(["--device", "cpu", *argv])
    rows = capsys.readouterr().out.splitlines()
    _jax_main(argv)
    jrows = capsys.readouterr().out.splitlines()
    assert len(rows) == len(jrows) == 2
    for r, j in zip(rows, jrows):
        assert r.split(", ")[2:6] == j.split(", ")[2:6]
        vals = lambda s: np.array([float(v) for v in s.split(", ")[6:]])
        assert np.abs(vals(r) - vals(j)).max() <= 0.0100001
    for a, b in zip(ours[0].power_db, ref[0].power_db):
        assert np.abs(a - b).max() <= 1e-3


@pytest.mark.parametrize("argv", [
    ["simulate"], ["wideband"], ["stream"], ["adsb"], ["demod"], ["scan", "88", "108"], ["server"], ["buoy"],
    ["bench"],
])
def test_cuda_without_a_card_raises(argv):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(argv)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--device", "cuda", *argv])


def test_help_lists_the_subcommands(capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["--help"])
    assert e.value.code == 0
    text = capsys.readouterr().out
    for name in ("server", "buoy", "simulate", "wideband", "stream", "demod", "adsb", "scan",
                 "web", "analyze", "capture", "sdrtest", "test", "setup", "eeprom", "usbprobe", "bench"):
        assert name in text
    assert "--device {cuda,cpu}" in text
    # every subcommand of the JAX package's CLI, each with the reference's options
    ours, ref = cli.build_parser(), jcli.build_parser()
    sub = lambda p: next(a for a in p._actions if a.dest == "command").choices
    assert set(sub(ours)) == set(sub(ref))
    for name, parser in sub(ours).items():
        opts = lambda p: sorted((a.dest, a.default, tuple(a.choices or ()), a.nargs) for a in p._actions
                                if a.dest != "help")
        mine, theirs = opts(parser), opts(sub(ref)[name])
        if name == "buoy":  # the port keeps --dev's flag under dest dev_mode (args.dev is the torch device)
            mine = [("dev",) + o[1:] if o[0] == "dev_mode" else o for o in mine]
        assert mine == sorted(theirs), name
