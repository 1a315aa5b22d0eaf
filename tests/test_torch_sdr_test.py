"""The port's rtl_test counterpart (``radio_mapper_tpu_torch.tools.sdr_test``)
against the JAX package's (``radio_mapper_tpu.tools.sdr_test``).

``DropStats`` and ``measure_ppm`` see the same arrays in both packages
(random counter streams with injected gaps, made with numpy
``default_rng``); ``measure_ppm`` reads a stepped fake clock, so its
result is arithmetic, never a wall-clock reading. The loopback checks
(``sdr_test_rtl_tcp`` and ``sdrtest --loopback``) run the port's server on
port 0 unthrottled with windows of at most 0.3 s and assert byte counts,
gaps and ``total_samples > 0``, never a ppm bound.

Tolerance: exact.
"""

import dataclasses
import json

import numpy as np
import pytest

from radio_mapper_tpu.tools import sdr_test as jst

from radio_mapper_tpu_torch import cli
from radio_mapper_tpu_torch import sim
from radio_mapper_tpu_torch.ingest import SimulatedSource
from radio_mapper_tpu_torch.net import rtl_tcp
from radio_mapper_tpu_torch.tools import sdr_test as st
from radio_mapper_tpu_torch.testing import cap_cpu_threads

cap_cpu_threads()


def _stream(rng, n, n_gaps):
    """An 8-bit counter stream of ``n`` bytes with ``n_gaps`` random drops."""
    s = (int(rng.integers(0, 256)) + np.arange(n + 300 * n_gaps)) % 256
    keep = np.ones(s.size, bool)
    for start in rng.integers(0, s.size - 300, n_gaps):
        keep[start: start + int(rng.integers(1, 300))] = False
    return s[keep][:n].astype(np.uint8)


@pytest.mark.parametrize("seed,n_gaps", [(0, 0), (1, 1), (2, 7), (3, 40)])
def test_drop_stats_same_tally(seed, n_gaps):
    rng = np.random.default_rng(seed)
    stream = _stream(rng, 50_000, n_gaps)
    cuts = np.sort(rng.integers(0, stream.size, 9))
    ours, ref = st.DropStats(), jst.DropStats()
    for chunk in np.split(stream, cuts):
        ours.update(chunk)
        ref.update(chunk)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.loss_ratio == ref.loss_ratio
    assert ours.total_bytes == stream.size
    assert (ours.gaps == 0) == (n_gaps == 0)


def test_drop_stats_edges():
    for blocks in ([np.array([253, 254, 255, 3, 4], np.uint8)], [np.zeros(0, np.uint8)],
                   [np.array([7], np.uint8), np.array([9], np.uint8)], [np.array([255], np.uint8)] * 3):
        ours, ref = st.DropStats(), jst.DropStats()
        for b in blocks:
            ours.update(b)
            ref.update(b)
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref)


class _Clock:
    """``time`` stand-in whose ``monotonic()`` steps by ``dt`` a call."""

    def __init__(self, dt):
        self.t, self.dt = 100.0, dt

    def monotonic(self):
        self.t += self.dt
        return self.t


@pytest.mark.parametrize("dt,block,warmup", [(0.001, 1000, 1), (0.0037, 4096, 2), (0.05, 8192, 0)])
def test_measure_ppm_same_arithmetic(monkeypatch, dt, block, warmup):
    results = []
    for mod in (st, jst):
        monkeypatch.setattr(mod, "time", _Clock(dt))
        calls = []
        read = lambda n: calls.append(n) or np.zeros(n, np.complex64)
        r = mod.measure_ppm(read, nominal_rate_hz=2_048_000.0, duration_s=0.25,
                            block_samples=block, warmup_blocks=warmup)
        results.append((dataclasses.asdict(r), calls))
    assert results[0] == results[1]
    assert results[0][0]["total_samples"] > 0


def test_run_drop_test_same_on_a_scripted_reader(monkeypatch):
    """The lock-then-tally loop on the same byte script (a non-counter
    preamble, then a ramp with one gap) and the same stepped clock."""
    rng = np.random.default_rng(9)
    preamble = [rng.integers(0, 256, 16384, dtype=np.uint8) for _ in range(3)]
    ramp = _stream(rng, 16384 * 20, 1)
    tallies = []
    for mod in (st, jst):
        monkeypatch.setattr(mod, "time", _Clock(0.01))
        blocks = iter(preamble + np.split(ramp, 20))
        tallies.append(dataclasses.asdict(mod.run_drop_test(lambda n: next(blocks), duration_s=0.1)))
    assert tallies[0] == tallies[1]
    assert tallies[0]["total_bytes"] > 0
    for mod in (st, jst):
        with pytest.raises(RuntimeError, match="never entered"):
            mod.run_drop_test(lambda n: np.zeros(n, np.uint8), duration_s=0.1, max_lock_blocks=3)


def test_loopback_report_has_no_loss():
    server = rtl_tcp.RtlTcpServer(SimulatedSource(sim.default_scenario(signal="tone"), 0),
                                  host="127.0.0.1", port=0, throttle=False)
    rtl_tcp.serve_in_thread(server)
    report = st.sdr_test_rtl_tcp("127.0.0.1", server.port, drop_seconds=0.3, ppm_seconds=0.2)
    d, p = report["drop_test"], report["ppm_test"]
    assert d["lost_bytes"] == 0 and d["gaps"] == 0 and d["loss_ratio"] == 0.0
    assert d["total_bytes"] > 16384
    assert p["total_samples"] > 0 and p["nominal_rate_hz"] == 2_048_000.0
    assert sorted(report) == ["drop_test", "ppm_test"]


def test_sdrtest_cli_loopback_on_port_0(capsys):
    cli.main(["--device", "cpu", "sdrtest", "--loopback", "--rtl-tcp", "127.0.0.1:0",
              "--drop-seconds", "0.3", "--ppm-seconds", "0.2"])
    out = capsys.readouterr().out
    report = json.loads(out[: out.rindex("}") + 1])
    assert report["drop_test"]["lost_bytes"] == 0 and report["drop_test"]["gaps"] == 0
    assert report["drop_test"]["total_bytes"] > 16384
    assert report["ppm_test"]["total_samples"] > 0
    assert out.splitlines()[-1].startswith("# drops: 0 bytes in 0 gaps (0.0000% loss); rate: ")
