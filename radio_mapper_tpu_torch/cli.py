"""Command-line runner of the PyTorch/CUDA port: ``python -m radio_mapper_tpu_torch``.

Port of ``radio_mapper_tpu/cli.py``'s compute subcommands, with the same
options and printed lines:

  server    — central processor (WS ingest + HTTP API + triangulation)
  buoy      — a buoy node (sim / file / rtl_sdr / native-file / native-tcp source)
  simulate  — synthesize a scenario, run the pipeline, print the fix
  wideband  — the config-4 wideband demo (channelizer → per-subchannel GCC → fixes)
  stream    — continuous streaming TDOA over a simulated scenario
  demod     — demodulate to audio PCM (rtl_fm parity: raw, single, squelch-hop
              scan, simultaneous ``--watch``)
  adsb      — Mode-S/ADS-B decoder (rtl_adsb parity)
  scan      — wideband power survey to CSV (rtl_power parity)

The reference's ``--backend`` is ``--device {cuda,cpu}`` here, default
``cuda``: every subcommand runs on the card unless ``--device cpu`` is
given, and with ``cuda`` and no card it raises
(:func:`radio_mapper_tpu_torch.device.require_cuda`); nothing falls back to
the CPU. The ``rtl_tcp`` and ``usbmodel`` sources and the ``capture``,
``sdrtest``, ``usbprobe``, ``eeprom``, ``setup``, ``test``, ``analyze``,
``web`` and ``bench`` subcommands are not ported (ROADMAP M12–M14).
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import logging


def _setup_logging(verbose: bool):
    logging.basicConfig(
        level=logging.DEBUG if verbose else logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )


def _device(args):
    """The torch device of ``--device``; ``cuda`` without a card raises."""
    import torch

    from radio_mapper_tpu_torch import device

    if args.device == "cuda":
        device.require_cuda()
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def cmd_server(args):
    from radio_mapper_tpu_torch.runtime.central import CentralProcessor

    central = CentralProcessor(
        host=args.host, ws_port=args.ws_port, http_port=args.http_port,
        min_nodes=args.min_nodes, waveform_mode=args.waveform_mode, device=args.dev,
    )
    asyncio.run(central.run_forever())


def cmd_buoy(args):
    from radio_mapper_tpu_torch import sim
    from radio_mapper_tpu_torch.runtime.buoy import BuoyNode, BuoyNodeConfig, simulated_buoy

    # the detector's bin->Hz mapping and the iq_sample_rate_hz reported
    # to central must match the SOURCE's rate, not the config default
    # (sim sources set it from the scenario below)
    cfg = BuoyNodeConfig(
        buoy_id=args.id,
        central_ws_url=args.central,
        development_mode=args.dev_mode,
        iq_wire_format=args.iq_wire_format,
        iq_snippet_samples=args.snippet_samples,
        sample_rate_hz=args.sample_rate,
    )
    if args.source == "sim":
        scen = sim.default_scenario(signal="noise", bandwidth_hz=50e3)
        idx = args.sim_index % len(scen.buoys)
        node = simulated_buoy(scen, idx, cfg, device=args.dev)
        # An explicit --id wins over the scenario's buoy name (the
        # scenario still provides position/physics for this node).
        if args.id != "buoy-001":
            node.config = dataclasses.replace(node.config, buoy_id=args.id)
    elif args.source == "file":
        from radio_mapper_tpu_torch.ingest import FileSource

        node = BuoyNode(cfg, source=FileSource(args.file, sample_rate_hz=args.sample_rate), device=args.dev)
    elif args.source == "native-file":
        from radio_mapper_tpu_torch.ingest.native import NativeIngest, NativeRingSource

        node = BuoyNode(cfg, source=NativeRingSource(
            NativeIngest.open_file(args.file), sample_rate_hz=args.sample_rate), device=args.dev)
    elif args.source == "native-tcp":
        from radio_mapper_tpu_torch.ingest.native import NativeIngest, NativeRingSource

        host, _, port = args.rtl_tcp.partition(":")
        node = BuoyNode(cfg, source=NativeRingSource(
            NativeIngest.open_tcp(host, int(port or 1234)),
            sample_rate_hz=args.sample_rate), device=args.dev)
    else:  # rtl_sdr subprocess
        from radio_mapper_tpu_torch.ingest import RtlSdrProcessSource

        node = BuoyNode(cfg, source=RtlSdrProcessSource(sample_rate_hz=args.sample_rate), device=args.dev)
    asyncio.run(node.run())


def cmd_simulate(args):
    import numpy as np
    import torch

    from radio_mapper_tpu_torch import geo, sim
    from radio_mapper_tpu_torch.models.pipeline import PipelineConfig, TDOAPipeline

    dwells = max(1, args.dwells)
    scen = sim.default_scenario(
        emitter_lat=args.lat, emitter_lng=args.lng, signal=args.signal,
        bandwidth_hz=args.bandwidth, snr_db=args.snr,
        timing_jitter_s=args.timing_jitter_us * 1e-6, seed=args.seed,
        block_len=16_384 * dwells,
    )
    cap = sim.synthesize(scen)
    pipe = TDOAPipeline(
        PipelineConfig(
            num_buoys=len(scen.buoys), block_len=scen.block_len // dwells,
            sample_rate_hz=scen.sample_rate_hz, max_lag=600,
            power_offset_db=40.0, correlation_dwells=dwells,
            solver_starts=4 if dwells > 1 else 1,
        ),
        device=args.dev,
    )
    iq = np.asarray(cap.iq, np.complex64)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(args.dev)
    out = pipe.step_split(to(iq.real), to(iq.imag), to(cap.buoy_enu))
    est = out.fix.position_enu.cpu().numpy()
    lat, lng, _ = geo.enu_to_lat_lng(est, *scen.ref_origin)
    err = float(np.linalg.norm(est[:2] - cap.emitter_enu[0][:2]))
    print(f"emitter (true): {scen.emitters[0].lat:.6f}, {scen.emitters[0].lng:.6f}")
    print(f"emitter (fix):  {float(lat):.6f}, {float(lng):.6f}")
    print(f"error: {err:.1f} m   residual rms: {float(out.fix.residual_rms_m):.2f} m")
    print(
        "1-sigma ellipse: "
        f"{float(out.fix.ellipse_major_m):.1f} x "
        f"{float(out.fix.ellipse_minor_m):.1f} m @ "
        f"{float(out.fix.ellipse_orientation_deg):.0f} deg"
    )
    print(f"pair lags (samples): {np.round(out.correlation.lag_samples.cpu().numpy(), 2).tolist()}")


def cmd_wideband(args):
    """Config-4 demo: synthesize a wideband scene with one active
    subchannel emitter, run the channelized pipeline, print the
    per-subchannel weights and the active subchannel's fix."""
    import numpy as np
    import torch

    from radio_mapper_tpu_torch import sim
    from radio_mapper_tpu_torch.models.wideband import WidebandConfig, WidebandTDOAPipeline

    cfg = WidebandConfig(
        num_buoys=args.buoys, wide_rate_hz=args.rate,
        num_subchannels=args.subchannels, sub_block=args.sub_block,
        max_lag=args.max_lag,
    )
    pipe = WidebandTDOAPipeline(cfg, device=args.dev)
    b, fs = cfg.num_buoys, cfg.wide_rate_hz
    ang = 2 * np.pi * np.arange(b) / b
    anchors = np.stack(
        [12_000 * np.cos(ang), 12_000 * np.sin(ang), np.zeros(b)], -1
    ).astype(np.float32)
    emitter = np.array([2_000.0, -3_000.0, 0.0])
    sub = args.active_sub % cfg.num_subchannels
    re, im = sim.synthesize_wideband(
        cfg, active_subchannel=sub, anchors_enu=anchors,
        emitter_enu=emitter, snr_db=args.snr, seed=args.seed,
    )
    to = lambda a: torch.from_numpy(a).to(args.dev)
    out = pipe.step_split(to(re), to(im), to(anchors))
    w = out.weights.cpu().numpy().mean(axis=-1)
    fixes = out.fixes_enu.cpu().numpy()
    print(f"wideband: {b} buoys x {fs/1e6:.1f} MS/s -> "
          f"{cfg.num_subchannels} subchannels x {cfg.sub_rate_hz/1e3:.0f} kS/s, "
          f"{cfg.num_pairs} pairs/subchannel")
    for m in range(cfg.num_subchannels):
        off = out.channel_offset_hz[m]
        tag = " <- active" if m == sub else ""
        print(f"  sub {m:2d} ({off/1e3:+8.0f} kHz): mean weight {w[m]:.3f}{tag}")
    err = np.linalg.norm(fixes[sub, :2] - emitter[:2])
    print(f"active subchannel fix: ({fixes[sub,0]:.1f}, {fixes[sub,1]:.1f}) m "
          f"— error {err:.1f} m (true ({emitter[0]:.0f}, {emitter[1]:.0f}))")


def cmd_scan(args):
    """rtl_power-style wideband survey to CSV."""
    from radio_mapper_tpu_torch.tools import power_scan

    if args.source == "sim":
        from radio_mapper_tpu_torch import sim
        from radio_mapper_tpu_torch.ingest import SimulatedSource

        source = SimulatedSource(sim.default_scenario(signal="tone"), 0)
    else:
        from radio_mapper_tpu_torch.ingest import RtlSdrProcessSource

        source = RtlSdrProcessSource(sample_rate_hz=args.sample_rate)
    lines = power_scan.scan_to_csv(
        source,
        args.freq_lo * 1e6,
        args.freq_hi * 1e6,
        bin_hz=args.bin_hz,
        integration_s=args.integration,
        out_path=args.output,
        passes=args.passes,
        peak_hold=args.peak,
        device=args.dev,
    )
    if not args.output:
        for line in lines:
            print(line)
    else:
        print(f"wrote {len(lines)} rows to {args.output}")


def cmd_stream(args):
    """Continuous streaming TDOA over a simulated scenario (config-3 demo)."""
    import numpy as np
    import torch

    from radio_mapper_tpu_torch import sim
    from radio_mapper_tpu_torch.models.streaming_tdoa import StreamingTDOA, StreamingTDOAConfig

    scen = sim.default_scenario(
        signal="noise", bandwidth_hz=args.bandwidth, snr_db=args.snr,
        block_len=args.block_len * args.blocks,
    )
    cap = sim.synthesize(scen)
    st = StreamingTDOA(
        StreamingTDOAConfig(
            num_buoys=len(scen.buoys),
            num_subchannels=args.subchannels,
            sample_rate_hz=scen.sample_rate_hz,
            block_len=args.block_len,
            max_lag=args.max_lag,
        ),
        device=args.dev,
    )
    anchors = torch.from_numpy(cap.buoy_enu.astype(np.float32)).to(args.dev)
    state = st.init_state()
    for k in range(args.blocks):
        blk = torch.from_numpy(
            np.ascontiguousarray(cap.iq[:, k * args.block_len: (k + 1) * args.block_len], dtype=np.complex64)
        ).to(args.dev)
        state, out = st.step(state, blk, anchors)
        w = out.weights.cpu().numpy()
        best = int(np.argmax(w.sum(axis=-1)))
        est = out.fixes_enu.cpu().numpy()[best]
        err = np.linalg.norm(est[:2] - cap.emitter_enu[0][:2])
        print(
            f"block {k}: best subchannel {best}  fix ENU=({est[0]:.0f},{est[1]:.0f})  "
            f"err={err:.0f} m  mean psr={out.psr.cpu().numpy()[best].mean():.2f}"
        )


def _parse_freq_specs(specs):
    """rtl_fm -f frequency list: each entry is a single MHz value or an
    inclusive ``lower:upper:step`` MHz range. Returns the expanded scan
    list in MHz."""
    freqs = []
    for spec in specs:
        s = str(spec)
        if ":" in s:
            parts = s.split(":")
            if len(parts) != 3:
                raise ValueError(f"range must be lower:upper:step, got {s!r}")
            lo, hi, step = (float(p) for p in parts)
            if step <= 0 or hi < lo:
                raise ValueError(f"bad range {s!r}")
            f = lo
            while f <= hi + 1e-9:
                freqs.append(round(f, 9))
                f += step
        else:
            freqs.append(float(s))
    if not freqs:
        raise ValueError("no frequencies given")
    return freqs


def _on(iq, dev):
    """A host block (numpy) or a tensor as complex64 on ``dev``."""
    import numpy as np
    import torch

    if isinstance(iq, torch.Tensor):
        return iq.to(device=dev, dtype=torch.complex64)
    return torch.from_numpy(np.ascontiguousarray(iq, dtype=np.complex64)).to(dev)


def _demod_audio(iq, mode, sample_rate, audio_rate, dev):
    """One block through the selected rtl_fm demod pipeline → float audio
    (on ``dev``)."""
    from radio_mapper_tpu_torch.ops import demod as demod_ops

    iq = _on(iq, dev)
    if mode == "nbfm":
        return demod_ops.nbfm_pipeline(iq, sample_rate_hz=sample_rate, audio_rate_hz=audio_rate)
    if mode == "wbfm":
        return demod_ops.wbfm_pipeline(iq, sample_rate_hz=sample_rate, audio_rate_hz=audio_rate)
    factor = max(1, int(sample_rate / audio_rate))
    if mode == "am":
        return demod_ops.decimate(demod_ops.am_demod(iq), factor)
    if mode == "usb":
        return demod_ops.decimate(demod_ops.usb_demod(iq, sample_rate_hz=sample_rate), factor)
    return demod_ops.decimate(demod_ops.lsb_demod(iq, sample_rate_hz=sample_rate), factor)


def _cmd_demod_watch(args, source, freqs_mhz):
    """Simultaneous multi-frequency watch: one wideband capture, all watch
    channels mixed/decimated/demodulated in one batched call per block,
    per-channel squelch gating, per-channel streaming WAV sinks (no tuner
    hops, no settle/flush dead time)."""
    import wave

    import numpy as np

    from radio_mapper_tpu_torch.ops import demod as demod_ops

    center_hz = float(np.mean(freqs_mhz)) * 1e6
    # The capture rate is whatever the source actually delivers (a sim
    # source runs at its scenario's rate regardless of --sample-rate).
    fs = float(getattr(source, "sample_rate_hz", args.sample_rate))
    span_hz = (max(freqs_mhz) - min(freqs_mhz)) * 1e6
    if span_hz > fs:
        source.close()
        raise SystemExit(
            f"demod --watch: {span_hz/1e6:.3f} MHz span exceeds the "
            f"{fs/1e6:.3f} MS/s capture"
        )
    source.tune(center_hz)
    offsets = tuple(f * 1e6 - center_hz for f in freqs_mhz)

    factor, audio_factor, block = watch_block_plan(fs, args.channel_rate, args.audio_rate, args.dwell)
    # Deterministic streaming gain (per-block peak normalization would
    # pump): FM discriminator output is ±π; envelope modes ~unit scale.
    scale = 32000.0 / np.pi if args.mode in ("wbfm", "nbfm") else 16000.0

    sinks = []
    for f in freqs_mhz:
        w = wave.open(f"{args.output}.{f:.4f}MHz.wav", "wb")
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(int(fs / factor / audio_factor))
        sinks.append(w)
    counts = [0] * len(freqs_mhz)
    total = int(args.seconds * fs)
    consumed = 0
    try:
        while consumed < total:
            iq = source.read(block)
            consumed += block
            audio, open_ = demod_ops.watch_demod_block(
                _on(iq, args.dev),
                sample_rate_hz=fs,
                offsets_hz=offsets,
                mode=args.mode,
                channel_rate_hz=fs / factor,
                audio_rate_hz=fs / factor / audio_factor,
                squelch_threshold=args.squelch,
            )
            audio = audio.cpu().numpy()
            open_np = open_.cpu().numpy()
            for k in range(len(freqs_mhz)):
                if open_np[k]:
                    counts[k] += 1
                    pcm = np.clip(audio[k] * scale, -32767, 32767).astype(np.int16)
                    sinks[k].writeframes(pcm.tobytes())
    finally:
        source.close()
        for w in sinks:
            w.close()
    for f, c in zip(freqs_mhz, counts):
        print(f"# {f:.4f} MHz: {c} open block(s) -> {args.output}.{f:.4f}MHz.wav")


def watch_block_plan(fs, channel_rate, audio_rate, dwell):
    """``(channel factor, audio factor, block samples)`` of ``demod --watch``
    at capture rate ``fs``: the block is ``dwell`` seconds cut to a whole
    number of ``factor · audio_factor`` samples."""
    factor = max(1, int(round(fs / channel_rate)))
    audio_factor = max(1, int(round(channel_rate / audio_rate)))
    block = max(1, int(dwell * fs))
    quantum = factor * audio_factor
    return factor, audio_factor, max(quantum, block - block % quantum)


def cmd_demod(args):
    """rtl_fm-style demodulator: source → audio PCM (s16le) to a file."""
    import numpy as np

    from radio_mapper_tpu_torch.ops import demod as demod_ops

    freqs_mhz = _parse_freq_specs(args.frequency)
    args.frequency = freqs_mhz[0]
    if args.source == "sim":
        from radio_mapper_tpu_torch import sim
        from radio_mapper_tpu_torch.ingest import SimulatedSource

        scen = sim.default_scenario(signal="fm", bandwidth_hz=150e3)
        source = SimulatedSource(scen, 0)
        source.tune(scen.center_frequency_mhz * 1e6)
    else:
        from radio_mapper_tpu_torch.ingest import RtlSdrProcessSource

        source = RtlSdrProcessSource(
            sample_rate_hz=args.sample_rate, center_frequency_hz=args.frequency * 1e6
        )
    if args.watch:
        if args.mode == "raw":
            source.close()
            raise SystemExit("demod: --watch needs a demod mode, not raw")
        _cmd_demod_watch(args, source, freqs_mhz)
        return
    if len(freqs_mhz) > 1:
        # rtl_fm scanning mode: with multiple -f frequencies, squelch is
        # mandatory and a closed squelch hops to the next frequency.
        if args.squelch <= 0:
            source.close()
            raise SystemExit("demod: multiple frequencies require --squelch > 0")
        if args.mode == "raw":
            source.close()
            raise SystemExit("demod: raw mode does not scan; give one frequency")
        dwell = max(2048, int(args.dwell * args.sample_rate))
        total = int(args.seconds * args.sample_rate)
        hits = 0
        idx = 0
        open_dwells = {f: 0 for f in freqs_mhz}
        source.tune(freqs_mhz[idx] * 1e6)
        parts = []
        consumed = 0
        while consumed < total:
            iq = source.read(dwell)
            consumed += dwell
            gated, open_ = demod_ops.squelch(_on(iq, args.dev), args.squelch)
            if bool(open_):
                hits = 0
                open_dwells[freqs_mhz[idx]] += 1
                parts.append(_demod_audio(gated, args.mode, args.sample_rate, args.audio_rate, args.dev).cpu().numpy())
            else:
                hits += 1
                if hits >= args.squelch_hits:  # rtl_fm -t conseq_squelch
                    hits = 0
                    idx = (idx + 1) % len(freqs_mhz)
                    source.tune(freqs_mhz[idx] * 1e6)
        source.close()
        for f, count in open_dwells.items():
            print(f"# {f:.4f} MHz: {count} open dwell(s)")
        if not parts:
            print("# squelch never opened on any scanned frequency")
            np.zeros(0, np.int16).tofile(args.output)
            return
        a = np.concatenate(parts)
    else:
        n = int(args.seconds * args.sample_rate)
        iq = source.read(n)
        source.close()
        if args.squelch > 0:
            # rtl_fm's -l power gate: mute below threshold.
            gated, open_ = demod_ops.squelch(_on(iq, args.dev), args.squelch)
            iq = gated.cpu().numpy()
            if not bool(open_):
                print("# squelch closed (mean power below threshold); output muted")
        if args.mode == "raw":
            # rtl_fm raw mode: no demodulation — interleaved I/Q s16 at the
            # capture rate.
            a = np.empty(2 * len(iq), np.float32)
            a[0::2] = np.real(iq)
            a[1::2] = np.imag(iq)
            peak = np.abs(a).max() + 1e-12
            pcm = np.clip(a / peak * 32000.0, -32767, 32767).astype(np.int16)
            pcm.tofile(args.output)
            print(f"wrote {pcm.size} s16le raw I/Q values @ {args.sample_rate:.0f} Hz to {args.output}")
            return
        a = _demod_audio(iq, args.mode, args.sample_rate, args.audio_rate, args.dev).cpu().numpy()
    peak = np.abs(a).max() + 1e-12
    pcm = np.clip(a / peak * 32000.0, -32767, 32767).astype(np.int16)
    pcm.tofile(args.output)
    print(f"wrote {pcm.size} s16le samples @ {args.audio_rate:.0f} Hz to {args.output}")


def cmd_adsb(args):
    """rtl_adsb-style Mode-S decoder: prints ``*<hex>;`` frames."""
    from radio_mapper_tpu_torch.ops import adsb as adsb_ops

    if args.source == "selftest":
        iq = adsb_ops.encode_frame_iq(
            adsb_ops.append_crc("8d4840d6202cc371c32ce057"), noise=0.02
        )
        for frame in adsb_ops.decode_block(iq, require_crc=not args.no_crc, device=args.dev):
            print(frame)
        return
    from radio_mapper_tpu_torch.ingest import RtlSdrProcessSource

    source = RtlSdrProcessSource(sample_rate_hz=adsb_ops.ADSB_RATE_HZ, center_frequency_hz=1090e6)
    try:
        for _ in range(args.blocks):
            iq = source.read(1 << 18)
            for frame in adsb_ops.decode_block(iq, require_crc=not args.no_crc, device=args.dev):
                print(frame, flush=True)
    finally:
        source.close()


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="radio_mapper_tpu_torch", description="TDOA geolocation framework on PyTorch and CUDA"
    )
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument(
        "--device", choices=["cuda", "cpu"], default="cuda",
        help="where the compute runs; cuda (the default) raises without a card",
    )
    sub = p.add_subparsers(dest="command", required=True)

    s = sub.add_parser("server", help="run the central processor")
    s.add_argument("--host", default="0.0.0.0")
    s.add_argument("--ws-port", type=int, default=8081)
    s.add_argument("--http-port", type=int, default=4000)
    s.add_argument("--min-nodes", type=int, default=3)
    s.add_argument("--waveform-mode", choices=["auto", "always", "never"],
                   default="auto",
                   help="waveform GCC-PHAT TDOA on IQ-bearing detections "
                        "(auto = prefer, fall back to timestamps)")
    s.set_defaults(fn=cmd_server)

    s = sub.add_parser("buoy", help="run a buoy node")
    s.add_argument("--id", default="buoy-001")
    s.add_argument("--central", default="ws://localhost:8081")
    s.add_argument(
        "--source",
        choices=["sim", "file", "rtl_sdr", "native-file", "native-tcp"],
        default="sim",
        help="native-* variants ingest through the C++ ring (native/)",
    )
    s.add_argument("--sim-index", type=int, default=0)
    s.add_argument("--file", help="raw uint8 I/Q .bin for --source file")
    s.add_argument("--rtl-tcp", default="127.0.0.1:1234")
    s.add_argument("--sample-rate", type=float, default=2_048_000.0)
    s.add_argument("--dev", dest="dev_mode", action="store_true", help="development mode (simulated GPS)")
    s.add_argument("--iq-wire-format", choices=["u8", "f16", "json"], default="u8",
                   help="snippet encoding on the wire (u8 ≈ 15× smaller than json)")
    s.add_argument("--snippet-samples", type=int, default=2048,
                   help="IQ samples attached per detection for waveform TDOA")
    s.set_defaults(fn=cmd_buoy)

    s = sub.add_parser("simulate", help="synthetic scenario through the pipeline")
    s.add_argument("--lat", type=float, default=35.47)
    s.add_argument("--lng", type=float, default=-97.51)
    s.add_argument("--signal", default="noise", choices=["noise", "tone", "bpsk", "chirp", "fm"])
    s.add_argument("--bandwidth", type=float, default=150e3)
    s.add_argument("--snr", type=float, default=25.0)
    s.add_argument("--timing-jitter-us", type=float, default=0.0)
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--dwells", type=int, default=1,
                   help="narrowband mode: correlate this many consecutive "
                        "dwells as one coherent capture (correlation_dwells)")
    s.set_defaults(fn=cmd_simulate)

    s = sub.add_parser(
        "wideband",
        help="config-4 demo: wideband capture -> PFB channelizer "
             "-> per-subchannel all-pairs GCC -> per-subchannel fixes",
    )
    s.add_argument("--buoys", type=int, default=16)
    s.add_argument("--rate", type=float, default=10e6, help="wideband MS/s")
    s.add_argument("--subchannels", type=int, default=16)
    s.add_argument("--sub-block", type=int, default=4096)
    s.add_argument("--max-lag", type=int, default=128)
    s.add_argument("--active-sub", type=int, default=5,
                   help="subchannel index carrying the synthetic emitter")
    s.add_argument("--snr", type=float, default=25.0)
    s.add_argument("--seed", type=int, default=0)
    s.set_defaults(fn=cmd_wideband)

    s = sub.add_parser("demod", help="demodulate to audio PCM (rtl_fm parity)")
    s.add_argument(
        "--mode",
        choices=["wbfm", "nbfm", "am", "usb", "lsb", "raw"],
        default="wbfm",
    )
    s.add_argument("--squelch", type=float, default=0.0,
                   help="mean-power squelch threshold (rtl_fm -l), 0 = off")
    s.add_argument("--source", choices=["sim", "rtl_sdr"], default="sim")
    s.add_argument(
        "--frequency", nargs="+", default=["105.7"],
        help="MHz; several values or lower:upper:step ranges scan with "
             "squelch-driven hopping (rtl_fm -f list)")
    s.add_argument("--dwell", type=float, default=0.1,
                   help="seconds per scan dwell before a squelch decision")
    s.add_argument("--squelch-hits", type=int, default=1,
                   help="closed dwells before hopping (rtl_fm -t)")
    s.add_argument("--sample-rate", type=float, default=1_024_000.0)
    s.add_argument("--audio-rate", type=float, default=32_000.0)
    s.add_argument("--seconds", type=float, default=2.0)
    s.add_argument("--output", default="audio.s16le")
    s.add_argument(
        "--watch", action="store_true",
        help="demodulate ALL --frequency channels simultaneously from one "
             "wideband capture (batched; replaces hop scanning) and write "
             "per-channel WAV files <output>.<MHz>.wav")
    s.add_argument("--channel-rate", type=float, default=256_000.0,
                   help="--watch per-channel rate before audio decimation")
    s.set_defaults(fn=cmd_demod)

    s = sub.add_parser("adsb", help="Mode-S/ADS-B decoder (rtl_adsb parity)")
    s.add_argument("--source", choices=["selftest", "rtl_sdr"], default="selftest")
    s.add_argument("--blocks", type=int, default=8)
    s.add_argument("--no-crc", action="store_true", help="permissive (rtl_adsb's behavior)")
    s.set_defaults(fn=cmd_adsb)

    s = sub.add_parser("scan", help="wideband power survey (rtl_power CSV)")
    s.add_argument("freq_lo", type=float, help="MHz")
    s.add_argument("freq_hi", type=float, help="MHz")
    s.add_argument("--source", choices=["sim", "rtl_sdr"], default="sim")
    s.add_argument("--sample-rate", type=float, default=2_048_000.0)
    s.add_argument("--bin-hz", type=float, default=10_000.0)
    s.add_argument("--integration", type=float, default=1.0)
    s.add_argument("--passes", type=int, default=1)
    s.add_argument("--peak", action="store_true",
                   help="peak-hold instead of mean integration (rtl_power -P)")
    s.add_argument("--output", help="append CSV rows to this file")
    s.set_defaults(fn=cmd_scan)

    s = sub.add_parser("stream", help="continuous streaming TDOA demo")
    s.add_argument("--blocks", type=int, default=4)
    s.add_argument("--block-len", type=int, default=16_384)
    s.add_argument("--subchannels", type=int, default=8)
    s.add_argument("--max-lag", type=int, default=8)
    s.add_argument("--bandwidth", type=float, default=110e3)
    s.add_argument("--snr", type=float, default=25.0)
    s.set_defaults(fn=cmd_stream)

    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    _setup_logging(args.verbose)
    args.dev = _device(args)
    args.fn(args)


if __name__ == "__main__":
    main()
