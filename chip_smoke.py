#!/usr/bin/env python3
"""One run of the PyTorch/CUDA port's paths on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It builds the CUDA kernels from ``radio_mapper_tpu_torch/csrc`` (one nvcc
per source, in parallel, sm_90a), then:

1. prints the card's name and power limit and the kernel build time;
2. K1 (fused FFT + detect) vs its plain PyTorch version at the flagship
   shape [1024 rows, 17408], with errors and median CUDA-event times;
   K1 there is one launch of its cluster design (the cluster K3's kernel
   with its detect half, ``csrc/fft_rows_ct_cluster.cu``): its c, block
   0's detect columns, shared memory, registers, spills, blocks an SM and
   active clusters, its outputs equal to the one-block K1's (the design
   it replaced, ``fft_detect.block_detect``) bit for bit, and both
   times;
3. K2 (PHAT pair stage) vs its plain version at [128, 8, 17408] →
   [128, 28, 1025], fed K1's outputs, and at the pair body's other inner
   length, n1 = 256: [16, 8, 34816] → [16, 28, 1025] on spectra made here
   (window within 1e-4 of its max, same argmax), with its kernel's
   registers, spills and blocks an SM at both;
4. a simulated scene (4 buoys, 16384 samples, max_lag 600) through
   ``TDOAPipeline.step_split`` on the card: the fix must land within
   50 m and agree with the port's CPU run;
5. the flagship at full width — 8 blocks of 128 channels × 8 buoys ×
   16384 uint8 IQ at 2.4 MS/s, max_lag 512 — through
   ``step_split_uint8_scan``, with both kernels' launch counts (K1 once a
   block, by design: its cluster design; no K4), ms/block, IQ samples/s
   and a per-stage split from CUDA events; then the same blocks on the
   combined-topk route (``detect.set_combined_topk(True)``: K1 with
   ``emit_topk = 8``, one launch of its cluster design a block), its
   detections, lag peaks and fixes equal to the default route's bit for
   bit, with both routes' "fft_detect" and "peaks" stages (as in phases
   19, 20 and 39 at block_len 32768, 57344 and 96000);
6. K3 (CT-order FFT) vs its plain version at the wideband shape [1024,
   5120]: the full-width ``WidebandTDOAPipeline.example_inputs(seed=0)``
   block after the channelizer;
7. K5 (pair list as data, per-pair gate) vs its plain version at
   [16, 64, 5120] + s2 [16, 2016] → [16, 2016, 257], fed K3's outputs,
   and at n1 = 256, [1, 64, 34816] → [1, 2016, 1025];
   K6 (row-aligned pairs) vs its plain version and vs K5 on one
   subchannel, [2016, 5120] × 4 (same argmax each); K5's and K6's
   registers, spills and blocks an SM;
8. a full-width wideband scene (64 buoys on a 12 km ring, emitter in
   subchannel 5): the active fix within 300 m and its weights well above
   a quiet subchannel's, the K6 route agreeing with the K5 route, and the
   card agreeing with the CPU at the small wideband config;
9. the wideband config 4 at full width — 8 blocks of 64 buoys × 65,648
   samples at 10 MS/s into 16 subchannels × 2016 pairs — through
   ``WidebandTDOAPipeline.step_split`` on its default route (K3 + K5),
   with launch counts, ms/block, wideband samples/s, pair correlations/s
   and a per-stage split; then the same 8 blocks on the K6 route;
10. K7 (natural-order FFT) vs its plain version at [8192, 16384] (one
    full-width narrowband block's dwells), the same bytes as [16384,
    8192] and [32768, 4096], [32, 32768] (the ELT scene's dwells),
    [8, 65536], [8192, 32768] (a full-width narrowband block at
    block_len 32768) and the same bytes as [4096, 65536], with
    ``torch.fft.fft`` beside it; per shape the design that ran
    (``fft_natural.design``: one-launch radix for n ≤ 16384, the
    thread-block cluster design for 32768 and 65536, whose c, shared
    memory a block and ``cudaOccupancyMaxActiveClusters`` it prints), the
    error (limit 1e-4 of the row max), the bound and the achieved TB/s
    beside the bound's 3.35;
11. the 121.5 MHz ELT scene (OKC buoys, 5 kHz chirp, 8 dwells × 32768,
    max_lag 600, 4 solver starts) through the multi-dwell
    ``TDOAPipeline.step_split`` on the card: the fix within 500 m and
    within 1 m of the port's CPU run, K7 launched;
12. the buoy's detection dwell (``runtime.buoy_detect.detect_dwell``) on
    a simulated 16384-sample dwell, card vs CPU: the same peaks and
    bandwidths, power within 1e-3 dB;
13. the narrowband multi-dwell configuration at full width — 4 blocks of
    128 channels × 8 buoys × 8 dwells × 16384 uint8 IQ at 2.4 MS/s,
    max_lag 512, 4 solver starts — through ``step_split_uint8_scan``,
    with ms/block, IQ samples/s, the ratio to real time, peak device
    memory (limit 40 GiB), a per-stage split and K7 launches per block;
    then 2 blocks of the same at block_len 32768 (8 dwells × 32768, K7's
    cluster design on [8192, 32768]): ms/block against real time, peak
    memory, K7 launches by design and the per-stage split (the psd
    stage's ms/block);
14. K3 vs its plain version at the two-kernel route's shape [1024, 17408]
    (the phase-5 flagship block, padded), with ``torch.fft.fft`` + the CT
    permutation beside it; K4 (CT-order detect on spectra read from
    memory) vs its plain version on those K3 spectra, within K1's limits;
    K1 on the same rows, whose spectra must equal K3's bit for bit (the
    same radix steps of ``ct_fft.cuh``); and K4 on K1's spectra and on
    K3's, which must both equal K1's own partials and noise floor bit for
    bit; and K1's cluster design on those rows as in phase 2;
15. K2 in its l2, l1 and "cc" modes vs its plain version at [128, 8,
    17408] → [128, 28, 1025], within 1e-4 of the window max, same argmax;
16. K8 (the per-channel megakernel) vs its plain version at [128, 8,
    17408], and vs K1 → K2 (l2rx) on the same block: partials, noise
    floors and windows equal bit for bit (the same device functions run
    in the same order; the pair body folds a window by the same k-steps
    at 512 threads); its pair plan, registers and spills;
17. the phase-4 scene on the mega route and on the two-kernel route
    (K3 → K4 → K2): each fix within 50 m and within 0.5 m of the port's
    CPU run on the same route;
18. the phase-5 flagship blocks on the mega route and on the two-kernel
    route, in the same call as phase 5's default route: ms/block, IQ
    samples/s, launches per block (K8 once; K3, K4, K2 once each) and a
    per-stage split;
19. rows past one block's shared memory (fault F3): the long-row designs
    of K3 (``fft_rows_ct_cluster.cu``, a row on a thread-block cluster,
    whose c, shared memory a block and ``cudaOccupancyMaxActiveClusters``
    it prints at each length) and K1 (the long K3, then K4's column
    tiles, ``detect_ct.cu``), and K4, vs their plain versions at
    [1024, 33792] (the flagship block at block_len 32768), [1024, 34816]
    (n1 = 256, max_lag 2048) and [1024, 66560] (block_len 65536), with
    times, bounds and ``torch.fft.fft`` + the CT permutation beside K3;
    K1 one launch of its cluster design (as in phase 2: its shape on the
    card, its outputs equal to the parent's design, the cluster K3 then K4,
    bit for bit, and both times); the long K3 and K1 forced onto 17408 and
    24576 equal to the one-block designs bit for bit, and K4 on the
    one-block K3's spectra equal to the one-block K1's partials;
    the phase-4 scene at block_len 32768 on the default and two-kernel
    routes, card vs CPU; and 4 flagship blocks at full width, 128 ch × 8
    buoys × 32768 uint8 IQ, max_lag 600, through
    ``step_split_uint8_scan`` on the default route: ms/block, launches by
    design (K1 once a block, its cluster design; no K4) and a per-stage
    split;
20. the lengths whose split has n1 ∈ {384, 640, 896} (once fault F3b;
    the mixed-radix warp FFT) and the in-kernel top-K (T1): the long K3
    vs its plain version at [1024, 58368] (the flagship block at
    block_len 57344), [512, 87040], [1024, 97280] (block_len 96000),
    [256, 117760], [256, 128000] and [1024, 121856], with times, bounds
    and ``torch.fft.fft`` + the CT permutation; at each the wide design:
    K1 one launch of it (no K4), its c, shared memory, registers, spills,
    blocks an SM and active clusters printed, K1 = K3 → K4 and both equal
    to the workspace K3 → K4 (the parent design) bit for bit, also on
    rows of equal powers (zeros, an impulse) that take the floor's
    bisection fallback, K1 vs its plain version, and the workspace K3 and
    K3 → K4 timed beside the wide K3 and K1; K1 and K3 at [1024, 17408],
    [1024, 33792], [1024, 34816], [1024, 66560] (n1 = 128/256), [1024,
    58368], [1024, 97280] and [256, 121856] back to back against
    ``RM_PARENT_TREE``'s (``tools/forward_times.py --k1`` by path: parent,
    this, this, parent), with the long rows' digests equal to the
    parent's; at [1024, 58368] and [1024,
    97280] the rows are the flagship's uint8 inputs at block_len 57344 and
    96000 (elsewhere noise), and K2 runs on K1's outputs there, [128, 8,
    58368] and [128, 8, 97280], vs plain (window within 1e-4 of its max,
    same argmax); K2 at [16, 8, 58368] and
    [8, 8, 121856] and K5 at [1, 64, 58368] vs plain; K8's long design at
    [16, 8, 58368] and [16, 8, 121856] equal to K1 → K2 bit for bit and
    vs plain; the pair body's kernels (K2, K5, K6) at 58368, 87040 and
    121856: registers, spills, blocks an SM; K2 at [128, 8, 58368] and, at
    n1 = 128, K2 and K8 at [128, 8, 17408], K5 at [16, 64, 5120] and K6 at
    [2016, 5120] × 4 back to back against ``RM_PARENT_TREE``'s
    (``tools/forward_times.py --pair`` by path), with the n1 = 128/256
    pair digests compared (they differ from a parent before the tensor-core
    fold); K1 and K4 with ``emit_topk = 8`` (T1) at [1024, n], n = 17408,
    33792, 34816, 66560, 58368 and 97280: K1 one launch of its cluster or
    wide design, with its registers, spills, blocks an SM and active
    clusters, equal bit for bit to the parent's T1 design (the one-block
    K1 up to 24576, the long K3 then K4's top-K phase above), timed beside
    it, and to its own partials + the port's top-K tail, at K = 8 and 128
    (K = 128 timed too), K4 to the same, both close to their plain
    versions; ``tools/forward_times.py --k1 ... --topk 8`` gives T1's
    back-to-back times beside the parent's too; the phase-4 scene at
    block_len 57344 on the default, two-kernel, mega and combined-topk
    routes, card vs CPU; and 4 flagship blocks at full width, 128 ch × 8
    buoys × 57344 uint8 IQ, max_lag 600, on the default route: ms/block,
    launches by design and a per-stage split;
21. the complex-IQ step (``TDOAPipeline.step``) on the phase-4 scene, card
    vs CPU: the fix within 50 m and within 0.5 m of the CPU's, lags within
    1e-3 samples, the detections' bins and valid flags equal, their power
    within 1e-3 dB and the noise floors within 1e-4 dB, K7 launched once
    (the detection spectrum); then the
    multi-dwell complex step on the phase-11 ELT scene: the fix within
    500 m and within 1 m of the CPU's, K7 once (the dwell PSD);
22. the complex step at full width — 4 blocks of 128 channels × 8 buoys ×
    16384 uint8 IQ at 2.4 MS/s, max_lag 512 — through ``step_uint8``:
    ms/block, IQ samples/s, the ratio to real time, peak device memory,
    K7 launches a block and a per-stage split (decode, psd, detect,
    spectra, pair corr, lag peaks, solve); and K7 through the complex
    ``fft`` wrapper (planes split, spectrum joined) on the decoded block 0,
    [1024, 16384], against the plain four-step within 1e-4 of each row's
    max |X|, with its time, the plain version's and ``torch.fft.fft``'s;
23. ``StreamingTDOA`` on the simulated stream of
    ``tests/test_streaming_tdoa.py``, card vs CPU on the emitter's
    subchannel (lags within 1e-3 subchannel samples, the fix within 0.5 m
    and within 600 m of the emitter), and 64 blocks of its default
    configuration (8 buoys × 16 subchannels × 16384 samples) through
    ``scan``: ms/block beside the block's real time; and
    ``TDoAEngine.process_signal_detections`` on a simulated group (4 OKC
    buoys, 16384-sample snippets at 2.4 MS/s), card vs CPU: the same
    measurements within 1 ns, the fix within 1 m. These two paths reach
    no FFT or pair kernel (only the LM's): their 5-smooth FFT lengths
    (1080 for the default stream's subchannels, 16875 for the engine's
    snippets) take the matmul four-step.
24. the multi-device layer (``radio_mapper_tpu_torch/parallel``), phases
    24-26 each at world size 1 (one rank, NCCL) and 2 (two ranks on the
    one card over gloo: a functional check, not a multi-card measurement),
    each rank a process started by ``parallel.launch.run_ranks``: the
    pair-parallel (EP) step at ``PairEPConfig()`` (64 buoys, 2016 pairs,
    block 4096 at 2.048 MS/s, max_lag 256, nfft 5120: K3, then K5 on the
    rank's pair slice) on a simulated 8 × 8 grid of buoys, against CPU
    ranks running the same algorithm on the plain versions (fix within
    0.5 m, lags within 1e-3 samples), world size 2 against 1, every rank
    holding the same fix; ms/block, pair correlations/s, launches, the
    all_gather and all_reduce times from CUDA events, peak memory; then
    256 buoys (32640 pairs, K6) at world size 2; K5 and K6 held against
    their plain versions on a rank's pair slice;
25. BASELINE config 5 through ``build_sharded_step_split``: 256 channels ×
    8 buoys × 32768 samples a step at 2.4 MS/s, 16 subchannels × 4 taps,
    max_lag 32, on a (1, 1) mesh (nfft 3072) and a (1, 2) mesh (a halo
    exchange, nfft 2048): ms/step against the 13.653 ms budget, peak
    memory, K3 and K2 launches; each rank's frames equal bit for bit to
    the one-rank channelizer on the rank's span of the stream (the halo
    checked) and within 1e-6 of the largest frame of the one-rank
    channelizer on the whole stream; K3 and K2 held on the rank's block;
26. the sharded wideband step (``build_wideband_sharded_step``) at config 4
    (``WidebandConfig()``): ms/block, launches, rank 0's outputs against
    the one-device ``step_split`` on the same block (phase 9's), K3 and
    K5 held on the rank's subchannels;
27. fault F4: config 4 at full width under ``set_gcc_fused("off")``, the
    reference's natural-grid fallback (nfft 4320, the matmul four-step):
    8 blocks, ms/block and pair correlations/s, no kernel launched but the
    LM's (no K3, no K5), a per-stage split; the phase-8 scene's active fix within 300 m;
    card vs CPU at the small wideband config under "off";
28. the ingest loop (``ingest.runner.IngestLoop``) over the native ring
    (``ingest.native.NativeIngest``, built from ``native/ingest.cpp`` with
    g++ at the first open) at the flagship's width, 128 ch × 8 buoys ×
    16384 uint8 IQ at 2.4 MS/s, max_lag 512: an unpaced synthetic ring
    (``open_synthetic(seed)``, large enough that every byte read is the
    seed's stream) through 8 steps, the last output against
    ``step_split_uint8`` called directly on the same bytes (fixes within
    1e-3 m, lags within 1e-4 samples; bit for bit printed), K1 and K2
    launches a step; the paced ring at real time with ``bench.py
    run_ingest_bench``'s settings at 32 and 128 channels, each with
    ``blocks_per_dispatch`` 1 and 4: IQ samples/s, ``real_time_ratio``,
    host-read, copy-issue and copy CUDA-event ms a step, dropped, consumed
    and written bytes (the check is the accounting: the step is slower
    than real time); and ``bench.py run_ingest_loopback_bench``'s leg at
    32 ch (paced ring → pinned slot → copy → decode and a sparse reduce on
    the card): its dropped bytes;
29. the buoy service: ``runtime.buoy.simulated_buoy`` on the card,
    ``scan_once`` on the scenario's channel, against a CPU ``BuoyNode`` on
    the same samples (detections and bandwidths equal, power within 1e-3
    dB), K7 launched once a dwell, ``detect_block`` ms a dwell, and
    ``match_signal_pattern`` over the node's history within 1e-5 of the
    CPU's scores, lags equal;
30. the demodulators (``ops/demod``): ``watch_demod_block`` on 8 watch
    channels 250 kHz apart from one 2.4 MS/s capture (FM, broadcast FM
    and AM carriers, the rest empty and squelched), 20 blocks of the
    CLI's 0.1 s dwell with its channel and audio factors
    (``cli.watch_block_plan``: 9 × 8) in nbfm, wbfm and am: ms a block
    with its copies against the block's real time and on the card, card
    vs CPU on 5 blocks a mode (open masks equal, audio within 1e-4 of the
    max); the CLI's single-channel wbfm (2 s at 1.024 MS/s), card vs CPU;
31. ADS-B: ``detect_frames`` on 64 blocks of 2^18 samples (the CLI's read
    at 2 MS/s) holding 96 planted encoder frames (19 with a corrupted
    CRC) and 16 noise-only blocks: starts, valid flags and bits equal to
    the CPU's, scores within 1e-5; the decoded hex equal to the planted
    frames (the corrupted ones only with the CRC gate off); ms a block;
32. the power scan (``tools/power_scan.run_scan``) on the tone scene over
    88–108 MHz at 10 kHz bins (nfft 256, 13 hops of 1 s, no kernel) and
    one 1 s hop at 125 Hz bins on the tone's channel (nfft 16384: K7 on
    the frames, its launches counted): dB within 1e-3 of the CPU's on
    every bin, ms a hop;
33. the central service: ``CentralProcessor(device="cuda")``, no socket
    opened, fed the wire messages of 8 simulated buoys over 16 frequency
    groups with 2048-sample u8 snippets through ``_dispatch``: 16
    waveform fixes, equal to ``TDoAEngine.process_signal_detections``
    called directly (within 1e-3 m) and within 1 m of the CPU service;
    ms a correlation pass;
34. the command line: ``python -m radio_mapper_tpu_torch --device cuda``
    for ``simulate``, ``wideband``, ``stream`` (4 blocks), ``adsb --source
    selftest``, ``demod --source sim`` (nbfm, 0.05 s) and ``scan --source
    sim`` (120.5–122.5 MHz), six subprocesses started together: each exits
    0 and prints its checked lines, ``simulate``'s error under 100 m;
35. the modeled dongle: every tuner type through ``usb_proto.Rtl2832u``
    on the port's ``MockRtlUsbTransport`` (open, probe, rate, tune, gain,
    a gap-free counter test), its achieved rate and LO printed;
    ``Rtl2832uSource(open_model_device())`` in counter test mode under a
    card ``BuoyNode`` (``scan_once``) against a CPU node on the same
    samples (detections equal, at least one), K7 once a
    dwell, ``detect_block`` ms a dwell; the CLI's ``_pipeline_smoke`` on
    the card and ``_l0_smoke``;
36. rtl_tcp on the loopback: an in-process ``RtlTcpServer`` on port 0
    serving phase 29's FM scene unthrottled; ``RtlTcpSource`` under a card
    ``BuoyNode`` against a CPU node on the recorded samples (detections
    equal, at least one, power within 1e-3 dB, K7 once a dwell,
    ``detect_block`` ms); ``power_scan.run_scan`` at 125 Hz bins over it
    (K7 once a hop, dB within 3e-4 of the CPU's on the same samples, ms a
    hop, the PSD's CUDA-event ms); ``sdr_test_rtl_tcp`` with short
    windows: 0 lost bytes, 0 gaps;
37. the new CLI: ``usbprobe``, ``capture --source usbmodel`` then
    ``analyze`` (peaks equal to the CPU analyzer's, their dB and the max
    within 1e-6; the mean, over the constant capture's rounding residue,
    printed),
    ``eeprom`` generate then parse, ``sdrtest --loopback`` on port 0, and
    ``demod``, ``adsb``, ``scan`` with ``--source rtl_tcp`` against
    servers on port 0, all ``--device cuda`` subprocesses in two waves;
    ``test`` and ``setup`` probe the host's network and ``web`` serves
    until stopped, so the CPU tests hold them and phase 35 runs ``test``'s
    device part;
38. the benchmark (``radio_mapper_tpu_torch/bench.py``, ``python -m
    radio_mapper_tpu_torch bench``): each leg at full width and small depth
    (scan 2, 2 iterations, one epoch) — the flagship at 128 ch (K1 and K2
    once a block; its complex path, K7 once a block), the FFT leg (K7 once
    a call, held against ``fft_re_im_plain`` at [256, 16384]), the GCC leg
    (K3 and K2 once a block), EP (K3 and K5 or K6 once a step, counted in
    its rank), config 4 (K3 and K5 once a block), the ingest leg at 8 ch
    for 4 steps (K1 and K2 once a step) and the loopback for 8 steps, each
    value finite and above 0; then ``bench.main`` shallow, its last stdout
    line parsed: the reference's keys, ``"backend": "cuda"``;
39. the flagship at block_len 96000 (nfft 97280 = 640·152, the wide K1 at
    n1 = 640): the phase-4 scene at block_len 96000 on the default route,
    card vs CPU (fix within 50 m of the emitter and 0.5 m of the CPU's, K1
    one wide launch, K2 one launch), then 4 full-width blocks, 128 ch × 8
    buoys × 96000 uint8 IQ, max_lag 600, through ``step_split_uint8_scan``:
    ms/block, launches by design (K1 wide and K2 once a block) and a
    per-stage split, and those blocks on the combined-topk route;
40. the LM solve's kernel (``ops/cuda/lm_solve.py``) at the flagship's
    shape (16,384 problems, 8 receivers, 28 pairs, 40 iterations, 2-D)
    and narrowband's (4 starts × 2 captures × 128 channels): one launch,
    equal bit for bit to its numpy float32 emulation
    (``testing.lm_emulate``), against ``solver.lm_loop`` on the card (the
    99th percentile of the gap between the fixes each solve keeps, at
    narrowband the start ``solver.best_start`` picks, within 0.1 m: the
    two sum in another order), and both times (CUDA events);
41. the narrowband pair stage's kernels (``ops/cuda/pair_fft.py``) at
    its shape, 256 captures × 8 buoys × 131072 samples (nfft 135000 =
    1080·125, 7168 pairs, max_lag 512), on delayed-noise captures in the
    decoded planes' strided layout: K9's spectra against its plain
    version and ``torch.fft.fft`` (1e-5 of a row's max |X|), the max
    pass against its plain version, K10's windows against its plain
    version, a whitened ``torch.fft.ifft`` and the four-step (1e-4 of a
    pair's window max, the same argmax, lags within 4.6e-5 samples, PSR
    within 1e-3), lags at the planted delays; each kernel's time beside
    its bound, the plain version's and the library's (``torch.fft``, the
    yardstick the port never calls); then one dispatch of [2, 128, 8,
    131072] through ``step_split`` on both routes of the pair stage (K9 →
    K10 and the four-step forced): launches, lags, PSR, fixes and both
    stage splits. Phases 13 and 22 (nfft 135000 and 17280) count K9, the
    max pass and K10 once a block.

Every phase that solves on the card counts the LM kernel's launches
(``lm_solve_kernel``, one a solve with no ``psum``) beside the others':
one a block on every pipeline and wideband route, none in EP (its
``psum`` keeps the loop).

Each kernel's entry in the ``kernels`` line carries its sources (K1's
``source`` is its cluster design's, ``fft_rows_ct_cluster.cu``, with the
one-block and wide designs' files beside it; K3 with its long-row files,
K7 with its cluster design's, K8 with its long design's), K1's cluster
design at each of phases 2, 14 and 19's lengths (``cluster_design``,
``cluster_design_flagship_block``) and its launches by design on the
flagship at block_len 16384 and 32768 (``design_counts_*``), the long
rows' numbers (K1, K3, K4; K7's
``cluster_rows``), phase 20's (``mixed_rows`` of K1, K2, K3, K5; K8's
``long_rows``; ``topk`` of K1 and K4; K1's and K3's ``wide_design`` by
length, K1's ``wide_vs_workspace`` and ``wide_back_to_back``), phase 39's
(K1's and K2's ``launches_block_len_96000``), phase 22's (K7's
``launches_complex_step``, its launches a block, and ``complex_step_rows``,
the complex wrapper's check and times), its
time and its
plain version's at the main path's shapes (K2's error is the largest of
its PHAT modes; "cc" windows are unwhitened, so their errors are in other
units and phase 15 prints them relative to the window max), its bound
(``bound_ms``: the larger of the least FP32 work of its function over 67
TFLOP/s — 5·n·log2(n) FLOP an FFT, an inverse pruned to the lag window
for the pair stages, 6 FLOP a bin for the detect body — and its bytes,
each input read once and each output written once, over 3.35 TB/s: the
H100 SXM's published peaks), the FLOPs of the repo's own algorithm
(``algorithm_flops``: K3's radix steps, for K1 and K8's forward half with
the detect body's least work; K7's radix passes at 16384; the pair body's
warp FFT and window fold for K2, K5, K6 and K8's pair half), and, where
one PyTorch call computes the same
function, that call's time (``library_ms``:
``torch.fft.fft`` for K7, plus the CT permutation by index for K3; null
for the others, which no single call computes). Every entry also carries
``parallel``: its launches on each path of phases 24-26, by path, world
size and rank (each counted in its rank from 0 just before that path's
step), and its checks against the plain version inside the ranks
(``rank_rows``, with times and bounds). K1 and K2 carry
``launches_ingest`` (phase 28's deterministic run, 8 steps) and K7
``launches_buoy`` (phase 29's dwell), ``launches_scan`` (phase 32's
125 Hz hop), ``launches_buoy_rtl_tcp`` and ``launches_scan_rtl_tcp``
(phase 36's dwell and hop) and ``launches_buoy_usbmodel`` (phase 35's
dwell).

K1, K2, K3, K5, K6 and K7 also carry ``launches_bench``, their launches by
leg of phase 38; K7 ``bench_rows``, its check at the FFT leg's shape.

Any failed check raises, so the run exits non-zero and prints no result
line. The last two lines are a JSON object describing the kernels and,
last, ``{"ok": true, "device": {...}}``. Without a CUDA device it exits
non-zero at once.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import math
import os
import re
import statistics
import subprocess
import sys
import time


def _cuda_ms(torch, fn, reps=5):
    """Median milliseconds of ``fn()`` on the current stream (CUDA events,
    after one warm-up call)."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def _leaves(torch, x):
    """The tensors of a (nested) NamedTuple of tensors."""
    if isinstance(x, torch.Tensor):
        return [x]
    return [t for f in x for t in _leaves(torch, f)]


def _require(cond, what):
    if not cond:
        raise AssertionError(what)


def _stage_split(torch, run, names, reps=3):
    """Median over ``reps`` runs of each stage's ms in ``run(on_stage)``,
    from CUDA events recorded at each hook call; a stage marked more than
    once in a run (once per chunk) counts the sum of its spans."""
    splits = {k: [] for k in names}
    for _ in range(reps):
        events = []

        def mark(name, events=events):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append((name, ev))

        mark("start")
        run(mark)
        torch.cuda.synchronize()
        run_ms = dict.fromkeys(names, 0.0)
        for (_, a), (name, b) in zip(events, events[1:]):
            run_ms[name] += a.elapsed_time(b)
        for k, v in run_ms.items():
            splits[k].append(v)
    return {k: statistics.median(v) for k, v in splits.items()}


def _ring(np, b, radius_m):
    """``[b, 3]`` float32 buoy positions on a ring (the CLI wideband demo's layout)."""
    ang = 2 * np.pi * np.arange(b) / b
    return np.stack([radius_m * np.cos(ang), radius_m * np.sin(ang), np.zeros(b)], -1).astype(np.float32)


def _row_rel_error(out, ref):
    """(max |out − ref| over re and im, max over rows of that error over
    the row's max |X| of the spectrum pair ``ref``)."""
    mag = (ref[0] * ref[0] + ref[1] * ref[1]).amax(-1).sqrt()
    d = [(o - r).abs() for o, r in zip(out, ref)]
    return max(x.max().item() for x in d), max((x.amax(-1) / mag).max().item() for x in d)


def _elt_scene(sim, dwells=8, n=32_768):
    """The 121.5 MHz ELT case of ``tests/test_validation_scenarios.py``."""
    return sim.Scenario(
        buoys=tuple(sim.Buoy(b, la, ln, al) for b, la, ln, al in sim.OKC_BUOYS),
        emitters=(sim.Emitter(lat=35.46, lng=-97.50, signal="chirp", bandwidth_hz=5e3,
                              freq_offset_hz=12_000.0),),
        center_frequency_mhz=121.5, sample_rate_hz=2_048_000.0, block_len=dwells * n,
        snr_db=22.0, seed=11,
    )


H100_FP32_FLOPS = 67e12  # FLOP/s outside the tensor cores (H100 SXM data sheet)
H100_HBM_BYTES = 3.35e12  # bytes/s


def _bound(flops, nbytes):
    """``(bound_ms, bound_by)``: the least time for ``flops`` FP32 operations
    and ``nbytes`` of device-memory traffic at the card's published peaks."""
    t_ops, t_bytes = flops / H100_FP32_FLOPS, nbytes / H100_HBM_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def _fft_flops(rows, n):
    """The least work of ``rows`` complex FFTs of n points: the radix-2
    count, 5·n·log2(n) FLOP a row."""
    return 5.0 * rows * n * math.log2(n)


def _detect_flops(rows, n):
    """The least work of the detect body: the power (3 FLOP a bin) and a
    sliding max at 3 compares a bin (van Herk / Gil-Werman); the noise
    floor over the stride-8 subsample is not counted."""
    return 6.0 * rows * n


def _pair_flops(pairs, n, width):
    """The least work of the pair stage: R = X·conj(Y) (6 FLOP a bin; the
    whitening is not counted), an inverse FFT pruned to the ``width``
    window lags (5·n·log2(width)) and |r| (3 FLOP a lag), per pair."""
    return pairs * (6.0 * n + 5.0 * n * math.log2(width) + 3.0 * width)


def _radix_flops(rows, n, a, r):
    """K3's algorithm (``csrc/ct_fft.cuh``) on ``rows`` rows of n = 128·a·r
    points: step A's a-point radix-2 FFTs (5·n·log2(a) FLOP) and their
    twiddles (6·n), step B's direct r-point DFTs (128·a·r² complex FMAs,
    8 FLOP each) and the row twiddle (6·n), step C's 128-point radix-2
    FFTs (5·n·7)."""
    return rows * (5.0 * n * math.log2(a) + 12.0 * n + 8.0 * 128 * a * r * r + 35.0 * n)


def _natural_radix_flops(rows, plan):
    """K7's radix design (``csrc/fft_natural_radix.cu``) on ``rows`` rows of
    ``plan.n`` points: each pass's R-point radix-2 FFTs (5·n·log2(R) FLOP)
    and, after the first pass, its twiddles (6 FLOP for each of the
    (R − 1)·n/R twiddled points)."""
    n = plan.n
    return rows * sum(5.0 * n * math.log2(r) + (6.0 * n * (r - 1) / r if ns > 1 else 0.0)
                      for r, ns in plan.passes)


def _fft_pair_flops(pairs, n1, n2, rows_w):
    """The repo's pair body (``csrc/gcc_pair_wide.cuh``): the inner inverse
    FFT of every CT row (5·n·log2(n1) FLOP), the inverse twiddle (6·n) and
    the fold into the ``rows_w`` window rows (rows_w·n complex FMAs, 8 FLOP
    each), per pair."""
    n = n1 * n2
    return pairs * (5.0 * n * math.log2(n1) + 6.0 * n + 8.0 * rows_w * n)


def _stockham_flops(n, radices):
    """A Stockham plan (``csrc/mixed_fft.cuh``) on one sequence of n points:
    each pass's R-point DFTs at the radix-2 count (5·n·log2 R FLOP) and,
    after the first pass, its (R − 1)·n/R twiddles (6 FLOP each)."""
    return sum(5.0 * n * math.log2(r) + (6.0 * n * (r - 1) / r if k else 0.0) for k, r in enumerate(radices))


def _pair_fft_flops(rows, pairs, plan, width):
    """``(K9, K10)``'s algorithm on ``rows`` rows and ``pairs`` pairs of a
    ``pair_fft.PLANS`` plan: K9's N1 column DFTs of N2 points, the twiddle
    (6 FLOP a bin) and N2 DFTs of N1 points; K10's R (6 FLOP a bin), its
    whitening (|R|, the sum and two divides, 7), N2 inverse DFTs of N1
    points and, for each column and lag, the twiddle from two tables and
    the multiply-add (14)."""
    n = plan.n1 * plan.n2
    k9 = rows * (plan.n1 * _stockham_flops(plan.n2, plan.radix2) + 6.0 * n
                 + plan.n2 * _stockham_flops(plan.n1, plan.radix1))
    k10 = pairs * (13.0 * n + plan.n2 * _stockham_flops(plan.n1, plan.radix1) + 14.0 * width * plan.n2)
    return k9, k10


PAIR_KERNELS = {"K2": ("gcc_pair_tile_kernel<{n1}, 0>", 2), "K5": ("gcc_pair_tile_kernel<{n1}, 1>", None),
                "K6": ("gcc_rows_kernel<{n1}>", 1)}  # the pair body's kernels: name, pairs a tile (None: TILE_PAIRS)


def _pair_kernel_info(build, gcc_pair, ct_plan, kind, n, lag):
    """What the card makes of the pair body's kernel of ``kind`` at nfft
    ``n``, max_lag ``lag``: registers, spills (the build's -Xptxas -v
    report), local memory and blocks of 256 threads an SM at its launch's
    shared memory (``gcc_pair.wide_info``), and the launch plan."""
    n1, n2 = ct_plan.ct_split(n)
    name, pairs = PAIR_KERNELS[kind]
    plan = gcc_pair.wide_plan(n1, n2, *gcc_pair.window_rows(n, lag), pairs or gcc_pair.TILE_PAIRS)
    info = gcc_pair.wide_info(kind, n1, plan.smem)
    ptx = {r["kernel"]: r for r in build.ptxas_report(build.build_log())}[name.format(n1=n1)]
    return {"kernel": kind, "name": name.format(n1=n1), "nfft": n, "n1": n1, "max_lag": lag,
            "registers": info["registers"], "spill_bytes": ptx["spill_stores"] + ptx["spill_loads"],
            "local_bytes": info["local_bytes"], "blocks_an_sm": info["blocks"], "smem_bytes": plan.smem,
            "pairs_a_block": plan.pairs, "rows_a_chunk": plan.rows, "ntiles_a_block": plan.ntg}


def _pair_info_text(i):
    return (f"{i['name']} at nfft {i['nfft']}, max_lag {i['max_lag']}: {i['registers']} registers, spills "
            f"{i['spill_bytes']} B, local memory {i['local_bytes']} B, {i['blocks_an_sm']} blocks of 256 threads an "
            f"SM at {i['smem_bytes']} B of shared memory ({i['pairs_a_block']} pair(s) a block, {i['rows_a_chunk']} "
            f"rows a chunk, {i['ntiles_a_block']} n-tile(s) a pair)")


def _ct_spectra(torch, ct_plan, c, b, nfft, dev, seed):
    """``(re, im, row max power)``: CT-order spectra ``[c, b, nfft]`` of
    circularly shifted copies of one complex noise source per channel plus
    independent noise (a correlation peak per pair), from ``seed``."""
    g = torch.Generator(device=dev).manual_seed(seed)
    noise = lambda *shape: torch.randn(*shape, dtype=torch.complex64, device=dev, generator=g)
    src = noise(c, nfft)
    shifts = torch.randint(-40, 41, (b,), device=dev, generator=g).tolist()
    x = torch.stack([torch.roll(src, s, -1) for s in shifts], 1) + 0.5 * noise(c, b, nfft)
    spec = torch.fft.fft(x)[..., torch.as_tensor(ct_plan.ct_permutation(nfft), device=dev)]
    re, im = spec.real.contiguous(), spec.imag.contiguous()
    return re, im, (re * re + im * im).amax(-1)


def _window_errors(a, b):
    """(max |a − b|, max over windows of max|a − b| / max|b|)."""
    d = (a - b).abs()
    return d.max().item(), (d.amax(-1) / b.abs().amax(-1)).max().item()


def _partials_errors(torch, out, ref, fr, fi):
    """Detect partials ``out`` vs ``ref`` (seg_score, seg_arg, noise floor)
    on CT spectra ``(fr, fi)``: (share of segments whose candidate pattern
    differs, share of common candidates whose argmax differs, floor max
    |err| dB, score max |err|, score max |err| over the row's max power,
    any common candidate)."""
    fin, pfin = torch.isfinite(out[0]), torch.isfinite(ref[0])
    both = fin & pfin
    pmax = (fr * fr + fi * fi).amax(-1, keepdim=True)
    return (
        (fin != pfin).float().mean().item(),
        (out[1] != ref[1])[both].float().mean().item(),
        (out[2] - ref[2]).abs().max().item(),
        (out[0] - ref[0])[both].abs().max().item(),
        ((out[0] - ref[0]).abs() / pmax)[both].max().item(),
        bool(both.any().item()),
    )


LM = "lm_solve_kernel"  # the LM's launches: one a solve on the card with no psum
K9, KMAX, K10 = "pair_fft_spectra", "pair_fft_max", "pair_fft_window"  # the pair stage at nfft 135000 and 17280
PAIR_FFT = (K9, KMAX, K10)  # one launch each a chunk of the pair stage


def _same_bits(np, got, want):
    """The same NaNs, and every other float32 bit for bit."""
    nan = np.isnan(want)
    return bool(np.array_equal(np.isnan(got), nan) and np.array_equal(got[~nan].view(np.uint32),
                                                                      want[~nan].view(np.uint32)))


def _lm_phase(np, torch, dev, zero_counts, launch_counts, tag):
    """Phase 40: the LM kernel at the flagship's and narrowband's shapes
    against its float32 emulation (bit for bit) and the eager loop, with
    both times. Returns each shape's row for the kernels line."""
    from radio_mapper_tpu_torch import solver, testing
    from radio_mapper_tpu_torch.ops.cuda import lm_solve
    from radio_mapper_tpu_torch.tools import lm_times

    rows = {}
    for name in ("flagship", "narrowband"):
        args, iterations = lm_times.inputs(name, dev, seed=29)
        kern = lambda: lm_solve.lm_solve(*args, iterations=iterations, solve_2d=True)
        loop = lambda: solver.lm_loop(*args, iterations=iterations, solve_2d=True)
        kern()  # the library's first call
        torch.cuda.synchronize()
        zero_counts()
        x, cost = kern()
        torch.cuda.synchronize()
        counts = {k: v for k, v in launch_counts().items() if v}
        xl, cl = loop()
        _, flat = lm_solve.flatten_problems(args[0], *args[3:])
        fa, fd, fw, fs, fx = (t.cpu().numpy() for t in flat)
        n, b, p = fa.shape[0], fa.shape[1], fd.shape[1]
        kind = lm_solve.layout(p, b)
        xe, ce = testing.lm_emulate(fa, args[1].cpu().numpy(), args[2].cpu().numpy(), fd, fw, fs, fx,
                                    iterations=iterations, solve_2d=True, lanes=32 if kind == "warp" else 0)
        bits = _same_bits(np, x.reshape(-1, 3).cpu().numpy(), xe) and _same_bits(np, cost.reshape(-1).cpu().numpy(), ce)
        if name == "narrowband":  # the fix each solve keeps from its 4 starts (a start alone may run off either way)
            x = torch.take_along_dim(x, solver.best_start(cost)[None, ..., None], dim=0)[0]
            xl = torch.take_along_dim(xl, solver.best_start(cl)[None, ..., None], dim=0)[0]
        gap = (x - xl).abs().amax(-1).nan_to_num(0.0).flatten().cpu().numpy()
        k_ms = _cuda_ms(torch, kern, reps=20)
        l_ms = _cuda_ms(torch, loop, reps=3)
        # per problem: receivers' distance and unit vector 13 FLOP a pass, two passes an iteration; a pair's
        # normal-equation terms 42 and its cost 5; the damped 3x3 solve ~60; the first cost
        flops = n * (iterations * (26 * b + 47 * p + 60) + 13 * b + 5 * p)
        nbytes = 4 * n * (3 * b + 2 * p + 1 + 3) + 4 * n * 4 + 8 * p  # inputs once, x and cost out
        bound = _bound(flops, nbytes)
        p99 = float(np.percentile(gap, 99))
        print(
            f"phase 40: LM kernel, {name}'s shape: N = {n} problems x {b} receivers x {p} pairs, {iterations} "
            f"iterations, {kind} layout: launches {counts}; = its float32 emulation bit for bit {bits}; vs the loop "
            f"on the card, the fixes kept ({gap.size}): gap max {gap.max():.3e} m, 99th percentile {p99:.3e} m (tol 0.1), median "
            f"{np.median(gap):.3e} m; kernel {k_ms:.4f} ms, loop {l_ms:.3f} ms, bound {bound[0]:.5f} ms "
            f"({bound[1]}) {tag}"
        )
        _require(counts == {LM: 1}, f"LM kernel at {name}'s shape: launches {counts}")
        _require(bits, f"LM kernel at {name}'s shape differs from its float32 emulation")
        _require(p99 <= 0.1, f"LM kernel at {name}'s shape: fixes {p99} m from the loop's")
        rows[name] = {"shape": [n, b, p, iterations], "layout": kind, "max_abs_err": float(gap.max()),
                      "ms": k_ms, "plain_ms": l_ms, "bound_ms": bound[0], "bound_by": bound[1], "library_ms": None,
                      "algorithm_flops": flops, "emulation_bit_equal": bits}
    return rows


def _pair_fft_phase(np, torch, dev, zero_counts, launch_counts, tag, chans=256):
    """Phase 41: K9, the max pass and K10 at narrowband's shape (256
    captures × 8 buoys × 131072 samples, nfft 135000 = 1080·125, 7168
    pairs, max_lag 512) on delayed-noise captures in the decoded planes'
    strided layout: each against its plain version on the card and the
    library's ``torch.fft.fft``/``ifft`` (the yardstick, which the port
    never calls), the windows also against the four-step; lags against
    the planted delays; each kernel's time beside its bound, the plain
    version's and the library's. Then one narrowband dispatch through
    ``step_split`` on both routes of the pair stage (K9 → K10, and the
    four-step forced): launches, stage split, lags, PSR and fixes. Returns
    the kernel-table rows."""
    from radio_mapper_tpu_torch import testing
    from radio_mapper_tpu_torch.models.pipeline import PipelineConfig, TDOAPipeline
    from radio_mapper_tpu_torch.ops import gcc_phat, split_complex
    from radio_mapper_tpu_torch.ops.cuda import pair_fft

    nfft, b, length, lag, eps = 135_000, 8, 131_072, 512, 0.05
    plan = pair_fft.PLANS[nfft]
    rows, npairs, width = chans * b, b * (b - 1) // 2, 2 * lag + 1
    re, im, delays = testing.delayed_noise(chans, b, length, 200, seed=41, device=dev)
    fre, fim = re.reshape(rows, length), im.reshape(rows, length)
    zero_counts()
    spec = pair_fft.receiver_spectra(fre, fim, nfft)
    pmax = pair_fft.pair_max(spec, b)
    mags = pair_fft.lag_mags(spec, b, max_lag=lag, eps=eps)
    torch.cuda.synchronize()
    got = {k: v for k, v in launch_counts().items() if v}
    _require(got == {K9: 1, KMAX: 2, K10: 1}, f"phase 41 launches {got}")  # lag_mags runs its own max pass

    # K9 against its plain version and torch.fft.fft, in natural order; rel: to the row's max |X|
    def rel(a, ref):
        return ((a - ref).abs().amax(-1) / ref.abs().amax(-1)).max().item()

    nat = torch.complex(*pair_fft.natural(spec))
    lib = torch.fft.fft(torch.complex(fre, fim), n=nfft)
    k9_lib = rel(nat, lib)
    plain = pair_fft.receiver_spectra_plain(fre, fim, nfft)
    k9_plain = rel(torch.complex(*pair_fft.natural(plain)), lib)
    k9_vs_plain = ((spec - plain).abs().amax((1, 2, 3)) / plain.abs().amax((1, 2, 3))).max().item()
    del plain, nat
    max_rel = ((pmax - pair_fft.pair_max_plain(spec, b)).abs() / pmax).max().item()

    # K10 against its plain version, a torch.fft window and the four-step, per chunk of channels
    ii, jj = (torch.as_tensor(a, device=dev) for a in np.triu_indices(b, k=1))
    step = 32

    def lib_window(c0, c1):
        x = lib.reshape(chans, b, nfft)[c0:c1]
        r = x[:, ii] * x[:, jj].conj()
        a = r.abs()
        r = torch.fft.ifft(r / (a + eps * a.amax(-1, keepdim=True) + 1e-30))
        return torch.cat([r[..., nfft - lag:], r[..., : lag + 1]], -1).abs()

    def plain_window(c0, c1):
        part = spec[c0 * b:c1 * b]
        return pair_fft.lag_mags_plain(part, pair_fft.pair_max_plain(part, b), b, max_lag=lag, eps=eps)

    def four_step_window(c0, c1):
        fr, fi, _ = split_complex.receiver_spectra_split(re[c0:c1], im[c0:c1], max_lag=lag)
        return gcc_phat.pair_lag_mags(fr, fi, ii, jj, max_lag=lag, eps=eps)

    refs = {name: torch.cat([f(c, min(c + step, chans)) for c in range(0, chans, step)])
            for name, f in (("plain", plain_window), ("torch.fft", lib_window), ("four-step", four_step_window))}
    peaks = lambda m: gcc_phat.peaks_from_lag_mags(m, sample_rate_hz=1.0, max_lag=lag)
    ours = peaks(mags)
    truth = (delays[:, jj] - delays[:, ii]).to(torch.float32)
    truth_gap = (ours.lag_samples - truth).abs().max().item()
    cmp = {}
    for name, ref in refs.items():
        pr = peaks(ref)
        cmp[name] = {
            "window_rel": ((mags - ref).abs().amax(-1) / ref.amax(-1)).max().item(),
            "argmax_equal": bool((mags.argmax(-1) == ref.argmax(-1)).all()),
            "lag_gap": (ours.lag_samples - pr.lag_samples).abs().max().item(),
            "psr_rel": ((ours.psr - pr.psr).abs() / pr.psr).max().item(),
        }
    del refs
    print(
        f"phase 41: K9 [{rows}, {length}] -> [{rows}, {plan.n2}, {plan.n1}] (nfft {nfft} = {plan.n1}x{plan.n2}): "
        f"spectra vs torch.fft.fft rel {k9_lib:.3e} (the plain version's {k9_plain:.3e}), vs plain {k9_vs_plain:.3e} "
        f"(tol 1e-5); max pass vs plain rel {max_rel:.3e}; K10 [{chans}, {npairs}, {width}]: "
        + "; ".join(f"vs {k} window rel {v['window_rel']:.3e}, argmax equal {v['argmax_equal']}, lags "
                    f"{v['lag_gap']:.3e} samples, PSR rel {v['psr_rel']:.3e}" for k, v in cmp.items())
        + f"; lags vs the planted delays max {truth_gap:.3e} {tag}"
    )
    _require(k9_lib <= 1e-5 and k9_vs_plain <= 1e-5, f"K9 spectra: {k9_lib}, {k9_vs_plain}")
    _require(max_rel <= 1e-6, f"the max pass: {max_rel}")
    _require(truth_gap < 0.5, f"K10's lags miss the planted delays by {truth_gap}")
    for name, v in cmp.items():
        _require(v["window_rel"] <= 1e-4 and v["argmax_equal"] and v["lag_gap"] <= 4.6e-5 and v["psr_rel"] <= 1e-3,
                 f"K10 against {name}: {v}")

    # times, beside the bound, the plain version and the library
    k9_ms = _cuda_ms(torch, lambda: pair_fft.receiver_spectra(fre, fim, nfft))
    max_ms = _cuda_ms(torch, lambda: pair_fft.pair_max(spec, b))
    k10_ms = _cuda_ms(torch, lambda: pair_fft.lag_mags(spec, b, max_lag=lag, eps=eps)) - max_ms
    k9_plain_ms = _cuda_ms(torch, lambda: pair_fft.receiver_spectra_plain(fre, fim, nfft), reps=2)
    k10_plain_ms = _cuda_ms(torch, lambda: [plain_window(c, c + step) for c in range(0, chans, step)], reps=1)
    k9_lib_ms = _cuda_ms(torch, lambda: torch.fft.fft(torch.complex(fre, fim), n=nfft))
    k10_lib_ms = _cuda_ms(torch, lambda: [lib_window(c, c + step) for c in range(0, chans, step)], reps=2)
    pairs = chans * npairs
    k9_bound = _bound(_fft_flops(rows, nfft), rows * length * 8 + rows * nfft * 8)
    max_bound = _bound(9.0 * pairs * nfft, rows * nfft * 8)
    k10_bound = _bound(_pair_flops(pairs, nfft, width), rows * nfft * 8 + pairs * width * 4)
    print(
        f"phase 41: K9 {k9_ms:.3f} ms (bound {k9_bound[0]:.3f} by {k9_bound[1]}; plain {k9_plain_ms:.3f}; "
        f"torch.fft.fft {k9_lib_ms:.3f}), max pass {max_ms:.3f} ms (bound {max_bound[0]:.3f} by {max_bound[1]}), "
        f"K10 {k10_ms:.3f} ms (bound {k10_bound[0]:.3f} by {k10_bound[1]}; plain {k10_plain_ms:.3f}; whitening + "
        f"torch.fft.ifft {k10_lib_ms:.3f}): the stage {k9_ms + max_ms + k10_ms:.3f} ms a dispatch of "
        f"{chans} captures {tag}"
    )
    del spec, mags, lib
    torch.cuda.empty_cache()

    # one narrowband dispatch on both routes of the pair stage
    cfg = PipelineConfig(num_buoys=b, block_len=16_384, sample_rate_hz=2.4e6, max_lag=lag, solver_starts=4,
                         correlation_dwells=8, power_offset_db=40.0)
    pipe = TDOAPipeline(cfg, device=dev)
    anchors = torch.from_numpy(_ring(np, b, 12_000.0)).to(dev)
    x = (re.reshape(2, chans // 2, b, length), im.reshape(2, chans // 2, b, length), anchors)
    names = ["psd", "detect", "spectra", "pair_corr", "lag_peaks", "solve"]
    runs = {}
    route = pair_fft.route
    try:
        for name in ("K9 -> K10", "four-step"):
            if name == "four-step":
                pair_fft.route = lambda *a, **k: "four-step"
            pipe.step_split(*x)
            torch.cuda.synchronize()
            zero_counts()
            out = pipe.step_split(*x)
            torch.cuda.synchronize()
            counts = {k: v for k, v in launch_counts().items() if v}
            runs[name] = (out, counts, _stage_split(torch, lambda mark: pipe.step_split(*x, on_stage=mark), names))
    finally:
        pair_fft.route = route
    (a, ca, sa), (bb, cb, sb) = runs["K9 -> K10"], runs["four-step"]
    lag_gap = (a.correlation.lag_samples - bb.correlation.lag_samples).abs().max().item()
    psr_rel = ((a.correlation.psr - bb.correlation.psr).abs() / bb.correlation.psr).max().item()
    fix_gap = (a.fix.position_enu - bb.fix.position_enu).norm(dim=-1).max().item()
    fmt = lambda st: ", ".join(f"{k} {v:.3f}" for k, v in st.items())
    print(
        f"phase 41: narrowband dispatch [2, {chans // 2}, {b}, {length}], launches {ca} (four-step forced: {cb}); lags "
        f"{lag_gap:.3e} samples, PSR rel {psr_rel:.3e}, fixes {fix_gap:.3e} m apart; stage split ms/dispatch "
        f"(median of 3): K9 -> K10: {fmt(sa)} | four-step: {fmt(sb)} {tag}"
    )
    _require(ca == {"fft_rows": 1, LM: 1, K9: 1, KMAX: 1, K10: 1}, f"narrowband dispatch launches {ca}")
    _require(cb == {"fft_rows": 1, LM: 1}, f"the four-step route's launches {cb}")
    _require(lag_gap <= 4.6e-5 and psr_rel <= 1e-3, "the two routes of the pair stage disagree")
    del re, im, x, runs, a, bb
    torch.cuda.empty_cache()
    row = lambda shape, err, ms, plain_ms, bound, lib_ms, fl: {
        "shape": shape, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0],
        "bound_by": bound[1], "library_ms": lib_ms, "algorithm_flops": fl}
    k9_flops, k10_flops = _pair_fft_flops(rows, pairs, plan, width)
    return {
        K9: row([rows, nfft], k9_lib, k9_ms, k9_plain_ms, k9_bound, k9_lib_ms, k9_flops),
        KMAX: row([chans, npairs, nfft], max_rel, max_ms, None, max_bound, None, 9.0 * pairs * nfft),
        K10: row([chans, npairs, width], cmp["torch.fft"]["window_rel"], k10_ms, k10_plain_ms, k10_bound,
                 k10_lib_ms, k10_flops),
    }


def _kernel_counters():
    """Every kernel's launch counter, by the name of its wrapper:
    ``{name: (module, attribute)}``."""
    from radio_mapper_tpu_torch.ops.cuda import (
        channel_step, detect_ct, fft_detect, fft_natural, fft_rows, gcc_pair, lm_solve, pair_fft,
    )

    return {
        LM: (lm_solve, "launch_count"),
        "fft_detect_rows_ct": (fft_detect, "launch_count"),
        "gcc_pair_lag_mags": (gcc_pair, "launch_count"),
        "fft_rows_ct": (fft_rows, "launch_count"),
        "detect_ct_partials": (detect_ct, "launch_count"),
        "gcc_pairs_onehot_lag_mags": (gcc_pair, "onehot_launch_count"),
        "gcc_rows_lag_mags": (gcc_pair, "rows_launch_count"),
        "fft_rows": (fft_natural, "launch_count"),
        "channel_step_partials": (channel_step, "launch_count"),
        K9: (pair_fft, "launch_count"),
        KMAX: (pair_fft, "max_launch_count"),
        K10: (pair_fft, "window_launch_count"),
    }


def _zero_counts(counters):
    for mod, attr in counters.values():
        setattr(mod, attr, 0)


def _read_counts(counters):
    return {k: getattr(mod, attr) for k, (mod, attr) in counters.items()}


def _step_ms(torch, fn, reps):
    """Median host milliseconds of ``fn()`` through a device synchronise,
    after one warm-up call: a whole step with its host work."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def _path_run(torch, counters, step, args, reps):
    """Drive one multi-rank path on this rank: a warm-up step; one step with
    the launch counts set to 0 just before and read just after; one step
    with the collectives' CUDA-event times recorded; ``reps`` timed steps
    with the peak memory. Returns ``(output of the counted step, facts)``."""
    from radio_mapper_tpu_torch.parallel import collectives

    step(*args)
    torch.cuda.synchronize()
    _zero_counts(counters)
    out = step(*args)
    torch.cuda.synchronize()
    launches = {k: v for k, v in _read_counts(counters).items() if v}
    with collectives.recording() as rec:
        step(*args)
        coll_ms, coll_calls = rec.ms(), rec.calls()
    torch.cuda.reset_peak_memory_stats()
    ms = _step_ms(torch, lambda: step(*args), reps)
    return out, {"launches": launches, "coll_ms": coll_ms, "coll_calls": coll_calls, "ms": ms,
                 "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


# tools/forward_times.py --pair's times at n1 = 128: key -> shape
PAIR_SHAPES = {"K2 17408": [128, 8, 17408], "K8 17408": [128, 8, 17408], "K5 5120": [16, 64, 5120],
               "K6 5120": [2016, 5120]}


def _pair_times(tree):
    """``tools/forward_times.py --pair`` of this checkout run by path on the
    package under ``tree`` (this checkout's or a parent's): ``{key: ms}``
    for K2 at [128, 8, 58368] (``"K2 58368"``) and :data:`PAIR_SHAPES`, and
    the n1 = 128/256 pair digests."""
    script = os.path.join(os.path.dirname(os.path.abspath(__file__)), "radio_mapper_tpu_torch", "tools",
                          "forward_times.py")
    out = subprocess.run([sys.executable, script, "--pair"], env={**os.environ, "PYTHONPATH": tree},
                         capture_output=True, text=True, timeout=600, check=True).stdout
    num = lambda pattern: float(re.search(pattern, out).group(1))
    times = {"K2 58368": num(r"\[128, 8, 58368\], max_lag 600: K2 ([0-9.]+) ms"),
             "K2 17408": num(r"\[128, 8, 17408\], max_lag 512: K2 ([0-9.]+) ms"),
             "K8 17408": num(r"\[128, 8, 17408\], max_lag 512: K2 [0-9.]+ ms, K8 ([0-9.]+) ms"),
             "K5 5120": num(r"\[16, 64, 5120\], max_lag 128: K5 ([0-9.]+) ms"),
             "K6 5120": num(r"K6 \[2016, 5120\] x 4 ([0-9.]+) ms")}
    one = re.search(r"K5 \(one pair a block\) ([0-9.]+) ms", out)
    if one:  # K5 in the tile kernel, also timed one pair a block
        times["K5 5120 one pair a block"] = float(one.group(1))
    digests = re.search(r"pair digests \(n1 = 128, 256\): (.*) \[", out).group(1)
    return times, digests


# forward_times.py --k1's lengths here: n1 = 128/256 (the flagship at block_len 16384, 32768, 65536 and
# 32768 at max_lag 2048), then 384, 640, 896
K1_LENGTHS = (17_408, 33_792, 34_816, 66_560, 58_368, 97_280, 121_856)


def _k1_times(tree):
    """``tools/forward_times.py --k1 ... --topk 8`` at :data:`K1_LENGTHS` of
    this checkout run by path on the package under ``tree``: ``{nfft:
    (rows, K1 ms, K3 ms, K1 with emit_topk = 8 ms, its design)}`` and the
    long rows' digests (K1's top-K blocks among them)."""
    script = os.path.join(os.path.dirname(os.path.abspath(__file__)), "radio_mapper_tpu_torch", "tools",
                          "forward_times.py")
    out = subprocess.run([sys.executable, script, "--k1", ",".join(map(str, K1_LENGTHS)), "--topk", "8"],
                         env={**os.environ, "PYTHONPATH": tree}, capture_output=True, text=True, timeout=600,
                         check=True).stdout
    times = {}
    for n in K1_LENGTHS:
        m = re.search(rf"\[([0-9]+), {n}\], n1 = [0-9]+: K1 ([0-9.]+) ms, K3 ([0-9.]+) ms", out)
        t = re.search(rf"\[[0-9]+, {n}\], n1 = [0-9]+: K1 top-K 8 ([0-9.]+) ms \((\w+)\)", out)
        times[n] = (int(m.group(1)), float(m.group(2)), float(m.group(3)), float(t.group(1)), t.group(2))
    digests = re.search(r"long digests \([^)]*\): (.*) \[", out).group(1)
    return times, digests


def _k1_cluster_report(torch, n, xr, xi, plan, phase, tag):
    """K1's cluster design (n1 = 128/256, ``csrc/fft_rows_ct_cluster.cu``
    with its detect half) on the rows ``xr, xi`` of length n: one launch
    through the wrapper (no K3, no K4), its shape on the card (c, block 0's
    detect columns, shared memory, registers, spills, blocks an SM, active
    clusters), its outputs against the design it replaced bit for bit (the
    one-block K1 up to 24576, the cluster K3 then K4 above: spectra,
    partials, floor, row max), and the CUDA-event times of both. Returns
    the facts for the kernels line."""
    from radio_mapper_tpu_torch.ops.cuda import build, detect_ct, fft_detect, fft_rows

    g = fft_detect.cluster_geometry(n, plan.radius)
    info = fft_detect.cluster_info(n, plan.radius)
    ptx = {r["kernel"]: r for r in build.ptxas_report(build.build_log())}[f"ct_cluster_kernel<{g.n1}, {g.cols}, 1, 0>"]
    spills = ptx["spill_stores"] + ptx["spill_loads"]
    short = n <= fft_detect.MAX_N

    def parent():
        if short:
            return fft_detect.block_detect(xr, xi, plan)
        f3 = fft_rows.long_rows(xr, xi)
        return (*f3, *detect_ct.launch(*f3, plan, row_max=True))

    counts = lambda: (fft_detect.design_counts["cluster"], fft_detect.launch_count, fft_rows.launch_count,
                      detect_ct.launch_count)
    before = counts()
    k1 = fft_detect.fft_detect_rows_ct(xr, xi, plan)
    torch.cuda.synchronize()
    one_launch = tuple(a - b for a, b in zip(counts(), before)) == (1, 1, 0, 0)
    names = ("spectra re", "spectra im", "segment scores", "segment offsets", "floor", "row max")
    same = {k: torch.equal(x, y) for k, x, y in zip(names, k1, parent())}
    del k1
    ms = _cuda_ms(torch, lambda: fft_detect.fft_detect_rows_ct(xr, xi, plan))
    parent_ms = _cuda_ms(torch, parent)
    parent_name = "the one-block K1" if short else "the cluster K3 -> K4"
    print(
        f"phase {phase}: K1 [{xr.shape[0]}, {n}] ({g.n1}·{g.n2}) design {fft_detect.geometry(n, 0, plan.radius)}: one "
        f"launch (no K3, no K4) {one_launch}; c = {info['c']} blocks a row, block 0's detect columns "
        f"{info['dcols0']}, {info['smem']} B of shared memory a block, {info['registers']} registers, spills "
        f"{ptx['spill_stores']}/{ptx['spill_loads']} B, {info['blocks']} blocks of 512 threads an SM, "
        f"cudaOccupancyMaxActiveClusters {info['clusters']}; = {parent_name} bit for bit: {same}; kernel "
        f"{ms:.3f} ms, {parent_name} {parent_ms:.3f} ms {tag}"
    )
    _require(one_launch, f"K1 at {n} is not one launch of the cluster design")
    _require(all(same.values()), f"K1's cluster design differs from {parent_name} at {n}: {same}")
    two = 2 * (info["smem"] + fft_rows.CLUSTER_DETECT_STATIC_BYTES + fft_rows.SMEM_RESERVED) <= fft_rows.SM_SMEM
    _require(info["clusters"] > 0 and info["registers"] <= 64 and info["blocks"] == (2 if two else 1),
             f"K1's cluster at {n}: {info}")
    return {"shape": [xr.shape[0], n], "design": "cluster", **info, "spill_bytes": spills, "ms": ms,
            "parent_design": "block" if short else "cluster K3 -> K4", "parent_ms": parent_ms,
            "bit_equal_to_parent": all(same.values())}


def _combined_topk_report(torch, pipe, raw, anchors, default_out, label, phase, tag):
    """The flagship blocks ``raw`` through ``step_split_uint8_scan`` on the
    combined-topk route (``detect.set_combined_topk(True)``: K1 with
    ``emit_topk = max_peaks``, the tail only unpacking) beside the default
    route's output ``default_out`` on the same blocks: launches by kernel
    and K1's by design (K1 and K2 once a block, K1 one launch of its
    cluster or wide design), its detections, lag windows' peaks and fixes
    equal to the default route's bit for bit, ms/block, and both routes'
    "fft_detect" and "peaks" stages (CUDA events, median of 3). Returns the
    facts for the kernels line."""
    from radio_mapper_tpu_torch.ops import detect as detect_ops
    from radio_mapper_tpu_torch.ops.cuda import fft_detect

    counters = _kernel_counters()
    blocks = raw.shape[0]
    names = ["decode", "fft_detect", "peaks", "gcc_pair", "solve"]
    split = lambda: _stage_split(torch, lambda mark: pipe.step_split_uint8(raw[0], anchors, on_stage=mark), names)
    default_med = split()
    detect_ops.set_combined_topk(True)
    try:
        pipe.step_split_uint8(raw[0], anchors)  # warm-up
        torch.cuda.synchronize()
        _zero_counts(counters)
        designs0 = dict(fft_detect.design_counts)
        t0 = time.perf_counter()
        out = pipe.step_split_uint8_scan(raw, anchors)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in _read_counts(counters).items() if v}
        designs = {k: v - designs0[k] for k, v in fft_detect.design_counts.items() if v != designs0[k]}
        med = split()
    finally:
        detect_ops.set_combined_topk(False)
    same = {part: all(torch.equal(x, y) for x, y in zip(_leaves(torch, getattr(out, part)),
                                                        _leaves(torch, getattr(default_out, part))))
            for part in ("peaks", "correlation", "fix")}
    design = fft_detect.geometry(pipe.plan.nfft, emit_topk=pipe.config.max_peaks)
    print(
        f"phase {phase}: flagship {label}, {blocks} blocks, combined-topk route (K1 emit_topk "
        f"{pipe.config.max_peaks}): {1e3 * wall / blocks:.3f} ms/block, launches {launches}, K1 by design {designs}; "
        f"= the default route bit for bit {same}; fft_detect {med['fft_detect']:.3f} ms, peaks {med['peaks']:.3f} "
        f"ms (default route: fft_detect {default_med['fft_detect']:.3f}, peaks {default_med['peaks']:.3f}) {tag}"
    )
    _require(launches == {"fft_detect_rows_ct": blocks, "gcc_pair_lag_mags": blocks, LM: blocks}
             and designs == {design: blocks}
             and design in ("cluster", "wide"), f"combined-topk route {label}: launches {launches}, K1 {designs}")
    _require(all(same.values()), f"combined-topk route {label} differs from the default route: {same}")
    return {"block_len": label, "blocks": blocks, "launches": launches, "k1_designs": designs,
            "ms_block": 1e3 * wall / blocks, "fft_detect_ms": med["fft_detect"], "peaks_ms": med["peaks"],
            "default_fft_detect_ms": default_med["fft_detect"], "default_peaks_ms": default_med["peaks"],
            "equal_to_default": all(same.values())}


def _held(torch, name, kernel, plain, shape, window, bound):
    """``kernel()`` against ``plain()`` on this rank's tensors: errors
    (spectra: rel to each row's max |X|; windows: rel to each window's
    max, with the argmax compared), the kernel's and the plain version's
    CUDA-event times, and the ``bound`` (:func:`_bound`) of the call."""
    k, p = kernel(), plain()
    torch.cuda.synchronize()
    if window:
        err, rel = _window_errors(k, p)
        same = bool((k.argmax(-1) == p.argmax(-1)).all())
    else:
        err, rel = _row_rel_error(k, p)
        same = True
    del k, p
    return {"name": name, "shape": shape, "max_abs_err": err, "rel_err": rel, "same_argmax": same,
            "ms": _cuda_ms(torch, kernel), "plain_ms": _cuda_ms(torch, plain, reps=3),
            "bound_ms": bound[0], "bound_by": bound[1]}


def _ep_rank(ctx, cases, reps, measure=True):
    """Phase 24 on one rank: the EP step of each case (name, config,
    global re, im, anchors). With ``measure`` (the card's ranks): the
    path's launches, collective times, ms/block, peak memory, and K5 or K6
    held against its plain version on this rank's pair slice; without (the
    CPU ranks, the fused route forced on: the plain versions of the card's
    algorithm), the outputs only."""
    import numpy as np
    import torch

    from radio_mapper_tpu_torch.ops import split_complex
    from radio_mapper_tpu_torch.ops.cuda import gcc_pair
    from radio_mapper_tpu_torch.parallel import mesh as mesh_lib
    from radio_mapper_tpu_torch.parallel.pair_ep import OUT_SPEC, build_pair_ep_step

    counters = _kernel_counters()
    mesh = mesh_lib.make_mesh((ctx.world_size,), ("pair",), device=ctx.device.type)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(ctx.device)
    res = {}
    for name, cfg, re, im, anchors in cases:
        prev = split_complex.gcc_fused_mode()
        if ctx.device.type == "cpu":  # the card's route, on the plain versions
            split_complex.set_gcc_fused("on")
        try:
            step, specs, _ = build_pair_ep_step(mesh, cfg)
        finally:
            split_complex.set_gcc_fused(prev)
        args = [to(mesh_lib.local_block(a, mesh, s)) for a, s in zip((re, im, anchors), specs)]
        r = {}
        if measure:
            out, r = _path_run(torch, counters, step, args, reps)
            fr, fi = step.spectra(*args[:2])
            kw = dict(max_lag=cfg.max_lag, eps=cfg.gcc_eps, weighting=cfg.weighting, s2=step.gate_scales(fr, fi))
            p_loc, (b, nfft), width = len(step.pair_i), fr.shape, 2 * cfg.max_lag + 1
            flops = _pair_flops(p_loc, nfft, width)
            if step.onehot():
                k = lambda: gcc_pair.gcc_pairs_onehot_lag_mags(fr, fi, step.pair_i, step.pair_j, **kw)
                p = lambda: gcc_pair.gcc_pairs_onehot_lag_mags_plain(fr, fi, step.pair_i, step.pair_j, **kw)
                bound = _bound(flops, b * nfft * 8 + p_loc * 4 + p_loc * width * 4)
                r["held"] = _held(torch, "gcc_pairs_onehot_lag_mags", k, p, [b, nfft, p_loc], True, bound)
            else:
                rows = step.gathered_pairs(fr, fi)
                k = lambda: gcc_pair.gcc_rows_lag_mags(*rows, **kw)
                p = lambda: gcc_pair.gcc_rows_lag_mags_plain(*rows, **kw)
                bound = _bound(flops, 4 * p_loc * nfft * 4 + p_loc * 4 + p_loc * width * 4)
                r["held"] = _held(torch, "gcc_rows_lag_mags", k, p, list(rows[0].shape), True, bound)
            r["nfft"] = fr.shape[-1]
            del fr, fi
        else:
            out = step(*args)
        r["fix"], r["cost"] = out.fix_enu, out.cost
        r["lags"] = mesh_lib.gather_global(out.lags, mesh, OUT_SPEC.lags)
        r["weights"] = mesh_lib.gather_global(out.weights, mesh, OUT_SPEC.weights)
        r["pairs"] = step.num_real_pairs
        res[name] = r
        if measure:
            torch.cuda.empty_cache()
    return res


def _config5_rank(ctx, reps):
    """Phase 25 on one rank: ``build_sharded_step_split`` at BASELINE
    config 5 (256 ch × 8 buoys × 32768 samples a step at 2.4 MS/s, 16
    subchannels × 4 taps, max_lag 32) on a (1, world) ("ch", "blk") mesh;
    the rank's channelized frames against the one-rank channelizer on its
    span of the stream (the history read from the stream, not exchanged),
    bit for bit, and against the one-rank channelizer on the whole stream;
    K3 and K2 held against their plain versions on the rank's block."""
    import numpy as np
    import torch

    from radio_mapper_tpu_torch.ops import gcc_phat, split_complex
    from radio_mapper_tpu_torch.ops.cuda import fft_rows, gcc_pair
    from radio_mapper_tpu_torch.parallel import mesh as mesh_lib
    from radio_mapper_tpu_torch.parallel import sharded

    cfg = sharded.ShardedStepConfig(
        num_channels=256, num_buoys=8, num_subchannels=16, taps_per_channel=4,
        sample_rate_hz=2_400_000.0, max_lag=32,
    )
    n_step = 32_768
    mesh = mesh_lib.make_mesh((1, ctx.world_size), device="cuda")
    blk = mesh_lib.axis(mesh, "blk")
    step, _ = sharded.build_sharded_step_split(mesh, cfg)
    args = sharded.example_inputs_split(mesh, cfg, samples_per_shard=n_step // ctx.world_size)
    out, r = _path_run(torch, _kernel_counters(), step, args, reps)
    fixes = mesh_lib.gather_global(out.fixes_enu, mesh, sharded.OUT_SPEC)
    r["fix_shape"] = list(fixes.shape)
    r["finite"] = all(bool(torch.isfinite(x).all()) for x in out)

    # the rank's frames against the one-rank channelizer: on the rank's
    # span of the stream (its history read from the stream: the halo
    # exchange checked bit for bit), and on the whole stream
    ch_re, ch_im = sharded.sharded_channelize_split(args[0], args[1], cfg, blk)
    (g_re, g_im), _ = sharded.global_inputs(cfg, n_step, 0, split=True)
    hist = (cfg.taps_per_channel - 1) * cfg.num_subchannels
    n_l = n_step // blk.size
    padded = lambda g: torch.cat([torch.zeros(*g.shape[:-1], hist), torch.from_numpy(g)], -1).to(ctx.device)
    one = lambda a, b: split_complex.channelize_split(
        a, b, cfg.num_subchannels, sample_rate_hz=cfg.sample_rate_hz, taps_per_channel=cfg.taps_per_channel,
    )
    g_re, g_im = padded(g_re), padded(g_im)  # sample t of the stream at hist + t
    span = slice(blk.index * n_l, blk.index * n_l + hist + n_l)
    span_re, span_im = one(g_re[..., span].contiguous(), g_im[..., span].contiguous())
    r["frames_equal_span"] = bool(torch.equal(ch_re, span_re) and torch.equal(ch_im, span_im))
    del span_re, span_im
    one_re, one_im = one(g_re, g_im)
    del g_re, g_im
    f_l = ch_re.shape[-1]
    mine = slice(blk.index * f_l, (blk.index + 1) * f_l)
    r["frames_equal"] = bool(torch.equal(ch_re, one_re[..., mine]) and torch.equal(ch_im, one_im[..., mine]))
    r["frames_max_err"] = max((ch_re - one_re[..., mine]).abs().max().item(),
                              (ch_im - one_im[..., mine]).abs().max().item())
    r["frames_max"] = max(one_re.abs().max().item(), one_im.abs().max().item())
    del one_re, one_im

    # K3, then K2, on this rank's block as the step runs them
    xr, xi, nfft = split_complex.pad_ct(ch_re.movedim(1, 2), ch_im.movedim(1, 2), max_lag=cfg.max_lag)
    rows = (xr.reshape(-1, nfft), xi.reshape(-1, nfft))
    del ch_re, ch_im, xr, xi
    r["nfft"] = nfft
    n_rows = rows[0].shape[0]
    r["held_k3"] = _held(torch, "fft_rows_ct", lambda: fft_rows.fft_rows_ct(*rows),
                         lambda: fft_rows.fft_rows_ct_plain(*rows), [n_rows, nfft], False,
                         _bound(_fft_flops(n_rows, nfft), 2 * 8 * n_rows * nfft))
    fr, fi = (x.view(-1, cfg.num_buoys, nfft) for x in fft_rows.fft_rows_ct(*rows))
    del rows
    i_idx, j_idx = gcc_phat.pair_indices(cfg.num_buoys)
    kw = dict(max_lag=cfg.max_lag, eps=0.05)
    c, pairs, width = fr.shape[0], len(i_idx), 2 * cfg.max_lag + 1
    r["held_k2"] = _held(torch, "gcc_pair_lag_mags", lambda: gcc_pair.gcc_pair_lag_mags(fr, fi, None, i_idx, j_idx, **kw),
                         lambda: gcc_pair.gcc_pair_lag_mags_plain(fr, fi, None, i_idx, j_idx, **kw),
                         list(fr.shape), True,
                         _bound(_pair_flops(c * pairs, nfft, width), fr.numel() * 8 + c * pairs * width * 4))
    del fr, fi
    torch.cuda.empty_cache()
    return r


def _wideband_rank(ctx, reps):
    """Phase 26 on one rank: ``build_wideband_sharded_step`` at config 4
    (``WidebandConfig()``) over a "sub" axis of every rank, against the
    one-device ``step_split`` on the same block (rank 0); K3 and K5 held
    against their plain versions on the rank's subchannels."""
    import numpy as np
    import torch

    from radio_mapper_tpu_torch.models.wideband import (
        WidebandConfig, WidebandTDOAPipeline, build_wideband_sharded_step,
    )
    from radio_mapper_tpu_torch.ops import safe, split_complex
    from radio_mapper_tpu_torch.ops.cuda import fft_rows, gcc_pair
    from radio_mapper_tpu_torch.parallel import mesh as mesh_lib

    cfg = WidebandConfig()
    mesh = mesh_lib.make_mesh((ctx.world_size,), ("sub",), device="cuda")
    ax = mesh_lib.axis(mesh, "sub")
    step, _ = build_wideband_sharded_step(mesh, cfg)
    pipe = WidebandTDOAPipeline(cfg, device=ctx.device)
    args = pipe.example_inputs(seed=0)
    out, r = _path_run(torch, _kernel_counters(), step, args, reps)
    r["finite"] = all(bool(torch.isfinite(x).all()) for x in out[:4])
    if ctx.rank == 0:
        one = pipe.step_split(*args)
        r["vs_one_device"] = {f: (getattr(out, f) - getattr(one, f)).abs().max().item()
                              for f in ("fixes_enu", "cost", "lags", "weights")}
        r["equal_one_device"] = all(torch.equal(getattr(out, f), getattr(one, f))
                                    for f in ("fixes_enu", "cost", "lags", "weights"))
        r["fix_rel"] = ((out.fixes_enu - one.fixes_enu).norm(dim=-1) / one.fixes_enu.norm(dim=-1)).max().item()
        del one

    # K3 and K5 on this rank's subchannels, as the step runs them
    m_loc = cfg.num_subchannels // ax.size
    cre, cim = split_complex.channelize_split(
        args[0], args[1], cfg.num_subchannels, sample_rate_hz=cfg.wide_rate_hz,
        taps_per_channel=cfg.taps_per_channel, shift=False,
    )
    mine = slice(ax.index * m_loc, (ax.index + 1) * m_loc)
    xr, xi, nfft = split_complex.pad_ct(cre.movedim(-2, 0)[mine], cim.movedim(-2, 0)[mine], max_lag=cfg.max_lag)
    rows = (xr.reshape(-1, nfft), xi.reshape(-1, nfft))
    n_rows = rows[0].shape[0]
    r["held_k3"] = _held(torch, "fft_rows_ct", lambda: fft_rows.fft_rows_ct(*rows),
                         lambda: fft_rows.fft_rows_ct_plain(*rows), [n_rows, nfft], False,
                         _bound(_fft_flops(n_rows, nfft), 2 * 8 * n_rows * nfft))
    fr, fi = (x.view(m_loc, cfg.num_buoys, nfft) for x in fft_rows.fft_rows_ct(*rows))
    rmax = (fr * fr + fi * fi).amax(-1)
    s2 = safe.pair_select(rmax, pipe.pair_i) * safe.pair_select(rmax, pipe.pair_j)
    kw = dict(max_lag=cfg.max_lag, eps=cfg.gcc_eps, s2=s2)
    pairs, width = m_loc * cfg.num_pairs, 2 * cfg.max_lag + 1
    r["held_k5"] = _held(
        torch, "gcc_pairs_onehot_lag_mags",
        lambda: gcc_pair.gcc_pairs_onehot_lag_mags(fr, fi, pipe.pair_i_np, pipe.pair_j_np, **kw),
        lambda: gcc_pair.gcc_pairs_onehot_lag_mags_plain(fr, fi, pipe.pair_i_np, pipe.pair_j_np, **kw),
        list(fr.shape), True,
        _bound(_pair_flops(pairs, nfft, width), fr.numel() * 8 + pairs * 4 + pairs * width * 4),
    )
    r["nfft"] = nfft
    torch.cuda.empty_cache()
    return r


def _parallel_rank(ctx, ep_cases, reps):
    """Phases 24, 25 and 26 on one rank of the card, in that order."""
    return {"ep": _ep_rank(ctx, ep_cases, reps), "config5": _config5_rank(ctx, reps),
            "wideband": _wideband_rank(ctx, reps)}


def _grid_scene(sim, side, spacing_deg, seed):
    """A ``side × side`` grid of buoys around the OKC emitter, one
    4096-sample block at 2.048 MS/s, a 500 kHz noise emitter at 25 dB SNR:
    the EP scene of ``tests/test_pair_ep.py``, on a grid that keeps every
    pair's delay inside max_lag 256."""
    buoys = [(f"b{k}", 35.47 - spacing_deg * (side - 1) / 2 + spacing_deg * (k % side),
              -97.51 - spacing_deg * (side - 1) / 2 + spacing_deg * (k // side), 0.0) for k in range(side * side)]
    return sim.synthesize(sim.default_scenario(
        block_len=4096, snr_db=25.0, seed=seed, bandwidth_hz=500e3, buoys=buoys,
        emitter_lat=35.475, emitter_lng=-97.505,
    ))


def _parallel_phases(np, torch, sim, wcfg, tag):
    """Phases 24-26: the multi-device layer (``radio_mapper_tpu_torch/parallel``),
    every path at world size 1 (NCCL) and 2 (two ranks on the one card,
    gloo), each rank in its own process; the CPU ranks of phase 24 are its
    reference. Returns ``parallel(kernel)``: the kernel's launches on these
    paths and its checks in the ranks, for the ``kernels`` line."""
    from radio_mapper_tpu_torch.parallel import launch
    from radio_mapper_tpu_torch.parallel.pair_ep import PairEPConfig

    torch.cuda.empty_cache()
    par_reps = 10
    ep_cfg = PairEPConfig()
    cap64 = _grid_scene(sim, 8, 0.02, seed=11)
    cap256 = _grid_scene(sim, 16, 0.01, seed=12)
    as_case = lambda name, cfg, cap: (name, cfg, cap.iq.real.astype(np.float32), cap.iq.imag.astype(np.float32),
                                      cap.buoy_enu.astype(np.float32))
    ep64 = as_case("ep64", ep_cfg, cap64)
    ep256 = as_case("ep256", dataclasses.replace(ep_cfg, num_buoys=256), cap256)
    t0 = time.perf_counter()
    par = {1: launch.run_ranks(_parallel_rank, 1, device="cuda", args=([ep64], par_reps), timeout_s=600)}
    par[2] = launch.run_ranks(_parallel_rank, 2, device="cuda", args=([ep64, ep256], par_reps), timeout_s=600)
    cpu_ep = launch.run_ranks(_ep_rank, 2, device="cpu", args=([ep64], par_reps, False), timeout_s=600)
    par_s = time.perf_counter() - t0
    backends = {ws: launch.default_backend("cuda", ws) for ws in par}
    print(f"phases 24-26: ranks on the card: world size 1 over {backends[1]}, world size 2 over {backends[2]} "
          f"(two ranks on one card: gloo copies the CUDA tensors of its collectives through host memory "
          f"itself; no collective is staged by the port); 3 launches in {par_s:.1f} s {tag}")
    _require(backends == {1: "nccl", 2: "gloo"}, f"backends {backends}")

    def coll(r):
        return ", ".join(f"{k} {r['coll_calls'][k]} calls {r['coll_ms'][k]:.3f} ms" for k in r["coll_ms"]
                         if r["coll_calls"][k])

    def held(h):
        return (f"{h['name']} {h['shape']}: max|err| {h['max_abs_err']:.3e} (rel {h['rel_err']:.3e}, tol 1e-4"
                f"{', same argmax ' + str(h['same_argmax']) if h['name'] != 'fft_rows_ct' else ''}), kernel "
                f"{h['ms']:.3f} ms, plain {h['plain_ms']:.3f} ms")

    def require_held(h, what):
        _require(h["rel_err"] <= 1e-4 and h["same_argmax"], f"{what}: {h['name']} disagrees with its plain version")

    # ---- phase 24: EP at PairEPConfig() (64 buoys, 2016 pairs, nfft 5120: K3, K5)
    cpu64 = cpu_ep[0]["ep64"]
    _require(np.array_equal(cpu_ep[1]["ep64"]["fix"], cpu64["fix"]), "EP CPU ranks disagree")
    emit64 = cap64.emitter_enu[0]
    for ws, ranks in par.items():
        for rank, rr in enumerate(ranks):
            e = rr["ep"]["ep64"]
            err_m = float(np.linalg.norm(e["fix"][:2] - emit64[:2]))
            gap_cpu = float(np.abs(e["fix"] - cpu64["fix"]).max())
            gap_ws = float(np.abs(e["fix"] - par[1][0]["ep"]["ep64"]["fix"]).max())
            p = e["pairs"]
            lag_gap = float(np.abs(e["lags"][:p] - cpu64["lags"][:p]).max())
            print(
                f"phase 24: EP world size {ws} rank {rank}, {ep_cfg.num_buoys} buoys x {ep_cfg.block_len} samples, "
                f"{p} pairs ({len(e['lags']) // ws} a rank), nfft {e['nfft']}: fix error {err_m:.3f} m (limit 100), "
                f"card vs CPU ranks: fix {gap_cpu:.3e} m (tol 0.5), lags {lag_gap:.3e} samples (tol 1e-3); "
                f"world size {ws} vs 1: fix {gap_ws:.3e} m (tol 0.5); {e['ms']:.3f} ms/block, "
                f"{p / e['ms'] * 1e3:.4e} pair correlations/s, peak mem {e['peak_gib']:.2f} GiB, launches "
                f"{e['launches']}, collectives (CUDA events, one block): {coll(e)}; held on this rank's slice: "
                f"{held(e['held'])} {tag}"
            )
            _require(err_m < 100.0 and gap_cpu <= 0.5 and lag_gap <= 1e-3 and gap_ws <= 0.5, "EP fix")
            _require(e["launches"] == {"fft_rows_ct": 1, "gcc_pairs_onehot_lag_mags": 1}, f"EP launches {e['launches']}")
            require_held(e["held"], "EP")
            _require(np.array_equal(e["fix"], ranks[0]["ep"]["ep64"]["fix"]), "EP ranks hold different fixes")
    emit256 = cap256.emitter_enu[0]
    for rank, rr in enumerate(par[2]):
        e = rr["ep"]["ep256"]
        err_m = float(np.linalg.norm(e["fix"][:2] - emit256[:2]))
        print(
            f"phase 24: EP world size 2 rank {rank}, 256 buoys x {ep_cfg.block_len} samples, {e['pairs']} pairs "
            f"({len(e['lags']) // 2} a rank; the B spectra exceed K5's 8 MB gate: K6): fix error {err_m:.3f} m "
            f"(limit 100); {e['ms']:.3f} ms/block, {e['pairs'] / e['ms'] * 1e3:.4e} pair correlations/s, peak mem "
            f"{e['peak_gib']:.2f} GiB, launches {e['launches']}, collectives: {coll(e)}; held on this rank's "
            f"slice: {held(e['held'])} {tag}"
        )
        _require(err_m < 100.0, f"EP 256 fix error {err_m}")
        _require(e["launches"] == {"fft_rows_ct": 1, "gcc_rows_lag_mags": 1}, f"EP 256 launches {e['launches']}")
        require_held(e["held"], "EP 256")
        _require(np.array_equal(e["fix"], par[2][0]["ep"]["ep256"]["fix"]), "EP 256 ranks hold different fixes")

    # ---- phase 25: config 5, 256 ch x 8 buoys x 32768 samples a step (K3, K2)
    c5_real = 1e3 * 32_768 / 2_400_000.0
    for ws, ranks in par.items():
        for rank, rr in enumerate(ranks):
            c = rr["config5"]
            print(
                f"phase 25: config 5 on a (1, {ws}) mesh, rank {rank}: 256 ch x 8 buoys x {32_768 // ws} samples "
                f"(nfft {c['nfft']}), fixes {c['fix_shape']}: {c['ms']:.3f} ms/step (real-time budget "
                f"{c5_real:.3f}, ratio {c['ms'] / c5_real:.3f}), peak mem {c['peak_gib']:.2f} GiB, launches "
                f"{c['launches']}, collectives: {coll(c) or 'none'}; frames vs the one-rank channelizer on the "
                f"rank's span of the stream: equal bit for bit {c['frames_equal_span']}; on the whole stream: "
                f"equal bit for bit {c['frames_equal']}, max|err| {c['frames_max_err']:.3e} (tol 1e-6 of the "
                f"largest frame, {c['frames_max']:.3e}); held on this rank's block: "
                f"{held(c['held_k3'])}; {held(c['held_k2'])} {tag}"
            )
            _require(c["finite"] and c["fix_shape"] == [ws, 256, 16, 3], "config 5 outputs")
            _require(c["frames_equal_span"], "config 5: the halo did not deliver the left neighbour's history")
            _require(c["frames_max_err"] <= 1e-6 * c["frames_max"], "config 5: the frames differ from the whole stream's")
            _require(c["launches"] == {"fft_rows_ct": 1, "gcc_pair_lag_mags": 1, LM: 1}, f"config 5 launches {c['launches']}")
            require_held(c["held_k3"], "config 5")
            require_held(c["held_k2"], "config 5")

    # ---- phase 26: config 4 with subchannels over "sub" (K3, K5)
    w_real = 1e3 * wcfg.wide_block / wcfg.wide_rate_hz
    for ws, ranks in par.items():
        for rank, rr in enumerate(ranks):
            w = rr["wideband"]
            one = (f"vs the one-device step_split on the same block: equal {w['equal_one_device']}, max|diff| "
                   + ", ".join(f"{k} {v:.3e}" for k, v in w["vs_one_device"].items())
                   + f" (fixes: {w['fix_rel']:.3e} of |fix|; the example block is noise); ") if rank == 0 else ""
            print(
                f"phase 26: sharded wideband, world size {ws} rank {rank}: {wcfg.num_subchannels // ws} of "
                f"{wcfg.num_subchannels} subchannels, {wcfg.num_buoys} buoys, nfft {w['nfft']}: {w['ms']:.3f} ms/block (real "
                f"time {w_real:.3f}), peak mem {w['peak_gib']:.2f} GiB, launches {w['launches']}, collectives: "
                f"{coll(w)}; {one}held on this rank's subchannels: {held(w['held_k3'])}; {held(w['held_k5'])} {tag}"
            )
            _require(w["finite"], "sharded wideband outputs")
            _require(w["launches"] == {"fft_rows_ct": 1, "gcc_pairs_onehot_lag_mags": 1, LM: 1}, f"wideband launches {w['launches']}")
            require_held(w["held_k3"], "sharded wideband")
            require_held(w["held_k5"], "sharded wideband")
            if rank == 0:
                d = w["vs_one_device"]
                _require(d["lags"] <= 1e-3 and d["weights"] <= 1e-3, f"sharded wideband vs step_split {d}")

    def par_launches(kernel):
        """This kernel's launches on each multi-rank path, by path, world size and rank."""
        return {f"{path} ws{ws} rank{rank}": r["launches"].get(kernel, 0)
                for ws, ranks in par.items() for rank, rr in enumerate(ranks)
                for path, r in (*rr["ep"].items(), ("config5", rr["config5"]), ("wideband", rr["wideband"]))}

    def par_rows(kernel):
        """The rank-side checks of this kernel against its plain version."""
        out = []
        for ws, ranks in par.items():
            for rank, rr in enumerate(ranks):
                for path, r in (*rr["ep"].items(), ("config5", rr["config5"]), ("wideband", rr["wideband"])):
                    for h in (r.get("held"), r.get("held_k3"), r.get("held_k2"), r.get("held_k5")):
                        if h is not None and h["name"] == kernel:
                            out.append({"path": f"{path} ws{ws} rank{rank}",
                                        **{k: v for k, v in h.items() if k != "name"}})
        return out

    def parallel(kernel):
        return {"launches": par_launches(kernel), "rank_rows": par_rows(kernel)}

    return parallel


def _wideband_fallback_phase(np, torch, sim, dev, tag, counters, wcfg, blocks):
    """Phase 27 (fault F4): config 4 at full width under
    ``set_gcc_fused("off")``, the reference's natural-grid fallback (nfft
    4320: the matmul four-step, no kernel). Returns its facts."""
    from radio_mapper_tpu_torch.models.wideband import WidebandConfig, WidebandTDOAPipeline
    from radio_mapper_tpu_torch.ops import fft as fft_ops
    from radio_mapper_tpu_torch.ops import split_complex

    split_complex.set_gcc_fused("off")
    try:
        wpipe = WidebandTDOAPipeline(wcfg, device=dev)
        _require(not wpipe.use_fused and wpipe.pair_nfft == fft_ops.friendly_fft_len(wcfg.sub_block + wcfg.max_lag),
                 "config 4 under 'off' takes the fallback at the 5-smooth nfft (4320)")
        m_sub, wb, wp = wcfg.num_subchannels, wcfg.num_buoys, wcfg.num_pairs
        wblocks = [wpipe.example_inputs(seed=k) for k in range(blocks)]
        wpipe.step_split(*wblocks[0])  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        _zero_counts(counters)
        t0 = time.perf_counter()
        outs = [wpipe.step_split(*blk) for blk in wblocks]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k: v for k, v in _read_counts(counters).items() if v}
        ok = all(torch.isfinite(x).all().item() for o in outs for x in o[:4]) and all(
            tuple(o.lags.shape) == (m_sub, wp) for o in outs)
        mem = torch.cuda.max_memory_allocated(dev) / 2**30
        med = _stage_split(torch, lambda mark: wpipe.step_split(*wblocks[0], on_stage=mark),
                           ["channelize", "fft", "s2", "pair", "lag_peaks", "solve"])
        del wblocks, outs
        ms_block = 1e3 * wall / blocks
        print(
            f"phase 27: config 4 under set_gcc_fused('off') (natural-grid fallback, nfft {wpipe.pair_nfft}), {blocks} "
            f"blocks x {wb} buoys x {wcfg.wide_block} samples -> {m_sub} subchannels x {wp} pairs: {ms_block:.3f} "
            f"ms/block (real time {1e3 * wcfg.wide_block / wcfg.wide_rate_hz:.3f}), {blocks * m_sub * wp / wall:.4e} "
            f"pair correlations/s, peak mem {mem:.2f} GiB, launches {counts}, finite+shapes {ok}; stage split "
            f"(median of 3, CUDA events): channelize {med['channelize']:.3f}, spectra {med['fft']:.3f}, pair "
            f"{med['pair']:.3f}, lag peaks {med['lag_peaks']:.3f}, solve {med['solve']:.3f} {tag}"
        )
        _require(ok, "non-finite or misshapen fallback outputs")
        _require(counts == {LM: blocks}, f"the fallback launched kernels but the LM's: {counts}")

        sub, ring, emitter = 5, _ring(np, wb, 12_000.0), np.array([2_000.0, -3_000.0, 0.0])
        sre, sim_ = sim.synthesize_wideband(wcfg, active_subchannel=sub, anchors_enu=ring, emitter_enu=emitter,
                                            snr_db=25.0, seed=0)
        on = wpipe.step_split(*(torch.from_numpy(a).to(dev) for a in (sre, sim_, ring)))
        err_m = float(np.linalg.norm(on.fixes_enu[sub, :2].cpu().numpy() - emitter[:2]))
        w = on.weights.cpu().numpy()
        quiet = (sub + m_sub // 2) % m_sub
        scfg = WidebandConfig(num_buoys=8, wide_rate_hz=4_096_000.0, num_subchannels=8,
                              sub_block=1024, max_lag=64, solver_iterations=20)
        sring = _ring(np, scfg.num_buoys, 9_000.0)
        shost = [torch.from_numpy(a) for a in (*sim.synthesize_wideband(
            scfg, active_subchannel=3, anchors_enu=sring, emitter_enu=np.array([1_500.0, -2_200.0, 0.0]),
            snr_db=25.0, seed=1), sring)]
        s_card = WidebandTDOAPipeline(scfg, device=dev).step_split(*(a.to(dev) for a in shost))
        s_cpu = WidebandTDOAPipeline(scfg, device="cpu").step_split(*shost)
        s_lag = (s_card.lags[3].cpu() - s_cpu.lags[3]).abs().max().item()
        s_fix = (s_card.fixes_enu[3].cpu() - s_cpu.fixes_enu[3]).abs().max().item()
        print(
            f"phase 27: phase-8 scene under 'off': active subchannel {sub} fix error {err_m:.3f} m (limit 300), mean "
            f"weight {w[sub].mean():.4f} vs quiet {w[quiet].mean():.4f}; small config card vs CPU under 'off': lags "
            f"{s_lag:.3e} samples (tol 1e-3), fix {s_fix:.3e} m (tol 0.5) {tag}"
        )
        _require(err_m < 300.0, f"fallback wideband fix error {err_m} m")
        _require(s_lag <= 1e-3 and s_fix <= 0.5, "fallback wideband: card and CPU disagree")
    finally:
        split_complex.set_gcc_fused("auto")
    return {"ms_block": ms_block, "launches": counts}


def _ingest_phase(np, torch, dev, tag, counters, wide=128, narrow=32, n=16_384):
    """Phase 28: the ingest loop (``ingest.runner.IngestLoop``) over the
    native ring at the flagship's width (``wide`` channels; the paced legs
    also at ``narrow``). Returns the kernel launches of its deterministic
    run and the legs' numbers."""
    from radio_mapper_tpu_torch.ingest import runner
    from radio_mapper_tpu_torch.ingest.native import NativeIngest
    from radio_mapper_tpu_torch.models.pipeline import PipelineConfig, TDOAPipeline
    from radio_mapper_tpu_torch.ops import iq

    fs, lag, buoys = 2_400_000.0, 512, 8
    ms = lambda v: "n/a" if v is None else f"{v:.3f}"
    pipe = TDOAPipeline(PipelineConfig(num_buoys=buoys, block_len=n, sample_rate_hz=fs, max_lag=lag), device=dev)
    rng = np.random.default_rng(0)
    anchors_np = rng.normal(scale=8_000.0, size=(buoys, 3)).astype(np.float32)
    anchors_np[:, 2] = 0.0
    anchors = lambda ch: torch.from_numpy(np.broadcast_to(anchors_np, (ch, buoys, 3)).copy()).to(dev)

    # 28.1: an unpaced deterministic ring (the first ring_bytes are the seed's stream) through the loop
    chans, steps, seed = wide, 8, 7
    block_bytes = chans * buoys * 2 * n
    ring_bytes = 1 << (steps * block_bytes - 1).bit_length()
    loop = runner.IngestLoop.from_pipeline(pipe, None, channels=chans, anchors=anchors(chans))
    outs, step = [], loop.step
    loop.step = lambda raw, a: outs.append(step(raw, a)) or outs[-1]
    loop.warm_compile()
    outs.clear()
    ing = NativeIngest.open_synthetic(seed, ring_bytes=ring_bytes)
    loop.ingest = ing
    try:
        _zero_counts(counters)
        stats = loop.run(steps, warmup_steps=0)
        launches = {k: v for k, v in _read_counts(counters).items() if v}
    finally:
        ing.close()
    again = NativeIngest.open_synthetic(seed, ring_bytes=ring_bytes)
    try:
        buf = np.empty(block_bytes, np.uint8)
        for _ in range(steps):
            got, _ = again.read_into(buf, 60_000)
            _require(got == block_bytes, "replay ring underrun")
    finally:
        again.close()
    direct = pipe.step_split_uint8(torch.from_numpy(buf.reshape(chans, buoys, 2 * n)).to(dev), anchors(chans))
    last = outs[-1]
    fix_gap = (last.fix.position_enu - direct.fix.position_enu).abs().max().item()
    lag_gap = (last.correlation.lag_samples - direct.correlation.lag_samples).abs().max().item()
    bit_equal = all(torch.equal(a, b) for a, b in zip(_leaves(torch, last), _leaves(torch, direct)))
    per_step = {k: v / steps for k, v in launches.items()}
    print(
        f"phase 28: IngestLoop, unpaced synthetic ring (seed {seed}, {ring_bytes >> 20} MiB) -> {steps} steps of "
        f"{chans} ch x {buoys} buoys x {n} uint8 IQ: last output vs step_split_uint8 on the same bytes: fixes "
        f"{fix_gap:.3e} m (tol 1e-3), lags {lag_gap:.3e} samples (tol 1e-4), bit for bit {bit_equal}; launches a "
        f"step {per_step}; {stats.sustained_samples_per_s:.4e} IQ samples/s, {1e3 * stats.elapsed_s / steps:.3f} "
        f"ms/step, host read {stats.host_read_ms_per_step:.3f} ms, copy issue {stats.transfer_ms_per_step:.3f} ms, "
        f"copy (CUDA events) {ms(loop.copy_ms_per_step())} ms a step; consumed {stats.bytes_consumed} B {tag}"
    )
    _require(fix_gap <= 1e-3 and lag_gap <= 1e-4, "the loop's output differs from the direct step on its bytes")
    _require(launches == {"fft_detect_rows_ct": steps, "gcc_pair_lag_mags": steps, LM: steps},
             f"loop launches {launches}")
    _require(stats.bytes_consumed == steps * block_bytes, "loop byte accounting")
    del outs, last, direct, loop
    torch.cuda.empty_cache()

    # 28.2: the paced ring at real time, bench.py run_ingest_bench's settings
    legs = []
    for chans, bpd, steps in ((narrow, 1, 30), (narrow, 4, 8), (wide, 1, 30), (wide, 4, 8)):
        rate = chans * buoys * fs
        loop = runner.IngestLoop.from_pipeline(pipe, None, channels=chans, anchors=anchors(chans),
                                               blocks_per_dispatch=bpd, source_samples_per_s=rate)
        loop.warm_compile()
        ring = 1 << max(24, (loop.block_bytes * 8).bit_length())
        ing = NativeIngest.open_synthetic_paced(1, bytes_per_s=2.0 * rate, ring_bytes=ring)
        loop.ingest = ing
        try:
            st = loop.run(steps, warmup_steps=0)
            ring_st = ing.stats()
        finally:
            ing.close()
        copy_ms = loop.copy_ms_per_step()
        print(
            f"phase 28: paced ring at real time ({2.0 * rate / 1e9:.3f} GB/s, ring {ring >> 20} MiB), {chans} ch x "
            f"{buoys} buoys x {n}, blocks_per_dispatch {bpd}, {steps} steps: {st.sustained_samples_per_s:.4e} IQ "
            f"samples/s, real_time_ratio {st.real_time_ratio:.4f}, {1e3 * st.elapsed_s / steps:.3f} ms/step, host read "
            f"{st.host_read_ms_per_step:.3f} ms, copy issue {st.transfer_ms_per_step:.3f} ms, copy (CUDA events) "
            f"{ms(copy_ms)} ms a step; dropped {st.dropped_bytes} B, consumed {st.bytes_consumed} B, written "
            f"{ring_st['bytes_written']} B {tag}"
        )
        _require(st.bytes_consumed == steps * loop.block_bytes and ring_st["error"] == 0
                 and ring_st["bytes_written"] >= st.bytes_consumed, "paced ring accounting")
        legs.append({"channels": chans, "blocks_per_dispatch": bpd, "real_time_ratio": st.real_time_ratio,
                     "dropped_bytes": st.dropped_bytes, "copy_ms": copy_ms})
        del loop
        torch.cuda.empty_cache()

    # 28.3: the loopback leg: paced ring -> pinned slot -> copy -> decode + a sparse reduce on the card
    chans, steps = narrow, 60
    rate = chans * buoys * fs

    def consume(raw, _anchors):
        re, im = iq.decode_uint8_split(raw)
        return re[..., ::4097].sum() + im[..., ::4097].sum()

    loop = runner.IngestLoop(consume, None, channels=chans, num_buoys=buoys, block_len=n,
                             anchors=anchors(1), source_samples_per_s=rate, device=dev, drain_threads=4)
    loop.warm_compile()
    ring = 1 << max(24, (loop.block_bytes * 32).bit_length())
    ing = NativeIngest.open_synthetic_paced(2, bytes_per_s=2.0 * rate, ring_bytes=ring, chunk_bytes=1 << 18)
    loop.ingest = ing
    try:
        st = loop.run(steps, warmup_steps=0)
    finally:
        ing.close()
    print(
        f"phase 28: loopback leg ({chans} ch, paced ring -> pinned slot, 4-thread drain -> copy -> decode + sparse "
        f"reduce on the card), {steps} steps: real_time_ratio {st.real_time_ratio:.4f}, host read "
        f"{st.host_read_ms_per_step:.3f} ms, copy issue {st.transfer_ms_per_step:.3f} ms, copy (CUDA events) "
        f"{ms(loop.copy_ms_per_step())} ms a step; dropped {st.dropped_bytes} B, consumed {st.bytes_consumed} B {tag}"
    )
    _require(st.bytes_consumed == steps * loop.block_bytes, "loopback accounting")
    legs.append({"channels": chans, "loopback": True, "real_time_ratio": st.real_time_ratio,
                 "dropped_bytes": st.dropped_bytes})
    return {"launches": launches, "steps": steps, "legs": legs}


def _buoy_phase(np, torch, sim, dev, tag, counters):
    """Phase 29: ``runtime.buoy.simulated_buoy`` on the card against a CPU
    ``BuoyNode`` on the same samples. Returns K7's launches a dwell."""
    import asyncio

    from radio_mapper_tpu_torch import constants
    from radio_mapper_tpu_torch.runtime import buoy

    scen = sim.default_scenario(signal="fm", bandwidth_hz=16e3, freq_offset_hz=150e3, snr_db=25.0, seed=5,
                                block_len=16_384)
    node = buoy.simulated_buoy(scen, 0, device=dev)
    node.gps.initialize()
    node.schedule = (constants.ScheduleEntry(scen.center_frequency_mhz, 35.0, "emergency"),)  # on channel
    seen, read = [], node.source.read
    node.source.read = lambda k: seen.append(read(k)) or seen[-1]
    asyncio.run(node.scan_once())  # warm-up: the kernels' first launch
    torch.cuda.synchronize()
    _zero_counts(counters)
    dets = asyncio.run(node.scan_once())
    torch.cuda.synchronize()
    launches = {k: v for k, v in _read_counts(counters).items() if v}
    iq_block = seen[-1]
    center = scen.center_frequency_mhz * 1e6
    cpu = buoy.BuoyNode(node.config, source=node.source, gps=node.gps, device="cpu")
    ref = cpu.detect_block(iq_block, center)
    same = len(dets) == len(ref) and all(
        (a.frequency_mhz, a.confidence, a.signal_type) == (b.frequency_mhz, b.confidence, b.signal_type)
        for a, b in zip(dets, ref))
    same_bw = bool(np.array_equal(node.last_bandwidths_hz, cpu.last_bandwidths_hz))
    to = lambda a, where: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(where)
    gp, _ = node._detector()(to(iq_block.real, dev), to(iq_block.imag, dev))
    cp, _ = cpu._detector()(to(iq_block.real, "cpu"), to(iq_block.imag, "cpu"))
    valid = cp.valid.numpy()
    same_valid = bool(np.array_equal(gp.valid.cpu().numpy(), valid))
    pw_gap = float(np.abs(gp.power_db.cpu().numpy()[valid] - cp.power_db.numpy()[valid]).max()) if valid.any() else 0.0
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        node.detect_block(iq_block, center)
        times.append(1e3 * (time.perf_counter() - t0))
    detect_ms = statistics.median(times)
    # waveform search over the node's history, on the card and on the CPU
    cpu.signal_history.extend(node.signal_history)
    cpu.snippet_history.extend(node.snippet_history)
    pattern = np.roll(node.snippet_history[-1][1], 11) * np.exp(0.7j)
    g_match, c_match = node.match_signal_pattern(pattern, min_score=0.0), cpu.match_signal_pattern(pattern, min_score=0.0)
    score_gap = max(abs(a[1] - b[1]) for a, b in zip(g_match, c_match))
    same_lags = [a[2] for a in g_match] == [b[2] for b in c_match]
    print(
        f"phase 29: simulated buoy on the card, scan_once on {scen.center_frequency_mhz} MHz ({len(dets)} detections, "
        f"strongest {dets[0].frequency_mhz if dets else None} MHz): vs a CPU BuoyNode on the same samples: detections "
        f"equal {same}, bandwidths equal {same_bw}, peaks valid equal {same_valid}, power {pw_gap:.3e} dB (tol 1e-3); "
        f"launches a dwell {launches}; detect_block {detect_ms:.3f} ms a dwell; match_signal_pattern over "
        f"{len(g_match)} snippets: scores {score_gap:.3e} apart (tol 1e-5), lags equal {same_lags} {tag}"
    )
    _require(dets and same and same_bw and same_valid and pw_gap <= 1e-3, "buoy: card and CPU disagree")
    _require(launches == {"fft_rows": 1}, f"buoy dwell launches {launches}")
    _require(g_match and score_gap <= 1e-5 and same_lags, "buoy pattern match: card and CPU disagree")
    return {"launches": launches, "detect_ms": detect_ms}


def _demod_phase(np, torch, dev, tag, counters):
    """Phase 30: ``watch_demod_block`` on 8 watch channels of one 2.4 MS/s
    capture, 20 blocks of the CLI's 0.1 s dwell in nbfm, wbfm and am, and
    the CLI's single-channel wbfm for 2 s at 1.024 MS/s; card against CPU."""
    from radio_mapper_tpu_torch import cli, sim
    from radio_mapper_tpu_torch.ingest import SimulatedSource
    from radio_mapper_tpu_torch.ops import demod

    fs, blocks = 2_400_000.0, 20
    factor, audio_factor, block = cli.watch_block_plan(fs, 256_000.0, 32_000.0, 0.1)
    offsets = tuple(250e3 * (k - 3.5) for k in range(8))  # −875 … +875 kHz
    n = blocks * block
    t = np.arange(n) / fs
    rng = np.random.default_rng(30)

    def fm(dev_hz, msg_hz):
        return np.exp(2j * np.pi * dev_hz * np.cumsum(np.sin(2 * np.pi * msg_hz * t)) / fs)

    iq = (fm(5e3, 700.0) * np.exp(2j * np.pi * offsets[0] * t)  # narrowband FM
          + 0.8 * fm(60e3, 1000.0) * np.exp(2j * np.pi * offsets[2] * t)  # broadcast-style FM
          + 0.7 * (1 + 0.5 * np.sin(2 * np.pi * 600.0 * t)) * np.exp(2j * np.pi * (offsets[3] + 1.5e3) * t)  # AM
          + 0.5 * fm(3e3, 400.0) * np.exp(2j * np.pi * offsets[5] * t)
          + 0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))).astype(np.complex64)
    del t
    kw = dict(sample_rate_hz=fs, offsets_hz=offsets, channel_rate_hz=fs / factor,
              audio_rate_hz=fs / factor / audio_factor, squelch_threshold=0.01)
    host = lambda k: iq[k * block:(k + 1) * block]
    real_ms = 1e3 * block / fs
    checked = 5  # blocks held against the CPU a mode
    _zero_counts(counters)
    for mode in ("nbfm", "wbfm", "am"):
        step = lambda x, mode=mode: demod.watch_demod_block(x, mode=mode, **kw)
        step(torch.from_numpy(host(0)).to(dev))  # warm-up: tables built, cached on the card
        torch.cuda.synchronize()
        outs, opens, times = [], [], []
        for k in range(blocks):  # as the CLI's loop: block up, demodulate, audio down
            t0 = time.perf_counter()
            audio, open_ = step(torch.from_numpy(host(k)).to(dev))
            outs.append(audio.cpu().numpy())
            opens.append(open_.cpu().numpy())
            times.append(1e3 * (time.perf_counter() - t0))
        xd = torch.from_numpy(host(0)).to(dev)
        dev_ms = _cuda_ms(torch, lambda: step(xd))
        err, same_open = 0.0, True
        for k in range(checked):
            ca, co = step(torch.from_numpy(host(k)))
            same_open &= bool(np.array_equal(co.numpy(), opens[k]))
            err = max(err, float(np.abs(outs[k] - ca.numpy()).max() / max(np.abs(ca.numpy()).max(), 1e-30)))
        wall_ms = statistics.median(times)
        print(
            f"phase 30: watch {mode}, 8 channels 250 kHz apart from one {fs / 1e6:.1f} MS/s capture, {blocks} blocks "
            f"of {block} samples (factor {factor} x {audio_factor}, audio [8, {outs[0].shape[-1]}]): {wall_ms:.3f} ms "
            f"a block with its copies (real time {real_ms:.3f}, ratio {wall_ms / real_ms:.4f}), {dev_ms:.3f} ms on the "
            f"card (CUDA events); open {opens[0].astype(int).tolist()}; card vs CPU over {checked} blocks: open "
            f"masks equal {same_open}, audio {err:.3e} of the CPU's max (tol 1e-4) {tag}"
        )
        _require(same_open and err <= 1e-4, f"watch {mode}: card and CPU disagree")
        _require(opens[0].tolist() == [True, False, True, True, False, True, False, False],
                 f"watch {mode}: squelch {opens[0].tolist()}")
    # the CLI's single-channel wbfm: `demod --source sim` defaults, 2 s at 1.024 MS/s
    src = SimulatedSource(sim.default_scenario(signal="fm", bandwidth_hz=150e3), 0)
    src.tune(src.scenario.center_frequency_mhz * 1e6)
    x = src.read(int(2.0 * 1_024_000.0))
    one = lambda where: cli._demod_audio(x, "wbfm", 1_024_000.0, 32_000.0, where)
    one(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    a = one(dev).cpu().numpy()
    one_ms = 1e3 * (time.perf_counter() - t0)
    xd = torch.from_numpy(x).to(dev)
    one_dev_ms = _cuda_ms(torch, lambda: cli._demod_audio(xd, "wbfm", 1_024_000.0, 32_000.0, dev))
    c = one("cpu").numpy()
    one_err = float(np.abs(a - c).max() / np.abs(c).max())
    launches = {k: v for k, v in _read_counts(counters).items() if v}
    print(
        f"phase 30: wbfm, one channel, {x.size} samples (2 s at 1.024 MS/s) -> {a.size} audio samples: {one_ms:.3f} ms "
        f"with its copies, {one_dev_ms:.3f} ms on the card (CUDA events); card vs CPU {one_err:.3e} of the max (tol "
        f"1e-4); kernel launches in phase 30 {launches} (none: elementwise, the FIR and the recurrence) {tag}"
    )
    _require(one_err <= 1e-4 and np.isfinite(a).all() and a.size == 64_000, "wbfm: card and CPU disagree")


def _adsb_phase(np, torch, dev, tag):
    """Phase 31: ``detect_frames`` on 64 blocks of 2^18 samples at 2 MS/s
    (the CLI's read), planted encoder frames and noise-only blocks; card
    against CPU and the decoded frames against the planted ones."""
    from radio_mapper_tpu_torch.ops import adsb

    rows, n = 64, 1 << 18
    rng = np.random.default_rng(31)
    x = ((rng.standard_normal((rows, n), np.float32) + 1j * rng.standard_normal((rows, n), np.float32))
         * 0.05).astype(np.complex64)
    good, bad = [set() for _ in range(rows)], [set() for _ in range(rows)]
    for r in range(48):  # rows 48-63 carry noise only
        starts = np.sort(rng.choice(np.arange(1_000, n - 1_000, 1_000), 1 + r % 3, replace=False))
        for j, s in enumerate(starts):
            full = adsb.append_crc("8d" + bytes(rng.integers(0, 256, 10, dtype=np.uint8)).hex())
            if (r + j) % 5 == 4:  # a corrupted frame: one byte of its payload flipped
                b = bytearray(bytes.fromhex(full))
                b[4] ^= 0x21
                full = b.hex()
                bad[r].add(f"*{full};")
            else:
                good[r].add(f"*{full};")
            w = adsb.encode_frame_iq(full, noise=0.0, pad_before=0, pad_after=0)
            x[r, s:s + w.size] += w
    xd = torch.from_numpy(x).to(dev)
    card = adsb.detect_frames(xd)
    torch.cuda.synchronize()
    cpu = adsb.detect_frames(torch.from_numpy(x))
    same = all(torch.equal(getattr(card, f).cpu(), getattr(cpu, f)) for f in ("start_index", "valid", "bits"))
    scale = cpu.score.abs().amax(-1, keepdim=True).clamp_min(1e-30)
    score_rel = ((card.score.cpu() - cpu.score).abs() / scale).max().item()

    def decode():
        c = adsb.detect_frames(xd)
        packed = torch.cat([c.valid.to(torch.uint8).unsqueeze(-1), c.bits], dim=-1).cpu().numpy()
        return packed[..., 0].astype(bool), packed[..., 1:]

    valid, bits = decode()
    strict = [set(adsb.frames_hex(valid[r], bits[r])) for r in range(rows)]
    loose = [set(adsb.frames_hex(valid[r], bits[r], require_crc=False)) for r in range(rows)]
    decoded_ok = strict == good and all(bad[r] <= loose[r] for r in range(rows))
    det_ms = _cuda_ms(torch, lambda: adsb.detect_frames(xd))
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        decode()
        times.append(1e3 * (time.perf_counter() - t0))
    wall = statistics.median(times)
    planted = sum(map(len, good)) + sum(map(len, bad))
    print(
        f"phase 31: ADS-B detect_frames on [{rows}, {n}] (2 MS/s, {1e3 * n / 2e6:.3f} ms a block), {planted} planted "
        f"frames ({sum(map(len, bad))} with a bad CRC), 16 noise-only blocks: card vs CPU starts/valid/bits equal "
        f"{same}, scores {score_rel:.3e} rel (tol 1e-5); decoded = planted (CRC on), bad frames seen with the CRC "
        f"off: {decoded_ok}; {det_ms / rows:.4f} ms a block on the card (CUDA events), {wall / rows:.4f} ms a block "
        f"with the candidates' copy to the host {tag}"
    )
    _require(same and score_rel <= 1e-5, "adsb: card and CPU candidates differ")
    _require(decoded_ok, "adsb: decoded frames differ from the planted ones")


def _scan_phase(np, torch, sim, dev, tag, counters):
    """Phase 32: ``run_scan`` on the tone scene over 88-108 MHz at 10 kHz
    bins (nfft 256) and one hop at 125 Hz bins (nfft 16384, K7), card vs
    CPU. Returns K7's launches on the 125 Hz hop."""
    from radio_mapper_tpu_torch.ingest import SimulatedSource
    from radio_mapper_tpu_torch.tools import power_scan

    src = lambda: SimulatedSource(sim.default_scenario(signal="tone"), 0)
    out = {}
    for name, lo, hi, bin_hz in (("coarse", 88e6, 108e6, 10_000.0), ("fine", 120.9e6, 121.1e6, 125.0)):
        plan = power_scan.plan_scan(lo, hi, bin_hz=bin_hz)
        if name == "fine":
            power_scan.run_scan(src(), plan, device=dev)  # warm-up: K7's first launch
        torch.cuda.synchronize()
        _zero_counts(counters)
        t0 = time.perf_counter()
        res = power_scan.run_scan(src(), plan, device=dev)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0) / len(plan.hops)
        launches = {k: v for k, v in _read_counts(counters).items() if v}
        ref = power_scan.run_scan(src(), plan, device="cpu")
        db = np.concatenate(res.power_db)
        rdb = np.concatenate(ref.power_db)
        db_gap = float(np.abs(db - rdb).max())
        iq = src().read(res.samples_per_hop)
        xd = torch.from_numpy(iq).to(dev)
        psd_ms = _cuda_ms(torch, lambda: power_scan.welch_psd_db(xd, nfft=plan.nfft, window="hamming"))
        print(
            f"phase 32: scan {lo / 1e6:.1f}-{hi / 1e6:.1f} MHz at {plan.bin_hz:.2f} Hz bins: nfft {plan.nfft}, "
            f"{len(plan.hops)} hops of {res.samples_per_hop} samples, {len(db)} bins; {wall:.3f} ms a hop with the "
            f"source and the copies, {psd_ms:.3f} ms a hop's PSD on the card (CUDA events); card vs CPU "
            f"{db_gap:.3e} dB (tol 1e-3, every bin); peak {rdb.max() - np.median(rdb):.1f} dB over the median; "
            f"launches {launches} {tag}"
        )
        _require(db_gap <= 1e-3 and np.isfinite(db).all(), f"scan {name}: card and CPU differ")
        out[name] = launches
    _require(not out["coarse"], f"scan at nfft 256 launched {out['coarse']}")
    _require(out["fine"].get("fft_rows", 0) >= 1, f"scan at nfft 16384: K7 not launched ({out['fine']})")
    return out["fine"].get("fft_rows", 0)


def _central_phase(np, torch, sim, dev, tag, counters):
    """Phase 33: ``CentralProcessor(device="cuda")`` fed the wire messages
    of 8 simulated buoys over 16 frequency groups (2048-sample u8
    snippets), no socket opened; against the engine called directly and
    against the CPU."""
    import asyncio

    from radio_mapper_tpu_torch import geo
    from radio_mapper_tpu_torch.runtime import alerts, central, datamodel
    from radio_mapper_tpu_torch.runtime.tdoa_engine import TDoAEngine

    lat0, lng0, fs, t0_ns = 35.47, -97.51, 2_048_000.0, 1_700_000_000_000_000_000
    ang = 2 * np.pi * np.arange(8) / 8
    buoys = [(f"buoy-{k}", lat0 + 0.07 * np.sin(a), lng0 + 0.09 * np.cos(a), 10.0) for k, a in enumerate(ang)]
    clock_ns = [int(v) for v in np.random.default_rng(33).integers(-120_000, 120_000, 8)]
    now = datamodel.utc_now_iso()
    regs = [{"type": "node_registration", "node_id": b[0], "lat": b[1], "lng": b[2], "timing_accuracy_ns": 100_000}
            for b in buoys]
    dets, emitters = [], []
    for g in range(16):
        elat, elng = lat0 + 0.03 * np.cos(g), lng0 + 0.03 * np.sin(1.7 * g)
        scen = sim.default_scenario(emitter_lat=elat, emitter_lng=elng, signal="noise", bandwidth_hz=150e3,
                                    snr_db=20.0, seed=100 + g, sample_rate_hz=fs, block_len=2048, buoys=buoys)
        cap = sim.synthesize(scen)
        emitters.append((elat, elng))
        anchor = t0_ns + g * 2_000_000_000
        for k, b in enumerate(scen.buoys):
            det = datamodel.SignalDetection(
                buoy_id=b.buoy_id, frequency_mhz=121.5 + 0.05 * g, signal_strength_dbm=-55.0, timestamp_utc=now,
                gps_timestamp_ns=anchor + int(cap.geometric_delays_s[k, 0] * 1e9) + clock_ns[k], lat=b.lat,
                lng=b.lng, confidence=0.9, signal_type="emergency", iq_samples=cap.iq[k].astype(np.complex64),
                iq_sample_rate_hz=fs, iq_anchor_ns=anchor + clock_ns[k])
            dets.append({"type": "signal_detection", "data": datamodel.detection_wire_dict(det, "u8")})

    class Socket:
        async def send(self, msg):
            pass

    def feed(where):
        proc = central.CentralProcessor(host="127.0.0.1", ws_port=0, http_port=0, device=where,
                                        correlation_window_s=3600.0, alerter=alerts.EmergencyAlerter(methods=[]))

        async def run():
            for m in regs:
                await proc._dispatch(Socket(), None, m)
            for m in dets:
                await proc._dispatch(Socket(), m["data"]["buoy_id"], m)
            while proc._corr_task is not None and not proc._corr_task.done():
                await proc._corr_task

        asyncio.run(run())
        return proc

    quiet = logging.getLogger("radio_mapper_tpu_torch.runtime.tdoa_engine")
    level = quiet.level
    quiet.setLevel(logging.ERROR)  # the engine logs a warning a fix of an emergency signal
    feed(dev)  # warm-up
    torch.cuda.synchronize()
    _zero_counts(counters)
    card = feed(dev)
    torch.cuda.synchronize()
    launches = {k: v for k, v in _read_counts(counters).items() if v}
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        asyncio.run(card.process_signal_correlations())
        times.append(1e3 * (time.perf_counter() - t0))
    pass_ms = statistics.median(times)
    cpu = feed("cpu")
    fixes, rfixes = card.triangulated_signals[:16], cpu.triangulated_signals
    _require(len(fixes) == len(rfixes) == 16, f"central: {len(fixes)} / {len(rfixes)} fixes of 16 groups")
    # the engine called directly on the groups the service built
    eng = TDoAEngine(min_buoys=3, device=dev)
    for b in buoys:
        eng.register_buoy(datamodel.BuoyPosition(buoy_id=b[0], lat=b[1], lng=b[2], timing_accuracy_ns=100_000))
    groups = {}
    for d in card._recent:
        groups.setdefault(round(d.frequency_mhz, 2), []).append(datamodel.SignalDetection(
            buoy_id=d.node_id, frequency_mhz=d.frequency_mhz, signal_strength_dbm=d.signal_strength_dbm,
            timestamp_utc=d.timestamp_utc, gps_timestamp_ns=d.gps_timestamp_ns, lat=d.lat, lng=d.lng,
            confidence=d.confidence, signal_type=d.signal_type, iq_samples=d.iq_samples,
            iq_sample_rate_hz=d.iq_sample_rate_hz, iq_anchor_ns=d.iq_anchor_ns))
    direct = [r for g in groups.values() for r in eng.process_signal_detections(g)]
    quiet.setLevel(level)
    enu = lambda a, b: float(np.linalg.norm(geo.lat_lng_to_enu_np(a.estimated_lat, a.estimated_lng, 0.0,
                                                                   b.estimated_lat, b.estimated_lng, 0.0)[:2]))
    direct_gap = max(enu(a, b) for a, b in zip(fixes, direct))
    bit_equal = all((a.estimated_lat, a.estimated_lng) == (b.estimated_lat, b.estimated_lng)
                    for a, b in zip(fixes, direct))
    cpu_gap = max(enu(a, b) for a, b in zip(fixes, rfixes))
    methods = sorted({f.triangulation_method for f in fixes})
    errs = [float(np.linalg.norm(geo.lat_lng_to_enu_np(f.estimated_lat, f.estimated_lng, 0.0, *e, 0.0)[:2]))
            for f, e in zip(fixes, emitters)]
    print(
        f"phase 33: CentralProcessor(device='cuda'), 8 buoys x 16 frequency groups, 2048-sample u8 snippets, "
        f"{len(dets)} detections through _dispatch: 16 fixes {methods}, error median {statistics.median(errs):.3f} m, "
        f"max {max(errs):.3f} m; vs TDoAEngine called directly {direct_gap:.3e} m (tol 1e-3; bit for bit "
        f"{bit_equal}); vs the CPU service {cpu_gap:.3e} m (tol 1); {pass_ms:.3f} ms a correlation pass "
        f"({pass_ms / 16:.3f} a group); launches {launches} {tag}"
    )
    _require(methods == ["gcc-phat+lm"] and direct_gap <= 1e-3 and cpu_gap <= 1.0, "central: fixes disagree")
    _require(max(errs) < 200.0, f"central: fix errors {errs}")


def _cli_phase(tag):
    """Phase 34: ``python -m radio_mapper_tpu_torch ... --device cuda`` in
    subprocesses, all started together: each exits 0 and prints its
    checked lines."""
    import os
    import re
    import subprocess
    import tempfile

    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        runs = {
            "simulate": ["simulate", "--seed", "4"],
            "wideband": ["wideband"],
            "stream": ["stream", "--blocks", "4"],
            "adsb": ["adsb", "--source", "selftest"],
            "demod": ["demod", "--source", "sim", "--mode", "nbfm", "--seconds", "0.05", "--output",
                      os.path.join(tmp, "audio.s16le")],
            "scan": ["scan", "120.5", "122.5", "--source", "sim"],
        }
        t0 = time.perf_counter()
        procs = {k: subprocess.Popen([sys.executable, "-m", "radio_mapper_tpu_torch", "--device", "cuda", *v],
                                     cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for k, v in runs.items()}
        outs = {}
        try:
            for k, p in procs.items():
                out, err = p.communicate(timeout=600)
                outs[k] = (p.returncode, out, err)
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.perf_counter() - t0
    for k, (rc, out, err) in outs.items():
        _require(rc == 0, f"cli {k}: exit {rc}\n{err[-3000:]}")
    sim_out = outs["simulate"][1]
    err_m = float(re.search(r"^error: ([0-9.]+) m", sim_out, re.M).group(1))
    checks = {
        "simulate": "emitter (fix):" in sim_out and err_m < 100.0,
        "wideband": "<- active" in outs["wideband"][1] and "active subchannel fix" in outs["wideband"][1],
        "stream": len(re.findall(r"^block \d+: best subchannel", outs["stream"][1], re.M)) == 4,
        "adsb": outs["adsb"][1].splitlines() == ["*8d4840d6202cc371c32ce0576098;"],
        "demod": re.search(r"^wrote \d+ s16le samples @ 32000 Hz", outs["demod"][1], re.M) is not None,
        "scan": len(outs["scan"][1].splitlines()) == 2,
    }
    lines = "; ".join(f"{k}: {(outs[k][1].strip().splitlines() or [''])[-1][:90]!r}" for k in runs)
    print(f"phase 34: CLI on the card, {len(runs)} subprocesses together in {wall:.1f} s, all exit 0; simulate error "
          f"{err_m:.1f} m (limit 100); checked lines {checks}; last lines: {lines} {tag}")
    _require(all(checks.values()), f"cli: checks {checks}")


class _Recorded:
    """An IQ source that keeps a copy of every block it returns."""

    def __init__(self, source):
        self.source, self.blocks = source, []

    def __getattr__(self, name):
        return getattr(self.source, name)

    def read(self, n):
        self.blocks.append(self.source.read(n))
        return self.blocks[-1]


class _Replay:
    """The blocks a ``_Recorded`` source returned, read back in order."""

    def __init__(self, template, blocks):
        self.sample_rate_hz = template.sample_rate_hz
        self.center_frequency_hz = template.center_frequency_hz
        self.power_offset_db = template.power_offset_db
        self.blocks = iter(blocks)

    def tune(self, hz):
        self.center_frequency_hz = float(hz)

    def read(self, n):
        out = next(self.blocks)
        assert len(out) == n, (len(out), n)
        return out


def _serve_rtl_tcp(source):
    """An in-process ``RtlTcpServer`` on a free port, unthrottled, serving
    ``source`` from its thread; returns the port it bound."""
    from radio_mapper_tpu_torch.net import rtl_tcp

    server = rtl_tcp.RtlTcpServer(source, host="127.0.0.1", port=0, throttle=False)
    rtl_tcp.serve_in_thread(server)
    return server.port


def _fm_scene(sim, block_len=16_384):
    """Phase 29's scene: FM, 16 kHz wide, 150 kHz above the 121.5 MHz
    channel, 25 dB SNR."""
    return sim.default_scenario(signal="fm", bandwidth_hz=16e3, freq_offset_hz=150e3, snr_db=25.0, seed=5,
                                block_len=block_len)


def _buoy_dwell(np, torch, node, counters, center_hz):
    """One warm-up ``scan_once`` and one counted: its detections, the block
    it read, K7's launches and ``detect_block`` ms a dwell (median of 5)."""
    import asyncio

    from radio_mapper_tpu_torch import constants

    node.gps.initialize()
    node.schedule = (constants.ScheduleEntry(center_hz / 1e6, 35.0, "emergency"),)
    rec = _Recorded(node.source)
    node.source = rec
    asyncio.run(node.scan_once())  # warm-up
    torch.cuda.synchronize()
    _zero_counts(counters)
    dets = asyncio.run(node.scan_once())
    torch.cuda.synchronize()
    launches = {k: v for k, v in _read_counts(counters).items() if v}
    block = rec.blocks[-1]
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        node.detect_block(block, center_hz)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return dets, block, launches, statistics.median(times)


def _cpu_agrees(np, torch, node, dets, block, center_hz, by_frequency=False):
    """A CPU ``BuoyNode`` on the card node's block: (detections equal, peaks
    valid equal, power gap in dB on the valid peaks). ``by_frequency``
    compares the detections sorted by frequency, for a scene whose peaks
    tie in pairs."""
    from radio_mapper_tpu_torch.runtime import buoy

    cpu = buoy.BuoyNode(node.config, source=node.source, gps=node.gps, device="cpu")
    ref = cpu.detect_block(block, center_hz)
    if by_frequency:
        dets, ref = (sorted(d, key=lambda x: x.frequency_mhz) for d in (dets, ref))
    same = len(dets) == len(ref) and all(
        (a.frequency_mhz, a.confidence, a.signal_type) == (b.frequency_mhz, b.confidence, b.signal_type)
        for a, b in zip(dets, ref))
    to = lambda a, where: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(where)
    gp, _ = node._detector()(to(block.real, node.device), to(block.imag, node.device))
    cp, _ = cpu._detector()(to(block.real, "cpu"), to(block.imag, "cpu"))
    valid = cp.valid.numpy()
    same_valid = bool(np.array_equal(gp.valid.cpu().numpy(), valid))
    gap = float(np.abs(gp.power_db.cpu().numpy()[valid] - cp.power_db.numpy()[valid]).max()) if valid.any() else 0.0
    return same, same_valid, gap


def _usbmodel_phase(np, torch, dev, tag, counters):
    """Phase 35: the modeled dongle on the card. Every tuner type through
    ``usb_proto.Rtl2832u`` on the port's ``MockRtlUsbTransport`` (open →
    probe → rate → tune → gain → counter test, 0 lost); the L0-closed
    source, ``Rtl2832uSource(open_model_device())``, under a card
    ``BuoyNode.scan_once()`` against a CPU node on the same samples (K7
    once a dwell). The dongle runs its counter test pattern, a complex
    sawtooth with harmonics every fs/128: the idle model's constant
    mid-scale bytes leave only float32 rounding residue above the
    detector's notch, which no two FFTs share. Then the CLI's self-test parts, ``_pipeline_smoke`` on the card
    and ``_l0_smoke``: the device part of ``test``, which phase 37 does not
    run (it probes the host's network).
    Returns K7's launches a dwell and ``detect_block`` ms."""
    from radio_mapper_tpu_torch import cli
    from radio_mapper_tpu_torch.ingest import Rtl2832uSource
    from radio_mapper_tpu_torch.net import rtl2832u_model, usb_proto
    from radio_mapper_tpu_torch.runtime import buoy
    from radio_mapper_tpu_torch.tools.sdr_test import DropStats

    probes = []
    for tuner in usb_proto.TunerType:
        t = rtl2832u_model.MockRtlUsbTransport(None if tuner == usb_proto.TunerType.UNKNOWN else tuner)
        drv = usb_proto.Rtl2832u(t)
        found = drv.open()
        rate = drv.set_sample_rate(2_400_000)
        lo = drv.set_center_freq(433_920_000)
        gain = drv.set_tuner_gain(280) if found != usb_proto.TunerType.UNKNOWN else None
        drv.set_testmode(True)
        stats = DropStats()
        for _ in range(8):
            stats.update(np.frombuffer(drv.read_sync(16384), np.uint8))
        drv.close()
        _require(found == tuner and stats.lost_bytes == 0 and stats.gaps == 0 and stats.total_bytes == 8 * 16384,
                 f"usbmodel {tuner.name}: found {found.name}, {stats}")
        probes.append(f"{tuner.name} rate {rate:.3f} Hz LO {lo:.1f} Hz gain {gain}")
    src = Rtl2832uSource(rtl2832u_model.open_model_device(), sample_rate_hz=2_048_000)
    src.dev.set_testmode(True)
    cfg = buoy.BuoyNodeConfig(buoy_id="usbmodel", lat=35.5, lng=-97.5, sample_rate_hz=src.sample_rate_hz)
    node = buoy.BuoyNode(cfg, source=src, device=dev)
    center = 121.5e6
    dets, block, launches, detect_ms = _buoy_dwell(np, torch, node, counters, center)
    # the sawtooth is real times (1 + j): its ± harmonics tie in exact
    # arithmetic and rounding orders each pair
    same, same_valid, gap = _cpu_agrees(np, torch, node, dets, block, center, by_frequency=True)
    src.close()
    smoke = cli._pipeline_smoke(dev)
    l0 = cli._l0_smoke()
    print(
        f"phase 35: the modeled dongle: {len(probes)} tuner types open, tune and stream a gap-free counter "
        f"(8 x 16384 bytes, 0 lost): {'; '.join(probes)}; Rtl2832uSource under a card BuoyNode at "
        f"{src.sample_rate_hz:.3f} Hz (LO {src.achieved_lo_hz:.1f} Hz), counter pattern: {len(dets)} detections "
        f"(strongest {dets[0].frequency_mhz if dets else None} MHz), CPU equal {same}, "
        f"peaks valid equal {same_valid}, power {gap:.3e} dB; launches a dwell {launches}; detect_block "
        f"{detect_ms:.3f} ms a dwell; _pipeline_smoke on the card {smoke!r}; _l0_smoke {l0!r} {tag}"
    )
    _require(dets and same and same_valid and gap <= 1e-3, "usbmodel buoy: card and CPU disagree")
    _require(launches == {"fft_rows": 1}, f"usbmodel buoy dwell launches {launches}")
    _require(smoke == "ok" and l0.endswith("0 dropped"), "self-test parts failed")
    return {"launches": launches.get("fft_rows", 0), "detect_ms": detect_ms}


def _rtl_tcp_phase(np, torch, sim, dev, tag, counters):
    """Phase 36: rtl_tcp loopback on the card. An in-process
    ``RtlTcpServer`` on port 0 serves phase 29's FM scene unthrottled;
    ``RtlTcpSource`` feeds a card ``BuoyNode.scan_once()`` (against a CPU
    node on the recorded samples: equal detections, at least one, power
    within 1e-3 dB, K7 once a dwell) and ``power_scan.run_scan`` at 125 Hz
    bins (K7 once a hop; dB within 3e-4 of the CPU's on the same samples);
    ``sdr_test_rtl_tcp`` over the loopback with short windows: 0 lost
    bytes, 0 gaps. Returns K7's launches a dwell and a hop, and the times."""
    from radio_mapper_tpu_torch.ingest import SimulatedSource
    from radio_mapper_tpu_torch.net import rtl_tcp
    from radio_mapper_tpu_torch.runtime import buoy
    from radio_mapper_tpu_torch.tools import power_scan, sdr_test

    scen = _fm_scene(sim)
    center = scen.center_frequency_mhz * 1e6
    serve = lambda: _serve_rtl_tcp(SimulatedSource(scen, 0))
    src = rtl_tcp.RtlTcpSource("127.0.0.1", serve(), sample_rate_hz=scen.sample_rate_hz)
    try:
        cfg = buoy.BuoyNodeConfig(buoy_id="rtl_tcp", lat=35.5, lng=-97.5, sample_rate_hz=src.sample_rate_hz)
        node = buoy.BuoyNode(cfg, source=src, device=dev)
        dets, block, b_launches, detect_ms = _buoy_dwell(np, torch, node, counters, center)
        same, same_valid, gap = _cpu_agrees(np, torch, node, dets, block, center)
    finally:
        src.close()
    print(
        f"phase 36: buoy over rtl_tcp (loopback, port 0, unthrottled), scan_once on {scen.center_frequency_mhz} MHz: "
        f"{len(dets)} detections (strongest {dets[0].frequency_mhz if dets else None} MHz); vs a CPU BuoyNode on "
        f"the same samples: detections equal {same}, peaks valid equal {same_valid}, power {gap:.3e} dB (tol "
        f"1e-3); launches a dwell {b_launches}; detect_block {detect_ms:.3f} ms a dwell {tag}"
    )
    _require(dets and same and same_valid and gap <= 1e-3, "rtl_tcp buoy: card and CPU disagree")
    _require(b_launches == {"fft_rows": 1}, f"rtl_tcp buoy dwell launches {b_launches}")

    plan = power_scan.plan_scan(center - 100e3, center + 100e3, bin_hz=125.0)
    src = _Recorded(rtl_tcp.RtlTcpSource("127.0.0.1", serve(), sample_rate_hz=plan.sample_rate_hz))
    try:
        power_scan.run_scan(src, plan, device=dev)  # warm-up
        torch.cuda.synchronize()
        src.blocks.clear()
        _zero_counts(counters)
        t0 = time.perf_counter()
        res = power_scan.run_scan(src, plan, device=dev)
        torch.cuda.synchronize()
        hop_ms = 1e3 * (time.perf_counter() - t0) / len(plan.hops)
        s_launches = {k: v for k, v in _read_counts(counters).items() if v}
    finally:
        src.close()
    ref = power_scan.run_scan(_Replay(src, src.blocks), plan, device="cpu")
    db, rdb = np.concatenate(res.power_db), np.concatenate(ref.power_db)
    db_gap = float(np.abs(db - rdb).max())
    xd = torch.from_numpy(src.blocks[-1]).to(dev)
    psd_ms = _cuda_ms(torch, lambda: power_scan.welch_psd_db(xd, nfft=plan.nfft, window="hamming"))
    hops = len(plan.hops)
    print(
        f"phase 36: scan over rtl_tcp {plan.hops[0].center_hz / 1e6:.4f} MHz at {plan.bin_hz:.2f} Hz bins: nfft "
        f"{plan.nfft}, {hops} hop(s) of {res.samples_per_hop} samples, {len(db)} bins; {hop_ms:.3f} ms a hop with "
        f"the socket reads and the copies, {psd_ms:.3f} ms a hop's PSD on the card (CUDA events); card vs CPU on the "
        f"same samples {db_gap:.3e} dB (tol 3e-4); launches {s_launches} {tag}"
    )
    _require(db_gap <= 3e-4 and np.isfinite(db).all(), "rtl_tcp scan: card and CPU differ")
    _require(s_launches == {"fft_rows": hops}, f"rtl_tcp scan: K7 launches {s_launches} over {hops} hop(s)")

    t0 = time.perf_counter()
    report = sdr_test.sdr_test_rtl_tcp("127.0.0.1", serve(), drop_seconds=0.5, ppm_seconds=0.3)
    d = report["drop_test"]
    print(f"phase 36: sdr_test_rtl_tcp over the loopback: {d['total_bytes']} counter bytes, {d['lost_bytes']} lost, "
          f"{d['gaps']} gaps; {report['ppm_test']['total_samples']} samples in the rate window; "
          f"{time.perf_counter() - t0:.2f} s {tag}")
    _require(d["lost_bytes"] == 0 and d["gaps"] == 0 and d["total_bytes"] > 0, f"sdr_test loopback: {d}")
    _require(report["ppm_test"]["total_samples"] > 0, "sdr_test loopback: no samples in the rate window")
    return {"buoy": b_launches.get("fft_rows", 0), "scan": s_launches.get("fft_rows", 0) // hops,
            "detect_ms": detect_ms, "hop_ms": hop_ms, "psd_ms": psd_ms}


class _LoopSource:
    """A fixed buffer served cyclically, whatever the source is tuned to."""

    power_offset_db = 0.0

    def __init__(self, np, buf, sample_rate_hz):
        self.np, self.buf, self.pos = np, np.asarray(buf, np.complex64), 0
        self.sample_rate_hz, self.center_frequency_hz = float(sample_rate_hz), 0.0

    def tune(self, hz):
        self.center_frequency_hz = float(hz)

    def read(self, n):
        idx = (self.pos + self.np.arange(n)) % self.buf.size
        self.pos = int((self.pos + n) % self.buf.size)
        return self.buf[idx]


def _cli_tools_phase(np, torch, sim, dev, tag):
    """Phase 37: the new subcommands and sources, ``python -m
    radio_mapper_tpu_torch --device cuda ...`` in subprocesses started
    together (two waves: the second reads the first's files): ``usbprobe``;
    ``capture --source usbmodel`` then ``analyze`` of that file (its peaks
    and max equal the CPU analyzer's within 1e-6 dB); ``eeprom`` generate, then
    parse; ``sdrtest --loopback --rtl-tcp 127.0.0.1:0`` (0 lost); ``demod``,
    ``adsb`` and ``scan`` with ``--source rtl_tcp`` against servers this
    process runs on port 0. ``test`` and ``setup`` probe the host's
    network (the local address by a UDP connect to a public address, the
    clock by ``timedatectl``, ``chronyc`` or ``ntpdate``) and ``web``
    serves until stopped: the CPU tests hold them, and phase 35 runs
    ``test``'s device part. Returns the wall seconds."""
    import os
    import re
    import subprocess
    import tempfile

    from radio_mapper_tpu_torch import analyzer
    from radio_mapper_tpu_torch.ingest import SimulatedSource
    from radio_mapper_tpu_torch.ops import adsb, iq

    serve = lambda source: f"127.0.0.1:{_serve_rtl_tcp(source)}"

    frames = ["8d4840d6202cc371c32ce057", "8d40621d58c382d690c8ac28"]
    burst = np.concatenate([adsb.encode_frame_iq(adsb.append_crc(f), noise=0.02, seed=k) for k, f in enumerate(frames)])
    adsb_buf = 60.0 * np.concatenate([burst, np.zeros((1 << 18) - burst.size, np.complex64)])
    # what the CLI should print for each 2^18-sample read: the CPU decode of the bytes the server sends
    wire = iq.decode_uint8_iq_numpy(iq.encode_uint8_iq_numpy(adsb_buf)).astype(np.complex64)
    adsb_cpu = list(adsb.decode_block(wire, device="cpu"))
    scen = _fm_scene(sim)
    root = os.path.dirname(os.path.abspath(__file__))

    def wave(runs):
        procs = {k: subprocess.Popen([sys.executable, "-m", "radio_mapper_tpu_torch", "--device", "cuda", *v],
                                     cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for k, v in runs.items()}
        outs = {}
        try:
            for k, p in procs.items():
                out, err = p.communicate(timeout=600)
                outs[k] = (p.returncode, out, err)
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for k, (rc, out, err) in outs.items():
            _require(rc == 0, f"cli {k}: exit {rc}\n{out[-1500:]}\n{err[-3000:]}")
        return {k: v[1] for k, v in outs.items()}

    with tempfile.TemporaryDirectory() as tmp:
        cap, img = os.path.join(tmp, "usbmodel.bin"), os.path.join(tmp, "eeprom.bin")
        t0 = time.perf_counter()
        first = wave({
            "usbprobe": ["usbprobe", "--tuner", "r820t"],
            "capture": ["capture", "--source", "usbmodel", "--samples", "262144", "--output", cap],
            "eeprom": ["eeprom", "--generate", "realtek_oem", "--serial", "BUOY37", "--out", img],
            "sdrtest": ["sdrtest", "--loopback", "--rtl-tcp", "127.0.0.1:0", "--drop-seconds", "0.5",
                        "--ppm-seconds", "0.3"],
            "demod": ["demod", "--source", "rtl_tcp", "--rtl-tcp", serve(SimulatedSource(scen, 0)), "--mode", "nbfm",
                      "--frequency", "121.65", "--sample-rate", "2048000", "--seconds", "0.1", "--output",
                      os.path.join(tmp, "audio.s16le")],
            "adsb": ["adsb", "--source", "rtl_tcp", "--rtl-tcp", serve(_LoopSource(np, adsb_buf, adsb.ADSB_RATE_HZ)),
                     "--blocks", "2"],
            "scan": ["scan", "120.5", "122.5", "--source", "rtl_tcp", "--rtl-tcp", serve(SimulatedSource(scen, 0)),
                     "--integration", "0.1"],
        })
        second = wave({
            "analyze": ["analyze", cap, "--frequency", "121.5"],
            "eeprom_read": ["eeprom", "--read", img],
        })
        wall = time.perf_counter() - t0
        cpu = analyzer.analyze_iq_file(cap, center_frequency_hz=121.5e6, device="cpu")
        card = analyzer.analyze_iq_file(cap, center_frequency_hz=121.5e6, device=dev)
    # the capture is the idle model's constant: its spectrum is the DC bin
    # over float rounding residue, so the mean power (over the residue) is
    # printed, and the peaks and the max are held
    peaks_equal = card.peak_frequencies_hz == cpu.peak_frequencies_hz and len(cpu.peak_frequencies_hz) >= 1
    db_gap = max([abs(a - b) for a, b in zip(card.peak_powers_db, cpu.peak_powers_db)]
                 + [abs(card.max_power_db - cpu.max_power_db)])
    mean_gap = abs(card.mean_power_db - cpu.mean_power_db)
    peak_lines = lambda text: [ln for ln in text.splitlines() if ln.startswith(("samples:", "peaks:", "  "))]
    report = json.loads(first["sdrtest"][: first["sdrtest"].rindex("}") + 1])
    checks = {
        "usbprobe": "tuner: R820T" in first["usbprobe"] and "0 lost, 0 gaps" in first["usbprobe"],
        "capture": "via the L0 driver stack" in first["capture"],
        "analyze": peak_lines(second["analyze"]) == peak_lines(cpu.summary()) and peaks_equal and db_gap <= 1e-6,
        "eeprom": "BUOY37" in second["eeprom_read"] and "0x2838" in second["eeprom_read"],
        "sdrtest": report["drop_test"]["lost_bytes"] == 0 and report["drop_test"]["gaps"] == 0,
        "demod": re.search(r"^wrote \d+ s16le samples @ 32000 Hz", first["demod"], re.M) is not None,
        "adsb": first["adsb"].splitlines() == adsb_cpu * 2 and len(adsb_cpu) == 2,
        "scan": len(first["scan"].splitlines()) == 2,
    }
    outs = {**first, **second}
    lines = "; ".join(f"{k}: {(v.strip().splitlines() or [''])[-1][:90]!r}" for k, v in outs.items())
    print(f"phase 37: the new CLI on the card, {len(outs)} subprocesses in two waves in {wall:.1f} s, all exit 0; "
          f"analyze vs the CPU analyzer: peaks equal {peaks_equal}, peaks and max {db_gap:.3e} dB apart (tol 1e-6), "
          f"mean power over the residue {mean_gap:.3e} dB apart (not held); checked lines "
          f"{checks}; last lines: {lines} {tag}")
    _require(all(checks.values()), f"cli tools: checks {checks}")
    return wall


def _bench_phase(np, torch, dev, tag, counters):
    """Phase 38: the benchmark's legs at full width and small depth, each
    with its launch counts; then ``bench.main`` shallow. Returns the
    launches by leg and K7's check at the FFT leg's shape."""
    import contextlib
    import io

    from radio_mapper_tpu_torch import bench
    from radio_mapper_tpu_torch.ops import fft as fft_ops

    k1, k2, k3, k5, k6, k7 = ("fft_detect_rows_ct", "gcc_pair_lag_mags", "fft_rows_ct", "gcc_pairs_onehot_lag_mags",
                              "gcc_rows_lag_mags", "fft_rows")
    positive = lambda *xs: all(math.isfinite(x) and x > 0 for x in xs)
    launches = {}

    def leg(name, run):
        torch.cuda.empty_cache()
        _zero_counts(counters)
        t0 = time.perf_counter()
        out = run()
        wall = time.perf_counter() - t0
        launches[name] = {k: v for k, v in _read_counts(counters).items() if v}
        return out, launches[name], wall

    # the flagship: 1 warm-up + 2 dispatches of 2 blocks
    (rate, path, block_s, flops), n, wall = leg("flagship", lambda: bench.run_pipeline_bench(
        num_channels=128, iters=2, scan_blocks=2, device=dev))
    print(f"phase 38: bench flagship leg, {path}, 128 ch x 8 buoys x 16384: {rate:.4e} IQ samples/s, "
          f"{1e3 * block_s:.3f} ms/block, {flops / 1e9:.3f} GFLOP/block; launches {n} over 6 blocks; {wall:.1f} s {tag}")
    _require(positive(rate, block_s, flops) and n == {k1: 6, k2: 6, LM: 6}, f"bench flagship: {rate}, {n}")
    # its complex path: the first call, 1 warm-up, 2 timed
    (rate, path, block_s, _), n, wall = leg("flagship_complex", lambda: bench.run_pipeline_bench(
        num_channels=128, iters=2, path="complex", device=dev))
    print(f"phase 38: bench flagship leg, {path}, 128 ch: {rate:.4e} IQ samples/s, {1e3 * block_s:.3f} ms/block; "
          f"launches {n} over 4 blocks; {wall:.1f} s {tag}")
    _require(positive(rate, block_s) and n == {k7: 4, LM: 4, **{k: 4 for k in PAIR_FFT}},
             f"bench flagship complex: {rate}, {n}")

    # the FFT leg: 2 warm-up + 2 calls; K7 held at its shape on the leg's draws
    rate, n, wall = leg("fft", lambda: bench.run_fft_microbench(iters=2, epochs=1, device=dev))
    rng = np.random.default_rng(0)
    xr, xi = (torch.from_numpy(rng.normal(size=(256, 16_384)).astype(np.float32)).to(dev) for _ in range(2))
    _zero_counts(counters)
    out, ref = fft_ops.fft_re_im(xr, xi), fft_ops.fft_re_im_plain(xr, xi)
    torch.cuda.synchronize()
    _require(_read_counts(counters)[k7] == 1, "the FFT leg's fft_re_im did not run K7")
    err_abs, err_rel = _row_rel_error(out, ref)
    del out, ref
    k_ms = _cuda_ms(torch, lambda: fft_ops.fft_re_im(xr, xi))
    p_ms = _cuda_ms(torch, lambda: fft_ops.fft_re_im_plain(xr, xi), reps=3)
    xc = torch.complex(xr, xi)
    lib_ms = _cuda_ms(torch, lambda: torch.fft.fft(xc))
    del xc, xr, xi
    bound = _bound(_fft_flops(256, 16_384), 2 * 8 * 256 * 16_384)
    print(f"phase 38: bench FFT leg [256, 16384]: {rate / 1e6:.1f} M complex samples/s; launches {n} over 4 calls; "
          f"K7 vs fft_re_im_plain max|err| {err_abs:.3e} (rel to row max|X| {err_rel:.3e}, tol 1e-4), kernel "
          f"{k_ms:.3f} ms, plain {p_ms:.3f} ms, torch.fft.fft {lib_ms:.3f} ms, bound {bound[0]:.4f} ms ({bound[1]}) "
          f"{tag}")
    _require(positive(rate) and n == {k7: 4}, f"bench FFT leg: {rate}, {n}")
    _require(err_rel <= 1e-4, f"K7 disagrees at the FFT leg's shape: {err_rel}")
    fft_row = {"shape": [256, 16_384], "max_abs_err": err_abs, "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound[0],
               "bound_by": bound[1], "library_ms": lib_ms}

    # the GCC leg: (2 warm-up + 2) dispatches of 2 blocks
    rate, n, wall = leg("gcc", lambda: bench.run_gcc_microbench(iters=2, scan_blocks=2, epochs=1, device=dev))
    print(f"phase 38: bench GCC leg [32, 8, 16384], max_lag 512: {rate:.4e} pair correlations/s; launches {n} over 8 "
          f"blocks; {wall:.1f} s {tag}")
    _require(positive(rate) and n == {k3: 8, k2: 8}, f"bench GCC leg: {rate}, {n}")

    # EP in a one-rank process group: (2 + 2) dispatches of 2 steps, counted in the rank
    ep = {}
    t0 = time.perf_counter()
    rate = bench.run_ep_microbench(iters=2, scan_blocks=2, epochs=1, device=dev, launches=ep)
    launches["ep"] = ep
    print(f"phase 38: bench EP leg, 64 buoys x 4096, 2016 pairs: {rate:.4e} pair correlations/s; launches in the "
          f"rank {ep} over 8 steps; {time.perf_counter() - t0:.1f} s {tag}")
    _require(positive(rate) and ep.get(k3) == 8 and ep.get(k5, 0) + ep.get(k6, 0) == 8 and set(ep) <= {k3, k5, k6},
             f"bench EP leg: {rate}, {ep}")

    # config 4: the first dispatch, 1 warm-up and 2 timed, of 2 blocks
    (wb_ms, wide_rate, pair_rate), n, wall = leg("wideband", lambda: bench.run_wideband_bench(
        iters=2, scan_blocks=2, device=dev))
    print(f"phase 38: bench wideband leg (config 4): {wb_ms:.3f} ms/block, {wide_rate / 1e6:.1f} wide MS/s, "
          f"{pair_rate:.4e} pairs/s; launches {n} over 8 blocks; {wall:.1f} s {tag}")
    _require(positive(wb_ms, wide_rate, pair_rate) and n == {k3: 8, k5: 8, LM: 8}, f"bench wideband leg: {wb_ms}, {n}")

    # the ingest leg: the warm-up step and 4 paced steps
    st, n, wall = leg("ingest", lambda: bench.run_ingest_bench(channels=8, steps=4, device=dev))
    print(f"phase 38: bench ingest leg, 8 ch at real time, 4 steps: {st.sustained_samples_per_s:.4e} IQ samples/s, "
          f"real_time_ratio {st.real_time_ratio:.4f} (keeps up: {st.dropped_bytes == 0 and st.real_time_ratio >= 0.95}), "
          f"dropped {st.dropped_bytes} B, host read {st.host_read_ms_per_step:.3f} ms; launches {n} over 5 steps; "
          f"{wall:.1f} s {tag}")
    _require(positive(st.sustained_samples_per_s, st.real_time_ratio) and n == {k1: 5, k2: 5, LM: 5}, f"bench ingest: {n}")
    st, n, wall = leg("loopback", lambda: bench.run_ingest_loopback_bench(steps=8, device=dev))
    print(f"phase 38: bench loopback leg, 32 ch, 8 steps: {st.sustained_samples_per_s * 2 / 1e9:.3f} GB/s, "
          f"real_time_ratio {st.real_time_ratio:.4f}, dropped {st.dropped_bytes} B, host read "
          f"{st.host_read_ms_per_step:.3f} ms; consumed {st.bytes_consumed} B {tag}")
    _require(positive(st.sustained_samples_per_s) and st.bytes_consumed == 8 * 32 * 8 * 2 * 16_384 and not n,
             f"bench loopback leg: {st}, {n}")

    # the whole benchmark, shallow: its last stdout line
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        bench.main(device=dev, sweep_epochs=1, sweep_iters=1, scan_blocks=2, micro_epochs=1, fft_iters=2,
                   gcc_iters=2, gcc_scan_blocks=2, ep_iters=2, ep_scan_blocks=2, wideband_iters=2,
                   wideband_scan_blocks=2, ingest_steps=4, loopback_steps=8)
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    print(f"phase 38: bench.main shallow in {time.perf_counter() - t0:.1f} s: {json.dumps(line)} {tag}")
    _require(tuple(line) == bench.RESULT_KEYS and line["backend"] == "cuda" and positive(line["value"])
             and line["path"] == "split-scan2", f"bench.main's line: {line}")
    torch.cuda.empty_cache()
    return {"launches": launches, "fft_row": fft_row}


def main() -> int:
    import numpy as np
    import torch
    import torch.nn.functional as F

    from radio_mapper_tpu_torch import device, geo, sim, testing
    from radio_mapper_tpu_torch.models.pipeline import PipelineConfig, TDOAPipeline
    from radio_mapper_tpu_torch.models.streaming_tdoa import StreamingTDOA, StreamingTDOAConfig
    from radio_mapper_tpu_torch.models.wideband import WidebandConfig, WidebandTDOAPipeline
    from radio_mapper_tpu_torch.ops import ct_plan, gcc_phat, iq, split_complex
    from radio_mapper_tpu_torch.ops import fft as fft_ops
    from radio_mapper_tpu_torch.ops import detect as detect_ops
    from radio_mapper_tpu_torch.ops.cuda import (
        build, channel_step, detect_ct, fft_detect, fft_natural, fft_rows, gcc_pair,
    )
    from radio_mapper_tpu_torch.runtime import buoy_detect, datamodel
    from radio_mapper_tpu_torch.runtime.tdoa_engine import TDoAEngine

    counters = _kernel_counters()
    zero_counts = lambda: _zero_counts(counters)
    launch_counts = lambda: _read_counts(counters)

    card = device.require_cuda()
    tag = card.label()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    # the plain versions are the FP32 comparison: no TF32 anywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- phase 1: card and build
    print(card.smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {card.name} count {card.count}")
    t0 = time.perf_counter()
    build.library()
    print(f"phase 1: kernels built+loaded in {time.perf_counter() - t0:.2f} s {tag}")
    for line in build.build_log().splitlines():
        if "entry function" in line or "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    # ---- phase 2: K1 vs plain at the flagship shape
    fs, n, lag, chans, buoys = 2_400_000.0, 16_384, 512, 128, 8
    nfft = ct_plan.plan_nfft(n + lag)
    plan = ct_plan.detect_plan(
        nfft, sample_rate_hz=fs, threshold_db=-70.0, min_distance_bins=10,
        dc_notch_hz=10_000.0, confidence_floor=0.3, snr_fullscale_db=20.0,
    )
    rng = np.random.default_rng(0)
    raw = torch.from_numpy(rng.integers(0, 256, size=(chans, buoys, 2 * n), dtype=np.uint8)).to(dev)
    re, im = iq.decode_uint8_split(raw)
    pad = lambda a: torch.nn.functional.pad(a, (0, nfft - n)).reshape(-1, nfft).contiguous()
    xr, xi = pad(re), pad(im)
    k1 = fft_detect.fft_detect_rows_ct(xr, xi, plan)
    p1 = fft_detect.fft_detect_rows_ct_plain(xr, xi, plan)
    torch.cuda.synchronize()
    fr, fi, score, arg, nf, rmax = k1
    pfr, pfi, pscore, parg, pnf, prmax = p1
    row_mag = torch.sqrt(prmax).unsqueeze(-1)
    spec_abs = max((fr - pfr).abs().max().item(), (fi - pfi).abs().max().item())
    spec_rel = max(((fr - pfr).abs() / row_mag).max().item(), ((fi - pfi).abs() / row_mag).max().item())
    nf_err = (nf - pnf).abs().max().item()
    rmax_rel = ((rmax - prmax).abs() / prmax).max().item()
    fin, pfin = torch.isfinite(score), torch.isfinite(pscore)
    both = fin & pfin
    pattern_diff = (fin != pfin).float().mean().item()
    arg_diff = (arg != parg)[both].float().mean().item()
    score_rel = ((score - pscore).abs() / prmax.unsqueeze(-1))[both].max().item()
    k1_ms = _cuda_ms(torch, lambda: fft_detect.fft_detect_rows_ct(xr, xi, plan))
    k1_plain_ms = _cuda_ms(torch, lambda: fft_detect.fft_detect_rows_ct_plain(xr, xi, plan))
    print(
        f"phase 2: K1 [{xr.shape[0]}, {nfft}] spectra max|err| {spec_abs:.3e} "
        f"(rel to row max|X| {spec_rel:.3e}, tol 1e-4), noise floor {nf_err:.3e} dB (tol 1e-3), "
        f"row_max rel {rmax_rel:.3e} (tol 1e-5), candidate pattern differs {pattern_diff:.2e} "
        f"of segments, argmax differs {arg_diff:.2e} (tol 1e-3 each), score rel {score_rel:.3e} "
        f"(tol 1e-4); kernel {k1_ms:.3f} ms, plain {k1_plain_ms:.3f} ms {tag}"
    )
    _require(spec_rel <= 1e-4, f"K1 spectra disagree: {spec_rel}")
    _require(nf_err <= 1e-3, f"K1 noise floor disagrees: {nf_err}")
    _require(rmax_rel <= 1e-5, f"K1 row max disagrees: {rmax_rel}")
    _require(pattern_diff <= 1e-3 and arg_diff <= 1e-3, "K1 detect partials disagree")
    _require(score_rel <= 1e-4, f"K1 segment scores disagree: {score_rel}")
    _require(both.any().item(), "K1 produced no candidates to compare")
    k1_cluster = {nfft: _k1_cluster_report(torch, nfft, xr, xi, plan, 2, tag)}  # nfft -> the cluster design's facts

    # ---- phase 3: K2 vs plain, fed K1's outputs
    pi, pj = gcc_phat.pair_indices(buoys)
    sre, sim_ = fr.view(chans, buoys, nfft), fi.view(chans, buoys, nfft)
    smax = rmax.view(chans, buoys)
    k2 = gcc_pair.gcc_pair_lag_mags(sre, sim_, smax, pi, pj, max_lag=lag)
    p2 = gcc_pair.gcc_pair_lag_mags_plain(sre, sim_, smax, pi, pj, max_lag=lag)
    torch.cuda.synchronize()
    win_abs = (k2 - p2).abs().max().item()
    win_rel = ((k2 - p2).abs().amax(-1) / p2.abs().amax(-1)).max().item()
    k2_same = bool((k2.argmax(-1) == p2.argmax(-1)).all())
    k2_ms = _cuda_ms(torch, lambda: gcc_pair.gcc_pair_lag_mags(sre, sim_, smax, pi, pj, max_lag=lag))
    k2_plain_ms = _cuda_ms(
        torch, lambda: gcc_pair.gcc_pair_lag_mags_plain(sre, sim_, smax, pi, pj, max_lag=lag)
    )
    print(
        f"phase 3: K2 [{chans}, {buoys}, {nfft}] -> {list(k2.shape)} window max|err| {win_abs:.3e} "
        f"(rel to window max {win_rel:.3e}, tol 1e-4), same argmax {k2_same}; kernel {k2_ms:.3f} ms, plain "
        f"{k2_plain_ms:.3f} ms {tag}"
    )
    _require(tuple(k2.shape) == (chans, len(pi), 2 * lag + 1), "K2 output shape")
    _require(win_rel <= 1e-4 and k2_same, f"K2 lag windows disagree: {win_rel}")
    pair_info = [_pair_kernel_info(build, gcc_pair, ct_plan, "K2", n_, lag) for n_ in (nfft, 34_816)]
    n256 = 34_816  # = 256·136: the pair body's warp FFT at n1 = 256
    s256 = _ct_spectra(torch, ct_plan, 16, buoys, n256, dev, seed=3)
    k2b = gcc_pair.gcc_pair_lag_mags(*s256, pi, pj, max_lag=lag)
    p2b = gcc_pair.gcc_pair_lag_mags_plain(*s256, pi, pj, max_lag=lag)
    torch.cuda.synchronize()
    k2b_abs, k2b_rel = _window_errors(k2b, p2b)
    k2b_same = bool((k2b.argmax(-1) == p2b.argmax(-1)).all())
    k2b_ms = _cuda_ms(torch, lambda: gcc_pair.gcc_pair_lag_mags(*s256, pi, pj, max_lag=lag))
    print(
        f"phase 3: K2 at n1 = {ct_plan.ct_split(n256)[0]}, [16, {buoys}, {n256}] -> {list(k2b.shape)} window "
        f"max|err| {k2b_abs:.3e} (rel to window max {k2b_rel:.3e}, tol 1e-4), same argmax {k2b_same}; "
        f"kernel {k2b_ms:.3f} ms {tag}"
    )
    _require(ct_plan.ct_split(n256)[0] == 256 and tuple(k2b.shape) == (16, len(pi), 2 * lag + 1),
             "K2 n1 = 256 shape")
    _require(k2b_rel <= 1e-4 and k2b_same, f"K2 lag windows disagree at n1 = 256: {k2b_rel}")
    for i in pair_info:
        print(f"phase 3: K2 {_pair_info_text(i)} {tag}")
        _require(i["spill_bytes"] == 0 and i["local_bytes"] == 0 and i["blocks_an_sm"] >= 2, f"K2: {i}")
    del s256, k2b, p2b
    del k1, p1, k2, p2, fr, fi, score, arg, pfr, pfi, pscore, parg, xr, xi, re, im, raw

    # ---- phase 4: a simulated scene, fixed on the card and on the CPU
    scen = sim.default_scenario(signal="noise", bandwidth_hz=150e3, snr_db=25.0, seed=8)
    cap = sim.synthesize(scen)
    cfg = PipelineConfig(num_buoys=4, block_len=scen.block_len, sample_rate_hz=scen.sample_rate_hz,
                         max_lag=600, power_offset_db=40.0)
    host = [torch.from_numpy(a.astype(np.float32)) for a in (cap.iq.real, cap.iq.imag, cap.buoy_enu)]
    on_card = TDOAPipeline(cfg, device=dev).step_split(*(a.to(dev) for a in host))
    on_cpu = TDOAPipeline(cfg, device="cpu").step_split(*host)
    pos = on_card.fix.position_enu.cpu().numpy()
    err_m = float(np.linalg.norm(pos[:2] - cap.emitter_enu[0][:2]))
    lag_gap = (on_card.correlation.lag_samples.cpu() - on_cpu.correlation.lag_samples).abs().max().item()
    fix_gap = float(np.abs(pos - on_cpu.fix.position_enu.numpy()).max())
    print(
        f"phase 4: scene fix error {err_m:.3f} m (limit 50), card vs CPU: lags {lag_gap:.2e} "
        f"samples (tol 1e-3), fix {fix_gap:.3e} m (tol 0.5) {tag}"
    )
    _require(err_m < 50.0, f"scene fix error {err_m} m")
    _require(lag_gap <= 1e-3 and fix_gap <= 0.5, "card and CPU runs disagree")

    # ---- phase 5: full width, 8 blocks through the scan entry point
    blocks = 8
    cfg = PipelineConfig(num_buoys=buoys, block_len=n, sample_rate_hz=fs, max_lag=lag)
    pipe = TDOAPipeline(cfg, device=dev)
    raw, anchors = pipe.example_inputs(batch=(blocks, chans), seed=0, uint8=True)
    anchors = anchors[0]
    pipe.step_split_uint8(raw[0], anchors)  # warm-up: tables, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    k1_designs0 = dict(fft_detect.design_counts)
    t0 = time.perf_counter()
    out = pipe.step_split_uint8_scan(raw, anchors)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in launch_counts().items() if v}
    k1_designs16 = {k: v - k1_designs0[k] for k, v in fft_detect.design_counts.items() if v != k1_designs0[k]}
    default_ms_block = 1e3 * wall / blocks
    leaves = _leaves(torch, out)
    finite = all(torch.isfinite(x).all().item() for x in leaves if x.is_floating_point())
    ms_block = 1e3 * wall / blocks
    samples_s = blocks * chans * buoys * n / wall
    print(
        f"phase 5: {blocks} blocks x {chans} ch x {buoys} buoys x {n} uint8 IQ: {ms_block:.3f} ms/block, "
        f"{samples_s:.4e} IQ samples/s, peak mem {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB, "
        f"launches {launches}, K1 by design {k1_designs16}, all finite {finite} {tag}"
    )
    _require(out.fix.position_enu.shape == (blocks, chans, 3), "scan output shape")
    _require(finite, "non-finite outputs at full width")
    _require(launches == {"fft_detect_rows_ct": blocks, "gcc_pair_lag_mags": blocks, LM: blocks}
             and k1_designs16 == {fft_detect.geometry(nfft): blocks},
             f"kernel launches {launches}, K1 designs {k1_designs16}")

    med = _stage_split(
        torch, lambda mark: pipe.step_split_uint8(raw[0], anchors, on_stage=mark),
        ["decode", "fft_detect", "peaks", "gcc_pair", "solve"],
    )
    stage = {
        "decode": med["decode"],
        "pad+K1 fft_detect": med["fft_detect"],
        "top-K tail": med["peaks"],
        "K2 gcc_pair+lag peaks": med["gcc_pair"],
        "weights+solve": med["solve"],
    }
    print(
        "phase 5: stage split ms/block (median of 3, CUDA events): "
        + ", ".join(f"{k} {v:.3f}" for k, v in stage.items())
        + f", sum {sum(stage.values()):.3f} {tag}"
    )
    combined_topk = [_combined_topk_report(torch, pipe, raw, anchors, out, n, 5, tag)]

    del raw, out
    torch.cuda.empty_cache()

    # ---- phase 6: K3 vs plain at the wideband shape
    wcfg = WidebandConfig()
    wpipe = WidebandTDOAPipeline(wcfg, device=dev)
    m_sub, wb, wp, wlag, wn = (wcfg.num_subchannels, wcfg.num_buoys, wcfg.num_pairs,
                               wcfg.max_lag, wcfg.nfft)
    wre, wim, _ = wpipe.example_inputs(seed=0)
    cre, cim = split_complex.channelize_split(
        wre, wim, m_sub, sample_rate_hz=wcfg.wide_rate_hz,
        taps_per_channel=wcfg.taps_per_channel, shift=False,
    )
    wpad = lambda a: F.pad(a.movedim(-2, 0), (0, wn - wcfg.sub_block)).reshape(-1, wn).contiguous()
    xr, xi = wpad(cre), wpad(cim)
    k3 = fft_rows.fft_rows_ct(xr, xi)
    p3 = fft_rows.fft_rows_ct_plain(xr, xi)
    torch.cuda.synchronize()
    row_mag = torch.sqrt((p3[0] * p3[0] + p3[1] * p3[1]).amax(-1, keepdim=True))
    k3_abs = max((k3[0] - p3[0]).abs().max().item(), (k3[1] - p3[1]).abs().max().item())
    k3_rel = max(((k3[0] - p3[0]).abs() / row_mag).max().item(), ((k3[1] - p3[1]).abs() / row_mag).max().item())
    k3_ms = _cuda_ms(torch, lambda: fft_rows.fft_rows_ct(xr, xi))
    k3_plain_ms = _cuda_ms(torch, lambda: fft_rows.fft_rows_ct_plain(xr, xi))
    xc = torch.complex(xr, xi)
    perm = torch.as_tensor(ct_plan.ct_permutation(wn), device=dev)
    lib = torch.fft.fft(xc)[:, perm]
    k3_lib_rel = max(((k3[0] - lib.real).abs() / row_mag).max().item(),
                     ((k3[1] - lib.imag).abs() / row_mag).max().item())
    k3_lib_ms = _cuda_ms(torch, lambda: torch.fft.fft(xc)[:, perm])
    del xc, lib
    k3_bound = _bound(_fft_flops(xr.shape[0], wn), 2 * 8 * xr.numel())
    print(
        f"phase 6: K3 [{xr.shape[0]}, {wn}] spectra max|err| {k3_abs:.3e} (rel to row max|X| "
        f"{k3_rel:.3e}, tol 1e-4); kernel {k3_ms:.3f} ms, plain {k3_plain_ms:.3f} ms, "
        f"torch.fft.fft + CT permutation {k3_lib_ms:.3f} ms (rel to K3 {k3_lib_rel:.2e}), "
        f"bound {k3_bound[0]:.4f} ms ({k3_bound[1]}) {tag}"
    )
    _require(k3_rel <= 1e-4, f"K3 spectra disagree: {k3_rel}")
    del p3

    # ---- phase 7: K5 vs plain at [16, 64, 5120], fed K3's outputs; K6 on one subchannel
    f3r, f3i = k3[0].view(m_sub, wb, wn), k3[1].view(m_sub, wb, wn)
    wpi, wpj = gcc_phat.pair_indices(wb)
    ti = torch.as_tensor(wpi, dtype=torch.int64, device=dev)
    tj = torch.as_tensor(wpj, dtype=torch.int64, device=dev)
    rmax = (f3r * f3r + f3i * f3i).amax(-1)
    s2 = (rmax[:, ti] * rmax[:, tj]).contiguous()  # [M, P]
    kw = dict(max_lag=wlag, eps=wcfg.gcc_eps)
    k5 = gcc_pair.gcc_pairs_onehot_lag_mags(f3r, f3i, wpi, wpj, s2=s2, **kw)
    p5 = gcc_pair.gcc_pairs_onehot_lag_mags_plain(f3r, f3i, wpi, wpj, s2=s2, **kw)
    torch.cuda.synchronize()
    k5_abs, k5_rel = _window_errors(k5, p5)
    k5_same = bool((k5.argmax(-1) == p5.argmax(-1)).all())
    k5_ms = _cuda_ms(torch, lambda: gcc_pair.gcc_pairs_onehot_lag_mags(f3r, f3i, wpi, wpj, s2=s2, **kw))
    k5_plain_ms = _cuda_ms(
        torch, lambda: gcc_pair.gcc_pairs_onehot_lag_mags_plain(f3r, f3i, wpi, wpj, s2=s2, **kw)
    )
    del p5
    rows = [x[0].index_select(0, idx).contiguous() for idx in (ti, tj) for x in (f3r, f3i)]
    s2_0 = s2[0].contiguous()
    k6 = gcc_pair.gcc_rows_lag_mags(*rows, s2=s2_0, **kw)
    p6 = gcc_pair.gcc_rows_lag_mags_plain(*rows, s2=s2_0, **kw)
    torch.cuda.synchronize()
    k6_abs, k6_rel = _window_errors(k6, p6)
    k6_same = bool((k6.argmax(-1) == p6.argmax(-1)).all())
    k65_abs, k65_rel = _window_errors(k6, k5[0])
    k6_ms = _cuda_ms(torch, lambda: gcc_pair.gcc_rows_lag_mags(*rows, s2=s2_0, **kw))
    k6_plain_ms = _cuda_ms(torch, lambda: gcc_pair.gcc_rows_lag_mags_plain(*rows, s2=s2_0, **kw))
    print(
        f"phase 7: K5 [{m_sub}, {wb}, {wn}] -> {list(k5.shape)} window max|err| {k5_abs:.3e} (rel to "
        f"window max {k5_rel:.3e}, tol 1e-4), same argmax {k5_same}; kernel {k5_ms:.3f} ms, plain "
        f"{k5_plain_ms:.3f} ms; K6 [{wp}, {wn}] x 4 -> {list(k6.shape)} max|err| {k6_abs:.3e} (rel {k6_rel:.3e}), "
        f"same argmax {k6_same}, vs K5 {k65_abs:.3e} (rel {k65_rel:.3e}), tol 1e-4; kernel {k6_ms:.3f} ms, plain "
        f"{k6_plain_ms:.3f} ms {tag}"
    )
    _require(tuple(k5.shape) == (m_sub, wp, 2 * wlag + 1), "K5 output shape")
    _require(tuple(k6.shape) == (wp, 2 * wlag + 1), "K6 output shape")
    _require(k5_rel <= 1e-4 and k5_same, f"K5 lag windows disagree: {k5_rel}")
    _require(k6_same, "K6's window peaks differ from the plain version's")
    pair_info += [_pair_kernel_info(build, gcc_pair, ct_plan, kind, wn, wlag) for kind in ("K5", "K6")]
    pair_info.append(_pair_kernel_info(build, gcc_pair, ct_plan, "K5", 34_816, 512))
    for i in pair_info[-3:]:
        print(f"phase 7: {i['kernel']} {_pair_info_text(i)} {tag}")
        _require(i["spill_bytes"] == 0 and i["local_bytes"] == 0 and i["blocks_an_sm"] >= 2, f"{i['kernel']}: {i}")
    n256 = 34_816  # n1 = 256
    b256r, b256i, b256m = _ct_spectra(torch, ct_plan, 1, wb, n256, dev, seed=4)
    s2b = (b256m[:, ti] * b256m[:, tj]).contiguous()
    kwb = dict(max_lag=512, eps=wcfg.gcc_eps, s2=s2b)
    k5b = gcc_pair.gcc_pairs_onehot_lag_mags(b256r, b256i, wpi, wpj, **kwb)
    p5b = gcc_pair.gcc_pairs_onehot_lag_mags_plain(b256r, b256i, wpi, wpj, **kwb)
    torch.cuda.synchronize()
    k5b_abs, k5b_rel = _window_errors(k5b, p5b)
    k5b_same = bool((k5b.argmax(-1) == p5b.argmax(-1)).all())
    k5b_ms = _cuda_ms(torch, lambda: gcc_pair.gcc_pairs_onehot_lag_mags(b256r, b256i, wpi, wpj, **kwb))
    print(
        f"phase 7: K5 at n1 = {ct_plan.ct_split(n256)[0]}, [1, {wb}, {n256}] -> {list(k5b.shape)} window "
        f"max|err| {k5b_abs:.3e} (rel to window max {k5b_rel:.3e}, tol 1e-4), same argmax {k5b_same}; "
        f"kernel {k5b_ms:.3f} ms {tag}"
    )
    _require(tuple(k5b.shape) == (1, wp, 1025), "K5 n1 = 256 output shape")
    _require(k5b_rel <= 1e-4 and k5b_same, f"K5 lag windows disagree at n1 = 256: {k5b_rel}")
    del b256r, b256i, b256m, s2b, k5b, p5b
    _require(k6_rel <= 1e-4 and k65_rel <= 1e-4, f"K6 lag windows disagree: {k6_rel}, {k65_rel}")
    del k3, k5, k6, p6, rows, f3r, f3i, xr, xi, cre, cim
    torch.cuda.empty_cache()

    # ---- phase 8: wideband scenes — full width on both pair routes, and
    # the card vs the CPU at the small config
    sub = 5
    ring = _ring(np, wb, 12_000.0)
    emitter = np.array([2_000.0, -3_000.0, 0.0])
    sre, sim_ = sim.synthesize_wideband(
        wcfg, active_subchannel=sub, anchors_enu=ring, emitter_enu=emitter, snr_db=25.0, seed=0
    )
    scene = [torch.from_numpy(a).to(dev) for a in (sre, sim_, ring)]
    on5 = wpipe.step_split(*scene)
    gcc_pair.set_onehot_pairs("off")
    try:
        on6 = wpipe.step_split(*scene)
    finally:
        gcc_pair.set_onehot_pairs("auto")
    fix5 = on5.fixes_enu[sub].cpu().numpy()
    err_m = float(np.linalg.norm(fix5[:2] - emitter[:2]))
    w5 = on5.weights.cpu().numpy()
    quiet = (sub + m_sub // 2) % m_sub
    route_fix = float(np.abs(on6.fixes_enu[sub].cpu().numpy() - fix5).max())
    route_w = (on6.weights - on5.weights).abs().max().item()
    scfg = WidebandConfig(num_buoys=8, wide_rate_hz=4_096_000.0, num_subchannels=8,
                          sub_block=1024, max_lag=64, solver_iterations=20)
    sring = _ring(np, scfg.num_buoys, 9_000.0)
    semit = np.array([1_500.0, -2_200.0, 0.0])
    shost = [torch.from_numpy(a) for a in (*sim.synthesize_wideband(
        scfg, active_subchannel=3, anchors_enu=sring, emitter_enu=semit, snr_db=25.0, seed=1
    ), sring)]
    s_card = WidebandTDOAPipeline(scfg, device=dev).step_split(*(a.to(dev) for a in shost))
    s_cpu = WidebandTDOAPipeline(scfg, device="cpu").step_split(*shost)
    s_lag = (s_card.lags[3].cpu() - s_cpu.lags[3]).abs().max().item()
    s_fix = (s_card.fixes_enu[3].cpu() - s_cpu.fixes_enu[3]).abs().max().item()
    print(
        f"phase 8: wideband scene {wb} buoys, active subchannel {sub}: fix error {err_m:.3f} m "
        f"(limit 300), mean weight {w5[sub].mean():.4f} vs quiet {w5[quiet].mean():.4f} (need > 3x); "
        f"K6 route vs K5 route: fix {route_fix:.3e} m (tol 1), weights {route_w:.3e} (tol 1e-3); "
        f"small config card vs CPU: lags {s_lag:.3e} samples (tol 1e-3), fix {s_fix:.3e} m (tol 0.5) {tag}"
    )
    _require(err_m < 300.0, f"wideband fix error {err_m} m")
    _require(w5[sub].mean() > 3 * w5[quiet].mean(), "active subchannel not weighted above a quiet one")
    _require(route_fix <= 1.0 and route_w <= 1e-3, "K5 and K6 routes disagree")
    _require(s_lag <= 1e-3 and s_fix <= 0.5, "wideband card and CPU runs disagree")
    del scene, on5, on6

    # ---- phase 9: config 4 at full width, 8 blocks, default route (K3 + K5),
    # then the same blocks on the K6 route
    wblocks = [wpipe.example_inputs(seed=k) for k in range(blocks)]
    wpipe.step_split(*wblocks[0])  # warm-up
    torch.cuda.synchronize()

    def run_blocks():
        torch.cuda.reset_peak_memory_stats(dev)
        zero_counts()
        t0 = time.perf_counter()
        outs = [wpipe.step_split(*blk) for blk in wblocks]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k: v for k, v in launch_counts().items() if v}
        finite = all(torch.isfinite(x).all().item() for o in outs for x in o[:4])
        shapes = all(tuple(o.fixes_enu.shape) == (m_sub, 3) and tuple(o.lags.shape) == (m_sub, wp)
                     for o in outs)
        return wall, counts, finite and shapes, torch.cuda.max_memory_allocated(dev)

    wall5, wl5, ok5, mem5 = run_blocks()
    gcc_pair.set_onehot_pairs("off")
    try:
        wall6, wl6, ok6, mem6 = run_blocks()
    finally:
        gcc_pair.set_onehot_pairs("auto")
    wide_samples = wb * wcfg.wide_block
    pairs_blk = m_sub * wp
    for route, wall, counts, ok, mem in (("K5", wall5, wl5, ok5, mem5), ("K6", wall6, wl6, ok6, mem6)):
        print(
            f"phase 9: {route} route, {blocks} blocks x {wb} buoys x {wcfg.wide_block} samples -> "
            f"{m_sub} subchannels x {wp} pairs: {1e3 * wall / blocks:.3f} ms/block "
            f"(real time {1e3 * wcfg.wide_block / wcfg.wide_rate_hz:.3f}), "
            f"{blocks * wide_samples / wall:.4e} wide IQ samples/s, {blocks * pairs_blk / wall:.4e} pair "
            f"correlations/s, peak mem {mem / 2**30:.2f} GiB, launches {counts}, "
            f"finite+shapes {ok} {tag}"
        )
    _require(ok5 and ok6, "non-finite or misshapen wideband outputs at full width")
    _require(wl5 == {"fft_rows_ct": blocks, "gcc_pairs_onehot_lag_mags": blocks, LM: blocks},
             f"K5-route launches {wl5}")
    _require(wl6 == {"fft_rows_ct": blocks, "gcc_rows_lag_mags": blocks * m_sub, LM: blocks},
             f"K6-route launches {wl6}")

    med = _stage_split(
        torch, lambda mark: wpipe.step_split(*wblocks[0], on_stage=mark),
        ["channelize", "fft", "s2", "pair", "lag_peaks", "solve"],
    )
    stage = {
        "channelize": med["channelize"],
        "K3 fft_rows_ct": med["fft"],
        "s2": med["s2"],
        "K5 gcc_pairs_onehot": med["pair"],
        "lag peaks": med["lag_peaks"],
        "weights+solve": med["solve"],
    }
    print(
        "phase 9: stage split ms/block (median of 3, CUDA events): "
        + ", ".join(f"{k} {v:.3f}" for k, v in stage.items())
        + f", sum {sum(stage.values()):.3f} {tag}"
    )

    del wblocks
    torch.cuda.empty_cache()

    # ---- phase 10: K7 vs plain at the narrowband shapes
    ncfg = PipelineConfig(num_buoys=buoys, block_len=n, sample_rate_hz=fs, max_lag=lag,
                          solver_starts=4, correlation_dwells=8)
    npipe = TDOAPipeline(ncfg, device=dev)
    raw, nanchors = npipe.example_inputs(batch=(chans,), seed=0, uint8=True)
    elt = sim.synthesize(_elt_scene(sim))
    elt_host = [torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
                for a in (elt.iq.real, elt.iq.imag, elt.buoy_enu)]
    nb_rows = [x.reshape(-1, n).contiguous() for x in iq.decode_uint8_split(raw)]
    # the narrowband configuration at block_len 32768 (phase 13's second run): its decoded dwells are
    # K7's cluster rows at full width, [8192, 32768], and the same bytes as [4096, 65536]
    ncfg32 = dataclasses.replace(ncfg, block_len=32_768)
    npipe32 = TDOAPipeline(ncfg32, device=dev)
    raw32, nanchors32 = npipe32.example_inputs(batch=(chans,), seed=0, uint8=True)
    nb32_rows = [x.reshape(-1, 32_768).contiguous() for x in iq.decode_uint8_split(raw32)]
    shapes = {
        (chans * buoys * 8, n): nb_rows,
        # the radix design's two shorter lengths on the same bytes (on no path)
        (chans * buoys * 16, 8192): [x.view(-1, 8192) for x in nb_rows],
        (chans * buoys * 32, 4096): [x.view(-1, 4096) for x in nb_rows],
        (32, 32_768): [x.reshape(32, 32_768).to(dev) for x in elt_host[:2]],
        (8, 65_536): [x.reshape(-1, 65_536)[:8].contiguous().to(dev) for x in elt_host[:2]],
        (chans * buoys * 8, 32_768): nb32_rows,
        (chans * buoys * 4, 65_536): [x.view(-1, 65_536) for x in nb32_rows],
    }
    for cn in fft_natural.CLUSTER_N:
        info = fft_natural.cluster_info(cn)
        print(f"phase 10: K7 cluster design at n = {cn}: c = {info['c']} blocks a row, {info['smem']} B of shared "
              f"memory a block, cudaOccupancyMaxActiveClusters {info['clusters']} {tag}")
        _require(info["clusters"] > 0, f"K7's cluster at {cn} does not fit the card")
    k7 = {}
    for shape, (xr, xi) in shapes.items():
        by_design = dict(fft_natural.design_counts)
        out = fft_natural.fft_rows(xr, xi)
        ran = [k for k, v in fft_natural.design_counts.items() if v != by_design[k]]
        ref = fft_natural.fft_rows_plain(xr, xi)
        torch.cuda.synchronize()
        err_abs, err_rel = _row_rel_error(out, ref)
        del out, ref
        k_ms = _cuda_ms(torch, lambda: fft_natural.fft_rows(xr, xi))
        p_ms = _cuda_ms(torch, lambda: fft_natural.fft_rows_plain(xr, xi))
        xc = torch.complex(xr, xi)
        lib_ms = _cuda_ms(torch, lambda: torch.fft.fft(xc))
        del xc
        nbytes = 2 * 8 * shape[0] * shape[1]  # a row read once, its spectrum written once
        bound = _bound(_fft_flops(*shape), nbytes)
        k7[shape] = (err_abs, err_rel, k_ms, p_ms, lib_ms, bound, ran)
        factors = ("·".join(str(r) for r, _ in fft_natural.radix_plan(shape[1]).passes) if ran == ["radix"]
                   else f"{shape[1] // fft_natural.CLUSTER_SUB_N} blocks × 16384")
        print(
            f"phase 10: K7 {list(shape)}, design {'+'.join(ran)} ({factors}): spectra max|err| {err_abs:.3e} "
            f"(rel to row max|X| {err_rel:.3e}, tol 1e-4); kernel {k_ms:.3f} ms "
            f"({nbytes / k_ms / 1e9:.3f} TB/s of the bound's {H100_HBM_BYTES / 1e12:.2f}; bound "
            f"{bound[0]:.4f} ms), plain {p_ms:.3f} ms, torch.fft.fft {lib_ms:.3f} ms {tag}"
        )
        _require(ran == [fft_natural.design(shape[1])], f"K7 at {shape} ran {ran}")
        _require(err_rel <= 1e-4, f"K7 spectra disagree at {shape}: {err_rel}")
    del shapes, nb_rows, nb32_rows, xr, xi
    torch.cuda.empty_cache()

    # ---- phase 11: the ELT scene, multi-dwell, on the card and on the CPU
    ecfg = PipelineConfig(num_buoys=4, block_len=32_768, sample_rate_hz=2_048_000.0, max_lag=600,
                          power_offset_db=40.0, solver_starts=4, correlation_dwells=8)
    zero_counts()
    on_card = TDOAPipeline(ecfg, device=dev).step_split(*(a.to(dev) for a in elt_host))
    torch.cuda.synchronize()
    elt_launches = {k: v for k, v in launch_counts().items() if v}
    on_cpu = TDOAPipeline(ecfg, device="cpu").step_split(*elt_host)
    pos = on_card.fix.position_enu.cpu().numpy()
    err_m = float(np.linalg.norm(pos[:2] - elt.emitter_enu[0][:2]))
    cpu_err_m = float(np.linalg.norm(on_cpu.fix.position_enu.numpy()[:2] - elt.emitter_enu[0][:2]))
    fix_gap = float(np.abs(pos - on_cpu.fix.position_enu.numpy()).max())
    lag_gap = (on_card.correlation.lag_samples.cpu() - on_cpu.correlation.lag_samples).abs().max().item()
    same_peaks = bool((on_card.peaks.bin_index.cpu() == on_cpu.peaks.bin_index).all())
    print(
        f"phase 11: ELT scene (4 buoys, 8 dwells x 32768, 5 kHz chirp): fix error {err_m:.3f} m "
        f"(limit 500; CPU {cpu_err_m:.3f}), card vs CPU: fix {fix_gap:.3e} m (tol 1), lags "
        f"{lag_gap:.3e} samples, peaks equal {same_peaks}, launches {elt_launches} {tag}"
    )
    _require(err_m < 500.0, f"ELT fix error {err_m} m")
    _require(fix_gap <= 1.0, f"ELT card and CPU fixes differ by {fix_gap} m")
    _require(elt_launches == {"fft_rows": 1, LM: 1}, f"the ELT run's launches {elt_launches}")

    # ---- phase 12: the buoy detection dwell, card vs CPU
    dwell = sim.synthesize(sim.default_scenario(signal="fm", bandwidth_hz=16e3, freq_offset_hz=150e3,
                                                snr_db=25.0, seed=5, block_len=n))
    dhost = [torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)) for a in (dwell.iq.real, dwell.iq.imag)]
    dkw = dict(sample_rate_hz=dwell.scenario.sample_rate_hz, max_peaks=8, threshold_db=-70.0,
               power_offset_db=40.0)
    c_peaks, c_bw = buoy_detect.detect_dwell(*dhost, **dkw)
    g_peaks, g_bw = buoy_detect.detect_dwell(*(a.to(dev) for a in dhost), **dkw)
    torch.cuda.synchronize()
    same_bins = bool((g_peaks.bin_index.cpu() == c_peaks.bin_index).all()
                     and (g_peaks.valid.cpu() == c_peaks.valid).all())
    pw_gap = (g_peaks.power_db.cpu() - c_peaks.power_db).abs().max().item()
    same_bw = bool((g_bw.cpu() == c_bw).all())
    print(
        f"phase 12: buoy dwell [4, {n}] card vs CPU: peaks equal {same_bins}, power {pw_gap:.3e} dB "
        f"(tol 1e-3), bandwidths equal {same_bw}, {int(c_peaks.valid.sum())} valid peaks, strongest at "
        f"{g_peaks.freq_offset_hz[:, 0].cpu().numpy().round(1).tolist()} Hz {tag}"
    )
    _require(same_bins and pw_gap <= 1e-3 and same_bw, "buoy dwell: card and CPU disagree")
    _require(bool(c_peaks.valid.any()), "buoy dwell detected nothing")

    # ---- phase 13: narrowband multi-dwell at full width, 4 blocks
    nblocks = 4
    nraw = torch.stack([raw] + [npipe.example_inputs(batch=(chans,), seed=k, uint8=True)[0]
                                for k in range(1, nblocks)])
    npipe.step_split_uint8(raw, nanchors)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    t0 = time.perf_counter()
    nout = npipe.step_split_uint8_scan(nraw, nanchors)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k7_launches = launch_counts()["fft_rows"]
    nb_other = {k: v for k, v in launch_counts().items() if v and k != "fft_rows"}
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    finite = all(torch.isfinite(x).all().item() for x in _leaves(torch, nout) if x.is_floating_point())
    ms_block = 1e3 * wall / nblocks
    real_ms = 1e3 * ncfg.correlation_dwells * n / fs
    print(
        f"phase 13: narrowband {nblocks} blocks x {chans} ch x {buoys} buoys x 8 dwells x {n} uint8 IQ "
        f"(nfft {fft_ops.friendly_fft_len(8 * n + lag)} for the pair stage): "
        f"{ms_block:.3f} ms/block (real time {real_ms:.3f}, ratio {ms_block / real_ms:.3f}), "
        f"{nblocks * chans * buoys * 8 * n / wall:.4e} IQ samples/s, peak mem {peak_gib:.2f} GiB "
        f"(limit 40), K7 launches {k7_launches} ({k7_launches / nblocks:g} per block), all finite "
        f"{finite} {tag}"
    )
    _require(tuple(nout.fix.position_enu.shape) == (nblocks, chans, 3), "narrowband scan output shape")
    _require(finite, "non-finite narrowband outputs at full width")
    _require(peak_gib < 40.0, f"narrowband peak device memory {peak_gib:.2f} GiB")
    _require(k7_launches == nblocks and nb_other == {LM: nblocks, **{k: nblocks for k in PAIR_FFT}},
             f"K7 launches {k7_launches}, others {nb_other}")
    med = _stage_split(
        torch, lambda mark: npipe.step_split_uint8(raw, nanchors, on_stage=mark),
        ["decode", "psd", "detect", "spectra", "pair_corr", "lag_peaks", "solve"],
    )
    print(
        "phase 13: stage split ms/block (median of 3, CUDA events; the pair stage in one chunk): "
        f"decode {med['decode']:.3f}, K7 psd {med['psd']:.3f}, detect {med['detect']:.3f}, "
        f"spectra (K9) {med['spectra']:.3f}, pair corr (max pass, K10) {med['pair_corr']:.3f}, "
        f"lag peaks {med['lag_peaks']:.3f}, weights+solve (4 starts) {med['solve']:.3f}, "
        f"sum {sum(med.values()):.3f} {tag}"
    )
    k7_main = k7[(chans * buoys * 8, n)]
    del nraw, nout, raw
    torch.cuda.empty_cache()

    # the same configuration at block_len 32768 (the ELT dwell): K7's cluster design on [8192, 32768]
    nblocks32 = 2
    nraw32 = torch.stack([raw32] + [npipe32.example_inputs(batch=(chans,), seed=k, uint8=True)[0]
                                    for k in range(1, nblocks32)])
    npipe32.step_split_uint8(raw32, nanchors32)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    cluster0 = fft_natural.design_counts["cluster"]
    t0 = time.perf_counter()
    nout32 = npipe32.step_split_uint8_scan(nraw32, nanchors32)
    torch.cuda.synchronize()
    wall32 = time.perf_counter() - t0
    k7_launches32 = launch_counts()["fft_rows"]
    nb32_other = {k: v for k, v in launch_counts().items() if v and k != "fft_rows"}
    k7_cluster_runs = fft_natural.design_counts["cluster"] - cluster0
    peak32_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    finite32 = all(torch.isfinite(x).all().item() for x in _leaves(torch, nout32) if x.is_floating_point())
    ms_block32 = 1e3 * wall32 / nblocks32
    real_ms32 = 1e3 * ncfg32.correlation_dwells * 32_768 / fs
    print(
        f"phase 13: narrowband at block_len 32768, {nblocks32} blocks x {chans} ch x {buoys} buoys x 8 dwells x "
        f"32768 uint8 IQ (nfft {fft_ops.friendly_fft_len(8 * 32_768 + lag)} for the pair stage): "
        f"{ms_block32:.3f} ms/block (real time {real_ms32:.3f}, ratio {ms_block32 / real_ms32:.3f}), peak mem "
        f"{peak32_gib:.2f} GiB, K7 launches {k7_launches32} (cluster design {k7_cluster_runs}), all finite "
        f"{finite32} {tag}"
    )
    _require(tuple(nout32.fix.position_enu.shape) == (nblocks32, chans, 3) and finite32,
             "narrowband block_len 32768 outputs")
    _require(k7_launches32 == nblocks32 == k7_cluster_runs and nb32_other == {LM: nblocks32},
             f"block_len 32768 K7 launches {k7_launches32}, cluster {k7_cluster_runs}, others {nb32_other}")
    med32 = _stage_split(
        torch, lambda mark: npipe32.step_split_uint8(raw32, nanchors32, on_stage=mark),
        ["decode", "psd", "detect", "spectra", "pair_corr", "lag_peaks", "solve"],
    )
    print(
        "phase 13: block_len 32768 stage split ms/block (median of 3, CUDA events): "
        + ", ".join(f"{k} {v:.3f}" for k, v in med32.items()) + f", sum {sum(med32.values()):.3f}; K7 psd "
        f"{med32['psd']:.3f} ms/block {tag}"
    )
    del nraw32, nout32, raw32
    torch.cuda.empty_cache()

    # ---- phases 14-18 run on the phase-5 flagship blocks (the same seed)
    raw, anchors = pipe.example_inputs(batch=(blocks, chans), seed=0, uint8=True)
    anchors = anchors[0]
    xr, xi, _ = split_complex.pad_ct(*iq.decode_uint8_split(raw[0]), max_lag=lag)  # [chans, buoys, nfft]
    rows = lambda a: a.reshape(-1, nfft)
    n1, n2 = plan.n1, plan.n2
    nrows, npairs, width = chans * buoys, len(pi), 2 * lag + 1
    rows_w = sum(gcc_pair.window_rows(nfft, lag))

    # ---- phase 14: K3 vs plain at [1024, 17408]; K4 vs plain on K3's
    # spectra; K4 on K1's spectra = K1's partials
    x3r, x3i = rows(xr), rows(xi)
    f3r, f3i = fft_rows.fft_rows_ct(x3r, x3i)
    p3 = fft_rows.fft_rows_ct_plain(x3r, x3i)
    torch.cuda.synchronize()
    f3_abs, f3_rel = _row_rel_error((f3r, f3i), p3)
    del p3
    f3_ms = _cuda_ms(torch, lambda: fft_rows.fft_rows_ct(x3r, x3i))
    f3_plain_ms = _cuda_ms(torch, lambda: fft_rows.fft_rows_ct_plain(x3r, x3i))
    xc = torch.complex(x3r, x3i)
    perm = torch.as_tensor(ct_plan.ct_permutation(nfft), device=dev)
    f3_lib_ms = _cuda_ms(torch, lambda: torch.fft.fft(xc)[:, perm])
    del xc
    f3_bound = _bound(_fft_flops(nrows, nfft), 2 * 8 * nrows * nfft)
    print(
        f"phase 14: K3 [{nrows}, {nfft}] (flagship block 0, two-kernel route) spectra max|err| {f3_abs:.3e} "
        f"(rel to row max|X| {f3_rel:.3e}, tol 1e-4); kernel {f3_ms:.3f} ms, plain {f3_plain_ms:.3f} ms, "
        f"torch.fft.fft + CT permutation {f3_lib_ms:.3f} ms, bound {f3_bound[0]:.4f} ms ({f3_bound[1]}) {tag}"
    )
    _require(f3_rel <= 1e-4, f"K3 spectra disagree at [{nrows}, {nfft}]: {f3_rel}")
    k4 = detect_ct.detect_ct_partials(f3r, f3i, plan)
    p4 = detect_ct.detect_ct_partials_plain(f3r, f3i, plan)
    fr1, fi1, s1, a1, nf1, rmax1 = fft_detect.fft_detect_rows_ct(rows(xr), rows(xi), plan)
    k4_on_k1 = detect_ct.detect_ct_partials(fr1, fi1, plan)
    torch.cuda.synchronize()
    fin, pfin = torch.isfinite(k4[0]), torch.isfinite(p4[0])
    both = fin & pfin
    k4_pattern = (fin != pfin).float().mean().item()
    k4_arg = (k4[1] != p4[1])[both].float().mean().item()
    k4_nf = (k4[2] - p4[2]).abs().max().item()
    k4_score_abs = (k4[0] - p4[0])[both].abs().max().item()
    k4_score_rel = ((k4[0] - p4[0]).abs() / (f3r * f3r + f3i * f3i).amax(-1, keepdim=True))[both].max().item()
    k4_same_as_k1 = all(torch.equal(x, y) for x, y in zip(k4_on_k1, (s1, a1, nf1)))
    k1_same_as_k3 = torch.equal(fr1, f3r) and torch.equal(fi1, f3i)
    k3k4_same_as_k1 = all(torch.equal(x, y) for x, y in zip(k4, (s1, a1, nf1)))
    k4_ms = _cuda_ms(torch, lambda: detect_ct.detect_ct_partials(f3r, f3i, plan))
    k4_plain_ms = _cuda_ms(torch, lambda: detect_ct.detect_ct_partials_plain(f3r, f3i, plan))
    k4_bound = _bound(_detect_flops(nrows, nfft), nrows * nfft * 8 + nrows * plan.segments * 8 + nrows * 4)
    print(
        f"phase 14: K4 [{nrows}, {nfft}] on K3's spectra of flagship block 0: candidate pattern differs "
        f"{k4_pattern:.2e} of segments, argmax differs {k4_arg:.2e} (tol 1e-3 each), noise floor {k4_nf:.3e} dB "
        f"(tol 1e-3), score max|err| {k4_score_abs:.3e} (rel {k4_score_rel:.3e}, tol 1e-4); on K1's spectra "
        f"equal to K1's partials and floor: {k4_same_as_k1}; kernel {k4_ms:.3f} ms, plain {k4_plain_ms:.3f} ms, "
        f"bound {k4_bound[0]:.4f} ms ({k4_bound[1]}) {tag}"
    )
    print(
        f"phase 14: K1 [{nrows}, {nfft}] on the same rows: spectra equal to K3's bit for bit: {k1_same_as_k3}; "
        f"K3 -> K4 partials and floor equal to K1's bit for bit: {k3k4_same_as_k1} {tag}"
    )
    _require(k4_pattern <= 1e-3 and k4_arg <= 1e-3, "K4 detect partials disagree")
    _require(k4_nf <= 1e-3 and k4_score_rel <= 1e-4, f"K4 floor or scores disagree: {k4_nf}, {k4_score_rel}")
    _require(both.any().item(), "K4 produced no candidates to compare")
    _require(k4_same_as_k1, "K4 on K1's spectra differs from K1's own partials")
    _require(k1_same_as_k3, "K1's spectra differ from K3's on the same rows")
    _require(k3k4_same_as_k1, "K3 -> K4 partials differ from K1's")
    k1_cluster_block0 = _k1_cluster_report(torch, nfft, x3r, x3i, plan, 14, tag)
    del f3r, f3i, x3r, x3i, k4, p4, k4_on_k1

    # ---- phase 15: K2's l2, l1 and "cc" modes vs plain, fed K1's outputs
    sre, sim_, smax = fr1.view(chans, buoys, nfft), fi1.view(chans, buoys, nfft), rmax1.view(chans, buoys)
    k2_modes = {}
    for mode, gate, weighting in (("l2", "l2", "phat"), ("l1", "l1", "phat"), ("cc", "l2rx", "cc")):
        kw = dict(max_lag=lag, weighting=weighting)
        gcc_pair.set_phat_gate(gate)
        try:
            k2 = gcc_pair.gcc_pair_lag_mags(sre, sim_, smax, pi, pj, **kw)
            p2 = gcc_pair.gcc_pair_lag_mags_plain(sre, sim_, smax, pi, pj, **kw)
            torch.cuda.synchronize()
            m_abs, m_rel = _window_errors(k2, p2)
            same_arg = bool((k2.argmax(-1) == p2.argmax(-1)).all())
            m_ms = _cuda_ms(torch, lambda: gcc_pair.gcc_pair_lag_mags(sre, sim_, smax, pi, pj, **kw))
            m_plain_ms = _cuda_ms(torch, lambda: gcc_pair.gcc_pair_lag_mags_plain(sre, sim_, smax, pi, pj, **kw))
        finally:
            gcc_pair.set_phat_gate("l2rx")
        k2_modes[mode] = (m_abs, m_ms, m_plain_ms)
        print(
            f"phase 15: K2 {mode} [{chans}, {buoys}, {nfft}] -> {list(k2.shape)} window max|err| {m_abs:.3e} "
            f"(rel to window max {m_rel:.3e}, tol 1e-4), same argmax {same_arg}; kernel {m_ms:.3f} ms, "
            f"plain {m_plain_ms:.3f} ms (l2rx: kernel {k2_ms:.3f}) {tag}"
        )
        _require(tuple(k2.shape) == (chans, npairs, width), f"K2 {mode} output shape")
        _require(m_rel <= 1e-4 and same_arg, f"K2 {mode} lag windows disagree: {m_rel}")
    print(f"phase 15: every gate runs K2's kernel {_pair_info_text(pair_info[0])} {tag}")
    del k2, p2

    # ---- phase 16: K8 vs plain, and vs K1 -> K2 (l2rx) on the same block
    k8 = channel_step.channel_step_partials(xr, xi, pi, pj, plan, lag)
    p8 = channel_step.channel_step_partials_plain(xr, xi, pi, pj, plan, lag)
    w12 = gcc_pair.gcc_pair_lag_mags(sre, sim_, smax, pi, pj, max_lag=lag)
    torch.cuda.synchronize()
    k8_same = {
        "partials": torch.equal(k8[0].view(-1, plan.segments), s1) and torch.equal(k8[1].view(-1, plan.segments), a1),
        "noise floors": torch.equal(k8[2].view(-1), nf1),
        "windows": torch.equal(k8[3], w12),
    }
    k8_abs, k8_rel = _window_errors(k8[3], p8[3])
    k8_nf = (k8[2] - p8[2]).abs().max().item()
    fin, pfin = torch.isfinite(k8[0]), torch.isfinite(p8[0])
    k8_pattern = (fin != pfin).float().mean().item()
    k8_ms = _cuda_ms(torch, lambda: channel_step.channel_step_partials(xr, xi, pi, pj, plan, lag))
    k8_plain_ms = _cuda_ms(torch, lambda: channel_step.channel_step_partials_plain(xr, xi, pi, pj, plan, lag))
    k8_bound = _bound(
        _fft_flops(nrows, nfft) + _detect_flops(nrows, nfft) + _pair_flops(chans * npairs, nfft, width),
        nrows * nfft * 8 + nrows * plan.segments * 8 + nrows * 4 + chans * npairs * width * 4,
    )
    print(
        f"phase 16: K8 [{chans}, {buoys}, {nfft}] -> partials + {list(k8[3].shape)}: vs plain window max|err| "
        f"{k8_abs:.3e} (rel {k8_rel:.3e}, tol 1e-4), noise floor {k8_nf:.3e} dB (tol 1e-3), candidate pattern "
        f"differs {k8_pattern:.2e} (tol 1e-3); vs K1 -> K2 (l2rx) bit-equal {k8_same}; kernel {k8_ms:.3f} ms, "
        f"plain {k8_plain_ms:.3f} ms (K1 + K2 {k1_ms + k2_ms:.3f}), bound {k8_bound[0]:.4f} ms ({k8_bound[1]}) {tag}"
    )
    _require(k8_rel <= 1e-4 and k8_nf <= 1e-3 and k8_pattern <= 1e-3, "K8 disagrees with its plain version")
    _require(all(k8_same.values()), f"K8 differs from K1 -> K2: {k8_same}")
    k8_plan = channel_step.pair_plan(nfft, *gcc_pair.window_rows(nfft, lag))
    k8_ptx = [r for r in build.ptxas_report(build.build_log()) if r["kernel"].startswith("channel_step_kernel<")]
    print(f"phase 16: K8's pair half: K2's body on 512 threads, {k8_plan.pairs} pair(s) a tile, {k8_plan.rows} rows a "
          f"chunk, {k8_plan.smem} B of its row's {nfft * 8} B of shared memory; "
          + "; ".join(f"{r['kernel']} {r['registers']} registers, spills {r['spill_stores']}/{r['spill_loads']} B"
                      for r in k8_ptx) + f", one 512-thread block an SM {tag}")
    _require(k8_plan.smem <= nfft * 8 and all(r["spill_stores"] == r["spill_loads"] == 0 for r in k8_ptx),
             f"K8's pair half: {k8_plan}, {k8_ptx}")
    del k8, p8, w12, fr1, fi1, s1, a1, nf1, rmax1, sre, sim_, smax, xr, xi
    torch.cuda.empty_cache()

    # ---- phase 17: the phase-4 scene on the mega and the two-kernel routes
    routes = {  # route → (knob, on, default, kernels launched per block)
        "mega": (channel_step.set_mega_fused, "on", "off", ["channel_step_partials"]),
        "two-kernel": (detect_ops.set_fused_fft_detect, "off", "auto",
                       ["fft_rows_ct", "detect_ct_partials", "gcc_pair_lag_mags"]),
    }
    scen = sim.default_scenario(signal="noise", bandwidth_hz=150e3, snr_db=25.0, seed=8)
    cap = sim.synthesize(scen)
    cfg4 = PipelineConfig(num_buoys=4, block_len=scen.block_len, sample_rate_hz=scen.sample_rate_hz,
                          max_lag=600, power_offset_db=40.0)
    host = [torch.from_numpy(a.astype(np.float32)) for a in (cap.iq.real, cap.iq.imag, cap.buoy_enu)]
    for route, (knob, on, default, kernels) in routes.items():
        knob(on)
        try:
            zero_counts()
            on_card = TDOAPipeline(cfg4, device=dev).step_split(*(a.to(dev) for a in host))
            torch.cuda.synchronize()
            got = {k: v for k, v in launch_counts().items() if v}
            on_cpu = TDOAPipeline(cfg4, device="cpu").step_split(*host)
        finally:
            knob(default)
        pos = on_card.fix.position_enu.cpu().numpy()
        err_m = float(np.linalg.norm(pos[:2] - cap.emitter_enu[0][:2]))
        fix_gap = float(np.abs(pos - on_cpu.fix.position_enu.numpy()).max())
        lag_gap = (on_card.correlation.lag_samples.cpu() - on_cpu.correlation.lag_samples).abs().max().item()
        same_peaks = bool((on_card.peaks.bin_index.cpu() == on_cpu.peaks.bin_index).all())
        print(
            f"phase 17: {route} route, scene fix error {err_m:.3f} m (limit 50), card vs CPU: fix {fix_gap:.3e} m "
            f"(tol 0.5), lags {lag_gap:.2e} samples, peaks equal {same_peaks}, launches {got} {tag}"
        )
        _require(err_m < 50.0, f"{route} route: scene fix error {err_m} m")
        _require(fix_gap <= 0.5, f"{route} route: card and CPU fixes differ by {fix_gap} m")
        _require(got == {**dict.fromkeys(kernels, 1), LM: 1}, f"{route} route launches {got}")

    # ---- phase 18: the flagship blocks on the mega and two-kernel routes
    stages = {
        "mega": ["decode", "channel_step", "peaks", "lag_peaks", "solve"],
        "two-kernel": ["decode", "spectra", "detect", "gcc_pair", "solve"],
    }
    route_launches = {}
    for route, (knob, on, default, kernels) in routes.items():
        knob(on)
        try:
            pipe.step_split_uint8(raw[0], anchors)  # warm-up
            torch.cuda.synchronize()
            zero_counts()
            t0 = time.perf_counter()
            out = pipe.step_split_uint8_scan(raw, anchors)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = {k: v for k, v in launch_counts().items() if v}
            med = _stage_split(
                torch, lambda mark: pipe.step_split_uint8(raw[0], anchors, on_stage=mark), stages[route]
            )
        finally:
            knob(default)
        finite = all(torch.isfinite(x).all().item() for x in _leaves(torch, out) if x.is_floating_point())
        print(
            f"phase 18: {route} route, {blocks} blocks x {chans} ch x {buoys} buoys x {n} uint8 IQ: "
            f"{1e3 * wall / blocks:.3f} ms/block (default route, phase 5: {default_ms_block:.3f}), "
            f"{blocks * chans * buoys * n / wall:.4e} IQ samples/s, launches {got} "
            f"({', '.join(f'{k} {v / blocks:g}' for k, v in got.items())} per block), all finite {finite} {tag}"
        )
        print(
            f"phase 18: {route} route stage split ms/block (median of 3, CUDA events): "
            + ", ".join(f"{k} {v:.3f}" for k, v in med.items())
            + f", sum {sum(med.values()):.3f} {tag}"
        )
        _require(out.fix.position_enu.shape == (blocks, chans, 3), f"{route} scan output shape")
        _require(finite, f"non-finite {route} outputs at full width")
        _require(got == {**dict.fromkeys(kernels, blocks), LM: blocks}, f"{route} route launches {got}")
        route_launches.update(got)
    del raw, out

    # ---- phase 19: rows past one block's shared memory (fault F3)
    def k3_cluster_report(nf, phase):
        g = fft_rows.long_geometry(nf)
        if g.design == "wide":
            ptx = {r["kernel"]: r for r in build.ptxas_report(build.build_log())}
            out = {}
            for detect in (True, False):
                info = fft_rows.wide_info(nf, detect)
                min_blocks = info["min_blocks"]
                spill = ptx[f"fft_detect_cluster_kernel<{g.n1}, {int(detect)}, {min_blocks}, 0>"]
                out["K1" if detect else "K3"] = {**info, "spill_bytes": spill["spill_stores"] + spill["spill_loads"]}
                print(f"phase {phase}: {'K1' if detect else 'K3'} wide design at nfft {nf} = {g.n1}·{g.n2}: one "
                      f"launch, c = {info['c']} blocks a row, r = {g.r}, {info['smem']} B of shared memory a block, "
                      f"{info['registers']} registers, spills {spill['spill_stores']}/{spill['spill_loads']} B, "
                      f"local memory {info['local_bytes']} B, {info['blocks']} blocks of {fft_rows.WIDE_THREADS} "
                      f"threads an SM, cudaOccupancyMaxActiveClusters {info['clusters']} {tag}")
                _require(info["clusters"] > 0 and info["registers"] <= 65_536 // (min_blocks * fft_rows.WIDE_THREADS)
                         and info["blocks"] == fft_rows.wide_blocks(g.n1, g.n2, detect) <= min_blocks,
                         f"the wide design at {nf}: {info}")
            return out
        if g.design != "cluster":
            print(f"phase {phase}: K3 long design at nfft {nf} = {g.n1}·{g.n2}: {g.design} (two passes) {tag}")
            return
        info = fft_rows.cluster_info(nf)
        print(f"phase {phase}: K3 long design at nfft {nf} = {g.n1}·{g.n2}: cluster, c = {info['c']} blocks a row, "
              f"{g.cols}-column tiles, r = {g.r}, {info['smem']} B of shared memory a block, "
              f"cudaOccupancyMaxActiveClusters {info['clusters']} {tag}")
        _require(info["clusters"] > 0, f"K3's cluster at {nf} does not fit the card")

    long_cfg = PipelineConfig(num_buoys=buoys, block_len=32_768, sample_rate_hz=fs, max_lag=600)
    long_pipe = TDOAPipeline(long_cfg, device=dev)
    lraw, lanchors = long_pipe.example_inputs(batch=(4, chans), seed=0, uint8=True)
    lanchors = lanchors[0]
    lre, lim = iq.decode_uint8_split(lraw[0])  # [chans, buoys, 32768]
    wraw, _ = TDOAPipeline(dataclasses.replace(long_cfg, block_len=65_536), device=dev).example_inputs(
        batch=(chans,), seed=0, uint8=True)
    wre, wim = iq.decode_uint8_split(wraw)  # [chans, buoys, 65536]
    del wraw
    fill = lambda a, nf: F.pad(a, (0, nf - a.shape[-1])).reshape(-1, nf).contiguous()
    long_shapes = {  # nfft -> rows: flagship block 0 at block_len 32768 (max_lag 600, 2048) and 65536
        33_792: (fill(lre, 33_792), fill(lim, 33_792)),
        34_816: (fill(lre, 34_816), fill(lim, 34_816)),
        66_560: (fill(wre, 66_560), fill(wim, 66_560)),
    }
    del wre, wim
    long_rows, long_row_count = {}, {}
    for ln, (lxr, lxi) in long_shapes.items():
        lplan = ct_plan.detect_plan(
            ln, sample_rate_hz=fs, threshold_db=-70.0, min_distance_bins=10,
            dc_notch_hz=10_000.0, confidence_floor=0.3, snr_fullscale_db=20.0,
        )
        rows_l = lxr.shape[0]
        _require(fft_rows.geometry(ln) == "long" and fft_detect.geometry(ln) == "cluster", f"nfft {ln}: designs")
        k3_cluster_report(ln, 19)
        k1_cluster[ln] = _k1_cluster_report(torch, ln, lxr, lxi, lplan, 19, tag)
        designs = lambda: (fft_rows.design_counts["long"], detect_ct.launch_count, fft_detect.design_counts["cluster"])
        before = designs()
        l3 = fft_rows.fft_rows_ct(lxr, lxi)
        l4 = detect_ct.detect_ct_partials(*l3, lplan)
        l1 = fft_detect.fft_detect_rows_ct(lxr, lxi, lplan)
        torch.cuda.synchronize()
        ran_long = tuple(a - b for a, b in zip(designs(), before)) == (1, 1, 1)
        p3l = fft_rows.fft_rows_ct_plain(lxr, lxi)
        l3_abs, l3_rel = _row_rel_error(l3, p3l)
        del p3l
        l4e = _partials_errors(torch, l4, detect_ct.detect_ct_partials_plain(*l3, lplan), *l3)
        p1l = fft_detect.fft_detect_rows_ct_plain(lxr, lxi, lplan)
        l1_abs, l1_rel = _row_rel_error(l1[:2], p1l[:2])
        l1e = _partials_errors(torch, l1[2:5], p1l[2:5], *p1l[:2])
        l1_rmax = ((l1[5] - p1l[5]).abs() / p1l[5]).max().item()
        del p1l
        del l1
        l3_ms = _cuda_ms(torch, lambda: fft_rows.fft_rows_ct(lxr, lxi))
        l3_plain_ms = _cuda_ms(torch, lambda: fft_rows.fft_rows_ct_plain(lxr, lxi))
        lxc = torch.complex(lxr, lxi)
        lperm = torch.as_tensor(ct_plan.ct_permutation(ln), device=dev)
        l3_lib_ms = _cuda_ms(torch, lambda: torch.fft.fft(lxc)[:, lperm])
        del lxc
        l4_ms = _cuda_ms(torch, lambda: detect_ct.detect_ct_partials(*l3, lplan))
        l4_plain_ms = _cuda_ms(torch, lambda: detect_ct.detect_ct_partials_plain(*l3, lplan))
        l1_ms = _cuda_ms(torch, lambda: fft_detect.fft_detect_rows_ct(lxr, lxi, lplan))
        l1_plain_ms = _cuda_ms(torch, lambda: fft_detect.fft_detect_rows_ct_plain(lxr, lxi, lplan))
        segs = rows_l * lplan.segments
        long_row_count[ln] = rows_l
        long_rows[ln] = {
            "K3": (l3_abs, l3_ms, l3_plain_ms, _bound(_fft_flops(rows_l, ln), 2 * 8 * rows_l * ln), l3_lib_ms),
            "K4": (max(l4e[3], l4e[2]), l4_ms, l4_plain_ms,
                   _bound(_detect_flops(rows_l, ln), rows_l * ln * 8 + segs * 8 + rows_l * 4), None),
            "K1": (l1_abs, l1_ms, l1_plain_ms,
                   _bound(_fft_flops(rows_l, ln) + _detect_flops(rows_l, ln), rows_l * ln * 16 + segs * 8 + rows_l * 8),
                   None),
        }
        n1l, n2l = ct_plan.ct_split(ln)
        for name, (err, ms, pms, bnd, lib) in long_rows[ln].items():
            print(
                f"phase 19: long {name} [{rows_l}, {ln}] ({n1l}·{n2l}): max|err| {err:.3e}; kernel {ms:.3f} ms, plain "
                f"{pms:.3f} ms, bound {bnd[0]:.4f} ms ({bnd[1]})"
                + (f", torch.fft.fft + CT permutation {lib:.3f} ms" if lib is not None else "") + f" {tag}"
            )
        print(
            f"phase 19: [{rows_l}, {ln}] K3 spectra rel to row max|X| {l3_rel:.3e} (tol 1e-4); K4 on K3's spectra: "
            f"pattern differs {l4e[0]:.2e}, argmax differs {l4e[1]:.2e} (tol 1e-3 each), floor {l4e[2]:.3e} dB "
            f"(tol 1e-3), score rel {l4e[4]:.3e} (tol 1e-4); K1 spectra rel {l1_rel:.3e}, floor {l1e[2]:.3e} dB, row "
            f"max rel {l1_rmax:.3e} (tol 1e-5), pattern {l1e[0]:.2e}, argmax {l1e[1]:.2e}, score rel {l1e[4]:.3e}; "
            f"K3, K4 and K1's cluster design ran: {ran_long} (K1 = K3 -> K4 bit for bit above) {tag}"
        )
        _require(ran_long, f"the long designs did not run at {ln}")
        _require(l3_rel <= 1e-4 and l1_rel <= 1e-4, f"long K3/K1 spectra disagree at {ln}: {l3_rel}, {l1_rel}")
        for e in (l4e, l1e):
            _require(e[0] <= 1e-3 and e[1] <= 1e-3 and e[2] <= 1e-3 and e[4] <= 1e-4 and e[5],
                     f"K4/long K1 partials disagree at {ln}: {e}")
        _require(l1_rmax <= 1e-5, f"long K1 row max disagrees at {ln}: {l1_rmax}")
        del l3, l4
    del long_shapes, lxr, lxi

    # the long K3 and K1 forced onto lengths the one-block designs take; K4 there
    fraw, _ = pipe.example_inputs(batch=(1, chans), seed=0, uint8=True)
    fre_, fim_ = iq.decode_uint8_split(fraw[0])
    forced = {17_408: (fill(fre_, 17_408), fill(fim_, 17_408)),
              24_576: (fill(lre[..., :24_064], 24_576), fill(lim[..., :24_064], 24_576))}
    del fraw, fre_, fim_
    for fn_, (fxr, fxi) in forced.items():
        fplan = ct_plan.detect_plan(
            fn_, sample_rate_hz=fs, threshold_db=-70.0, min_distance_bins=10,
            dc_notch_hz=10_000.0, confidence_floor=0.3, snr_fullscale_db=20.0,
        )
        b3 = fft_rows.fft_rows_ct(fxr, fxi)
        b1 = fft_detect.block_detect(fxr, fxi, fplan)  # the one-block K1 (the route takes the cluster design)
        same = {
            "K3": all(torch.equal(x, y) for x, y in zip(fft_rows.fft_rows_ct_long(fxr, fxi), b3)),
            "K4": all(torch.equal(x, y) for x, y in zip(detect_ct.detect_ct_partials(*b3, fplan), b1[2:5])),
            "K1": all(torch.equal(x, y) for x, y in zip(fft_detect.fft_detect_rows_ct_long(fxr, fxi, fplan), b1)),
        }
        torch.cuda.synchronize()
        f_ms = {
            "K3 block": _cuda_ms(torch, lambda: fft_rows.fft_rows_ct(fxr, fxi)),
            "K3 long": _cuda_ms(torch, lambda: fft_rows.fft_rows_ct_long(fxr, fxi)),
            "K1 block": _cuda_ms(torch, lambda: fft_detect.block_detect(fxr, fxi, fplan)),
            "K1 long": _cuda_ms(torch, lambda: fft_detect.fft_detect_rows_ct_long(fxr, fxi, fplan)),
        }
        print(
            f"phase 19: long K3, K1 forced onto [{fxr.shape[0]}, {fn_}], K4 on K3's spectra: bit-equal to the "
            f"one-block K3, K1 and K1's partials {same}; "
            + ", ".join(f"{k} {v:.3f} ms" for k, v in f_ms.items()) + f" {tag}"
        )
        _require(all(same.values()), f"long designs differ from the one-block designs at {fn_}: {same}")
        del b3, b1
    del forced, fxr, fxi, lre, lim

    # the phase-4 scene at block_len 32768 on the default and two-kernel routes
    scen32 = sim.default_scenario(signal="noise", bandwidth_hz=150e3, snr_db=25.0, seed=8, block_len=32_768)
    cap32 = sim.synthesize(scen32)
    cfg32 = PipelineConfig(num_buoys=4, block_len=32_768, sample_rate_hz=scen32.sample_rate_hz, max_lag=600,
                           power_offset_db=40.0)
    host32 = [torch.from_numpy(a.astype(np.float32)) for a in (cap32.iq.real, cap32.iq.imag, cap32.buoy_enu)]
    for route, (knob, on, default, kernels) in (("default", (detect_ops.set_fused_fft_detect, "auto", "auto",
                                                            ["fft_detect_rows_ct", "gcc_pair_lag_mags"])),
                                               ("two-kernel", routes["two-kernel"])):
        knob(on)
        try:
            zero_counts()
            longs = (fft_detect.design_counts["cluster"], fft_rows.design_counts["long"], detect_ct.launch_count)
            on_card = TDOAPipeline(cfg32, device=dev).step_split(*(a.to(dev) for a in host32))
            torch.cuda.synchronize()
            got = {k: v for k, v in launch_counts().items() if v}
            longs = tuple(a - b for a, b in zip(
                (fft_detect.design_counts["cluster"], fft_rows.design_counts["long"], detect_ct.launch_count),
                longs))
            on_cpu = TDOAPipeline(cfg32, device="cpu").step_split(*host32)
        finally:
            knob(default)
        pos = on_card.fix.position_enu.cpu().numpy()
        err_m = float(np.linalg.norm(pos[:2] - cap32.emitter_enu[0][:2]))
        fix_gap = float(np.abs(pos - on_cpu.fix.position_enu.numpy()).max())
        lag_gap = (on_card.correlation.lag_samples.cpu() - on_cpu.correlation.lag_samples).abs().max().item()
        same_peaks = bool((on_card.peaks.bin_index.cpu() == on_cpu.peaks.bin_index).all())
        print(
            f"phase 19: scene at block_len 32768 (nfft 33792), {route} route: fix error {err_m:.3f} m (limit 50), "
            f"card vs CPU: fix {fix_gap:.3e} m (tol 0.5), lags {lag_gap:.2e} samples (tol 1e-3), peaks equal "
            f"{same_peaks}, launches {got}, K1 cluster design, long K3, K4 {longs} {tag}"
        )
        _require(err_m < 50.0 and fix_gap <= 0.5 and lag_gap <= 1e-3 and same_peaks,
                 f"block_len 32768 scene, {route} route: card and CPU disagree")
        _require(got == {**dict.fromkeys(kernels, 1), LM: 1}, f"block_len 32768 {route} route launches {got}")
        _require(longs == ((1, 0, 0) if route == "default" else (0, 1, 1)), f"{route} route long designs {longs}")

    # the flagship at full width at block_len 32768: 4 blocks, default route
    lblocks = 4
    long_pipe.step_split_uint8(lraw[0], lanchors)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    k1_designs0 = dict(fft_detect.design_counts)
    t0 = time.perf_counter()
    lout = long_pipe.step_split_uint8_scan(lraw, lanchors)
    torch.cuda.synchronize()
    lwall = time.perf_counter() - t0
    long_launches = {k: v for k, v in launch_counts().items() if v}
    k1_designs32 = {k: v - k1_designs0[k] for k, v in fft_detect.design_counts.items() if v != k1_designs0[k]}
    lfinite = all(torch.isfinite(x).all().item() for x in _leaves(torch, lout) if x.is_floating_point())
    print(
        f"phase 19: flagship at block_len 32768, {lblocks} blocks x {chans} ch x {buoys} buoys x 32768 uint8 IQ "
        f"(nfft {long_pipe.plan.nfft}): {1e3 * lwall / lblocks:.3f} ms/block (real time "
        f"{1e3 * 32_768 / fs:.3f}), {lblocks * chans * buoys * 32_768 / lwall:.4e} IQ samples/s, peak mem "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB, launches {long_launches}, K1 by design "
        f"{k1_designs32}, all finite {lfinite} {tag}"
    )
    _require(tuple(lout.fix.position_enu.shape) == (lblocks, chans, 3) and lfinite, "block_len 32768 outputs")
    _require(long_launches == {"fft_detect_rows_ct": lblocks, "gcc_pair_lag_mags": lblocks, LM: lblocks}
             and k1_designs32 == {"cluster": lblocks}, f"block_len 32768 launches {long_launches}, K1 {k1_designs32}")
    med = _stage_split(
        torch, lambda mark: long_pipe.step_split_uint8(lraw[0], lanchors, on_stage=mark),
        ["decode", "fft_detect", "peaks", "gcc_pair", "solve"],
    )
    print(
        "phase 19: block_len 32768 stage split ms/block (median of 3, CUDA events): "
        + ", ".join(f"{k} {v:.3f}" for k, v in med.items())
        + f", sum {sum(med.values()):.3f}, before the solve {sum(v for k, v in med.items() if k != 'solve'):.3f} {tag}"
    )
    combined_topk.append(_combined_topk_report(torch, long_pipe, lraw, lanchors, lout, 32_768, 19, tag))
    del lraw, lout

    # ---- phase 20: the mixed-radix inner lengths (n1 = 384, 640, 896: the
    # lengths that were fault F3b; K1 and K3 there are the wide design at
    # every planned n1 = 640/896 length, beside the parent's workspace K3 ->
    # K4) and the in-kernel top-K (T1, emit_topk)
    mcfg = PipelineConfig(num_buoys=buoys, block_len=57_344, sample_rate_hz=fs, max_lag=600)
    mpipe = TDOAPipeline(mcfg, device=dev)
    mnfft = mpipe.plan.nfft
    _require(mnfft == 58_368 and ct_plan.ct_split(mnfft) == (384, 152), f"block_len 57344 plans nfft {mnfft}")
    mraw, manchors = mpipe.example_inputs(batch=(4, chans), seed=0, uint8=True)
    manchors = manchors[0]
    mre, mim = iq.decode_uint8_split(mraw[0])  # [chans, buoys, 57344]
    # the flagship's inputs at block_len 57344 and 96000 (phase 39's path),
    # each padded to its nfft: K1 and K2 run on them at the path's shapes
    pipe96_20 = TDOAPipeline(PipelineConfig(num_buoys=buoys, block_len=96_000, sample_rate_hz=fs, max_lag=600),
                             device=dev)
    raw96_20, _ = pipe96_20.example_inputs(batch=(1, chans), seed=0, uint8=True)
    flagship_rows = {mnfft: (mre, mim, mpipe.plan), 97_280: (*iq.decode_uint8_split(raw96_20[0]), pipe96_20.plan)}
    del raw96_20
    gen = torch.Generator(device=dev).manual_seed(20)
    noise_rows = lambda r, nf: (40.0 * torch.randn(r, nf, device=dev, generator=gen),
                                40.0 * torch.randn(r, nf, device=dev, generator=gen))
    mixed_rows = {}  # K3 and K1 at the mixed-radix row passes
    wide_report = {}  # the wide design's shape (K1, K3) at each length
    wide_vs_workspace = []  # K1 and K3 beside the parent's design, the workspace K3 (-> K4), in this call
    for rows_m, mn in ((1024, 58_368), (512, 87_040), (1024, 97_280), (256, 117_760), (256, 128_000),
                       (1024, 121_856)):
        mxr, mxi = (fill(flagship_rows[mn][0], mn), fill(flagship_rows[mn][1], mn)) if mn in flagship_rows \
            else noise_rows(rows_m, mn)
        n1m, n2m = ct_plan.ct_split(mn)
        wide_report[mn] = k3_cluster_report(mn, 20)
        key = "wide" if fft_rows.long_geometry(mn).design == "wide" else "long"
        before = fft_rows.design_counts[key]
        m3 = fft_rows.fft_rows_ct(mxr, mxi)
        torch.cuda.synchronize()
        _require(fft_rows.design_counts[key] == before + 1, f"the long K3 did not run its {key} design at {mn}")
        pm3 = fft_rows.fft_rows_ct_plain(mxr, mxi)
        m3_abs, m3_rel = _row_rel_error(m3, pm3)
        del pm3
        m3_ms = _cuda_ms(torch, lambda: fft_rows.fft_rows_ct(mxr, mxi))
        m3_plain_ms = _cuda_ms(torch, lambda: fft_rows.fft_rows_ct_plain(mxr, mxi))
        mxc = torch.complex(mxr, mxi)
        mperm = torch.as_tensor(ct_plan.ct_permutation(mn), device=dev)
        m3_lib_ms = _cuda_ms(torch, lambda: torch.fft.fft(mxc)[:, mperm])
        del mxc
        m3_bound = _bound(_fft_flops(rows_m, mn), 2 * 8 * rows_m * mn)
        mixed_rows[("K3", mn)] = ([rows_m, mn], m3_abs, m3_ms, m3_plain_ms, m3_bound, m3_lib_ms)
        print(
            f"phase 20: long K3 [{rows_m}, {mn}] ({n1m}·{n2m}, P = {n1m // 32} a lane): spectra max|err| {m3_abs:.3e} "
            f"(rel to row max|X| {m3_rel:.3e}, tol 1e-4); kernel {m3_ms:.3f} ms, plain {m3_plain_ms:.3f} ms, "
            f"torch.fft.fft + CT permutation {m3_lib_ms:.3f} ms, bound {m3_bound[0]:.4f} ms ({m3_bound[1]}) {tag}"
        )
        _require(m3_rel <= 1e-4, f"long K3 spectra disagree at {mn}: {m3_rel}")
        # K1's long rows there: the wide design, one launch, = K3 -> K4 bit for bit
        mplan = flagship_rows[mn][2] if mn in flagship_rows else ct_plan.detect_plan(
            mn, sample_rate_hz=fs, threshold_db=-70.0, min_distance_bins=10, dc_notch_hz=10_000.0,
            confidence_floor=0.3, snr_fullscale_db=20.0)
        k1_counts = lambda: (fft_detect.launch_count, fft_detect.design_counts["wide"], fft_rows.launch_count,
                             detect_ct.launch_count)
        before = k1_counts()
        m1 = fft_detect.fft_detect_rows_ct(mxr, mxi, mplan)
        torch.cuda.synchronize()
        m1_one_launch = tuple(a - b for a, b in zip(k1_counts(), before)) == (1, 1, 0, 0)
        m4 = detect_ct.detect_ct_partials(*m3, mplan)
        w3 = fft_rows.workspace_rows(mxr, mxi)  # the parent's design: workspace K3, then K4
        w4 = detect_ct.launch(*w3, mplan, row_max=True)
        torch.cuda.synchronize()
        m1_is_k3k4 = all(torch.equal(x, y) for x, y in zip(m1[:5], (*m3, *m4)))
        m1_is_ws = all(torch.equal(x, y) for x, y in zip((*m3, *m1), (*w3, *w3, *w4)))
        del w3, w4
        ws3_ms = _cuda_ms(torch, lambda: fft_rows.workspace_rows(mxr, mxi))
        ws34_ms = _cuda_ms(torch, lambda: detect_ct.launch(*fft_rows.workspace_rows(mxr, mxi), mplan, row_max=True))
        pm1 = fft_detect.fft_detect_rows_ct_plain(mxr, mxi, mplan)
        m1e = _partials_errors(torch, m1[2:5], pm1[2:5], *pm1[:2])
        m1_abs = _row_rel_error(m1[:2], pm1[:2])[0]
        del pm1
        m1_ms = _cuda_ms(torch, lambda: fft_detect.fft_detect_rows_ct(mxr, mxi, mplan))
        m1_plain_ms = _cuda_ms(torch, lambda: fft_detect.fft_detect_rows_ct_plain(mxr, mxi, mplan))
        m1_bound = _bound(_fft_flops(rows_m, mn) + _detect_flops(rows_m, mn),
                          rows_m * mn * 16 + rows_m * mplan.segments * 8 + rows_m * 8)
        mixed_rows[("K1", mn)] = ([rows_m, mn], m1_abs, m1_ms, m1_plain_ms, m1_bound, None)
        print(
            f"phase 20: long K1 [{rows_m}, {mn}]: one launch of the wide design (no K4): {m1_one_launch}; "
            f"= K3 -> K4 bit for bit: {m1_is_k3k4}; K3 and K1 = the workspace K3 -> K4 bit for bit: {m1_is_ws}; "
            f"vs plain: floor {m1e[2]:.3e} dB, pattern {m1e[0]:.2e}, argmax {m1e[1]:.2e}, score rel "
            f"{m1e[4]:.3e}; kernel {m1_ms:.3f} ms, plain {m1_plain_ms:.3f} ms, bound {m1_bound[0]:.4f} ms "
            f"({m1_bound[1]}) {tag}"
        )
        wide_vs_workspace.append({"shape": [rows_m, mn], "K1_ms": m1_ms, "K3_ms": m3_ms, "workspace_K3_ms": ws3_ms,
                                  "workspace_K3_K4_ms": ws34_ms})
        print(f"phase 20: [{rows_m}, {mn}] in this call: wide K1 {m1_ms:.3f} ms against the parent's design "
              f"(workspace K3 -> K4) {ws34_ms:.3f} ms ({ws34_ms / m1_ms:.2f}x); wide K3 {m3_ms:.3f} ms against the "
              f"workspace K3 {ws3_ms:.3f} ms ({ws3_ms / m3_ms:.2f}x) {tag}")
        _require(m1_one_launch, f"long K1 at {mn} is not one launch of the wide design")
        _require(m1_is_k3k4 and m1_is_ws, f"long K1 differs from K3 -> K4 at {mn}")
        # rows of a receiver with no signal: zeros and an impulse, whose powers
        # are all equal (more than 512 of the floor's values share one histogram
        # bucket, so block 0 takes rm_det::bisect_floor), and a constant offset
        flat = torch.zeros((2, 3, mn), dtype=torch.float32, device=dev)
        flat[0, 1, 0], flat[0, 2], flat[1, 2] = 1.0, 0.25, -0.5
        f1 = fft_detect.fft_detect_rows_ct(flat[0], flat[1], mplan)
        fw3 = fft_rows.workspace_rows(flat[0], flat[1])
        fw4 = detect_ct.launch(*fw3, mplan, row_max=True)
        sub = (fw3[0] * fw3[0] + fw3[1] * fw3[1]).view(3, n2m, n1m)[:2, ::8]  # CT rows k2 = 0 mod 8
        flat_ties = min(int(torch.unique(x, return_counts=True)[1].max()) for x in sub)
        flat_is_ws = all(torch.equal(x, y) for x, y in zip(f1, (*fw3, *fw4)))
        del flat, f1, fw3, fw4, sub
        print(f"phase 20: long K1 on rows with no signal (zeros and an impulse, at least {flat_ties} equal "
              f"floor values a row: the bisection's fallback; a constant): = the workspace K3 -> K4 bit for bit: "
              f"{flat_is_ws}")
        _require(flat_ties > 512 and flat_is_ws, f"long K1's floor fallback differs at {mn}: {flat_ties}")
        _require(m1e[0] <= 1e-3 and m1e[1] <= 1e-3 and m1e[2] <= 1e-3 and m1e[4] <= 1e-4 and m1e[5],
                 f"long K1 partials disagree at {mn}: {m1e}")
        if mn in flagship_rows:  # K2 at the flagship's own shapes, fed these K1 outputs, as phase 3 does at 17408
            m2in = (m1[0].view(chans, buoys, mn), m1[1].view(chans, buoys, mn), m1[5].view(chans, buoys), pi, pj)
            m2 = gcc_pair.gcc_pair_lag_mags(*m2in, max_lag=600)
            pm2 = gcc_pair.gcc_pair_lag_mags_plain(*m2in, max_lag=600)
            torch.cuda.synchronize()
            m2_abs, m2_rel = _window_errors(m2, pm2)
            m2_arg = bool((m2.argmax(-1) == pm2.argmax(-1)).all())
            del pm2
            m2_ms = _cuda_ms(torch, lambda: gcc_pair.gcc_pair_lag_mags(*m2in, max_lag=600))
            m2_plain_ms = _cuda_ms(torch, lambda: gcc_pair.gcc_pair_lag_mags_plain(*m2in, max_lag=600))
            m2_bound = _bound(_pair_flops(chans * npairs, mn, 1201),
                              rows_m * mn * 8 + rows_m * 4 + chans * npairs * 1201 * 4)
            mixed_rows[("K2", ("flagship", mn))] = ([chans, buoys, mn], m2_abs, m2_ms, m2_plain_ms, m2_bound, None)
            print(
                f"phase 20: K2 at n1 = {n1m}, [{chans}, {buoys}, {mn}] (the flagship's shape, fed long K1) -> "
                f"{list(m2.shape)} window max|err| {m2_abs:.3e} (rel to window max {m2_rel:.3e}, tol 1e-4), same "
                f"argmax {m2_arg}; kernel {m2_ms:.3f} ms, plain {m2_plain_ms:.3f} ms, bound {m2_bound[0]:.4f} ms "
                f"({m2_bound[1]}) {tag}"
            )
            _require(tuple(m2.shape) == (chans, npairs, 1201), f"K2 output shape at {mn}")
            _require(m2_rel <= 1e-4 and m2_arg, f"K2 lag windows disagree at the flagship's shape {mn}: {m2_rel}")
            del m2, m2in
        del m1, m4, m3, mxr, mxi
    del flagship_rows, pipe96_20

    # K2 and K5 (the pair body's mixed-radix inverse) and K8's long design
    for name, c_m, b_m, mn in (("K2", 16, 8, 58_368), ("K2", 8, 8, 121_856), ("K5", 1, 64, 58_368)):
        sre_m, sim_m, smax_m = _ct_spectra(torch, ct_plan, c_m, b_m, mn, dev, seed=mn % 97)
        pi_m, pj_m = gcc_phat.pair_indices(b_m)
        if name == "K2":
            run = lambda: gcc_pair.gcc_pair_lag_mags(sre_m, sim_m, smax_m, pi_m, pj_m, max_lag=600)
            plain = lambda: gcc_pair.gcc_pair_lag_mags_plain(sre_m, sim_m, smax_m, pi_m, pj_m, max_lag=600)
        else:
            s2_m = smax_m[:, pi_m] * smax_m[:, pj_m]
            run = lambda: gcc_pair.gcc_pairs_onehot_lag_mags(sre_m, sim_m, pi_m, pj_m, max_lag=600, s2=s2_m)
            plain = lambda: gcc_pair.gcc_pairs_onehot_lag_mags_plain(sre_m, sim_m, pi_m, pj_m, max_lag=600, s2=s2_m)
        km, pm = run(), plain()
        torch.cuda.synchronize()
        km_abs, km_rel = _window_errors(km, pm)
        km_arg = bool((km.argmax(-1) == pm.argmax(-1)).all())
        km_ms, km_plain_ms = _cuda_ms(torch, run), _cuda_ms(torch, plain)
        npm = c_m * len(pi_m)
        km_bound = _bound(_pair_flops(npm, mn, 1201), c_m * b_m * mn * 8 + npm * 4 + npm * 1201 * 4)
        mixed_rows[(name, mn)] = ([c_m, b_m, mn], km_abs, km_ms, km_plain_ms, km_bound, None)
        print(
            f"phase 20: {name} at n1 = {ct_plan.ct_split(mn)[0]}, [{c_m}, {b_m}, {mn}] -> {list(km.shape)} window "
            f"max|err| {km_abs:.3e} (rel to window max {km_rel:.3e}, tol 1e-4), same argmax {km_arg}; kernel "
            f"{km_ms:.3f} ms, plain {km_plain_ms:.3f} ms, bound {km_bound[0]:.4f} ms ({km_bound[1]}) {tag}"
        )
        _require(km_rel <= 1e-4 and km_arg, f"{name} lag windows disagree at {mn}: {km_rel}")
        del km, pm, sre_m, sim_m, smax_m
    for k8n in (mnfft, 121_856):  # K8's long design at n1 = 384 (the flagship's rows) and 896 (noise rows)
        if k8n == mnfft:
            m8r, m8i = (fill(a[:16], mnfft).view(16, buoys, mnfft) for a in (mre, mim))
            k8plan = mpipe.plan
        else:
            m8r, m8i = (x.view(16, buoys, k8n) for x in noise_rows(16 * buoys, k8n))
            k8plan = ct_plan.detect_plan(k8n, sample_rate_hz=fs, threshold_db=-70.0, min_distance_bins=10,
                                         dc_notch_hz=10_000.0, confidence_floor=0.3, snr_fullscale_db=20.0)
        _require(channel_step.geometry(k8n) == "long", f"K8 at {k8n} is not its long design")
        before = (channel_step.launch_count, channel_step.design_counts["long"])
        k8m = channel_step.channel_step_partials(m8r, m8i, pi, pj, k8plan, 600)
        torch.cuda.synchronize()
        k8_long_ran = (channel_step.launch_count - before[0], channel_step.design_counts["long"] - before[1]) == (1, 1)
        c1 = fft_detect.fft_detect_rows_ct(m8r.view(-1, k8n), m8i.view(-1, k8n), k8plan)
        c2 = gcc_pair.gcc_pair_lag_mags(c1[0].view(16, buoys, k8n), c1[1].view(16, buoys, k8n),
                                        c1[5].view(16, buoys), pi, pj, max_lag=600)
        k8m_same = all(torch.equal(x.reshape(y.shape), y) for x, y in zip(k8m, (*c1[2:5], c2)))
        p8m = channel_step.channel_step_partials_plain(m8r, m8i, pi, pj, k8plan, 600)
        k8m_abs, k8m_rel = _window_errors(k8m[3], p8m[3])
        k8m_nf = (k8m[2] - p8m[2]).abs().max().item()
        del p8m, c1, c2
        k8m_ms = _cuda_ms(torch, lambda: channel_step.channel_step_partials(m8r, m8i, pi, pj, k8plan, 600))
        k8m_plain_ms = _cuda_ms(torch, lambda: channel_step.channel_step_partials_plain(m8r, m8i, pi, pj, k8plan, 600))
        mrows8 = 16 * buoys
        k8m_bound = _bound(
            _fft_flops(mrows8, k8n) + _detect_flops(mrows8, k8n) + _pair_flops(16 * npairs, k8n, 1201),
            mrows8 * k8n * 8 + mrows8 * (k8n // 8) * 8 + mrows8 * 4 + 16 * npairs * 1201 * 4,
        )
        mixed_rows[("K8", k8n)] = ([16, buoys, k8n], k8m_abs, k8m_ms, k8m_plain_ms, k8m_bound, None)
        print(
            f"phase 20: K8 long design [16, {buoys}, {k8n}] (the wide K1, then K2, as one K8 launch: {k8_long_ran}): "
            f"= K1 -> K2 (l2rx) bit for bit: {k8m_same}; vs plain window max|err| {k8m_abs:.3e} (rel {k8m_rel:.3e}, "
            f"tol 1e-4), floor {k8m_nf:.3e} dB; kernel {k8m_ms:.3f} ms, plain {k8m_plain_ms:.3f} ms, bound "
            f"{k8m_bound[0]:.4f} ms ({k8m_bound[1]}) {tag}"
        )
        _require(k8_long_ran and k8m_same, f"K8's long design at {k8n} is not K1 -> K2")
        _require(k8m_rel <= 1e-4 and k8m_nf <= 1e-3, f"K8 long design disagrees with its plain version at {k8n}: {k8m_rel}")
        del k8m, m8r, m8i

    # T1: K1 and K4 with emit_topk = 8. K1 is one launch of its cluster
    # design (n1 = 128/256) or wide design (384/640/896) at every length,
    # held bit for bit against the parent's T1 design in this call (the
    # one-block K1 up to 24576, the long K3 then K4's top-K phase above)
    # and against its own partials + the port's top-K tail; K = 128 too
    traw, _ = pipe.example_inputs(batch=(1, chans), seed=0, uint8=True)
    t17 = iq.decode_uint8_split(traw[0])
    traw, _ = long_pipe.example_inputs(batch=(1, chans), seed=0, uint8=True)
    t33 = iq.decode_uint8_split(traw[0])
    traw, _ = TDOAPipeline(PipelineConfig(num_buoys=buoys, block_len=96_000, sample_rate_hz=fs, max_lag=600),
                           device=dev).example_inputs(batch=(1, chans), seed=0, uint8=True)
    t97 = iq.decode_uint8_split(traw[0])
    del traw
    topk_rows = {}
    t1_sources = {17_408: t17, 33_792: t33, 34_816: t33, 66_560: None, mnfft: (mre, mim), 97_280: t97}
    for tn, tsrc in t1_sources.items():
        txr, txi = (fill(tsrc[0], tn), fill(tsrc[1], tn)) if tsrc is not None else noise_rows(1024, tn)
        tplan = ct_plan.detect_plan(
            tn, sample_rate_hz=fs, threshold_db=-70.0, min_distance_bins=10,
            dc_notch_hz=10_000.0, confidence_floor=0.3, snr_fullscale_db=20.0,
        )
        tdesign = fft_detect.geometry(tn, emit_topk=8)
        short = tn <= fft_detect.MAX_N

        def t1_parent(k=8):  # the parent's T1 design
            if short:
                return fft_detect.block_detect(txr, txi, tplan, k)
            f3 = fft_rows.long_rows(txr, txi)
            return (*f3, *detect_ct.launch(*f3, tplan, row_max=True, emit_topk=k))

        tcounts = lambda: (fft_detect.launch_count, fft_rows.launch_count, detect_ct.launch_count,
                           fft_detect.design_counts[tdesign])
        before = tcounts()
        t1 = fft_detect.fft_detect_rows_ct(txr, txi, tplan, emit_topk=8)
        torch.cuda.synchronize()
        t1_one = tuple(a - b for a, b in zip(tcounts(), before)) == (1, 0, 0, 1)
        t0_ = fft_detect.fft_detect_rows_ct(txr, txi, tplan)
        t4 = detect_ct.detect_ct_partials(t0_[0], t0_[1], tplan, emit_topk=8)
        tail = fft_detect.topk_plain(t0_[2], t0_[3], 8)
        t128 = fft_detect.fft_detect_rows_ct(txr, txi, tplan, emit_topk=128)
        tail128 = fft_detect.topk_plain(t0_[2], t0_[3], 128)
        torch.cuda.synchronize()
        same = {
            "K1 = parent design": all(torch.equal(x, y) for x, y in zip(t1, t1_parent())),
            "K1 = partials + tail": all(torch.equal(x, y) for x, y in zip(t1, (*t0_[:2], *tail, *t0_[4:]))),
            "K1 (K = 128) = parent design": all(torch.equal(x, y) for x, y in zip(t128, t1_parent(128))),
            "K1 (K = 128) = partials + tail": all(torch.equal(x, y) for x, y in zip(t128[2:4], tail128)),
            "K4": all(torch.equal(x, y) for x, y in zip(t4, (*tail, t0_[4]))),
        }
        del t128, tail128
        tp1 = fft_detect.fft_detect_rows_ct_plain(txr, txi, tplan, emit_topk=8)
        tp4 = detect_ct.detect_ct_partials_plain(t0_[0], t0_[1], tplan, emit_topk=8)
        te1 = testing.topk_errors(t1[2:4], tp1[2:4], tp1[5], 8)
        te4 = testing.topk_errors(t4[:2], tp4[:2], tp1[5], 8)
        del tp1, tp4
        tms = {
            "K1": _cuda_ms(torch, lambda: fft_detect.fft_detect_rows_ct(txr, txi, tplan, emit_topk=8)),
            "K1 parent design": _cuda_ms(torch, t1_parent),
            "K1 K = 128": _cuda_ms(torch, lambda: fft_detect.fft_detect_rows_ct(txr, txi, tplan, emit_topk=128)),
            "K1 partials": _cuda_ms(torch, lambda: fft_detect.fft_detect_rows_ct(txr, txi, tplan)),
            "K1 plain": _cuda_ms(torch, lambda: fft_detect.fft_detect_rows_ct_plain(txr, txi, tplan, emit_topk=8)),
            "K4": _cuda_ms(torch, lambda: detect_ct.detect_ct_partials(t0_[0], t0_[1], tplan, emit_topk=8)),
            "K4 partials": _cuda_ms(torch, lambda: detect_ct.detect_ct_partials(t0_[0], t0_[1], tplan)),
            "K4 plain": _cuda_ms(torch, lambda: detect_ct.detect_ct_partials_plain(t0_[0], t0_[1], tplan, emit_topk=8)),
        }
        if tdesign == "cluster":
            tinfo, tg = fft_detect.cluster_info(tn, emit_topk=8), fft_detect.cluster_geometry(tn)
            tkern = f"ct_cluster_kernel<{tg.n1}, {tg.cols}, 1, 1>"
        else:
            tinfo = fft_rows.wide_info(tn, topk=8)
            tkern = f"fft_detect_cluster_kernel<{ct_plan.ct_split(tn)[0]}, 1, {tinfo['min_blocks']}, 1>"
        tptx = {r["kernel"]: r for r in build.ptxas_report(build.build_log())}[tkern]
        trows = txr.shape[0]
        tb1 = _bound(_fft_flops(trows, tn) + _detect_flops(trows, tn), trows * tn * 16 + trows * 128 * 8 + trows * 8)
        tb4 = _bound(_detect_flops(trows, tn), trows * tn * 8 + trows * 128 * 8 + trows * 4)
        t1_facts = {"design": tdesign, "parent_design": "block" if short else "long K3 -> K4",
                    "parent_ms": tms["K1 parent design"], "k128_ms": tms["K1 K = 128"],
                    "registers": tinfo["registers"], "spill_bytes": tptx["spill_stores"] + tptx["spill_loads"],
                    "blocks_per_sm": tinfo["blocks"], "clusters": tinfo["clusters"],
                    "bit_equal_to_parent": same["K1 = parent design"]}
        topk_rows[tn] = {"K1": ([trows, tn], te1[0], tms["K1"], tms["K1 plain"], tb1, tms["K1 partials"], t1_facts),
                         "K4": ([trows, tn], te4[0], tms["K4"], tms["K4 plain"], tb4, tms["K4 partials"], {})}
        print(
            f"phase 20: emit_topk 8 at [{trows}, {tn}] (K1 design {tdesign}, one launch {t1_one}; {tinfo['registers']} "
            f"registers, spills {tptx['spill_stores']}/{tptx['spill_loads']} B, {tinfo['blocks']} blocks an SM, "
            f"cudaOccupancyMaxActiveClusters {tinfo['clusters']}): bit for bit {same}; vs plain: K1 value max|err| "
            f"{te1[0]:.3e} (rel to row max power {te1[1]:.3e}, tol 1e-4), packed differ outside near-ties {te1[2]} "
            f"({te1[3]:.2f} of lanes checked); K4 {te4[0]:.3e} ({te4[1]:.3e}), {te4[2]} ({te4[3]:.2f}); "
            + ", ".join(f"{k} {v:.3f} ms" for k, v in tms.items())
            + f" (parent design {t1_facts['parent_design']}); K1 bound {tb1[0]:.4f} ms ({tb1[1]}) {tag}"
        )
        _require(t1_one and tdesign == ("cluster" if ct_plan.ct_split(tn)[0] in fft_rows.CLUSTER_N1 else "wide"),
                 f"emit_topk at {tn} is not one launch of the cluster designs")
        _require(all(same.values()), f"emit_topk differs from the parent design or partials + tail at {tn}: {same}")
        for te in (te1, te4):
            _require(te[1] <= 1e-4 and te[2] == 0 and te[3] > 0.5, f"emit_topk disagrees with plain at {tn}: {te}")
        del t1, t0_, t4, tail, txr, txi
    del t17, t33, t97

    # the phase-4 scene at block_len 57344 on four routes, card vs CPU
    scen57 = sim.default_scenario(signal="noise", bandwidth_hz=150e3, snr_db=25.0, seed=8, block_len=57_344)
    cap57 = sim.synthesize(scen57)
    cfg57 = PipelineConfig(num_buoys=4, block_len=57_344, sample_rate_hz=scen57.sample_rate_hz, max_lag=600,
                           power_offset_db=40.0)
    host57 = [torch.from_numpy(a.astype(np.float32)) for a in (cap57.iq.real, cap57.iq.imag, cap57.buoy_enu)]
    routes57 = {  # route → (knob, on, default, kernels launched)
        "default": (detect_ops.set_fused_fft_detect, "auto", "auto", ["fft_detect_rows_ct", "gcc_pair_lag_mags"]),
        "two-kernel": routes["two-kernel"],
        "mega": routes["mega"],
        "combined-topk": (detect_ops.set_combined_topk, True, False, ["fft_detect_rows_ct", "gcc_pair_lag_mags"]),
    }
    mega_long_launches = 0
    for route, (knob, on, default, kernels) in routes57.items():
        knob(on)
        try:
            zero_counts()
            k8_long0 = channel_step.design_counts["long"]
            on_card = TDOAPipeline(cfg57, device=dev).step_split(*(a.to(dev) for a in host57))
            torch.cuda.synchronize()
            got = {k: v for k, v in launch_counts().items() if v}
            k8_long = channel_step.design_counts["long"] - k8_long0
            on_cpu = TDOAPipeline(cfg57, device="cpu").step_split(*host57)
        finally:
            knob(default)
        if route == "mega":
            mega_long_launches = got.get("channel_step_partials", 0)
        pos = on_card.fix.position_enu.cpu().numpy()
        err_m = float(np.linalg.norm(pos[:2] - cap57.emitter_enu[0][:2]))
        fix_gap = float(np.abs(pos - on_cpu.fix.position_enu.numpy()).max())
        lag_gap = (on_card.correlation.lag_samples.cpu() - on_cpu.correlation.lag_samples).abs().max().item()
        same_peaks = bool((on_card.peaks.bin_index.cpu() == on_cpu.peaks.bin_index).all())
        print(
            f"phase 20: scene at block_len 57344 (nfft {mnfft} = 384·152), {route} route: fix error {err_m:.3f} m "
            f"(limit 50), card vs CPU: fix {fix_gap:.3e} m (tol 0.5), lags {lag_gap:.2e} samples (tol 1e-3), peaks "
            f"equal {same_peaks}, launches {got}, K8 long design {k8_long} {tag}"
        )
        _require(err_m < 50.0 and fix_gap <= 0.5 and lag_gap <= 1e-3 and same_peaks,
                 f"block_len 57344 scene, {route} route: card and CPU disagree")
        _require(got == {**dict.fromkeys(kernels, 1), LM: 1}, f"block_len 57344 {route} route launches {got}")
        _require(k8_long == (1 if route == "mega" else 0), f"block_len 57344 {route} route K8 long {k8_long}")

    # the flagship at full width at block_len 57344: 4 blocks, default route
    mblocks = 4
    mpipe.step_split_uint8(mraw[0], manchors)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    designs0 = (dict(fft_detect.design_counts), dict(fft_rows.design_counts))
    t0 = time.perf_counter()
    mout = mpipe.step_split_uint8_scan(mraw, manchors)
    torch.cuda.synchronize()
    mwall = time.perf_counter() - t0
    mixed_launches = {k: v for k, v in launch_counts().items() if v}
    k1_designs = {k: v - designs0[0][k] for k, v in fft_detect.design_counts.items()}
    mfinite = all(torch.isfinite(x).all().item() for x in _leaves(torch, mout) if x.is_floating_point())
    print(
        f"phase 20: flagship at block_len 57344, {mblocks} blocks x {chans} ch x {buoys} buoys x 57344 uint8 IQ "
        f"(nfft {mnfft}): {1e3 * mwall / mblocks:.3f} ms/block (real time {1e3 * 57_344 / fs:.3f}), "
        f"{mblocks * chans * buoys * 57_344 / mwall:.4e} IQ samples/s, peak mem "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB, launches {mixed_launches}, K1 by design "
        f"{k1_designs}, all finite {mfinite} {tag}"
    )
    _require(tuple(mout.fix.position_enu.shape) == (mblocks, chans, 3) and mfinite, "block_len 57344 outputs")
    _require(mixed_launches == {"fft_detect_rows_ct": mblocks, "gcc_pair_lag_mags": mblocks, LM: mblocks}
             and k1_designs == {"block": 0, "cluster": 0, "long": 0, "wide": mblocks},
             f"block_len 57344 launches {mixed_launches}, K1 designs {k1_designs}")
    med = _stage_split(
        torch, lambda mark: mpipe.step_split_uint8(mraw[0], manchors, on_stage=mark),
        ["decode", "fft_detect", "peaks", "gcc_pair", "solve"],
    )
    print(
        "phase 20: block_len 57344 stage split ms/block (median of 3, CUDA events): "
        + ", ".join(f"{k} {v:.3f}" for k, v in med.items())
        + f", sum {sum(med.values()):.3f}, before the solve {sum(v for k, v in med.items() if k != 'solve'):.3f} {tag}"
    )
    combined_topk.append(_combined_topk_report(torch, mpipe, mraw, manchors, mout, 57_344, 20, tag))
    del mraw, mout, mre, mim

    # the pair body at the mixed lengths: one kernel a length for K2, K5 and
    # K6, its registers, spills and resident blocks at the launches' shared
    # memory (max_lag 600); n1 = 128 and 256 in phases 3 and 7
    wide_kernels = [i for i in pair_info]
    for kind in ("K2", "K5", "K6"):
        for xn in (58_368, 87_040, 121_856):
            i = _pair_kernel_info(build, gcc_pair, ct_plan, kind, xn, 600)
            wide_kernels.append(i)
            print(f"phase 20: {kind} {_pair_info_text(i)} {tag}")
            _require(i["local_bytes"] == 0 and i["spill_bytes"] == 0, f"{kind} at n1 = {i['n1']} spills")
            _require(i["blocks_an_sm"] >= (2 if i["n1"] == 384 else 1), f"{kind} at n1 = {i['n1']}: {i}")

    # K2 at [128, 8, 58368] beside the parent's, back to back in this call
    # (tools/forward_times.py --pair by path: parent, this, this, parent);
    # RM_PARENT_TREE names an unpacked parent checkout, else this tree alone
    torch.cuda.empty_cache()
    here = os.path.dirname(os.path.abspath(__file__))
    parent_tree = os.environ.get("RM_PARENT_TREE")
    order = [parent_tree, here, here, parent_tree] if parent_tree else [here]
    k2_runs = [(tree, *_pair_times(tree)) for tree in order]
    ours = [t["K2 58368"] for tree, t, _ in k2_runs if tree == here]
    theirs = [t["K2 58368"] for tree, t, _ in k2_runs if tree != here]
    k2_parent = {"ms": ours, "parent_ms": theirs or None}
    print(
        f"phase 20: K2 at [128, 8, 58368] (flagship at block_len 57344, max_lag 600) back to back: this tree "
        f"{', '.join(f'{t:.4f}' for t in ours)} ms"
        + (f", parent {', '.join(f'{t:.4f}' for t in theirs)} ms" if theirs else " (RM_PARENT_TREE unset: no parent)")
        + f"; pair digests at n1 = 128, 256: {next(d for tree, _, d in k2_runs if tree == here)} {tag}"
    )
    narrow_parent = {}  # the pair kernels at n1 = 128 on the main paths' shapes, this tree and the parent's
    for key, shape in PAIR_SHAPES.items():
        narrow_parent[key] = {"shape": shape, "ms": [t[key] for tree, t, _ in k2_runs if tree == here],
                              "parent_ms": [t[key] for tree, t, _ in k2_runs if tree != here] or None}
        if key == "K5 5120":
            narrow_parent[key]["one_pair_a_block_ms"] = [t[key + " one pair a block"] for tree, t, _ in k2_runs
                                                         if tree == here]
        print(f"phase 20: {key} {shape} back to back: this tree "
              + ", ".join(f"{t:.4f}" for t in narrow_parent[key]["ms"]) + " ms"
              + ("" if key != "K5 5120" else " in tiles of six, one pair a block "
                 + ", ".join(f"{t:.4f}" for t in narrow_parent[key]["one_pair_a_block_ms"]) + " ms")
              + (", parent " + ", ".join(f"{t:.4f}" for t in narrow_parent[key]["parent_ms"]) + " ms" if theirs
                 else "") + f" {tag}")
    if theirs:
        same = len({d for _, _, d in k2_runs}) == 1
        print(f"phase 20: n1 = 128/256 pair digests equal the parent's: {same} (the fold's TF32 split changes "
              f"their bits; phases 3, 7, 15 and 16 hold them to the plain versions) {tag}")
    # K1 and K3 at [1024, 58368], [1024, 97280] and [256, 121856] beside the
    # parent's (tools/forward_times.py --k1 by path: parent, this, this,
    # parent), and the long rows' digests
    k1_runs = [(tree, *_k1_times(tree)) for tree in order]
    k1_parent = {}  # nfft -> back-to-back times of this tree and the parent's
    for kn in K1_LENGTHS:
        pick = lambda mine, i: [t[kn][i] for tree, t, _ in k1_runs if (tree == here) == mine]
        k1_parent[kn] = {"shape": [k1_runs[0][1][kn][0], kn], "K1_ms": pick(True, 1), "K3_ms": pick(True, 2),
                        "parent_K1_ms": pick(False, 1) or None, "parent_K3_ms": pick(False, 2) or None,
                        "T1_ms": pick(True, 3), "T1_design": pick(True, 4)[0],
                        "parent_T1_ms": pick(False, 3) or None, "parent_T1_design": (pick(False, 4) or [None])[0]}
        ms_list = lambda key: ", ".join(f"{t:.4f}" for t in k1_parent[kn][key])
        print(
            f"phase 20: K1 and K3 at {k1_parent[kn]['shape']} (n1 = {ct_plan.ct_split(kn)[0]}) back to back: this "
            f"tree K1 {ms_list('K1_ms')} ms, K3 {ms_list('K3_ms')} ms, K1 emit_topk 8 {ms_list('T1_ms')} ms "
            f"({k1_parent[kn]['T1_design']})"
            + (f"; parent K1 {ms_list('parent_K1_ms')} ms, K3 {ms_list('parent_K3_ms')} ms, K1 emit_topk 8 "
               f"{ms_list('parent_T1_ms')} ms ({k1_parent[kn]['parent_T1_design']})" if theirs else
               " (no parent)") + f" {tag}"
        )
    print(f"phase 20: long digests: {k1_runs[0][2]} {tag}")
    if theirs:
        same = len({d for *_, d in k1_runs}) == 1
        print(f"phase 20: long-row digests (K3, K4, K1 and K1 with emit_topk 8 at 33792 ... 121856, the wide "
              f"design at 58368, 87040, 97280, 121856) equal the parent's: {same} (K8's long design, whose K2 "
              f"folds on tensor cores, is held to K1 -> K2 above) {tag}")
        _require(same, "the long-row kernels differ from the parent's")

    # ---- phase 21: the complex step (TDOAPipeline.step) on the phase-4 scene, card vs CPU
    cscen = sim.default_scenario(signal="noise", bandwidth_hz=150e3, snr_db=25.0, seed=8)
    ccap = sim.synthesize(cscen)
    ccfg = PipelineConfig(num_buoys=4, block_len=cscen.block_len, sample_rate_hz=cscen.sample_rate_hz,
                          max_lag=600, power_offset_db=40.0)
    chost = [torch.from_numpy(ccap.iq.astype(np.complex64)), torch.from_numpy(ccap.buoy_enu.astype(np.float32))]
    zero_counts()
    on_card = TDOAPipeline(ccfg, device=dev).step(*(a.to(dev) for a in chost))
    torch.cuda.synchronize()
    c21 = {k: v for k, v in launch_counts().items() if v}
    on_cpu = TDOAPipeline(ccfg, device="cpu").step(*chost)
    pos = on_card.fix.position_enu.cpu().numpy()
    err_m = float(np.linalg.norm(pos[:2] - ccap.emitter_enu[0][:2]))
    fix_gap = float(np.abs(pos - on_cpu.fix.position_enu.numpy()).max())
    lag_gap = (on_card.correlation.lag_samples.cpu() - on_cpu.correlation.lag_samples).abs().max().item()
    pk_card, pk_cpu = on_card.peaks, on_cpu.peaks
    same_peaks = bool((pk_card.bin_index.cpu() == pk_cpu.bin_index).all()
                      and (pk_card.valid.cpu() == pk_cpu.valid).all())
    pdb_gap = (pk_card.power_db.cpu() - pk_cpu.power_db).abs().max().item()
    nf_gap = (pk_card.noise_floor_db.cpu() - pk_cpu.noise_floor_db).abs().max().item()
    print(
        f"phase 21: complex step, scene (4 buoys, {cscen.block_len} samples, max_lag 600, pair nfft "
        f"{fft_ops.friendly_fft_len(cscen.block_len + 600)}): fix error {err_m:.3f} m (limit 50), card vs CPU: "
        f"lags {lag_gap:.2e} samples (tol 1e-3), fix {fix_gap:.3e} m (tol 0.5), peak bins and valid equal "
        f"{same_peaks} ({int(pk_cpu.valid.sum())} valid), peak power {pdb_gap:.2e} dB (tol 1e-3), noise floor "
        f"{nf_gap:.2e} dB (tol 1e-4), launches {c21} {tag}"
    )
    _require(err_m < 50.0, f"complex step fix error {err_m} m")
    _require(lag_gap <= 1e-3 and fix_gap <= 0.5, "complex step: card and CPU disagree on the lags or the fix")
    _require(same_peaks and bool(pk_cpu.valid.any()) and pdb_gap <= 1e-3 and nf_gap <= 1e-4,
             "complex step: card and CPU disagree on the detections")
    _require(c21 == {"fft_rows": 1, LM: 1}, f"complex step launches {c21} (K7 for the detection spectrum)")
    # the multi-dwell complex step on the phase-11 ELT scene
    elt_iq = torch.complex(elt_host[0], elt_host[1])
    zero_counts()
    on_card = TDOAPipeline(ecfg, device=dev).step(elt_iq.to(dev), elt_host[2].to(dev))
    torch.cuda.synchronize()
    c21e = {k: v for k, v in launch_counts().items() if v}
    on_cpu = TDOAPipeline(ecfg, device="cpu").step(elt_iq, elt_host[2])
    pos = on_card.fix.position_enu.cpu().numpy()
    err_m = float(np.linalg.norm(pos[:2] - elt.emitter_enu[0][:2]))
    fix_gap = float(np.abs(pos - on_cpu.fix.position_enu.numpy()).max())
    lag_gap = (on_card.correlation.lag_samples.cpu() - on_cpu.correlation.lag_samples).abs().max().item()
    print(
        f"phase 21: complex multi-dwell step, ELT scene (8 dwells x 32768): fix error {err_m:.3f} m (limit 500), "
        f"card vs CPU: fix {fix_gap:.3e} m (tol 1), lags {lag_gap:.3e} samples, launches {c21e} {tag}"
    )
    _require(err_m < 500.0 and fix_gap <= 1.0, "complex multi-dwell ELT step: fix")
    _require(c21e == {"fft_rows": 1, LM: 1}, f"complex multi-dwell launches {c21e} (K7 for the dwell PSD)")
    del elt_iq

    # ---- phase 22: the complex step at full width through step_uint8
    cblocks = 4
    craw, canchors = pipe.example_inputs(batch=(cblocks, chans), seed=0, uint8=True)
    canchors = canchors[0]
    pipe.step_uint8(craw[0], canchors)  # warm-up: tables, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    t0 = time.perf_counter()
    couts = [pipe.step_uint8(blk, canchors) for blk in craw.unbind(0)]
    torch.cuda.synchronize()
    cwall = time.perf_counter() - t0
    c22 = {k: v for k, v in launch_counts().items() if v}
    cfinite = all(torch.isfinite(x).all().item() for o in couts for x in _leaves(torch, o) if x.is_floating_point())
    cpeak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    c_ms_block = 1e3 * cwall / cblocks
    real_ms = 1e3 * n / fs
    complex_k7_per_block = c22.get("fft_rows", 0) / cblocks
    print(
        f"phase 22: complex step, {cblocks} blocks x {chans} ch x {buoys} buoys x {n} uint8 IQ (pair nfft "
        f"{fft_ops.friendly_fft_len(n + lag)}): {c_ms_block:.3f} ms/block (real time {real_ms:.3f}, ratio "
        f"{c_ms_block / real_ms:.3f}), {cblocks * chans * buoys * n / cwall:.4e} IQ samples/s, peak mem "
        f"{cpeak_gib:.2f} GiB, K7 launches {complex_k7_per_block:g} per block, launches {c22}, all finite "
        f"{cfinite} {tag}"
    )
    _require(all(tuple(o.fix.position_enu.shape) == (chans, 3) for o in couts) and cfinite,
             "complex step outputs at full width")
    _require(c22 == {"fft_rows": cblocks, LM: cblocks, **{k: cblocks for k in PAIR_FFT}},
             f"complex step launches {c22}")
    med = _stage_split(
        torch, lambda mark: pipe.step_uint8(craw[0], canchors, on_stage=mark),
        ["decode", "psd", "detect", "spectra", "pair_corr", "lag_peaks", "solve"],
    )
    print(
        "phase 22: complex step stage split ms/block (median of 3, CUDA events): decode "
        f"{med['decode']:.3f}, psd (K7) {med['psd']:.3f}, detect {med['detect']:.3f}, spectra (K9 at 17280) "
        f"{med['spectra']:.3f}, pair corr {med['pair_corr']:.3f}, lag peaks {med['lag_peaks']:.3f}, solve "
        f"{med['solve']:.3f}, sum {sum(med.values()):.3f} {tag}"
    )
    # K7 through the complex wrapper (complex64 split into planes, the
    # spectrum joined again) at the shape this path gives it, against the
    # plain four-step on the same planes
    cx = iq.decode_uint8_iq(craw[0])
    crows = cx.numel() // n
    k7_before = fft_natural.launch_count
    cfft = fft_ops.fft(cx)
    cfft_k7 = fft_natural.launch_count - k7_before
    plain_fft = lambda: torch.complex(*fft_ops.fft_re_im_plain(cx.real.contiguous(), cx.imag.contiguous()))
    cref = plain_fft()
    torch.cuda.synchronize()
    cf_abs, cf_rel = _row_rel_error((cfft.real, cfft.imag), (cref.real, cref.imag))
    del cfft, cref
    cf_ms = _cuda_ms(torch, lambda: fft_ops.fft(cx))
    cf_plain_ms = _cuda_ms(torch, plain_fft)
    cf_lib_ms = _cuda_ms(torch, lambda: torch.fft.fft(cx))
    cf_bound = _bound(_fft_flops(crows, n), 2 * 8 * crows * n)
    print(
        f"phase 22: K7 through the complex fft at [{crows}, {n}] (the decoded block 0): K7 launches {cfft_k7}, "
        f"spectra max|err| {cf_abs:.3e} (rel to row max|X| {cf_rel:.3e}, tol 1e-4) against the plain four-step; "
        f"fft {cf_ms:.3f} ms (split, K7, join), plain {cf_plain_ms:.3f} ms, torch.fft.fft {cf_lib_ms:.3f} ms, "
        f"bound {cf_bound[0]:.4f} ms {tag}"
    )
    _require(cfft_k7 == 1, f"the complex fft at [{crows}, {n}] launched K7 {cfft_k7} times")
    _require(cf_rel <= 1e-4, f"K7 through the complex fft disagrees with the plain four-step: {cf_rel}")
    del craw, couts, cx
    torch.cuda.empty_cache()

    # ---- phase 23: the streaming model and the central engine
    sscen = sim.default_scenario(signal="noise", bandwidth_hz=110e3, snr_db=25.0, seed=6, block_len=32_768)
    scap = sim.synthesize(sscen)
    scfg = StreamingTDOAConfig(num_buoys=4, num_subchannels=8, taps_per_channel=6, sample_rate_hz=sscen.sample_rate_hz,
                               block_len=16_384, max_lag=8, solver_iterations=25)
    shost = [torch.from_numpy(scap.iq.astype(np.complex64).reshape(4, 2, 16_384).transpose(1, 0, 2).copy()),
             torch.from_numpy(scap.buoy_enu.astype(np.float32))]
    zero_counts()
    _, s_card = StreamingTDOA(scfg, device=dev).scan(*(a.to(dev) for a in shost))
    torch.cuda.synchronize()
    c23s = {k: v for k, v in launch_counts().items() if v}
    _, s_cpu = StreamingTDOA(scfg, device="cpu").scan(*shost)
    best = int(np.argmax(s_cpu.weights[1].numpy().sum(-1)))
    best_card = int(np.argmax(s_card.weights[1].cpu().numpy().sum(-1)))
    pos = s_card.fixes_enu[1, best].cpu().numpy()
    err_m = float(np.linalg.norm(pos[:2] - scap.emitter_enu[0][:2]))
    fix_gap = float(np.abs(pos - s_cpu.fixes_enu[1, best].numpy()).max())
    lag_gap = (s_card.lags[:, best].cpu() - s_cpu.lags[:, best]).abs().max().item()
    print(
        f"phase 23: streaming scene (4 buoys, 8 subchannels, 2 blocks of 16384): emitter subchannel {best} "
        f"(card {best_card}), fix error {err_m:.3f} m (limit 600), card vs CPU there: lags {lag_gap:.2e} "
        f"subchannel samples (tol 1e-3), fix {fix_gap:.3e} m (tol 0.5); launches {c23s} (nfft "
        f"{fft_ops.friendly_fft_len(16_384 // 8 + 8)}: the matmul four-step) {tag}"
    )
    _require(best == best_card and err_m < 600.0, f"streaming fix: subchannel {best}/{best_card}, {err_m} m")
    _require(lag_gap <= 1e-3 and fix_gap <= 0.5, "streaming: card and CPU disagree on the emitter's subchannel")
    stream = StreamingTDOA(StreamingTDOAConfig(), device=dev)
    sblocks, sanchors = stream.example_inputs(num_blocks=64, seed=0)
    stream.scan(sblocks[:1], sanchors)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, sout = stream.scan(sblocks, sanchors)
    torch.cuda.synchronize()
    swall = time.perf_counter() - t0
    sc = stream.config
    s_ms_block = 1e3 * swall / 64
    s_real_ms = 1e3 * sc.block_len / sc.sample_rate_hz
    sfinite = all(torch.isfinite(x).all().item() for x in sout)
    print(
        f"phase 23: StreamingTDOA default config ({sc.num_buoys} buoys, {sc.num_subchannels} subchannels, "
        f"{sc.block_len} samples a step), scan over 64 blocks: {s_ms_block:.3f} ms/block (real time "
        f"{s_real_ms:.3f}, ratio {s_ms_block / s_real_ms:.3f}), {64 * sc.num_buoys * sc.block_len / swall:.4e} "
        f"IQ samples/s, all finite {sfinite} {tag}"
    )
    _require(tuple(sout.fixes_enu.shape) == (64, sc.num_subchannels, 3) and sfinite, "streaming scan outputs")
    del sblocks, sout

    escen = sim.default_scenario(emitter_lat=35.47, emitter_lng=-97.51, signal="noise", bandwidth_hz=150e3,
                                 snr_db=20.0, seed=3, sample_rate_hz=fs)
    ecap = sim.synthesize(escen)
    clock_ns = (80_000, -120_000, 40_000, -60_000)
    t_ns = 1_700_000_000_000_000_000
    group = [
        datamodel.SignalDetection(
            buoy_id=b.buoy_id, frequency_mhz=121.5, signal_strength_dbm=-55.0,
            timestamp_utc="2026-08-17T00:00:00+00:00",
            gps_timestamp_ns=t_ns + int(ecap.geometric_delays_s[k, 0] * 1e9) + clock_ns[k],
            lat=b.lat, lng=b.lng, confidence=0.9, signal_type="emergency",
            iq_samples=ecap.iq[k].astype(np.complex64), iq_sample_rate_hz=fs, iq_anchor_ns=t_ns + clock_ns[k],
        )
        for k, b in enumerate(escen.buoys)
    ]

    def engine_run(where):
        eng = TDoAEngine(device=where)
        for b in escen.buoys:
            eng.register_buoy(datamodel.BuoyPosition(b.buoy_id, b.lat, b.lng, b.alt_m, 100_000))
        return eng.process_signal_detections(group)

    engine_run(dev)  # warm-up
    zero_counts()
    t0 = time.perf_counter()
    e_card = engine_run(dev)
    e_ms = 1e3 * (time.perf_counter() - t0)
    c23e = {k: v for k, v in launch_counts().items() if v}
    e_cpu = engine_run("cpu")
    _require(len(e_card) == len(e_cpu) == 1 and e_card[0].method == e_cpu[0].method == "gcc-phat+lm",
             "engine: one waveform-mode fix on each side")
    dt_gap = max(abs(a.time_difference_ns - b.time_difference_ns)
                 for a, b in zip(e_card[0].tdoa_measurements, e_cpu[0].tdoa_measurements))
    gap = geo.lat_lng_to_enu_np(e_card[0].estimated_lat, e_card[0].estimated_lng, 0.0,
                                e_cpu[0].estimated_lat, e_cpu[0].estimated_lng, 0.0)
    err = geo.lat_lng_to_enu_np(e_card[0].estimated_lat, e_card[0].estimated_lng, 0.0, 35.47, -97.51, 0.0)
    print(
        f"phase 23: TDoAEngine.process_signal_detections, 4 OKC buoys, {ecap.iq.shape[1]}-sample snippets at "
        f"{fs / 1e6:.1f} MS/s: {e_ms:.3f} ms on the card, fix error {float(np.linalg.norm(err[:2])):.3f} m, card vs "
        f"CPU: measurements {dt_gap} ns apart (tol 1), fix {float(np.linalg.norm(gap[:2])):.3e} m (tol 1); launches "
        f"{c23e} {tag}"
    )
    _require(dt_gap <= 1 and float(np.linalg.norm(gap[:2])) <= 1.0, "engine: card and CPU disagree")
    _require(len(e_card[0].tdoa_measurements) == 6, "engine: six pair measurements")

    parallel = _parallel_phases(np, torch, sim, wcfg, tag)

    # ---- phases 27-29: the wideband fallback (F4), the ingest loop, the buoy service
    fallback = _wideband_fallback_phase(np, torch, sim, dev, tag, counters, wcfg, blocks)
    ingest = _ingest_phase(np, torch, dev, tag, counters)
    buoy_run = _buoy_phase(np, torch, sim, dev, tag, counters)

    # ---- phases 30-34: demod, ADS-B, the power scan, the central service, the CLI
    _demod_phase(np, torch, dev, tag, counters)
    _adsb_phase(np, torch, dev, tag)
    k7_scan = _scan_phase(np, torch, sim, dev, tag, counters)
    _central_phase(np, torch, sim, dev, tag, counters)
    _cli_phase(tag)

    # ---- phases 35-37: the modeled dongle, rtl_tcp, the new CLI
    usbmodel = _usbmodel_phase(np, torch, dev, tag, counters)
    tcp = _rtl_tcp_phase(np, torch, sim, dev, tag, counters)
    _cli_tools_phase(np, torch, sim, dev, tag)

    # ---- phase 38: the benchmark's legs and bench.main
    bench_run = _bench_phase(np, torch, dev, tag, counters)
    by_leg = lambda name: {leg: n[name] for leg, n in bench_run["launches"].items() if n.get(name)}

    # ---- phase 39: the flagship at block_len 96000 (nfft 97280 = 640·152):
    # K1 is one launch of the wide design at n1 = 640, K2 its wide body
    cfg96 = PipelineConfig(num_buoys=buoys, block_len=96_000, sample_rate_hz=fs, max_lag=600)
    pipe96 = TDOAPipeline(cfg96, device=dev)
    _require(pipe96.plan.nfft == 97_280 and ct_plan.ct_split(97_280) == (640, 152)
             and fft_rows.long_geometry(97_280).design == "wide", f"block_len 96000 plans nfft {pipe96.plan.nfft}")
    scen96 = sim.default_scenario(signal="noise", bandwidth_hz=150e3, snr_db=25.0, seed=8, block_len=96_000)
    cap96 = sim.synthesize(scen96)
    cfg96s = PipelineConfig(num_buoys=4, block_len=96_000, sample_rate_hz=scen96.sample_rate_hz, max_lag=600,
                            power_offset_db=40.0)
    host96 = [torch.from_numpy(a.astype(np.float32)) for a in (cap96.iq.real, cap96.iq.imag, cap96.buoy_enu)]
    zero_counts()
    wide0 = fft_detect.design_counts["wide"]
    on_card = TDOAPipeline(cfg96s, device=dev).step_split(*(a.to(dev) for a in host96))
    torch.cuda.synchronize()
    got96 = {k: v for k, v in launch_counts().items() if v}
    wide96 = fft_detect.design_counts["wide"] - wide0
    on_cpu = TDOAPipeline(cfg96s, device="cpu").step_split(*host96)
    pos = on_card.fix.position_enu.cpu().numpy()
    err_m = float(np.linalg.norm(pos[:2] - cap96.emitter_enu[0][:2]))
    fix_gap = float(np.abs(pos - on_cpu.fix.position_enu.numpy()).max())
    lag_gap = (on_card.correlation.lag_samples.cpu() - on_cpu.correlation.lag_samples).abs().max().item()
    same_peaks = bool((on_card.peaks.bin_index.cpu() == on_cpu.peaks.bin_index).all())
    print(
        f"phase 39: scene at block_len 96000 (nfft 97280 = 640·152), default route: fix error {err_m:.3f} m (limit "
        f"50), card vs CPU: fix {fix_gap:.3e} m (tol 0.5), lags {lag_gap:.2e} samples (tol 1e-3), peaks equal "
        f"{same_peaks}, launches {got96}, K1 wide design {wide96} {tag}"
    )
    _require(err_m < 50.0 and fix_gap <= 0.5 and lag_gap <= 1e-3 and same_peaks,
             "block_len 96000 scene: card and CPU disagree")
    _require(got96 == {"fft_detect_rows_ct": 1, "gcc_pair_lag_mags": 1, LM: 1} and wide96 == 1,
             f"block_len 96000 scene launches {got96}, K1 wide {wide96}")
    del on_card, on_cpu, host96, cap96
    blocks96 = 4
    raw96, anchors96 = pipe96.example_inputs(batch=(blocks96, chans), seed=0, uint8=True)
    anchors96 = anchors96[0]
    pipe96.step_split_uint8(raw96[0], anchors96)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    designs0 = dict(fft_detect.design_counts)
    zero_counts()
    t0 = time.perf_counter()
    out96 = pipe96.step_split_uint8_scan(raw96, anchors96)
    torch.cuda.synchronize()
    wall96 = time.perf_counter() - t0
    launches96 = {k: v for k, v in launch_counts().items() if v}
    k1_designs96 = {k: v - designs0[k] for k, v in fft_detect.design_counts.items()}
    finite96 = all(torch.isfinite(x).all().item() for x in _leaves(torch, out96) if x.is_floating_point())
    print(
        f"phase 39: flagship at block_len 96000, {blocks96} blocks x {chans} ch x {buoys} buoys x 96000 uint8 IQ "
        f"(nfft 97280): {1e3 * wall96 / blocks96:.3f} ms/block (real time {1e3 * 96_000 / fs:.3f}), "
        f"{blocks96 * chans * buoys * 96_000 / wall96:.4e} IQ samples/s, peak mem "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB, launches {launches96}, K1 by design "
        f"{k1_designs96}, all finite {finite96} {tag}"
    )
    _require(tuple(out96.fix.position_enu.shape) == (blocks96, chans, 3) and finite96, "block_len 96000 outputs")
    _require(launches96 == {"fft_detect_rows_ct": blocks96, "gcc_pair_lag_mags": blocks96, LM: blocks96}
             and k1_designs96 == {"block": 0, "cluster": 0, "long": 0, "wide": blocks96},
             f"block_len 96000 launches {launches96}, K1 designs {k1_designs96}")
    med96 = _stage_split(
        torch, lambda mark: pipe96.step_split_uint8(raw96[0], anchors96, on_stage=mark),
        ["decode", "fft_detect", "peaks", "gcc_pair", "solve"],
    )
    print(
        "phase 39: block_len 96000 stage split ms/block (median of 3, CUDA events): "
        + ", ".join(f"{k} {v:.3f}" for k, v in med96.items())
        + f", sum {sum(med96.values()):.3f}, before the solve "
        f"{sum(v for k, v in med96.items() if k != 'solve'):.3f} {tag}"
    )
    combined_topk.append(_combined_topk_report(torch, pipe96, raw96, anchors96, out96, 96_000, 39, tag))
    del raw96, out96

    # ---- phase 40: the LM solve's kernel at the main path's shapes
    lm_rows = _lm_phase(np, torch, dev, zero_counts, launch_counts, tag)

    # ---- phase 41: the narrowband pair stage's kernels (K9, the max pass, K10)
    pair_rows = _pair_fft_phase(np, torch, dev, zero_counts, launch_counts, tag)

    def rows_entry(shape, err, ms, plain_ms, bound, library_ms):
        return {"shape": shape, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0],
                "bound_by": bound[1], "library_ms": library_ms}

    def topk_entry(shape, err, ms, plain_ms, bound, partials_ms, facts):
        return {**rows_entry(shape, err, ms, plain_ms, bound, None), "emit_topk": 8, "partials_ms": partials_ms,
                **facts}

    def entry(name, source, replaces, launches, err, ms, plain_ms, bound, algorithm_flops, library_ms=None,
              long_source=(), long_name=None, **extra):
        out = {
            "name": name,
            "route": "cuda",
            "source": f"radio_mapper_tpu_torch/csrc/{source}",
            "replaces": f"radio_mapper_tpu/ops/pallas/{replaces}",
            "launches": launches,
            "max_abs_err": err,
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound[0],
            "bound_by": bound[1],
            "library_ms": library_ms,
            "algorithm_flops": algorithm_flops,
        }
        if long_name is not None:  # rows past one block's shared memory (fault F3)
            out["sources"] = [out["source"]] + [f"radio_mapper_tpu_torch/csrc/{f}" for f in long_source]
            out["long_rows"] = [
                {"shape": [long_row_count[ln], ln], "max_abs_err": v[long_name][0], "ms": v[long_name][1],
                 "plain_ms": v[long_name][2], "bound_ms": v[long_name][3][0], "bound_by": v[long_name][3][1],
                 "library_ms": v[long_name][4]}
                for ln, v in long_rows.items()
            ]
            out["long_launches_block_len_32768"] = long_launches.get(name, 0)
        return {**out, **extra}

    mixed = lambda name: [rows_entry(*v) for (k, _), v in mixed_rows.items() if k == name]
    topk = lambda name: [topk_entry(*v[name]) for v in topk_rows.values()]

    wn1, wn2 = ct_plan.ct_split(wn)
    w_rows = sum(gcc_pair.window_rows(wn, wlag))
    w_width = 2 * wlag + 1
    k7_rows = chans * buoys * 8
    k1_radix = _radix_flops(nrows, nfft, *ct_plan.radix_split(nfft)[1:]) + _detect_flops(nrows, nfft)
    k2_fft = _fft_pair_flops(chans * npairs, n1, n2, rows_w)
    print(json.dumps({"kernels": [
        entry("fft_detect_rows_ct", "fft_rows_ct_cluster.cu", "detect_kernel.py:443",
              launches["fft_detect_rows_ct"], spec_abs, k1_ms, k1_plain_ms,
              _bound(_fft_flops(nrows, nfft) + _detect_flops(nrows, nfft),
                     nrows * nfft * 16 + nrows * plan.segments * 8 + nrows * 8), k1_radix,
              long_source=["ct_detect.cuh", "cluster.cuh", "ct_fft.cuh", "fft_detect.cu", "fft_detect_cluster.cu",
                           "fft_detect_cluster_mixed.cu", "fft_detect_cluster.cuh", "detect_ct.cu"],
              long_name="K1", mixed_rows=mixed("K1"), topk=topk("K1"), combined_topk_flagship=combined_topk,
              design_counts_block_len_16384=k1_designs16, design_counts_block_len_32768=k1_designs32,
              cluster_design=k1_cluster, cluster_design_flagship_block=k1_cluster_block0,
              wide_design={n: r["K1"] for n, r in wide_report.items() if r}, wide_back_to_back=k1_parent,
              wide_vs_workspace=wide_vs_workspace,
              launches_block_len_57344=mixed_launches.get("fft_detect_rows_ct", 0),
              launches_block_len_96000=launches96.get("fft_detect_rows_ct", 0),
              launches_ingest=ingest["launches"].get("fft_detect_rows_ct", 0),
              launches_bench=by_leg("fft_detect_rows_ct"),
              parallel=parallel("fft_detect_rows_ct")),
        entry("gcc_pair_lag_mags", "gcc_pair.cu", "gcc_kernel.py:358",
              launches["gcc_pair_lag_mags"], max(win_abs, k2_modes["l2"][0], k2_modes["l1"][0]), k2_ms, k2_plain_ms,
              _bound(_pair_flops(chans * npairs, nfft, width),
                     nrows * nfft * 8 + nrows * 4 + chans * npairs * width * 4), k2_fft,
              mixed_rows=mixed("K2"), launches_block_len_57344=mixed_launches.get("gcc_pair_lag_mags", 0),
              launches_block_len_96000=launches96.get("gcc_pair_lag_mags", 0),
              wide_kernels=[w for w in wide_kernels if w["kernel"] == "K2"], flagship_57344_back_to_back=k2_parent,
              flagship_back_to_back=narrow_parent["K2 17408"],
              sources=[f"radio_mapper_tpu_torch/csrc/{f}" for f in ("gcc_pair.cu", "gcc_pair_wide.cuh", "gcc_pair.cuh")],
              launches_ingest=ingest["launches"].get("gcc_pair_lag_mags", 0),
              launches_bench=by_leg("gcc_pair_lag_mags"),
              parallel=parallel("gcc_pair_lag_mags")),
        entry("fft_rows_ct", "fft_rows_ct.cu", "fft_kernel.py:446",
              wl5["fft_rows_ct"], k3_abs, k3_ms, k3_plain_ms, k3_bound,
              _radix_flops(m_sub * wb, wn, *ct_plan.radix_split(wn)[1:]), k3_lib_ms,
              long_source=["fft_rows_ct_cluster.cu", "fft_detect_cluster.cu", "fft_detect_cluster_mixed.cu"],
              long_name="K3",
              mixed_rows=mixed("K3"), wide_design={n: r["K3"] for n, r in wide_report.items() if r},
              launches_bench=by_leg("fft_rows_ct"),
              parallel=parallel("fft_rows_ct")),
        entry("detect_ct_partials", "detect_ct.cu", "detect_kernel.py:309",
              route_launches["detect_ct_partials"], max(k4_score_abs, k4_nf), k4_ms, k4_plain_ms, k4_bound,
              nrows * nfft * (3 + 2 * plan.radius + 1),  # power, then the sliding max's compares
              long_name="K4", topk=topk("K4"),
              parallel=parallel("detect_ct_partials")),
        entry("gcc_pairs_onehot_lag_mags", "gcc_pair.cu", "gcc_kernel.py:743",
              wl5["gcc_pairs_onehot_lag_mags"], k5_abs, k5_ms, k5_plain_ms,
              _bound(_pair_flops(m_sub * wp, wn, w_width),
                     m_sub * wb * wn * 8 + m_sub * wp * 4 + m_sub * wp * w_width * 4),
              _fft_pair_flops(m_sub * wp, wn1, wn2, w_rows), mixed_rows=mixed("K5"),
              wide_kernels=[w for w in wide_kernels if w["kernel"] == "K5"],
              wideband_back_to_back=narrow_parent["K5 5120"],
              launches_bench=by_leg("gcc_pairs_onehot_lag_mags"),
              parallel=parallel("gcc_pairs_onehot_lag_mags")),
        entry("gcc_rows_lag_mags", "gcc_pair.cu", "gcc_kernel.py:548",
              wl6["gcc_rows_lag_mags"], k6_abs, k6_ms, k6_plain_ms,
              _bound(_pair_flops(wp, wn, w_width), 4 * wp * wn * 4 + wp * 4 + wp * w_width * 4),
              _fft_pair_flops(wp, wn1, wn2, w_rows),
              wide_kernels=[w for w in wide_kernels if w["kernel"] == "K6"],
              wideband_back_to_back=narrow_parent["K6 5120"],
              launches_bench=by_leg("gcc_rows_lag_mags"),
              parallel=parallel("gcc_rows_lag_mags")),
        entry("fft_rows", "fft_natural_radix.cu", "fft_kernel.py:212",
              k7_launches, max([v[0] for v in k7.values()] + [cf_abs]), k7_main[2], k7_main[3],
              _bound(_fft_flops(k7_rows, n), 2 * 8 * k7_rows * n),
              _natural_radix_flops(k7_rows, fft_natural.radix_plan(n)), k7_main[4],
              sources=[f"radio_mapper_tpu_torch/csrc/{f}" for f in ("fft_natural_radix.cu", "fft_natural_cluster.cu")],
              cluster_rows=[rows_entry(list(shape), v[0], v[2], v[3], v[5], v[4])
                            for shape, v in k7.items() if v[6] == ["cluster"]],
              launches_block_len_32768=k7_launches32 // nblocks32,
              launches_complex_step=complex_k7_per_block,
              complex_step_rows=[rows_entry([crows, n], cf_abs, cf_ms, cf_plain_ms, cf_bound, cf_lib_ms)],
              launches_buoy=buoy_run["launches"].get("fft_rows", 0),
              launches_scan=k7_scan,
              launches_buoy_rtl_tcp=tcp["buoy"],
              launches_buoy_usbmodel=usbmodel["launches"],
              launches_scan_rtl_tcp=tcp["scan"],
              launches_bench=by_leg("fft_rows"),
              bench_rows=[bench_run["fft_row"]],
              parallel=parallel("fft_rows")),
        entry("channel_step_partials", "channel_step.cu", "channel_kernel.py:161",
              route_launches["channel_step_partials"], k8_abs, k8_ms, k8_plain_ms, k8_bound, k1_radix + k2_fft,
              sources=[f"radio_mapper_tpu_torch/csrc/{f}" for f in
                       ("channel_step.cu", "fft_rows_ct_cluster.cu", "fft_detect_cluster.cu",
                        "fft_detect_cluster_mixed.cu", "detect_ct.cu", "gcc_pair.cu", "gcc_pair_wide.cuh")],
              flagship_back_to_back=narrow_parent["K8 17408"],
              long_rows=mixed("K8"), long_launches_block_len_57344_mega=mega_long_launches,
              parallel=parallel("channel_step_partials")),
        {"name": "lm_solve", "route": "cuda", "source": "radio_mapper_tpu_torch/csrc/lm_solve.cu",
         "replaces": "radio_mapper_tpu/solver.py solve_tdoa_impl (an XLA fori_loop; no Pallas kernel)",
         "launches": launches.get(LM, 0), **lm_rows["flagship"], "narrowband": lm_rows["narrowband"],
         "parallel": parallel(LM)},
        *({"name": k, "route": "cuda", "source": "radio_mapper_tpu_torch/csrc/pair_fft.cu",
           "replaces": "none: the reference's XLA dots (radio_mapper_tpu/ops/fft.py _fft_re_im)",
           "launches": launches.get(k, 0), **r} for k, r in pair_rows.items()),
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card.name, "count": card.count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
