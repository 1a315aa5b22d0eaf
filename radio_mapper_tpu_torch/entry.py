"""Entry points: the single-device step and the multi-rank dry run.

Port of the repo's ``__graft_entry__.py`` for the PyTorch package:

- :func:`entry` returns the flagship split-complex step and example
  arguments for one device (the card unless ``device="cpu"``);
- :func:`dryrun_multichip` starts ``n`` ranks (:func:`.parallel.launch.run_ranks`)
  and runs one step of each multi-device program on small shapes: the
  sharded split step on a ("ch", "blk") mesh, the same at the BASELINE
  config-5 width (256 channels × 8 buoys × 16 subchannels at 2.4 MS/s,
  1024 samples a shard), the pair-parallel step at 64 and at 256
  receivers, the flagship step split over channels (32 × 8 × 16384), and
  the wideband step split over subchannels.

On the card, ``n`` ranks share the cards there are (rank r on card
r mod count); more ranks than cards is a functional check, not a
multi-card run.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch


def entry(device: str = "cuda"):
    """``(fn, args)``: the flagship ``step_split`` and ``(re, im,
    anchors)`` for 2 channels × 4 buoys × 8192 samples, drawn as the JAX
    package's ``entry()`` draws them."""
    from radio_mapper_tpu_torch.models.pipeline import PipelineConfig, TDOAPipeline

    pipe = TDOAPipeline(
        PipelineConfig(
            num_buoys=4,
            block_len=8192,
            sample_rate_hz=2_048_000.0,
            max_lag=256,
            max_peaks=8,
            solver_iterations=20,
        ),
        device=device,
    )
    re, im, anchors = pipe.example_inputs(batch=(2,), seed=0)
    return pipe.step_split, (re, im, anchors)


def dryrun_multichip(n_devices: int, device: str = "cuda") -> List[Dict[str, Any]]:
    """One step of every multi-device program on ``n_devices`` ranks;
    returns each rank's summary (output shapes and the replicated fixes).
    Raises if a rank fails or an output has the wrong shape."""
    from radio_mapper_tpu_torch.parallel.launch import run_ranks

    return run_ranks(_dryrun_rank, n_devices, device=device)


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"dryrun_multichip: {what}")


def _dryrun_rank(ctx) -> Dict[str, Any]:
    from radio_mapper_tpu_torch.models.pipeline import PipelineConfig, TDOAPipeline
    from radio_mapper_tpu_torch.models.wideband import WidebandConfig, build_wideband_sharded_step
    from radio_mapper_tpu_torch.parallel import mesh as mesh_lib
    from radio_mapper_tpu_torch.parallel.pair_ep import OUT_SPEC as EP_SPEC
    from radio_mapper_tpu_torch.parallel.pair_ep import PairEPConfig, build_pair_ep_step
    from radio_mapper_tpu_torch.parallel.sharded import (
        OUT_SPEC,
        ShardedStepConfig,
        build_sharded_step_split,
        example_inputs_split,
    )

    n = ctx.world_size
    dev = ctx.device
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    summary: Dict[str, Any] = {}

    # DP over "ch", SP over "blk" with halos, the all-pairs GCC, the LM
    shape = mesh_lib.balanced_mesh_shape(n)
    mesh = mesh_lib.make_mesh(shape, ("ch", "blk"), device=dev.type)
    s = shape[1]
    for name, cfg in (
        ("sharded", ShardedStepConfig(
            num_channels=max(4, 2 * shape[0]), num_buoys=8, num_subchannels=8,
            taps_per_channel=4, max_lag=24, solver_iterations=8,
        )),
        # BASELINE config 5 (docs/MULTIHOST.md): 256 channels × 8 buoys × 16
        # subchannels at 2.4 MS/s, max_lag 32; 1024 samples a shard
        ("config5", ShardedStepConfig(
            num_channels=256, num_buoys=8, num_subchannels=16, sample_rate_hz=2_400_000.0,
            max_lag=32, taps_per_channel=4, solver_iterations=6,
        )),
    ):
        step, _ = build_sharded_step_split(mesh, cfg)
        out = step(*example_inputs_split(mesh, cfg, samples_per_shard=1024))
        fixes = mesh_lib.gather_global(out.fixes_enu, mesh, OUT_SPEC)
        _check(tuple(fixes.shape) == (s, cfg.num_channels, cfg.num_subchannels, 3), f"{name} fixes {tuple(fixes.shape)}")
        summary[name] = tuple(fixes.shape)

    # pair-parallel (EP): receivers over "pair", spectra all_gathered, the
    # solve psum'd; 64 receivers (2016 pairs), then 256 (32640)
    ep_mesh = mesh_lib.make_mesh((n,), ("pair",), device=dev.type)
    rng = np.random.default_rng(0)
    for name, cfg in (
        ("ep64", PairEPConfig(
            num_buoys=64 if 64 % n == 0 else 2 * n, block_len=1024, max_lag=64, solver_iterations=6,
        )),
        ("ep256", PairEPConfig(
            num_buoys=256 if 256 % n == 0 else 8 * n, block_len=512, max_lag=32, solver_iterations=4,
        )),
    ):
        step, specs, (pi, _) = build_pair_ep_step(ep_mesh, cfg)
        re = rng.normal(size=(cfg.num_buoys, cfg.block_len)).astype(np.float32)
        im = rng.normal(size=(cfg.num_buoys, cfg.block_len)).astype(np.float32)
        anchors = rng.normal(scale=5_000.0, size=(cfg.num_buoys, 3)).astype(np.float32)
        out = step(*(to(mesh_lib.local_block(a, ep_mesh, sp)) for a, sp in zip((re, im, anchors), specs)))
        lags = mesh_lib.gather_global(out.lags, ep_mesh, EP_SPEC.lags)
        _check(tuple(out.fix_enu.shape) == (3,), f"{name} fix {tuple(out.fix_enu.shape)}")
        _check(len(pi) == cfg.num_pairs and lags.shape[0] >= cfg.num_pairs, f"{name} pairs")
        summary[name] = out.fix_enu

    # the flagship step split over channels: 32 ch × 8 buoys × 16384
    flag_mesh = mesh_lib.make_mesh((n,), ("ch",), device=dev.type)
    pipe = TDOAPipeline(
        PipelineConfig(
            num_buoys=8, block_len=16_384, sample_rate_hz=2_400_000.0,
            max_lag=512, max_peaks=8, solver_iterations=25,
        ),
        device=dev,
    )
    spec = mesh_lib.channel_sharding(3)
    f_out = pipe.step_split(*(mesh_lib.local_block(a, flag_mesh, spec) for a in pipe.example_inputs(batch=(32,), seed=0)))
    fixes = mesh_lib.gather_global(f_out.fix.position_enu, flag_mesh, spec[:2])
    _check(tuple(fixes.shape) == (32, 3), f"flagship fixes {tuple(fixes.shape)}")
    summary["flagship"] = tuple(fixes.shape)

    # wideband config 4's decomposition: subchannels over "sub"
    wb_mesh = mesh_lib.make_mesh((n,), ("sub",), device=dev.type)
    wb_cfg = WidebandConfig(
        num_buoys=6, wide_rate_hz=2_048_000.0, num_subchannels=2 * n, sub_block=512,
        max_lag=48, solver_iterations=6,
    )
    wb_step, _ = build_wideband_sharded_step(wb_mesh, wb_cfg)
    wb = [rng.normal(size=(wb_cfg.num_buoys, wb_cfg.wide_block)).astype(np.float32) for _ in range(2)]
    wb_anchors = rng.normal(scale=5_000.0, size=(wb_cfg.num_buoys, 3)).astype(np.float32)
    wb_out = wb_step(to(wb[0]), to(wb[1]), to(wb_anchors))
    _check(tuple(wb_out.fixes_enu.shape) == (wb_cfg.num_subchannels, 3), f"wideband fixes {tuple(wb_out.fixes_enu.shape)}")
    summary["wideband"] = tuple(wb_out.fixes_enu.shape)
    return summary


if __name__ == "__main__":
    import sys

    dev = sys.argv[1] if len(sys.argv) > 1 else "cuda"
    fn, args = entry(dev)
    print("entry() ok:", tuple(fn(*args).fix.position_enu.shape))
    n = int(sys.argv[2]) if len(sys.argv) > 2 else (torch.cuda.device_count() if dev == "cuda" else 4)
    print(f"dryrun_multichip({n}) ok:", dryrun_multichip(n, dev)[0])
