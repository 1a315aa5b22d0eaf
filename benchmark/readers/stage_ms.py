"""ms a block of the named stages: the median over the window's dispatches
of their summed device spans (CUDA events at the program's marks), over
the blocks a dispatch carries."""

from harness.driver import median_stage_ms


def read(run, stages):
    ms = median_stage_ms(run.device_spans, stages)
    return None if ms is None else ms / run.blocks
