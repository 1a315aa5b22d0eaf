"""A stage's share of its roofline (%): the least time of its work
(``work/<stage>.py`` at the card's published peaks) over the median of
its device spans in a dispatch."""

from harness.driver import least_ms, median_stage_ms


def read(run, stages, work):
    ms = median_stage_ms(run.device_spans, stages)
    if not ms:
        return None
    return 100.0 * least_ms(run.cell, run, work) / ms
