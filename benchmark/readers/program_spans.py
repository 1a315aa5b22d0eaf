"""A span or counter of the program's own step record
(``radio_mapper_tpu_torch.utils.spans``): the median over the measured
window's dispatches of the named span's value a dispatch, summed where
the span repeats in a step.

A traced run records every dispatch it hands over with a hook: the warm
ones before the window, the window's ``run.dispatches``, then the
``run.profiled_dispatches`` of the profiler's trace; so the window's
steps are the store's newest but the profiled ones. ``value`` is
``host_ms`` (host clock), ``device_ms`` (CUDA events; None off the
card) or ``syncs`` (the host's synchronising calls inside the span and
the spans below it). None where the program keeps no such record or the
window's steps have no such span."""

import statistics


def window_steps(run):
    try:
        from radio_mapper_tpu_torch.utils import spans
    except ImportError:
        return []
    recs = spans.steps()
    end = len(recs) - run.profiled_dispatches
    return recs[max(0, end - run.dispatches):max(0, end)]


def read(run, span, value):
    vals = [getattr(rec, value)(span) for rec in window_steps(run)]
    vals = [v for v in vals if v is not None]
    return float(statistics.median(vals)) if vals else None
