"""A kernel's share of its roofline (%) from a program span: the least time
of its work (``work/<stage>.py`` at the card's published peaks) over the
median of the span's device ms a dispatch (``readers/program_spans.py``).
None where the program records no such span, or off the card."""

from harness import manifest
from harness.driver import least_ms


def read(run, span, work):
    ms = manifest.reader("program_spans", run.cell.bench_dir).read(run, span=span, value="device_ms")
    if not ms:
        return None
    return 100.0 * least_ms(run.cell, run, work) / ms
