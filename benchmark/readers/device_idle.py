"""The device's idle share (%) of the measured window: 1 − the device's
busy seconds a dispatch over the window's seconds a dispatch.

The busy seconds are the union of kernels, copies and fills in the
profiler's trace of the dispatches after the window, over their count:
the device's work a dispatch, which the profiler's cost on the host
does not change. The window's seconds a dispatch are those of the
untraced window, so the share is that of the window as it runs, not of
the profiled one, where the host is slower (``device.busy_s`` and
``device.window_s`` give that one)."""


def read(run):
    t = run.trace
    if t is None or not run.profiled_dispatches or not run.dispatches or t.busy_s <= 0:
        return None
    busy = t.busy_s / run.profiled_dispatches
    return 100.0 * (1.0 - busy / (run.window_s / run.dispatches))
