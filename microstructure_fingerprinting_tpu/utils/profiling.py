"""Tracing / profiling hooks.

The reference's only observability is ad-hoc ``time.time()`` deltas printed
at verbose>=2 (mf.py:624-631, 976, 1030-1032). Here the verbose print
contract is kept in MFModel.fit, and this module adds the device layer:
``jax.profiler`` trace capture around a region and lightweight named stage
timers that synchronize the device before reading the clock.
"""

import contextlib
import glob
import os
import time

import jax


@contextlib.contextmanager
def device_trace(log_dir):
    """Capture a jax/XLA profiler trace viewable in TensorBoard/Perfetto.

    >>> with device_trace('/tmp/mf_trace'):
    ...     model.fit(...)
    """
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def device_op_times(log_dir):
    """Per-op device time from the newest trace written under ``log_dir``.

    Sums, by name, the durations of the events on each GPU plane's "XLA
    Ops" line (its "Stream" lines where it has none). Returns
    ({op name: total ns}, busy ns, window ns): busy is the union of the op
    intervals, window spans the first op start to the last op end, so
    1 - busy / window is the device's idle share. A trace without a GPU
    plane gives ({}, 0, 0).
    """
    files = glob.glob(os.path.join(log_dir, "**", "*.xplane.pb"),
                      recursive=True)
    if not files:
        raise FileNotFoundError("no profiler trace under %s" % log_dir)
    data = jax.profiler.ProfileData.from_file(max(files,
                                                  key=os.path.getmtime))
    totals, spans = {}, []
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        lines = list(plane.lines)
        ops = [ln for ln in lines if ln.name == "XLA Ops"] or [
            ln for ln in lines if ln.name.startswith("Stream")]
        for line in ops:
            for ev in line.events:
                totals[ev.name] = totals.get(ev.name, 0) + ev.duration_ns
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    if not spans:
        return totals, 0, 0
    spans.sort()
    busy, (cur_lo, cur_hi) = 0, spans[0]
    for lo, hi in spans[1:]:
        if lo > cur_hi:
            busy += cur_hi - cur_lo
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    busy += cur_hi - cur_lo
    return totals, busy, max(hi for _lo, hi in spans) - spans[0][0]


class StageTimer(object):
    """Named wall-clock stage timers with device synchronization.

    >>> t = StageTimer()
    >>> with t.stage("rotate"):
    ...     out = kernel(x)
    >>> t.report()
    """

    def __init__(self, sync=True):
        self.sync = sync
        self.totals = {}
        self.counts = {}

    @contextlib.contextmanager
    def stage(self, name, sync_value=None):
        st = time.perf_counter()
        try:
            yield
        finally:
            if self.sync:
                if sync_value is not None:
                    jax.block_until_ready(sync_value)
                else:
                    jax.effects_barrier()
            dt = time.perf_counter() - st
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self, printer=print):
        for name in self.totals:
            printer("%-24s %8.3f s  (%d call%s)" %
                    (name, self.totals[name], self.counts[name],
                     "s" if self.counts[name] != 1 else ""))
        return dict(self.totals)


def annotate(name):
    """Decorator: label a function's device work in profiler traces."""
    def wrap(fn):
        def inner(*args, **kwargs):
            with jax.profiler.TraceAnnotation(name):
                return fn(*args, **kwargs)
        inner.__name__ = getattr(fn, "__name__", name)
        return inner
    return wrap
