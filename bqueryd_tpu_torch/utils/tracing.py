"""Per-phase timing of a worker's calc reply, and the profiler hooks.

A worker times each groupby's phases into a :class:`PhaseTimer` and sends
``timer.as_dict()`` in the reply under ``phase_timings``: ``{phase:
seconds, ..., "_total": seconds}``.  All durations use
``time.perf_counter``.

A PhaseTimer may carry an :class:`bqueryd_tpu_torch.obs.trace.SpanRecorder`:
each phase then also records a tracing span (wall-clock start, perf_counter
duration), which is how worker phases reach the controller's
``rpc.trace(trace_id)`` waterfall.  The spans reach the recorder through
the timer, not through a contextvar: the executor times phases on the
pipeline's pool threads too, where a contextvar set on the loop thread is
not visible.

:func:`trace_span` opens a ``torch.profiler.record_function`` range (and,
on a CUDA device, an NVTX range) under ``BQUERYD_TPU_PROFILE=1``;
:func:`profiler_trace` captures a Chrome trace of a block.
"""

import contextlib
import os
import threading
import time

#: key of the whole-call wall in :meth:`PhaseTimer.as_dict`, named so that
#: no real phase can overwrite it
TOTAL_KEY = "_total"


class PhaseTimer:
    """Accumulates named phase durations; a phase that recurs sums.

    ``recorder``/``span_names`` (optional): a SpanRecorder receiving one
    span per phase occurrence, its name mapped through ``span_names``
    (``obs.trace.PHASE_SPAN_NAMES``: ``open`` -> ``storage_decode``); a
    phase mapped to None is timed but records no span.  Phases may run
    concurrently on the pipeline's threads: the lock keeps the sums
    whole."""

    def __init__(self, recorder=None, span_names=None):
        self.timings = {}
        self.recorder = recorder
        self.span_names = span_names or {}
        self._started = time.perf_counter()
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def phase(self, name, tags=None):
        """Time the block as ``name``; ``tags``, which the block may fill
        (the bytes a transfer moved, say), land on its span."""
        start_ts = time.time()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            duration = time.perf_counter() - t0
            with self._lock:
                self.timings[name] = self.timings.get(name, 0.0) + duration
            span_name = self.span_names.get(name, name)
            if self.recorder is not None and span_name is not None:
                self.recorder.record(span_name, start_ts, duration,
                                     tags=tags)

    def debit(self, name, seconds):
        """Subtract a serially nested sub-phase's wall from its enclosing
        phase (the device -> host ``fetch`` inside ``aggregate``), so that
        the same seconds are not billed twice.  The enclosing phase's entry
        may land later (on its exit): the negative adjustment nets out in
        the sum."""
        with self._lock:
            self.timings[name] = self.timings.get(name, 0.0) - seconds

    def total(self):
        return time.perf_counter() - self._started

    def as_dict(self):
        out = dict(self.timings)
        out[TOTAL_KEY] = self.total()
        return out


def profiling_enabled():
    """``BQUERYD_TPU_PROFILE=1``, read per call."""
    return os.environ.get("BQUERYD_TPU_PROFILE") == "1"


@contextlib.contextmanager
def trace_span(name, device=None):
    """A ``torch.profiler.record_function`` range named ``name`` (tagged
    ``name[trace_id]`` when a trace context is active), and on a CUDA
    ``device`` an NVTX range of the same name, under
    ``BQUERYD_TPU_PROFILE=1``; a no-op otherwise.  A range that fails to
    open raises."""
    if not profiling_enabled():
        yield
        return
    import torch

    from bqueryd_tpu_torch.obs.trace import current_trace

    ctx = current_trace()
    label = f"{name}[{ctx.trace_id}]" if ctx is not None else name
    with contextlib.ExitStack() as stack:
        stack.enter_context(torch.profiler.record_function(label))
        if device is not None and torch.device(device).type == "cuda":
            stack.enter_context(torch.cuda.nvtx.range(label))
        yield


@contextlib.contextmanager
def profiler_trace(log_dir, device=None):
    """Capture a ``torch.profiler`` trace of the CPU activity, and of the
    CUDA activity for a CUDA ``device``, around a block and export it as a
    Chrome trace (``trace_<pid>_<ns>.json``) into ``log_dir``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
