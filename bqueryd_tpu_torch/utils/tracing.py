"""Per-phase timing of a worker's calc reply.

A worker times each groupby's phases into a :class:`PhaseTimer` and sends
``timer.as_dict()`` in the reply under ``phase_timings``: ``{phase:
seconds, ..., "_total": seconds}``.  All durations use
``time.perf_counter``.
"""

import contextlib
import time

#: key of the whole-call wall in :meth:`PhaseTimer.as_dict`, named so that
#: no real phase can overwrite it
TOTAL_KEY = "_total"


class PhaseTimer:
    """Accumulates named phase durations; a phase that recurs sums.
    Phases are timed on one thread (the worker's loop thread)."""

    def __init__(self):
        self.timings = {}
        self._started = time.perf_counter()

    @contextlib.contextmanager
    def phase(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.timings[name] = (
                self.timings.get(name, 0.0) + time.perf_counter() - t0
            )

    def total(self):
        return time.perf_counter() - self._started

    def as_dict(self):
        out = dict(self.timings)
        out[TOTAL_KEY] = self.total()
        return out
