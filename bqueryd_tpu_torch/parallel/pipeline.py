"""Bounded shard-stage pipeline: one shared thread pool + stage accounting.

The port's copy of ``bqueryd_tpu/parallel/pipeline.py``.  The host stages
of a query -- storage decode, factorize/align, NumPy packing -- run on one
bounded process-wide pool, so shard (or column) *i+1*'s host work overlaps
shard *i*'s.  Device work (H2D copies, kernel launches, the D2H fetch)
stays on the calling thread: the executor submits only host functions
here.

* :func:`map_ordered` -- run a stage function over shards on the bounded
  pool, results in input order (the contract ``hostmerge.merge_payloads``
  and the executor's key alignment both rely on);
* :func:`submit` / :func:`pool` -- double-buffering seams (the executor
  keeps one column build in flight ahead of its upload loop, and prefetches
  storage decode while alignment runs);
* :func:`stage` -- wall-clock busy accounting per stage name (thread-safe,
  process-global).  Busy time sums across all pool threads, so a busy/wall
  ratio above the serial share shows concurrent execution.

The pool is sized by ``BQUERYD_TPU_PIPELINE_THREADS`` (default
``min(16, cpu)``; ``1`` serializes every stage).  The variable is read per
call and the pool rebuilt on a size change.
"""

import contextlib
import logging
import os
import threading
import time

_DEFAULT_THREADS = min(16, os.cpu_count() or 4)


def pipeline_threads():
    """Pool width from ``BQUERYD_TPU_PIPELINE_THREADS`` (default
    ``min(16, cpu)``); 1 disables every pipeline overlap (serial stages),
    0/negative and unparseable values fall back to the default."""
    raw = os.environ.get("BQUERYD_TPU_PIPELINE_THREADS")
    if raw is None:
        return _DEFAULT_THREADS
    try:
        n = int(raw)
    except ValueError:
        logging.getLogger("bqueryd_tpu_torch").warning(
            "unparseable BQUERYD_TPU_PIPELINE_THREADS=%r, using default %d",
            raw, _DEFAULT_THREADS,
        )
        return _DEFAULT_THREADS
    return n if n >= 1 else _DEFAULT_THREADS


_pool_lock = threading.Lock()
_pool = None
_pool_width = None


def pool():
    """The process-wide pipeline ThreadPoolExecutor, (re)built to the
    current ``pipeline_threads()`` width.

    A replaced pool is not shut down: an in-flight ``map_ordered`` may still
    submit to it.  Its idle threads cost only memory until process exit."""
    global _pool, _pool_width
    width = pipeline_threads()
    with _pool_lock:
        if _pool is None or _pool_width != width:
            from concurrent.futures import ThreadPoolExecutor

            _pool = ThreadPoolExecutor(
                max_workers=width, thread_name_prefix="bq-pipeline"
            )
            _pool_width = width
        return _pool


def submit(fn, *args, **kwargs):
    """Submit one stage job; with a one-thread pipeline the call runs at
    once and its result (or exception) is wrapped in a completed future."""
    if pipeline_threads() <= 1:
        from concurrent.futures import Future

        f = Future()
        try:
            f.set_result(fn(*args, **kwargs))
        except BaseException as exc:  # the future carries it to .result()
            f.set_exception(exc)
        return f
    return pool().submit(fn, *args, **kwargs)


def map_ordered(fn, items):
    """Map ``fn`` over ``items`` on the pipeline pool, returning results in
    input order, at most ``pipeline_threads()`` jobs in flight.  Runs
    serially when that width or the item count is 1."""
    items = list(items)
    width = pipeline_threads()
    if len(items) <= 1 or width <= 1:
        return [fn(it) for it in items]
    # at most `width` jobs in flight: prime a window, then launch the next
    # item as each result is taken
    futures = {}
    results = [None] * len(items)
    next_idx = iter(range(len(items)))
    executor = pool()

    def launch():
        for i in next_idx:
            futures[i] = executor.submit(fn, items[i])
            return

    for _ in range(min(width, len(items))):
        launch()
    try:
        for i in range(len(items)):
            results[i] = futures.pop(i).result()
            launch()
    except BaseException:
        # the query already failed: queued shards must not burn the shared
        # pool (running ones finish; cancel() cannot interrupt them)
        for fut in futures.values():
            fut.cancel()
        raise
    return results


class StageClock:
    """Thread-safe per-stage busy seconds and call counts."""

    def __init__(self):
        self._lock = threading.Lock()
        self._busy = {}    # stage -> seconds
        self._calls = {}   # stage -> count

    def add(self, stage_name, seconds):
        with self._lock:
            self._busy[stage_name] = (
                self._busy.get(stage_name, 0.0) + float(seconds)
            )
            self._calls[stage_name] = self._calls.get(stage_name, 0) + 1

    def snapshot(self):
        with self._lock:
            return {
                "busy_seconds": dict(self._busy),
                "calls": dict(self._calls),
            }

    def reset(self):
        with self._lock:
            self._busy.clear()
            self._calls.clear()


_clock = StageClock()


def clock():
    """The process-global :class:`StageClock`."""
    return _clock


@contextlib.contextmanager
def stage(name):
    """Time one stage occurrence into the global clock."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _clock.add(name, time.perf_counter() - t0)
