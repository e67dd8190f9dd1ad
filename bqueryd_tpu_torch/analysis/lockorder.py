"""Runtime lock-order recorder: prove deadlock-freedom of the real paths.

The static checker (:mod:`bqueryd_tpu_torch.analysis.concurrency`) proves each
shared object takes ITS lock; it cannot see ordering BETWEEN locks.  With
the pipeline pool live, one thread holding the metrics-registry lock while
touching a cache whose lock another thread holds while rendering metrics is
a classic ABBA deadlock — invisible until the interleaving lands in
production.

This module records instead of hoping: :class:`TrackedLock` wraps a real
``threading.Lock``; every successful acquisition while other tracked locks
are held adds a directed edge (held -> acquired) to a process-wide (per
recorder) graph, remembering the exact acquisition SITES of both ends.
After driving the real pipeline/worker code paths under instrumented locks,
:meth:`LockOrderRecorder.cycles` answers whether any ordering cycle — any
potential deadlock — was ever observable, and the report names both
acquisition sites of every edge so the fix is a file:line away.

Tests adopt real objects with :func:`instrument_object`, which swaps every
``threading.Lock`` attribute for a tracked wrapper in place.  Acquiring a
tracked lock a thread already holds raises immediately (``threading.Lock``
is non-reentrant: that interleaving is a guaranteed self-deadlock, better
surfaced as an exception with a stack than as a hung test).

Deliberately not installed in production paths: the recorder costs a stack
walk per acquisition.  It is a test-harness instrument, same tier as the
injected-fault fixtures.
"""

import threading
import traceback


class LockOrderError(RuntimeError):
    pass


def _call_site(skip_internal=True):
    """`file:line (function)` of the acquiring frame, skipping this module's
    own wrapper frames."""
    for frame in reversed(traceback.extract_stack()):
        if skip_internal and frame.filename == __file__:
            continue
        return f"{frame.filename}:{frame.lineno} ({frame.name})"
    return "<unknown>"


class TrackedLock:
    """``threading.Lock`` lookalike that reports acquisitions to a recorder.

    Supports the surface the package's classes use: ``acquire``/``release``,
    context manager, ``locked``.
    """

    def __init__(self, recorder, name, inner=None):
        self._recorder = recorder
        self.name = name
        self._inner = inner if inner is not None else threading.Lock()

    def acquire(self, blocking=True, timeout=-1):
        self._recorder._before_acquire(self)
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            self._recorder._acquired(self, _call_site())
        return ok

    def release(self):
        self._recorder._released(self)
        self._inner.release()

    def locked(self):
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def __repr__(self):
        return f"<TrackedLock {self.name}>"


class LockOrderRecorder:
    """Per-test acquisition graph with cycle detection (module docstring)."""

    def __init__(self):
        self._tls = threading.local()
        self._graph_lock = threading.Lock()
        # (held_name, acquired_name) -> (held_site, acquired_site): first
        # observation wins — one witness per edge keeps reports readable
        self._edges = {}
        self.acquisitions = 0

    # -- TrackedLock callbacks ----------------------------------------------
    def _held(self):
        held = getattr(self._tls, "held", None)
        if held is None:
            held = self._tls.held = []
        return held

    def _before_acquire(self, lock):
        for other, _site in self._held():
            if other is lock:
                raise LockOrderError(
                    f"self-deadlock: thread re-acquires non-reentrant "
                    f"{lock.name} already held (acquired at {_site}), "
                    f"re-acquired at {_call_site()}"
                )

    def _acquired(self, lock, site):
        held = self._held()
        with self._graph_lock:
            self.acquisitions += 1
            for other, other_site in held:
                self._edges.setdefault(
                    (other.name, lock.name), (other_site, site)
                )
        held.append((lock, site))

    def _released(self, lock):
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] is lock:
                del held[i]
                return

    # -- analysis ------------------------------------------------------------
    def edges(self):
        with self._graph_lock:
            return dict(self._edges)

    def cycles(self):
        """Every elementary cycle in the acquisition graph, as lists of lock
        names (each cycle reported once, from its lexically-smallest node)."""
        edges = self.edges()
        adjacency = {}
        for a, b in edges:
            adjacency.setdefault(a, set()).add(b)
        cycles = []
        seen = set()

        def dfs(start, node, path, on_path):
            for nxt in sorted(adjacency.get(node, ())):
                if nxt == start:
                    # dedup by the ORDERED path (DFS always starts a cycle
                    # at its smallest node): both orientations over the
                    # same lock set are distinct deadlock orderings and
                    # must both be reported with their witness sites
                    key = tuple(path)
                    if key not in seen:
                        seen.add(key)
                        cycles.append(list(path))
                elif nxt > start and nxt not in on_path:
                    dfs(start, nxt, path + [nxt], on_path | {nxt})

        for start in sorted(adjacency):
            dfs(start, start, [start], {start})
        return cycles

    def report(self):
        """Readable cycle report naming both acquisition sites of every edge
        in every cycle; empty string when the graph is acyclic."""
        cycles = self.cycles()
        if not cycles:
            return ""
        edges = self.edges()
        lines = []
        for cycle in cycles:
            lines.append(
                "lock-order cycle: " + " -> ".join(cycle + [cycle[0]])
            )
            ring = cycle + [cycle[0]]
            for a, b in zip(ring, ring[1:]):
                held_site, acq_site = edges[(a, b)]
                lines.append(
                    f"  {b} acquired at {acq_site}"
                    f" while holding {a} (acquired at {held_site})"
                )
        return "\n".join(lines)

    def assert_no_cycles(self):
        report = self.report()
        if report:
            raise LockOrderError(report)

    # -- adoption helpers ----------------------------------------------------
    def lock(self, name):
        """A fresh tracked lock (for fixtures and new objects)."""
        return TrackedLock(self, name)

    def instrument_object(self, obj, prefix=None):
        """Swap every plain ``threading.Lock`` attribute of ``obj`` for a
        tracked wrapper in place (the wrapper adopts the existing inner lock,
        so already-held locks keep working).  Returns the names wrapped."""
        prefix = prefix or type(obj).__name__
        lock_type = type(threading.Lock())
        wrapped = []
        for attr, value in sorted(vars(obj).items()):
            if isinstance(value, lock_type):
                setattr(
                    obj, attr,
                    TrackedLock(self, f"{prefix}.{attr}", inner=value),
                )
                wrapped.append(f"{prefix}.{attr}")
        return wrapped

    def instrument_module_lock(self, module, attr, prefix=None):
        """Swap a module-global lock (e.g. ``pipeline._pool_lock``); returns
        a zero-arg restore callable."""
        original = getattr(module, attr)
        name = f"{prefix or module.__name__}.{attr}"
        setattr(module, attr, TrackedLock(self, name, inner=original))

        def restore():
            setattr(module, attr, original)

        return restore
