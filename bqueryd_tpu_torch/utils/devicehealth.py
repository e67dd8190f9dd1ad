"""Device health: detect a wedged card without ever hanging a caller.

The port of ``bqueryd_tpu/utils/devicehealth.py``.  A device that stops
answering (a lost CUDA context, a hung kernel, a card fallen off the bus)
blocks any thread that touches it, inside native code where no signal
reaches it.  Every liveness question is therefore answered by SACRIFICIAL
daemon threads: a probe thread runs one tiny op plus ``.item()`` on the
watched device; the asking thread waits at most a deadline and never joins
the probe.  A hung probe parks on the dead device forever (a daemon: it
cannot block process exit) while callers see the device latched as
wedged.  Routing then sends every query the host kernels can serve to the
host (:func:`bqueryd_tpu_torch.models.query.host_kernel_rows` returns its
cap), and device-only work fails with an error instead of hanging the
worker loop.  A later successful probe unlatches.

The probe runs on the devices a node registers with :func:`watch` (the
engine registers its own device, the executor each of its cards), never on
an implicit current device: a process that registered none has no device
intent and never launches a probe.  At most one probe is in flight; a dead device costs one parked
thread per probe attempt, rate-limited to the recheck interval.
"""

import os
import threading
import time

_lock = threading.Lock()
_wedged = False
_probe_started = None     # monotonic start of the in-flight probe, or None
_last_probe_start = 0.0   # start of the most recent probe, any outcome
_abandoned = 0            # probes written off as hung since the last success
_generation = 0           # incremented on every not-wedged -> wedged flip
_device = None            # the first torch device probes run on, or None
_devices = ()             # every torch device probes run on

#: past this many parked probe threads, relaunch only every 10 intervals:
#: a permanently dead device must not grow a thread per interval forever
_MAX_ABANDONED_FAST = 16


def probe_timeout_s():
    """Deadline for one tiny op plus fetch
    (``BQUERYD_TPU_DEVICE_PROBE_TIMEOUT_S``, default 60).  ``0`` disables
    wedge detection entirely (no probes, never latched)."""
    return float(os.environ.get("BQUERYD_TPU_DEVICE_PROBE_TIMEOUT_S", 60))


def _recheck_interval_s():
    return float(
        os.environ.get("BQUERYD_TPU_DEVICE_PROBE_INTERVAL_S", 30)
    )


def watch(device):
    """Register the torch device probes run on (the node's own device), or
    a list of them (an executor's cards; a repeated device is probed
    once).  Until a device is registered the default probe never
    launches."""
    global _device, _devices
    devices = (tuple(device) if isinstance(device, (list, tuple))
               else (device,))
    with _lock:
        _devices = tuple(dict.fromkeys(devices))
        _device = _devices[0]


def watched_device():
    """The first registered probe device, or None."""
    with _lock:
        return _device


def _default_probe():
    """One tiny op on each watched device and a synchronising fetch: a
    card that does not answer keeps the probe from returning."""
    import torch

    for device in _devices or (_device,):
        (torch.zeros((), device=device) + 1).item()


#: test seam: replaced to simulate a wedged device without real hangs
_probe_fn = _default_probe


def _can_probe():
    """A probe has somewhere to run: a watched device, or a replaced
    probe function."""
    return _device is not None or _probe_fn is not _default_probe


def _latch_locked():
    """Set the latch (under _lock) and bump the generation on the
    not-wedged -> wedged transition: the single place the rule lives."""
    global _wedged, _generation
    if not _wedged:
        _generation += 1
    _wedged = True


def _probe_body(my_start):
    global _probe_started, _wedged, _abandoned
    try:
        _probe_fn()
    except Exception:
        # a probe that ERRORS answered within the deadline, but the device
        # is unusable: latch; the interval clock keeps re-probing
        with _lock:
            if _probe_started == my_start:
                _probe_started = None
            _latch_locked()
        return
    with _lock:
        # an abandoned probe that returns after a recovery is good news
        # too: any success unlatches
        if _probe_started == my_start:
            _probe_started = None
        _wedged = False
        _abandoned = 0


def _start_probe_locked():
    global _probe_started, _last_probe_start
    _probe_started = _last_probe_start = time.monotonic()
    threading.Thread(
        target=_probe_body,
        args=(_probe_started,),
        name="bqueryd-device-probe",
        daemon=True,
    ).start()


def backend_wedged(launch=True):
    """Whether the device is currently latched as wedged.

    Never blocks: state transitions ride the background probes.  An
    in-flight probe past the deadline flips the latch and is written off,
    so the interval clock keeps launching fresh probes and a recovered
    device unlatches within an interval plus one op.  Past
    ``_MAX_ABANDONED_FAST`` written-off probes the relaunch cadence drops
    to every 10 intervals.

    ``launch=False`` reads the latch without ever starting a probe, for
    callers that may run in a process with no device intent (the routing
    threshold under an operator's environment pin)."""
    global _probe_started, _abandoned
    if probe_timeout_s() <= 0:
        return False  # detection disabled: never latched, no probes
    now = time.monotonic()
    with _lock:
        if _probe_started is not None:
            if now - _probe_started > probe_timeout_s():
                _latch_locked()
                # write the hung probe off so the clock can relaunch
                _probe_started = None
                _abandoned += 1
        elif launch and _can_probe():
            interval = _recheck_interval_s()
            if _abandoned >= _MAX_ABANDONED_FAST:
                interval *= 10
            if now - _last_probe_start > interval:
                _start_probe_locked()
        return _wedged


def run_with_deadline(fn, timeout_s):
    """Run ``fn`` in a sacrificial daemon thread; return ``(done, result)``.

    ``done`` is False when the deadline passed: the thread is abandoned,
    never joined, and its eventual result discarded.  An exception inside
    ``fn`` counts as done with result None."""
    box = {}
    ev = threading.Event()

    def body():
        try:
            box["result"] = fn()
        except Exception:
            box["result"] = None
        finally:
            ev.set()

    threading.Thread(target=body, daemon=True).start()
    if ev.wait(timeout_s):
        return True, box.get("result")
    return False, None


def latch_wedged():
    """Latch the device as wedged on direct evidence (a device call that
    blew its deadline, such as the dispatch-floor measurement).  The
    interval clock keeps probing, so recovery stays automatic."""
    with _lock:
        _latch_locked()


def wedge_marker():
    """Snapshot for evidence windows: ``(generation, currently_wedged)``.
    A window is clean iff the marker is identical before and after and
    neither end is wedged: a wedge that recovered inside the window bumps
    the generation though both ends read not-wedged."""
    with _lock:
        return (_generation, _wedged)


def window_dirty(start_marker, end_marker=None):
    """Whether a wedge overlapped the window between two markers."""
    if end_marker is None:
        end_marker = wedge_marker()
    return (
        start_marker != end_marker or start_marker[1] or end_marker[1]
    )


def health_snapshot():
    """Read-only state for monitoring (never launches a probe):
    ``{"wedged": 0/1, "abandoned_probes": n, "wedge_generation": n}``."""
    with _lock:
        return {
            "wedged": 1 if _wedged else 0,
            "abandoned_probes": _abandoned,
            "wedge_generation": _generation,
        }


def force_state(wedged):
    """Pin the latch without probing (and reset the interval clock, so the
    next ``backend_wedged`` does not launch a real probe under a pinned
    state).  Pinning it wedged bumps the generation like a real flip.
    Tests and ``chip_smoke.py`` force the latch through this."""
    global _wedged, _probe_started, _last_probe_start, _abandoned
    with _lock:
        if wedged:
            _latch_locked()
        else:
            _wedged = False
        _probe_started = None
        _last_probe_start = time.monotonic()
        _abandoned = 0
