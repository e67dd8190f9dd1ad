"""Admission control of the port's controller: bounded queueing and
backpressure.

The port's copy of ``bqueryd_tpu/plan/admission.py``.  Without it, N
concurrent clients mean N concurrent fan-outs and unbounded work in
flight.  The admission controller bounds it:

* at most ``max_active`` plans execute at once;
* at most ``queue_depth`` more wait in a priority queue (priority
  ascending, then earliest deadline, then FIFO);
* at most ``client_quota`` tickets (active + queued) per client identity;
* anything beyond gets an explicit **BUSY** reply at once, so that clients
  see backpressure instead of a timeout and the controller's memory stays
  bounded;
* a queued ticket whose deadline passes expires without launching.

Env defaults (overridable per :class:`AdmissionController` instance):
``BQUERYD_TPU_ADMIT_MAX_ACTIVE`` (64), ``BQUERYD_TPU_ADMIT_QUEUE_DEPTH``
(256), ``BQUERYD_TPU_ADMIT_CLIENT_QUOTA`` (0 = unlimited).

Two hooks feed the controller's observability and keep this module free
of it: ``wait_observer(seconds)`` for every ticket launched from the
queue, and ``arrival_observer(decision, payload)`` for every submission
that is not a duplicate (ADMIT, QUEUED and BUSY alike: offered load).  An
observer that raises never breaks admission.

Control-plane module: stdlib only.
"""

import heapq
import itertools
import time

from bqueryd_tpu_torch.utils.env import env_num

ADMIT = "admit"
QUEUED = "queued"
BUSY = "busy"
#: the ticket is ALREADY live (a client retrying after its own timeout
#: resent the same identity): callers must not launch a second run — the
#: in-flight one will answer that identity, and its completion frees the
#: slot for the client's next retry
DUPLICATE = "duplicate"


def _env_int(name, default):
    return env_num(name, default, cast=int)


class AdmissionController:
    def __init__(self, max_active=None, queue_depth=None, client_quota=None):
        self.max_active = (
            _env_int("BQUERYD_TPU_ADMIT_MAX_ACTIVE", 64)
            if max_active is None else int(max_active)
        )
        self.queue_depth = (
            _env_int("BQUERYD_TPU_ADMIT_QUEUE_DEPTH", 256)
            if queue_depth is None else int(queue_depth)
        )
        self.client_quota = (
            _env_int("BQUERYD_TPU_ADMIT_CLIENT_QUOTA", 0)
            if client_quota is None else int(client_quota)
        )
        self._active = {}    # ticket_id -> client
        self._queued = {}    # ticket_id -> (client, priority, deadline, payload)
        self._heap = []      # (priority, deadline-or-inf, seq, ticket_id)
        self._seq = itertools.count()
        self._client_load = {}  # client -> active + queued count
        self._enqueued_at = {}  # ticket_id -> monotonic enqueue time
        #: called with the queued seconds of each ticket launched from the
        #: queue
        self.wait_observer = None
        #: called as ``arrival_observer(decision, payload)`` for each
        #: non-duplicate submission
        self.arrival_observer = None
        # lifetime totals, for stats()
        self.total_admitted = 0
        self.total_queued = 0
        self.total_busy = 0
        self.total_expired = 0

    # -- internals ----------------------------------------------------------
    def _charge(self, client, delta):
        n = self._client_load.get(client, 0) + delta
        if n <= 0:
            self._client_load.pop(client, None)
        else:
            self._client_load[client] = n

    def _notify_arrival(self, decision, payload):
        """Fire the arrival tap; returns ``decision``."""
        if self.arrival_observer is not None:
            try:
                self.arrival_observer(decision, payload)
            except Exception:
                pass  # an observer must never break admission
        return decision

    # -- surface -------------------------------------------------------------
    def submit(self, ticket_id, client, priority=0, deadline=None,
               payload=None):
        """Returns ADMIT (run now), QUEUED (held), BUSY (rejected), or
        DUPLICATE (this ticket is already active/queued — do NOT launch a
        second run for it)."""
        if ticket_id in self._active or ticket_id in self._queued:
            return DUPLICATE
        if self.client_quota > 0 and (
            self._client_load.get(client, 0) >= self.client_quota
        ):
            self.total_busy += 1
            return self._notify_arrival(BUSY, payload)
        if len(self._active) < self.max_active:
            self._active[ticket_id] = client
            self._charge(client, +1)
            self.total_admitted += 1
            return self._notify_arrival(ADMIT, payload)
        if len(self._queued) >= self.queue_depth:
            self.total_busy += 1
            return self._notify_arrival(BUSY, payload)
        entry = (
            float(priority or 0),
            float(deadline) if deadline is not None else float("inf"),
            next(self._seq),
            ticket_id,
        )
        self._queued[ticket_id] = (client, priority, deadline, payload)
        self._enqueued_at[ticket_id] = time.monotonic()
        heapq.heappush(self._heap, entry)
        self._charge(client, +1)
        self.total_queued += 1
        return self._notify_arrival(QUEUED, payload)

    def pop_ready(self, now=None):
        """Drain the queue into capacity.  Returns ``(launch, expired)``:
        payload lists of tickets to start now and tickets whose deadline
        passed while queued (already released)."""
        now = time.time() if now is None else now
        launch, expired = [], []
        while self._heap and len(self._active) < self.max_active:
            _p, _d, _seq, ticket_id = heapq.heappop(self._heap)
            item = self._queued.pop(ticket_id, None)
            if item is None:
                continue  # cancelled/expired earlier; stale heap entry
            enqueued = self._enqueued_at.pop(ticket_id, None)
            client, _priority, deadline, payload = item
            if deadline is not None and deadline <= now:
                self._charge(client, -1)
                self.total_expired += 1
                expired.append(payload)
                continue
            self._active[ticket_id] = client
            self.total_admitted += 1
            launch.append(payload)
            if self.wait_observer is not None and enqueued is not None:
                try:
                    self.wait_observer(max(time.monotonic() - enqueued, 0.0))
                except Exception:
                    pass  # an observer must never break admission
        # deadline sweep for tickets stuck behind higher-priority work
        if self._queued:
            for ticket_id, item in list(self._queued.items()):
                client, _priority, deadline, payload = item
                if deadline is not None and deadline <= now:
                    self._queued.pop(ticket_id, None)
                    self._enqueued_at.pop(ticket_id, None)
                    self._charge(client, -1)
                    self.total_expired += 1
                    expired.append(payload)
        return launch, expired

    def release(self, ticket_id):
        """A plan finished (reply sent, success or abort): free its slot."""
        client = self._active.pop(ticket_id, None)
        if client is not None:
            self._charge(client, -1)
            return True
        item = self._queued.pop(ticket_id, None)
        if item is not None:
            self._enqueued_at.pop(ticket_id, None)
            self._charge(item[0], -1)
            return True
        return False

    def stats(self):
        return {
            "active": len(self._active),
            "queued": len(self._queued),
            "max_active": self.max_active,
            "queue_depth": self.queue_depth,
            "client_quota": self.client_quota,
            "clients": len(self._client_load),
            "total_admitted": self.total_admitted,
            "total_queued": self.total_queued,
            "total_busy": self.total_busy,
            "total_expired": self.total_expired,
        }
