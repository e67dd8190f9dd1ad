"""Dataset distribution: download tickets, locks, progress, two-phase commit.

The port's copy of ``bqueryd_tpu/download.py``, with the same store keys,
slot values and staging layout, so that a ticket registered by either
package's controller is claimed, fetched and activated by either
package's downloader and mover (through a ``file://`` or ``redis://``
store).  It imports neither torch nor pandas.

The host-side pipeline that gets sharded tables onto worker machines —
capability match for the reference's downloader/movebcolz machinery:

* the controller registers a **ticket**: one coordination-store hash per
  download, one slot per (node, file-url), value ``"<timestamp>_<progress>"``
  starting at ``-1`` (reference bqueryd/controller.py:435-469);
* every downloader polls the tickets, claims (node, ticket, file) work with a
  TTL lock, streams the blob into ``incoming/<ticket>/``, heartbeats progress
  into the slot, marks it DONE (reference bqueryd/worker.py:358-498);
* a cancelled ticket (slots deleted) aborts mid-flight downloads
  (reference bqueryd/worker.py:418-428);
* the **movebcolz** role watches the same tickets and, only when EVERY slot
  on EVERY node is DONE, atomically swaps the new shard dirs into the serving
  directory, writing a ``bqueryd.metadata`` provenance file into each —
  the two-phase commit that flips all nodes in sync (reference
  bqueryd/worker.py:570-637, README.md:153).
"""

import json
import os
import random
import shutil
import time
import zipfile

import bqueryd_tpu_torch
from bqueryd_tpu_torch import blob as blob_mod
from bqueryd_tpu_torch.utils.fs import mkdir_p, rm_file_or_dir

DONE = "DONE"
ERROR_PREFIX = "ERROR"
METADATA_FILENAME = "bqueryd.metadata"


def ticket_key(ticket):
    return bqueryd_tpu_torch.REDIS_TICKET_KEY_PREFIX + ticket


def lock_name(node, ticket, fileurl):
    return bqueryd_tpu_torch.REDIS_DOWNLOAD_LOCK_PREFIX + node + ticket + fileurl


def set_progress(store, node, ticket, fileurl, progress):
    store.hset(ticket_key(ticket), f"{node}_{fileurl}", f"{time.time()}_{progress}")


def slot_state(value):
    """Progress slot value -> the progress token after the last underscore."""
    return value.rpartition("_")[2]


# ---------------------------------------------------------------------------
# controller side
# ---------------------------------------------------------------------------

def placement_nodes(filename, nodes, factor):
    """Replica placement: the ``factor`` nodes that should hold ``filename``,
    chosen by rendezvous hashing (highest-random-weight) so the choice is
    deterministic per file, stable under node churn (only 1/n of files move
    when a node joins/leaves), and balanced across the fleet.  ``factor``
    <= 0 or >= len(nodes) means every node (the historical full fan-out)."""
    import zlib

    if factor <= 0 or factor >= len(nodes):
        return list(nodes)
    ranked = sorted(
        nodes,
        key=lambda node: zlib.crc32(f"{node}\x00{filename}".encode()),
    )
    return ranked[:factor]


def setup_download(controller, msg):
    """Register a ticket for every (file, placement-node) pair and either
    park the RPC until a TicketDoneMessage (wait=True) or return the ticket
    immediately.

    Placement honors ``BQUERYD_TPU_REPLICA_FACTOR`` (overridable per ticket
    via ``replica_factor=``): 0 keeps the historical every-node fan-out; N
    targets N holders per file via rendezvous hashing — how a cold shard
    gets the second holder the failover dispatch needs."""
    _args, kwargs = msg.get_args_kwargs()
    filenames = kwargs.get("filenames") or []
    bucket = kwargs.get("bucket")
    wait = kwargs.get("wait", False)
    scheme = kwargs.get("scheme", "s3")
    if not filenames or not bucket:
        raise ValueError("download needs filenames=[...] and bucket=...")

    factor = kwargs.get("replica_factor")
    if factor is None:
        # the controller ctor is the single parse site for
        # BQUERYD_TPU_REPLICA_FACTOR (clamped to >= 0); re-reading the env
        # here would drift from those semantics
        factor = getattr(controller, "replica_factor", 0)

    nodes = sorted(
        {info.get("node") for info in controller.worker_map.values() if info.get("node")}
    )
    if not nodes:
        # no workers yet: register for this controller's own node so the
        # ticket is still actionable by co-located downloaders
        nodes = [controller.node_name]

    ticket = os.urandom(8).hex()
    # the shards this ticket activates: once a mover reports it done, the
    # controller's caches of those names (stats, rollups) are stale
    controller.note_ticket(
        ticket, [_strip_zip(os.path.basename(f)) for f in filenames])
    for filename in filenames:
        fileurl = f"{scheme}://{bucket}/{filename}"
        for node in placement_nodes(filename, nodes, int(factor)):
            set_progress(controller.store, node, ticket, fileurl, -1)

    if wait:
        controller.rpc_segments[f"ticket_{ticket}"] = {
            "client_token": msg["token"],
            "msg": msg,
            "created": time.time(),
        }
    else:
        reply = msg.copy()
        reply.add_as_binary("result", ticket)
        controller.reply_rpc_message(msg["token"], reply)


# ---------------------------------------------------------------------------
# downloader side
# ---------------------------------------------------------------------------

def incoming_dir(worker, ticket):
    base = os.environ.get(
        "BQUERYD_TPU_INCOMING", os.path.join(worker.data_dir, "incoming")
    )
    return os.path.join(base, ticket)


def check_downloads(worker):
    """One poll cycle: claim any pending slot for this node and hand it to
    the worker's download pool.  The claim lock (TTL-bounded, so a crashed
    downloader's work is reclaimable) stays held by the in-flight job and
    also stops this poller re-claiming the same slot next tick."""
    keys = worker.store.keys(bqueryd_tpu_torch.REDIS_TICKET_KEY_PREFIX + "*")
    random.shuffle(keys)
    node = worker.node_name
    for key in keys:
        ticket = key[len(bqueryd_tpu_torch.REDIS_TICKET_KEY_PREFIX):]
        for slot, value in worker.store.hgetall(key).items():
            slot_node, _, fileurl = slot.partition("_")
            state = slot_state(value)
            if slot_node != node or state == DONE or state.startswith(
                ERROR_PREFIX
            ):
                continue
            lock = worker.store.lock(
                lock_name(node, ticket, fileurl),
                ttl=bqueryd_tpu_torch.REDIS_DOWNLOAD_LOCK_DURATION,
            )
            if not lock.acquire(blocking=False):
                continue
            worker.run_download(ticket, fileurl, lock)


def get_backend(worker, scheme):
    """Backend construction seam: tests and exotic deployments override this
    (or the worker's ``blob_backend`` attribute) — the subclass-level seam
    strategy of the reference tests (reference tests/test_download.py:25-45)."""
    override = getattr(worker, "blob_backend", None)
    if override is not None:
        return override
    return blob_mod.backend_for(scheme)


def download_file(worker, ticket, fileurl, max_retries=3, lock=None):
    """Stream one blob into incoming/<ticket>/<filename>; zip archives are
    extracted in place (shards travel zipped, reference bqueryd/worker.py:453,
    500-505).  Mid-flight cancellation: if the ticket's slot disappears, the
    download aborts and cleans up.  ``lock`` is the claim lock, periodically
    extended from the progress path so a fetch outlasting the TTL can't be
    re-claimed into a duplicate concurrent download."""
    scheme, bucket, key = blob_mod.parse_url(fileurl)
    backend = get_backend(worker, scheme)
    dest_dir = incoming_dir(worker, ticket)
    mkdir_p(dest_dir)
    filename = os.path.basename(key)
    dest = os.path.join(dest_dir, filename)
    final_target = os.path.join(dest_dir, _strip_zip(filename))
    if os.path.exists(final_target) and final_target != dest:
        # already present from an earlier attempt (reference bqueryd/worker.py:455-457)
        set_progress(worker.store, worker.node_name, ticket, fileurl, DONE)
        return

    watch = CancelWatch(
        worker.store, worker.node_name, ticket, fileurl,
        lock=lock, lock_ttl=bqueryd_tpu_torch.REDIS_DOWNLOAD_LOCK_DURATION,
    )

    def progress(done):
        # cancellation check on EVERY chunk, BEFORE any write: a progress
        # hset after delete_download would resurrect the deleted slot and
        # the cancellation would be lost forever (writes are what's
        # rate-limited, not checks — the reverse drops cancellations)
        if watch.cancelled():
            raise DownloadCancelled(fileurl)
        watch.maybe_write_progress(done)

    for attempt in range(max_retries):
        try:
            backend.fetch(bucket, key, dest, progress_cb=progress)
            break
        except DownloadCancelled:
            worker.logger.info("download %s cancelled", fileurl)
            rm_file_or_dir(dest_dir)
            return
        except Exception:
            if attempt == max_retries - 1:
                raise
            worker.logger.warning(
                "download %s attempt %d failed, retrying", fileurl, attempt + 1
            )
            time.sleep(0.5 * (attempt + 1))

    if zipfile.is_zipfile(dest):
        with zipfile.ZipFile(dest) as zf:
            extract_dir = final_target
            mkdir_p(extract_dir)
            zf.extractall(extract_dir)
        os.remove(dest)
    set_progress(worker.store, worker.node_name, ticket, fileurl, DONE)


def _strip_zip(filename):
    return filename[:-4] if filename.endswith(".zip") else filename


class DownloadCancelled(Exception):
    pass


class CancelWatch:
    """Cancellation detection + rate-limited progress heartbeat for one
    in-flight download.

    ``cancelled()`` (a single hget) runs on every chunk;
    ``maybe_write_progress`` throttles the hset to one per ``interval`` so
    the store isn't hammered.  The check-before-write ordering matters: an
    unconditional progress write after a client's ``delete_download`` would
    re-create the deleted slot and lose the cancellation.  A delete landing
    in the instant between check and write still resurrects the slot — the
    reference's per-chunk check/write pair had the same (wider) window.

    When a claim ``lock`` is supplied its TTL is re-armed from the same
    throttled path (every ``lock_ttl/3`` seconds), so a fetch that outlasts
    the TTL keeps its claim instead of letting another poll cycle start a
    duplicate concurrent download to the same dest file."""

    def __init__(
        self, store, node, ticket, fileurl, interval=2.0,
        lock=None, lock_ttl=None,
    ):
        self.store = store
        self.node = node
        self.ticket = ticket
        self.fileurl = fileurl
        self.slot = f"{node}_{fileurl}"
        self.key = ticket_key(ticket)
        self.interval = interval
        self.lock = lock if lock is not None and lock_ttl else None
        self.lock_ttl = lock_ttl
        self._last_write = 0.0
        self._last_extend = time.time()

    def cancelled(self):
        return self.store.hget(self.key, self.slot) is None

    def maybe_write_progress(self, done):
        now = time.time()
        if now - self._last_write < self.interval:
            return
        self._last_write = now
        set_progress(self.store, self.node, self.ticket, self.fileurl, done)
        if self.lock is not None and now - self._last_extend >= self.lock_ttl / 3:
            self._last_extend = now
            try:
                self.lock.extend(self.lock_ttl)
            except Exception:
                pass  # best-effort: an expired claim is the pre-existing risk


def remove_ticket(worker, ticket):
    """Drop this node's slots for a ticket and its staging dir."""
    key = ticket_key(ticket)
    node = worker.node_name
    for slot in list(worker.store.hgetall(key)):
        if slot.partition("_")[0] == node:
            worker.store.hdel(key, slot)
    rm_file_or_dir(incoming_dir(worker, ticket))


def fail_ticket(worker, ticket, fileurl, error):
    """Mark a terminally failed download as ERROR in its slot (instead of the
    reference's slot deletion, reference bqueryd/worker.py:558-567, which made
    the remaining nodes' all-DONE barrier pass and activate a PARTIAL dataset
    while the waiting client was told DONE — flagged two-phase-commit fix).

    The ERROR state poisons the ticket: movebcolz never activates it (and
    cleans its own staging), waiting clients get the error back, and
    ``delete_download(ticket)`` clears the record."""
    # the state token must survive slot_state()'s rpartition('_') parsing
    reason = str(error).replace("_", "-")[:80] or "failed"
    set_progress(
        worker.store, worker.node_name, ticket, fileurl,
        f"{ERROR_PREFIX}:{reason}",
    )
    rm_file_or_dir(incoming_dir(worker, ticket))


def ticket_error(store, ticket):
    """First ERROR state recorded on a ticket, or None."""
    for value in store.hgetall(ticket_key(ticket)).values():
        state = slot_state(value)
        if state.startswith(ERROR_PREFIX):
            return state
    return None


# ---------------------------------------------------------------------------
# movebcolz side (phase 2 of the commit)
# ---------------------------------------------------------------------------

def check_moves(worker):
    """Activate a ticket only when every slot across ALL nodes is DONE and
    this node staged files for it (reference bqueryd/worker.py:594-633)."""
    for key in worker.store.keys(bqueryd_tpu_torch.REDIS_TICKET_KEY_PREFIX + "*"):
        ticket = key[len(bqueryd_tpu_torch.REDIS_TICKET_KEY_PREFIX):]
        entries = worker.store.hgetall(key)
        if not entries:
            continue
        states = [slot_state(v) for v in entries.values()]
        if any(s.startswith(ERROR_PREFIX) for s in states):
            # poisoned ticket: never activate anywhere; drop own staging so
            # no node serves a partial dataset (the ERROR slot itself stays
            # visible until delete_download clears it)
            rm_file_or_dir(incoming_dir(worker, ticket))
            continue
        if not all(s == DONE for s in states):
            continue
        staging = incoming_dir(worker, ticket)
        if not os.path.isdir(staging):
            continue
        movebcolz(worker, ticket)


def movebcolz(worker, ticket):
    """Atomically swap staged shard dirs into the serving data_dir, stamping
    provenance metadata into each (reference bqueryd/worker.py:573-592)."""
    staging = incoming_dir(worker, ticket)
    for name in sorted(os.listdir(staging)):
        src = os.path.join(staging, name)
        if not os.path.isdir(src):
            continue
        with open(os.path.join(src, METADATA_FILENAME), "w") as f:
            json.dump({"ticket": ticket, "timestamp": time.time()}, f)
        dest = os.path.join(worker.data_dir, name)
        rm_file_or_dir(dest)
        shutil.move(src, dest)
        worker.logger.info("activated %s (ticket %s)", name, ticket)
    worker.remove_ticket(ticket)
