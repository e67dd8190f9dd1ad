"""Device-resident merge of the executor's per-device partial tables.

The port of ``bqueryd_tpu/parallel/devicemerge.py``.  The executor runs
one ``partial_tables`` call per device over that device's row of the
``[n_dev, width]`` pack; this module merges the per-device tables, written
for a list of torch devices where the reference traces collectives over a
mesh axis:

* **key-span partitioning**: the group codes are one shared key space (the
  executor's host alignment), so device ``d`` of ``n`` owns the contiguous
  span ``[d * span, (d + 1) * span)`` of the padded group axis
  (:func:`bucket_span`); ``ops.bucketize_partials`` pads a partial table
  onto that layout past every real group;
* **span-owned merge** (:func:`scatter_merge_partials`): owner ``d``
  receives its span of every device's table by peer copies
  (``Tensor.to(dev, non_blocking=True)``, on the current streams) and
  reduces it there: sums and counts add, min and max take the elementwise
  extremum.  That is what the reference's ``psum_scatter`` and
  ``pmin``/``pmax`` with an own-span slice give;
* **D2H of the final table only**: the executor fetches each owner's span
  and concatenates the spans in device order, so no per-device table
  leaves its device.

The dense top-k tables of the DAG fast path merge by gathering every
device's candidates of a span and re-selecting the best ``k``
(:func:`allgather_topk_merge`), the quantile sketch grids by adding
bucket counts (:func:`scatter_merge_grid`).  The copies and reductions are
plain torch ops: the reference's collectives are XLA ops, not Pallas
kernels.

``BQUERYD_TPU_DEVICE_MERGE=0`` is the kill switch: the executor fetches
every device's table and merges them with ``hostmerge.merge_payloads``,
and the controller dispatches one message per shard.  A
``torch.distributed`` job of more than one process (``ops.
maybe_init_distributed``) takes the ``psum`` mode: each process merges its
own devices, then an all-reduce (``ops.psum_partials``) leaves the whole
table on every process.

Bytes moved are accounted in :class:`MergeStats` (the worker's
``bqueryd_tpu_merge_*`` gauges).  Import-light: the controller reads
:func:`device_merge_enabled`, so torch loads only inside the merges.
"""

import os
import threading

#: merge modes of the executor
MODE_DEVICE = "device"   # span-owned merge, span-only fetch
MODE_HOST = "host"       # fetch every device's partials, hostmerge on host
MODE_PSUM = "psum"       # all-reduce across processes, replicated fetch


def device_merge_enabled():
    """The ``BQUERYD_TPU_DEVICE_MERGE`` kill switch (default on).  Off, the
    merge stays on the host end to end: the executor merges per-device
    partials with ``hostmerge.merge_payloads`` and the controller
    dispatches per shard instead of batching shard groups."""
    return os.environ.get("BQUERYD_TPU_DEVICE_MERGE", "1") != "0"


def _distributed_world():
    """World size of the initialized ``torch.distributed`` group, else 1.
    Does not import torch when no one else has."""
    import sys

    if "torch" not in sys.modules:
        return 1
    import torch.distributed as dist

    if not dist.is_available() or not dist.is_initialized():
        return 1
    return int(dist.get_world_size())


def resolve_mode():
    """The merge mode of this query: ``psum`` in a ``torch.distributed``
    job of more than one process (each process fetches only what its own
    devices hold, so the all-reduce's replicated table is the contract
    there), else ``device`` or, under the kill switch, ``host``."""
    if _distributed_world() > 1:
        return MODE_PSUM
    return MODE_DEVICE if device_merge_enabled() else MODE_HOST


def bucket_span(n_groups, n_devices):
    """Key-span partitioner: ``(span, padded_groups)`` for laying a
    ``n_groups``-wide table over ``n_devices`` contiguous owners.  Device
    ``d`` owns ``[d * span, (d + 1) * span)``; ``padded_groups == span *
    n_devices >= n_groups`` and the pad tail holds no real group."""
    n_groups = max(int(n_groups), 1)
    n_devices = max(int(n_devices), 1)
    span = -(-n_groups // n_devices)
    return span, span * n_devices


def _gather(leaves, owner, lo, hi):
    """The ``[lo, hi)`` slice of every device's leaf, on ``owner``."""
    return [leaf[lo:hi].to(owner, non_blocking=True) for leaf in leaves]


def _reduce(kind, parts):
    """Elementwise merge of equally shaped leaves by partial kind."""
    from bqueryd_tpu_torch.ops import groupby as gb

    out = parts[0]
    for part in parts[1:]:
        out = (gb._extremum(out, part, kind) if kind in ("min", "max")
               else gb._add(out, part))
    return out


def scatter_merge_partials(partials, devices, span):
    """Merge bucketized partial tables span-owned.  ``partials`` holds one
    tree per device (``{"rows", "aggs"}``, leaves ``[n_dev * span]`` from
    ``ops.bucketize_partials``, each on its device); returns one tree per
    device whose leaves are that device's span ``[span]`` of the merged
    table: sums and counts added, min and max their extremum.  One
    device's tree is returned as it is: there is nothing to merge."""
    if len(partials) == 1:
        return [partials[0]]
    out = []
    for d, owner in enumerate(devices):
        lo, hi = d * span, (d + 1) * span
        rows = _reduce("rows", _gather([p["rows"] for p in partials],
                                       owner, lo, hi))
        aggs = tuple(
            {kind: _reduce(kind, _gather([p["aggs"][i][kind]
                                          for p in partials], owner, lo, hi))
             for kind in part}
            for i, part in enumerate(partials[0]["aggs"])
        )
        out.append({"rows": rows, "aggs": aggs})
    return out


def reduce_partials(partials, owner):
    """Merge whole partial tables (one tree per device) onto ``owner``:
    the local stage of the psum mode, before the all-reduce."""
    n = int(partials[0]["rows"].shape[0])
    return scatter_merge_partials(partials, [owner], n)[0]


def topk_reselect(values, counts, k, largest, float_neg):
    """The best ``k`` of ``n`` candidate tables per group: ``values`` and
    ``counts`` are lists of ``[groups, k]`` dense tables and ``[groups]``
    counts on one device; a slot is live iff its rank is below its
    table's count.  Validity is the primary key and the value (best first)
    the secondary, from two stable sorts (torch has no lexsort), so that a
    zero-padded slot never shadows a live candidate.  Payloads carry
    values only, so which of equal candidates survives is unobservable:
    the result equals the host k-way merge as a multiset."""
    import torch

    from bqueryd_tpu_torch.ops import groupby as gb
    from bqueryd_tpu_torch.ops import relops

    dev = values[0].device
    rank = torch.arange(k, dtype=torch.int64, device=dev)
    cand = torch.cat(values, dim=1)
    valid = torch.cat([rank[None, :] < c.to(torch.int64)[:, None]
                       for c in counts], dim=1)
    key, _fill, _restore = relops._ranked(gb._Measure(cand, dev), largest)
    if float_neg:
        key = key + 0.0  # -0.0 and +0.0 rank equal, as NumPy holds them
    by_value = torch.sort(key, dim=1, descending=True, stable=True).indices
    live = torch.gather(valid, 1, by_value)
    order = torch.gather(
        by_value, 1,
        torch.sort((~live).to(torch.int8), dim=1, stable=True).indices)
    computable, dtype = gb._computable(cand)
    top = gb._restored(torch.gather(computable, 1, order[:, :k]), dtype)
    cnt = torch.clamp(sum(c.to(torch.int64) for c in counts), max=k)
    return top, cnt


def allgather_topk_merge(values, counts, devices, span, largest, float_neg):
    """Merge dense per-group top-k tables across devices: owner ``d``
    gathers the ``[span, k]`` slice of every device's ``[n_dev * span,
    k]`` table (and of its counts) and re-selects the best ``k``
    (:func:`topk_reselect`).  Returns one ``(top [span, k], count [span])``
    per device.  ``span=None`` merges the whole tables onto the first
    device instead and returns one pair.  One device's table is returned
    as it is."""
    if len(values) == 1:
        return [(values[0], counts[0])]
    k = int(values[0].shape[1])
    if span is None:
        owner = devices[0]
        return [topk_reselect([v.to(owner) for v in values],
                              [c.to(owner) for c in counts], k, largest,
                              float_neg)]
    out = []
    for d, owner in enumerate(devices):
        lo, hi = d * span, (d + 1) * span
        out.append(topk_reselect(_gather(values, owner, lo, hi),
                                 _gather(counts, owner, lo, hi), k, largest,
                                 float_neg))
    return out


def scatter_merge_grid(grids, devices, span):
    """Bucket-count addition of dense per-(group, bucket) sketch grids:
    owner ``d`` adds the ``[span, width]`` slices of every device's grid.
    Returns one grid per device; ``span=None`` adds the whole grids onto
    the first device and returns one.  One device's grid is returned as it
    is."""
    if len(grids) == 1:
        return [grids[0]]
    if span is None:
        return [_reduce("sum", [g.to(devices[0]) for g in grids])]
    return [_reduce("sum", _gather(grids, owner, d * span, (d + 1) * span))
            for d, owner in enumerate(devices)]


class MergeStats:
    """Process-wide merge byte accounting (thread-safe): D2H bytes fetched
    per merge mode, queries per mode, and the per-device partial bytes the
    device-resident merge kept out of the fetch.  The worker exports these
    as the ``bqueryd_tpu_merge_*`` gauges."""

    #: lock discipline: the attributes each lock guards
    _bqtpu_guarded_ = {"_lock": ("_bytes_fetched", "_bytes_saved", "_queries")}

    def __init__(self):
        self._lock = threading.Lock()
        self._bytes_fetched = {MODE_DEVICE: 0, MODE_HOST: 0}
        self._bytes_saved = 0
        self._queries = {MODE_DEVICE: 0, MODE_HOST: 0}

    def record(self, mode, fetched, saved=0):
        """One merged query: ``fetched`` D2H bytes under ``mode``; ``saved``
        is the host-gather fetch minus the actual one (device-resident
        modes only).  The psum mode counts as ``device``: the merge is
        device-resident, only the fetch is replicated."""
        key = MODE_HOST if mode == MODE_HOST else MODE_DEVICE
        with self._lock:
            self._bytes_fetched[key] += int(fetched)
            self._bytes_saved += max(int(saved), 0)
            self._queries[key] += 1

    def fetched(self, mode):
        with self._lock:
            return self._bytes_fetched.get(mode, 0)

    def saved(self):
        with self._lock:
            return self._bytes_saved

    def count(self, mode):
        with self._lock:
            return self._queries.get(mode, 0)

    def snapshot(self):
        with self._lock:
            return {
                "bytes_fetched": dict(self._bytes_fetched),
                "d2h_bytes_saved": self._bytes_saved,
                "queries": dict(self._queries),
            }

    def reset(self):
        """Zero the counters for a bracketed measurement."""
        with self._lock:
            self._bytes_fetched = {MODE_DEVICE: 0, MODE_HOST: 0}
            self._bytes_saved = 0
            self._queries = {MODE_DEVICE: 0, MODE_HOST: 0}


_stats = MergeStats()


def stats():
    """The process-global :class:`MergeStats`."""
    return _stats
