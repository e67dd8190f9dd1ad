"""Query executor: one query over many shards, one kernel call per device,
merged on the devices.

The port of ``bqueryd_tpu/parallel/executor.py``'s ``MeshQueryExecutor``
over a list of torch devices (``devices=``, which may repeat a device, as
the reference's tests repeat the CPU; or ``n_devices=``).  Where the
per-shard engine runs one partial-table call per shard and merges the
payloads on the host by key value, the executor

* aligns every shard's group keys into ONE global code space on the host
  (:meth:`MeshQueryExecutor._global_key_space`: dictionary-sized NumPy
  work, plus a per-shard composite factorize for several keys, persisted
  next to the shard as a sidecar both packages read);
* lays every shard's rows out as one ``[n_dev, width]`` block
  (:meth:`MeshQueryExecutor._pack`, ``width`` on the
  ``program_bucket(fine=True)`` grid, padded with code -1), whose row
  ``d`` lives on device ``d`` (:class:`_Rows`);
* keeps the codes (with the row filter folded in) and the measure columns
  resident on the device in a working set (:mod:`..ops.workingset`), so a
  repeat query -- also one with another measure or filter -- skips decode,
  factorize, alignment and uploads;
* runs ONE ``partial_tables`` call per device over its row, so the merge
  across shards happens inside the kernel, then merges across devices as
  ``parallel.devicemerge.resolve_mode`` says: ``device`` (each device
  owns a key span of the table, receives that span of every device's
  table and reduces it; the spans alone are fetched, in parallel, and
  concatenated in device order), ``host`` (the ``BQUERYD_TPU_DEVICE_MERGE=0``
  kill switch: every device's table is fetched and merged by
  ``hostmerge.merge_payloads``) or ``psum`` (a ``torch.distributed`` job:
  the local devices merge, then an all-reduce leaves the whole table on
  every process, each of which runs its own rows of the global pack).
  Each device's result leaves are packed into one byte buffer and fetched
  with one D2H copy.

Host work (decode, factorize, NumPy packing) runs on the pipeline pool
(:mod:`.pipeline`); device work (uploads, kernels, the fetch) stays on the
calling thread.  A CUDA error propagates to the caller: there is no retry
and no fallback here.  ``ops.CompositeOverflow`` (a key space past int64)
is raised for the worker to serve through the per-shard engine.

Basket expansion (``expand_filter_column``) widens each shard's row filter
to whole baskets before the fold, so the folded codes in the working set
already carry it.  The executor runs as well over the ``ChunkView``s that
chunk pruning hands it: every working-set entry is keyed by the view's own
``table_cache_key``, and a view has no sidecars.

Extended operator DAGs (joins, top-k, quantile sketches, windows) take the
same machinery through :meth:`MeshQueryExecutor.execute_dag`, the fast
path: each shard's derivations (join probe, window buckets, post-filter,
key codes) cached under the DAG's derivation signature, one key alignment
over the shard group, the folded codes and every measure resident in the
working set, and one device program (:func:`_dag_partials`) emitting the
classic partials through ``partial_tables``, a dense per-group top-k table
per top-k agg and a dense bucket grid per quantile agg, per device, merged
across devices (the classic partials and the grids span-owned, the top-k
tables by gathering and re-selecting) and fetched.  Shapes it cannot serve
raise :class:`DagFastPathUnsupported`, and the worker runs those per
shard; so does the kill switch.

A compatible bundle of queries (the same shards and group keys, any
measures and filters) takes :meth:`MeshQueryExecutor.execute_bundle`:
one alignment, one unmasked codes upload, one upload per distinct measure,
the members' masks stacked on each device, one member-per-launch
``bundle_partial_tables`` call per device, every member merged in one
pass and one fetch per device for every member.

Each entry point (``execute``, ``execute_bundle``, ``execute_dag``) first
fires the ``worker.device`` fault site (:mod:`bqueryd_tpu_torch.chaos`),
before any upload, working-set insert or launch.

With a :class:`~bqueryd_tpu_torch.utils.tracing.PhaseTimer` set as
``timer``, each entry point times its phases (``align``, ``mask``,
``layout``, ``aggregate``, ``fetch``, ``collect``; ``prune`` for a DAG),
which become the calc reply's spans (``layout`` as ``h2d_transfer``,
``aggregate`` as ``kernel``, ``fetch`` as ``d2h_fetch``, ``collect`` as
``merge``).  The launches are asynchronous: the host-timed ``aggregate``
ends before its kernels do, and their device time lands in the ``fetch``
that waits for them, which runs nested in ``aggregate`` and is debited
from it.  On CUDA devices a CUDA event pair per card recorded around the
launches on its current stream, read after that fetch (which has
synchronized already), tags the ``kernel`` span with ``device_s``, the
longest card's: no synchronization is added.  While the observability hot
path is on, each ``h2d_transfer`` and ``filter`` span carries the
``bytes`` its uploads copied (``ops.groupby.as_tensor``; 0 when the
working set held every block) and each ``d2h_fetch`` span the ``bytes``
it fetched; :attr:`MeshQueryExecutor.h2d_bytes` and
:attr:`~MeshQueryExecutor.d2h_bytes` sum them.  Under
``BQUERYD_TPU_PROFILE=1`` each phase is also a ``torch.profiler`` range and
an NVTX range (``utils.tracing.trace_span``).
"""

import contextlib
import os
import threading
import time

import numpy as np

from bqueryd_tpu_torch import obs
from bqueryd_tpu_torch.models.query import GroupByQuery, ResultPayload
from bqueryd_tpu_torch.storage.ctable import table_cache_key as _table_key


def _fire_device_site(n_tables, signature):
    """The ``worker.device`` fault site of the executor's entry points
    (``raise``: a transient ``DeviceBusyError`` that the worker flags
    ``transient`` and the controller fails over; ``delay``).  ``signature``
    is called only while a plan is armed, so that the disarmed path pays
    one None check."""
    from bqueryd_tpu_torch import chaos

    if chaos.enabled():
        chaos.fire("worker.device", n_tables=n_tables,
                   signature=signature()[:120])


def _wire_dtype(tables, col):
    """Narrowest signed int dtype covering every shard's stored [min, max]
    of ``col``, or None to ship the stored dtype unchanged.  Sums still
    accumulate exactly in int64 on the device; min/max partials go back to
    the stored dtype on the host."""
    lo = hi = None
    stored = None
    for t in tables:
        if t.kind(col) != "numeric":
            return None
        dt = t.physical_dtype(col)
        if dt.kind not in "iu":
            return None
        stored = dt if stored is None else max(
            stored, dt, key=lambda d: d.itemsize
        )
        stats = t.col_stats(col)
        if stats is None:
            return None
        lo = stats[0] if lo is None else min(lo, stats[0])
        hi = stats[1] if hi is None else max(hi, stats[1])
    for cand in (np.int8, np.int16, np.int32):
        info = np.iinfo(cand)
        if lo >= info.min and hi <= info.max:
            cand = np.dtype(cand)
            return cand if cand.itemsize < stored.itemsize else None
    return None


def _stored_dtype(tables, col):
    """Widest stored numeric dtype of ``col`` across shards, or None when
    any shard stores it non-numerically (dict/datetime)."""
    dts = []
    for t in tables:
        if t.kind(col) != "numeric":
            return None
        dts.append(t.physical_dtype(col))
    return np.result_type(*dts)


def _measure_kind(tables, col):
    """'datetime' when every shard stores ``col`` as a datetime, 'uint64'
    when the widened dtype is unsigned 64-bit, 'uint' for narrower unsigned
    storage, None otherwise; mixed datetime/non-datetime storage across
    shards is a data error."""
    kinds = {t.kind(col) for t in tables}
    if kinds == {"datetime"}:
        return "datetime"
    if "datetime" in kinds:
        raise ValueError(
            f"column {col!r} is datetime on some shards but not others"
        )
    dtypes = [t.physical_dtype(col) for t in tables]
    if dtypes:
        widened = np.result_type(*dtypes)
        if widened == np.dtype(np.uint64):
            return "uint64"
        if widened.kind == "u":
            return "uint"
    return None


def _where_signature(query):
    """Hashable, canonical identity of a query's row filter."""
    from bqueryd_tpu_torch.models.query import freeze_value

    return (
        freeze_value(query.where_terms or []),
        query.expand_filter_column,
    )


def _codes_dtype(n_groups):
    """Narrowest signed dtype holding dense codes in [-1, n_groups)."""
    if n_groups <= np.iinfo(np.int8).max:
        return np.dtype(np.int8)
    if n_groups <= np.iinfo(np.int16).max:
        return np.dtype(np.int16)
    return np.dtype(np.int32)


def _upload(arr, device):
    """One host -> device copy of a packed block."""
    from bqueryd_tpu_torch.ops.groupby import as_tensor

    return as_tensor(arr, device)


class _Rows:
    """A ``[n_dev, width]`` block whose row ``d`` lives on device ``d``:
    ``block[d]`` is that device's ``[width]`` tensor.  Shaped and sized
    like the tensor it stands for, so that the working set accounts it by
    its bytes."""

    def __init__(self, rows):
        self.rows = tuple(rows)

    def __getitem__(self, d):
        return self.rows[d]

    def __iter__(self):
        return iter(self.rows)

    @property
    def shape(self):
        return (len(self.rows),) + tuple(self.rows[0].shape)

    @property
    def dtype(self):
        return self.rows[0].dtype

    def numel(self):
        return sum(int(r.numel()) for r in self.rows)

    def element_size(self):
        return self.rows[0].element_size()


#: the open aggregate phase of this thread: (timer, device clocks, the
#: executor), which :func:`_fetch_many` ends, times and counts
_fetch_ctx = threading.local()


class _DeviceClock:
    """A CUDA event pair on ``device``'s current stream: :meth:`start` and
    :meth:`stop` record, :meth:`seconds` reads once both completed."""

    def __init__(self, device):
        import torch

        self._stream = torch.cuda.current_stream(device)
        self._start = torch.cuda.Event(enable_timing=True)
        self._stop = torch.cuda.Event(enable_timing=True)
        self._stopped = False

    def start(self):
        self._start.record(self._stream)

    def stop(self):
        if not self._stopped:
            self._stop.record(self._stream)
            self._stopped = True

    def done(self):
        """Whether both events completed (no wait)."""
        return self._stopped and self._stop.query()

    def seconds(self):
        return self._start.elapsed_time(self._stop) / 1e3


def _copy_out(flats):
    """Host copies of packed buffers: one blocking copy for a sole buffer;
    several CUDA buffers are copied in parallel (non-blocking copies into
    pinned host memory, each device's current stream, then waited on)."""
    import torch

    if len(flats) == 1 or not any(f.device.type == "cuda" for f in flats):
        return [f.cpu().numpy() for f in flats]
    outs, events = [], []
    for f in flats:
        if f.device.type != "cuda":
            outs.append(f.cpu())
            continue
        host = torch.empty(f.shape, dtype=f.dtype, pin_memory=True)
        host.copy_(f, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(f.device))
        outs.append(host)
        events.append(event)
    for event in events:
        event.synchronize()
    return [o.numpy() for o in outs]


def _fetch_many(flats):
    """The device -> host copies of a query's result: one packed buffer per
    device.  Inside an aggregate phase
    (:meth:`MeshQueryExecutor._kernel_phase`) it first ends the phase's
    device clocks, and is timed as the phase ``fetch``, debited from the
    enclosing ``aggregate``, its span tagged with the ``bytes`` fetched."""
    timer, clocks, owner = (getattr(_fetch_ctx, "value", None)
                            or (None, (), None))
    for clock in clocks:
        clock.stop()
    tags = None
    if owner is not None and obs.enabled():
        nbytes = sum(int(f.numel()) * f.element_size() for f in flats)
        owner.d2h_bytes += nbytes
        tags = {"bytes": nbytes}
    if timer is None:
        return _copy_out(flats)
    t0 = time.perf_counter()
    try:
        with timer.phase("fetch", tags):
            return _copy_out(flats)
    finally:
        timer.debit("aggregate", time.perf_counter() - t0)


def resolve_devices(device=None, n_devices=1, devices=None):
    """The executor's devices: ``devices`` as given (a list, which may
    repeat a device: ``[cuda:0] * 4`` runs four logical devices on one
    card); else ``n_devices`` of ``device``'s type: on ``cuda`` the cards
    from ``device``'s index on (``None``: every visible card, or in a
    joined multi-process job this rank's own, ``ops.rank_cards``), on the
    CPU ``n_devices`` logical CPU devices (``None``: one)."""
    import torch

    from bqueryd_tpu_torch import ops, resolve_device

    if devices is not None:
        out = tuple(resolve_device(d) for d in devices)
        if not out:
            raise ValueError("devices must name at least one device")
        return out
    base = resolve_device(device)
    if base.type == "cpu":
        return (base,) * (1 if n_devices is None else int(n_devices))
    count = torch.cuda.device_count()
    job = ops.distributed_info()
    if n_devices is None and job is not None:
        return tuple(torch.device("cuda", i) for i in ops.rank_cards(
            count, job["rank"], job["world_size"]))
    n = count - base.index if n_devices is None else int(n_devices)
    if n < 1 or base.index + n > count:
        raise ValueError(
            f"{n_devices} cards from {base} asked for, {count} visible; "
            "pass devices=[...] to repeat a card"
        )
    return tuple(torch.device("cuda", base.index + i) for i in range(n))


class MeshQueryExecutor:
    """Executes a :class:`GroupByQuery` over a list of shard tables on a
    list of devices (``cuda`` unless ``device="cpu"`` is passed; see
    :func:`resolve_devices`), merging on the devices.  Handles the
    mergeable ops (``ops.MERGEABLE_OPS``); the worker serves the rest per
    shard."""

    def __init__(self, device=None, n_devices=1, devices=None):
        from bqueryd_tpu_torch.ops.workingset import WorkingSet

        self.devices = resolve_devices(device, n_devices, devices)
        self.device = self.devices[0]
        self.n_devices = len(self.devices)
        #: whether every rank of the psum job was seen to run as many
        #: devices as this one (:meth:`_layout`)
        self._psum_checked = False
        self._align_engine = None
        #: a PhaseTimer the worker sets: execute_dag's phases go there
        self.timer = None
        #: per-shard (decoded, skipped) chunk counts of the last
        #: execute_dag, for the worker's reply
        self.last_prune_counts = []
        #: the kernel route the last execute() dispatched ("matmul",
        #: "scatter" or "sort")
        self.last_effective_strategy = None
        #: how the last entry point merged across devices: "device" (the
        #: span-owned merge, or the all-reduce of the psum mode) or "host"
        #: (the kill switch), the reply envelope's ``merge_mode``
        self.last_merge_mode = None
        #: bytes uploaded in the ``layout`` and ``mask`` phases and fetched
        #: (:func:`_fetch_many`) while the observability hot path was on
        self.h2d_bytes = 0
        self.d2h_bytes = 0
        #   align:  (tables_key, groupby_cols) -> (dense codes per shard,
        #           combos, cards, key_values), host
        #   codes:  folded + packed group codes, [n_dev, width] _Rows
        #   blocks: packed wire-dtype measure columns, [n_dev, width]
        self.workingset = WorkingSet(devices=self.devices)
        self._align_cache = self.workingset.segment("align")
        self._hbm_cache = self.workingset.segment("blocks")
        self._codes_cache = self.workingset.segment("codes")

    def clear_caches(self):
        """Drop the alignment and device working-set segments and the
        alignment engine's factorize cache."""
        self.workingset.clear()
        if self._align_engine is not None:
            self._align_engine.clear_caches()

    @staticmethod
    def _map_shards(fn, items):
        """Map ``fn`` over shards on the shared pipeline pool, in order.
        ``BQUERYD_TPU_ALIGN_THREADS`` caps this alignment fan-out (1 runs it
        sequentially); ``BQUERYD_TPU_PIPELINE_THREADS`` sizes the pool."""
        from bqueryd_tpu_torch.parallel import pipeline

        items = list(items)
        cap = os.environ.get("BQUERYD_TPU_ALIGN_THREADS")
        max_workers = int(cap) if cap is not None else len(items)
        return pipeline.map_ordered(fn, items, max_workers=max_workers)

    def _engine(self):
        """The engine whose factorize cache serves key alignment, kept
        across queries."""
        if self._align_engine is None:
            from bqueryd_tpu_torch.models.query import QueryEngine

            self._align_engine = QueryEngine(device=self.device)
        return self._align_engine

    def _phase(self, name):
        """A timed phase (when ``timer`` is set) and a profiler range; a
        ``layout`` or ``mask`` span carries the ``bytes`` its uploads
        copied."""
        from bqueryd_tpu_torch.ops.groupby import uploaded_bytes
        from bqueryd_tpu_torch.utils.tracing import trace_span

        stack = contextlib.ExitStack()
        stack.enter_context(trace_span(name, self.device))
        if self.timer is None:
            return stack
        tags = None
        if name in ("layout", "mask") and obs.enabled():
            tags = {}
            before = uploaded_bytes()
        stack.enter_context(self.timer.phase(name, tags))
        if tags is not None:
            def count():
                # before the phase's exit records the span
                tags["bytes"] = uploaded_bytes() - before
                self.h2d_bytes += tags["bytes"]

            stack.callback(count)
        return stack

    @contextlib.contextmanager
    def _kernel_phase(self):
        """The ``aggregate`` phase of an entry point: its launches and
        merge, then the fetch (:func:`_fetch_many`).  With a span recorder
        on CUDA devices, a :class:`_DeviceClock` per card from the phase's
        start to the fetch tags the ``kernel`` span with ``device_s``."""
        recorder = getattr(self.timer, "recorder", None)
        clocks = ()
        if recorder is not None and self.device.type == "cuda":
            clocks = tuple(_DeviceClock(d) for d in dict.fromkeys(
                self.devices))
        prev = getattr(_fetch_ctx, "value", None)
        _fetch_ctx.value = (self.timer, clocks, self)
        try:
            with self._phase("aggregate"):
                for clock in clocks:
                    clock.start()
                yield
        finally:
            _fetch_ctx.value = prev
        if clocks and all(clock.done() for clock in clocks):
            # the fetch inside the phase synchronized the streams; the
            # longest card's time is the kernel's
            device_s = max(clock.seconds() for clock in clocks)
            for span in reversed(recorder.spans):
                if span.get("name") == "kernel":
                    span.setdefault("tags", {})["device_s"] = round(
                        device_s, 6)
                    break

    @staticmethod
    def supports(query: GroupByQuery):
        from bqueryd_tpu_torch.models.query import MERGEABLE_OPS

        return query.aggregate and all(op in MERGEABLE_OPS for op in query.ops)

    # -- key alignment (host-side, dictionary-sized work only) --------------
    def _global_key_space(self, tables, query, engine):
        """Remap every shard's per-column key codes into one global space.

        Returns ``(per_shard_dense, combos, cards, key_values)``: dense
        global codes per shard, the sorted global composite keys, the
        global per-column cardinalities, and ``key_values[col]`` the global
        per-column key values (indexed by unpacked codes)."""
        from bqueryd_tpu_torch import ops

        n_cols = len(query.groupby_cols)
        shard_codes = [[] for _ in range(n_cols)]   # [col][shard] -> codes
        shard_values = [[] for _ in range(n_cols)]  # [col][shard] -> uniques
        # composite-sidecar stamps, captured BEFORE any key column is read:
        # a shard rewritten mid-align stores a stale-stamped sidecar that
        # future loads miss
        comp_stamps = [
            getattr(t, "composite_stamp", lambda cols: None)(
                query.groupby_cols
            )
            for t in tables
        ]
        per_table = self._map_shards(
            lambda table: [
                engine._key_codes(table, col) for col in query.groupby_cols
            ],
            tables,
        )
        for results in per_table:
            for ci, (codes, values) in enumerate(results):
                shard_codes[ci].append(np.asarray(codes))
                shard_values[ci].append(np.asarray(values))

        cards = []
        global_values = []
        pos_maps = [[] for _ in range(n_cols)]  # [col][shard] -> local->global
        for ci in range(n_cols):
            gvals = np.unique(np.concatenate(shard_values[ci]))
            # null VALUES (NaN / NaT) leave the global dictionary: their
            # rows already carry code -1, and the single-key shortcut below
            # needs every dictionary entry to be an observed group
            if gvals.dtype.kind == "f":
                gvals = gvals[~np.isnan(gvals)]
            elif gvals.dtype.kind == "M":
                gvals = gvals[~np.isnat(gvals)]
            cards.append(max(len(gvals), 1))
            global_values.append(gvals)
            for si in range(len(tables)):
                pos_maps[ci].append(
                    np.searchsorted(gvals, shard_values[ci][si])
                )

        def mapped_codes(si, ci):
            # local codes through the local->global map; nulls stay -1
            codes = shard_codes[ci][si]
            pos = pos_maps[ci][si]
            return np.where(
                codes >= 0, pos[np.clip(codes, 0, None)], np.int64(-1)
            )

        if n_cols == 1:
            # dense shortcut: every global dictionary entry is observed in
            # some row, so global codes are already dense positions
            combos = np.arange(len(global_values[0]), dtype=np.int64)
            dense = self._map_shards(
                lambda si: mapped_codes(si, 0).astype(np.int64),
                range(len(tables)),
            )
            key_values = dict(zip(query.groupby_cols, global_values))
            return dense, combos, cards, key_values

        # guard BEFORE the sidecar loader: a sidecar from a build without
        # the guard could hold wrapped packs under the same digest
        if ops.total_cardinality(cards) >= ops.MAX_COMPOSITE:
            raise ops.CompositeOverflow(
                "composite group-key space "
                f"{'x'.join(str(int(c)) for c in cards)} exceeds int64"
            )

        # several keys: observed composites per shard through the hash
        # factorizer, persisted next to the shard keyed by a digest of the
        # GLOBAL dictionaries + cardinalities (packed codes depend on the
        # whole shard set)
        import hashlib

        h = hashlib.blake2b(digest_size=16)
        h.update(np.asarray(cards, dtype=np.int64).tobytes())
        for g in global_values:
            a = np.asarray(g)
            if a.dtype == object:
                h.update(repr(a.tolist()).encode())
            else:
                h.update(a.dtype.str.encode())
                h.update(a.tobytes())
        digest = h.digest()

        def shard_composites(si):
            # a ChunkView has no sidecars: its composites stay in memory
            table = tables[si]
            if comp_stamps[si] is not None:
                hit = table.composite_cache_load(
                    query.groupby_cols, digest, stamp=comp_stamps[si]
                )
                if hit is not None:
                    return (np.asarray(hit[0]),
                            np.asarray(hit[1], dtype=np.int64))
            packed = ops.pack_codes(
                [mapped_codes(si, ci) for ci in range(n_cols)], cards
            )
            inv, uniq = ops.factorize(packed)
            inv = np.asarray(inv)
            uniq = np.asarray(uniq, dtype=np.int64)
            if comp_stamps[si] is not None:
                table.composite_cache_store(
                    query.groupby_cols, digest, inv, uniq,
                    stamp=comp_stamps[si],
                )
            return inv, uniq

        composites = self._map_shards(shard_composites, range(len(tables)))
        local_uniques = [c[1] for c in composites]
        observed = [u[u >= 0] for u in local_uniques]
        observed = [o for o in observed if len(o)]
        combos = (
            np.unique(np.concatenate(observed))
            if observed
            else np.empty(0, dtype=np.int64)
        )
        # each shard's few observed composites map into the sorted global
        # combos, then one gather per shard
        dense = []
        for inv, uniq in composites:
            lut = np.searchsorted(combos, np.clip(uniq, 0, None)).astype(
                np.int64
            )
            lut[uniq < 0] = -1
            dense.append(lut[inv])
        key_values = dict(zip(query.groupby_cols, global_values))
        return dense, combos, cards, key_values

    # -- device layout ------------------------------------------------------
    @staticmethod
    def _pack(arrays, n_devices, pad, dtype=None):
        """Concatenate shard arrays and split them evenly into
        ``[n_devices, width]``.  Every row carries a global code, so any
        row partition is valid.  ``width`` is on the ``program_bucket``
        row grid; padded rows carry ``pad`` (-1 for codes) and drop from
        every reduction.  ``dtype`` defaults to the widest input dtype."""
        from bqueryd_tpu_torch import ops

        if dtype is None:
            dtype = (
                np.result_type(*[a.dtype for a in arrays])
                if len(arrays) > 1
                else arrays[0].dtype
            )
        total = sum(len(a) for a in arrays)
        width = ops.program_bucket(
            max(-(-total // n_devices), 1), fine=True
        )
        out = np.full(n_devices * width, pad, dtype=dtype)
        off = 0
        for arr in arrays:
            out[off : off + len(arr)] = arr
            off += len(arr)
        return out.reshape(n_devices, width)

    def _layout(self, mode):
        """``(n_rows, first)``: the rows of the global ``[n_rows, width]``
        pack and the first of this process's.  In the psum mode every
        process packs every shard's rows and runs its own devices' rows,
        ``[rank * n_dev, (rank + 1) * n_dev)``; otherwise all rows are
        local.  That layout holds only when every rank runs as many
        devices: the first psum call all-gathers the counts and raises
        ``ValueError`` in every rank when they differ (the all-reduce of
        equal-shaped tables would otherwise count rows twice or drop
        them)."""
        from bqueryd_tpu_torch.parallel import devicemerge

        if mode != devicemerge.MODE_PSUM:
            return self.n_devices, 0
        import torch
        import torch.distributed as dist

        from bqueryd_tpu_torch.ops.groupby import all_gather_leaf

        if not self._psum_checked:
            counts = [int(c[0]) for c in all_gather_leaf(
                torch.tensor([self.n_devices], dtype=torch.int64))]
            if len(set(counts)) > 1:
                raise ValueError(
                    f"the psum ranks run {counts} devices (in rank "
                    "order); every rank must run as many"
                )
            self._psum_checked = True
        return (self.n_devices * dist.get_world_size(),
                self.n_devices * dist.get_rank())

    def _dev_key(self, first):
        """The devices (and the first local row of the pack) in working-set
        keys: another device list, or another rank's rows, is another
        entry."""
        key = ",".join(str(d) for d in self.devices)
        return key if not first else f"{key}@{first}"

    def _upload_rows(self, packed, first):
        """This process's rows of a packed ``[n_rows, width]`` block, row
        ``d`` uploaded to device ``d``."""
        return _Rows(_upload(packed[first + d], dev)
                     for d, dev in enumerate(self.devices))

    def _merge_fetch(self, per_dev, n_groups, mode):
        """Merge per-device partial tables across devices and fetch them.

        ``per_dev[d]`` is the list of partial-table trees (one per bundle
        member, one for a query) device ``d`` emitted over ``n_groups``.
        ``device`` mode pads each onto the key-span layout, merges it
        span-owned (``devicemerge.scatter_merge_partials``) and fetches
        each owner's span without the pad tail, so the bytes fetched are
        one table's; ``host`` mode fetches every device's tables; ``psum``
        merges the local devices onto the first, all-reduces across the
        processes and fetches that one table.  One packed buffer per
        device, fetched in parallel.  Returns the trees as NumPy leaves,
        ``[n_groups]`` each, or ``[n_dev, n_groups]`` in host mode; records
        the bytes in ``devicemerge.stats()``."""
        from bqueryd_tpu_torch import ops
        from bqueryd_tpu_torch.parallel import devicemerge

        devices, n_dev = self.devices, len(self.devices)
        like = per_dev[0]
        if mode == devicemerge.MODE_DEVICE:
            span, _padded = devicemerge.bucket_span(n_groups, n_dev)
            outputs = [[] for _ in devices]
            for m in range(len(like)):
                owned = devicemerge.scatter_merge_partials(
                    [ops.bucketize_partials(trees[m], n_groups, n_dev)[0]
                     for trees in per_dev], devices, span)
                for d, tree in enumerate(owned):
                    keep = max(0, min(span, n_groups - d * span))
                    outputs[d].append(_tree_map(lambda a, k=keep: a[:k],
                                                tree))
        elif mode == devicemerge.MODE_PSUM:
            outputs = [[
                ops.psum_partials(devicemerge.reduce_partials(
                    [trees[m] for trees in per_dev], devices[0]))
                for m in range(len(like))
            ]]
        else:
            outputs = per_dev
        host, fetched = _fetch_leaves(
            [[leaf for tree in trees for leaf in _tree_leaves(tree)]
             for trees in outputs])
        n_leaves = [len(_tree_leaves(tree)) for tree in like]
        if mode == devicemerge.MODE_HOST:
            leaves = [np.stack(per) for per in zip(*host)]
        elif mode == devicemerge.MODE_DEVICE:
            leaves = [np.concatenate(per) for per in zip(*host)]
        else:
            leaves = host[0]
        merged, off = [], 0
        for tree, n in zip(like, n_leaves):
            merged.append(_tree_unflatten(tree, leaves[off:off + n]))
            off += n
        table_bytes = sum(leaf.nbytes for leaf in leaves)
        if mode == devicemerge.MODE_HOST:
            table_bytes //= n_dev
        _record_merge_bytes(mode, fetched, self._layout(mode)[0],
                            table_bytes)
        return merged

    def _finish_collect(self, merged, mode, query, tables, combos, cards,
                        key_values, measure_kinds):
        """One query's merged partials -> its ResultPayload.  Host mode
        collects each device's table and merges the payloads by key value
        with ``hostmerge.merge_payloads``, the reference's host-gather
        merge: the same aggregates, bit for bit on ints."""
        from bqueryd_tpu_torch.parallel import devicemerge, hostmerge

        if mode == devicemerge.MODE_HOST:
            payloads = [
                self._collect_payload(
                    _tree_map(lambda a, d=d: a[d], merged), query, tables,
                    combos, cards, key_values, measure_kinds)
                for d in range(self.n_devices)
            ]
            return ResultPayload(hostmerge.merge_payloads(payloads))
        return self._collect_payload(merged, query, tables, combos, cards,
                                     key_values, measure_kinds)

    # -- execution ----------------------------------------------------------
    def execute(self, tables, query: GroupByQuery,
                strategy=None) -> ResultPayload:
        """Run ``query`` over ``tables``; one payload.  ``strategy`` is the
        kernel-route hint of ``partial_tables`` (None/"auto" keeps the
        dispatcher's own choice)."""
        from bqueryd_tpu_torch import ops
        from bqueryd_tpu_torch.ops import onehot
        from bqueryd_tpu_torch.ops.groupby import np_dtype
        from bqueryd_tpu_torch.parallel import pipeline
        from bqueryd_tpu_torch.plan import calibrate

        # the worker.device fault site, before any upload, working-set
        # insert or launch: a failed attempt launches nothing
        _fire_device_site(len(tables), lambda: str(query.signature()))
        self.last_effective_strategy = None
        self.last_merge_mode = None
        if strategy in (None, "auto", "host"):
            # "host" means nothing on the device path: auto
            strategy = None
        if not self.supports(query):
            raise ValueError(
                "MeshQueryExecutor handles mergeable aggregations only; "
                "route distinct-count / raw-rows queries per shard"
            )
        # datetime measures ride as int64 with NaT (int64 min) as their
        # null sentinel; their sums/means are rejected before any work
        measure_kinds = tuple(
            _measure_kind(tables, col) for col in query.in_cols
        )
        for col, kind, op in zip(query.in_cols, measure_kinds, query.ops):
            if kind == "datetime" and op in ("sum", "mean"):
                raise ValueError(
                    f"{op!r} is not defined for datetime column {col!r}"
                )
        engine = self._engine()

        tables = [
            t for t in tables
            if not query.where_terms
            or ops.shard_can_match(t, query.where_terms)
        ]
        if not tables:
            return ResultPayload.empty()

        from bqueryd_tpu_torch.parallel import devicemerge

        # the cross-device merge of this query: span-owned by default, the
        # host merge under the kill switch, the all-reduce in a
        # multi-process job
        mode = devicemerge.resolve_mode()
        n_dev, first = self._layout(mode)
        dev_key = self._dev_key(first)
        tables_key = tuple(_table_key(t) for t in tables)
        cols_key = tuple(query.groupby_cols)
        codes_key = (
            tables_key, "codes", cols_key, _where_signature(query), n_dev,
            dev_key,
        )

        # sum+count+mean of one column share one uploaded block:
        # measure_index maps each agg to its distinct column's slot
        unique_cols = list(dict.fromkeys(query.in_cols))
        measure_index = tuple(unique_cols.index(c) for c in query.in_cols)

        def block_key(col):
            return (tables_key, "col", col, n_dev, dev_key)

        missing_cols = [
            c for c in unique_cols if block_key(c) not in self._hbm_cache
        ]
        align_warm = (tables_key, cols_key) in self._align_cache
        codes_warm = codes_key in self._codes_cache
        # shed device cache BEFORE this query adds residency; a fully warm
        # query adds nothing and skips the memory sample
        if missing_cols or not codes_warm:
            self.workingset.evict_under_pressure()

        # storage decode of the missing measure columns on the pool, so it
        # overlaps alignment (when warm) or the codes fold and upload (when
        # alignment is cold and needs the pool itself first)
        prefetch = {}

        def prefetch_missing():
            if pipeline.pipeline_threads() <= 1:
                return
            for col in missing_cols:
                prefetch[col] = [f for t in tables for f in t.prefetch([col])]

        if align_warm:
            prefetch_missing()
        with self._phase("align"), pipeline.stage("align"):
            cached = self._align_cache.get((tables_key, cols_key))
            if cached is None:
                dense, combos, cards, key_values = self._global_key_space(
                    tables, query, engine
                )
                self._align_cache.put(
                    (tables_key, cols_key),
                    (dense, combos, cards, key_values),
                    nbytes=sum(d.nbytes for d in dense)
                    + combos.nbytes
                    + sum(v.nbytes for v in key_values.values()),
                )
            else:
                dense, combos, cards, key_values = cached
            n_groups = max(len(combos), 1)
            if not len(combos):
                # no shard holds a row (views of no chunks): one padded
                # group, which no row reaches and collect drops
                combos = np.zeros(1, dtype=np.int64)
        if not align_warm:
            prefetch_missing()

        codes_d = self._codes_cache.get(codes_key)
        if codes_d is None:
            # cold only: on a hit the folded codes ARE the filter
            codes_d = self._codes_block(tables, query, dense, n_groups,
                                        engine, n_dev, first)
            self._codes_cache.put(codes_key, codes_d)
        with self._phase("layout"):
            measures_d = self._measure_blocks(
                tables, unique_cols, block_key, prefetch, n_dev, first
            )

        sentinels = tuple(
            np.iinfo(np.int64).min if k == "datetime" else None
            for k in measure_kinds
        )
        # the kernel runs over the bucketed group count; padded groups
        # have zero rows and are sliced off below
        n_prog = ops.program_bucket(n_groups)
        width = int(codes_d.shape[1])
        per_agg = tuple(measures_d[i] for i in measure_index)
        route = ops.kernel_route(
            strategy, per_agg, tuple(query.ops), width, n_prog
        )
        self.last_effective_strategy = route
        self.last_merge_mode = (
            "host" if mode == devicemerge.MODE_HOST else "device")
        marker = onehot.build_marker()
        kernel_clock = time.perf_counter()
        with self._kernel_phase(), pipeline.stage("kernel"):
            merged = self._device_partials(
                tuple(query.ops), n_prog, codes_d, per_agg, sentinels,
                strategy, mode,
            )
        # the measured-cost calibration sample: the wall through the
        # synchronising fetch, keyed on the group's rows as the controller
        # estimated them from stats; a window that built the kernels or
        # launched a shape for the first time is skipped
        if onehot.build_marker() == marker:
            calibrate.record_sample(
                rows=sum(int(t.nrows) for t in tables), groups=n_groups,
                dtypes=[np_dtype(m.dtype) for m in per_agg],
                backend=self.device.type, strategy=route,
                wall_s=time.perf_counter() - kernel_clock,
            )
        if n_prog != n_groups:
            # the group axis is last: host mode's leaves are [n_dev, G]
            merged = _tree_map(lambda a: a[..., :n_groups], merged)
        with self._phase("collect"), pipeline.stage("merge"):
            return self._finish_collect(
                merged, mode, query, tables, combos, cards, key_values,
                measure_kinds,
            )

    def _codes_block(self, tables, query, dense, n_groups, engine, n_dev,
                     first):
        """Packed global codes on the devices (rows ``[first, first +
        self.n_devices)`` of the ``[n_dev, width]`` pack), with each
        shard's row filter folded in (filtered-out rows become -1).  Masks
        are built on the first device, expanded to whole baskets there
        under ``expand_filter_column`` (each shard's own basket codes,
        cached by ``engine``), and each device's row of them folded on
        that device."""
        import torch

        from bqueryd_tpu_torch import ops
        from bqueryd_tpu_torch.parallel import pipeline

        masks = []
        with self._phase("mask"):
            for t in tables:
                mask = ops.build_mask(t, query.where_terms, self.device)
                if query.expand_filter_column:
                    bcodes, buniques = engine._basket_codes(
                        t, query.expand_filter_column
                    )
                    mask = ops.expand_mask_by_group(
                        bcodes, mask, n_groups=len(buniques),
                        device=self.device,
                    )
                masks.append(mask)
        with self._phase("layout"):
            with pipeline.stage("align"):
                cdt = _codes_dtype(n_groups)
                packed = self._pack(
                    [d.astype(cdt) for d in dense], n_dev,
                    cdt.type(-1), dtype=cdt,
                )
            with pipeline.stage("h2d"):
                codes_d = self._upload_rows(packed, first)
            if all(m is None for m in masks):
                return codes_d
            keep = torch.zeros(packed.size, dtype=torch.bool,
                               device=self.device)
            off = 0
            for d, m in zip(dense, masks):
                keep[off:off + len(d)] = True if m is None else m
                off += len(d)
            keep = keep.view(packed.shape)
            return _Rows(
                torch.where(keep[first + d].to(row.device), row,
                            torch.full_like(row, -1))
                for d, row in enumerate(codes_d)
            )

    def _measure_blocks(self, tables, unique_cols, block_key, prefetch,
                        n_dev, first):
        """One packed block per distinct measure column, each device's row
        on its device, from the ``blocks`` segment or built: decode +
        narrow + pack on the pool (one column in flight ahead of the
        upload), upload here."""
        from bqueryd_tpu_torch.parallel import pipeline

        def build_packed(col):
            # wait for this column's prefetched decodes: they fill the
            # storage cache, and a duplicate decode would burn the cores
            for fut in prefetch.get(col, ()):
                fut.result()
            with pipeline.stage("decode"):
                wire = _wire_dtype(tables, col) or _stored_dtype(tables, col)
                cols = [np.asarray(t.column_raw(col)) for t in tables]
                if wire is not None:
                    cols = [c.astype(wire, copy=False) for c in cols]
                return self._pack(cols, n_dev, 0, dtype=wire)

        missing = [c for c in unique_cols if block_key(c) not in self._hbm_cache]
        futures = {}
        missing_iter = iter(missing)

        def submit_next():
            for c in missing_iter:
                futures[c] = pipeline.submit(build_packed, c)
                return

        if len(missing) > 1 and pipeline.pipeline_threads() > 1:
            # one build in flight ahead of the upload loop
            submit_next()
        measures_d = []
        for col in unique_cols:
            arr = self._hbm_cache.get(block_key(col))
            if arr is None:
                if col in futures:
                    packed = futures.pop(col).result()
                    submit_next()
                else:
                    packed = build_packed(col)
                with pipeline.stage("h2d"):
                    arr = self._upload_rows(packed, first)
                self._hbm_cache.put(block_key(col), arr)
            measures_d.append(arr)
        return measures_d

    def _device_partials(self, agg_ops, n_groups, codes_d, measures_d,
                         null_sentinels, strategy, mode):
        """The counterpart of the reference's ``_mesh_partials`` /
        ``_mesh_program``: ``partial_tables`` over each device's row of the
        block (one kernel call per device over its share of every shard's
        rows), then the merge across devices and the fetch of
        :meth:`_merge_fetch`.  Returns the tables as NumPy leaves."""
        from bqueryd_tpu_torch import ops

        per_dev = [
            [ops.partial_tables(
                codes_d[d],
                tuple(m[d] for m in measures_d),
                agg_ops,
                n_groups,
                null_sentinels=null_sentinels,
                strategy=strategy,
            )]
            for d in range(self.n_devices)
        ]
        return self._merge_fetch(per_dev, n_groups, mode)[0]

    def _collect_payload(self, partial_table, query, tables, combos, cards,
                         key_values, measure_kinds):
        """One merged partial table -> ResultPayload keyed by actual key
        values."""
        from bqueryd_tpu_torch import ops

        rows = partial_table["rows"]
        present = rows > 0
        combos_present = combos[present]
        if len(query.groupby_cols) == 1:
            key_codes = [combos_present]
        else:
            key_codes = ops.unpack_codes(combos_present, cards)
        keys = {}
        for col, codes_g in zip(query.groupby_cols, key_codes):
            keys[col] = key_values[col][np.asarray(codes_g, dtype=np.int64)]
        aggs = []
        for in_col, part in zip(query.in_cols, partial_table["aggs"]):
            stored = _stored_dtype(tables, in_col)
            selected = {}
            for k, v in part.items():
                v = v[present]
                # min/max computed on a narrowed wire dtype go back to the
                # column's stored dtype
                if (
                    k in ("min", "max")
                    and stored is not None
                    and v.dtype != stored
                    and stored.kind in "iu"
                ):
                    v = v.astype(stored)
                selected[k] = v
            aggs.append(selected)
        return ResultPayload.partials(
            key_cols=query.groupby_cols,
            keys=keys,
            rows=rows[present],
            aggs=aggs,
            ops=query.ops,
            out_cols=query.out_cols,
            value_kinds=list(measure_kinds),
        )


    # -- shared-scan bundles -------------------------------------------------
    def execute_bundle(self, tables, queries, strategy=None):
        """Shared-scan execution of a compatible bundle: every query scans
        the same ``tables`` with the same group-key columns, while measures
        and filters differ per member.  One key alignment (the solo
        query's ``align`` entry), one UNMASKED codes upload (the entry of
        the unfiltered solo query, which it shares and warms), one upload
        per distinct measure column of the whole bundle, each filtered
        member's mask built on the device and stacked into one ``[n_masks,
        width]`` tensor, ONE :func:`ops.bundle_partial_tables` call and ONE
        packed fetch of every member's leaves.  Returns one
        :class:`ResultPayload` per query, in input order.

        Whole shards are scanned and each member's filter applies by mask
        (the solo path also prunes shards and chunks): integer partials
        equal the member's solo answer bit for bit, floats differ by
        summation order.  Members with different group keys, a member that
        is not mergeable, a column a shard lacks, or a datetime ``sum`` or
        ``mean`` raise ``ValueError`` before any device work."""
        import torch

        from bqueryd_tpu_torch import ops
        from bqueryd_tpu_torch.models.query import freeze_value
        from bqueryd_tpu_torch.parallel import devicemerge, pipeline

        if not queries:
            return []
        _fire_device_site(len(tables), lambda: f"bundle:{len(queries)}")
        self.last_effective_strategy = None
        self.last_merge_mode = None
        if strategy in (None, "auto", "host"):
            strategy = None
        gcols = tuple(queries[0].groupby_cols)
        for query in queries:
            if tuple(query.groupby_cols) != gcols:
                raise ValueError(
                    "bundle members must share group-key columns")
            if not self.supports(query):
                raise ValueError(
                    "bundle members must be mergeable aggregations")
            for col in dict.fromkeys(
                    list(query.in_cols) + list(gcols)
                    + [t[0] for t in query.where_terms or []]):
                if any(col not in t for t in tables):
                    # a member-shape error: the worker runs the members
                    # one by one, where this one fails alone
                    raise ValueError(f"column {col!r} is not in every shard")
        # the union upload: every DISTINCT measure column of the bundle,
        # first seen first; each member's aggs map onto its slots
        union_cols = list(dict.fromkeys(c for q in queries for c in q.in_cols))
        union_kinds = tuple(_measure_kind(tables, c) for c in union_cols)
        kind_of = dict(zip(union_cols, union_kinds))
        for query in queries:
            for col, op in zip(query.in_cols, query.ops):
                if kind_of[col] == "datetime" and op in ("sum", "mean"):
                    raise ValueError(
                        f"{op!r} is not defined for datetime column {col!r}"
                    )
        engine = self._engine()
        mode = devicemerge.resolve_mode()
        n_dev, first = self._layout(mode)
        dev_key = self._dev_key(first)
        tables_key = tuple(_table_key(t) for t in tables)
        cols_key = tuple(gcols)
        # the unfiltered solo query's codes entry
        codes_key = (tables_key, "codes", cols_key, (freeze_value([]), None),
                     n_dev, dev_key)

        def block_key(col):
            return (tables_key, "col", col, n_dev, dev_key)

        missing_cols = [c for c in union_cols
                        if block_key(c) not in self._hbm_cache]
        align_warm = (tables_key, cols_key) in self._align_cache
        if missing_cols or codes_key not in self._codes_cache:
            self.workingset.evict_under_pressure()
        # every member's missing measure column decodes on the pool up
        # front, so that the shared pass never waits on a member's decode
        prefetch = {}

        def prefetch_missing():
            if pipeline.pipeline_threads() <= 1:
                return
            for col in missing_cols:
                prefetch[col] = [f for t in tables for f in t.prefetch([col])]

        if align_warm:
            prefetch_missing()
        with self._phase("align"), pipeline.stage("align"):
            cached = self._align_cache.get((tables_key, cols_key))
            if cached is None:
                dense, combos, cards, key_values = self._global_key_space(
                    tables, queries[0], engine
                )
                self._align_cache.put(
                    (tables_key, cols_key),
                    (dense, combos, cards, key_values),
                    nbytes=sum(d.nbytes for d in dense)
                    + combos.nbytes
                    + sum(v.nbytes for v in key_values.values()),
                )
            else:
                dense, combos, cards, key_values = cached
            n_groups = max(len(combos), 1)
            if not len(combos):
                # no shard holds a row: one padded group, which no row
                # reaches and collect drops
                combos = np.zeros(1, dtype=np.int64)
        if not align_warm:
            prefetch_missing()

        codes_d = self._codes_cache.get(codes_key)
        if codes_d is None:
            with self._phase("layout"):
                with pipeline.stage("align"):
                    cdt = _codes_dtype(n_groups)
                    packed = self._pack(
                        [d.astype(cdt) for d in dense], n_dev,
                        cdt.type(-1), dtype=cdt,
                    )
                with pipeline.stage("h2d"):
                    codes_d = self._upload_rows(packed, first)
                self._codes_cache.put(codes_key, codes_d)
        width = int(codes_d.shape[1])

        # one stacked mask row per member that filters, built on the first
        # device over the whole pack, each device's row of the stack moved
        # to it; a member without a filter indexes None and runs with
        # mask=None, its solo form
        mask_rows, mask_idx_of = [], {}
        with self._phase("mask"), pipeline.stage("mask"):
            for qi, query in enumerate(queries):
                if not query.where_terms:
                    continue
                row = torch.zeros(n_dev * width, dtype=torch.bool,
                                  device=self.device)
                off = 0
                for t, d in zip(tables, dense):
                    m = ops.build_mask(t, query.where_terms, self.device)
                    row[off:off + len(d)] = True if m is None else m
                    off += len(d)
                mask_idx_of[qi] = len(mask_rows)
                mask_rows.append(row.view(n_dev, width))
            masks_d = None
            if mask_rows:
                stacked = torch.stack(mask_rows)
                masks_d = [stacked[:, first + d].to(dev)
                           for d, dev in enumerate(self.devices)]

        with self._phase("layout"):
            measures_d = self._measure_blocks(tables, union_cols, block_key,
                                              prefetch, n_dev, first)
        slot_of = {col: i for i, col in enumerate(union_cols)}
        sentinels = tuple(np.iinfo(np.int64).min if k == "datetime" else None
                          for k in union_kinds)
        member_specs = tuple(
            (mask_idx_of.get(qi),
             tuple((slot_of[c], op) for c, op in zip(q.in_cols, q.ops)))
            for qi, q in enumerate(queries)
        )

        n_prog = ops.program_bucket(n_groups)
        self.last_merge_mode = (
            "host" if mode == devicemerge.MODE_HOST else "device")
        with self._kernel_phase(), pipeline.stage("kernel"):
            # the members share one shape: the first one's route speaks
            # for the bundle
            lead = queries[0]
            self.last_effective_strategy = ops.kernel_route(
                strategy, tuple(measures_d[slot_of[c]] for c in lead.in_cols),
                tuple(lead.ops), width, n_prog,
            )
            per_dev = [
                list(ops.bundle_partial_tables(
                    codes_d[d],
                    None if masks_d is None else masks_d[d],
                    tuple(m[d] for m in measures_d),
                    member_specs, n_prog,
                    null_sentinels=sentinels, strategy=strategy,
                ))
                for d in range(self.n_devices)
            ]
            # every member merged in one pass, its leaves in one packed
            # fetch per device
            merged_members = self._merge_fetch(per_dev, n_prog, mode)
        if n_prog != n_groups:
            merged_members = [_tree_map(lambda a: a[..., :n_groups], m)
                              for m in merged_members]
        with self._phase("collect"), pipeline.stage("merge"):
            return [
                self._finish_collect(
                    merged, mode, query, tables, combos, cards, key_values,
                    tuple(kind_of[c] for c in query.in_cols),
                )
                for query, merged in zip(queries, merged_members)
            ]

    # -- operator-DAG fast path ----------------------------------------------
    def execute_dag(self, tables, dag):
        """Run an extended operator DAG (joins, top-k, quantile sketches,
        windows) over the whole shard group: one decode, alignment and
        upload pass, one device program emitting every aggregation's
        partial state, one fetch.  Returns ONE :class:`ResultPayload`
        (``last_merge_mode`` "device").

        Raises :class:`DagFastPathUnsupported` for what it cannot serve
        (raw rows, an op without a device-mergeable partial such as
        ``count_distinct``, object-dtype join measures, a sketch grid past
        :func:`sketch_grid_cells_limit`), and ``ops.CompositeOverflow``
        for a key space past int64; the worker serves those per shard.
        Query-shape errors raise as on the per-shard route, with the same
        class and text.  Against that route, ints, top-k value multisets
        and sketch buckets are bit-identical; float sums and means differ
        by summation order."""
        from bqueryd_tpu_torch import ops
        from bqueryd_tpu_torch.models.query import MERGEABLE_OPS
        from bqueryd_tpu_torch.ops import groupby as gb
        from bqueryd_tpu_torch.parallel import devicemerge, opexec, pipeline
        from bqueryd_tpu_torch.plan.dag import DagValidationError, parse_op

        _fire_device_site(len(tables),
                          lambda: f"dag:{str(dag.signature())[:100]}")
        self.last_effective_strategy = None
        self.last_merge_mode = None
        self.last_prune_counts = []
        mode = devicemerge.resolve_mode()
        if mode == devicemerge.MODE_HOST:
            raise DagFastPathUnsupported(
                "BQUERYD_TPU_DEVICE_MERGE=0: the merge stays on the host")
        if not dag.aggregate_rows:
            raise DagFastPathUnsupported("raw-rows DAGs dispatch per shard")
        parsed = [parse_op(a[1]) for a in dag.aggs]
        classic_idx, topk_idx, sketch_idx = [], [], []
        for i, p in enumerate(parsed):
            if p[0] in MERGEABLE_OPS:
                classic_idx.append(i)
            elif p[0] == "topk":
                topk_idx.append(i)
            elif p[0] == "quantile":
                sketch_idx.append(i)
            else:
                raise DagFastPathUnsupported(
                    f"op {dag.aggs[i][1]!r} has no device-mergeable partial"
                )

        with self._phase("prune"):
            if dag.scan.pushdown:
                tables = [
                    t for t in tables
                    if ops.shard_can_match(t, dag.scan.pushdown)
                ]
                pruned = []
                for t in tables:
                    view, decoded, skipped = ops.chunk_pruned_table(
                        t, dag.scan.pushdown
                    )
                    pruned.append(view)
                    if decoded or skipped:
                        self.last_prune_counts.append((decoded, skipped))
                tables = pruned
        if not tables:
            return ResultPayload.empty()

        first = tables[0]

        def col_source(col):
            if dag.window is not None and col == dag.window.alias:
                return "window"
            if dag.join is not None and col in dag.join.select:
                return "join"
            if col not in first:
                raise DagValidationError(
                    f"column {col!r} is not a fact column, a join-selected "
                    f"column, or the window alias"
                )
            return "fact"

        unique_cols = list(dict.fromkeys(a[0] for a in dag.aggs))
        kind_of, sentinel_of = {}, {}
        for col in unique_cols:
            src = col_source(col)
            if src == "window":
                kind_of[col] = "datetime"
                sentinel_of[col] = opexec.NAT_SENTINEL
            elif src == "join":
                dimv = np.asarray(dag.join.table[col])
                if dimv.dtype == object:
                    raise DagFastPathUnsupported(
                        f"object-dtype join measure {col!r}"
                    )
                # the one shared copy of the dim-measure dtype rules: the
                # two routes agree bit for bit through it
                sentinel_of[col], kind_of[col] = opexec.dim_measure_kind(
                    dimv.dtype
                )
            else:
                kind_of[col] = _measure_kind(tables, col)
                sentinel_of[col] = (
                    opexec.NAT_SENTINEL if kind_of[col] == "datetime"
                    else None
                )
        # query-shape validation, identical (class and text) to the
        # per-shard route's, so the fast path never masks an error
        for i, (in_col, _op, _out) in enumerate(dag.aggs):
            kind = parsed[i][0]
            if kind in ("sum", "mean") and kind_of[in_col] == "datetime":
                raise ValueError(
                    f"{kind!r} is not defined for datetime column {in_col!r}"
                )
            is_dict = (col_source(in_col) == "fact"
                       and first.kind(in_col) == "dict")
            if kind == "topk" and is_dict:
                raise DagValidationError(
                    f"topk measure {in_col!r} must be numeric or "
                    f"datetime, not strings"
                )
            if kind == "quantile" and (
                is_dict or sentinel_of[in_col] is not None
            ):
                raise DagValidationError(
                    f"quantile measure {in_col!r} must be numeric "
                    f"(strings/datetimes have no sketch ordering)"
                )

        engine = self._engine()
        tables_key = tuple(_table_key(t) for t in tables)
        derive_sig = dag.derive_signature()
        n_dev, row0 = self._layout(mode)
        dev_key = self._dev_key(row0)
        self.last_merge_mode = "device"
        dexec = opexec.DagExecutor(engine)

        def derive(table):
            """One shard's derivations, the per-shard route's own code,
            cached under the derivation signature: a repeat query (same
            derivations, any measures) skips them all.  Runs on the
            pipeline pool; its mask and join gather each end in a copy to
            the host."""
            dkey = (_table_key(table), "dagderive", derive_sig)
            hit = self._align_cache.get(dkey)
            if hit is not None:
                return hit
            state = opexec._ShardState(table, dag, self.device)
            mask = ops.build_mask(table, dag.scan.pushdown, self.device)
            mask = None if mask is None else mask.cpu().numpy()
            if dag.join is not None:
                mask = dexec._probe_join(state, mask)
            if dag.window is not None:
                dexec._derive_window(state)
            if dag.filter is not None and dag.filter.terms:
                for col, fop, value in dag.filter.terms:
                    m = opexec._eval_post_term(
                        dexec._post_filter_values(state, col), fop, value
                    )
                    mask = m if mask is None else (mask & m)
            per_key = [
                dexec._key_codes_for(state, c) for c in dag.group_keys
            ]
            entry = (mask, per_key, state.row_pos, state.window_ints)
            nbytes = sum(
                np.asarray(c).nbytes + np.asarray(v).nbytes
                for c, v in per_key
            )
            for extra in (mask, state.row_pos, state.window_ints):
                if extra is not None:
                    nbytes += np.asarray(extra).nbytes
            self._align_cache.put(dkey, entry, nbytes=nbytes)
            return entry

        derived_memo = []

        def get_derived():
            if not derived_memo:
                derived_memo.append(self._map_shards(derive, tables))
            return derived_memo[0]

        def block_key(col):
            # a fact measure shares the groupby executor's block
            if col_source(col) == "fact":
                return (tables_key, "col", col, n_dev, dev_key)
            return (tables_key, "dagcol", col, derive_sig, n_dev, dev_key)

        codes_key = (tables_key, "dagcodes", derive_sig, n_dev, dev_key)
        if (any(block_key(c) not in self._hbm_cache for c in unique_cols)
                or codes_key not in self._codes_cache):
            self.workingset.evict_under_pressure()

        with self._phase("align"), pipeline.stage("align"):
            akey = (tables_key, "dagalign", derive_sig)
            cached = self._align_cache.get(akey)
            if cached is None:
                dense, combo_cols, key_values = self._dag_key_space(
                    get_derived(), dag
                )
                self._align_cache.put(
                    akey, (dense, combo_cols, key_values),
                    nbytes=sum(d.nbytes for d in dense)
                    + combo_cols.nbytes
                    + sum(np.asarray(v).nbytes for v in key_values.values()),
                )
            else:
                dense, combo_cols, key_values = cached
            n_groups = max(len(combo_cols), 1)

        # the sketch grids' budget BEFORE any upload: one dense int64
        # [padded groups, width] grid per quantile agg and device; past the
        # budget the flat host merge of the per-shard route is the better
        # economics
        n_prog = ops.program_bucket(n_groups)
        _span, padded = devicemerge.bucket_span(n_prog, self.n_devices)
        sketch_geo = {}
        for i in sketch_idx:
            width, kmin = opexec.sketch_grid_layout(parsed[i][2])
            if padded * width > sketch_grid_cells_limit():
                raise DagFastPathUnsupported(
                    f"sketch grid {padded}x{width} cells exceeds "
                    f"BQUERYD_TPU_SKETCH_GRID_CELLS"
                )
            sketch_geo[i] = (width, kmin)

        codes_d = self._codes_cache.get(codes_key)
        if codes_d is None:
            with self._phase("layout"):
                with pipeline.stage("align"):
                    cdt = _codes_dtype(n_groups)
                    packed = self._pack(
                        [d.astype(cdt) for d in dense], n_dev,
                        cdt.type(-1), dtype=cdt,
                    )
                with pipeline.stage("h2d"):
                    codes_d = self._upload_rows(packed, row0)
                self._codes_cache.put(codes_key, codes_d)

        with self._phase("layout"):
            fact_cols = [c for c in unique_cols if col_source(c) == "fact"]
            blocks = dict(zip(fact_cols, self._measure_blocks(
                tables, fact_cols, block_key, {}, n_dev, row0
            )))
            for col in unique_cols:
                if col in blocks:
                    continue
                arr = self._hbm_cache.get(block_key(col))
                if arr is None:
                    with pipeline.stage("decode"):
                        vals = []
                        for _m, _pk, row_pos, window_ints in get_derived():
                            if col_source(col) == "window":
                                vals.append(np.asarray(window_ints))
                            else:
                                vals.append(opexec.gathered_dim_values(
                                    dag.join.table[col], row_pos
                                ))
                        packed = self._pack(vals, n_dev, 0)
                    with pipeline.stage("h2d"):
                        arr = self._upload_rows(packed, row0)
                    self._hbm_cache.put(block_key(col), arr)
                blocks[col] = arr
            slot_of = {col: i for i, col in enumerate(unique_cols)}
            measures_d = [blocks[col] for col in unique_cols]

        classic_spec = tuple(
            (slot_of[dag.aggs[i][0]], parsed[i][0],
             sentinel_of[dag.aggs[i][0]])
            for i in classic_idx
        )
        topk_spec = []
        for i in topk_idx:
            col = dag.aggs[i][0]
            is_float = gb.np_dtype(measures_d[slot_of[col]].dtype).kind == "f"
            sentinel = sentinel_of[col]
            topk_spec.append((
                slot_of[col], parsed[i][1], parsed[i][2], is_float,
                None if sentinel is None else int(sentinel), is_float,
            ))
        sketch_spec = []
        for i in sketch_idx:
            _gamma, lg, imin, imax = opexec.sketch_layout(parsed[i][2])
            width, kmin = sketch_geo[i]
            sketch_spec.append((slot_of[dag.aggs[i][0]], float(lg),
                                int(imin), int(imax), int(kmin), int(width)))

        with self._kernel_phase(), pipeline.stage("kernel"):
            self.last_effective_strategy = ops.kernel_route(
                None, tuple(measures_d[s] for s, _op, _st in classic_spec),
                tuple(op for _s, op, _st in classic_spec),
                int(codes_d.shape[1]), n_prog,
            )
            # over the program bucket: padded groups have no rows, so
            # ``present`` drops them below
            merged = _dag_partials(
                n_prog, codes_d, measures_d, classic_spec, topk_spec,
                sketch_spec, self.devices, mode, n_dev,
            )

        with self._phase("collect"), pipeline.stage("merge"):
            rows = merged["classic"]["rows"]
            present = rows > 0
            present_idx = np.flatnonzero(present)
            keys = {}
            for ci, col in enumerate(dag.group_keys):
                vals = np.asarray(key_values[col])
                keys[col] = vals[combo_cols[present_idx, ci]]
            aggs_out = [None] * len(dag.aggs)

            def stored_int(in_col):
                """A fact measure's stored int dtype, else None."""
                if col_source(in_col) != "fact":
                    return None
                stored = _stored_dtype(tables, in_col)
                if stored is None or stored.kind not in "iu":
                    return None
                return stored

            for pos, i in enumerate(classic_idx):
                stored = stored_int(dag.aggs[i][0])
                sel = {}
                for kname, v in merged["classic"]["aggs"][pos].items():
                    v = v[present]
                    # min/max on a narrowed wire dtype: back to the stored
                    if (kname in ("min", "max") and stored is not None
                            and v.dtype != stored):
                        v = v.astype(stored)
                    sel[kname] = v
                aggs_out[i] = sel
            for pos, i in enumerate(topk_idx):
                top, cnt = merged["topk"][pos]
                top, cnt = top[present_idx], cnt[present_idx]
                stored = stored_int(dag.aggs[i][0])
                if stored is not None and top.dtype != stored:
                    top = top.astype(stored)
                flat, offsets = opexec.dense_topk_to_flat(top, cnt)
                aggs_out[i] = {"topk_values": flat, "topk_offsets": offsets}
            for pos, i in enumerate(sketch_idx):
                skeys, scounts, soffs = opexec.sketch_grid_to_flat(
                    merged["sketch"][pos][present_idx], sketch_geo[i][1]
                )
                aggs_out[i] = {
                    "sketch_keys": skeys,
                    "sketch_counts": scounts,
                    "sketch_offsets": soffs,
                }
            value_kinds = [
                None if parsed[i][0] == "quantile"
                else kind_of[dag.aggs[i][0]]
                for i in range(len(dag.aggs))
            ]
            return ResultPayload.partials(
                key_cols=list(dag.group_keys),
                keys=keys,
                rows=rows[present],
                aggs=aggs_out,
                ops=[a[1] for a in dag.aggs],
                out_cols=[a[2] for a in dag.aggs],
                value_kinds=value_kinds,
            )

    def _dag_key_space(self, derived, dag):
        """One composite key space over the DAG's (possibly derived) group
        keys, fed by the cached per-shard derivations: the DAG twin of
        :meth:`_global_key_space`.  The pushdown, join-miss and
        post-derivation-filter mask is folded into the dense codes here
        (the derivation signature keys the entry, so another filter is
        another entry): masked rows carry code -1.  Returns ``(folded dense
        codes per shard, combo_cols [n_combos, n_cols] global dictionary
        positions, key_values)`` with combos in sorted composite order."""
        from bqueryd_tpu_torch import ops

        n_cols = len(dag.group_keys)
        n_shards = len(derived)
        masks = [d[0] for d in derived]
        shard_codes = [[np.asarray(d[1][ci][0]) for d in derived]
                       for ci in range(n_cols)]
        shard_values = [[np.asarray(d[1][ci][1]) for d in derived]
                        for ci in range(n_cols)]
        cards, global_values = [], []
        pos_maps = [[] for _ in range(n_cols)]
        for ci in range(n_cols):
            gvals = np.unique(np.concatenate(shard_values[ci]))
            # null VALUES (NaN/NaT) leave the global dictionary: their rows
            # already carry code -1, as in the groupby alignment
            if gvals.dtype.kind == "f":
                gvals = gvals[~np.isnan(gvals)]
            elif gvals.dtype.kind == "M":
                gvals = gvals[~np.isnat(gvals)]
            cards.append(max(len(gvals), 1))
            global_values.append(gvals)
            for si in range(n_shards):
                pos_maps[ci].append(
                    np.searchsorted(gvals, shard_values[ci][si])
                )

        def mapped(si, ci):
            codes = shard_codes[ci][si]
            pos = pos_maps[ci][si]
            if len(pos) == 0:
                return np.full(len(codes), np.int64(-1))
            return np.where(
                codes >= 0, pos[np.clip(codes, 0, None)], np.int64(-1)
            )

        def fold(si, dense_si):
            m = masks[si]
            if m is None:
                return dense_si
            return np.where(m, dense_si, np.int64(-1))

        key_values = dict(zip(dag.group_keys, global_values))
        if n_cols == 1:
            dense = self._map_shards(
                lambda si: fold(si, mapped(si, 0).astype(np.int64)),
                range(n_shards),
            )
            combo_cols = np.arange(
                len(global_values[0]), dtype=np.int64
            )[:, None]
            return dense, combo_cols, key_values

        if ops.total_cardinality(cards) >= ops.MAX_COMPOSITE:
            raise ops.CompositeOverflow(
                "composite group-key space "
                f"{'x'.join(str(int(c)) for c in cards)} exceeds int64"
            )

        def shard_composites(si):
            packed = np.asarray(ops.pack_codes(
                [mapped(si, ci) for ci in range(n_cols)], cards
            ))
            packed = fold(si, packed)
            inv, uniq = ops.factorize(packed)
            return np.asarray(inv), np.asarray(uniq, dtype=np.int64)

        composites = self._map_shards(shard_composites, range(n_shards))
        observed = [u[u >= 0] for _inv, u in composites]
        observed = [o for o in observed if len(o)]
        combos = (
            np.unique(np.concatenate(observed))
            if observed
            else np.empty(0, dtype=np.int64)
        )
        dense = []
        for inv, uniq in composites:
            lut = np.searchsorted(
                combos, np.clip(uniq, 0, None)
            ).astype(np.int64)
            lut[uniq < 0] = -1
            dense.append(lut[inv])
        combo_cols = (
            np.stack(ops.unpack_codes(combos, cards), axis=1)
            if len(combos)
            else np.empty((0, n_cols), dtype=np.int64)
        )
        return dense, combo_cols, key_values


class DagFastPathUnsupported(Exception):
    """The fast path cannot serve this extended-DAG dispatch (its shape,
    a dtype or the sketch-grid budget).  Not an error the client sees: the
    worker catches it and serves the DAG through the per-shard
    ``DagExecutor`` and the host merge, which serve every DAG shape."""


def sketch_grid_cells_limit():
    """Cell budget (padded groups x bucket width) of one quantile agg's
    dense grid on the fast path, past which the DAG keeps the per-shard
    route: default 2^23 cells (64 MiB of int64).  Tune with
    ``BQUERYD_TPU_SKETCH_GRID_CELLS``."""
    return int(os.environ.get("BQUERYD_TPU_SKETCH_GRID_CELLS",
                              str(1 << 23)))


def _dag_partials(n_groups, codes_d, measures_d, classic_spec, topk_spec,
                  sketch_spec, devices, mode, n_rows):
    """The fast path's device program (the reference's
    ``_mesh_dag_program``), per device over its row of the block: ONE
    ``partial_tables`` call for the classic aggs (with none, the row counts
    alone), one dense top-k emission per ``topk_spec`` entry ``(slot, k,
    largest, drop_nan, sentinel, float_neg)`` and one bucket grid per
    ``sketch_spec`` entry ``(slot, log_gamma, imin, imax, kmin, width)``.
    Then the merge across ``devices``: in ``device`` mode the classic
    partials reduce span-owned, the top-k tables (emitted over the padded
    groups) are gathered per span and re-selected, and the grids add per
    span, each owner's span fetched without the pad tail; in ``psum`` mode
    the local devices merge onto the first, then the processes all-reduce
    (the top-k tables all-gather and re-select).  Each device's leaves are
    packed into one byte buffer and fetched.  Returns ``{"classic":
    {"rows", "aggs"}, "topk": ((dense, counts), ...), "sketch": (grid,
    ...)}`` of NumPy leaves over ``n_groups`` (the program bucket).
    ``n_rows`` is the global pack's row count, for the byte accounting."""
    import torch

    from bqueryd_tpu_torch import ops
    from bqueryd_tpu_torch.ops import groupby as gb
    from bqueryd_tpu_torch.ops import relops
    from bqueryd_tpu_torch.parallel import devicemerge

    n_dev = len(devices)
    device_mode = mode == devicemerge.MODE_DEVICE
    span, padded = devicemerge.bucket_span(n_groups, n_dev)
    g_emit = padded if device_mode else n_groups
    per_dev = []
    for d in range(n_dev):
        codes = codes_d[d].to(torch.int64)
        per_slot = tuple(m[d] for m in measures_d)
        classic = ops.partial_tables(
            codes,
            tuple(per_slot[s] for s, _op, _st in classic_spec),
            tuple(op for _s, op, _st in classic_spec),
            n_groups,
            null_sentinels=tuple(st for _s, _op, st in classic_spec),
        )
        topk = tuple(
            relops.topk_dense_emit(codes, per_slot[slot], None, k, largest,
                                   g_emit, drop_nan, sentinel, float_neg)
            for slot, k, largest, drop_nan, sentinel, float_neg in topk_spec
        )
        sketch = tuple(
            relops.sketch_grid_block(codes, per_slot[slot], g_emit, lg, imin,
                                     imax, kmin, width)
            for slot, lg, imin, imax, kmin, width in sketch_spec
        )
        per_dev.append({"classic": classic, "topk": topk, "sketch": sketch})

    topk_args = [(spec[2], spec[5]) for spec in topk_spec]
    if device_mode:
        classic = devicemerge.scatter_merge_partials(
            [ops.bucketize_partials(t["classic"], n_groups, n_dev)[0]
             for t in per_dev], devices, span)
        topk = [devicemerge.allgather_topk_merge(
            [t["topk"][i][0] for t in per_dev],
            [t["topk"][i][1] for t in per_dev], devices, span, largest,
            float_neg) for i, (largest, float_neg) in enumerate(topk_args)]
        sketch = [devicemerge.scatter_merge_grid(
            [t["sketch"][i] for t in per_dev], devices, span)
            for i in range(len(sketch_spec))]
        outputs = []
        for d in range(n_dev):
            keep = max(0, min(span, n_groups - d * span))
            tree = {"classic": classic[d],
                    "topk": tuple(pairs[d] for pairs in topk),
                    "sketch": tuple(grids[d] for grids in sketch)}
            outputs.append([leaf[:keep] for leaf in _dag_leaves(tree)])
    else:  # psum: the local devices, then the processes
        classic = ops.psum_partials(devicemerge.reduce_partials(
            [t["classic"] for t in per_dev], devices[0]))
        topk = []
        for i, (largest, float_neg) in enumerate(topk_args):
            (dense, cnt), = devicemerge.allgather_topk_merge(
                [t["topk"][i][0] for t in per_dev],
                [t["topk"][i][1] for t in per_dev], devices, None, largest,
                float_neg)
            topk.append(devicemerge.topk_reselect(
                gb.all_gather_leaf(dense), gb.all_gather_leaf(cnt),
                int(dense.shape[1]), largest, float_neg))
        sketch = [gb.all_reduce_leaf(devicemerge.scatter_merge_grid(
            [t["sketch"][i] for t in per_dev], devices, None)[0], "sum")
            for i in range(len(sketch_spec))]
        tree = {"classic": classic, "topk": tuple(topk),
                "sketch": tuple(sketch)}
        outputs = [_dag_leaves(tree)]
    host, fetched = _fetch_leaves(outputs)
    leaves = ([np.concatenate(per) for per in zip(*host)] if device_mode
              else host[0])
    _record_merge_bytes(mode, fetched, n_rows,
                        sum(leaf.nbytes for leaf in leaves))
    return _dag_unflatten(per_dev[0], leaves)


def _dag_program_flops(args, _kwargs):
    """Analytic flops of one :func:`_dag_partials` call: one multiply-add
    per row and classic aggregation (the partial-table contraction)."""
    codes_d, classic_spec = args[1], args[3]
    return 2 * int(np.prod(codes_d.shape)) * (len(classic_spec) + 1)


def _instrument_dag_program():
    from bqueryd_tpu_torch.obs import profile

    return profile.instrument("executor.dag_program", _dag_partials,
                              cost=_dag_program_flops)


#: call accounting of the fast path's device program (obs.profile)
_dag_partials = _instrument_dag_program()


def _dag_leaves(tree):
    return (_tree_leaves(tree["classic"])
            + [a for pair in tree["topk"] for a in pair]
            + list(tree["sketch"]))


def _dag_unflatten(like, leaves):
    n_classic = len(_tree_leaves(like["classic"]))
    classic = _tree_unflatten(like["classic"], leaves[:n_classic])
    rest = leaves[n_classic:]
    n_topk = 2 * len(like["topk"])
    topk = tuple(zip(rest[0:n_topk:2], rest[1:n_topk:2]))
    return {"classic": classic, "topk": topk,
            "sketch": tuple(rest[n_topk:])}


# -- partial-table trees: {"rows": leaf, "aggs": ({part: leaf}, ...)} --------

def _tree_leaves(tree):
    return [tree["rows"]] + [v for part in tree["aggs"] for v in part.values()]


def _tree_unflatten(like, leaves):
    """A tree shaped as ``like`` holding ``leaves`` in
    :func:`_tree_leaves` order."""
    it = iter(leaves)
    rows = next(it)
    return {
        "rows": rows,
        "aggs": tuple({k: next(it) for k in part} for part in like["aggs"]),
    }


def _tree_map(fn, tree):
    return _tree_unflatten(tree, [fn(leaf) for leaf in _tree_leaves(tree)])


def _fetch_leaves(per_device):
    """Fetch leaf lists, ``per_device[d]`` on device ``d``: each device's
    leaves packed into one byte buffer there, the buffers fetched in
    parallel (:func:`_fetch_many`).  Returns ``(NumPy leaf lists, bytes
    fetched)``."""
    import torch

    from bqueryd_tpu_torch.ops import groupby as gb

    specs = [[(gb.np_dtype(leaf.dtype), tuple(leaf.shape)) for leaf in leaves]
             for leaves in per_device]
    flats = _fetch_many([torch.cat([_pack_leaf(leaf) for leaf in leaves])
                         for leaves in per_device])
    return ([_unpack_host(flat, spec) for flat, spec in zip(flats, specs)],
            sum(int(flat.nbytes) for flat in flats))


def _record_merge_bytes(mode, fetched, n_rows, table_bytes):
    """Account one merged fetch: ``fetched`` bytes against the host-gather
    fetch of one ``table_bytes`` table per row of the ``n_rows``-row pack
    (every device's whole table crossing to the host)."""
    from bqueryd_tpu_torch.parallel import devicemerge

    devicemerge.stats().record(mode, fetched,
                               saved=n_rows * table_bytes - fetched)


def _pack_leaf(leaf):
    """A result leaf as its native bytes (lossless, no widening)."""
    import torch

    return leaf.contiguous().view(torch.uint8).reshape(-1)


def _unpack_host(flat, spec):
    """Invert :func:`_pack_leaf` on the fetched uint8 buffer."""
    leaves = []
    off = 0
    for dtype, shape in spec:
        n = int(np.prod(shape, dtype=np.int64)) if shape else 1
        nbytes = n * dtype.itemsize
        seg = flat[off:off + nbytes]
        off += nbytes
        # copy() realigns the slice so the view is valid at any offset
        leaves.append(seg.copy().view(dtype).reshape(shape))
    return leaves
