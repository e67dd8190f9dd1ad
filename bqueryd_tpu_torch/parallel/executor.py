"""Query executor: one query over many shards, one kernel call, merged on
the device.

The port of ``bqueryd_tpu/parallel/executor.py``'s ``MeshQueryExecutor``
for one CUDA device.  Where the per-shard engine runs one partial-table
call per shard and merges the payloads on the host by key value, the
executor

* aligns every shard's group keys into ONE global code space on the host
  (:meth:`MeshQueryExecutor._global_key_space`: dictionary-sized NumPy
  work, plus a per-shard composite factorize for several keys, persisted
  next to the shard as a sidecar both packages read);
* lays every shard's rows out as one ``[n_dev, width]`` block
  (:meth:`MeshQueryExecutor._pack`, ``width`` on the
  ``program_bucket(fine=True)`` grid, padded with code -1);
* keeps the codes (with the row filter folded in) and the measure columns
  resident on the device in a working set (:mod:`..ops.workingset`), so a
  repeat query -- also one with another measure or filter -- skips decode,
  factorize, alignment and uploads;
* runs ONE ``partial_tables`` call over all rows, so the merge across
  shards happens inside the kernel, packs every result leaf into one byte
  buffer on the device and fetches it with one D2H copy.

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

Waiting for later slices: several devices (the ``torch.distributed``
merge, its host-merge kill switch and the ``psum`` mode), shared-scan
bundles and operator-DAG programs.
"""

import numpy as np

from bqueryd_tpu_torch.models.query import GroupByQuery, ResultPayload
from bqueryd_tpu_torch.storage.ctable import table_cache_key as _table_key


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


def _fetch(flat):
    """The device -> host copy of a query's result: the one packed
    buffer."""
    return flat.cpu().numpy()


class MeshQueryExecutor:
    """Executes a :class:`GroupByQuery` over a list of shard tables on one
    device (``cuda`` unless ``device="cpu"`` is passed), merging on the
    device.  Handles the mergeable ops (``ops.MERGEABLE_OPS``); the worker
    serves the rest per shard.  ``n_devices`` other than 1 raises
    ``NotImplementedError`` until the multi-GPU slice."""

    def __init__(self, device=None, n_devices=1):
        from bqueryd_tpu_torch import resolve_device
        from bqueryd_tpu_torch.ops.workingset import WorkingSet

        if int(n_devices) != 1:
            raise NotImplementedError(
                "the executor runs on one device; the multi-GPU merge is "
                "not ported yet"
            )
        self.device = resolve_device(device)
        self.n_devices = 1
        self._align_engine = None
        #: the kernel route the last execute() dispatched ("matmul",
        #: "scatter" or "sort")
        self.last_effective_strategy = None
        #: how the last execute() merged: "device" (on one device the
        #: kernel call over every shard's rows is the merge)
        self.last_merge_mode = None
        #   align:  (tables_key, groupby_cols) -> (dense codes per shard,
        #           combos, cards, key_values), host
        #   codes:  folded + packed group codes, [n_dev, width] tensor
        #   blocks: packed wire-dtype measure columns, [n_dev, width]
        self.workingset = WorkingSet(device=self.device)
        self._align_cache = self.workingset.segment("align")
        self._hbm_cache = self.workingset.segment("blocks")
        self._codes_cache = self.workingset.segment("codes")

    def clear_caches(self):
        """Drop the alignment and device working-set segments and the
        alignment engine's factorize cache."""
        self.workingset.clear()
        if self._align_engine is not None:
            self._align_engine.clear_caches()

    def _engine(self):
        """The engine whose factorize cache serves key alignment, kept
        across queries."""
        if self._align_engine is None:
            from bqueryd_tpu_torch.models.query import QueryEngine

            self._align_engine = QueryEngine(device=self.device)
        return self._align_engine

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
        from bqueryd_tpu_torch.parallel import pipeline

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
        per_table = pipeline.map_ordered(
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
            dense = pipeline.map_ordered(
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

        composites = pipeline.map_ordered(shard_composites, range(len(tables)))
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

    # -- execution ----------------------------------------------------------
    def execute(self, tables, query: GroupByQuery,
                strategy=None) -> ResultPayload:
        """Run ``query`` over ``tables``; one payload.  ``strategy`` is the
        kernel-route hint of ``partial_tables`` (None/"auto" keeps the
        dispatcher's own choice)."""
        from bqueryd_tpu_torch import ops
        from bqueryd_tpu_torch.parallel import pipeline

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

        tables_key = tuple(_table_key(t) for t in tables)
        cols_key = tuple(query.groupby_cols)
        n_dev = self.n_devices
        dev_key = str(self.device)
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
        with pipeline.stage("align"):
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
                                        engine)
            self._codes_cache.put(codes_key, codes_d)
        measures_d = self._measure_blocks(
            tables, unique_cols, block_key, prefetch
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
        self.last_effective_strategy = ops.kernel_route(
            strategy, per_agg, tuple(query.ops), width, n_prog
        )
        with pipeline.stage("kernel"):
            merged = self._device_partials(
                tuple(query.ops), n_prog, codes_d, per_agg, sentinels,
                strategy,
            )
        if n_prog != n_groups:
            merged = _tree_map(lambda a: a[:n_groups], merged)
        self.last_merge_mode = "device"
        with pipeline.stage("merge"):
            return self._collect_payload(
                merged, query, tables, combos, cards, key_values,
                measure_kinds,
            )

    def _codes_block(self, tables, query, dense, n_groups, engine):
        """Packed global codes on the device, with each shard's row filter
        folded in (filtered-out rows become -1).  Masks are built on the
        device, expanded to whole baskets there under
        ``expand_filter_column`` (each shard's own basket codes, cached by
        ``engine``), and folded there."""
        import torch

        from bqueryd_tpu_torch import ops
        from bqueryd_tpu_torch.parallel import pipeline

        masks = []
        for t in tables:
            mask = ops.build_mask(t, query.where_terms, self.device)
            if query.expand_filter_column:
                bcodes, buniques = engine._basket_codes(
                    t, query.expand_filter_column
                )
                mask = ops.expand_mask_by_group(
                    bcodes, mask, n_groups=len(buniques), device=self.device
                )
            masks.append(mask)
        with pipeline.stage("align"):
            cdt = _codes_dtype(n_groups)
            packed = self._pack(
                [d.astype(cdt) for d in dense], self.n_devices,
                cdt.type(-1), dtype=cdt,
            )
        with pipeline.stage("h2d"):
            codes_d = _upload(packed, self.device)
        if all(m is None for m in masks):
            return codes_d
        keep = torch.zeros(packed.size, dtype=torch.bool, device=self.device)
        off = 0
        for d, m in zip(dense, masks):
            keep[off:off + len(d)] = True if m is None else m
            off += len(d)
        return torch.where(
            keep.view(packed.shape), codes_d,
            torch.full_like(codes_d, -1),
        )

    def _measure_blocks(self, tables, unique_cols, block_key, prefetch):
        """One packed device block per distinct measure column, from the
        ``blocks`` segment or built: decode + narrow + pack on the pool
        (one column in flight ahead of the upload), upload here."""
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
                return self._pack(cols, self.n_devices, 0, dtype=wire)

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
                    arr = _upload(packed, self.device)
                self._hbm_cache.put(block_key(col), arr)
            measures_d.append(arr)
        return measures_d

    def _device_partials(self, agg_ops, n_groups, codes_d, measures_d,
                         null_sentinels, strategy):
        """The single-device counterpart of the reference's
        ``_mesh_partials`` / ``_mesh_program``: ``partial_tables`` over the
        whole ``[1, width]`` block (one kernel call over every shard's
        rows), then every leaf packed into one byte buffer on the device
        and fetched with ONE D2H copy.  Returns the ``[n_groups]`` tables
        as NumPy leaves."""
        import torch

        from bqueryd_tpu_torch import ops
        from bqueryd_tpu_torch.ops import groupby as gb

        partials = ops.partial_tables(
            codes_d[0],
            tuple(m[0] for m in measures_d),
            agg_ops,
            n_groups,
            null_sentinels=null_sentinels,
            strategy=strategy,
        )
        leaves = _tree_leaves(partials)
        spec = [(gb.np_dtype(leaf.dtype), tuple(leaf.shape))
                for leaf in leaves]
        flat = _fetch(torch.cat([_pack_leaf(leaf) for leaf in leaves]))
        return _tree_unflatten(partials, _unpack_host(flat, spec))

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
