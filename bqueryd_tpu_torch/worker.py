"""Per-query execution over a worker's shards.

The port of ``bqueryd_tpu/worker.py`` ``WorkerNode._execute``:

* mergeable aggregate queries go to the executor
  (:class:`~bqueryd_tpu_torch.parallel.executor.MeshQueryExecutor`): one
  key alignment, one kernel call over every shard's rows, the merge on the
  device;
* a composite key space past int64 (``ops.CompositeOverflow``) is served
  by the per-shard engine, which factorizes key tuples instead;
* a single shard that the executor does not take (raw rows, other ops)
  goes to :meth:`QueryEngine.execute_local`;
* anything else runs per shard, then merges on the host by key value:
  each shard's host work (key factorize, column decode) runs on the
  pipeline pool, its device work on the calling thread.

A device error is never caught here.  The ZMQ worker node around this,
latency-aware host routing and chunk pruning wait for later slices, so
the port never routes a query around the device.
"""

import logging

from bqueryd_tpu_torch.models.query import ResultPayload
from bqueryd_tpu_torch.parallel import hostmerge, pipeline


def execute(tables, query, engine, executor=None, strategy=None,
            report=None):
    """Run ``query`` over ``tables``; always returns ONE payload.

    ``executor`` serves the mergeable aggregations when given; ``engine``
    the rest.  ``report``, a dict when given, receives the reply envelope
    keys of the reference worker: ``effective_strategy`` (the kernel
    route) and ``merge_mode`` ("device" for the executor, "host" for the
    per-shard host merge, "none" for one shard's payload)."""
    from bqueryd_tpu_torch import ops

    if report is None:
        report = {}
    report["effective_strategy"] = report["merge_mode"] = None
    if executor is not None and executor.supports(query):
        try:
            result = executor.execute(tables, query, strategy=strategy)
        except ops.CompositeOverflow:
            logging.getLogger("bqueryd_tpu_torch").info(
                "composite key space exceeds int64; serving via the "
                "per-shard engine path"
            )
        else:
            report["effective_strategy"] = executor.last_effective_strategy
            report["merge_mode"] = executor.last_merge_mode
            return result
    if len(tables) == 1:
        result = engine.execute_local(tables[0], query, strategy=strategy)
        report["effective_strategy"] = engine.last_effective_strategy
        report["merge_mode"] = "none"
        return result
    pipeline.map_ordered(_host_stage(engine, query), tables)
    payloads = [
        engine.execute_local(t, query, strategy=strategy) for t in tables
    ]
    report["effective_strategy"] = engine.last_effective_strategy
    report["merge_mode"] = "host"
    return ResultPayload(hostmerge.merge_payloads(payloads))


def _host_stage(engine, query):
    """One shard's host work for ``query``: its key columns' factorize and
    its column decodes, left in the engine's and the storage's caches for
    :meth:`QueryEngine.execute_local` (decodes only where the table keeps
    them in the decoded-column cache).  A shard the filter's stats rule
    out is skipped, as ``execute_local`` skips it."""
    from bqueryd_tpu_torch import ops

    columns = list(dict.fromkeys(
        list(query.in_cols) + [term[0] for term in query.where_terms or []]
    ))

    def run(table):
        if query.where_terms and not ops.shard_can_match(
            table, query.where_terms
        ):
            return
        for col in query.groupby_cols:
            engine._key_codes(table, col)
        if table.auto_cache:
            for col in columns:
                table.column_raw(col)

    return run
