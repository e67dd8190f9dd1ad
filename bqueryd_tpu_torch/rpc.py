"""In-process query entry of the port.

:class:`LocalRPC` takes ``rpc.groupby``'s arguments (``bqueryd_tpu/rpc.py``
``RPC.groupby``), opens the named shards under its data directory, runs the
query through :func:`bqueryd_tpu_torch.worker.execute` with the executor
and the engine it owns, as a worker does, and merges and finalizes the
result as the client does (``RPC._parse_groupby_reply``).  It stands in
for the controller/worker round-trip until the ZMQ slice ports it, and
returns plain arrays, so no pandas is needed.
"""

import os

from bqueryd_tpu_torch import worker
from bqueryd_tpu_torch.models.query import GroupByQuery, QueryEngine
from bqueryd_tpu_torch.parallel import hostmerge
from bqueryd_tpu_torch.parallel.executor import MeshQueryExecutor
from bqueryd_tpu_torch.storage.ctable import ctable


class LocalRPC:
    """Groupby over local shards on ``cuda`` (or on the CPU when
    ``device="cpu"`` is passed).  Mergeable aggregations run on the
    executor, the rest per shard on the engine."""

    def __init__(self, data_dir, device=None):
        self.data_dir = data_dir
        self.engine = QueryEngine(device=device)
        self.executor = MeshQueryExecutor(device=self.engine.device)
        #: the kernel route and merge mode of the last groupby (the
        #: reference worker's reply envelope keys)
        self.last_effective_strategy = None
        self.last_merge_mode = None
        self._tables = {}

    @property
    def device(self):
        return self.engine.device

    def _table(self, filename):
        path = os.path.join(self.data_dir, filename)
        table = self._tables.get(path)
        if table is None:
            table = self._tables[path] = ctable(path, mode="r")
        return table

    def groupby(self, filenames, groupby_cols, agg_list, where_terms=None,
                aggregate=True):
        """``(order, {column: np.ndarray})`` of the finalized result: the
        group keys then the aggregates (or the selected raw rows when
        ``aggregate=False``)."""
        if isinstance(filenames, str):
            filenames = [filenames]
        query = GroupByQuery(
            list(groupby_cols), agg_list, list(where_terms or []),
            aggregate=aggregate,
        )
        tables = [self._table(f) for f in filenames]
        report = {}
        payload = worker.execute(
            tables, query, self.engine, executor=self.executor,
            report=report,
        )
        self.last_effective_strategy = report["effective_strategy"]
        self.last_merge_mode = report["merge_mode"]
        merged = hostmerge.merge_payloads([payload])
        return hostmerge.finalize_table(merged)
