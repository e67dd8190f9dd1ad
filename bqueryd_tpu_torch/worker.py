"""Per-query execution over a worker's shards.

The port of the engine branch of ``bqueryd_tpu/worker.py``
``WorkerNode._execute``: one shard goes straight to
:meth:`QueryEngine.execute_local`; several run per shard and merge on the
host by key value.  The ZMQ worker node around it, the mesh executor and
chunk pruning wait for later slices.
"""

from bqueryd_tpu_torch.models.query import ResultPayload
from bqueryd_tpu_torch.parallel import hostmerge


def execute(tables, query, engine, strategy=None):
    """Run ``query`` over ``tables`` with ``engine``; always returns ONE
    payload."""
    if len(tables) == 1:
        return engine.execute_local(tables[0], query, strategy=strategy)
    payloads = [
        engine.execute_local(t, query, strategy=strategy) for t in tables
    ]
    return ResultPayload(hostmerge.merge_payloads(payloads))
