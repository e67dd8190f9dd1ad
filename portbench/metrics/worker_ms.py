"""``worker_ms``: the worker's share of a query's wall, mean over the
autopsies of the window's last queries, in ms: the segments
``storage_decode``, ``filter``, ``align``, ``h2d_transfer``, ``kernel``,
``d2h_fetch``, ``collective_merge``, ``reply_serialization`` and
``worker_other``.  Layer: the worker and its executor (``worker``,
``parallel/executor``, ``ops/workingset``)."""

SEGMENTS = ("storage_decode", "filter", "align", "h2d_transfer", "kernel",
            "d2h_fetch", "collective_merge", "reply_serialization",
            "worker_other")


def read(window):
    if not window.autopsies:
        return None
    total = sum(float(a["segments"].get(s, 0.0))
                for a in window.autopsies for s in SEGMENTS)
    return 1e3 * total / len(window.autopsies)
