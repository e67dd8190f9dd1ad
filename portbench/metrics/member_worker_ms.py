"""``member_worker_ms``: the worker time that falls to a query, mean over
the autopsies of the window's last queries, in ms: ``worker_ms``'s nine
segments, each scan counted once.  A bundle's spans reach every member's
timeline at their true walls, so a member counts its autopsy's
``bundle.member_segments`` (those segments times its share: an equal one
of a shared scan, its own wall's of a bundle run member by member); any
other query counts its segments in full.  Layer: the worker and its
executor (``worker``, ``parallel/executor``, ``ops/workingset``)."""

SEGMENTS = ("storage_decode", "filter", "align", "h2d_transfer", "kernel",
            "d2h_fetch", "collective_merge", "reply_serialization",
            "worker_other")


def read(window):
    if not window.autopsies:
        return None
    total = 0.0
    for a in window.autopsies:
        bundle = a.get("bundle")
        segments = (bundle.get("member_segments") or {}
                    if isinstance(bundle, dict) else a["segments"])
        total += sum(float(segments.get(s, 0.0)) for s in SEGMENTS)
    return 1e3 * total / len(window.autopsies)
