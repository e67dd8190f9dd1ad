"""The end-to-end arithmetic over a window's queries."""

import math


def percentile(values, q):
    """The ``q``-th percentile (0..100) with linear interpolation between
    the closest ranks; a failed query counts as ``inf``."""
    xs = sorted(values)
    if not xs:
        return None
    if len(xs) == 1:
        return xs[0]
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    if math.isinf(xs[hi]):
        return xs[hi]
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def window_metrics(records, window_start, window_end, lost=0):
    """``qps``: queries completed inside the window over its length;
    ``p95_ms``: the 95th percentile of the wall of every query sent inside
    the window (each waited for, so that the stragglers at the close count
    too; a failed query, and each of ``lost`` that never answered, counts
    as missing every limit)."""
    length = window_end - window_start
    done = [r for r in records if r["ok"] and r["done"] <= window_end]
    walls = [(r["done"] - r["sent"]) * 1e3 if r["ok"] else math.inf
             for r in records] + [math.inf] * lost
    return {"qps": len(done) / length,
            "p95_ms": percentile(walls, 95)}
