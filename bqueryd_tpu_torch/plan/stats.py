"""Statistics-based pruning predicates of the port.

The port's copy of ``zone_can_match`` from ``bqueryd_tpu/plan/stats.py``:
the per-chunk test that chunk pruning (:mod:`..ops.predicates`) runs over
the zone maps the writer stores.  The shard statistics the reference's
workers advertise for plan-time pruning are not ported yet.
"""


def zone_can_match(lo, hi, op, value):
    """True unless NO value in a chunk's ``[lo, hi]`` zone map can satisfy
    ``(op, value)``.  Values are physical (datetimes as int64 ns); anything
    incomparable conservatively matches: garbage reads as "cannot prune",
    never raises mid-query.

    Only the provable ops prune.  ``!=``/``not in`` never do, even when
    ``lo == hi``: a float chunk's zone map skips NaNs, and NaN rows satisfy
    ``!=``."""
    try:
        if op == "==":
            return not (value < lo or value > hi)
        if op == ">":
            return hi > value
        if op == ">=":
            return hi >= value
        if op == "<":
            return lo < value
        if op == "<=":
            return lo <= value
        if op == "in":
            if isinstance(value, (list, tuple, set, frozenset)) and value:
                return any(not (v < lo or v > hi) for v in value)
            return True
    except TypeError:
        return True
    return True
