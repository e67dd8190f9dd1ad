"""The least time an aggregation could take on the card, counted from the
query and the data and never from the program's launches, so that it reads
the same work whatever implements it.

* the selected rows are counted once;
* each row reads its group code at the narrowest width that holds the
  group count plus a sentinel: 1, 2 or 4 bytes;
* each row reads each measure column once, at the narrowest width that
  holds its values (an integer column's range in the configuration, a
  float column's own width); a count reads none;
* each output value is written once, at 8 bytes.

The counts are low on purpose: no honest implementation moves fewer bytes,
so no share of the roofline reads over 100%.  The bytes over the card's
memory rate give the least time.
"""

import numpy as np

#: NVIDIA H100 SXM HBM3 rate, bytes/s (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12


def code_bytes(n_groups):
    """Width of a group code that holds ``n_groups`` plus a sentinel."""
    for width in (1, 2, 4):
        if n_groups + 1 <= 1 << (8 * width):
            return width
    return 8


def measure_bytes(spec):
    """The narrowest width that holds a column's values."""
    if spec["kind"] == "float":
        return np.dtype(spec["dtype"]).itemsize
    lo, hi = int(spec["low"]), int(spec["high"]) - 1
    for width in (1, 2, 4):
        bound = 1 << (8 * width - 1)
        if -bound <= lo and hi < bound:
            return width
    return 8


def query_bytes(query, columns, rows_selected, groups_out):
    """Bytes the aggregation of one query has to move at the least."""
    n_groups = 1
    for col in query["groupby"]:
        n_groups *= int(columns[col]["high"]) - int(columns[col]["low"])
    measures = {a[0] for a in query["aggs"] if a[1] != "count"}
    per_row = code_bytes(n_groups) + sum(measure_bytes(columns[m])
                                         for m in measures)
    return rows_selected * per_row + groups_out * len(query["aggs"]) * 8


def least_seconds(nbytes):
    return nbytes / HBM_BYTES_PER_S


class SelectedRows:
    """Rows a query's filter selects, from sorted copies of each filtered
    column per shard (one sort per column, then a binary search per
    query)."""

    def __init__(self, parts):
        self.parts = parts
        self._sorted = {}

    def __call__(self, query):
        shards = query["shards"]
        if not query["where"]:
            return sum(len(next(iter(self.parts[i].values()))) for i in shards)
        if len(query["where"]) != 1:
            total = 0
            for i in shards:
                keep = np.ones(len(next(iter(self.parts[i].values()))), bool)
                for col, op, value in query["where"]:
                    keep &= _mask(self.parts[i][col], op, value)
                total += int(keep.sum())
            return total
        col, op, value = query["where"][0]
        total = 0
        for i in shards:
            key = (i, col)
            if key not in self._sorted:
                self._sorted[key] = np.sort(self.parts[i][col])
            s = self._sorted[key]
            v = np.asarray(value, dtype=s.dtype)
            lo = np.searchsorted(s, v, side="left")
            hi = np.searchsorted(s, v, side="right")
            total += {">": len(s) - hi, ">=": len(s) - lo, "<": lo,
                      "<=": hi, "==": hi - lo, "!=": len(s) - (hi - lo)}[op]
        return int(total)


def _mask(values, op, value):
    return {">": np.greater, ">=": np.greater_equal, "<": np.less,
            "<=": np.less_equal, "==": np.equal,
            "!=": np.not_equal}[op](values, value)
