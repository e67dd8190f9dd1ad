"""The plain reference: a NumPy groupby over the generated arrays.

It works from the arrays the harness handed to the writer
(``datagen.Dataset.parts``) and imports nothing of the program.  Keys are
dense codes from each key column's ``[low, high)`` range in the
configuration (a dictionary column's strings are ``format.format(i)`` for
``i`` in that range), packed in mixed radix, so that every groupby is a
``bincount``.  Sums of integers are exact in int64, sums and means of
floats are taken in float64.
"""

import numpy as np

_COMPARE = {">": np.greater, ">=": np.greater_equal, "<": np.less,
            "<=": np.less_equal, "==": np.equal, "!=": np.not_equal}

#: the largest magnitude a float64 running sum holds exactly
_EXACT_F64 = float(1 << 53)


class Answer:
    """One query's answer: ``codes`` (the packed key of each group
    present, ascending), ``values`` ({out column: array} in that order) and
    ``exact`` ({out column: True where the value is an integer to be
    matched bit for bit})."""

    def __init__(self, codes, values, exact):
        self.codes = codes
        self.values = values
        self.exact = exact


def radix(columns, groupby):
    """``(lows, cards)`` of the key columns, from the configuration's
    column specs."""
    lows = [int(columns[c]["low"]) for c in groupby]
    cards = [int(columns[c]["high"]) - int(columns[c]["low"]) for c in groupby]
    return lows, cards


def pack(keys, lows, cards):
    """Mixed-radix code of key columns given as integers (a dictionary
    column as its ``i``)."""
    packed = np.zeros(len(keys[0]), dtype=np.int64)
    for key, low, card in zip(keys, lows, cards):
        packed = packed * card + (np.asarray(key, dtype=np.int64) - low)
    return packed


def unpack(codes, lows, cards):
    """The key integers of packed codes, one array per key column."""
    keys = []
    rest = np.asarray(codes, dtype=np.int64)
    for low, card in zip(reversed(lows), reversed(cards)):
        keys.append(rest % card + low)
        rest = rest // card
    return keys[::-1]


def selected(parts, columns, query):
    """The columns a query reads, over its shards, after its filter."""
    needed = list(dict.fromkeys(
        list(query["groupby"]) + [a[0] for a in query["aggs"]]))
    shards = [parts[i] for i in query["shards"]]
    keep = [np.ones(len(next(iter(p.values()))), dtype=bool) for p in shards]
    for col, op, value in query["where"]:
        for k, p in zip(keep, shards):
            k &= _COMPARE[op](p[col], value)
    return {c: np.concatenate([p[c][k] for p, k in zip(shards, keep)])
            for c in needed}


def answer(parts, columns, query):
    """The reference answer of ``query`` over ``parts``, shard by shard."""
    lows, cards = radix(columns, query["groupby"])
    size = int(np.prod(cards))
    count = np.zeros(size, dtype=np.int64)
    totals, exact = {}, {}
    for in_col, op, out_col in query["aggs"]:
        if op not in ("count", "sum", "mean"):
            raise ValueError(f"the reference has no {op!r}")
        integral = np.dtype(columns[in_col].get("dtype", "int64")).kind in "iub"
        exact[out_col] = op == "count" or (op == "sum" and integral)
        totals[out_col] = np.zeros(size, dtype=np.int64 if exact[out_col]
                                   else np.float64)
    for i in query["shards"]:
        p = parts[i]
        keep = None
        for col, op, value in query["where"]:
            hit = _COMPARE[op](p[col], value)
            keep = hit if keep is None else keep & hit
        pick = (lambda a: a) if keep is None else (lambda a: a[keep])
        packed = pack([pick(p[c]) for c in query["groupby"]], lows, cards)
        count += np.bincount(packed, minlength=size)
        for in_col, op, out_col in query["aggs"]:
            if op == "count":
                continue
            v = pick(p[in_col])
            if exact[out_col]:
                totals[out_col] += _int_sum(packed, v, size)
            else:
                totals[out_col] += np.bincount(
                    packed, weights=v.astype(np.float64), minlength=size)
    present = np.flatnonzero(count)
    values = {}
    for _in_col, op, out_col in query["aggs"]:
        out = count if op == "count" else totals[out_col]
        if op == "mean":
            out = out / np.maximum(count, 1)
        values[out_col] = out[present]
    return Answer(present.astype(np.int64), values, exact)


def _int_sum(packed, v, size):
    """Per-group int64 sums, exact: a float64 ``bincount`` where no partial
    sum can pass 2**53, else ``np.add.at`` in int64."""
    bound = float(np.abs(v).max(initial=0)) * len(v)
    if bound < _EXACT_F64:
        return np.bincount(packed, weights=v.astype(np.float64),
                           minlength=size).astype(np.int64)
    out = np.zeros(size, dtype=np.int64)
    np.add.at(out, packed, v.astype(np.int64))
    return out
