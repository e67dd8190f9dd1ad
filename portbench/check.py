"""The comparison that decides ``correct``.

Each checked answer of the program, ``(order, {column: array})`` as
``RPC.groupby`` returns it, is held against the reference's
:class:`reference.Answer` of the same query.  Three numbers come out:

* ``missing_groups``: groups in one answer and not the other, or twice in
  the program's;
* ``int_mismatches``: integer values (counts, sums of integers) that are
  not equal, bit for bit;
* ``float_rel_err``: the largest relative error of a float value (sums
  and means of floats, means of integers) against the reference's float64.

Over a run, the first two add up and the third takes the largest.  Each has
its limit in the configuration file's ``limits``; a run is correct when
every number is at or under its limit.
"""

import numpy as np

from portbench import reference

NUMBERS = ("missing_groups", "int_mismatches", "float_rel_err")


class Tally:
    def __init__(self):
        self.numbers = {"missing_groups": 0, "int_mismatches": 0,
                        "float_rel_err": 0.0}
        self.checked = 0

    def add(self, numbers):
        self.checked += 1
        self.numbers["missing_groups"] += numbers["missing_groups"]
        self.numbers["int_mismatches"] += numbers["int_mismatches"]
        self.numbers["float_rel_err"] = max(self.numbers["float_rel_err"],
                                            numbers["float_rel_err"])

    def verdict(self, limits):
        """``(correct, [(name, value, limit), ...])``; no answer checked is
        not correct."""
        rows = [(n, self.numbers[n], limits[n]) for n in NUMBERS]
        ok = self.checked > 0 and all(v <= lim for _n, v, lim in rows)
        return ok, rows


def compare(answer, order, columns, query, key_ints, lows, cards):
    """The three numbers of one answer.  ``key_ints(col, array)`` gives a
    key column's integers (a dictionary column's ``i``)."""
    outs = [a[2] for a in query["aggs"]]
    if list(order) != list(query["groupby"]) + outs:
        # a wrong shape of answer matches nothing
        return {"missing_groups": len(answer.codes),
                "int_mismatches": len(answer.codes) * len(outs),
                "float_rel_err": float("inf")}
    n = len(columns[order[0]]) if order else 0
    codes = (reference.pack([key_ints(c, columns[c]) for c in query["groupby"]],
                            lows, cards) if n else np.zeros(0, np.int64))
    sort = np.argsort(codes, kind="stable")
    codes = codes[sort]
    dup = int(np.count_nonzero(codes[1:] == codes[:-1]))
    common, mine, theirs = np.intersect1d(codes, answer.codes,
                                          assume_unique=False,
                                          return_indices=True)
    missing = (len(codes) - len(common)) + (len(answer.codes) - len(common))
    int_bad, rel = 0, 0.0
    for out in outs:
        got = np.asarray(columns[out])[sort][mine]
        want = answer.values[out][theirs]
        if answer.exact[out]:
            int_bad += int(np.count_nonzero(got != want))
        else:
            got = got.astype(np.float64)
            err = np.abs(got - want) / np.maximum(np.abs(want), 1e-300)
            err = np.where(np.isfinite(got), err, np.inf)
            if len(err):
                rel = max(rel, float(err.max()))
    return {"missing_groups": missing + dup, "int_mismatches": int_bad,
            "float_rel_err": rel}
