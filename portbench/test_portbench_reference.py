"""The reference and the comparison, against a brute-force groupby."""

import numpy as np
import pytest

from portbench import check, control, datagen, reference, spec

COLUMNS = {
    "k1": {"name": "k1", "kind": "int", "dtype": "int64", "low": 1, "high": 4},
    "k2": {"name": "k2", "kind": "dict", "format": "s{:02d}", "low": 0,
           "high": 5},
    "m": {"name": "m", "kind": "int", "dtype": "int32", "low": -50,
          "high": 50},
    "f": {"name": "f", "kind": "float", "dtype": "float64", "low": 0.0,
          "high": 10.0},
}
CONFIG = {"name": "tiny", "rows": 3000, "shards": 3, "table_prefix": "t",
          "columns": list(COLUMNS.values())}


def _brute(parts, query):
    groups = {}
    for i in query["shards"]:
        p = parts[i]
        for r in range(len(p["m"])):
            if not all({">": p[c][r] > v, "<=": p[c][r] <= v}[op]
                       for c, op, v in query["where"]):
                continue
            key = tuple(int(p[c][r]) for c in query["groupby"])
            g = groups.setdefault(key, {"n": 0, "m": 0, "f": 0.0})
            g["n"] += 1
            g["m"] += int(p["m"][r])
            g["f"] += float(p["f"][r])
    return groups


QUERY = {"shape": "x", "shards": [0, 2], "groupby": ["k1", "k2"],
         "aggs": [["m", "sum", "ms"], ["m", "count", "n"], ["f", "mean", "fm"],
                  ["f", "sum", "fs"], ["m", "mean", "mm"]],
         "where": [["f", ">", 2.5]]}


def test_reference_matches_brute_force():
    ds = datagen.Dataset(CONFIG, 4)
    ans = reference.answer(ds.parts, COLUMNS, QUERY)
    want = _brute(ds.parts, QUERY)
    lows, cards = reference.radix(COLUMNS, QUERY["groupby"])
    keys = reference.unpack(ans.codes, lows, cards)
    got = {tuple(int(k[i]) for k in keys): i for i in range(len(ans.codes))}
    assert set(got) == set(want)
    for key, i in got.items():
        w = want[key]
        assert ans.values["ms"][i] == w["m"] and ans.values["n"][i] == w["n"]
        assert ans.values["fs"][i] == pytest.approx(w["f"], rel=1e-12)
        assert ans.values["fm"][i] == pytest.approx(w["f"] / w["n"], rel=1e-12)
        assert ans.values["mm"][i] == pytest.approx(w["m"] / w["n"], rel=1e-12)
    assert ans.exact == {"ms": True, "n": True, "fm": False, "fs": False,
                         "mm": False}


def _as_program(ds, query):
    """The reference's answer in the program's form, rows shuffled."""
    ans = reference.answer(ds.parts, COLUMNS, query)
    lows, cards = reference.radix(COLUMNS, query["groupby"])
    keys = reference.unpack(ans.codes, lows, cards)
    perm = np.random.default_rng(0).permutation(len(ans.codes))
    cols = {c: ds.decoded(c, k)[perm] for c, k in zip(query["groupby"], keys)}
    cols.update({c: v[perm] for c, v in ans.values.items()})
    return list(query["groupby"]) + [a[2] for a in query["aggs"]], cols, ans


def _numbers(ds, order, cols, ans, query=QUERY):
    lows, cards = reference.radix(COLUMNS, query["groupby"])
    return check.compare(ans, order, cols, query, ds.key_ints, lows, cards)


def test_compare_reads_zero_on_the_reference_and_catches_each_fault():
    ds = datagen.Dataset(CONFIG, 4)
    order, cols, ans = _as_program(ds, QUERY)
    assert _numbers(ds, order, cols, ans) == {
        "missing_groups": 0, "int_mismatches": 0, "float_rel_err": 0.0}
    bad = dict(cols, ms=cols["ms"].copy())
    bad["ms"][3] += 1
    assert _numbers(ds, order, bad, ans)["int_mismatches"] == 1
    bad = dict(cols, fm=cols["fm"] * (1 + 1e-6))
    assert _numbers(ds, order, bad, ans)["float_rel_err"] == pytest.approx(
        1e-6, rel=1e-3)
    dropped = {c: v[1:] for c, v in cols.items()}
    assert _numbers(ds, order, dropped, ans)["missing_groups"] == 1
    renamed = dict(cols, k2=np.array(["zz"] * len(cols["k2"]), dtype=object))
    assert _numbers(ds, order, renamed, ans)["missing_groups"] >= 2 * len(
        cols["k2"])
    assert _numbers(ds, order[::-1], cols, ans)["float_rel_err"] == np.inf


def test_tally_adds_counts_and_keeps_the_worst_error():
    t = check.Tally()
    t.add({"missing_groups": 1, "int_mismatches": 0, "float_rel_err": 1e-9})
    t.add({"missing_groups": 0, "int_mismatches": 2, "float_rel_err": 1e-7})
    ok, rows = t.verdict({"missing_groups": 0, "int_mismatches": 0,
                          "float_rel_err": 1e-5})
    assert not ok
    assert rows == [("missing_groups", 1, 0), ("int_mismatches", 2, 0),
                    ("float_rel_err", 1e-7, 1e-5)]
    assert not check.Tally().verdict({n: 1 for n in check.NUMBERS})[0]


@pytest.mark.parametrize("cell", ["taxi10m.dashboard-c8", "h2o1e7.basic-c1"])
def test_control_comes_out_not_correct(cell_root, cell):
    ok, rows = control.run_control(cell, 2**31 + 21, "cpu",
                                   root=cell_root(cell), rows=200_000)
    assert not ok
    numbers = {n: v for n, v, _lim in rows}
    assert numbers["missing_groups"] == 0


@pytest.mark.card
@pytest.mark.parametrize("cell", ["taxi10m.dashboard-c8", "h2o1e7.basic-c1"])
def test_control_at_the_cells_size_on_the_card(card, cell_root, cell):
    ok, _rows = control.run_control(cell, 2**31 + 22, card,
                                    root=cell_root(cell))
    assert not ok


def test_reference_imports_nothing_of_the_program():
    import ast

    with open(reference.__file__) as f:
        tree = ast.parse(f.read())
    names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names}
    names |= {n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module}
    assert names == {"numpy"}
    assert spec.ROOT
