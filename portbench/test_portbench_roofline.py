"""The roofline's byte counts at the cells' shapes, worked by hand."""

import json
import os

import numpy as np
import pytest

from portbench import datagen, roofline
from portbench.traffic import Traffic

HERE = os.path.dirname(os.path.abspath(__file__))


def _load(kind, name):
    with open(os.path.join(HERE, kind, f"{name}.json")) as f:
        return json.load(f)


TAXI = {c["name"]: c for c in _load("configs", "taxi10m")["columns"]}
H2O = {c["name"]: c for c in _load("configs", "h2o1e7")["columns"]}

# (shape, bytes a selected row reads, groups, aggregations), by hand:
# code width from groups + 1 (<= 256: 1 B, <= 65,536: 2 B, else 4 B);
# fare 250..19,999 in 2 B, trip_distance float32 4 B, v1 1..5 and v2
# 1..15 in 1 B, v3 float64 8 B; a count reads no measure
TAXI_SHAPES = [("single", 1 + 2, 9, 1), ("sharded", 1 + 2, 9, 1),
               ("multikey", 1 + 2 + 4, 10, 3), ("zones", 2 + 2, 265, 2),
               ("highcard", 4 + 2, 70_225, 1)]
H2O_SHAPES = [("q1", 1 + 1, 100, 1), ("q2", 2 + 1, 10_000, 1),
              ("q3", 4 + 1 + 8, 100_000, 2), ("q4", 1 + 1 + 1 + 8, 100, 3),
              ("q5", 4 + 1 + 1 + 8, 100_000, 3)]


@pytest.mark.parametrize("traffic,columns,shapes", [
    ("dashboard-c8", TAXI, TAXI_SHAPES), ("basic-c1", H2O, H2O_SHAPES)])
def test_bytes_per_shape(traffic, columns, shapes):
    t = Traffic(_load("traffic", traffic), 10, 1)
    for shape, per_row, groups, aggs in shapes:
        q = t.query(shape)
        assert roofline.query_bytes(q, columns, 1_000_000, groups) == (
            1_000_000 * per_row + groups * aggs * 8), shape


def test_widths_and_least_time():
    assert [roofline.code_bytes(g) for g in (9, 255, 256, 65_535, 65_536,
                                             70_225)] == [1, 1, 2, 2, 4, 4]
    assert roofline.measure_bytes(TAXI["fare_amount"]) == 2
    assert roofline.measure_bytes(TAXI["trip_distance"]) == 4
    assert roofline.measure_bytes(H2O["v3"]) == 8
    assert roofline.measure_bytes({"kind": "int", "low": -129,
                                   "high": 0}) == 2
    # sharded over 10M rows: 30 MB at 3.35 TB/s
    assert roofline.least_seconds(30_000_072) == pytest.approx(8.955e-6,
                                                               rel=1e-3)


def test_selected_rows_count_the_filter():
    cfg = _load("configs", "taxi10m")
    ds = datagen.Dataset(cfg, 3, rows=100_000)
    sel = roofline.SelectedRows(ds.parts)
    t = Traffic(_load("traffic", "dashboard-c8"), 10, 3)
    for value in (0.0, 5.0, 29.9990234375):
        q = t.query("sharded", value)
        want = sum(int((p["trip_distance"] > np.float32(value)).sum())
                   for p in ds.parts)
        assert sel(q) == want
    q = t.query("single", 7.5)
    q["where"].append(["fare_amount", "<=", 1000])
    p = ds.parts[0]
    assert sel(q) == int(((p["trip_distance"] > 7.5)
                          & (p["fare_amount"] <= 1000)).sum())
    assert sel(t.query("single")) == 10_000
