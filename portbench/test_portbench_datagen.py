"""The generators: data and traffic are the seed's and nothing else's."""

import json
import os

import numpy as np
import pytest

from portbench import datagen
from portbench.traffic import Traffic

HERE = os.path.dirname(os.path.abspath(__file__))


def _load(kind, name):
    with open(os.path.join(HERE, kind, f"{name}.json")) as f:
        return json.load(f)


def test_same_seed_same_data_other_seed_other_data():
    cfg = _load("configs", "taxi10m")
    a = datagen.Dataset(cfg, 2**31 + 11, rows=20_000)
    b = datagen.Dataset(cfg, 2**31 + 11, rows=20_000)
    c = datagen.Dataset(cfg, 2**31 + 12, rows=20_000)
    for pa, pb, pc in zip(a.parts, b.parts, c.parts):
        for col in pa:
            assert np.array_equal(pa[col], pb[col])
        assert not np.array_equal(pa["fare_amount"], pc["fare_amount"])


@pytest.mark.parametrize("config", ["taxi10m", "h2o1e7"])
def test_the_shards_written_in_processes_are_those_written_in_line(
        tmp_path, config):
    ds = datagen.Dataset(_load("configs", config), 2**31 + 13, rows=30_000)
    ds.write(str(tmp_path / "forked"), processes=3)
    ds.write(str(tmp_path / "line"), processes=1)
    for base, _dirs, files in os.walk(tmp_path / "line"):
        for name in files:
            path = os.path.join(base, name)
            other = path.replace(str(tmp_path / "line"),
                                 str(tmp_path / "forked"))
            with open(path, "rb") as a, open(other, "rb") as b:
                assert a.read() == b.read(), path
    assert sorted(os.listdir(tmp_path / "forked")) == sorted(ds.names)


def test_taxi_ranges_levels_and_sorted_pickups():
    cfg = _load("configs", "taxi10m")
    ds = datagen.Dataset(cfg, 5, rows=400_000)
    assert ds.names == [f"taxi_{i}.bcolzs" for i in range(10)]
    assert sum(len(p["fare_amount"]) for p in ds.parts) == 400_000
    allv = {c: np.concatenate([p[c] for p in ds.parts]) for c in ds.parts[0]}
    for col, levels in (("passenger_count", 9), ("VendorID", 2),
                        ("payment_type", 5), ("PULocationID", 265),
                        ("DOLocationID", 265)):
        spec = ds.columns[col]
        assert np.unique(allv[col]).tolist() == list(
            range(spec["low"], spec["high"])) and len(
                np.unique(allv[col])) == levels
    assert allv["fare_amount"].min() >= 250
    assert allv["fare_amount"].max() < 20000
    assert allv["trip_distance"].dtype == np.float32
    assert 0.0 <= allv["trip_distance"].min()
    assert allv["trip_distance"].max() < 30.0
    for p in ds.parts:
        ts = p["pickup_ts"].view(np.int64)
        assert np.all(np.diff(ts) >= 0)


def test_h2o_levels_dictionary_strings_and_v3():
    cfg = _load("configs", "h2o1e7")
    ds = datagen.Dataset(cfg, 9, rows=2_000_000)
    allv = {c: np.concatenate([p[c] for p in ds.parts]) for c in ds.parts[0]}
    for col, k in (("id1", 100), ("id2", 100), ("id4", 100), ("id5", 100),
                   ("v1", 5), ("v2", 15)):
        assert len(np.unique(allv[col])) == k
    # 2M rows over 100,000 levels: nearly every level present
    assert len(np.unique(allv["id3"])) > 99_000
    assert allv["id6"].min() >= 1 and allv["id6"].max() <= 100_000
    assert allv["id4"].dtype == np.int32 and allv["v1"].dtype == np.int32
    assert ds.decoded("id1", np.array([1, 100])).tolist() == ["id001",
                                                              "id100"]
    assert ds.decoded("id3", np.array([1])).tolist() == ["id0000000001"]
    v3 = allv["v3"]
    assert v3.dtype == np.float64 and 0.0 <= v3.min() and v3.max() <= 100.0
    assert np.array_equal(np.round(v3, 6), v3)


def test_dashboard_streams_never_repeat_and_mix_shapes_evenly():
    t = Traffic(_load("traffic", "dashboard-c8"), 10, 2**31 + 3)
    seen = set()
    counts = {}
    for client in range(t.clients):
        stream = t.stream(client)
        for _ in range(250):
            q = next(stream)
            key = (q["shape"], q["where"][0][2])
            assert key not in seen
            seen.add(key)
            counts[q["shape"]] = counts.get(q["shape"], 0) + 1
            value = q["where"][0][2]
            # exact in float32: compares alike in any precision
            assert float(np.float32(value)) == value and 0 <= value < 30
    for q in t.cold():
        assert (q["shape"], q["where"][0][2]) not in seen
    assert set(counts.values()) == {400}


def test_an_unknown_order_is_refused():
    spec = dict(_load("traffic", "basic-c1"), order="tiles")
    with pytest.raises(ValueError, match="unknown order"):
        Traffic(spec, 10, 1)


def test_basic_cycles_q1_to_q5():
    t = Traffic(_load("traffic", "basic-c1"), 10, 1)
    stream = t.stream(0)
    assert [next(stream)["shape"] for _ in range(10)] == [
        "q1", "q2", "q3", "q4", "q5"] * 2
    assert all(q["where"] == [] for q in t.cold())
