"""A configuration's dataset, made from ``--seed`` and written with the
port's ctable.

One general generator reads the ``columns`` of a configuration file; each
column names its kind:

* ``int``: uniform integers on ``[low, high)`` in ``dtype``;
* ``float``: uniform on ``[low, high)``, rounded to ``round`` places when
  given, in ``dtype``;
* ``datetime``: ``origin_ns + k * unit_ns`` with ``k`` uniform on
  ``[low, high)``, sorted within each shard when ``sorted`` is true;
* ``dict``: strings ``format.format(i)`` for ``i`` uniform on
  ``[low, high)``, written as the port's dictionary columns.

The arrays are drawn shard after shard from one stream, so the same seed
gives the same data.  ``Dataset.parts`` keeps them for the reference, with
a dictionary column as its integer ``i`` (``Dataset.values`` maps it back
to the string).
"""

import multiprocessing
import os
import time

import numpy as np

#: processes that write the shards
WRITERS = 4
#: the dataset the writing processes inherit
_WRITING = None

#: salts that keep the streams of one seed apart (a client's traffic is
#: ``TRAFFIC + client``)
DATA, SAMPLE, COLD, TRAFFIC = 0, 1, 2, 100


def rng(seed, salt):
    """A generator of ``seed`` (any whole number) for one purpose."""
    return np.random.default_rng([int(seed) % (1 << 64), salt])


class Dataset:
    """The shards of one configuration: ``names`` (shard file names),
    ``parts`` (per shard ``{column: array}``) and ``values`` (per dictionary
    column, the strings its integers stand for)."""

    def __init__(self, config, seed, rows=None):
        self.config = config
        self.rows = int(rows if rows is not None else config["rows"])
        self.shards = int(config["shards"])
        self.columns = {c["name"]: c for c in config["columns"]}
        self.values = {}
        self._lookups = {}
        for col in config["columns"]:
            if col["kind"] == "dict":
                self.values[col["name"]] = np.array(
                    [col["format"].format(i)
                     for i in range(col["low"], col["high"])], dtype=object)
        stream = rng(seed, DATA)
        per = self.rows // self.shards
        prefix = config["table_prefix"]
        self.names, self.parts = [], []
        for i in range(self.shards):
            n = per + (self.rows % self.shards if i == self.shards - 1 else 0)
            self.parts.append({c["name"]: _draw(stream, c, n)
                               for c in config["columns"]})
            self.names.append(f"{prefix}_{i}.bcolzs")

    def write(self, data_dir, processes=WRITERS):
        """Write every shard under ``data_dir`` with the port's ctable, in
        up to ``processes`` forked processes (a shard each at a time);
        returns the seconds it took.  A configuration with dictionary
        columns goes through ``ctable.append_dataframe``, which factorizes
        strings with ``pandas.factorize``; ``ctable.append`` of a mapping
        factorizes them in a Python loop, and takes the row count from the
        first column, which for a dictionary column is its ``(codes,
        uniques)`` pair."""
        global _WRITING

        t0 = time.perf_counter()
        # imported once, before the children fork (pandas, which starts a
        # thread, only in the children)
        import bqueryd_tpu_torch.storage.ctable  # noqa: F401

        jobs = [(data_dir, i) for i in range(self.shards)]
        processes = min(int(processes), self.shards)
        if processes < 2:
            for job in jobs:
                self.write_shard(*job)
            return time.perf_counter() - t0
        # the children inherit the arrays: nothing is pickled but an index
        _WRITING = self
        pool = multiprocessing.get_context("fork").Pool(processes)
        try:
            pool.starmap(_write_shard, jobs, chunksize=1)
            pool.close()
        except BaseException:
            pool.terminate()
            raise
        finally:
            pool.join()
            _WRITING = None
        return time.perf_counter() - t0

    def write_shard(self, data_dir, i):
        """Write shard ``i`` under ``data_dir``."""
        from bqueryd_tpu_torch.storage.ctable import ctable

        dicts = [c for c, s in self.columns.items() if s["kind"] == "dict"]
        part = self.parts[i]
        table = ctable(os.path.join(data_dir, self.names[i]), mode="w")
        if dicts:
            import pandas as pd

            table.append(pd.DataFrame({
                col: (pd.Series(self.decoded(col, values), dtype=object)
                      if col in dicts else values)
                for col, values in part.items()}))
        else:
            table.append(dict(part))
        table.flush()

    def key_ints(self, column, array):
        """The stored integers of a key column's logical values (a
        dictionary column's strings back to their ``i``; a string the
        column does not hold maps to a value no group has)."""
        spec = self.columns[column]
        if spec["kind"] != "dict":
            return np.asarray(array).astype(np.int64)
        if column not in self._lookups:
            self._lookups[column] = {s: i + spec["low"] for i, s
                                     in enumerate(self.values[column])}
        lookup = self._lookups[column]
        return np.fromiter((lookup.get(s, -(1 << 40)) for s in array),
                           dtype=np.int64, count=len(array))

    def decoded(self, column, values):
        """Logical values of a column's stored integers (strings for a
        dictionary column)."""
        spec = self.columns[column]
        if spec["kind"] == "dict":
            return self.values[column][np.asarray(values) - spec["low"]]
        return values


def _draw(stream, col, n):
    kind = col["kind"]
    if kind in ("int", "dict"):
        dtype = col.get("dtype", "int64") if kind == "int" else "int64"
        return stream.integers(col["low"], col["high"], n).astype(dtype)
    if kind == "float":
        values = stream.random(n) * (col["high"] - col["low"]) + col["low"]
        if "round" in col:
            values = np.round(values, col["round"])
        return values.astype(col["dtype"])
    if kind == "datetime":
        ticks = stream.integers(col["low"], col["high"], n)
        if col.get("sorted"):
            ticks = np.sort(ticks)
        return (np.int64(col["origin_ns"])
                + ticks.astype(np.int64) * np.int64(col["unit_ns"])
                ).view("datetime64[ns]")
    raise ValueError(f"unknown column kind {kind!r} ({col['name']})")


def _write_shard(data_dir, i):
    _WRITING.write_shard(data_dir, i)
