"""One general generator of query streams from a traffic file.

A traffic file (``traffic/<name>.json``) holds:

* ``loop``: the loop kind that drives the clients (``loops/<loop>.py``);
* ``clients``: how many clients the loop runs;
* ``shapes``: named query shapes, each ``{"shards": [i, ...] | "all",
  "groupby": [...], "aggs": [[in, op, out], ...]}``;
* ``order``: how each client walks them:

  - ``cycle``: the shapes in their order, over and over;
  - ``shuffled``: a fresh seeded permutation of the shapes after each pass
    (every shape equally often, in another order per seed), each query
    with its own ``filter`` value, never repeated within a run;

* ``filter`` (optional): ``{"column", "op", "low", "high", "step"}``:
  values ``low + k * step`` below ``high``.  A ``step`` that is a power of two
  keeps every value exact in float32, so a float32 column compares alike
  in any precision.

A query is ``{"shape", "shards", "groupby", "aggs", "where"}`` with
``shards`` as indices into the configuration's shard list.
"""

import itertools

from portbench import datagen


class Traffic:
    def __init__(self, traffic, n_shards, seed):
        self.spec = traffic
        self.clients = int(traffic["clients"])
        self.order = traffic["order"]
        self.n_shards = n_shards
        self.seed = seed
        self.shapes = list(traffic["shapes"])
        if self.order not in ("cycle", "shuffled"):
            raise ValueError(f"unknown order {self.order!r}")

    def query(self, shape, value=None):
        s = self.spec["shapes"][shape]
        shards = (list(range(self.n_shards)) if s["shards"] == "all"
                  else list(s["shards"]))
        where = []
        if value is not None:
            f = self.spec["filter"]
            where = [[f["column"], f["op"], value]]
        return {"shape": shape, "shards": shards, "groupby": list(s["groupby"]),
                "aggs": [list(a) for a in s["aggs"]], "where": where}

    def _grid(self, lane):
        """The filter values of one lane (lanes ``0..clients-1`` are the
        clients', lane ``clients`` the cold queries'): every
        ``clients + 1``-th grid value, so that no two lanes share one."""
        f = self.spec["filter"]
        n = int(round((f["high"] - f["low"]) / f["step"]))
        return [f["low"] + k * f["step"]
                for k in range(lane, n, self.clients + 1)]

    def cold(self):
        """The first query of each shape, asked one at a time before the
        window."""
        if "filter" not in self.spec:
            return [self.query(s) for s in self.shapes]
        stream = datagen.rng(self.seed, datagen.COLD)
        grid = self._grid(self.clients)
        picks = stream.choice(len(grid), len(self.shapes), replace=False)
        return [self.query(s, grid[int(k)])
                for s, k in zip(self.shapes, picks)]

    def stream(self, client):
        """The endless query stream of one client."""
        stream = datagen.rng(self.seed, datagen.TRAFFIC + client)
        if self.order == "cycle":
            value = None
            for shape in itertools.cycle(self.shapes):
                yield self.query(shape, value)
        else:
            grids = {}
            if "filter" in self.spec:
                lane = self._grid(client)
                grids = {s: iter([lane[int(i)] for i in
                                  stream.permutation(len(lane))])
                         for s in self.shapes}
            while True:
                for i in stream.permutation(len(self.shapes)):
                    shape = self.shapes[int(i)]
                    value = next(grids[shape]) if grids else None
                    yield self.query(shape, value)
