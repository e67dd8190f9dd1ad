"""The control of the comparison: the reference put in the program's place
and computed one precision lower than the configuration states, which has
to come out as not correct.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 [--device cuda]

Per seed it draws the dataset and the queries a run checks (the cold
queries and the first ``SAMPLE_PER_SHAPE`` of each shape from the clients'
streams), answers them with the lower-precision reference and holds the
answers against the reference with :mod:`portbench.check`, printing each
number beside its limit and ``correct``.  The lower precision is the step
that would tempt a kernel: an int64 sum accumulated in int32, a float64
measure stored and accumulated in float32, a float32 one in bfloat16, an
integer mean in float32 (``torch.index_add_`` in that type).  The
benchmark's own runs never run it.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path[0] == os.path.dirname(os.path.abspath(__file__)):
    sys.path[0] = ROOT

import numpy as np  # noqa: E402

from portbench import check, datagen, reference, spec  # noqa: E402
from portbench.harness import SAMPLE_PER_SHAPE  # noqa: E402
from portbench.traffic import Traffic  # noqa: E402


def _lower(values):
    """The type one step below a measure's."""
    import torch

    if values.dtype.kind == "f":
        return torch.float32 if values.dtype.itemsize == 8 else torch.bfloat16
    return torch.int32


def control_answer(ds, query, device):
    """``(order, {column: array})`` as the program returns it, computed in
    the lower precision."""
    import torch

    columns = ds.columns
    data = reference.selected(ds.parts, columns, query)
    lows, cards = reference.radix(columns, query["groupby"])
    packed = reference.pack([data[c] for c in query["groupby"]], lows, cards)
    size = int(np.prod(cards))
    idx = torch.from_numpy(packed).to(device)
    count = torch.bincount(idx, minlength=size)
    present = torch.nonzero(count).flatten()
    out = {}
    for in_col, op, out_col in query["aggs"]:
        if op == "count":
            out[out_col] = count[present].cpu().numpy()
            continue
        v = data[in_col]
        if op == "mean" and v.dtype.kind in "iub":
            low = torch.float32  # a mean of integers is stated in float64
        else:
            low = _lower(v)
        vals = torch.from_numpy(np.ascontiguousarray(v)).to(device).to(low)
        acc = torch.zeros(size, dtype=low, device=device)
        acc.index_add_(0, idx, vals)
        if op == "mean":
            acc = acc / count.clamp(min=1).to(low)
        res = acc[present].cpu()
        out[out_col] = (res.to(torch.int64).numpy() if low == torch.int32
                        else res.to(torch.float64).numpy())
    keys = reference.unpack(present.cpu().numpy(), lows, cards)
    cols = {c: ds.decoded(c, k) for c, k in zip(query["groupby"], keys)}
    cols.update(out)
    return list(query["groupby"]) + [a[2] for a in query["aggs"]], cols


def checked_queries(traffic):
    """The cold queries and the first ``SAMPLE_PER_SHAPE`` of each shape
    from the clients' streams, taken client by client."""
    queries = traffic.cold()
    want = {s: SAMPLE_PER_SHAPE for s in traffic.shapes}
    streams = [traffic.stream(c) for c in range(traffic.clients)]
    while any(want.values()):
        for stream in streams:
            q = next(stream)
            if want[q["shape"]]:
                want[q["shape"]] -= 1
                queries.append(q)
    return queries


def run_control(cell_name, seed, device, root=spec.ROOT, rows=None):
    """``(correct, [(name, value, limit), ...])`` of the control on one
    seed."""
    cell = spec.Cell(cell_name, root)
    ds = datagen.Dataset(cell.config, seed, rows=rows)
    traffic = Traffic(cell.traffic, ds.shards, seed)
    tally = check.Tally()
    for query in checked_queries(traffic):
        want = reference.answer(ds.parts, ds.columns, query)
        order, cols = control_answer(ds, query, device)
        lows, cards = reference.radix(ds.columns, query["groupby"])
        tally.add(check.compare(want, order, cols, query, ds.key_ints, lows,
                                cards))
    return tally.verdict(cell.config["limits"])


def main(argv=None):
    parser = argparse.ArgumentParser(prog="portbench/control.py")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--rows", type=int, default=None)
    args = parser.parse_args(argv)
    failed_all = True
    for seed in (int(s) for s in args.seeds.split(",")):
        ok, rows = run_control(args.workload, seed, args.device,
                               rows=args.rows)
        failed_all &= not ok
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": ok,
                          "numbers": {n: v for n, v, _lim in rows},
                          "limits": {n: lim for n, _v, lim in rows}}),
              flush=True)
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main())
