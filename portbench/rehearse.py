"""A rehearsal of the whole harness on the CPU, at a small size.

    python3 portbench/rehearse.py --workload <cell> --seed <n> --seconds <s> \\
        [--rows N] [--trace 0|1]

The same run as ``run.py`` (the deployment, the set-up, the window, the
check), with the worker on ``--device=cpu`` (a cell's ``chips`` as as
many logical CPU devices, so that its merge runs in ``device`` mode over
them) and ``--rows`` rows in the configuration's shards.  Its line
carries no device block and no device metric: a CPU run measures
nothing of the card.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path[0] == os.path.dirname(os.path.abspath(__file__)):
    sys.path[0] = ROOT

#: per-layer metrics that only a card's trace can give
DEVICE_METRICS = ("agg_roofline", "device_idle")


def rehearse(workload, seed, seconds, rows, trace=False, root=None):
    from portbench import harness, spec

    result = harness.run_cell(workload, seed, seconds, trace, device="cpu",
                              root=root or spec.ROOT, rows=rows, t0=T0)
    result.pop("device", None)
    result.pop("breakdown", None)
    for name in DEVICE_METRICS:
        result["metrics"].pop(name, None)
    result["rehearsal"] = True
    return result


def main(argv=None):
    parser = argparse.ArgumentParser(prog="portbench/rehearse.py")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, default=1)
    parser.add_argument("--seconds", type=float, default=3.0)
    parser.add_argument("--rows", type=int, default=200_000)
    parser.add_argument("--trace", type=int, default=0, choices=[0, 1])
    args = parser.parse_args(argv)
    from portbench import run

    run.emit(rehearse(args.workload, args.seed, args.seconds, args.rows,
                      bool(args.trace)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
