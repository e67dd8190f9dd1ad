"""The benchmark's command: one run of one cell on its ``chips`` cards.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Exits 2, printing no result, without a CUDA card (or with fewer than the
cell asks for); exits 1, printing no result, when the run fails, or when
JAX or the JAX package is loaded in a node once the window has closed or
in this process just before the result is printed.  Otherwise the last
line of standard output is the result: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device`` (the fullest card's memory
peak, the mean busy time; over several cards also each card's),
``breakdown`` (traced runs)
and ``checks`` (each number compared, with its limit), and the last lines
of standard error repeat the checks.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path[0] == os.path.dirname(os.path.abspath(__file__)):
    sys.path[0] = ROOT


#: the cards as torch sees them: the count, or 0 without CUDA
PROBE = ("import torch; print(torch.cuda.device_count() "
         "if torch.cuda.is_available() else 0)")
PROBE_TIMEOUT_S = 300.0


def _start_smi(cards):
    """``nvidia-smi``'s name and power limit of ``cards`` (the worker's,
    ``harness.smi_cards``), or None where there is no such tool."""
    if not cards:
        return None
    try:
        return subprocess.Popen(["nvidia-smi", "--query-gpu=name,power.limit",
                                 "--format=csv,noheader", "-i",
                                 ",".join(cards)],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.DEVNULL, text=True)
    except OSError:
        return None


class NoCard(RuntimeError):
    """No CUDA card, or fewer than the cell asks for."""


def parse(argv=None):
    parser = argparse.ArgumentParser(prog="portbench/run.py")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, default=0, choices=[0, 1])
    return parser.parse_args(argv)


def emit(result):
    """The result line last on stdout, the checks last on stderr."""
    checks = result.pop("checks")
    result["checks"] = checks
    print(json.dumps(result), flush=True)
    for name, c in checks.items():
        print(f"[portbench] check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)


def main(argv=None):
    args = parse(argv)
    from portbench import harness, spec

    cell = spec.Cell(args.workload)

    # the look for the cards runs in processes of its own, beside the
    # dataset's write; this process never imports torch
    probe = subprocess.Popen([sys.executable, "-c", PROBE],
                             stdout=subprocess.PIPE, text=True)
    smi = _start_smi(harness.smi_cards(cell.chips))

    def check_device():
        count = int((probe.communicate(timeout=PROBE_TIMEOUT_S)[0].split()
                     or ["0"])[-1])
        if count < cell.chips:
            raise NoCard(f"needs {cell.chips} CUDA card(s); found {count}")
        if smi is not None:
            cards = smi.communicate(timeout=PROBE_TIMEOUT_S)[0]
            harness.log(f"card: {cards.strip()}")

    try:
        result = harness.run_cell(args.workload, args.seed, args.seconds,
                                  bool(args.trace), device="cuda", t0=T0,
                                  check_device=check_device)
    except NoCard as exc:
        harness.log(str(exc))
        return 2
    except Exception:
        traceback.print_exc()
        return 1
    finally:
        for proc in (p for p in (probe, smi) if p is not None):
            if proc.poll() is None:
                proc.kill()
            proc.wait()
            proc.stdout.close()
    device = {"platform": "gpu"}
    device.update(result.pop("device"))
    result["device"] = device
    if "breakdown" in result:
        result["breakdown"] = result.pop("breakdown")
    bad = harness.forbidden_here()
    if bad:
        harness.log(f"JAX or the JAX package loaded: {bad}")
        return 1
    emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
