"""A node of the benchmark's deployment, as a process of its own.

    python3 portbench/node.py controller --coordination URL --rundir DIR
    python3 portbench/node.py worker --coordination URL --rundir DIR \\
        --data_dir DIR --device cuda [--cards N] [--trace 1]

Runs the port's ``ControllerNode`` or ``WorkerNode`` as
``bqueryd_tpu_torch.node`` does, until SIGTERM: one worker over the
cell's ``chips`` cards (``--cards``, default 1: ``n_devices``; on the CPU
as many logical CPU devices).  The worker's side writes, under
``--rundir``:

* nothing until the harness creates ``data.ready`` (the dataset is
  written): the worker imports the port meanwhile, then starts;
* ``worker.ready`` once its background warmup has ended, with the card's
  name and the executor's devices (``["cuda:0", ...]``) (and, with
  ``--trace 1``, a first start and stop of the profiler, which
  initializes CUPTI);
* ``window.json`` when the harness closes the window (it creates
  ``window.start`` and ``window.stop``): the seconds between the two, the
  worker's ``/metrics`` series at both and, with ``--trace 1``, the
  cards' busy time and breakdown from ``torch.profiler`` (CUDA activity
  only) held over the window, read by :mod:`portbench.devtrace`.

Before it exits each node writes ``<role>.status.json``: the modules of
JAX or the JAX package found in ``sys.modules`` (compared by whole
top-level name) and, for the worker, the fullest card's peak of allocated
bytes (over several cards also each card's, in the executor's order).
"""

import argparse
import json
import os
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path[0] == os.path.dirname(os.path.abspath(__file__)):
    sys.path[0] = ROOT

#: top-level module names that no process of the benchmark may hold
FORBIDDEN = ("jax", "jaxlib", "flax", "bqueryd_tpu")

POLL_S = 0.005


def forbidden_modules():
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def _write_json(path, obj):
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


def _wait_for(path, stop):
    while not os.path.exists(path):
        if stop.is_set():
            return False
        time.sleep(POLL_S)
    return True


def _metric_series(node):
    """``{series: value}`` of the node's Prometheus text."""
    out = {}
    for line in node.metrics.render().splitlines():
        if not line or line.startswith("#"):
            continue
        series, _, value = line.rpartition(" ")
        try:
            out[series] = float(value)
        except ValueError:
            continue
    return out


def cards(node):
    """The executor's cards, each once, in its order."""
    return list(dict.fromkeys(node.executor.devices))


def memory_peaks(node):
    """``memory_peak_bytes``, the fullest card's peak of allocated bytes,
    and over several cards ``memory_peak_bytes_per_card``."""
    import torch

    peaks = [int(torch.cuda.max_memory_allocated(c)) for c in cards(node)]
    out = {"memory_peak_bytes": max(peaks)}
    if len(peaks) > 1:
        out["memory_peak_bytes_per_card"] = peaks
    return out


def watch_window(node, rundir, trace, stop):
    """The worker's side of the window (see the module docstring); a
    failure is written to ``window.json`` for the harness to raise."""
    try:
        _watch_window(node, rundir, trace, stop)
    except Exception:
        import traceback

        _write_json(os.path.join(rundir, "window.json"),
                    {"error": traceback.format_exc()})


def _watch_window(node, rundir, trace, stop):
    from portbench import devtrace

    node.warmup_done.wait()
    ready = {"t": time.time(),
             "devices": [str(d) for d in node.executor.devices]}
    if node.executor.device.type == "cuda":
        import torch

        ready["device_name"] = torch.cuda.get_device_name(node.executor.device)
    trace = trace and node.executor.device.type == "cuda"
    if trace:
        from torch.profiler import ProfilerActivity, profile

        # the profiler's first start initializes CUPTI for seconds: do it
        # in set-up, so that the window's start is quick
        mark = time.perf_counter()
        first = profile(activities=[ProfilerActivity.CUDA])
        first.start()
        first.stop()
        ready["profiler_init_s"] = time.perf_counter() - mark
    _write_json(os.path.join(rundir, "worker.ready"), ready)
    if not _wait_for(os.path.join(rundir, "window.start"), stop):
        return
    before = _metric_series(node)
    prof = None
    start_s = 0.0
    if trace:
        mark = time.perf_counter()
        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.start()
        start_s = time.perf_counter() - mark
    t0 = time.perf_counter()
    if not _wait_for(os.path.join(rundir, "window.stop"), stop):
        return
    window_s = time.perf_counter() - t0
    result = {"window_s": window_s, "profiler_start_s": start_s,
              "metrics_before": before, "metrics_after": _metric_series(node)}
    if prof is not None:
        for card in cards(node):
            torch.cuda.synchronize(card)
        prof.stop()
        path = os.path.join(rundir, "device_trace.json")
        prof.export_chrome_trace(path)
        result["device"] = devtrace.summarize(devtrace.device_events(path),
                                              window_s)
        os.remove(path)
    _write_json(os.path.join(rundir, "window.json"), result)


def main(argv=None):
    parser = argparse.ArgumentParser(prog="portbench/node.py")
    parser.add_argument("role", choices=["controller", "worker"])
    parser.add_argument("--coordination", required=True)
    parser.add_argument("--rundir", required=True)
    parser.add_argument("--data_dir")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--cards", type=int, default=1)
    parser.add_argument("--trace", type=int, default=0, choices=[0, 1])
    args = parser.parse_args(argv)
    import logging

    status = {"role": args.role}
    boot = {"spawned": float(os.environ.get("PORTBENCH_SPAWNED", "0")),
            "started": time.time()}
    if args.role == "controller":
        from bqueryd_tpu_torch.controller import ControllerNode

        node = ControllerNode(coordination_url=args.coordination,
                              loglevel=logging.WARNING)
        boot["constructed"] = time.time()
        _write_json(os.path.join(args.rundir, "controller.boot.json"), boot)
        node.go()
    else:
        from bqueryd_tpu_torch.worker import WorkerNode

        # the imports above overlap the harness's dataset write; the node
        # starts (and scans its data dir) once every shard is there
        boot["imported"] = time.time()
        ready = os.path.join(args.rundir, "data.ready")
        while not os.path.exists(ready):
            time.sleep(POLL_S)
        boot["data_ready"] = time.time()
        node = WorkerNode(data_dir=args.data_dir, device=args.device,
                          n_devices=args.cards,
                          coordination_url=args.coordination,
                          loglevel=logging.WARNING)
        boot["constructed"] = time.time()
        _write_json(os.path.join(args.rundir, "worker.boot.json"), boot)
        stop = threading.Event()
        watcher = threading.Thread(target=watch_window,
                                   args=(node, args.rundir, args.trace, stop),
                                   name="portbench-window", daemon=True)
        watcher.start()
        try:
            node.go()
        finally:
            stop.set()
            watcher.join(timeout=60)
        if node.executor.device.type == "cuda":
            status.update(memory_peaks(node))
    status["forbidden_modules"] = forbidden_modules()
    _write_json(os.path.join(args.rundir, f"{args.role}.status.json"), status)
    sys.stdout.flush()
    sys.stderr.flush()
    # daemon threads of the node (heartbeat, probes, pools) end with it
    os._exit(3 if status["forbidden_modules"] else 0)


if __name__ == "__main__":
    main()
