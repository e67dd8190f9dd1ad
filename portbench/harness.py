"""One run of one cell: the deployment, its set-up, the measured window,
the check of the answers and the result line.

The deployment is the reference's production topology: a controller
process and one calc worker process (``portbench/node.py``), one worker
over the cell's ``chips`` cards, coordinated through a ``file://`` store
in the run's directory under ``TMPDIR``.  Each node runs in a process
group of its own, which the run ends whole.  This process holds the
traffic's clients, a thread and an ``bqueryd_tpu_torch.rpc.RPC`` each
(load from one process with few threads keeps the runs steady), asks the
cold queries, reads the autopsies and holds the reference; it never
touches the card.
"""

import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

from portbench import check, datagen, reference, roofline, spec, stats
from portbench.traffic import Traffic

#: window answers of each shape kept for the check, drawn from the seed
SAMPLE_PER_SHAPE = 8
#: autopsies read after the window (the controller keeps the newest 256)
AUTOPSIES = 256
#: seconds a query in flight at the close may take before it counts as lost
STRAGGLER_S = 60.0
#: seconds the processes get to come up, and to stop
START_TIMEOUT_S = 900.0
STOP_TIMEOUT_S = 30.0
#: seconds what a node started gets to end on SIGTERM once the node has
GROUP_GRACE_S = 5.0
#: seconds between the clients' start and the window's
GO_LEAD_S = 0.05
#: routes on which the card computed nothing
OFF_DEVICE_ROUTES = ("host", "cached", "delta")


def log(msg):
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


class RunError(RuntimeError):
    """The run cannot produce a result."""


class Window:
    """What the per-layer readers read: ``records`` (every query sent in the
    window), ``window_s``, ``autopsies`` (segment dicts), ``device`` (the
    worker's trace summary, or None) and ``least_s`` (the roofline's least
    aggregation time of each query the card computed in the window)."""

    def __init__(self, records, window_s, autopsies, device, least_s):
        self.records = records
        self.window_s = window_s
        self.autopsies = autopsies
        self.device = device
        self.least_s = least_s


def _die_with_parent():
    """The child gets SIGTERM if this process dies first (Linux)."""
    try:
        import ctypes

        ctypes.CDLL("libc.so.6").prctl(1, signal.SIGTERM)  # PR_SET_PDEATHSIG
    except OSError:
        pass


def _wait(predicate, timeout, what, procs=()):
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        for name, proc in procs:
            if proc.poll() is not None:
                raise RunError(f"the {name} exited ({proc.returncode}) "
                               f"while waiting for {what}")
        value = predicate()
        if value:
            return value
        time.sleep(0.01)
    raise RunError(f"timed out after {timeout:.0f}s waiting for {what}")


def spawn(cmd, env, log_path):
    """A node's process, in a process group of its own (its id is the
    node's pid), its output to ``log_path``."""
    with open(log_path, "w") as logf:
        return subprocess.Popen(cmd, env=env, stdout=logf,
                                stderr=subprocess.STDOUT, process_group=0,
                                preexec_fn=_die_with_parent)


def group_members(pgid):
    """The pids of the live (not zombie) processes of group ``pgid``."""
    out = []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        # after the command's closing parenthesis: state, ppid, pgrp, ...
        fields = stat[stat.rindex(")") + 2:].split()
        if fields[0] != "Z" and int(fields[2]) == pgid:
            out.append(int(entry))
    return out


def _end_group(pgid):
    """SIGTERM what is left of group ``pgid``, and SIGKILL it if it is
    still there after ``GROUP_GRACE_S``."""
    for sig in (signal.SIGTERM, signal.SIGKILL):
        try:
            os.killpg(pgid, sig)
        except ProcessLookupError:
            return
        deadline = time.perf_counter() + GROUP_GRACE_S
        while group_members(pgid) and time.perf_counter() < deadline:
            time.sleep(0.01)
        if not group_members(pgid):
            return


def reap(procs):
    """SIGTERM each node (``{name: Popen}`` from :func:`spawn`), wait, kill
    what is left; then end what each node started and left in its group."""
    for proc in procs.values():
        if proc.poll() is None:
            proc.terminate()
    for name, proc in procs.items():
        try:
            proc.wait(timeout=STOP_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            log(f"the {name} did not stop in {STOP_TIMEOUT_S:.0f}s: killed")
            proc.kill()
            proc.wait()
    for name, proc in procs.items():
        left = group_members(proc.pid)
        if left:
            log(f"the {name} left {len(left)} processes: ended")
            _end_group(proc.pid)


def _tail(path, nbytes=3000):
    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            f.seek(max(0, f.tell() - nbytes))
            return f.read().decode(errors="replace")
    except OSError:
        return ""


class Deployment:
    """The nodes of one run: the controller and the worker, started first
    so that their imports overlap the dataset's write."""

    def __init__(self, cell, rundir, data_dir, device, trace):
        self.rundir = rundir
        self.url = f"file://{os.path.join(rundir, 'store')}"
        build = os.path.join(cell.root, "build")
        self.env = dict(os.environ)
        self.env.update(cell.config.get("env", {}))
        self.env.update({
            "BQUERYD_TPU_IP": "127.0.0.1",
            "BQUERYD_TPU_RUNFILE_DIR": rundir,
            "BQUERYD_TPU_DEBUG_DIR": rundir,
            # the program's build caches, at fixed paths in the checkout
            "BQUERYD_TPU_COMPILE_CACHE": os.path.join(build, "kernels"),
            "TRITON_CACHE_DIR": os.path.join(build, "triton"),
            "TORCH_EXTENSIONS_DIR": os.path.join(build, "torch_extensions"),
            "USE_FLAX": "0",
            "USE_JAX": "0",
            "PYTHONPATH": os.pathsep.join(
                [cell.root] + [p for p in [os.environ.get("PYTHONPATH")]
                               if p]),
            "PORTBENCH_SPAWNED": repr(time.time()),
        })
        py = [sys.executable]
        node = py + [os.path.join(cell.bench_dir, "node.py")]
        common = ["--coordination", self.url, "--rundir", rundir]
        cmds = {
            "controller": node + ["controller"] + common,
            "worker": node + ["worker"] + common
            + ["--data_dir", data_dir, "--device", device,
               "--cards", str(cell.chips), "--trace", str(int(trace))],
        }
        self.logs = {r: os.path.join(rundir, f"{r}.log") for r in cmds}
        self.procs = {role: spawn(cmd, self.env, self.logs[role])
                      for role, cmd in cmds.items()}

    def watched(self, roles=None):
        return [(r, p) for r, p in self.procs.items()
                if roles is None or r in roles]

    def node_env(self):
        return {k: self.env[k] for k in sorted(self.env)
                if k.startswith(("BQUERYD_", "USE_"))}

    def stop(self):
        """Ends both nodes and their groups (:func:`reap`); returns their
        status files."""
        reap(self.procs)
        status = {}
        for name in self.procs:
            path = os.path.join(self.rundir, f"{name}.status.json")
            if os.path.exists(path):
                with open(path) as f:
                    status[name] = json.load(f)
        return status

    def tails(self):
        return {name: _tail(path) for name, path in self.logs.items()}


def smi_cards(chips, environ=os.environ):
    """The ``nvidia-smi -i`` ids of the worker's cards: the first ``chips``
    visible ones, as the executor counts them (``CUDA_VISIBLE_DEVICES``'s
    first entries where it is set, else ``0 .. chips-1``)."""
    visible = environ.get("CUDA_VISIBLE_DEVICES")
    if visible is None:
        return [str(i) for i in range(chips)]
    return [v.strip() for v in visible.split(",") if v.strip()][:chips]


def _nvidia_smi_sampler(rundir, cards):
    """``nvidia-smi`` sampling the clocks and power of ``cards`` (ids from
    :func:`smi_cards`) once a second beside the window, or None where there
    is no such tool."""
    exe = shutil.which("nvidia-smi")
    if exe is None or not cards:
        return None
    with open(os.path.join(rundir, "smi.csv"), "w") as out:
        return subprocess.Popen(
            [exe, "--query-gpu=index,clocks.sm,clocks.mem,power.draw,"
             "power.limit,temperature.gpu", "--format=csv,noheader,nounits",
             "-i", ",".join(cards), "-lms", "1000"], stdout=out,
            stderr=subprocess.DEVNULL, preexec_fn=_die_with_parent)


def _smi_summary(rundir):
    """``{column: [min, median, max]}`` over the samples, and over several
    cards ``{card: {column: [min, median, max]}}``."""
    rows = []
    try:
        with open(os.path.join(rundir, "smi.csv")) as f:
            for line in f:
                try:
                    rows.append([float(p) for p in line.split(",")])
                except ValueError:
                    continue
    except OSError:
        return None
    if not rows:
        return None
    cols = ("sm_mhz", "mem_mhz", "power_w", "power_limit_w", "temp_c")
    arr = np.array(rows)

    def summary(part):
        return {c: [float(part[:, i].min()), float(np.median(part[:, i])),
                    float(part[:, i].max())]
                for i, c in enumerate(cols, start=1)}

    cards = sorted(set(arr[:, 0]))
    if len(cards) == 1:
        return summary(arr)
    return {f"card {int(c)}": summary(arr[arr[:, 0] == c]) for c in cards}


class Ask:
    """Sends one query; returns its answer and what the answer leaves on
    the ``RPC``."""

    def __init__(self, names):
        self.names = names

    def __call__(self, rpc, query):
        files = [self.names[i] for i in query["shards"]]
        order, columns = rpc.groupby(files, query["groupby"], query["aggs"],
                                     query["where"])
        effective = (rpc.last_call_strategies or {}).get("effective") or {}
        return {
            "order": order,
            "columns": columns,
            "groups": len(columns[order[0]]) if order else 0,
            "merge_s": rpc.last_call_client_merge_s or 0.0,
            "trace_id": rpc.last_trace_id,
            "routes": sorted({str(r) for r in effective.values()}),
            "source": rpc.last_call_answer_source,
            "reply_bytes": rpc.last_call_reply_bytes,
        }


class Sampler:
    """The window's answers kept for the check: a seeded reservoir of
    ``SAMPLE_PER_SHAPE`` answers per shape, and the slowest answer."""

    def __init__(self, seed):
        self.rng = datagen.rng(seed, datagen.SAMPLE)
        self.seen = {}
        self.kept = {}
        self.slowest = (-1.0, None)
        self.lock = threading.Lock()

    def offer(self, query, wall, answer):
        with self.lock:
            shape = query["shape"]
            n = self.seen[shape] = self.seen.get(shape, 0) + 1
            kept = self.kept.setdefault(shape, [])
            if len(kept) < SAMPLE_PER_SHAPE:
                kept.append((query, answer))
            else:
                j = int(self.rng.integers(0, n))
                if j < SAMPLE_PER_SHAPE:
                    kept[j] = (query, answer)
            if wall > self.slowest[0]:
                self.slowest = (wall, (query, answer))

    def items(self):
        out = [item for kept in self.kept.values() for item in kept]
        if self.slowest[1] is not None:
            out.append(self.slowest[1])
        return out


def run_cell(name, seed, seconds, trace, device="cuda", root=spec.ROOT,
             rows=None, t0=None, check_device=None):
    """One run; returns the result dict (``correct``, ``attempted``,
    ``failed``, ``metrics``, ``device``, ``checks``, ...).
    ``check_device()``, when given, runs once the dataset is written and
    raises to end the run."""
    t0 = time.perf_counter() if t0 is None else t0
    parts_s = {"start": time.perf_counter() - t0}
    cell = spec.Cell(name, root)
    cfg = cell.config
    columns = {c["name"]: c for c in cfg["columns"]}
    rundir = tempfile.mkdtemp(prefix="portbench-",
                              dir=os.environ.get("TMPDIR")
                              or tempfile.gettempdir())
    data_dir = os.path.join(rundir, "data")
    os.makedirs(data_dir)
    os.makedirs(os.path.join(rundir, "store"))
    deployment = None
    try:
        deployment = Deployment(cell, rundir, data_dir, device, trace)
        mark = time.perf_counter()
        ds = datagen.Dataset(cfg, seed, rows=rows)
        parts_s["datagen"] = time.perf_counter() - mark
        parts_s["write"] = ds.write(data_dir)
        open(os.path.join(rundir, "data.ready"), "w").close()
        if check_device is not None:
            mark = time.perf_counter()
            check_device()
            parts_s["check_device"] = time.perf_counter() - mark
        log(f"dataset {cfg['name']}: {ds.rows} rows in {ds.shards} shards, "
            f"drawn in {parts_s['datagen']:.3f}s, written in "
            f"{parts_s['write']:.3f}s")
        log(f"deployment env {json.dumps(deployment.node_env())}")

        mark = time.perf_counter()
        admin = _admin(deployment, ds)
        parts_s["nodes"] = time.perf_counter() - mark
        mark = time.perf_counter()
        ready_path = os.path.join(rundir, "worker.ready")
        _wait(lambda: os.path.exists(ready_path), START_TIMEOUT_S,
              "the worker's warmup", deployment.watched())
        parts_s["warmup"] = time.perf_counter() - mark
        with open(ready_path) as f:
            worker_ready = json.load(f)
        log(f"worker ready: {json.dumps(worker_ready)}")
        devices = worker_ready.get("devices") or []
        if len(devices) != cell.chips:
            raise RunError(f"the cell asks for {cell.chips} cards; the "
                           f"worker runs over {len(devices)}: {devices}")

        log("node boot, s after the run's start: " + json.dumps(_boot_times(
            rundir, time.time() - (time.perf_counter() - t0))))
        traffic = Traffic(cell.traffic, ds.shards, seed)

        ask = Ask(ds.names)
        mark = time.perf_counter()
        cold = []
        for query in traffic.cold():
            sent = time.perf_counter()
            answer = ask(admin, query)
            cold.append((query, time.perf_counter() - sent, answer))
        parts_s["cold"] = time.perf_counter() - mark
        cold_ms = 1e3 * sum(w for _q, w, _a in cold) / len(cold)
        for query, wall, answer in cold:
            log(f"cold {query['shape']}: {1e3 * wall:.3f} ms, routes "
                f"{answer['routes']}, source {answer['source']}, "
                f"{answer['groups']} groups, {answer['reply_bytes']} B")

        # the window
        window, sampler, lost, window_start, window_end = _window(
            cell, traffic, deployment, ask, rundir, seconds, seed)
        setup_s = window_start - t0
        attempted = len(window) + lost
        failed = sum(not r["ok"] for r in window) + lost
        e2e = stats.window_metrics(window, window_start, window_end, lost)

        wjson = os.path.join(rundir, "window.json")
        _wait(lambda: os.path.exists(wjson), 300,
              "the worker's window record", deployment.watched())
        with open(wjson) as f:
            worker_window = json.load(f)
        if "error" in worker_window:
            raise RunError(f"the worker's window: {worker_window['error']}")
        ids = [r["trace_id"] for r in sorted(window, key=lambda r: r["done"])
               if r["ok"] and r.get("trace_id")][-AUTOPSIES:]
        autopsies = [a for a in (admin.autopsy(t) for t in ids)
                     if isinstance(a, dict) and a.get("segments")]
        _diagnostics(window, autopsies, worker_window, rundir, e2e)

        status = deployment.stop()
        tails = deployment.tails()
        deployment = None
        bad = [m for s in status.values()
               for m in s.get("forbidden_modules", [])]
        if bad:
            raise RunError("JAX or the JAX package loaded in a node: "
                           f"{sorted(set(bad))}")
        if set(status) != {"controller", "worker"}:
            raise RunError("a node left no status: "
                           + json.dumps(tails)[-4000:])

        # the check, once the window has closed and the nodes are gone
        items = [(q, (a["order"], a["columns"])) for q, _w, a in cold]
        items += sampler.items()
        mark = time.perf_counter()
        tally, distinct = _check(ds, columns, items)
        ok, rows_checked = tally.verdict(cfg["limits"])
        ok = ok and not failed
        log(f"checked {tally.checked} answers ({distinct} distinct queries) "
            f"against the reference in {time.perf_counter() - mark:.3f}s")

        result = {"correct": bool(ok), "attempted": attempted,
                  "failed": failed}
        if trace:
            view = Window(window, seconds, autopsies,
                          worker_window.get("device"),
                          _least_seconds(ds, columns, window, window_end))
            result["metrics"] = {}
            for m in cell.per_layer:
                value = cell.reader(m["name"]).read(view)
                if value is not None:
                    result["metrics"][m["name"]] = {"value": value,
                                                    "unit": m["unit"]}
        else:
            # cold_ms is measured in every run; BENCHMARK.json decides
            # which cells report it
            values = dict(e2e, cold_ms=cold_ms, setup_s=setup_s)
            result["metrics"] = {m["name"]: {"value": values[m["name"]],
                                             "unit": m["unit"]}
                                 for m in cell.end_to_end}
        result["device"] = {"kind": worker_ready.get("device_name"),
                            "count": cell.chips,
                            "memory_peak_bytes": status["worker"].get(
                                "memory_peak_bytes")}
        if "memory_peak_bytes_per_card" in status["worker"]:
            result["device"]["memory_peak_bytes_per_card"] = status[
                "worker"]["memory_peak_bytes_per_card"]
        if trace and worker_window.get("device"):
            dev = worker_window["device"]
            result["device"].update(busy_s=dev["busy_s"],
                                    window_s=dev["window_s"])
            if "busy_s_per_card" in dev:
                result["device"]["busy_s_per_card"] = dev["busy_s_per_card"]
            result["breakdown"] = dev["breakdown"]
        log("set-up parts, s: " + json.dumps(parts_s))
        log(f"setup_s {setup_s:.6f}, window {seconds} s, attempted "
            f"{attempted}, failed {failed}")
        result["checks"] = {n: {"value": v, "limit": lim}
                            for n, v, lim in rows_checked}
        result["checks"]["failed_queries"] = {"value": failed, "limit": 0}
        # last, once the check and the readers have run in this process
        bad = forbidden_here()
        if bad:
            raise RunError(f"JAX or the JAX package loaded here: {bad}")
        return result
    finally:
        if deployment is not None:
            tails = deployment.tails()
            deployment.stop()
            for role, text in tails.items():
                if text:
                    log(f"--- {role} log tail ---\n{text}")
        shutil.rmtree(rundir, ignore_errors=True)


def _window(cell, traffic, deployment, ask, rundir, seconds, seed):
    """The measured window: the traffic's clients, each a thread with its
    own ``RPC``, run their loop (``loops/<loop>.py``) from the window's
    start to its close; the worker profiles meanwhile.  Returns the
    records of every query sent in the window, the sampler of answers, the
    clients lost past ``STRAGGLER_S``, and the window's start and end."""
    import logging

    from bqueryd_tpu_torch.rpc import RPC

    rpcs = [RPC(coordination_url=deployment.url, timeout=120, retries=3,
                loglevel=logging.WARNING) for _ in range(traffic.clients)]
    sampler = Sampler(seed)
    records = []
    lock = threading.Lock()

    def keeper(client):
        def record(index, query, sent, done, answer, error):
            rec = {"client": client, "index": index, "shape": query["shape"],
                   "query": query, "sent": sent, "done": done,
                   "ok": error is None, "error": error}
            if answer is not None:
                rec.update({k: v for k, v in answer.items()
                            if k not in ("order", "columns")})
                sampler.offer(query, done - sent,
                              (answer["order"], answer["columns"]))
            with lock:
                records.append(rec)
        return record

    loop = cell.loop()
    open(os.path.join(rundir, "window.start"), "w").close()
    smi = _nvidia_smi_sampler(rundir, smi_cards(cell.chips))
    try:
        start = time.perf_counter() + GO_LEAD_S
        end = start + seconds
        threads = [threading.Thread(
            target=loop.run_client,
            args=(rpcs[c], traffic.stream(c), ask, keeper(c), start, end),
            name=f"client-{c}", daemon=True) for c in range(traffic.clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=max(0.0, end - time.perf_counter()) + STRAGGLER_S)
        lost = sum(t.is_alive() for t in threads)
        if lost:
            log(f"{lost} clients still waiting {STRAGGLER_S:.0f}s after the "
                "close: their queries count as failed")
        open(os.path.join(rundir, "window.stop"), "w").close()
    finally:
        if smi is not None:
            smi.terminate()
            smi.wait()
    with lock:
        return list(records), sampler, lost, start, end


def _admin(deployment, ds):
    """This process's own client, once the controller is up and the worker
    serves every shard."""
    import logging

    import bqueryd_tpu_torch
    from bqueryd_tpu_torch.coordination import coordination_store
    from bqueryd_tpu_torch.rpc import RPC

    nodes = deployment.watched()
    store = coordination_store(deployment.url)
    _wait(lambda: store.smembers(bqueryd_tpu_torch.REDIS_SET_KEY),
          START_TIMEOUT_S, "the controller to register", nodes)
    admin = RPC(coordination_url=deployment.url, timeout=120, retries=3,
                loglevel=logging.WARNING)

    def served():
        workers = admin.info()["workers"].values()
        held = {f for w in workers if w.get("workertype") == "calc"
                for f in w.get("data_files") or []}
        return set(ds.names) <= held

    _wait(served, START_TIMEOUT_S, "the worker to serve every shard", nodes)
    return admin


def _check(ds, columns, items):
    """The check's tally over ``(query, (order, columns))`` answers, and
    the number of distinct queries the reference answered."""
    tally = check.Tally()
    answers = {}
    for query, (order, cols) in items:
        key = json.dumps([query["shards"], query["groupby"], query["aggs"],
                          query["where"]])
        if key not in answers:
            answers[key] = reference.answer(ds.parts, columns, query)
        lows, cards = reference.radix(columns, query["groupby"])
        tally.add(check.compare(answers[key], order, cols, query,
                                ds.key_ints, lows, cards))
    return tally, len(answers)


def _least_seconds(ds, columns, window, window_end):
    """The roofline's least time of each query completed in the window
    whose answer the card computed."""
    sel = roofline.SelectedRows(ds.parts)
    return [roofline.least_seconds(roofline.query_bytes(
        r["query"], columns, sel(r["query"]), r["groups"]))
        for r in window
        if r["ok"] and r["done"] <= window_end
        and r["source"] in (None, "recompute")
        and not set(r["routes"]) & set(OFF_DEVICE_ROUTES)]


def _boot_times(rundir, start_wall):
    out = {}
    for role in ("controller", "worker"):
        try:
            with open(os.path.join(rundir, f"{role}.boot.json")) as f:
                boot = json.load(f)
        except OSError:
            continue
        out[role] = {k: round(v - start_wall, 3) for k, v in boot.items()}
    return out


def forbidden_here():
    """Modules of JAX or the JAX package in this process."""
    from portbench.node import forbidden_modules

    return forbidden_modules()


def _diagnostics(window, autopsies, worker_window, rundir, e2e):
    """Earlier lines of the run, for whoever reads its log."""
    by_shape = {}
    for r in window:
        s = by_shape.setdefault(r["shape"], {"n": 0, "failed": 0,
                                             "routes": {}, "sources": {},
                                             "walls": []})
        s["n"] += 1
        if not r["ok"]:
            s["failed"] += 1
            continue
        s["walls"].append(1e3 * (r["done"] - r["sent"]))
        route = ",".join(r["routes"]) or "-"
        s["routes"][route] = s["routes"].get(route, 0) + 1
        src = str(r["source"])
        s["sources"][src] = s["sources"].get(src, 0) + 1
    for shape, s in sorted(by_shape.items()):
        walls = s.pop("walls")
        s["median_ms"] = stats.percentile(walls, 50)
        s["p95_ms"] = stats.percentile(walls, 95)
        log(f"shape {shape}: {json.dumps(s)}")
    errors = sorted({r["error"] for r in window if not r["ok"]})
    if errors:
        log(f"errors: {errors[:5]}")
    if autopsies:
        cov = [float(a.get("coverage") or 0.0) for a in autopsies]
        walls = [float(a.get("wall_s") or 0.0) for a in autopsies]
        seg_totals = {}
        for a in autopsies:
            for k, v in a["segments"].items():
                seg_totals[k] = seg_totals.get(k, 0.0) + float(v)
        log(f"autopsies {len(autopsies)}: coverage min {min(cov):.4f} "
            f"median {stats.percentile(cov, 50):.4f}; admission_wait share "
            f"{seg_totals.get('admission_wait', 0.0) / max(sum(walls), 1e-12):.6f}"
            "; segment means, ms " + json.dumps(
                {k: 1e3 * v / len(autopsies)
                 for k, v in sorted(seg_totals.items())}))
    before = worker_window.get("metrics_before") or {}
    after = worker_window.get("metrics_after") or {}
    deltas = {k: after[k] - before.get(k, 0.0) for k in after
              if after[k] != before.get(k, 0.0)
              and ("pipeline_busy" in k or "workingset" in k
                   or "result_cache" in k or "errors" in k
                   or "_merge_" in k)}
    log(f"worker /metrics deltas over the window: {json.dumps(deltas)}")
    smi = _smi_summary(rundir)
    if smi is not None:
        log(f"nvidia-smi over the window [min, median, max]: "
            f"{json.dumps(smi)}")
    log(f"window: {json.dumps(e2e)}")
