"""Kernel-build and device-memory profiling.

The port's counterpart of ``bqueryd_tpu/obs/profile.py``, behind the
reference's names and snapshot keys.  The reference accounts JAX's jit
cache, its persistent compile cache (``jax.monitoring``) and
``cost_analysis``; the port has none of them.  Its compile cost is the
``nvcc`` build of the kernel library (``ops/onehot.py``), content-addressed
in the build directory, so the mapping is:

* a library already on disk is a persistent-cache hit, an ``nvcc`` run a
  miss, whose seconds land in ``bqueryd_tpu_compile_seconds``
  (:meth:`ProgramProfiler.record_build`); each load of the library counts
  in ``library_loads`` (:meth:`ProgramProfiler.record_load`);
* :func:`instrument` wraps a device entry point (the two kernel wrappers,
  ``partial_tables`` and the DAG program): every call is counted per name
  and shape signature, its first call of a signature as a miss
  (``jit_cache_misses``, the first launch of the shape), the others as
  hits; a call inside which the library was built or loaded counts as a
  compile of its entry.  The cost fields are analytic, from the shapes:
  each tensor argument read once and the output written once
  (``bytes_accessed``), and one multiply-add per element of the stacked
  rows (``flops``, the kernels' contraction) where the caller gives a
  ``cost`` function.  Accounting adds no launch and no synchronization;
* :meth:`ProgramProfiler.memory_sample` and the device-memory gauges read
  ``torch.cuda.memory_stats`` through ``ops.workingset.memory_sample``,
  per card of the executor (:meth:`ProgramProfiler.watch_devices`),
  summed as the reference sums its local devices.

Every ``torch.cuda`` call is guarded by ``torch.cuda.is_initialized()``
(and torch by its presence in ``sys.modules``): a controller or a
downloader never creates a CUDA context, and never imports torch, for its
profile.  The profiler is process-global (one kernel library per process);
:meth:`ProgramProfiler.bind` adopts the same metric instances into each
node's registry.

``BQUERYD_TPU_COMPILE_PROFILE=0`` (or ``BQUERYD_TPU_METRICS=0``) makes
:func:`instrument` a passthrough.  Standard library only at import time.
"""

import os
import re
import sys
import tempfile
import threading
import time

from bqueryd_tpu_torch.obs import metrics as metrics_mod

#: registry entries kept; the least recently called is evicted past this
MAX_PROGRAMS = 256

#: the default kernel build directory: ``build/kernels`` beside the package
DEFAULT_BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))),
    "build", "kernels",
)


def profiling_enabled():
    """Call profiling on or off (read per call).  ``BQUERYD_TPU_METRICS=0``
    turns it off too (checked by the wrapper through ``obs.enabled()``)."""
    return os.environ.get("BQUERYD_TPU_COMPILE_PROFILE", "1") != "0"


def _cuda_initialized():
    """Whether this process already holds a CUDA context (without
    importing torch or creating one)."""
    torch = sys.modules.get("torch")
    return torch is not None and torch.cuda.is_initialized()


def _shape_signature(name, args, kwargs):
    """``name(dtype[shape];...)``: a tensor or array argument by its dtype
    and shape, any other value by its repr."""
    parts = []
    for value in list(args) + [kwargs[k] for k in sorted(kwargs)]:
        if hasattr(value, "shape") and hasattr(value, "dtype"):
            dims = ",".join(str(int(d)) for d in value.shape)
            dtype = str(value.dtype).replace("torch.", "")
            parts.append(f"{dtype}[{dims}]")
        elif isinstance(value, (tuple, list)) and value and all(
                hasattr(v, "shape") for v in value):
            parts.append("(" + ",".join(
                str(v.dtype).replace("torch.", "") + "["
                + ",".join(str(int(d)) for d in v.shape) + "]"
                for v in value) + ")")
        else:
            parts.append(repr(value)[:48])
    return f"{name}({';'.join(parts)})"


def _tensor_bytes(value):
    """Bytes of a tensor (or a tuple of tensors), else 0."""
    if isinstance(value, (tuple, list)):
        return sum(_tensor_bytes(v) for v in value)
    numel = getattr(value, "numel", None)
    size = getattr(value, "element_size", None)
    if callable(numel) and callable(size):
        return int(numel()) * int(size())
    return 0


class ProgramProfiler:
    """Process-wide build, call and device-memory state (module
    docstring)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.compile_seconds = metrics_mod.Histogram(
            "bqueryd_tpu_compile_seconds",
            "wall of nvcc builds of the kernel library",
        )
        self.jit_cache_hits = 0
        self.jit_cache_misses = 0
        self.persistent_cache_hits = 0
        self.persistent_cache_misses = 0
        self.library_loads = 0
        self.nvcc_release = None
        self.programs = {}        # signature -> registry entry dict
        self.programs_evicted = 0
        self._call_seq = 0        # recency order for eviction and snapshot
        self._devices = ()        # the executor's CUDA cards

    # -- the kernel library ------------------------------------------------
    def record_build(self, hit, seconds=0.0, nvcc_release=None):
        """One ``build()``: a library on disk (``hit``) or an nvcc run of
        ``seconds``; ``nvcc_release`` is the compiler's release line."""
        with self._lock:
            if hit:
                self.persistent_cache_hits += 1
            else:
                self.persistent_cache_misses += 1
            if nvcc_release:
                self.nvcc_release = nvcc_release
        if not hit:
            self.compile_seconds.observe(seconds)

    def record_load(self):
        """One load of the kernel library into the process."""
        with self._lock:
            self.library_loads += 1

    # -- per-call accounting -----------------------------------------------
    def record_call(self, name, fn, args, kwargs, compiled, duration_s,
                    signature=None, cost=None):
        """Account one call of an instrumented entry point: ``compiled``
        when the library was built or loaded inside it, ``cost`` its
        analytic ``{"flops", "bytes_accessed"}``."""
        del fn  # the reference's seam; the port's cost is analytic
        if signature is None:
            signature = _shape_signature(name, args, kwargs)
        now = time.time()
        with self._lock:
            entry = self.programs.get(signature)
            if entry is None:
                self.jit_cache_misses += 1
                entry = self.programs[signature] = {
                    "name": name,
                    "signature": signature,
                    "calls": 0,
                    "compiles": 0,
                    "jit_cache_hits": 0,
                    "total_compile_s": 0.0,
                    "last_compile_s": None,
                    "flops": None,
                    "bytes_accessed": None,
                    "first_ts": round(now, 3),
                    # stamped before the eviction scan: a new entry without
                    # it would min() as the oldest and evict itself
                    "_seq": self._call_seq + 1,
                }
                while len(self.programs) > MAX_PROGRAMS:
                    oldest = min(self.programs.values(),
                                 key=lambda e: e.get("_seq", 0))
                    self.programs.pop(oldest["signature"], None)
                    self.programs_evicted += 1
            else:
                self.jit_cache_hits += 1
                entry["jit_cache_hits"] += 1
            self._call_seq += 1
            entry["calls"] += 1
            entry["_seq"] = self._call_seq
            entry["last_call_ts"] = round(now, 3)
            if compiled:
                entry["compiles"] += 1
                entry["last_compile_s"] = round(duration_s, 4)
                entry["total_compile_s"] = round(
                    entry["total_compile_s"] + duration_s, 4)
            if cost:
                entry.update(cost)

    # -- device memory -----------------------------------------------------
    def watch_devices(self, devices):
        """The CUDA cards whose memory the profile reads (the executor's;
        a repeated card counts once)."""
        with self._lock:
            self._devices = tuple(dict.fromkeys(
                d for d in devices if d.type == "cuda"))

    def _cards(self):
        import torch

        with self._lock:
            cards = self._devices
        return cards or (torch.device("cuda", torch.cuda.current_device()),)

    def memory_sample(self, device=None):
        """``{"bytes_in_use", "peak_bytes_in_use", "bytes_limit"}`` of
        ``device``, or over the watched cards (the current one when none
        is watched): in use and limit summed, the peak the largest, as the
        reference summarizes its local devices; from
        ``ops.workingset.memory_sample``.  None while this process holds
        no CUDA context."""
        if device is not None:
            return self.device_memory_of(device)
        per_device = self.device_memory()
        if not per_device:
            return None
        return {
            "bytes_in_use": sum(d["bytes_in_use"] for d in per_device),
            "peak_bytes_in_use": max(d["peak_bytes_in_use"]
                                     for d in per_device),
            "bytes_limit": sum(d["bytes_limit"] for d in per_device),
        }

    def device_memory_of(self, device):
        """One card's sample, or None without a CUDA context."""
        if not _cuda_initialized():
            return None
        from bqueryd_tpu_torch.ops.workingset import memory_sample

        return memory_sample(device)

    def device_memory(self):
        """One entry per watched card, the reference's per-device list."""
        if not _cuda_initialized():
            return []
        import torch

        out = []
        for card in self._cards():
            sample = self.device_memory_of(card)
            if sample is not None:
                out.append({"device": card.index,
                            "kind": torch.cuda.get_device_name(card),
                            **sample})
        return out

    def _memory_gauge(self, key):
        def read():
            sample = self.memory_sample()
            return float("nan") if sample is None else float(sample[key] or 0)

        return read

    def last_program(self, name_prefix):
        """The most recently called entry whose ``name`` starts with
        ``name_prefix`` (a copy), or None."""
        with self._lock:
            best = None
            for entry in self.programs.values():
                if not str(entry.get("name", "")).startswith(name_prefix):
                    continue
                if best is None or entry.get("_seq", 0) > best.get("_seq", 0):
                    best = entry
            return dict(best) if best is not None else None

    # -- export ------------------------------------------------------------
    def snapshot(self, max_programs=32):
        """JSON-safe state for the WRM debug slice and the debug bundle;
        the ``max_programs`` most recently called entries."""
        with self._lock:
            programs = sorted(
                (dict(e) for e in self.programs.values()),
                key=lambda e: e.get("_seq", 0),
                reverse=True,
            )[:max_programs]
            return {
                "jit_cache_hits": self.jit_cache_hits,
                "jit_cache_misses": self.jit_cache_misses,
                "persistent_cache_hits": self.persistent_cache_hits,
                "persistent_cache_misses": self.persistent_cache_misses,
                "library_loads": self.library_loads,
                "programs_tracked": len(self.programs),
                "programs_evicted": self.programs_evicted,
                "compile_seconds": self.compile_seconds.snapshot(),
                "programs": programs,
            }

    def bind(self, registry):
        """Expose the profiler on a node's registry: the compile histogram
        is the same instance in every bound registry; the rest are
        callback gauges over the shared state."""
        registry.register(self.compile_seconds)
        for name, help_text, fn in (
            (
                "bqueryd_tpu_jit_cache_hits",
                "instrumented device calls of an already launched shape "
                "(monotonic)",
                lambda: self.jit_cache_hits,
            ),
            (
                "bqueryd_tpu_jit_cache_misses",
                "instrumented device calls of a shape's first launch "
                "(monotonic)",
                lambda: self.jit_cache_misses,
            ),
            (
                "bqueryd_tpu_persistent_cache_hits",
                "kernel library builds served from the build directory "
                "(monotonic)",
                lambda: self.persistent_cache_hits,
            ),
            (
                "bqueryd_tpu_persistent_cache_misses",
                "kernel library builds that ran nvcc (monotonic)",
                lambda: self.persistent_cache_misses,
            ),
            (
                "bqueryd_tpu_device_bytes_in_use",
                "device memory held by live tensors",
                self._memory_gauge("bytes_in_use"),
            ),
            (
                "bqueryd_tpu_device_peak_bytes_in_use",
                "high watermark of device memory held by live tensors",
                self._memory_gauge("peak_bytes_in_use"),
            ),
            (
                "bqueryd_tpu_device_bytes_limit",
                "device memory capacity",
                self._memory_gauge("bytes_limit"),
            ),
        ):
            registry.gauge(name, help_text, fn=fn)


_profiler = ProgramProfiler()


def profiler():
    """The process-global :class:`ProgramProfiler`."""
    return _profiler


def _reset_for_tests():
    """Test seam: fresh process-global profiler state."""
    global _profiler
    _profiler = ProgramProfiler()
    return _profiler


def _library_loads():
    """The kernel library's load count, without importing torch."""
    onehot = sys.modules.get("bqueryd_tpu_torch.ops.onehot")
    return onehot._LOADS[0] if onehot is not None else 0


def instrument(name, fn, cost=None):
    """Wrap a device entry point with call accounting.

    ``cost(args, kwargs)``, when given, returns the analytic flops of one
    call; bytes are the tensor arguments' plus the output's.  The wrapper
    is a passthrough while profiling or the observability hot path is off,
    and accounting never raises into the query path."""

    def wrapped(*args, **kwargs):
        from bqueryd_tpu_torch import obs

        if not profiling_enabled() or not obs.enabled():
            return fn(*args, **kwargs)
        loads = _library_loads()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        duration = time.perf_counter() - t0
        try:
            nbytes = (sum(_tensor_bytes(a) for a in args)
                      + sum(_tensor_bytes(v) for v in kwargs.values())
                      + _tensor_bytes(out))
            fields = {"bytes_accessed": float(nbytes)}
            if cost is not None:
                fields["flops"] = float(cost(args, kwargs))
            _profiler.record_call(
                name, fn, args, kwargs,
                compiled=_library_loads() != loads,
                duration_s=duration,
                signature=_shape_signature(name, args, kwargs),
                cost=fields,
            )
        except Exception:
            pass  # accounting must never fail the query
        return out

    wrapped.__name__ = name.rsplit(".", 1)[-1]
    wrapped.__wrapped__ = fn
    return wrapped


# -- environment facts (controller processes report these too) -------------

_package_versions = None


def runtime_versions():
    """torch and numpy versions from package metadata (no import of torch),
    and, where this process already imported torch, ``torch_cuda``
    (``torch.version.cuda``); where it holds a CUDA context, ``device``
    (the card's name); ``nvcc`` (the release the kernel library was built
    with) once a build was accounted."""
    global _package_versions
    if _package_versions is None:
        from importlib import metadata

        out = {}
        for pkg in ("torch", "numpy", "pyzmq"):
            try:
                out[pkg] = metadata.version(pkg)
            except Exception:
                continue
        _package_versions = out
    versions = dict(_package_versions)
    torch = sys.modules.get("torch")
    if torch is not None:
        versions["torch"] = torch.__version__
        versions["torch_cuda"] = torch.version.cuda
        if torch.cuda.is_initialized():
            versions["device"] = torch.cuda.get_device_name()
    if _profiler.nvcc_release:
        versions["nvcc"] = _profiler.nvcc_release
    return versions


def compile_cache_info():
    """The kernel build directory as facts: ``enabled`` (False under
    ``BQUERYD_TPU_COMPILE_CACHE=0``: each process builds into a directory
    of its own), ``path`` (``BQUERYD_TPU_COMPILE_CACHE`` when it names a
    directory, else ``build/kernels`` beside the package) and
    ``writable``."""
    cc = os.environ.get("BQUERYD_TPU_COMPILE_CACHE", "1")
    enabled = cc != "0"
    path = None
    writable = False
    if enabled:
        path = cc if cc not in ("", "1") else DEFAULT_BUILD_DIR
        probe = path
        while probe and not os.path.isdir(probe):
            # a directory not made yet is writable where its parent is
            parent = os.path.dirname(probe)
            probe = parent if parent != probe else None
        writable = bool(probe) and os.access(probe, os.W_OK)
    return {"enabled": enabled, "path": path, "writable": writable}


_private_build_dir = []


def kernel_build_dir():
    """Where ``ops.onehot.build`` puts the kernel library:
    :func:`compile_cache_info`'s path, or a per-process temporary
    directory while the cache is off."""
    info = compile_cache_info()
    if info["enabled"]:
        return info["path"]
    if not _private_build_dir:
        _private_build_dir.append(tempfile.mkdtemp(prefix="bqtpu_kernels_"))
    return _private_build_dir[0]


def nvcc_release(version_text):
    """The release line of ``nvcc --version``'s output
    (``"release 12.4, V12.4.131"``), or None."""
    match = re.search(r"release [^\n]*", version_text or "")
    return match.group(0).strip() if match else None
