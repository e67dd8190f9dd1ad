"""Config-registry lint: one typed table of every ``BQUERYD_TPU_*`` env var
the port reads.

The port's copy of ``bqueryd_tpu/analysis/configreg.py`` with the port's
own registry.  The names are the reference's, so one deployment configures
both packages alike; the defaults and read times are the port's.  The
reference's variables whose subject is JAX, XLA or Pallas (``PLATFORM``,
``PALLAS``, ``PALLAS_HICARD_GT``/``_KT``, ``PACKED_FETCH``,
``SHAPE_BUCKETS``, ``FORCE_MATMUL``, ``COST_ANALYSIS``) have no reader in
the port and stay out of it.  :data:`ENV_REGISTRY` declares name, type,
default (as the code spells it), help, and read-time — and
:class:`ConfigRegistryAnalyzer` is the AST pass that keeps code, registry,
and the README's port section from drifting:

* every ``os.environ`` / ``os.getenv`` touch of a ``BQUERYD_TPU_*`` key must
  name a registered var (``config-unregistered-env``);
* every registered var must appear in the README config table
  (``config-undocumented``) and every ``BQUERYD_TPU_*`` token in the README
  must be registered (``config-readme-unknown``);
* a registered var whose name appears nowhere in package source is dead
  (``config-dead-var``);
* a var declared ``read_time="call"`` (live-tunable) must not be read at
  module scope, where the value latches at import (``config-import-time-read``);
* reads of non-``BQUERYD_TPU_`` env vars must be in
  :data:`EXTERNAL_ENV_ALLOWED` (``config-external-env``) — the package must
  not silently grow dependencies on ambient environment;
* env reads with a non-literal key are opaque to all of the above and
  require an inline suppression explaining where the keys come from
  (``config-dynamic-env-key``);
* registered names where one extends the other (``FOO`` vs ``FOO_BARS``)
  must cross-reference via ``related=`` or they read as near-collisions —
  the ``TRACE_BUFFER`` (entries) vs ``TRACE_BUFFER_BYTES`` (bytes) class of
  confusion (``config-name-collision``).

Stdlib only.
"""

import ast
import re

from bqueryd_tpu_torch.analysis.core import Finding

ENV_PREFIX = "BQUERYD_TPU_"

#: exact var-name tokens (substring matching would let BQUERYD_TPU_FOO hide
#: inside BQUERYD_TPU_FOO_BYTES — precisely the near-collision pairs this
#: module polices)
_TOKEN_RE = re.compile(r"BQUERYD_TPU_[A-Z0-9_]+")

#: reads of env vars owned by other systems (the CUDA toolkit, cloud SDKs)
#: that the package legitimately consults; anything else non-BQUERYD is a
#: finding
EXTERNAL_ENV_ALLOWED = frozenset({
    "CUDA_HOME",                # where nvcc lives when it is not on PATH
    "AZURE_STORAGE_CONNECTION_STRING",  # azure SDK's own credential var
})

READ_IMPORT = "import"   # latched at module import; restart to change
READ_CALL = "call"       # re-read per use; live-tunable


class EnvVar:
    """One registered config var.  ``default`` is the human-readable default
    exactly as operators should understand it; ``related`` names registered
    vars this one is easily confused with (prefix extensions) and doubles as
    the near-collision waiver."""

    __slots__ = ("name", "type", "default", "help", "read_time", "related")

    def __init__(self, name, type, default, help, read_time=READ_CALL,
                 related=()):
        self.name = name
        self.type = type
        self.default = default
        self.help = help
        self.read_time = read_time
        self.related = tuple(related)


def _v(name, type, default, help, read_time=READ_CALL, related=()):
    return EnvVar(ENV_PREFIX + name, type, default, help, read_time,
                  tuple(ENV_PREFIX + r for r in related))


#: the central typed registry; ordering is the README config-table ordering
ENV_REGISTRY = {
    var.name: var
    for var in [
        _v("CFG", "path", "/etc/bqueryd_tpu.cfg",
           "config file path", READ_IMPORT),
        _v("COORDINATION_URL", "str", "redis://localhost:6379",
           "membership/tickets/locks store", READ_IMPORT),
        _v("DATA_DIR", "path", "/srv/bcolz/",
           "served shard directory", READ_IMPORT),
        _v("RUNFILE_DIR", "path", "/srv",
           "controller address/pid runfiles", READ_IMPORT),
        _v("IP", "str", "auto", "advertised IP override"),
        _v("MATMUL_GROUPS", "int", "8192",
           "contraction groupby path cardinality limit (0=off)"),
        _v("MATMUL_CELLS", "int", "2^36",
           "rows x groups budget for the contraction path"),
        _v("PALLAS_HICARD_GROUPS", "int", "2^18",
           "group-count ceiling of the hicard contraction route (the "
           "reference's name; the route runs the CUDA hicard kernel)"),
        _v("DEVICE_PROBE_TIMEOUT_S", "float", "60",
           "wedge-latch deadline for backend liveness probes (0 disables)"),
        _v("DEVICE_PROBE_INTERVAL_S", "float", "30",
           "backend liveness probe cadence"),
        _v("HOST_KERNEL_ROWS", "int", "auto",
           "host-route queries below this many rows (0 = always device)"),
        _v("DEVICE_MERGE", "flag", "1",
           "device-resident distributed merge over the mesh (0 = host-side "
           "hostmerge fallback + per-shard dispatch)"),
        _v("RESULT_CACHE_BYTES", "int", "256 MiB",
           "worker result cache (0=off)"),
        _v("PIPELINE_THREADS", "int", "min(16, cpu)",
           "shard-pipeline pool width (1 = fully serial stages)"),
        _v("HBM_CACHE_BYTES", "int", "1 GiB",
           "working-set blocks segment: device-resident measure columns, "
           "filter columns and basket codes"),
        _v("CODES_CACHE_BYTES", "int", "256 MiB",
           "working-set codes segment: device-resident unmasked group "
           "codes"),
        _v("ALIGN_CACHE_BYTES", "int", "512 MiB",
           "working-set align segment: host key alignment"),
        _v("HBM_EVICT_WATERMARK", "float", "0.9",
           "shed LRU device cache above this fraction of the card's memory"),
        _v("COLUMN_CACHE_BYTES", "int", "2 GiB",
           "decoded-column cache byte budget", READ_IMPORT),
        _v("NATIVE_LIB", "path", "auto",
           "path to the native codec library, tried before the build "
           "tree"),
        _v("ENABLE_EXECUTE_CODE", "flag", "0",
           "allow the remote-execution verb"),
        _v("S3_ENDPOINT", "str", "-",
           "S3 endpoint override (localstack testing)"),
        _v("BLOB_DIR", "path", "-", "local-dir blob backend root (testing)"),
        _v("PROFILE", "flag", "0",
           "torch.profiler and NVTX ranges per executor phase",
           related=("PROFILE_DIR",)),
        _v("PROFILE_DIR", "path", "-",
           "write a Chrome trace (torch.profiler) of each query a worker "
           "computes",
           related=("PROFILE",)),
        _v("DIST_COORDINATOR", "str", "-",
           "host:port to join a multi-process torch.distributed job"),
        _v("DIST_NPROCS", "int", "1",
           "process count of the torch.distributed job"),
        _v("DIST_PROC_ID", "int", "0",
           "this process's rank in the torch.distributed job"),
        _v("WARMUP", "flag", "1",
           "background kernel warmup at worker start: library load, one "
           "launch, the dispatch floor (0=off)"),
        _v("FACTORIZE_CACHE_BYTES", "int", "256 MiB",
           "per-column factorization cache"),
        _v("DISK_FACTOR_CACHE", "flag", "1",
           "persist factorizations/composites next to shards (0=off)"),
        _v("ALIGN_THREADS", "int", "auto",
           "shard-alignment concurrency cap (1=sequential)"),
        _v("COMPILE_CACHE", "str", "1",
           "kernel build directory (0 = a per-process temporary one, "
           "<path> = relocate)"),
        _v("DISTINCT_VALUES_LIMIT", "int", "5_000_000",
           "cap on shipped (group, value) pairs per count_distinct payload"),
        _v("TOPK_LIMIT", "int", "1024",
           "per-group k ceiling for DAG top-k operators (payload grows "
           "with k x groups x shards)",
           related=("JOIN_BROADCAST_LIMIT", "SKETCH_ALPHA")),
        _v("JOIN_BROADCAST_LIMIT", "int", "100_000",
           "max dimension-table rows a broadcast hash join ships per "
           "dispatch envelope (larger tables belong in shards)",
           related=("TOPK_LIMIT", "SKETCH_ALPHA")),
        _v("SKETCH_ALPHA", "float", "0.01",
           "default relative accuracy of DAG quantile sketches "
           "(DDSketch-style log buckets; estimate error <= alpha)",
           related=("TOPK_LIMIT", "JOIN_BROADCAST_LIMIT")),
        _v("DAG_BATCH", "flag", "1",
           "batched shard-group dispatch + device-resident merge for "
           "extended DAG queries (0 = per-shard dispatch + host "
           "merge, bit-identical; the mixed-version fallback)",
           related=("DEVICE_MERGE", "SKETCH_GRID_CELLS")),
        _v("SKETCH_GRID_CELLS", "int", "2^23",
           "dense sketch-grid cell budget (padded groups x bucket width) "
           "for the DAG fast path's device merge; above it quantile "
           "queries fall back to the per-shard host merge",
           related=("DAG_BATCH", "SKETCH_ALPHA")),
        _v("DOWNLOAD_THREADS", "int", "3",
           "parallel blob fetches per downloader"),
        _v("INCOMING", "path", "data_dir/incoming",
           "download staging directory"),
        _v("PLANNER", "flag", "1",
           "plan-time shard pruning + kernel-strategy hints (0=static)"),
        _v("CALIB", "flag", "1",
           "measured-cost strategy calibration feeding the planner "
           "(0 = the heuristic hints exactly)",
           related=("CALIB_PATH", "CALIB_EPSILON", "CALIB_MIN_SAMPLES")),
        _v("CALIB_PATH", "path", "-",
           "persist worker calibration cells to this JSON file across "
           "restarts (- = in-memory only)",
           related=("CALIB",)),
        _v("CALIB_EPSILON", "float", "0.05",
           "bounded exploration rate: ~every 1/eps-th warm-bucket decision "
           "samples an unmeasured legal route (0 = off)",
           related=("CALIB",)),
        _v("CALIB_MIN_SAMPLES", "int", "3",
           "measured kernel walls a strategy cell needs before calibration "
           "trusts it",
           related=("CALIB",)),
        _v("BATCH_WINDOW_MS", "float", "0",
           "admission micro-batch window: hold admitted groupby plans this "
           "many ms so compatible concurrent queries fuse into one "
           "shared-scan bundle (0 = off, single-query behaviour)",
           related=("BATCH_MAX",)),
        _v("BATCH_MAX", "int", "16",
           "member-query cap per micro-batch flush (a full window flushes "
           "early)",
           related=("BATCH_WINDOW_MS",)),
        _v("ADMIT_MAX_ACTIVE", "int", "64",
           "concurrent executing plans before queueing"),
        _v("ADMIT_QUEUE_DEPTH", "int", "256",
           "admission wait-queue depth before BUSY"),
        _v("ADMIT_CLIENT_QUOTA", "int", "0",
           "max tickets per quota bucket (0 = unlimited)"),
        _v("SHARD_STATS", "flag", "1",
           "advertise per-shard planning stats in worker WRMs"),
        _v("METRICS", "flag", "1",
           "observability hot path: spans + histogram observes (0=off)",
           related=("METRICS_PORT",)),
        _v("METRICS_PORT", "int", "-",
           "serve Prometheus /metrics on this port (0 = ephemeral)",
           related=("METRICS",)),
        _v("TRACE_BUFFER", "int", "256",
           "ENTRY-COUNT cap: how many per-query trace timelines rpc.trace() "
           "retains (distinct from the _BYTES total-size cap)",
           related=("TRACE_BUFFER_BYTES",)),
        _v("TRACE_BUFFER_BYTES", "int", "16 MiB",
           "BYTE cap on the same trace ring: total retained timeline bytes, "
           "whichever of the two caps trips first evicts",
           related=("TRACE_BUFFER",)),
        _v("SLOW_QUERY_MS", "int", "1000",
           "slow-query log threshold (0 records everything)"),
        _v("SLOW_QUERY_BYTES", "int", "4 MiB",
           "byte cap on the slow-query ring"),
        _v("SLO_CLASSES", "str", "",
           "SLO class table: comma list of name:target_s[:objective] "
           "(e.g. interactive:0.5:0.999,batch:30); a default class "
           "(2 s, 0.99) always exists — clients pick theirs via "
           "RPC(slo_class=...)", read_time="import"),
        _v("TIMELINE_INTERVAL_S", "float", "10",
           "rpc.timeline() snapshot period in SECONDS (<=0 disables the "
           "ring; distinct from the _ENTRIES count cap)",
           related=("TIMELINE_ENTRIES",)),
        _v("TIMELINE_ENTRIES", "int", "360",
           "ENTRY-COUNT cap on the rpc.timeline() snapshot ring (newest "
           "kept; distinct from the _INTERVAL_S period)",
           read_time="import", related=("TIMELINE_INTERVAL_S",)),
        _v("CAPACITY", "flag", "1",
           "fleet capacity model: μ/λ/ρ accounting, saturation states and "
           "the shadow scaling advisor behind rpc.capacity() (0 = taps and "
           "evaluation off)",
           related=("CAPACITY_WINDOW_S", "CAPACITY_RHO_WARM",
                    "CAPACITY_RHO_SATURATED", "CAPACITY_HYSTERESIS_S",
                    "CAPACITY_TARGET_RHO")),
        _v("CAPACITY_WINDOW_S", "float", "60",
           "rolling window the capacity model's arrival/dispatch rates are "
           "measured over",
           related=("CAPACITY",)),
        _v("CAPACITY_RHO_WARM", "float", "0.5",
           "utilization at which a worker/fleet classifies warm "
           "(saturated and overloaded sit above; see _RHO_SATURATED)",
           related=("CAPACITY", "CAPACITY_RHO_SATURATED")),
        _v("CAPACITY_RHO_SATURATED", "float", "0.8",
           "utilization at which a worker/fleet classifies saturated "
           "(>= 1.0 is overloaded by definition, not a knob)",
           related=("CAPACITY", "CAPACITY_RHO_WARM")),
        _v("CAPACITY_HYSTERESIS_S", "float", "10",
           "a capacity state change must persist this many seconds before "
           "it takes (0 = flip immediately)",
           related=("CAPACITY",)),
        _v("CAPACITY_TARGET_RHO", "float", "0.7",
           "utilization the shadow advisor sizes the fleet for: scale_up "
           "asks for enough workers to return ρ here, scale_down sheds "
           "only what the target leaves headroom for",
           related=("CAPACITY",)),
        _v("LOG_JSON", "flag", "0",
           "structured JSON log lines with trace correlation ids"),
        _v("COMPILE_PROFILE", "flag", "1",
           "call and build accounting on instrumented entry points (0=off)"),
        _v("FLIGHT_CAPACITY", "int", "512",
           "flight-ring entry cap per node"),
        _v("FLIGHT_BYTES", "int", "1 MiB", "flight-ring byte cap per node"),
        _v("HEALTH_ROUTING", "flag", "1",
           "dispatch deprioritizes degraded/wedged workers (0 = score only)"),
        _v("DEBUG_DIR", "path", "tmpdir",
           "where SIGUSR1 debug bundles are written"),
        _v("DEAD_WORKER_TIMEOUT", "float", "60",
           "cull workers silent longer than this many seconds",
           related=("DISPATCH_TIMEOUT", "DISPATCH_HARD_TIMEOUT")),
        _v("DISPATCH_TIMEOUT", "float", "120",
           "re-queue (fail over) in-flight shard work older than this many "
           "seconds when its worker stopped heartbeating",
           related=("DEAD_WORKER_TIMEOUT", "DISPATCH_HARD_TIMEOUT",
                    "MAX_DISPATCH_RETRIES")),
        _v("DISPATCH_HARD_TIMEOUT", "float", "1800",
           "re-queue in-flight shard work older than this many seconds even "
           "on a live, heartbeating worker (wedged-but-alive reclaim)",
           related=("DISPATCH_TIMEOUT", "DEAD_WORKER_TIMEOUT")),
        _v("MAX_DISPATCH_RETRIES", "int", "2",
           "failover attempts per shard before the query aborts with the "
           "structured DispatchExhausted envelope",
           related=("DISPATCH_TIMEOUT",)),
        _v("FAULT_PLAN", "str", "-",
           "arm deterministic fault injection: a FaultPlan JSON file path "
           "or inline JSON (bqueryd_tpu_torch.chaos); unset = every injection "
           "site is a no-op"),
        _v("HEDGE_MS", "float", "0",
           "duplicate a tail shard still inflight past this many ms onto a "
           "second healthy holder, first reply wins (0 = hedging off)"),
        _v("REPLICA_FACTOR", "int", "0 (all nodes)",
           "placement hint: holders per shard — download fan-out targets "
           "this many nodes per file (0 = every node, the historical "
           "full fan-out); under-replicated shards surface in "
           "rpc.info()['replication'] (failover needs >=2)"),
        _v("APPEND", "flag", "1",
           "accept rpc.append on this worker (0 = reject streaming "
           "ingest with a structured error)",
           related=("DELTA_SERVE", "CHUNK_PRUNE")),
        _v("CHUNK_PRUNE", "flag", "1",
           "chunk-granular zone-map pruning: filtered queries decode only "
           "chunks whose per-chunk min/max can match (0 = whole-column "
           "decode)",
           related=("CHUNK_PRUNE_SELECTIVITY", "APPEND")),
        _v("CHUNK_PRUNE_SELECTIVITY", "float", "0.9",
           "surviving-chunk fraction ABOVE which chunk pruning is skipped "
           "(near-full selections would fragment the content-keyed caches "
           "for no decode savings)",
           related=("CHUNK_PRUNE",)),
        _v("DELTA_SERVE", "flag", "1",
           "delta-maintained hot aggregates: a cached result whose tables "
           "only grew refreshes by aggregating the appended chunks alone "
           "and merging the delta partial (0 = full recompute on every "
           "append)",
           related=("DELTA_CACHE_BYTES", "APPEND")),
        _v("DELTA_CACHE_BYTES", "int", "128 MiB",
           "byte budget of the worker's delta-maintained aggregate cache",
           related=("DELTA_SERVE",)),
        _v("SERVE", "flag", "1",
           "semantic serving layer: answer admitted queries from "
           "materialized rollups via plan subsumption (0 = exact-signature "
           "caches only, bit-identical to the pre-serving tree)",
           related=("ROLLUP_MAX", "ROLLUP_HEAT_MIN", "ROLLUP_CACHE_BYTES",
                    "DELTA_SERVE")),
        _v("ROLLUP_MAX", "int", "16",
           "max materialized rollup entries held controller-side",
           related=("SERVE", "ROLLUP_CACHE_BYTES")),
        _v("ROLLUP_HEAT_MIN", "float", "3.0",
           "decayed hit-score a plan view must reach before the controller "
           "materializes a rollup for it",
           related=("SERVE", "ROLLUP_HEAT_HALFLIFE_S")),
        _v("ROLLUP_HEAT_HALFLIFE_S", "float", "300",
           "half-life (seconds) of the rollup heat tracker's exponential "
           "decay",
           related=("ROLLUP_HEAT_MIN",)),
        _v("ROLLUP_CACHE_BYTES", "int", "256 MiB",
           "byte budget for stored rollup partials (least-recently-hit "
           "entries evicted past it)",
           related=("ROLLUP_MAX", "SERVE")),
    ]
}


def registry_markdown_rows():
    """``| name | default | help |`` rows in registry order — the generator
    behind the README config-reference table (the lint checks the README
    covers every name; this helper regenerates the table wholesale)."""
    rows = []
    for var in ENV_REGISTRY.values():
        live = "" if var.read_time == READ_CALL else " (restart required)"
        rows.append(f"| `{var.name}` | {var.default} | {var.help}{live} |")
    return rows


class _EnvReadVisitor(ast.NodeVisitor):
    """Collect env-API touch sites: (key_or_None, lineno, module_scope)."""

    def __init__(self):
        # (key | None, lineno, at_module_scope, scope_name)
        self.sites = []
        self._scopes = []           # enclosing function-name stack

    # -- scope tracking ----------------------------------------------------
    def _scoped(self, node):
        self._scopes.append(getattr(node, "name", "<lambda>"))
        self.generic_visit(node)
        self._scopes.pop()

    visit_FunctionDef = _scoped
    visit_AsyncFunctionDef = _scoped
    visit_Lambda = _scoped

    # -- env APIs ----------------------------------------------------------
    @staticmethod
    def _is_environ(node):
        """True for ``os.environ`` (Attribute) or a bare ``environ`` Name."""
        if isinstance(node, ast.Attribute) and node.attr == "environ":
            return True
        return isinstance(node, ast.Name) and node.id == "environ"

    def _record(self, key_node, lineno):
        key = (
            key_node.value
            if isinstance(key_node, ast.Constant)
            and isinstance(key_node.value, str)
            else None
        )
        scope = self._scopes[-1] if self._scopes else "<module>"
        self.sites.append((key, lineno, not self._scopes, scope))

    def visit_Call(self, node):
        func = node.func
        if isinstance(func, ast.Attribute):
            # os.environ.get/setdefault/pop("KEY"...), os.getenv("KEY"...)
            if (
                func.attr in ("get", "setdefault", "pop")
                and self._is_environ(func.value)
                and node.args
            ):
                self._record(node.args[0], node.lineno)
            elif func.attr == "getenv" and node.args:
                self._record(node.args[0], node.lineno)
        self.generic_visit(node)

    def visit_Subscript(self, node):
        if self._is_environ(node.value):
            self._record(node.slice, node.lineno)
        self.generic_visit(node)

    def visit_Compare(self, node):
        # "KEY" in os.environ
        if len(node.ops) == 1 and isinstance(
            node.ops[0], (ast.In, ast.NotIn)
        ):
            if self._is_environ(node.comparators[0]):
                self._record(node.left, node.lineno)
        self.generic_visit(node)


class ConfigRegistryAnalyzer:
    name = "config-registry"

    RULES = {
        "config-unregistered-env":
            "BQUERYD_TPU_* env var touched in code but absent from "
            "ENV_REGISTRY",
        "config-undocumented":
            "registered env var missing from the README config table",
        "config-readme-unknown":
            "README names a BQUERYD_TPU_* var that is not registered",
        "config-dead-var":
            "registered env var referenced nowhere in package source",
        "config-import-time-read":
            "var declared read_time='call' (live-tunable) is read at module "
            "scope, latching its value at import",
        "config-external-env":
            "read of a non-BQUERYD env var outside the external allowlist",
        "config-dynamic-env-key":
            "env access with a non-literal key (opaque to the registry lint)",
        "config-name-collision":
            "registered names where one extends the other without a "
            "related= cross-reference",
    }

    def __init__(self, registry=None, external_allowed=None):
        self.registry = ENV_REGISTRY if registry is None else registry
        self.external = (
            EXTERNAL_ENV_ALLOWED if external_allowed is None
            else frozenset(external_allowed)
        )

    def run(self, project):
        findings = []
        referenced = set()   # registered names seen anywhere in source text
        seen_keys = set()    # env keys actually touched via the env APIs

        for sf in project.files:
            if sf.tree is None:
                continue
            is_registry_module = sf.relpath.endswith("analysis/configreg.py")
            if not is_registry_module:
                # exact tokens, not substrings: a reference to FOO_BYTES
                # must not keep FOO alive
                file_tokens = set(_TOKEN_RE.findall(sf.text))
                referenced |= file_tokens & set(self.registry)
            visitor = _EnvReadVisitor()
            visitor.visit(sf.tree)
            for key, lineno, at_module, scope in visitor.sites:
                if key is None:
                    # symbol anchors on the enclosing scope, not the line:
                    # fingerprints (and hence baselines) must survive
                    # unrelated edits above the site
                    findings.append(Finding(
                        "config-dynamic-env-key", sf.relpath, lineno,
                        "env access with a non-literal key — the registry "
                        "lint cannot see which vars flow through here",
                        symbol=f"dynamic:{scope}",
                    ))
                    continue
                if not key.startswith(ENV_PREFIX):
                    if key not in self.external:
                        findings.append(Finding(
                            "config-external-env", sf.relpath, lineno,
                            f"reads env var {key!r} not in the external "
                            "allowlist (EXTERNAL_ENV_ALLOWED)",
                            symbol=key,
                        ))
                    continue
                seen_keys.add(key)
                var = self.registry.get(key)
                if var is None:
                    findings.append(Finding(
                        "config-unregistered-env", sf.relpath, lineno,
                        f"{key} is read here but not declared in "
                        "analysis.configreg.ENV_REGISTRY",
                        symbol=key,
                    ))
                    continue
                if at_module and var.read_time == READ_CALL:
                    findings.append(Finding(
                        "config-import-time-read", sf.relpath, lineno,
                        f"{key} is declared live-tunable "
                        "(read_time='call') but read at module scope — "
                        "the value latches at import",
                        symbol=key,
                    ))

        readme = project.readme_text
        readme_file = "README.md"
        # readme_text is None when the file is absent — the framework
        # reports that once (analysis-missing-readme); per-var findings
        # here would just be noise on top
        readme_present = readme is not None
        readme_tokens = set(_TOKEN_RE.findall(readme or ""))
        for name, var in self.registry.items():
            if readme_present and name not in readme_tokens:
                findings.append(Finding(
                    "config-undocumented", readme_file, 0,
                    f"{name} is registered but missing from the README "
                    "config table",
                    symbol=name,
                ))
            if name not in referenced:
                findings.append(Finding(
                    "config-dead-var",
                    f"{project.package}/analysis/configreg.py", 0,
                    f"{name} is registered but referenced nowhere in "
                    "package source — remove it or its reader came back "
                    "unregistered",
                    symbol=name,
                ))

        # README tokens that look like config vars but aren't registered
        for token in sorted(readme_tokens):
            if token not in self.registry:
                findings.append(Finding(
                    "config-readme-unknown", readme_file, 0,
                    f"README documents {token} which is not in ENV_REGISTRY",
                    symbol=token,
                ))

        # prefix near-collisions must be cross-referenced
        names = sorted(self.registry)
        for a in names:
            for b in names:
                if b.startswith(a + "_") and a != b:
                    va, vb = self.registry[a], self.registry[b]
                    if b not in va.related or a not in vb.related:
                        findings.append(Finding(
                            "config-name-collision",
                            f"{project.package}/analysis/configreg.py", 0,
                            f"{a} vs {b}: one name extends the other; "
                            "declare related= on both (with help text that "
                            "distinguishes them) or rename",
                            symbol=f"{a}~{b}",
                        ))
        return findings
