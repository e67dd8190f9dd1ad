"""The groupby one-hot contraction: wrappers around the CUDA kernels of
``csrc/onehot_groupby.cu``, their plain PyTorch versions, the shape plans
that choose each kernel's branch, and the build.

The contraction reduces stacked bf16 rows (a count row, 8-bit limbs of
biased ints, a 3-limb bf16 split of float32 values) against the one-hot of
the group codes: ``out[.., r, g] = sum_k rows[r, k] * (codes[k] == g)``.

* :func:`onehot_rows_dot` replaces ``bqueryd_tpu/ops/pallas_groupby.py``
  ``onehot_rows_dot`` (kernel body ``_make_kernel``): one float32 partial
  per block of :data:`BLOCK_K` rows, ``f32[nb, R16, G128]``.  Branch
  ``"mma"`` (up to :data:`MMA_GROUPS_LIMIT` groups) is a tensor-core one-hot
  product reduced across a thread-block cluster, deterministic from run to
  run; branch ``"table"`` a shared-memory table for more groups.
* :func:`onehot_rows_dot_hicard` replaces ``onehot_rows_dot_hicard``
  (kernel body ``_make_hicard_kernel``): the whole row range reduced mod
  2^32, ``uint32[R16, Gpad]``, int rows only, ``n <= HICARD_MAX_ROWS``.
  Branch ``"cluster"`` holds the group table in the distributed shared
  memory of 16-CTA clusters; branch ``"global"`` (tables too big for that)
  adds into a global table with atomics.

Both keep the TPU kernels' conventions: codes outside ``[0, G128)`` (base)
or ``[0, Gpad)`` (hicard) -- among them the folded -1 of filtered or
null-key rows -- contribute nowhere, and the output is rounded up to
``R16`` rows and ``G128`` (base) or ``Gpad`` (a multiple of
:data:`HICARD_GROUP_PAD`, hicard) groups, which callers slice off.

On the card the row operand is a ``[R, n]`` view whose row stride ``ld`` is
a multiple of 8 elements (16 bytes), as :func:`padded_width` gives it; codes
are contiguous; both start 16-byte aligned.  :func:`_base_plan` and
:func:`_hicard_plan` choose a branch from ``(n_rows, n_groups, n)`` alone.

Each wrapper takes its plain version only because its tensors lie on the
CPU; on a CUDA tensor it launches a kernel branch or raises.
``<wrapper>.launches`` counts kernel launches and nothing else;
:data:`LAUNCHES` splits them by (kernel, branch, n_rows, n_groups, n).
"""

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

#: rows per output block of the base kernel: a block's sum of 8-bit limbs
#: stays below 32768 * 255 < 2^24, so its float32 partial is exact
BLOCK_K = 32768

#: output row padding (the TPU kernels' bf16 sublane tile)
_SUBLANE = 16

#: output group padding of the base kernel
_LANE = 128

#: output group padding of the hicard kernel (the TPU kernel's group tile)
HICARD_GROUP_PAD = 2048

#: uint32 accumulator bound: every 8-bit limb row's TOTAL sum must stay
#: below 2^32, so a longer call must be split or take another route
HICARD_MAX_ROWS = (1 << 32) // 256

#: shared memory one CTA can use on Hopper (227 KB)
SMEM_LIMIT = 232_448

#: shared memory a table of the "table" (base) or "cluster" (hicard)
#: branch may take
_SMEM_BUDGET = 200 * 1024

#: warps per table-branch CTA, and so the most private table copies
_WARPS = 8

#: SMs of an H100
_SMS = 132

#: groups up to which onehot_rows_dot takes its tensor-core branch; past
#: it the shared-memory table branch (crossover measured by chip_smoke.py's
#: G sweep, PERF.md)
MMA_GROUPS_LIMIT = 32

#: n-tile counts (8 groups each) the "mma" branch is compiled for
_MMA_NTILES = (1, 2, 4, 8, 16, 32)

#: "mma" branch: CTAs per cluster (one cluster per BLOCK_K rows) and
#: threads per CTA (kMmaThreads in the kernel)
_MMA_CLUSTER = 8
_MMA_THREADS = 256

#: CTAs per hicard cluster (a non-portable cluster size)
HICARD_CLUSTER = 16

#: preferred number C of hicard clusters (chip_smoke.py's C sweep,
#: PERF.md); a larger C is taken when the table does not fit
HICARD_CLUSTERS = 8

#: cluster counts the "cluster" branch may take: C * 16 <= 132 SMs
_HICARD_CLUSTER_CHOICES = (2, 4, 8)

#: "global" hicard branch grid size cap (grid-stride loop beyond it)
_HICARD_MAX_BLOCKS = _SMS * 16

#: launches per (kernel, branch, n_rows, n_groups, n)
LAUNCHES = collections.Counter()

#: every (kernel, branch, n_rows, n_groups) launched in this process, and
#: the library loads: never reset (see :func:`build_marker`)
_SHAPES_SEEN = set()
_LOADS = [0]

BasePlan = collections.namedtuple(
    "BasePlan",
    "branch grid cluster smem ntiles g_tile copies ld",
)
HicardPlan = collections.namedtuple(
    "HicardPlan", "branch grid cluster smem clusters ld",
)

_PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PACKAGE_DIR, "csrc", "onehot_groupby.cu")
BUILD_DIR = os.path.join(os.path.dirname(_PACKAGE_DIR), "build", "kernels")

_lib = None
_lib_lock = threading.Lock()


def _round_up(x, mult):
    return -(-x // mult) * mult


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build():
    """Compile ``csrc/onehot_groupby.cu`` for sm_90a into
    ``build/kernels/`` (once per source content) and return the library
    path.  Needs ``nvcc``; never runs at import time."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    path = os.path.join(BUILD_DIR, f"libonehot_groupby_{digest}.so")
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
        "-o", tmp, SOURCE,
    ]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, path)
    build.ptxas_report = proc.stderr
    return path


build.ptxas_report = ""


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
            signatures = {
                "onehot_mma_launch": [ptr, ptr, ptr, i64, i64, i32, i32, i32,
                                      i32, i32, i32, ptr],
                "onehot_table_launch": [ptr, ptr, ptr, i64, i64, i32, i32,
                                        i32, i32, i32, ptr],
                "hicard_cluster_launch": [ptr, ptr, ptr, i64, i64, i32, i32,
                                          i32, i32, i32, ptr],
                "hicard_global_launch": [ptr, ptr, ptr, i64, i64, i32, i32,
                                         i32, ptr],
                "hicard_max_active_clusters": [i32, ctypes.POINTER(i32)],
            }
            for name, argtypes in signatures.items():
                fn = getattr(lib, name)
                fn.restype = i32
                fn.argtypes = argtypes
            _lib = lib
            _LOADS[0] += 1
        return _lib


def build_marker():
    """``(library loads, shapes launched)``: a timing window whose marker
    changed built or loaded the kernels, or launched a (kernel, branch, R,
    G) shape for the first time, so its wall is not a sample of the route
    (the counterpart of a JAX compile in the reference's calibration)."""
    return (_LOADS[0], len(_SHAPES_SEEN))


def padded_width(n):
    """Row stride, in elements, of a stacked ``[R, n]`` row operand: ``n``
    rounded up to 8 bf16 values, so that every row starts 16-byte aligned
    (the kernels read 8 values at a time with 16-byte loads)."""
    return _round_up(max(int(n), 1), 8)


def _row_stride(rows):
    """``ld`` of a ``[R, n]`` row operand (any stride serves one row)."""
    if rows.shape[0] > 1:
        return rows.stride(0)
    return padded_width(rows.shape[1])


def _check_inputs(codes, rows, n_rows):
    if codes.dtype != torch.int32 or codes.dim() != 1:
        raise TypeError(f"codes must be int32[n], got {codes.dtype} "
                        f"{tuple(codes.shape)}")
    n = codes.shape[0]
    if rows.dtype != torch.bfloat16 or tuple(rows.shape) != (n_rows, n):
        raise TypeError(f"rows must be bf16[{n_rows}, {n}], got {rows.dtype} "
                        f"{tuple(rows.shape)}")
    if rows.device != codes.device:
        raise ValueError("codes and rows must be on the same device")
    if codes.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {codes.device}")
    if codes.device.type == "cuda" and n:
        ld = _row_stride(rows)
        if not codes.is_contiguous() or (n > 1 and rows.stride(1) != 1):
            raise ValueError("the CUDA kernels take contiguous codes and "
                             "rows with unit element stride")
        if ld % 8 or ld < n:
            raise ValueError(
                f"rows' row stride {ld} must be a multiple of 8 elements "
                f"and at least n={n}: stack into [R, padded_width(n)]"
            )
        if codes.data_ptr() % 16 or rows.data_ptr() % 16:
            raise ValueError("the CUDA kernels take 16-byte aligned codes "
                             "and rows")
    return n


def _launch_error(name, rc):
    return RuntimeError(f"{name} launch failed: cudaError_t {rc}")


def _count(wrapper, branch, n_rows, n_groups, n):
    wrapper.launches += 1
    _SHAPES_SEEN.add((wrapper.__name__, branch, int(n_rows), int(n_groups)))
    LAUNCHES[(wrapper.__name__, branch, int(n_rows), int(n_groups),
              int(n))] += 1


def _base_tiling(n_rows, g_pad):
    """(group tile, private table copies) of a table-branch CTA: the
    widest group tile (a multiple of 32, tiles of even width) whose float32
    [n_rows, tile] table fits the shared-memory budget, then as many
    per-warp copies of it as still fit."""
    per_group = n_rows * 4
    max_tile = (_SMEM_BUDGET // per_group) // 32 * 32
    if max_tile < 32:
        raise ValueError(
            f"n_rows={n_rows} stacked rows do not fit the base kernel's "
            "shared-memory table"
        )
    tiles = -(-g_pad // max_tile)
    g_tile = _round_up(-(-g_pad // tiles), 32)
    copies = max(1, min(_WARPS, _SMEM_BUDGET // (per_group * g_tile)))
    return g_tile, copies


def _mma_ntiles(n_groups):
    """The compiled n-tile count covering ``n_groups``, or None."""
    need = -(-max(int(n_groups), 1) // 8)
    for nt in _MMA_NTILES:
        if nt >= need:
            return nt
    return None


def _mma_smem(g_pad):
    """Shared memory of an "mma" CTA: its [16][g_pad] float32 table and a
    [16][8] float32 fragment per warp for the fold."""
    return (_SUBLANE * g_pad + (_MMA_THREADS // 32) * 128) * 4


def _base_plan(n_rows, n_groups, n, branch=None):
    """How :func:`onehot_rows_dot` runs ``n`` rows of ``n_rows`` stacked
    rows against ``n_groups`` groups: a pure function of the shape.

    ``"mma"`` up to :data:`MMA_GROUPS_LIMIT` groups (where a compiled
    n-tile count covers them inside G128), else ``"table"``.  ``branch``
    forces one branch (a sweep); it raises where that branch cannot run."""
    n_rows, n_groups, n = int(n_rows), int(n_groups), int(n)
    nb = max(1, -(-n // BLOCK_K))
    rpad, gpad = _round_up(n_rows, _SUBLANE), _round_up(n_groups, _LANE)
    ld = padded_width(n)
    ntiles = _mma_ntiles(n_groups)
    mma_ok = ntiles is not None and ntiles * 8 <= gpad
    if branch is None:
        branch = ("mma" if mma_ok and n_groups <= MMA_GROUPS_LIMIT
                  else "table")
    if branch == "mma":
        if not mma_ok:
            raise ValueError(f"the mma branch cannot run {n_groups} groups "
                             f"over {n} rows")
        return BasePlan("mma", (nb * _MMA_CLUSTER, rpad // _SUBLANE),
                        _MMA_CLUSTER, _mma_smem(gpad), ntiles, None, None,
                        ld)
    if branch != "table":
        raise ValueError(f"unknown onehot_rows_dot branch {branch!r}")
    g_tile, copies = _base_tiling(n_rows, gpad)
    return BasePlan("table", (nb * 8, -(-gpad // g_tile)), 1,
                    copies * n_rows * g_tile * 4, None, g_tile, copies, ld)


def onehot_rows_dot_plain(codes, rows, n_rows, n_groups):
    """Plain PyTorch version of :func:`onehot_rows_dot`: a per-block
    ``index_add_`` into float32."""
    n = codes.shape[0]
    nb = max(1, -(-n // BLOCK_K))
    rpad, gpad = _round_up(n_rows, _SUBLANE), _round_up(n_groups, _LANE)
    c = codes.to(torch.int64)
    k = torch.nonzero((c >= 0) & (c < gpad)).squeeze(1)
    slot = (k // BLOCK_K) * gpad + c[k]
    acc = torch.zeros(nb * gpad, n_rows, dtype=torch.float32,
                      device=codes.device)
    acc.index_add_(0, slot, rows[:, k].t().to(torch.float32))
    out = torch.zeros(nb, rpad, gpad, dtype=torch.float32, device=codes.device)
    out[:, :n_rows, :] = acc.view(nb, gpad, n_rows).permute(0, 2, 1)
    return out


def onehot_rows_dot(codes, rows, n_rows, n_groups):
    """``out[b, r, g] = sum_k rows[r, b*K+k] * (codes[b*K+k] == g)``.

    codes: int32[n] folded group codes (negative = contributes nowhere)
    rows:  bf16[R, n] stacked reduction rows (R == n_rows)
    Returns float32[nb, R16, G128] with ``nb = max(1, ceil(n / BLOCK_K))``;
    callers slice ``[:, :R, :G]``."""
    n = _check_inputs(codes, rows, n_rows)
    if codes.device.type == "cpu":
        return onehot_rows_dot_plain(codes, rows, n_rows, n_groups)
    return _launch_base(codes, rows, n_rows, n_groups,
                        _base_plan(n_rows, n_groups, n))


def _launch_base(codes, rows, n_rows, n_groups, plan):
    """Launch :func:`onehot_rows_dot`'s kernel branch ``plan.branch`` on
    CUDA tensors already checked by :func:`_check_inputs`."""
    n = codes.shape[0]
    nb = max(1, -(-n // BLOCK_K))
    rpad, gpad = _round_up(n_rows, _SUBLANE), _round_up(n_groups, _LANE)
    if n == 0:
        return torch.zeros(nb, rpad, gpad, dtype=torch.float32,
                           device=codes.device)
    # the mma branch writes every element; the table branch adds into zeros
    alloc = torch.empty if plan.branch == "mma" else torch.zeros
    out = alloc(nb, rpad, gpad, dtype=torch.float32, device=codes.device)
    lib = _library()
    ld = _row_stride(rows)
    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream().cuda_stream
        if plan.branch == "mma":
            rc = lib.onehot_mma_launch(
                codes.data_ptr(), rows.data_ptr(), out.data_ptr(), n, ld,
                n_rows, rpad, gpad, plan.ntiles, plan.cluster, plan.smem,
                stream,
            )
        else:
            rc = lib.onehot_table_launch(
                codes.data_ptr(), rows.data_ptr(), out.data_ptr(), n, ld,
                n_rows, rpad, gpad, plan.g_tile, plan.copies, stream,
            )
    if rc != 0:
        raise _launch_error(f"onehot_rows_dot ({plan.branch})", rc)
    _count(onehot_rows_dot, plan.branch, n_rows, n_groups, n)
    return out


onehot_rows_dot.launches = 0


def _check_hicard_rows(n):
    if n > HICARD_MAX_ROWS:
        raise ValueError(
            f"n={n} exceeds HICARD_MAX_ROWS={HICARD_MAX_ROWS}: a limb "
            "total could wrap twice; split the call or use the sort path"
        )


def _hicard_plan(n_rows, n_groups, n, clusters=None, branch=None):
    """How :func:`onehot_rows_dot_hicard` runs: a pure function of the
    shape.  ``"cluster"`` with the smallest C >= :data:`HICARD_CLUSTERS`
    whose per-CTA table ``n_rows * Gpad / (16 C)`` uint32 fits the
    shared-memory budget, else ``"global"``.  ``clusters`` forces C and
    ``branch="global"`` the global branch (sweeps); a forced C raises where
    it cannot hold the table."""
    n_rows, n_groups, n = int(n_rows), int(n_groups), int(n)
    gpad = _round_up(n_groups, HICARD_GROUP_PAD)
    ld = padded_width(n)
    if branch not in (None, "cluster", "global"):
        raise ValueError(f"unknown onehot_rows_dot_hicard branch {branch!r}")
    if clusters is not None:
        choices = (int(clusters),)
    elif branch == "global":
        choices = ()
    else:
        choices = tuple(c for c in _HICARD_CLUSTER_CHOICES
                        if c >= HICARD_CLUSTERS)
    for c in choices:
        smem = n_rows * (gpad // (HICARD_CLUSTER * c)) * 4
        if c in _HICARD_CLUSTER_CHOICES and smem <= _SMEM_BUDGET:
            return HicardPlan("cluster", (HICARD_CLUSTER * c,),
                              HICARD_CLUSTER, smem, c, ld)
    if clusters is not None or branch == "cluster":
        raise ValueError(f"no hicard cluster count holds {n_rows} x {gpad} "
                         "groups")
    blocks = max(1, min(-(-n // (256 * 8)), _HICARD_MAX_BLOCKS))
    return HicardPlan("global", (blocks,), 1, 0, 0, ld)


def onehot_rows_dot_hicard_plain(codes, rows, n_rows, n_groups):
    """Plain PyTorch version of :func:`onehot_rows_dot_hicard`: one int64
    ``index_add_`` over the full row range, reduced mod 2^32."""
    _check_hicard_rows(codes.shape[0])
    rpad = _round_up(n_rows, _SUBLANE)
    gpad = _round_up(n_groups, HICARD_GROUP_PAD)
    c = codes.to(torch.int64)
    k = torch.nonzero((c >= 0) & (c < gpad)).squeeze(1)
    acc = torch.zeros(gpad, n_rows, dtype=torch.int64, device=codes.device)
    acc.index_add_(0, c[k], rows[:, k].t().to(torch.float32).to(torch.int64))
    wrapped = acc & 0xFFFFFFFF
    wrapped = torch.where(wrapped >= 1 << 31, wrapped - (1 << 32), wrapped)
    out = torch.zeros(rpad, gpad, dtype=torch.int32, device=codes.device)
    out[:n_rows] = wrapped.t().to(torch.int32)
    return out.view(torch.uint32)


def onehot_rows_dot_hicard(codes, rows, n_rows, n_groups):
    """High-cardinality variant: ``out[r, g] = sum_k rows[r, k] *
    (codes[k] == g)`` over all rows, accumulated mod 2^32.

    INT rows only (count flags and 8-bit limbs); raises ``ValueError`` past
    :data:`HICARD_MAX_ROWS` rows.  Returns uint32[R16, Gpad] (Gpad = G
    rounded up to :data:`HICARD_GROUP_PAD`); callers slice ``[:R, :G]`` and
    zero-extend."""
    n = _check_inputs(codes, rows, n_rows)
    if codes.device.type == "cpu":
        return onehot_rows_dot_hicard_plain(codes, rows, n_rows, n_groups)
    _check_hicard_rows(n)
    return _launch_hicard(codes, rows, n_rows, n_groups,
                          _hicard_plan(n_rows, n_groups, n))


def _launch_hicard(codes, rows, n_rows, n_groups, plan):
    """Launch :func:`onehot_rows_dot_hicard`'s kernel branch
    ``plan.branch`` on CUDA tensors already checked."""
    n = codes.shape[0]
    rpad = _round_up(n_rows, _SUBLANE)
    gpad = _round_up(n_groups, HICARD_GROUP_PAD)
    if n == 0:
        return torch.zeros(rpad, gpad, dtype=torch.int32,
                           device=codes.device).view(torch.uint32)
    # the cluster branch writes every element; the global one adds into 0
    alloc = torch.empty if plan.branch == "cluster" else torch.zeros
    out = alloc(rpad, gpad, dtype=torch.int32, device=codes.device)
    lib = _library()
    ld = _row_stride(rows)
    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream().cuda_stream
        if plan.branch == "cluster":
            rc = lib.hicard_cluster_launch(
                codes.data_ptr(), rows.data_ptr(), out.data_ptr(), n, ld,
                n_rows, rpad, gpad, plan.clusters, plan.smem, stream,
            )
        else:
            rc = lib.hicard_global_launch(
                codes.data_ptr(), rows.data_ptr(), out.data_ptr(), n, ld,
                n_rows, gpad, plan.grid[0], stream,
            )
    if rc != 0:
        raise _launch_error(f"onehot_rows_dot_hicard ({plan.branch})", rc)
    _count(onehot_rows_dot_hicard, plan.branch, n_rows, n_groups, n)
    return out.view(torch.uint32)


onehot_rows_dot_hicard.launches = 0


def hicard_max_active_clusters(smem):
    """How many 16-CTA hicard clusters with ``smem`` bytes of shared memory
    per CTA the card can hold at once (a diagnostic; needs the card)."""
    count = ctypes.c_int(0)
    rc = _library().hicard_max_active_clusters(int(smem), ctypes.byref(count))
    if rc != 0:
        raise _launch_error("hicard_max_active_clusters", rc)
    return count.value


def reset_launch_counts():
    onehot_rows_dot.launches = 0
    onehot_rows_dot_hicard.launches = 0
    LAUNCHES.clear()
