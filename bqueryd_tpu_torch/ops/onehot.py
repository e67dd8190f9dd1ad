"""The groupby one-hot contraction: wrappers around the two CUDA kernels of
``csrc/onehot_groupby.cu``, their plain PyTorch versions and their build.

The contraction reduces stacked bf16 rows (a count row, 8-bit limbs of
biased ints, a 3-limb bf16 split of float32 values) against the one-hot of
the group codes: ``out[.., r, g] = sum_k rows[r, k] * (codes[k] == g)``.

* :func:`onehot_rows_dot` replaces ``bqueryd_tpu/ops/pallas_groupby.py``
  ``onehot_rows_dot`` (kernel body ``_make_kernel``): one float32 partial
  per block of :data:`BLOCK_K` rows, ``f32[nb, R16, G128]``.
* :func:`onehot_rows_dot_hicard` replaces ``onehot_rows_dot_hicard``
  (kernel body ``_make_hicard_kernel``): the whole row range reduced mod
  2^32, ``uint32[R16, Gpad]``, int rows only, ``n <= HICARD_MAX_ROWS``.

Both keep the TPU kernels' conventions: codes outside ``[0, G)`` (the
folded -1 of filtered or null-key rows) contribute nowhere, and the output
is rounded up to ``R16`` rows and ``G128`` (base) or ``Gpad`` (a multiple of
:data:`HICARD_GROUP_PAD`, hicard) groups, which callers slice off.

Each wrapper takes its plain version only because its tensors lie on the
CPU; on a CUDA tensor it launches the kernel or raises.  Both kernels are
bound by the bytes they stream (rows and codes, read once); the source
note in ``csrc/onehot_groupby.cu`` says what each design does about it.
``<wrapper>.launches`` counts kernel launches and nothing else.
"""

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

#: dynamic shared memory a base-kernel CTA may use (of 227 KB on Hopper)
_SMEM_BUDGET = 200 * 1024

#: warps per base-kernel CTA, and so the most private table copies
_WARPS = 8

#: hicard grid size cap (grid-stride loop beyond it)
_HICARD_MAX_BLOCKS = 132 * 16

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
            lib.onehot_rows_dot_launch.restype = i32
            lib.onehot_rows_dot_launch.argtypes = [
                ptr, ptr, ptr, i64, i32, i32, i32, i32, i32, ptr,
            ]
            lib.onehot_rows_dot_hicard_launch.restype = i32
            lib.onehot_rows_dot_hicard_launch.argtypes = [
                ptr, ptr, ptr, i64, i32, i32, i32, ptr,
            ]
            _lib = lib
        return _lib


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
    if codes.device.type == "cuda" and not (
        codes.is_contiguous() and rows.is_contiguous()
    ):
        raise ValueError("the CUDA kernels take contiguous codes and rows")
    return n


def _launch_error(name, rc):
    return RuntimeError(f"{name} launch failed: cudaError_t {rc}")


def _base_tiling(n_rows, g_pad):
    """(group tile, private table copies) of a base-kernel CTA: the widest
    group tile (a multiple of 32, tiles of even width) whose float32
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
    nb = max(1, -(-n // BLOCK_K))
    rpad, gpad = _round_up(n_rows, _SUBLANE), _round_up(n_groups, _LANE)
    out = torch.zeros(nb, rpad, gpad, dtype=torch.float32, device=codes.device)
    if n == 0:
        return out
    g_tile, copies = _base_tiling(n_rows, gpad)
    lib = _library()
    with torch.cuda.device(codes.device):
        rc = lib.onehot_rows_dot_launch(
            codes.data_ptr(), rows.data_ptr(), out.data_ptr(), n, n_rows,
            rpad, gpad, g_tile, copies,
            torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise _launch_error("onehot_rows_dot", rc)
    onehot_rows_dot.launches += 1
    return out


onehot_rows_dot.launches = 0


def _check_hicard_rows(n):
    if n > HICARD_MAX_ROWS:
        raise ValueError(
            f"n={n} exceeds HICARD_MAX_ROWS={HICARD_MAX_ROWS}: a limb "
            "total could wrap twice; split the call or use the sort path"
        )


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
    rpad = _round_up(n_rows, _SUBLANE)
    gpad = _round_up(n_groups, HICARD_GROUP_PAD)
    out = torch.zeros(rpad, gpad, dtype=torch.int32, device=codes.device)
    if n == 0:
        return out.view(torch.uint32)
    blocks = max(1, min(-(-n // 256), _HICARD_MAX_BLOCKS))
    lib = _library()
    with torch.cuda.device(codes.device):
        rc = lib.onehot_rows_dot_hicard_launch(
            codes.data_ptr(), rows.data_ptr(), out.data_ptr(), n, n_rows,
            gpad, blocks, torch.cuda.current_stream().cuda_stream,
        )
    if rc != 0:
        raise _launch_error("onehot_rows_dot_hicard", rc)
    onehot_rows_dot_hicard.launches += 1
    return out.view(torch.uint32)


onehot_rows_dot_hicard.launches = 0


def reset_launch_counts():
    onehot_rows_dot.launches = 0
    onehot_rows_dot_hicard.launches = 0
