"""ctypes bindings for libtpucolz (native codec + column decoder).

A copy of ``bqueryd_tpu/storage/native.py`` reduced to what the port's
storage layer calls: chunk encode/decode and the int64 factorizer.  The
library is built from the repository's ``native/`` sources into
``native/build/libtpucolz.so`` on first use and stays optional: every entry
point has a pure NumPy/zlib fallback in :mod:`bqueryd_tpu_torch.storage.codec`.
"""

import ctypes
import os

import numpy as np

TPC_RAW = 0
TPC_LZ4 = 1
TPC_ZLIB = 2

_lib = None
_searched = False


def _candidate_paths():
    here = os.path.dirname(os.path.abspath(__file__))
    repo = os.path.dirname(os.path.dirname(here))
    yield os.path.join(repo, "native", "build", "libtpucolz.so")


def _try_build():
    """One-shot build of the native lib from ``native/build.sh``."""
    here = os.path.dirname(os.path.abspath(__file__))
    repo = os.path.dirname(os.path.dirname(here))
    script = os.path.join(repo, "native", "build.sh")
    if not os.path.exists(script):
        return
    import subprocess

    try:
        subprocess.run(
            ["/bin/sh", script], capture_output=True, timeout=120, check=True
        )
    except Exception:
        pass


def get_lib():
    """Load (and memoize) the native library; returns None if unavailable."""
    global _lib, _searched
    if _lib is not None or _searched:
        return _lib
    _searched = True
    paths = list(_candidate_paths())
    if not any(os.path.exists(p) for p in paths):
        _try_build()
    for path in paths:
        if not os.path.exists(path):
            continue
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            continue
        lib.tpc_max_csize.restype = ctypes.c_size_t
        lib.tpc_max_csize.argtypes = [ctypes.c_size_t]
        lib.tpc_encode.restype = ctypes.c_size_t
        lib.tpc_encode.argtypes = [
            ctypes.c_char_p,
            ctypes.c_size_t,
            ctypes.c_size_t,
            ctypes.c_int32,
            ctypes.c_void_p,
            ctypes.c_size_t,
        ]
        lib.tpc_decode.restype = ctypes.c_size_t
        lib.tpc_decode.argtypes = [
            ctypes.c_char_p,
            ctypes.c_size_t,
            ctypes.c_size_t,
            ctypes.c_size_t,
            ctypes.c_int32,
            ctypes.c_void_p,
        ]
        lib.tpc_decode_column.restype = ctypes.c_int32
        lib.tpc_decode_column.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.c_size_t,
            ctypes.c_size_t,
            ctypes.c_int32,
            ctypes.c_void_p,
            ctypes.c_int32,
        ]
        lib.tpc_factorize_i64.restype = ctypes.c_int64
        lib.tpc_factorize_i64.argtypes = [
            ctypes.c_void_p,
            ctypes.c_size_t,
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_size_t,
        ]
        _lib = lib
        break
    return _lib


def available():
    return get_lib() is not None


def encode(payload: bytes, elem_size: int, codec: int) -> bytes:
    lib = get_lib()
    cap = lib.tpc_max_csize(len(payload))
    dst = ctypes.create_string_buffer(cap)
    csize = lib.tpc_encode(payload, len(payload), elem_size, codec, dst, cap)
    if csize == 0:
        raise RuntimeError("tpc_encode failed")
    return dst.raw[:csize]


def decode(buf: bytes, usize: int, elem_size: int, codec: int) -> bytes:
    lib = get_lib()
    dst = ctypes.create_string_buffer(usize)
    got = lib.tpc_decode(buf, len(buf), usize, elem_size, codec, dst)
    if got != usize:
        raise RuntimeError("tpc_decode failed (corrupt chunk?)")
    return dst.raw


def decode_column(file_buf, offsets, usizes, elem_size, codec, out, nthreads):
    """Decode all chunks of a column in parallel into ``out`` (a writable
    contiguous ndarray viewed as bytes).  ``offsets`` has nchunks+1 entries."""
    lib = get_lib()
    nchunks = len(usizes)
    off = np.ascontiguousarray(offsets, dtype=np.uint64)
    usz = np.ascontiguousarray(usizes, dtype=np.uint64)
    ok = lib.tpc_decode_column(
        file_buf,
        off.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        usz.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        nchunks,
        elem_size,
        codec,
        out.ctypes.data,
        nthreads,
    )
    if not ok:
        raise RuntimeError("tpc_decode_column failed (corrupt column?)")


def factorize_i64(values: np.ndarray):
    """Dense-code an int64 array in first-seen order: returns (codes int32,
    uniques int64)."""
    lib = get_lib()
    values = np.ascontiguousarray(values, dtype=np.int64)
    n = len(values)
    codes = np.empty(n, dtype=np.int32)
    uniques = np.empty(n if n else 1, dtype=np.int64)
    nuniq = lib.tpc_factorize_i64(
        values.ctypes.data, n, codes.ctypes.data, uniques.ctypes.data, max(n, 1)
    )
    if nuniq < 0:
        raise RuntimeError("tpc_factorize_i64 capacity exceeded")
    return codes, uniques[:nuniq].copy()
