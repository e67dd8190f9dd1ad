"""ctypes bindings for libtpucolz (native codec + column decoder).

A copy of ``bqueryd_tpu/storage/native.py`` reduced to what the port
calls: chunk encode/decode, the int64 factorizer, the striped host
groupby kernels of the host route (:func:`groupby_i64`,
:func:`groupby_f64`, :func:`groupby_minmax`) and the Blosc v1 chunk
decoder of the bcolz v1 import (:func:`blosc_decode`).  The library is
loaded from ``BQUERYD_TPU_NATIVE_LIB`` when that names one, else built from
the repository's ``native/`` sources into ``native/build/libtpucolz.so`` on
first use, once for the tree however many processes ask (:func:`_build`);
it stays optional: every entry point has a pure NumPy/zlib
fallback in :mod:`bqueryd_tpu_torch.storage.codec`.
"""

import ctypes
import os

import numpy as np

TPC_RAW = 0
TPC_LZ4 = 1
TPC_ZLIB = 2

_lib = None
_searched = False
_has_groupby = False
_has_groupby_minmax = False
_has_blosc = False

_NATIVE_DIR = os.path.normpath(os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..", "native"))
_LIB_NAME = "libtpucolz.so"
#: what ``native/build.sh`` reads, copied for each private build
_SOURCES = ("build.sh", "CMakeLists.txt", "tpucolz.cpp")


def _candidate_paths():
    """``BQUERYD_TPU_NATIVE_LIB`` first when set, then the build tree."""
    env = os.environ.get("BQUERYD_TPU_NATIVE_LIB")
    if env:
        yield env
    yield os.path.join(_NATIVE_DIR, "build", _LIB_NAME)


def _build(native_dir=_NATIVE_DIR):
    """Build ``native_dir/build/libtpucolz.so`` once for the tree.

    Under an exclusive ``flock`` on ``build/.lock``, a process that finds
    no library copies the sources into a private directory under
    ``build/``, runs that copy's ``build.sh`` and moves the result into
    place with ``os.replace``; the processes that lose the race wait on
    the lock and find the published file.  Returns whether this call
    compiled it (False also when the build failed: no compiler, a
    read-only tree)."""
    import fcntl
    import shutil
    import subprocess
    import tempfile

    if not os.path.exists(os.path.join(native_dir, "build.sh")):
        return False
    out_dir = os.path.join(native_dir, "build")
    target = os.path.join(out_dir, _LIB_NAME)
    try:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, ".lock"), "a") as lock:
            # released when the file closes
            fcntl.flock(lock, fcntl.LOCK_EX)
            if os.path.exists(target):
                return False
            private = tempfile.mkdtemp(prefix="private-", dir=out_dir)
            try:
                for name in _SOURCES:
                    shutil.copy(os.path.join(native_dir, name), private)
                subprocess.run(
                    ["/bin/sh", os.path.join(private, "build.sh")],
                    capture_output=True, timeout=120, check=True,
                )
                os.replace(os.path.join(private, "build", _LIB_NAME), target)
            finally:
                shutil.rmtree(private, ignore_errors=True)
    except (OSError, subprocess.SubprocessError):
        return False
    return True


def get_lib():
    """Load (and memoize) the native library; returns None if unavailable.
    With no library on disk the locked :func:`_build` runs first, so a
    miss is saved only once that build left nothing that loads."""
    global _lib, _searched
    if _lib is not None or _searched:
        return _lib
    paths = list(_candidate_paths())
    if not any(os.path.exists(p) for p in paths):
        _build()
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
        _bind_groupby(lib)
        _bind_blosc(lib)
        _lib = lib
        break
    _searched = True
    return _lib


def _bind_groupby(lib):
    """Declare the host groupby kernels, each family probed on its own: a
    stale prebuilt library may carry the sum kernels but not min/max."""
    global _has_groupby, _has_groupby_minmax
    try:
        for name in ("tpc_groupby_minmax_i64", "tpc_groupby_minmax_f64"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int32
            fn.argtypes = [
                ctypes.c_void_p,  # codes int32*
                ctypes.c_void_p,  # values
                ctypes.c_void_p,  # mask uint8* (nullable)
                ctypes.c_size_t,  # n
                ctypes.c_int64,   # n_groups
                ctypes.c_void_p,  # mins
                ctypes.c_void_p,  # maxs
                ctypes.c_void_p,  # counts
                ctypes.c_int32,   # nthreads
            ]
        _has_groupby_minmax = True
    except AttributeError:
        _has_groupby_minmax = False
    try:
        for name in ("tpc_groupby_i64", "tpc_groupby_f64"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int32
            fn.argtypes = [
                ctypes.c_void_p,  # codes int32*
                ctypes.c_void_p,  # values (nullable)
                ctypes.c_void_p,  # mask uint8* (nullable)
                ctypes.c_size_t,  # n
                ctypes.c_int64,   # n_groups
                ctypes.c_void_p,  # sums (nullable for i64)
                ctypes.c_void_p,  # counts
                ctypes.c_int32,   # nthreads
            ]
        _has_groupby = True
    except AttributeError:
        _has_groupby = False


def _bind_blosc(lib):
    """Declare the Blosc v1 chunk decoder (legacy bcolz ``.blp`` files),
    probed on its own: an older library lacks it, and the bcolz v1 reader
    then takes its Python decoder."""
    global _has_blosc
    try:
        lib.tpc_blosc_info.restype = ctypes.c_int32
        lib.tpc_blosc_info.argtypes = [
            ctypes.c_char_p,
            ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.tpc_blosc_decode.restype = ctypes.c_size_t
        lib.tpc_blosc_decode.argtypes = [
            ctypes.c_char_p,
            ctypes.c_size_t,
            ctypes.c_void_p,
            ctypes.c_size_t,
        ]
        _has_blosc = True
    except AttributeError:
        _has_blosc = False


def available():
    return get_lib() is not None


def blosc_available():
    """True when the loaded library carries the Blosc v1 decoder."""
    return get_lib() is not None and _has_blosc


def blosc_info(buf: bytes):
    """Parse a Blosc v1 chunk header: ``(nbytes, typesize, flags)``."""
    lib = get_lib()
    nbytes = ctypes.c_int64()
    typesize = ctypes.c_int32()
    flags = ctypes.c_int32()
    if not lib.tpc_blosc_info(
        buf, len(buf),
        ctypes.byref(nbytes), ctypes.byref(typesize), ctypes.byref(flags),
    ):
        raise ValueError("not a Blosc v1 chunk")
    return nbytes.value, typesize.value, flags.value


def blosc_decode(buf: bytes, usize: int) -> bytes:
    """Decode one Blosc v1 chunk of ``usize`` bytes."""
    lib = get_lib()
    dst = ctypes.create_string_buffer(usize)
    got = lib.tpc_blosc_decode(buf, len(buf), dst, usize)
    if got != usize:
        raise ValueError("Blosc chunk decode failed (corrupt or unsupported)")
    return dst.raw


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


def groupby_available():
    """True when the loaded library carries the host groupby sum/count
    kernels (callers fall back to the NumPy paths otherwise)."""
    return get_lib() is not None and _has_groupby


def groupby_minmax_available():
    """True when the loaded library also carries the min/max kernels."""
    return get_lib() is not None and _has_groupby_minmax


def groupby_i64(codes, values, mask, n_groups, nthreads=0):
    """Per-group exact int64 sums (mod 2^64, any value magnitude) and
    counts.

    codes: int32[n] (negative = excluded); values: int64[n] or None (counts
    only); mask: bool[n] or None.  Returns (sums int64[n_groups] | None,
    counts int64[n_groups])."""
    lib = get_lib()
    codes = np.ascontiguousarray(codes, dtype=np.int32)
    n = len(codes)
    counts = np.empty(n_groups, dtype=np.int64)
    sums = None
    vptr = sptr = mptr = None
    if values is not None:
        values = np.ascontiguousarray(values, dtype=np.int64)
        sums = np.empty(n_groups, dtype=np.uint64)
        vptr, sptr = values.ctypes.data, sums.ctypes.data
    if mask is not None:
        mask = np.ascontiguousarray(mask, dtype=np.uint8)
        mptr = mask.ctypes.data
    rc = lib.tpc_groupby_i64(
        codes.ctypes.data, vptr, mptr, n, n_groups, sptr,
        counts.ctypes.data, nthreads,
    )
    if rc != 0:
        raise RuntimeError("tpc_groupby_i64 failed")
    return (None if sums is None else sums.view(np.int64)), counts


def groupby_f64(codes, values, mask, n_groups, nthreads=0, want_counts=True):
    """Per-group float64 sums with NaN skip; counts = present (non-NaN)
    rows.  The thread merge order is fixed, so results are deterministic
    for a given thread count but not bit-identical to NumPy's bincount."""
    lib = get_lib()
    codes = np.ascontiguousarray(codes, dtype=np.int32)
    values = np.ascontiguousarray(values, dtype=np.float64)
    n = len(codes)
    sums = np.empty(n_groups, dtype=np.float64)
    counts = np.empty(n_groups, dtype=np.int64) if want_counts else None
    mptr = None
    if mask is not None:
        mask = np.ascontiguousarray(mask, dtype=np.uint8)
        mptr = mask.ctypes.data
    rc = lib.tpc_groupby_f64(
        codes.ctypes.data, values.ctypes.data, mptr, n, n_groups,
        sums.ctypes.data,
        None if counts is None else counts.ctypes.data, nthreads,
    )
    if rc != 0:
        raise RuntimeError("tpc_groupby_f64 failed")
    return sums, counts


def groupby_minmax(codes, values, mask, n_groups, nthreads=0):
    """Per-group (min, max, present_count) in one striped pass.

    int64 values take the i64 kernel; floats the f64 kernel (NaN rows
    skipped).  Empty groups report the identity fills (int64 max/min or
    +/-inf) with count 0."""
    lib = get_lib()
    codes = np.ascontiguousarray(codes, dtype=np.int32)
    n = len(codes)
    counts = np.empty(n_groups, dtype=np.int64)
    mptr = None
    if mask is not None:
        mask = np.ascontiguousarray(mask, dtype=np.uint8)
        mptr = mask.ctypes.data
    if np.issubdtype(np.asarray(values).dtype, np.floating):
        values = np.ascontiguousarray(values, dtype=np.float64)
        mins = np.empty(n_groups, dtype=np.float64)
        maxs = np.empty(n_groups, dtype=np.float64)
        rc = lib.tpc_groupby_minmax_f64(
            codes.ctypes.data, values.ctypes.data, mptr, n, n_groups,
            mins.ctypes.data, maxs.ctypes.data, counts.ctypes.data, nthreads,
        )
    else:
        values = np.ascontiguousarray(values, dtype=np.int64)
        mins = np.empty(n_groups, dtype=np.int64)
        maxs = np.empty(n_groups, dtype=np.int64)
        rc = lib.tpc_groupby_minmax_i64(
            codes.ctypes.data, values.ctypes.data, mptr, n, n_groups,
            mins.ctypes.data, maxs.ctypes.data, counts.ctypes.data, nthreads,
        )
    if rc != 0:
        raise RuntimeError("tpc_groupby_minmax failed")
    return mins, maxs, counts
