"""Reader for legacy bcolz v1 on-disk data (the migration path).

The port's copy of ``bqueryd_tpu/storage/bcolz_v1.py``.  The original
bqueryd served ``.bcolz``/``.bcolzs`` rootdirs written by the bcolz/Blosc
C library; this module reads those directories without bcolz installed,
so that existing deployments move their data into the tpucolz store with
``bqueryd-tpu-torch import`` (see :func:`import_ctable`).  It imports
neither torch nor pandas: a host codec, not a device path.

On-disk layout read here (bcolz 1.x):

    <rootdir>/                      ctable
        __attrs__                   JSON user attrs (optional)
        <col>/                      one carray rootdir per column
            __attrs__               JSON (optional)
            meta/sizes              JSON: {"shape": [n], ...}
            meta/storage            JSON: {"dtype": ..., "chunklen": ...,
                                           "cparams": {...}, ...}
            data/__0.blp ...        Blosc v1 chunks, one per chunklen rows
            data/__leftover*.blp    trailing partial chunk (when present)

Chunks are Blosc v1 containers (16-byte header, block starts table, split
streams) decoded by the native library (``native/tpucolz.cpp``,
``tpc_blosc_decode``: blosclz + LZ4 + zlib codecs, byte-shuffle and
bit-shuffle filters) with a pure Python fallback implementing the same
public format.  Because split policy
varied across c-blosc releases, both decoders validate split framing and
retry the alternative split count rather than trusting the inference.

Column-name order: bcolz's own metadata file is consulted when present; a
deterministic sorted listing of carray subdirectories is the fallback (order
only affects column ordering of the converted table, not values).
"""

import json
import os
import zlib

import numpy as np

from bqueryd_tpu_torch.storage.codec import (
    _bitunshuffle,
    _lz4_decompress_py,
    _unshuffle,
)

#: exceptions that mean "this split framing / codec stream is inconsistent"
#: — the retry-the-alternative-split signal (a wrong split guess feeds the
#: codecs garbage, which surfaces as any of these, never silent corruption)
_DECODE_ERRORS = (ValueError, IndexError, zlib.error)

# ---------------------------------------------------------------------------
# pure-Python Blosc v1 chunk decoder (fallback when libtpucolz is absent)
# ---------------------------------------------------------------------------

_SHUFFLE = 0x1
_MEMCPYED = 0x2
_BITSHUFFLE = 0x4
_MAX_DISTANCE = 8191


def _blosclz_decompress_py(src, usize):
    """BloscLZ (FastLZ-derived) stream decoder; see native/tpucolz.cpp for
    the format notes.  Returns the decoded bytes or raises ValueError."""
    out = bytearray(usize)
    n = len(src)
    if n == 0:
        raise ValueError("empty blosclz stream")
    ip = 0
    op = 0
    ctrl = src[ip] & 31
    ip += 1
    while True:
        if ctrl >= 32:
            length = (ctrl >> 5) - 1
            ofs = (ctrl & 31) << 8
            if length == 6:  # 3-bit field saturated at 7: extend
                while True:
                    if ip >= n:
                        raise ValueError("truncated blosclz match length")
                    code = src[ip]
                    ip += 1
                    length += code
                    if code != 255:
                        break
            if ip >= n:
                raise ValueError("truncated blosclz offset")
            code = src[ip]
            ip += 1
            if code == 255 and ofs == (31 << 8):
                if ip + 2 > n:
                    raise ValueError("truncated blosclz far offset")
                ofs = (src[ip] << 8) + src[ip + 1]
                ip += 2
                ref = op - ofs - _MAX_DISTANCE - 1
            else:
                ref = op - ofs - code - 1
            if ref < 0:
                raise ValueError("blosclz reference before start")
            length += 3
            if op + length > usize:
                raise ValueError("blosclz output overflow")
            if ref + 1 == op:
                out[op:op + length] = out[op - 1:op] * length
            else:
                for k in range(length):  # may overlap forward
                    out[op + k] = out[ref + k]
            op += length
        else:
            run = ctrl + 1
            if ip + run > n or op + run > usize:
                raise ValueError("blosclz literal overflow")
            out[op:op + run] = src[ip:ip + run]
            ip += run
            op += run
        if ip >= n:
            break
        ctrl = src[ip]
        ip += 1
    if op != usize:
        raise ValueError(f"blosclz decoded {op} bytes, expected {usize}")
    return bytes(out)


def _decode_split_stream_py(buf, bsize, nsplits, codec):
    """Decode one block's ``nsplits`` int32-framed sub-streams; raises one of
    ``_DECODE_ERRORS`` on any framing/codec inconsistency (the retry
    signal)."""
    if nsplits <= 0 or bsize % nsplits:
        raise ValueError("invalid split count")
    neblock = bsize // nsplits
    pos = 0
    parts = []
    for _ in range(nsplits):
        if pos + 4 > len(buf):
            raise ValueError("truncated split header")
        sc = int.from_bytes(buf[pos:pos + 4], "little", signed=True)
        pos += 4
        if sc <= 0 or pos + sc > len(buf):
            raise ValueError("bad split size")
        sbuf = buf[pos:pos + sc]
        pos += sc
        if sc == neblock:
            parts.append(bytes(sbuf))
        elif codec == 0:
            parts.append(_blosclz_decompress_py(sbuf, neblock))
        elif codec == 1:
            parts.append(_lz4_decompress_py(sbuf, neblock))
        elif codec == 3:
            raw = zlib.decompress(bytes(sbuf))
            if len(raw) != neblock:
                raise ValueError("zlib split size mismatch")
            parts.append(raw)
        else:
            raise ValueError(f"unsupported blosc codec id {codec}")
    return b"".join(parts)


def _blosc_decode_chunk_py(buf):
    if len(buf) < 16:
        raise ValueError("short blosc header")
    flags = buf[2]
    typesize = buf[3]
    nbytes = int.from_bytes(buf[4:8], "little", signed=True)
    blocksize = int.from_bytes(buf[8:12], "little", signed=True)
    if nbytes < 0 or blocksize <= 0:
        raise ValueError("bad blosc header")
    if flags & _MEMCPYED:
        if len(buf) < 16 + nbytes:
            raise ValueError("truncated memcpyed chunk")
        return bytes(buf[16:16 + nbytes])
    codec = (flags >> 5) & 0x7
    nblocks = -(-nbytes // blocksize)
    out = bytearray()
    for b in range(nblocks):
        start = int.from_bytes(
            buf[16 + 4 * b:20 + 4 * b], "little", signed=True
        )
        if start < 0 or start > len(buf):
            raise ValueError("bad block start")
        bsize = nbytes - b * blocksize if b == nblocks - 1 else blocksize
        leftover = bsize != blocksize
        splittable = (
            not leftover
            and codec in (0, 1)
            and 1 < typesize <= 16
            and bsize % typesize == 0
            and bsize // typesize >= 128
        )
        candidates = [typesize, 1] if splittable else [1, typesize]
        block = None
        err = None
        for nsplits in candidates:
            if nsplits <= 0:
                continue
            try:
                block = _decode_split_stream_py(
                    buf[start:], bsize, nsplits, codec
                )
                break
            except _DECODE_ERRORS as exc:
                err = exc
        if block is None:
            raise ValueError(f"block {b} undecodable: {err}")
        # filter precedence mirrors c-blosc's blosc_d: byte-shuffle wins,
        # else bit-shuffle (both per block; bit-shuffle applies at any
        # typesize — bit-planes are its point for boolean data)
        if flags & _SHUFFLE and typesize > 1:
            block = _unshuffle(block, typesize)
        elif flags & _BITSHUFFLE:
            block = _bitunshuffle(block, typesize)
        out += block
    return bytes(out)


def decode_chunk(buf):
    """Decode one Blosc v1 chunk (native fast path, Python fallback)."""
    from bqueryd_tpu_torch.storage import native

    if native.blosc_available():
        try:
            nbytes, _typesize, _flags = native.blosc_info(bytes(buf))
            return native.blosc_decode(bytes(buf), nbytes)
        except ValueError:
            pass  # fall through: Python decoder raises the precise error
    return _blosc_decode_chunk_py(buf)


# ---------------------------------------------------------------------------
# carray / ctable directory readers
# ---------------------------------------------------------------------------

def _load_json(path):
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def _parse_dtype(spec):
    if spec is None:
        raise ValueError("carray metadata has no dtype")
    if isinstance(spec, str):
        spec = spec.strip()
        # bcolz writes dtype reprs like "'<i8'" / "int64" / "|S5"
        if len(spec) >= 2 and spec[0] == spec[-1] and spec[0] in "'\"":
            spec = spec[1:-1]
    return np.dtype(spec)


def is_carray_dir(path):
    return os.path.isfile(os.path.join(path, "meta", "storage"))


def is_ctable_dir(path):
    if not os.path.isdir(path):
        return False
    if is_carray_dir(path):
        return False
    return any(
        is_carray_dir(os.path.join(path, d))
        for d in os.listdir(path)
        if os.path.isdir(os.path.join(path, d))
    )


def _chunk_files(data_dir):
    """Numbered ``__<i>.blp`` files in index order, then any leftover files."""
    numbered = []
    leftovers = []
    for name in os.listdir(data_dir):
        if not name.endswith(".blp"):
            continue
        stem = name[:-4]
        if stem.startswith("__") and stem[2:].isdigit():
            numbered.append((int(stem[2:]), name))
        else:
            leftovers.append(name)
    numbered.sort()
    leftovers.sort()
    return [name for _, name in numbered] + leftovers


def read_carray(rootdir):
    """Read one bcolz v1 carray rootdir into a 1-D numpy array."""
    meta = {}
    meta.update(_load_json(os.path.join(rootdir, "meta", "storage")))
    sizes = _load_json(os.path.join(rootdir, "meta", "sizes"))
    meta.update(sizes)
    dtype = _parse_dtype(meta.get("dtype"))
    shape = meta.get("shape")
    length = None
    if isinstance(shape, (list, tuple)) and shape:
        if len(shape) != 1:
            raise ValueError(
                f"{rootdir}: only 1-D carrays are supported, shape={shape}"
            )
        length = int(shape[0])
    data_dir = os.path.join(rootdir, "data")
    if not os.path.isdir(data_dir):
        raise ValueError(f"{rootdir}: no data/ directory")
    pieces = []
    for name in _chunk_files(data_dir):
        with open(os.path.join(data_dir, name), "rb") as f:
            buf = f.read()
        if not buf:
            continue
        try:
            pieces.append(decode_chunk(buf))
        except ValueError:
            # leftover files in some layouts are raw element bytes
            if name in ("__leftover.blp", "__leftovers.blp"):
                pieces.append(buf)
            else:
                raise
    raw = b"".join(pieces)
    if len(raw) % dtype.itemsize:
        raise ValueError(
            f"{rootdir}: decoded {len(raw)} bytes, not a multiple of "
            f"itemsize {dtype.itemsize}"
        )
    arr = np.frombuffer(raw, dtype=dtype)
    if length is not None:
        if len(arr) < length:
            raise ValueError(
                f"{rootdir}: decoded {len(arr)} rows, metadata says {length}"
            )
        arr = arr[:length]
    return arr.copy()


def _column_names(rootdir):
    # bcolz metadata variants first, sorted subdirs as the fallback
    for candidate in ("__cols__", "__attrs__", "__rootdirs__"):
        blob = _load_json(os.path.join(rootdir, candidate))
        names = blob.get("names") if isinstance(blob, dict) else None
        if isinstance(names, list) and names:
            present = [
                n for n in names if is_carray_dir(os.path.join(rootdir, n))
            ]
            if present:
                return present
    return sorted(
        d
        for d in os.listdir(rootdir)
        if is_carray_dir(os.path.join(rootdir, d))
    )


def read_ctable(rootdir):
    """Read a bcolz v1 ctable rootdir: returns (columns dict in stable
    order, user attrs dict)."""
    if is_carray_dir(rootdir):
        raise ValueError(
            f"{rootdir} is a bare carray; wrap it in a ctable or import "
            "column by column via read_carray"
        )
    names = _column_names(rootdir)
    if not names:
        raise ValueError(f"{rootdir}: no carray columns found")
    columns = {name: read_carray(os.path.join(rootdir, name)) for name in names}
    lengths = {name: len(col) for name, col in columns.items()}
    if len(set(lengths.values())) > 1:
        raise ValueError(f"{rootdir}: ragged columns {lengths}")
    attrs = _load_json(os.path.join(rootdir, "__attrs__"))
    return columns, (attrs if isinstance(attrs, dict) else {})


def import_ctable(src, dst):
    """Convert a legacy bcolz v1 ctable rootdir into the tpucolz store.

    ``bqueryd-tpu-torch import <src.bcolz> <dst.bcolz>``: the destination
    then serves through the normal query path.  The columns are written
    from ``{name: ndarray}`` without pandas; byte-string columns become
    dictionary-encoded text (``KIND_DICT``, codes in first-seen order, as
    the JAX package's import writes them), and the v1 user attrs are kept
    under ``bcolz_v1_attrs``.  Returns the number of rows imported."""
    from bqueryd_tpu_torch.storage.ctable import ctable

    columns, attrs = read_ctable(src)
    arrays = {
        name: (
            np.char.decode(col, "utf-8", "replace").astype(object)
            if col.dtype.kind == "S"
            else col
        )
        for name, col in columns.items()
    }
    table = ctable(dst, mode="w")
    rows = table.append(arrays)
    if attrs:
        table.set_attrs(bcolz_v1_attrs=attrs)
    return rows
