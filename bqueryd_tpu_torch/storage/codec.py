"""Chunk codec front-end: native fast path with pure-Python fallbacks (a
copy of ``bqueryd_tpu/storage/codec.py``; of the legacy bcolz filters only
the inverses the bcolz v1 reader needs).

Codec ids are part of the on-disk format: 0=raw, 1=shuffle+LZ4, 2=shuffle+zlib.
The fallback implements raw and zlib natively and can *decode* (not encode) LZ4
blocks in pure Python, so data written with the native library stays readable
on hosts without it.
"""

import zlib

import numpy as np

from bqueryd_tpu_torch.storage import native

RAW = native.TPC_RAW
LZ4 = native.TPC_LZ4
ZLIB = native.TPC_ZLIB

DEFAULT_CODEC = LZ4


def _shuffle(payload: bytes, elem_size: int) -> bytes:
    if elem_size <= 1:
        return payload
    n = len(payload)
    nelems = n // elem_size
    body = np.frombuffer(payload, dtype=np.uint8, count=nelems * elem_size)
    out = body.reshape(nelems, elem_size).T.tobytes()
    return out + payload[nelems * elem_size:]


def _unshuffle(payload: bytes, elem_size: int) -> bytes:
    if elem_size <= 1:
        return payload
    n = len(payload)
    nelems = n // elem_size
    body = np.frombuffer(payload, dtype=np.uint8, count=nelems * elem_size)
    out = body.reshape(elem_size, nelems).T.tobytes()
    return out + payload[nelems * elem_size:]


def _bitunshuffle(payload: bytes, elem_size: int) -> bytes:
    """Undo c-blosc's bit-shuffle filter: the element count is truncated
    to a multiple of 8, each byte-of-element's 8 bit-planes are packed
    across those elements, and the trailing bytes are copied through."""
    if elem_size <= 0:
        return payload
    nelems = (len(payload) // elem_size) & ~7
    cut = nelems * elem_size
    if nelems == 0:
        return payload
    planes = np.unpackbits(
        np.frombuffer(payload, dtype=np.uint8, count=cut),
        bitorder="little",
    ).reshape(elem_size, 8, nelems)
    bits = planes.transpose(2, 0, 1)  # (element, byte-of-elem, bit)
    out = np.packbits(bits.reshape(-1), bitorder="little").tobytes()
    return out + payload[cut:]


def _lz4_decompress_py(src: bytes, usize: int) -> bytes:
    """Pure-Python LZ4 block decoder (read-compat fallback)."""
    dst = bytearray()
    ip, n = 0, len(src)
    while ip < n:
        token = src[ip]
        ip += 1
        lit_len = token >> 4
        if lit_len == 15:
            while True:
                b = src[ip]
                ip += 1
                lit_len += b
                if b != 255:
                    break
        dst += src[ip:ip + lit_len]
        ip += lit_len
        if ip >= n:
            break
        offset = src[ip] | (src[ip + 1] << 8)
        ip += 2
        ml = token & 15
        if ml == 15:
            while True:
                b = src[ip]
                ip += 1
                ml += b
                if b != 255:
                    break
        ml += 4
        start = len(dst) - offset
        if start < 0:
            raise ValueError("corrupt LZ4 block: bad offset")
        for i in range(ml):
            dst.append(dst[start + i])
    if len(dst) != usize:
        raise ValueError("corrupt LZ4 block: size mismatch")
    return bytes(dst)


def encode_chunk(payload: bytes, elem_size: int, codec: int = DEFAULT_CODEC):
    """Compress one chunk; returns (codec_used, compressed_bytes).  Falls back
    to zlib when LZ4 is requested without the native library."""
    if native.available():
        return codec, native.encode(payload, elem_size, codec)
    if codec == LZ4:
        codec = ZLIB  # encodable without native lib; recorded per chunk
    shuffled = _shuffle(payload, elem_size)
    if codec == RAW:
        return RAW, shuffled
    return ZLIB, zlib.compress(shuffled, 1)


def decode_chunk(buf: bytes, usize: int, elem_size: int, codec: int) -> bytes:
    if native.available():
        return native.decode(buf, usize, elem_size, codec)
    if codec == RAW:
        payload = buf
    elif codec == ZLIB:
        payload = zlib.decompress(buf)
    elif codec == LZ4:
        payload = _lz4_decompress_py(buf, usize)
    else:
        raise ValueError(f"unknown codec id {codec}")
    if len(payload) != usize:
        raise ValueError("corrupt chunk: size mismatch")
    return _unshuffle(payload, elem_size)


def decode_column_into(file_buf, chunks, elem_size, codec, out, nthreads=0):
    """Decode a whole column into the contiguous array ``out``.

    ``chunks`` is the column metadata list ({offset, csize, usize} dicts in
    file order).  Uses the native multithreaded decoder when present.
    """
    if not chunks:
        return
    _verify_crcs(file_buf, chunks)
    # a chunk may carry its own codec id (mixed-writer tables)
    uniform = all(c.get("codec", codec) == codec for c in chunks)
    if native.available() and uniform:
        offsets = np.array(
            [c["offset"] for c in chunks] + [chunks[-1]["offset"] + chunks[-1]["csize"]],
            dtype=np.uint64,
        )
        usizes = np.array([c["usize"] for c in chunks], dtype=np.uint64)
        native.decode_column(file_buf, offsets, usizes, elem_size, codec, out, nthreads)
        return
    view = out.view(np.uint8).reshape(-1)
    pos = 0
    for c in chunks:
        raw = decode_chunk(
            file_buf[c["offset"]:c["offset"] + c["csize"]],
            c["usize"],
            elem_size,
            c.get("codec", codec),
        )
        view[pos:pos + c["usize"]] = np.frombuffer(raw, dtype=np.uint8)
        pos += c["usize"]


def _verify_crcs(file_buf, chunks):
    """Check each chunk's stored CRC32 (over the compressed bytes) before
    decoding — LZ4 happily 'succeeds' on some corrupted inputs, so decode
    success alone does not prove integrity."""
    view = memoryview(file_buf)
    for i, c in enumerate(chunks):
        crc = c.get("crc")
        if crc is None:
            continue
        got = zlib.crc32(view[c["offset"]:c["offset"] + c["csize"]]) & 0xFFFFFFFF
        if got != crc:
            raise ValueError(f"corrupt chunk {i}: CRC mismatch")


def first_seen_order(uniques, inverse, n_values):
    """Re-order np.unique output (sorted) into first-seen order:
    returns (codes int32, uniques reordered)."""
    first_pos = np.full(len(uniques), n_values, dtype=np.int64)
    np.minimum.at(first_pos, inverse, np.arange(n_values))
    order = np.argsort(first_pos, kind="stable")
    remap = np.empty(len(order), dtype=np.int64)
    remap[order] = np.arange(len(order))
    return remap[inverse].astype(np.int32), uniques[order]


def factorize_i64(values: np.ndarray):
    """Dense-code int64 values in first-seen order -> (codes i32, uniques i64)."""
    if native.available():
        return native.factorize_i64(values)
    uniques, inverse = np.unique(values, return_inverse=True)
    return first_seen_order(uniques, inverse, len(values))
