"""Group-key factorization on the host: values -> dense codes + dictionary.

The port's copy of the host half of ``bqueryd_tpu/ops/factorize.py``:

* :func:`factorize` — any dtype, dynamic cardinality (the native hash
  factorizer for integers, NumPy otherwise);
* :func:`pack_codes` / :func:`unpack_codes` — composite multi-key codes:
  with per-key cardinalities ``(K1..Kn)`` a key tuple becomes one int
  ``c1*K2*...*Kn + c2*K3*...*Kn + ... + cn``.

The fixed-capacity device factorize waits for the executor slice.
"""

import numpy as np

from bqueryd_tpu_torch.storage import codec as storage_codec


def factorize(values):
    """Host factorize in first-seen order -> (codes int (n,), uniques).

    Integers go through the native hash factorizer (or its NumPy fallback);
    other dtypes through ``np.unique``.  NaNs factorize as ordinary keys:
    callers on the groupby path poison them to -1 themselves."""
    values = np.asarray(values)
    if values.dtype.kind in "iu" and values.dtype.itemsize <= 8:
        codes, uniques = storage_codec.factorize_i64(values.astype(np.int64))
        return codes, uniques.astype(values.dtype)
    uniques, inverse = np.unique(values, return_inverse=True)
    return storage_codec.first_seen_order(uniques, inverse, len(values))


#: composite key spaces at or past this product cannot be radix-packed in
#: int64; the single definition every overflow check compares against
MAX_COMPOSITE = 2**63


class CompositeOverflow(ValueError):
    """The product of key cardinalities exceeds int64: radix-packed
    composite codes would wrap and silently merge unrelated groups.  The
    engine degrades to tuple-wise factorization."""


def pack_codes(code_arrays, cardinalities):
    """Combine per-key dense codes (NumPy) into one composite code array.

    ``cardinalities[i]`` must bound ``code_arrays[i]``; negative codes
    (nulls) poison the whole composite to -1.  Raises
    :class:`CompositeOverflow` when the composite space does not fit int64."""
    assert len(code_arrays) == len(cardinalities) and code_arrays
    if total_cardinality(cardinalities) >= MAX_COMPOSITE:
        raise CompositeOverflow(
            "composite group-key space "
            f"{'x'.join(str(int(c)) for c in cardinalities)} exceeds int64"
        )
    total = np.asarray(code_arrays[0]).astype(np.int64)
    negative = np.asarray(code_arrays[0]) < 0
    for codes, card in zip(code_arrays[1:], cardinalities[1:]):
        codes = np.asarray(codes)
        total = total * int(card) + codes.astype(np.int64)
        negative = negative | (codes < 0)
    return np.where(negative, np.int64(-1), total)


def unpack_codes(packed, cardinalities):
    """Inverse of :func:`pack_codes`: composite codes -> list of per-key
    codes.  Null composites (-1) unpack to -1 for every key."""
    packed = np.asarray(packed).astype(np.int64)
    null = packed < 0
    out = []
    rest = np.where(null, 0, packed)
    for card in reversed(cardinalities[1:]):
        out.append(np.where(null, np.int64(-1), rest % int(card)))
        rest = rest // int(card)
    out.append(np.where(null, np.int64(-1), rest))
    return list(reversed(out))


def total_cardinality(cardinalities):
    total = 1
    for k in cardinalities:
        total *= int(k)
    return total
