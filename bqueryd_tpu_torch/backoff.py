"""Retry pacing: capped exponential backoff with deterministic jitter.

The jitter is keyed on a caller-supplied seed (a socket identity) through
crc32, so retrying clients spread out the same way on every run.
"""

import zlib

#: default envelope: base * 2^exponent, capped
BACKOFF_BASE_S = 0.05
BACKOFF_CAP_S = 2.0


def backoff_delay(exponent, seed_key, base=BACKOFF_BASE_S, cap=BACKOFF_CAP_S):
    """Delay before the attempt after ``exponent`` failures: ``base *
    2^exponent`` capped at ``cap``, stretched by up to 25% keyed on
    ``seed_key``."""
    delay = min(base * (2 ** exponent), cap)
    jitter = (zlib.crc32(str(seed_key).encode()) % 256) / 1024.0  # [0, 0.25)
    return delay * (1.0 + jitter)
