from bqueryd_tpu_torch.storage.ctable import (
    DEFAULT_CHUNKLEN,
    KIND_DATETIME,
    KIND_DICT,
    KIND_NUMERIC,
    ctable,
    free_cachemem,
    open_ctable,
)

__all__ = [
    "ctable",
    "open_ctable",
    "free_cachemem",
    "DEFAULT_CHUNKLEN",
    "KIND_NUMERIC",
    "KIND_DICT",
    "KIND_DATETIME",
]
