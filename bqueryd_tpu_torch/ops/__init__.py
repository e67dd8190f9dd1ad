"""The port's columnar kernels: host factorize, device filter masks and
chunk pruning, the groupby partial tables whose contraction runs on the
CUDA kernels of :mod:`bqueryd_tpu_torch.ops.onehot`, the distinct counts
and basket expansion, and the NumPy twins of the host route; the
bucketized emission and the all-reduce of the device merge; and
:func:`maybe_init_distributed`, which joins a multi-process job."""

import logging
import os

from bqueryd_tpu_torch.ops.factorize import (
    MAX_COMPOSITE,
    CompositeOverflow,
    factorize,
    pack_codes,
    total_cardinality,
    unpack_codes,
)
from bqueryd_tpu_torch.ops.groupby import (
    AGG_OPS,
    MERGEABLE_OPS,
    bucketize_partials,
    bundle_partial_tables,
    combine_partials,
    expand_mask_by_group,
    finalize,
    groupby_count_distinct,
    groupby_sorted_count_distinct,
    host_expand_mask_by_group,
    host_partial_tables,
    host_sorted_count_distinct,
    kernel_route,
    partial_tables,
    partial_tables_bucketized,
    program_bucket,
    psum_partials,
    tree_to_numpy,
)
from bqueryd_tpu_torch.ops.predicates import (
    WHERE_OPS,
    build_mask,
    chunk_pruned_table,
    chunk_selection,
    shard_can_match,
    term_mask,
    translate_value,
)

__all__ = [
    "CompositeOverflow",
    "MAX_COMPOSITE",
    "factorize",
    "pack_codes",
    "unpack_codes",
    "total_cardinality",
    "AGG_OPS",
    "MERGEABLE_OPS",
    "bucketize_partials",
    "bundle_partial_tables",
    "combine_partials",
    "expand_mask_by_group",
    "finalize",
    "groupby_count_distinct",
    "groupby_sorted_count_distinct",
    "host_expand_mask_by_group",
    "host_partial_tables",
    "host_sorted_count_distinct",
    "kernel_route",
    "partial_tables",
    "partial_tables_bucketized",
    "program_bucket",
    "psum_partials",
    "tree_to_numpy",
    "WHERE_OPS",
    "build_mask",
    "chunk_pruned_table",
    "chunk_selection",
    "shard_can_match",
    "term_mask",
    "translate_value",
    "distributed_info",
    "maybe_init_distributed",
    "rank_cards",
]


#: ``{"backend", "rank", "world_size"}`` of the job this process joined
_distributed = None


def distributed_backend(nprocs):
    """The collective backend of a job of ``nprocs`` processes: NCCL when
    each rank has a card of its own (at least ``nprocs`` visible cards),
    gloo otherwise (the CPU, or ranks sharing one card).  A choice made
    from the layout, not a fallback."""
    import torch

    if torch.cuda.is_available() and torch.cuda.device_count() >= nprocs:
        return "nccl"
    return "gloo"


def rank_cards(count, rank, world_size):
    """The card indices of rank ``rank`` of a ``world_size``-process job on
    a host of ``count`` visible cards: ``count // world_size`` each, rank
    ``r`` the ``r``-th block, so that no card is two ranks'; with fewer
    cards than ranks, the one card ``rank % count`` (shared, gloo)."""
    per = count // world_size
    if per == 0:
        return (rank % count,)
    return tuple(range(rank * per, (rank + 1) * per))


def maybe_init_distributed(logger=None):
    """Join a multi-process job when configured; a no-op otherwise.

    ``BQUERYD_TPU_DIST_COORDINATOR=host:port`` (rank 0 listens there),
    ``BQUERYD_TPU_DIST_NPROCS`` (the world size) and
    ``BQUERYD_TPU_DIST_PROC_ID`` (this process's rank) make this process
    one rank of a ``torch.distributed`` group; the executor's merge then
    takes the ``psum`` mode (``parallel.devicemerge.resolve_mode``).  Under
    NCCL the rank's current card is the first of :func:`rank_cards`, and an
    executor built after joining runs on the rank's cards
    (``parallel.executor.resolve_devices``).  The worker calls it at
    construction.  Returns True when it joined."""
    global _distributed
    coordinator = os.environ.get("BQUERYD_TPU_DIST_COORDINATOR")
    if not coordinator or _distributed is not None:
        return False
    import datetime

    import torch
    import torch.distributed as dist

    nprocs = int(os.environ.get("BQUERYD_TPU_DIST_NPROCS", "1"))
    rank = int(os.environ.get("BQUERYD_TPU_DIST_PROC_ID", "0"))
    backend = distributed_backend(nprocs)
    if backend == "nccl":
        torch.cuda.set_device(
            rank_cards(torch.cuda.device_count(), rank, nprocs)[0])
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator}", world_size=nprocs,
        rank=rank, timeout=datetime.timedelta(seconds=300),
    )
    _distributed = {"backend": backend, "rank": rank, "world_size": nprocs}
    (logger or logging.getLogger("bqueryd_tpu_torch")).info(
        "joined a %d-process job as rank %d, backend %s", nprocs, rank,
        backend,
    )
    return True


def distributed_info():
    """``{"backend", "rank", "world_size"}`` of the job this process
    joined through :func:`maybe_init_distributed`, else None."""
    return None if _distributed is None else dict(_distributed)
