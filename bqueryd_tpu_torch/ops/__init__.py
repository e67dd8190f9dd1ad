"""The port's columnar kernels: host factorize, device filter masks and
chunk pruning, the groupby partial tables whose contraction runs on the
CUDA kernels of :mod:`bqueryd_tpu_torch.ops.onehot`, the distinct counts
and basket expansion, and the NumPy twins of the host route."""

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
    program_bucket,
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
    "program_bucket",
    "tree_to_numpy",
    "WHERE_OPS",
    "build_mask",
    "chunk_pruned_table",
    "chunk_selection",
    "shard_can_match",
    "term_mask",
    "translate_value",
]
