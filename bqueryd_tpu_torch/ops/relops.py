"""Device twins of the relational operators' host kernels (plan.dag,
parallel.opexec), in torch.

The port of ``bqueryd_tpu/ops/relops.py``, whose three entry points are
jnp programs (no Pallas kernel).  Each takes NumPy inputs, computes on
``device`` (``cuda`` unless the caller passes ``device="cpu"``) and
returns NumPy, bit-identical to its NumPy host twin in
:mod:`bqueryd_tpu_torch.parallel.opexec`:

* :func:`gather_positions` — the broadcast hash-join probe: one gather of
  per-distinct-key dimension positions onto rows;
* :func:`topk_partials` — per-group top-k: a lexicographic order by
  (group, value) from two stable sorts, then each group's first or last
  ``k`` rows of its segment, as ``opexec.topk_flat`` selects them;
* :func:`sketch_bin` — the quantile sketch's signed log-gamma bucket key
  per value, in float64.

The mesh fast path's dense sketch grid (``sketch_grid_block``) waits for
the slice that ports that path.
"""

import numpy as np
import torch

from bqueryd_tpu_torch import resolve_device
from bqueryd_tpu_torch.ops.groupby import as_tensor
from bqueryd_tpu_torch.parallel.opexec import (
    SKETCH_MIN_MAGNITUDE,
    sketch_keys_host,
    sketch_layout,
)

#: a sketch quotient ``log(v) / log(gamma)`` within this relative distance
#: of an integer is a bucket edge where a one-ulp difference between the
#: card's ``log`` and NumPy's could change the bucket: such values take
#: the host formula that defines the layout
_EDGE_RTOL = 1e-9


def gather_positions(pos_of_unique, codes, device=None):
    """Join probe: ``row_pos[i] = pos_of_unique[codes[i]]``, -1 (a miss)
    where ``codes[i]`` is null."""
    device = resolve_device(device)
    pos = as_tensor(np.asarray(pos_of_unique, dtype=np.int64), device)
    c = as_tensor(np.asarray(codes), device).to(torch.int64)
    out = torch.where(c >= 0, pos[c.clamp(min=0)], torch.full_like(c, -1))
    return out.cpu().numpy()


def _order_key(values, device):
    """An order-preserving tensor of ``values`` that torch sorts: bools
    as small ints, unsigned ints shifted into int64, floats as float64
    with -0.0 folded onto +0.0 (NumPy's sorts hold them equal, a radix sort
    of their bits would not)."""
    v = np.asarray(values)
    if v.dtype == np.bool_:
        return as_tensor(v.astype(np.int16), device)
    if v.dtype == np.uint64:
        return as_tensor(
            v.view(np.int64) ^ np.int64(np.iinfo(np.int64).min), device
        )
    if v.dtype.kind in "iu":
        return as_tensor(v.astype(np.int64), device)
    if v.dtype.kind == "f":
        return as_tensor(v.astype(np.float64), device) + 0.0
    raise TypeError(f"no order for top-k values of dtype {v.dtype}")


def topk_partials(codes, values, k, largest, n_groups, mask=None,
                  sentinel=None, device=None):
    """Per-shard top-k partial in the flat mergeable form ``(values,
    offsets)``, bit-identical to ``opexec.topk_flat``: null keys, masked
    rows, NaNs and the null ``sentinel`` (datetime NaT) drop; group ``g``'s
    values are best-first, ties kept (a value multiset, as ``nlargest``)."""
    values = np.asarray(values)
    c = as_tensor(np.asarray(codes), resolve_device(device)).to(torch.int64)
    key = _order_key(values, c.device)
    valid = c >= 0
    if mask is not None:
        valid &= as_tensor(np.asarray(mask, dtype=bool), c.device)
    if sentinel is not None:
        raw = as_tensor(values.astype(np.int64), c.device)
        valid &= raw != int(sentinel)
    if values.dtype.kind == "f":
        valid &= ~torch.isnan(key)
    rows = torch.nonzero(valid).squeeze(1)
    g = c[rows]
    by_value = torch.sort(key[rows], stable=True).indices
    perm = by_value[torch.sort(g[by_value], stable=True).indices]
    counts = torch.bincount(g, minlength=int(n_groups))
    take = counts.clamp(max=int(k))
    ends = torch.cumsum(counts, 0)
    group_of = torch.repeat_interleave(
        torch.arange(int(n_groups), device=c.device), take
    )
    loc = (torch.arange(group_of.numel(), device=c.device)
           - (torch.cumsum(take, 0) - take)[group_of])
    if largest:
        at = ends[group_of] - 1 - loc
    else:
        at = (ends - counts)[group_of] + loc
    picked = rows[perm[at]].cpu().numpy()
    offsets = np.zeros(int(n_groups) + 1, dtype=np.int64)
    np.cumsum(take.cpu().numpy(), out=offsets[1:])
    return values[picked], offsets


def sketch_bin(values, alpha, device=None):
    """Signed bucket key per value (int64), equal to
    ``opexec.sketch_keys_host``'s.  NaN rows produce garbage keys and must
    be excluded by the caller's validity mask, as for the host twin.  A
    value at a bucket edge (its quotient within :data:`_EDGE_RTOL` of an
    integer) is binned by the host formula, which defines the layout."""
    _gamma, lg, imin, imax = sketch_layout(alpha)
    host = np.asarray(values, dtype=np.float64)
    v = as_tensor(host, resolve_device(device))
    mag = v.abs()
    tiny = mag < SKETCH_MIN_MAGNITUDE
    q = torch.log(torch.where(tiny, torch.ones_like(mag), mag)) / lg
    i = torch.ceil(q).clamp(imin, imax).to(torch.int64)
    unsigned = i - imin + 1
    keys = torch.where(
        tiny, torch.zeros_like(i), torch.where(v < 0, -unsigned, unsigned)
    )
    edge = (q - torch.round(q)).abs() <= _EDGE_RTOL * q.abs().clamp(min=1.0)
    edge &= ~tiny
    out = keys.cpu().numpy()
    at = np.flatnonzero(edge.cpu().numpy())
    if len(at):
        out[at] = sketch_keys_host(host[at], alpha)
    return out
