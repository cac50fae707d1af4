"""Deterministic scatter-add through an owner table (the port's
counterpart of the JAX package's `jax.ops.segment_sum`).

Every assembly scatter of the port (the residual vector, the Jacobian's
diagonal and dense form, the block-tridiagonal template fill, the density
filter) sums "slots" of a flat source vector into destinations.  An
index_add does that with atomics on CUDA tensors, so the order of the
additions, and with it the rounding, changes from run to run.  Here the
pattern is analysed once on the host: for each destination, the slots
that add into it in increasing slot order, padded to the longest list
with the index of a zero appended to the source.  The sum is then one
gather into a (k, destinations) array (k the longest list) and a sum
over its first axis: no atomics, and a reduction of fixed shape, so the
same values sum to the same bits on every run.  A padded entry adds an
exact 0.

The sum is linear and each source element has at most one destination,
so its transpose is one gather: the backward pass reads each source's
gradient from its destination (`owner`), and the forward-mode
derivative is the same sum of the tangent.  Both are written out
(`_OwnerSum`), where autograd's own backward of the gathers would
scatter with a sort per column.
"""

from __future__ import annotations

import numpy as np
import torch


def owner_csr(dest: np.ndarray, n: int):
    """CSR of the slots owned by each of n destinations, in increasing
    slot order: (ptr (n+1,), slot (len(dest),)) int64.  dest: flat
    destination of every slot, in [0, n)."""
    dest = np.asarray(dest).reshape(-1)
    if dest.size and (dest.min() < 0 or dest.max() >= n):
        raise ValueError(f"destination ids outside [0, {n})")
    slot = np.argsort(dest, kind="stable")
    ptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(dest, minlength=n), out=ptr[1:])
    return ptr, slot.astype(np.int64)


def _fold(vals, table):
    """Sum of vals[table[j]] over j, with a zero appended to vals for the
    padding."""
    return torch.cat([vals, vals.new_zeros(1)])[table].sum(0)


class _OwnerSum(torch.autograd.Function):
    """(vals, table, owner) -> the owner-table sum, with its transpose
    gather as the backward pass and itself as the forward derivative."""

    generate_vmap_rule = True

    @staticmethod
    def forward(vals, table, owner):
        return _fold(vals, table)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, ctx.table, ctx.owner = inputs

    @staticmethod
    def backward(ctx, grad):
        return torch.cat([grad, grad.new_zeros(1)])[ctx.owner], None, None

    @staticmethod
    def jvp(ctx, vals_t, *_):
        return _fold(vals_t, ctx.table)


class OwnerTable:
    """The owner table of one scatter pattern, on one device.

    dest : flat destination of each entry.
    n_src : length of the source vector the entries read.
    n_out : number of destinations; None keeps only the destinations that
        receive an entry (their ids, increasing, in `ids`), for scatters
        into a large mostly-empty target.
    src : source index of each entry (default: entry j reads source j).

    `table` is (k, destinations) int64, k the most entries of one
    destination: table[j] holds the j-th slot of every destination, or
    n_src where it has fewer.  `owner` (n_src,) holds each source's
    destination, or the number of destinations where it has none; a
    source may feed at most one destination."""

    def __init__(self, dest, n_src: int, n_out: int | None = None,
                 src=None, device=None):
        dest = np.asarray(dest, np.int64).reshape(-1)
        src = (np.arange(len(dest), dtype=np.int64) if src is None
               else np.asarray(src, np.int64).reshape(-1))
        if len(src) != len(dest):
            raise ValueError(f"{len(src)} sources for {len(dest)} "
                             "destinations")
        if src.size and (src.min() < 0 or src.max() >= n_src):
            raise ValueError(f"source ids outside [0, {n_src})")
        if src.size and np.bincount(src).max() > 1:
            raise ValueError("a source feeds more than one destination")
        self.ids = None
        if n_out is None:
            ids, dest = np.unique(dest, return_inverse=True)
            n_out = len(ids)
            self.ids = torch.as_tensor(ids, device=device)
        ptr, order = owner_csr(dest, n_out)
        counts = np.diff(ptr)
        k = max(int(counts.max()) if n_out else 0, 1)
        table = np.full((k, n_out), n_src, np.int64)
        rows = np.repeat(np.arange(n_out), counts)
        table[np.arange(len(order)) - ptr[rows], rows] = src[order]
        owner = np.full(n_src, n_out, np.int64)
        owner[src] = dest
        self.n_src, self.n_out = int(n_src), int(n_out)
        self.table = torch.as_tensor(table, device=device)
        self.owner = torch.as_tensor(owner, device=device)

    def sum(self, vals: torch.Tensor) -> torch.Tensor:
        """The (n_out,) sums of the (n_src,) source `vals`."""
        if tuple(vals.shape) != (self.n_src,):
            raise ValueError(f"source shape {tuple(vals.shape)}, want "
                             f"({self.n_src},)")
        return _OwnerSum.apply(vals, self.table, self.owner)
