"""Mode a: assembly with the cells (and facets) sharded over the ranks
(port of femo_tpu/parallel/sharding.py).

Each rank assembles its slice of every term's entities into a
full-length vector, scalar or dense matrix, and one all-reduce
(`collectives.reduce_from_ranks`) gives every rank the whole, in place of
both the reference's ghost scatter and its allreduce.  Dof vectors stay
replicated, so the Krylov and dense solves that follow run the same on
every rank and need no further collective.

The entities keep the JAX package's layout: ordered by the native RCB
partition of their (side-0) cell centroids, padded to a multiple of the
rank count by repeats of entity 0 with a zero mask, and cut into equal
contiguous slices.  Rank r therefore holds the entities that JAX device r
holds.  Within a rank the sums go through the port's owner tables
(ops/scatter.py), as every assembly of the port does.

Departure: `device_mesh` returns a `RankMesh`, this process's view of an
initialized process group (rank, size, device), where the JAX package
returns a `jax.sharding.Mesh` over n devices of one process; the ranks
are started by `launch.spawn`.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from types import SimpleNamespace

import numpy as np
import torch
import torch.distributed as dist

from .. import native
from ..config import get_device
from ..fea.assemble import CompiledForm, _host, _Term
from ..ops.scatter import OwnerTable
from .collectives import copy_to_ranks, reduce_from_ranks

# per-entity data of a term, sharded along its first axis (the JAX
# package's list)
_ENTITY_KEYS = ("coords0", "h", "tag", "ctag0", "ctag1", "var0", "cent0",
                "coords1", "var1")


@dataclass(frozen=True)
class RankMesh:
    """One rank's view of a process group: the counterpart of the JAX
    package's one-axis device mesh.  group None is the default group."""

    group: object
    rank: int
    size: int
    device: torch.device


def device_mesh(n_devices: int | None = None, device=None) -> RankMesh:
    """This rank's RankMesh of the default process group (initialized,
    e.g. by `launch.spawn`).  n_devices, if given, must be the group's
    size.  device: this rank's device; None is the current card
    (`torch.cuda.current_device()`), "cpu" the CPU."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: start the ranks with "
                           "parallel.launch.spawn or init_process_group")
    size = dist.get_world_size()
    if n_devices is not None and int(n_devices) != size:
        raise ValueError(f"n_devices={n_devices}, but the group has {size} "
                         "ranks")
    dev = get_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return RankMesh(dist.group.WORLD, dist.get_rank(), size, dev)


def _pad_shard(arr, n_ent: int, ndev: int):
    """Pad the leading dim to a multiple of ndev by repeating entry 0
    (valid geometry, masked to a zero contribution)."""
    ne_pad = -(-n_ent // ndev) * ndev
    if ne_pad == n_ent:
        return arr
    if isinstance(arr, torch.Tensor):
        pad = arr[0:1].expand((ne_pad - n_ent,) + tuple(arr.shape[1:]))
        return torch.cat([arr, pad])
    pad = np.broadcast_to(arr[0:1], (ne_pad - n_ent,) + arr.shape[1:])
    return np.concatenate([arr, pad])


def _entity_order(term: _Term, ndev: int) -> np.ndarray:
    """Entities ordered by the native RCB partition of their (side-0)
    cell centroids, stably: each rank's contiguous slice is a compact
    spatial block."""
    cents = _host(term.coords0).mean(axis=1)  # (ne, gdim)
    part = native.rcb_partition(cents, ndev)
    return np.argsort(part, kind="stable").astype(np.int64)


def _shard_term_data(term: _Term, ndev: int, order=None):
    """A padded and masked copy of a term's entity data, in `order`,
    ready to be cut along its leading axis (device tensors, and the host
    dof ids that the owner tables read)."""
    ne = term.n_ent
    ne_pad = -(-ne // ndev) * ndev
    dev = term.coords0.device
    mask = torch.zeros(ne_pad, dtype=term.coords0.dtype, device=dev)
    mask[:ne] = 1.0
    d = SimpleNamespace(mask=mask)
    idx = None if order is None else torch.as_tensor(order, device=dev)

    def prep(a):
        if isinstance(a, torch.Tensor):
            return _pad_shard(a if idx is None else a[idx], ne, ndev)
        return _pad_shard(a if order is None else a[order], ne, ndev)

    for key in _ENTITY_KEYS:
        if hasattr(term, key):
            setattr(d, key, prep(getattr(term, key)))
    for side in ("0", "1"):
        if hasattr(term, f"gdofs{side}"):
            setattr(d, f"gdofs{side}", {k: prep(v) for k, v in getattr(
                term, f"gdofs{side}").items()})
            setattr(d, f"dofs{side}", {k: prep(v) for k, v in getattr(
                term, f"dofs{side}").items()})
    return d


def _rank_term(term: _Term, mesh: RankMesh) -> tuple[_Term, torch.Tensor]:
    """(view, mask): the term restricted to this rank's slice of its
    padded, RCB-ordered entities, and the slice's mask."""
    d = _shard_term_data(term, mesh.size, _entity_order(term, mesh.size))
    return _rank_view(term, d, mesh)


def _rank_view(term: _Term, d, mesh: RankMesh) -> tuple[_Term, torch.Tensor]:
    """(view, mask) of this rank's slice of `d`, the term's padded data
    (`_shard_term_data`)."""
    per = d.mask.shape[0] // mesh.size
    sl = slice(mesh.rank * per, (mesh.rank + 1) * per)
    view = copy.copy(term)
    view.n_ent = per
    view._spmv_plans = {}
    for key in _ENTITY_KEYS:
        if hasattr(d, key):
            setattr(view, key, getattr(d, key)[sl])
    for side in ("0", "1"):
        if hasattr(d, f"gdofs{side}"):
            for name in ("gdofs", "dofs"):
                setattr(view, f"{name}{side}", {k: v[sl] for k, v in getattr(
                    d, f"{name}{side}").items()})
    return view, d.mask[sl]


def _rank_terms(cform: CompiledForm, mesh: RankMesh):
    if not isinstance(mesh, RankMesh):
        raise TypeError("device_mesh must be a parallel.sharding.RankMesh, "
                        f"got {type(mesh).__name__}")
    if cform.device != mesh.device:
        raise ValueError(f"form on {cform.device}, rank {mesh.rank} on "
                         f"{mesh.device}")
    return [_rank_term(t, mesh) for t in cform.terms]


def _replicated(cform: CompiledForm, values: dict, mesh: RankMesh) -> dict:
    """The form's values (names it does not use dropped), each marked as
    replicated over the ranks for its gradient."""
    return {k: copy_to_ranks(values[k], mesh.group)
            for k in cform.all_names if k in values}


def sharded_vector_fn(cform: CompiledForm, mesh: RankMesh):
    """Residual assembly with the entities sharded over the ranks:
    fn(values: dict of replicated tensors) -> (n_dofs,), the same on every
    rank, differentiable in both modes (collectives.py)."""
    n = cform.form.test.n_dofs
    terms = _rank_terms(cform, mesh)
    rows = np.concatenate([v.host_rows("__test__").reshape(-1)
                           for v, _ in terms])
    table = OwnerTable(rows, len(rows), n, device=mesh.device)

    def fn(values: dict):
        vals = _replicated(cform, values, mesh)
        local = table.sum(torch.cat([
            (v.residual_contrib(vals, "__test__").reshape(v.n_ent, -1)
             * m[:, None]).reshape(-1) for v, m in terms]))
        return reduce_from_ranks(local, mesh.group)

    return fn


def sharded_scalar_fn(cform: CompiledForm, mesh: RankMesh):
    """Functional assembly with the entities sharded over the ranks:
    fn(values) -> scalar, the same on every rank."""
    terms = _rank_terms(cform, mesh)

    def fn(values: dict):
        vals = _replicated(cform, values, mesh)
        local = sum(torch.sum(v._vmapped(
            v.make_entity_kernel(None, list(vals)), vals) * m)
            for v, m in terms)
        return reduce_from_ranks(local, mesh.group)

    return fn


def sharded_matrix_dense_fn(cform: CompiledForm, mesh: RankMesh, wrt: str):
    """Jacobian assembly with the entities sharded over the ranks,
    densified and all-reduced to the replicated (n_rows, n_cols) matrix:
    the sharded counterpart of `cform.matrix(values, wrt).to_dense()`,
    for a replicated dense solve (`implicit_solve_dense`)."""
    n_rows = cform.form.test.n_dofs
    n_cols = cform.form.coeffs[wrt].space.n_dofs
    terms = _rank_terms(cform, mesh)
    dest = np.concatenate([
        (v.host_rows("__test__").astype(np.int64)[:, :, None] * n_cols
         + v.host_rows(wrt)[:, None, :]).reshape(-1) for v, _ in terms])
    table = OwnerTable(dest, len(dest), device=mesh.device)

    def fn(values: dict):
        vals = _replicated(cform, values, mesh)
        blocks = []
        for v, m in terms:
            A, _, _ = v.matrix_blocks(vals, "__test__", wrt)
            blocks.append((A * m[:, None, None]).reshape(-1))
        vals_flat = torch.cat(blocks)
        M = torch.zeros(n_rows * n_cols, dtype=vals_flat.dtype,
                        device=vals_flat.device)
        M[table.ids] = table.sum(vals_flat)
        return reduce_from_ranks(M.reshape(n_rows, n_cols), mesh.group)

    return fn
