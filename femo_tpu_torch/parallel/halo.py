"""Mode b: dof-sharded operators with halo exchange (port of
femo_tpu/parallel/halo.py).

Each rank owns a block of dofs plus ghost copies of its partition
boundary, and both directions of PETSc's `ghostUpdate` become one
`all_to_all_single` of precomputed, padded (ranks, S) send lists:

  forward  (INSERT): owner values -> ghost copies        before the product
  reverse  (ADD):    ghost partial sums -> owner slots   after it

so the communication is O(partition boundary), not O(n).  The product in
between is the element SpMV K4 (ops/spmv.py) on the rank's own elements,
whose rows and columns are local slots in [0, L + G): owned slots first,
then ghosts.  Krylov dot products are partial dots summed over the
ranks: all-reduced, or, inside `cg`, carried by the halo exchanges.

The layout is the JAX package's: by default elements are partitioned by
the native RCB partition of their first row dof (`rows[:, :1]`, a proxy
for geometry); `from_cells` takes a partition and a dofmap instead (the
halo steps' RCB of cell centroids over the composite (u, theta) dofmap,
parallel/halo_step.py), and the rank's element values come later through
`set_elements`.  Each dof belongs to the lowest rank among the cells that
touch it, and `build_halo_layout` (pure numpy, a copy of the JAX
function) is computed in full on every rank, which then keeps its own
slice.  So the layouts, and with them the CG iterations, are the JAX
package's.

A form of several terms (the motor's mesh motion: hyperelastic cells
and the interior-facet Nitsche term) gives one element block per term
(`from_terms`, as femo_tpu/parallel/halo_newton.py lays it out): each
term's entities in the RCB order of their centroids, padded to a
multiple of the rank count, the layout from the union of every term's
row and column lists.  K4 then runs once per block in a product, K4T in
the transpose product (`matvec(transpose=True)`), and `gmres` solves the
nonsymmetric systems.

Departures, each for the process-per-rank model: vectors are this rank's
(L,) owned slots, where the JAX package stacks every device's as an
(ndev, L) array on one host; each rank keeps its own elements unpadded,
where the JAX package pads every device to the largest count with a mask;
`cg` is a Python loop in place of `lax.while_loop`, whose stopping test
reads the summed residual, so every rank leaves on the same iteration,
and whose dot products ride on the halo exchanges (two collectives an
iteration, see `cg`); `gmres` orthogonalizes by classical Gram-Schmidt
with one reorthogonalization, each pass's dots in one all-reduce, where
the JAX package's modified Gram-Schmidt makes one psum per dot (see
`gmres`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import scipy.linalg
import torch
import torch.distributed as dist

from .. import native
from ..config import config
from ..fea.assemble import ElementMatrix, MatBlock, _host
from ..ops.scatter import OwnerTable
from ..ops.spmv import ElementSpMVPlan
from .sharding import RankMesh, _rank_view, _shard_term_data


@dataclass
class HaloLayout:
    """Index maps of every rank (stacked over the rank axis)."""

    ndev: int
    n_owned: np.ndarray  # (ndev,) actual owned counts
    L: int  # padded owned slots per rank
    G: int  # padded ghost slots per rank
    S: int  # padded exchange slots per (src, dst) pair
    owned_global: np.ndarray  # (ndev, L) global dof id per owned slot (0 pad)
    # forward exchange: rank o sends x_local[send_slot[o, r, s]] to r,
    # which stores it at ghost slot recv_ghost_slot[r, o, s]
    send_slot: np.ndarray  # (ndev, ndev, S) owned-slot index or 0
    send_mask: np.ndarray  # (ndev, ndev, S)
    recv_ghost_slot: np.ndarray  # (ndev, ndev, S) ghost slot or 0
    recv_mask: np.ndarray  # (ndev, ndev, S)
    owner_of: np.ndarray  # (n,) owning rank of each global dof
    local_of: np.ndarray  # (n,) owned slot of each global dof on its owner


def build_halo_layout(dofmap: np.ndarray, n_dofs: int, cell_part: np.ndarray,
                      ndev: int) -> HaloLayout:
    """Ownership, ghosts and exchange lists from a cell partition."""
    nc, nd = dofmap.shape
    # dof owner = min partition index among touching cells (deterministic)
    flat = dofmap.reshape(-1)
    cell_of_entry = np.repeat(np.arange(nc), nd)
    order = np.argsort(flat, kind="stable")
    fsort = flat[order]
    csort = cell_part[cell_of_entry[order]]
    first = np.searchsorted(fsort, np.arange(n_dofs))
    owner = np.minimum.reduceat(
        csort, np.clip(first, 0, len(csort) - 1)).astype(np.int32)

    owned_lists = [np.nonzero(owner == d)[0] for d in range(ndev)]
    L = max(max(len(o) for o in owned_lists), 1)
    owned_global = np.zeros((ndev, L), np.int64)
    local_of = np.zeros(n_dofs, np.int32)
    n_owned = np.zeros(ndev, np.int64)
    for d, o in enumerate(owned_lists):
        owned_global[d, : len(o)] = o
        local_of[o] = np.arange(len(o))
        n_owned[d] = len(o)

    # ghosts per rank: dofs of local cells not owned locally
    ghost_lists = []
    for d in range(ndev):
        dofs = np.unique(dofmap[cell_part == d].reshape(-1))
        ghost_lists.append(dofs[owner[dofs] != d])
    G = max(max(len(g) for g in ghost_lists), 1)

    # exchange lists
    S = 1
    pair_dofs = {}
    for r in range(ndev):
        g = ghost_lists[r]
        for o in range(ndev):
            sel = g[owner[g] == o]
            pair_dofs[(o, r)] = sel
            S = max(S, len(sel))
    send_slot = np.zeros((ndev, ndev, S), np.int32)
    send_mask = np.zeros((ndev, ndev, S), bool)
    recv_ghost_slot = np.zeros((ndev, ndev, S), np.int32)
    recv_mask = np.zeros((ndev, ndev, S), bool)
    ghost_index = [dict() for _ in range(ndev)]
    for r in range(ndev):
        for k, gd in enumerate(ghost_lists[r]):
            ghost_index[r][gd] = k
    for (o, r), sel in pair_dofs.items():
        k = len(sel)
        send_slot[o, r, :k] = local_of[sel]
        send_mask[o, r, :k] = True
        recv_ghost_slot[r, o, :k] = [ghost_index[r][gd] for gd in sel]
        recv_mask[r, o, :k] = True

    return HaloLayout(ndev, n_owned, L, G, S, owned_global,
                      send_slot, send_mask, recv_ghost_slot, recv_mask,
                      owner, local_of)


class HaloShardedOperator:
    """A dof-sharded element-form operator over the ranks of a RankMesh.

    emat: the assembled ElementMatrix (every rank passes the same);
    n_dofs: its size; free: the BC mask (None: no BC), the operator then
    being P A P + (I - P) as on one device.  Or `from_cells` /
    `from_terms` and `set_elements` (see there).  Vectors are this rank's
    (L,) owned slots (padding slots 0).  Every method that communicates
    (`matvec`, `dot`, `diagonal`, `gather_vector`, `cg`, `gmres`) must be
    called by every rank in the same order.  `collectives` counts this
    rank's halo exchanges and all-reduces."""

    def __init__(self, emat: ElementMatrix, dofmap: np.ndarray, n_dofs: int,
                 mesh: RankMesh, free=None):
        A_e = np.concatenate([_host(b.A) for b in emat.blocks])
        rows = np.concatenate([_host(b.rows) for b in emat.blocks])
        cols = np.concatenate([_host(b.cols) for b in emat.blocks])
        # partition elements by their first row dof (proxy for geometry
        # when coordinates are unavailable at this level), as the JAX
        # package does: the same layout, so the same CG iterations
        part = native.rcb_partition(rows[:, :1].astype(np.float64),
                                    mesh.size)
        self._setup(rows, n_dofs, part, mesh, free)
        self._set_maps([(rows[self.cells], cols[self.cells])])
        self.set_elements(torch.as_tensor(A_e[self.cells],
                                          dtype=config.dtype,
                                          device=mesh.device))

    @classmethod
    def from_cells(cls, dofmap: np.ndarray, n_dofs: int, part: np.ndarray,
                   mesh: RankMesh, free=None) -> "HaloShardedOperator":
        """The operator of a given cell partition, before its values:
        dofmap (n_cells, nd) the rows (= columns) of every cell, part
        (n_cells,) the rank of each.  The rank's element blocks, in the
        order of `cells`, come later through `set_elements`, so each rank
        assembles only its own cells (the JAX package's halo steps)."""
        op = cls.__new__(cls)
        dofmap = np.asarray(dofmap)
        op._setup(dofmap, n_dofs, np.asarray(part), mesh, free)
        op._set_maps([(dofmap[op.cells], dofmap[op.cells])])
        return op

    @classmethod
    def from_terms(cls, terms, wrt: str, n_dofs: int, mesh: RankMesh,
                   free=None) -> "HaloShardedOperator":
        """The operator of a compiled form's Jacobian in `wrt` (test space
        = wrt's space), one element block per term, laid out as the JAX
        package's halo Newton lays it out (femo_tpu/parallel/
        halo_newton.py:86-130): each term's entities ordered by the RCB
        partition of their centroids (`cent0` where the term has one, else
        the mean of its side-0 cell's vertices), padded to a multiple of
        the rank count by repeats of entity 0 and cut into equal chunks,
        chunk r on rank r; the ownership and ghosts from the union of
        every term's row and column lists (interior facets: side 0 then
        side 1), padded to a common width by repeating their first
        column.  `views` holds this rank's (term view, mask) of each term,
        in its block's order; `set_elements` takes the masked blocks
        assembled on them (a padded entity's block is zero, its dofs stay
        in the layout)."""
        op = cls.__new__(cls)
        ndev = mesh.size
        data, maps, parts = [], [], []
        for t in terms:
            cents = (_host(t.cent0) if hasattr(t, "cent0")
                     else _host(t.coords0).mean(axis=1))
            order = np.argsort(native.rcb_partition(
                np.asarray(cents, np.float64), ndev), kind="stable")
            d = _shard_term_data(t, ndev, order)
            sides = ("0", "1") if hasattr(d, "dofs1") else ("0",)
            rows, cols = (np.concatenate([getattr(d, f"dofs{k}")[name]
                                          for k in sides], axis=1)
                          for name in ("__test__", wrt))
            data.append(d)
            maps.append((rows, cols))
            parts.append(np.repeat(np.arange(ndev), len(rows) // ndev))
        W = max(r.shape[1] + c.shape[1] for r, c in maps)
        combined = []
        for r, c in maps:
            rc = np.concatenate([r, c], axis=1)
            combined.append(np.concatenate(
                [rc, np.repeat(rc[:, :1], W - rc.shape[1], axis=1)], axis=1))
        op._setup(np.concatenate(combined), n_dofs, np.concatenate(parts),
                  mesh, free)
        chunks = []
        for r, c in maps:
            ce = len(r) // ndev
            sl = slice(mesh.rank * ce, (mesh.rank + 1) * ce)
            chunks.append((r[sl], c[sl]))
        op._set_maps(chunks)
        op.views = [_rank_view(t, d, mesh) for t, d in zip(terms, data)]
        return op

    def _setup(self, dofmap, n_dofs, part, mesh, free):
        """The layout from the entity partition `part` of `dofmap` (rows
        of each entity), this rank's entities (`cells`, increasing) and
        ghosts, the exchange tables and the owned free mask."""
        size, rank, dev = mesh.size, mesh.rank, mesh.device
        self.mesh = mesh
        self.n = int(n_dofs)
        lay = build_halo_layout(dofmap, self.n, part, size)
        self.layout = lay
        L, G, S = lay.L, lay.G, lay.S
        self.n_local = L + G
        self.collectives = dict(exchanges=0, all_reduces=0)

        sel = np.nonzero(part == rank)[0]
        self.cells = sel
        dofs = np.unique(dofmap[sel].reshape(-1))
        self.ghosts = dofs[lay.owner_of[dofs] != rank]
        # every rank's ghost count (the JAX halo Newton's info["ghosts"])
        self.ghost_counts = np.array([np.count_nonzero(lay.owner_of[
            np.unique(dofmap[part == d])] != d) for d in range(size)])

        def ti(a):
            return torch.as_tensor(np.asarray(a, np.int64), device=dev)

        # this rank's exchange tables: what it sends to each rank (forward)
        # and where what it receives goes (ghost slots; owned slots in
        # the reverse exchange)
        send_slot = lay.send_slot[rank].reshape(-1).astype(np.int64)
        send_mask = lay.send_mask[rank].reshape(-1)
        recv_slot = lay.recv_ghost_slot[rank].reshape(-1).astype(np.int64)
        recv_mask = lay.recv_mask[rank].reshape(-1)
        f = config.dtype
        self._send_slot = ti(send_slot)
        self._send_mask = torch.as_tensor(send_mask, dtype=f, device=dev)
        self._recv_slot = ti(recv_slot)
        self._recv_mask = torch.as_tensor(recv_mask, dtype=f, device=dev)
        self._recv_pos = ti(np.nonzero(recv_mask)[0])
        self._recv_dst = ti(recv_slot[recv_mask])
        # reverse: the ghost partials received add into owned slots,
        # several ranks' into one, summed in (rank, slot) order
        pos = np.nonzero(send_mask)[0]
        self._rev_table = OwnerTable(send_slot[pos], size * S, L, src=pos,
                                     device=dev)
        k = int(lay.n_owned[rank])
        self._owned = ti(lay.owned_global[rank, :k])
        self.free_l = None if free is None else \
            self.scatter_vector(np.asarray(_host(free), float)) > 0.5
        self._diag = None

    def _set_maps(self, blocks):
        """This rank's element blocks as (rows, cols) of global dof ids,
        indexed by local slots: owned dofs -> [0, L), ghosts -> L + their
        place in the sorted ghost list.  `local_rows` / `local_cols` are
        the first block's."""
        self.block_maps = [(self._to_local(r).astype(np.int64),
                            self._to_local(c).astype(np.int64))
                           for r, c in blocks]
        self.local_rows, self.local_cols = self.block_maps[0]
        self.n_elements = sum(len(r) for r, _ in self.block_maps)
        self._local_pattern = None
        self.local = None

    def _to_local(self, gdofs) -> np.ndarray:
        """Global dof ids (host, any shape) of this rank's cells -> its
        local slots: owned -> the owned slot, ghost -> L + ghost index."""
        lay, rank = self.layout, self.mesh.rank
        own = lay.owner_of[gdofs] == rank
        return np.where(own, lay.local_of[gdofs],
                        lay.L + np.searchsorted(self.ghosts, gdofs))

    def set_elements(self, A_local):
        """This rank's element values, the values of every later product:
        one (elements, nr, nc) tensor per block (a list; a tensor alone for
        a one-block operator), in the order of `cells` (`from_terms`: of
        each term's view).  K4's plan of each block and the diagonal's
        owner table are built once and kept across values."""
        As = [A_local] if isinstance(A_local, torch.Tensor) else list(A_local)
        if len(As) != len(self.block_maps):
            raise ValueError(f"{len(As)} element blocks for an operator of "
                             f"{len(self.block_maps)}")
        n = self.n_local
        if self._local_pattern is None:
            dev = self.mesh.device
            pats = []
            for r, c in self.block_maps:
                rows = torch.as_tensor(r, device=dev)
                cols = torch.as_tensor(c, device=dev)
                pats.append((rows, cols, ElementSpMVPlan(rows, cols, n, n)))
            self._local_pattern = (pats, {})
        pats, cache = self._local_pattern
        self.local = ElementMatrix(
            [MatBlock(A, rows, cols, plan)
             for A, (rows, cols, plan) in zip(As, pats)], n, n, cache=cache)
        self._diag = None

    # -- vector scatter/gather ------------------------------------------------
    def scatter_vector(self, x) -> torch.Tensor:
        """Global (n,) (host array or tensor) -> this rank's (L,) owned
        slots."""
        x = torch.as_tensor(_host(x), device=self.mesh.device)
        xl = x.new_zeros(self.layout.L)
        xl[: len(self._owned)] = x[self._owned]
        return xl

    def gather_vector(self, xl) -> torch.Tensor:
        """Every rank's (L,) owned slots -> the global (n,), on every rank
        (one all-reduce of the disjoint parts: exact)."""
        out = xl.new_zeros(self.n)
        out[self._owned] = xl[: len(self._owned)]
        return self.all_reduce(out)

    def all_reduce(self, t) -> torch.Tensor:
        """t summed over the ranks (in place; one collective), the same on
        every rank."""
        self.collectives["all_reduces"] += 1
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.mesh.group)
        return t

    # -- halo exchanges -------------------------------------------------------
    def _exchange(self, send, sums=None):
        """One all_to_all_single of the (ranks * S,) send lists.  With
        `sums`, this rank's (k,) partial sums ride along to every rank:
        (recv, their totals over the ranks, summed in rank order, the
        same on every rank)."""
        self.collectives["exchanges"] += 1
        if sums is None:
            recv = torch.empty_like(send)
            dist.all_to_all_single(recv, send, group=self.mesh.group)
            return recv
        n = self.mesh.size
        buf = torch.cat([send.view(n, -1), sums.expand(n, -1)], dim=1)
        recv = torch.empty_like(buf)
        dist.all_to_all_single(recv, buf, group=self.mesh.group)
        S = self.layout.S
        return recv[:, :S].reshape(-1), recv[:, S:].sum(dim=0)

    def fwd_halo(self, x_own, sums=None):
        """Owner values -> this rank's ghost slots (INSERT), (G,); with
        `sums` (k,) partial sums, also their totals (`_exchange`)."""
        out = self._exchange(x_own[self._send_slot] * self._send_mask, sums)
        recv = out if sums is None else out[0]
        ghosts = x_own.new_zeros(self.layout.G)
        ghosts[self._recv_dst] = recv[self._recv_pos]
        return ghosts if sums is None else (ghosts, out[1])

    def rev_halo(self, gh_partial, sums=None):
        """Ghost partial sums -> their owners' slots (ADD), (L,): the
        reverse of fwd_halo; with `sums`, also their totals."""
        out = self._exchange(gh_partial[self._recv_slot] * self._recv_mask,
                             sums)
        if sums is None:
            return self._rev_table.sum(out)
        return self._rev_table.sum(out[0]), out[1]

    def local_matvec(self, x_own, transpose=False) -> torch.Tensor:
        """Forward halo, K4 (transpose: K4T) on the rank's element blocks
        (the plain versions on CPU tensors), reverse halo.  The transpose
        gathers at the row maps and scatters at the column maps, both
        local slots, so the same two exchanges serve it."""
        L = self.layout.L
        x_loc = torch.cat([x_own, self.fwd_halo(x_own)])
        y_loc = (self.local.rmatvec if transpose
                 else self.local.matvec)(x_loc)
        return y_loc[:L] + self.rev_halo(y_loc[L:])

    def matvec(self, xl, transpose=False) -> torch.Tensor:
        """The sharded matvec (transpose: with A^T); with BCs the
        constrained operator P A P + (I - P) (zero rows and columns, unit
        diagonal), whose transpose is P A^T P + (I - P)."""
        if self.free_l is None:
            return self.local_matvec(xl, transpose)
        y = self.local_matvec(torch.where(self.free_l, xl, 0.0), transpose)
        return torch.where(self.free_l, y, xl)

    def dot(self, xl, yl) -> torch.Tensor:
        """The global dot product: one all-reduce of the rank's partial
        dot over its owned slots."""
        return self.all_reduce(torch.dot(xl, yl).reshape(1))[0]

    # -- diagonal (local Jacobi preconditioning) -----------------------------
    def diagonal(self) -> torch.Tensor:
        """Owned-slot diagonal of the constrained operator, (L,): each
        block's entries whose row and column are one local slot (the JAX
        halo Newton's rule, which also takes an interior facet's two
        copies of a shared dof), summed per slot, the ghost partials sent
        to their owners; exact zeros and constrained or padding slots ->
        1.  The same for A^T.  Kept after the first call."""
        if self._diag is None:
            L = self.layout.L
            blocks = self.local.blocks
            cache = self._local_pattern[1]
            if "halo_diagonal" not in cache:
                cache["halo_diagonal"] = OwnerTable(
                    np.concatenate([r.reshape(-1)
                                    for r, _ in self.block_maps]),
                    sum(r.size for r, _ in self.block_maps), self.n_local,
                    device=self.mesh.device)
            d_loc = cache["halo_diagonal"].sum(torch.cat([
                (b.A * (b.rows[:, :, None] == b.cols[:, None, :])).sum(
                    dim=2).reshape(-1) for b in blocks]))
            d = d_loc[:L] + self.rev_halo(d_loc[L:])
            d = torch.where(torch.abs(d) < 1e-30, 1.0, d)
            if self.free_l is not None:
                d = torch.where(self.free_l, d, 1.0)
            self._diag = d
        return self._diag

    # -- distributed CG -------------------------------------------------------
    def cg(self, bl, rtol=1e-10, maxiter=2000, jacobi=True, precond=None,
           transpose=False):
        """Preconditioned CG on sharded vectors: (x (L,), iterations, ||r||
        as a tensor); transpose: on A^T, its products K4T (the IFT
        adjoint of a symmetric Jacobian, as the JAX halo Newton runs
        it).  The preconditioner is rank-local: `precond`, a
        callable r -> z on owned slots, when it is given (the halo steps'
        block Jacobi and Chebyshev), else the owned diagonal (jacobi=True)
        or none.  Each iteration is one matvec and one preconditioner
        application (so iterations + 1 of each in all, the first for the
        initial residual), and two exchanges that carry the dot products
        with them: the reverse exchange of the matvec carries each rank's
        partial p.Ap (over its local slots, ghost copies included, which
        sums to the owned-slot dot), and the forward exchange of the next
        search direction carries r.z and r.r, the ghost copies of p being
        updated as p itself is.  So an iteration makes two collectives,
        where the JAX package's makes two exchanges and psums.  The
        stopping test reads the summed ||r||^2, the same number on every
        rank, so all ranks leave together."""
        if precond is None:
            Minv = 1.0 / self.diagonal() if jacobi else None

            def precond(r):
                return r * Minv if jacobi else r

        free, L = self.free_l, self.layout.L

        def masked(v):  # what the constrained operator multiplies
            return v if free is None else torch.where(free, v, 0.0)

        def matvec_dot(p, pg):
            """(A p, p.A p) from p and the ghost copies pg of masked(p)."""
            x_loc = torch.cat([masked(p), pg])
            y_loc = (self.local.rmatvec if transpose
                     else self.local.matvec)(x_loc)
            part = torch.dot(x_loc, y_loc)
            if free is not None:  # the unit rows of constrained slots
                pc = torch.where(free, 0.0, p)
                part = part + torch.dot(pc, pc)
            rev, (pAp,) = self.rev_halo(y_loc[L:], part.reshape(1))
            y = y_loc[:L] + rev
            return (y if free is None else torch.where(free, y, p)), pAp

        def direction(r, z, *more):
            """Ghost copies of masked(z), and r.z, r.r (and the dots of
            `more` pairs) summed over the ranks, in one exchange."""
            return self.fwd_halo(masked(z), torch.stack(
                [torch.dot(a, b) for a, b in ((r, z), (r, r)) + more]))

        x = torch.zeros_like(bl)
        r = bl - self.matvec(x, transpose)
        z = precond(r)
        pg, (rz, rr, b2) = direction(r, z, (bl, bl))
        p = z
        stop = rtol**2 * float(b2)
        k = 0
        while k < maxiter and float(rr) > stop:
            Ap, pAp = matvec_dot(p, pg)
            alpha = rz / pAp
            x = x + alpha * p
            r = r - alpha * Ap
            z = precond(r)
            zg, (rz_new, rr) = direction(r, z)
            beta = rz_new / rz
            p = z + beta * p
            pg = zg + beta * pg
            rz = rz_new
            k += 1
        return x, k, torch.sqrt(rr)

    # -- distributed restarted GMRES ------------------------------------------
    def gmres(self, bl, rtol=1e-12, maxiter=20000, restart=50,
              transpose=False):
        """Restarted GMRES(m), m = min(restart, maxiter), on sharded
        vectors, right-preconditioned by the point Jacobi (`diagonal`):
        (x (L,), cycles, ||b - A x|| as a float); transpose: on A^T (K4T).

        The JAX package's halo GMRES (femo_tpu/parallel/halo_newton.py:
        262-331) step for step: from x = 0, while the true residual norm
        exceeds max(rtol ||b||, eps) and fewer than ceil(maxiter / m)
        cycles ran, a cycle restarts from r = b - A x, runs all m Arnoldi
        steps on w = A (v_j / d), Givens-rotates each Hessenberg column,
        solves the triangle (a zero pivot taken as 1), updates x and
        recomputes the true residual.  So a solve makes 1 + cycles (m + 2)
        products, K4 (K4T) once per element block each.

        Departure: the Arnoldi step orthogonalizes by classical Gram-
        Schmidt with one reorthogonalization (CGS2), where the JAX
        package's modified Gram-Schmidt psums each of its m dots in turn.
        Pass 1 sends the j + 1 partial dots V_{0..j} . w in one
        all-reduce and subtracts; pass 2 sends the j + 1 dots again with
        ||w||^2 in a second all-reduce and subtracts the correction, and
        the new norm is sqrt(||w||^2 - ||h_2||^2) (V orthonormal; floored
        at 0).  An Arnoldi step therefore makes 4 collectives whatever j
        and m: the product's 2 halo exchanges and 2 all-reduces.  A cycle
        adds 2 products and 2 all-reduces (the norms of its first and last
        residual), the start 1 product and 1 all-reduce (||b||^2 with
        ||r_0||^2).  Same Krylov space, other rounding: cycle counts may
        differ by a cycle where a solve ends near a cycle's end.  The
        Hessenberg columns, rotations and stopping test are computed on
        the host from the all-reduced sums, the same numbers on every
        rank, so every rank takes the same branch and leaves together."""
        Minv = 1.0 / self.diagonal()
        L = self.layout.L
        m = int(min(restart, maxiter))
        eps = torch.finfo(bl.dtype).tiny * 1e3
        n_cycles = max(1, -(-int(maxiter) // m))

        def A(v):
            return self.matvec(v, transpose)

        def norm(v):
            return math.sqrt(float(self.dot(v, v)))

        r0 = bl - A(torch.zeros_like(bl))
        b2, r2 = self.all_reduce(torch.stack([torch.dot(bl, bl),
                                              torch.dot(r0, r0)])).tolist()
        tol = max(rtol * math.sqrt(b2), eps)
        rn, k = math.sqrt(r2), 0
        x = torch.zeros_like(bl)
        V = bl.new_zeros(m + 1, L)
        while rn > tol and k < n_cycles:
            r = bl - A(x)
            beta = norm(r)
            V.zero_()
            V[0] = r / max(beta, eps)
            H = np.zeros((m, m))
            cs, sn = np.ones(m), np.zeros(m)
            g = np.zeros(m + 1)
            g[0] = beta
            for j in range(m):
                w = A(V[j] * Minv)
                Vj = V[: j + 1]
                h = self.all_reduce(Vj @ w)
                w = w - h @ Vj
                s = self.all_reduce(torch.cat([Vj @ w,
                                               torch.dot(w, w).reshape(1)]))
                h2 = s[: j + 1]
                w = w - h2 @ Vj
                col = torch.cat([h + h2, (s[j + 1] - torch.dot(h2, h2))
                                 .reshape(1)]).tolist()
                hcol = np.zeros(m + 1)
                hcol[: j + 1] = col[: j + 1]
                hcol[j + 1] = math.sqrt(max(col[j + 1], 0.0))
                V[j + 1] = w / max(hcol[j + 1], eps)
                for i in range(j):
                    t1 = cs[i] * hcol[i] + sn[i] * hcol[i + 1]
                    t2 = -sn[i] * hcol[i] + cs[i] * hcol[i + 1]
                    hcol[i], hcol[i + 1] = t1, t2
                d = math.sqrt(hcol[j] ** 2 + hcol[j + 1] ** 2)
                cs[j] = hcol[j] / max(d, eps)
                sn[j] = hcol[j + 1] / max(d, eps)
                g[j + 1] = -sn[j] * g[j]
                g[j] = cs[j] * g[j]
                hcol[j], hcol[j + 1] = d, 0.0
                H[:, j] = hcol[:m]
            Hd = H + np.diag((np.abs(np.diag(H)) < eps).astype(float))
            y = scipy.linalg.solve_triangular(Hd, g[:m], lower=False)
            x = x + (torch.as_tensor(y, dtype=bl.dtype, device=bl.device)
                     @ V[:m]) * Minv
            rn = norm(bl - A(x))
            k += 1
        return x, k, rn
