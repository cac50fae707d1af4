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

Departures, each for the process-per-rank model: vectors are this rank's
(L,) owned slots, where the JAX package stacks every device's as an
(ndev, L) array on one host; each rank keeps its own elements unpadded,
where the JAX package pads every device to the largest count with a mask;
`cg` is a Python loop in place of `lax.while_loop`, whose stopping test
reads the summed residual, so every rank leaves on the same iteration,
and whose dot products ride on the halo exchanges (two collectives an
iteration, see `cg`).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from .. import native
from ..config import config
from ..fea.assemble import ElementMatrix, MatBlock, _host
from ..ops.scatter import OwnerTable
from ..ops.spmv import ElementSpMVPlan
from .sharding import RankMesh


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
    being P A P + (I - P) as on one device.  Or `from_cells` and
    `set_elements` (see there).  Vectors are this rank's (L,) owned slots
    (padding slots 0).  Every method that communicates (`matvec`, `dot`,
    `diagonal`, `gather_vector`, `cg`) must be called by every rank in the
    same order."""

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
        self._setup(rows, cols, n_dofs, part, mesh, free)
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
        op._setup(dofmap, dofmap, n_dofs, np.asarray(part), mesh, free)
        return op

    def _setup(self, rows, cols, n_dofs, part, mesh, free):
        """The layout from the cell partition `part`, this rank's cells
        (`cells`, increasing) with their local slots, the exchange tables
        and the owned free mask."""
        size, rank, dev = mesh.size, mesh.rank, mesh.device
        self.mesh = mesh
        self.n = int(n_dofs)
        lay = build_halo_layout(rows, self.n, part, size)
        self.layout = lay
        L, G, S = lay.L, lay.G, lay.S
        self.n_local = L + G

        # this rank's elements, indexed by local slots: owned dofs ->
        # [0, L), ghosts -> L + their place in the sorted ghost list
        sel = np.nonzero(part == rank)[0]
        self.cells = sel
        dofs = np.unique(rows[sel].reshape(-1))
        self.ghosts = dofs[lay.owner_of[dofs] != rank]
        self.local_rows = self._to_local(rows[sel]).astype(np.int64)
        self.local_cols = self._to_local(cols[sel]).astype(np.int64)
        self._local_pattern = None
        self.local = None
        self.n_elements = len(sel)

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

    def _to_local(self, gdofs) -> np.ndarray:
        """Global dof ids (host, any shape) of this rank's cells -> its
        local slots: owned -> the owned slot, ghost -> L + ghost index."""
        lay, rank = self.layout, self.mesh.rank
        own = lay.owner_of[gdofs] == rank
        return np.where(own, lay.local_of[gdofs],
                        lay.L + np.searchsorted(self.ghosts, gdofs))

    def set_elements(self, A_local: torch.Tensor):
        """This rank's element blocks (n_elements, nr, nc), in the order of
        `cells`: the values of every later product.  K4's plan and the
        diagonal's owner table are built once and kept across values."""
        n = self.n_local
        if self._local_pattern is None:
            dev = self.mesh.device
            rows = torch.as_tensor(self.local_rows, device=dev)
            cols = torch.as_tensor(self.local_cols, device=dev)
            self._local_pattern = (rows, cols,
                                   ElementSpMVPlan(rows, cols, n, n), {})
        rows, cols, plan, cache = self._local_pattern
        self.local = ElementMatrix([MatBlock(A_local, rows, cols, plan)], n,
                                   n, cache=cache)
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
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=self.mesh.group)
        return out

    # -- halo exchanges -------------------------------------------------------
    def _exchange(self, send, sums=None):
        """One all_to_all_single of the (ranks * S,) send lists.  With
        `sums`, this rank's (k,) partial sums ride along to every rank:
        (recv, their totals over the ranks, summed in rank order, the
        same on every rank)."""
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

    def local_matvec(self, x_own) -> torch.Tensor:
        """Forward halo, K4 on the rank's elements (its plain version on
        CPU tensors), reverse halo."""
        L = self.layout.L
        x_loc = torch.cat([x_own, self.fwd_halo(x_own)])
        y_loc = self.local.matvec(x_loc)
        return y_loc[:L] + self.rev_halo(y_loc[L:])

    def matvec(self, xl) -> torch.Tensor:
        """The sharded matvec; with BCs the constrained operator P A P +
        (I - P) (zero rows and columns, unit diagonal)."""
        if self.free_l is None:
            return self.local_matvec(xl)
        y = self.local_matvec(torch.where(self.free_l, xl, 0.0))
        return torch.where(self.free_l, y, xl)

    def dot(self, xl, yl) -> torch.Tensor:
        """The global dot product: one all-reduce of the rank's partial
        dot over its owned slots."""
        d = torch.dot(xl, yl).reshape(1)
        dist.all_reduce(d, op=dist.ReduceOp.SUM, group=self.mesh.group)
        return d[0]

    # -- diagonal (local Jacobi preconditioning) -----------------------------
    def diagonal(self) -> torch.Tensor:
        """Owned-slot diagonal of the constrained operator, (L,): the
        rank's element diagonal, its ghost partials sent to their owners;
        exact zeros and constrained or padding slots -> 1.  Kept after
        the first call."""
        if self._diag is None:
            L = self.layout.L
            d_loc = self.local.diagonal()
            d = d_loc[:L] + self.rev_halo(d_loc[L:])
            d = torch.where(torch.abs(d) < 1e-30, 1.0, d)
            if self.free_l is not None:
                d = torch.where(self.free_l, d, 1.0)
            self._diag = d
        return self._diag

    # -- distributed CG -------------------------------------------------------
    def cg(self, bl, rtol=1e-10, maxiter=2000, jacobi=True, precond=None):
        """Preconditioned CG on sharded vectors: (x (L,), iterations, ||r||
        as a tensor).  The preconditioner is rank-local: `precond`, a
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
            y_loc = self.local.matvec(x_loc)
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
        r = bl - self.matvec(x)
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
