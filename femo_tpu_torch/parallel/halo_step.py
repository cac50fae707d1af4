"""Workload steps with a distributed linear solve: mode b, the
dof-sharded halo CG, inside the W6 shell step and the coupled FSI step
(port of femo_tpu/parallel/halo_step.py).

Each rank is a process (`launch.spawn`) with a `sharding.RankMesh`.  The
cells are partitioned by the native RCB of their centroids, and the
halo operator (parallel/halo.py, `HaloShardedOperator.from_cells`) is
laid out over the composite dofmap [u dofs | theta dofs + off]:

  * each rank assembles only its own cells' composite (u, theta)
    Jacobian blocks, 27 x 27 on triangles (CG2 u: 18 dofs, CG1 theta: 9);
  * the solve is a preconditioned CG on owned slots: per iteration K4
    on the rank's blocks between a forward and a reverse halo exchange,
    which carry the dot products (`HaloShardedOperator.cg`, with the
    preconditioner passed in);
  * the preconditioner is point Jacobi, Chebyshev on Jacobi
    (`cheby_degree`), or block Jacobi (`precond="bjacobi"`): each rank's
    owned diagonal block, assembled in full (the matrix halo ships the
    entries that other ranks' cells give it, once a factor), ordered by
    RCM, factored by block Thomas in f64 and applied by K1 then K2 with no
    communication;
  * the solve is a `torch.autograd.Function` whose backward runs the
    same distributed CG on the cotangent (the energy Hessian is
    symmetric) and takes the residual's VJP in the thickness and the
    force, so the whole gradient is distributed too.

The residual and the compliance come from mode a (`sharding.py`); only
the DG0 thickness, the force and the gathered state are replicated.

Departures, each for the process-per-rank model:
  * Each rank keeps its own cells unpadded: the cell count must split
    into equal RCB parts (it does at every shape driven here, which all
    have a multiple of 4 cells); otherwise `_halo_shell_core` raises,
    where the JAX package pads every device by repeats of cell 0.
  * Block Jacobi: each rank builds only its own template, and the
    shared block size Bj = max(128, round_up(max bandwidth, 128)) comes
    from one all_reduce(MAX) of the ranks' RCM bandwidths, where the JAX
    package builds every device's template on one host.  The blocks come
    out the same.  The factor is the port's `BlockTridiagonalMatrix
    .factor()` (LU block inverses), where the JAX package's scan inverts
    by QR/Cholesky: the preconditioner rounds differently, and CG
    iteration counts may differ by a few.
  * The adjoint reuses its forward's assembled blocks and factor (the
    same thickness), where the JAX package's custom_vjp assembles and
    factors again.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch
import torch.distributed as dist

from .. import native
from ..config import config
from ..fea.assemble import _host, compile_form
from ..ops.block_tridiag import BlockTridiagTemplate, _round_up
from ..ops.scatter import OwnerTable
from .halo import HaloShardedOperator
from .sharding import (RankMesh, _rank_term, sharded_scalar_fn,
                       sharded_vector_fn)

# power iterations of the Chebyshev preconditioner's lam_max estimate and
# its assumed spread lam_max / lam_min (the JAX package's)
CHEBY_POWER_ITERS = 12
CHEBY_RATIO = 30.0


def composite_partition(ucf, tcf, off: int, ndev: int):
    """(comp, part): the composite per-cell dofmap [u dofs | theta dofs +
    off] of the u and theta residual forms' one cell term each, and the
    native RCB partition of the cell centroids into ndev parts.  Raises
    ValueError unless every part holds n_cells / ndev cells (the ranks
    are unpadded, see the module's departures)."""
    (tu,), (tt,) = ucf.terms, tcf.terms
    comp = np.concatenate([tu.host_rows("__test__"),
                           tt.host_rows("__test__") + off], axis=1)
    part = native.rcb_partition(_host(tu.coords0).mean(axis=1), ndev)
    counts = np.bincount(part, minlength=ndev)
    if not np.all(counts == len(part) // ndev) or len(part) % ndev:
        raise ValueError(f"{len(part)} cells do not split into {ndev} equal "
                         f"RCB parts ({counts.tolist()}): the halo steps "
                         "keep every rank unpadded")
    return comp, part


def _matrix_halo_pairs(comp, part, owner_of, free, n_dofs, ndev):
    """The matrix halo of every (source e, owner d) pair: the entries
    (i, j) of e's cells whose dofs are both owned by one other rank d and
    both free, as (keys, flat, inv): the sorted unique keys i * n + j that
    e sends to d, the flat element-entry index (cell in e's order, row,
    column) of each entry, and its key's place in `keys`.  Every rank
    computes all pairs from the whole mesh (the JAX package's host
    analysis)."""
    ndc = comp.shape[1]
    pairs = {}
    for e in range(ndev):
        cells = comp[part == e]
        bmask = (owner_of[cells] != e).any(axis=1)
        if not bmask.any():
            continue
        cell_ids = np.nonzero(bmask)[0]
        cg = cells[bmask]
        nbc = len(cg)
        gi = np.broadcast_to(cg[:, :, None], (nbc, ndc, ndc))
        gj = np.broadcast_to(cg[:, None, :], (nbc, ndc, ndc))
        oi = owner_of[gi]
        sel = (oi == owner_of[gj]) & (oi != e) & free[gi] & free[gj]
        if not sel.any():
            continue
        ii, jj, kk = np.nonzero(sel)
        flat = (cell_ids[ii] * ndc + jj) * ndc + kk
        key = gi[sel].astype(np.int64) * n_dofs + gj[sel]
        own = oi[sel]
        for d in np.unique(own):
            m = own == d
            keys, inv = np.unique(key[m], return_inverse=True)
            pairs[(e, int(d))] = (keys, flat[m], inv)
    return pairs


class BlockJacobi:
    """The per-rank block-Jacobi preconditioner of a `from_cells` halo
    operator: this rank's owned principal submatrix of the global
    operator, ordered by RCM over the rank's local slots, factored by
    block Thomas, applied by K1 then K2 (the plain sweeps on CPU tensors)
    with no communication.

    Ghost slots and constrained or padding owned slots are not free in
    the local template: their entries drop and their rows are identity.
    The owned blocks are assembled in full: an entry whose dofs are both
    owned here but which comes from another rank's cell arrives in one
    `all_to_all_single` at fill time (`matrix_halo`).  Construction
    makes one collective (the all_reduce(MAX) of the bandwidths), and
    every call of `matrix_halo` (so of `factor`) one more; every rank
    makes them in the same order."""

    def __init__(self, op: HaloShardedOperator, comp, part, free_np):
        mesh, lay = op.mesh, op.layout
        ndev, me, n = mesh.size, mesh.rank, op.n
        self.op = op
        pairs = _matrix_halo_pairs(comp, part, lay.owner_of, free_np, n,
                                   ndev)
        S = max([len(v[0]) for v in pairs.values()] or [1])
        self.S = S
        n_el = op.n_elements * comp.shape[1] ** 2
        # export: this rank's element entries -> its (ndev, S) send buffer
        exp = [(d * S + inv, flat) for (e, d), (_, flat, inv)
               in sorted(pairs.items()) if e == me]
        dest = np.concatenate([x[0] for x in exp]) if exp else np.zeros(0)
        src = np.concatenate([x[1] for x in exp]) if exp else np.zeros(0)
        self._export = OwnerTable(dest, n_el, ndev * S, src=src,
                                  device=mesh.device)
        # import: what each source sends this rank, in source order; its
        # keys enter the local template's pattern as 1 x 1 blocks, so the
        # RCM sees them and the fill sums them
        imp = [(e, pairs[(e, me)][0]) for e in range(ndev)
               if (e, me) in pairs]
        keys = np.concatenate([k for _, k in imp]) if imp else \
            np.zeros(0, np.int64)
        self._recv_pos = torch.as_tensor(
            np.concatenate([e * S + np.arange(len(k)) for e, k in imp])
            if imp else np.zeros(0, np.int64), device=mesh.device)
        self.n_import = len(keys)
        self.n_export = int(sum(len(x[1]) for x in exp))
        blocks = [SimpleNamespace(rows=op.local_rows, cols=op.local_cols)]
        if self.n_import:
            blocks.append(SimpleNamespace(
                rows=lay.local_of[keys // n].astype(np.int64)[:, None],
                cols=lay.local_of[keys % n].astype(np.int64)[:, None]))
        pattern = SimpleNamespace(blocks=blocks,
                                  shape=(op.n_local, op.n_local))
        free_loc = np.zeros(op.n_local, bool)
        free_loc[: lay.L] = _host(op.free_l)
        tpl = BlockTridiagTemplate(pattern, free=free_loc,
                                   device=mesh.device)
        bw = torch.tensor([tpl.bw], dtype=torch.int64, device=mesh.device)
        dist.all_reduce(bw, op=dist.ReduceOp.MAX, group=mesh.group)
        self.B = max(128, _round_up(int(bw[0]), 128))
        if self.B != tpl.B:
            tpl = BlockTridiagTemplate(pattern, free=free_loc, block=self.B,
                                       device=mesh.device)
        self.template = tpl
        self.bw = tpl.bw
        self.nb = tpl.nb

    def matrix_halo(self, A) -> torch.Tensor:
        """This rank's element blocks A -> the matrix-halo entries it
        imports, (n_import,): one all_to_all_single of the (ranks, S)
        buffers of pair sums."""
        send = self._export.sum(A.reshape(-1))
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=self.op.mesh.group)
        return recv[self._recv_pos]

    def fill(self, A, imported):
        """The rank's owned block, block-tridiagonal after RCM
        (`BlockTridiagonalMatrix`), from its element blocks and the
        imported entries."""
        blocks = [(A, None, None)]
        if self.n_import:
            blocks.append((imported.reshape(-1, 1, 1), None, None))
        return self.template.matrix(blocks)

    def factor(self, A):
        """matrix_halo, fill and the f64 block-Thomas factor."""
        return self.fill(A, self.matrix_halo(A)).factor()

    def apply(self, fac, r):
        """z = M^{-1} r on owned slots: the factor's K1 + K2 solve on the
        local slots (ghosts 0), constrained and padding slots passed
        through."""
        op = self.op
        x = fac.solve(torch.cat([r, r.new_zeros(op.layout.G)]))
        return torch.where(op.free_l, x[: op.layout.L], r)


def chebyshev(op: HaloShardedOperator, Minv, degree: int):
    """The Chebyshev polynomial of the Jacobi-scaled operator as a CG
    preconditioner (the JAX package's): lam_max of D^-1 A from
    CHEBY_POWER_ITERS distributed power iterations (all-reduced norms),
    times 1.02, lam_min = lam_max / CHEBY_RATIO; each application costs
    degree - 1 matvecs."""
    v = op.free_l.to(Minv.dtype)
    v = v / torch.sqrt(op.dot(v, v))
    lam = None
    for _ in range(CHEBY_POWER_ITERS):
        w = Minv * op.matvec(v)
        lam = torch.sqrt(op.dot(w, w))
        v = w / (lam + 1e-30)
    lam_max = 1.02 * lam
    lam_min = lam_max / CHEBY_RATIO
    theta = 0.5 * (lam_max + lam_min)
    delta = 0.5 * (lam_max - lam_min)
    sigma1 = theta / delta

    def apply(r):
        d = Minv * r / theta
        xk, rho_prev = d, 1.0 / sigma1
        for _ in range(1, degree):
            res = Minv * (r - op.matvec(xk))
            rho = 1.0 / (2.0 * sigma1 - rho_prev)
            d = rho * rho_prev * d + (2.0 * rho / delta) * res
            xk, rho_prev = xk + d, rho
        return torch.where(op.free_l, xk, r)

    return apply


class HaloShellCore:
    """The distributed-solve core of the shell and FSI halo steps on one
    rank (see `_halo_shell_core`).  `prepare(thick)` assembles the rank's
    element blocks and builds the preconditioner (a `system`); `cg(system,
    b)` solves on it; `solve` is the differentiable solve.  `iterations`
    lists every CG's iteration count, in order."""

    def __init__(self, shell, state, mesh: RankMesh, cg_rtol, cg_maxiter,
                 cheby_degree, precond):
        if not isinstance(mesh, RankMesh):
            raise TypeError("the halo steps run on the ranks of a "
                            "parallel.sharding.RankMesh (launch.spawn), got "
                            f"{type(mesh).__name__}")
        if precond not in ("jacobi", "bjacobi"):
            raise ValueError(f"precond={precond!r}: 'jacobi' or 'bjacobi'")
        if torch.any(state.bc_values != 0):
            raise ValueError("the halo core assumes homogeneous Dirichlet "
                             "values")
        self.mesh = mesh
        self.rtol, self.maxiter = cg_rtol, cg_maxiter
        self.cheby_degree, self.precond = int(cheby_degree), precond
        self.off = off = shell.Vu.n_dofs
        self.n_dofs = n = state.n_dofs
        self.free = state.free
        ucf = compile_form(shell.res_u)
        tcf = compile_form(shell.res_th)
        self.ccf = compile_form(shell.compliance_form)
        comp, part = composite_partition(ucf, tcf, off, mesh.size)
        self.op = HaloShardedOperator.from_cells(comp, n, part, mesh,
                                                 free=state.free)
        self.ghosts = self.op.ghost_counts
        self.bjacobi = None
        if precond == "bjacobi":
            self.bjacobi = BlockJacobi(self.op, comp, part,
                                       _host(state.free).astype(bool))
        # this rank's cells of each form, in the operator's cell order
        self._views = [_rank_term(cf.terms[0], mesh)[0] for cf in (ucf, tcf)]
        dev, f = mesh.device, config.dtype
        self._zeros = {"u": torch.zeros(off, dtype=f, device=dev),
                       "theta": torch.zeros(shell.Vth.n_dofs, dtype=f,
                                            device=dev),
                       "force": torch.zeros(shell.Vf.n_dofs, dtype=f,
                                            device=dev)}
        self._rfn = [sharded_vector_fn(cf, mesh) for cf in (ucf, tcf)]
        self.c_fn = sharded_scalar_fn(self.ccf, mesh)
        self.iterations = []

    # -- assembly ---------------------------------------------------------
    def assemble(self, thick) -> torch.Tensor:
        """The rank's composite element blocks at `thick`, (cells, 27,
        27) on triangles: [[A_uu, A_ut], [A_tu, A_tt]].  The Jacobian does
        not depend on the force (the load is linear) or the state (the
        shell is linear): zeros keep the coefficient set whole."""
        vals = dict(self._zeros, thickness=thick.detach())
        vu, vt = self._views
        with torch.no_grad():
            rows = [torch.cat([v.matrix_blocks(vals, "__test__", wrt)[0]
                               for wrt in ("u", "theta")], dim=2)
                    for v in (vu, vt)]
        return torch.cat(rows, dim=1).contiguous()

    def residual(self, x, thick, farr):
        """The composite residual R(x; thick, force), replicated (mode
        a)."""
        vals = {"u": x[: self.off], "theta": x[self.off:],
                "thickness": thick, "force": farr}
        return torch.cat([fn(vals) for fn in self._rfn])

    # -- the solve --------------------------------------------------------
    def prepare(self, thick):
        """(A, preconditioner): the rank's element blocks at `thick`, set
        as the operator's values, and the preconditioner built on them."""
        op = self.op
        A = self.assemble(thick)
        op.set_elements(A)
        if self.bjacobi is not None:
            fac = self.bjacobi.factor(A)
            return A, lambda r: self.bjacobi.apply(fac, r)
        Minv = 1.0 / op.diagonal()
        if self.cheby_degree > 0:
            return A, chebyshev(op, Minv, self.cheby_degree)
        return A, lambda r: r * Minv

    def cg(self, system, b_rep):
        """The halo CG on `system` (from `prepare`) of the replicated
        right-hand side b_rep: the gathered x, replicated."""
        A, precond = system
        op = self.op
        if op.local.blocks[0].A is not A:
            op.set_elements(A)
        b = torch.where(op.free_l, op.scatter_vector(b_rep), 0.0)
        x, k, _ = op.cg(b, rtol=self.rtol, maxiter=self.maxiter,
                        precond=precond)
        self.iterations.append(k)
        return op.gather_vector(x)

    def halo_cg(self, thick, b_rep):
        """(x, iterations): prepare at `thick`, then the CG of b_rep."""
        x = self.cg(self.prepare(thick), b_rep)
        return x, self.iterations[-1]

    def solve(self, thick, farr):
        """x(thick, force) on the free dofs (R(x) = 0), differentiable in
        both (`_HaloSolve`)."""
        return _HaloSolve.apply(thick, farr, self)


class _HaloSolve(torch.autograd.Function):
    """The forward solves A x = -R(0) on the free dofs; the backward
    solves A psi = xbar on the free dofs with the same distributed CG on
    the forward's blocks and preconditioner, then returns minus the
    residual's VJP with psi in the thickness and the force."""

    @staticmethod
    def forward(ctx, thick, farr, core):
        zeros = torch.zeros(core.n_dofs, dtype=thick.dtype,
                            device=thick.device)
        system = core.prepare(thick)
        b = torch.where(core.free, -core.residual(zeros, thick, farr), 0.0)
        x = core.cg(system, b)
        ctx.core, ctx.system = core, system
        ctx.save_for_backward(x, thick, farr)
        return x

    @staticmethod
    def backward(ctx, xbar):
        x, thick, farr = ctx.saved_tensors
        core = ctx.core
        psi = core.cg(ctx.system, torch.where(core.free, xbar, 0.0))
        with torch.enable_grad():
            t = thick.detach().requires_grad_(True)
            f = farr.detach().requires_grad_(True)
            tbar, fbar = torch.autograd.grad(core.residual(x, t, f), (t, f),
                                             psi)
        return -tbar, -fbar, None


def _halo_shell_core(mesh, shell, state, device_mesh, cg_rtol, cg_maxiter,
                     cheby_degree: int = 0, precond: str = "jacobi"):
    """The distributed-solve core shared by the shell and FSI halo steps,
    on this rank of `device_mesh` (a RankMesh; every rank calls it).

    Returns a dict: `solve(thick, farr) -> x` (differentiable in both),
    `halo_cg(thick, b) -> (x, iterations)`, the distributed `residual`,
    the sharded compliance `c_fn`, the layout `lay`, `off`, `n_dofs`, the
    BC mask `free`, the ghosts of every rank `ghosts`, bjacobi's block
    size and count `bj` (dict(B, nb); None otherwise), and `core`, the
    HaloShellCore (its operator `op`, `bjacobi`, `assemble`,
    `iterations`).

    precond: "jacobi" (the point diagonal; with cheby_degree > 0 the
    Chebyshev polynomial on it) or "bjacobi" (`BlockJacobi`, the one that
    converges at workload scale: the Jacobi-scaled shell at (24, 400) has
    cond ~6.6e7, hopeless for point-Jacobi CG); cheby_degree applies only
    to "jacobi".  `mesh` (the cell mesh) is unused, as in the JAX
    package."""
    core = HaloShellCore(shell, state, device_mesh, cg_rtol, cg_maxiter,
                         cheby_degree, precond)
    bj = core.bjacobi
    return dict(solve=core.solve, halo_cg=core.halo_cg,
                residual=core.residual, c_fn=core.c_fn,
                lay=core.op.layout, off=core.off, n_dofs=core.n_dofs,
                free=core.free, ghosts=core.ghosts,
                bj=None if bj is None else dict(B=bj.B, nb=bj.nb),
                core=core)


def build_shell_halo_step(n_shell=(4, 6), span=2.0, chord=1.0,
                          E=7e10, nu=0.3, thickness=0.01, pressure=2.0e3,
                          device_mesh=None, cg_rtol=1e-12,
                          cg_maxiter=20000, cheby_degree=0,
                          precond="jacobi"):
    """The cells-partitioned CG2CG1 shell compliance step whose linear
    solve is dof-sharded: thickness -> (compliance, d compliance / d
    thickness), on this rank of `device_mesh` (every rank calls it and
    the step), on the rank's device (the card unless the ranks were
    started with device="cpu").

    Returns (step, t0, info); info has mesh, shell, state, force,
    n_dofs, layout, n_owned and core (`_halo_shell_core`'s dict).
    Matches the unsharded step (`models/shell.py::
    build_shell_sharded_step`) to the CG tolerance."""
    from ..models.shell import plate_shell

    shell, bcs = plate_shell(n_shell, span, chord, E, nu, thickness,
                             _mesh_device(device_mesh))
    state = shell.make_state(bcs)
    core = _halo_shell_core(shell.mesh, shell, state, device_mesh,
                            cg_rtol, cg_maxiter, cheby_degree, precond)
    solve, c_fn, off = core["solve"], core["c_fn"], core["off"]
    dev = shell.Vu.device
    farr = np.zeros(shell.Vf.n_dofs)
    farr[2::3] = pressure
    force = torch.as_tensor(farr, dtype=config.dtype, device=dev)

    def step(tarr):
        t = tarr.detach().requires_grad_(True)
        with torch.enable_grad():
            x = solve(t, force)
            J = c_fn({"u": x[:off], "force": force})
            (g,) = torch.autograd.grad(J, t)
        return J.detach(), g

    t0 = torch.full((shell.Vt.n_dofs,), thickness, dtype=config.dtype,
                    device=dev)
    return step, t0, dict(mesh=shell.mesh, shell=shell, state=state,
                          force=force, n_dofs=core["n_dofs"],
                          layout=core["lay"], n_owned=core["lay"].n_owned,
                          core=core)


def build_fsi_halo_step(n_shell=(4, 6), n_vlm=(2, 4), span=4.0, chord=1.0,
                        E=7e10, nu=0.3, thickness=0.01, rho_air=1.225,
                        v_inf=(20.0, 0.0, 2.0), rho_s=2700.0,
                        device_mesh=None, gs_passes=8, relax=0.7,
                        cg_rtol=1e-12, cg_maxiter=20000, cheby_degree=0,
                        precond="jacobi"):
    """The distributed coupled aeroelastic step: the VLM <-> RBF <->
    shell Gauss-Seidel loop in which every shell solve, forward passes
    and their adjoints, is the dof-sharded halo CG; on this rank of
    `device_mesh` (every rank calls it and the step), on the rank's
    device.

    The VLM and the RBF transfer maps are replicated: O(panels) and
    O(interface), serial in the reference too.  Returns (step, t0, info);
    step(thick) -> (tip, d tip / d thick), the gradient through every
    pass (each solve's adjoint is distributed)."""
    from ..models.fsi import _vlm_and_maps, _wing_shell_system

    mesh, shell, state = _wing_shell_system(
        n_shell, span, chord, E, nu, rho_s, _mesh_device(device_mesh))
    vlm, lat0, vvec, cmaps, _ = _vlm_and_maps(
        mesh, shell, n_vlm, span, chord, rho_air, v_inf)
    core = _halo_shell_core(mesh, shell, state, device_mesh,
                            cg_rtol, cg_maxiter, cheby_degree, precond)
    solve, off = core["solve"], core["off"]
    n_nodes = mesh.n_nodes
    lshape = lat0.shape
    n_lat = int(np.prod(lshape[:-1]))
    dmapW, fmapW = cmaps["__dmapW__"], cmaps["__fmapW__"]
    tip_idx = int(np.argmax(mesh.coords[:, 1]))

    def traction_of(d):
        aero = vlm.solve(lat0 + d.reshape(lshape), vvec)
        return (fmapW @ aero["forces"]).reshape(-1)

    def coupled_tip(thick):
        d = torch.zeros(n_lat * 3, dtype=lat0.dtype, device=lat0.device)
        for _ in range(gs_passes):
            x = solve(thick, traction_of(d))
            u_nodes = x[:off].reshape(-1, 3)[:n_nodes]
            d = (1.0 - relax) * d + relax * (dmapW @ u_nodes).reshape(-1)
        x = solve(thick, traction_of(d))
        return x[:off].reshape(-1, 3)[:n_nodes][tip_idx, 2]

    def step(tarr):
        t = tarr.detach().requires_grad_(True)
        with torch.enable_grad():
            tip = coupled_tip(t)
            (g,) = torch.autograd.grad(tip, t)
        return tip.detach(), g

    t0 = torch.full((shell.Vt.n_dofs,), thickness, dtype=config.dtype,
                    device=shell.Vu.device)
    return step, t0, dict(mesh=mesh, shell=shell, n_dofs=core["n_dofs"],
                          layout=core["lay"], n_lat=n_lat, core=core)


def _mesh_device(device_mesh):
    if not isinstance(device_mesh, RankMesh):
        raise ValueError("the halo steps are SPMD-only: pass device_mesh, "
                         "a RankMesh of ranks started by launch.spawn")
    return device_mesh.device

