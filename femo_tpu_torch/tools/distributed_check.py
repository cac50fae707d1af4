"""The distributed paths on the card: one pool of ranks runs mode b (the
dof-sharded halo CG of run_distributed_poisson.py, with K4 inside each
rank), mode a (the cells-sharded Poisson, motor and shell steps), mode b
inside the workload steps (parallel/halo_step.py: the W6 shell halo step
at full width with block Jacobi, K1/K2 and K4 in each rank; the shell
steps at (3, 4) and the FSI halo step) and inside the motor step
(parallel/halo_newton.py: halo GMRES and CG, K4/K4T in each rank), and
returns what
chip_smoke.py's `distributed` phase holds against the JAX package's
values.

    python -m femo_tpu_torch.tools.distributed_check [--ranks 4]
    python -m femo_tpu_torch.tools.distributed_check --halo-step-only
    python -m femo_tpu_torch.tools.distributed_check --motor-halo-only
    python -m femo_tpu_torch.tools.distributed_check --motor-probe 20000

runs chip_smoke.py's configuration on the card (the second: only the
full-width shell halo step; the third: only the motor halo step of
parallel/halo_newton.py at bench.py's refine-1 motor, then the
single-device dense-LU step in this process beside it; the fourth: each
motor state's first Newton system at refine 4, solved once) and prints
each rank's results as JSON (arrays left out); `--device cpu` runs the
ranks on the CPU.  chip_smoke.py calls `run` and does the gates.  The
ranks share the card through gloo when there are more ranks than cards
(parallel/launch.py).
"""

from __future__ import annotations

import argparse
import functools
import json
import time

import numpy as np
import torch
import torch.distributed as dist

from ..config import config, get_device
from ..fea import (
    DirichletBC, FormDef, Function, FunctionSpace, assemble_matrix,
    bc_arrays, create_unit_square_mesh, dot, dx, grad)
from ..ops import bt_sweeps, spmv
from ..parallel.halo import HaloShardedOperator
from ..parallel.launch import spawn
from ..parallel.sharding import RankMesh, sharded_vector_fn

# repeats of each piece of a CG iteration in the split of its time
SPLIT_REPS = 50
# the oracle configuration of the motor (em_load_steps, Newton counts,
# edge deltas) with the dense LU that mode a runs
MOTOR_CFG = dict(em_load_steps=3, mm_newton_iters=3, em_newton_iters=3,
                 factorization="lu", design_space="edge_deltas")
# the W6 shell halo step at full width: bench_scale.py::run_halo_scale's
# configuration (19,200 cells, 147,822 dofs) on the plate of chip_smoke.py's
# shell oracle entry a (span 4, chord 1, E, nu, thickness, pressure, clamp)
HALO_STEP = dict(n_shell=(24, 400), span=4.0, precond="bjacobi",
                 cg_rtol=1e-8, cg_maxiter=60000)
# mode b inside the motor step (parallel/halo_newton.py): bench.py's
# refine-1 motor (bench.py:70-87: 3 EM load steps, edge deltas) with 6
# Newton iterations a load step, where both states have converged, so
# its gradient is comparable with the single-device step's
MOTOR_HALO = dict(refine=1, design_space="edge_deltas", em_load_steps=3,
                  mm_newton_iters=6, em_newton_iters=6)
# the probe past it: each state's first Newton system at refine 4
MOTOR_PROBE = dict(refine=4, design_space="edge_deltas", em_load_steps=3)
# the steps at (3, 4) held against the JAX package's values (oracles/
# distributed_oracle.npz shell34_halo_*, fsi34_halo_*): key -> the step's
# arguments; "bjacobi" and "fsi" are entry._dryrun_halo_steps'
SMALL_STEPS = {"jacobi": dict(precond="jacobi"),
               "cheby6": dict(cheby_degree=6)}


def halo_system(nel, device):
    """run_distributed_poisson.py's system: grad.grad + mass on the
    nel x nel unit square, u = 0 on x = 0.  Returns (A, free, V)."""
    V = FunctionSpace(create_unit_square_mesh(nel), ("CG", 1), device=device)
    u = Function(V, "u")
    A = assemble_matrix(
        FormDef([dx(lambda w, g: dot(grad(w.u), grad(w.v)) + w.u * w.v)],
                coeffs=[u], test=V), "u")
    free, _ = bc_arrays([DirichletBC(V, 0.0, where=lambda x: np.isclose(
        x[0], 0.0))], V.n_dofs, device)
    return A, free, V


def _sync(mesh):
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)


def _timed(mesh, fn):
    """(fn(), wall seconds ending in a device sync)."""
    t0 = time.perf_counter()
    out = fn()
    _sync(mesh)
    return out, time.perf_counter() - t0


def _per_call_ms(mesh, fn, reps=SPLIT_REPS):
    fn()
    _sync(mesh)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    _sync(mesh)
    return (time.perf_counter() - t0) / reps * 1e3


def _counted_cg(mesh, op, b, rtol):
    """One CG with K4's count set to 0 just before and read just after:
    (x, iterations, ||r||, seconds, K4 launches)."""
    spmv.launches["K4"] = 0
    (x, k, rn), t = _timed(mesh, lambda: op.cg(b, rtol=rtol))
    return x, k, float(rn), t, spmv.launches["K4"]


def _host(t):
    return t.detach().cpu().numpy()


def halo_rank(mesh, nel, rtol):
    """Mode b on this rank: the operator, K4 against its plain version on
    one local product, a cold and a warm CG (K4 counted in each), the
    split of an iteration's time, then the same CG on a group of rank 0
    alone."""
    out = {"rank": mesh.rank}
    (A, free, V), out["assembly_s"] = _timed(
        mesh, lambda: halo_system(nel, mesh.device))
    n = V.n_dofs
    op, out["layout_s"] = _timed(mesh, lambda: HaloShardedOperator(
        A, V.dofmap, n, mesh, free=free))
    lay = op.layout
    out.update(n_dofs=n, n_cells=V.mesh.n_cells, L=lay.L, G=lay.G, S=lay.S,
               n_owned=int(lay.n_owned[mesh.rank]),
               n_ghosts=len(op.ghosts), n_elements=op.n_elements)

    # K4 against its plain version on one local product (not counted)
    blk = op.local.blocks[0]
    rng = np.random.default_rng(100 + mesh.rank)
    x_loc = torch.as_tensor(rng.standard_normal(op.n_local),
                            device=mesh.device)
    y_k4 = op.local.matvec(x_loc)
    y_plain = spmv.element_spmv_plain(blk.A, blk.rows, blk.cols, x_loc,
                                      op.n_local)
    out["k4_max_abs_err"] = float((y_k4 - y_plain).abs().max())
    out["k4_max_abs"] = float(y_plain.abs().max())

    b = op.scatter_vector(np.ones(n))
    x, k, rn, t, k4 = _counted_cg(mesh, op, b, rtol)
    out["cold"] = dict(iterations=k, rnorm=rn, seconds=t, k4=k4)
    x, k, rn, t, k4 = _counted_cg(mesh, op, b, rtol)
    out["warm"] = dict(iterations=k, rnorm=rn, seconds=t, k4=k4,
                       ms_per_iteration=t / max(k, 1) * 1e3)
    xg = op.gather_vector(x)
    out["x"] = _host(xg) if mesh.rank == 0 else None

    # the split of an iteration: halo exchanges (gloo, staged through the
    # host), K4 alone, one all-reduced dot
    gh = torch.zeros(lay.G, dtype=x.dtype, device=mesh.device)
    x_cat = torch.cat([x, op.fwd_halo(x)])
    out["split_ms"] = dict(
        fwd_halo=_per_call_ms(mesh, lambda: op.fwd_halo(x)),
        rev_halo=_per_call_ms(mesh, lambda: op.rev_halo(gh)),
        k4=_per_call_ms(mesh, lambda: op.local.matvec(x_cat)),
        matvec=_per_call_ms(mesh, lambda: op.matvec(x)),
        dot=_per_call_ms(mesh, lambda: op.dot(x, x)))

    # the same CG on one rank (rank 0 alone; the others wait)
    solo = dist.new_group([0])
    if mesh.rank == 0:
        op1 = HaloShardedOperator(A, V.dofmap, n,
                                  RankMesh(solo, 0, 1, mesh.device),
                                  free=free)
        x1, k1, rn1, t1, k41 = _counted_cg(mesh, op1,
                                           op1.scatter_vector(np.ones(n)),
                                           rtol)
        out["one_rank"] = dict(iterations=k1, rnorm=rn1, seconds=t1, k4=k41,
                               x=_host(op1.gather_vector(x1)),
                               L=op1.layout.L, G=op1.layout.G)
    dist.barrier()
    return out


def mode_a_rank(mesh, poisson_nel, motor_refine, shell_shape):
    """Mode a on this rank: the Poisson step ("cg") at poisson_nel, the
    motor step at motor_refine (MOTOR_CFG), the shell step at
    shell_shape; each first call's value, gradient and seconds."""
    from ..models.motor.model import build_motor_jit_step
    from ..models.poisson import build_jit_opt_step
    from ..models.shell import build_shell_sharded_step

    out = {}
    step, f0 = build_jit_opt_step(nel=poisson_nel, device_mesh=mesh)
    (J, g), t = _timed(mesh, lambda: step(f0))
    out["poisson"] = dict(J=float(J), g=_host(g), seconds=t)
    step, (dv0, iq0), _ = build_motor_jit_step(
        refine=motor_refine, device_mesh=mesh, **MOTOR_CFG)
    (loss, (g_dv, g_iq)), t = _timed(mesh, lambda: step(dv0, iq0))
    out["motor"] = dict(loss=float(loss), g_dv=_host(g_dv),
                        g_iq=float(g_iq), seconds=t)
    step, t0, info = build_shell_sharded_step(n_shell=shell_shape,
                                              device_mesh=mesh)
    (J, g), t = _timed(mesh, lambda: step(t0))
    out["shell"] = dict(J=float(J), g=_host(g), seconds=t,
                        n_dofs=info["n_dofs"])
    return out


def _reset_counts():
    bt_sweeps.launches.update(K1=0, K2=0)
    spmv.launches["K4"] = 0


def _counts():
    return dict(K1=bt_sweeps.launches["K1"], K2=bt_sweeps.launches["K2"],
                K4=spmv.launches["K4"])


def count_solves(mesh, core, log):
    """Wrap the halo core's CG (an instance attribute over the method):
    each solve, forward or adjoint, has K1, K2 and K4 set to 0 just before
    it and read just after, with its iterations and synced seconds,
    appended to `log`; the first solve's x is kept in log[0]["x"]."""
    solve = core.cg

    def counted(system, b):
        _sync(mesh)
        _reset_counts()
        t0 = time.perf_counter()
        x = solve(system, b)
        _sync(mesh)
        log.append(dict(iterations=core.iterations[-1],
                        seconds=time.perf_counter() - t0, **_counts()))
        if len(log) == 1:
            log[0]["x"] = x
        return x

    core.cg = counted


def _rel(a, b):
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def sweeps_vs_plain(fac, seed):
    """K1 and K2 against their plain versions on a factor (a random
    right-hand side; K2 fed the plain z): the relative L2 differences and
    max abs errors, each sweep's steps recomputed in plain from the
    kernel's own previous values (step residuals), and the plain solve's
    own spread when the sums inside its block products run in another
    order (one random column permutation): the rounding the recurrences
    amplify.  These launches are not counted on a path."""
    m = fac.mat
    nb, B = fac.Sinv.shape[:2]
    bb = torch.as_tensor(np.random.default_rng(seed).standard_normal(
        (nb, B)), dtype=fac.Sinv.dtype, device=fac.Sinv.device)
    z_k = bt_sweeps.fwd_sweep_cuda(fac.Sinv, m.L, bb)
    z_p = bt_sweeps.fwd_sweep_plain(fac.Sinv, m.L, bb)
    x_k = bt_sweeps.bwd_sweep_cuda(fac.C, z_p)
    x_p = bt_sweeps.bwd_sweep_plain(fac.C, z_p)

    def mv(M, v):
        return torch.bmm(M, v[..., None])[..., 0]

    z_prev = torch.cat([torch.zeros_like(z_k[:1]), z_k[:-1]])
    x_next = torch.cat([x_k[1:], torch.zeros_like(x_k[:1])])
    step_k1 = _rel(z_k, mv(fac.Sinv, bb - mv(m.L, z_prev)))
    step_k2 = _rel(x_k, z_p - mv(fac.C, x_next))
    p = torch.as_tensor(np.random.default_rng(seed + 1).permutation(B),
                        device=bb.device)
    z, zs = torch.zeros_like(bb[0]), []
    for i in range(nb):
        z = fac.Sinv[i][:, p] @ (bb[i] - m.L[i][:, p] @ z[p])[p]
        zs.append(z)
    x, xs = torch.zeros_like(bb[0]), [None] * nb
    for i in range(nb - 1, -1, -1):
        x = zs[i] - fac.C[i][:, p] @ x[p]
        xs[i] = x
    x_solve = bt_sweeps.bwd_sweep_plain(fac.C, z_p)
    return dict(K1_rel=_rel(z_k, z_p), K2_rel=_rel(x_k, x_p),
                K1_max_abs_err=float((z_k - z_p).abs().max()),
                K2_max_abs_err=float((x_k - x_p).abs().max()),
                step_residuals=(step_k1, step_k2),
                spread=_rel(torch.stack(xs), x_solve), nb=nb, B=B)


def k4_vs_plain(op, seed):
    """K4 against its plain version on one product of the rank's local
    element blocks (not counted on a path): (max abs error, max abs of
    the plain product)."""
    blk = op.local.blocks[0]
    x = torch.as_tensor(np.random.default_rng(seed).standard_normal(
        op.n_local), dtype=blk.A.dtype, device=blk.A.device)
    y_k4 = op.local.matvec(x)
    y_plain = spmv.element_spmv_plain(blk.A, blk.rows, blk.cols, x,
                                      op.n_local)
    return (float((y_k4 - y_plain).abs().max()),
            float(y_plain.abs().max()))


def halo_step_rank(mesh, cfg):
    """The W6 shell halo step (cfg: build_shell_halo_step's arguments) on
    this rank: the layout and blocks, the pieces of one preconditioner
    build timed (assembly, matrix halo, fill, factor), the step with each
    solve counted (count_solves), the true relative residual of the
    forward's gathered x (the assembled residual, mode a, and on rank 0
    the plain matvec of the whole Jacobian: no halo operator in either),
    the energy estimate on rank 0, the split of one CG
    iteration, the peak device memory; on the card, K1/K2 and K4 against
    their plain versions on the rank's own factor and blocks."""
    from ..parallel.halo_step import build_shell_halo_step

    cuda = mesh.device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(mesh.device)
    (step, t0, info), build_s = _timed(mesh, lambda: build_shell_halo_step(
        device_mesh=mesh, **cfg))
    core = info["core"]["core"]
    op, bj, lay = core.op, core.bjacobi, info["layout"]
    out = dict(rank=mesh.rank, n_dofs=info["n_dofs"],
               n_cells=info["mesh"].n_cells, L=lay.L, G=lay.G, S=lay.S,
               n_owned=int(lay.n_owned[mesh.rank]), n_ghosts=len(op.ghosts),
               n_elements=op.n_elements, block=tuple(
                   op.local_rows.shape[1:]), build_s=build_s)
    if bj is not None:
        out.update(nb=bj.nb, B=bj.B, bw=bj.bw, n_import=bj.n_import,
                   n_export=bj.n_export)
        A, out["assemble_s"] = _timed(mesh, lambda: core.assemble(t0))
        imp, out["matrix_halo_s"] = _timed(mesh,
                                           lambda: bj.matrix_halo(A))
        mat, out["fill_s"] = _timed(mesh, lambda: bj.fill(A, imp))
        fac, out["factor_s"] = _timed(mesh, mat.factor)
        del A, imp, mat
    solves = []
    count_solves(mesh, core, solves)
    (J, g), out["step_s"] = _timed(mesh, lambda: step(t0))
    x = solves[0].pop("x")
    out.update(J=float(J), g=_host(g), solves=solves)
    # the true relative residual of the gathered x against the right-hand
    # side b = -R(0) on the free dofs: R(x) = A x - b assembled as the
    # residual is (a collective, mode a), and on rank 0 b - A x with K4's
    # plain version on the whole composite Jacobian (no halo operator)
    free, force, state = info["state"].free, info["force"], info["state"]
    with torch.no_grad():
        rhs = torch.where(free, -core.residual(torch.zeros_like(x), t0,
                                               force), 0.0)
        r = torch.where(free, core.residual(x, t0, force), 0.0)
    out["true_residual_assembled"] = float(torch.linalg.norm(r)
                                           / torch.linalg.norm(rhs))
    if mesh.rank == 0:
        with torch.no_grad():
            xf = torch.where(free, x, 0.0)
            Ax = sum(spmv.element_spmv_plain(A, rows, cols, xf, len(x))
                     for A, rows, cols in state.jacobian_blocks(
                         x, {"thickness": t0, "force": force}))
        out["true_residual"] = float(
            torch.linalg.norm(torch.where(free, rhs - Ax, 0.0))
            / torch.linalg.norm(rhs))
        out["J_C"], out["J_E"] = info["shell"].energy_estimate(
            state, x, t0, force)
    # the split of one CG iteration (a call each, synced): its two
    # exchanges, each with the partial dots it carries, K4 alone, one
    # preconditioner application; beside them a plain matvec and a
    # scalar all-reduce; and the kernels against their plain versions
    A, M = core.prepare(t0)
    xl = op.scatter_vector(x)
    gh = torch.zeros(lay.G, dtype=x.dtype, device=mesh.device)
    x_cat = torch.cat([xl, op.fwd_halo(xl)])
    two, one = xl.new_zeros(2), xl.new_zeros(1)
    out["split_ms"] = dict(
        fwd_halo=_per_call_ms(mesh, lambda: op.fwd_halo(xl, two)),
        rev_halo=_per_call_ms(mesh, lambda: op.rev_halo(gh, one)),
        k4=_per_call_ms(mesh, lambda: op.local.matvec(x_cat)),
        precond=_per_call_ms(mesh, lambda: M(xl)),
        matvec=_per_call_ms(mesh, lambda: op.matvec(xl)),
        dot=_per_call_ms(mesh, lambda: op.dot(xl, xl)))
    if cuda:
        if bj is not None:
            out["sweeps"] = sweeps_vs_plain(fac, 200 + mesh.rank)
        out["k4_max_abs_err"], out["k4_max_abs"] = k4_vs_plain(
            op, 300 + mesh.rank)
        out["peak_gib"] = torch.cuda.max_memory_allocated(
            mesh.device) / 2**30
    out["x"] = _host(x) if mesh.rank == 0 else None
    dist.barrier()
    return out


def count_halo_solves(mesh, op, kind, log):
    """Wrap a halo Newton operator's Krylov method (`op.cg` or
    `op.gmres`, an instance attribute over the method): each solve has K4
    and K4T set to 0 just before it and read just after, with its
    direction, count (CG iterations or GMRES cycles), collectives and
    synced seconds, appended to `log`."""
    solve = getattr(op, kind)

    def counted(b, *args, transpose=False, **kw):
        _sync(mesh)
        spmv.launches.update(K4=0, K4T=0)
        before = dict(op.collectives)
        t0 = time.perf_counter()
        out = solve(b, *args, transpose=transpose, **kw)
        _sync(mesh)
        log.append(dict(kind=kind, transpose=transpose, count=out[1],
                        seconds=time.perf_counter() - t0,
                        K4=spmv.launches["K4"], K4T=spmv.launches["K4T"],
                        **{k: op.collectives[k] - before[k]
                           for k in before}))
        return out

    setattr(op, kind, counted)


def time_assembly(mesh, op, log):
    """Wrap each of a halo Newton operator's term views' matrix_blocks:
    the synced seconds of each call appended to `log`."""
    for view, _ in op.views:
        blocks = view.matrix_blocks

        def timed(*args, _blocks=blocks, **kw):
            _sync(mesh)
            t0 = time.perf_counter()
            out = _blocks(*args, **kw)
            _sync(mesh)
            log.append(time.perf_counter() - t0)
            return out

        view.matrix_blocks = timed


def element_vs_plain(op, seed):
    """K4 and K4T against their plain versions on each of the rank's
    element blocks (not counted on a path): per block its shape and, per
    kernel, (max abs error, max abs of the plain product)."""
    rng = np.random.default_rng(seed)
    out = []
    for b in op.local.blocks:
        n = op.n_local
        x = torch.as_tensor(rng.standard_normal(n), dtype=b.A.dtype,
                            device=b.A.device)
        row = dict(shape=tuple(b.A.shape))
        for k, kern, plain in (
                ("K4", spmv.element_spmv_cuda, spmv.element_spmv_plain),
                ("K4T", spmv.element_rspmv_cuda, spmv.element_rspmv_plain)):
            y = kern(b.A, b.plan, x)
            y_p = plain(b.A, b.rows, b.cols, x, n)
            row[k] = (float((y - y_p).abs().max()), float(y_p.abs().max()))
        out.append(row)
    return out


def halo_split_ms(mesh, op, transpose=False):
    """The pieces of one Arnoldi step and one CG iteration on a halo
    Newton operator (a call each, synced, SPLIT_REPS of them): the two
    exchanges (CG's with the partial dots they carry), the local product
    (K4, or K4T), the orthogonalization's two all-reduces at the average
    Arnoldi index (25 and 26 dots of GMRES(50)) and the whole
    constrained product."""
    L, G = op.layout.L, op.layout.G
    x = torch.ones(L, dtype=config.dtype, device=mesh.device)
    gh = torch.zeros(G, dtype=x.dtype, device=mesh.device)
    x_loc = torch.cat([x, op.fwd_halo(x)])
    prod = op.local.rmatvec if transpose else op.local.matvec
    h1, h2 = x.new_zeros(25), x.new_zeros(27)
    return {
        "fwd_halo": _per_call_ms(mesh, lambda: op.fwd_halo(x)),
        "rev_halo": _per_call_ms(mesh, lambda: op.rev_halo(gh)),
        "fwd_halo_dots": _per_call_ms(mesh, lambda: op.fwd_halo(
            x, x.new_zeros(2))),
        "rev_halo_dots": _per_call_ms(mesh, lambda: op.rev_halo(
            gh, x.new_zeros(1))),
        "k4t" if transpose else "k4": _per_call_ms(mesh,
                                                   lambda: prod(x_loc)),
        "all_reduce_pass1": _per_call_ms(mesh, lambda: op.all_reduce(h1)),
        "all_reduce_pass2": _per_call_ms(mesh, lambda: op.all_reduce(h2)),
        "matvec": _per_call_ms(mesh, lambda: op.matvec(x, transpose))}


def motor_halo_rank(mesh, cfg):
    """The motor halo step (cfg: build_motor_halo_step's arguments) on
    this rank: the layouts and blocks of both states, the step with each
    Krylov solve counted (count_halo_solves) and each Jacobian assembly
    timed (time_assembly), loss and gradients; then the split of an
    Arnoldi step and of a CG iteration (halo_split_ms) and, on the card,
    K4/K4T against their plain versions on the rank's last blocks of each
    state and the peak device memory."""
    from ..parallel.halo_newton import build_motor_halo_step

    cuda = mesh.device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(mesh.device)
    (step, (dv0, iq0), info), build_s = _timed(
        mesh, lambda: build_motor_halo_step(device_mesh=mesh, **cfg))
    out = dict(rank=mesh.rank, build_s=build_s, n_dv=int(dv0.numel()))
    logs = {}
    for key, kind in (("mm", "gmres"), ("em", "cg")):
        op = info[key]["op"]
        lay = op.layout
        out[key] = dict(n_dofs=op.n, L=lay.L, G=lay.G, S=lay.S,
                        n_owned=int(lay.n_owned[mesh.rank]),
                        n_ghosts=len(op.ghosts),
                        blocks=[tuple(r.shape) + (c.shape[1],)
                                for r, c in op.block_maps])
        logs[key] = ([], [])
        count_halo_solves(mesh, op, kind, logs[key][0])
        time_assembly(mesh, op, logs[key][1])
    (loss, (g_dv, g_iq)), out["step_s"] = _timed(mesh,
                                                  lambda: step(dv0, iq0))
    out.update(loss=float(loss), g_dv=_host(g_dv), g_iq=float(g_iq))
    for key in ("mm", "em"):
        op = info[key]["op"]
        out[key].update(solves=logs[key][0], assembly_s=logs[key][1])
        out[key]["split_ms"] = halo_split_ms(mesh, op)
        out[key]["split_t_ms"] = halo_split_ms(mesh, op, transpose=True)
        if cuda:
            out[key]["kernels"] = element_vs_plain(op, 400 + mesh.rank)
    if cuda:
        out["peak_gib"] = torch.cuda.max_memory_allocated(mesh.device) / 2**30
    dist.barrier()
    return out


def motor_probe_rank(mesh, cfg, maxiter):
    """Each state's first Newton system of the motor halo step at cfg
    (refine 4: bench.py's refine-4 motor), solved once on this rank:
    mesh motion by halo GMRES at u = 0 and half the interface
    displacement (its first load step), EM by halo CG at A_z = 0 on the
    undeformed mesh (uhat = 0: the mesh-motion solve need not converge)
    with the first load step's tables; each solve's count, collectives,
    synced seconds and the true relative residual of its gathered x
    (against the constrained Jacobian by halo_apply).  maxiter: the
    solves' cg_maxiter."""
    from ..fea.bc import constrain_residual
    from ..models.motor.model import em_scale, em_vals, mm_vals, motor_problem
    from ..models.motor.pde import source_tables
    from ..parallel.halo_newton import build_halo_newton_solver

    dev, f = mesh.device, config.dtype
    mp, build_s = _timed(mesh, lambda: motor_problem(
        cfg["refine"], None, cfg["design_space"], dev))
    out = dict(rank=mesh.rank, build_s=build_s)
    iq0 = torch.as_tensor(1e5, dtype=f, device=dev)
    Ht, Jt = source_tables(iq0, torch.zeros((), dtype=f, device=dev))
    zeros_mm = torch.zeros(mp.Vmm.n_dofs, dtype=f, device=dev)
    zeros_em = torch.zeros(mp.Vem.n_dofs, dtype=f, device=dev)
    systems = (
        ("mm", "uhat", "gmres", mp.mm_cf, mp.free_mm, mp.bv_mm, mm_vals,
         mm_vals(zeros_mm, {"uhat_bc": 0.5 * mp.to_bc(mp.dv0)})),
        ("em", "A_z", "cg", mp.em_cf, mp.free_em, mp.bv_em, em_vals,
         em_vals(zeros_em, em_scale({"uhat": zeros_mm, "Htable": Ht,
                                     "Jtable": Jt},
                                    1.0 / cfg["em_load_steps"]))))
    for key, state, kind, cf, free, bv, vals_of, vals in systems:
        _, aux = build_halo_newton_solver(cf, state, free, bv, mesh,
                                          vals_of=vals_of, krylov=kind,
                                          cg_maxiter=maxiter)
        with torch.no_grad():
            b = -constrain_residual(sharded_vector_fn(cf, mesh)(vals),
                                    vals[state], free, bv)
        log = []
        count_halo_solves(mesh, aux["op"], kind, log)
        x, _ = aux["halo_cg"](vals, b)
        r = b - aux["halo_apply"](vals, x)
        out[key] = dict(n_dofs=aux["op"].n, L=aux["op"].layout.L,
                        G=aux["op"].layout.G, solve=log[0], maxiter=maxiter,
                        true_residual=float(torch.linalg.norm(r)
                                            / torch.linalg.norm(b)))
    dist.barrier()
    return out


def small_steps_rank(mesh):
    """The steps at (3, 4) against the JAX package's values: the dryrun's
    two mode-b step lines (the shell halo step with block Jacobi beside
    the unsharded step, the FSI halo step with block Jacobi), with K1, K2
    and K4 set to 0 just before and read just after, and every CG's
    iterations; the dryrun's motor line (K4 and K4T counted, each
    state's Krylov counts); then the shell halo step with each SMALL_STEPS
    preconditioner, each solve counted (count_solves; the Chebyshev
    power iterations' K4 launches fall outside the solves)."""
    from ..entry import _dryrun_halo_steps, _dryrun_motor_halo
    from ..parallel.halo_step import build_shell_halo_step

    _sync(mesh)
    _reset_counts()
    (lines, vals), t = _timed(mesh, lambda: _dryrun_halo_steps(mesh))
    out = {"lines": lines, "dryrun_s": t, "dryrun_launches": _counts(),
           "dryrun_iterations": [
               list(vals[f"{k}_core"]["core"].iterations)
               for k in ("shell", "fsi")]}
    # the dryrun's motor line (refine 0.5, n2), K4 and K4T counted
    _sync(mesh)
    spmv.launches.update(K4=0, K4T=0)
    (mlines, mvals), t = _timed(mesh, lambda: _dryrun_motor_halo(mesh))
    out["motor_dryrun"] = dict(
        lines=mlines, seconds=t, K4=spmv.launches["K4"],
        K4T=spmv.launches["K4T"], loss=mvals["halo"][0],
        single_loss=mvals["single"][0],
        **{f"{k}_counts": list(mvals["info"][k]["counts"])
           for k in ("mm", "em")})
    for key in ("shell", "fsi"):
        out[key] = dict(J=vals[key][0], g=vals[key][1])
    for key, kw in SMALL_STEPS.items():
        step, t0, info = build_shell_halo_step(n_shell=(3, 4),
                                               device_mesh=mesh, **kw)
        log = []
        count_solves(mesh, info["core"]["core"], log)
        (J, g), t = _timed(mesh, lambda: step(t0))
        log[0].pop("x")
        out[key] = dict(J=float(J), g=_host(g), solves=log, seconds=t)
    return out


# the CG iteration spread under rounding: the shell halo steps' forward
# solves (n_shell, build arguments), each run again with its element
# blocks perturbed by one ulp (SPREAD_SEEDS seeds)
SPREAD_CASES = (((3, 4), dict(precond="jacobi")),
                ((3, 4), dict(cheby_degree=6)),
                ((3, 4), dict(precond="bjacobi")),
                ((4, 6), dict(precond="jacobi")),
                ((4, 6), dict(precond="bjacobi")))
SPREAD_SEEDS = 5


def iteration_spread_rank(mesh):
    """How far rounding alone moves the halo CG's iteration count: for
    each SPREAD_CASES step, the forward solve's iterations on the step's
    right-hand side, then the same CG with the rank's element blocks
    multiplied by (1 + eps n), n standard normal (seeded by the seed and
    the rank), eps = 2^-52, and symmetrized.  A list of (n_shell,
    arguments, [unperturbed, perturbed...]), the same on every rank."""
    from ..parallel.halo_step import build_shell_halo_step, chebyshev

    torch.set_num_threads(1)
    out = []
    for shape, kw in SPREAD_CASES:
        _, t0, info = build_shell_halo_step(n_shell=shape,
                                            device_mesh=mesh, **kw)
        core = info["core"]["core"]
        force = torch.zeros(info["shell"].Vf.n_dofs, dtype=t0.dtype,
                            device=t0.device)
        force[2::3] = 2.0e3
        b = torch.where(core.free, -core.residual(
            torch.zeros(core.n_dofs, dtype=t0.dtype, device=t0.device),
            t0, force), 0.0)
        A0 = core.assemble(t0)
        eps = torch.finfo(A0.dtype).eps
        for seed in range(SPREAD_SEEDS + 1):
            A = A0
            if seed:
                g = torch.Generator().manual_seed(10 * seed + mesh.rank)
                A = A0 * (1 + eps * torch.randn(
                    A0.shape, generator=g, dtype=A0.dtype).to(A0.device))
                A = 0.5 * (A + A.transpose(1, 2))
            core.op.set_elements(A)
            if core.bjacobi is not None:
                fac = core.bjacobi.factor(A)
                M = functools.partial(core.bjacobi.apply, fac)
            else:
                Minv = 1.0 / core.op.diagonal()
                M = (chebyshev(core.op, Minv, core.cheby_degree)
                     if core.cheby_degree else functools.partial(
                         torch.mul, Minv))
            core.cg((A, M), b)
        out.append((shape, kw, core.iterations[:]))
    return out


def chip_rank(mesh, nel, rtol, poisson_nel, motor_refine, shell_shape,
              halo_step, motor_halo):
    """One rank of chip_smoke.py's `distributed` phase: mode b, mode a,
    the full-width shell halo step (`halo_step`: its arguments), the
    steps at (3, 4) with the dryrun, the motor halo step (`motor_halo`:
    its arguments), with the seconds of each."""
    out = {}
    for key, fn in (("halo", lambda: halo_rank(mesh, nel, rtol)),
                    ("mode_a", lambda: mode_a_rank(
                        mesh, poisson_nel, motor_refine, shell_shape)),
                    ("halo_step", lambda: halo_step_rank(mesh, halo_step)),
                    ("small_steps", lambda: small_steps_rank(mesh)),
                    ("motor_halo", lambda: motor_halo_rank(mesh,
                                                           motor_halo))):
        t0 = time.perf_counter()
        out[key] = fn()
        out[f"{key}_s"] = time.perf_counter() - t0
    return out


def run(ranks=4, nel=260, rtol=1e-8, poisson_nel=260, motor_refine=1,
        shell_shape=(3, 4), halo_step=None, motor_halo=None, device=None,
        timeout=900.0):
    """chip_rank on `ranks` ranks (on the card by default); the list of
    their results, rank 0 first.  halo_step, motor_halo: the full-width
    shell halo step's and the motor halo step's arguments (None:
    HALO_STEP, MOTOR_HALO).  On the card, K1/K2's and K4's libraries are
    built here first, not by the ranks at once."""
    if get_device(device).type == "cuda":
        spmv.get_lib()
        bt_sweeps.get_lib()
    return spawn(chip_rank, ranks, device=device, timeout=timeout,
                 args=(nel, rtol, poisson_nel, motor_refine,
                       tuple(shell_shape), dict(halo_step or HALO_STEP),
                       dict(motor_halo or MOTOR_HALO)))


def run_motor_halo(ranks=4, motor_halo=None, device=None, timeout=900.0):
    """motor_halo_rank alone on `ranks` ranks: the list of their
    results."""
    if get_device(device).type == "cuda":
        spmv.get_lib()
    return spawn(motor_halo_rank, ranks, device=device, timeout=timeout,
                 args=(dict(motor_halo or MOTOR_HALO),))


def motor_single(cfg, device=None):
    """The port's single-device dense-LU motor step at cfg, in this
    process: (loss, g_dv, g_iq) as numpy."""
    from ..models.motor.model import build_motor_jit_step

    step, (dv0, iq0), _ = build_motor_jit_step(device=device,
                                               factorization="lu", **cfg)
    loss, (g_dv, g_iq) = step(dv0, iq0)
    return float(loss), _host(g_dv), float(g_iq)


def run_halo_step(ranks=4, halo_step=None, device=None, timeout=900.0):
    """halo_step_rank alone on `ranks` ranks: the list of their
    results."""
    if get_device(device).type == "cuda":
        spmv.get_lib()
        bt_sweeps.get_lib()
    return spawn(halo_step_rank, ranks, device=device, timeout=timeout,
                 args=(dict(halo_step or HALO_STEP),))


def _jsonable(o):
    if isinstance(o, dict):
        return {k: _jsonable(v) for k, v in o.items()
                if not isinstance(v, np.ndarray)}
    if isinstance(o, (list, tuple)):
        return [_jsonable(v) for v in o]
    return o


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--ranks", type=int, default=4)
    p.add_argument("--halo-step-only", action="store_true",
                   help="only the full-width shell halo step")
    p.add_argument("--motor-halo-only", action="store_true",
                   help="only the motor halo step (MOTOR_HALO), against "
                        "the single-device dense-LU step in this process")
    p.add_argument("--motor-probe", type=int, default=None, metavar="MAXITER",
                   help="only each state's first Newton system at refine 4 "
                        "(MOTOR_PROBE), cg_maxiter MAXITER")
    p.add_argument("--iteration-spread", action="store_true",
                   help="only the CG iteration spread under one-ulp "
                        "perturbations (iteration_spread_rank)")
    p.add_argument("--device", default=None,
                   help="the ranks' device: the card (default) or cpu")
    args = p.parse_args(argv)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    t0 = time.perf_counter()
    if args.iteration_spread:
        res = spawn(iteration_spread_rank, args.ranks, device=args.device,
                    timeout=900.0)
        for shape, kw, its in res[0]:
            dev = max(abs(k - its[0]) for k in its[1:]) / its[0]
            print(f"n_shell={shape} {kw}: {its[0]} iterations, perturbed "
                  f"{its[1:]}, largest change {100 * dev:.1f}%")
        print(f"{time.perf_counter() - t0:.1f} s")
        return res
    if args.motor_probe is not None:
        if get_device(args.device).type == "cuda":
            spmv.get_lib()
        res = spawn(motor_probe_rank, args.ranks, device=args.device,
                    timeout=3000.0, args=(MOTOR_PROBE, args.motor_probe))
    elif args.motor_halo_only:
        res = run_motor_halo(args.ranks, device=args.device, timeout=2400.0)
        (loss, g_dv, g_iq), t = _timed(RankMesh(
            None, 0, 1, get_device(args.device)), lambda: motor_single(
                MOTOR_HALO, args.device))
        r0 = res[0]
        print(f"single-device dense-LU step ({t:.1f} s): loss rel "
              f"{abs(r0['loss'] - loss) / abs(loss):.3e}, g_dv rel "
              f"{np.linalg.norm(r0['g_dv'] - g_dv) / np.linalg.norm(g_dv):.3e}"
              f", g_iq rel {abs(r0['g_iq'] - g_iq) / abs(g_iq):.3e}; ranks "
              "equal: " + str(all(
                  r["loss"] == r0["loss"] and np.array_equal(r["g_dv"],
                                                             r0["g_dv"])
                  for r in res)))
    else:
        res = (run_halo_step(args.ranks, device=args.device)
               if args.halo_step_only
               else run(args.ranks, device=args.device))
    for r in res:
        print(json.dumps(_jsonable(r)))
    print(f"{time.perf_counter() - t0:.1f} s")
    return res


if __name__ == "__main__":
    main()
