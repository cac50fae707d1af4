"""Rank-side checks of the port's distributed paths, for
tests/test_torch_sharding.py and tests/test_torch_halo.py.

Each file's module fixture starts one pool of 4 gloo CPU ranks
(`femo_tpu_torch.parallel.launch.spawn`) that runs every check of the
file in one pass and returns a dict; the tests then hold each entry
against the JAX package.  This module imports torch and the port only:
the ranks are fresh processes that import it by name, and JAX has no
place in them.
"""

import numpy as np
import torch

from femo_tpu_torch.fea import (
    FormDef, Function, FunctionSpace, compile_form, create_unit_square_mesh,
    dot, dx, grad)
from femo_tpu_torch.tools.distributed_check import halo_system

NRANKS = 4
SHARD_NEL = 8  # the sharded residual, scalar and Jacobian
HALO_NEL = 12  # tests/test_halo.py's system (halo_system)
MOTOR_R05 = dict(refine=0.5, em_load_steps=3, mm_newton_iters=3,
                 em_newton_iters=3, factorization="lu",
                 design_space="edge_deltas")


def shard_values(n_u, n_f):
    """The random (u, f) of the sharded assembly checks, seeds 0-2 as in
    tests/test_sharding.py."""
    out = {}
    for seed in (0, 1, 2):
        rng = np.random.default_rng(seed)
        out[seed] = (rng.normal(size=n_u), rng.normal(size=n_f))
    return out


def poisson_forms(nel, device):
    """tests/test_sharding.py's forms: the Poisson residual and the
    functional u^2 + f^2 / 2."""
    V = FunctionSpace(create_unit_square_mesh(nel), ("CG", 1), device=device)
    W = FunctionSpace(V.mesh, ("DG", 0), device=device)
    u, f = Function(V, "u"), Function(W, "f")
    res = FormDef([dx(lambda w, g: dot(grad(w.u), grad(w.v)) - w.f * w.v)],
                  coeffs=[u, f], test=V)
    J = FormDef([dx(lambda w, g: w.u ** 2 + 0.5 * w.f ** 2)], coeffs=[u, f])
    return V, W, res, J


def _np(t):
    return t.detach().cpu().numpy()


def sharding_checks(mesh):
    """Mode a on 4 ranks: the sharded residual, scalar, dense Jacobian
    and their derivatives; the Poisson, motor and shell steps beside
    their one-rank steps; the collectives' transposes; the dryrun."""
    torch.set_num_threads(1)
    from torch.func import jvp, vjp

    from femo_tpu_torch.entry import _dryrun_rank
    from femo_tpu_torch.models.motor.model import build_motor_jit_step
    from femo_tpu_torch.models.poisson import build_jit_opt_step
    from femo_tpu_torch.models.shell import build_shell_sharded_step
    from femo_tpu_torch.parallel.collectives import (
        copy_to_ranks, reduce_from_ranks)
    from femo_tpu_torch.parallel.sharding import (
        device_mesh, sharded_matrix_dense_fn, sharded_scalar_fn,
        sharded_vector_fn)

    out = {"mesh": (mesh.rank, mesh.size, str(mesh.device)),
           "device_mesh": device_mesh(NRANKS, device="cpu") == mesh}
    V, W, res, J = poisson_forms(SHARD_NEL, "cpu")
    rcf, jcf = compile_form(res), compile_form(J)
    vals = {s: {"u": torch.as_tensor(u), "f": torch.as_tensor(f)}
            for s, (u, f) in shard_values(V.n_dofs, W.n_dofs).items()}
    rfn = sharded_vector_fn(rcf, mesh)
    out["residual"] = _np(rfn(vals[0]))
    out["scalar"] = float(sharded_scalar_fn(jcf, mesh)(vals[1]))
    out["matrix"] = _np(sharded_matrix_dense_fn(rcf, mesh, "u")(vals[2]))
    # derivatives through the collectives against the one-rank assembly
    u, f = vals[0]["u"], vals[0]["f"]
    t = torch.as_tensor(np.random.default_rng(3).normal(size=V.n_dofs))
    _, jt = jvp(lambda uu: rfn({"u": uu, "f": f}), (u,), (t,))
    _, jt1 = jvp(lambda uu: rcf.vector({"u": uu, "f": f}), (u,), (t,))
    _, pull = vjp(lambda ff: rfn({"u": u, "f": ff}), f)
    _, pull1 = vjp(lambda ff: rcf.vector({"u": u, "f": ff}), f)
    out["jvp"] = (_np(jt), _np(jt1))
    out["vjp"] = (_np(pull(t)[0]), _np(pull1(t)[0]))
    x = torch.full((3,), float(mesh.rank + 1), dtype=torch.float64,
                   requires_grad=True)
    y = reduce_from_ranks(copy_to_ranks(x, mesh.group) * 2.0, mesh.group)
    (gx,) = torch.autograd.grad(y.sum(), x)
    out["collectives"] = (_np(y), _np(gx))

    for solver in ("cg", "dense"):
        step, f0 = build_jit_opt_step(nel=SHARD_NEL, solver=solver,
                                      device_mesh=mesh)
        Jv, g = step(f0)
        out[f"poisson_{solver}"] = (float(Jv), _np(g))

    step, (dv0, iq0), _ = build_motor_jit_step(device_mesh=mesh, **MOTOR_R05)
    loss, (g_dv, g_iq) = step(dv0, iq0)
    out["motor"] = (float(loss), _np(g_dv), float(g_iq))

    sstep, t0, _ = build_shell_sharded_step(n_shell=(3, 4), device_mesh=mesh)
    Js, gs = sstep(t0)
    out["shell"] = (float(Js), _np(gs))
    out["dryrun"] = _dryrun_rank(mesh)

    # the same steps on one rank, after the last collective: Poisson on
    # rank 0, the shell on rank 1, the motor on rank 2, at once
    if mesh.rank == 0:
        for solver in ("cg", "dense"):
            step1, f0 = build_jit_opt_step(nel=SHARD_NEL, solver=solver,
                                           device="cpu")
            J1, g1 = step1(f0)
            out[f"poisson_{solver}_one_rank"] = (float(J1), _np(g1))
    elif mesh.rank == 1:
        J1, g1 = build_shell_sharded_step(n_shell=(3, 4), device="cpu")[0](t0)
        out["shell_one_rank"] = (float(J1), _np(g1))
    elif mesh.rank == 2:
        step1, _, _ = build_motor_jit_step(device="cpu", **MOTOR_R05)
        loss1, (g1_dv, g1_iq) = step1(dv0, iq0)
        out["motor_one_rank"] = (float(loss1), _np(g1_dv), float(g1_iq))
    return out


def halo_checks(mesh):
    """Mode b on 4 ranks at nel=12: the layout this rank keeps, the
    matvec, dot, diagonal and CG, the same CG on a one-rank group, the
    example's rank function."""
    torch.set_num_threads(1)
    import torch.distributed as dist

    from femo_tpu_torch.examples.run_distributed_poisson import _rank
    from femo_tpu_torch.ops import spmv
    from femo_tpu_torch.parallel.halo import HaloShardedOperator
    from femo_tpu_torch.parallel.sharding import RankMesh

    A, free, V = halo_system(HALO_NEL, "cpu")
    n = V.n_dofs
    launches = dict(spmv.launches)
    op = HaloShardedOperator(A, V.dofmap, n, mesh, free=free)
    lay = op.layout
    out = {"L": lay.L, "G": lay.G, "S": lay.S,
           "n_owned": int(lay.n_owned[mesh.rank]),
           "n_elements": op.n_elements}
    x = np.random.default_rng(0).normal(size=n)
    y = np.random.default_rng(1).normal(size=n)
    out["scatter_gather"] = _np(op.gather_vector(op.scatter_vector(x)))
    out["matvec"] = _np(op.gather_vector(op.matvec(op.scatter_vector(x))))
    out["dot"] = float(op.dot(op.scatter_vector(x), op.scatter_vector(y)))
    out["diagonal"] = _np(op.gather_vector(op.diagonal()))
    b = np.random.default_rng(2).normal(size=n)
    xl, iters, rn = op.cg(op.scatter_vector(b), rtol=1e-12)
    out["cg"] = (_np(op.gather_vector(xl)), iters, float(rn))
    out["launches"] = (launches, dict(spmv.launches))
    # the same CG on a group of rank 0 alone
    solo = dist.new_group([0])
    if mesh.rank == 0:
        op1 = HaloShardedOperator(A, V.dofmap, n, RankMesh(solo, 0, 1,
                                                           mesh.device),
                                  free=free)
        x1, it1, _ = op1.cg(op1.scatter_vector(b), rtol=1e-12)
        out["cg_one_rank"] = (_np(op1.gather_vector(x1)), it1,
                              op1.layout.L, op1.layout.G)
    dist.barrier()
    out["example"] = _rank(mesh, HALO_NEL)
    return out



# the shell halo steps held against the JAX package (oracles/
# distributed_oracle.npz keys shell34_halo_<key>_*) at n_shell=(3, 4):
# bjacobi is the dryrun's step (entry._dryrun_halo_steps), jacobi and
# cheby6 (cheby_degree=6) build_shell_halo_step's; cheby0 is the jacobi
# run (cheby_degree=0 is point Jacobi), as in the JAX package
HALO_STEP_SHELL = (3, 4)
HALO_STEP_ITERS_SHELL = (4, 6)  # the iteration counts of jacobi, bjacobi


def step_rhs(info, t0):
    """The right-hand side of a shell halo step's forward solve at t0,
    b = -R(0) on the free dofs (the load of build_shell_halo_step)."""
    core = info["core"]
    force = torch.zeros(info["shell"].Vf.n_dofs, dtype=t0.dtype)
    force[2::3] = 2.0e3
    zeros = torch.zeros(core["n_dofs"], dtype=t0.dtype)
    return torch.where(core["free"], -core["residual"](zeros, t0, force),
                       0.0)


def _halo_summary(core, J, g):
    lay = core["lay"]
    return dict(J=J, g=g, iters=list(core["core"].iterations),
                LGS=(lay.L, lay.G, lay.S), ghosts=core["ghosts"],
                n_owned=lay.n_owned, owned=lay.owned_global,
                owner=lay.owner_of, bj=core["bj"])


def halo_step_checks(mesh):
    """Mode b inside the workload steps on two groups of 4 ranks that run
    at once (a rank's results are its group's checks; the tests merge
    rank r of both groups): group 0 the shell halo step with jacobi
    (value, gradient, each solve's iterations, the layout, the ghosts),
    the Chebyshev-6 forward solve and its compliance, and the CG
    iterations at (4, 6) with jacobi and bjacobi; group 1 the dryrun's
    two step lines (the shell halo step at (3, 4) with block Jacobi
    beside the unsharded step, the FSI halo step); each with the kernel
    counts around it (CPU tensors launch none).  Every collective stays
    inside its group."""
    torch.set_num_threads(1)
    import torch.distributed as dist

    from femo_tpu_torch.entry import _dryrun_halo_steps
    from femo_tpu_torch.ops import bt_sweeps, spmv
    from femo_tpu_torch.parallel.halo_step import build_shell_halo_step
    from femo_tpu_torch.parallel.sharding import RankMesh

    n = mesh.size // 2
    groups = [dist.new_group(list(range(g * n, (g + 1) * n)))
              for g in range(2)]
    g = mesh.rank // n
    sub = RankMesh(groups[g], mesh.rank % n, n, mesh.device)
    before = dict(spmv.launches, **bt_sweeps.launches)
    out = {}
    if g == 1:
        lines, vals = _dryrun_halo_steps(sub)
        out.update(lines=lines, unsharded=vals["unsharded"],
                   fsi=vals["fsi"], bjacobi=_halo_summary(
                       vals["shell_core"], *vals["shell"]))
    else:
        step, t0, info = build_shell_halo_step(
            n_shell=HALO_STEP_SHELL, device_mesh=sub, precond="jacobi")
        J, g_ = step(t0)
        out["jacobi"] = _halo_summary(info["core"], float(J), _np(g_))
        # Chebyshev: the forward solve and its compliance (the card's run
        # of chip_smoke.py holds the gradient too)
        _, t0, info = build_shell_halo_step(
            n_shell=HALO_STEP_SHELL, device_mesh=sub, cheby_degree=6)
        core = info["core"]
        x = core["solve"](t0, info["force"])
        J = core["c_fn"]({"u": x[:core["off"]], "force": info["force"]})
        out["cheby6"] = _halo_summary(core, float(J), None)
        for key in ("jacobi", "bjacobi"):
            step, t0, info = build_shell_halo_step(
                n_shell=HALO_STEP_ITERS_SHELL, device_mesh=sub,
                precond=key)
            out[f"iters46_{key}"] = info["core"]["halo_cg"](
                t0, step_rhs(info, t0))[1]
    out[f"launches{g}"] = (before, dict(spmv.launches, **bt_sweeps.launches))
    return out


# tests/test_motor_halo.py's advection-diffusion system: its nel, the
# advection velocity (the operator is nonsymmetric) and b's seed
ADVDIFF_NEL = 10
ADVDIFF_BETA = (3.0, 1.0)
ADVDIFF_SEED = 3


def advdiff_system(nel, device):
    """(form, free, bc values, V): grad.grad + beta.grad on the nel x nel
    square, source 1, u = 0 on x = 0."""
    from femo_tpu_torch.fea import DirichletBC, bc_arrays

    V = FunctionSpace(create_unit_square_mesh(nel), ("CG", 1), device=device)
    u = Function(V, "u")
    beta = torch.tensor(ADVDIFF_BETA, dtype=torch.float64, device=device)
    form = FormDef([dx(lambda w, g: dot(grad(w.u), grad(w.v))
                       + dot(beta, grad(w.u)) * w.v - 1.0 * w.v)],
                   coeffs=[u], test=V)
    free, bv = bc_arrays([DirichletBC(V, 0.0, where=lambda x: np.isclose(
        x[0], 0))], V.n_dofs, device)
    return form, free, bv, V


def halo_newton_checks(mesh):
    """Mode b inside the motor step (parallel/halo_newton.py) on 4 ranks:
    on the advection-diffusion system, the constrained operator's columns
    (halo_apply), the GMRES solve of b and of the transpose, the Newton
    solve's free-dof residual; then the dryrun's motor line (the halo
    step at refine 0.5, n2, beside the single-device step), each state's
    Krylov counts and layout; the kernel and collective counts."""
    torch.set_num_threads(1)
    from femo_tpu_torch.entry import _dryrun_motor_halo
    from femo_tpu_torch.ops import bt_sweeps, spmv
    from femo_tpu_torch.parallel.halo_newton import build_halo_newton_solver
    from femo_tpu_torch.parallel.sharding import sharded_vector_fn

    before = dict(spmv.launches, **bt_sweeps.launches)
    form, free, bv, V = advdiff_system(ADVDIFF_NEL, mesh.device)
    cf = compile_form(form)
    solve, aux = build_halo_newton_solver(
        cf, "u", free, bv, mesh, vals_of=lambda u, p: {"u": u},
        newton_iters=1, krylov="gmres", cg_rtol=1e-13)
    n = V.n_dofs
    vals = {"u": torch.zeros(n, dtype=torch.float64)}
    out = {"K": np.stack([_np(aux["halo_apply"](vals, e)) for e in
                          torch.eye(n, dtype=torch.float64)], axis=1)}
    b = torch.as_tensor(np.where(_np(free), np.random.default_rng(
        ADVDIFF_SEED).normal(size=n), 0.0))
    for key, tr in (("x", False), ("xt", True)):
        x, k = aux["halo_cg"](vals, b, transpose=tr)
        out[key], out[f"{key}_cycles"] = _np(x), k
    u = solve({}, torch.zeros(n, dtype=torch.float64))
    r = sharded_vector_fn(cf, mesh)({"u": u})
    out["newton_residual"] = float(torch.linalg.norm(r[free]))
    out["advdiff_counts"] = list(aux["counts"])
    out["advdiff_collectives"] = dict(aux["op"].collectives)

    lines, vals = _dryrun_motor_halo(mesh)
    info = vals["info"]
    out.update(lines=lines, halo=vals["halo"], single=vals["single"])
    for key in ("mm", "em"):
        aux = info[key]
        out[f"{key}_counts"] = list(aux["counts"])
        out[f"{key}_layout"] = dict(aux["info"])
        out[f"{key}_collectives"] = dict(aux["op"].collectives)
    out["launches"] = (before, dict(spmv.launches, **bt_sweeps.launches))
    return out
