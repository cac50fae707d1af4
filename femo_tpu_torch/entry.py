"""The port's counterparts of the repository's `__graft_entry__`:

* `entry()`: the W1 opt step at nel=32 with the dense-LU Newton step, on
  the card by default.
* `dryrun_multichip(n)`: one step of each distributed path of the port on
  n ranks (`parallel/launch.spawn`), the counterpart of
  `__graft_entry__._dryrun_multichip_body` for what the port distributes:
  mode a (cells sharded) on the Poisson, motor and shell steps, mode b's
  dof-sharded halo CG, mode b inside the shell and FSI steps
  (`parallel/halo_step.py`) and inside the motor step
  (`parallel/halo_newton.py`).

    from femo_tpu_torch.entry import entry, dryrun_multichip
    fn, args = entry()          # device=None: the card
    J, dJ_df = fn(*args)
    dryrun_multichip(4)         # 4 ranks on the card(s)
"""

from __future__ import annotations

import numpy as np

from .models.poisson import build_jit_opt_step


def entry(device=None):
    """(step, (f0,)): step(f) -> (J, dJ/df), W1 at nel=32, solver "dense",
    in the port's working dtype (f64 by default) on `device`."""
    step, f0 = build_jit_opt_step(nel=32, solver="dense", device=device)
    return step, (f0,)


def _finite(label, *vals):
    for v in vals:
        if not np.all(np.isfinite(np.asarray(v))):
            raise RuntimeError(f"non-finite {label} in the multichip dryrun")


def _dryrun_rank(mesh):
    """One rank of `dryrun_multichip`: the JAX dryrun's shapes; rank 0
    prints one line per path."""
    from .fea import (
        DirichletBC, FormDef, Function, FunctionSpace, assemble_matrix,
        bc_arrays, create_unit_square_mesh, dot, dx, grad)
    from .models.motor.model import build_motor_jit_step
    from .models.shell import build_shell_sharded_step
    from .parallel.halo import HaloShardedOperator

    n, lines = mesh.size, []
    step, f0 = build_jit_opt_step(nel=8, device_mesh=mesh)
    val, g = (t.cpu().numpy() for t in step(f0))
    _finite("Poisson objective or gradient", val, g)
    lines.append(f"dryrun_multichip({n}) mode a (cells-sharded poisson): "
                 f"objective={float(val):.6e}, "
                 f"|grad|={float(np.linalg.norm(g)):.6e}")

    mstep, (dv0, iq0), _ = build_motor_jit_step(
        refine=0.5, em_load_steps=1, mm_newton_iters=2, em_newton_iters=2,
        device_mesh=mesh)
    mval, (mg, _) = mstep(dv0, iq0)
    gnorm = float(mg.norm())
    _finite("motor objective or gradient", float(mval), gnorm)
    lines.append(f"dryrun_multichip({n}) mode a (cells-sharded motor): "
                 f"objective={float(mval):.6e}, |d(obj)/d(dv)|={gnorm:.6e}")

    sstep, st0, _ = build_shell_sharded_step(n_shell=(3, 4),
                                             device_mesh=mesh)
    sval, sg = sstep(st0)
    sgn = float(sg.norm())
    _finite("shell compliance or gradient", float(sval), sgn)
    lines.append(f"dryrun_multichip({n}) mode a (cells-sharded shell): "
                 f"compliance={float(sval):.6e}, |d(J)/d(t)|={sgn:.6e}")

    V = FunctionSpace(create_unit_square_mesh(8), ("CG", 1),
                      device=mesh.device)
    u = Function(V, "u")
    A = assemble_matrix(
        FormDef([dx(lambda w, g: dot(grad(w.u), grad(w.v)) + w.u * w.v)],
                coeffs=[u], test=V), "u")
    free, _ = bc_arrays([DirichletBC(V, 0.0, where=lambda x: np.isclose(
        x[0], 0))], V.n_dofs, mesh.device)
    op = HaloShardedOperator(A, V.dofmap, V.n_dofs, mesh, free=free)
    _, iters, rn = op.cg(op.scatter_vector(np.ones(V.n_dofs)), rtol=1e-10)
    _finite("halo CG residual", float(rn))
    lines.append(f"dryrun_multichip({n}) mode b (dof-sharded halo CG): "
                 f"{iters} iters, ||r||={float(rn):.3e}")
    if mesh.rank == 0:
        print("\n".join(lines), flush=True)
    return lines


# the shell halo step's bar against the unsharded step (value and
# gradient, relative), the JAX dryrun's
HALO_STEP_BAR = 1e-8


def _dryrun_halo_steps(mesh):
    """The JAX dryrun's two mode-b step lines on one rank, rank 0
    printing them: the shell halo step at (3, 4) with block Jacobi
    against the unsharded `build_shell_sharded_step` (HALO_STEP_BAR in
    value and gradient, or raise), and the FSI halo step at (3, 4) /
    (2, 3) with 3 Gauss-Seidel passes (finite).  Departure: the FSI step
    takes block Jacobi where the JAX dryrun keeps point Jacobi, whose
    solves take ~4x the CG iterations on this wing (1,170 against 300 on
    CPU ranks), each iteration a gloo exchange pair and two all-reduces.
    Returns (lines, values): values holds each step's (value, gradient)
    as numpy, and the halo steps' cores (`shell_core`, `fsi_core`)."""
    from .models.shell import build_shell_sharded_step
    from .parallel.halo_step import build_fsi_halo_step, build_shell_halo_step

    n, lines = mesh.size, []
    hstep, ht0, hinfo = build_shell_halo_step(n_shell=(3, 4),
                                              device_mesh=mesh,
                                              precond="bjacobi")
    hval, hgrad = (t.cpu().numpy() for t in hstep(ht0))
    sstep, st0, _ = build_shell_sharded_step(n_shell=(3, 4),
                                             device=mesh.device)
    sval, sgrad = (t.cpu().numpy() for t in sstep(st0))
    rv = abs(float(hval) - float(sval)) / abs(float(sval))
    rg = float(np.linalg.norm(hgrad - sgrad) / np.linalg.norm(sgrad))
    if not (rv < HALO_STEP_BAR and rg < HALO_STEP_BAR):
        raise RuntimeError(f"the distributed-solve shell step deviates "
                           f"from the unsharded one: value rel {rv:.3e}, "
                           f"grad rel {rg:.3e}")
    lines.append(f"dryrun_multichip({n}) mode b (shell step w/ DISTRIBUTED "
                 f"halo-CG solve): compliance={float(hval):.6e}, "
                 f"single-device match value {rv:.2e} / grad {rg:.2e}")

    fstep, ft0, finfo = build_fsi_halo_step(n_shell=(3, 4), n_vlm=(2, 3),
                                        device_mesh=mesh, gs_passes=3,
                                        precond="bjacobi")
    ftip, fgrad = (t.cpu().numpy() for t in fstep(ft0))
    fgn = float(np.linalg.norm(fgrad))
    _finite("FSI tip or gradient", float(ftip), fgn)
    lines.append(f"dryrun_multichip({n}) mode b (COUPLED FSI w/ "
                 f"distributed shell solves): tip={float(ftip):.6e}, "
                 f"|d(tip)/d(t)|={fgn:.6e}")
    if mesh.rank == 0:
        print("\n".join(lines), flush=True)
    return lines, dict(shell=(float(hval), hgrad),
                       unsharded=(float(sval), sgrad),
                       fsi=(float(ftip), fgrad), shell_core=hinfo["core"],
                       fsi_core=finfo["core"])


# the motor halo step's loss against the single-device step's (relative),
# the JAX dryrun's; its n2 gradient is only held finite (the adjoints
# assemble at different states, see parallel/halo_newton.py)
MOTOR_HALO_BAR = 1e-8
MOTOR_HALO_DRYRUN = dict(refine=0.5, em_load_steps=1, mm_newton_iters=2,
                         em_newton_iters=2)


def _dryrun_motor_halo(mesh):
    """The JAX dryrun's motor line on one rank, rank 0 printing it: the
    motor halo step (mesh motion by halo GMRES, EM by halo CG) at
    MOTOR_HALO_DRYRUN, "basis", beside the single-device dense-LU step:
    loss within MOTOR_HALO_BAR, or raise; gradient finite.  Returns
    (lines, values): values holds each step's (loss, g_dv, g_iq) as numpy
    (`halo`, `single`) and the halo step's info (`info`)."""
    from .models.motor.model import build_motor_jit_step
    from .parallel.halo_newton import build_motor_halo_step

    hstep, (dv, iq), info = build_motor_halo_step(device_mesh=mesh,
                                                  **MOTOR_HALO_DRYRUN)
    hval, (hg, hgi) = hstep(dv, iq)
    sstep, _, _ = build_motor_jit_step(device=mesh.device,
                                       **MOTOR_HALO_DRYRUN)
    sval, (sg, sgi) = sstep(dv, iq)
    halo, single = ((float(v), g.cpu().numpy(), float(gi))
                    for v, g, gi in ((hval, hg, hgi), (sval, sg, sgi)))
    rv = abs(halo[0] - single[0]) / abs(single[0])
    rg = float(np.linalg.norm(halo[1] - single[1])
               / np.linalg.norm(single[1]))
    _finite("motor halo loss or gradient", halo[0], halo[1], halo[2], rg)
    if not rv < MOTOR_HALO_BAR:
        raise RuntimeError(f"the distributed motor forward deviates from "
                           f"the single-device step: value rel {rv:.3e}")
    line = (f"dryrun_multichip({mesh.size}) mode b (MOTOR w/ DISTRIBUTED "
            f"GMRES+CG solves): loss={halo[0]:.6e}, single-device match "
            f"value {rv:.2e} / grad {rg:.2e}")
    if mesh.rank == 0:
        print(line, flush=True)
    return [line], dict(halo=halo, single=single, info=info)


def _dryrun_all(mesh):
    return (_dryrun_rank(mesh) + _dryrun_halo_steps(mesh)[0]
            + _dryrun_motor_halo(mesh)[0])


def dryrun_multichip(n_devices: int, device=None) -> list[str]:
    """One step of each distributed path on n_devices ranks (on the
    card(s) by default; device="cpu": gloo CPU ranks).  Raises if a rank
    fails or a value is not finite, or if the shell or motor halo step
    misses its single-device step; returns rank 0's lines."""
    from .parallel.launch import spawn

    return spawn(_dryrun_all, n_devices, device=device)[0]
