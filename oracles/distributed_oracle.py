"""The JAX package's f64 reference values for the distributed paths of
the PyTorch/CUDA port (femo_tpu_torch/parallel/): chip_smoke.py's
`distributed` phase and tests/test_torch_halo.py,
tests/test_torch_sharding.py.

    JAX_PLATFORMS=cpu PYTHONPATH=. python oracles/distributed_oracle.py

Runs femo_tpu on the CPU with 8 virtual devices in f64 and writes
oracles/distributed_oracle.npz:

* halo260_*: run_distributed_poisson.py's system at its default
  --nel 260 (135,200 cells, 68,121 dofs; grad.grad + mass, u = 0 on
  x = 0), dof-sharded over device_mesh(4), b = 1, the Jacobi CG to
  rtol 1e-8: the gathered x, the iterations, ||r||, the layout's L, G,
  S; `x_exact`, the exact solution of the same constrained system
  (scipy.sparse.linalg.spsolve on the assembled CSR's free block, x = b
  on the constrained dofs), and `dist`, the CG's relative distance to it.
* halo12_*: tests/test_halo.py's system at nel=12 over device_mesh(4):
  the CG of b = normal(seed 2) to rtol 1e-12 (the same keys), the matvec
  of x = normal(seed 0) and the dot of x with y = normal(seed 1).
* shell34_*: build_shell_sharded_step(n_shell=(3, 4)) over
  device_mesh(4): compliance J and its thickness gradient g.
* poisson8_{cg,dense}_*: build_jit_opt_step(nel=8, solver=...) over
  device_mesh(4): J and the gradient g at f0.
* shell34_halo_{jacobi,bjacobi,cheby0,cheby6}_*: femo_tpu/parallel/
  halo_step.py's build_shell_halo_step(n_shell=(3, 4)) over
  device_mesh(4), with precond="jacobi", "bjacobi", and the Jacobi CG
  with cheby_degree 0 and 6: compliance J and its gradient g at t0; the
  halo CG's iterations on the step's right-hand side (`iters`); the
  layout's L, G, S, n_owned, owned_global and owner_of, the ghosts per
  device (`ghosts`); bjacobi's block size `Bj` and block count `nb`.
* shell46_halo_{jacobi,bjacobi}_*: the same at n_shell=(4, 6): J, g and
  the iterations.
* fsi34_halo_*: build_fsi_halo_step(n_shell=(3, 4), n_vlm=(2, 3),
  gs_passes=3, precond="bjacobi") over device_mesh(4): the tip
  displacement and its thickness gradient g.  Block Jacobi, where the
  JAX dryrun's FSI line keeps point Jacobi: on this wing a point-Jacobi
  solve takes ~1,170 CG iterations, a block-Jacobi one ~300.

* advdiff10_*: tests/test_motor_halo.py's advection-diffusion system
  (nel=10; grad.grad + (3, 1).grad, u = 0 on x = 0): the dense
  constrained Jacobian `K` (P A P + (I - P), by matvec columns as that
  test builds it), b = normal(seed 3) on the free dofs, the dense forward
  and transpose solutions `x`, `xt`; advdiff{5,10}_layout_*: the layout
  of femo_tpu/parallel/halo_newton.py's solver of that system over
  device_mesh(4) (L, G, n_owned, owned_global, owner_of and the ghosts
  per device); nel=5 has 50 cells, which 4 does not divide, so its last
  device holds padding.
* motor05_halo_n2_*: build_motor_halo_step(refine=0.5, em_load_steps=1,
  mm_newton_iters=2, em_newton_iters=2) over device_mesh(4), the JAX
  dryrun's settings ("basis"): loss, g_dv, g_iq; each state's layout
  (`mm_*`, `em_*`: L, G, n_owned, owned_global, ghosts); the halo
  Krylov's count on each state's first Newton system (`mm_cycles`: GMRES
  cycles; `em_iters`: CG iterations): at u = 0 and the first load step's
  inputs (mesh motion: uhat_bc / 2; EM: uhat the mesh-motion solution,
  the tables at iq0), b = -R_c.
* motor1_n6_lu_edge_*: the single-device build_motor_jit_step(refine=1,
  em_load_steps=3, mm_newton_iters=6, em_newton_iters=6,
  factorization="lu", design_space="edge_deltas") at (dv0, iq0): loss,
  g_dv, g_iq (chip_smoke.py's motor halo step is held to it).

Every key an earlier run wrote (all but the run times, `seconds*`) must
come out with the same value: the script compares them with the file it replaces and
raises before writing if one differs.  Named groups (`halo`, `mode_a`,
`halo_steps`, `halo_newton`) recompute only their keys and keep the
others from the file:

    JAX_PLATFORMS=cpu PYTHONPATH=. python oracles/distributed_oracle.py halo_newton

Run time on an 8-core CPU, all groups (the file's `seconds_*`): halo
32.8 s, mode_a 12.7 s, halo_steps 1,816.9 s, halo_newton 685.8 s (2,548
s; the XLA compiles of the JAX halo steps and of the refine-1 n6 step
take most of it); `halo_newton` alone 736.0 s.
"""

import os
import sys
import time

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")

import numpy as np  # noqa: E402
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import scipy.sparse.linalg as spla  # noqa: E402

from femo_tpu.fea import (  # noqa: E402
    DirichletBC, FormDef, Function, FunctionSpace, assemble_matrix,
    bc_arrays, create_unit_square_mesh, dot, dx, grad)
from femo_tpu.models.poisson import build_jit_opt_step  # noqa: E402
from femo_tpu.models.shell import build_shell_sharded_step  # noqa: E402
from femo_tpu.parallel.halo import HaloShardedOperator  # noqa: E402
from femo_tpu.parallel.halo_step import (  # noqa: E402
    build_fsi_halo_step, build_shell_halo_step)
from femo_tpu.parallel.sharding import device_mesh  # noqa: E402

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "distributed_oracle.npz")
NDEV = 4


def halo_system(nel):
    """The example's operator: grad.grad + mass on the nel x nel square,
    u = 0 on x = 0.  Returns (A, free, V)."""
    mesh = create_unit_square_mesh(nel)
    V = FunctionSpace(mesh, ("CG", 1))
    u = Function(V, "u")
    A = assemble_matrix(
        FormDef([dx(lambda w, g: dot(grad(w.u), grad(w.v)) + w.u * w.v)],
                coeffs=[u], test=V), "u")
    bc = DirichletBC(V, 0.0, where=lambda x: np.isclose(x[0], 0.0))
    free, _ = bc_arrays([bc], V.n_dofs)
    return A, np.asarray(free), V


def exact(A, free, b):
    """The constrained system's exact solution: A_ff x_f = b_f, x = b on
    the constrained dofs (the operator's unit rows there)."""
    csr = A.to_scipy_csr()
    f = np.nonzero(free)[0]
    x = b.copy()
    x[f] = spla.spsolve(csr[f][:, f].tocsc(), b[f])
    return x


def halo_cg(prefix, nel, b, rtol, out):
    A, free, V = halo_system(nel)
    op = HaloShardedOperator(A, V.dofmap, V.n_dofs, device_mesh(NDEV),
                             free=free)
    xl, it, rn = op.cg(op.scatter_vector(b), rtol=rtol)
    x = np.asarray(op.gather_vector(xl))
    xe = exact(A, free, b)
    out.update({f"{prefix}_x": x, f"{prefix}_iters": int(it),
                f"{prefix}_rnorm": float(rn), f"{prefix}_x_exact": xe,
                f"{prefix}_dist": float(np.linalg.norm(x - xe)
                                        / np.linalg.norm(xe)),
                f"{prefix}_L": op.layout.L, f"{prefix}_G": op.layout.G,
                f"{prefix}_S": op.layout.S})
    print(f"{prefix}: {V.n_dofs} dofs, L/G/S {op.layout.L}/{op.layout.G}/"
          f"{op.layout.S}, {int(it)} iterations, ||r|| {float(rn):.3e}, "
          f"distance to the exact solution {out[prefix + '_dist']:.3e}",
          flush=True)
    return op, V


# the halo steps' variants: key -> build_shell_halo_step's arguments
HALO_STEPS = {
    "shell34_halo_jacobi": dict(n_shell=(3, 4), precond="jacobi"),
    "shell34_halo_bjacobi": dict(n_shell=(3, 4), precond="bjacobi"),
    "shell34_halo_cheby0": dict(n_shell=(3, 4), cheby_degree=0),
    "shell34_halo_cheby6": dict(n_shell=(3, 4), cheby_degree=6),
    "shell46_halo_jacobi": dict(n_shell=(4, 6), precond="jacobi"),
    "shell46_halo_bjacobi": dict(n_shell=(4, 6), precond="bjacobi"),
}
PRESSURE = 2.0e3  # build_shell_halo_step's default load


def halo_step(prefix, kw, out):
    """One shell halo step at t0 and its CG on the step's right-hand
    side (tests/test_halo.py's way of counting iterations)."""
    step, t_0, info = build_shell_halo_step(device_mesh=device_mesh(NDEV),
                                            **kw)
    J, g = step(t_0)
    core, lay = info["core"], info["layout"]
    farr = np.zeros(info["shell"].Vf.n_dofs)
    farr[2::3] = PRESSURE
    b = jax.numpy.where(core["freej"], -core["residual"](
        jax.numpy.zeros(core["n_dofs"]), t_0, jax.numpy.asarray(farr)), 0.0)
    _, k = core["halo_cg"](t_0, b)
    out.update({f"{prefix}_J": float(J), f"{prefix}_g": np.asarray(g),
                f"{prefix}_iters": int(k), f"{prefix}_L": lay.L,
                f"{prefix}_G": lay.G, f"{prefix}_S": lay.S,
                f"{prefix}_n_owned": np.asarray(lay.n_owned),
                f"{prefix}_owned_global": np.asarray(lay.owned_global),
                f"{prefix}_owner_of": np.asarray(lay.owner_of),
                f"{prefix}_ghosts": np.asarray(core["ghosts"])})
    if core["bj"] is not None:
        out.update({f"{prefix}_Bj": core["bj"]["B"],
                    f"{prefix}_nb": core["bj"]["nb"]})
    print(f"{prefix}: {core['n_dofs']} dofs, J {float(J)!r}, {int(k)} CG "
          f"iterations, L/G/S {lay.L}/{lay.G}/{lay.S}, ghosts "
          f"{core['ghosts'].tolist()}, bjacobi {core['bj']}", flush=True)


BETA = np.array([3.0, 1.0])  # tests/test_motor_halo.py's advection


def advdiff_system(nel):
    """tests/test_motor_halo.py's advection-diffusion residual at nel:
    (form, free, bc values, V)."""
    mesh = create_unit_square_mesh(nel)
    V = FunctionSpace(mesh, ("CG", 1))
    u = Function(V, "u")
    form = FormDef(
        [dx(lambda w, g: dot(grad(w.u), grad(w.v))
            + dot(BETA, grad(w.u)) * w.v - 1.0 * w.v)],
        coeffs=[u], test=V)
    bc = DirichletBC(V, 0.0, where=lambda x: np.isclose(x[0], 0))
    free, bv = bc_arrays([bc], V.n_dofs)
    return form, free, bv, V


class Captured:
    """Records what femo_tpu/parallel/halo_newton.py builds: each
    `build_halo_layout` result and each `build_halo_newton_solver` call's
    arguments and (solve, aux), by wrapping the module's names."""

    def __init__(self):
        import femo_tpu.parallel.halo_newton as hn
        self.layouts, self.solvers = [], []
        layout, solver = hn.build_halo_layout, hn.build_halo_newton_solver

        def lay(*a):
            self.layouts.append(layout(*a))
            return self.layouts[-1]

        def sol(*a, **kw):
            self.solvers.append((a, kw, solver(*a, **kw)))
            return self.solvers[-1][2]

        hn.build_halo_layout, hn.build_halo_newton_solver = lay, sol


def layout_keys(prefix, lay, ghosts, out):
    out.update({f"{prefix}_L": lay.L, f"{prefix}_G": lay.G,
                f"{prefix}_n_owned": np.asarray(lay.n_owned),
                f"{prefix}_owned_global": np.asarray(lay.owned_global),
                f"{prefix}_owner_of": np.asarray(lay.owner_of),
                f"{prefix}_ghosts": np.asarray(ghosts)})


def first_system_count(call, inputs):
    """The halo Krylov's count on a solver's first Newton system: at u = 0
    (the BC values) and the first load step's inputs, b = -R_c."""
    import jax.numpy as jnp
    from femo_tpu.fea.bc import apply_bc, constrain_residual
    from femo_tpu.parallel.sharding import sharded_vector_fn

    (cf, _, free, bv, dm), kw, (_, aux) = call
    ls = kw.get("load_steps", 1)
    p = inputs
    if ls > 1:
        scale = kw.get("scale_inputs") or (
            lambda q, s: jax.tree.map(lambda x: x * s, q))
        p = scale(inputs, 1.0 / ls)
    u = apply_bc(jnp.zeros(cf.form.test.n_dofs), free, bv)
    vals = kw["vals_of"](u, p)
    Rc = constrain_residual(sharded_vector_fn(cf, dm)(vals), u, free, bv)
    return int(aux["halo_cg"](vals, -Rc)[1])


def halo_newton(out):
    """The advdiff*, motor05_halo_n2_* and motor1_n6_lu_edge_* keys."""
    import jax.numpy as jnp
    from femo_tpu.fea.assemble import compile_form
    from femo_tpu.models.motor.model import (
        boundary_displacement_basis, build_motor_jit_step)
    from femo_tpu.models.motor.pde import source_tables
    from femo_tpu.parallel.halo_newton import (
        build_halo_newton_solver, build_motor_halo_step)

    cap = Captured()
    form, free, bv, V = advdiff_system(10)
    A = assemble_matrix(form, "u")
    n = V.n_dofs
    K = np.stack([np.asarray(jnp.where(free, A.matvec(jnp.where(
        free, jnp.asarray(e), 0.0)), jnp.asarray(e))) for e in np.eye(n)],
        axis=1)
    b = np.where(np.asarray(free), np.random.default_rng(3).normal(size=n),
                 0.0)
    out.update(advdiff10_K=K, advdiff10_b=b,
               advdiff10_x=np.linalg.solve(K, b),
               advdiff10_xt=np.linalg.solve(K.T, b))
    for nel in (5, 10):
        form, free, bv, _ = advdiff_system(nel)
        _, aux = build_halo_newton_solver(
            compile_form(form), "u", free, bv, device_mesh(NDEV),
            vals_of=lambda u, p: {"u": u}, newton_iters=1, krylov="gmres",
            cg_rtol=1e-13)
        layout_keys(f"advdiff{nel}_layout", cap.layouts[-1],
                    aux["info"]["ghosts"], out)
        print(f"advdiff nel={nel}: {aux['info']}", flush=True)

    dm = device_mesh(NDEV)
    k = "motor05_halo_n2"
    step, (dv0, iq0), info = build_motor_halo_step(
        refine=0.5, em_load_steps=1, mm_newton_iters=2, em_newton_iters=2,
        device_mesh=dm)
    loss, (g_dv, g_iq) = step(dv0, iq0)
    out.update({f"{k}_loss": float(loss), f"{k}_g_dv": np.asarray(g_dv),
                f"{k}_g_iq": float(g_iq)})
    mm, em = cap.solvers[-2:]
    for name, call, lay in (("mm", mm, cap.layouts[-2]),
                            ("em", em, cap.layouts[-1])):
        layout_keys(f"{k}_{name}", lay, call[2][1]["info"]["ghosts"], out)
    inputs = {"uhat_bc": jnp.asarray(boundary_displacement_basis(
        info["mesh"], info["Vmm"])) @ dv0}
    out[f"{k}_mm_cycles"] = first_system_count(mm, inputs)
    uh = mm[2][0](inputs, jnp.zeros(info["Vmm"].n_dofs))
    Ht, Jt = source_tables(iq0, jnp.asarray(0.0))
    out[f"{k}_em_iters"] = first_system_count(
        em, {"uhat": uh, "Htable": Ht, "Jtable": Jt})
    print(f"{k}: loss {float(loss)!r}, g_iq {float(g_iq)!r}, first systems "
          f"{out[k + '_mm_cycles']} GMRES cycles, {out[k + '_em_iters']} "
          f"CG iterations; mm {info['mm_halo']}, em {info['em_halo']}",
          flush=True)

    k = "motor1_n6_lu_edge"
    step, (dv0, iq0), _ = build_motor_jit_step(
        refine=1, em_load_steps=3, mm_newton_iters=6, em_newton_iters=6,
        factorization="lu", design_space="edge_deltas")
    loss, (g_dv, g_iq) = step(dv0, iq0)
    out.update({f"{k}_loss": float(loss), f"{k}_g_dv": np.asarray(g_dv),
                f"{k}_g_iq": float(g_iq)})
    print(f"{k}: loss {float(loss)!r}, g_iq {float(g_iq)!r}", flush=True)


def check_kept(out, keep_others=False):
    """Every key of the file being replaced (but the run times) keeps its
    value; with keep_others, the keys not recomputed are copied into out
    unchecked."""
    if not os.path.exists(OUT):
        return
    old = np.load(OUT)
    if keep_others:
        out.update({k: old[k] for k in old.files if k not in out})
    changed = [k for k in old.files if not k.startswith("seconds")
               and not (k in out and np.array_equal(old[k], out[k]))]
    if changed:
        raise AssertionError(f"keys whose value changed: {changed}")
    print(f"{len(old.files) - 1} earlier keys unchanged", flush=True)


def halo(out):
    """The halo260_* and halo12_* keys."""
    n260 = 261 * 261
    halo_cg("halo260", 260, np.ones(n260), 1e-8, out)
    n12 = 13 * 13
    op, V = halo_cg("halo12", 12, np.random.default_rng(2).normal(size=n12),
                    1e-12, out)
    x = np.random.default_rng(0).normal(size=n12)
    y = np.random.default_rng(1).normal(size=n12)
    out["halo12_matvec"] = np.asarray(
        op.gather_vector(op.matvec(op.scatter_vector(x))))
    out["halo12_dot"] = float(op.dot(op.scatter_vector(x),
                                     op.scatter_vector(y)))


def mode_a(out):
    """The shell34_* and poisson8_* keys."""
    step, t_0, _ = build_shell_sharded_step(n_shell=(3, 4),
                                            device_mesh=device_mesh(NDEV))
    J, g = step(t_0)
    out.update(shell34_J=float(J), shell34_g=np.asarray(g))
    print(f"shell (3, 4): J {float(J)!r}", flush=True)
    for solver in ("cg", "dense"):
        step, f0 = build_jit_opt_step(nel=8, solver=solver,
                                      device_mesh=device_mesh(NDEV))
        J, g = step(f0)
        out.update({f"poisson8_{solver}_J": float(J),
                    f"poisson8_{solver}_g": np.asarray(g)})
        print(f"poisson nel=8 {solver}: J {float(J)!r}", flush=True)


def halo_steps(out):
    """The shell34_halo_*, shell46_halo_* and fsi34_halo_* keys."""
    for prefix, kw in HALO_STEPS.items():
        halo_step(prefix, kw, out)
    fstep, f_t0, _ = build_fsi_halo_step(
        n_shell=(3, 4), n_vlm=(2, 3), device_mesh=device_mesh(NDEV),
        gs_passes=3, precond="bjacobi")
    tip, g = fstep(f_t0)
    out.update(fsi34_halo_tip=float(tip), fsi34_halo_g=np.asarray(g))
    print(f"fsi (3, 4) / (2, 3) halo step: tip {float(tip)!r}", flush=True)


GROUPS = {"halo": halo, "mode_a": mode_a, "halo_steps": halo_steps,
          "halo_newton": halo_newton}


def main(argv):
    """Recompute the named groups (all by default), keep every other key
    of the file, check the kept values and write."""
    names = argv or list(GROUPS)
    unknown = sorted(set(names) - set(GROUPS))
    if unknown:
        raise SystemExit(f"unknown groups {unknown}; known {list(GROUPS)}")
    out = {}
    for name in names:
        t0 = time.perf_counter()
        GROUPS[name](out)
        out[f"seconds_{name}"] = time.perf_counter() - t0
    check_kept(out, keep_others=bool(argv))
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT}: " + ", ".join(
        f"{n} {out['seconds_' + n]:.1f} s" for n in names))


if __name__ == "__main__":
    main(sys.argv[1:])
