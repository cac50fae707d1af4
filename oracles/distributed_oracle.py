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

Every key an earlier run wrote (all but `seconds`) must come out with
the same value: the script compares them with the file it replaces and
raises before writing if one differs.

Run time on an 8-core CPU: 2,022.7 s (72.8 s before the halo steps;
nearly all the rest is their XLA compiles).
"""

import os
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


def check_kept(out):
    """Every key of the file being replaced (but its run time) keeps its
    value."""
    if not os.path.exists(OUT):
        return
    old = np.load(OUT)
    changed = [k for k in old.files if k != "seconds"
               and not (k in out and np.array_equal(old[k], out[k]))]
    if changed:
        raise AssertionError(f"keys whose value changed: {changed}")
    print(f"{len(old.files) - 1} earlier keys unchanged", flush=True)


def main():
    t0 = time.perf_counter()
    out = {}
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
    for prefix, kw in HALO_STEPS.items():
        halo_step(prefix, kw, out)
    fstep, f_t0, _ = build_fsi_halo_step(
        n_shell=(3, 4), n_vlm=(2, 3), device_mesh=device_mesh(NDEV),
        gs_passes=3, precond="bjacobi")
    tip, g = fstep(f_t0)
    out.update(fsi34_halo_tip=float(tip), fsi34_halo_g=np.asarray(g))
    print(f"fsi (3, 4) / (2, 3) halo step: tip {float(tip)!r}", flush=True)
    check_kept(out)
    out["seconds"] = time.perf_counter() - t0
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT} in {out['seconds']:.1f} s")


if __name__ == "__main__":
    main()
