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

Run time on an 8-core CPU: 72.8 s.
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
    out["seconds"] = time.perf_counter() - t0
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT} in {out['seconds']:.1f} s")


if __name__ == "__main__":
    main()
