"""Parity of the port's W1 opt step as one function
(models/poisson.py::build_jit_opt_step, entry.py::entry) with the JAX
package's jitted step, f64, CPU.

* solver "cg": matrix-free Newton-Krylov forward (`newton_solve_jit`,
  the Jacobian action a `torch.func.jvp`) and the CG transpose adjoint
  through `torch.func.vjp` (`implicit_solve_jit`), at nel=8.  Both stop
  CG at 1e-12, each by its own rounding: loss 1e-10, gradient 1e-8.
* solver "dense": one dense-LU Newton step (`implicit_solve_dense`), at
  nel=8 and through `entry()` at nel=32: loss 1e-12, gradient 1e-10.
"""

import numpy as np
import pytest
import torch

from femo_tpu.models.poisson import build_jit_opt_step as jbuild_step

from femo_tpu_torch.entry import entry
from femo_tpu_torch.fea.bc import bc_arrays
from femo_tpu_torch.fea.forms import FormDef, dot, dx, grad
from femo_tpu_torch.fea.space import Function, FunctionSpace
from femo_tpu_torch.fea.assemble import compile_form
from femo_tpu_torch.mesh.generators import create_unit_square_mesh
from femo_tpu_torch.models.poisson import build_jit_opt_step
from femo_tpu_torch.solvers.newton import newton_solve_jit

torch.set_num_threads(1)

# solver -> (loss tol, gradient tol)
TOLS = {"cg": (1e-10, 1e-8), "dense": (1e-12, 1e-10)}


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


def _check(got, want, solver):
    (v, g), (jv, jg) = got, want
    lt, gt = TOLS[solver]
    assert abs(float(v) - float(jv)) <= lt * abs(float(jv))
    assert _rel(g.numpy(), jg) <= gt


@pytest.mark.parametrize("solver", ["cg", "dense"])
def test_jit_opt_step_matches_jax(solver):
    step, f0 = build_jit_opt_step(8, solver=solver, device="cpu")
    jstep, jf0 = jbuild_step(8, solver=solver)
    np.testing.assert_array_equal(f0.numpy(), np.asarray(jf0))
    # a seeded control away from the constant start
    f = np.asarray(jf0) + 0.3 * np.random.default_rng(7).standard_normal(
        f0.numel())
    _check(step(torch.as_tensor(f)), jstep(f), solver)


def test_entry_matches_jax():
    import __graft_entry__

    fn, args = entry(device="cpu")
    jfn, jargs = __graft_entry__.entry()
    assert args[0].numel() == jargs[0].size == 2 * 32 * 32
    _check(fn(*args), jfn(*jargs), "dense")
    with pytest.raises(NotImplementedError):
        build_jit_opt_step(8, device_mesh=object(), device="cpu")


def test_newton_solve_jit_nonlinear():
    """A nonlinear residual (-lap u + u^3 = 1, u = 0 on the boundary):
    Newton-Krylov with the Jacobi diag_fn converges quadratically to the
    dense Newton solution."""
    mesh = create_unit_square_mesh(6)
    V = FunctionSpace(mesh, ("CG", 1), device="cpu")
    u = Function(V, "u")
    cf = compile_form(FormDef(
        [dx(lambda w, g: dot(grad(w.u), grad(w.v)) + (w.u**3 - 50.0) * w.v)],
        coeffs=[u], test=V))
    from femo_tpu_torch.fea.bc import DirichletBC
    from femo_tpu_torch.models.poisson import on_boundary

    free, bv = bc_arrays([DirichletBC(V, 0.0, where=on_boundary)], V.n_dofs,
                         device="cpu")
    res = lambda uu: cf.vector({"u": uu})  # noqa: E731
    diag = lambda uu: cf.matrix({"u": uu}, "u").diagonal()  # noqa: E731
    u0 = torch.zeros(V.n_dofs, dtype=torch.float64)
    x, rn, k = newton_solve_jit(res, u0, free, bv, krylov_rtol=1e-12,
                                diag_fn=diag)
    y, rn_b, k_b = newton_solve_jit(res, u0, free, bv, krylov="bicgstab",
                                    krylov_rtol=1e-12)
    assert 2 <= k <= 6 and float(rn) <= 1e-10
    assert _rel(x.numpy(), y.numpy()) <= 1e-10
    assert float(torch.abs(x[~free]).max()) == 0.0
