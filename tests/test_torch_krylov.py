"""Parity of the port's Krylov solvers, Chebyshev preconditioner and
LinearSolver backends (femo_tpu_torch/solvers/) with the JAX package,
f64, CPU.

The same operators go to both packages: the BC-constrained CG1 stiffness
of the nel=8 unit square (SPD) and a seeded nonsymmetric dense matrix.
Solutions agree to 1e-10 relative and the iteration counts are equal:
the port runs the reference's stopping rule every iteration.  The
Chebyshev polynomial given the same lam_max agrees to 1e-12 (the same
arithmetic); its power-iteration estimate starts from another random
vector in each package, so solves through it are compared by solution.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from femo_tpu.fea import (
    FormDef as JFormDef, Function as JFunction, FunctionSpace as JSpace,
    assemble_matrix as jassemble_matrix, create_unit_square_mesh as jmesh_fn,
    dot as jdot, dx as jdx, grad as jgrad)
from femo_tpu.solvers import krylov as jkrylov
from femo_tpu.solvers.linear import (
    LinearSolver as JLinearSolver, constrained_matvec as jconstrained)
from femo_tpu.solvers.precond import chebyshev_preconditioner as jcheb

from femo_tpu_torch.fea.assemble import assemble_matrix
from femo_tpu_torch.fea.forms import FormDef, dot, dx, grad
from femo_tpu_torch.fea.space import Function, FunctionSpace
from femo_tpu_torch.mesh.generators import create_unit_square_mesh
from femo_tpu_torch.solvers import krylov
from femo_tpu_torch.solvers.linear import LinearSolver, constrained_matvec
from femo_tpu_torch.solvers.precond import chebyshev_preconditioner

torch.set_num_threads(1)

TOL = 1e-10


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


def _on_bdry(x):
    return (np.isclose(x[0], 0) | np.isclose(x[0], 1)
            | np.isclose(x[1], 0) | np.isclose(x[1], 1))


def _stiffness(FS, Fn, FD, dx_, dot_, grad_, assemble, mesh, **kw):
    V = FS(mesh, ("CG", 1), **kw)
    u = Fn(V, "u")
    form = FD([dx_(lambda w, g: dot_(grad_(w.u), grad_(w.v)))], coeffs=[u],
              test=V)
    return assemble(form, "u"), V


@pytest.fixture(scope="module")
def system():
    jA, jV = _stiffness(JSpace, JFunction, JFormDef, jdx, jdot, jgrad,
                        jassemble_matrix, jmesh_fn(8))
    A, V = _stiffness(FunctionSpace, Function, FormDef, dx, dot, grad,
                      assemble_matrix, create_unit_square_mesh(8),
                      device="cpu")
    free = ~np.isin(np.arange(V.n_dofs), V.locate_dofs_geometrical(_on_bdry))
    rng = np.random.default_rng(3)
    n = 60
    N = 4.0 * np.eye(n) + 0.5 * rng.standard_normal((n, n)) / np.sqrt(n)
    return dict(jA=jA, A=A, free=free, b=rng.standard_normal(V.n_dofs),
                N=N, bN=rng.standard_normal(n))


def _operators(system, which):
    """(port matvec, jax matvec, rhs, jacobi diag) of one operator."""
    if which == "stiffness":
        free = system["free"]
        mv = constrained_matvec(system["A"].matvec, torch.as_tensor(free))
        jmv = jconstrained(system["jA"].matvec, jnp.asarray(free))
        d = np.where(free, np.asarray(system["jA"].diagonal()), 1.0)
        return mv, jmv, system["b"], d
    N = system["N"]
    tN, jN = torch.as_tensor(N), jnp.asarray(N)
    return ((lambda x: tN @ x), (lambda x: jN @ x), system["bN"],
            np.diag(N).copy())


@pytest.mark.parametrize("method,which", [
    ("cg", "stiffness"), ("bicgstab", "stiffness"), ("gmres", "stiffness"),
    ("bicgstab", "nonsymmetric"), ("gmres", "nonsymmetric")])
@pytest.mark.parametrize("jacobi", [False, True])
def test_krylov_matches_jax(system, method, which, jacobi):
    mv, jmv, b, d = _operators(system, which)
    kw = dict(restart=20) if method == "gmres" else {}
    M = (lambda x: x / torch.as_tensor(d)) if jacobi else None
    jM = (lambda x: x / jnp.asarray(d)) if jacobi else None
    res = krylov.KRYLOV[method](mv, torch.as_tensor(b), M=M, **kw)
    jres = jkrylov.KRYLOV[method](jmv, jnp.asarray(b), M=jM, **kw)
    assert res.converged and bool(jres.converged)
    assert res.iters == int(jres.iters)
    assert _rel(res.x.numpy(), jres.x) < TOL


def test_krylov_maxiter_clamp(system):
    """cg/bicgstab clamp maxiter to 4 n, and stop there unconverged."""
    mv, jmv, b, _ = _operators(system, "stiffness")
    for method in ("cg", "bicgstab"):
        res = krylov.KRYLOV[method](mv, torch.as_tensor(b), maxiter=3)
        jres = jkrylov.KRYLOV[method](jmv, jnp.asarray(b), maxiter=3)
        assert res.iters == int(jres.iters) == 3
        assert not res.converged
        assert _rel(res.x.numpy(), jres.x) < TOL


def test_chebyshev_matches_jax(system):
    mv, jmv, b, d = _operators(system, "stiffness")
    lam = 1.9
    M = chebyshev_preconditioner(mv, torch.as_tensor(d), degree=5,
                                 lam_max=lam)
    jM = jcheb(jmv, jnp.asarray(d), degree=5, lam_max=lam)
    assert _rel(M(torch.as_tensor(b)).numpy(), jM(jnp.asarray(b))) < 1e-12


@pytest.mark.parametrize("method,pc", [
    ("dense", None), ("scipy", None), ("cg", "jacobi"),
    ("bicgstab", "jacobi"), ("gmres", "jacobi"), ("bicgstab", "chebyshev"),
    ("cg", None)])
@pytest.mark.parametrize("transpose", [False, True])
def test_linear_solver_backends_match_jax(system, method, pc, transpose):
    free = system["free"]
    fac = LinearSolver(method=method, pc=pc).factor(
        system["A"], torch.as_tensor(free))
    jfac = JLinearSolver(method=method, pc=pc).factor(
        system["jA"], jnp.asarray(free))
    b = system["b"]
    if transpose:
        x, jx = fac.solve_t(torch.as_tensor(b)), jfac.solve_t(jnp.asarray(b))
    else:
        x, jx = fac.solve(torch.as_tensor(b)), jfac.solve(jnp.asarray(b))
    assert _rel(x.numpy(), jx) < TOL


def test_auto_method_and_unported_backends(system):
    ls = LinearSolver()
    assert ls.resolve_method(4096) == JLinearSolver().resolve_method(4096) \
        == "dense"
    assert ls.resolve_method(4097) == "bicgstab"
    assert LinearSolver(symmetric=True).resolve_method(10**5) == "cg"
    # the block-Thomas backends (held to the JAX package in
    # tests/test_torch_block_tridiag.py) solve the constrained system
    b = torch.as_tensor(system["b"])
    free = torch.as_tensor(system["free"])
    for method in ("block_thomas", "cg_bt"):
        fac = LinearSolver(method=method).factor(system["A"], free)
        x = fac.solve(b)
        r = torch.where(free, system["A"].matvec(torch.where(free, x, 0.0)),
                        x) - b
        assert float(torch.linalg.norm(r)) <= TOL * float(
            torch.linalg.norm(b))
    with pytest.raises(ValueError, match="unknown"):
        LinearSolver(method="nope_bt").factor(system["A"], free)
