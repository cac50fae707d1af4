"""The coupled solvers' building blocks in the port, on CPU tensors in f64:
the differentiable fixed point (femo_tpu_torch/graph/fixed_point.py),
`pcg_tol` (femo_tpu_torch/ops/block_tridiag.py) and the chunked entity
loop of the assembly (femo_tpu_torch/fea/assemble.py).

* Both fixed-point solvers, forward and IFT adjoint, on x = A x + b,
  whose solution and gradient have a closed form (1e-10), and against the
  JAX package's solvers on the same problem (1e-12).
* An IFT solve frees its saved state at its first backward unless it was
  built under `repeated_backward()`, as the fixed point's adjoint builds
  its pass.
* pcg_tol against the JAX package's pcg_tol, live, on a seeded SPD
  block-tridiagonal matrix preconditioned by its f32-stored block-Thomas
  factor: the same iteration count, the solution to 1e-10 and the
  relative residual to 1e-15.
* Chunked assembly gives the same bits as the whole-mesh vmap, for
  residuals and element-matrix blocks of cell, exterior- and
  interior-facet terms and of the shell's composite state, with the
  entity count not a multiple of the chunk (a remainder below 8 too:
  the last slice is padded to the chunk).
"""

import contextlib

import numpy as np
import pytest
import torch

import jax

jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp  # noqa: E402

from femo_tpu.graph import fixed_point as jfp  # noqa: E402
from femo_tpu.ops import block_tridiag as jbt  # noqa: E402

from femo_tpu_torch.fea import forms  # noqa: E402
from femo_tpu_torch.fea.assemble import compile_form  # noqa: E402
from femo_tpu_torch.fea.forms import FormDef  # noqa: E402
from femo_tpu_torch.fea.space import Function, FunctionSpace  # noqa: E402
from femo_tpu_torch.graph.fixed_point import (  # noqa: E402
    fixed_point_solve, fixed_point_solve_jit)
from femo_tpu_torch.graph.implicit import (  # noqa: E402
    _ift_solve, repeated_backward)
from femo_tpu_torch.mesh.generators import (  # noqa: E402
    create_unit_square_mesh)
from femo_tpu_torch.models.fsi import _wing_shell_system  # noqa: E402
from femo_tpu_torch.ops.block_tridiag import (  # noqa: E402
    BlockTridiagonalMatrix, pcg_tol)

torch.set_num_threads(1)

SOLVERS = {"eager": (fixed_point_solve, jfp.fixed_point_solve),
           "jit": (fixed_point_solve_jit, jfp.fixed_point_solve_jit)}


def _linear_case():
    rng = np.random.default_rng(1)
    A = 0.3 * rng.normal(size=(6, 6)) / np.sqrt(6)
    return A, rng.normal(size=6), rng.normal(size=6)


@pytest.mark.parametrize("relax", [1.0, 0.7])
@pytest.mark.parametrize("name", sorted(SOLVERS))
def test_fixed_point_linear_exact(name, relax):
    """x = A x + b: x* = (I - A)^{-1} b, d(c.x*)/db = (I - A)^{-T} c
    (tests/test_fsi.py::test_fixed_point_adjoint_linear_exact), and d/dA
    = outer((I - A)^{-T} c, x*); the JAX package's solver on the same
    problem."""
    A, b0, c = _linear_case()
    solve, jsolve = SOLVERS[name]
    At = torch.as_tensor(A).requires_grad_(True)
    bt = torch.as_tensor(b0).requires_grad_(True)
    x = solve(lambda x, p: p["A"] @ x + p["b"],
              torch.zeros(6, dtype=torch.float64), {"A": At, "b": bt},
              tol=1e-14, maxiter=500, relax=relax)
    gA, gb = torch.autograd.grad(torch.dot(torch.as_tensor(c), x), [At, bt])
    x_exact = np.linalg.solve(np.eye(6) - A, b0)
    g_exact = np.linalg.solve(np.eye(6) - A.T, c)
    np.testing.assert_allclose(x.detach().numpy(), x_exact, rtol=1e-10)
    np.testing.assert_allclose(gb.numpy(), g_exact, rtol=1e-10)
    np.testing.assert_allclose(gA.numpy(), np.outer(g_exact, x_exact),
                               rtol=1e-10)

    def jobj(b):
        xj = jsolve(lambda x, p: jnp.asarray(A) @ x + p["b"], jnp.zeros(6),
                    {"b": b}, tol=1e-14, maxiter=500, relax=relax)
        return jnp.dot(jnp.asarray(c), xj), xj

    (_, xj), gj = jax.value_and_grad(jobj, has_aux=True)(jnp.asarray(b0))
    np.testing.assert_allclose(x.detach().numpy(), np.asarray(xj),
                               rtol=1e-12)
    np.testing.assert_allclose(gb.numpy(), np.asarray(gj), rtol=1e-12)


def test_eager_fixed_point_warns_when_not_converged():
    A, b0, _ = _linear_case()
    with pytest.warns(UserWarning, match="did not converge"):
        fixed_point_solve(lambda x, p: torch.as_tensor(A) @ x + p["b"],
                          torch.zeros(6, dtype=torch.float64),
                          {"b": torch.as_tensor(b0)}, tol=1e-14, maxiter=3)


@pytest.mark.parametrize("repeat", [False, True])
def test_ift_solve_frees_its_state_unless_repeated(repeat):
    """An IFT solve frees its saved state (a factor) at its first
    backward; built inside repeated_backward(), as the fixed point's
    adjoint builds its pass, it keeps it for the next backward."""
    A = torch.as_tensor(2.0 * np.eye(3) + 0.1)
    solve = _ift_solve(
        lambda inp, u0: (torch.linalg.solve(A, inp["b"]), A),
        lambda u, inp, saved, ubar: {"b": torch.linalg.solve(saved.T,
                                                             ubar)})
    b = torch.ones(3, dtype=torch.float64, requires_grad=True)
    with repeated_backward() if repeat else contextlib.nullcontext():
        u = solve({"b": b}, torch.zeros(3, dtype=torch.float64))
    (g,) = torch.autograd.grad(u.sum(), b, retain_graph=True)
    np.testing.assert_allclose(g.numpy(),
                               np.linalg.solve(A.numpy().T, np.ones(3)))
    if repeat:
        assert torch.equal(torch.autograd.grad(u.sum(), b)[0], g)
    else:
        with pytest.raises(AttributeError):  # the state is gone: None.T
            torch.autograd.grad(u.sum(), b)


def _spd_block_tridiag(nb=6, B=32, seed=0):
    """A = R R^T + I with R block lower bidiagonal: SPD and exactly
    block tridiagonal (identity permutation); its D, L, U blocks."""
    rng = np.random.default_rng(seed)
    n = nb * B
    R = np.zeros((n, n))
    for i in range(nb):
        R[i * B:(i + 1) * B, i * B:(i + 1) * B] = rng.normal(size=(B, B))
        if i:
            R[i * B:(i + 1) * B, (i - 1) * B:i * B] = rng.normal(size=(B, B))
    A = R @ R.T + np.eye(n)
    blk = lambda i, j: A[i * B:(i + 1) * B, j * B:(j + 1) * B]  # noqa
    z = np.zeros((B, B))
    D = np.stack([blk(i, i) for i in range(nb)])
    L = np.stack([blk(i, i - 1) if i else z for i in range(nb)])
    U = np.stack([blk(i, i + 1) if i < nb - 1 else z for i in range(nb)])
    return A, D, L, U, rng.normal(size=n)


@pytest.mark.parametrize("maxiter", [100, 3])
def test_pcg_tol_matches_jax(maxiter):
    """The same iterations as the JAX package's pcg_tol, to rtol 1e-12
    (or stopped at maxiter), with the f32-stored factor as the
    preconditioner."""
    A, D, L, U, b = _spd_block_tridiag()
    n = len(b)
    mat = BlockTridiagonalMatrix(*(torch.as_tensor(a) for a in (D, L, U)),
                                 np.arange(n), n)
    fac = mat.factor("float32", spd=True)
    x, k, rr = pcg_tol(mat, fac, torch.as_tensor(b), rtol=1e-12,
                       maxiter=maxiter)

    @jax.jit
    def jpcg(D, L, U, b):
        jmat = jbt.BlockTridiagonalMatrix(D, L, U, np.arange(n), n)
        return jbt.pcg_tol(jmat, jmat.factor("float32"), b, rtol=1e-12,
                           maxiter=maxiter)

    jx, jk, jrr = jpcg(*(jnp.asarray(a) for a in (D, L, U, b)))
    assert k == int(jk) and 1 < k <= maxiter
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=1e-10)
    # the relative residual is itself relative: held to rounding
    np.testing.assert_allclose(float(rr), float(jrr), rtol=0, atol=1e-15)
    if maxiter == 100:
        assert float(rr) <= 1e-12
        np.testing.assert_allclose(x.numpy(), np.linalg.solve(A, b),
                                   rtol=1e-9)


def _square_forms():
    """A nonlinear residual with cell, exterior- and interior-facet terms
    on the unit square 5 (50 cells, 20 exterior and 65 interior facets)."""
    mesh = create_unit_square_mesh(5)
    V = FunctionSpace(mesh, ("CG", 2), device="cpu")
    u = Function(V, "u")
    f = forms

    def cell(w, g):
        return (1 + w.u**2) * f.dot(f.grad(w.u), f.grad(w.v)) - w.u * w.v

    def ext(w, g):
        return w.u**3 * w.v / g.h + f.dot(f.grad(w.u), g.n) * w.v

    def inter(w, g):
        j = f.jump(w.u, g.n)
        return f.dot(j, j) * f.avg(w.v) / g.h

    return FormDef([f.dx(cell), f.ds(ext), f.dS(inter)], coeffs=[u],
                   test=V), V


@pytest.mark.parametrize("chunk", [8, 16, 43])
def test_chunked_assembly_same_bits(chunk):
    form, V = _square_forms()
    cf = compile_form(form)
    rng = np.random.default_rng(5)
    vals = {"u": torch.as_tensor(rng.normal(size=V.n_dofs))}
    assert any(t.n_ent > chunk and t.n_ent % chunk for t in cf.terms)
    assert torch.equal(cf.vector(vals, chunk), cf.vector(vals))
    whole, chunked = cf.matrix(vals, "u"), cf.matrix(vals, "u", chunk)
    for a, b in zip(whole.blocks, chunked.blocks):
        assert a.A.shape == b.A.shape and torch.equal(a.A, b.A)


def test_chunked_composite_same_bits():
    """The shell wing's composite residual and Jacobian blocks (48 cells,
    chunks of 10), the pieces build_fsi_jit_step chunks at scale."""
    mesh, shell, state = _wing_shell_system((4, 6), 4.0, 1.0, 7e10, 0.3,
                                            2700.0, "cpu")
    rng = np.random.default_rng(6)
    x = torch.as_tensor(1e-3 * rng.normal(size=state.n_dofs))
    inputs = {"thickness": torch.as_tensor(
        0.01 + 1e-3 * rng.random(shell.Vt.n_dofs)),
        "force": torch.as_tensor(rng.normal(size=shell.Vf.n_dofs))}
    assert torch.equal(state.residual(x, inputs, chunk=10),
                       state.residual(x, inputs))
    for (a, ra, ca), (b, rb, cb) in zip(
            state.jacobian_blocks(x, inputs),
            state.jacobian_blocks(x, inputs, chunk=10)):
        assert torch.equal(a, b) and torch.equal(ra, rb) \
            and torch.equal(ca, cb)
