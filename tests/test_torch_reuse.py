"""Shamanskii factor reuse, Jacobi scaling and the dense-LU implicit solve
of the port (femo_tpu_torch/graph/implicit.py) against the JAX package,
on the nonlinear Poisson system of tests/test_block_tridiag.py
(-lap u + u^3 = f, u = 0 on x = 0, f = 8 on DG0; the unit square 14 for
`refactor_every=3`, 12 for the frozen operator), f64, CPU.

Both packages run the same algorithm with the same iteration counts, so
they agree to round-off: value 1e-10 relative, gradient 1e-8 relative L2.
Against the port's own every-iteration factor, the JAX package's own bars:
1e-10 / 1e-8 for factor reuse, 1e-7 / 1e-6 for the frozen operator (a
quasi-Newton iteration that approaches the same root more slowly).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from femo_tpu.config import config as jconfig
from femo_tpu.fea import (
    DirichletBC as JDirichletBC, FormDef as JFormDef, Function as JFunction,
    FunctionSpace as JSpace, bc_arrays as jbc_arrays,
    create_unit_square_mesh as jsquare, dot as jdot, dx as jdx,
    grad as jgrad)
from femo_tpu.fea.assemble import (
    ElementMatrix as JElementMatrix, MatBlock as JMatBlock,
    compile_form as jcompile)
from femo_tpu.graph.implicit import (
    implicit_solve_bt_jit, implicit_solve_dense_jit)
from femo_tpu.ops.block_tridiag import BlockTridiagTemplate as JTemplate

from femo_tpu_torch.convert import mesh_from_jax
from femo_tpu_torch.fea.assemble import compile_form
from femo_tpu_torch.fea.bc import DirichletBC, bc_arrays
from femo_tpu_torch.fea.forms import FormDef, dot, dx, grad
from femo_tpu_torch.fea.space import Function, FunctionSpace
from femo_tpu_torch.graph.implicit import (
    implicit_solve_bt, implicit_solve_dense)
from femo_tpu_torch.ops.block_tridiag import BlockTridiagTemplate

torch.set_num_threads(1)

LOADS = dict(load_steps=2, pcg_iters=4)
NEWTON = {14: 6, 12: 8}  # Newton iterations per load step


def _x0(x):
    return np.isclose(x[0], 0)


def _residual(dot_, grad_):
    return lambda w, g: (dot_(grad_(w.u), grad_(w.v)) + w.u**3 * w.v
                         - w.f * w.v)


_SYSTEMS = {}


def system(n):
    """Both packages' forms, BCs and templates on the unit square n."""
    if n in _SYSTEMS:
        return _SYSTEMS[n]
    jmesh = jsquare(n)
    jV, jW = JSpace(jmesh, ("CG", 1)), JSpace(jmesh, ("DG", 0))
    ju, jf = JFunction(jV, "u"), JFunction(jW, "f")
    jcf = jcompile(JFormDef([jdx(_residual(jdot, jgrad))], coeffs=[ju, jf],
                            test=jV))
    jfree, jbv = jbc_arrays([JDirichletBC(jV, 0.0, where=_x0)], jV.n_dofs)
    # the template reads only the pattern: broadcast ones, no assembly
    # (an eager JAX Jacobian costs seconds of compiles)
    jtpl = JTemplate(JElementMatrix([JMatBlock(
        np.broadcast_to(1.0, t.gdofs0["__test__"].shape
                        + t.gdofs0["u"].shape[1:]),
        np.asarray(t.gdofs0["__test__"]), np.asarray(t.gdofs0["u"]))
        for t in jcf.terms], jV.n_dofs, jV.n_dofs), free=np.asarray(jfree))

    mesh = mesh_from_jax(jmesh)
    V = FunctionSpace(mesh, ("CG", 1), device="cpu")
    W = FunctionSpace(mesh, ("DG", 0), device="cpu")
    u, f = Function(V, "u"), Function(W, "f")
    cf = compile_form(FormDef([dx(_residual(dot, grad))], coeffs=[u, f],
                              test=V))
    free, bv = bc_arrays([DirichletBC(V, 0.0, where=_x0)], V.n_dofs,
                         device="cpu")
    tpl = BlockTridiagTemplate(cf.matrix_pattern("u"), free=free.numpy(),
                               device="cpu")
    _SYSTEMS[n] = out = dict(jcf=jcf, jfree=jfree, jbv=jbv, jtpl=jtpl,
                             cf=cf, free=free, bv=bv, tpl=tpl,
                             nu=V.n_dofs, nf=W.n_dofs)
    return out


def _jax_blocks(jcf):
    def blocks(uarr, p):
        raw = jcf.matrix({"u": uarr, "f": p["f"]}, "u")
        return [(b.A, b.rows, b.cols) for b in raw.blocks]
    return blocks


def jax_value_and_grad(n, dense=False, **kw):
    s = system(n)
    res = lambda uarr, p: s["jcf"].vector({"u": uarr, "f": p["f"]})
    if dense:
        solve = implicit_solve_dense_jit(
            res, lambda uarr, p: s["jcf"].matrix(
                {"u": uarr, "f": p["f"]}, "u").to_dense(),
            s["jfree"], s["jbv"], newton_iters=NEWTON[n], load_steps=2,
            **kw)
    else:
        solve = implicit_solve_bt_jit(
            res, _jax_blocks(s["jcf"]), s["jtpl"], s["jfree"], s["jbv"],
            newton_iters=NEWTON[n], **LOADS, **kw)

    def obj(farr):
        x = solve({"f": farr}, jnp.zeros(s["nu"], jconfig.jdtype))
        return jnp.sum(x**2)

    v, g = jax.jit(jax.value_and_grad(obj))(
        jnp.full(s["nf"], 8.0, jconfig.jdtype))
    return float(v), np.asarray(g)


def port_value_and_grad(n, dense=False, **kw):
    s = system(n)
    cf = s["cf"]
    res = lambda uarr, p: cf.vector({"u": uarr, "f": p["f"]})  # noqa
    if dense:
        solve = implicit_solve_dense(
            res, lambda uarr, p: cf.matrix(
                {"u": uarr, "f": p["f"]}, "u").to_dense(),
            s["free"], s["bv"], newton_iters=NEWTON[n], load_steps=2, **kw)
    else:
        def blocks(uarr, p):
            return [(b.A, b.rows, b.cols) for b in cf.matrix(
                {"u": uarr, "f": p["f"]}, "u").blocks]

        solve = implicit_solve_bt(res, blocks, s["tpl"], s["free"],
                                  s["bv"], newton_iters=NEWTON[n], **LOADS,
                                  **kw)
    f = torch.full((s["nf"],), 8.0, dtype=torch.float64, requires_grad=True)
    v = torch.sum(solve({"f": f}, torch.zeros(s["nu"],
                                              dtype=torch.float64)) ** 2)
    (g,) = torch.autograd.grad(v, f)
    return float(v.detach()), g.numpy()


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("n, kw", [
    (14, dict(refactor_every=3)),
    (12, dict(refactor_every=4, freeze_operator=True)),
    (14, dict(refactor_every=3, jacobi_scale=True)),
    (14, dict(jacobi_scale=True)),
], ids=["refactor3", "freeze4", "refactor3-jacobi", "jacobi"])
def test_bt_reuse_matches_jax(n, kw):
    """The same configuration in both packages at fixed iteration counts:
    round-off.  A preconditioner built from the fresh L beside the stale
    Sinv would be another (still convergent) iteration and miss this."""
    jv, jg = jax_value_and_grad(n, **kw)
    tv, tg = port_value_and_grad(n, **kw)
    assert abs(tv - jv) <= 1e-10 * abs(jv)
    assert _rel(tg, jg) <= 1e-8


def test_refactor_every_matches_every_iteration_factor():
    """Reuse keeps the fixed point (the residual and the PCG polish use
    the fresh operator): the JAX package's bars against refactor_every=1."""
    va, ga = port_value_and_grad(14)
    vb, gb = port_value_and_grad(14, refactor_every=3)
    assert abs(vb - va) <= 1e-10 * abs(va)
    assert np.allclose(gb, ga, rtol=1e-8, atol=0)


def test_freeze_operator_matches_every_iteration_factor_at_convergence():
    va, ga = port_value_and_grad(12)
    vb, gb = port_value_and_grad(12, refactor_every=4, freeze_operator=True)
    assert abs(vb - va) <= 1e-7 * abs(va)
    assert np.allclose(gb, ga, rtol=1e-6, atol=0)


@pytest.mark.parametrize("kw, match", [
    (dict(pcg_iters=0, refactor_every=2), "pcg_iters"),
    (dict(pcg_iters=4, factor_method="cr", refactor_every=2),
     "factor_method"),
    (dict(pcg_iters=4, refactor_every=1, freeze_operator=True),
     "refactor_every > 1"),
    (dict(pcg_iters=4, refactor_every=0), "refactor_every"),
    (dict(pcg_iters=4, refactor_every=2, freeze_operator=True,
          jacobi_scale=True), "jacobi_scale"),
], ids=["no-polish", "cr", "freeze-refactor1", "refactor0",
        "freeze-jacobi"])
def test_reuse_guards(kw, match):
    """The JAX package's guards; freeze with jacobi_scale raises in the
    port only (its JAX counterpart freezes raw D and U with a scaled L)."""
    s = system(12)
    with pytest.raises(ValueError, match=match):
        implicit_solve_bt(None, None, s["tpl"], s["free"], s["bv"], **kw)


@pytest.mark.parametrize("factorization", ["lu", "inv"])
def test_dense_matches_jax(factorization):
    jv, jg = jax_value_and_grad(12, dense=True, factorization=factorization)
    tv, tg = port_value_and_grad(12, dense=True,
                                 factorization=factorization)
    assert abs(tv - jv) <= 1e-10 * abs(jv)
    assert _rel(tg, jg) <= 1e-8
    # the dense Newton reaches the block-Thomas path's root
    bv, bg = port_value_and_grad(12)
    assert abs(tv - bv) <= 1e-10 * abs(bv)
    assert _rel(tg, bg) <= 1e-8
