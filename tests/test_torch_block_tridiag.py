"""The port's block-tridiagonal template, factor and solves
(femo_tpu_torch/ops/block_tridiag.py) against the JAX package's, on the
refine-0.5 motor's mesh-motion and EM Jacobians, f64, CPU; its Jacobi
scaling there (1e-14); and, on the Poisson system of
tests/test_block_tridiag.py, the host construction from an element
matrix (1e-14) and the `block_thomas` / `*_bt` LinearSolver backends.

The host analyze step shares the JAX package's C++ (RCM, destination map),
so the layout is EQUAL.  Tolerances: fill 1e-13 (the same sums in another
order); factor blocks 1e-10 relative (the block inverses come from
different LAPACK paths); matvecs, solves and PCG 1e-12 (given the same
factor arrays).
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from femo_tpu.fea import (
    FormDef as JFormDef, Function as JFunction, FunctionSpace as JSpace,
    assemble_matrix as jassemble_matrix, create_unit_square_mesh as jsquare,
    dot as jdot, dx as jdx, grad as jgrad)
from femo_tpu.fea.assemble import compile_form as jcompile
from femo_tpu.fea.bc import DirichletBC as JDirichletBC, bc_arrays as jbc
from femo_tpu.fea.forms import GlobalCoefficient as JGlobal
from femo_tpu.models.motor import pde as jpde
from femo_tpu.models.motor.mesh import RADII, create_motor_mesh
from femo_tpu.models.motor.permeability import PiecewiseBHCurve as JBH
from femo_tpu.ops.block_tridiag import (
    BlockThomasFactor as JFactor, BlockTridiagonalMatrix as JMatrix,
    BlockTridiagTemplate as JTemplate, pcg_fixed as jpcg_fixed)
from femo_tpu.solvers.linear import LinearSolver as JLinearSolver

from femo_tpu_torch.convert import mesh_from_jax
from femo_tpu_torch.fea.assemble import assemble_matrix
from femo_tpu_torch.fea.bc import DirichletBC, bc_arrays
from femo_tpu_torch.fea.forms import FormDef, dot, dx, grad
from femo_tpu_torch.fea.space import Function, FunctionSpace
from femo_tpu_torch.ops.block_tridiag import (
    BlockThomasFactor, BlockTridiagonalMatrix, BlockTridiagTemplate,
    pcg_fixed)
from femo_tpu_torch.solvers.linear import LinearSolver

# the port's CPU path is dispatch-bound: extra intra-op threads only
# oversubscribe the cores that parallel test workers share
torch.set_num_threads(1)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _on_rim(x):
    r = np.hypot(x[0], x[1])
    return (np.isclose(r, RADII["r0"], atol=1e-9)
            | np.isclose(r, RADII["r6"], atol=1e-9))


@pytest.fixture(scope="module", params=["mm", "em"])
def case(request):
    """Both packages' templates on one Jacobian pattern, plus the JAX
    element blocks at seeded fields."""
    jmesh = create_motor_mesh(0.5)
    Vmm = JSpace(jmesh, ("CG", 1), ncomp=2)
    Vem = JSpace(jmesh, ("CG", 1))
    uhat, uhat_bc, A_z = (JFunction(Vmm, "uhat"), JFunction(Vmm, "uhat_bc"),
                          JFunction(Vem, "A_z"))
    Ht, Jt = jpde.source_tables(jnp.asarray(1e5), jnp.asarray(0.0))
    rng = np.random.default_rng(5)
    vals = {"uhat": jnp.asarray(2e-5 * rng.standard_normal(Vmm.n_dofs)),
            "uhat_bc": jnp.asarray(2e-5 * rng.standard_normal(Vmm.n_dofs)),
            "A_z": jnp.asarray(5e-3 * rng.standard_normal(Vem.n_dofs)),
            "Htable": Ht, "Jtable": Jt}
    if request.param == "mm":
        form, wrt, jV = jpde.mesh_motion_residual_form(uhat, uhat_bc), \
            "uhat", Vmm
    else:
        form, wrt, jV = jpde.em_residual_form(
            A_z, uhat, JGlobal("Htable", Ht), JGlobal("Jtable", Jt),
            JBH()), "A_z", Vem
    cf = jcompile(form)
    jfree, _ = jbc([JDirichletBC(jV, 0.0, where=_on_rim)], jV.n_dofs)
    V = FunctionSpace(mesh_from_jax(jmesh), ("CG", 1), ncomp=jV.ncomp,
                      device="cpu")
    free, _ = bc_arrays([DirichletBC(V, 0.0, where=_on_rim)], V.n_dofs,
                        device="cpu")
    np.testing.assert_array_equal(free.numpy(), np.asarray(jfree))
    jtpl = JTemplate(cf.matrix_pattern(wrt), free=np.asarray(jfree))
    tpl = BlockTridiagTemplate(cf.matrix_pattern(wrt), free=free.numpy(),
                               device="cpu")
    blocks = cf.matrix_blocks_jit(wrt)({k: vals[k] for k in cf.all_names})
    jmat = jtpl.matrix(blocks)
    tmat = tpl.matrix([(torch.as_tensor(np.array(A)), None, None)
                       for A, _, _ in blocks])
    return dict(jtpl=jtpl, tpl=tpl, jmat=jmat, tmat=tmat,
                jfac=jmat.factor(), rng=rng,
                nb={"mm": 11, "em": 6}[request.param])


def _port_factor(case, transpose=False):
    """The port's factor object holding the JAX factor's arrays, so the
    solve-phase comparisons see identical blocks."""
    jmat = case["jmat"]
    jfac = jmat.factor_t() if transpose else case["jfac"]
    t = lambda a: torch.as_tensor(np.array(a))
    m = BlockTridiagonalMatrix(t(jmat.D), t(jmat.L), t(jmat.U),
                               jmat.perm, jmat.n)
    if transpose:
        m = m._transposed()
    return BlockThomasFactor(m, t(jfac.Sinv), t(jfac.C))


def test_template_layout_is_equal(case):
    jtpl, tpl = case["jtpl"], case["tpl"]
    assert (tpl.n, tpl.nb, tpl.B, tpl.bw) == (jtpl.n, jtpl.nb, jtpl.B,
                                              jtpl.bw)
    assert (tpl.nb, tpl.B) == (case["nb"], 128)
    np.testing.assert_array_equal(tpl.perm_full, jtpl.perm_full)
    np.testing.assert_array_equal(tpl.dest.numpy(), np.asarray(jtpl.dest))
    np.testing.assert_array_equal(tpl.diag_ids.numpy(),
                                  np.asarray(jtpl.diag_ids))


def test_fill_matches(case):
    jmat, tmat = case["jmat"], case["tmat"]
    for a, b in ((tmat.D, jmat.D), (tmat.L, jmat.L), (tmat.U, jmat.U)):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 1e-13 * np.abs(b).max()


def test_factor_matches(case):
    jfac, fac = case["jfac"], case["tmat"].factor()
    assert _rel(fac.Sinv.numpy(), jfac.Sinv) <= 1e-10
    assert _rel(fac.C.numpy(), jfac.C) <= 1e-10
    jfac_t, fac_t = case["jmat"].factor_t(), case["tmat"].factor_t()
    assert _rel(fac_t.Sinv.numpy(), jfac_t.Sinv) <= 1e-10
    assert _rel(fac_t.C.numpy(), jfac_t.C) <= 1e-10


@pytest.mark.parametrize("op", ["matvec", "matvec_t", "solve", "solve_t"])
def test_products_and_solves_match(case, op):
    n = case["jmat"].n
    x = case["rng"].standard_normal(n)
    if op.startswith("matvec"):
        y_j = getattr(case["jmat"], op)(jnp.asarray(x))
        y_t = getattr(case["tmat"], op)(torch.as_tensor(x))
    else:
        transpose = op == "solve_t"
        jfac = case["jmat"].factor_t() if transpose else case["jfac"]
        y_j = jfac.solve(jnp.asarray(x))
        y_t = _port_factor(case, transpose).solve(torch.as_tensor(x))
    assert _rel(y_t.numpy(), y_j) <= 1e-12


@pytest.mark.parametrize("transpose", [False, True])
def test_pcg_fixed_matches(case, transpose):
    jmat = case["jmat"]
    b = case["rng"].standard_normal(jmat.n)
    jfac = jmat.factor_t() if transpose else case["jfac"]
    x_j = jpcg_fixed(jmat, jfac, jnp.asarray(b), 8, transpose=transpose)
    fac = _port_factor(case, transpose)
    m = BlockTridiagonalMatrix(*(torch.as_tensor(np.array(a)) for a in (
        jmat.D, jmat.L, jmat.U)), jmat.perm, jmat.n)
    x_t = pcg_fixed(m, fac, torch.as_tensor(b), 8, transpose=transpose)
    assert _rel(x_t.numpy(), x_j) <= 1e-12
    # and with a warm start, as the Newton step calls it
    x_j0 = jpcg_fixed(jmat, jfac, jnp.asarray(b), 8, x0=jfac.solve(
        jnp.asarray(b)), transpose=transpose)
    x_t0 = pcg_fixed(m, None, torch.as_tensor(b), 8,
                     x0=fac.solve(torch.as_tensor(b)), transpose=transpose,
                     M=fac.solve)
    assert _rel(x_t0.numpy(), x_j0) <= 1e-12


def test_factor_refuses_unported_modes(case):
    """The JAX factor's reduced-precision sweeps and scaled solve, once
    refused here, are ported (`sweep_dtype`, `scale`, `Lfac`): the f32
    factor of the equilibrated operator solved as x = S F^{-1} (S b) with
    the sweeps in f32, against the JAX package's solve of the same
    (1e-5, f32 factors from different LAPACK paths)."""
    f32 = np.float32
    jsm, js = case["jmat"].jacobi_scaled()
    jf = JMatrix(jsm.D.astype(f32), jsm.L.astype(f32), jsm.U.astype(f32),
                 jsm.perm, jsm.n).factor()
    jfac = JFactor(case["jmat"], jf.Sinv, jf.C, sweep_dtype="float32",
                   scale=js, Lfac=jsm.L.astype(f32))
    tm = case["tmat"]
    sm, s = tm.jacobi_scaled()
    tf = sm._like(sm.D.float(), sm.L.float(), sm.U.float()).factor()
    fac = BlockThomasFactor(tm, tf.Sinv, tf.C, sweep_dtype=torch.float32,
                            scale=s, Lfac=sm.L.float())
    b = case["rng"].standard_normal(tm.n)
    x = fac.solve(torch.as_tensor(b))
    assert x.dtype == torch.float64
    assert _rel(x.numpy(), jfac.solve(jnp.asarray(b))) <= 1e-5


def test_jacobi_scaled_matches(case):
    jsm, js = case["jmat"].jacobi_scaled()
    sm, s = case["tmat"].jacobi_scaled()
    assert _rel(s.numpy(), js) <= 1e-14
    for a, b in ((sm.D, jsm.D), (sm.L, jsm.L), (sm.U, jsm.U)):
        assert _rel(a.numpy(), b) <= 1e-14
    x = case["rng"].standard_normal(case["jmat"].n)
    assert _rel(case["tmat"].scale_vector(torch.as_tensor(x), s).numpy(),
                case["jmat"].scale_vector(jnp.asarray(x), js)) <= 1e-14
    # the scaled solve S F'^{-1} S b inverts A
    b = torch.as_tensor(x)
    fac = sm.factor()
    y = case["tmat"].scale_vector(
        fac.solve(case["tmat"].scale_vector(b, s)), s)
    assert _rel(case["tmat"].matvec(y).numpy(), x) <= 1e-10


# The Poisson system of tests/test_block_tridiag.py: -lap u + u on the unit
# square 16, u = 0 on x = 0.


def _poisson(FS, Fn, FD, dx_, dot_, grad_, assemble, bcs, DBC, mesh, **kw):
    V = FS(mesh, ("CG", 1), **kw)
    u = Fn(V, "u")
    A = assemble(FD([dx_(lambda w, g: dot_(grad_(w.u), grad_(w.v))
                         + w.u * w.v)], coeffs=[u], test=V), "u")
    free, _ = bcs([DBC(V, 0.0, where=lambda x: np.isclose(x[0], 0))],
                  V.n_dofs, **kw)
    return A, free


@pytest.fixture(scope="module")
def poisson():
    jm = jsquare(16)
    jA, jfree = _poisson(JSpace, JFunction, JFormDef, jdx, jdot, jgrad,
                         jassemble_matrix, jbc, JDirichletBC, jm)
    A, free = _poisson(FunctionSpace, Function, FormDef, dx, dot, grad,
                       assemble_matrix, bc_arrays, DirichletBC,
                       mesh_from_jax(jm), device="cpu")
    np.testing.assert_array_equal(free.numpy(), np.asarray(jfree))
    b = np.random.default_rng(9).standard_normal(len(free))
    return dict(jA=jA, jfree=jfree, A=A, free=free, b=b)


def test_from_element_matrix_matches(poisson):
    """The port lays the constrained operator out with its template and
    the JAX package with scipy, so the two may order the dofs apart: they
    are held to the same operator, A x and A^T x in dof order (1e-14)."""
    jm = JMatrix.from_element_matrix(poisson["jA"], np.asarray(
        poisson["jfree"]))
    m = BlockTridiagonalMatrix.from_element_matrix(poisson["A"],
                                                   poisson["free"])
    assert m.n == jm.n
    x = np.random.default_rng(3).standard_normal(m.n)
    for mv, jmv in ((m.matvec, jm.matvec), (m.matvec_t, jm.matvec_t)):
        assert _rel(mv(torch.as_tensor(x)).numpy(),
                    jmv(jnp.asarray(x))) <= 1e-14


@pytest.mark.parametrize("method", ["block_thomas", "cg_bt", "bicgstab_bt",
                                    "gmres_bt"])
@pytest.mark.parametrize("transpose", [False, True],
                         ids=["solve", "solve_t"])
def test_block_thomas_backends_match_jax(poisson, method, transpose):
    """LinearSolver's block-Thomas backends: the direct solve (1e-12) and
    Krylov preconditioned by the factor, of the transpose in solve_t
    (1e-10, the Krylov stopping rule)."""
    fac = LinearSolver(method=method).factor(poisson["A"], poisson["free"])
    jfac = JLinearSolver(method=method).factor(poisson["jA"],
                                               poisson["jfree"])
    b = poisson["b"]
    if transpose:
        x, jx = fac.solve_t(torch.as_tensor(b)), jfac.solve_t(jnp.asarray(b))
    else:
        x, jx = fac.solve(torch.as_tensor(b)), jfac.solve(jnp.asarray(b))
    tol = 1e-12 if method == "block_thomas" else 1e-10
    assert _rel(x.numpy(), jx) <= tol
    if method != "block_thomas":
        assert fac.last_result.iters == jfac.last_result.iters
    # the constrained residual
    free, A = poisson["free"], poisson["A"]
    mv = A.rmatvec if transpose else A.matvec
    r = torch.where(free, mv(torch.where(free, x, 0.0)), x) \
        - torch.as_tensor(b)
    assert float(torch.linalg.norm(r)) <= 1e-9 * np.linalg.norm(b)


def test_solve_refined_matches(poisson):
    m = BlockTridiagonalMatrix.from_element_matrix(poisson["A"],
                                                   poisson["free"])
    jm = JMatrix.from_element_matrix(poisson["jA"], np.asarray(
        poisson["jfree"]))
    b = poisson["b"]
    for refine in (0, 2):
        x = m.factor().solve_refined(torch.as_tensor(b), refine)
        jx = jm.factor().solve_refined(jnp.asarray(b), refine)
        assert _rel(x.numpy(), jx) <= 1e-12
