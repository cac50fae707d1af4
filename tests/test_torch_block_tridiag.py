"""The port's block-tridiagonal template, factor and solves
(femo_tpu_torch/ops/block_tridiag.py) against the JAX package's, on the
refine-0.5 motor's mesh-motion and EM Jacobians, f64, CPU.

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

from femo_tpu.fea import Function as JFunction, FunctionSpace as JSpace
from femo_tpu.fea.assemble import compile_form as jcompile
from femo_tpu.fea.bc import DirichletBC as JDirichletBC, bc_arrays as jbc
from femo_tpu.fea.forms import GlobalCoefficient as JGlobal
from femo_tpu.models.motor import pde as jpde
from femo_tpu.models.motor.mesh import RADII, create_motor_mesh
from femo_tpu.models.motor.permeability import PiecewiseBHCurve as JBH
from femo_tpu.ops.block_tridiag import (
    BlockTridiagTemplate as JTemplate, pcg_fixed as jpcg_fixed)

from femo_tpu_torch.convert import mesh_from_jax
from femo_tpu_torch.fea.bc import DirichletBC, bc_arrays
from femo_tpu_torch.fea.space import FunctionSpace
from femo_tpu_torch.ops.block_tridiag import (
    BlockThomasFactor, BlockTridiagonalMatrix, BlockTridiagTemplate,
    pcg_fixed)

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
    fac = case["tmat"].factor()
    b = torch.zeros(case["tmat"].n, dtype=torch.float64)
    for kw in ({"scale": torch.ones(1)}, {"sweep_dtype": torch.float32}):
        with pytest.raises(NotImplementedError):
            BlockThomasFactor(fac.mat, fac.Sinv, fac.C, **kw).solve(b)
