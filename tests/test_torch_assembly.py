"""Parity of the port's host copies, forms and assembly (femo_tpu_torch)
with the JAX package on the refine-0.5 motor, f64, CPU.

Seeded fields (numpy) go through both packages' motor forms: residual
vectors, element-matrix blocks and B-power scalars agree to 1e-12
relative (the same arithmetic, summed in another order).
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from femo_tpu.elements.element import Element as JElement
from femo_tpu.elements.quadrature import cell_rule as jcell_rule
from femo_tpu.fea import Function as JFunction, FunctionSpace as JSpace
from femo_tpu.fea.assemble import compile_form as jcompile
from femo_tpu.fea.forms import GlobalCoefficient as JGlobal
from femo_tpu.models.motor import pde as jpde
from femo_tpu.models.motor.mesh import create_motor_mesh as jcreate_mesh
from femo_tpu.models.motor.permeability import PiecewiseBHCurve as JBH

from femo_tpu_torch.convert import mesh_from_jax
from femo_tpu_torch.elements.element import Element
from femo_tpu_torch.elements.quadrature import cell_rule
from femo_tpu_torch.fea.assemble import compile_form
from femo_tpu_torch.fea.forms import GlobalCoefficient
from femo_tpu_torch.fea.space import Function, FunctionSpace
from femo_tpu_torch.models.motor import pde
from femo_tpu_torch.models.motor.mesh import MotorTags, create_motor_mesh
from femo_tpu_torch.models.motor.permeability import PiecewiseBHCurve

T = MotorTags
TOL = 1e-12

# the port's CPU path is dispatch-bound: extra intra-op threads only
# oversubscribe the cores that parallel test workers share
torch.set_num_threads(1)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


def _forms(FS, Fn, GC, mod, BH, mesh, tables, **kw):
    Vmm = FS(mesh, ("CG", 1), ncomp=2, **kw)
    Vem = FS(mesh, ("CG", 1), **kw)
    uhat, uhat_bc, A_z = Fn(Vmm, "uhat"), Fn(Vmm, "uhat_bc"), Fn(Vem, "A_z")
    Ht = GC("Htable", tables[0], **kw)
    Jt = GC("Jtable", tables[1], **kw)
    bh = BH()
    return dict(
        mm=mod.mesh_motion_residual_form(uhat, uhat_bc),
        em=mod.em_residual_form(A_z, uhat, Ht, Jt, bh),
        eddy=mod.b_power_form(A_z, uhat, 2.0, (1, 2)),
        hyst=mod.b_power_form(A_z, uhat, 1.76835, (1, 2)),
        n_mm=Vmm.n_dofs, n_em=Vem.n_dofs)


@pytest.fixture(scope="module")
def both():
    jmesh = jcreate_mesh(0.5)
    Ht, Jt = jpde.source_tables(jnp.asarray(1e5), jnp.asarray(0.0))
    tables = (np.array(Ht), np.array(Jt))
    jf = _forms(JSpace, JFunction, JGlobal, jpde, JBH, jmesh, tables)
    tf = _forms(FunctionSpace, Function, GlobalCoefficient, pde,
                PiecewiseBHCurve, mesh_from_jax(jmesh), tables,
                device="cpu")
    rng = np.random.default_rng(11)
    vals = {
        "uhat": 2e-5 * rng.standard_normal(jf["n_mm"]),
        "uhat_bc": 2e-5 * rng.standard_normal(jf["n_mm"]),
        "A_z": 5e-3 * rng.standard_normal(jf["n_em"]),
        "Htable": tables[0], "Jtable": tables[1],
    }
    return jf, tf, vals


def _pick(cf, vals, lib):
    if lib == "jax":
        return {k: jnp.asarray(vals[k]) for k in cf.all_names}
    return {k: torch.as_tensor(vals[k], dtype=torch.float64)
            for k in cf.all_names}


def test_motor_mesh_arrays_match():
    jm = jcreate_mesh(0.5)
    tm = create_motor_mesh(0.5)
    np.testing.assert_array_equal(tm.coords, jm.coords)
    np.testing.assert_array_equal(tm.cells, jm.cells)
    np.testing.assert_array_equal(tm.cell_tags, jm.cell_tags)
    np.testing.assert_array_equal(tm.facets, jm.facets)
    np.testing.assert_array_equal(tm.facet_cells, jm.facet_cells)
    np.testing.assert_array_equal(tm.facet_local, jm.facet_local)
    np.testing.assert_array_equal(tm.facet_tags, jm.facet_tags)
    np.testing.assert_array_equal(tm.cell_sizes(), jm.cell_sizes())
    cm = mesh_from_jax(jm)
    np.testing.assert_array_equal(cm.facet_tags, jm.facet_tags)
    assert (cm.facet_tags == T.MAGNET_INTERFACE).sum() > 0


@pytest.mark.parametrize("qdeg", [2, 3])
def test_quadrature_and_tabulation_match(qdeg):
    for cell in ("triangle", "interval"):
        qp, qw = cell_rule(cell, qdeg)
        jqp, jqw = jcell_rule(cell, qdeg)
        np.testing.assert_array_equal(qp, jqp)
        np.testing.assert_array_equal(qw, jqw)
    qp, _ = cell_rule("triangle", qdeg)
    for ncomp in (1, 2):
        N, dN = Element("triangle", "P", 1, ncomp).tabulate(qp)
        jN, jdN = JElement("triangle", "P", 1, ncomp).tabulate(qp)
        np.testing.assert_array_equal(N, jN)
        np.testing.assert_array_equal(dN, jdN)


def test_function_space_dofmaps_match():
    jm = jcreate_mesh(0.5)
    for ncomp in (1, 2):
        jV = JSpace(jm, ("CG", 1), ncomp=ncomp)
        V = FunctionSpace(mesh_from_jax(jm), ("CG", 1), ncomp=ncomp,
                          device="cpu")
        np.testing.assert_array_equal(V.dofmap, jV.dofmap)
        np.testing.assert_array_equal(V.scalar_dof_coords,
                                      jV.scalar_dof_coords)
        assert V.n_dofs == jV.n_dofs


@pytest.mark.parametrize("name", ["mm", "em"])
def test_residual_vectors_match(both, name):
    jf, tf, vals = both
    jcf, tcf = jcompile(jf[name]), compile_form(tf[name])
    r_j = np.asarray(jcf.vector_jit()(_pick(jcf, vals, "jax")))
    r_t = tcf.vector(_pick(tcf, vals, "torch")).numpy()
    assert np.abs(r_j).max() > 0
    assert _rel(r_t, r_j) <= TOL


@pytest.mark.parametrize("name,wrt", [("mm", "uhat"), ("em", "A_z"),
                                      ("em", "uhat")])
def test_element_matrix_blocks_match(both, name, wrt):
    jf, tf, vals = both
    jcf, tcf = jcompile(jf[name]), compile_form(tf[name])
    jblocks = jcf.matrix_blocks_jit(wrt)(_pick(jcf, vals, "jax"))
    tblocks = tcf.matrix(_pick(tcf, vals, "torch"), wrt).blocks
    assert len(jblocks) == len(tblocks)
    for (jA, jr, jc), b in zip(jblocks, tblocks):
        np.testing.assert_array_equal(b.rows.numpy(), np.asarray(jr))
        np.testing.assert_array_equal(b.cols.numpy(), np.asarray(jc))
        assert b.A.shape == jA.shape
        assert _rel(b.A.numpy(), jA) <= TOL
    # the pattern prototype carries the same ids without running a kernel
    for (_, jr, jc), b in zip(jblocks, tcf.matrix_pattern(wrt).blocks):
        np.testing.assert_array_equal(b.rows, np.asarray(jr))
        np.testing.assert_array_equal(b.cols, np.asarray(jc))


@pytest.mark.parametrize("name", ["eddy", "hyst"])
def test_b_power_scalars_match(both, name):
    jf, tf, vals = both
    jcf, tcf = jcompile(jf[name]), compile_form(tf[name])
    s_j = float(jcf.scalar_jit()(_pick(jcf, vals, "jax")))
    s_t = float(tcf.scalar(_pick(tcf, vals, "torch")))
    assert s_j > 0
    assert abs(s_t - s_j) <= TOL * abs(s_j)


def test_bh_curve_c1_continuity():
    bh = PiecewiseBHCurve()
    f = lambda x: float(bh(torch.tensor(x, dtype=torch.float64)))
    for x in (bh.x1, bh.x2):
        np.testing.assert_allclose(f(x - 1e-8), f(x + 1e-8), rtol=1e-5)
        dlo = (f(x - 1e-6) - f(x - 2e-6)) / 1e-6
        dhi = (f(x + 2e-6) - f(x + 1e-6)) / 1e-6
        np.testing.assert_allclose(dlo, dhi, rtol=2e-2, atol=1.0)
    # saturates toward mu_r -> 1
    assert f(3.0) < f(0.5)
    assert f(6.0) > 1.0
    # the same law as the JAX package's
    B = np.linspace(0.0, 3.0, 301)
    jbh = JBH()
    assert _rel(bh(torch.as_tensor(B)).numpy(), np.asarray(jbh(
        jnp.asarray(B)))) <= TOL


def test_source_tables_three_phase():
    dt = torch.float64
    H, J = pde.source_tables(torch.tensor(100.0, dtype=dt),
                             torch.tensor(0.3, dtype=dt))
    H, J = H.numpy(), J.numpy()
    # magnets: alternating polarity, uniform magnitude
    mags = H[T.MAGNET_FIRST : T.MAGNET_LAST + 1]
    norms = np.linalg.norm(mags, axis=1)
    np.testing.assert_allclose(norms, norms[0], rtol=1e-12)
    # windings: pole-alternating signs cancel over the full winding set
    w = J[T.WINDING_FIRST : T.WINDING_LAST + 1]
    np.testing.assert_allclose(w.sum(), 0.0, atol=1e-9 * 100)
    assert np.abs(w).max() > 0
    jH, jJ = jpde.source_tables(jnp.asarray(100.0), jnp.asarray(0.3))
    assert _rel(H, jH) <= TOL and _rel(J, jJ) <= TOL


def test_source_tables_differentiable_in_iq():
    iq = torch.tensor(1e5, dtype=torch.float64, requires_grad=True)
    _, J = pde.source_tables(iq, torch.tensor(0.0, dtype=torch.float64))
    (g,) = torch.autograd.grad(J.square().sum(), iq)
    J = J.detach()
    # J is linear in iq (up to EPS): d/diq sum J^2 = 2 sum J^2 / iq
    np.testing.assert_allclose(float(g), 2 * float(J.square().sum()) / 1e5,
                               rtol=1e-10)
