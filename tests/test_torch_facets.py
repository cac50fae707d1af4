"""Exterior-facet (ds) assembly, the motor's Nitsche EM boundary form and
output forms, and L2 projection (femo_tpu_torch/fea/assemble.py, fea/
project.py, models/motor/pde.py) against the JAX package, f64, CPU.

Seeded fields (numpy) go through both packages: on the unit square 6 the
ds scalar, residual vector and element matrix of integrands that read
g.n, g.h and g.ctag, for a scalar and a 2-vector CG1 space; on the
refine-0.5 motor the Nitsche EM boundary residual and Jacobian (alone and
added to the EM residual, facet tags 1000/1001, the boundary cell's
permeability by g.ctag), the area, torque and |B| forms, and the lumped
and consistent projections.  All agree to 1e-12 relative (the same
arithmetic, summed in another order).
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from femo_tpu.fea import (
    FormDef as JFormDef, Function as JFunction, FunctionSpace as JSpace,
    create_unit_square_mesh as jsquare)
from femo_tpu.fea import forms as jforms
from femo_tpu.fea.assemble import (
    ElementMatrix, MatBlock, compile_form as jcompile)
from femo_tpu.fea.forms import GlobalCoefficient as JGlobal
from femo_tpu.fea.project import (
    lumped_mass as jlumped_mass, project_form as jproject_form)
from femo_tpu.models.motor import pde as jpde
from femo_tpu.models.motor.mesh import create_motor_mesh as jmotor_mesh
from femo_tpu.models.motor.permeability import PiecewiseBHCurve as JBH

from femo_tpu_torch.convert import mesh_from_jax
from femo_tpu_torch.fea import forms
from femo_tpu_torch.fea.assemble import compile_form
from femo_tpu_torch.fea.forms import FormDef, GlobalCoefficient
from femo_tpu_torch.fea.project import lumped_mass, project_form
from femo_tpu_torch.fea.space import Function, FunctionSpace
from femo_tpu_torch.models.motor import pde
from femo_tpu_torch.models.motor.permeability import PiecewiseBHCurve

torch.set_num_threads(1)

TOL = 1e-12


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


def _square_forms(f, FS, Fn, FD, mesh, **kw):
    """ds forms on the unit square in the form language `f` of one
    package: a scalar, a residual on a scalar space and one on a 2-vector
    space (both nonlinear, so their Jacobians depend on the state)."""
    V = FS(mesh, ("CG", 1), **kw)
    Q = FS(mesh, ("CG", 1), ncomp=2, **kw)
    u, q = Fn(V, "u"), Fn(Q, "q")

    def scalar_res(w, g):
        return (w.u**2 * w.v / g.h + f.dot(f.grad(w.u), g.n) * w.v
                + (1.0 + g.ctag) * w.u * f.dot(f.grad(w.v), g.n))

    def vector_res(w, g):
        return f.dot(w.q.val, g.n) ** 2 * f.dot(w.v.val, g.n) \
            + g.h * f.dot(w.q.val, w.v.val)

    return dict(
        scalar=FD([f.ds(lambda w, g: w.u**3 * g.h
                        + f.dot(f.grad(w.u), g.n))], coeffs=[u]),
        res_u=FD([f.ds(scalar_res)], coeffs=[u], test=V),
        res_q=FD([f.ds(vector_res)], coeffs=[q], test=Q),
        n_u=V.n_dofs, n_q=Q.n_dofs)


@pytest.fixture(scope="module")
def square():
    jm = jsquare(6)
    jf = _square_forms(jforms, JSpace, JFunction, JFormDef, jm)
    tf = _square_forms(forms, FunctionSpace, Function, FormDef,
                       mesh_from_jax(jm), device="cpu")
    rng = np.random.default_rng(2)
    vals = {"u": rng.standard_normal(jf["n_u"]),
            "q": rng.standard_normal(jf["n_q"])}
    return jf, tf, vals


def _pick(cf, vals, lib):
    if lib == "jax":
        return {k: jnp.asarray(vals[k]) for k in cf.all_names}
    return {k: torch.as_tensor(np.asarray(vals[k]), dtype=torch.float64)
            for k in cf.all_names}


def _assembled(jform, tform, vals, kind, wrt=None):
    jcf, tcf = jcompile(jform), compile_form(tform)
    jv, tv = _pick(jcf, vals, "jax"), _pick(tcf, vals, "torch")
    if kind == "scalar":
        return float(tcf.scalar(tv)), float(jcf.scalar_jit()(jv))
    if kind == "vector":
        return tcf.vector(tv).numpy(), np.asarray(jcf.vector_jit()(jv))
    blocks = [MatBlock(*b) for b in jcf.matrix_blocks_jit(wrt)(jv)]
    n = jform.test.n_dofs
    return (tcf.matrix(tv, wrt).to_dense().numpy(),
            np.asarray(ElementMatrix(blocks, n, jform.coeffs[wrt]
                                     .space.n_dofs).to_dense()))


@pytest.mark.parametrize("name, kind, wrt", [
    ("scalar", "scalar", None),
    ("res_u", "vector", None), ("res_u", "matrix", "u"),
    ("res_q", "vector", None), ("res_q", "matrix", "q"),
], ids=["scalar", "vector-scalar-space", "matrix-scalar-space",
        "vector-vector-space", "matrix-vector-space"])
def test_ds_assembly_matches_jax(square, name, kind, wrt):
    jf, tf, vals = square
    got, want = _assembled(jf[name], tf[name], vals, kind, wrt)
    assert np.abs(want).max() > 0
    assert _rel(got, want) <= TOL


def _motor_forms(FS, Fn, GC, mod, BH, mesh, tables, **kw):
    Vmm = FS(mesh, ("CG", 1), ncomp=2, **kw)
    Vem = FS(mesh, ("CG", 1), **kw)
    uhat, A_z = Fn(Vmm, "uhat"), Fn(Vem, "A_z")
    Ht, Jt = GC("Htable", tables[0], **kw), GC("Jtable", tables[1], **kw)
    bh = BH()
    nitsche = mod.em_nitsche_boundary_form(A_z, uhat, bh)
    magnets = tuple(range(3, 15))
    return dict(
        nitsche=nitsche,
        em_weak=mod.em_residual_form(A_z, uhat, Ht, Jt, bh)
        + mod.em_nitsche_boundary_form(A_z, uhat, bh),
        area=mod.area_form(uhat, magnets),
        torque=mod.torque_form(A_z, uhat),
        b_field=mod.b_field_output_form(A_z, uhat, FS(mesh, ("CG", 1),
                                                      **kw)),
        n_mm=Vmm.n_dofs, n_em=Vem.n_dofs)


@pytest.fixture(scope="module")
def motor():
    jm = jmotor_mesh(0.5)
    Ht, Jt = jpde.source_tables(jnp.asarray(1e5), jnp.asarray(0.0))
    tables = (np.array(Ht), np.array(Jt))
    jf = _motor_forms(JSpace, JFunction, JGlobal, jpde, JBH, jm, tables)
    tf = _motor_forms(FunctionSpace, Function, GlobalCoefficient, pde,
                      PiecewiseBHCurve, mesh_from_jax(jm), tables,
                      device="cpu")
    rng = np.random.default_rng(13)
    vals = {"uhat": 2e-5 * rng.standard_normal(jf["n_mm"]),
            "A_z": 5e-3 * rng.standard_normal(jf["n_em"]),
            "Htable": tables[0], "Jtable": tables[1]}
    return jf, tf, vals


@pytest.mark.parametrize("name, kind, wrt", [
    ("nitsche", "vector", None), ("nitsche", "matrix", "A_z"),
    ("nitsche", "matrix", "uhat"), ("em_weak", "vector", None),
    ("em_weak", "matrix", "A_z"), ("area", "scalar", None),
    ("torque", "scalar", None), ("b_field", "vector", None),
], ids=["nitsche-vector", "nitsche-jacobian", "nitsche-shape-jacobian",
        "em-weak-vector", "em-weak-jacobian", "area", "torque", "b-field"])
def test_motor_boundary_and_output_forms_match_jax(motor, name, kind, wrt):
    jf, tf, vals = motor
    got, want = _assembled(jf[name], tf[name], vals, kind, wrt)
    assert np.abs(want).max() > 0
    assert _rel(got, want) <= TOL


def test_nitsche_term_covers_the_tagged_rims(motor):
    """The Nitsche term integrates over the exterior facets tagged 1000 and
    1001 only, with the boundary cell's tag as g.ctag."""
    _, tf, _ = motor
    (term,) = compile_form(tf["nitsche"]).terms
    mesh = tf["nitsche"].test.mesh
    ext = mesh.exterior_facets
    tagged = ext[np.isin(mesh.facet_tags[ext], (1000, 1001))]
    assert term.domain == "exterior_facet" and term.n_ent == len(tagged) > 0
    np.testing.assert_array_equal(term.ctag0.numpy(), mesh.cell_tags[
        mesh.facet_cells[tagged, 0]])


def test_projection_matches_jax(motor):
    """The lumped-mass projection of the |B| output and the lumped masses
    of scalar and vector spaces (TOL)."""
    jf, tf, vals = motor
    jV, V = jf["b_field"].test, tf["b_field"].test
    jcf, tcf = jcompile(jf["b_field"]), compile_form(tf["b_field"])
    want = np.asarray(jproject_form(jf["b_field"], jV,
                                    _pick(jcf, vals, "jax")))
    got = project_form(tf["b_field"], V, _pick(tcf, vals, "torch"))
    assert _rel(got.numpy(), want) <= TOL
    for ncomp in (1, 2):
        jW = JSpace(jV.mesh, ("CG", 1), ncomp=ncomp)
        W = FunctionSpace(V.mesh, ("CG", 1), ncomp=ncomp, device="cpu")
        assert _rel(lumped_mass(W).numpy(), jlumped_mass(jW)) <= TOL
