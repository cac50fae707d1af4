"""Facet terms of 3D cells and the 3D and annulus mesh generators
(femo_tpu_torch/fea/assemble.py, femo_tpu_torch/mesh/generators.py)
against the JAX package, f64, CPU.

* The generators: the coordinates, cells and cell tags of the box (tets
  and hexes), the unit cube and the annulus equal the JAX package's bit for
  bit.
* The cases of tests/test_assembly.py for 3D facets, in the port: the
  jump of a continuous linear interpolant over the interior facets of the
  tet unit cube and of a distorted hex mesh (whose bilinear facets exercise
  every dihedral symmetry) vanishes; avg() of one integrates the interior
  facet area; on the distorted hexes the outward normals close the
  surface, int c.n ds = 0 and int x.n ds = 3 Vol.
* Seeded fields (numpy) through both packages: an interior-facet residual
  (jumps, each side's value and gradient, the normal, g.h) and its
  Jacobian, and an exterior-facet
  scalar reading the normal, on tets and on the distorted hexes, within
  1e-12 relative (the same arithmetic, summed in another order).
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from femo_tpu.fea import (
    FormDef as JFormDef, Function as JFunction, FunctionSpace as JSpace)
from femo_tpu.fea import forms as jforms
from femo_tpu.fea.assemble import ElementMatrix, MatBlock, compile_form as \
    jcompile
from femo_tpu.mesh import generators as jgen
from femo_tpu.mesh.mesh import Mesh as JMesh

from femo_tpu_torch.fea import forms
from femo_tpu_torch.fea.assemble import assemble_scalar, compile_form
from femo_tpu_torch.fea.forms import FormDef
from femo_tpu_torch.fea.space import Function, FunctionSpace
from femo_tpu_torch.mesh import generators as gen
from femo_tpu_torch.mesh.mesh import Mesh

torch.set_num_threads(1)

TOL = 1e-12


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


@pytest.mark.parametrize("name, args, kw", [
    ("create_box_mesh", (2, 3, 2), dict(x1=2.0, z0=-0.5, cell_type="tet")),
    ("create_box_mesh", (3, 2, 2), dict(y1=0.5, cell_type="hex")),
    ("create_unit_cube_mesh", (3,), {}),
    ("create_unit_cube_mesh", (2,), dict(cell_type="hex")),
    ("create_annulus_mesh", (6, 16, 0.5, 2.0),
     dict(radial_breaks=[0.9, 1.4], ring_tags=[1, 2, 3])),
    ("create_annulus_mesh", (4, 12, 1.0, 2.0), dict(cell_type="quad")),
], ids=["box-tet", "box-hex", "cube-tet", "cube-hex", "annulus-tagged",
        "annulus-quad"])
def test_generators_match_jax(name, args, kw):
    jm, m = getattr(jgen, name)(*args, **kw), getattr(gen, name)(*args, **kw)
    assert m.cell_type == jm.cell_type
    np.testing.assert_array_equal(m.coords, np.asarray(jm.coords))
    np.testing.assert_array_equal(m.cells, np.asarray(jm.cells))
    if jm.cell_tags is None:
        assert m.cell_tags is None
    else:
        np.testing.assert_array_equal(m.cell_tags, np.asarray(jm.cell_tags))


def _distorted_hex(Mesh_, cube, amp=0.08):
    """The unit-cube hex mesh with interior nodes moved by a smooth bump,
    so that its facets are non-parallelogram bilinear surfaces (the JAX
    package's tests/test_assembly.py::_distorted_hex_mesh)."""
    c = np.asarray(cube.coords).copy()
    s = np.sin(np.pi * c)
    bump = s[:, 0] * s[:, 1] * s[:, 2]
    c[:, 0] += amp * bump
    c[:, 1] -= 0.7 * amp * bump
    c[:, 2] += 0.4 * amp * bump
    return Mesh_(c, np.asarray(cube.cells), "hex")


def _mesh(kind, n):
    if kind == "tet":
        return gen.create_unit_cube_mesh(n, cell_type="tet")
    return _distorted_hex(Mesh, gen.create_unit_cube_mesh(n, cell_type="hex"))


def _linear(V):
    return Function(V, "u").interpolate(
        lambda x: 1.7 * x[0] - 0.3 * x[1] + 0.9 * x[2])


@pytest.mark.parametrize("kind, n", [("tet", 2), ("hex", 3)])
def test_jump_of_continuous_field_vanishes(kind, n):
    mesh = _mesh(kind, n)
    V = FunctionSpace(mesh, ("CG", 1), device="cpu")
    u = _linear(V)
    form = FormDef([forms.dS(lambda w, g: forms.jump(w.u) ** 2)], coeffs=[u])
    assert abs(float(assemble_scalar(form))) <= 1e-22


def _area_form(mesh):
    V = FunctionSpace(mesh, ("CG", 1), device="cpu")
    one = Function(V, "one")
    one.set(1.0)
    return FormDef([forms.dS(lambda w, g: 0.5 * (w.one("+").val
                                                 + w.one("-").val))],
                   coeffs=[one])


def test_interior_facet_area():
    """avg(1) over the interior facets: the direct sum of the tet cube's
    interior triangle areas, and 3 for the 2 x 2 x 2 hex cube."""
    tet = gen.create_unit_cube_mesh(2, cell_type="tet")
    tot = sum(0.5 * np.linalg.norm(np.cross(p[1] - p[0], p[2] - p[0]))
              for p in tet.coords[tet.facets[tet.interior_facets]])
    assert _rel(float(assemble_scalar(_area_form(tet))), tot) <= TOL
    hexes = gen.create_unit_cube_mesh(2, cell_type="hex")
    assert _rel(float(assemble_scalar(_area_form(hexes))), 3.0) <= TOL


def test_divergence_theorem_distorted_hex():
    mesh = _mesh("hex", 2)
    V = FunctionSpace(mesh, ("CG", 1), device="cpu")
    one = Function(V, "one")
    one.set(1.0)
    c = FormDef([forms.ds(lambda w, g: w.one * (
        0.3 * g.n[0] - 1.1 * g.n[1] + 0.7 * g.n[2]), qdeg=4)], coeffs=[one])
    assert abs(float(assemble_scalar(c))) <= 1e-13
    x = FormDef([forms.ds(lambda w, g: w.one * forms.dot(g.x, g.n),
                          qdeg=4)], coeffs=[one])
    vol = FormDef([forms.dx(lambda w, g: w.one * 1.0, qdeg=4)], coeffs=[one])
    assert _rel(float(assemble_scalar(x)),
                3.0 * float(assemble_scalar(vol))) <= TOL


def _forms(f, FS, Fn, FD, mesh, **kw):
    """An interior-facet residual of one package (nonlinear, so its
    Jacobian depends on the state)."""
    V = FS(mesh, ("CG", 1), **kw)
    u = Fn(V, "u")

    def res(w, g):
        total = f.jump(w.u) * f.jump(w.v) / g.h
        for side, sgn in (("+", 1.0), ("-", -1.0)):
            uh, vv = w.u(side), w.v(side)
            total = total + sgn * (uh.val ** 2 * f.dot(vv.grad, g.n)
                                   + f.dot(uh.grad, g.n) * vv.val)
        return total

    return dict(res=FD([f.dS(res)], coeffs=[u], test=V), n=V.n_dofs)


@pytest.fixture(scope="module", params=["tet", "hex"])
def pair(request):
    tm = _mesh(request.param, 2)
    jm = JMesh(tm.coords.copy(), tm.cells.copy(), tm.cell_type)
    jf = _forms(jforms, JSpace, JFunction, JFormDef, jm)
    tf = _forms(forms, FunctionSpace, Function, FormDef, tm, device="cpu")
    u = np.random.default_rng(5).standard_normal(jf["n"])
    return jf, tf, u


def test_facet_forms_match_jax(pair):
    jf, tf, u = pair
    jv, tv = {"u": jnp.asarray(u)}, {"u": torch.as_tensor(u)}
    jr, tr = jcompile(jf["res"]), compile_form(tf["res"])
    want = np.asarray(jr.vector_jit()(jv))
    assert np.abs(want).max() > 0
    assert _rel(tr.vector(tv).numpy(), want) <= TOL
    blocks = [MatBlock(*b) for b in jr.matrix_blocks_jit("u")(jv)]
    want = np.asarray(ElementMatrix(blocks, jf["n"], jf["n"]).to_dense())
    assert _rel(tr.matrix(tv, "u").to_dense().numpy(), want) <= TOL
