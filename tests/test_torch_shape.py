"""Parity of the port's shape derivatives (fea/shape.py, workload W10)
with the JAX package's `shape_gradient` (its `jax.grad` of
`shape_functional`, jitted here), f64, CPU: the three functionals
of tests/test_shape_derivative.py (the volume, the Dirichlet energy with
a `g.h`-weighted boundary term, and an interior-facet term) to 1e-12
relative, and a central finite difference of the port's own
`shape_functional`.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from femo_tpu.fea import (
    FormDef as JFormDef, Function as JFunction, FunctionSpace as JSpace,
    create_unit_square_mesh as jsquare, dS as jdS, dot as jdot, ds as jds,
    dx as jdx, grad as jgrad)
from femo_tpu.fea.forms import avg as javg
from femo_tpu.fea.shape import shape_functional as jshape_functional

from femo_tpu_torch.fea.forms import FormDef, avg, dS, dot, ds, dx, grad
from femo_tpu_torch.fea.shape import shape_functional, shape_gradient
from femo_tpu_torch.fea.space import Function, FunctionSpace
from femo_tpu_torch.mesh.generators import create_unit_square_mesh

torch.set_num_threads(1)


def _forms(case, mod):
    """(form, mesh) of one functional in one package."""
    J = mod == "jax"
    Sp, Fn, FD = ((JSpace, JFunction, JFormDef) if J else
                  (FunctionSpace, Function, FormDef))
    d_, g_, dx_, ds_, dS_, avg_ = (
        (jdot, jgrad, jdx, jds, jdS, javg) if J else
        (dot, grad, dx, ds, dS, avg))
    kw = {} if J else {"device": "cpu"}
    mesh = (jsquare if J else create_unit_square_mesh)(
        4 if case == "volume" else 3)
    V = Sp(mesh, ("CG", 1), **kw)
    if case == "volume":
        one = Fn(V, "one")
        one.set(1.0)
        return FD([dx_(lambda w, g: w.one * 1.0)], coeffs=[one]), mesh
    if case == "energy":
        mesh.mark_boundary_facets(1)
        u = Fn(V, "u").interpolate(lambda x: x[0] ** 2 + 0.5 * x[1])
        return FD([dx_(lambda w, g: d_(g_(w.u), g_(w.u))),
                   ds_(lambda w, g: 0.1 * w.u * g.h, tag=1)],
                  coeffs=[u]), mesh
    u = Fn(V, "u").interpolate(lambda x: x[0] ** 2 - 0.3 * x[1])
    return FD([dS_(lambda w, g: (avg_(w.u) + 0.2 * g.n[0]) ** 2)],
              coeffs=[u]), mesh


@pytest.mark.parametrize("case", ["volume", "energy", "interior_facet"])
def test_shape_gradient_matches_jax(case):
    form, mesh = _forms(case, "torch")
    jform, jmesh = _forms(case, "jax")
    g = shape_gradient(form).numpy()
    # the JAX package's shape_gradient, jitted (eager it dispatches op by
    # op for seconds)
    jg = np.asarray(jax.jit(jax.grad(jshape_functional(jform)))(
        jnp.asarray(jmesh.coords), jform.values()))
    assert g.shape == (mesh.n_nodes, 2)
    assert np.linalg.norm(g - jg) <= 1e-12 * np.linalg.norm(jg)


def test_shape_gradient_finite_difference():
    """Central differences of the energy functional (cell + ds terms) in
    seeded node directions."""
    form, mesh = _forms("energy", "torch")
    g = shape_gradient(form).numpy()
    J = shape_functional(form)
    vals = form.values()
    coords = torch.as_tensor(mesh.coords, dtype=torch.float64)
    rng = np.random.default_rng(1)
    h = 1e-6
    for _ in range(4):
        i, d = rng.integers(mesh.n_nodes), rng.integers(2)
        cp, cm = coords.clone(), coords.clone()
        cp[i, d] += h
        cm[i, d] -= h
        fd = (float(J(cp, vals)) - float(J(cm, vals))) / (2 * h)
        np.testing.assert_allclose(g[i, d], fd, rtol=2e-5, atol=1e-8)
