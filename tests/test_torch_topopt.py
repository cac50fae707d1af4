"""Parity of the port's W4 SIMP topology optimization
(models/topopt.py, graph/filters.py) and its quad facet terms with the
JAX package, f64, CPU:

* DensityFilter: the same weights, and the filtered field to 1e-14;
* facet terms on quads (fea/assemble.py): exterior- and interior-facet
  scalars and residual vectors to 1e-13;
* build_topopt_model(12, 6) through Simulator.run and
  objective_gradient on the dense path: compliance 1e-12, gradient
  1e-10 relative;
* RAMP interpolation.
"""

import numpy as np
import jax.numpy as jnp
import torch

from femo_tpu.fea import (
    FormDef as JFormDef, Function as JFunction, FunctionSpace as JSpace,
    create_rectangle_mesh as jrect, dS as jdS, dot as jdot, ds as jds,
    grad as jgrad)
from femo_tpu.fea.assemble import compile_form as jcompile
from femo_tpu.fea.forms import avg as javg, jump as jjump
from femo_tpu.graph.filters import DensityFilter as JDensityFilter
from femo_tpu.graph.simulator import Simulator as JSimulator
from femo_tpu.models.topopt import build_topopt_model as jbuild_model

from femo_tpu_torch.fea.assemble import compile_form
from femo_tpu_torch.fea.forms import FormDef, avg, dS, dot, ds, grad, jump
from femo_tpu_torch.fea.space import Function, FunctionSpace
from femo_tpu_torch.graph.filters import DensityFilter
from femo_tpu_torch.graph.simulator import Simulator
from femo_tpu_torch.mesh.generators import create_rectangle_mesh
from femo_tpu_torch.models.topopt import (
    build_topopt_model, stiffness_interpolation)

torch.set_num_threads(1)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


def test_filter_matches_jax():
    rng = np.random.default_rng(0)
    pts = rng.uniform(size=(100, 2))
    filt = DensityFilter(pts, radius=0.2, device="cpu")
    jfilt = JDensityFilter(pts, radius=0.2)
    np.testing.assert_array_equal(filt.weights.numpy(),
                                  np.asarray(jfilt.weights))
    x = rng.uniform(size=100)
    y = filt(torch.as_tensor(x)).numpy()
    assert np.abs(y - np.asarray(jfilt(jnp.asarray(x)))).max() <= 1e-14
    np.testing.assert_allclose(filt(torch.ones(100, dtype=torch.float64))
                               .numpy(), 1.0, atol=1e-14)
    assert y.var() < x.var()


def _quad_forms(mod):
    J = mod == "jax"
    mesh = (jrect if J else create_rectangle_mesh)(4, 3, 0.0, 0.0, 2.0, 1.5,
                                                   cell_type="quad")
    mesh.mark_boundary_facets(7, lambda x: np.isclose(x[0], 2.0))
    Sp, Fn, FD = ((JSpace, JFunction, JFormDef) if J else
                  (FunctionSpace, Function, FormDef))
    d_, g_, ds_, dS_, avg_, jump_ = (
        (jdot, jgrad, jds, jdS, javg, jjump) if J else
        (dot, grad, ds, dS, avg, jump))
    V = Sp(mesh, ("CG", 1), ncomp=2, **({} if J else {"device": "cpu"}))
    u = Fn(V, "u").interpolate(
        lambda x: np.stack([x[0] ** 2 + x[1], np.sin(x[0]) * x[1]]))
    ext = lambda w, g: (d_(w.u, g.n) * g.x[1] + 0.3 * g.h  # noqa: E731
                        * d_(d_(g_(w.u), g.n), w.v))
    res_ext = FD([ds_(ext, tag=7), ds_(lambda w, g: d_(w.u, w.v) * g.x[0])],
                 coeffs=[u], test=V)
    res_int = FD([dS_(lambda w, g: d_(jump_(w.u), jump_(w.v))
                      + d_(avg_(w.u), g.n) * d_(avg_(w.v), g.n))],
                 coeffs=[u], test=V)
    scal = FD([ds_(lambda w, g: d_(w.u, g.n) ** 2 * g.x[1]),
               dS_(lambda w, g: d_(avg_(w.u), g.n) ** 2)], coeffs=[u])
    return res_ext, res_int, scal


def test_quad_facet_terms_match_jax():
    forms, jforms = _quad_forms("torch"), _quad_forms("jax")
    for f, jf in zip(forms[:2], jforms[:2]):
        v = compile_form(f).vector(f.values()).numpy()
        jv = np.asarray(jcompile(jf).vector_jit()(jf.values()))
        assert np.abs(v - jv).max() <= 1e-13 * np.abs(jv).max()
    s = float(compile_form(forms[2]).scalar(forms[2].values()))
    js = float(jcompile(jforms[2]).scalar_jit()(jforms[2].values()))
    assert abs(s - js) <= 1e-13 * abs(js)


def test_compliance_and_gradient_match_jax():
    model, fea, d = build_topopt_model(12, 6, device="cpu")
    jmodel, jfea, jd = jbuild_model(12, 6)
    x = 0.4 + 0.2 * np.random.default_rng(3).uniform(-1, 1, d["W"].n_dofs)
    out = []
    for M, Sim in ((model, Simulator), (jmodel, JSimulator)):
        sim = Sim(M)
        sim["density_unfiltered"] = x
        o = sim.run()
        val, grads, _ = sim.objective_gradient(
            "compliance", ["density_unfiltered"])
        out.append((float(o["avg_density"]), float(val),
                    np.asarray(grads["density_unfiltered"])))
    (avg_t, c, g), (avg_j, jc, jg) = out
    assert fea.linear_solver.resolve_method(d["V"].n_dofs) == "dense"
    assert abs(avg_t - avg_j) <= 1e-14 and abs(c - jc) <= 1e-12 * abs(jc)
    assert _rel(g, jg) <= 1e-10


def test_ramp_interpolation():
    r = stiffness_interpolation(torch.tensor([0.0, 0.5, 1.0],
                                             dtype=torch.float64), "RAMP")
    np.testing.assert_allclose(r.numpy(), [0.0, 0.5 / 5.0, 1.0])
