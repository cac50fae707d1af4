"""W7 parity: the port's vortex lattice method (femo_tpu_torch/models/
vlm.py) against the JAX package's, live (the system is small), on CPU
tensors in f64.

Seeded lattices (numpy) go through both packages: the circulations,
forces, force points, collocation points, normals and total force, CL and
CDi agree to 1e-12 (relative); the gradient of the lift and a
vector-Jacobian product of the forces with respect to the lattice nodes
(the coupled FSI adjoint's products through `VLM.solve`) to 1e-8, 10x
the JAX package's own spread (GRAD_TOL).  The
lifting-line check of tests/test_fsi.py::test_vlm_lifting_line holds for
the port on its own.
"""

import numpy as np
import pytest
import torch

import jax

jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp  # noqa: E402

from femo_tpu.models import vlm as jvlm  # noqa: E402

from femo_tpu_torch.models.vlm import (  # noqa: E402
    VLM, flat_wing_lattice, flat_wing_lattice_np)

torch.set_num_threads(1)

V_INF = np.array([20.0, 0.0, 2.0])
# Each force point lies on its own bound vortex, where r1 x r2 vanishes
# and EPS regularizes the Biot-Savart law: that self term is rounding
# noise amplified by 1/EPS.  The port and the JAX package's eager ops
# round alike (the forward values agree to 1e-12), its jitted program
# otherwise: there the forces move by 6e-11-7e-11, and the node
# derivatives by 6e-10-8e-10 (also under a 1e-15 relative change of the
# nodes).  The gradients are compared with the jitted JAX program (one
# compile, where its eager ops compile one by one) at 10x that spread.
GRAD_TOL = 1e-8


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _lattice(seed, nc=2, ns=6):
    """A flat lattice at incidence with a seeded perturbation of every
    node (camber, twist, a swept tip)."""
    lat = flat_wing_lattice_np(6.0, 1.0, nc, ns, alpha_deg=3.0)
    rng = np.random.default_rng(seed)
    return lat + 0.02 * rng.standard_normal(lat.shape)


@pytest.mark.parametrize("seed", [0, 1])
def test_solve_matches_jax(seed):
    lat = _lattice(seed)
    out = VLM(2, 6, rho=1.225).solve(torch.as_tensor(lat), V_INF)
    jout = jvlm.VLM(2, 6, rho=1.225).solve(jnp.asarray(lat),
                                           jnp.asarray(V_INF))
    for k in ("gamma", "forces", "points", "total", "colloc", "normals"):
        assert _rel(out[k].numpy(), jout[k]) <= 1e-12, k
    np.testing.assert_allclose(out["points"].numpy(),
                               VLM.bound_midpoints_np(lat), rtol=0,
                               atol=1e-15)


def test_coefficients_match_jax():
    lat = _lattice(2)
    CL, CDi, _ = VLM(2, 6).coefficients(torch.as_tensor(lat), V_INF)
    jCL, jCDi, _ = jvlm.VLM(2, 6).coefficients(jnp.asarray(lat),
                                               jnp.asarray(V_INF))
    assert abs(float(CL) - float(jCL)) <= 1e-12 * abs(float(jCL))
    assert abs(float(CDi) - float(jCDi)) <= 1e-12 * abs(float(jCDi))


def test_geometry_gradient_matches_jax():
    """d(lift)/d(nodes) and a VJP of the forces in the nodes."""
    lat = _lattice(3)
    rng = np.random.default_rng(4)
    cot = rng.standard_normal((2 * 6, 3))
    vlm, jv = VLM(2, 6), jvlm.VLM(2, 6)

    nodes = torch.as_tensor(lat).requires_grad_(True)
    out = vlm.solve(nodes, V_INF)
    (g_lift,) = torch.autograd.grad(out["total"][2], nodes,
                                    retain_graph=True)
    (g_vjp,) = torch.autograd.grad(out["forces"], nodes,
                                   torch.as_tensor(cot))
    vi = jnp.asarray(V_INF)

    @jax.jit
    def jgrads(n, c):
        g = jax.grad(lambda n: jv.solve(n, vi)["total"][2])(n)
        _, vjp = jax.vjp(lambda n: jv.solve(n, vi)["forces"], n)
        return g, vjp(c)[0]

    j_lift, j_vjp = jgrads(jnp.asarray(lat), jnp.asarray(cot))
    assert _rel(g_lift.numpy(), j_lift) <= GRAD_TOL
    assert _rel(g_vjp.numpy(), j_vjp) <= GRAD_TOL


def test_vlm_lifting_line():
    """Rectangular AR=10 wing at 5 deg against the lifting-line estimate
    (tests/test_fsi.py::test_vlm_lifting_line)."""
    span, chord, alpha = 10.0, 1.0, 5.0
    nodes = flat_wing_lattice(span, chord, 4, 16, alpha_deg=alpha,
                              device="cpu")
    CL, CDi, out = VLM(4, 16).coefficients(nodes, [1.0, 0.0, 0.0])
    a = np.deg2rad(alpha)
    CL_llt = 2 * np.pi * a / (1 + 2 / (span / chord))
    assert abs(float(CL) - CL_llt) / CL_llt < 0.08
    # induced drag close to the elliptic estimate CL^2 / (pi AR)
    cdi_est = float(CL) ** 2 / (np.pi * span / chord)
    assert 0.5 * cdi_est < float(CDi) < 1.5 * cdi_est
    assert abs(float(out["total"][1])) <= 1e-10


def test_lattice_matches_jax_and_defaults_to_the_card():
    lat = flat_wing_lattice(4.0, 1.0, 3, 8, alpha_deg=2.0, device="cpu")
    np.testing.assert_array_equal(
        lat.numpy(), np.asarray(jvlm.flat_wing_lattice(4.0, 1.0, 3, 8,
                                                       alpha_deg=2.0)))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            flat_wing_lattice(4.0, 1.0, 3, 8)
