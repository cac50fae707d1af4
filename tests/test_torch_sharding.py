"""Mode a of the port's distribution (femo_tpu_torch/parallel/sharding.py)
on 4 gloo CPU ranks, against the JAX package.

One pool of ranks per file: the module fixture starts 4 ranks once
(`launch.spawn`, torch on one thread each, a 180 s limit after which
every rank is killed and the fixture fails) and runs every rank-side
check of tests/torch_dist_ranks.py::sharding_checks in one pass; each
test asserts one entry.

* The sharded residual, functional and dense Jacobian at nel=8 (the
  checks of tests/test_sharding.py) against the JAX package's unsharded
  assembly, in this process: 1e-12 / 1e-13 relative / 1e-12, as there.
  The forward and reverse derivatives through the collectives against
  the one-rank assembly: 1e-13.
* The Poisson (both solvers), motor and shell steps over the 4 ranks
  against the JAX package's values over 4 devices
  (oracles/distributed_oracle.npz, oracles/motor_oracle.npz's r05_lu):
  Poisson 1e-10 / 1e-8, the motor 1e-10 / 1e-8 (as
  tests/test_torch_motor.py), the shell 1e-9 / 1e-8 (as
  tests/test_sharding.py: its E = 7e10 stiffness leaves ~1e-10 of
  reduction-order spread in f64).  The gradients from 4 ranks equal the
  one-rank step's to 1e-9 relative: a gradient scaled by the rank count
  or left partial misses by orders of magnitude; the one-rank steps run
  on ranks 0-2 after the last collective.
"""

import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from femo_tpu.fea import (
    FormDef as JFormDef, Function as JFunction,
    FunctionSpace as JFunctionSpace, compile_form as jcompile_form,
    create_unit_square_mesh as jmesh, dot as jdot, dx as jdx,
    grad as jgrad)

from femo_tpu_torch.parallel.launch import spawn

import torch_dist_ranks as R

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORACLE = np.load(os.path.join(REPO, "oracles", "distributed_oracle.npz"))
MOTOR_ORACLE = np.load(os.path.join(REPO, "oracles", "motor_oracle.npz"))


@pytest.fixture(scope="module")
def ranks():
    return spawn(R.sharding_checks, R.NRANKS, device="cpu", timeout=180)


@pytest.fixture(scope="module")
def jax_forms():
    V = JFunctionSpace(jmesh(R.SHARD_NEL), ("CG", 1))
    W = JFunctionSpace(V.mesh, ("DG", 0))
    u, f = JFunction(V, "u"), JFunction(W, "f")
    res = JFormDef([jdx(lambda w, g: jdot(jgrad(w.u), jgrad(w.v))
                        - w.f * w.v)], coeffs=[u, f], test=V)
    J = JFormDef([jdx(lambda w, g: w.u ** 2 + 0.5 * w.f ** 2)],
                 coeffs=[u, f])
    vals = {s: {"u": jnp.asarray(a), "f": jnp.asarray(b)}
            for s, (a, b) in R.shard_values(V.n_dofs, W.n_dofs).items()}
    return jcompile_form(res), jcompile_form(J), vals


def _rel(a, b):
    return np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(b)


def _same_on_every_rank(ranks, key):
    """Rank 0's entry, after checking that every rank has its bits (the
    replicated results of an all-reduce)."""
    first = ranks[0][key]
    parts = first if isinstance(first, tuple) else (first,)
    for r in ranks[1:]:
        others = r[key] if isinstance(first, tuple) else (r[key],)
        for a, b in zip(parts, others):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    return first


def test_rank_meshes(ranks):
    assert [r["mesh"] for r in ranks] == [(k, R.NRANKS, "cpu")
                                          for k in range(R.NRANKS)]
    assert all(r["device_mesh"] for r in ranks)


def test_sharded_residual_matches_jax(ranks, jax_forms):
    rcf, _, vals = jax_forms
    r = _same_on_every_rank(ranks, "residual")
    np.testing.assert_allclose(r, np.asarray(rcf.vector_jit()(vals[0])),
                               atol=1e-12)


def test_sharded_scalar_matches_jax(ranks, jax_forms):
    _, jcf, vals = jax_forms
    s = _same_on_every_rank(ranks, "scalar")
    np.testing.assert_allclose(s, float(jcf.scalar_jit()(vals[1])),
                               rtol=1e-13)


def test_sharded_matrix_dense_matches_jax(ranks, jax_forms):
    """Against the JAX package's dense Jacobian of its residual, by
    jax.jacfwd (the residual is linear in u: the same matrix as
    `matrix(...).to_dense()`, whose element kernels take seconds more to
    compile)."""
    rcf, _, vals = jax_forms
    A = _same_on_every_rank(ranks, "matrix")
    vec = rcf.vector_jit()
    J = jax.jacfwd(lambda u: vec({"u": u, "f": vals[2]["f"]}))(vals[2]["u"])
    np.testing.assert_allclose(A, np.asarray(J), atol=1e-12)


@pytest.mark.parametrize("mode", ["jvp", "vjp"])
def test_sharded_residual_derivatives(ranks, mode):
    for r in ranks:
        got, one_rank = r[mode]
        np.testing.assert_allclose(got, one_rank, rtol=0, atol=1e-13)


def test_collectives_transpose(ranks):
    """y = sum_r 2 x_r: every rank gets the sum, and the gradient of the
    replicated output's sum is 2 x (number of ranks) on every rank."""
    want = 2.0 * sum(range(1, R.NRANKS + 1))
    for r in ranks:
        y, gx = r["collectives"]
        np.testing.assert_array_equal(y, np.full(3, want))
        np.testing.assert_array_equal(gx, np.full(3, 2.0 * R.NRANKS))


@pytest.mark.parametrize("solver", ["cg", "dense"])
def test_poisson_step_matches_jax(ranks, solver):
    J, g = _same_on_every_rank(ranks, f"poisson_{solver}")
    want_J = float(ORACLE[f"poisson8_{solver}_J"])
    assert abs(J - want_J) / abs(want_J) < 1e-10
    assert _rel(g, ORACLE[f"poisson8_{solver}_g"]) < 1e-8


@pytest.mark.parametrize("solver", ["cg", "dense"])
def test_poisson_gradient_equals_one_rank(ranks, solver):
    J, g = ranks[0][f"poisson_{solver}"]
    J1, g1 = ranks[0][f"poisson_{solver}_one_rank"]
    assert abs(J - J1) / abs(J1) < 1e-12
    assert _rel(g, g1) < 1e-9


def test_motor_step_matches_jax(ranks):
    loss, g_dv, g_iq = _same_on_every_rank(ranks, "motor")
    want = float(MOTOR_ORACLE["r05_lu_loss"])
    assert abs(loss - want) / abs(want) < 1e-10
    g = np.concatenate([g_dv, [g_iq]])
    want_g = np.concatenate([MOTOR_ORACLE["r05_lu_g_dv"],
                             [float(MOTOR_ORACLE["r05_lu_g_iq"])]])
    assert _rel(g, want_g) < 1e-8


def test_shell_step_matches_jax(ranks):
    J, g = _same_on_every_rank(ranks, "shell")
    want = float(ORACLE["shell34_J"])
    assert abs(J - want) / abs(want) < 1e-9
    assert _rel(g, ORACLE["shell34_g"]) < 1e-8


def test_motor_gradient_equals_one_rank(ranks):
    loss, g_dv, g_iq = ranks[0]["motor"]
    loss1, g1_dv, g1_iq = ranks[2]["motor_one_rank"]
    assert abs(loss - loss1) / abs(loss1) < 1e-12
    assert _rel(np.concatenate([g_dv, [g_iq]]),
                np.concatenate([g1_dv, [g1_iq]])) < 1e-9


def test_shell_gradient_equals_one_rank(ranks):
    J, g = ranks[0]["shell"]
    J1, g1 = ranks[1]["shell_one_rank"]
    assert abs(J - J1) / abs(J1) < 1e-9
    assert _rel(g, g1) < 1e-9


def test_dryrun_multichip_lines(ranks):
    """entry.dryrun_multichip's rank body: one line per path on rank 0,
    the Poisson objective the oracle's."""
    lines = ranks[0]["dryrun"]
    assert [ln.split(" mode ")[1].split(":")[0] for ln in lines] == [
        "a (cells-sharded poisson)", "a (cells-sharded motor)",
        "a (cells-sharded shell)", "b (dof-sharded halo CG)"]
    assert f"objective={float(ORACLE['poisson8_cg_J']):.6e}" in lines[0]
