"""Block cyclic reduction and the guarded, equilibrated f32 factor of the
port (femo_tpu_torch/ops/block_tridiag.py, graph/implicit.py,
models/fsi.py) against the JAX package, f64 unless stated, CPU.

* factor_cr / factor_t_cr solves on the 6 x ny rectangles of
  tests/test_block_tridiag.py (ny 100, 230, 320): rtol 1e-11, atol 1e-13
  against the JAX package's CR, and against the port's Thomas factor.
* implicit_solve_bt(factor_method="cr") on the nonlinear Poisson system of
  tests/test_torch_reuse.py (unit square 14), with and without
  jacobi_scale: value 1e-12, gradient 1e-9 (relative) against the JAX
  package; through the fused shell step at (6, 8) against the JAX
  package's step_cr entry at tests/test_torch_shell.py's bars.
* factor(guard=True) on an f32 chain with one exactly singular block: the
  rescued factor against the JAX package's (1e-5 relative, f32), the same
  block rescued; a healthy chain is not changed.
* the equilibrated f32 factor of models/fsi.py (`_BTPrograms`) against the
  JAX package's `_bt_factor_programs` on a chain whose diagonal spans 1e8:
  the solve within 1e-5 (f32 factors), and the factor's solve residual.
* the FSI builders with "cr" and "float32" against oracles/fsi_oracle.npz
  and oracles/fsi_dynamic_oracle.npz (their JAX compiles take minutes) at
  the bars of tests/test_torch_fsi.py: 10x the JAX package's own spread
  between the entry and the same configuration with the Thomas f64
  factor, at least 1e-12 (tools/shell_parity.py); the solver counts (no
  K1/K2 with "cr").
* the ValueErrors the JAX package raises for these options.
"""

import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from femo_tpu.models.fsi import _bt_factor_programs
from femo_tpu.ops.block_tridiag import BlockTridiagonalMatrix as JMatrix

from femo_tpu_torch.fea.assemble import assemble_matrix
from femo_tpu_torch.fea.forms import FormDef, dot, dx, grad
from femo_tpu_torch.fea.space import Function, FunctionSpace
from femo_tpu_torch.graph.implicit import implicit_solve_bt
from femo_tpu_torch.mesh.generators import create_rectangle_mesh
from femo_tpu_torch.models.fsi import (
    _BTPrograms, build_dynamic_fsi_jit_step, build_fsi_jit_step)
from femo_tpu_torch.models.motor.model import build_motor_jit_step
from femo_tpu_torch.models.shell import build_shell_jit_step
from femo_tpu_torch.ops.block_tridiag import BlockTridiagonalMatrix
from femo_tpu_torch.tools.profile_step import (
    DYN_LAYERS, FSI_LAYERS, layer_ranges)
from femo_tpu_torch.tools.shell_parity import ROUNDING, rel_l2, step_spread
from test_torch_reuse import jax_value_and_grad, port_value_and_grad, system

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHELL_ORACLE = os.path.join(ROOT, "oracles", "shell_oracle.npz")


def _rel(a, b):
    return np.linalg.norm(np.asarray(a) - b) / np.linalg.norm(b)


@pytest.mark.parametrize("ny", [100, 230, 320])
def test_cr_solves_match_jax(ny):
    """The port's matrix (assembled by the port) in both packages."""
    mesh = create_rectangle_mesh(6, ny, 0, 0, 1.0, 30.0,
                                 cell_type="triangle")
    V = FunctionSpace(mesh, ("CG", 1), device="cpu")
    u = Function(V, "u")
    A = assemble_matrix(FormDef([dx(lambda w, g: dot(grad(w.u), grad(w.v))
                                    + w.u * w.v)], coeffs=[u], test=V), "u")
    tm = BlockTridiagonalMatrix.from_element_matrix(A)
    jm = JMatrix(*(jnp.asarray(a.numpy()) for a in (tm.D, tm.L, tm.U)),
                 tm.perm, tm.n)
    b = np.random.default_rng(ny).standard_normal(V.n_dofs)
    tb = torch.as_tensor(b)
    # the JAX solves in one program (op by op, the JAX package compiles
    # every primitive of every level)
    wants = jax.jit(lambda v: (jm.factor_cr().solve(v),
                               jm.factor_t_cr().solve(v)))(jnp.asarray(b))
    for name, want in zip(("factor_cr", "factor_t_cr"), wants):
        tf = getattr(tm, name)()
        assert tf.n2 == 1 << (tm.nb - 1).bit_length()
        np.testing.assert_allclose(tf.solve(tb).numpy(), np.asarray(want),
                                   rtol=1e-11, atol=1e-13)
    np.testing.assert_allclose(tm.factor_cr().solve(tb).numpy(),
                               tm.factor().solve(tb).numpy(),
                               rtol=1e-11, atol=1e-13)
    # the chunked variant is the whole reduction here
    for a, c in zip(tm.factor_cr_chunked(tail=2).levels,
                    tm.factor_cr().levels):
        assert all(torch.equal(x, y) for x, y in zip(a, c))


@pytest.mark.parametrize("jacobi", [False, True], ids=["raw", "jacobi"])
def test_implicit_cr_matches_jax(jacobi):
    kw = dict(factor_method="cr", jacobi_scale=jacobi)
    jv, jg = jax_value_and_grad(14, **kw)
    tv, tg = port_value_and_grad(14, **kw)
    assert abs(tv - jv) <= 1e-12 * abs(jv)
    assert _rel(tg, jg) <= 1e-9


def test_shell_step_cr_matches_jax():
    """The fused shell step (build_shell_jit_step, not split) with
    factor_method="cr" at (6, 8) against the JAX package's step_cr entry
    (oracles/shell_oracle.npz), J and gradient within 10x the JAX
    package's own spread between its direct paths (tests/
    test_torch_shell.py's bars)."""
    with np.load(SHELL_ORACLE) as o:
        assert json.loads(str(o["step_cr_config"])) == dict(
            n_shell=[6, 8], factor_method="cr")
        want_J, want_g = float(o["step_cr_J"]), o["step_cr_grad"]
        sJ, sg = step_spread(o, "direct")
    step, t0, _ = build_shell_jit_step(n_shell=(6, 8), factor_method="cr",
                                       device="cpu")
    J, g = step(t0)
    assert abs(float(J) - want_J) <= 10 * sJ * abs(want_J)
    assert rel_l2(g.numpy(), want_g) <= 10 * sg


def _chain(nb, B, seed, spread=0.0):
    """An SPD block-tridiagonal chain (numpy f64) whose diagonal spans
    10^spread."""
    rng = np.random.default_rng(seed)
    D = np.tile(np.eye(B) * 4.0, (nb, 1, 1)) + 0.1 * rng.standard_normal(
        (nb, B, B))
    D = 0.5 * (D + D.transpose(0, 2, 1))
    L = 0.5 / np.sqrt(B) * rng.standard_normal((nb, B, B))
    L[0] = 0.0
    U = np.zeros_like(L)
    U[:-1] = L[1:].transpose(0, 2, 1)
    s = 10.0 ** (0.5 * spread * rng.random((nb, B)))
    sm, sp = np.roll(s, 1, 0), np.roll(s, -1, 0)
    return (D * s[:, :, None] * s[:, None, :],
            L * s[:, :, None] * sm[:, None, :],
            U * s[:, :, None] * sp[:, None, :])


def test_guarded_f32_factor_matches_jax():
    nb, B, k = 6, 8, 3
    D, L, U = (a.astype(np.float32) for a in _chain(nb, B, 7))
    L[k] = 0.0  # S_k = D_k, exactly singular in f32
    U[k - 1] = 0.0
    D[k, -1, :] = D[k, :, -1] = 0.0
    perm = np.arange(nb * B)
    jfac = JMatrix(*(jnp.asarray(a) for a in (D, L, U)), perm,
                   nb * B).factor(spd=True, guard=True)
    tm = BlockTridiagonalMatrix(*(torch.as_tensor(a) for a in (D, L, U)),
                                perm, nb * B)
    tfac = tm.factor(spd=True, guard=True)
    assert int(tfac.rescued) == 1
    assert not torch.isfinite(tm.factor().Sinv[k]).all()
    for name in ("Sinv", "C"):
        got = getattr(tfac, name).numpy()
        want = np.asarray(getattr(jfac, name))
        assert np.isfinite(got).all()
        assert _rel(got, want) <= 1e-5, name
    # a healthy chain: the guard changes nothing
    h = BlockTridiagonalMatrix(*(torch.as_tensor(a.astype(np.float32))
                                 for a in _chain(nb, B, 8)), perm, nb * B)
    g, p = h.factor(guard=True), h.factor()
    assert int(g.rescued) == 0
    assert torch.equal(g.Sinv, p.Sinv) and torch.equal(g.C, p.C)


def test_equilibrated_f32_factor_matches_jax():
    nb, B = 5, 32
    D, L, U = _chain(nb, B, 11, spread=8.0)
    n = nb * B
    tpl = SimpleNamespace(perm_full=np.arange(nb * B), n=n, nb=nb)
    jprog = _bt_factor_programs(tpl, None, None, n, None, None, None,
                                factor_compute_dtype="float32")
    jD, jL, jU = (jnp.asarray(a) for a in (D, L, U))
    _, jfac = jprog[3]((jD, jL, jU) + tuple(jprog[1](jD, jL, jU)))
    bt = _BTPrograms(tpl, None, n, None, None, None, compute="float32")
    tD, tL, tU = (torch.as_tensor(a) for a in (D, L, U))
    carry = (tD, tL, tU) + bt.factor_core(tD, tL, tU)
    assert carry[3].dtype == carry[4].dtype == torch.float32
    mat, fac = bt.unpack(carry)
    assert fac.sweep_dtype == torch.float32 and fac.Lfac.dtype == torch.float32
    b = np.random.default_rng(3).standard_normal(n)
    x = fac.solve(torch.as_tensor(b))
    assert x.dtype == torch.float64
    assert _rel(x.numpy(), np.asarray(jfac.solve(jnp.asarray(b)))) <= 1e-5
    assert _rel(mat.matvec(x).numpy(), b) <= 1e-4


FSI_ORACLE = os.path.join(ROOT, "oracles", "fsi_oracle.npz")
DYN_ORACLE = os.path.join(ROOT, "oracles", "fsi_dynamic_oracle.npz")
SMALL = dict(n_shell=[4, 6], n_vlm=[2, 4], span=4.0, chord=1.0)
JIT = dict(SMALL, gs_inner=4, relax=0.7, adj_passes=12, rounds=3)
# each entry and the Thomas f64 configuration beside it (its JAX spread)
FSI_PATHS = {
    "jit_cr_f64": (dict(JIT, factor_store_dtype=None, pcg_iters=2,
                        factor_method="cr"), "jit_f64"),
    "jit_cr_f32": (dict(JIT, factor_store_dtype="float32", pcg_iters=4,
                        factor_method="cr"), "jit_f64"),
    "jit_f32c": (dict(JIT, thickness=0.05, factor_store_dtype=None,
                      factor_compute_dtype="float32", pcg_iters=8),
                 "jit_f32c_f64"),
}
DYN_JIT = dict(n_shell=[4, 6], n_vlm=[2, 4], dt=0.01, fsi_iters=8,
               factor_store_dtype=None, pcg_iters=0, adj_passes=10, n_steps=3)
DYN_PATHS = {"jit_cr": dict(DYN_JIT, factor_method="cr"),
             "jit_f32c": dict(DYN_JIT, factor_compute_dtype="float32",
                              pcg_iters=4)}


def _entry(path, key, cfg=None):
    with np.load(path) as o:
        if cfg is not None:
            got = json.loads(str(o[f"{key}_config"]))
            assert got == json.loads(json.dumps(cfg)), (key, got)
        return {k[len(key) + 1:]: o[k] for k in o.files
                if k.startswith(f"{key}_") and not k.endswith("_config")}


def _kw(c, drop=()):
    return {k: (tuple(v) if isinstance(v, list) else v)
            for k, v in c.items() if k not in drop}


def _np(v):
    return np.asarray(v.detach().numpy() if torch.is_tensor(v) else v,
                      np.float64)


@pytest.mark.parametrize("key", sorted(FSI_PATHS))
def test_fsi_factor_options_match_jax(key):
    cfg, pair_key = FSI_PATHS[key]
    want = _entry(FSI_ORACLE, key, cfg)
    pair = _entry(FSI_ORACLE, pair_key)
    f = build_fsi_jit_step(**_kw(cfg, ("rounds",)), device="cpu")
    with layer_ranges(FSI_LAYERS) as lr:
        out = f["solve_with_grad"](f["t0"], rounds=cfg["rounds"])
    got = {"tip": out["tip_disp"], "objective": out["objective"],
           "compliance": out["compliance"], "aero": out["total_aero_force"],
           "grad": out["grad_thickness"]}
    for k, v in got.items():
        bar = 10 * max(ROUNDING, rel_l2(want[k], pair[k]))
        r = rel_l2(_np(v), want[k])
        assert r <= bar, (key, k, r, bar)
    st = f["stats"]
    assert st["solves"] == JIT["rounds"] * JIT["gs_inner"] + 2 + JIT[
        "adj_passes"]
    assert st["precond"] == st["solves"] * (1 + cfg["pcg_iters"])
    sweeps = 0 if cfg.get("factor_method") == "cr" else (
        st["solves"] + st["precond"])
    assert lr.calls["fsi.sweeps"] == sweeps
    assert lr.calls["fsi.factor_core"] == 1


@pytest.mark.parametrize("key", sorted(DYN_PATHS))
def test_dynamic_factor_options_match_jax(key):
    cfg = DYN_PATHS[key]
    want = _entry(DYN_ORACLE, key, cfg)
    pair = _entry(DYN_ORACLE, "jit")
    f = build_dynamic_fsi_jit_step(**_kw(cfg, ("n_steps",)), device="cpu")
    with layer_ranges(DYN_LAYERS) as lr:
        out = f["run_with_grad"](f["t0"], cfg["n_steps"])
    for k, v in (("tips", out["tips"]), ("J", out["J"]),
                 ("grad", out["grad_thickness"])):
        bar = 10 * max(ROUNDING, rel_l2(want[k], pair[k]))
        r = rel_l2(_np(v), want[k])
        assert r <= bar, (key, k, r, bar)
    st = f["stats"]
    sweeps = 0 if key == "jit_cr" else st["solves"] + st["precond"]
    assert lr.calls["dyn.sweeps"] == sweeps > 0 or key == "jit_cr"


def test_factor_option_guards():
    s = system(14)
    for kw in (dict(adjoint="reuse_symmetric", newton_iters=1),
               dict(refactor_every=2, pcg_iters=4, newton_iters=2)):
        with pytest.raises(ValueError, match="factor_method='thomas'"):
            implicit_solve_bt(None, None, s["tpl"], s["free"], s["bv"],
                              factor_method="cr", **kw)
    with pytest.raises(ValueError, match="'thomas' or 'cr'"):
        implicit_solve_bt(None, None, s["tpl"], s["free"], s["bv"],
                          factor_method="lu")
    bad = dict(n_shell=(4, 6), n_vlm=(2, 4), device="cpu",
               factor_method="cr", factor_compute_dtype="float32")
    for build in (build_fsi_jit_step, build_dynamic_fsi_jit_step):
        with pytest.raises(ValueError, match="requires factor_method"):
            build(**bad)
    with pytest.raises(ValueError, match="factor_method='thomas'"):
        build_motor_jit_step(refine=0.5, factorization="block_thomas",
                             factor_method="cr", refactor_every=3,
                             device="cpu")
    with pytest.raises(ValueError, match="factor_method"):
        build_shell_jit_step(n_shell=(2, 2), split_programs=True,
                             factor_method="cr", device="cpu")
