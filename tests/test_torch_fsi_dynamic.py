"""W8/W9 parity: the port's dynamic aeroelastic FSI (femo_tpu_torch/models/
fsi.py: DynamicShellFSI, build_dynamic_fsi_jit_step) against the JAX
package, on CPU tensors in f64, at n_shell=(4, 6), n_vlm=(2, 4) (48
cells, 456 dofs) and, for W9, (6, 10) (1,050 dofs).

The JAX dynamic builders take minutes to compile, so their values are
read from oracles/fsi_dynamic_oracle.npz (written by
oracles/fsi_dynamic_oracle.py, each entry beside its configuration,
checked here).  Bars follow tests/test_torch_fsi.py: each value within 10
times the JAX package's own spread between two of its paths (the eager
class against the jitted builder, the builder against its
mixed-precision block inverses), at least 1e-12.  The trajectory
gradient against autograd through the unrolled forward with dense solves
1e-6; the W9 gradients against central differences.  On CPU tensors the
sweeps run their plain version.
"""

import functools
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from femo_tpu_torch.models.fsi import (
    DynamicShellFSI, aero_forces_from_file, build_dynamic_fsi_jit_step,
    build_wing_fsi, one_cosine_gust, synthetic_restart)
from femo_tpu_torch.tools.profile_step import DYN_LAYERS, layer_ranges
from femo_tpu_torch.tools.shell_parity import ROUNDING, rel_l2

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORACLE = os.path.join(ROOT, "oracles", "fsi_dynamic_oracle.npz")
SMALL = dict(n_shell=[4, 6], n_vlm=[2, 4])
GUST = dict(t0=0.0, duration=0.03)
EAGER = dict(SMALL, dt=0.01, fsi_iters=6, n_steps=3)
JIT = dict(SMALL, dt=0.01, fsi_iters=8, factor_store_dtype=None,
           pcg_iters=0, adj_passes=10, n_steps=3)
W9 = dict(n_shell=[6, 10], n_vlm=[2, 4], span=4.0, thickness=0.01, dt=0.01,
          pcg_iters=8, factor_store_dtype=None, external_loads=True,
          n_steps=4, series=dict(kind="seeded", seed=3, scale=2.0, lift=40.0))


@pytest.fixture(scope="module")
def oracle():
    return np.load(ORACLE)


def _entry(oracle, key, cfg):
    got = json.loads(str(oracle[f"{key}_config"]))
    assert got == json.loads(json.dumps(cfg)), (key, got)
    return {k[len(key) + 1:]: oracle[k] for k in oracle.files
            if k.startswith(f"{key}_") and not k.endswith("_config")}


def _np(v):
    return np.asarray(v.detach().cpu().numpy() if torch.is_tensor(v) else v,
                      np.float64)


def _gust(c):
    return (functools.partial(one_cosine_gust, **c["gust"])
            if "gust" in c else one_cosine_gust)


def _build(c, **extra):
    kw = {k: (tuple(v) if isinstance(v, list) else v) for k, v in c.items()
          if k not in ("n_steps", "gust", "series")}
    return build_dynamic_fsi_jit_step(gust=_gust(c), device="cpu",
                                      **kw, **extra)


def _seeded_series(c, n_pts):
    s = c["series"]
    rng = np.random.default_rng(s["seed"])
    series = rng.standard_normal((c["n_steps"], n_pts, 3)) * s["scale"]
    series[:, :, 2] += s["lift"]
    return series


def _eager_tips(c, gust=None, **run):
    fsi = build_wing_fsi(n_shell=tuple(c["n_shell"]),
                         n_vlm=tuple(c["n_vlm"]), device="cpu")
    dyn = DynamicShellFSI(fsi, dt=c["dt"], fsi_iters=c["fsi_iters"],
                          gust=gust or _gust(c))
    return dyn.run(c["n_steps"], **run)["tip_disp"]


@pytest.mark.parametrize("gust", [False, True])
def test_eager_matches_jax(oracle, gust):
    """DynamicShellFSI's tips, from rest and under a gust acting from the
    first step, within 10x the JAX package's eager-vs-jit spread."""
    c = dict(EAGER, gust=GUST) if gust else EAGER
    j = dict(JIT, gust=GUST) if gust else JIT
    sfx = "_gust" if gust else ""
    want = _entry(oracle, f"eager{sfx}", c)["tips"]
    pair = _entry(oracle, f"jit{sfx}", j)["tips"]
    tips = _eager_tips(c)
    bar = 10 * max(ROUNDING, rel_l2(pair, want))
    assert rel_l2(tips, want) <= bar, (rel_l2(tips, want), bar)
    assert 0 < tips[0] < tips[1] < tips[2]


def test_jit_matches_eager():
    """The factor-once builder against the eager class on one gust problem
    (tests/test_fsi.py::test_dynamic_fsi_jit_step_matches_eager)."""
    c = dict(EAGER, gust=GUST)
    f = _build(dict(c, factor_store_dtype=None, pcg_iters=0))
    tips = f["run"](f["t0"], c["n_steps"])["tip_disp"]
    np.testing.assert_allclose(tips, _eager_tips(c), rtol=1e-5)
    assert 0 < tips[0] < tips[1] < tips[2]


@pytest.fixture(scope="module")
def jit_runs():
    """run_with_grad of each JIT path, the stages counted by the step
    profiler's dynamic ranges."""
    runs = {}
    for name, c in (("jit", JIT), ("jit_gust", dict(JIT, gust=GUST))):
        f = _build(c)
        with layer_ranges(DYN_LAYERS) as lr:
            out = f["run_with_grad"](f["t0"], c["n_steps"])
        runs[name] = (out, dict(f["stats"]), dict(lr.calls), f)
    return runs


@pytest.mark.parametrize("name", ["jit", "jit_gust"])
def test_run_with_grad_matches_jax(oracle, jit_runs, name):
    """The tips, J and the trajectory gradient within 10x the JAX
    package's own spread between its f64 and mixed-inverse factors."""
    c = dict(JIT, gust=GUST) if name == "jit_gust" else JIT
    want = _entry(oracle, name, c)
    base = _entry(oracle, "jit", JIT)
    pair = _entry(oracle, "jit_mixed", dict(JIT, factor_compute_dtype="mixed"))
    out = jit_runs[name][0]
    for k, got in (("tips", out["tips"]), ("J", out["J"]),
                   ("grad", out["grad_thickness"])):
        bar = 10 * max(ROUNDING, rel_l2(pair[k], base[k]))
        r = rel_l2(_np(got), want[k])
        assert r <= bar, (name, k, r, bar)
    assert max(out["adj_deltas"]) < 1e-10
    assert out["tips"][-1] > out["tips"][0] > 0


@pytest.mark.parametrize("name", ["jit", "jit_gust"])
def test_run_with_grad_counts(jit_runs, name):
    """A forward step is fsi_iters solves (VLM + right-hand side each); a
    backward step 1 + adj_passes solves and adj_passes Fm^T products (K4T
    on the card); one fill and one factor."""
    out, stats, calls, f = jit_runs[name]
    n, it, adj = JIT["n_steps"], JIT["fsi_iters"], JIT["adj_passes"]
    assert stats["solves"] == n * it + n * (1 + adj)
    assert stats["precond"] == 0  # pcg_iters = 0
    assert calls["dyn.sweeps"] == stats["solves"]
    assert calls["dyn.rhs"] == n * it
    assert calls["dyn.step"] == calls["dyn.adjoint"] == n
    assert calls["assemble.rmatvec"] == n * adj
    assert calls["dyn.fill"] == calls["dyn.factor_core"] == 1
    assert calls["dyn.step_ext"] == calls["dyn.adjoint_ext"] == 0


def _dense_step_operator(f, tarr):
    """The constrained dynamic operator, dense and differentiable in the
    thickness (the assembly's jacfwd), and the zero old-state vectors."""
    st, sh = f["state"], f["shell"]
    z = lambda n: torch.zeros(n, dtype=torch.float64)  # noqa: E731
    p = {"thickness": tarr, "u_old": z(sh.Vu.n_dofs),
         "theta_old": z(sh.Vth.n_dofs), "v_old": z(sh.Vu.n_dofs),
         "force": z(sh.Vf.n_dofs)}
    K = st.jacobian(z(st.n_dofs), p).to_dense()
    return torch.where(st.free[:, None], K,
                       torch.eye(st.n_dofs, dtype=torch.float64))


def test_trajectory_gradient_matches_unrolled():
    """run_with_grad's checkpointed adjoint against autograd through the
    whole unrolled forward (3 steps of 8 inner passes, each a dense solve
    of the assembled midpoint operator), 1e-6."""
    c = JIT
    f = _build(c)
    out = f["run_with_grad"](f["t0"], c["n_steps"])
    st, sh, dyn = f["state"], f["shell"], f["dyn"]
    n_u = sh.Vu.n_dofs
    t = f["t0"].clone().requires_grad_(True)
    Kc = _dense_step_operator(f, t)
    u = torch.zeros(n_u, dtype=torch.float64)
    th = torch.zeros(sh.Vth.n_dofs, dtype=torch.float64)
    v = torch.zeros(n_u, dtype=torch.float64)
    d = torch.zeros(3 * dyn.n_lat, dtype=torch.float64)
    tips = []
    for n in range(c["n_steps"]):
        v_now = dyn.v_now((n + 0.5) * c["dt"])
        for _ in range(c["fsi_iters"]):
            trac = dyn.aero_traction(d, v_now).reshape(-1)
            u0 = torch.where(st.free, torch.zeros(st.n_dofs,
                                                  dtype=torch.float64),
                             st.bc_values)
            R = f["residual"](u0, dyn.params(t, u, th, v, trac))
            b = -torch.where(st.free, R, u0 - st.bc_values)
            x = u0 + torch.linalg.solve(Kc, b)
            d = dyn.d_mid(x, u)
        v = 2.0 * (x[:n_u] - u) / c["dt"] - v
        u, th = x[:n_u], x[n_u:]
        tips.append(dyn.u_nodes(x)[dyn.tip_idx, 2])
    J = torch.mean(torch.abs(torch.stack(tips)) ** 8) ** 0.125
    (g_true,) = torch.autograd.grad(J, t)
    J = float(J.detach())
    assert abs(J - out["J"]) <= 1e-10 * abs(J)
    assert rel_l2(_np(out["grad_thickness"]), _np(g_true)) < 1e-6


def test_dynamic_step_gradient_fd():
    """d(tip)/d(thickness) through one implicit-midpoint step of the
    eager class's op (its IFT adjoint) against central differences
    (tests/test_fsi.py::test_dynamic_step_adjoint_fd)."""
    fsi = build_wing_fsi(n_shell=(4, 6), n_vlm=(2, 4), device="cpu")
    dyn = DynamicShellFSI(fsi, dt=0.02, fsi_iters=2)
    op, state, sh = dyn.dyn_op, dyn.dyn_state, fsi["shell"]
    z = lambda V: torch.zeros(V.n_dofs, dtype=torch.float64)  # noqa: E731
    tip = int(np.argmax(fsi["mesh"].coords[:, 1]))
    f2 = torch.zeros(sh.Vf.n_dofs, dtype=torch.float64)
    f2[2::3] = 100.0

    def step_tip(tarr):
        x = op({"u_old": z(sh.Vu), "theta_old": z(sh.Vth), "v_old": z(sh.Vu),
                "thickness": tarr, "force": f2}, state.current().detach())
        return state.split(x)["u"].reshape(-1, 3)[tip, 2]

    t0 = sh.thickness.array.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(step_tip(t0), t0)
    h, i = 1e-6, 2
    with torch.no_grad():
        tp, tm = t0.detach().clone(), t0.detach().clone()
        tp[i] += h
        tm[i] -= h
        fd = (float(step_tip(tp)) - float(step_tip(tm))) / (2 * h)
    np.testing.assert_allclose(float(g[i]), fd, rtol=1e-4)


def test_aero_forces_from_file(tmp_path):
    """W9 through restart files: .npz and .h5 give the same tips (1e-12)
    and the directly passed callable's (1e-9); the interpolation matches
    the JAX package's on the same file."""
    import h5py
    from femo_tpu.models.fsi import aero_forces_from_file as jax_fn

    c = dict(EAGER, fsi_iters=4)
    fsi = build_wing_fsi(n_shell=(4, 6), n_vlm=(2, 4), device="cpu")
    n_pts = fsi["force_map"].W_np.shape[0]
    times = np.linspace(0.0, 0.1, 6)
    rng = np.random.default_rng(7)
    base = rng.standard_normal((n_pts, 3)) * 0.05
    base[:, 2] += 1.0
    series = base[None, :, :] * (1.0 + 5.0 * times)[:, None, None]
    fn_h5 = str(tmp_path / "vpm_restart.h5")
    with h5py.File(fn_h5, "w") as f:
        f.create_dataset("time", data=times)
        f.create_dataset("forces", data=series)
    fn_npz = str(tmp_path / "vpm_restart.npz")
    # shuffled in time: the reader sorts
    order = np.random.default_rng(1).permutation(len(times))
    np.savez(fn_npz, time=times[order], forces=series[order])

    def direct(t):
        return base * (1.0 + 5.0 * np.clip(float(t), times[0], times[-1]))

    tips_h5 = _eager_tips(c, aero_forces_fn=aero_forces_from_file(
        fn_h5, device="cpu"))
    tips_npz = _eager_tips(c, aero_forces_fn=aero_forces_from_file(
        fn_npz, device="cpu"))
    tips_direct = _eager_tips(c, aero_forces_fn=direct)
    assert all(np.isfinite(tips_h5)) and tips_h5[2] != 0.0
    np.testing.assert_allclose(tips_h5, tips_npz, rtol=1e-12)
    np.testing.assert_allclose(tips_h5, tips_direct, rtol=1e-9)
    ours, theirs = aero_forces_from_file(fn_npz, device="cpu"), jax_fn(fn_npz)
    for t in (-0.01, 0.0, 0.013, 0.05, 0.1, 0.2):
        np.testing.assert_allclose(_np(ours(t)), np.asarray(theirs(t)),
                                   rtol=1e-15, atol=1e-15)
    with pytest.raises(ValueError, match="unsupported"):
        aero_forces_from_file(str(tmp_path / "loads.csv"), device="cpu")


def test_one_cosine_gust_matches_jax():
    from femo_tpu.models.fsi import one_cosine_gust as jax_gust

    ts = np.linspace(-0.05, 0.4, 37)
    ours = _np(one_cosine_gust(torch.as_tensor(ts)))
    np.testing.assert_allclose(ours, np.asarray(jax_gust(ts)), rtol=1e-15,
                               atol=1e-15)
    assert float(one_cosine_gust(0.2)) == pytest.approx(2.0)
    assert float(one_cosine_gust(0.05)) == 0.0


@pytest.fixture(scope="module")
def w9_run():
    f = _build(W9)
    series = _seeded_series(W9, f["n_force_pts"])
    with layer_ranges(DYN_LAYERS) as lr:
        out = f["run_with_grad"](f["t0"], W9["n_steps"],
                                 forces_series=series)
    return f, series, out, dict(f["stats"]), dict(lr.calls)


def test_w9_matches_jax(oracle, w9_run):
    """The W9 tips, J, thickness gradient and load gradient within 10x the
    JAX package's own spread between its f64 and mixed-inverse factors."""
    f, series, out, stats, calls = w9_run
    want = _entry(oracle, "w9", W9)
    pair = _entry(oracle, "w9_mixed", dict(W9, factor_compute_dtype="mixed"))
    np.testing.assert_array_equal(series, want["series"])
    for k, got in (("tips", out["tips"]), ("J", out["J"]),
                   ("grad", out["grad_thickness"]),
                   ("grad_forces", out["grad_forces"])):
        bar = 10 * max(ROUNDING, rel_l2(pair[k], want[k]))
        r = rel_l2(_np(got), want[k])
        assert r <= bar, (k, r, bar)
    assert out["adj_deltas"] == [0.0] * W9["n_steps"]


def test_w9_counts(w9_run):
    """W9: one polished solve a step each way (2 + pcg_iters sweeps each),
    no VLM, no Fm^T product."""
    f, series, out, stats, calls = w9_run
    n, pcg = W9["n_steps"], W9["pcg_iters"]
    assert stats["solves"] == 2 * n
    assert stats["precond"] == 2 * n * (1 + pcg)
    assert calls["dyn.sweeps"] == 2 * n * (2 + pcg)
    assert calls["dyn.step_ext"] == calls["dyn.adjoint_ext"] == n
    assert calls["dyn.vlm"] == calls["assemble.rmatvec"] == 0
    assert tuple(out["grad_forces"].shape) == series.shape


def _J_of(f, tarr, series):
    tips = f["run"](tarr, W9["n_steps"], forces_series=series)["tip_disp"]
    return float(np.mean(np.abs(np.asarray(tips)) ** 8) ** 0.125)


@pytest.mark.parametrize("h", [1e-4, 1e-5])
def test_w9_thickness_gradient_fd(w9_run, h):
    """dJ/dt . t0 against central differences along t0
    (tests/test_fsi.py::test_w9_external_loads_jit_trajectory_gradient)."""
    f, series, out, _, _ = w9_run
    t0 = f["t0"]
    g_dir = float(torch.dot(out["grad_thickness"], t0))
    fd = (_J_of(f, t0 * (1 + h), series)
          - _J_of(f, t0 * (1 - h), series)) / (2 * h)
    np.testing.assert_allclose(g_dir, fd, rtol=1e-5)


@pytest.mark.parametrize("n, i, k", [(0, 1, 2), (3, 3, 2), (1, 0, 0)])
def test_w9_load_gradient_fd(w9_run, n, i, k):
    """dJ/d series[n, i, k] against central differences (h = 1e-3)."""
    f, series, out, _, _ = w9_run
    hh = 1e-3
    sp, sm = series.copy(), series.copy()
    sp[n, i, k] += hh
    sm[n, i, k] -= hh
    fd = (_J_of(f, f["t0"], sp) - _J_of(f, f["t0"], sm)) / (2 * hh)
    np.testing.assert_allclose(float(out["grad_forces"][n, i, k]), fd,
                               rtol=5e-6, atol=1e-12)


def test_synthetic_restart_matches_example(tmp_path):
    """The port's copy of examples/run_aeroelasticity_vpm.py's writer gives
    the example's file."""
    spec = importlib.util.spec_from_file_location(
        "run_aeroelasticity_vpm",
        os.path.join(ROOT, "examples", "run_aeroelasticity_vpm.py"))
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    write_synthetic_restart = ex.write_synthetic_restart
    a = synthetic_restart(str(tmp_path / "a.npz"), 8, 0.12)
    b = write_synthetic_restart(str(tmp_path / "b.npz"), 8, 0.12)
    with np.load(a) as da, np.load(b) as db:
        for key in ("time", "forces"):
            np.testing.assert_array_equal(da[key], db[key])


def test_guards():
    kw = dict(n_shell=(4, 6), n_vlm=(2, 4), device="cpu")
    for bad, match in ((dict(factor_method="lu"), "factor_method"),
                       (dict(factor_compute_dtype="bf16"),
                        "factor_compute_dtype"),
                       (dict(factor_method="cr",
                             factor_compute_dtype="float32"),
                        "requires factor_method='thomas'")):
        with pytest.raises(ValueError, match=match):
            build_dynamic_fsi_jit_step(**kw, **bad)
    f = build_dynamic_fsi_jit_step(**kw, external_loads=True)
    for call in (f["run"], f["run_with_grad"]):
        with pytest.raises(ValueError, match="requires forces_series"):
            call(f["t0"], 2)
    with pytest.raises(ValueError, match="template is for"):
        build_dynamic_fsi_jit_step(n_shell=(4, 8), n_vlm=(2, 4),
                                   device="cpu", template=f["tpl"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_dynamic_fsi_jit_step(n_shell=(4, 6), n_vlm=(2, 4))


def test_template_reuse_gives_the_same_bits():
    """A W9 build on a W8 build's template runs what a fresh build runs."""
    c = dict(n_shell=(4, 6), n_vlm=(2, 4), pcg_iters=2,
             factor_store_dtype=None, device="cpu")
    w8 = build_dynamic_fsi_jit_step(**c)
    series = np.random.default_rng(5).standard_normal(
        (2, w8["n_force_pts"], 3)) + [0.0, 0.0, 30.0]
    outs = []
    for tpl in (None, w8["tpl"]):
        f = build_dynamic_fsi_jit_step(**c, external_loads=True, template=tpl)
        outs.append(f["run_with_grad"](f["t0"], 2, forces_series=series))
    assert np.array_equal(outs[0]["tips"], outs[1]["tips"])
    for k in ("grad_thickness", "grad_forces"):
        assert torch.equal(outs[0][k], outs[1][k]), k


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


@pytest.mark.parametrize("key", ["rung_f64", "rung", "w9_rung_f64"])
def test_rung_entries(oracle, key):
    """The JAX package's rung entries that chip_smoke.py holds the card's
    W8/W9 runs to: computed for chip_smoke.py's configurations (the 77k
    rung of bench_scale.py, 12 steps), at the rung's sizes, finite."""
    cs = _chip_smoke()
    cfg = cs.dyn_config(key)
    assert cfg["n_shell"] == [4, 9600] and cfg["n_steps"] == 12
    e = _entry(oracle, key, cfg)
    assert (int(e["n_dofs"]), int(e["B"])) == (662442, 128)
    assert int(e["nb"]) == cs.DYN_NB
    assert e["grad"].shape == (76800,) and e["tips"].shape == (12,)
    assert all(np.all(np.isfinite(e[k])) for k in ("tips", "J", "grad"))
    if key.startswith("w9"):
        assert e["grad_forces"].shape == e["series"].shape == (12, 96, 3)
        assert np.all(np.isfinite(e["grad_forces"]))
    else:
        assert len(e["adj_deltas"]) == 12
