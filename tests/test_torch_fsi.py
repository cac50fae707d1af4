"""W7 parity: the port's static aeroelastic FSI (femo_tpu_torch/models/
fsi.py) against the JAX package, on CPU tensors in f64, at n_shell=(4, 6),
n_vlm=(2, 4) (48 cells, 456 dofs, nb=4 blocks of B=128).

The JAX FSI builders take minutes to compile, so their values are read
from oracles/fsi_oracle.npz (written by oracles/fsi_oracle.py, each entry
beside its configuration, checked here).  Bars follow the thin shell's
conditioning, as the shell's tests do (femo_tpu_torch/tools/
shell_parity.py): each value within 10 times the JAX package's own
spread between its paths of the same kind, at least 1e-12 -- for
`build_wing_fsi` its three solve modes, for `build_fsi_jit_step` each
path and the same path with the JAX package's mixed-precision block
inverses.  Force conservation 1e-13.  The coupled IFT gradient of the
port against autograd through an unrolled eager Gauss-Seidel loop 1e-6
(tests/test_fsi.py::test_fsi_jit_adjoint_matches_unrolled_gradient).
On CPU tensors the sweeps run their plain version.
"""

import json
import os

import numpy as np
import pytest
import torch

from femo_tpu_torch.fea.assemble import compile_form
from femo_tpu_torch.models.fsi import build_fsi_jit_step, build_wing_fsi
from femo_tpu_torch.tools.profile_step import FSI_LAYERS, layer_ranges
from femo_tpu_torch.tools.shell_parity import ROUNDING, rel_l2

torch.set_num_threads(1)

ORACLE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "oracles", "fsi_oracle.npz")
SMALL = dict(n_shell=[4, 6], n_vlm=[2, 4], span=4.0, chord=1.0)
WING = dict(SMALL, tol=1e-12, maxiter=2, relax=0.7)
JIT = dict(SMALL, gs_inner=4, relax=0.7, adj_passes=12, rounds=3)
JIT_PATHS = {
    "f64": dict(factor_store_dtype=None, pcg_iters=2),
    "f32": dict(factor_store_dtype="float32", pcg_iters=4),
    "compliance": dict(factor_store_dtype=None, pcg_iters=2,
                       objective="compliance"),
    "aitken": dict(factor_store_dtype=None, pcg_iters=2, accel="aitken"),
    "rtol": dict(factor_store_dtype="float32", pcg_rtol=1e-7,
                 pcg_maxiter=10),
}
MODES = ("jit_dense", "jit_bt", "eager")
JIT_SCALARS = ("tip", "compliance", "objective")
JIT_VECTORS = ("aero", "mapped", "grad")
CONSERVATION = 1e-13


@pytest.fixture(scope="module")
def oracle():
    return np.load(ORACLE)


def _entry(oracle, key, cfg):
    got = json.loads(str(oracle[f"{key}_config"]))
    assert got == json.loads(json.dumps(cfg)), (key, got)
    return {k[len(key) + 1:]: oracle[k] for k in oracle.files
            if k.startswith(f"{key}_") and not k.endswith("_config")}


def _kw(c, drop=()):
    return {k: (tuple(v) if isinstance(v, list) else v)
            for k, v in c.items() if k not in drop}


def _np(v):
    return np.asarray(v.detach().cpu().numpy() if torch.is_tensor(v) else v,
                      np.float64)


def _conservation(out):
    a, m = _np(out["total_aero_force"]), _np(out["total_mapped_force"])
    return np.linalg.norm(m - a) / np.linalg.norm(a)


@pytest.fixture(scope="module")
def wing_runs():
    """Each solve mode of build_wing_fsi, 2 passes; the tip's IFT
    gradient through fixed_point_solve_jit in the jit modes."""
    runs = {}
    for mode in MODES:
        fsi = build_wing_fsi(**_kw(WING, ("tol", "maxiter", "relax")),
                             solve_mode=mode, device="cpu")
        t = fsi["shell"].thickness.array.clone().requires_grad_(
            mode != "eager")
        run = dict(tol=WING["tol"], maxiter=WING["maxiter"],
                   relax=WING["relax"])
        if mode == "eager":
            with pytest.warns(UserWarning, match="did not converge"):
                out = fsi["solve"](t, **run)
        else:
            out = fsi["solve"](t, **run)
            out["grad"] = torch.autograd.grad(out["tip_disp"], t)[0]
        runs[mode] = out
    return runs


@pytest.mark.parametrize("mode", MODES)
def test_wing_fsi_matches_jax(oracle, wing_runs, mode):
    want = {m: _entry(oracle, f"wing_{m}", dict(WING, solve_mode=m))
            for m in MODES}
    out = wing_runs[mode]
    assert _conservation(out) <= CONSERVATION
    got = {"tip": out["tip_disp"], "aero": out["total_aero_force"],
           "mapped": out["total_mapped_force"], "disp": out["disp_fluid"]}
    if mode != "eager":
        got["grad"] = out["grad"]
    for k, v in got.items():
        ref = [want[m][k] for m in MODES if k in want[m]]
        spread = max([rel_l2(a, b) for a in ref for b in ref] + [ROUNDING])
        r = rel_l2(_np(v), want[mode][k])
        assert r <= 10 * spread, (mode, k, r, spread)


@pytest.fixture(scope="module")
def jit_runs():
    """Each build_fsi_jit_step path: solve_with_grad with the stages
    counted by the step profiler's FSI ranges."""
    runs = {}
    for name, kw in JIT_PATHS.items():
        fsi = build_fsi_jit_step(**_kw(JIT, ("rounds",)), **kw,
                                 device="cpu")
        with layer_ranges(FSI_LAYERS) as lr:
            out = fsi["solve_with_grad"](fsi["t0"], rounds=JIT["rounds"])
        runs[name] = (out, dict(fsi["stats"]), dict(lr.calls), fsi)
    return runs


@pytest.mark.parametrize("name", sorted(JIT_PATHS))
def test_jit_step_matches_jax(oracle, jit_runs, name):
    cfg = dict(JIT, **JIT_PATHS[name])
    want = _entry(oracle, f"jit_{name}", cfg)
    pair = _entry(oracle, f"jit_{name}_mixed",
                  dict(cfg, factor_compute_dtype="mixed"))
    out = jit_runs[name][0]
    assert _conservation(out) <= CONSERVATION
    got = {"tip": out["tip_disp"], "compliance": out["compliance"],
           "objective": out["objective"], "aero": out["total_aero_force"],
           "mapped": out["total_mapped_force"],
           "grad": out["grad_thickness"]}
    for k in JIT_SCALARS + JIT_VECTORS:
        bar = 10 * max(ROUNDING, rel_l2(pair[k], want[k]))
        r = rel_l2(_np(got[k]), want[k])
        assert r <= bar, (name, k, r, bar)
    assert float(out["rel_delta"]) < 1e-5 and float(out["adj_delta"]) < 1e-5


@pytest.mark.parametrize("name", sorted(JIT_PATHS))
def test_jit_step_solver_counts(jit_runs, name):
    """Every inner solve is one block-Thomas solve plus the PCG polish's
    preconditioner applications (so K1/K2 launch solves + precond times
    on the card); each adjoint pass applies Fm^T once (K4T)."""
    out, stats, calls, fsi = jit_runs[name]
    kw = JIT_PATHS[name]
    rounds, gs_inner, adj = JIT["rounds"], JIT["gs_inner"], JIT["adj_passes"]
    # forward passes, finalize, the adjoint's first solve and its passes
    assert stats["solves"] == rounds * gs_inner + 1 + 1 + adj
    assert calls["fsi.sweeps"] == stats["solves"] + stats["precond"]
    assert calls["fsi.rhs"] == rounds * gs_inner + 1
    assert calls["assemble.rmatvec"] == adj
    assert calls["fsi.fill"] == calls["fsi.factor_core"] == 1
    assert calls["fsi.adjoint"] == 1
    if "pcg_rtol" in kw:
        its = stats["pcg_iters"]
        assert len(its) == stats["solves"]
        assert stats["precond"] == len(its) + sum(its)
        assert 0 < max(its) <= kw["pcg_maxiter"]
    else:
        assert stats["precond"] == stats["solves"] * (1 + kw["pcg_iters"])


def test_mixed_and_pallas_give_the_same_bits():
    """factor_compute_dtype="mixed" computes the plain f64 inverse, and
    sweeps="pallas" runs the same sweeps (K1/K2 on the card) as "scan"."""
    kw = dict(_kw(SMALL), gs_inner=2, adj_passes=2, pcg_iters=2,
              factor_store_dtype="float32", device="cpu")
    runs = []
    for extra in ({}, {"factor_compute_dtype": "mixed"},
                  {"sweeps": "pallas"}):
        fsi = build_fsi_jit_step(**kw, **extra)
        runs.append(fsi["solve_with_grad"](fsi["t0"], rounds=1))
    for other in runs[1:]:
        for k in ("tip_disp", "objective", "grad_thickness", "x"):
            assert torch.equal(runs[0][k], other[k]), k


def _unrolled_tip(fsi, tarr, passes, relax):
    """The tip after `passes` damped Gauss-Seidel passes and a final
    solve, each shell solve a dense solve of the constrained composite
    operator K(t) (assembled once, differentiable in t through the
    assembly's jacfwd) with the right-hand side -Fm f of the traction;
    autograd differentiates the whole loop."""
    st, sh, consts = fsi["state"], fsi["shell"], fsi["consts"]
    free = st.free
    z = lambda n: torch.zeros(n, dtype=torch.float64)  # noqa: E731
    K = st.jacobian(z(st.n_dofs), {"thickness": tarr,
                                   "force": z(sh.Vf.n_dofs)}).to_dense()
    Kc = torch.where(free[:, None], K, torch.eye(st.n_dofs,
                                                 dtype=torch.float64))
    Fm = compile_form(sh.res_u).matrix(
        {"u": z(sh.Vu.n_dofs), "theta": z(sh.Vth.n_dofs),
         "thickness": z(sh.Vt.n_dofs), "force": z(sh.Vf.n_dofs)},
        "force").to_dense()
    n_u, n_nodes = sh.Vu.n_dofs, fsi["mesh"].n_nodes
    lat0, vlm, vvec = fsi["lat0"], fsi["vlm"], fsi["vvec"]

    def shell(d):
        aero = vlm.solve(lat0 + d.reshape(lat0.shape), vvec)
        trac = (consts["__fmapW__"] @ aero["forces"]).reshape(-1)
        R0 = torch.cat([Fm @ trac, z(st.n_dofs - n_u)])
        return torch.linalg.solve(Kc, -torch.where(free, R0, 0.0))

    d = z(3 * lat0.shape[0] * lat0.shape[1])
    for _ in range(passes):
        u_nodes = shell(d)[:n_u].reshape(-1, 3)[:n_nodes]
        d = (1 - relax) * d + relax * (consts["__dmapW__"] @ u_nodes
                                       ).reshape(-1)
    tip = int(np.argmax(fsi["mesh"].coords[:, 1]))
    return shell(d)[:n_u].reshape(-1, 3)[tip, 2]


def test_adjoint_matches_unrolled_gradient():
    """The coupled IFT adjoint (factor reuse, Fm^T and the VLM/RBF
    vector-Jacobian product per pass) against autograd through 40
    unrolled passes of the dense Gauss-Seidel loop."""
    fsi = build_fsi_jit_step(**_kw(SMALL), factor_store_dtype=None,
                             pcg_iters=2, gs_inner=5, relax=0.7,
                             adj_passes=24, device="cpu")
    out = fsi["solve_with_grad"](fsi["t0"], rounds=4)
    assert float(out["rel_delta"]) < 1e-8 and float(out["adj_delta"]) < 1e-8
    t = fsi["t0"].clone().requires_grad_(True)
    tip = _unrolled_tip(fsi, t, 40, 0.7)
    (g_true,) = torch.autograd.grad(tip, t)
    assert abs(float(tip) - float(out["tip_disp"])) <= 1e-8 * abs(float(tip))
    assert rel_l2(_np(out["grad_thickness"]), _np(g_true)) < 1e-6


def test_guards():
    kw = dict(n_shell=(4, 6), n_vlm=(2, 4), device="cpu")
    for bad, match in ((dict(objective="mass"), "objective"),
                       (dict(factor_method="lu"), "factor_method"),
                       (dict(accel="anderson"), "accel"),
                       (dict(sweeps="triton"), "sweeps"),
                       (dict(factor_compute_dtype="bf16"),
                        "factor_compute_dtype"),
                       (dict(sweeps="pallas", pcg_iters=0),
                        "requires pcg_iters > 0"),
                       (dict(factor_method="cr",
                             factor_compute_dtype="float32"),
                        "requires factor_method='thomas'"),
                       (dict(factor_method="cr", sweeps="pallas"),
                        "requires factor_method='thomas'")):
        with pytest.raises(ValueError, match=match):
            build_fsi_jit_step(**kw, **bad)
    if not torch.cuda.is_available():
        for build in (build_fsi_jit_step, build_wing_fsi):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                build(n_shell=(4, 6), n_vlm=(2, 4))


def test_anchor_f64_entry(oracle):
    """The JAX package's anchor entry that chip_smoke.py holds the card's
    anchor to: computed for chip_smoke.py's anchor configuration with the
    factor stored in f64, at the anchor's sizes, with finite values."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(ORACLE), os.pardir,
                                   "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    cfg = cs.fsi_config("anchor_f64")
    assert cfg == dict(cs.FSI_CONFIGS["anchor"], factor_store_dtype=None)
    assert cfg == dict(n_shell=[4, 13440], n_vlm=[4, 32], span=30.0,
                       thickness=0.05, gs_inner=4, factor_store_dtype=None,
                       pcg_rtol=1e-7, pcg_maxiter=10, rounds=5)
    e = _entry(oracle, "anchor_f64", cfg)
    assert (int(e["n_dofs"]), int(e["nb"]), int(e["B"])) == (927402, 7246,
                                                              128)
    assert e["grad"].shape == (107520,)
    assert all(np.all(np.isfinite(e[k])) for k in
               ("tip", "objective", "compliance", "aero", "mapped", "grad"))
    assert float(e["tip"]) == float(e["objective"])  # the tip objective
    assert _conservation({"total_aero_force": e["aero"],
                          "total_mapped_force": e["mapped"]}) \
        <= CONSERVATION


def test_conditioning_tool(tmp_path):
    """tools/fsi_conditioning.py on the anchor's wing at (4, 2): the tips
    as built and perturbed, and one solve's PCG history (the recursive
    residual falls, the true residual is no smaller than rounding)."""
    from femo_tpu_torch.tools.fsi_conditioning import main

    out = tmp_path / "cond.json"
    (r,) = main(["--spans", "2", "--seeds", "1", "--device", "cpu",
                 "--out", str(out)])
    assert json.loads(out.read_text())["rungs"][0]["n_shell"] == [4, 2]
    assert len(r["tips"]) == 2 and all(np.isfinite(r["tips"]))
    assert 0 < r["tip_rel_change"][0] < 1e-3
    k, rec, true, tip = r["pcg"][-1]
    assert k == 60 and rec < 1e-12 and true > 0 and np.isfinite(tip)
