"""The port's optimizer drivers and Simulator introspection against the JAX
package, f64, CPU (mirroring tests/test_optimizer_extras.py and
tests/test_io_utils.py's gradient-field dumps): LBFGSB on W1 at nel=8
against oracles/examples_oracle.npz, ExternalDriver with a mock
optimizer, SNOPT's warning and its SLSQP fallback, SNOPT driving a stub
`modopt` binding, the graph summary text, dump_gradient_fields, the
Dashboard's frames and build_motor_model(record=True).
"""

import json
import os
import sys
import types

import numpy as np
import pytest
import torch

from femo_tpu.graph.model import FEAModel as JFEAModel
from femo_tpu.graph.simulator import Simulator as JSimulator
from femo_tpu.models.poisson import build_fea as jbuild_fea

import femo_tpu_torch
from femo_tpu_torch.graph.model import FEAModel
from femo_tpu_torch.graph.optimizer import (
    LBFGSB, SLSQP, SNOPT, ExternalDriver, OptimizationProblem)
from femo_tpu_torch.graph.simulator import Simulator
from femo_tpu_torch.models.poisson import build_fea
from femo_tpu_torch.tools.minimize_log import minimize_log

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORACLE = os.path.join(REPO, "oracles", "examples_oracle.npz")


@pytest.fixture(autouse=True)
def cpu(monkeypatch):
    monkeypatch.setattr(femo_tpu_torch.config, "device", "cpu")


@pytest.fixture(scope="module")
def oracle():
    with np.load(ORACLE) as f:
        return {k: f[k] for k in f.files}


def _rel(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def _w1(nel, val, build=build_fea, FM=FEAModel, S=Simulator, **sim_kw):
    fea, d = build(nel=nel)
    model = FM(fea=[fea])
    model.create_input("f", shape=d["W"].n_dofs, val=val)
    model.add_design_variable("f")
    model.add_objective("l2_functional", scaler=1e5)
    sim = S(model, **sim_kw)
    sim.run()
    return sim, d


def test_lbfgsb_w1_matches_oracle(oracle):
    """LBFGSB(maxiter=5) on W1 at nel=8 (f = 0.5): every evaluation's
    objective (1e-8), the final controls (1e-6) and the evaluation count
    against the JAX package's run."""
    key = "w1_lbfgsb_nel8"
    cfg = json.loads(str(oracle[f"{key}_config"]))
    sim, _ = _w1(cfg["nel"], 0.5)
    prob = OptimizationProblem(sim, "poisson_lbfgsb")
    with minimize_log() as calls:
        res = LBFGSB(prob, maxiter=cfg["maxiter"]).solve()
    (c,) = calls
    assert c["method"] == "L-BFGS-B"
    assert c["nfev"] == int(oracle[f"{key}_nfev"])
    f_rel = np.abs(np.array(c["f"]) - oracle[f"{key}_f"]) \
        / np.abs(oracle[f"{key}_f"])
    assert f_rel.max() <= 1e-8, f_rel
    assert _rel(c["x"], oracle[f"{key}_x"]) <= 1e-6
    assert _rel(c["g0"], oracle[f"{key}_g0"]) <= 1e-8
    assert res.fun < c["f"][0]
    # the optimum was written back and the simulator run there
    assert _rel(prob.x0, res.x) <= 1e-15
    assert abs(float(sim["l2_functional"])
               - float(oracle[f"{key}_out_l2_functional"])) <= 1e-8 * abs(
                   float(oracle[f"{key}_out_l2_functional"]))


def test_external_driver_mock():
    """A mock optimizer with the modOpt-style callback signature drives
    the problem through ExternalDriver."""
    sim, _ = _w1(8, 0.086)
    prob = OptimizationProblem(sim, "poisson_ext")

    class MockDriver:
        """Fixed-step steepest descent through the neutral callbacks."""

        def __init__(self, cb, steps=5, lr=0.5):
            self.cb, self.steps, self.lr = cb, steps, lr

        def solve(self):
            x = np.asarray(self.cb["x0"], float)
            f0 = self.cb["objective"](x)
            for _ in range(self.steps):
                x = x - self.lr * self.cb["objective_gradient"](x)
            self.result = {"f0": f0, "f": self.cb["objective"](x), "x": x}
            return x

    drv = ExternalDriver(prob, driver_factory=MockDriver, steps=5, lr=0.5)
    res = drv.solve()
    assert res["f"] < res["f0"], res
    rec = prob.history[-1]
    assert "dvs" in rec and "obj" in rec and "iter" in rec
    np.testing.assert_array_equal(prob.x0, res["x"])
    with pytest.raises(ValueError, match="driver_factory"):
        ExternalDriver(prob).solve()


def test_snopt_falls_back_to_slsqp():
    """Without a binding SNOPT warns and runs SLSQP with ftol =
    Major_optimality and maxiter = Major_iterations: the same result, bit
    for bit, as SLSQP called so."""
    sim, _ = _w1(8, 0.086)
    prob = OptimizationProblem(sim, "poisson_snopt")
    opt = SNOPT(prob, Major_iterations=8, Major_optimality=1e-9)
    with pytest.warns(UserWarning, match="SNOPT binding not available"):
        res = opt.solve()
    sim2, _ = _w1(8, 0.086)
    res2 = SLSQP(OptimizationProblem(sim2, "poisson_slsqp"), ftol=1e-9,
                 maxiter=8).solve()
    np.testing.assert_array_equal(res.x, res2.x)
    assert (res.fun, res.nit, res.nfev) == (res2.fun, res2.nit, res2.nfev)
    assert res.fun < prob.history[0]["obj"] * 1e5 * 0.1
    opt.print_results()


def test_snopt_drives_stub_modopt_binding(monkeypatch):
    """With a stub modopt.SNOPT importable, SNOPT takes the binding branch
    and hands it the neutral callbacks (x0, bounds, objective and
    gradient, constraint fun/jac) and the Major_* options as given."""
    fea, d = build_fea(8)
    model = FEAModel(fea=[fea])
    model.create_input("f", shape=d["W"].n_dofs, val=0.086)
    model.add_design_variable("f", lower=-2.0, upper=2.0)
    model.add_objective("l2_functional", scaler=1e5)
    model.add_constraint("l2_functional", upper=1.0, scaler=1e5)
    sim = Simulator(model)
    sim.run()
    prob = OptimizationProblem(sim, problem_name="snopt_stub")
    seen = {}

    class _StubSNOPT:
        def __init__(self, cb, **opts):
            seen["cb"], seen["opts"] = cb, opts

        def solve(self):
            cb = seen["cb"]
            x = np.asarray(cb["x0"], float)
            seen["f0"] = cb["objective"](x)
            for _ in range(3):
                x = np.clip(x - 0.5 * cb["objective_gradient"](x),
                            cb["lower"], cb["upper"])
            seen["f"] = cb["objective"](x)
            c = cb["constraints"][0]
            seen["c_val"] = np.asarray(c["fun"](x), float)
            seen["c_jac"] = np.asarray(c["jac"](x), float)
            return x

    stub = types.ModuleType("modopt")
    stub.SNOPT = _StubSNOPT
    monkeypatch.setitem(sys.modules, "modopt", stub)
    opt = SNOPT(prob, Major_iterations=7, Major_optimality=1e-7,
                Major_feasibility=1e-5)
    x_opt = np.asarray(opt.solve(), float)
    assert seen["opts"] == dict(Major_iterations=7, Major_optimality=1e-7,
                                Major_feasibility=1e-5, append2file=False)
    cb = seen["cb"]
    assert cb["x0"].shape == (prob.nx,)
    assert np.all(cb["lower"] == -2.0) and np.all(cb["upper"] == 2.0)
    assert seen["f"] < seen["f0"]
    assert np.allclose(seen["c_val"], seen["f"], rtol=1e-12)
    assert seen["c_jac"].shape == (1, prob.nx)
    assert np.linalg.norm(seen["c_jac"]) > 0
    assert np.allclose(prob.x0, x_opt, atol=1e-12)
    opt.print_results()


def test_graph_summary_text_matches_jax(tmp_path, capsys):
    """Simulator(analytics=True) prints the op graph after run(), and
    visualize_implementation returns and writes it: the same text as the
    JAX package's for W1 at nel=4."""
    sim, _ = _w1(4, 0.1, analytics=True, jit=True)
    out = capsys.readouterr().out
    jsim, _ = _w1(4, 0.1, jbuild_fea, JFEAModel, JSimulator, analytics=True)
    jout = capsys.readouterr().out
    assert "model graph:" in out and "l2_functional" in out
    assert out == jout
    p = str(tmp_path / "graph.txt")
    s = sim.visualize_implementation(path=p)
    assert s == jsim.visualize_implementation()
    assert open(p).read().strip() == s.strip()
    # with no outputs yet it runs the model first
    fresh = Simulator(sim.model)
    assert fresh.visualize_implementation() == s


def _h5(path):
    import h5py

    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda n, o: out.__setitem__(n, o[()])
                     if isinstance(o, h5py.Dataset) else None)
    return out


def test_dump_gradient_fields_matches_jax(tmp_path):
    """Analytic, FD and error gradient FIELDS to XDMF: the error field is
    their difference, the analytic one matches the JAX package's dump
    (1e-10) and the XDMF text is the JAX writer's."""
    sim, d = _w1(5, 0.5)
    path = str(tmp_path / "port" / "dJ_df.xdmf")
    rep = sim.dump_gradient_fields("l2_functional", "f", d["W"], path,
                                   step=1e-7)
    assert rep["rel_error"] < 1e-6
    jsim, jd = _w1(5, 0.5, jbuild_fea, JFEAModel, JSimulator)
    jpath = str(tmp_path / "jax" / "dJ_df.xdmf")
    jsim.dump_gradient_fields("l2_functional", "f", jd["W"], jpath,
                              step=1e-7)
    h5, jh5 = _h5(path[:-5] + ".h5"), _h5(jpath[:-5] + ".h5")
    assert sorted(h5) == sorted(jh5)
    an = h5["fields/dl2_functional_df_analytic/0"]
    fd = h5["fields/dl2_functional_df_fd/1"]
    er = h5["fields/dl2_functional_df_error/2"]
    np.testing.assert_allclose(an, rep["analytic"].ravel())
    np.testing.assert_allclose(an - fd, er, atol=1e-12)
    assert np.abs(er).max() < 1e-5 * np.abs(an).max() + 1e-12
    assert _rel(an, jh5["fields/dl2_functional_df_analytic/0"]) <= 1e-10
    np.testing.assert_array_equal(h5["mesh/cells"], jh5["mesh/cells"])
    assert open(path).read() == open(jpath).read()


def test_dump_gradient_fields_wrong_space_raises(tmp_path):
    sim, d = _w1(4, 0.5)
    with pytest.raises(ValueError, match="dofs"):
        sim.dump_gradient_fields("l2_functional", "f", d["V"],
                                 str(tmp_path / "g.xdmf"))


def test_dashboard_writes_frames(tmp_path):
    """The Dashboard callback renders a PNG frame every 2 evaluations, a
    per-cell field frame of the DG0 control with each, and a summary."""
    from femo_tpu_torch.graph.dashboard import Dashboard

    sim, d = _w1(8, 0.086)
    prob = OptimizationProblem(sim, "poisson_dash")
    dash = Dashboard(prob, outdir=str(tmp_path / "dash"), every=2,
                     mesh=d["mesh"], field_fn=lambda rec: rec["dvs"]["f"],
                     field_name="control")
    SLSQP(prob, ftol=1e-12, maxiter=4).solve()
    summary = dash.finalize()
    frames = sorted(os.listdir(tmp_path / "dash"))
    n = len(prob.history)
    assert "summary.png" in frames
    assert [f for f in frames if f.startswith("frame_")
            and not f.endswith("_control.png")] == [
        f"frame_{i:04d}.png" for i in range(0, n, 2)]
    assert any(f.endswith("_control.png") for f in frames)
    assert os.path.getsize(summary) > 5000
    drawn = dash.render_field_frame(str(tmp_path / "f.png"), prob.history[-1])
    assert drawn.shape == (d["mesh"].n_cells,)
    with pytest.raises(ValueError, match="per-node"):
        Dashboard(prob, outdir=str(tmp_path / "bad"), mesh=d["mesh"],
                  field_fn=lambda rec: np.zeros(3)).render_field_frame(
            str(tmp_path / "bad.png"), prob.history[-1])


def test_motor_model_records_match_jax(oracle, tmp_path, monkeypatch):
    """build_motor_model(record=True) at refine 0.5: one run writes the
    |B| series under records_motor, with the JAX package's XDMF text, its
    mesh datasets bit for bit and the field within 1e-8."""
    from femo_tpu_torch.models.motor.model import build_motor_model
    from femo_tpu_torch.solvers.linear import LinearSolver

    key = "motor_record_r05"
    c = json.loads(str(oracle[f"{key}_config"]))
    monkeypatch.chdir(tmp_path)
    model, _ = build_motor_model(
        refine=c["refine"], em_load_steps=c["em_load_steps"],
        linear_solver=LinearSolver(method=c["linear_solver"]), record=True)
    sim = Simulator(model)
    sim["shape_dv"] = np.array(c["shape_dv"])
    sim.run()
    model.recorder.close()
    assert sorted(os.listdir("records_motor")) == json.loads(
        str(oracle[f"{key}_files"]))
    base = os.path.join("records_motor", "record_B_magnitude")
    assert open(base + ".xdmf").read() == str(oracle[f"{key}_xdmf"])
    h5 = _h5(base + ".h5")
    want = {k[len(key) + 4:]: v for k, v in oracle.items()
            if k.startswith(f"{key}_h5/")}
    assert sorted(h5) == sorted(want)
    for k, v in want.items():
        if k.startswith("mesh/"):
            np.testing.assert_array_equal(h5[k], v)
        else:
            assert _rel(h5[k], v) <= 1e-8, k
