"""Parity of the port's entry-point modules with the JAX package, f64, CPU:
fea/utils, the public `fea` names, compat, the consistent-mass
projection, BlockTridiagFactorization with refinement, the XDMF writer
and Recorder, checkpoints across the two packages, the profiling
utilities, and a guard that no module of the port imports jax or
femo_tpu.

Everything here is small (unit squares of 3-8 cells a side, a 4 x 24
annulus); the JAX side runs live.
"""

import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import femo_tpu.compat as jcompat
import femo_tpu.fea as jfea
from femo_tpu.fea import utils as jutils
from femo_tpu.fea.project import project_form as jproject_form
from femo_tpu.graph.model import FEAModel as JFEAModel
from femo_tpu.graph.optimizer import OptimizationProblem as JProblem
from femo_tpu.graph.simulator import Simulator as JSimulator
from femo_tpu.io.xdmf import Recorder as JRecorder, XDMFWriter as JXDMFWriter
from femo_tpu.models.poisson import build_fea as jbuild_fea
from femo_tpu.ops.block_tridiag import (
    BlockTridiagFactorization as JBTFactorization)
from femo_tpu.utils.checkpoint import (
    load_checkpoint as jload_checkpoint, save_checkpoint as jsave_checkpoint)

import femo_tpu_torch
import femo_tpu_torch.compat as compat
import femo_tpu_torch.fea as tfea
from femo_tpu_torch.convert import mesh_from_jax
from femo_tpu_torch.fea import utils
from femo_tpu_torch.fea.project import project_form
from femo_tpu_torch.graph.model import FEAModel
from femo_tpu_torch.graph.optimizer import OptimizationProblem
from femo_tpu_torch.graph.simulator import Simulator
from femo_tpu_torch.io.xdmf import Recorder, XDMFWriter
from femo_tpu_torch.models.poisson import build_fea
from femo_tpu_torch.ops.block_tridiag import BlockTridiagFactorization
from femo_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from femo_tpu_torch.utils.profiling import (
    StageTimers, Timer, device_trace, profile)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rel(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


@pytest.fixture()
def cpu(monkeypatch):
    monkeypatch.setattr(femo_tpu_torch.config, "device", "cpu")


# -- fea/utils -----------------------------------------------------------------

def _partials_form(F, mesh, seed):
    """J = int 0.5 f u^2 + f^2 dx with u (CG1) and f (DG0) from a seed."""
    V = F.FunctionSpace(mesh, ("CG", 1))
    W = F.FunctionSpace(mesh, ("DG", 0))
    rng = np.random.default_rng(seed)
    u = F.Function(V, "u")
    f = F.Function(W, "f")
    u.array = (torch.as_tensor(rng.standard_normal(V.n_dofs))
               if F is tfea else jnp.asarray(rng.standard_normal(V.n_dofs)))
    f.array = (torch.as_tensor(rng.standard_normal(W.n_dofs))
               if F is tfea else jnp.asarray(rng.standard_normal(W.n_dofs)))
    return F.FormDef([F.dx(lambda w, g: 0.5 * w.f * w.u ** 2 + w.f ** 2)],
                     coeffs=[u, f])


def test_compute_partials_matches(cpu):
    jm = jfea.create_unit_square_mesh(5)
    m = mesh_from_jax(jm)
    for wrt in ("u", "f"):
        g = utils.compute_partials(_partials_form(tfea, m, 4), wrt)
        jg = jutils.compute_partials(_partials_form(jfea, jm, 4), wrt)
        assert _rel(_np(g), jg) <= 1e-13
    # values= replaces a coefficient
    vals = {"f": torch.ones(m.n_cells, dtype=torch.float64)}
    g = tfea.compute_partials(_partials_form(tfea, m, 4), "u", vals)
    jg = jfea.compute_partials(_partials_form(jfea, jm, 4), "u",
                               {"f": jnp.ones(jm.n_cells)})
    assert _rel(_np(g), jg) <= 1e-13
    assert utils.assemble_partials is utils.compute_partials


def test_node_and_polar_lookups_match(cpu):
    rng = np.random.default_rng(1)
    coords = rng.uniform(size=(50, 2))
    pts = rng.uniform(size=(7, 2))
    np.testing.assert_array_equal(utils.findNodeIndices(coords, pts),
                                  jutils.findNodeIndices(coords, pts))
    jm = jfea.create_annulus_mesh(4, 24, 0.5, 1.0)
    m = mesh_from_jax(jm)
    for ncomp in (1, 2):
        V = tfea.FunctionSpace(m, ("CG", 1), ncomp=ncomp)
        jV = jfea.FunctionSpace(jm, ("CG", 1), ncomp=ncomp)
        for kw in (dict(), dict(angle_range=(0.0, np.pi / 2)),
                   dict(component=1) if ncomp == 2 else dict()):
            for r in (0.5, 1.0):
                got = utils.locateDOFs(V, r, **kw)
                want = jutils.locateDOFs(jV, r, **kw)
                assert got.dtype == want.dtype and len(got) > 0
                np.testing.assert_array_equal(got, want)


def test_move_matches(cpu):
    jm = jfea.create_unit_square_mesh(4)
    jm.mark_boundary_facets(3)
    m = mesh_from_jax(jm)
    d = np.random.default_rng(2).standard_normal((m.n_nodes, 2)) * 1e-2
    for disp, jdisp in ((d, d), (torch.as_tensor(d.reshape(-1)),
                                 d.reshape(-1)),
                        (lambda x: 0.1 * x ** 2, lambda x: 0.1 * x ** 2)):
        out, jout = utils.move(m, disp), jutils.move(jm, jdisp)
        np.testing.assert_array_equal(out.coords, jout.coords)
        np.testing.assert_array_equal(out.cells, jout.cells)
        np.testing.assert_array_equal(out.facet_tags, jout.facet_tags)
        assert out is not m and np.array_equal(m.coords, jm.coords)


def test_fea_public_names():
    """Every public name of femo_tpu.fea exists in femo_tpu_torch.fea,
    aliases included, and the package imports neither h5py nor
    matplotlib."""
    def public(mod):
        return {n for n in dir(mod) if not n.startswith("_")}

    missing = public(jfea) - public(tfea)
    assert not missing, sorted(missing)
    for alias, name in (("createUnitSquareMesh", "create_unit_square_mesh"),
                        ("createIntervalMesh", "create_interval_mesh"),
                        ("createRectangleMesh", "create_rectangle_mesh"),
                        ("errorNorm", "error_norm"),
                        ("findNodeIndices", "find_node_indices"),
                        ("locateDOFs", "locate_dofs_polar")):
        assert getattr(tfea, alias) is getattr(tfea, name)
    res = subprocess.run(
        [sys.executable, "-c",
         "import sys, femo_tpu_torch.fea, femo_tpu_torch.compat\n"
         "heavy = [m for m in ('h5py', 'matplotlib') if m in sys.modules]\n"
         "assert not heavy, heavy\n"],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr


# -- compat on W1 at nel=4 ------------------------------------------------------

def test_compat_on_w1(cpu):
    fea, d = build_fea(nel=4)
    jfea_, jd = jbuild_fea(nel=4)
    src = np.random.default_rng(5).standard_normal(d["W"].n_dofs)
    compat.setFuncArray(d["f"], src)
    jcompat.setFuncArray(jd["f"], src)
    np.testing.assert_array_equal(compat.getFuncArray(d["f"]),
                                  jcompat.getFuncArray(jd["f"]))
    fea.solve("u", {"f": d["f"].array})
    jfea_.solve("u", {"f": jd["f"].array})
    assert _rel(compat.getFuncArray(d["u"]),
                jcompat.getFuncArray(jd["u"])) <= 1e-12
    compat.update(d["u"], compat.getFuncArray(d["u"]) * 2)
    jcompat.update(jd["u"], jcompat.getFuncArray(jd["u"]) * 2)
    res = fea.states_dict["u"]["residual_form"]
    jres = jfea_.states_dict["u"]["residual_form"]
    assert _rel(compat.getFormArray(res),
                jcompat.getFormArray(jres)) <= 1e-12
    obj = fea.outputs_dict["l2_functional"]["form"]
    jobj = jfea_.outputs_dict["l2_functional"]["form"]
    assert _rel(_np(compat.computePartials(obj, "f")),
                jcompat.computePartials(jobj, "f")) <= 1e-12
    VV = compat.VectorFunctionSpace(d["mesh"], ("CG", 1))
    jVV = jcompat.VectorFunctionSpace(jd["mesh"], ("CG", 1))
    assert (VV.n_dofs, VV.ncomp) == (jVV.n_dofs, jVV.ncomp)
    for name in ("FEA", "FunctionSpace", "Simulator", "FEAModel", "SLSQP",
                 "LBFGSB", "XDMFFile", "Recorder", "import_mesh",
                 "LinearSolver", "solveNonlinear", "createUnitSquareMesh"):
        assert hasattr(compat, name), name


# -- projection, factorization ---------------------------------------------------

def test_project_consistent_mass_matches(cpu):
    jm = jfea.create_unit_square_mesh(6)
    m = mesh_from_jax(jm)

    def setup(F, mesh):
        V = F.FunctionSpace(mesh, ("CG", 1))
        W = F.FunctionSpace(mesh, ("DG", 0))
        q = F.Function(W, "q").interpolate(lambda x: np.sin(3 * x[0])
                                           + x[1] ** 2)
        form = F.FormDef([F.dx(lambda w, g: w.q * w.v)], coeffs=[q],
                         test=V)
        return form, V, {"q": q.array}

    form, V, vals = setup(tfea, m)
    jform, jV, jvals = setup(jfea, jm)
    for lump in (True, False):
        p = project_form(form, V, vals, lump_mass=lump)
        jp = jproject_form(jform, jV, jvals, lump_mass=lump)
        assert _rel(_np(p), jp) <= 1e-10
    # the consistent projection of a CG1 function is that function
    u = tfea.Function(V, "u").interpolate(lambda x: x[0] - 2 * x[1])
    f2 = tfea.FormDef([tfea.dx(lambda w, g: w.u * w.v)], coeffs=[u], test=V)
    assert _rel(_np(project_form(f2, V, {"u": u.array}, lump_mass=False)),
                _np(u.array)) <= 1e-10


def _convection(F, mesh, assemble, bcs, DBC, **kw):
    V = F.FunctionSpace(mesh, ("CG", 1), **kw)
    u = F.Function(V, "u")
    A = assemble(F.FormDef([F.dx(
        lambda w, g: F.dot(F.grad(w.u), F.grad(w.v)) + w.u * w.v
        + 3.0 * (F.grad(w.u)[0] + 0.5 * F.grad(w.u)[1]) * w.v)],
        coeffs=[u], test=V), "u")
    free, _ = bcs([DBC(V, 0.0, where=lambda x: np.isclose(x[0], 0))],
                  V.n_dofs, **kw)
    return A, free


@pytest.mark.parametrize("refine", [0, 1])
def test_block_tridiag_factorization_refined(cpu, refine):
    jm = jfea.create_unit_square_mesh(8)
    jA, jfree = _convection(jfea, jm, jfea.assemble_matrix, jfea.bc_arrays,
                            jfea.DirichletBC)
    A, free = _convection(tfea, mesh_from_jax(jm), tfea.assemble_matrix,
                          tfea.bc_arrays, tfea.DirichletBC, device="cpu")
    fac = BlockTridiagFactorization(A, free, refine=refine)
    jfac = JBTFactorization(jA, jfree, refine=refine)
    b = np.random.default_rng(7).standard_normal(len(free))
    x, jx = fac.solve(torch.as_tensor(b)), jfac.solve(jnp.asarray(b))
    xt, jxt = fac.solve_t(torch.as_tensor(b)), jfac.solve_t(jnp.asarray(b))
    assert _rel(_np(x), jx) <= 1e-12 and _rel(_np(xt), jxt) <= 1e-12
    assert _rel(_np(x), _np(xt)) > 1e-3  # the operator is not symmetric
    # each is the constrained solution (of A, of A^T)
    for sol, mv in ((x, A.matvec), (xt, A.rmatvec)):
        r = torch.where(free, mv(torch.where(free, sol, 0.0)), sol) \
            - torch.as_tensor(b)
        assert float(torch.linalg.norm(r)) <= 1e-11 * np.linalg.norm(b)


# -- XDMF --------------------------------------------------------------------------

def _fields(F, mesh):
    V = F.FunctionSpace(mesh, ("CG", 1))
    VV = F.FunctionSpace(mesh, ("CG", 1), ncomp=2)
    W = F.FunctionSpace(mesh, ("DG", 0))
    return [F.Function(V, "u").interpolate(lambda x: x[0] + 2 * x[1]),
            F.Function(VV, "disp").interpolate(
                lambda x: np.stack([x[1], -x[0] ** 2])),
            F.Function(W, "rho").interpolate(lambda x: 1 + x[0] * x[1])]


def _h5(path):
    import h5py

    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda n, o: out.__setitem__(n, o[()])
                     if isinstance(o, h5py.Dataset) else None)
    return out


def _same_files(a, b):
    assert open(a + ".xdmf").read() == open(b + ".xdmf").read()
    ha, hb = _h5(a + ".h5"), _h5(b + ".h5")
    assert sorted(ha) == sorted(hb)
    for k in ha:
        assert ha[k].dtype == hb[k].dtype and ha[k].shape == hb[k].shape, k
        np.testing.assert_array_equal(ha[k], hb[k])


@pytest.mark.parametrize("cell_type", ["triangle", "quad"])
def test_xdmf_writer_matches(cpu, tmp_path, cell_type):
    jm = jfea.create_unit_square_mesh(3, cell_type=cell_type)
    m = mesh_from_jax(jm)
    for root, F, mesh, W in ((tmp_path / "port", tfea, m, XDMFWriter),
                             (tmp_path / "jax", jfea, jm, JXDMFWriter)):
        with W(str(root / "out.xdmf"), mesh) as x:
            for t, f in enumerate(_fields(F, mesh)):
                x.write_function(f, t=t)
            f.array = f.array * 2
            x.write(f, t=3)
        with W(str(root / "mesh_only.xdmf"), mesh) as x:
            x.write_mesh(mesh)
    for name in ("out", "mesh_only"):
        _same_files(str(tmp_path / "port" / name),
                    str(tmp_path / "jax" / name))


def test_recorder_matches(cpu, tmp_path):
    jm = jfea.create_unit_square_mesh(3)
    m = mesh_from_jax(jm)
    for root, F, mesh, R in ((tmp_path / "port", tfea, m, Recorder),
                             (tmp_path / "jax", jfea, jm, JRecorder)):
        u, disp, _ = _fields(F, mesh)
        rec = R(str(root))
        for it in range(3):
            u.array = u.array + 1.0
            rec.write("u", u, it)
            rec.write("disp", disp, it)
        rec.close()
    for name in ("record_u", "record_disp"):
        _same_files(str(tmp_path / "port" / name),
                    str(tmp_path / "jax" / name))


# -- checkpoints across the packages ---------------------------------------------

def _w1_sim(build, FM, S, P, val):
    fea, d = build(nel=4)
    model = FM(fea=[fea])
    model.create_input("f", shape=d["W"].n_dofs, val=val)
    model.add_design_variable("f")
    model.add_objective("l2_functional")
    sim = S(model)
    return sim, P(sim), fea


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoint_read_by_the_other_package(cpu, tmp_path, writer):
    port = (build_fea, FEAModel, Simulator, OptimizationProblem)
    jax_ = (jbuild_fea, JFEAModel, JSimulator, JProblem)
    src, dst = (port, jax_) if writer == "port" else (jax_, port)
    save = save_checkpoint if writer == "port" else jsave_checkpoint
    load = jload_checkpoint if writer == "port" else load_checkpoint
    sim, prob, fea = _w1_sim(*src, 0.3)
    sim.run()
    fea.opt_iter = 4
    prob.history.append({"obj": 1.23, "time": 0.0})
    path = str(tmp_path / "ck" / "opt.npz")
    save(path, sim, prob, extra={"note": 7})
    sim2, prob2, fea2 = _w1_sim(*dst, 0.0)
    extras = load(path, sim2, prob2)
    np.testing.assert_allclose(_np(sim2.values["f"]), 0.3)
    np.testing.assert_array_equal(
        _np(fea2.states_dict["u"]["function"].array),
        _np(fea.states_dict["u"]["function"].array))
    assert fea2.opt_iter == 4
    assert prob2.history[0]["obj"] == pytest.approx(1.23)
    assert int(extras["note"]) == 7
    with np.load(path) as data:
        assert set(data.files) == {"value/f", "state/u", "opt_iter",
                                   "history/obj", "extra/note"}


# -- profiling ---------------------------------------------------------------------

def test_timers_and_profile(tmp_path, capsys):
    with Timer("Solve nonlinear") as t:
        sum(range(1000))
    assert "Solve nonlinear finished in" in capsys.readouterr().out
    assert t.elapsed > 0
    with Timer("quiet", report=False, sync=False):
        pass
    assert capsys.readouterr().out == ""

    st = StageTimers()
    for _ in range(2):
        with st.stage("assembly"):
            sum(range(100))
    assert st.counts["assembly"] == 2 and st.totals["assembly"] > 0
    st.report()
    assert "assembly" in capsys.readouterr().out

    fn = str(tmp_path / "prof")

    @profile(fn)
    def work():
        return sum(range(10000))

    assert work() == sum(range(10000))
    assert any(f.startswith("prof.") for f in os.listdir(tmp_path))

    with device_trace(str(tmp_path / "trace")):
        torch.ones(8) @ torch.ones(8)
    assert any(f.endswith(".json")
               for f in os.listdir(tmp_path / "trace"))


# -- the port imports neither jax nor femo_tpu ----------------------------------

def test_no_module_of_the_port_imports_jax():
    """Every module under femo_tpu_torch (walk_packages: examples/, io/,
    utils/ and tools/ included) imported in one fresh process, then
    neither jax nor femo_tpu is in sys.modules."""
    code = (
        "import pkgutil, sys, femo_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "femo_tpu_torch.__path__, 'femo_tpu_torch.')]\n"
        "for n in names:\n"
        "    __import__(n)\n"
        "need = {'femo_tpu_torch.examples.run_motor_opt', "
        "'femo_tpu_torch.io.xdmf', 'femo_tpu_torch.utils.checkpoint', "
        "'femo_tpu_torch.graph.dashboard', 'femo_tpu_torch.compat'}\n"
        "assert need <= set(names), need - set(names)\n"
        "bad = [m for m in sys.modules if m in ('jax', 'femo_tpu') or "
        "m.startswith(('jax.', 'jaxlib', 'femo_tpu.'))]\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) == len(list(pkgutil.walk_packages(
        femo_tpu_torch.__path__, "femo_tpu_torch.")))
