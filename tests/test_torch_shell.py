"""W6 parity: the port's Reissner-Mindlin shell (femo_tpu_torch/models/
shell.py and what it stands on: Lagrange dofmaps of degree 2, manifold
cells, composite states, the SPD and storage options of the
block-Thomas factor) against the JAX package, on CPU tensors in f64.

The JAX side's shell kernels take seconds to compile for each form and
step configuration, so the values of the JAX package at these sizes are
read from oracles/shell_oracle.npz (written by oracles/shell_oracle.py,
each entry beside its configuration); the dofmaps, the RBF maps and the
block-Thomas factors are held against the JAX package live.  Tolerances:
dofmaps equal; residuals and Jacobian blocks 1e-12 (max abs over max
abs); the compliance step within 10 times the JAX package's own spread
between its paths of the same kind (femo_tpu_torch/tools/shell_parity.py);
Lanczos frequencies 1e-8, dense ones within 10 times the JAX package's
own dense-vs-Lanczos spread.  On CPU tensors the sweeps run their plain
version.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax

jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp  # noqa: E402

from femo_tpu.fea.space import FunctionSpace as JSpace  # noqa: E402
from femo_tpu.mesh.generators import (  # noqa: E402
    create_rectangle_mesh as jrect)
from femo_tpu.mesh.mesh import Mesh as JMesh  # noqa: E402
from femo_tpu.models import coupling as jcoupling  # noqa: E402
from femo_tpu.ops import block_tridiag as jbt  # noqa: E402

from femo_tpu_torch.convert import array_from_jax  # noqa: E402
from femo_tpu_torch.fea.assemble import compile_form  # noqa: E402
from femo_tpu_torch.fea.bc import DirichletBC  # noqa: E402
from femo_tpu_torch.fea.composite import (  # noqa: E402
    CompositeState, composite_implicit_op)
from femo_tpu_torch.fea.space import FunctionSpace  # noqa: E402
from femo_tpu_torch.mesh.generators import create_rectangle_mesh  # noqa
from femo_tpu_torch.mesh.mesh import Mesh  # noqa: E402
from femo_tpu_torch.models import coupling  # noqa: E402
from femo_tpu_torch.models.shell import (  # noqa: E402
    RMShellModel, build_shell_jit_step, shell_modal_analysis)
from femo_tpu_torch.models.shell_module import (  # noqa: E402
    extract_cg2_vertex_displacements, plate_module)
from femo_tpu_torch.ops.block_tridiag import (  # noqa: E402
    BlockTridiagonalMatrix)
from femo_tpu_torch.tools.profile_step import (  # noqa: E402
    SHELL_LAYERS, layer_ranges)
from femo_tpu_torch.tools.shell_parity import (  # noqa: E402
    STEP_PATHS, path_kind, rel_l2, step_spread)

torch.set_num_threads(1)

ORACLE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "oracles", "shell_oracle.npz")
@pytest.fixture(scope="module")
def oracle():
    return np.load(ORACLE)


def entry(oracle, key, config):
    """The configuration of the oracle's entry `key`, checked to be
    `config`."""
    got = json.loads(str(oracle[f"{key}_config"]))
    assert got == json.loads(json.dumps(config)), (key, got)
    return got


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def coords3(m2, curved):
    c = m2.coords
    if curved:
        return np.stack([np.sin(c[:, 0]), c[:, 1], np.cos(c[:, 0])], axis=1)
    return np.concatenate([c, np.zeros((len(c), 1))], axis=1)


def plate(nx, ny, x1, y1, cell_type="triangle"):
    m2 = create_rectangle_mesh(nx, ny, 0, 0, x1, y1, cell_type=cell_type)
    return Mesh(coords3(m2, False), m2.cells, cell_type)


def roof(n, cell_type):
    R, L, phi_max = 25.0, 50.0, np.deg2rad(40.0)
    m2 = create_rectangle_mesh(n, n, -phi_max, 0.0, phi_max, L,
                               cell_type=cell_type)
    phi, y = m2.coords[:, 0], m2.coords[:, 1]
    return Mesh(np.stack([R * np.sin(phi), y, R * np.cos(phi)], axis=1),
                m2.cells, cell_type)


@pytest.mark.parametrize("cell_type", ["triangle", "quad"])
@pytest.mark.parametrize("curved", [False, True], ids=["flat", "curved"])
def test_dofmaps_match_jax(cell_type, curved):
    """CG2 (P2 / Q2) vertex, edge and interior dofs in the JAX order, with
    their coordinates; CG1 and DG0 beside them."""
    m2 = jrect(5, 3, 0, 0, 1.0, 2.0, cell_type=cell_type)
    c3 = coords3(m2, curved)
    jm = JMesh(c3, m2.cells, cell_type)
    tm = Mesh(c3, m2.cells, cell_type)
    for spec, ncomp in ((("CG", 2), 3), (("CG", 2), 1), (("CG", 1), 3),
                        (("DG", 0), 1)):
        js = JSpace(jm, spec, ncomp=ncomp)
        ts = FunctionSpace(tm, spec, ncomp=ncomp, device="cpu")
        assert ts.n_dofs == js.n_dofs and \
            ts.n_scalar_dofs == js.n_scalar_dofs
        np.testing.assert_array_equal(ts.dofmap, js.dofmap)
        np.testing.assert_array_equal(ts.scalar_dof_coords,
                                      js.scalar_dof_coords)
        np.testing.assert_array_equal(ts.scalar_dof_kind, js.scalar_dof_kind)


@pytest.mark.parametrize("case", ["asm_plate", "asm_roof_triangle",
                                  "asm_roof_quad"])
def test_residual_and_jacobian_blocks_match_jax(oracle, case):
    """The two residual blocks and the four Jacobian blocks of the shell at
    a random state, on the (6, 8) plate and on 4 x 4 Scordelis-Lo roofs
    (triangles, and quads: Q2 with its interior dof): 1e-12."""
    c = entry(oracle, "assembly", dict(plate=[6, 8], roof=4, seed=0))
    mesh = (plate(*c["plate"], 1.0, 4.0) if case == "asm_plate"
            else roof(c["roof"], case.split("_")[-1]))
    shell = RMShellModel(mesh, E=7e10, nu=0.3, device="cpu")
    vals = {k: array_from_jax(oracle[f"{case}_in_{k}"], "cpu")
            for k in ("u", "theta", "thickness", "force")}
    for rname, form in (("u", shell.res_u), ("theta", shell.res_th)):
        cf = compile_form(form)
        r = cf.vector(vals).numpy()
        assert rel(r, oracle[f"{case}_r_{rname}"]) < 1e-12, rname
        for cname in ("u", "theta"):
            (blk,) = cf.matrix(vals, cname).blocks
            want = oracle[f"{case}_A_{rname}_{cname}"]
            assert rel(blk.A.numpy(), want) < 1e-12, (rname, cname)


def test_edge_load_ds_matches_jax(oracle):
    """The per-length edge traction on tagged boundary edges of a 2D cell
    in 3D (in-plane outward normal and edge measure): 1e-12."""
    c = entry(oracle, "edge", dict(n=[16, 2], L=10.0, b=1.0, t=0.1, E=1e6,
                                   seed=1))
    mesh = plate(*c["n"], c["L"], c["b"])
    mesh.mark_boundary_facets(1, predicate=lambda x: np.isclose(x[0],
                                                                c["L"]))
    shell = RMShellModel(mesh, E=c["E"], nu=0.0, edge_load_tag=1,
                         device="cpu")
    shell.thickness.set(c["t"])
    shell.edge_force.array = array_from_jax(oracle["edge_in_force"], "cpu")
    r = compile_form(shell.res_u).vector(shell.res_u.values()).numpy()
    assert rel(r, oracle["edge_r_u"]) < 1e-12


@pytest.mark.parametrize("name", list(STEP_PATHS))
def test_step_paths_match_jax(oracle, name):
    """build_shell_jit_step at (6, 8) in every configuration of
    tests/test_shell_step_paths.py against the JAX package's value of the
    same configuration, J and its gradient (relative L2), each within 10
    times the JAX package's own spread between its paths of the same kind
    (PCG-polished, direct or f32-stored; `step_spread`): two correct
    solves of this system differ by that much whatever the
    implementation, the JAX package's paths among themselves included."""
    kw = STEP_PATHS[name]
    entry(oracle, f"step_{name}", dict(kw, n_shell=[6, 8]))
    step, t0, info = build_shell_jit_step(n_shell=(6, 8), device="cpu", **kw)
    J, g = step(t0)
    sJ, sg = step_spread(oracle, path_kind(kw))
    rJ = abs(float(J) - float(oracle[f"step_{name}_J"])) / abs(
        float(oracle[f"step_{name}_J"]))
    rg = rel_l2(g.numpy(), oracle[f"step_{name}_grad"])
    print(f"{name}: J rel {rJ:.3e} (bar {10 * sJ:.3e}), gradient rel L2 "
          f"{rg:.3e} (bar {10 * sg:.3e})")
    assert rJ <= 10 * sJ and rg <= 10 * sg, (rJ, rg)
    assert info["n_dofs"] == 852 and info["n_cells"] == 96


def test_split_step_layers():
    """The split step's work, counted by the step profiler's shell layer
    ranges: one Jacobian, one fill, one factor shared by the forward and
    the adjoint, 2 + pcg_iters block solves in each."""
    step, t0, _ = build_shell_jit_step(n_shell=(4, 4), split_programs=True,
                                       pcg_iters=2, device="cpu")
    with layer_ranges(SHELL_LAYERS) as lr:
        step(t0)
    calls = lr.calls
    assert calls["composite.jacobian"] == 1 and calls["bt.fill"] == 1
    assert calls["bt.factor"] == 1 and calls["bt.solve"] == 2 * (2 + 2)
    assert calls["sweeps.K1"] == 0  # CPU tensors: no kernel launch


@pytest.fixture(scope="module")
def cantilever(oracle):
    """The 12 x 2 cantilever plate of tests/test_shell.py, solved with the
    default jit_bt op."""
    c = entry(oracle, "cantilever", dict(n=[12, 2], L=10.0, b=1.0, t=0.1,
                                         E=1e6, q=1e-3, n_modes=4))
    shell = RMShellModel(plate(*c["n"], c["L"], c["b"]), E=c["E"], nu=0.0,
                         device="cpu")
    shell.thickness.set(c["t"])
    farr = np.zeros(shell.Vf.n_dofs)
    farr[2::3] = -c["q"]
    shell.force.array = torch.as_tensor(farr)

    def clamp(x):
        return np.isclose(x[0], 0.0)

    bcs = [DirichletBC(shell.Vu, 0.0, where=clamp),
           DirichletBC(shell.Vth, 0.0, where=clamp)]
    state, op, x = shell.solve(bcs)
    return shell, bcs, state, op, x


def test_cantilever_solve_beam_theory_and_jax(oracle, cantilever):
    shell, _, state, _, x = cantilever
    w = shell.u.array.numpy().reshape(-1, 3)[:, 2]
    tip = np.argmax(shell.Vu.scalar_dof_coords[:, 0])
    w_exact = -1e-3 * 10.0**4 / (8 * 1e6 * 0.1**3 / 12)
    np.testing.assert_allclose(w[tip], w_exact, rtol=5e-3)
    assert rel_l2(x.numpy(), oracle["cant_x"]) < 1e-10
    np.testing.assert_array_equal(state.current().numpy(), x.numpy())


@pytest.mark.parametrize("mode", ["eager", "jit_dense"])
def test_cantilever_solve_modes(oracle, cantilever, mode):
    """RMShellModel.solve's other modes (host Newton with scipy's sparse
    LU; the dense LU) on the same cantilever, against the JAX package's
    jit_bt state: the energy estimate 2 (J - E), second order in the
    state's error, within 1e-12; the state, first order (another solver
    stops at another point of the f64 floor: measured 2-3e-10), within
    1e-8."""
    shell, bcs, state, _, _ = cantilever
    shell.u.set(0.0)
    shell.theta.set(0.0)
    _, _, x = shell.solve(bcs, solve_mode=mode)

    def energy_estimate(xx):
        return shell.energy_estimate(state, xx, shell.thickness.array,
                                     shell.force.array)[1]

    x_jax = torch.as_tensor(oracle["cant_x"])
    JE, JE_jax = energy_estimate(x), energy_estimate(x_jax)
    assert abs(JE - JE_jax) < 1e-12 * abs(JE_jax)
    assert rel_l2(x.numpy(), oracle["cant_x"]) < 1e-8


def test_composite_adjoint_matches_jax(oracle, cantilever):
    """d(compliance)/d(thickness) through the composite op's IFT adjoint
    against the JAX package's: 1e-10 on the value, 1e-8 on the
    gradient."""
    shell, _, state, op, _ = cantilever
    ccf = compile_form(shell.compliance_form)
    t = shell.thickness.array.clone().requires_grad_(True)
    x = op({"thickness": t}, state.current().detach())
    J = ccf.scalar({"u": state.split(x)["u"], "force": shell.force.array})
    (g,) = torch.autograd.grad(J, t)
    J = J.detach()
    assert abs(float(J) - float(oracle["cant_J"])) < 1e-10 * abs(
        float(oracle["cant_J"]))
    assert rel_l2(g.numpy(), oracle["cant_grad"]) < 1e-8


def test_modes_match_jax(oracle, cantilever):
    """Lanczos (1e-8) and dense frequencies of the cantilever against the
    JAX package's, the first bending frequency against beam theory, and
    each mode's direction (|cos| of each pair).  The dense `eigh` loses
    the fundamental's relative accuracy to the operator's conditioning
    (the JAX package's own dense and Lanczos fundamentals differ by
    7.7e-10), so the dense frequencies are held within 10 times the JAX
    package's own dense-vs-Lanczos spread."""
    shell, bcs, _, _, _ = cantilever
    f_d, m_d = shell_modal_analysis(shell, bcs, n_modes=4, method="dense")
    f_l, m_l = shell_modal_analysis(shell, bcs, n_modes=4, method="lanczos")
    jd, jl = oracle["cant_freqs_dense"], oracle["cant_freqs_lanczos"]
    spread = float(np.max(np.abs(jd - jl) / jl))
    np.testing.assert_allclose(f_d.numpy(), jd, rtol=10 * spread)
    np.testing.assert_allclose(f_l.numpy(), oracle["cant_freqs_lanczos"],
                               rtol=1e-8)
    f1_beam = (1.8751**2 / (2 * np.pi)) * np.sqrt(
        1e6 * 0.1**3 / 12 / (1.0 * 0.1 * 10.0**4))
    assert abs(float(f_d[0]) - f1_beam) / f1_beam < 0.03
    for j in range(4):
        for mine, theirs in ((m_d, "cant_modes_dense"),
                             (m_l, "cant_modes_lanczos")):
            a, b = mine[:, j].numpy(), oracle[theirs][:, j]
            c = abs(a @ b) / (np.linalg.norm(a) * np.linalg.norm(b))
            assert c > 1.0 - 1e-8, (theirs, j, c)


def spd_blocks(nb, B, seed):
    """A random SPD block-tridiagonal matrix (nb blocks of B)."""
    rng = np.random.default_rng(seed)
    n = nb * B
    R = rng.standard_normal((n, n)) / np.sqrt(n)
    mask = np.abs(np.arange(n)[:, None] - np.arange(n)[None, :]) < B
    A = (R @ R.T) * mask + 4.0 * np.eye(n)
    A = 0.5 * (A + A.T)
    blk = lambda i, j: A[i * B:(i + 1) * B, j * B:(j + 1) * B]  # noqa
    D = np.stack([blk(i, i) for i in range(nb)])
    L = np.stack([np.zeros((B, B))] + [blk(i, i - 1) for i in range(1, nb)])
    U = np.stack([blk(i, i + 1) for i in range(nb - 1)] + [np.zeros((B, B))])
    return D, L, U, rng.standard_normal(n)


@pytest.mark.parametrize("kind", ["inverse", "spd", "store_f32", "cholesky",
                                  "cholesky_f32"])
def test_block_factors_match_jax(kind):
    """BlockTridiagonalMatrix.factor's spd / store_dtype options
    and factor_spd's BlockCholeskyFactor against the JAX package's on a
    synthetic SPD block matrix (nb=4, B=32): solves 1e-12, the stored
    blocks 1e-12; the transpose factor too."""
    nb, B = 4, 32
    D, L, U, b = spd_blocks(nb, B, seed=3)
    perm = np.arange(nb * B)
    jm = jbt.BlockTridiagonalMatrix(jnp.asarray(D), jnp.asarray(L),
                                    jnp.asarray(U), perm, nb * B)
    tm = BlockTridiagonalMatrix(*(torch.as_tensor(a) for a in (D, L, U)),
                                perm, nb * B)
    jf, tf = {
        "inverse": (lambda m: m.factor(), lambda m: m.factor()),
        "spd": (lambda m: m.factor(spd=True), lambda m: m.factor(spd=True)),
        "store_f32": (lambda m: m.factor(jnp.float32),
                      lambda m: m.factor("float32")),
        "cholesky": (lambda m: m.factor_spd(), lambda m: m.factor_spd()),
        "cholesky_f32": (lambda m: m.factor_spd(jnp.float32),
                         lambda m: m.factor_spd(torch.float32)),
    }[kind]
    jfac, tfac = jf(jm), tf(tm)
    x_j = np.asarray(jfac.solve(jnp.asarray(b)))
    x_t = tfac.solve(torch.as_tensor(b)).numpy()
    assert rel(x_t, x_j) < 1e-12
    stored = ("Lc", "C") if kind.startswith("cholesky") else ("Sinv", "C")
    for name in stored:
        assert rel(getattr(tfac, name).numpy(),
                   np.asarray(getattr(jfac, name), np.float64)) < 1e-12
    if not kind.startswith("cholesky"):
        xt_j = np.asarray(jm.factor_t().solve(jnp.asarray(b)))
        assert rel(tm.factor_t().solve(torch.as_tensor(b)).numpy(),
                   xt_j) < 1e-12


def test_unported_factor_paths_raise():
    """factor(guard=True), the JAX package's low-precision rescue, leaves a
    healthy SPD chain's factor as it is (tests/test_torch_cr.py holds a
    rescue to the JAX package's), and the Cholesky-storage solve refuses
    a tensor off the CPU: no kernel computes its triangular sweep, and a
    solve on the card runs K1/K2 or raises."""
    nb, B = 2, 32
    D, L, U, b = spd_blocks(nb, B, seed=4)
    tm = BlockTridiagonalMatrix(*(torch.as_tensor(a) for a in (D, L, U)),
                                np.arange(nb * B), nb * B)
    g, p = tm.factor(guard=True), tm.factor()
    assert int(g.rescued) == 0
    assert torch.equal(g.Sinv, p.Sinv) and torch.equal(g.C, p.C)
    with pytest.raises(RuntimeError, match="CPU tensors only"):
        tm.factor_spd().solve(torch.empty(nb * B, dtype=torch.float64,
                                          device="meta"))


def test_composite_state_layout():
    """split/concat/push round trip, the BC masks on both fields and the
    pattern Jacobian's offsets against the assembled one."""
    shell = RMShellModel(plate(2, 3, 1.0, 2.0), E=7e10, nu=0.3,
                         device="cpu")
    bcs = [DirichletBC(shell.Vu, 0.0, where=lambda x: np.isclose(x[1], 0)),
           DirichletBC(shell.Vth, 0.0, where=lambda x: np.isclose(x[1], 0))]
    state = CompositeState([shell.u, shell.theta],
                           {"u": shell.res_u, "theta": shell.res_th}, bcs)
    n_u = shell.Vu.n_dofs
    x = torch.arange(state.n_dofs, dtype=torch.float64)
    parts = state.split(x)
    assert torch.equal(state.concat(parts), x)
    state.push(x)
    assert torch.equal(shell.theta.array, x[n_u:])
    free = state.free.numpy()
    assert not free[bcs[0].dofs].any() and not free[n_u + bcs[1].dofs].any()
    emat = state.jacobian(x, {})
    pat = state.jacobian_pattern()
    assert len(pat.blocks) == len(emat.blocks) == 4
    for bp, be in zip(pat.blocks, emat.blocks):
        np.testing.assert_array_equal(bp.rows, be.rows.numpy())
        np.testing.assert_array_equal(bp.cols, be.cols.numpy())
    K = emat.to_dense()
    assert torch.allclose(K, K.T, rtol=1e-10, atol=1e-12 * K.abs().max())
    op = composite_implicit_op(state, ["thickness"], mode="jit_dense")
    assert op.n_dofs == state.n_dofs


def test_cg2_vertex_extraction_and_nodal_map():
    """extract_cg2_vertex_displacements on the vertex-leading CG2 layout
    (and its refusal of a space without vertex dofs first), and the RBF
    nodal maps against the JAX package's (1e-14)."""
    mesh = plate(3, 4, 1.0, 2.0)
    V = FunctionSpace(mesh, ("CG", 2), ncomp=3, device="cpu")
    u = torch.arange(V.n_dofs, dtype=torch.float64)
    got = extract_cg2_vertex_displacements(V, u, mesh.n_nodes)
    assert torch.equal(got, u.reshape(-1, 3)[:mesh.n_nodes])
    with pytest.raises(ValueError):
        extract_cg2_vertex_displacements(
            FunctionSpace(mesh, ("DG", 0), device="cpu"),
            torch.zeros(mesh.n_cells), mesh.n_nodes)
    rng = np.random.default_rng(5)
    pts = np.concatenate([rng.random((7, 2)) * [1.0, 2.0],
                          0.1 * rng.random((7, 1))], axis=1)
    for kind in ("gaussian", "bump", "thin_plate"):
        jmap = jcoupling.NodalMap(mesh.coords, pts, kind=kind)
        tmap = coupling.NodalMap(mesh.coords, pts, kind=kind, device="cpu")
        assert tmap.eps == jmap.eps
        np.testing.assert_allclose(tmap.W.numpy(), np.asarray(jmap.W),
                                   rtol=0, atol=1e-14)
    d = rng.standard_normal((mesh.n_nodes, 3))
    np.testing.assert_allclose(
        tmap.map_displacements(torch.as_tensor(d)).numpy(),
        np.asarray(jmap.map_displacements(jnp.asarray(d))), atol=1e-13)


@pytest.mark.parametrize("entry", [
    lambda: build_shell_jit_step(n_shell=(2, 2)),
    lambda: RMShellModel(plate(2, 2, 1.0, 1.0), E=1.0, nu=0.3),
    lambda: plate_module(n_shell=(2, 2), n_aero=(2, 2)),
], ids=["build_shell_jit_step", "RMShellModel", "plate_module"])
def test_entry_points_default_to_the_card(entry):
    """device=None means the card: on a machine without one the shell's
    entry points raise instead of running on the CPU."""
    if torch.cuda.is_available():
        entry()
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry()
