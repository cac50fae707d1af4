"""Parity of the port's SpMV (femo_tpu_torch/ops/spmv.py) with the JAX
package on the CG1 stiffness of the nel=8 unit square, f64, CPU.

The plain versions of K3/K4/K5 (what CPU tensors run) and the element
matrix's matvec/rmatvec are held to the JAX package's ElementMatrix and
to the Pallas kernels of experiments/pallas_spmv.py run as the JAX
package runs them on the CPU (interpret mode), at 1e-12: the same
products summed in another order.  The K4 row-owner maps, which only the
CUDA kernel reads, are checked by replaying the kernel's loop in numpy.
"""

import importlib.util
import os

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from femo_tpu.fea import (
    FormDef as JFormDef, Function as JFunction, FunctionSpace as JSpace,
    assemble_matrix as jassemble_matrix, create_unit_square_mesh as jmesh_fn,
    dot as jdot, dx as jdx, grad as jgrad)
from femo_tpu.solvers.krylov import cg as jcg

from femo_tpu_torch.fea.assemble import assemble_matrix
from femo_tpu_torch.fea.forms import FormDef, dot, dx, grad
from femo_tpu_torch.fea.space import Function, FunctionSpace
from femo_tpu_torch.mesh.generators import create_unit_square_mesh
from femo_tpu_torch.ops import spmv
from femo_tpu_torch.solvers.krylov import cg

torch.set_num_threads(1)

TOL = 1e-12
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name, *path):
    """A script of the repo (not a package module) as a module."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, *path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


@pytest.fixture(scope="module")
def ops():
    jV = JSpace(jmesh_fn(8), ("CG", 1))
    ju = JFunction(jV, "u")
    jA = jassemble_matrix(
        JFormDef([jdx(lambda w, g: jdot(jgrad(w.u), jgrad(w.v)))],
                 coeffs=[ju], test=jV), "u")
    V = FunctionSpace(create_unit_square_mesh(8), ("CG", 1), device="cpu")
    u = Function(V, "u")
    A = assemble_matrix(
        FormDef([dx(lambda w, g: dot(grad(w.u), grad(w.v)))], coeffs=[u],
                test=V), "u")
    rng = np.random.default_rng(0)
    x = rng.normal(size=V.n_dofs)
    return dict(jA=jA, A=A, x=x, n=V.n_dofs,
                ps=_load("pallas_spmv", "experiments", "pallas_spmv.py"),
                free=~np.isin(np.arange(V.n_dofs), V.locate_dofs_geometrical(
                    lambda p: np.isclose(p[0], 0) | np.isclose(p[0], 1))))


def test_element_blocks_match_jax(ops):
    jb, b = ops["jA"].blocks[0], ops["A"].blocks[0]
    assert _rel(b.A.numpy(), jb.A) < TOL
    np.testing.assert_array_equal(b.rows.numpy(), np.asarray(jb.rows))
    np.testing.assert_array_equal(b.cols.numpy(), np.asarray(jb.cols))


@pytest.mark.parametrize("transpose", [False, True])
def test_element_matvec_matches_jax(ops, transpose):
    x = ops["x"]
    if transpose:
        y, y_ref = ops["A"].rmatvec(torch.as_tensor(x)), \
            ops["jA"].rmatvec(jnp.asarray(x))
    else:
        y, y_ref = ops["A"].matvec(torch.as_tensor(x)), \
            ops["jA"].matvec(jnp.asarray(x))
    assert _rel(y.numpy(), y_ref) < TOL


def test_element_plain_matches_pallas_interpret(ops):
    b0 = ops["jA"].blocks[0]
    y_pl = ops["ps"].element_spmv_pallas(
        b0.A, b0.cols, jnp.asarray(ops["x"]), ops["n"], b0.rows,
        interpret=True)
    b = ops["A"].blocks[0]
    y = spmv.element_spmv_plain(b.A, b.rows, b.cols,
                                torch.as_tensor(ops["x"]), ops["n"])
    assert _rel(y.numpy(), y_pl) < TOL


def test_diagonal_and_dense_match_jax(ops):
    assert _rel(ops["A"].diagonal().numpy(), ops["jA"].diagonal()) < TOL
    assert _rel(ops["A"].to_dense().numpy(), ops["jA"].to_dense()) < TOL
    Ac, jAc = ops["A"].to_scipy_csr(), ops["jA"].to_scipy_csr()
    np.testing.assert_array_equal(Ac.indptr, jAc.indptr)
    np.testing.assert_array_equal(Ac.indices, jAc.indices)
    assert _rel(Ac.data, jAc.data) < TOL


@pytest.mark.parametrize("transpose", [False, True])
def test_k4_owner_maps_replay_the_product(ops, transpose):
    """Replay K4/K4T's loop (one output row per thread, its slots in
    order) in numpy from the plan's int32 maps."""
    b = ops["A"].blocks[0]
    m = b.plan.maps()
    for k in ("rows", "cols", "row_ptr", "row_slot", "col_ptr", "col_slot"):
        assert m[k].dtype == torch.int32
    A = b.A.numpy()
    ne, nr, nc = A.shape
    x = ops["x"]
    ptr, slot, idx = ((m["col_ptr"], m["col_slot"], m["rows"]) if transpose
                      else (m["row_ptr"], m["row_slot"], m["cols"]))
    ptr, slot, idx = ptr.numpy(), slot.numpy(), idx.numpy()
    y = np.zeros(len(ptr) - 1)
    for i in range(len(y)):
        assert np.all(np.diff(slot[ptr[i]:ptr[i + 1]]) > 0)
        for s in slot[ptr[i]:ptr[i + 1]]:
            if transpose:
                e, c = divmod(s, nc)
                y[i] += sum(A[e, k, c] * x[idx[e, k]] for k in range(nr))
            else:
                e, r = divmod(s, nr)
                y[i] += sum(A[e, r, k] * x[idx[e, k]] for k in range(nc))
    ref = (ops["A"].rmatvec if transpose else ops["A"].matvec)(
        torch.as_tensor(x)).numpy()
    assert _rel(y, ref) < TOL


def test_ell_matches_jax_and_pallas_interpret(ops):
    ps = ops["ps"]
    jvals, jcols = ps.ell_from_element_matrix(ops["jA"])
    vals, cols = spmv.ell_from_element_matrix(ops["A"])
    assert cols.dtype == torch.int32
    np.testing.assert_array_equal(cols.numpy(), np.asarray(jcols))
    assert _rel(vals.numpy(), jvals) < TOL
    x = torch.as_tensor(ops["x"])
    y = spmv.ell_spmv(vals, cols, x)
    assert _rel(y.numpy(), ps.ell_spmv_reference(
        jvals, jcols, jnp.asarray(ops["x"]))) < TOL
    assert _rel(y.numpy(), ps.ell_spmv_pallas(
        jvals, jcols, jnp.asarray(ops["x"]), interpret=True)) < TOL
    assert _rel(spmv.ELLOperator(ops["A"]).matvec(x).numpy(),
                ops["jA"].matvec(jnp.asarray(ops["x"]))) < TOL


@pytest.mark.parametrize("constrained", [False, True])
def test_banded_matches_jax_and_pallas_interpret(ops, constrained):
    ps = ops["ps"]
    free = ops["free"] if constrained else None
    jband, jb, jperm = ps.banded_from_element_matrix(ops["jA"], free=free)
    band, b, perm = spmv.banded_from_element_matrix(ops["A"], free=free)
    assert b == jb
    np.testing.assert_array_equal(perm, jperm)
    assert _rel(band.numpy(), jband) < TOL
    xp = ops["x"][perm]
    y = spmv.banded_spmv(band, torch.as_tensor(xp), b)
    assert _rel(y.numpy(), ps.banded_spmv_pallas(
        jband, jnp.asarray(xp), jb, interpret=True)) < TOL
    if not constrained:
        y_ref = np.asarray(ops["jA"].matvec(jnp.asarray(ops["x"])))
        assert _rel(y.numpy(), y_ref[perm]) < TOL


def _replay_k5(plan, x, n, b):
    """K5's loop in numpy, in f64, from the plan's arrays: per tile, per
    lane (row 32 t + r), the tile's segments in order, x zero outside
    [0, n)."""
    ptr, diag = plan.tile_ptr.numpy(), plan.diag.numpy()
    vals = plan.vals.numpy().astype(np.float64)
    T = spmv.TILE
    y = np.zeros((len(ptr) - 1) * T)
    for t in range(len(ptr) - 1):
        assert np.all(np.diff(diag[ptr[t]:ptr[t + 1]]) > 0)
        for r in range(T):
            for j in range(ptr[t], ptr[t + 1]):
                col = t * T + r + diag[j] - b
                if 0 <= col < n:
                    y[t * T + r] += vals[j, r] * x[col]
    return y[:n]


def _check_plan(band, b, x):
    """Build the plan on CPU tensors, check its layout, replay it and hold
    it to the plain dense product (in f64) at TOL."""
    n, nd = band.shape
    plan = spmv.BandedSpMVPlan(torch.as_tensor(band), b)
    assert plan.tile_ptr.dtype == plan.diag.dtype == torch.int32
    assert plan.vals.dtype == torch.as_tensor(band).dtype
    T = spmv.TILE
    n_tiles = -(-n // T)
    assert plan.vals.shape == (len(plan.diag), T)
    # the segments are exactly the (tile, d) whose values are not all zero
    pad = np.zeros((n_tiles * T, nd), bool)
    pad[:n] = band != 0
    want = np.nonzero(pad.reshape(n_tiles, T, nd).any(1))
    ptr = plan.tile_ptr.numpy()
    np.testing.assert_array_equal(np.repeat(np.arange(n_tiles),
                                            np.diff(ptr)), want[0])
    np.testing.assert_array_equal(plan.diag.numpy(), want[1])
    assert int((plan.vals != 0).sum()) == int((band != 0).sum())
    y = _replay_k5(plan, x, n, b)
    y_ref = spmv.banded_spmv_plain(torch.as_tensor(band, dtype=torch.float64),
                                   torch.as_tensor(x), b).numpy()
    assert _rel(y, y_ref) < TOL


@pytest.mark.parametrize("constrained", [False, True])
def test_k5_plan_replays_the_product(ops, constrained):
    """K5's segment plan of the nel=8 RCM band, replayed as the kernel's
    loop, against the plain dense product."""
    free = ops["free"] if constrained else None
    band, b, perm = spmv.banded_from_element_matrix(ops["A"], free=free)
    _check_plan(band.numpy(), b, ops["x"][perm])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_k5_plan_edge_cases(dtype):
    """K5's plan of synthetic bands: ragged last tiles, b = 0, 1 and
    n - 1, whole diagonals zero in some tiles, an all-zero row."""
    synthetic_band = _load("chip_smoke", "chip_smoke.py").synthetic_band
    rng = np.random.default_rng(5)
    for n in (1, 31, 32, 33, 100):
        for b in sorted({0, 1, n - 1}):
            band = synthetic_band(n, b, rng).astype(dtype)
            _check_plan(band, b, rng.standard_normal(n))
    with pytest.raises(ValueError, match="2b\\+1"):
        spmv.BandedSpMVPlan(torch.zeros((4, 3)), 2)


def test_cg_through_the_ell_operator(ops):
    """The self-test's CG (experiments/pallas_spmv.py:313-320): the ELL
    operator shifted to SPD, solved to 1e-10, against the JAX solve."""
    op = spmv.ELLOperator(ops["A"])
    rng = np.random.default_rng(1)
    b = rng.normal(size=ops["n"])
    res = cg(lambda v: op.matvec(v) + v, torch.as_tensor(b), rtol=1e-10)
    assert res.converged
    r = b - (op.matvec(res.x) + res.x).numpy()
    assert np.linalg.norm(r) < 1e-8 * np.linalg.norm(b)
    jop = ops["ps"].PallasELLOperator(ops["jA"], interpret=True)
    jres = jcg(lambda v: jop.matvec(v) + v, jnp.asarray(b), rtol=1e-10)
    assert res.iters == int(jres.iters)
    assert _rel(res.x.numpy(), jres.x) < 1e-10


def test_cuda_wrappers_refuse_cpu_tensors(ops):
    """A *_cuda wrapper takes CUDA tensors only and counts nothing else;
    the dispatching entry points take the plain versions on CPU
    tensors."""
    before = dict(spmv.launches)
    b = ops["A"].blocks[0]
    x = torch.as_tensor(ops["x"])
    vals, cols = spmv.ell_from_element_matrix(ops["A"])
    band, bw, _ = spmv.banded_from_element_matrix(ops["A"])
    with pytest.raises(ValueError, match="CUDA"):
        spmv.element_spmv_cuda(b.A, b.plan, x)
    with pytest.raises(ValueError, match="CUDA"):
        spmv.element_rspmv_cuda(b.A, b.plan, x)
    with pytest.raises(ValueError, match="CUDA"):
        spmv.ell_spmv_cuda(vals, cols, x)
    with pytest.raises(ValueError, match="CUDA"):
        spmv.banded_spmv_cuda(spmv.BandedSpMVPlan(band, bw), x)
    ops["A"].matvec(x), ops["A"].rmatvec(x)
    spmv.ell_spmv(vals, cols, x), spmv.banded_spmv(band, x, bw)
    assert spmv.launches == before
