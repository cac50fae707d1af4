"""Parity of the port's SpMV (femo_tpu_torch/ops/spmv.py) with the JAX
package on the CG1 stiffness of the nel=8 unit square, f64, CPU.

The plain versions of K3/K4/K5 (what CPU tensors run) and the element
matrix's matvec/rmatvec are held to the JAX package's ElementMatrix and
to the Pallas kernels of experiments/pallas_spmv.py run as the JAX
package runs them on the CPU (interpret mode), at 1e-12: the same
products summed in another order.  The K4 owner maps, which only the
CUDA kernels read, are checked by replaying each design's arithmetic in
numpy: the row-owner loop, and the element-major products followed by
the owner-ordered sum, the latter also on a seeded rectangular 18 x 9
pattern (the shape of the FSI force-load operator's blocks).
"""

import importlib.util
import os

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from femo_tpu.fea.assemble import (
    ElementMatrix as JElementMatrix, MatBlock as JMatBlock)
from femo_tpu.fea import (
    FormDef as JFormDef, Function as JFunction, FunctionSpace as JSpace,
    assemble_matrix as jassemble_matrix, create_unit_square_mesh as jmesh_fn,
    dot as jdot, dx as jdx, grad as jgrad)
from femo_tpu.solvers.krylov import cg as jcg

from femo_tpu_torch.fea.assemble import (
    ElementMatrix, MatBlock, assemble_matrix)
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


def _vector_pattern(nr, nc, bs, seed=7):
    """Two seeded element blocks of nr x nc for a vector field of bs
    components numbered together (entry bs * node + c, as the FSI
    force-load operator's 18 x 9 blocks and W4's 8 x 8 are): rows among
    the components of 100 nodes, columns among those of 20, so each
    column is shared by several elements.  The torch ElementMatrix on the
    CPU and the JAX package's."""
    rng = np.random.default_rng(seed)
    n_rows, n_cols = 100 * bs, 20 * bs

    def ids(n_nodes, k):
        nodes = rng.choice(n_nodes, k // bs, replace=False)
        return (bs * nodes[:, None] + np.arange(bs)).reshape(-1)

    blocks = []
    for ne in (37, 11):
        rows = np.array([ids(100, nr) for _ in range(ne)])
        cols = np.array([ids(20, nc) for _ in range(ne)])
        blocks.append((rng.standard_normal((ne, nr, nc)), rows, cols))
    A = ElementMatrix([MatBlock(torch.as_tensor(a), torch.as_tensor(r),
                                torch.as_tensor(c)) for a, r, c in blocks],
                      n_rows, n_cols)
    jA = JElementMatrix([JMatBlock(jnp.asarray(a), jnp.asarray(r),
                                   jnp.asarray(c)) for a, r, c in blocks],
                        n_rows, n_cols)
    return A, jA


def _replay_element_major(A, m, v, transpose, out=None):
    """K4/K4T design 1 in numpy from the plan's int32 maps: the gathered
    side's values from its nodes (bs consecutive entries each), each
    element's products summed over k in increasing order and stored at
    their owner-ordered place dest, then each output's run of partials
    summed in order, added into `out` when it is given."""
    own, gat = ("col", "row") if transpose else ("row", "col")
    nodes, bs = m[f"{gat}_nodes"].numpy(), m[f"{gat}_bs"]
    ptr, slot, dest = (m[f"{own}_{k}"].numpy()
                       for k in ("ptr", "slot", "dest"))
    np.testing.assert_array_equal(dest[slot], np.arange(slot.size))
    ne, ni = nodes.shape[0], nodes.shape[1] * bs
    idx = (bs * nodes[:, :, None] + np.arange(bs)).reshape(ne, ni)
    np.testing.assert_array_equal(idx, m[f"{gat}s"].numpy())
    Ak = A.transpose(0, 2, 1) if transpose else A  # (ne, products, k)
    prod = np.zeros(Ak.shape[:2])
    for k in range(ni):
        prod = prod + Ak[:, :, k] * v[idx[:, k]][:, None]
    part = np.empty(prod.size)
    part[dest] = prod.reshape(-1)
    y = np.zeros(len(ptr) - 1)
    for i in range(len(y)):
        assert np.all(np.diff(slot[ptr[i]:ptr[i + 1]]) > 0)
        for s in range(ptr[i], ptr[i + 1]):
            y[i] += part[s]
    return y if out is None else out + y


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("pattern", ["w1", "rect18x9", "quad8x8"])
def test_k4_element_major_replays_the_product(ops, pattern, transpose):
    """K4/K4T's element-major design replayed in numpy from the plans'
    maps, block after block into one output (the kernels' accumulate
    mode), against the plain versions and the JAX package's
    matvec/rmatvec: on the W1 fixture (scalar, bs 1), a rectangular
    18 x 9 pattern of 3-component nodes and an 8 x 8 one of 2."""
    if pattern == "w1":
        A, jA, bs = ops["A"], ops["jA"], 1
    else:
        nr, nc, bs = (18, 9, 3) if pattern == "rect18x9" else (8, 8, 2)
        A, jA = _vector_pattern(nr, nc, bs)
    for b in A.blocks:
        m = b.plan.maps()
        assert m["row_bs"] == m["col_bs"] == bs
    n_rows, n_cols = A.shape
    v = np.random.default_rng(3).standard_normal(n_rows if transpose
                                                 else n_cols)
    y = None
    for b in A.blocks:
        m = b.plan.maps()
        part = b.plan.partials(torch.float64, transpose)
        assert part.shape == ((b.cols if transpose else b.rows).numel(),)
        y = _replay_element_major(b.A.numpy(), m, v, transpose, y)
    vt = torch.as_tensor(v)
    plain = sum((spmv.element_rspmv_plain(b.A, b.rows, b.cols, vt, n_cols)
                 if transpose else
                 spmv.element_spmv_plain(b.A, b.rows, b.cols, vt, n_rows))
                for b in A.blocks)
    ref = (jA.rmatvec if transpose else jA.matvec)(jnp.asarray(v))
    assert _rel(y, plain.numpy()) < TOL
    assert _rel(y, ref) < TOL
    assert _rel((A.rmatvec if transpose else A.matvec)(vt).numpy(),
                ref) < TOL


@pytest.mark.parametrize("nr, nc, transpose, itemsize, design", [
    (3, 3, False, 8, 0), (3, 3, True, 8, 0),    # W1: row-owner both ways
    (8, 8, False, 8, 0), (8, 8, True, 8, 1),    # W4: rows 64 B, columns not
    (18, 9, False, 8, 1), (18, 9, True, 8, 1),  # FSI's Fm: element-major
    (8, 8, True, 4, 1), (4, 4, True, 4, 0), (1, 1, True, 8, 0)])
def test_k4_design_rule(nr, nc, transpose, itemsize, design):
    """element_design: the row-owner kernel where one output's values of
    an element lie within 64 bytes, the element-major design otherwise."""
    assert spmv.element_design(nr, nc, transpose, itemsize) == design


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
