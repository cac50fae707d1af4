"""The port's deterministic scatter (femo_tpu_torch/ops/scatter.py): the
owner-table sums against index_add and the JAX package's segment_sum,
f64, CPU, on a residual vector's pattern, the Jacobian's dense form and
the block-tridiagonal template fill of the W1 Poisson operator (1e-15);
the table's structure (every real slot exactly once); and the port's
copy of the native host source, which must stay byte-identical to the
JAX package's so that both packages share the RCM order.
"""

import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from femo_tpu.fea import (
    FormDef as JFormDef, Function as JFunction, FunctionSpace as JSpace,
    create_unit_square_mesh as jsquare, dot as jdot, dx as jdx,
    grad as jgrad)
from femo_tpu.fea.assemble import (
    ElementMatrix as JElementMatrix, MatBlock as JMatBlock,
    compile_form as jcompile)
from femo_tpu.ops.block_tridiag import BlockTridiagTemplate as JTemplate

from femo_tpu_torch import native
from femo_tpu_torch.fea.assemble import compile_form
from femo_tpu_torch.fea.forms import FormDef, dot, dx, grad
from femo_tpu_torch.fea.space import Function, FunctionSpace
from femo_tpu_torch.mesh.generators import create_unit_square_mesh
from femo_tpu_torch.ops.block_tridiag import BlockTridiagTemplate
from femo_tpu_torch.ops.scatter import OwnerTable

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEL = 5
TOL = 1e-15


def _max_rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _poisson(mod, nel, **kw):
    """(form, V, W) of -lap u + u^3 - f in one package (a nonlinear
    residual, so the Jacobian depends on u)."""
    mesh = (jsquare if mod == "jax" else create_unit_square_mesh)(nel)
    Sp, Fn, FD, d, g, dt = ((JSpace, JFunction, JFormDef, jdot, jgrad, jdx)
                            if mod == "jax" else
                            (FunctionSpace, Function, FormDef, dot, grad, dx))
    V = Sp(mesh, ("CG", 1), **kw)
    W = Sp(mesh, ("DG", 0), **kw)
    u, f = Fn(V, "u"), Fn(W, "f")
    form = FD([dt(lambda w, gg: d(g(w.u), g(w.v)) + w.u**3 * w.v
                  - w.f * w.v)], coeffs=[u, f], test=V)
    return form, V, W


@pytest.fixture(scope="module")
def w1():
    rng = np.random.default_rng(11)
    jform, jV, jW = _poisson("jax", NEL)
    form, V, W = _poisson("torch", NEL, device="cpu")
    u = rng.standard_normal(V.n_dofs)
    f = rng.standard_normal(W.n_dofs)
    jvals = {"u": jnp.asarray(u), "f": jnp.asarray(f)}
    tvals = {"u": torch.as_tensor(u), "f": torch.as_tensor(f)}
    return dict(jcf=jcompile(jform), cf=compile_form(form), jvals=jvals,
                tvals=tvals, n=V.n_dofs, rng=rng)


def test_vector_sum_matches_index_add_and_segment_sum(w1):
    """A seeded source over the residual's own pattern (the rows of every
    cell): owner table vs index_add vs segment_sum."""
    rows = w1["cf"].terms[0].host_rows("__test__").reshape(-1)
    vals = w1["rng"].standard_normal(len(rows))
    got = OwnerTable(rows, len(rows), w1["n"]).sum(torch.as_tensor(vals))
    ref = torch.zeros(w1["n"], dtype=torch.float64).index_add_(
        0, torch.as_tensor(rows), torch.as_tensor(vals))
    seg = jax.ops.segment_sum(jnp.asarray(vals), jnp.asarray(rows),
                              num_segments=w1["n"])
    assert _max_rel(got, ref) <= TOL
    assert _max_rel(got, seg) <= TOL
    # and the assembled residual itself against the JAX package's
    assert _max_rel(w1["cf"].vector(w1["tvals"]),
                    w1["jcf"].vector_jit()(w1["jvals"])) <= 1e-14


def test_to_dense_and_diagonal_match(w1):
    A = w1["cf"].matrix(w1["tvals"], "u")
    dense = A.to_dense()
    b = A.blocks[0]
    ne, nr, nc = b.A.shape
    ref = torch.zeros(A.shape, dtype=torch.float64).index_put(
        (b.rows[:, :, None].expand(ne, nr, nc).reshape(-1),
         b.cols[:, None, :].expand(ne, nr, nc).reshape(-1)),
        b.A.reshape(-1), accumulate=True)
    jA = JElementMatrix([JMatBlock(*blk) for blk in
                         w1["jcf"].matrix_blocks_jit("u")(w1["jvals"])],
                        *A.shape)
    assert _max_rel(dense, ref) <= TOL
    assert _max_rel(dense, jA.to_dense()) <= 1e-14
    assert _max_rel(A.diagonal(), jA.diagonal()) <= 1e-14
    # the matrix's tables are kept with the compiled form's pattern
    A2 = w1["cf"].matrix(w1["tvals"], "u")
    assert A2._cache is A._cache and "dense" in A2._cache
    assert torch.equal(A2.to_dense(), dense)


def test_template_fill_matches(w1):
    free = np.ones(w1["n"], bool)
    free[::7] = False
    tpl = BlockTridiagTemplate(w1["cf"].matrix_pattern("u"), free=free,
                               device="cpu")
    jtpl = JTemplate(w1["jcf"].matrix_pattern("u"), free=free)
    A = w1["cf"].matrix(w1["tvals"], "u")
    blocks = [(b.A, b.rows, b.cols) for b in A.blocks]
    D, L, U = tpl.fill(blocks)
    got = torch.stack([D, L, U]).reshape(-1)
    # the previous index_add fill from the same destination map
    vals = torch.cat([b.A.reshape(-1) for b in A.blocks])
    keep = tpl.dest != tpl.dest_size - 1
    ref = torch.zeros(tpl.dest_size - 1, dtype=torch.float64)
    ref.index_add_(0, tpl.dest[keep], vals[keep])
    ref.index_add_(0, tpl.diag_ids, torch.ones(len(tpl.diag_ids),
                                               dtype=torch.float64))
    jD, jL, jU = jtpl.fill([(jnp.asarray(b.A.numpy()), None, None)
                            for b in A.blocks])
    assert _max_rel(got, ref) <= TOL
    assert _max_rel(got, np.stack([jD, jL, jU]).reshape(-1)) <= TOL


@pytest.mark.parametrize("n_out", [40, None])
def test_every_slot_appears_once(n_out):
    """Each real source slot is in the table exactly once, in entry order
    per destination; the rest is the padding index n_src."""
    rng = np.random.default_rng(3)
    dest = rng.integers(0, 40, size=300) * (1 if n_out else 997)
    src = rng.permutation(350)[:300]
    tab = OwnerTable(dest, 350, n_out, src=src)
    t = tab.table.numpy()
    real = t[t != 350]
    np.testing.assert_array_equal(np.sort(real), np.sort(src))
    for j in range(t.shape[1]):
        d = tab.ids[j].item() if n_out is None else j
        np.testing.assert_array_equal(t[:, j][t[:, j] != 350],
                                      src[dest == d])
    vals = torch.as_tensor(rng.standard_normal(350))
    ref = np.zeros(40 if n_out else 40 * 997)
    np.add.at(ref, dest, vals.numpy()[src])
    got = tab.sum(vals).numpy()
    if n_out is None:
        np.testing.assert_array_equal(tab.ids.numpy(), np.unique(dest))
        ref = ref[np.unique(dest)]
    assert _max_rel(got, ref) <= TOL


def test_owner_sum_derivatives():
    """The written-out transpose (a gather from each source's destination)
    and forward derivative equal index_add's, under torch.autograd and the
    torch.func transforms; a source that feeds two destinations is
    refused."""
    rng = np.random.default_rng(5)
    dest = rng.integers(0, 30, size=200)
    src = rng.permutation(220)[:200]  # 20 sources feed nothing
    tab = OwnerTable(dest, 220, 30, src=src)
    vals = torch.as_tensor(rng.standard_normal(220))
    cot = torch.as_tensor(rng.standard_normal(30))
    tan = torch.as_tensor(rng.standard_normal(220))

    def ref(v):
        return torch.zeros(30, dtype=v.dtype).index_add(
            0, torch.as_tensor(dest), v[torch.as_tensor(src)])

    g = torch.func.vjp(tab.sum, vals)[1](cot)[0]
    g_ref = torch.func.vjp(ref, vals)[1](cot)[0]
    np.testing.assert_array_equal(g.numpy(), g_ref.numpy())
    v = vals.clone().requires_grad_(True)
    (g2,) = torch.autograd.grad(tab.sum(v), v, cot)
    np.testing.assert_array_equal(g2.numpy(), g_ref.numpy())
    t = torch.func.jvp(tab.sum, (vals,), (tan,))[1]
    assert _max_rel(t, ref(tan)) <= TOL
    batch = torch.stack([vals, tan])
    assert _max_rel(torch.func.vmap(tab.sum)(batch)[1], ref(tan)) <= TOL
    with pytest.raises(ValueError, match="more than one"):
        OwnerTable([0, 1], 2, 2, src=[1, 1])


def test_native_source_is_the_jax_packages():
    with open(native.SRC, "rb") as fh:
        ours = fh.read()
    with open(os.path.join(REPO, "femo_tpu", "native", "femo_native.cpp"),
              "rb") as fh:
        theirs = fh.read()
    assert native.SRC.startswith(os.path.join(REPO, "femo_tpu_torch"))
    assert ours == theirs
