"""Mode b of the port's distribution (femo_tpu_torch/parallel/halo.py):
the dof-sharded halo operator and its distributed CG on 4 gloo CPU
ranks, against the JAX package.

* Rank-free: the port's `build_halo_layout` and `rcb_partition` equal
  the JAX package's, field for field and int for int, for nel in {8, 12}
  and 2, 4 and 8 ranks (cheap numpy).
* One pool of ranks for the rest: the module fixture starts 4 ranks once
  (`launch.spawn`, torch on one thread each, a 180 s limit after which
  every rank is killed and the fixture fails) and runs
  tests/torch_dist_ranks.py::halo_checks in one pass; each test asserts
  one entry.  At tests/test_halo.py's nel=12 against the JAX package's
  run over 4 devices (oracles/distributed_oracle.npz): the layout's L,
  G, S; the matvec (1e-11, as there), the dot (1e-12); the CG's
  iterations (within 1: the same layout and partition, the sums in
  another order) and its solution (1e-8 relative to JAX's, and to the
  exact solution of the system); the same CG on a one-rank group.
"""

import os

import numpy as np
import pytest

from femo_tpu import native as jnative
from femo_tpu.fea import (
    FunctionSpace as JFunctionSpace, create_unit_square_mesh as jmesh)
from femo_tpu.parallel.halo import build_halo_layout as jax_layout

from femo_tpu_torch import native
from femo_tpu_torch.fea import FunctionSpace, create_unit_square_mesh
from femo_tpu_torch.parallel.halo import build_halo_layout
from femo_tpu_torch.parallel.launch import spawn

import torch_dist_ranks as R

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORACLE = np.load(os.path.join(REPO, "oracles", "distributed_oracle.npz"))


@pytest.mark.parametrize("nel", [8, 12])
@pytest.mark.parametrize("ndev", [2, 4, 8])
def test_halo_layout_matches_jax(nel, ndev):
    rows = FunctionSpace(create_unit_square_mesh(nel), ("CG", 1),
                         device="cpu").dofmap
    jrows = np.asarray(JFunctionSpace(jmesh(nel), ("CG", 1)).dofmap)
    np.testing.assert_array_equal(rows, jrows)
    part = native.rcb_partition(rows[:, :1].astype(np.float64), ndev)
    np.testing.assert_array_equal(
        part, jnative.rcb_partition(jrows[:, :1].astype(np.float64), ndev))
    got = build_halo_layout(rows, rows.max() + 1, part, ndev)
    want = jax_layout(jrows, jrows.max() + 1, part, ndev)
    for field in want.__dataclass_fields__:
        a, b = getattr(got, field), getattr(want, field)
        np.testing.assert_array_equal(a, b, err_msg=field)
        assert np.asarray(a).dtype == np.asarray(b).dtype, field


@pytest.fixture(scope="module")
def ranks():
    return spawn(R.halo_checks, R.NRANKS, device="cpu", timeout=180)


def test_layout_slices(ranks):
    for r in ranks:
        assert (r["L"], r["G"], r["S"]) == tuple(
            int(ORACLE[f"halo12_{k}"]) for k in "LGS")
    n = (R.HALO_NEL + 1) ** 2
    assert sum(r["n_owned"] for r in ranks) == n
    assert sum(r["n_elements"] for r in ranks) == 2 * R.HALO_NEL ** 2


def test_scatter_gather_roundtrip(ranks):
    x = np.random.default_rng(0).normal(size=(R.HALO_NEL + 1) ** 2)
    for r in ranks:
        np.testing.assert_array_equal(r["scatter_gather"], x)


def test_halo_matvec_matches_jax(ranks):
    for r in ranks:
        np.testing.assert_allclose(r["matvec"], ORACLE["halo12_matvec"],
                                   atol=1e-11)


def test_halo_dot_matches_jax(ranks):
    for r in ranks:
        np.testing.assert_allclose(r["dot"], float(ORACLE["halo12_dot"]),
                                   rtol=1e-12)


def test_halo_diagonal_positive(ranks):
    """The Jacobi diagonal: positive, 1 on the constrained dofs (x = 0)."""
    d = ranks[0]["diagonal"]
    x0 = np.isclose(create_unit_square_mesh(R.HALO_NEL).coords[:, 0], 0.0)
    assert x0.sum() == R.HALO_NEL + 1
    assert np.all(d > 0)
    np.testing.assert_array_equal(d[x0], 1.0)


def test_halo_cg_matches_jax(ranks):
    x, iters, rn = ranks[0]["cg"]
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["cg"][0], x)
        assert r["cg"][1] == iters
    assert abs(iters - int(ORACLE["halo12_iters"])) <= 1
    jx = ORACLE["halo12_x"]
    assert np.linalg.norm(x - jx) / np.linalg.norm(jx) < 1e-8
    xe = ORACLE["halo12_x_exact"]
    assert np.linalg.norm(x - xe) / np.linalg.norm(xe) < 1e-8
    assert rn <= 1e-12 * np.linalg.norm(
        np.random.default_rng(2).normal(size=xe.size))


def test_halo_cg_runs_plain_k4_on_cpu(ranks):
    """CPU tensors take K4's plain version: no launch counted."""
    for r in ranks:
        before, after = r["launches"]
        assert after == before


def test_halo_cg_one_rank_group(ranks):
    x, iters, _ = ranks[0]["cg"]
    x1, it1, L1, G1 = ranks[0]["cg_one_rank"]
    assert (L1, G1) == ((R.HALO_NEL + 1) ** 2, 1)
    assert abs(it1 - iters) <= 1
    assert np.linalg.norm(x1 - x) / np.linalg.norm(x) < 1e-10


def test_distributed_example_rank(ranks):
    """run_distributed_poisson's rank body at nel=12: the same layout,
    a converged CG on every rank."""
    for r in ranks:
        ex = r["example"]
        assert (ex["L"], ex["G"], ex["S"]) == (r["L"], r["G"], r["S"])
        assert ex["iterations"] == ranks[0]["example"]["iterations"] > 0
        assert ex["n_cells"] == 2 * R.HALO_NEL ** 2
