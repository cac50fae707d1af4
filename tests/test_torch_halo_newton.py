"""Mode b inside the motor step (femo_tpu_torch/parallel/halo_newton.py):
the form-generic halo Newton with distributed GMRES and CG on 4 gloo CPU
ranks, against the JAX package's run of femo_tpu/parallel/halo_newton.py
over 4 devices (oracles/distributed_oracle.npz, written by
oracles/distributed_oracle.py: no JAX halo step is compiled here) and
against the port's single-device step.

* Rank-free (each rank's view built without a process group): the motor's
  mesh-motion (cell + interior-facet Nitsche terms) and EM layouts at
  refine 0.5 equal JAX's (L, G, n_owned, owned_global, ghosts), and the
  advection-diffusion layouts at nel=5 (50 cells: the last rank holds two
  padded entities, masked to zero) and nel=10; a step without ranks
  raises.
* One pool of 4 ranks for the rest (`launch.spawn`, torch on one thread
  each, a 240 s limit), running tests/torch_dist_ranks.py::
  halo_newton_checks once; each test asserts one entry.  On the
  advection-diffusion system (tests/test_motor_halo.py's): the halo
  operator's columns against JAX's dense constrained Jacobian, its
  asymmetry above 0.05, GMRES and its transpose against the dense solves
  to 1e-8 (tests/test_motor_halo.py:80-85), the Newton solve's free-dof
  residual under 1e-9 (:102), the collectives each solve makes against
  the count the code gives.  The motor halo step at refine 0.5, n2 (the
  dryrun's): loss 1e-10, gradients 1e-8 against the JAX halo step
  (tests/test_motor_halo.py:128-130's bars), loss 1e-8 against the port's
  single-device step (the dryrun's bar), the first Newton system's GMRES
  cycles and CG iterations within 15% of JAX's (rounding moves counts:
  HALO_ITERS in chip_smoke.py), the dryrun's line; every rank's results
  equal; no kernel launched on CPU tensors.

The n6 gradient comparison with the single-device step is held on the
card (chip_smoke.py's `distributed` phase, refine 1), not here: its 13
GMRES solves would take this file past its time.
"""

import os

import numpy as np
import pytest
import torch

from femo_tpu_torch.fea.assemble import compile_form
from femo_tpu_torch.models.motor.model import motor_problem
from femo_tpu_torch.parallel.halo import HaloShardedOperator
from femo_tpu_torch.parallel.halo_newton import build_motor_halo_step
from femo_tpu_torch.parallel.launch import spawn
from femo_tpu_torch.parallel.sharding import RankMesh

import torch_dist_ranks as R

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORACLE = np.load(os.path.join(REPO, "oracles", "distributed_oracle.npz"))
NDEV = 4
CPU = torch.device("cpu")
# tests/test_motor_halo.py's bars: GMRES against the dense solve; the
# Newton residual; the motor step's loss and gradients
SOLVE_BAR, NEWTON_BAR, LOSS_BAR, GRAD_BAR = 1e-8, 1e-9, 1e-10, 1e-8
# the dryrun's bar on the loss against the single-device step
SINGLE_BAR = 1e-8
# Krylov counts relative to JAX's (at least 1): rounding moves them
ITERS_BAR = 0.15
RESTART = 50  # the solver's default GMRES(m)
MOTOR = "motor05_halo_n2"


def rel(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b))
                 / np.linalg.norm(np.asarray(b)))


def layouts(cf, wrt, free, rank=0):
    return HaloShardedOperator.from_terms(
        cf.terms, wrt, cf.form.test.n_dofs, RankMesh(None, rank, NDEV, CPU),
        free=free)


def check_layout(op, prefix, owner=False):
    lay = op.layout
    assert (lay.L, lay.G) == (int(ORACLE[f"{prefix}_L"]),
                              int(ORACLE[f"{prefix}_G"]))
    for got, key in ((lay.n_owned, "n_owned"), (lay.owned_global,
                                                "owned_global"),
                     (op.ghost_counts, "ghosts")) + (
            ((lay.owner_of, "owner_of"),) if owner else ()):
        np.testing.assert_array_equal(got, ORACLE[f"{prefix}_{key}"],
                                      err_msg=key)


@pytest.fixture(scope="module")
def motor():
    torch.set_num_threads(1)
    return motor_problem(0.5, None, "basis", CPU)


@pytest.mark.parametrize("state", ["mm", "em"])
def test_motor_layout_matches_jax(motor, state):
    """The mesh motion's two terms (4 x 288 cells, 4 x 36 facets) and
    EM's one, laid out as JAX's halo Newton lays them out."""
    cf, wrt, free = ((motor.mm_cf, "uhat", motor.free_mm) if state == "mm"
                     else (motor.em_cf, "A_z", motor.free_em))
    op = layouts(cf, wrt, free)
    assert len(op.block_maps) == len(cf.terms)
    check_layout(op, f"{MOTOR}_{state}")


@pytest.mark.parametrize("nel", [5, 10])
def test_advdiff_layout_matches_jax(nel):
    """nel=5: 50 cells in chunks of 13, so the last rank's chunk holds
    two repeats of cell 0 with a zero mask."""
    torch.set_num_threads(1)
    form, free, _, _ = R.advdiff_system(nel, CPU)
    cf = compile_form(form)
    ops = [layouts(cf, "u", free, r) for r in range(NDEV)]
    check_layout(ops[0], f"advdiff{nel}_layout", owner=True)
    masks = [float(op.views[0][1].sum()) for op in ops]
    assert sum(masks) == nel * nel * 2
    assert masks[-1] == (11 if nel == 5 else 50)


def test_motor_halo_step_needs_ranks():
    with pytest.raises(ValueError, match="SPMD-only"):
        build_motor_halo_step(refine=0.5, device_mesh=None)


@pytest.fixture(scope="module")
def ranks():
    return spawn(R.halo_newton_checks, NDEV, device="cpu", timeout=240)


def test_halo_operator_matches_jax(ranks):
    """The constrained advection-diffusion operator, column by column
    (halo_apply), equals JAX's dense one; it is nonsymmetric."""
    K = ranks[0]["K"]
    np.testing.assert_allclose(K, ORACLE["advdiff10_K"], rtol=0,
                               atol=1e-12 * np.abs(K).max())
    assert np.linalg.norm(K - K.T) / np.linalg.norm(K) > 0.05


@pytest.mark.parametrize("key", ["x", "xt"])
def test_gmres_matches_dense(ranks, key):
    """Distributed GMRES (xt: on the transpose, K4T's path) against the
    dense solve of the same b."""
    assert rel(ranks[0][key], ORACLE[f"advdiff10_{key}"]) < SOLVE_BAR


def test_newton_residual(ranks):
    assert ranks[0]["newton_residual"] < NEWTON_BAR


def gmres_collectives(cycles, m=RESTART):
    """(exchanges, all-reduces) of one halo GMRES solve with its diagonal
    and gather: 2 per product (1 + cycles (m + 2) products) + 1 (the
    diagonal's reverse exchange); 2 per Arnoldi step + 2 per cycle + 1 at
    the start + 1 (the gather)."""
    return (2 * (1 + cycles * (m + 2)) + 1,
            cycles * (2 * m + 2) + 2)


def cg_collectives(iterations):
    """(exchanges, all-reduces) of one halo CG solve: 2 an iteration, the
    first residual's product and direction, the diagonal; the gather."""
    return 2 * iterations + 4, 1


def test_collectives_per_solve(ranks):
    """Each solve's collectives equal the count the code gives: an
    Arnoldi step makes 4 whatever its index (2 exchanges, 2 all-reduces),
    a CG iteration 2 (exchanges); the advection-diffusion operator also
    made n_dofs products and gathers (halo_apply)."""
    r = ranks[0]
    n = r["K"].shape[0]
    ex, ar = (sum(x) for x in zip(*(gmres_collectives(c)
                                    for c in r["advdiff_counts"])))
    assert r["advdiff_collectives"] == dict(exchanges=ex + 2 * n,
                                            all_reduces=ar + n)
    ex, ar = (sum(x) for x in zip(*(gmres_collectives(c)
                                    for c in r["mm_counts"])))
    assert r["mm_collectives"] == dict(exchanges=ex, all_reduces=ar)
    ex, ar = (sum(x) for x in zip(*(cg_collectives(k)
                                    for k in r["em_counts"])))
    assert r["em_collectives"] == dict(exchanges=ex, all_reduces=ar)


@pytest.mark.parametrize("key", ["loss", "g_dv", "g_iq"])
def test_motor_halo_step_matches_jax(ranks, key):
    got = ranks[0]["halo"][("loss", "g_dv", "g_iq").index(key)]
    bar = LOSS_BAR if key == "loss" else GRAD_BAR
    assert rel(got, ORACLE[f"{MOTOR}_{key}"]) < bar


def test_motor_halo_step_matches_single_device(ranks):
    """The loss within the dryrun's bar of the port's single-device
    dense-LU step (at n2 the gradients differ by design: the adjoints
    assemble at different states)."""
    h, s = ranks[0]["halo"], ranks[0]["single"]
    assert abs(h[0] - s[0]) / abs(s[0]) < SINGLE_BAR
    assert np.all(np.isfinite(h[1])) and np.isfinite(h[2])


@pytest.mark.parametrize("state,key", [("mm", "mm_cycles"),
                                       ("em", "em_iters")])
def test_first_system_counts_match_jax(ranks, state, key):
    """The first Newton system's GMRES cycles (mesh motion) and CG
    iterations (EM), the step's first solve of each state, within
    ITERS_BAR of JAX's on the same system; a step at n2 solves 4 + 1 mesh
    motion and 2 + 1 EM systems."""
    counts = ranks[0][f"{state}_counts"]
    want = int(ORACLE[f"{MOTOR}_{key}"])
    assert abs(counts[0] - want) <= max(1, ITERS_BAR * want)
    assert len(counts) == (5 if state == "mm" else 3)


def test_motor_layouts_on_ranks(ranks):
    for state in ("mm", "em"):
        lay = ranks[0][f"{state}_layout"]
        assert (lay["L"], lay["G"]) == (int(ORACLE[f"{MOTOR}_{state}_L"]),
                                        int(ORACLE[f"{MOTOR}_{state}_G"]))
        np.testing.assert_array_equal(lay["ghosts"],
                                      ORACLE[f"{MOTOR}_{state}_ghosts"])


def test_dryrun_motor_line(ranks):
    (line,) = ranks[0]["lines"]
    assert line.split(" mode ")[1].split(":")[0] == \
        "b (MOTOR w/ DISTRIBUTED GMRES+CG solves)"


def test_every_rank_same(ranks):
    """Loss, gradients, solutions and Krylov counts are replicated: every
    rank's bits equal."""
    r0 = ranks[0]
    for r in ranks[1:]:
        for key in ("x", "xt", "K"):
            np.testing.assert_array_equal(r[key], r0[key])
        for key in ("halo", "single"):
            assert r[key][0] == r0[key][0] and r[key][2] == r0[key][2]
            np.testing.assert_array_equal(r[key][1], r0[key][1])
        assert (r["mm_counts"], r["em_counts"]) == (r0["mm_counts"],
                                                    r0["em_counts"])


def test_cpu_tensors_launch_no_kernel(ranks):
    for r in ranks:
        before, after = r["launches"]
        assert after == before
