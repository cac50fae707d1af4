"""Mode b inside the workload steps (femo_tpu_torch/parallel/halo_step.py):
the shell and FSI halo steps on 4 gloo CPU ranks, against the JAX
package's run of femo_tpu/parallel/halo_step.py over 4 devices
(oracles/distributed_oracle.npz, written by oracles/distributed_oracle.py:
no JAX halo step is compiled here) and against the port's unsharded step.

* Rank-free (cheap numpy): the composite dofmap [u | theta + off] and the
  RCB partition of the cell centroids give, through the port's
  `build_halo_layout`, the JAX package's `build_halo_layout` field for
  field, and the JAX halo core's owners and owned slots; a cell count
  that does not split into equal parts raises; a step without ranks
  raises.
* One pool of ranks for the rest: the module fixture starts 8 ranks once
  (`launch.spawn`, torch on one thread each, a 240 s limit after which
  every rank is killed and the fixture fails), two groups of 4 that run
  tests/torch_dist_ranks.py::halo_step_checks' two halves at once (the
  CG's gloo collectives, ~1 ms each here, set the time); each test
  asserts one entry.  The shell halo step at (3, 4) with jacobi and
  bjacobi: J and gradient at 1e-8 (the JAX dryrun's and
  tests/test_halo.py:132's bar) against JAX and against the port's
  unsharded step, and Chebyshev degree 6's forward solve: J at 1e-8
  (chip_smoke.py holds its gradient); layout, ghosts and bjacobi's blocks
  equal to JAX's; the forward solve's CG iterations within 15% of JAX's
  (ITERS_BAR); at (4, 6) bjacobi under 0.6x jacobi's iterations
  (tests/test_halo.py:157), each within 15% of JAX's; Chebyshev degree
  6 under half degree 0's iterations with equal J (tests/test_halo.py:
  236); the FSI halo step at
  (3, 4) / (2, 3) with 3 Gauss-Seidel passes, tip and gradient at 1e-7
  (tests/test_halo.py:203); the dryrun's two mode-b lines; every rank's
  results equal; no kernel launched on CPU tensors.
"""

import os

import numpy as np
import pytest

from femo_tpu.parallel.halo import build_halo_layout as jax_layout

from femo_tpu_torch.fea.assemble import compile_form
from femo_tpu_torch.models.shell import plate_shell
from femo_tpu_torch.parallel.halo import build_halo_layout
from femo_tpu_torch.parallel.halo_step import (
    build_shell_halo_step, composite_partition)
from femo_tpu_torch.parallel.launch import spawn

import torch_dist_ranks as R

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORACLE = np.load(os.path.join(REPO, "oracles", "distributed_oracle.npz"))
NDEV = 4
# value and gradient (relative) of the shell step, of the FSI step
SHELL_BAR, FSI_BAR = 1e-8, 1e-7
# CG iterations, relative to JAX's (at least 1).  Rounding alone moves
# them: with its element blocks perturbed by one ulp, the port's own
# counts change by up to 13.5% (jacobi at (3, 4); `python -m
# femo_tpu_torch.tools.distributed_check --iteration-spread --device
# cpu`), so a 2% bar would pass or fail by chance
ITERS_BAR = 0.15
PRECONDS = ("jacobi", "bjacobi", "cheby6")


def rel(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b))
                 / np.linalg.norm(np.asarray(b)))


def composite(n_shell, span=2.0):
    shell, bcs = plate_shell(n_shell, span=span, device="cpu")
    state = shell.make_state(bcs)
    ucf, tcf = compile_form(shell.res_u), compile_form(shell.res_th)
    return (*composite_partition(ucf, tcf, shell.Vu.n_dofs, NDEV),
            state.n_dofs)


@pytest.mark.parametrize("n_shell", [(3, 4), (4, 6)])
def test_composite_layout_matches_jax(n_shell):
    comp, part, n = composite(n_shell)
    got = build_halo_layout(comp, n, part, NDEV)
    want = jax_layout(comp, n, part, NDEV)
    for field in want.__dataclass_fields__:
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field), err_msg=field)


def test_composite_layout_is_jax_cores():
    """The port's composite dofmap and partition lay the dofs out as the
    JAX halo core did: its owners and owned slots."""
    comp, part, n = composite(R.HALO_STEP_SHELL)
    lay = build_halo_layout(comp, n, part, NDEV)
    for key in ("owner_of", "owned_global", "n_owned"):
        np.testing.assert_array_equal(
            getattr(lay, key),
            ORACLE[f"shell34_halo_jacobi_{key}"], err_msg=key)


def test_unequal_partition_raises():
    """(3, 5): 30 cells do not split into 4 equal parts."""
    with pytest.raises(ValueError, match="equal RCB parts"):
        composite((3, 5))


def test_halo_step_needs_ranks():
    with pytest.raises(ValueError, match="SPMD-only"):
        build_shell_halo_step(n_shell=(3, 4), device_mesh=None)


@pytest.fixture(scope="module")
def ranks():
    """Rank r's results of both groups of halo_step_checks, merged."""
    res = spawn(R.halo_step_checks, 2 * NDEV, device="cpu", timeout=240)
    return [dict(a, **b) for a, b in zip(res[:NDEV], res[NDEV:])]


def _close(r, J, g):
    """Value and gradient within SHELL_BAR (Chebyshev: the value; its
    gradient is held on the card)."""
    return abs(r["J"] - J) / abs(J) < SHELL_BAR and (
        r["g"] is None or rel(r["g"], g) < SHELL_BAR)


@pytest.mark.parametrize("key", PRECONDS)
def test_shell_halo_step_matches_jax(ranks, key):
    assert _close(ranks[0][key], float(ORACLE[f"shell34_halo_{key}_J"]),
                  ORACLE[f"shell34_halo_{key}_g"])


@pytest.mark.parametrize("key", PRECONDS)
def test_shell_halo_step_matches_unsharded(ranks, key):
    assert _close(ranks[0][key], *ranks[0]["unsharded"])


@pytest.mark.parametrize("key", PRECONDS)
def test_halo_step_layout_matches_jax(ranks, key):
    r = ranks[0][key]
    assert r["LGS"] == tuple(int(ORACLE[f"shell34_halo_{key}_{k}"])
                             for k in "LGS")
    for name, field in (("ghosts", "ghosts"), ("n_owned", "n_owned"),
                        ("owned", "owned_global"), ("owner", "owner_of")):
        np.testing.assert_array_equal(
            r[name], ORACLE[f"shell34_halo_{key}_{field}"], err_msg=name)


def test_bjacobi_blocks_match_jax(ranks):
    assert ranks[0]["bjacobi"]["bj"] == dict(
        B=int(ORACLE["shell34_halo_bjacobi_Bj"]),
        nb=int(ORACLE["shell34_halo_bjacobi_nb"]))


def _iters_close(got, want):
    return abs(got - want) <= max(1, ITERS_BAR * want)


@pytest.mark.parametrize("key", PRECONDS)
def test_cg_iterations_match_jax(ranks, key):
    """The forward solve's iterations (the step's right-hand side, as the
    oracle's halo_cg) within ITERS_BAR of JAX's; a step also solves the
    adjoint."""
    it = ranks[0][key]["iters"]
    assert _iters_close(it[0], int(ORACLE[f"shell34_halo_{key}_iters"])) \
        and len(it) == (1 if key == "cheby6" else 2)


@pytest.mark.parametrize("key", ("jacobi", "bjacobi"))
def test_cg_iterations_46_match_jax(ranks, key):
    assert _iters_close(ranks[0][f"iters46_{key}"],
                        int(ORACLE[f"shell46_halo_{key}_iters"]))


def test_bjacobi_accelerates(ranks):
    """At (4, 6) block Jacobi takes under 0.6x point Jacobi's iterations
    (tests/test_halo.py:157's bar)."""
    r = ranks[0]
    assert r["iters46_bjacobi"] < 0.6 * r["iters46_jacobi"]


def test_chebyshev_fewer_iterations(ranks):
    """Degree 6 against degree 0 (the jacobi run, which is point Jacobi):
    under half the iterations, within ITERS_BAR of JAX's counts, the same
    J (1e-9), as tests/test_halo.py:236."""
    c6, c0 = ranks[0]["cheby6"], ranks[0]["jacobi"]
    assert (2 * c6["iters"][0] < c0["iters"][0]
            and _iters_close(c0["iters"][0],
                             int(ORACLE["shell34_halo_cheby0_iters"]))
            and abs(c6["J"] - c0["J"]) <= 1e-9 * abs(c0["J"]))


def test_fsi_halo_step_matches_jax(ranks):
    tip, g = ranks[0]["fsi"]
    want = float(ORACLE["fsi34_halo_tip"])
    assert abs(tip - want) / abs(want) < FSI_BAR \
        and rel(g, ORACLE["fsi34_halo_g"]) < FSI_BAR


def test_dryrun_halo_step_lines(ranks):
    """entry._dryrun_halo_steps: the JAX dryrun's two mode-b lines."""
    lines = ranks[0]["lines"]
    assert [ln.split(" mode ")[1].split(":")[0] for ln in lines] == [
        "b (shell step w/ DISTRIBUTED halo-CG solve)",
        "b (COUPLED FSI w/ distributed shell solves)"]


def test_every_rank_same(ranks):
    """Values and gradients are replicated: every rank's bits equal."""
    for r in ranks[1:]:
        for key in PRECONDS:
            assert r[key]["J"] == ranks[0][key]["J"]
            assert r[key]["iters"] == ranks[0][key]["iters"]
            if key != "cheby6":
                np.testing.assert_array_equal(r[key]["g"],
                                              ranks[0][key]["g"])
        np.testing.assert_array_equal(r["fsi"][1], ranks[0]["fsi"][1])


def test_cpu_tensors_launch_no_kernel(ranks):
    """CPU tensors take K1/K2's and K4's plain versions: no launch."""
    for r in ranks:
        for g in (0, 1):
            before, after = r[f"launches{g}"]
            assert after == before

