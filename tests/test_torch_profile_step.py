"""The step profiler's layer ranges (femo_tpu_torch/tools/profile_step.py),
on CPU tensors, for the motor step at refine 0.5 and the W1
objective_gradient at nel=6: every layer runs inside a range of its
name as often as the step calls it, and leaving the context restores the
port's functions.  The device-side numbers need the card."""

import numpy as np
import pytest
import torch

from femo_tpu_torch.fea.assemble import CompiledForm
from femo_tpu_torch.models.motor.model import build_motor_jit_step
from femo_tpu_torch.ops import bt_sweeps
from femo_tpu_torch.ops.block_tridiag import BlockTridiagonalMatrix
from femo_tpu_torch.solvers.linear import LinearSolver
from femo_tpu_torch.tools.profile_step import (
    LAYERS, ORACLE_CFG, W1_LAYERS, _inside_us, _union_us, layer_ranges,
    w1_simulator)

torch.set_num_threads(1)

# 2x3 mesh-motion + 3x3 EM Newton iterations, 2 adjoints; 10 solves each
NEWTON, ADJOINTS = 2 * 3 + 3 * 3, 2


@pytest.fixture(scope="module")
def counted():
    step, (dv0, iq0), _ = build_motor_jit_step(refine=0.5, device="cpu",
                                               **ORACLE_CFG)
    saved = {k: getattr(o, a) for k, (o, a) in LAYERS.items()}
    with layer_ranges() as lr:
        step(dv0, iq0)
    return lr.calls, saved


def test_layer_ranges_count_the_step(counted):
    calls, _ = counted
    assert calls["assemble.jacobian"] == NEWTON + ADJOINTS
    assert calls["bt.factor"] == NEWTON + ADJOINTS
    assert calls["bt.transpose"] == ADJOINTS
    assert calls["bt.fill"] == NEWTON + ADJOINTS
    assert calls["bt.solve"] == 10 * (NEWTON + ADJOINTS)
    assert calls["assemble.scalar"] == 2
    assert calls["sweeps.K1"] == 0  # CPU tensors: no kernel launch


@pytest.mark.parametrize("kw, factors, jacobians", [
    (dict(refactor_every=3), 7, NEWTON + ADJOINTS),
    (dict(refactor_every=3, freeze_operator=True), 7, 7),
], ids=["refactor3", "freeze3"])
def test_layer_ranges_count_the_reuse_step(kw, factors, jacobians):
    """bench.py's configurations: one factor per three Newton iterations
    (mesh motion 2 + 1 adjoint, EM 3 + 1), and with the frozen operator
    one Jacobian per factor; 10 block solves per Newton iteration and
    adjoint either way."""
    step, (dv0, iq0), _ = build_motor_jit_step(
        refine=0.5, device="cpu", **dict(ORACLE_CFG, **kw))
    with layer_ranges() as lr:
        step(dv0, iq0)
    assert lr.calls["bt.factor"] == factors
    assert lr.calls["assemble.jacobian"] == jacobians
    assert lr.calls["bt.transpose"] == ADJOINTS
    assert lr.calls["bt.solve"] == 10 * (NEWTON + ADJOINTS)


def test_layer_ranges_restore_the_port(counted):
    _, saved = counted
    for k, (o, a) in LAYERS.items():
        assert getattr(o, a) is saved[k], k
    assert CompiledForm.matrix is saved["assemble.jacobian"]
    assert bt_sweeps.fwd_sweep_cuda is saved["sweeps.K1"]


def test_layer_ranges_reach_the_profiler():
    rng = np.random.default_rng(0)
    D = torch.as_tensor(4 * np.eye(32) + 0.1 * rng.standard_normal(
        (2, 32, 32)))
    L = torch.as_tensor(0.1 * rng.standard_normal((2, 32, 32)))
    mat = BlockTridiagonalMatrix(D, L, L.clone(), np.arange(64), 64)
    acts = [torch.profiler.ProfilerActivity.CPU]
    with layer_ranges(), torch.profiler.profile(activities=acts) as p:
        mat.factor_t().solve(torch.ones(64, dtype=torch.float64))
    names = [e.name for e in p.events() if e.name in LAYERS]
    assert sorted(names) == ["bt.factor", "bt.solve", "bt.transpose"]


@pytest.mark.parametrize("method", ["dense", "bicgstab"])
def test_w1_layer_ranges_count_objective_gradient(method):
    """At the converged warm start of run() the forward Newton takes no
    step: one Jacobian, one factorization, one adjoint solve."""
    sim, fea, _ = w1_simulator(6, device="cpu")
    op = fea.states_dict["u"]["op"]
    op.linear_solver = LinearSolver(method=method)
    saved = {k: getattr(o, a) for k, (o, a) in W1_LAYERS.items()}
    with layer_ranges(W1_LAYERS) as lr:
        sim.objective_gradient("l2_functional", ["f"])
    krylov = int(method == "bicgstab")
    assert lr.calls == {
        "assemble.jacobian": 1, "assemble.residual": 2,
        "assemble.scalar": 1, "linear.factor": 1, "krylov.solve": 0,
        "krylov.solve_t": krylov, "spmv.K4": 0, "spmv.K4T": 0}
    for k, (o, a) in W1_LAYERS.items():
        assert getattr(o, a) is saved[k], k


@pytest.mark.parametrize("intervals, busy", [
    ([], 0.0),
    ([(0, 2), (1, 3)], 3.0),
    ([(5, 6), (0, 1), (0.5, 0.75)], 2.0),
    ([(0, 10), (2, 3), (4, 12)], 12.0),
])
def test_union_of_device_intervals(intervals, busy):
    assert _union_us(intervals) == busy


@pytest.mark.parametrize("kernels, ranges, inside", [
    ([(1, 2)], [], 0.0),
    ([(1, 2), (3, 5)], [(0, 4)], 3.0),
    ([(1, 2), (4, 5)], [(0, 1.5), (3.5, 6)], 2.0),
    ([(1, 2), (2, 3)], [(0, 2)], 1.0),
    ([(0.5, 1), (6, 8)], [(0, 3), (2, 7)], 2.5),
])
def test_kernels_inside_layer_ranges(kernels, ranges, inside):
    assert _inside_us(kernels, ranges) == inside
