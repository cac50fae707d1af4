"""Where the time of the port's motor step, W1 optimization step, W6
shell compliance step, W7 FSI optimization iteration and W8 trajectory
gradient goes, on one CUDA card.

    python -m femo_tpu_torch.tools.profile_step [--refine 1 4] [--w1 260]
        [--shell a b] [--fsi] [--fsi-dynamic] [--factor-method cr]
        [--refactor-every N] [--freeze-operator] [--steps 5] [--out FILE]

For each refine level the motor step is built in f64 in the
configuration of the f64 oracle (experiments/motor_latency_oracle.json),
with Shamanskii factor reuse when given: `--refactor-every 3` is
bench.py's refine-4 configuration, with `--freeze-operator` its refine-1
one;
for each `--w1` nel the W1 Poisson model is built in f64 (f = 0.5,
objective l2_functional, `Simulator.run()` once) and its step is one
`objective_gradient`, the call SLSQP makes each iteration; for each
`--shell` configuration the shell step `build_shell_jit_step(n_shell=(24,
400), split_programs=True, ...)` is built in f64, "a" with pcg_iters=2,
"b" (the JAX package's TPU production configuration) with f32 factor
storage and pcg_iters=4, and its step is one call (compliance and its
thickness gradient); with `--fsi` the FSI anchor (FSI_ANCHOR: 107,520
cells, 927,402 dofs, the JAX package's anchor solver) is built in f64
and its step is one `solve_with_grad`; with `--fsi-dynamic` the W8
rung (DYN_RUNG: 76,800 cells, 662,442 dofs, f32 factor storage) is
built in f64 and its step is one `run_with_grad` over DYN_STEPS time
steps (the factor, the forward march, the checkpointed adjoint); with
`--factor-method cr` both FSI runs use block cyclic reduction with f64
factor storage (the factor and its solves in their own ranges,
`fsi.factor_cr` / `fsi.cr_solve` and `dyn.*`).  Each step is
run once to warm, timed over `--steps` untraced warm steps (host clock,
ending in a device sync), then traced for one warm step with
torch.profiler (CPU + CUDA).  During the traced step the port's layers
run inside `record_function` ranges (the wrappers below, installed only
by this tool).  It reports:

- the device's busy time (the union of the intervals of kernels and
  copies; the device-side copies of the `record_function` ranges are not
  device work and are left out) and its idle share against the traced
  step's wall time;
- per layer, the host time inside its ranges and the device time of the
  kernels that start inside the device-side copy of its ranges (both
  inclusive: a solve holds its sweeps);
- the device kernels by total time;
- the bytes the sweep kernels stream (counted from the shapes they were
  given) and their rate, beside a device-to-device copy's rate measured in
  the same run.

It prints a summary and writes everything to `--out` as JSON.
"""

from __future__ import annotations

import argparse
import bisect
import functools
import gc
import json
import os
import statistics
import subprocess
import time

import torch
from torch.autograd import DeviceType

from .. import set_precision
from ..fea.assemble import CompiledForm, ElementMatrix
from ..graph.model import FEAModel
from ..graph.simulator import Simulator
from ..fea.composite import CompositeState
from ..models.motor.model import build_motor_jit_step
from ..models import fsi
from ..models.shell import build_shell_jit_step
from ..models.vlm import VLM
from ..models.poisson import build_fea
from ..ops import bt_sweeps, spmv
from ..ops.block_tridiag import (
    BlockCyclicFactor, BlockThomasFactor, BlockTridiagonalMatrix,
    BlockTridiagTemplate)
from ..solvers.linear import KrylovFactorization, LinearSolver

ORACLE_CFG = dict(em_load_steps=3, mm_newton_iters=3, em_newton_iters=3,
                  factorization="block_thomas", pcg_iters=8,
                  design_space="edge_deltas")

# range name -> (owner, attribute) of the function run inside it
LAYERS = {
    "assemble.jacobian": (CompiledForm, "matrix"),
    "assemble.residual": (CompiledForm, "vector"),
    "assemble.scalar": (CompiledForm, "scalar"),
    "bt.fill": (BlockTridiagTemplate, "fill"),
    "bt.factor": (BlockTridiagonalMatrix, "factor"),
    "bt.factor_cr": (BlockTridiagonalMatrix, "factor_cr"),
    "bt.transpose": (BlockTridiagonalMatrix, "_transposed"),
    "bt.matvec": (BlockTridiagonalMatrix, "matvec"),
    "bt.matvec_t": (BlockTridiagonalMatrix, "matvec_t"),
    "bt.solve": (BlockThomasFactor, "solve"),
    "bt.cr_solve": (BlockCyclicFactor, "solve"),
    "sweeps.K1": (bt_sweeps, "fwd_sweep_cuda"),
    "sweeps.K2": (bt_sweeps, "bwd_sweep_cuda"),
}
# the W1 step's layers
W1_LAYERS = {
    "assemble.jacobian": (CompiledForm, "matrix"),
    "assemble.residual": (CompiledForm, "vector"),
    "assemble.scalar": (CompiledForm, "scalar"),
    "linear.factor": (LinearSolver, "factor"),
    "krylov.solve": (KrylovFactorization, "solve"),
    "krylov.solve_t": (KrylovFactorization, "solve_t"),
    "spmv.K4": (spmv, "element_spmv_cuda"),
    "spmv.K4T": (spmv, "element_rspmv_cuda"),
}
# the shell step's layers
SHELL_LAYERS = {
    "assemble.residual": (CompiledForm, "vector"),
    "assemble.scalar": (CompiledForm, "scalar"),
    "composite.jacobian": (CompositeState, "jacobian_blocks"),
    "bt.fill": (BlockTridiagTemplate, "fill"),
    "bt.factor": (BlockTridiagonalMatrix, "factor"),
    "bt.matvec": (BlockTridiagonalMatrix, "matvec"),
    "bt.matvec_t": (BlockTridiagonalMatrix, "matvec_t"),
    "bt.solve": (BlockThomasFactor, "solve"),
    "sweeps.K1": (bt_sweeps, "fwd_sweep_cuda"),
    "sweeps.K2": (bt_sweeps, "bwd_sweep_cuda"),
}
# the FSI iteration's layers (models/fsi.py): the two halves of the
# factor, the VLM, the right-hand-side assembly, the block-Thomas solves
# (K1 + K2 each), the PCG polish (holding its solves) and the adjoint
FSI_LAYERS = {
    "fsi.fill": (fsi._BTPrograms, "fill"),
    "fsi.factor_core": (fsi._BTPrograms, "factor_core"),
    "fsi.gs": (fsi._FSIStep, "gs"),
    "fsi.finalize": (fsi._FSIStep, "finalize"),
    "fsi.vlm": (VLM, "solve"),
    "fsi.rhs": (fsi._FSIStep, "_rhs"),
    "fsi.sweeps": (BlockThomasFactor, "solve"),
    "fsi.factor_cr": (BlockTridiagonalMatrix, "factor_cr"),
    "fsi.cr_solve": (BlockCyclicFactor, "solve"),
    "fsi.pcg": (fsi._FSIStep, "_polish"),
    "fsi.adjoint": (fsi._FSIStep, "adjoint"),
    "bt.matvec": (BlockTridiagonalMatrix, "matvec"),
    "assemble.rmatvec": (ElementMatrix, "rmatvec"),
    "sweeps.K1": (bt_sweeps, "fwd_sweep_cuda"),
    "sweeps.K2": (bt_sweeps, "bwd_sweep_cuda"),
    "spmv.K4T": (spmv, "element_rspmv_cuda"),
}
# the dynamic FSI's layers (W8/W9, models/fsi.py): the factor's halves,
# the forward steps, the VLM, the right-hand-side assembly, the
# block-Thomas solves (K1 + K2 each), the PCG polish, the backward steps
# and the Fm^T products
DYN_LAYERS = {
    "dyn.fill": (fsi._BTPrograms, "fill"),
    "dyn.factor_core": (fsi._BTPrograms, "factor_core"),
    "dyn.step": (fsi._DynamicFSIStep, "step"),
    "dyn.step_ext": (fsi._DynamicFSIStep, "step_ext"),
    "dyn.vlm": (VLM, "solve"),
    "dyn.rhs": (fsi._DynamicFSIStep, "rhs"),
    "dyn.sweeps": (BlockThomasFactor, "solve"),
    "dyn.factor_cr": (BlockTridiagonalMatrix, "factor_cr"),
    "dyn.cr_solve": (BlockCyclicFactor, "solve"),
    "dyn.pcg": (fsi._FSIStep, "_polish"),
    "dyn.adjoint": (fsi._DynamicFSIStep, "adjoint_step"),
    "dyn.adjoint_ext": (fsi._DynamicFSIStep, "adjoint_step_ext"),
    "bt.matvec": (BlockTridiagonalMatrix, "matvec"),
    "assemble.rmatvec": (ElementMatrix, "rmatvec"),
    "sweeps.K1": (bt_sweeps, "fwd_sweep_cuda"),
    "sweeps.K2": (bt_sweeps, "bwd_sweep_cuda"),
    "spmv.K4T": (spmv, "element_rspmv_cuda"),
}
# the W8 rung of the reference's dynamic mesh ladder (bench_scale.py's
# run_fsi_dynamic, 76,800 cells) over DYN_STEPS steps (the gust acts from
# step 11)
DYN_RUNG = dict(n_shell=(4, 9600), n_vlm=(4, 24), span=21.0, thickness=0.05,
                dt=0.01, fsi_iters=2, pcg_iters=4, adj_passes=6)
DYN_STEPS = 12
# the FSI anchor: the reference's eVTOL wing class in the JAX package's
# anchor solver configuration (bench_scale.py), 5 rounds of 4 passes
FSI_ANCHOR = dict(n_shell=(4, 13440), n_vlm=(4, 32), span=30.0,
                  thickness=0.05, gs_inner=4, factor_store_dtype="float32",
                  pcg_rtol=1e-7, pcg_maxiter=10)
FSI_ROUNDS = 5
SHELL_CONFIGS = {
    "a": dict(n_shell=(24, 400), split_programs=True, pcg_iters=2),
    "b": dict(n_shell=(24, 400), split_programs=True, spd=True,
              factor_store_dtype="float32", pcg_iters=4),
}
SWEEP_BLOCKS = {"sweeps.K1": 2, "sweeps.K2": 1}  # (B,B) blocks per step


def _ranged(name, fn, lr):
    blocks = SWEEP_BLOCKS.get(name)

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        if lr.sync:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        with torch.profiler.record_function(name):
            out = fn(*args, **kwargs)
        if lr.sync:
            torch.cuda.synchronize()
            lr.seconds[name] += time.perf_counter() - t0
        lr.calls[name] += 1
        if blocks:
            lr.streamed[name] += blocks * args[0].numel() * args[0].itemsize
        return out
    return wrapped


class layer_ranges:
    """Context: run each layer of `layers` (LAYERS, the motor's, unless
    given) inside a record_function range of its name, count its calls,
    and count the bytes of (B,B) blocks the sweeps stream.  With
    sync=True (CUDA) each call is also bracketed by device syncs and its
    wall seconds summed into `seconds` (a nested layer's inside its
    parent's)."""

    def __init__(self, layers=None, sync=False):
        self.layers = LAYERS if layers is None else layers
        self.sync = sync

    def __enter__(self):
        self.saved = {k: getattr(o, a) for k, (o, a) in self.layers.items()}
        self.calls = {k: 0 for k in self.layers}
        self.seconds = {k: 0.0 for k in self.layers}
        self.streamed = {k: 0 for k in SWEEP_BLOCKS}
        for k, (o, a) in self.layers.items():
            setattr(o, a, _ranged(k, self.saved[k], self))
        return self

    def __exit__(self, *exc):
        for k, (o, a) in self.layers.items():
            setattr(o, a, self.saved[k])


def _merge(intervals):
    """Sorted disjoint intervals covering the union of `intervals`."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _union_us(intervals):
    return sum(b - a for a, b in _merge(intervals))


def _inside_us(kernels, ranges):
    """Total duration of the (start, end) kernels that start inside the
    union of `ranges`."""
    merged = _merge(ranges)
    starts = [a for a, _ in merged]
    total = 0.0
    for a, b in kernels:
        i = bisect.bisect_right(starts, a) - 1
        if i >= 0 and a < merged[i][1]:
            total += b - a
    return total


def _sync_time(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def copy_rate_gbs(nbytes=2 << 30, reps=10):
    """Device-to-device copy rate (read + write bytes / s), median."""
    x = torch.empty(nbytes // 8, dtype=torch.float64, device="cuda")
    y = torch.empty_like(x)
    times = []
    for _ in range(reps + 2):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        y.copy_(x)
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) * 1e-3)
    del x, y
    return 2 * nbytes / statistics.median(times[2:]) / 1e9


def trace_step(step, steps, layers):
    """Warm `step` once, time `steps` untraced warm calls, then trace one
    with each of `layers` inside its range.  Returns the measurements and
    the traced call's result."""
    t_first, _ = _sync_time(step)
    walls = [_sync_time(step)[0] for _ in range(steps)]

    # an earlier step's solve ops sit in reference cycles (each holds an
    # autograd.Function class): free them before the peak is read
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with layer_ranges(layers) as lr, \
            torch.profiler.profile(activities=acts) as p:
        t_traced, out = _sync_time(step)
    peak = torch.cuda.max_memory_allocated()

    # the profiler's raw events: building its FunctionEvent tree takes
    # minutes for the 10^6 events of an FSI anchor iteration
    dev, annotated, lays = [], {}, {}
    for e in p.profiler.kineto_results.events():
        name = e.name()
        span = (e.start_ns() / 1e3, e.end_ns() / 1e3)
        if e.device_type() == DeviceType.CUDA:
            if name in layers or e.is_user_annotation():
                annotated.setdefault(name, []).append(span)
            else:
                dev.append((name, span))
        elif name in layers and e.device_type() == DeviceType.CPU:
            lay = lays.setdefault(name, [0, 0.0, 0.0])
            lay[0] += 1
            lay[1] += span[1] - span[0]
    busy_us = _union_us([sp for _, sp in dev])
    kernels = {}
    for name, (a, b) in dev:
        k = kernels.setdefault(name, [0, 0.0])
        k[0] += 1
        k[1] += b - a
    for name, lay in lays.items():
        lay[2] = _inside_us([sp for _, sp in dev], annotated.get(name, []))
    dev_total_us = sum(v[1] for v in kernels.values())
    return {
        "first_step_s": t_first,
        "warm_step_s": walls, "warm_step_median_s": statistics.median(walls),
        "traced_step_s": t_traced, "device_busy_s": busy_us * 1e-6,
        "device_idle_share_of_traced": 1 - busy_us * 1e-6 / t_traced,
        "device_event_total_s": dev_total_us * 1e-6,
        "peak_device_mem_bytes": peak,
        "layers": {k: {"calls": v[0], "host_s": v[1] * 1e-6,
                       "device_s": v[2] * 1e-6}
                   for k, v in sorted(lays.items())},
        "kernels": [{"name": n, "calls": c, "device_s": us * 1e-6}
                    for n, (c, us) in sorted(kernels.items(),
                                             key=lambda kv: -kv[1][1])],
        "sweep_bytes": lr.streamed,
    }, out


def _sweep_rates(r):
    """The sweeps' device time and streaming rate, into r."""
    sweep_us = {"sweeps.K1": sum(k["device_s"] for k in r["kernels"]
                                 if "bt_fwd_kernel" in k["name"]) * 1e6,
                "sweeps.K2": sum(k["device_s"] for k in r["kernels"]
                                 if "bt_bwd_kernel" in k["name"]) * 1e6}
    r["sweep_device_s"] = {k: v * 1e-6 for k, v in sweep_us.items()}
    r["sweep_rate_gbs"] = {k: r["sweep_bytes"][k] / (sweep_us[k] * 1e-6)
                           / 1e9 for k in sweep_us if sweep_us[k] > 0}


def profile_refine(refine, steps, **step_kw):
    """The motor step at `refine` in ORACLE_CFG updated by step_kw."""
    cfg = dict(ORACLE_CFG, **step_kw)
    t_build, (step, (dv0, iq0), info) = _sync_time(
        lambda: build_motor_jit_step(refine=refine, device="cuda", **cfg))
    r, (loss, _) = trace_step(lambda: step(dv0, iq0), steps, LAYERS)
    _sweep_rates(r)
    reuse = "".join(f", {k}={v}" for k, v in step_kw.items())
    r.update(name=f"motor refine {refine}{reuse}", refine=refine,
             step_kwargs=step_kw,
             cells=info["mesh"].n_cells, bt=info["bt"], loss=float(loss),
             build_s=t_build)
    return r


def w1_simulator(nel, device=None):
    """The W1 model of examples/run_poisson_opt.py (f = 0.5), run once."""
    fea, d = build_fea(nel=nel, device=device)
    model = FEAModel(fea=[fea])
    model.create_input("f", shape=d["W"].n_dofs, val=0.5)
    model.add_design_variable("f")
    model.add_objective("l2_functional", scaler=1e5)
    sim = Simulator(model)
    sim.run()
    return sim, fea, d


def profile_w1(nel, steps):
    t_build, (sim, fea, d) = _sync_time(lambda: w1_simulator(nel))
    r, (val, _, _) = trace_step(
        lambda: sim.objective_gradient("l2_functional", ["f"]), steps,
        W1_LAYERS)
    r.update(name=f"W1 nel={nel}", nel=nel, cells=d["mesh"].n_cells,
             dofs=d["V"].n_dofs, controls=d["W"].n_dofs,
             method=fea.linear_solver.resolve_method(d["V"].n_dofs),
             loss=float(val), build_s=t_build)
    return r


def profile_shell(name, steps):
    """The shell compliance step in SHELL_CONFIGS[name]."""
    cfg = SHELL_CONFIGS[name]
    t_build, (step, t0, info) = _sync_time(
        lambda: build_shell_jit_step(device="cuda", **cfg))
    r, (J, _) = trace_step(lambda: step(t0), steps, SHELL_LAYERS)
    _sweep_rates(r)
    tpl = info["bt_tpl"]
    r.update(name=f"shell {name} {cfg}", config=name,
             step_kwargs={k: v for k, v in cfg.items() if k != "n_shell"},
             cells=info["n_cells"], dofs=info["n_dofs"],
             bt=dict(nb=tpl.nb, B=tpl.B), loss=float(J), build_s=t_build)
    return r


def _factor_kw(factor_method):
    """Block cyclic reduction with f64 factor storage, or {} (Thomas)."""
    if factor_method == "cr":
        return dict(factor_method="cr", factor_store_dtype=None)
    return {}


def profile_fsi(steps, factor_method="thomas"):
    """The FSI anchor's optimization iteration, `solve_with_grad` (5 rounds
    of 4 Gauss-Seidel passes, the 24-pass coupled adjoint)."""
    cfg = dict(FSI_ANCHOR, **_factor_kw(factor_method))
    t_build, f = _sync_time(lambda: fsi.build_fsi_jit_step(device="cuda",
                                                           **cfg))
    stats = f["stats"]
    r, out = trace_step(
        lambda: f["solve_with_grad"](f["t0"], rounds=FSI_ROUNDS), steps,
        FSI_LAYERS)
    _sweep_rates(r)
    n_calls = 2 + steps  # warm-up, the timed steps and the traced one
    r.update(name=f"fsi {cfg}", config={k: list(v) if isinstance(v, tuple)
                                        else v for k, v in cfg.items()},
             cells=f["n_cells"], dofs=f["n_dofs"],
             bt=dict(nb=f["tpl"].nb, B=f["tpl"].B),
             loss=float(out["tip_disp"]),
             objective=float(out["objective"]),
             rel_delta=float(out["rel_delta"]),
             adj_delta=float(out["adj_delta"]), build_s=t_build,
             solves_per_step=stats["solves"] / n_calls,
             pcg_iters_per_step=len(stats["pcg_iters"]) / n_calls)
    return r


def profile_fsi_dynamic(steps, factor_method="thomas"):
    """The W8 rung's trajectory gradient, `run_with_grad` over DYN_STEPS
    time steps (factor, forward march, checkpointed adjoint), f32 factor
    storage (bench_scale.py's configuration) with Thomas."""
    cfg = dict(DYN_RUNG, factor_store_dtype="float32",
               **_factor_kw(factor_method))
    t_build, f = _sync_time(lambda: fsi.build_dynamic_fsi_jit_step(
        device="cuda", **cfg))
    stats = f["stats"]
    r, out = trace_step(lambda: f["run_with_grad"](f["t0"], DYN_STEPS),
                        steps, DYN_LAYERS)
    _sweep_rates(r)
    n_calls = 2 + steps  # warm-up, the timed steps and the traced one
    r.update(name=f"fsi dynamic {cfg}, {DYN_STEPS} steps",
             config={k: list(v) if isinstance(v, tuple) else v
                     for k, v in cfg.items()},
             cells=f["n_cells"], dofs=f["n_dofs"],
             bt=dict(nb=f["tpl"].nb, B=f["tpl"].B), loss=out["J"],
             tips=out["tips"].tolist(), adj_deltas=out["adj_deltas"],
             forward_s=out["forward_s"], backward_s=out["backward_s"],
             build_s=t_build, solves_per_step=stats["solves"] / n_calls)
    return r


def _summary(r, copy_gbs):
    print(f"{r['name']} ({r['cells']} cells): loss "
          f"{r['loss']!r}; warm step median {r['warm_step_median_s']:.4f} s "
          f"over {len(r['warm_step_s'])} "
          f"({min(r['warm_step_s']):.4f}-{max(r['warm_step_s']):.4f}); "
          f"traced {r['traced_step_s']:.4f} s, device busy "
          f"{r['device_busy_s']:.4f} s, idle "
          f"{100 * r['device_idle_share_of_traced']:.1f}% of the traced "
          f"step; peak device memory "
          f"{r['peak_device_mem_bytes'] / 2**30:.3f} GiB")
    for k, v in r["layers"].items():
        print(f"  layer {k:18s} calls {v['calls']:5d}  host "
              f"{v['host_s']:.4f} s  device {v['device_s']:.4f} s")
    for k in r["kernels"][:12]:
        print(f"  kernel {k['device_s'] * 1e3:10.3f} ms {k['calls']:6d} x "
              f"{k['name'][:90]}")
    for k, gbs in r.get("sweep_rate_gbs", {}).items():
        print(f"  {k}: {r['sweep_bytes'][k] / 1e9:.3f} GB of blocks in "
              f"{r['sweep_device_s'][k]:.4f} s = {gbs:.1f} GB/s, "
              f"{100 * gbs / copy_gbs:.2f}% of the measured copy rate")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--refine", type=float, nargs="*", default=[1, 4],
                    help="motor refine levels (none: no motor step)")
    ap.add_argument("--w1", type=int, nargs="*", default=[],
                    help="W1 mesh sizes nel")
    ap.add_argument("--shell", nargs="*", default=[],
                    choices=sorted(SHELL_CONFIGS),
                    help="shell step configurations at n_shell=(24, 400)")
    ap.add_argument("--fsi", action="store_true",
                    help="the FSI anchor's optimization iteration")
    ap.add_argument("--fsi-dynamic", action="store_true",
                    help="the W8 rung's trajectory gradient")
    ap.add_argument("--factor-method", choices=("thomas", "cr"),
                    default="thomas",
                    help="the FSI runs' factor (cr: f64 storage)")
    ap.add_argument("--refactor-every", type=int, default=1,
                    help="motor step: factor every N Newton iterations")
    ap.add_argument("--freeze-operator", action="store_true",
                    help="motor step: freeze the operator between factors")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--out", default="chiprun_out/profile_step.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_step needs a CUDA device")
    set_precision("float64")
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    copy_gbs = copy_rate_gbs()
    print(f"device-to-device copy rate: {copy_gbs:.1f} GB/s (read + write)")
    results = []
    step_kw = {}
    if args.refactor_every != 1:
        step_kw["refactor_every"] = args.refactor_every
    if args.freeze_operator:
        step_kw["freeze_operator"] = True
    runs = ([lambda v=v: profile_refine(v, args.steps, **step_kw)
             for v in args.refine]
            + [lambda v=v: profile_w1(v, args.steps) for v in args.w1]
            + [lambda v=v: profile_shell(v, args.steps)
               for v in args.shell]
            + ([lambda: profile_fsi(args.steps, args.factor_method)]
               if args.fsi else [])
            + ([lambda: profile_fsi_dynamic(args.steps, args.factor_method)]
               if args.fsi_dynamic else []))
    for run in runs:
        r = run()
        _summary(r, copy_gbs)
        results.append(r)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": card, "torch": torch.__version__,
                   "copy_rate_gbs": copy_gbs, "runs": results}, f, indent=1)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
