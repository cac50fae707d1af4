#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (femo_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, one result line each; any failure raises and the script exits
non-zero without the final line:

1. device: the card's name and power limit (nvidia-smi); no CUDA -> fail.
2. build: the native host library (g++) and both CUDA sources, the
   block-Thomas sweeps (bt_sweeps.cu) and the SpMV kernels (spmv.cu),
   with nvcc for sm_90a from this checkout, the compilers started at once.
3. kernels: K1/K2 against their plain PyTorch versions on the card —
   synthetic blocks (nb in {1, 2, 3, 9}, B in {128, 160, 256, 512}, f32
   and f64, plus the unscaled B=256 system in f64) and the real refine-1
   mesh-motion and EM factors, each kernel launched twice and required to
   give the same bits — and their times at the refine-1 mesh-motion shapes
   (median of CUDA-event timings, and the profiler's device time) beside
   their bounds, with the launch geometry and the time per dependent
   phase.
4. the motor optimization step at refine 1, f64, on the card, in the f64
   oracle's configuration: loss against experiments/motor_latency_oracle
   .json, the gradient, each sweep kernel's launch count, and agreement
   with the same step on CPU tensors (plain sweeps).
5. the same step at refine 4 (the reference's largest dof class), then
   K1/K2 against the plain sweeps on its mesh-motion (B=512) and EM
   (B=256) factors, with their times there; these are in the kernels line
   too.
6. SpMV: K4/K4T (element), K3 (ELL) and K5 (RCM band) against their plain
   versions (f64 1e-14, f32 1e-6) and each other on the W1 operator at
   nel=260; K5, which reads a plan of the band's nonzero diagonal
   segments, also on the W1 band with the rounding leftovers of its
   cancelling couplings zeroed, on the BC-constrained W1 band, on the band
   of stiffness plus mass (no exact zero among its CSR entries) and on
   synthetic bands
   (n from 1, b up to 2999), each launched twice and required to give the
   same bits; the port of experiments/pallas_spmv.py's self-test with the
   K3/K5 counts reset just before it; times of each kernel, its plain
   version and torch.sparse.mm on the CSR, beside the bound: CUDA events
   around single calls, and the profiler's device time per call, which
   leaves out the host time between launches.  K5 is timed on all four
   nel=260 bands, beside the bound on the band's nonzeros (with x and y),
   the bound on what it reads and the dense band's bound, with the band's
   nonzero count, its plan's segments, bytes and build time.
7. W1, the Poisson source-control optimization, at nel=260 in f64 through
   the graph API (build_fea, FEAModel, Simulator.run, objective_gradient)
   with the K4/K4T counts reset just before and read just after: loss and
   gradient against the JAX oracle (oracles/w1_poisson_nel260.npz), the
   launches against BiCGStab's iterations, wall times, and the
   manufactured-solution error norm; then SLSQP(maxiter=3) at nel=32 and
   the card against CPU tensors at nel=64.
8. bench.py's refine-4 configuration (Shamanskii factor reuse,
   refactor_every=3): loss (1e-7) and gradient (1e-6) against the JAX
   package's values in oracles/motor_oracle.npz, 7 factors and 170 K1 +
   170 K2 launches per step, the warm step beside refactor_every=1's.
9. bench.py's refine-1 rung (refactor_every=3 with freeze_operator) and
   reuse alone at refine 1: the oracle (1e-8, 1e-6), 7 factors, 7 (17
   without freezing) Jacobian assemblies and 170 K1/K2 launches per step,
   warm steps, the frozen step against CPU tensors (1e-10, 1e-7).
10. refine 1 with factorization="lu" (no sweep) and design_space="basis",
   each against the oracle.
11. the eager graph-API model (build_motor_model, Simulator.run,
   objective_gradient) at refine 1 with LinearSolver("scipy") and with
   LinearSolver("block_thomas"), whose K1/K2 launches across the call must
   be > 0: outputs (torque, areas, losses; 1e-8), the |B| field (1e-8) and
   the gradient (1e-6) against the oracle.
12. the imported unstructured mesh (write_motor_msh, import_mesh) through
   the step in the oracle configuration, against the oracle, with K1/K2
   against plain on its factors.
   In phases 4 and 8-12 the K1/K2 counts are set to 0 just before each
   path and read just after; the factors, Jacobian assemblies and block
   solves are counted by the step profiler's layer ranges.
13. determinism (run after phase 7): the assembly scatters sum through
   owner tables in a fixed order, so two runs give the same bits: the
   nel=260 W1 residual, its VJP, the Jacobian's diagonal, the nel=64
   dense Jacobian, the refine-4 mesh-motion template fill; W1's
   objective_gradient at nel=260 in two fresh simulators (equal loss and
   gradient bits, equal BiCGStab counts, printed beside JAX's, and the
   W1 oracle's gates); the card band's nonzeros.
14. w1_weak: W1 with symmetric Nitsche weak BCs at nel=260 (68,121 dofs,
   no strong BC), run and objective_gradient, against
   oracles/slice_c_oracle.npz (loss 1e-8, gradient 1e-6).
15. w2: nonlinear Poisson with symmetric Nitsche terms and SNES
   backtracking at nel=260, run and objective_gradient, the same gates.
16. jit_step: build_jit_opt_step(nel=260, "cg"), the matrix-free
   Newton-Krylov step with its jvp/vjp matvecs (1e-8, 1e-6); entry() at
   nel=32, dense (1e-12, 1e-10).
17. shape: the W10 shape gradient of an energy functional with a ds term
   on the nel=260 square, against the oracle and CPU tensors (1e-12).
18. topopt: W4 SIMP at 160 x 80 quads (26,082 dofs, BiCGStab + Jacobi),
   run and objective_gradient against the oracle (1e-8, 1e-6); the
   example's 40 x 20 through SLSQP(maxiter=15), compliance below 0.7 of
   its start.
19. beam: W3 Hermite beam at 50 elements through SLSQP to the OpenMDAO
   optimum (max |t - ref| < 1e-4).
   In phases 14, 15 and 18 the K4/K4T counts are set to 0 just before
   the path and read just after, and must equal BiCGStab's matvecs.
   After each of these paths, K4/K4T are held against their plain
   versions (f64 1e-14) on the path's own Jacobians: every element block
   alone (W4's 8x8 quad-elasticity blocks too), then the matrix's
   matvec/rmatvec, whose later blocks add into the first block's output,
   twice bit for bit; in phase 14 K1/K2 against plain (f64 1e-12) and
   timed on the block-Thomas factors that preconditioned the solves.

Each phase prints its wall seconds.  It prints a JSON line describing
the kernels (K1/K2 with their launches on every motor path, K4/K4T on
W1, W1 with weak BCs, W2 and W4), and last
{"ok": true, "device": {...}}.  Imports nothing of JAX.
"""

from __future__ import annotations

import collections
import json
import os
import statistics
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import scipy.sparse as sp
import torch
from torch.autograd import DeviceType

import femo_tpu_torch
from femo_tpu_torch import native
from femo_tpu_torch.mesh.gmsh_io import import_mesh, read_association_table
from femo_tpu_torch.models.motor.model import (
    build_motor_jit_step, build_motor_model, edge_delta_design_space)
from femo_tpu_torch.models.motor.unstructured import write_motor_msh
from femo_tpu_torch.models.motor.pde import source_tables
from femo_tpu_torch.entry import entry
from femo_tpu_torch.fea.assemble import assemble_matrix, compile_form
from femo_tpu_torch.fea.fea import FEA
from femo_tpu_torch.fea.forms import FormDef, dot, ds, dx, grad
from femo_tpu_torch.fea.shape import shape_gradient
from femo_tpu_torch.fea.space import Function, FunctionSpace
from femo_tpu_torch.fea.utils import errorNorm
from femo_tpu_torch.graph.model import FEAModel
from femo_tpu_torch.graph.optimizer import OptimizationProblem, SLSQP
from femo_tpu_torch.graph.simulator import Simulator
from femo_tpu_torch.mesh.generators import create_unit_square_mesh
from femo_tpu_torch.models.beam import OPENMDAO_THICK_REF, build_beam_problem
from femo_tpu_torch.models.poisson import (
    build_fea, build_jit_opt_step, on_boundary)
from femo_tpu_torch.models.topopt import build_topopt_model
from femo_tpu_torch.ops import bt_sweeps, spmv
from femo_tpu_torch.ops.block_tridiag import BlockTridiagonalMatrix
from femo_tpu_torch.solvers.krylov import cg
from femo_tpu_torch.solvers.linear import (
    BlockThomasKrylovFactorization, KrylovFactorization, LinearSolver)
from femo_tpu_torch.tools.profile_step import layer_ranges

# experiments/motor_latency_oracle.json (the JAX package, f64, CPU)
ORACLE = {1: 28.709006394182538, 4: 30.388014626154067}
ORACLE_CFG = dict(em_load_steps=3, mm_newton_iters=3, em_newton_iters=3,
                  factorization="block_thomas", pcg_iters=8,
                  design_space="edge_deltas")
# sweep solves per step: (1 solve + 1 PCG start + 8 PCG iterations) per
# Newton iteration and per adjoint; 2x3 mesh-motion + 3x3 EM Newton
# iterations and 2 adjoints
SOLVES_PER_STEP = (1 + 1 + ORACLE_CFG["pcg_iters"]) * (2 * 3 + 3 * 3 + 2)
SWEEP_TOL = {torch.float32: 1e-6, torch.float64: 1e-12}


def rel(a, b):
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def phase_device():
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this script drives the port on "
                           "the card and has no CPU mode")
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    print(f"device: torch {torch.__version__} cuda {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    return card


def phase_build():
    """The native host library (g++) and both CUDA sources (nvcc), each
    compiler started at once in its own thread."""
    def timed(fn):
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:
        futs = [pool.submit(timed, m.get_lib)
                for m in (native, bt_sweeps, spmv)]
        t_native, t_bt, t_spmv = (f.result() for f in futs)
    print(f"build ({time.perf_counter() - t0:.2f} s in all): native g++ "
          f"{t_native:.2f} s; nvcc {' '.join(bt_sweeps.NVCC_FLAGS)}: "
          f"{bt_sweeps.SRC} {t_bt:.2f} s, {spmv.SRC} {t_spmv:.2f} s")
    for log in (bt_sweeps.build_log, spmv.build_log):
        for ln in log.splitlines():
            if "registers" in ln or "Compiling entry" in ln:
                print(f"  ptxas: {ln.strip()}")


def synthetic(nb, B, dtype, seed, scaled=True):
    """Well-conditioned block-tridiagonal system, factored on the card:
    the JAX package's tests/test_pallas_bt.py system.  With `scaled` its
    random parts scale with sqrt(128/B) (no change at B=128) so that the
    conditioning, and with it the f32 rounding a sweep amplifies, does not
    grow with B."""
    rng = np.random.default_rng(seed)
    a = np.sqrt(128 / B) if scaled else 1.0
    D = np.tile(np.eye(B) * 4.0, (nb, 1, 1)) \
        + 0.02 * a * rng.standard_normal((nb, B, B))
    D = 0.5 * (D + np.swapaxes(D, 1, 2))
    L = 0.1 * a * rng.standard_normal((nb, B, B))
    L[0] = 0
    U = np.swapaxes(np.roll(L, -1, axis=0), 1, 2).copy()
    U[-1] = 0
    t = lambda a: torch.as_tensor(a, dtype=dtype, device="cuda")
    mat = BlockTridiagonalMatrix(t(D), t(L), t(U), np.arange(nb * B),
                                 nb * B)
    return mat.factor(), t(rng.standard_normal((nb, B)))


def cond(mat):
    """2-norm condition number of the block-tridiagonal matrix, dense."""
    nb, B = mat.nb, mat.B
    A = torch.zeros((nb * B, nb * B), dtype=torch.float64,
                    device=mat.D.device)
    for i in range(nb):
        r = slice(i * B, (i + 1) * B)
        A[r, r] = mat.D[i]
        if i > 0:
            A[r, (i - 1) * B:i * B] = mat.L[i]
        if i < nb - 1:
            A[r, (i + 1) * B:(i + 2) * B] = mat.U[i]
    return float(torch.linalg.cond(A))


def step_residuals(fac, bb, z, x, z_in):
    """Each step of the two sweeps recomputed in plain PyTorch from the
    kernel's own previous value: ||z - Sinv (b - L z_prev)|| / ||z|| for
    K1 and ||x - (z_in - C x_next)|| / ||x|| for K2 (z_in: the z K2 was
    given).  A wrong step shows whatever the system's conditioning; a
    right one leaves only one step's rounding."""
    m = fac.mat
    mv = lambda M, v: torch.bmm(M, v[..., None])[..., 0]  # noqa: E731
    z_prev = torch.cat([torch.zeros_like(z[:1]), z[:-1]])
    x_next = torch.cat([x[1:], torch.zeros_like(x[:1])])
    rz = z - mv(fac.Sinv, bb - mv(m.L, z_prev))
    rx = x - (z_in - mv(fac.C, x_next))
    return (float(torch.linalg.norm(rz) / torch.linalg.norm(z)),
            float(torch.linalg.norm(rx) / torch.linalg.norm(x)))


def reordered_spread(fac, bb, x_p, seeds=3):
    """How far the plain solve moves when the sums inside its block
    products run in another order (a random permutation of each block's
    columns, `seeds` of them): the rounding the factor's recurrences
    amplify, the most two correct evaluations may differ by."""
    m, B = fac.mat, bb.shape[1]
    out = 0.0
    for seed in range(seeds):
        p = torch.as_tensor(np.random.default_rng(100 + seed).permutation(B),
                            device=bb.device)
        Sp, Lp, Cp = fac.Sinv[:, :, p], m.L[:, :, p], fac.C[:, :, p]
        z, zs = torch.zeros_like(bb[0]), []
        for i in range(bb.shape[0]):
            z = Sp[i] @ (bb[i] - Lp[i] @ z[p])[p]
            zs.append(z)
        x, xs = torch.zeros_like(bb[0]), [None] * bb.shape[0]
        for i in range(bb.shape[0] - 1, -1, -1):
            x = zs[i] - Cp[i] @ x[p]
            xs[i] = x
        out = max(out, rel(torch.stack(xs), x_p))
    return out


def check_sweeps(fac, bb, label, err, spread=False):
    """Kernel vs plain for K1, K2 and the whole solve, each sweep's steps
    recomputed from the kernel's own values (step_residuals), and a
    second launch of each kernel bit for bit against the first; returns
    rel err.  The bar of the kernel-vs-plain difference is SWEEP_TOL; with
    `spread`, for a factor whose recurrences amplify rounding past it,
    the larger of SWEEP_TOL and 10 times the plain solve's own spread
    under reordered sums (reordered_spread); the step residuals are held
    to SWEEP_TOL either way."""
    m = fac.mat
    z_k = bt_sweeps.fwd_sweep_cuda(fac.Sinv, m.L, bb)
    z_k2 = bt_sweeps.fwd_sweep_cuda(fac.Sinv, m.L, bb)
    z_p = bt_sweeps.fwd_sweep_plain(fac.Sinv, m.L, bb)
    x_k = bt_sweeps.bwd_sweep_cuda(fac.C, z_p)
    x_k2 = bt_sweeps.bwd_sweep_cuda(fac.C, z_p)
    x_p = bt_sweeps.bwd_sweep_plain(fac.C, z_p)
    x_solve = bt_sweeps.bt_sweep_solve(fac.Sinv, m.L, fac.C, bb)
    torch.cuda.synchronize()
    r = max(rel(z_k, z_p), rel(x_k, x_p), rel(x_solve, x_p))
    res = step_residuals(fac, bb, z_k, x_k, z_p)
    tol = SWEEP_TOL[bb.dtype]
    bar, why = tol, ""
    if spread:
        s = reordered_spread(fac, bb, x_p)
        bar = max(tol, 10 * s)
        why = f", 10x the plain solve's spread {s:.3e} under reordered sums"
    same = torch.equal(z_k, z_k2) and torch.equal(x_k, x_k2)
    print(f"  {label}: rel L2 {r:.3e} (bar {bar:.0e}{why}); step residuals "
          f"K1 {res[0]:.3e}, K2 {res[1]:.3e} (tol {tol:.0e}); second launch "
          f"bit-identical {same}")
    if not r <= bar:
        raise AssertionError(f"{label}: kernel disagrees with plain, {r}")
    if not max(res) <= tol:
        raise AssertionError(f"{label}: a sweep step is wrong, {res}")
    if not same:
        raise AssertionError(f"{label}: two launches differ")
    if err is not None:
        err["K1"] = max(err["K1"], float((z_k - z_p).abs().max()))
        err["K2"] = max(err["K2"], float((x_k - x_p).abs().max()))
    return r


def cuda_ms(fn, reps=50, warm=5):
    """Median over reps of one call timed with CUDA events."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, kernel=None, per_call=1, reps=10, tries=5):
    """Device time of one call in ms: the summed durations of the kernels
    and copies that `reps` calls run, traced with torch.profiler, over
    reps.  Unlike cuda_ms it leaves out the host time between launches,
    which is most of a call whose kernels take microseconds.  The profiler
    can miss launches, most often in its first traces of a new shape, so
    it traces `reps` calls once as a warm-up, drops them and traces
    `reps` more, and keeps that trace only when it holds every launch:
    each device event name `reps` times a whole number of times, and the
    events named after `kernel` exactly per_call * reps times.  Otherwise
    it traces again; after `tries` incomplete traces the time is not
    measured (None), never read from an incomplete trace."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    sched = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
    for _ in range(tries):
        with torch.profiler.profile(activities=acts, schedule=sched) as prof:
            for _ in range(2):  # the warm-up cycle, then the traced one
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
        counts = collections.Counter(e.name for e in evs)
        named = sum(c for name, c in counts.items()
                    if kernel is not None and kernel in name)
        if (evs and all(c % reps == 0 for c in counts.values())
                and (kernel is None or named == per_call * reps)):
            return sum(e.time_range.elapsed_us() for e in evs) / reps / 1e3
        odd = [(n[:60], c) for n, c in counts.items() if c % reps]
        print(f"  (incomplete trace: {len(evs)} device events in {reps} "
              f"calls{f', {named} of {kernel}' if kernel else ''}, counts "
              f"not a multiple of {reps}: {odd[:3]})")
        time.sleep(0.2)
    print(f"  device time of {kernel or 'a call'}: not measured ({tries} "
          "incomplete traces)")
    return None


def fmt_ms(x, digits=4):
    """A time in ms, or "not measured" for None."""
    return "not measured" if x is None else f"{x:.{digits}f} ms"


def ratio(a, b):
    """a / b, or None when either time was not measured."""
    return None if a is None or b is None else a / b


def jacobian_factor(info, which, dv0, iq0, em_load_steps):
    """A Jacobian the step factors, block-Thomas factored on the card:
    "mm" at half the boundary displacement of dv0, "em" the first EM
    Newton iteration (A_z = 0, first load step) on that displacement."""
    tpl, jac = info["jac"][which]
    scatter = edge_delta_design_space(info["mesh"], info["Vmm"])[0]
    g = scatter(dv0)
    if which == "mm":
        u, p = 0.5 * g, {"uhat_bc": g}
    else:
        Ht, Jt = source_tables(iq0, torch.zeros_like(iq0))
        s = 1.0 / em_load_steps
        u = torch.zeros(info["Vem"].n_dofs, dtype=dv0.dtype,
                        device=dv0.device)
        p = {"uhat": 0.5 * g, "Htable": Ht * s, "Jtable": Jt * s}
    return tpl.matrix(jac(u, p)).factor()


def check_real_factors(info, dv0, iq0, refine, err):
    """K1/K2 against plain on the step's mesh-motion and EM factors (f64,
    1e-12), folding max |kernel - plain| into err.  Returns the factors
    with a right-hand side each."""
    out = {}
    rng = np.random.default_rng(7)
    for which in ("mm", "em"):
        fac = jacobian_factor(info, which, dv0, iq0,
                              ORACLE_CFG["em_load_steps"])
        nb, B = fac.Sinv.shape[:2]
        bb = torch.as_tensor(rng.standard_normal((nb, B)),
                             dtype=torch.float64, device="cuda")
        check_sweeps(fac, bb, f"refine-{refine} {which} factor nb={nb} "
                     f"B={B} float64", err)
        out[which] = (fac, bb)
    return out


def time_sweeps(fac, bb, label):
    """Kernel and plain times, ms: the median of 50 CUDA-event timings of
    one call, and the profiler's device time per call (the kernel's own
    time plus the fill of its output with the not-yet-written mark), with
    the bounds, the launch geometry and the device time per dependent
    phase (2 nb - 1 for K1, nb - 1 for K2)."""
    m = fac.mat
    z = bt_sweeps.fwd_sweep_plain(fac.Sinv, m.L, bb)
    fns = {
        "K1": lambda: bt_sweeps.fwd_sweep_cuda(fac.Sinv, m.L, bb),
        "K1_plain": lambda: bt_sweeps.fwd_sweep_plain(fac.Sinv, m.L, bb),
        "K2": lambda: bt_sweeps.bwd_sweep_cuda(fac.C, z),
        "K2_plain": lambda: bt_sweeps.bwd_sweep_plain(fac.C, z),
    }
    nb, B = bb.shape
    s = bb.element_size()
    # each input read once, each output written once; 2 B^2 flops a block
    t = {"K1_bound": bound_ms((2 * nb * B * B + 2 * nb * B) * s,
                              4 * nb * B * B, bb.dtype),
         "K2_bound": bound_ms((nb * B * B + 2 * nb * B) * s,
                              2 * nb * B * B, bb.dtype)}
    t.update({k: cuda_ms(fn) for k, fn in fns.items()})
    names = {"K1": "bt_fwd_kernel", "K2": "bt_bwd_kernel"}
    t.update({f"{k}_device": device_ms(fn, names.get(k))
              for k, fn in fns.items()})
    print(f"  time, {label} nb={nb} B={B} f64 (median of 50, CUDA events): "
          f"K1 {t['K1']:.4f} ms vs plain {t['K1_plain']:.4f} ms, bound "
          f"{t['K1_bound'][0]:.4f} ms; K2 {t['K2']:.4f} ms vs plain "
          f"{t['K2_plain']:.4f} ms, bound {t['K2_bound'][0]:.4f} ms")
    print(f"  device time per call (profiler, 10 calls): K1 "
          f"{fmt_ms(t['K1_device'])} vs plain "
          f"{fmt_ms(t['K1_plain_device'])}; K2 {fmt_ms(t['K2_device'])} vs "
          f"plain {fmt_ms(t['K2_plain_device'])}")
    phases = {"K1": 2 * nb - 1, "K2": max(nb - 1, 1)}
    for k in ("K1", "K2"):
        plan = bt_sweeps.sweep_plan(k, nb, B, bb.dtype,
                                     bt_sweeps._sms(bb.device.index))
        t[f"{k}_geometry"] = dict(ctas=plan.ctas, rows=plan.rows,
                                  stages=plan.stages, smem=plan.smem)
        dev = t[f"{k}_device"]
        t[f"{k}_us_per_phase"] = ratio(dev, phases[k] / 1e3)
        share = ratio(t[f"{k}_bound"][0], dev)
        speed = ratio(t[f"{k}_plain_device"], dev)
        print(f"  {k}: G={plan.ctas} CTAs x R={plan.rows} rows, S="
              f"{plan.stages} stages, {plan.smem} B shared memory"
              + ("; device time not measured" if share is None else
                 f"; {t[f'{k}_us_per_phase']:.3f} us per dependent phase "
                 f"({phases[k]}); {100 * share:.1f}% of the bound")
              + ("" if speed is None else
                 f"; {speed:.2f}x the plain version's speed"))
    t["shape"] = dict(label=label, nb=nb, B=B)
    return t


def phase_kernels(info1, dv0, iq0):
    print("kernels: K1/K2 against the plain sweeps on the card")
    for dtype in (torch.float32, torch.float64):
        for B in (128, 160, 256, 512):
            for nb in (1, 2, 3, 9):
                fac, bb = synthetic(nb, B, dtype, seed=nb * 1000 + B)
                check_sweeps(fac, bb, f"synthetic nb={nb} B={B} "
                             f"{str(dtype)[6:]}", None)
    for nb in (1, 3, 9):
        fac, bb = synthetic(nb, 256, torch.float64, seed=nb * 1000 + 256,
                            scaled=False)
        check_sweeps(fac, bb, f"synthetic unscaled nb={nb} B=256 float64",
                     None)
    for B in (128, 256):
        for scaled in (True, False):
            fac, _ = synthetic(9, B, torch.float64, seed=9000 + B,
                               scaled=scaled)
            kind = "scaled" if scaled else "unscaled"
            print(f"  synthetic nb=9 B={B} {kind}: cond_2 "
                  f"{cond(fac.mat):.4e}")
    err = {"K1": 0.0, "K2": 0.0}
    fac, bb = check_real_factors(info1, dv0, iq0, 1, err)["mm"]
    return time_sweeps(fac, bb, "refine-1 mm"), err


def synced(fn):
    """(wall seconds of fn() between two device syncs, its result)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def warm_seconds(step, dv, iq, n):
    """The least wall time of n more calls of step(dv, iq)."""
    return min(synced(lambda: step(dv, iq))[0] for _ in range(n))


def counted_path(fn, label):
    """fn() with the K1/K2 counts reset just before and read just after,
    and the factors, Jacobian assemblies and block solves it ran counted
    (the step profiler's layer ranges); returns (seconds, fn's result,
    launches, calls)."""
    reset(bt_sweeps.launches)
    with layer_ranges() as lr:
        t, out = synced(fn)
    launches = dict(bt_sweeps.launches)
    print(f"  {label}: {t:.3f} s; K1 {launches['K1']}, K2 "
          f"{launches['K2']} launches; {lr.calls['bt.factor']} factors, "
          f"{lr.calls['assemble.jacobian']} Jacobian assemblies, "
          f"{lr.calls['bt.solve']} block solves")
    return t, out, launches, dict(lr.calls)


def expect(label, got, want):
    if got != want:
        raise AssertionError(f"{label}: {got}, expected {want}")


def check_step(refine, loss, g_dv, g_iq, n_dv, rtol):
    r = abs(float(loss) - ORACLE[refine]) / ORACLE[refine]
    ok = (r <= rtol and tuple(g_dv.shape) == (n_dv,)
          and bool(torch.isfinite(g_dv).all()) and bool(g_dv.abs().max() > 0)
          and bool(torch.isfinite(g_iq)) and float(g_iq) != 0.0)
    print(f"  loss {float(loss)!r}, oracle {ORACLE[refine]!r}, rel "
          f"{r:.3e} (tol {rtol:.0e}); g_dv {tuple(g_dv.shape)} |g_dv| "
          f"{float(torch.linalg.norm(g_dv)):.6e}, g_iq {float(g_iq):.6e}")
    if not ok:
        raise AssertionError(f"refine {refine} step is wrong")


def phase_refine1(step, dv0, iq0, info):
    print(f"motor step, refine 1, f64, cuda: mm nb={info['bt']['mm']['nb']} "
          f"B={info['bt']['mm']['B']}, em nb={info['bt']['em']['nb']} "
          f"B={info['bt']['em']['B']}")
    cold, (loss, (g_dv, g_iq)), launches, _ = counted_path(
        lambda: step(dv0, iq0), "first step")
    expect("K1/K2 launches", launches,
           {"K1": SOLVES_PER_STEP, "K2": SOLVES_PER_STEP})
    check_step(1, loss, g_dv, g_iq, 576, 1e-8)
    warm = warm_seconds(step, dv0, iq0, 3)
    print(f"  step wall time: first call {cold:.3f} s, warm {warm:.3f} s "
          "(least of 3)")

    step_c, (dv_c, iq_c), _ = build_motor_jit_step(refine=1, device="cpu",
                                                   **ORACLE_CFG)
    t0 = time.perf_counter()
    loss_c, (g_dv_c, g_iq_c) = step_c(dv_c, iq_c)
    t_cpu = time.perf_counter() - t0
    rl = abs(float(loss_c) - float(loss)) / abs(float(loss))
    g = torch.cat([g_dv, g_iq.reshape(1)]).cpu()
    gc = torch.cat([g_dv_c, g_iq_c.reshape(1)])
    rg = rel(g, gc)
    print(f"  card vs CPU tensors (plain sweeps, {t_cpu:.3f} s): loss rel "
          f"{rl:.3e} (tol 1e-10), gradient rel L2 {rg:.3e} (tol 1e-7)")
    if not (rl <= 1e-10 and rg <= 1e-7):
        raise AssertionError("card and CPU steps disagree")
    return launches, warm


def phase_refine4(err):
    t0 = time.perf_counter()
    step, (dv0, iq0), info = build_motor_jit_step(refine=4, device="cuda",
                                                  **ORACLE_CFG)
    t_build = time.perf_counter() - t0
    bt = info["bt"]
    print(f"motor step, refine 4, f64, cuda: {info['mesh'].n_cells} cells, "
          f"mm nb={bt['mm']['nb']} B={bt['mm']['B']} bw={bt['mm']['bw']}, "
          f"em nb={bt['em']['nb']} B={bt['em']['B']} bw={bt['em']['bw']}; "
          f"build {t_build:.2f} s")
    cold, (loss, (g_dv, g_iq)), launches, _ = counted_path(
        lambda: step(dv0, iq0), "first step")
    expect("K1/K2 launches", launches,
           {"K1": SOLVES_PER_STEP, "K2": SOLVES_PER_STEP})
    check_step(4, loss, g_dv, g_iq, dv0.numel(), 1e-7)
    warm = warm_seconds(step, dv0, iq0, 2)
    print(f"  step wall time: first call {cold:.3f} s, warm {warm:.3f} s "
          "(least of 2)")
    return [time_sweeps(fac, bb, f"refine-4 {which}")
            for which, (fac, bb) in check_real_factors(info, dv0, iq0, 4,
                                                       err).items()], \
        warm, info, dv0


# ---------------------------------------------------------------------------
# The motor in the reference's production configuration (bench.py:70-87:
# Shamanskii factor reuse, refine 1 also with the frozen operator), the
# dense-LU branch, the 2-dof design space, the eager graph-API model and the
# imported unstructured mesh, each against the JAX package's f64 values in
# oracles/motor_oracle.npz
# ---------------------------------------------------------------------------

MOTOR_ORACLE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "oracles", "motor_oracle.npz")
BENCH_CFG = dict(ORACLE_CFG, refactor_every=3)
# Newton iterations and adjoints per step: 2x3 mesh-motion + 3x3 EM, 2
NEWTON_ITERS, ADJOINTS = 2 * 3 + 3 * 3, 2
# factors at refactor_every=3: mesh motion 2 + 1 adjoint, EM 3 + 1
REUSE_FACTORS = 2 + 1 + 3 + 1
EAGER_DV = [5e-4, 3e-4]
EAGER_OUTPUTS = ("loss_sum", "torque", "magnet_area", "winding_area",
                 "steel_area", "eddy_current_loss", "hysteresis_loss")


def motor_oracle():
    return np.load(MOTOR_ORACLE)


def check_oracle(label, loss, g_dv, g_iq, oracle, key, loss_tol, grad_tol):
    """Loss (relative) and gradient (g_dv, g_iq; relative L2) against the
    JAX package's values `key` of oracles/motor_oracle.npz."""
    want_l = float(oracle[f"{key}_loss"])
    want_g = np.concatenate([oracle[f"{key}_g_dv"],
                             [float(oracle[f"{key}_g_iq"])]])
    g = np.concatenate([g_dv.detach().cpu().numpy(), [float(g_iq)]])
    rl = abs(float(loss) - want_l) / abs(want_l)
    rg = float(np.linalg.norm(g - want_g) / np.linalg.norm(want_g))
    print(f"  {label}: loss {float(loss)!r}, JAX {want_l!r}, rel {rl:.3e} "
          f"(tol {loss_tol:.0e}); gradient ({g.size}) rel L2 {rg:.3e} (tol "
          f"{grad_tol:.0e})")
    if not (rl <= loss_tol and rg <= grad_tol and np.all(np.isfinite(g))):
        raise AssertionError(f"{label} disagrees with the JAX oracle")
    return rl, rg


def phase_refine4_bench(warm_re1):
    """bench.py's refine-4 configuration (refactor_every=3): the oracle,
    7 factors and 170 K1 + 170 K2 launches per step, the warm step beside
    refactor_every=1's in this run."""
    oracle = motor_oracle()
    step, (dv0, iq0), info = build_motor_jit_step(refine=4, device="cuda",
                                                  **BENCH_CFG)
    print(f"motor step, refine 4, bench.py's configuration "
          f"(refactor_every=3), f64, cuda: mm nb={info['bt']['mm']['nb']} "
          f"B={info['bt']['mm']['B']}, em nb={info['bt']['em']['nb']} "
          f"B={info['bt']['em']['B']}")
    cold, (loss, (g_dv, g_iq)), launches, calls = counted_path(
        lambda: step(dv0, iq0), "first step")
    check_oracle("refine 4, refactor_every=3", loss, g_dv, g_iq, oracle,
                 "r4_re3", 1e-7, 1e-6)
    expect("factors per step", calls["bt.factor"], REUSE_FACTORS)
    expect("K1/K2 launches", launches,
           {"K1": SOLVES_PER_STEP, "K2": SOLVES_PER_STEP})
    warm = warm_seconds(step, dv0, iq0, 2)
    print(f"  warm step {warm:.3f} s (least of 2) at "
          f"refactor_every=3 vs {warm_re1:.3f} s at refactor_every=1 in "
          f"this run; {calls['bt.factor']} factors vs "
          f"{NEWTON_ITERS + ADJOINTS}")
    return dict(launches=launches, factors=calls["bt.factor"],
                warm_s=warm, warm_re1_s=warm_re1, first_s=cold)


def phase_refine1_bench(warm_re1):
    """bench.py's refine-1 rung (refactor_every=3 with freeze_operator) and
    factor reuse alone: the oracle, the counts (7 Jacobian assemblies with
    the frozen operator, 17 without), the warm steps, and the frozen step
    on CUDA against CPU tensors."""
    oracle = motor_oracle()
    out = {}
    for key, kw, jac in (("r1_re3", {}, NEWTON_ITERS + ADJOINTS),
                         ("r1_re3_freeze", dict(freeze_operator=True),
                          REUSE_FACTORS)):
        cfg = dict(BENCH_CFG, **kw)
        step, (dv0, iq0), _ = build_motor_jit_step(refine=1, device="cuda",
                                                   **cfg)
        print(f"motor step, refine 1, refactor_every=3"
              f"{', freeze_operator' if kw else ''}, f64, cuda")
        cold, (loss, (g_dv, g_iq)), launches, calls = counted_path(
            lambda: step(dv0, iq0), "first step")
        check_oracle(key, loss, g_dv, g_iq, oracle, key, 1e-8, 1e-6)
        expect("factors per step", calls["bt.factor"], REUSE_FACTORS)
        expect("Jacobian assemblies per step", calls["assemble.jacobian"],
               jac)
        expect("K1/K2 launches", launches,
               {"K1": SOLVES_PER_STEP, "K2": SOLVES_PER_STEP})
        warm = warm_seconds(step, dv0, iq0, 3)
        print(f"  warm step {warm:.3f} s (least of 3) vs "
              f"{warm_re1:.3f} s at refactor_every=1 in this run; "
              f"{calls['assemble.jacobian']} Jacobian assemblies vs "
              f"{NEWTON_ITERS + ADJOINTS}")
        out[key] = dict(launches=launches, factors=calls["bt.factor"],
                        jacobians=calls["assemble.jacobian"],
                        warm_s=warm, first_s=cold)
    step_c, (dv_c, iq_c), _ = build_motor_jit_step(refine=1, device="cpu",
                                                   **cfg)
    loss_c, (g_dv_c, g_iq_c) = step_c(dv_c, iq_c)
    rl = abs(float(loss_c) - float(loss)) / abs(float(loss))
    rg = rel(torch.cat([g_dv, g_iq.reshape(1)]).cpu(),
             torch.cat([g_dv_c, g_iq_c.reshape(1)]))
    print(f"  card vs CPU tensors (frozen operator): loss rel {rl:.3e} (tol "
          f"1e-10), gradient rel L2 {rg:.3e} (tol 1e-7)")
    if not (rl <= 1e-10 and rg <= 1e-7):
        raise AssertionError("card and CPU frozen-operator steps disagree")
    out["r1_re3"]["warm_re1_s"] = out["r1_re3_freeze"]["warm_re1_s"] = \
        warm_re1
    return out


def phase_refine1_lu_basis():
    """The dense-LU branch (edge deltas) and the 2-dof design space (block
    Thomas), each at refine 1 against the oracle."""
    oracle = motor_oracle()
    out = {}
    for key, kw, solves in (
            ("r1_lu", dict(ORACLE_CFG, factorization="lu"), 0),
            ("r1_basis", dict(ORACLE_CFG, design_space="basis"),
             SOLVES_PER_STEP)):
        step, (dv0, iq0), _ = build_motor_jit_step(refine=1, device="cuda",
                                                   **kw)
        print(f"motor step, refine 1, factorization={kw['factorization']}, "
              f"design_space={kw['design_space']} ({dv0.numel()} dvs), "
              "f64, cuda")
        t, (loss, (g_dv, g_iq)), launches, _ = counted_path(
            lambda: step(dv0, iq0), "first step")
        check_oracle(key, loss, g_dv, g_iq, oracle, key, 1e-8, 1e-6)
        expect("K1/K2 launches", launches, {"K1": solves, "K2": solves})
        warm = warm_seconds(step, dv0, iq0, 1)
        print(f"  warm step {warm:.3f} s")
        out[key] = dict(launches=launches, warm_s=warm, first_s=t)
    return out


def phase_eager_model():
    """The eager graph model (build_motor_model -> Simulator.run ->
    objective_gradient) at refine 1 with 3 EM load steps and shape_dv =
    (5e-4, 3e-4), with LinearSolver("scipy") and with "block_thomas" (every
    Newton and adjoint solve through K1/K2, counted across the call), each
    against the JAX package's scipy run."""
    oracle = motor_oracle()
    out = {}
    for method in ("scipy", "block_thomas"):
        model, d = build_motor_model(
            refine=1, em_load_steps=3, device="cuda",
            linear_solver=LinearSolver(method=method))
        sim = Simulator(model)
        sim["shape_dv"] = np.array(EAGER_DV)
        print(f"eager motor model, refine 1, LinearSolver({method!r}), "
              "f64, cuda: Simulator.run + objective_gradient")

        def run_and_gradient():
            outs = sim.run()
            return outs, sim.objective_gradient("loss_sum",
                                                ["shape_dv", "iq"])

        t, (outs, (val, grads, _)), launches, calls = counted_path(
            run_and_gradient, "run + objective_gradient")
        worst = 0.0
        for k in EAGER_OUTPUTS:
            want = float(oracle[f"eager_r1_{k}"])
            worst = max(worst, abs(float(outs[k]) - want) / abs(want))
        B = outs["B_magnitude"]
        rb = rel(B, torch.as_tensor(oracle["eager_r1_B_magnitude"],
                                    device=B.device))
        print(f"  torque {float(outs['torque']):.10g} N m, areas magnet "
              f"{float(outs['magnet_area']):.6e}, winding "
              f"{float(outs['winding_area']):.6e}, steel "
              f"{float(outs['steel_area']):.6e} m^2; |B| field "
              f"{tuple(B.shape)}, max {float(B.max()):.4f} T; outputs vs "
              f"JAX: worst rel {worst:.3e} (tol 1e-8), |B| rel L2 "
              f"{rb:.3e} (tol 1e-8)")
        if not (worst <= 1e-8 and rb <= 1e-8):
            raise AssertionError(f"eager model outputs ({method}) disagree "
                                 "with the JAX oracle")
        check_oracle(f"objective_gradient ({method})", val,
                     grads["shape_dv"], grads["iq"], oracle, "eager_r1",
                     1e-8, 1e-6)
        if method == "block_thomas" and not (launches["K1"] > 0
                                             and launches["K2"] > 0):
            raise AssertionError(f"block_thomas eager model launched "
                                 f"{launches}")
        out[method] = dict(launches=launches, seconds=t,
                           factors=calls["bt.factor"])
    return out


def phase_unstructured(err):
    """The step on the unstructured mesh that write_motor_msh(refine=1,
    seed=0) writes and import_mesh reads back, in the oracle
    configuration; K1/K2 against plain on its mesh-motion factor."""
    oracle = motor_oracle()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "motor_u.msh")
        ini = write_motor_msh(path, refine=1, seed=0)
        mesh = import_mesh(path)
        table = read_association_table(ini)
    step, (dv0, iq0), info = build_motor_jit_step(
        mesh=mesh, device="cuda", **ORACLE_CFG)
    bt = info["bt"]
    print(f"motor step on the imported unstructured mesh (refine 1, seed 0):"
          f" {mesh.n_cells} cells, {len(table)} named regions, mm "
          f"nb={bt['mm']['nb']} B={bt['mm']['B']} bw={bt['mm']['bw']}, em "
          f"nb={bt['em']['nb']} B={bt['em']['B']} bw={bt['em']['bw']}, "
          f"{dv0.numel()} dvs")
    t, (loss, (g_dv, g_iq)), launches, _ = counted_path(
        lambda: step(dv0, iq0), "first step")
    check_oracle("unstructured_r1", loss, g_dv, g_iq, oracle,
                 "unstructured_r1", 1e-8, 1e-6)
    expect("K1/K2 launches", launches,
           {"K1": SOLVES_PER_STEP, "K2": SOLVES_PER_STEP})
    check_real_factors(info, dv0, iq0, "unstructured 1", err)
    return dict(launches=launches, first_s=t)


# ---------------------------------------------------------------------------
# W1: the Poisson source-control optimization through the graph API, and
# the SpMV kernels K3/K4/K5 on its operator
# ---------------------------------------------------------------------------

# The JAX package's f64 values (CPU), written to oracles/w1_poisson_nel260.npz
# by `JAX_PLATFORMS=cpu PYTHONPATH=. python oracles/w1_poisson_oracle.py`.
# The gradient (135,200 values) is read from that file; the scalars are:
W1_NEL, W1_OPT_NEL, W1_CHECK_NEL = 260, 32, 64
W1_ORACLE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "oracles", "w1_poisson_nel260.npz")
W1_LOSS = 1.3669991806257774e-05  # l2_functional at f = 0.5, nel=260
W1_ERROR_NORM = 5.192500444336616e-07  # manufactured solution, nel=260
W1_KRYLOV_ITERS = {"run": [397], "objective_gradient": [411]}  # BiCGStab
W1_SLSQP_OBJ = [1.3668314815810345e-05, 1.0959285162131653e-05,
                3.298265080312179e-06, 1.976006143168327e-06]  # nel=32
SPMV_TOL = {torch.float32: 1e-6, torch.float64: 1e-14}
# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, and
# operations/s outside the tensor cores by dtype
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.float32: 67e12, torch.float64: 34e12}


def bound_ms(nbytes, ops, dtype):
    """(least time in ms, "bytes" | "operations"): the larger of the bytes
    over the memory rate and the operations over the peak rate."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = ops / PEAK_OPS[dtype] * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def reset(counts):
    for k in counts:
        counts[k] = 0


def check_rel(label, got, want, tol):
    r = rel(got, want)
    print(f"  {label}: rel L2 {r:.3e} (tol {tol:.0e})")
    if not r <= tol:
        raise AssertionError(f"{label}: {r} > {tol}")
    return float((got - want).abs().max())


def w1_stiffness(nel):
    """The W1 state Jacobian (the CG1 stiffness) assembled on the card."""
    fea, d = build_fea(nel=nel, device="cuda")
    form = fea.states_dict["u"]["residual_form"]
    return compile_form(form).matrix(form.values(), "u"), d


def torch_csr(m):
    """A scipy CSR matrix as a torch CSR tensor on the card, in canonical
    form (sorted, distinct column indices in each row, which torch's
    invariant check demands)."""
    m = m.tocsr(copy=True)
    m.sum_duplicates()
    return torch.sparse_csr_tensor(
        torch.as_tensor(m.indptr, dtype=torch.int64),
        torch.as_tensor(m.indices, dtype=torch.int64),
        torch.as_tensor(m.data), size=m.shape, device="cuda",
        check_invariants=True)


def stiffness_mass(V):
    """Stiffness plus mass on V, assembled on the card.  The P1 mass term
    fills the couplings that cancel in the W1 stiffness on this mesh, so
    no stored entry of its CSR is an exact zero (7 in an interior row)."""
    return assemble_matrix(FormDef(
        [dx(lambda w, g: dot(grad(w.u), grad(w.v)) + w.u * w.v)],
        coeffs=[Function(V, "u")], test=V), "u")


def rcm_csr(csr, perm, free=None):
    """The matrix that spmv.banded_from_element_matrix bands (with `free`,
    the BC-constrained P A P + (I - P)) as a scipy CSR in its RCM order."""
    if free is not None:
        P = sp.diags(free.astype(csr.dtype))
        csr = P @ csr @ P + sp.diags((~free).astype(csr.dtype))
    return csr.tocsr()[perm][:, perm]


def synthetic_band(n, b, rng):
    """A band (n, 2b+1), numpy f64, for K5's edge cases (also made by
    tests/test_torch_spmv.py): a few nonzero diagonals (the outermost two
    among them), each zeroed whole in some tiles of 32 rows and not in
    others, single zeros inside segments, one all-zero row (n > 1)."""
    nd = 2 * b + 1
    diags = np.unique(np.r_[0, b, nd - 1, rng.integers(0, nd, 4)])
    vals = rng.standard_normal((n, len(diags)))
    for t in range(-(-n // spmv.TILE)):
        vals[t * spmv.TILE:(t + 1) * spmv.TILE,
             rng.random(len(diags)) < 0.4] = 0
    vals[rng.random(vals.shape) < 0.05] = 0
    band = np.zeros((n, nd))
    band[:, diags] = vals
    if n > 1:
        band[rng.integers(n)] = 0
    return band


def plan_stats(plan):
    """Segments per tile (mean, max) of a K5 plan and the bytes of its
    arrays (what K5 reads besides x)."""
    per_tile = torch.diff(plan.tile_ptr).double()
    return dict(tiles=plan.n_tiles, segments=plan.diag.numel(),
                per_tile_mean=float(per_tile.mean()) if plan.n_tiles else 0.0,
                per_tile_max=int(per_tile.max()) if plan.n_tiles else 0,
                bytes=sum(t.numel() * t.element_size()
                          for t in (plan.tile_ptr, plan.diag, plan.vals)))


def band_nonzeros(band):
    """(nonzeros, nonzeros at most 1e-14 of the largest |entry|) of a band:
    the second counts the rounding leftovers of couplings that cancel."""
    a = band.abs()
    return (int(torch.count_nonzero(a)),
            int(((a > 0) & (a <= 1e-14 * a.max())).sum()))


def check_k5(label, band, bw, x64, err):
    """K5 against the plain dense product on one band in f64 and f32,
    each with its own plan, each launched twice and required to give the
    same bits; folds max |K5 - plain| (f64) into err.  Returns the plans
    and K5's products by dtype."""
    plans, ys, out = {}, {}, []
    for dtype in (torch.float64, torch.float32):
        bnd, x = band.to(dtype), x64.to(dtype)
        plans[dtype] = plan = spmv.BandedSpMVPlan(bnd, bw)
        y1 = spmv.banded_spmv_cuda(plan, x)
        y2 = spmv.banded_spmv_cuda(plan, x)
        y_p = spmv.banded_spmv_plain(bnd, x, bw)
        torch.cuda.synchronize()
        tol = SPMV_TOL[dtype]
        r = float(torch.linalg.norm(y1 - y_p)) / max(
            float(torch.linalg.norm(y_p)), 1e-300)  # a band may give y = 0
        if not r <= tol:
            raise AssertionError(f"K5 vs plain, {label}, {dtype}: {r}")
        if not torch.equal(y1, y2):
            raise AssertionError(f"K5, {label}, {dtype}: two launches "
                                 "differ")
        if dtype == torch.float64:
            err["K5"] = max(err["K5"], float((y1 - y_p).abs().max()))
        ys[dtype] = y1
        out.append(f"{str(dtype)[6:]} rel L2 {r:.3e} (tol {tol:.0e})")
    s = plan_stats(plans[torch.float64])
    print(f"  K5 vs plain, {label} (n={band.shape[0]}, b={bw}): "
          f"{', '.join(out)}; second launch bit-identical; plan "
          f"{s['segments']} segments over {s['tiles']} tiles (mean "
          f"{s['per_tile_mean']:.2f}, max {s['per_tile_max']} per tile), "
          f"{s['bytes'] / 1e6:.3f} MB in f64")
    return plans, ys


def time_spmv(name, kernel, kern, plain, lib, nbytes, ops):
    """Kernel, plain and library times of one SpMV (f64): medians of 50
    CUDA-event timings of one call, and the profiler's device time per
    call (`kernel` is the CUDA kernel's name, which the kernel's trace must
    hold once a call); the bound on nbytes and ops."""
    check_rel(f"torch.sparse.mm vs {name}", lib()[:, 0], kern(),
              SPMV_TOL[torch.float64])
    bound = bound_ms(nbytes, ops, torch.float64)
    r = dict(ms=cuda_ms(kern), plain_ms=cuda_ms(plain),
             library_ms=cuda_ms(lib), bound=bound,
             device_ms=device_ms(kern, kernel),
             plain_device_ms=device_ms(plain),
             library_device_ms=device_ms(lib))
    print(f"  time {name}, f64 (median of 50, CUDA events): kernel "
          f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
          f"torch.sparse.mm {r['library_ms']:.4f} ms; device time per "
          f"call (profiler, 10 calls): kernel {fmt_ms(r['device_ms'])}, "
          f"plain {fmt_ms(r['plain_device_ms'])}, torch.sparse.mm "
          f"{fmt_ms(r['library_device_ms'])}; bound {r['bound'][0]:.4f} "
          f"ms ({nbytes / 1e6:.2f} MB)")
    return r


def time_k5(label, band, bw, plan, lib_csr, xp):
    """K5's times on one band (f64) beside three bounds: on the band's
    nonzeros with x and y (the bound of the function), on what K5 reads
    (the plan, x and y) and on the dense band; with the plan's build
    time: host wall time (median of 5, ending in a sync) and the
    profiler's device time per build."""
    s = plan_stats(plan)
    nnz, tiny = band_nonzeros(band)
    n, vec = band.shape[0], 2 * band.shape[0] * 8
    P = torch_csr(lib_csr)
    r = time_spmv(f"K5 ({label})", "banded_segment_kernel",
                  lambda: spmv.banded_spmv_cuda(plan, xp),
                  lambda: spmv.banded_spmv_plain(band, xp, bw),
                  lambda: torch.sparse.mm(P, xp[:, None]), nnz * 8 + vec,
                  2 * nnz)
    build = lambda: spmv.BandedSpMVPlan(band, bw)  # noqa: E731
    r.update(band=label, n=n, b=bw, band_nnz=nnz, band_tiny=tiny,
             csr_nnz=int(lib_csr.nnz), plan=s,
             plan_bound_ms=bound_ms(s["bytes"] + vec,
                                    2 * s["segments"] * spmv.TILE,
                                    torch.float64)[0],
             dense_bound_ms=bound_ms(band.numel() * 8 + vec,
                                     2 * band.numel(), torch.float64)[0],
             plan_build_ms=1e3 * statistics.median(
                 synced(build)[0] for _ in range(5)),
             plan_build_device_ms=device_ms(build))
    reached = ratio(r["bound"][0], r["device_ms"])
    print(f"  K5 ({label}): band {nnz} nonzeros, {tiny} of them at most "
          f"1e-14 of the largest; device time {fmt_ms(r['device_ms'])} vs "
          f"torch.sparse.mm {fmt_ms(r['library_device_ms'])} "
          f"(CSR, {r['csr_nnz']} stored entries); bound on the nonzeros, x "
          f"and y {r['bound'][0] * 1e3:.3f} us ({(nnz * 8 + vec) / 1e6:.2f} "
          f"MB, {'?' if reached is None else f'{100 * reached:.0f}'}% of "
          "it reached), "
          f"on what K5 reads {r['plan_bound_ms'] * 1e3:.3f} us "
          f"({(s['bytes'] + vec) / 1e6:.2f} MB), on the dense band "
          f"{r['dense_bound_ms'] * 1e3:.1f} us; plan "
          f"{s['per_tile_mean']:.2f} segments per tile (max "
          f"{s['per_tile_max']}), {s['bytes'] / 1e6:.3f} MB, built in "
          f"{r['plan_build_ms']:.3f} ms ({fmt_ms(r['plan_build_device_ms'])} "
          f"of device time)")
    return r


def spmv_selftest(A, ell, band, bw, perm, x, b):
    """The port of experiments/pallas_spmv.py::_selftest on the card: the
    ELL operator, the element matvec and the RCM band against the
    element matvec, then CG through the ELL operator shifted to SPD.
    Returns the CG iterations."""
    y_ref = A.matvec(x)
    rel_tol = SPMV_TOL[torch.float64]
    for label, y in (("ELL", ell.matvec(x)),
                     ("banded (RCM order)",
                      spmv.banded_spmv(band, x[perm], bw))):
        want = y_ref[perm] if label.startswith("banded") else y_ref
        r = rel(y, want)
        if not r <= rel_tol:
            raise AssertionError(f"self-test {label}: {r}")
    res = cg(lambda v: ell.matvec(v) + v, b, rtol=1e-10)
    r = float(torch.linalg.norm(b - (ell.matvec(res.x) + res.x))
              / torch.linalg.norm(b))
    print(f"  self-test: CG through the ELL operator, {res.iters} "
          f"iterations, converged {res.converged}, residual {r:.3e}")
    if not (res.converged and r < 1e-8):
        raise AssertionError("CG through the ELL operator failed")
    return res.iters


def phase_spmv():
    """K3/K4/K4T/K5 against their plain versions (f64 and f32) and each
    other on the nel=260 W1 operator; the ported self-test with the K3
    and K5 counts reset just before it; times of kernel, plain and
    torch.sparse.mm on the CSR (median of 50 CUDA-event timings)."""
    t0 = time.perf_counter()
    A, d = w1_stiffness(W1_NEL)
    b0 = A.blocks[0]
    n = A.shape[0]
    ne, nr, nc = b0.A.shape
    csr = A.to_scipy_csr()
    ell = spmv.ELLOperator(A)
    band, bw, perm = spmv.banded_from_element_matrix(A)
    perm_t = torch.as_tensor(perm, dtype=torch.int64, device="cuda")
    k = ell.vals.shape[1]
    print(f"SpMV kernels on the W1 stiffness, nel={W1_NEL}: n={n}, "
          f"{ne} elements ({nr}x{nc}), nnz={csr.nnz}, ELL k={k}, RCM "
          f"bandwidth b={bw} (band {band.numel() * 8 / 1e6:.1f} MB in f64); "
          f"set-up {time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(0)
    x64 = torch.as_tensor(rng.standard_normal(n), device="cuda")
    err = {"K3": 0.0, "K4": 0.0, "K4T": 0.0, "K5": 0.0}
    xp = x64[perm_t].contiguous()
    plans, y5 = check_k5("W1 stiffness", band, bw, xp, err)
    for dtype in (torch.float64, torch.float32):
        tol = SPMV_TOL[dtype]
        Ae, x = b0.A.to(dtype), x64.to(dtype)
        vals = ell.vals.to(dtype)
        out = {
            "K4": (spmv.element_spmv_cuda(Ae, b0.plan, x),
                   spmv.element_spmv_plain(Ae, b0.rows, b0.cols, x, n)),
            "K4T": (spmv.element_rspmv_cuda(Ae, b0.plan, x),
                    spmv.element_rspmv_plain(Ae, b0.rows, b0.cols, x, n)),
            "K3": (spmv.ell_spmv_cuda(vals, ell.cols, x),
                   spmv.ell_spmv_plain(vals, ell.cols, x)),
        }
        torch.cuda.synchronize()
        name = str(dtype)[6:]
        for kern, (y_k, y_p) in out.items():
            e = check_rel(f"{kern} vs plain, {name}", y_k, y_p, tol)
            if dtype == torch.float64:
                err[kern] = e
        y4 = out["K4"][0]
        check_rel(f"K3 vs K4, {name}", out["K3"][0], y4, tol)
        check_rel(f"K5 vs K4 (RCM order), {name}", y5[dtype], y4[perm_t],
                  tol)

    # K5 on the other bands: the W1 band without the rounding leftovers of
    # the couplings that cancel (those of the band assembled on the CPU are
    # exact zeros), the BC-constrained W1 operator, stiffness plus mass (no
    # exact zeros in its CSR), synthetic bands
    a = band.abs()
    band_z = torch.where(a <= 1e-14 * a.max(), 0.0, band)
    csr_z = csr.copy()
    csr_z.data[np.abs(csr_z.data) <= 1e-14 * np.abs(csr_z.data).max()] = 0
    csr_z.eliminate_zeros()
    plan_z = check_k5("W1 stiffness, leftovers zeroed", band_z, bw, xp,
                      err)[0][torch.float64]
    V = d["V"]
    free = ~np.isin(np.arange(n), V.locate_dofs_geometrical(on_boundary))
    band_c, bw_c, perm_c = spmv.banded_from_element_matrix(A, free=free)
    A7 = stiffness_mass(V)
    csr7 = A7.to_scipy_csr()
    band7, bw7, perm7 = spmv.banded_from_element_matrix(A7)
    print(f"  stiffness + mass: CSR {csr7.nnz} stored entries, "
          f"{int((csr7.data == 0).sum())} of them exact zeros, at most "
          f"{int(np.diff(csr7.indptr).max())} a row; RCM bandwidth {bw7}. "
          f"BC-constrained W1 band: {int((~free).sum())} constrained dofs, "
          f"bandwidth {bw_c}")
    xc = x64[torch.as_tensor(perm_c, device="cuda")].contiguous()
    x7 = x64[torch.as_tensor(perm7, device="cuda")].contiguous()
    plan_c = check_k5("W1 stiffness, BC-constrained", band_c, bw_c, xc,
                      err)[0][torch.float64]
    plan7 = check_k5("stiffness + mass", band7, bw7, x7,
                     err)[0][torch.float64]
    cases = [(n_, b_) for n_ in (1, 31, 32, 33, 100)
             for b_ in sorted({0, 1, n_ - 1})] + [(5000, 2000), (3000, 2999)]
    for i, (n_, b_) in enumerate(cases):
        band_s = synthetic_band(n_, b_, np.random.default_rng(100 + i))
        check_k5("synthetic", torch.as_tensor(band_s, device="cuda"), b_,
                 torch.as_tensor(rng.standard_normal(n_), device="cuda"),
                 err)
    # symmetric operator: K4T and K4 compute the same product
    check_rel("K4T vs K4, float64", spmv.element_rspmv_cuda(
        b0.A, b0.plan, x64), spmv.element_spmv_cuda(b0.A, b0.plan, x64),
        SPMV_TOL[torch.float64])

    reset(spmv.launches)
    cg_iters = spmv_selftest(A, ell, band, bw, perm_t, x64,
                             torch.as_tensor(rng.standard_normal(n),
                                             device="cuda"))
    path = {k: spmv.launches[k] for k in ("K3", "K5")}
    print(f"  self-test launches: K3 {path['K3']} (CG: 1 + {cg_iters} "
          f"iterations + 2 checks), K5 {path['K5']}")
    if path != {"K3": cg_iters + 1 + 2, "K5": 1}:
        raise AssertionError(f"self-test launches {path}")

    A_lib, At_lib = torch_csr(csr), torch_csr(csr.T.tocsr())
    plain = {
        "K4": lambda: spmv.element_spmv_plain(b0.A, b0.rows, b0.cols, x64,
                                              n),
        "K4T": lambda: spmv.element_rspmv_plain(b0.A, b0.rows, b0.cols,
                                                x64, n),
        "K3": lambda: spmv.ell_spmv_plain(ell.vals, ell.cols, x64),
    }
    kern = {
        "K4": lambda: spmv.element_spmv_cuda(b0.A, b0.plan, x64),
        "K4T": lambda: spmv.element_rspmv_cuda(b0.A, b0.plan, x64),
        "K3": lambda: spmv.ell_spmv_cuda(ell.vals, ell.cols, x64),
    }
    lib = {
        "K4": lambda: torch.sparse.mm(A_lib, x64[:, None]),
        "K4T": lambda: torch.sparse.mm(At_lib, x64[:, None]),
        "K3": lambda: torch.sparse.mm(A_lib, x64[:, None]),
    }
    vec = 2 * n * 8  # x read once, y written once
    nbytes = {
        "K4": ne * nr * nc * 8 + ne * (nr + nc) * 4 + vec,
        "K3": ell.vals.numel() * (8 + 4) + vec,
    }
    nbytes["K4T"] = nbytes["K4"]
    ops = {"K4": 2 * ne * nr * nc, "K4T": 2 * ne * nr * nc,
           "K3": 2 * ell.vals.numel()}
    saved = dict(spmv.launches)
    kernel = {"K4": "element_spmv_kernel", "K4T": "element_spmv_kernel",
              "K3": "ell_thread_kernel" if ell.vals.shape[1] <= 8
              else "ell_warp_kernel"}  # csrc/spmv.cu's choice
    t = {name: time_spmv(name, kernel[name], kern[name], plain[name],
                         lib[name], nbytes[name], ops[name])
         for name in ("K4", "K4T", "K3")}
    # K5 on the four nel=260 bands; the W1 stiffness band's numbers are
    # K5's in the kernels line
    t["K5_bands"] = [
        time_k5("W1 stiffness", band, bw, plans[torch.float64],
                rcm_csr(csr, perm), xp),
        time_k5("W1 stiffness, leftovers zeroed", band_z, bw, plan_z,
                rcm_csr(csr_z, perm), xp),
        time_k5("W1 stiffness, BC-constrained", band_c, bw_c, plan_c,
                rcm_csr(csr, perm_c, free), xc),
        time_k5("stiffness + mass", band7, bw7, plan7, rcm_csr(csr7, perm7),
                x7)]
    t["K5"] = t["K5_bands"][0]
    spmv.launches.update(saved)  # comparisons and timings do not count
    return t, err, path


class krylov_log:
    """Context: record the Krylov iterations of every LinearSolver solve,
    by kind ("K4" for solve, whose matvec is K4; "K4T" for solve_t), of
    the Krylov and the block-Thomas-preconditioned Krylov backends, and
    the factorization objects that solved (`factors`, each once)."""

    CLASSES = (KrylovFactorization, BlockThomasKrylovFactorization)

    def __enter__(self):
        self.saved = [(c, c.__dict__["solve"], c.__dict__["solve_t"])
                      for c in self.CLASSES]
        self.solves, self.factors = [], []

        def wrap(fn, kind):
            def wrapped(fac, b):
                x = fn(fac, b)
                self.solves.append((kind, fac.method,
                                    int(fac.last_result.iters)))
                if not any(f is fac for f in self.factors):
                    self.factors.append(fac)
                return x
            return wrapped

        for c, solve, solve_t in self.saved:
            c.solve, c.solve_t = wrap(solve, "K4"), wrap(solve_t, "K4T")
        return self

    def __exit__(self, *exc):
        for c, solve, solve_t in self.saved:
            c.solve, c.solve_t = solve, solve_t

    def take(self):
        out, self.solves = self.solves, []
        return out


def matvecs(solves):
    """BiCGStab's matvecs: the initial residual, then 2 per iteration."""
    out = {"K4": 0, "K4T": 0}
    for kind, method, iters in solves:
        if method != "bicgstab":
            raise AssertionError(f"expected BiCGStab solves, got {method}")
        out[kind] += 1 + 2 * iters
    return out


def w1_model(nel, device, **kw):
    """The main path of examples/run_poisson_opt.py, through the port
    (kw: build_fea's weak_bc and sym)."""
    fea, d = build_fea(nel=nel, device=device, **kw)
    model = FEAModel(fea=[fea])
    model.create_input("f", shape=d["W"].n_dofs, val=0.5)
    model.add_design_variable("f")
    model.add_objective("l2_functional", scaler=1e5)
    return Simulator(model), fea, d


def phase_w1():
    """W1 at nel=260, f64, on the card: Simulator.run and
    objective_gradient with the K4/K4T counts reset just before and read
    just after, gated on the JAX oracle; a warm objective_gradient; the
    manufactured-solution forward solve."""
    oracle = np.load(W1_ORACLE)
    if float(oracle["loss"]) != W1_LOSS:
        raise AssertionError("oracles/w1_poisson_nel260.npz does not hold "
                             "the loss written here")
    t0 = time.perf_counter()
    sim, fea, d = w1_model(W1_NEL, "cuda")
    method = fea.linear_solver.resolve_method(d["V"].n_dofs)
    print(f"W1 at nel={W1_NEL}, f64, cuda: {d['V'].n_dofs} CG1 dofs, "
          f"{d['W'].n_dofs} DG0 controls, LinearSolver('auto') -> {method} "
          f"+ {fea.linear_solver.pc}, rtol {fea.linear_solver.rtol:.0e}; "
          f"build {time.perf_counter() - t0:.2f} s")
    reset(spmv.launches)
    with krylov_log() as log:
        t_run, _ = synced(sim.run)
        at_run = dict(spmv.launches)
        run_solves = log.take()
        t_cold, (val, grads, _) = synced(
            lambda: sim.objective_gradient("l2_functional", ["f"]))
        grad_solves = log.take()
        launches = dict(spmv.launches)
        t_warm, (val_w, grads_w, _) = synced(
            lambda: sim.objective_gradient("l2_functional", ["f"]))
        warm_solves = log.take()
    want = matvecs(run_solves + grad_solves)
    print(f"  Krylov iterations: run {[s[2] for s in run_solves]} "
          f"(JAX {W1_KRYLOV_ITERS['run']}), objective_gradient "
          f"{[(s[0], s[2]) for s in grad_solves]} (JAX adjoint "
          f"{W1_KRYLOV_ITERS['objective_gradient']}), warm "
          f"{[(s[0], s[2]) for s in warm_solves]}")
    print(f"  launches: run K4 {at_run['K4']} K4T {at_run['K4T']}; run + "
          f"objective_gradient K4 {launches['K4']} K4T {launches['K4T']} "
          f"(expected {want['K4']} and {want['K4T']}: 1 initial residual "
          f"+ 2 per iteration)")
    if not (launches["K4"] == want["K4"] > 0
            and launches["K4T"] == want["K4T"] > 0):
        raise AssertionError(f"K4/K4T launches {launches}, want {want}")
    g = grads["f"]
    g_ref = torch.as_tensor(oracle["grad"], device="cuda")
    rl = abs(float(val) - W1_LOSS) / W1_LOSS
    rg = rel(g, g_ref)
    rl_w = abs(float(val_w) - float(val)) / abs(float(val))
    rg_w = rel(grads_w["f"], g)
    print(f"  loss {float(val)!r}, oracle {W1_LOSS!r}, rel {rl:.3e} (tol "
          f"1e-8); gradient ({g.numel()}) rel L2 {rg:.3e} (tol 1e-6); warm "
          f"call: loss rel {rl_w:.3e}, gradient rel {rg_w:.3e}")
    if not (rl <= 1e-8 and rg <= 1e-6 and bool(torch.isfinite(g).all())
            and rl_w <= 1e-10 and rg_w <= 1e-8):
        raise AssertionError("W1 loss or gradient is wrong")
    print(f"  wall time: run {t_run:.3f} s, objective_gradient cold "
          f"{t_cold:.3f} s, warm {t_warm:.3f} s")

    src = lambda x: np.sin(np.pi * x[0]) * np.sin(np.pi * x[1])  # noqa
    fea_m, dm = build_fea(nel=W1_NEL, device="cuda")
    t_m, _ = synced(lambda: fea_m.solve(
        "u", {"f": Function(dm["W"]).interpolate(src).array}))
    err = errorNorm(dm["u_ex"], dm["u"])
    r = abs(err - W1_ERROR_NORM) / W1_ERROR_NORM
    # u agrees to ~1e-12 of its norm; the error norm is ~2e-5 of that norm,
    # so a relative bar of 1e-5 on it is ~2e-10 of the solution's norm
    print(f"  manufactured solution: errorNorm {err!r}, JAX "
          f"{W1_ERROR_NORM!r}, rel {r:.3e} (tol 1e-5; < 5e-3); solve "
          f"{t_m:.3f} s")
    if not (err < 5e-3 and r <= 1e-5):
        raise AssertionError("manufactured-solution error norm is wrong")
    return launches, dict(run=t_run, cold=t_cold, warm=t_warm)


def phase_w1_slsqp():
    """SLSQP(maxiter=3) on the W1 model at nel=32 (scipy's SLSQP keeps
    about 10.5 n^2 values of work arrays: 1.4 TiB at nel=260's 135,200
    controls, in either package)."""
    sim, fea, d = w1_model(W1_OPT_NEL, "cuda")
    sim.run()
    prob = OptimizationProblem(sim, "poisson_opt")
    t, res = synced(lambda: SLSQP(prob, ftol=1e-13, maxiter=3).solve())
    objs = [h["obj"] for h in prob.history]
    print(f"W1 SLSQP(maxiter=3) at nel={W1_OPT_NEL} ({d['W'].n_dofs} "
          f"controls, {fea.linear_solver.resolve_method(d['V'].n_dofs)}): "
          f"nit {res.nit}, {t:.3f} s; objective after each evaluation "
          f"{objs}; JAX {W1_SLSQP_OBJ}")
    if len(objs) != len(W1_SLSQP_OBJ) or max(
            abs(a - b) / abs(b) for a, b in zip(objs, W1_SLSQP_OBJ)) > 1e-8:
        raise AssertionError("SLSQP objectives disagree with the oracle")


def phase_w1_card_vs_cpu():
    """W1 at nel=64 on CUDA tensors (K4/K4T) and on CPU tensors (plain)."""
    out = {}
    for dev in ("cuda", "cpu"):
        sim, fea, d = w1_model(W1_CHECK_NEL, dev)
        sim.run()
        val, grads, _ = sim.objective_gradient("l2_functional", ["f"])
        out[dev] = (float(val), grads["f"].cpu())
    rl = abs(out["cuda"][0] - out["cpu"][0]) / abs(out["cpu"][0])
    rg = rel(out["cuda"][1], out["cpu"][1])
    print(f"W1 card vs CPU tensors at nel={W1_CHECK_NEL} "
          f"({fea.linear_solver.resolve_method(d['V'].n_dofs)}): loss rel "
          f"{rl:.3e} (tol 1e-10), gradient rel L2 {rg:.3e} (tol 1e-8)")
    if not (rl <= 1e-10 and rg <= 1e-8):
        raise AssertionError("W1 card and CPU runs disagree")


# ---------------------------------------------------------------------------
# Slice C: the deterministic assembly scatter, then the small workloads (W1
# with weak BCs, the Poisson step as one function, W2, W10 shape gradients,
# W4 SIMP topology, W3 Hermite beam), each against the JAX package's f64
# values in oracles/slice_c_oracle.npz
# ---------------------------------------------------------------------------

# written by `JAX_PLATFORMS=cpu PYTHONPATH=. python oracles/slice_c_oracle.py`;
# each entry beside the configuration it was computed for, checked here
SLICE_C_ORACLE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "oracles", "slice_c_oracle.npz")
SLICE_C_CONFIGS = {
    "w1_weak": dict(nel=260, weak_bc=True, sym=True, f=0.5,
                    objective="l2_functional", scaler=1e5,
                    linear_solver="bicgstab_bt"),
    "w2": dict(nel=260, sym=True, beta=10.0, pde_solver="SNES", f=1.0,
               objective="J"),
    "jit_step": dict(nel=260, solver="cg", f=0.5),
    "entry": dict(nel=32, solver="dense", f=0.5),
    "shape": dict(nel=260, functional="energy", u="x^2 + y/2",
                  ds="0.1 u h"),
    "topopt": dict(num_el_x=160, num_el_y=80, density=0.4,
                   linear_solver="auto"),
    "topopt_slsqp": dict(num_el_x=40, num_el_y=20,
                         solve_mode="jit_dense", maxiter=15, ftol=1e-9),
}
DET_NEL_DENSE = 64  # to_dense in the determinism phase (4,225 dofs)
DEVICE = "cuda"  # where the slice C phases run


def slice_c_oracle(key):
    """The oracle file, after checking that entry `key` was computed for
    the configuration driven here."""
    oracle = np.load(SLICE_C_ORACLE)
    got = json.loads(str(oracle[f"{key}_config"]))
    if got != json.loads(json.dumps(SLICE_C_CONFIGS[key])):
        raise AssertionError(f"oracle entry {key} is for {got}, not "
                             f"{SLICE_C_CONFIGS[key]}")
    return oracle


def check_oracle_values(label, val, grad, want_val, want_grad, loss_tol,
                        grad_tol):
    """A value (relative) and a gradient (relative L2) against the JAX
    package's."""
    g = grad.detach().cpu().numpy().reshape(np.shape(want_grad))
    rl = abs(float(val) - float(want_val)) / abs(float(want_val))
    rg = float(np.linalg.norm(g - want_grad) / np.linalg.norm(want_grad))
    print(f"  {label}: value {float(val)!r}, JAX {float(want_val)!r}, rel "
          f"{rl:.3e} (tol {loss_tol:.0e}); gradient ({g.size}) rel L2 "
          f"{rg:.3e} (tol {grad_tol:.0e})")
    if not (rl <= loss_tol and rg <= grad_tol and np.all(np.isfinite(g))):
        raise AssertionError(f"{label} disagrees with the JAX oracle")


def bits(t):
    """The raw 64-bit patterns of an f64 tensor (equal bits, not values)."""
    return t.detach().contiguous().view(torch.int64)


def same_bits(label, a, b):
    ok = torch.equal(bits(a), bits(b))
    n = int((bits(a) != bits(b)).sum())
    print(f"  {label}: {a.numel()} values, {n} differ in their bits "
          "between the two runs")
    if not ok:
        raise AssertionError(f"{label}: two runs differ")


def phase_determinism(info4, dv4):
    """F1: the assembly scatters give the same bits on every run.  Twice
    each: the nel=260 W1 residual, its VJP, the Jacobian's diagonal, the
    dense Jacobian at nel=64, the refine-4 motor mesh-motion template fill;
    then W1's objective_gradient at nel=260 in two fresh simulators: equal
    loss and gradient bits and equal BiCGStab counts, gated on the W1
    oracle, and the card band's nonzeros."""
    rng = np.random.default_rng(17)
    fea, d = build_fea(nel=W1_NEL, device=DEVICE)
    cf = compile_form(fea.states_dict["u"]["residual_form"])
    u = torch.as_tensor(rng.standard_normal(d["V"].n_dofs), device=DEVICE)
    f = torch.as_tensor(rng.standard_normal(d["W"].n_dofs), device=DEVICE)
    cot = torch.as_tensor(rng.standard_normal(d["V"].n_dofs),
                          device=DEVICE)

    def residual_vjp():
        _, pull = torch.func.vjp(
            lambda uu, ff: cf.vector({"u": uu, "f": ff}), u, f)
        return torch.cat(pull(cot))

    for label, fn in (
            (f"W1 residual vector, nel={W1_NEL}",
             lambda: cf.vector({"u": u, "f": f})),
            (f"its VJP (u and f), nel={W1_NEL}", residual_vjp),
            (f"Jacobian diagonal, nel={W1_NEL}",
             lambda: cf.matrix({"u": u, "f": f}, "u").diagonal())):
        same_bits(label, fn(), fn())
    fea_s, d_s = build_fea(nel=DET_NEL_DENSE, device=DEVICE)
    cf_s = compile_form(fea_s.states_dict["u"]["residual_form"])
    vs = {"u": torch.as_tensor(rng.standard_normal(d_s["V"].n_dofs),
                               device=DEVICE),
          "f": d_s["f"].array}
    same_bits(f"to_dense, nel={DET_NEL_DENSE}",
              *(cf_s.matrix(vs, "u").to_dense() for _ in range(2)))
    tpl, jac = info4["jac"]["mm"]
    g = edge_delta_design_space(info4["mesh"], info4["Vmm"])[0](dv4)
    blocks = jac(0.5 * g, {"uhat_bc": g})
    fills = [torch.stack(tpl.fill(blocks)) for _ in range(2)]
    same_bits(f"refine-4 mesh-motion template fill (nb={tpl.nb}, "
              f"B={tpl.B})", *fills)

    runs = []
    for _ in range(2):
        sim, _, _ = w1_model(W1_NEL, DEVICE)
        with krylov_log() as log:
            sim.run()
            val, grads, _ = sim.objective_gradient("l2_functional", ["f"])
            runs.append((val, grads["f"], [(k, it) for k, _, it in
                                           log.take()]))
    (v0, g0, it0), (v1, g1, it1) = runs
    print(f"  W1 objective_gradient at nel={W1_NEL}, two fresh simulators: "
          f"BiCGStab iterations {it0} and {it1} (JAX: forward "
          f"{W1_KRYLOV_ITERS['run'][0]}, adjoint "
          f"{W1_KRYLOV_ITERS['objective_gradient'][0]})")
    same_bits("W1 loss", v0[None], v1[None])
    same_bits("W1 gradient", g0, g1)
    if it0 != it1:
        raise AssertionError(f"BiCGStab counts differ: {it0} vs {it1}")
    oracle = np.load(W1_ORACLE)
    check_oracle_values("W1 against its oracle", v0, g0, W1_LOSS,
                        oracle["grad"], 1e-8, 1e-6)
    K, _ = w1_stiffness(W1_NEL)
    band, bw, _ = spmv.banded_from_element_matrix(K)
    nnz, tiny = band_nonzeros(band)
    print(f"  W1 stiffness band on the card (nel={W1_NEL}, b={bw}): "
          f"band_nnz {nnz}, of which {tiny} rounding leftovers (|entry| <= "
          f"1e-14 of the largest)")
    return dict(krylov=it0, band_nnz=nnz, band_tiny=tiny)


def counted_solve_path(label, fn, fea, state):
    """fn() with the K4/K4T counts reset just before and read just after,
    and every LinearSolver solve logged: (seconds, fn's result, launches,
    solves, the factorizations that solved).  The launches must be BiCGStab's matvecs (1 + 2 per
    iteration, each solve) times the element blocks of a matvec, one per
    term of the state's residual form."""
    blocks = len(compile_form(fea.states_dict[state]["residual_form"]).terms)
    reset(spmv.launches)
    with krylov_log() as log:
        t, out = synced(fn)
        solves = log.take()
    launches = {k: spmv.launches[k] for k in ("K4", "K4T")}
    factors = log.factors
    want = {k: blocks * n for k, n in matvecs(solves).items()}
    print(f"  {label}: {t:.3f} s; BiCGStab iterations "
          f"{[(s[0], s[2]) for s in solves]}; K4 {launches['K4']}, K4T "
          f"{launches['K4T']} launches (expected {want['K4']} and "
          f"{want['K4T']}: {blocks} element blocks per matvec)")
    if launches != want or launches["K4"] == 0:
        raise AssertionError(f"{label}: K4/K4T launches {launches}, want "
                             f"{want}")
    return t, out, launches, solves, factors


def check_element_matrices(label, factors):
    """K4/K4T on a path's own Jacobians (the ElementMatrix of every
    factorization that solved) against their plain versions, f64
    SPMV_TOL: each element block alone (a block whose plain product is
    exactly 0, as a load term's, must give exactly 0), then
    matvec/rmatvec, where every block after the first adds into the
    first's output (the kernel's accumulate mode), and a second
    matvec/rmatvec bit for bit against the first.  Returns max |kernel -
    plain| by kernel.  Called after the path's launches are read: these
    launches count for no path."""
    def rel0(got, want):
        n = float(torch.linalg.norm(want))
        if n == 0.0:
            return 0.0 if not bool(got.any()) else float("inf")
        return float(torch.linalg.norm(got - want)) / n

    rng = np.random.default_rng(11)
    tol = SPMV_TOL[torch.float64]
    err = {"K4": 0.0, "K4T": 0.0}
    for j, fac in enumerate(factors):
        A = fac.emat
        n_rows, n_cols = A.shape
        dev = A.blocks[0].A.device
        x = torch.as_tensor(rng.standard_normal(n_cols), device=dev)
        y = torch.as_tensor(rng.standard_normal(n_rows), device=dev)
        r = {"K4": [], "K4T": []}
        plain = {"K4": 0.0, "K4T": 0.0}
        for b in A.blocks:
            pair = {"K4": (spmv.element_spmv_cuda(b.A, b.plan, x),
                           spmv.element_spmv_plain(b.A, b.rows, b.cols, x,
                                                   n_rows)),
                    "K4T": (spmv.element_rspmv_cuda(b.A, b.plan, y),
                            spmv.element_rspmv_plain(b.A, b.rows, b.cols,
                                                     y, n_cols))}
            for k, (got, want) in pair.items():
                r[k].append(rel0(got, want))
                err[k] = max(err[k], float((got - want).abs().max()))
                plain[k] = plain[k] + want
        got = {"K4": A.matvec(x), "K4T": A.rmatvec(y)}
        again = {"K4": A.matvec(x), "K4T": A.rmatvec(y)}
        torch.cuda.synchronize()
        same = all(torch.equal(got[k], again[k]) for k in got)
        for k in got:
            r[k].append(rel0(got[k], plain[k]))
            err[k] = max(err[k], float((got[k] - plain[k]).abs().max()))
        shapes = ", ".join("x".join(map(str, b.A.shape)) for b in A.blocks)
        print(f"  {label}, Jacobian {j} ({shapes}), f64 vs plain, rel L2 "
              f"per block then accumulated (tol {tol:.0e}): K4 "
              f"{', '.join(f'{v:.3e}' for v in r['K4'])}; K4T "
              f"{', '.join(f'{v:.3e}' for v in r['K4T'])}; second call "
              f"bit-identical {same}")
        if not all(v <= tol for v in r["K4"] + r["K4T"]):
            raise AssertionError(f"{label}: K4/K4T disagree with plain on "
                                 f"Jacobian {j}")
        if not same:
            raise AssertionError(f"{label}: two K4/K4T launches differ")
    return err


def model_path(sim, of, wrt):
    """Simulator.run then objective_gradient(of, [wrt])."""
    def fn():
        sim.run()
        return sim.objective_gradient(of, [wrt])
    return fn


def phase_w1_weak(err):
    """W1 with Nitsche weak BCs (sym) at nel=260, no strong BC, BiCGStab
    preconditioned by the block-Thomas factor: run and objective_gradient,
    K4/K4T and K1/K2 counted, against the oracle (1e-8, 1e-6).  Then K1/K2
    against plain on the block-Thomas factors that ran (folding max
    |kernel - plain| into err, and timed at their shape) and K4/K4T on the
    path's own Jacobians."""
    c = SLICE_C_CONFIGS["w1_weak"]
    oracle = slice_c_oracle("w1_weak")
    t0 = time.perf_counter()
    sim, fea, d = w1_model(c["nel"], DEVICE, weak_bc=True, sym=c["sym"])
    # the JAX package's default, BiCGStab + Jacobi, does not converge on
    # this Nitsche system (beta = 0.1); both packages precondition with the
    # block-Thomas factor
    fea.linear_solver = LinearSolver(c["linear_solver"])
    print(f"W1 weak BCs at nel={c['nel']}, f64, {DEVICE}: "
          f"{d['mesh'].n_cells} triangles, {d['V'].n_dofs} CG1 dofs, "
          f"{len(fea.bc)} strong BCs, "
          f"{fea.linear_solver.resolve_method(d['V'].n_dofs)} + "
          f"{fea.linear_solver.pc}; build {time.perf_counter() - t0:.2f} s; "
          f"JAX BiCGStab run {list(oracle['w1_weak_run_krylov_iters'])}, "
          f"gradient {list(oracle['w1_weak_grad_krylov_iters'])}")
    reset(bt_sweeps.launches)
    t, (val, grads, _), launches, _, factors = counted_solve_path(
        "run + objective_gradient",
        model_path(sim, c["objective"], "f"), fea, "u")
    launches.update(bt_sweeps.launches)
    print(f"  K1 {launches['K1']}, K2 {launches['K2']} launches (the "
          "block-Thomas preconditioner)")
    if not (launches["K1"] > 0 and launches["K2"] > 0):
        raise AssertionError("the preconditioner launched no sweep")
    check_oracle_values("W1 weak", val, grads["f"], oracle["w1_weak_loss"],
                        oracle["w1_weak_grad"], 1e-8, 1e-6)
    rng = np.random.default_rng(13)
    ran = []
    for fac in factors:
        # the factor of the operator (solve) and of its transpose (solve_t)
        for name, f in (("factor", fac.bt._f), ("transpose factor",
                                                fac.bt._ft)):
            if f is not None:
                nb, B = f.Sinv.shape[:2]
                bb = torch.as_tensor(rng.standard_normal((nb, B)),
                                     dtype=torch.float64,
                                     device=f.Sinv.device)
                check_sweeps(f, bb, f"w1_weak {name} nb={nb} B={B} "
                             "float64", err, spread=True)
                ran.append((f, bb))
    if not ran:
        raise AssertionError("no block-Thomas factor preconditioned W1 weak")
    sweeps = time_sweeps(*ran[0], "w1_weak")
    spmv_err = check_element_matrices("w1_weak", factors)
    t_warm, _ = synced(lambda: sim.objective_gradient(c["objective"],
                                                      ["f"]))
    print(f"  warm objective_gradient {t_warm:.3f} s")
    return dict(launches=launches, seconds=t, warm=t_warm, err=spmv_err,
                sweeps=sweeps)


def w2_fea(nel, sym=True, beta=10.0, device=None):
    """W2 in the port, built as the JAX package's
    tests/test_nonlinear_poisson.py builds it: -lap u + u^3 = f with
    Nitsche terms on the boundary (tag 1), PDE_SOLVER="SNES"."""
    device = device or DEVICE
    mesh = create_unit_square_mesh(nel)
    mesh.mark_boundary_facets(1)
    V = FunctionSpace(mesh, ("CG", 1), device=device)
    W = FunctionSpace(mesh, ("DG", 0), device=device)
    u, f = Function(V, "u"), Function(W, "f")
    sgn = 1.0 if sym else -1.0

    def interior(w, g):
        return dot(grad(w.u), grad(w.v)) + w.u**3 * w.v - w.f * w.v

    def boundary(w, g):
        ue = torch.sin(2 * np.pi * g.x[0]) * torch.sin(np.pi * g.x[1])
        r = (-dot(grad(w.u), g.n) * w.v
             + sgn * (ue - w.u) * dot(grad(w.v), g.n))
        if sym:
            r = r + beta / g.h * (w.u - ue) * w.v
        return r

    residual = FormDef([dx(interior), ds(boundary, tag=1)], coeffs=[u, f],
                       test=V)
    u_ex = Function(V, "u_ex").interpolate(
        lambda x: np.sin(2 * np.pi * x[0]) * np.sin(np.pi * x[1]))
    obj = FormDef(
        [dx(lambda w, g: 0.5 * (w.u - w.u_ex) ** 2 + 3e-7 * w.f**2)],
        coeffs=[u, u_ex, f])
    fea = FEA(mesh)
    fea.PDE_SOLVER = "SNES"
    fea.add_input("f", f)
    fea.add_state("u", u, residual, ["f"])
    fea.add_output("J", "scalar", obj, ["u", "f"])
    return fea, V, W


def phase_w2():
    """W2 (symmetric Nitsche, SNES backtracking) at nel=260: run and
    objective_gradient, K4/K4T counted, against the oracle."""
    c = SLICE_C_CONFIGS["w2"]
    oracle = slice_c_oracle("w2")
    fea, V, W = w2_fea(c["nel"], c["sym"], c["beta"])
    model = FEAModel(fea=[fea])
    model.create_input("f", shape=W.n_dofs, val=c["f"])
    model.add_design_variable("f")
    model.add_objective(c["objective"])
    sim = Simulator(model)
    print(f"W2 at nel={c['nel']}, f64, {DEVICE}: {V.n_dofs} CG1 dofs, "
          f"{fea.linear_solver.resolve_method(V.n_dofs)} + "
          f"{fea.linear_solver.pc}, Newton with backtracking; JAX BiCGStab "
          f"run {list(oracle['w2_run_krylov_iters'])}, gradient "
          f"{list(oracle['w2_grad_krylov_iters'])}")
    t, (val, grads, _), launches, _, factors = counted_solve_path(
        "run + objective_gradient", model_path(sim, c["objective"], "f"),
        fea, "u")
    check_oracle_values("W2", val, grads["f"], oracle["w2_loss"],
                        oracle["w2_grad"], 1e-8, 1e-6)
    return dict(launches=launches, seconds=t,
                err=check_element_matrices("w2", factors))


def phase_jit_step():
    """build_jit_opt_step(nel=260, "cg") (matrix-free Newton-Krylov, jvp
    and vjp matvecs), value and gradient against the oracle (1e-8, 1e-6);
    entry() (nel=32, dense) against it (1e-12, 1e-10)."""
    c, ce = SLICE_C_CONFIGS["jit_step"], SLICE_C_CONFIGS["entry"]
    oracle = slice_c_oracle("jit_step")
    slice_c_oracle("entry")
    step, f0 = build_jit_opt_step(nel=c["nel"], solver=c["solver"])
    t_cold, (val, g) = synced(lambda: step(f0))
    check_oracle_values(f"jit step nel={c['nel']} cg", val, g,
                        oracle["jit_step_loss"], oracle["jit_step_grad"],
                        1e-8, 1e-6)
    t_warm, _ = synced(lambda: step(f0))
    fn, args = entry()
    t_e, (ev, eg) = synced(lambda: fn(*args))
    check_oracle_values(f"entry() nel={ce['nel']} dense", ev, eg,
                        oracle["entry_loss"], oracle["entry_grad"], 1e-12,
                        1e-10)
    t_ew, _ = synced(lambda: fn(*args))
    print(f"  wall time: jit step first {t_cold:.3f} s, warm {t_warm:.3f} "
          f"s; entry() first {t_e:.3f} s, warm {t_ew:.3f} s")
    return dict(cold=t_cold, warm=t_warm, entry=t_ew)


def energy_form(nel, device):
    """tests/test_shape_derivative.py's energy functional: Dirichlet energy
    of u = x^2 + y/2 plus 0.1 u h on the boundary."""
    mesh = create_unit_square_mesh(nel)
    mesh.mark_boundary_facets(1)
    V = FunctionSpace(mesh, ("CG", 1), device=device)
    u = Function(V, "u").interpolate(lambda x: x[0] ** 2 + 0.5 * x[1])
    return FormDef([dx(lambda w, g: dot(grad(w.u), grad(w.u))),
                    ds(lambda w, g: 0.1 * w.u * g.h, tag=1)], coeffs=[u])


def phase_shape():
    """shape_gradient of the energy functional on the nel=260 square, on
    the card against the oracle and against CPU tensors (1e-12 each)."""
    c = SLICE_C_CONFIGS["shape"]
    want = slice_c_oracle("shape")["shape_grad"]
    form = energy_form(c["nel"], DEVICE)
    t_cold, g = synced(lambda: shape_gradient(form))
    t_warm, _ = synced(lambda: shape_gradient(form))
    g_cpu = shape_gradient(energy_form(c["nel"], "cpu"))
    r_or = float(np.linalg.norm(g.cpu().numpy() - want)
                 / np.linalg.norm(want))
    r_cpu = rel(g.cpu(), g_cpu)
    print(f"shape gradient at nel={c['nel']} ({tuple(g.shape)}): rel L2 "
          f"{r_or:.3e} against the JAX oracle, {r_cpu:.3e} against CPU "
          f"tensors (tol 1e-12 each); first {t_cold:.3f} s, warm "
          f"{t_warm:.3f} s")
    if not (r_or <= 1e-12 and r_cpu <= 1e-12):
        raise AssertionError("shape gradient is wrong")
    return dict(warm=t_warm)


def phase_topopt():
    """W4 at 160 x 80 (BiCGStab + Jacobi, K4/K4T every iteration): run and
    objective_gradient against the oracle; the example's 40 x 20
    (jit_dense) through SLSQP(maxiter=15): compliance below 0.7 of its
    start, as tests/test_topopt.py requires."""
    c, cs = SLICE_C_CONFIGS["topopt"], SLICE_C_CONFIGS["topopt_slsqp"]
    oracle = slice_c_oracle("topopt")
    t0 = time.perf_counter()
    model, fea, d = build_topopt_model(c["num_el_x"], c["num_el_y"])
    sim = Simulator(model)
    n = d["V"].n_dofs
    print(f"W4 SIMP at {c['num_el_x']}x{c['num_el_y']} quads, f64, {DEVICE}: "
          f"{n} displacement dofs (JAX {int(oracle['topopt_n_dofs'])}), "
          f"{d['W'].n_dofs} densities, "
          f"{fea.linear_solver.resolve_method(n)} + {fea.linear_solver.pc}; "
          f"build {time.perf_counter() - t0:.2f} s; JAX BiCGStab run "
          f"{list(oracle['topopt_run_krylov_iters'])}, gradient "
          f"{list(oracle['topopt_grad_krylov_iters'])}")
    t, (val, grads, out), launches, _, factors = counted_solve_path(
        "run + objective_gradient",
        model_path(sim, "compliance", "density_unfiltered"), fea,
        "displacements")
    check_oracle_values("W4 compliance", val, grads["density_unfiltered"],
                        oracle["topopt_compliance"], oracle["topopt_grad"],
                        1e-8, 1e-6)
    if abs(float(out["avg_density"]) - float(oracle["topopt_avg_density"])) \
            > 1e-12:
        raise AssertionError("avg_density disagrees with the oracle")
    spmv_err = check_element_matrices("topopt", factors)
    del factors

    oracle_s = slice_c_oracle("topopt_slsqp")
    model, fea, d = build_topopt_model(cs["num_el_x"], cs["num_el_y"])
    fea.solve_mode = cs["solve_mode"]
    sim = Simulator(model)
    c0 = float(sim.run()["compliance"])
    prob = OptimizationProblem(sim, "topo")
    t_opt, res = synced(lambda: SLSQP(prob, ftol=cs["ftol"],
                                      maxiter=cs["maxiter"]).solve())
    c1 = float(sim.outputs["compliance"])
    avg = float(sim.outputs["avg_density"])
    print(f"  SLSQP(maxiter={cs['maxiter']}) at {cs['num_el_x']}x"
          f"{cs['num_el_y']}: compliance {c0!r} -> {c1!r} (JAX "
          f"{float(oracle_s['topopt_slsqp_c0'])!r} -> "
          f"{float(oracle_s['topopt_slsqp_c1'])!r}), avg density {avg!r}, "
          f"nit {res.nit}, {t_opt:.3f} s")
    if not (c1 < 0.7 * c0 and avg <= 0.4 + 1e-6 and abs(
            c0 - float(oracle_s["topopt_slsqp_c0"])) <= 1e-10 * c0):
        raise AssertionError("topology optimization did not reduce the "
                             "compliance enough")
    return dict(launches=launches, seconds=t, slsqp_seconds=t_opt,
                err=spmv_err)


def phase_beam():
    """W3 at the reference's 50 elements, as in
    examples/run_thickness_opt_cantilever_beam.py: jit_dense, SLSQP to the
    OpenMDAO optimum (max |t - ref| < 1e-4)."""
    fea, d = build_beam_problem(nel=50)
    fea.linear_problem = True
    fea.solve_mode = "jit_dense"
    model = FEAModel(fea=[fea])
    model.create_input("thickness", shape=50, val=0.1)
    model.add_design_variable("thickness", lower=1e-2, upper=10.0,
                              scaler=10.0)
    model.add_objective("compliance", scaler=1e-4)
    model.add_constraint("volume", equals=0.1 * 0.1 * 1.0, scaler=1e2)
    sim = Simulator(model)
    sim.run()
    prob = OptimizationProblem(sim, "beam_thickness_opt")
    t, res = synced(lambda: SLSQP(prob, ftol=1e-10, maxiter=200).solve())
    err = float(np.abs(sim["thickness"] - OPENMDAO_THICK_REF).max())
    print(f"W3 Hermite beam, nel=50, {d['V'].n_dofs} dofs, f64, {DEVICE}: "
          f"SLSQP nit {res.nit}, {t:.3f} s; max |t - OpenMDAO| {err:.3e} "
          f"(tol 1e-4); compliance {float(sim['compliance'])!r}")
    if not err < 1e-4:
        raise AssertionError("beam thickness differs from the OpenMDAO "
                             "optimum")
    return dict(seconds=t, nit=int(res.nit))



def kernel_entry(key, name, source, replaces, launches, err, t):
    """One kernel's entry of the kernels line.  ms, plain_ms and
    library_ms are medians of CUDA-event timings of single calls; the
    *device_ms keys are the profiler's device time per call, without the
    host time between launches (null: not measured, see device_ms)."""
    ms, by = t["bound"]
    return {"name": f"{name} ({key})", "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": ms,
            "bound_by": by, "library_ms": t["library_ms"],
            "lib_ms": t["library_ms"], "device_ms": t["device_ms"],
            "plain_device_ms": t["plain_device_ms"],
            "library_device_ms": t["library_device_ms"]}


def sweep_shape(k, t):
    """K1's or K2's times at one factor's shape, for the kernels line: the
    top-level numbers of its entry are those of the refine-1 mesh-motion
    factor; this list adds the refine-4 factors and the geometry."""
    return dict(t["shape"], **t[f"{k}_geometry"], ms=t[k],
                device_ms=t[f"{k}_device"], plain_ms=t[f"{k}_plain"],
                plain_device_ms=t[f"{k}_plain_device"],
                bound_ms=t[f"{k}_bound"][0], bound_by=t[f"{k}_bound"][1],
                us_per_phase=t[f"{k}_us_per_phase"])


def timed_phase(name, seconds, fn, *args):
    """fn(*args), its wall seconds kept under `name` and printed."""
    t0 = time.perf_counter()
    out = fn(*args)
    seconds[name] = time.perf_counter() - t0
    print(f"[phase {name}: {seconds[name]:.1f} s]")
    return out


def main():
    t_start = time.perf_counter()
    seconds = {}
    femo_tpu_torch.set_precision("float64")
    card = timed_phase("device", seconds, phase_device)
    timed_phase("build", seconds, phase_build)
    step1, (dv0, iq0), info1 = build_motor_jit_step(refine=1, device="cuda",
                                                    **ORACLE_CFG)
    t, err = timed_phase("kernels", seconds, phase_kernels, info1, dv0, iq0)
    launches, warm1 = timed_phase("refine1", seconds, phase_refine1, step1,
                                  dv0, iq0, info1)
    t4, warm4, info4, dv4 = timed_phase("refine4", seconds, phase_refine4,
                                        err)
    t_spmv, err_spmv, selftest = timed_phase("spmv", seconds, phase_spmv)
    w1_launches, _ = timed_phase("w1", seconds, phase_w1)
    timed_phase("w1_slsqp", seconds, phase_w1_slsqp)
    timed_phase("w1_card_vs_cpu", seconds, phase_w1_card_vs_cpu)
    det = timed_phase("determinism", seconds, phase_determinism, info4,
                      dv4)
    del info4
    paths = {"refine1_oracle": launches}
    r4b = timed_phase("refine4_bench", seconds, phase_refine4_bench, warm4)
    paths["refine4_refactor3"] = r4b["launches"]
    r1b = timed_phase("refine1_bench", seconds, phase_refine1_bench, warm1)
    paths["refine1_refactor3"] = r1b["r1_re3"]["launches"]
    paths["refine1_refactor3_freeze"] = r1b["r1_re3_freeze"]["launches"]
    lb = timed_phase("refine1_lu_basis", seconds, phase_refine1_lu_basis)
    paths["refine1_lu"] = lb["r1_lu"]["launches"]
    paths["refine1_basis"] = lb["r1_basis"]["launches"]
    eager = timed_phase("eager_model", seconds, phase_eager_model)
    paths["eager_model_scipy"] = eager["scipy"]["launches"]
    paths["eager_model_block_thomas"] = eager["block_thomas"]["launches"]
    un = timed_phase("unstructured", seconds, phase_unstructured, err)
    paths["unstructured_refine1"] = un["launches"]
    slice_c = {"determinism": det}
    for name, fn, args in (("w1_weak", phase_w1_weak, (err,)),
                           ("w2", phase_w2, ()),
                           ("jit_step", phase_jit_step, ()),
                           ("shape", phase_shape, ()),
                           ("topopt", phase_topopt, ()),
                           ("beam", phase_beam, ())):
        slice_c[name] = timed_phase(name, seconds, fn, *args)
    t_weak = slice_c["w1_weak"].pop("sweeps")
    print("slice C summary: " + json.dumps(slice_c))
    print(f"kernels vs plain on the steps' factors (refine 1 and 4, "
          f"unstructured, W1 weak): max |kernel - plain| K1 "
          f"{err['K1']:.3e}, K2 {err['K2']:.3e}")
    # K4/K4T: max_abs_err over the nel=260 W1 operator and the Jacobians
    # of W1 weak, W2 and W4
    for k in ("K4", "K4T"):
        err_spmv[k] = max([err_spmv[k]] + [slice_c[p]["err"][k] for p in
                                           ("w1_weak", "w2", "topopt")])
    print("motor summary: " + json.dumps({
        "refine4_refactor3": r4b, "refine1": r1b, "lu_basis": lb,
        "eager_model": eager, "unstructured": un}))

    bt, sp = "femo_tpu_torch/csrc/bt_sweeps.cu", "femo_tpu_torch/csrc/spmv.cu"
    ps = "experiments/pallas_spmv.py"
    rows = [dict(kernel_entry(
        k, name, bt, f"femo_tpu/ops/pallas_bt.py:{line}", launches[k],
        err[k], dict(ms=t[k], plain_ms=t[f"{k}_plain"], library_ms=None,
                     device_ms=t[f"{k}_device"],
                     plain_device_ms=t[f"{k}_plain_device"],
                     library_device_ms=None, bound=t[f"{k}_bound"])),
        shapes=[sweep_shape(k, ts) for ts in [t] + t4 + [t_weak]],
        launches_by_path=dict({p: n[k] for p, n in paths.items()},
                              w1_weak=slice_c["w1_weak"]["launches"][k]))
        for k, name, line in (("K1", "bt_fwd_sweep", 60),
                              ("K2", "bt_bwd_sweep", 76))]
    rows += [kernel_entry(k, name, sp, f"{ps}:{line}", n, err_spmv[k],
                          t_spmv[k])
             for k, name, line, n in (
                 ("K3", "ell_spmv", 75, selftest["K3"]),
                 ("K4", "element_spmv", 121, w1_launches["K4"]),
                 ("K4T", "element_spmv transposed", 121, w1_launches["K4T"]),
                 ("K5", "banded_spmv", 217, selftest["K5"]))]
    # K4/K4T: their top-level launches are W1's; launches_by_path adds the
    # other paths that run them
    for row, k in ((rows[3], "K4"), (rows[4], "K4T")):
        row["launches_by_path"] = dict(
            w1=w1_launches[k], **{p: slice_c[p]["launches"][k]
                                  for p in ("w1_weak", "w2", "topopt")})
    # K5: its top-level numbers are the W1 stiffness band's; "bands" adds
    # the other nel=260 bands; bound_ms is on the band's nonzeros with x and
    # y, plan_bound_ms on what K5 reads (plan, x, y), dense_bound_ms on the
    # dense band
    plan_keys = ("band_nnz", "band_tiny", "plan", "plan_bound_ms",
                 "dense_bound_ms", "plan_build_ms", "plan_build_device_ms")
    rows[-1].update({k: t_spmv["K5"][k] for k in plan_keys})
    rows[-1]["bands"] = [
        dict({k: v for k, v in r.items() if k != "bound"},
             bound_ms=r["bound"][0], bound_by=r["bound"][1])
        for r in t_spmv["K5_bands"]]
    print(f"phase seconds: {json.dumps(seconds)}; "
          f"{time.perf_counter() - t_start:.1f} s in all")
    print(card)  # again near the end, where a cut output still shows it
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
