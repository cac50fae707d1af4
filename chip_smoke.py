#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (femo_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, one result line each; any failure raises and the script exits
non-zero without the final line:

1. device: the card's name and power limit (nvidia-smi); no CUDA -> fail.
2. build: the native host library (g++) and the block-Thomas sweep kernels
   (nvcc, sm_90a) from the sources in this checkout.
3. kernels: K1/K2 against their plain PyTorch versions on the card —
   synthetic blocks (nb in {1, 3, 9}, B in {128, 256}, f32 and f64, plus
   the unscaled B=256 system in f64) and the real refine-1 mesh-motion and
   EM factors — and their times at the refine-1 mesh-motion shapes
   (median of CUDA-event timings).
4. the motor optimization step at refine 1, f64, on the card, in the f64
   oracle's configuration: loss against experiments/motor_latency_oracle
   .json, the gradient, each sweep kernel's launch count, and agreement
   with the same step on CPU tensors (plain sweeps).
5. the same step at refine 4 (the reference's largest dof class), then
   K1/K2 against the plain sweeps on its mesh-motion (B=512) and EM
   factors, with their times there.

It prints a JSON line describing the kernels, and last
{"ok": true, "device": {...}}.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import time

import numpy as np
import torch

import femo_tpu_torch
from femo_tpu_torch import native
from femo_tpu_torch.models.motor.model import (
    build_motor_jit_step, edge_delta_design_space)
from femo_tpu_torch.models.motor.pde import source_tables
from femo_tpu_torch.ops import bt_sweeps
from femo_tpu_torch.ops.block_tridiag import BlockTridiagonalMatrix

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
    t0 = time.perf_counter()
    native.get_lib()
    t1 = time.perf_counter()
    bt_sweeps.get_lib()
    t2 = time.perf_counter()
    ptxas = [ln.strip() for ln in bt_sweeps.build_log.splitlines()
             if "registers" in ln or "Compiling entry" in ln]
    print(f"build: native g++ {t1 - t0:.2f} s, {bt_sweeps.SRC} with nvcc "
          f"{' '.join(bt_sweeps.NVCC_FLAGS)} {t2 - t1:.2f} s")
    for ln in ptxas:
        print(f"  ptxas: {ln}")


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


def check_sweeps(fac, bb, label, err):
    """Kernel vs plain for K1, K2 and the whole solve; returns rel err."""
    m = fac.mat
    z_k = bt_sweeps.fwd_sweep_cuda(fac.Sinv, m.L, bb)
    z_p = bt_sweeps.fwd_sweep_plain(fac.Sinv, m.L, bb)
    x_k = bt_sweeps.bwd_sweep_cuda(fac.C, z_p)
    x_p = bt_sweeps.bwd_sweep_plain(fac.C, z_p)
    x_solve = bt_sweeps.bt_sweep_solve(fac.Sinv, m.L, fac.C, bb)
    torch.cuda.synchronize()
    r = max(rel(z_k, z_p), rel(x_k, x_p), rel(x_solve, x_p))
    tol = SWEEP_TOL[bb.dtype]
    print(f"  {label}: rel L2 {r:.3e} (tol {tol:.0e})")
    if not r <= tol:
        raise AssertionError(f"{label}: kernel disagrees with plain, {r}")
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
    """Kernel and plain times (median of 50 CUDA-event timings), ms."""
    m = fac.mat
    z = bt_sweeps.fwd_sweep_plain(fac.Sinv, m.L, bb)
    t = {
        "K1": cuda_ms(lambda: bt_sweeps.fwd_sweep_cuda(fac.Sinv, m.L, bb)),
        "K1_plain": cuda_ms(
            lambda: bt_sweeps.fwd_sweep_plain(fac.Sinv, m.L, bb)),
        "K2": cuda_ms(lambda: bt_sweeps.bwd_sweep_cuda(fac.C, z)),
        "K2_plain": cuda_ms(lambda: bt_sweeps.bwd_sweep_plain(fac.C, z)),
    }
    nb, B = fac.Sinv.shape[:2]
    print(f"  time, {label} nb={nb} B={B} f64 (median of 50, CUDA events): "
          f"K1 {t['K1']:.4f} ms vs plain {t['K1_plain']:.4f} ms; "
          f"K2 {t['K2']:.4f} ms vs plain {t['K2_plain']:.4f} ms")
    return t


def phase_kernels(info1, dv0, iq0):
    print("kernels: K1/K2 against the plain sweeps on the card")
    for dtype in (torch.float32, torch.float64):
        for B in (128, 256):
            for nb in (1, 3, 9):
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


def timed_step(step, dv, iq):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, (g_dv, g_iq) = step(dv, iq)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, loss, g_dv, g_iq


def counted_step(step, dv0, iq0):
    """One step with the kernels' launch counts reset just before it and
    read just after; each kernel runs once per sweep solve."""
    for k in bt_sweeps.launches:
        bt_sweeps.launches[k] = 0
    out = timed_step(step, dv0, iq0)
    launches = dict(bt_sweeps.launches)
    print(f"  launches in the step: K1 {launches['K1']}, K2 "
          f"{launches['K2']} (expected {SOLVES_PER_STEP} each)")
    if launches != {"K1": SOLVES_PER_STEP, "K2": SOLVES_PER_STEP}:
        raise AssertionError(f"kernel launches {launches}, expected "
                             f"{SOLVES_PER_STEP} each")
    return out + (launches,)


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
    cold, loss, g_dv, g_iq, launches = counted_step(step, dv0, iq0)
    check_step(1, loss, g_dv, g_iq, 576, 1e-8)
    warm, loss_w, g_dv_w, _ = timed_step(step, dv0, iq0)
    print(f"  step wall time: first call {cold:.3f} s, warm {warm:.3f} s")

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
    return launches


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
    cold, loss, g_dv, g_iq, _ = counted_step(step, dv0, iq0)
    check_step(4, loss, g_dv, g_iq, dv0.numel(), 1e-7)
    warm, _, _, _ = timed_step(step, dv0, iq0)
    print(f"  step wall time: first call {cold:.3f} s, warm {warm:.3f} s")
    for which, (fac, bb) in check_real_factors(info, dv0, iq0, 4,
                                               err).items():
        time_sweeps(fac, bb, f"refine-4 {which}")


def main():
    femo_tpu_torch.set_precision("float64")
    phase_device()
    phase_build()
    step1, (dv0, iq0), info1 = build_motor_jit_step(refine=1, device="cuda",
                                                    **ORACLE_CFG)
    t, err = phase_kernels(info1, dv0, iq0)
    launches = phase_refine1(step1, dv0, iq0, info1)
    phase_refine4(err)
    print(f"kernels vs plain on the step's factors (refine 1 and 4): max "
          f"|kernel - plain| K1 {err['K1']:.3e}, K2 {err['K2']:.3e}")
    src = "femo_tpu_torch/csrc/bt_sweeps.cu"
    print(json.dumps({"kernels": [
        {"name": f"{name} ({k})", "route": "cuda", "source": src,
         "replaces": f"femo_tpu/ops/pallas_bt.py:{line}",
         "launches": launches[k], "max_abs_err": err[k], "ms": t[k],
         "plain_ms": t[f"{k}_plain"]}
        for k, name, line in (("K1", "bt_fwd_sweep", 60),
                              ("K2", "bt_bwd_sweep", 76))]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
