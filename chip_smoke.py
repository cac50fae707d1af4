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
   too.  refine4_cr: the same step with block cyclic reduction
   (factor_method="cr"): 0 K1/K2 launches (counted from 0, as the code
   says), loss (1e-8) and gradient (1e-6) against the JAX package's r4_cr
   entry (oracles/motor_oracle.npz), a warm step, the peak device memory,
   and on the step's mesh-motion Jacobian the CR factor and solve beside
   Thomas's (CUDA events and the profiler's device time), the stored
   bytes, the solve's byte bound and the factor's flops against the f64
   peak.
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
   leaves out the host time between launches.  K4/K4T in both of their
   hand-written designs (ops/spmv.py::element_design) on the W1 operator
   and on synthetic patterns (no element, a 90 x 90 block whose tile
   needs more than 48 KB of shared memory, A_e off a 16-byte boundary),
   f64 and f32, each block alone and summed twice bit for bit; timed per
   design beside torch.sparse.mm on the CSR and on its transpose, with a
   burst of back-to-back calls besides.  K5 is timed on all four
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
   versions in both designs (f64 1e-14, f32 1e-6) on the path's own
   Jacobians: every element block alone (W4's 8x8 quad-elasticity blocks
   too), then the blocks summed, later blocks adding into the first
   block's output, twice bit for bit, and matvec/rmatvec equal to that
   sum; K4/K4T timed on W4's 8x8 blocks as on W1's; in phase 14 K1/K2 against plain (f64 1e-12) and
   timed on the block-Thomas factors that preconditioned the solves.
20. shell: the W6 compliance step build_shell_jit_step(n_shell=(24, 400))
   (19,200 cells, 147,822 dofs, nb=289 blocks of B=512) in f64, in the
   oracle's f64 configuration a (split_programs, pcg_iters=2) and in the
   JAX package's TPU production configuration b (f32 factor storage,
   pcg_iters=4): the first step with K1/K2 counted (2 (2 + pcg_iters)
   each) and one factor, the median of 5 warm steps, the peak device
   memory; the residual at a random state against the JAX package's
   (1e-12); compliance and gradient against oracles/shell_oracle.npz at
   the fixed bars of SHELL_GATES (the energy estimate 2 (J - E), J, the
   gradient; set from the readings of the first runs on the card, PERF.md
   §6: every solve stalls at f64's residual floor for this thin-shell
   operator, which moves J by ~2e-6 at this size, where the energy
   estimate, second order in the state's error, agrees to ~6e-13);
   K1/K2 against plain on each configuration's own factor (10x the plain
   solve's spread under reordered sums, step residuals 1e-12), timed on
   a's; two runs of the residual, the template fill and the step give
   equal bits; the card against CPU tensors at (6, 8) within 10x the JAX
   package's own spread between its step paths of the same kind.
21. shell_modal: shift-invert Lanczos on the (24, 400) plate, 6 modes, 40
   iterations, each one K1 + K2 launch; frequencies against the oracle
   where the JAX run converged them: the Rayleigh quotients from the
   modes' strain energy at 1e-10, the Lanczos values at the fixed bars of
   MODAL_GATES (1e-6; the fundamental 1e-5, the f64 floor again).
22. shell_module: ShellModule on the (16, 24) plate through Simulator.run
   and objective_gradient of compliance and the p-norm stress (K1/K2 5
   each), each output against the oracle within 10x the JAX package's
   own jit_bt vs jit_dense spread for that output, at least 1e-12;
   K1/K2 against plain on the (16, 24) step's factors, f64 and f32
   storage.
23. fsi: the W7 static aeroelastic FSI anchor, build_fsi_jit_step(
   n_shell=(4, 13440), n_vlm=(4, 32), span=30, thickness=0.05) (107,520
   cells, 927,402 dofs, 128 panels, nb=7246 blocks of B=128) in f64 in
   the JAX package's anchor solver (FSI_SOLVER: f32 factor storage, every
   inner solve PCG to 1e-7, 5 rounds of 4 Gauss-Seidel passes, the
   24-pass coupled adjoint): the build (the host template), the first
   solve_with_grad with K1/K2/K4T counted (K1 and K2 once per inner solve
   and per preconditioner application that pcg_tol reports, K4T once per
   adjoint pass) and its stage seconds, synced (fill, factor core,
   Gauss-Seidel, finalize, adjoint), peak device memory, rel_delta,
   adj_delta and the PCG iteration counts (no warm repeat: a depth cut,
   PERF.md §6); force conservation (1e-13); the tip against
   the exact solution of its own last linear system, solved apart from
   the block-Thomas path by banded LU with partial pivoting on the host
   and refined with longdouble residuals (FSI_GATES' anchor_solve);
   K1/K2 against plain on the anchor's factor (10x the plain solve's
   reordered-sum spread, step residuals 1e-12) and timed at (7246, 128);
   K4/K4T against plain on the force-load operator Fm (107,520
   rectangular 18 x 9 blocks; both designs, f64 1e-14, f32 1e-6) and
   timed beside torch.sparse.mm on its CSR and on the transposed CSR;
   the anchor again with its factor stored in f64, one solve_with_grad
   counted, against the JAX package's anchor entry (tip and objective
   2e-2, gradient 4e-2: FSI_GATES' anchor_f64); the anchor with block
   cyclic reduction in that f64-storage configuration, built on the
   anchor's template: one counted solve_with_grad (K4T 24, no K1/K2)
   with its stages timed, peak memory, force
   conservation (1e-13), the tip against the exact solution of its own
   last system (no farther than the unrefined pivoted LU of that system:
   FSI_GATES' anchor_cr_solve), tip and objective against the port's Thomas
   f64-storage run above (1e-3: FSI_GATES' anchor_cr), the distance to
   the JAX anchor entry printed and not gated, the CR factor and solve
   beside Thomas's; the anchor operator's equilibrated f32 factor
   (factor_compute_dtype="float32": guarded f32 recursion, its rescued
   blocks) with K1/K2 in f32 against plain (SWEEP_TOL f32, or 10x the
   plain solve's reordered-sum spread) and timed at (7246, 128);
   then the same wing against the JAX package's values
   (oracles/fsi_oracle.npz) at (4, 6720) (53,760 cells; f32 factor
   storage: tip and objective; f64 storage: tip, objective and
   gradient) and at (4, 1680) (13,440 cells, chunked; f32 storage within
   10x the JAX package's own spread, f64 storage at fixed bars, cyclic
   reduction with f64 storage against the JAX package's rung_cr_f64 at
   rung_f64's bars, and the residual at a random state, 1e-12).
24. fsi_small: bench_scale.py's small rung (16, 24) / (4, 8) against the
   oracle within 10x the JAX package's own spread between two of its
   factors, and the card against CPU tensors at (4, 6).
25. fsi_dynamic: W8, the gust-response dynamic FSI, at bench_scale.py's
   77k rung, build_dynamic_fsi_jit_step(n_shell=(4, 9600), n_vlm=(4,
   24), span=21, thickness=0.05, dt=0.01, fsi_iters=2, pcg_iters=4)
   (76,800 cells, 662,442 dofs, 96 panels, nb=5176 blocks of B=128),
   f64, 12 time steps (the gust acts in steps 11 and 12): the build and
   the factor's two halves; with f32 factor storage a run and a
   run_with_grad (the checkpointed trajectory adjoint, 6 passes a step),
   then with f64 storage a run_with_grad, the K1/K2/K4T counts set to 0
   just before each and read just after and required to equal the counts
   derived from the code (dyn_want); per-step forward and backward
   seconds, J, |grad|, adj_deltas; each against the JAX package's entry
   of its storage at the fixed bars of DYN_GATES
   (oracles/fsi_dynamic_oracle.npz), and the port's f32-vs-f64 distance
   within 10x the JAX package's own; two f64 run_with_grad of 2 steps
   with equal bits; peak device memory; K1/K2 against plain
   on the rung's f64-stored factor (10x the plain solve's reordered-sum
   spread, step residuals 1e-12) and timed at (5176, 128); K4/K4T against
   plain on its Fm (76,800 18 x 9 blocks, both designs) and timed; W9
   (external_loads=True) on the W8 build's template under the synthetic
   restart series written to a temporary directory and read back through
   aero_forces_from_file, one counted run_with_grad against the JAX
   package's entry (tips, J, the thickness and load gradients,
   DYN_GATES); W8 on that template with block cyclic reduction and with
   the equilibrated f32 factor (f64 storage, DYN_FACTORS), one counted
   run_with_grad each (cr: no K1/K2; the f32 factor over one step), CR
   against the JAX package's rung_f64 entry at DYN_GATES, the f32
   factor's run printed and not gated (no preconditioner at this chain
   length, in either package; DYN_FACTORS says why), its rescued blocks,
   and K1/K2 in f32 against
   plain on its factor, timed at (5176, 128); the f32 factor on the same
   wing at 600 spanwise cells against the JAX package's span600_f64 entry
   at DYN_GATES; the eager
   DynamicShellFSI at (4, 6), with and without an active gust, against
   the JAX package's eager tips within 10x its eager-vs-jit spread.
26. facets_3d: an interior-facet residual and its Jacobian on
   create_unit_cube_mesh(8), tets and hexes, on the card against CPU
   tensors (1e-12), twice with equal bits.
27. run_scripts (run right after phase 2, the build): the
   port's run scripts (femo_tpu_torch/examples/) and the L-BFGS-B
   driver, against the JAX package's runs of its own scripts
   (oracles/examples_oracle.npz, femo_tpu_torch/tools/example_parity.py):
   run_motor_opt --jit --refine 4 --maxiter 3 (f64, block Thomas; K1/K2
   launches = 170 x evaluations; the evaluation count, first loss 1e-8
   and gradient 1e-6, later losses 1e-7, final x 1e-6; per-evaluation
   wall times), W1 at nel=260 through LBFGSB(maxiter=5) (K4/K4T launches
   = BiCGStab's matvecs; every objective 1e-8, final controls 1e-6),
   run_motor_opt --refine 1 --driver snopt --maxiter 1 (SNOPT's warning;
   one SLSQP iteration, whose two evaluations agree with JAX's at 1e-7,
   the first gradient and final design at 1e-6; the paths would part at
   a second step), then every other script once at small arguments (objectives
   1e-8, designs 1e-6; topo at its first evaluation and the JAX run's
   final design, the roof at 10x the JAX package's spread between its
   two solves; not the shell thickness script, SCRIPT_KEYS says why);
   all kernel counts set to 0 around each run.
28. distributed (run last, after the side processes below have ended,
   and after phase 16, whose unsharded step it reuses): 4 ranks on the
   one card (femo_tpu_torch/parallel/launch.spawn; gloo,
   since NCCL refuses two ranks on one device; CUDA tensors, f64), K4's
   library built here before they start (tools/distributed_check.py).
   Mode b: run_distributed_poisson.py's system at nel=260 (135,200
   cells, 68,121 dofs) dof-sharded over the ranks, the layout's L/G/S
   equal to the JAX package's, a cold and a warm Jacobi CG to rtol 1e-8,
   each rank's K4 count set to 0 just before each and required to equal
   the CG's matvecs (iterations + 1), K4 against its plain version on one
   local product of each rank (f64 1e-14 of its largest entry), the split
   of an iteration's time (halo exchanges, K4, a dot); the gathered x
   against the JAX package's run over 4 devices (oracles/
   distributed_oracle.npz) at DIST_GATES: the true residual with the
   plain matvec (2e-8), the distance to the exact solution (10x the JAX
   package's own), the iterations (3%); the same CG on a group of one
   rank, at the same bars; K4/K4T timed at rank 0's local shape (33,800
   3x3 elements).  Mode a: build_jit_opt_step(nel=260) against phase
   16's unsharded step, build_motor_jit_step(refine=1) with the oracle
   configuration's counts and dense LU against oracles/motor_oracle.npz's
   r1_lu, build_shell_sharded_step(n_shell=(3, 4)) against the oracle
   file; value 1e-8, gradient 1e-6; every rank's values equal bit for
   bit.  Mode b inside the steps (parallel/halo_step.py): the W6 shell
   halo step at (24, 400) (19,200 cells, 147,822 dofs; block Jacobi,
   CG rtol 1e-8, bench_scale.py's run_halo_scale configuration on the
   plate of shell oracle entry a), value and gradient through the
   autograd adjoint, against entry a at SHELL_GATES["a"] and the true
   residual of its forward x at HALO_STEP_RESIDUAL; each rank's K1, K2
   and K4 set to 0 just before each solve and required to equal
   iterations + 1; K1/K2 against their plain versions on each rank's
   local factor and K4 on its 27 x 27 blocks; each rank's layout, block
   Jacobi (nb, B), fill, factor and matrix-halo times, the split of an
   iteration, the peak memory; K1/K2 timed at rank 0's (nb, B) and K4 at
   its blocks.  At (3, 4): the dryrun's two mode-b lines (the shell halo
   step with block Jacobi beside the unsharded step, the FSI halo step
   at (3, 4) / (2, 3) with 3 Gauss-Seidel passes), the shell halo step
   with jacobi and Chebyshev degree 6, each against the JAX package's
   values (distributed_oracle.npz: shell 1e-8, FSI 1e-7, CG iterations
   within 15%), their launches against the code's.  A rank that raises
   makes the phase raise.

Phases 23-25 run beside the main sequence: right after the build two
side processes start (`chip_smoke.py --side fsi|fsi_dynamic OUT`, the
same phases, their results written as JSON to OUT), and the main
sequence waits for both before phase 28, printing each one's output
then.  A side that fails or outlasts SIDE_LIMIT fails the script, and
every side still running when the script fails is killed.

Each phase prints its wall seconds.  It prints a JSON line describing
the kernels (K1/K2 with their launches on every motor path, the
shell's and FSI's, W8's and W9's (0 on the cyclic-reduction paths), with
their f32 times on the f32 factors, K4/K4T on W1, W1 with weak BCs, W2
and W4, K4T on FSI's and W8's Fm, and the run scripts' paths
(`launches_by_path`; the distributed halo CG's K4 summed over
the ranks, and by rank; mode b inside the steps' K1, K2 and K4 summed
and by rank, `distributed_launches_by_rank`), with K1/K2's times at a
halo step rank's block-Jacobi shape, K4/K4T's times at W1's, W4's,
both Fm shapes, a halo rank's local shape and a halo step rank's
27 x 27 blocks),
and last
{"ok": true, "device": {...}}.  Imports nothing of JAX.
"""

from __future__ import annotations

import collections
import functools
import gc
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
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
from femo_tpu_torch.fea.assemble import (
    ElementMatrix, MatBlock, assemble_matrix, compile_form)
from femo_tpu_torch.fea.fea import FEA
from femo_tpu_torch.fea.forms import FormDef, dS, dot, ds, dx, grad, jump
from femo_tpu_torch.fea.shape import shape_gradient
from femo_tpu_torch.fea.space import Function, FunctionSpace
from femo_tpu_torch.fea.utils import errorNorm
from femo_tpu_torch.graph.model import FEAModel
from femo_tpu_torch.graph.optimizer import (
    LBFGSB, OptimizationProblem, SLSQP)
from femo_tpu_torch.graph.simulator import Simulator
from femo_tpu_torch.mesh.generators import (
    create_unit_cube_mesh, create_unit_square_mesh)
from femo_tpu_torch.models.beam import OPENMDAO_THICK_REF, build_beam_problem
from femo_tpu_torch.models.poisson import (
    build_fea, build_jit_opt_step, on_boundary)
from femo_tpu_torch.models.fsi import (
    DynamicShellFSI, aero_forces_from_file, build_dynamic_fsi_jit_step,
    build_fsi_jit_step, build_wing_fsi, one_cosine_gust, synthetic_restart)
from femo_tpu_torch.models.shell import (
    build_shell_jit_step, modal_operators, plate_shell, shell_modal_analysis)
from femo_tpu_torch.models.shell_module import plate_module
from femo_tpu_torch.models.topopt import build_topopt_model
from femo_tpu_torch.ops import bt_sweeps, spmv
from femo_tpu_torch.ops.block_tridiag import (
    BlockThomasFactor, BlockTridiagonalMatrix)
from femo_tpu_torch.solvers.krylov import cg
from femo_tpu_torch.solvers.linear import (
    BlockThomasKrylovFactorization, KrylovFactorization, LinearSolver)
from femo_tpu_torch.parallel.halo import HaloShardedOperator
from femo_tpu_torch.parallel.sharding import RankMesh
from femo_tpu_torch.tools import distributed_check
from femo_tpu_torch.utils.roofline import CHIP_SPECS
from femo_tpu_torch.tools.example_parity import (
    check_example, check_optimizer, config, load_oracle, run_example)
from femo_tpu_torch.tools.fsi_conditioning import direct_witness
from femo_tpu_torch.tools.minimize_log import minimize_log
from femo_tpu_torch.tools.profile_step import (
    DYN_LAYERS, FSI_LAYERS, SHELL_LAYERS, layer_ranges)
from femo_tpu_torch.tools.shell_parity import (
    ROUNDING, module_bars, path_kind, step_spread)

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


def jacobian_matrix(info, which, dv0, iq0, em_load_steps):
    """A Jacobian the step factors, in block-tridiagonal form on the card:
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
    return tpl.matrix(jac(u, p))


def jacobian_factor(info, which, dv0, iq0, em_load_steps):
    """jacobian_matrix's matrix, block-Thomas factored."""
    return jacobian_matrix(info, which, dv0, iq0, em_load_steps).factor()


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


def time_sweeps(fac, bb, label, plain_reps=50, profile=True):
    """Kernel and plain times, ms: the median of 50 CUDA-event timings of
    one call (`plain_reps` for the plain version, whose Python loop takes
    a second at nb ~ 7,000), and the profiler's device time per call (the
    kernel's own time plus the fill of its output with the not-yet-written
    mark), with the bounds, the launch geometry and the device time per
    dependent phase (2 nb - 1 for K1, nb - 1 for K2).  With profile=False
    the device times are not measured (a trace of the plain loop's tens of
    thousands of launches takes minutes) and the time per phase, the
    share of the bound and the speed-up come from the event times, which a
    call of ~10 ms holds with microseconds of host time."""
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
    plain = {k: k.endswith("_plain") for k in fns}
    t.update({k: cuda_ms(fn, reps=plain_reps if plain[k] else 50,
                         warm=2 if plain[k] else 5)
              for k, fn in fns.items()})
    names = {"K1": "bt_fwd_kernel", "K2": "bt_bwd_kernel"}
    t.update({f"{k}_device": device_ms(
        fn, names.get(k), reps=min(plain_reps, 10) if plain[k] else 10)
        if profile else None for k, fn in fns.items()})
    print(f"  time, {label} nb={nb} B={B} {str(bb.dtype)[6:]} (median of "
          f"50, plain "
          f"{plain_reps}, CUDA events): "
          f"K1 {t['K1']:.4f} ms vs plain {t['K1_plain']:.4f} ms, bound "
          f"{t['K1_bound'][0]:.4f} ms; K2 {t['K2']:.4f} ms vs plain "
          f"{t['K2_plain']:.4f} ms, bound {t['K2_bound'][0]:.4f} ms")
    print(f"  device time per call (profiler, 10 calls, plain "
          f"{min(plain_reps, 10)}): K1 {fmt_ms(t['K1_device'])} vs plain "
          f"{fmt_ms(t['K1_plain_device'])}; K2 {fmt_ms(t['K2_device'])} vs "
          f"plain {fmt_ms(t['K2_plain_device'])}")
    phases = {"K1": 2 * nb - 1, "K2": max(nb - 1, 1)}
    for k in ("K1", "K2"):
        plan = bt_sweeps.sweep_plan(k, nb, B, bb.dtype,
                                     bt_sweeps._sms(bb.device.index))
        t[f"{k}_geometry"] = dict(ctas=plan.ctas, rows=plan.rows,
                                  stages=plan.stages, smem=plan.smem)
        dev = t[f"{k}_device"] if profile else t[k]
        t[f"{k}_us_per_phase"] = ratio(dev, phases[k] / 1e3)
        share = ratio(t[f"{k}_bound"][0], dev)
        speed = ratio(t[f"{k}_plain_device"] if profile
                      else t[f"{k}_plain"], dev)
        print(f"  {k}: G={plan.ctas} CTAs x R={plan.rows} rows, S="
              f"{plan.stages} stages, {plan.smem} B shared memory"
              + ("; device time not measured" if share is None else
                 f"; {t[f'{k}_us_per_phase']:.3f} us per dependent phase "
                 f"({phases[k]}); {100 * share:.1f}% of the bound")
              + ("" if speed is None else
                 f"; {speed:.2f}x the plain version's speed"))
    t["shape"] = dict(label=label, nb=nb, B=B, dtype=str(bb.dtype)[6:])
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
          f"{launches['K2']} launches; {lr.calls['bt.factor']} factors "
          f"(Thomas; {lr.calls['bt.factor_cr']} cyclic reduction), "
          f"{lr.calls['assemble.jacobian']} Jacobian assemblies, "
          f"{lr.calls['bt.solve']} block solves (Thomas; "
          f"{lr.calls['bt.cr_solve']} cyclic reduction)")
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
    warm = warm_seconds(step, dv0, iq0, 1)
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
    warm = warm_seconds(step, dv0, iq0, 1)
    print(f"  step wall time: first call {cold:.3f} s, warm {warm:.3f} s")
    return [time_sweeps(fac, bb, f"refine-4 {which}")
            for which, (fac, bb) in check_real_factors(info, dv0, iq0, 4,
                                                       err).items()], \
        warm, info, dv0


def stored_bytes(tensors):
    """Bytes of the distinct storages behind `tensors` (views counted
    once)."""
    seen = {}
    for t in tensors:
        st = t.untyped_storage()
        seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())


def cr_bytes(fac):
    """A cyclic-reduction factor's stored bytes (its levels and root)."""
    return stored_bytes([a for lvl in fac.levels for a in lvl]
                        + [fac.Dinv_root])


def cr_flops(n2, B):
    """The operations of factor_cr on n2 blocks of B: per level of m
    blocks, m / 2 inverses (~2 B^3 each) and six products of m / 2 block
    pairs (2 B^3 each), so 7 m B^3; 14 n2 B^3 over the levels."""
    return 14 * n2 * B ** 3


def cr_times(mat, label, reps=3):
    """The CR factor of `mat` beside its Thomas factor, and their solves,
    on the card: CUDA-event medians of `reps` calls (the solves 10; the
    Thomas factor, a Python loop of seconds at the FSI anchor, one call
    between syncs) and the profiler's device time per call of the CR
    factor and solve (device_ms); the CR factor's
    stored bytes, the solve's byte bound (the stored arrays read once,
    3.35 TB/s), the factor's operations against the f64 peak; the two
    solves' distance.  Returns the readings (ms)."""
    nb, B = mat.nb, mat.B
    n2 = 1 << (nb - 1).bit_length()
    fac = mat.factor_cr()
    t_th, th = synced(mat.factor)
    b = torch.as_tensor(np.random.default_rng(61).standard_normal(mat.n),
                        dtype=torch.float64, device=mat.D.device)
    x_cr, x_th = fac.solve(b), th.solve(b)
    nbytes = cr_bytes(fac)
    t = dict(
        factor_cr_ms=cuda_ms(lambda: mat.factor_cr(), reps=reps, warm=1),
        factor_thomas_ms=1e3 * t_th,
        factor_cr_device_ms=device_ms(lambda: mat.factor_cr(), reps=2,
                                      tries=3),
        solve_cr_ms=cuda_ms(lambda: fac.solve(b), reps=10, warm=2),
        solve_cr_device_ms=device_ms(lambda: fac.solve(b), reps=10),
        solve_thomas_ms=cuda_ms(lambda: th.solve(b), reps=10, warm=2),
        stored_gib=nbytes / 2**30, n2=n2, nb=nb, B=B,
        solve_bound_ms=bound_ms(nbytes, 2 * nbytes / 8, torch.float64)[0],
        factor_flops=cr_flops(n2, B),
        cr_vs_thomas=rel(x_cr, x_th))
    dev = t["factor_cr_device_ms"]
    t["factor_peak_share"] = ratio(
        t["factor_flops"] / PEAK_OPS[torch.float64] * 1e3, dev)
    print(f"  {label} (nb={nb} -> n2={n2}, B={B}): CR factor "
          f"{t['factor_cr_ms']:.3f} ms (events; device "
          f"{fmt_ms(dev, 3)}, {t['factor_flops']:.3e} flops"
          + ("" if dev is None else
             f", {100 * t['factor_peak_share']:.2f}% of the f64 peak")
          + f") vs Thomas {t['factor_thomas_ms']:.3f} ms; stored "
          f"{t['stored_gib']:.3f} GiB; CR solve {t['solve_cr_ms']:.4f} ms "
          f"(device {fmt_ms(t['solve_cr_device_ms'])}, bound "
          f"{t['solve_bound_ms']:.4f} ms on the stored bytes) vs Thomas "
          f"(K1 + K2) {t['solve_thomas_ms']:.4f} ms; CR vs Thomas solve "
          f"rel {t['cr_vs_thomas']:.3e}")
    return t


def phase_refine4_cr():
    """The motor step at refine 4 in the oracle configuration with block
    cyclic reduction (factor_method="cr"), f64: the first step with its
    sweep launches counted (0: cyclic reduction launches no K1/K2),
    against the JAX package's r4_cr entry (loss 1e-8, gradient 1e-6), a
    warm step, the peak device memory; the CR factor and solve beside
    Thomas's on the step's mesh-motion Jacobian (cr_times)."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_build, (step, (dv0, iq0), info) = synced(lambda: build_motor_jit_step(
        refine=4, device="cuda", factor_method="cr", **ORACLE_CFG))
    cold, (loss, (g_dv, g_iq)), launches, _ = counted_path(
        lambda: step(dv0, iq0), "first step, factor_method='cr'")
    expect("K1/K2 launches (cyclic reduction)", launches, {"K1": 0, "K2": 0})
    rl, rg = check_oracle("refine 4 cr", loss, g_dv, g_iq, motor_oracle(),
                          "r4_cr", 1e-8, 1e-6)
    warm = warm_seconds(step, dv0, iq0, 1)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"  build {t_build:.2f} s, first step {cold:.3f} s, warm "
          f"{warm:.3f} s; peak device memory {peak:.3f} GiB")
    t = cr_times(jacobian_matrix(info, "mm", dv0, iq0,
                                 ORACLE_CFG["em_load_steps"]),
                 "refine-4 mm Jacobian")
    return dict(loss_rel=rl, grad_rel=rg, first_s=cold, warm_s=warm,
                peak_gib=peak, launches=launches, times=t)


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
    warm = warm_seconds(step, dv0, iq0, 1)
    print(f"  warm step {warm:.3f} s at "
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
        warm = warm_seconds(step, dv0, iq0, 1)
        print(f"  warm step {warm:.3f} s vs "
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
# H100 SXM published peaks (NVIDIA data sheet; femo_tpu_torch/utils/
# roofline.py): HBM3 bytes/s, and operations/s outside the tensor cores
# by dtype
H100 = CHIP_SPECS["H100 80GB HBM3"]
HBM_BYTES_PER_S = H100["hbm_bw"]
PEAK_OPS = {torch.float32: H100["peak_flops_by_dtype"]["float32"],
            torch.float64: H100["peak_flops_by_dtype"]["float64"]}


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


# K4/K4T: the two hand-written designs (ops/spmv.py::element_design) and
# the CUDA kernel that each launches once a call (design 1 also launches
# owner_sum_kernel)
K4_DESIGNS = (0, 1)
K4_KERNEL = {0: "element_spmv_kernel", 1: "element_product_kernel"}
BURST = 200


def burst_ms(fn, n=BURST):
    """One call's share of n back-to-back calls between two CUDA events:
    the device time per call where the card is slower than the host's
    enqueueing (K4T on Fm), the host's time per call where not."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def time_element(label, mat, seed):
    """K4 and K4T (f64) on the largest element block of `mat` (W4's
    Jacobian has a second block of 2 elements), in each design
    (K4_DESIGNS), beside their plain versions and torch.sparse.mm on the
    block's CSR and on its transpose: per direction the median of 50
    CUDA-event timings of one call (ms), a burst of BURST calls over BURST
    (burst_ms) and the profiler's device time per call (device_ms), by
    design; the bound (bytes: A_e, rows, cols, x and y once; "bound",
    with the operations); the share bound / device time of the design
    element_design takes ("design"; of its burst time where the trace
    was incomplete, "share_of" says which)."""
    b = max(mat.blocks, key=lambda b: b.A.shape[0])
    ne, nr, nc = b.A.shape
    n_rows, n_cols = mat.shape
    rng = np.random.default_rng(seed)
    csr = ElementMatrix([b], n_rows, n_cols).to_scipy_csr()
    nbytes = ne * nr * nc * 8 + ne * (nr + nc) * 4 + (n_rows + n_cols) * 8
    bound = bound_ms(nbytes, 2 * ne * nr * nc, torch.float64)
    out = dict(label=label, ne=ne, nr=nr, nc=nc, n_rows=n_rows,
               n_cols=n_cols, csr_nnz=int(csr.nnz), nbytes=nbytes,
               bound_ms=bound[0], bound_by=bound[1])
    for k, n_in, lib_csr, kern, plain in (
            ("K4", n_cols, csr, spmv.element_spmv_cuda,
             lambda v: spmv.element_spmv_plain(b.A, b.rows, b.cols, v,
                                               n_rows)),
            ("K4T", n_rows, csr.T.tocsr(), spmv.element_rspmv_cuda,
             lambda v: spmv.element_rspmv_plain(b.A, b.rows, b.cols, v,
                                                n_cols))):
        v = torch.as_tensor(rng.standard_normal(n_in), device="cuda")
        pick = spmv.element_design(nr, nc, k == "K4T", 8)
        L = torch_csr(lib_csr)
        lib = lambda L=L, v=v: torch.sparse.mm(L, v[:, None])  # noqa: E731
        check_rel(f"torch.sparse.mm vs {k} ({label})", lib()[:, 0],
                  kern(b.A, b.plan, v), SPMV_TOL[torch.float64])
        r = dict(bound=bound, design=pick,
                 plain_ms=cuda_ms(lambda v=v: plain(v)),
                 library_ms=cuda_ms(lib), library_burst_ms=burst_ms(lib),
                 plain_device_ms=device_ms(lambda v=v: plain(v)),
                 library_device_ms=device_ms(lib))
        for d in K4_DESIGNS:
            fn = lambda d=d, v=v: kern(b.A, b.plan, v, design=d)  # noqa
            # the profiler has dropped the same launches of one kernel in
            # every trace of 10 calls; a trace of 25 is tried before the
            # time goes unmeasured
            dev = (device_ms(fn, K4_KERNEL[d])
                   or device_ms(fn, K4_KERNEL[d], reps=25, tries=2))
            r[f"design{d}"] = dict(ms=cuda_ms(fn), burst_ms=burst_ms(fn),
                                   device_ms=dev)
        r.update(r[f"design{pick}"])
        t = r["device_ms"] if r["device_ms"] is not None else r["burst_ms"]
        r["share"] = bound[0] / t
        r["share_of"] = ("device_ms" if r["device_ms"] is not None
                         else "burst_ms")
        print(f"  time {k} on {label} ({ne} {nr}x{nc} blocks, {n_rows} x "
              f"{n_cols}), f64: "
              + "; ".join(
                  f"design {d}{' (taken)' if d == pick else ''} "
                  f"{r[f'design{d}']['ms']:.4f} ms event, "
                  f"{r[f'design{d}']['burst_ms']:.4f} ms in a burst of "
                  f"{BURST}, device {fmt_ms(r[f'design{d}']['device_ms'])}"
                  for d in K4_DESIGNS)
              + f"; plain {r['plain_ms']:.4f} ms / device "
              f"{fmt_ms(r['plain_device_ms'])}; torch.sparse.mm on the "
              f"{'transposed ' if k == 'K4T' else ''}CSR ({csr.nnz} "
              f"entries) {r['library_ms']:.4f} ms / burst "
              f"{r['library_burst_ms']:.4f} ms / device "
              f"{fmt_ms(r['library_device_ms'])}; bound {bound[0]:.4f} ms "
              f"({nbytes / 1e6:.2f} MB), {100 * r['share']:.0f}% of it "
              f"reached ({r['share_of']})")
        out[k] = r
    return out


def k4_patterns():
    """Synthetic element matrices for K4/K4T's edge cases, each one block
    on the card: (ne, nr, nc) from no element to a 90 x 90 block whose
    tile takes more than 48 KB of shared memory, a last tile cut short,
    odd and even nc, rows and columns shared between elements, entries
    numbered as nodes of bs components (bs 3: what design 1 gathers by
    node), and A_e starting 8 bytes off a 16-byte boundary (offset 1: no
    TMA copy)."""
    rng = np.random.default_rng(21)
    mats = []
    for ne, nr, nc, n_rows, n_cols, bs, offset in (
            (0, 3, 3, 5, 5, 1, 0), (1, 1, 1, 1, 1, 1, 0),
            (7, 3, 3, 20, 20, 1, 0), (256, 3, 3, 100, 100, 1, 1),
            (33, 8, 8, 90, 90, 1, 0), (29, 18, 9, 200, 50, 1, 1),
            (61, 18, 9, 300, 90, 3, 0), (61, 18, 9, 300, 90, 3, 1),
            (5, 2, 7, 9, 30, 1, 0), (3, 90, 90, 200, 200, 1, 0)):
        rows, cols = (torch.as_tensor(np.array(
            [bs * rng.choice(n // bs, k // bs, replace=False)[:, None]
             + np.arange(bs) for _ in range(ne)],
            np.int64).reshape(ne, k), device="cuda")
            for n, k in ((n_rows, nr), (n_cols, nc)))
        buf = torch.as_tensor(rng.standard_normal(ne * nr * nc + offset),
                              device="cuda")
        mats.append(ElementMatrix(
            [MatBlock(buf[offset:].view(ne, nr, nc), rows, cols)], n_rows,
            n_cols))
    return mats


def shape_row(t, k):
    """K4's or K4T's numbers at one shape (time_element), for the kernels
    line's `shapes`."""
    r = t[k]
    return dict({x: t[x] for x in ("label", "ne", "nr", "nc", "n_rows",
                                   "n_cols", "csr_nnz", "bound_ms",
                                   "bound_by")},
                **{x: r[x] for x in r if x != "bound"})


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

    A_lib = torch_csr(csr)
    saved = dict(spmv.launches)
    err4 = check_element_matrices(f"W1 nel={W1_NEL} stiffness", [A])
    err4e = check_element_matrices("synthetic patterns", k4_patterns())
    for kern in ("K4", "K4T"):
        err[kern] = max(err[kern], err4[kern], err4e[kern])
    t = {"K3": time_spmv(
        "K3", "ell_thread_kernel" if k <= 8 else "ell_warp_kernel",
        lambda: spmv.ell_spmv_cuda(ell.vals, ell.cols, x64),
        lambda: spmv.ell_spmv_plain(ell.vals, ell.cols, x64),
        lambda: torch.sparse.mm(A_lib, x64[:, None]),
        ell.vals.numel() * (8 + 4) + 2 * n * 8, 2 * ell.vals.numel())}
    t["K4_shapes"] = [time_element(f"W1 nel={W1_NEL} stiffness", A, 12)]
    t["K4"], t["K4T"] = t["K4_shapes"][0]["K4"], t["K4_shapes"][0]["K4T"]
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
                        grad_tol, ref="JAX"):
    """A value (relative) and a gradient (relative L2) against the JAX
    package's (or `ref`'s)."""
    g = grad.detach().cpu().numpy().reshape(np.shape(want_grad))
    rl = abs(float(val) - float(want_val)) / abs(float(want_val))
    rg = float(np.linalg.norm(g - want_grad) / np.linalg.norm(want_grad))
    print(f"  {label}: value {float(val)!r}, {ref} {float(want_val)!r}, rel "
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


def check_element_matrices(label, mats):
    """K4/K4T on a path's own element matrices (the Jacobian of every
    factorization that solved, W1's stiffness or FSI's force-load
    operator) against their plain versions, in each design (K4_DESIGNS),
    f64 and f32 at SPMV_TOL: each element block alone (a block whose
    plain product is exactly 0, as a load term's, must give exactly 0),
    then the blocks summed through `out` (the kernels' accumulate mode),
    twice, bit for bit; and in f64 matvec/rmatvec, which take
    element_design's design per block, bit for bit equal to that sum.
    Returns max |kernel - plain| (f64, every design) by kernel.  Called
    after the path's launches are read: these launches count for no
    path."""
    def rel0(got, want):
        n = float(torch.linalg.norm(want))
        if n == 0.0:
            return 0.0 if not bool(got.any()) else float("inf")
        return float(torch.linalg.norm(got - want)) / n

    rng = np.random.default_rng(11)
    err = {"K4": 0.0, "K4T": 0.0}
    for j, A in enumerate(mats):
        n_rows, n_cols = A.shape
        dev = A.blocks[0].A.device
        x64 = torch.as_tensor(rng.standard_normal(n_cols), device=dev)
        y64 = torch.as_tensor(rng.standard_normal(n_rows), device=dev)
        shapes = ", ".join("x".join(map(str, b.A.shape)) for b in A.blocks)
        for dtype in (torch.float64, torch.float32):
            tol = SPMV_TOL[dtype]
            As = [b.A.to(dtype) for b in A.blocks]
            sides = {"K4": (spmv.element_spmv_cuda, x64.to(dtype),
                            [spmv.element_spmv_plain(a, b.rows, b.cols,
                                                     x64.to(dtype), n_rows)
                             for a, b in zip(As, A.blocks)]),
                     "K4T": (spmv.element_rspmv_cuda, y64.to(dtype),
                             [spmv.element_rspmv_plain(a, b.rows, b.cols,
                                                       y64.to(dtype), n_cols)
                              for a, b in zip(As, A.blocks)])}
            for d in list(K4_DESIGNS) + [None]:
                r, same = {"K4": [], "K4T": []}, True
                for k, (kern, v, plain) in sides.items():
                    if d is not None:
                        for a, b, p in zip(As, A.blocks, plain):
                            got = kern(a, b.plan, v, design=d)
                            r[k].append(rel0(got, p))
                            if dtype == torch.float64:
                                err[k] = max(err[k], float(
                                    (got - p).abs().max()))
                    sums = []
                    for _ in range(2):
                        out = None
                        for a, b in zip(As, A.blocks):
                            out = kern(a, b.plan, v, out, design=d)
                        sums.append(out)
                    want = sum(plain)
                    r[k].append(rel0(sums[0], want))
                    same = same and torch.equal(sums[0], sums[1])
                    if d is None and dtype == torch.float64:
                        got = A.matvec(v) if k == "K4" else A.rmatvec(v)
                        same = same and torch.equal(got, sums[0])
                    if dtype == torch.float64:
                        err[k] = max(err[k], float(
                            (sums[0] - want).abs().max()))
                torch.cuda.synchronize()
                name = ("element_design's" if d is None
                        else f"design {d}")
                print(f"  {label}, matrix {j} ({shapes}), {name}, "
                      f"{str(dtype)[6:]} vs plain, rel L2 "
                      f"{'' if d is None else 'per block then '}"
                      f"accumulated (tol {tol:.0e}): K4 "
                      f"{', '.join(f'{v:.3e}' for v in r['K4'])}; K4T "
                      f"{', '.join(f'{v:.3e}' for v in r['K4T'])}; second "
                      f"sum bit-identical{' and equal to matvec/rmatvec' if d is None and dtype == torch.float64 else ''}: {same}")
                if not all(v <= tol for v in r["K4"] + r["K4T"]):
                    raise AssertionError(f"{label}: K4/K4T ({name}) "
                                         f"disagree with plain on matrix "
                                         f"{j}, {dtype}")
                if not same:
                    raise AssertionError(f"{label}: two K4/K4T sums "
                                         f"({name}) differ")
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
    spmv_err = check_element_matrices("w1_weak", [f.emat for f in factors])
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
                err=check_element_matrices("w2", [f.emat for f in factors]))


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
    fn, args = entry()
    t_e, (ev, eg) = synced(lambda: fn(*args))
    check_oracle_values(f"entry() nel={ce['nel']} dense", ev, eg,
                        oracle["entry_loss"], oracle["entry_grad"], 1e-12,
                        1e-10)
    t_ew, _ = synced(lambda: fn(*args))
    # no warm repeat of the jit step (a depth cut: PERF.md §6)
    print(f"  wall time: jit step first {t_cold:.3f} s; entry() first "
          f"{t_e:.3f} s, warm {t_ew:.3f} s")
    # the distributed phase's mode-a Poisson step is held to this one
    return dict(cold=t_cold, entry=t_ew,
                ref=(float(val), g.detach().cpu().numpy()))


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
    spmv_err = check_element_matrices("topopt", [f.emat for f in factors])
    k4_times = time_element(f"W4 {c['num_el_x']}x{c['num_el_y']} "
                            f"Jacobian", factors[0].emat, 13)
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
                err=spmv_err, k4_times=k4_times)


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



SHELL_ORACLE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "oracles", "shell_oracle.npz")
SHELL_FULL = dict(n_shell=[24, 400])
SHELL_RESIDUAL = dict(SHELL_FULL, seed=3, scale=1e-3)
SHELL_CONFIGS = {
    "a": dict(SHELL_FULL, split_programs=True, pcg_iters=2),
    "b": dict(SHELL_FULL, split_programs=True, spd=True,
              factor_store_dtype="float32", pcg_iters=4),
    "a_jacobi": dict(SHELL_FULL, jacobi_scale=True, pcg_iters=2),
    "b_mixed": dict(SHELL_FULL, split_programs=True, pcg_iters=4,
                    factor_compute_dtype="mixed",
                    factor_store_dtype="float32"),
    "full_residual": SHELL_RESIDUAL,
    "modal": dict(SHELL_FULL, n_modes=6, method="lanczos",
                  lanczos_iters=40, seed=0, check_iters=60),
    "module": dict(n_shell=[16, 24], span=4.0, chord=1.0, E=7e10, nu=0.3,
                   thickness=0.01, n_aero=[8, 12], force_z=-80.0),
}
# Fixed bars against the oracle at (24, 400): the energy estimate J_E =
# 2 (J - E) (relative), J (relative) and the gradient (relative L2), for
# the f64 configuration a and the f32-stored factor of the JAX package's
# TPU production configuration b.  Every f64 solve of this operator stalls
# at ||R_c|| ~4e-4, which moves J, first order in the state's error, by
# ~2e-6; J_E is second order.  Set from the readings of the first runs on
# the card (PERF.md §6; H100 80GB HBM3, 700 W): a J_E 6.2e-13, J 3.7e-6,
# gradient 7.2e-6; b J_E 5.8e-6, J 1.1e-5, gradient 1.3e-4.
SHELL_GATES = {"a": dict(JE=1e-10, J=1e-5, grad=2e-5),
               "b": dict(JE=1e-5, J=3e-5, grad=4e-4)}
# the JAX package's other path beside each (printed: its own spread)
SHELL_PAIRS = {"a": "a_jacobi", "b": "b_mixed"}
SHELL_SMALL = (6, 8)  # card against CPU tensors
SHELL_MODULE_OUTPUTS = ("mass", "compliance", "elastic_energy",
                        "pnorm_stress", "nodal_displacements", "von_mises")
# Lanczos frequencies (relative) against the oracle, mode by mode: the
# fundamental at the f64 floor (read 2.7e-6 in the first runs), the
# others at 1e-6 (read <= 4e-8); the modes' Rayleigh quotients, second
# order, at 1e-10 (read <= 7.9e-13)
MODAL_GATES = (1e-5, 1e-6, 1e-6, 1e-6, 1e-6, 1e-6)
MODAL_RQ_GATE = 1e-10


def shell_oracle(key):
    """The shell oracle file, after checking that entry `key` was computed
    for the configuration driven here."""
    oracle = np.load(SHELL_ORACLE)
    got = json.loads(str(oracle[f"{key}_config"]))
    if got != json.loads(json.dumps(SHELL_CONFIGS[key])):
        raise AssertionError(f"shell oracle entry {key} is for {got}, not "
                             f"{SHELL_CONFIGS[key]}")
    return oracle


def shell_kwargs(c):
    return {k: (tuple(v) if isinstance(v, list) else v)
            for k, v in c.items()}


def shell_gates(key, info, t0):
    """The bars of configuration `key` against the oracle (SHELL_GATES),
    after holding the card's energy estimate J_E to the JAX package's;
    prints both solutions' first-order errors |J - J_E| / J_E and the JAX
    package's own spread between `key` and its SHELL_PAIRS path."""
    oracle = shell_oracle(key)
    x = info["programs"]["solve"](t0)
    C, JE = info["shell"].energy_estimate(info["state"], x, t0,
                                          info["consts"]["force"])
    JE_jax, J_jax = float(oracle[f"{key}_JE"]), float(oracle[f"{key}_J"])
    gate = SHELL_GATES[key]
    rE = abs(JE - JE_jax) / abs(JE_jax)
    o = shell_oracle(SHELL_PAIRS[key])
    J2, g0, g2 = (float(o[f"{SHELL_PAIRS[key]}_J"]), o[f"{key}_grad"],
                  o[f"{SHELL_PAIRS[key]}_grad"])
    print(f"  energy estimate J_E {JE!r}, JAX {JE_jax!r}, rel {rE:.3e} (tol "
          f"{gate['JE']:.0e}); first-order errors |J - J_E| / J_E: card "
          f"{abs(C - JE) / abs(JE):.3e}, JAX "
          f"{abs(J_jax - JE_jax) / abs(JE_jax):.3e}; the JAX package's own "
          f"{key} vs {SHELL_PAIRS[key]}: J {abs(J_jax - J2) / abs(J_jax):.3e}"
          f", gradient {np.linalg.norm(g0 - g2) / np.linalg.norm(g0):.3e}")
    if not rE <= gate["JE"]:
        raise AssertionError(f"shell {key}: the energy estimate differs "
                             "from the JAX package's")
    return gate["J"], gate["grad"]


def shell_operator_parity(info, t0):
    """The composite residual at the oracle's random state (no solve)
    against the JAX package's at (24, 400): max abs over max abs, 1e-12."""
    oracle = shell_oracle("full_residual")
    c = SHELL_RESIDUAL
    x = torch.as_tensor(c["scale"] * np.random.default_rng(
        c["seed"]).standard_normal(info["n_dofs"]), device=DEVICE)
    with torch.no_grad():
        r = info["state"].residual(x, {"thickness": t0,
                                       "force": info["consts"]["force"]})
    want = oracle["full_residual_r"]
    err = float(np.abs(r.cpu().numpy() - want).max() / np.abs(want).max())
    print(f"  residual at a random state vs JAX: {err:.3e} (tol 1e-12)")
    if not err <= 1e-12:
        raise AssertionError("the shell operator differs from the JAX one")
    return err


def shell_counted(label, fn):
    """fn() with the K1/K2 counts reset just before and read just after,
    the shell step's layers counted (the step profiler's shell ranges):
    (seconds, fn's result, launches, calls)."""
    reset(bt_sweeps.launches)
    with layer_ranges(SHELL_LAYERS) as lr:
        t, out = synced(fn)
    launches = dict(bt_sweeps.launches)
    print(f"  {label}: {t:.3f} s; K1 {launches['K1']}, K2 "
          f"{launches['K2']} launches; {lr.calls['bt.factor']} factors, "
          f"{lr.calls['composite.jacobian']} Jacobian assemblies, "
          f"{lr.calls['bt.fill']} fills, {lr.calls['bt.solve']} block "
          "solves")
    return t, out, launches, dict(lr.calls)


def check_shell_factor(info, t0, store, label, err, seed):
    """K1/K2 against plain on the step's factor (the shell's operator at
    t0 through the step's template, factored with the step's storage
    option `store`), with the bar of 10x the plain solve's spread under
    reordered sums and the step residuals at 1e-12; returns (factor,
    right-hand side)."""
    x = torch.zeros(info["n_dofs"], dtype=torch.float64, device=DEVICE)
    blocks = info["state"].jacobian_blocks(
        x, {"thickness": t0, "force": info["consts"]["force"]})
    with torch.no_grad():
        fac = info["bt_tpl"].matrix(blocks).factor(store, spd=True)
    nb, B = fac.Sinv.shape[:2]
    bb = torch.as_tensor(np.random.default_rng(seed).standard_normal(
        (nb, B)), dtype=torch.float64, device=DEVICE)
    check_sweeps(fac, bb, f"{label} factor nb={nb} B={B}", err, spread=True)
    return fac, bb


def phase_shell(err):
    """The W6 compliance step at (24, 400) (19,200 cells, 147,822 dofs,
    nb=289 blocks of B=512) in f64 on the card, configurations a (f64
    storage, pcg_iters=2) and b (f32 storage, pcg_iters=4): the first
    step with its K1/K2 launches and layers counted, the median of 5 warm
    steps, the peak device memory, the residual against the JAX
    package's (a), compliance and gradient against the oracle
    (shell_gates); K1/K2 against plain on each configuration's own factor
    (timed on a's); the determinism of the residual, the fill and the
    step (a); the card against CPU tensors at (6, 8) in both
    configurations."""
    out, shapes = {}, []
    for key in ("a", "b"):
        c = SHELL_CONFIGS[key]
        oracle = shell_oracle(key)
        pcg = c["pcg_iters"]
        torch.cuda.reset_peak_memory_stats()
        t_build, (step, t0, info) = synced(
            lambda: build_shell_jit_step(device=DEVICE, **shell_kwargs(c)))
        tpl = info["bt_tpl"]
        print(f"shell {key} {c}: {info['n_cells']} cells, {info['n_dofs']} "
              f"dofs, nb={tpl.nb} B={tpl.B} (RCM bandwidth {tpl.bw}); build "
              f"{t_build:.2f} s")
        t_first, (J, g), launches, calls = shell_counted(
            "first step", lambda: step(t0))
        # forward: the solve, PCG's first preconditioning and one per
        # iteration; the adjoint the same, with the forward's factor
        want = 2 * (2 + pcg)
        if launches != {"K1": want, "K2": want} or calls["bt.factor"] != 1:
            raise AssertionError(f"shell {key}: launches {launches}, "
                                 f"{calls['bt.factor']} factors; want "
                                 f"{want} each and 1 factor")
        warm = [synced(lambda: step(t0))[0] for _ in range(5)]
        peak = torch.cuda.max_memory_allocated()
        print(f"  warm steps {[round(w, 4) for w in warm]} s, median "
              f"{statistics.median(warm):.4f} s; peak device memory "
              f"{peak / 2**30:.3f} GiB")
        if key == "a":
            parity = shell_operator_parity(info, t0)
        check_oracle_values(f"shell {key}", J, g, oracle[f"{key}_J"],
                            oracle[f"{key}_grad"],
                            *shell_gates(key, info, t0))
        fac, bb = check_shell_factor(info, t0, c.get("factor_store_dtype"),
                                     f"shell {key}", err,
                                     seed=31 + len(key))
        if key == "a":
            shapes.append(time_sweeps(fac, bb, "shell (24, 400)"))
            det = shell_determinism(step, t0, info, J, g)
        out[key] = dict(build_s=t_build, first_s=t_first, warm_s=warm,
                        warm_median_s=statistics.median(warm),
                        peak_gib=peak / 2**30, J=float(J),
                        launches=launches, factors=calls["bt.factor"],
                        solves=calls["bt.solve"])
        del step, info, fac, bb
        # a's solve op sits in a reference cycle (it holds an
        # autograd.Function class): free it before b's peak is read
        gc.collect()
        torch.cuda.empty_cache()
    out["determinism"] = det
    out["residual_vs_jax"] = parity
    out["card_vs_cpu"] = shell_card_vs_cpu()
    return out, shapes


def shell_determinism(step, t0, info, J, g):
    """Two runs each of the shell residual at a random state, the template
    fill of the Jacobian and the step give the same bits."""
    state, tpl = info["state"], info["bt_tpl"]
    rng = np.random.default_rng(23)
    x = torch.as_tensor(1e-3 * rng.standard_normal(info["n_dofs"]),
                        device=DEVICE)
    inputs = {"thickness": t0, "force": info["consts"]["force"]}
    with torch.no_grad():
        r = [state.residual(x, inputs) for _ in range(2)]
        same_bits("shell residual", *r)
        blocks = state.jacobian_blocks(x, inputs)
        fills = [torch.stack(tpl.fill(blocks)) for _ in range(2)]
        same_bits("shell template fill (3, nb, B, B)", *fills)
    J2, g2 = step(t0)
    same_bits("shell step compliance", J, J2)
    same_bits("shell step gradient", g, g2)
    return True


def shell_card_vs_cpu():
    """Configurations a and b at (6, 8) on the card and on CPU tensors:
    within 10x the JAX package's own spread between its step paths of
    the same kind (the conditioning lets two correct solves differ by
    that much)."""
    oracle = shell_oracle("a")
    res = {}
    for key in ("a", "b"):
        kw = dict(shell_kwargs(SHELL_CONFIGS[key]), n_shell=SHELL_SMALL)
        vals = {}
        for dev in (DEVICE, "cpu"):
            step, t0, _ = build_shell_jit_step(device=dev, **kw)
            vals[dev] = [v.cpu().numpy() for v in step(t0)]
        sJ, sg = step_spread(oracle, path_kind(SHELL_CONFIGS[key]))
        (Jc, gc), (Jh, gh) = vals[DEVICE], vals["cpu"]
        rJ = abs(float(Jc) - float(Jh)) / abs(float(Jh))
        rg = float(np.linalg.norm(gc - gh) / np.linalg.norm(gh))
        print(f"  shell {key} at {SHELL_SMALL}, card vs CPU tensors: J rel "
              f"{rJ:.3e} (bar {10 * sJ:.3e}), gradient rel L2 {rg:.3e} "
              f"(bar {10 * sg:.3e}; 10x the JAX package's own spread "
              "between its step paths of this kind)")
        if not (rJ <= 10 * sJ and rg <= 10 * sg):
            raise AssertionError(f"shell {key}: card and CPU differ")
        res[key] = dict(J_rel=rJ, grad_rel=rg)
    return res


def rayleigh_hz(shell, state, m, phi):
    """The Rayleigh quotient of phi as a frequency: phi^T K phi = 2 E(phi)
    from the strain energy (a sum of squares), over phi^T M phi; second
    order in phi's error."""
    parts = state.split(phi)
    with torch.no_grad():
        E = compile_form(shell.energy_form).scalar(
            {"u": parts["u"], "theta": parts["theta"],
             "thickness": shell.thickness.array,
             "force": shell.force.array})
    return float(torch.sqrt(2 * E / torch.sum(m * phi * phi))) / (2 * np.pi)


def phase_shell_modal():
    """shell_modal_analysis(n_modes=6, method="lanczos") on the (24, 400)
    plate: 40 iterations, each one K1 + one K2 launch (counts reset just
    before, read just after), frequencies against the oracle where the
    JAX run converged them: the modes' Rayleigh quotients from their
    strain energy (second order in the modes' error) within MODAL_RQ_GATE
    of the JAX package's, and the Lanczos values within MODAL_GATES (both
    packages' first-order errors |f - f_RQ| / f_RQ printed beside them);
    the modes finite."""
    c = SHELL_CONFIGS["modal"]
    oracle = shell_oracle("modal")
    shell, bcs = plate_shell(tuple(c["n_shell"]), device=DEVICE)
    t, (freqs, modes), launches, calls = shell_counted(
        "lanczos", lambda: shell_modal_analysis(
            shell, bcs, n_modes=c["n_modes"], method=c["method"],
            lanczos_iters=c["lanczos_iters"], seed=c["seed"]))
    want = c["lanczos_iters"]
    if launches != {"K1": want, "K2": want} or calls["bt.factor"] != 1:
        raise AssertionError(f"modal: launches {launches}, "
                             f"{calls['bt.factor']} factors")
    f = freqs.cpu().numpy()
    conv = oracle["modal_converged"]
    r = np.abs(f - oracle["modal_freqs"]) / oracle["modal_freqs"]
    state, _, m = modal_operators(shell, bcs)
    rq = np.asarray([rayleigh_hz(shell, state, m, modes[:, j])
                     for j in range(len(f))])
    rq_jax = oracle["modal_freqs_rq"]
    r_rq = np.abs(rq - rq_jax) / rq_jax
    print(f"  Rayleigh quotients {list(rq)} Hz; JAX {list(rq_jax)}; rel "
          f"{list(r_rq)} (tol {MODAL_RQ_GATE:.0e})")
    if not np.all(r_rq[conv] <= MODAL_RQ_GATE):
        raise AssertionError("Rayleigh quotients disagree with the oracle")
    bars = np.asarray(MODAL_GATES)
    print(f"  frequencies {list(f)} Hz; JAX {list(oracle['modal_freqs'])}; "
          f"rel {list(r)}; bars {list(bars)} (where JAX converged: "
          f"{list(conv)}); first-order errors |f - f_RQ| / f_RQ: card "
          f"{list(np.abs(f - rq) / rq)}, JAX "
          f"{list(np.abs(oracle['modal_freqs'] - rq_jax) / rq_jax)}")
    if not (conv.any() and np.all(r[conv] <= bars[conv])):
        raise AssertionError("modal frequencies disagree with the oracle")
    if not (modes.shape == (shell.Vu.n_dofs + shell.Vth.n_dofs, 6)
            and bool(torch.isfinite(modes).all())):
        raise AssertionError("modes are not finite")
    return dict(seconds=t, launches=launches, freqs=[float(v) for v in f])


def phase_shell_module(err):
    """ShellModule on the (16, 24) plate through the graph API: run, then
    objective_gradient of compliance and of the p-norm stress with
    respect to thickness, K1/K2 counted (1 solve for run, 1 + 1 adjoint
    for each gradient); each output and gradient against the oracle
    within 10x the JAX package's own spread between its jit_bt and
    jit_dense modules for that output, at least 1e-12 (module_bars); then K1/K2 against plain on the (16, 24) compliance step's
    factors in both storage options."""
    c = SHELL_CONFIGS["module"]
    oracle = shell_oracle("module")
    mod, F = plate_module(**shell_kwargs(c), device=DEVICE)
    sim = Simulator(mod)
    sim["nodal_forces"] = F

    def path():
        out = dict(sim.run())
        return out, {of: sim.objective_gradient(of, ["thickness"])
                     for of in ("compliance", "pnorm_stress")}

    t, (out, grads), launches, _ = shell_counted(
        "run + 2 objective_gradient", path)
    if launches != {"K1": 5, "K2": 5}:
        raise AssertionError(f"module: launches {launches}, want 5 each")
    got = {k: out[k] for k in SHELL_MODULE_OUTPUTS}
    for of, (val, g, _) in grads.items():
        got[f"{of}_value"], got[f"{of}_grad"] = val, g["thickness"]
    bars = module_bars(oracle, "module", got)
    worst, bad = 0.0, []
    for k, v in got.items():
        want = oracle[f"module_{k}"]
        r = float(np.linalg.norm(v.detach().cpu().numpy().reshape(
            want.shape) - want) / np.linalg.norm(want))
        worst = max(worst, r)
        print(f"  {k}: rel L2 {r:.3e} (bar {bars[k]:.3e})")
        if not r <= bars[k]:
            bad.append(k)
    if bad:
        raise AssertionError(f"ShellModule disagrees with the oracle: {bad}")
    for store in (None, "float32"):
        step, t0, info = build_shell_jit_step(
            n_shell=tuple(c["n_shell"]), split_programs=True, pcg_iters=2,
            factor_store_dtype=store, device=DEVICE)
        check_shell_factor(info, t0, store, f"shell (16, 24) store {store}",
                           err, seed=41)
    return dict(seconds=t, launches=launches, worst_rel=worst)


FSI_ORACLE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "oracles", "fsi_oracle.npz")
# the JAX package's anchor solver (bench_scale.py:373-381, SCALE.json's
# 107,520-cell row): 4 passes a round, f32 factor storage, every inner
# solve PCG to 1e-7 (at most 10 iterations), 5 rounds, 24 adjoint passes
FSI_SOLVER = dict(gs_inner=4, factor_store_dtype="float32", pcg_rtol=1e-7,
                  pcg_maxiter=10, rounds=5)
FSI_CONFIGS = {
    # the reference's eVTOL wing class (run_aeroelasticity_static_w_
    # feedback.py:55): 107,520 cells, 927,402 dofs, nb=7246, B=128
    "anchor": dict(n_shell=[4, 13440], n_vlm=[4, 32], span=30.0,
                   thickness=0.05, **FSI_SOLVER),
    # the same wing at half the anchor's spanwise resolution (53,760
    # cells), and at an eighth (13,440 cells, chunked as the anchor is),
    # against the JAX package's values (oracles/fsi_oracle.py)
    "mid": dict(n_shell=[4, 6720], n_vlm=[4, 32], span=30.0,
                thickness=0.05, **FSI_SOLVER),
    "rung": dict(n_shell=[4, 1680], n_vlm=[4, 32], span=30.0,
                 thickness=0.05, assembly_chunk=4096, **FSI_SOLVER),
    # bench_scale.py's small rung
    "small": dict(n_shell=[16, 24], n_vlm=[4, 8], span=4.0, thickness=0.01,
                  **FSI_SOLVER),
}
# the JAX package's other paths beside a rung: their distance is its own
# spread there
FSI_PAIRS = {"mid": ("mid_f64",), "rung": ("rung_f64", "rung_mixed"),
             "small": ("small_f64", "small_mixed")}
FSI_SMALL_CPU = dict(n_shell=[4, 6], n_vlm=[2, 4], span=4.0, chord=1.0,
                     gs_inner=4, relax=0.7, adj_passes=12, rounds=3,
                     factor_store_dtype="float32", pcg_rtol=1e-7,
                     pcg_maxiter=10)  # the CPU tests' "rtol" path
# Fixed bars (no bar is computed from the run it judges), set from the
# readings of this wing's first card runs (PERF.md §6; H100 80GB HBM3,
# 700 W).  The wing's shell operator (span 30, chord 1, thickness 0.05,
# elements 0.25 x 0.0022 at the anchor) is so ill-conditioned that its
# f64 residuals stall at ~1e-2 at the anchor and ~3e-3 at (4, 6720)
# (tools/fsi_conditioning.py), and a relative 1e-15 perturbation of
# every assembled element-matrix entry moves the converged tip by
# 0.71-0.78e-2 and 0.84-1.29e-3 there (2e-6 at (4, 420)).
#   conservation: |total mapped - total aero| / |total aero|;
#   anchor_solve: the anchor's tip against the exact solution of its own
#     last linear system (banded LU with partial pivoting, refined with
#     longdouble residuals: tools/fsi_conditioning.py's direct_witness),
#     relative: read 4.0e-4 (the unrefined pivoted LU 2.8e-3, the solve
#     with the factor stored in f64 1.4e-3);
#   anchor_f64: the anchor with f64 factor storage against the JAX
#     package's anchor entry, tip and objective (relative) 2e-2, just above
#     the 1.6e-2 spread of the exact first-pass tips of one operator summed
#     from the port's card and CPU element blocks; gradient (relative L2)
#     4e-2, twice that, as at (4, 6720) (1.65e-3 against 9.1e-4);
#   mid: the (4, 6720) tip and objective against the JAX package's, f32
#     factor storage (relative; read 1.1e-3); its gradient is not gated:
#     with the f32-stored factor ten PCG iterations leave the solution a
#     true residual far above ||b|| in the stiff modes, and the JAX
#     package's own f32- and f64-storage gradients differ by 2.2
#     (relative L2);
#   mid_f64, rung_f64: the same wing with f64 factor storage against the
#     JAX package's f64-stored entries, tip and objective (relative) and
#     gradient (relative L2): read 9.1e-4 and 1.7e-3 at (4, 6720) (the
#     port's and the JAX package's element matrices, equal to rounding,
#     give exact first-pass tips 1.9e-3 apart there), 5.1e-6 and 1.9e-5
#     at (4, 1680);
#   rung, small: 10x the JAX package's own spread between its paths
#     (FSI_PAIRS), at least 1e-12 (tools/shell_parity.py's rule);
#   residual: the (4, 1680) composite residual at a random state against
#     the JAX package's, max abs over max abs;
#   anchor_cr: the anchor with block cyclic reduction (f64 storage)
#     against the port's Thomas run with f64 storage on the same card,
#     tip and objective (relative), set before the first CR run: both
#     solve the same assembled operator;
#   anchor_cr_solve: the CR anchor's tip against the exact solution of its
#     own last system.  It was to be held at anchor_solve's 1e-3 and read
#     1.398e-3 on its first card run: with f64 factor storage pcg_tol
#     stops at its 10 iterations with an f64 residual near 1e-2 (9.4e-3
#     here), as the Thomas f64-storage run does, whose tip reads 1.4e-3
#     from its exact solution (1e-3 holds the f32-storage run, 4.0e-4).
#     The gate holds the same quantity to what f64 allows on this system:
#     no farther from the exact tip than LAPACK's pivoted banded LU of the
#     same system before refinement, a backward-stable f64 direct solve
#     (read 2.783e-3 there).
FSI_GATES = dict(conservation=1e-13, anchor_solve=1e-3,
                 anchor_f64=dict(tip=2e-2, objective=2e-2, grad=4e-2),
                 mid=dict(tip=5e-3, objective=5e-3),
                 mid_f64=dict(tip=2.5e-3, objective=2.5e-3, grad=5e-3),
                 rung_f64=dict(tip=1.5e-5, objective=1.5e-5, grad=6e-5),
                 residual=1e-12, anchor_cr=1e-3)
# the anchor's Thomas and CR runs are one call each, their stages timed
# on it: the warm repeats and their equal-bits checks are depth cut to
# keep the script in its time (PERF.md §6); the W8 rung's pair of calls
# holds the bits of the same FSI solve path


def fsi_config(key):
    """The configuration of oracle entry `key` as driven here: an
    FSI_CONFIGS entry, one with f64 factor storage ("_f64") or the JAX
    package's mixed inverses ("_mixed"), either with block cyclic
    reduction ("_cr_f64"), or the CPU tests' path."""
    base, _, kind = key.partition("_")
    cr = kind.startswith("cr_")
    kind = kind[3:] if cr else kind
    if key.startswith("jit_rtol"):
        c, kind = dict(FSI_SMALL_CPU), key[len("jit_rtol_"):]
    elif key == "rung_residual":
        c = {k: v for k, v in FSI_CONFIGS["rung"].items()
             if k not in FSI_SOLVER}
        return dict(c, seed=3, scale=1e-3)
    else:
        c = dict(FSI_CONFIGS[base])
    if kind == "f64":
        c["factor_store_dtype"] = None
    elif kind == "mixed":
        c["factor_compute_dtype"] = "mixed"
    if cr:
        c["factor_method"] = "cr"
    return c


def fsi_oracle(key):
    """The FSI oracle's entry `key` (its values without the key prefix),
    after checking that it was computed for fsi_config(key)."""
    oracle = np.load(FSI_ORACLE)
    cfg = fsi_config(key)
    got = json.loads(str(oracle[f"{key}_config"]))
    if got != json.loads(json.dumps(cfg)):
        raise AssertionError(f"fsi oracle entry {key} is for {got}, not "
                             f"{cfg}")
    return {k[len(key) + 1:]: oracle[k] for k in oracle.files
            if k.startswith(f"{key}_") and not k.endswith("_config")}


def fsi_build(c, device=None, template=None):
    return build_fsi_jit_step(device=device or DEVICE, template=template,
                              **shell_kwargs({k: v for k, v in c.items()
                                              if k != "rounds"}))


def conservation(out):
    a, m = out["total_aero_force"], out["total_mapped_force"]
    return float(torch.linalg.norm(m - a) / torch.linalg.norm(a))


def fsi_counted(label, f, rounds, sync=False):
    """f's solve_with_grad with K1/K2/K4T and the solver's counts reset
    just before and read just after, the stages counted by the step
    profiler's FSI ranges (and timed, synced, with sync=True): (seconds,
    outputs, launches, stats, calls, stage seconds).
    K1 and K2 must each launch once per inner solve and once per
    preconditioner application of its PCG polish (with block Thomas; with
    cyclic reduction, whose solves are batched torch calls, never); K4T
    once per adjoint pass and block of the force-load operator Fm."""
    reset(bt_sweeps.launches)
    reset(spmv.launches)
    f["stats"].update(solves=0, precond=0, pcg_iters=[])
    with layer_ranges(FSI_LAYERS, sync=sync) as lr:
        t, out = synced(lambda: f["solve_with_grad"](f["t0"], rounds=rounds))
    launches = {**bt_sweeps.launches, "K4T": spmv.launches["K4T"]}
    stats = dict(f["stats"])
    its = stats.pop("pcg_iters")
    stats["pcg_iters_hist"] = np.bincount(its).tolist() if its else []
    sweeps = (0 if f["step"].bt.method == "cr"
              else stats["solves"] + stats["precond"])
    fm_blocks = len(f["step"].fm().blocks)
    want = {"K1": sweeps, "K2": sweeps,
            "K4T": f["step"].adj_passes * fm_blocks}
    print(f"  {label}: {t:.3f} s; K1 {launches['K1']}, K2 "
          f"{launches['K2']}, K4T {launches['K4T']} launches (want "
          f"{want}: {stats['solves']} solves + {stats['precond']} "
          f"preconditioner applications of pcg_tol, whose iteration counts "
          f"0.. are {stats['pcg_iters_hist']}; {f['step'].adj_passes} "
          f"adjoint passes x {fm_blocks} Fm block); {lr.calls['fsi.fill']} "
          f"fill, {lr.calls['fsi.factor_core']} factor, "
          f"{lr.calls['fsi.vlm']} VLM solves, {lr.calls['fsi.rhs']} "
          f"right-hand sides")
    if launches != want or launches["K4T"] == 0 or stats["solves"] == 0:
        raise AssertionError(f"{label}: launches {launches}, want {want}")
    stages = {k: lr.seconds[f"fsi.{k}"]
              for k in ("fill", "factor_core", "gs", "finalize", "adjoint")}
    return t, out, launches, stats, dict(lr.calls), stages


def fsi_outputs(out):
    return dict(tip=float(out["tip_disp"]), objective=float(out["objective"]),
                compliance=float(out["compliance"]),
                rel_delta=float(out["rel_delta"]),
                adj_delta=float(out["adj_delta"]),
                conservation=conservation(out))


def fsi_against(label, out, want, bars):
    """out's tip, objective and gradient against the JAX values `want`
    (relative; the gradient in L2), each at its bar where `bars` has one;
    returns the readings."""
    got = {"tip": float(out["tip_disp"]),
           "objective": float(out["objective"]),
           "grad": out["grad_thickness"].cpu().numpy()}
    r = {k: float(np.linalg.norm(np.asarray(got[k]) - want[k])
                  / np.linalg.norm(want[k])) for k in got}
    bar = {k: (f"bar {bars[k]:.1e}" if k in bars else "not gated")
           for k in got}
    print(f"  {label} vs the JAX package: tip {got['tip']!r} (JAX "
          f"{float(want['tip'])!r}) rel {r['tip']:.3e} ({bar['tip']}); "
          f"objective rel {r['objective']:.3e} ({bar['objective']}); "
          f"gradient ({got['grad'].size} values) rel L2 {r['grad']:.3e} "
          f"({bar['grad']})")
    if not all(r[k] <= bars[k] for k in bars):
        raise AssertionError(f"{label} disagrees with the JAX package: {r}")
    return r


def jax_spread(key):
    """The JAX package's own spread between `key` and its FSI_PAIRS paths:
    the largest relative distance of each value between two of them."""
    paths = [fsi_oracle(k) for k in (key,) + FSI_PAIRS[key]]
    return {k: max(float(np.linalg.norm(np.asarray(a[k]) - b[k])
                         / np.linalg.norm(b[k]))
                   for a in paths for b in paths)
            for k in ("tip", "objective", "grad")}


def spread_bars(key):
    """10x jax_spread(key), at least 10 ROUNDING."""
    return {k: 10 * max(ROUNDING, v) for k, v in jax_spread(key).items()}


def fsi_vs_jax(key, bars):
    """The configuration of oracle entry `key` (fsi_config) on the card,
    its launches counted, against the JAX package's values at `bars`,
    with the JAX package's own spread there (FSI_PAIRS); force
    conservation."""
    c = fsi_config(key)
    want = fsi_oracle(key)
    t_build, f = synced(lambda: fsi_build(c))
    print(f"fsi {key} {c}: {f['n_cells']} cells, {f['n_dofs']} dofs, "
          f"nb={f['tpl'].nb}; build {t_build:.2f} s")
    t, out, launches, stats, _, _ = fsi_counted("solve_with_grad", f,
                                                 c["rounds"])
    r = fsi_outputs(out)
    print(f"  conservation {r['conservation']:.3e}; rel_delta "
          f"{r['rel_delta']:.3e} (JAX {float(want['rel_delta']):.3e}), "
          f"adj_delta {r['adj_delta']:.3e} (JAX "
          f"{float(want['adj_delta']):.3e})")
    r["vs_jax"] = fsi_against(f"fsi {key}", out, want, bars)
    if key in FSI_PAIRS:
        r["jax_spread"] = jax_spread(key)
        print(f"  the JAX package's own spread between "
              f"{(key,) + FSI_PAIRS[key]}: "
              f"{ {k: f'{v:.3e}' for k, v in r['jax_spread'].items()} }")
    if not r["conservation"] <= FSI_GATES["conservation"]:
        raise AssertionError(f"fsi {key}: forces not conserved")
    r.update(build_s=t_build, seconds=t, launches=launches, stats=stats)
    return r, f


def fsi_residual_parity(f):
    """The (4, 1680) composite residual at the oracle's random state and
    force against the JAX package's: max abs over max abs."""
    c = fsi_config("rung_residual")
    want = fsi_oracle("rung_residual")["r"]
    rng = np.random.default_rng(c["seed"])
    x = torch.as_tensor(c["scale"] * rng.standard_normal(f["n_dofs"]),
                        device=DEVICE)
    force = torch.as_tensor(rng.standard_normal(f["shell"].Vf.n_dofs),
                            device=DEVICE)
    with torch.no_grad():
        r = f["residual"](x, {"thickness": f["t0"], "force": force})
    err = float(np.abs(r.cpu().numpy() - want).max() / np.abs(want).max())
    print(f"  (4, 1680) residual at a random state vs JAX (chunks of "
          f"{f['assembly_chunk']}): {err:.3e} (tol "
          f"{FSI_GATES['residual']:.0e})")
    if not err <= FSI_GATES["residual"]:
        raise AssertionError("the FSI shell operator differs from JAX's")
    return err


def check_fsi_kernels(f, err, last):
    """After the counted runs, on the anchor's own data: the tip of the
    run `last` against the exact solution of its last system
    (fsi_solve_witness); K1/K2 against
    plain on its factor (f32 storage, as the run's) at 10x the plain
    solve's spread under reordered sums, step residuals 1e-12, and timed
    at (7246, 128); K4/K4T against plain on Fm in both designs
    (check_element_matrices), and timed beside torch.sparse.mm on its CSR
    and on the transposed CSR (time_element)."""
    carry = f["factor"](f["t0"])
    mat, fac = f["step"].bt.unpack(carry)
    witness = fsi_solve_witness(f, mat, last)
    nb, B = fac.Sinv.shape[:2]
    bb = torch.as_tensor(np.random.default_rng(47).standard_normal((nb, B)),
                         dtype=torch.float64, device=DEVICE)
    check_sweeps(fac, bb, f"fsi anchor factor nb={nb} B={B}", err,
                 spread=True)
    t_sweeps = time_sweeps(fac, bb, "fsi anchor", plain_reps=3,
                           profile=False)
    del carry, mat, fac
    Fm = f["step"].fm()
    k4_err = check_element_matrices("fsi anchor Fm", [Fm])
    t_fm = time_element("fsi anchor Fm (u test dofs x force dofs)", Fm, 48)
    return t_sweeps, t_fm, k4_err, witness


def fsi_solve_witness(f, mat, last, lu_bar=False):
    """The anchor's tip against the exact solution of its own last linear
    system (finalize's right-hand side at the converged lattice
    `last["disp_fluid"]`, on the operator `mat`), computed independently
    of the block-Thomas factor, its sweeps and the PCG polish: LAPACK's
    banded LU with partial pivoting on the host, refined with longdouble
    residuals (tools/fsi_conditioning.py's direct_witness).  The bar is
    FSI_GATES' anchor_solve or, with lu_bar, the distance of the unrefined
    pivoted LU's tip from the exact one: what a backward-stable f64
    direct solve of the same system reaches (FSI_GATES' anchor_cr_solve
    says why)."""
    st = f["step"]
    with torch.no_grad():
        _, trac = st.traction(last["disp_fluid"])
        _, b = st._rhs(f["t0"], trac.reshape(-1))
    t, w = synced(lambda: direct_witness(mat, f["tpl"].bw, b, last["x"],
                                         3 * st.tip_idx + 2, steps=3))
    exact, tip = w["lu_tips"][-1], float(last["tip_disp"])
    w["rel"] = abs(tip - exact) / abs(exact)
    w["unrefined_rel"] = abs(w["lu_tips"][0] - exact) / abs(exact)
    w["bar"] = w["unrefined_rel"] if lu_bar else FSI_GATES["anchor_solve"]
    print(f"  anchor tip {tip!r} vs the exact solution of its last system "
          f"{exact!r} (banded LU, kl={w['kl']}, {w['factor_s']:.1f} s, "
          f"refined with longdouble residuals "
          f"{[f'{v:.2e}' for v in w['lu_relres_ld']]}; {t:.1f} s in all): "
          f"rel {w['rel']:.3e} (bar {w['bar']:.3e}"
          f"{', the unrefined LU' if lu_bar else ''}); the "
          f"unrefined LU rel {w['unrefined_rel']:.3e}; the run's solution's "
          f"residual longdouble {w['port_relres_ld']:.3e}, f64 "
          f"{w['port_relres_f64']:.3e}")
    if w["port_tip"] != tip:
        raise AssertionError("the witness's system is not the run's last")
    if not w["rel"] <= w["bar"]:
        raise AssertionError("fsi anchor: the tip disagrees with the "
                             "exact solution of its own last system")
    return w


def fsi_anchor_f64(f, rounds):
    """The anchor with its factor stored in f64, against the JAX package's
    anchor entry (oracles/fsi_oracle.npz `anchor_f64`): f's build reused,
    its factor storage set to f64 (build_fsi_jit_step(factor_store_dtype=
    None) differs from f32 storage there alone); one solve_with_grad with
    its launches counted; tip, objective and gradient at FSI_GATES'
    anchor_f64 bars; force conservation."""
    want = fsi_oracle("anchor_f64")
    f["step"].bt.store = fsi_config("anchor_f64")["factor_store_dtype"]
    t, out, launches, stats, _, _ = fsi_counted(
        "f64-storage solve_with_grad", f, rounds)
    r = fsi_outputs(out)
    print(f"  f64 storage: conservation {r['conservation']:.3e}; rel_delta "
          f"{r['rel_delta']:.3e} (JAX {float(want['rel_delta']):.3e}), "
          f"adj_delta {r['adj_delta']:.3e} (JAX "
          f"{float(want['adj_delta']):.3e})")
    r["vs_jax"] = fsi_against("fsi anchor_f64", out, want,
                              FSI_GATES["anchor_f64"])
    if not r["conservation"] <= FSI_GATES["conservation"]:
        raise AssertionError("fsi anchor_f64: forces not conserved")
    r.update(seconds=t, launches=launches, stats=stats)
    return r


def f32_factor_sweeps(f, bt, label, seed):
    """The equilibrated f32 factor of f's operator, made by f's factor
    programs `bt` switched to factor_compute_dtype="float32" (the guarded f32
    Thomas recursion on S A S, stored in f32): its factor-core seconds and
    rescued blocks; K1/K2 in f32 against plain on it (Sinv, the scaled L,
    C) at SWEEP_TOL f32, or 10x the plain solve's spread under reordered
    sums where that is larger (step residuals SWEEP_TOL either way), two
    launches bit for bit, and timed (time_sweeps).  These launches count
    for no path."""
    was = bt.method, bt.compute
    bt.method, bt.compute = "thomas", "float32"
    D, L, U = f["fill"](f["t0"])
    t_core, core = synced(lambda: f["factor_core"](D, L, U))
    mat, fac = bt.unpack((D, L, U) + tuple(core))
    bt.method, bt.compute = was
    rescued = int(bt.rescued)
    print(f"  {label}: the f32 factor core {t_core:.3f} s, {rescued} "
          f"block(s) rescued by the guard")
    view = BlockThomasFactor(mat._like(D, fac.Lfac, U), fac.Sinv, fac.C)
    nb, B = fac.Sinv.shape[:2]
    bb = torch.as_tensor(np.random.default_rng(seed).standard_normal(
        (nb, B)), dtype=torch.float32, device=DEVICE)
    err32 = {"K1": 0.0, "K2": 0.0}
    check_sweeps(view, bb, f"{label} f32 factor nb={nb} B={B} float32",
                 err32, spread=True)
    t = time_sweeps(view, bb, f"{label} (f32 factor)", plain_reps=3,
                    profile=False)
    t["max_abs_err"] = err32
    return t, dict(factor_core_s=t_core, rescued=rescued)


def fsi_anchor_cr(tpl, thomas, t_sweeps):
    """The anchor in its f64-storage configuration with block cyclic
    reduction (fsi_config("anchor_cr_f64")), built on the anchor's
    template `tpl`: one solve_with_grad with its launches counted (K4T as
    with Thomas, no K1/K2) and its stages timed, peak device memory; force
    conservation (1e-13); the tip against the exact solution of its own
    last system (fsi_solve_witness, at the unrefined LU's distance:
    FSI_GATES' anchor_cr_solve); tip and objective against the
    port's Thomas run with f64 factor storage on this card (`thomas`,
    FSI_GATES' anchor_cr); the distance to the JAX package's anchor_f64
    entry, printed and not gated (f64 fixes the anchor's tip only to
    ~2e-2); the CR factor and solve beside Thomas's (cr_times; Thomas's
    sweeps `t_sweeps`); then the anchor operator's f32 factor and K1/K2
    in f32 on it (f32_factor_sweeps)."""
    c = fsi_config("anchor_cr_f64")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_build, f = synced(lambda: fsi_build(c, template=tpl))
    print(f"fsi anchor_cr_f64 {c}: build on the anchor's template "
          f"{t_build:.2f} s")
    t_first, out, launches, stats, calls, stages = fsi_counted(
        "cr solve_with_grad", f, c["rounds"], sync=True)
    peak = torch.cuda.max_memory_allocated() / 2**30
    r = fsi_outputs(out)
    print(f"  cr: solve_with_grad {t_first:.3f} s; stages (synced) "
          f"{({k: round(v, 3) for k, v in stages.items()})} s; "
          f"peak device memory {peak:.3f} GiB; conservation "
          f"{r['conservation']:.3e}; rel_delta {r['rel_delta']:.3e}, "
          f"adj_delta {r['adj_delta']:.3e}")
    if not r["conservation"] <= FSI_GATES["conservation"]:
        raise AssertionError("fsi anchor cr: forces not conserved")
    last = {k: out[k] for k in ("disp_fluid", "x", "tip_disp")}
    D, L, U = f["fill"](f["t0"])
    mat = f["step"].bt.matrix(D, L, U)
    witness = fsi_solve_witness(f, mat, last, lu_bar=True)
    vs = {k: abs(r[k] - thomas[k]) / abs(thomas[k])
          for k in ("tip", "objective")}
    bar = FSI_GATES["anchor_cr"]
    print(f"  cr vs the port's Thomas f64-storage anchor on this card: tip "
          f"{r['tip']!r} vs {thomas['tip']!r} rel {vs['tip']:.3e}, "
          f"objective rel {vs['objective']:.3e} (bar {bar:.0e})")
    if not max(vs.values()) <= bar:
        raise AssertionError(f"fsi anchor cr differs from Thomas: {vs}")
    r["vs_jax"] = fsi_against("fsi anchor_cr_f64 (not gated)", out,
                              fsi_oracle("anchor_f64"), {})
    times = cr_times(mat, "anchor operator", reps=2)
    pair = t_sweeps["K1"] + t_sweeps["K2"]
    print(f"  Thomas on this card: sweeps K1 + K2 {pair:.4f} ms a solve "
          f"(events), solve_with_grad "
          f"{thomas['first_s']:.3f} s, factor core "
          f"{thomas['stages_s']['factor_core']:.3f} s, peak "
          f"{thomas['peak_gib']:.3f} GiB")
    del mat, out
    t32, f32 = f32_factor_sweeps(f, f["step"].bt, "fsi anchor operator",
                                 59)
    r.update(build_s=t_build, first_s=t_first,
             stages_s=stages, peak_gib=peak, launches=launches, stats=stats,
             calls=calls, witness=witness, vs_thomas=vs, times=times,
             f32=f32)
    return r, t32


def phase_fsi(err):
    """The W7 anchor, build_fsi_jit_step(n_shell=(4, 13440), n_vlm=(4,
    32), span=30, thickness=0.05) in the JAX package's anchor solver
    (FSI_SOLVER), f64, on the card: the build (the host template), the
    first solve_with_grad with its launches and stages counted
    (fsi_counted, its stage seconds synced), peak device memory,
    force conservation; then on the anchor's own factor, operator and Fm the
    tip against the exact solution of its last system and the kernels
    against plain (check_fsi_kernels); the anchor with f64 factor storage
    against the JAX package's anchor entry (fsi_anchor_f64); the anchor
    with block cyclic reduction on its template, and K1/K2 in f32 on the
    anchor operator's f32 factor (fsi_anchor_cr); then the same wing at
    (4, 6720) and (4, 1680), f32 and f64 factor storage, and at (4, 1680)
    with cyclic reduction (f64 storage, at rung_f64's bars), against the
    JAX package's values (oracles/fsi_oracle.npz) and, at (4, 1680), its
    residual at a random state."""
    c = FSI_CONFIGS["anchor"]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_build, f = synced(lambda: fsi_build(c))
    tpl = f["tpl"]
    print(f"fsi anchor {c}: {f['n_cells']} cells, {f['n_dofs']} dofs, "
          f"{f['n_panels']} panels, nb={tpl.nb} B={tpl.B} (RCM bandwidth "
          f"{tpl.bw}), assembly chunk {f['assembly_chunk']}; build "
          f"{t_build:.2f} s")
    t_first, out, launches, stats, calls, stages = fsi_counted(
        "first solve_with_grad", f, c["rounds"], sync=True)
    first = fsi_outputs(out)
    peak = torch.cuda.max_memory_allocated()
    print(f"  stages (synced) "
          f"{ {k: round(v, 3) for k, v in stages.items()} } s; peak "
          f"device memory {peak / 2**30:.3f} GiB")
    g = out["grad_thickness"]
    print(f"  tip {first['tip']!r} (the JAX package's TPU records: "
          f"17.66-17.69, PERF.md §6); force conservation "
          f"{first['conservation']:.3e} (tol {FSI_GATES['conservation']:.0e})"
          f"; objective {first['objective']!r}, compliance "
          f"{first['compliance']!r}; rel_delta {first['rel_delta']:.3e}, "
          f"adj_delta {first['adj_delta']:.3e}; gradient {tuple(g.shape)}, "
          f"|g| {float(torch.linalg.norm(g))!r}")
    if not first["conservation"] <= FSI_GATES["conservation"]:
        raise AssertionError(f"fsi anchor: forces not conserved: {first}")
    if not (g.shape == (f["n_cells"],) and bool(torch.isfinite(g).all())):
        raise AssertionError("fsi anchor gradient is not finite")
    last = {k: out[k] for k in ("disp_fluid", "x", "tip_disp")}
    del out
    t_sweeps, t_fm, k4_err, witness = check_fsi_kernels(f, err, last)
    res = dict(witness=witness, build_s=t_build, first_s=t_first,
               stages_s=stages,
               peak_gib=peak / 2**30, launches=launches, stats=stats,
               calls=calls, n_cells=f["n_cells"], n_dofs=f["n_dofs"],
               nb=tpl.nb, B=tpl.B, **first)
    res["anchor_f64"] = fsi_anchor_f64(f, c["rounds"])
    del f
    thomas = dict(res["anchor_f64"], first_s=res["first_s"],
                  stages_s=stages, peak_gib=res["peak_gib"])
    res["anchor_cr"], t_f32 = fsi_anchor_cr(tpl, thomas, t_sweeps)
    del tpl
    gc.collect()
    torch.cuda.empty_cache()
    for key in ("mid", "mid_f64", "rung", "rung_f64", "rung_cr_f64"):
        gc.collect()
        torch.cuda.empty_cache()
        res[key], f = fsi_vs_jax(key, FSI_GATES.get(key.replace("_cr", ""))
                                 or spread_bars(key))
        if key == "rung":
            res[key]["residual_vs_jax"] = fsi_residual_parity(f)
        del f
    return res, t_sweeps, t_fm, k4_err, t_f32


def phase_fsi_small():
    """bench_scale.py's small rung (16, 24) / (4, 8) against the JAX
    package's values within 10x its own spread between its f32-stored,
    f64-stored and mixed-inverse factors (shell_parity's rule, at least
    1e-12); the card against CPU tensors at (4, 6) in the CPU tests'
    anchor-solver path, within 10x the JAX package's spread there."""
    r, _ = fsi_vs_jax("small", spread_bars("small"))
    c = FSI_SMALL_CPU
    w = fsi_oracle("jit_rtol")
    p = fsi_oracle("jit_rtol_mixed")
    vals = {}
    for dev in (DEVICE, "cpu"):
        f = fsi_build(c, dev)
        o = f["solve_with_grad"](f["t0"], rounds=c["rounds"])
        vals[dev] = {"tip": float(o["tip_disp"]),
                     "objective": float(o["objective"]),
                     "grad": o["grad_thickness"].cpu().numpy()}
    b = {k: 10 * max(ROUNDING, float(
        np.linalg.norm(np.asarray(p[k]) - w[k]) / np.linalg.norm(w[k])))
        for k in ("tip", "objective", "grad")}
    rc = {k: float(np.linalg.norm(np.asarray(vals[DEVICE][k])
                                  - vals["cpu"][k])
                   / np.linalg.norm(vals["cpu"][k])) for k in b}
    print(f"  (4, 6) card vs CPU tensors: {rc} (bars {b}, 10x the JAX "
          "package's own spread)")
    if not all(rc[k] <= b[k] for k in b):
        raise AssertionError("fsi (4, 6): card and CPU differ")
    r["card_vs_cpu"] = rc
    return r


DYN_ORACLE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "oracles", "fsi_dynamic_oracle.npz")
# bench_scale.py's 77k rung of the reference's dynamic mesh ladder
# (run_fsi_dynamic; run_aeroelasticity_dynamic.py:51-55): 76,800 cells,
# 662,442 dofs, 96 panels, 2 FSI passes and 4 PCG iterations a step, the
# 6-pass adjoint; 12 steps, so that the 1-cosine gust (from t = 0.1) acts
# in steps 11 and 12
DYN_RUNG = dict(n_shell=[4, 9600], n_vlm=[4, 24], span=21.0, thickness=0.05,
                dt=0.01, fsi_iters=2, pcg_iters=4, adj_passes=6, n_steps=12)
DYN_NB = 5176  # its block-tridiagonal layout: nb blocks of B = 128
# the rung's two-call equal-bits check runs this many steps, not 12
DYN_REPEAT_STEPS = 2
# W9's loads: examples/run_aeroelasticity_vpm.py's synthetic restart file
DYN_SERIES = dict(kind="restart", seed=0, n_samples=24)
# the CPU tests' eager and jitted configurations at (4, 6) / (2, 4)
DYN_SMALL = dict(n_shell=[4, 6], n_vlm=[2, 4], dt=0.01)
DYN_GUST = dict(t0=0.0, duration=0.03)
# Fixed bars against the JAX package's entries (relative; tips and
# gradients in L2), set before the first card run (PERF.md §6): the
# midpoint operator (2 rho t / dt^2) M + K/2 lifts the cantilever's soft
# bending modes by the mass term, so its conditioning is far better than
# the static anchor's (whose bars, 2e-2 and 4e-2, these never exceed).
# The f32-storage run is held to them against the JAX package's f32
# entry, and its distance from the port's own f64-storage run to 10x the
# JAX package's f32-vs-f64 spread (DYN_STORAGE).  (10x that spread
# against the JAX f32 entry fails without a defect: the port reads ~2e-7
# from the JAX package in f64 too, where its own two storages differ by
# ~3e-9 and the JAX package's by ~5e-9; PERF.md §6.)
DYN_GATES = dict(rung_f64=dict(tips=1e-4, J=1e-4, grad=1e-3),
                 rung=dict(tips=1e-4, J=1e-4, grad=1e-3),
                 w9_rung_f64=dict(tips=1e-4, J=1e-4, grad=1e-3,
                                  grad_forces=1e-3))
DYN_STORAGE = ("rung", "rung_f64")
# the rung with block cyclic reduction and with the equilibrated f32
# factor (f64 storage); the same wing at 600 spanwise cells with the f32
# factor.  Each run_with_grad is held to the JAX package's f64 entry of its
# wing (DYN_REFS) at DYN_GATES' rung_f64 bars, but for the f32 factor at
# the rung, whose reading is printed and not gated: there the f32 factor is
# no preconditioner, in the JAX package either (PERF.md §6: ||A M b - b|| /
# ||b|| reads 0.71 on the card at the rung, 78 for the JAX package's own at
# 4,800 spanwise cells, and 32 PCG iterations leave the card's tips 10% off
# the f64 answer).  It missed DYN_GATES on its first reading (tips rel 62),
# and the same quantity is gated where the method is admissible in both
# packages: the wing at 600 spanwise cells (||A M b - b|| / ||b|| 5e-3).
# rung_f32c (ungated: its factor does not precondition this chain, PERF.md
# §6) runs one step of the rung, not 12: its K1/K2 launches and its f32
# factor's sweeps are what it measures
DYN_FACTORS = {"rung_cr": dict(factor_method="cr"),
               "rung_f32c": dict(factor_compute_dtype="float32", n_steps=1),
               "span600_f32c": dict(factor_compute_dtype="float32",
                                    n_shell=[4, 600])}
DYN_REFS = {"rung_cr": "rung_f64", "rung_f32c": None,
            "span600_f32c": "span600_f64"}


def dyn_config(key):
    """The configuration of dynamic-oracle entry `key` as driven here."""
    if key.startswith("eager"):
        c = dict(DYN_SMALL, fsi_iters=6, n_steps=3)
    elif key.startswith("jit"):
        c = dict(DYN_SMALL, fsi_iters=8, factor_store_dtype=None,
                 pcg_iters=0, adj_passes=10, n_steps=3)
    elif key == "rung":
        c = dict(DYN_RUNG, factor_store_dtype="float32")
    elif key in DYN_FACTORS:
        c = dict(DYN_RUNG, factor_store_dtype=None, **DYN_FACTORS[key])
    elif key == "span600_f64":
        c = dict(DYN_RUNG, factor_store_dtype=None, n_shell=[4, 600])
    else:
        c = dict(DYN_RUNG, factor_store_dtype=None)
        if key == "w9_rung_f64":
            c.update(external_loads=True, series=DYN_SERIES)
    if key.endswith("_gust"):
        c["gust"] = DYN_GUST
    return c


def dyn_oracle(key):
    """Dynamic-oracle entry `key`, after checking its configuration."""
    oracle = np.load(DYN_ORACLE)
    cfg = dyn_config(key)
    got = json.loads(str(oracle[f"{key}_config"]))
    if got != json.loads(json.dumps(cfg)):
        raise AssertionError(f"fsi dynamic oracle entry {key} is for {got}, "
                             f"not {cfg}")
    return {k[len(key) + 1:]: oracle[k] for k in oracle.files
            if k.startswith(f"{key}_") and not k.endswith("_config")}


def dyn_build(c, template=None):
    return build_dynamic_fsi_jit_step(
        device=DEVICE, template=template,
        **shell_kwargs({k: v for k, v in c.items()
                        if k not in ("n_steps", "series")}))


def dyn_series(f, c):
    """W9's midpoint load series: the synthetic restart file written to a
    temporary directory and read back through aero_forces_from_file."""
    s, n, dt = c["series"], c["n_steps"], c["dt"]
    with tempfile.TemporaryDirectory() as tmp:
        fn = aero_forces_from_file(synthetic_restart(
            os.path.join(tmp, "restart.npz"), f["n_force_pts"], n * dt,
            s["n_samples"], s["seed"]), device=DEVICE)
        return torch.stack([fn((k + 0.5) * dt) for k in range(n)])


def dyn_want(c, grad):
    """K1/K2/K4T launches of a run (grad: run_with_grad) from the code: a
    polished solve sweeps 2 + pcg_iters times (1 without the polish; 0
    with cyclic reduction); a W8 forward step is fsi_iters solves, a
    backward step 1 + adj_passes solves and adj_passes Fm^T products (Fm
    is one block); W9 one solve a step each way."""
    n, p = c["n_steps"], c["pcg_iters"]
    per = 2 + p if p > 0 else 1
    if c.get("factor_method") == "cr":
        per = 0
    if c.get("external_loads"):
        solves, k4t = n * (1 + grad), 0
    else:
        solves = n * c["fsi_iters"] + grad * n * (1 + c["adj_passes"])
        k4t = grad * n * c["adj_passes"]
    return {"K1": solves * per, "K2": solves * per, "K4T": k4t}


def dyn_counted(label, f, c, grad, series=None):
    """f's run (or run_with_grad) over c's steps with K1/K2/K4T and the
    solver's counts reset just before and read just after, the stages
    counted by the step profiler's dynamic ranges: (seconds, outputs,
    launches).  The launches must equal dyn_want's and the solver's own
    count (solves + preconditioner applications)."""
    reset(bt_sweeps.launches)
    reset(spmv.launches)
    f["stats"].update(solves=0, precond=0, pcg_iters=[])
    call = f["run_with_grad"] if grad else f["run"]
    with layer_ranges(DYN_LAYERS) as lr:
        t, out = synced(lambda: call(f["t0"], c["n_steps"],
                                     forces_series=series))
    launches = {**bt_sweeps.launches, "K4T": spmv.launches["K4T"]}
    want = dyn_want(c, grad)
    stats = dict(f["stats"])
    print(f"  {label}: {t:.3f} s; K1 {launches['K1']}, K2 {launches['K2']}, "
          f"K4T {launches['K4T']} launches (want {want}; {stats['solves']} "
          f"solves + {stats['precond']} preconditioner applications); "
          f"{lr.calls['dyn.fill']} fill, {lr.calls['dyn.factor_core']} "
          f"factor, {lr.calls['dyn.vlm']} VLM solves, {lr.calls['dyn.rhs']} "
          f"right-hand sides")
    sweeps = (0 if c.get("factor_method") == "cr"
              else stats["solves"] + stats["precond"])
    if (launches != want or stats["solves"] == 0
            or launches["K1"] != sweeps):
        raise AssertionError(f"{label}: launches {launches}, want {want}")
    return t, out, launches


def dyn_values(out):
    """run_with_grad's outputs as numpy values."""
    v = {"tips": np.asarray(out["tips"], np.float64), "J": out["J"],
         "grad": out["grad_thickness"].cpu().numpy()}
    if "grad_forces" in out:
        v["grad_forces"] = out["grad_forces"].cpu().numpy()
    return v


def dyn_rel(a, b):
    return float(np.linalg.norm(np.asarray(a, np.float64) - b)
                 / np.linalg.norm(b))


def dyn_against(label, got, want, bars):
    """got's values against the JAX package's `want`, each at its bar
    (none: printed, not gated); returns the readings."""
    r = {k: dyn_rel(v, want[k]) for k, v in got.items()}
    step = np.abs(got["tips"] - want["tips"]) / np.abs(want["tips"])
    print(f"  {label} vs the JAX package: "
          + "; ".join(f"{k} rel {v:.3e} ("
                      + (f"bar {bars[k]:.1e})" if k in bars else "not gated)")
                      for k, v in r.items())
          + f"; J {got['J']!r} (JAX {float(want['J'])!r}); last tips "
          f"{got['tips'][-2:].tolist()} (JAX {want['tips'][-2:].tolist()}); "
          f"tips rel by step {[f'{v:.1e}' for v in step]}")
    if not all(r[k] <= bars[k] for k in bars):
        raise AssertionError(f"{label} disagrees with the JAX package: {r}")
    return r


def dyn_rung(f, key, with_run):
    """W8 on f's build with the factor stored as dyn_config(key) says: a
    counted run (with_run), a counted run_with_grad (its tips the run's,
    bit for bit) against the JAX package's entry."""
    c = dyn_config(key)
    f["dyn"].bt.store = c["factor_store_dtype"]
    t_run = l_run = None
    if with_run:
        t_run, run, l_run = dyn_counted(f"{key} run", f, c, False)
    t, out, launches = dyn_counted(f"{key} run_with_grad", f, c, True)
    if with_run and not np.array_equal(np.asarray(run["tip_disp"]),
                                       out["tips"]):
        raise AssertionError(f"{key}: run and run_with_grad tips differ")
    want = dyn_oracle(key)
    bars = DYN_GATES[key]
    got = dyn_values(out)
    n = c["n_steps"]
    r = dict(run_s=t_run, run_with_grad_s=t, run_launches=l_run,
             launches=launches, forward_step_s=out["forward_s"] / n,
             backward_step_s=out["backward_s"] / n,
             adj_step_s=out["adj_step_s"], tips=got["tips"].tolist(),
             J=got["J"], grad_norm=float(np.linalg.norm(got["grad"])),
             adj_deltas=out["adj_deltas"],
             vs_jax=dyn_against(f"fsi dynamic {key}", got, want, bars),
             bars=bars)
    print(f"  {key}: forward {r['forward_step_s']:.3f} s a step, backward "
          f"{r['backward_step_s']:.3f} s a step; J {got['J']!r}, |grad| "
          f"{r['grad_norm']!r}; adj_deltas "
          f"{[f'{v:.2e}' for v in out['adj_deltas']]}")
    if not all(np.isfinite(v).all() for v in got.values()):
        raise AssertionError(f"fsi dynamic {key}: not finite")
    return r, out


def dyn_factor_option(key, tpl):
    """W8 with DYN_FACTORS[key] (on the W8 build's template `tpl` at the
    rung): one counted run_with_grad against the JAX package's f64 entry
    DYN_REFS[key] at DYN_GATES' rung_f64 bars (with none, the distance to
    rung_f64 is printed, not gated); with CR, its factor and solve beside
    Thomas's on the rung's operator (cr_times); with the f32 factor, the
    blocks the guard rescued, and at the rung K1/K2 in f32 against plain
    on its factor, timed (f32_factor_sweeps)."""
    c = dyn_config(key)
    gc.collect()
    torch.cuda.empty_cache()
    t_b, f = synced(lambda: dyn_build(
        c, template=tpl if c["n_shell"] == DYN_RUNG["n_shell"] else None))
    print(f"fsi dynamic {key} {DYN_FACTORS[key]}: {f['n_cells']} cells, "
          f"nb={f['tpl'].nb}; build {t_b:.2f} s")
    t, out, launches = dyn_counted(f"{key} run_with_grad", f, c, True)
    got = dyn_values(out)
    n, ref = c["n_steps"], DYN_REFS[key]
    r = dict(build_s=t_b, run_with_grad_s=t, launches=launches,
             forward_step_s=out["forward_s"] / n,
             backward_step_s=out["backward_s"] / n, J=got["J"],
             grad_norm=float(np.linalg.norm(got["grad"])))
    if ref:
        r["vs_jax"] = dyn_against(f"fsi dynamic {key}", got,
                                  dyn_oracle(ref), DYN_GATES["rung_f64"])
    else:  # fewer steps than any entry: printed, not compared
        print(f"  {key} ({n} step(s), not gated): tips "
              f"{got['tips'].tolist()}, J {got['J']!r}, |grad| "
              f"{r['grad_norm']!r}")
    print(f"  {key}: forward {r['forward_step_s']:.3f} s a step, backward "
          f"{r['backward_step_s']:.3f} s a step")
    if ref and not all(np.isfinite(v).all() for v in got.values()):
        raise AssertionError(f"fsi dynamic {key}: not finite")
    t32 = None
    if key == "rung_cr":
        del out
        D, L, U = f["fill"](f["t0"])
        r["times"] = cr_times(f["dyn"].bt.matrix(D, L, U), "W8 rung operator",
                              reps=2)
        del D, L, U
    if "factor_compute_dtype" in DYN_FACTORS[key]:
        r["rescued"] = int(f["dyn"].bt.rescued)
        print(f"  {key}: the guard rescued {r['rescued']} block(s) of the "
              f"f32 factor")
    if key == "rung_f32c":
        del out
        t32, r["f32"] = f32_factor_sweeps(f, f["dyn"].bt,
                                          "fsi dynamic rung operator", 67)
    return r, t32


def dyn_storage(got):
    """The port's f32-vs-f64 factor storage distance (DYN_STORAGE runs'
    values `got`) against 10x the JAX package's own, at least 10
    ROUNDING."""
    a, b = DYN_STORAGE
    ja, jb = dyn_oracle(a), dyn_oracle(b)
    r, bars = {}, {}
    for k in ("tips", "J", "grad"):
        r[k] = dyn_rel(got[a][k], got[b][k])
        bars[k] = 10 * max(ROUNDING, dyn_rel(ja[k], jb[k]))
    print("  f32 vs f64 factor storage, the port against itself: "
          + "; ".join(f"{k} rel {r[k]:.3e} (bar {bars[k]:.1e}, 10x the JAX "
                      f"package's)" for k in r))
    if not all(r[k] <= bars[k] for k in r):
        raise AssertionError(f"fsi dynamic: f32 storage moves the result "
                             f"more than in the JAX package: {r}")
    return dict(rel=r, bars=bars)


def dyn_eager(key):
    """DynamicShellFSI at (4, 6) / (2, 4) on the card (its solves are the
    composite op's block-Thomas solves, K1/K2 counted) against the JAX
    package's eager entry within 10x its eager-vs-jit spread."""
    c = dyn_config(key)
    want = dyn_oracle(key)["tips"]
    pair = dyn_oracle(key.replace("eager", "jit"))["tips"]
    gust = (functools.partial(one_cosine_gust, **c["gust"]) if "gust" in c
            else one_cosine_gust)
    fsi = build_wing_fsi(n_shell=tuple(c["n_shell"]),
                         n_vlm=tuple(c["n_vlm"]), device=DEVICE)
    dyn = DynamicShellFSI(fsi, dt=c["dt"], fsi_iters=c["fsi_iters"],
                          gust=gust)
    reset(bt_sweeps.launches)
    tips = dyn.run(c["n_steps"])["tip_disp"]
    launches = dict(bt_sweeps.launches)
    bar = 10 * max(ROUNDING, dyn_rel(pair, want))
    r = dyn_rel(tips, want)
    print(f"  eager {key} (4, 6): tips {tips} rel {r:.3e} (bar {bar:.1e}); "
          f"K1 {launches['K1']}, K2 {launches['K2']} launches")
    if not (r <= bar and launches["K1"] == launches["K2"] > 0):
        raise AssertionError(f"fsi dynamic eager {key}: {r}, {launches}")
    return dict(rel=r, bar=bar, launches=launches)


def phase_fsi_dynamic(err):
    """W8 and W9 at the 77k rung (DYN_RUNG), f64 on the card: the build
    (the host template) and the factor's two halves; W8 with f32 factor
    storage (a counted run and run_with_grad), then f64 storage (a
    counted run_with_grad): the launches against dyn_want, per-step
    seconds, J, |grad|, adj_deltas; each against the JAX package's entry
    at DYN_GATES, and the f32-vs-f64 distance within 10x the JAX
    package's own, dyn_storage)
    and a second f64 run_with_grad giving the same bits; peak device
    memory; K1/K2 against plain on the rung's f64-stored factor and timed
    at its shape, K4/K4T against plain on its Fm and timed; W9 on the W8
    build's template under the synthetic restart series, one counted
    run_with_grad at DYN_GATES; W8 with block cyclic reduction and with
    the equilibrated f32 factor on that template and with the f32 factor
    at 600 spanwise cells, against the JAX package's f64 entries where
    DYN_REFS names one, and K1/K2 in f32 on the rung's f32 factor
    (dyn_factor_option); the eager class at (4, 6)."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_build, f = synced(lambda: dyn_build(dyn_config("rung")))
    tpl = f["tpl"]
    t_fill, dlu = synced(lambda: f["fill"](f["t0"]))
    t_core, _ = synced(lambda: f["factor_core"](*dlu))
    del dlu
    print(f"fsi dynamic rung {DYN_RUNG}: {f['n_cells']} cells, "
          f"{f['n_dofs']} dofs, {f['n_force_pts']} panels, nb={tpl.nb} "
          f"B={tpl.B} (RCM bandwidth {tpl.bw}), assembly chunk "
          f"{f['assembly_chunk']}; build {t_build:.2f} s, fill "
          f"{t_fill:.3f} s, factor core {t_core:.3f} s")
    if (tpl.nb, tpl.B) != (DYN_NB, 128):
        raise AssertionError(f"fsi dynamic rung layout {tpl.nb} x {tpl.B}")
    res = dict(build_s=t_build, fill_s=t_fill, factor_core_s=t_core,
               n_cells=f["n_cells"], n_dofs=f["n_dofs"], nb=tpl.nb, B=tpl.B)
    res["rung"], out32 = dyn_rung(f, "rung", True)
    res["rung_f64"], out = dyn_rung(f, "rung_f64", False)
    res["storage"] = dyn_storage({"rung": dyn_values(out32),
                                  "rung_f64": dyn_values(out)})
    del out32, out
    # equal bits between two calls: two run_with_grad of DYN_REPEAT_STEPS
    t2, (out, out2) = synced(lambda: [
        f["run_with_grad"](f["t0"], DYN_REPEAT_STEPS) for _ in range(2)])
    for k in ("tips", "grad_thickness"):
        same_bits(f"fsi dynamic rung_f64 {k} over {DYN_REPEAT_STEPS} "
                  "steps, two calls",
                  torch.as_tensor(out[k]), torch.as_tensor(out2[k]))
    res["rung_f64"]["repeat_s"] = t2
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    print(f"  two f64 run_with_grad of {DYN_REPEAT_STEPS} steps {t2:.3f} s; "
          f"peak device memory {res['peak_gib']:.3f} GiB")
    del out, out2
    carry = f["factor"](f["t0"])
    mat, fac = f["dyn"].bt.unpack(carry)
    nb, B = fac.Sinv.shape[:2]
    bb = torch.as_tensor(np.random.default_rng(53).standard_normal((nb, B)),
                         dtype=torch.float64, device=DEVICE)
    check_sweeps(fac, bb, f"fsi dynamic rung factor (f64 storage) nb={nb} "
                 f"B={B}", err, spread=True)
    t_sweeps = time_sweeps(fac, bb, "fsi dynamic rung", plain_reps=3,
                           profile=False)
    del carry, mat, fac
    Fm = f["dyn"].fm()
    k4_err = check_element_matrices("fsi dynamic rung Fm", [Fm])
    t_fm = time_element("fsi dynamic rung Fm (u test dofs x force dofs)",
                        Fm, 54)
    c9 = dyn_config("w9_rung_f64")
    t_b9, f9 = synced(lambda: dyn_build(c9, template=tpl))
    del f, Fm
    series = dyn_series(f9, c9)
    want = dyn_oracle("w9_rung_f64")
    s_rel = dyn_rel(series.cpu().numpy(), want["series"])
    print(f"fsi w9 rung on the W8 template: build {t_b9:.2f} s; the restart "
          f"series {tuple(series.shape)} vs the JAX package's rel {s_rel:.1e}")
    if not s_rel <= 1e-14:
        raise AssertionError("fsi w9: the load series differs")
    t9, out9, l9 = dyn_counted("w9_rung_f64 run_with_grad", f9, c9, True,
                               series)
    got = dyn_values(out9)
    n = c9["n_steps"]
    res["w9"] = dict(
        build_s=t_b9, run_with_grad_s=t9, launches=l9,
        forward_step_s=out9["forward_s"] / n,
        backward_step_s=out9["backward_s"] / n, tips=got["tips"].tolist(),
        J=got["J"], grad_norm=float(np.linalg.norm(got["grad"])),
        grad_forces_norm=float(np.linalg.norm(got["grad_forces"])),
        vs_jax=dyn_against("fsi w9_rung_f64", got, want,
                           DYN_GATES["w9_rung_f64"]))
    print(f"  w9: forward {res['w9']['forward_step_s']:.3f} s a step, "
          f"backward {res['w9']['backward_step_s']:.3f} s a step; |grad| "
          f"{res['w9']['grad_norm']!r}, |grad_forces| "
          f"{res['w9']['grad_forces_norm']!r}")
    del f9, out9
    t_f32 = None
    for key in DYN_FACTORS:
        res[key], t32 = dyn_factor_option(key, tpl)
        t_f32 = t32 or t_f32
    res["eager"] = {k: dyn_eager(k) for k in ("eager", "eager_gust")}
    return res, t_sweeps, t_fm, k4_err, t_f32


FACETS_3D_N = 8  # create_unit_cube_mesh(8): 3,072 tets, 512 hexes


def facet_form(device, cell):
    """An interior-facet residual on create_unit_cube_mesh(FACETS_3D_N)
    of `cell` (jumps, each side's value and gradient, the normal, g.h;
    nonlinear, so its Jacobian depends on the state), compiled on
    `device`."""
    mesh = create_unit_cube_mesh(FACETS_3D_N, cell_type=cell)
    V = FunctionSpace(mesh, ("CG", 1), device=device)
    u = Function(V, "u")

    def res(w, g):
        total = jump(w.u) * jump(w.v) / g.h
        for side, sgn in (("+", 1.0), ("-", -1.0)):
            uh, vv = w.u(side), w.v(side)
            total = total + sgn * (uh.val ** 2 * dot(vv.grad, g.n)
                                   + dot(uh.grad, g.n) * vv.val)
        return total

    return compile_form(FormDef([dS(res)], coeffs=[u], test=V)), V.n_dofs


def phase_facets_3d():
    """Facet terms of 3D cells: the interior-facet residual of facet_form
    and its Jacobian on the unit cube of tets and of hexes, assembled on
    the card and on CPU tensors from one seeded state: relative 1e-12
    (each entry's sum runs in another order on the card), and two
    assemblies on the card with equal bits."""
    out = {}
    for cell in ("tet", "hex"):
        got = {}
        for dev in (DEVICE, "cpu"):
            cf, n = facet_form(dev, cell)
            u = torch.as_tensor(np.random.default_rng(71).standard_normal(n),
                                device=dev)
            runs = [(cf.vector({"u": u}), cf.matrix({"u": u}, "u").to_dense())
                    for _ in range(2 if dev == DEVICE else 1)]
            got[dev] = runs
        (r1, A1), (r2, A2) = got[DEVICE]
        r0, A0 = got["cpu"][0]
        same_bits(f"3D facets ({cell}) residual, two card runs", r1, r2)
        same_bits(f"3D facets ({cell}) Jacobian, two card runs", A1, A2)
        e = {"residual": rel(r1.cpu(), r0), "jacobian": rel(A1.cpu(), A0)}
        term = cf.terms[0]
        print(f"  3D facets ({cell}, unit cube {FACETS_3D_N}): {term.n_ent} "
              f"interior facets, {n} dofs; card vs CPU tensors: residual rel "
              f"{e['residual']:.3e}, Jacobian rel {e['jacobian']:.3e} (tol "
              f"1e-12)")
        if not max(e.values()) <= 1e-12:
            raise AssertionError(f"3D facets ({cell}): card and CPU differ")
        out[cell] = dict(e, facets=term.n_ent, dofs=n)
    return out


# ---------------------------------------------------------------------------
# distributed: mode b (the dof-sharded halo CG, K4 inside each rank) and
# mode a (the cells-sharded Poisson, motor and shell steps) on 4 ranks
# that share the card through gloo (femo_tpu_torch/parallel/,
# femo_tpu_torch/tools/distributed_check.py)
# ---------------------------------------------------------------------------

DIST_ORACLE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "oracles", "distributed_oracle.npz")
DIST = dict(ranks=4, nel=260, rtol=1e-8, poisson_nel=260, motor_refine=1,
            shell_shape=(3, 4), halo_step=distributed_check.HALO_STEP,
            motor_halo=distributed_check.MOTOR_HALO)
# the oracle entries they are held to: the halo CG's (halo260_*) and the
# motor's in oracles/motor_oracle.npz
DIST_KEYS = dict(halo="halo260", motor="r1_lu")
# fixed before the first run on the card.  Mode b: a CG stopped at rtol
# 1e-8 fixes x only to what its stopping test allows, so x is held to the
# exact solution, not to JAX's x: the true relative residual of the
# gathered x, its distance to the exact solution within `dist_factor`
# times the JAX package's own, its iterations within `iters` of JAX's.
# Mode a: value and gradient (relative L2).
DIST_GATES = dict(residual=2e-8, dist_factor=10.0, iters=0.03,
                  value=1e-8, grad=1e-6)
# mode b inside the workload steps (parallel/halo_step.py).  The full-
# width W6 shell halo step (distributed_check.HALO_STEP: 19,200 cells,
# 147,822 dofs, block Jacobi, the plate of shell oracle entry a) is held
# to entry a at SHELL_GATES["a"], and the true relative residual of its
# forward x (K4's plain version on the whole Jacobian) to
# HALO_STEP_RESIDUAL, fixed before the first gated run (PERF.md §6).  The
# steps at (3, 4) against distributed_oracle.npz's shell34_halo_* and
# fsi34_halo_*: value and gradient at SMALL_STEP_GATES (the JAX dryrun's
# and tests/test_halo.py's bars), the forward solve's CG iterations
# within HALO_ITERS of JAX's: rounding alone moves the port's own counts
# by up to 13.5% (distributed_check.py --iteration-spread).
HALO_STEP_RESIDUAL = 1e-3
SMALL_STEP_GATES = dict(shell=1e-8, fsi=1e-7)
HALO_ITERS = 0.15
# mode b inside the motor step (parallel/halo_newton.py): bench.py's
# refine-1 motor at n6 (distributed_check.MOTOR_HALO), held to the port's
# single-device dense-LU step in this run and to the JAX package's f64
# value of that step (distributed_oracle.npz MOTOR_HALO_KEY_*) at
# tests/test_motor_halo.py:128-130's bars: loss 1e-10, gradients 1e-8
MOTOR_HALO_KEY = "motor1_n6_lu_edge"
MOTOR_HALO_GATES = dict(loss=1e-10, grad=1e-8)
GMRES_RESTART = 50  # build_halo_newton_solver's default GMRES(m)


def constrained_plain(A, free, x):
    """The BC-constrained operator P A P + (I - P) applied with K4's plain
    version."""
    xf = torch.where(free, x, 0.0)
    y = sum(spmv.element_spmv_plain(b.A, b.rows, b.cols, xf, A.shape[0])
            for b in A.blocks)
    return torch.where(free, y, x)


def halo_gates(label, x, iters, A, free, oracle):
    """A gathered mode-b solution of A x = 1 against DIST_GATES and the
    JAX package's run (oracle DIST_KEYS["halo"])."""
    x = torch.as_tensor(x, device=DEVICE)
    h = DIST_KEYS["halo"]
    b = torch.ones_like(x)
    res = float(torch.linalg.norm(b - constrained_plain(A, free, x))
                / torch.linalg.norm(b))
    xe = torch.as_tensor(oracle[f"{h}_x_exact"], device=DEVICE)
    d = float(torch.linalg.norm(x - xe) / torch.linalg.norm(xe))
    jd, ji = float(oracle[f"{h}_dist"]), int(oracle[f"{h}_iters"])
    jx = torch.as_tensor(oracle[f"{h}_x"], device=DEVICE)
    g = DIST_GATES
    print(f"  {label}: {iters} iterations (JAX {ji}, bar +-"
          f"{g['iters']:.0%}); true residual ||b - A x||/||b|| {res:.3e} "
          f"(bar {g['residual']:.0e}); distance to the exact solution "
          f"{d:.3e} (JAX {jd:.3e}, bar {g['dist_factor']:.0f}x = "
          f"{g['dist_factor'] * jd:.3e}); x rel to JAX's x "
          f"{float(torch.linalg.norm(x - jx) / torch.linalg.norm(jx)):.3e}"
          " (not gated)")
    if not (res <= g["residual"] and d <= g["dist_factor"] * jd
            and abs(iters - ji) <= g["iters"] * ji):
        raise AssertionError(f"{label}: the distributed CG misses its bars")
    return dict(iterations=iters, true_residual=res, dist_exact=d,
                jax_iterations=ji, jax_dist=jd)


def phase_distributed(jit_ref):
    """4 ranks on the card (gloo, CUDA tensors, f64): mode b at the
    example's nel=260 against the JAX oracle and on one rank; K4 per rank
    (its launches against the CG's matvecs, against its plain version)
    and timed at rank 0's local shape; mode a's three steps against the
    port's unsharded Poisson step (`jit_ref`, phase jit_step), the motor
    oracle's r1_lu and the shell oracle entry; mode b inside the shell
    and FSI steps (halo_step_checks, small_steps_checks) and inside the
    motor step (motor_halo_checks: bench.py's refine-1 motor at n6, halo
    GMRES and CG with K4/K4T on every rank, against the single-device
    step and the JAX oracle), with K4/K4T timed at its rank-0 shapes."""
    oracle = np.load(DIST_ORACLE)
    t0 = time.perf_counter()
    res = distributed_check.run(device=DEVICE, **DIST)
    t_spawn = time.perf_counter() - t0
    h0 = res[0]["halo"]
    print(f"distributed: {DIST['ranks']} ranks on one card (gloo), f64; "
          f"mode b nel={DIST['nel']} ({h0['n_cells']} cells, "
          f"{h0['n_dofs']} dofs), layout L/G/S {h0['L']}/{h0['G']}/"
          f"{h0['S']} (JAX "
          + "/".join(str(int(oracle[f"{DIST_KEYS['halo']}_{k}"]))
                     for k in "LGS") + "); "
          f"{t_spawn:.1f} s for the pool")
    expect("halo layout L/G/S", (h0["L"], h0["G"], h0["S"]),
           tuple(int(oracle[f"{DIST_KEYS['halo']}_{k}"]) for k in "LGS"))
    A, free, V = distributed_check.halo_system(DIST["nel"], DEVICE)
    k4 = []
    for r in res:
        h = r["halo"]
        tol = SPMV_TOL[torch.float64] * h["k4_max_abs"]
        print(f"  rank {h['rank']}: {h['n_owned']} owned, {h['n_ghosts']} "
              f"ghosts, {h['n_elements']} elements; K4 vs plain max abs "
              f"{h['k4_max_abs_err']:.3e} (tol {tol:.1e}); cold CG "
              f"{h['cold']['iterations']} iterations, K4 {h['cold']['k4']} "
              f"launches; warm {h['warm']['iterations']}, K4 "
              f"{h['warm']['k4']}, {h['warm']['ms_per_iteration']:.3f} ms "
              f"an iteration; split (ms a call): "
              + ", ".join(f"{k} {v:.3f}" for k, v in h["split_ms"].items())
              + f"; assembly {h['assembly_s']:.2f} s, layout "
              f"{h['layout_s']:.2f} s")
        for run in ("cold", "warm"):
            want = h[run]["iterations"] + 1  # + the initial residual's
            if not (h[run]["k4"] == want > 1):
                raise AssertionError(f"rank {h['rank']} {run} CG: K4 "
                                     f"{h[run]['k4']}, matvecs {want}")
            expect("iterations on every rank", h[run]["iterations"],
                   h0[run]["iterations"])
        if not h["k4_max_abs_err"] <= tol:
            raise AssertionError(f"rank {h['rank']}: K4 disagrees with "
                                 "its plain version")
        k4.append(h["cold"]["k4"])
    four = halo_gates(f"{DIST['ranks']} ranks", h0["x"],
                      h0["warm"]["iterations"], A, free, oracle)
    one = h0["one_rank"]
    print(f"  one rank (L {one['L']}, G {one['G']}): K4 {one['k4']} "
          f"launches, {one['seconds']:.3f} s "
          f"({one['seconds'] / max(one['iterations'], 1) * 1e3:.3f} ms an "
          f"iteration)")
    expect("one-rank K4 launches", one["k4"], one["iterations"] + 1)
    single = halo_gates("one rank", one["x"], one["iterations"], A, free,
                        oracle)
    # K4 at rank 0's local shape on the otherwise idle card: rank 0's
    # elements and local slots, built here without a process group
    op0 = HaloShardedOperator(A, V.dofmap, V.n_dofs, RankMesh(
        None, 0, DIST["ranks"], torch.device(DEVICE)), free=free)
    expect("rank 0's elements", op0.n_elements, h0["n_elements"])
    t_k4 = time_element(f"halo rank 0 of {DIST['ranks']} (nel="
                        f"{DIST['nel']}, local slots)", op0.local, 31)

    a = [r["mode_a"] for r in res]
    for key in ("poisson", "motor", "shell"):
        for r in a[1:]:
            vals = ("J", "g") if key != "motor" else ("loss", "g_dv", "g_iq")
            for v in vals:
                if not np.array_equal(np.asarray(r[key][v]),
                                      np.asarray(a[0][key][v])):
                    raise AssertionError(f"mode a {key}: {v} differs "
                                         "between the ranks")
    p = a[0]["poisson"]
    check_oracle_values(
        f"mode a Poisson nel={DIST['poisson_nel']} (cg)", p["J"],
        torch.as_tensor(p["g"]), jit_ref[0], jit_ref[1],
        DIST_GATES["value"], DIST_GATES["grad"],
        ref="the port's unsharded step")
    m = a[0]["motor"]
    check_oracle(f"mode a motor refine {DIST['motor_refine']} (dense LU)",
                 m["loss"], torch.as_tensor(m["g_dv"]), m["g_iq"],
                 motor_oracle(), DIST_KEYS["motor"], DIST_GATES["value"],
                 DIST_GATES["grad"])
    sh = a[0]["shell"]
    check_oracle_values(
        f"mode a shell {DIST['shell_shape']} ({sh['n_dofs']} dofs)", sh["J"],
        torch.as_tensor(sh["g"]), oracle["shell34_J"], oracle["shell34_g"],
        DIST_GATES["value"], DIST_GATES["grad"])
    print(f"  mode a seconds (first call, rank 0): Poisson "
          f"{p['seconds']:.2f}, motor {m['seconds']:.2f}, shell "
          f"{sh['seconds']:.2f}; rank 0 mode b {res[0]['halo_s']:.1f} s, "
          f"mode a {res[0]['mode_a_s']:.1f} s")
    step = halo_step_checks([r["halo_step"] for r in res])
    small = small_steps_checks([r["small_steps"] for r in res], oracle)
    motor = motor_halo_checks([r["motor_halo"] for r in res], oracle)
    t_sw, t_k4s = halo_step_times(step)
    t_mh = motor_halo_times()
    print(f"  seconds (rank 0): mode b {res[0]['halo_s']:.1f}, mode a "
          f"{res[0]['mode_a_s']:.1f}, shell halo step "
          f"{res[0]['halo_step_s']:.1f}, steps at (3, 4) "
          f"{res[0]['small_steps_s']:.1f}, motor halo step "
          f"{res[0]['motor_halo_s']:.1f}")
    return dict(
        launches_by_rank=k4, launches=sum(k4), k4_err=max(
            [r["halo"]["k4_max_abs_err"] for r in res] + [step["K4_err"]]),
        k4_times=t_k4, four_ranks=four, one_rank=single,
        warm_ms_per_iteration=[r["halo"]["warm"]["ms_per_iteration"]
                               for r in res],
        split_ms=h0["split_ms"], pool_s=t_spawn,
        mode_a_s={k: a[0][k]["seconds"] for k in a[0]},
        halo_step={k: v for k, v in step.items() if k != "launches"},
        small_steps=small, sweep_times=t_sw, k4_step_times=t_k4s,
        step_launches=dict(step["launches"], **small["launches"]),
        sweep_err={k: step[f"{k}_err"] for k in ("K1", "K2")},
        motor_halo={k: v for k, v in motor.items() if k != "launches"},
        motor_launches=dict(motor["launches"], **small["motor_launches"]),
        motor_times=t_mh,
        seconds={k: res[0][f"{k}_s"] for k in (
            "halo", "mode_a", "halo_step", "small_steps", "motor_halo")})


def ms_per_it(solve):
    return solve["seconds"] / max(solve["iterations"], 1) * 1e3


def halo_step_checks(hs):
    """The full-width shell halo step, every rank's results (hs, rank 0
    first): the counts of each solve against the code's (K1, K2 and K4
    each iterations + 1: one preconditioner application and one matvec
    per iteration and one each for the initial residual), K1/K2 against
    their plain versions on each rank's factor (the step residuals at
    SWEEP_TOL, the kernel-vs-plain difference at SWEEP_TOL or 10x the
    plain solve's spread under reordered sums, as on the shell phase's
    factor), K4 against its plain version on each rank's 27 x 27 blocks
    (SPMV_TOL of the largest entry), the same values on every rank;
    compliance, energy estimate and gradient against shell oracle entry
    a at SHELL_GATES["a"], the true residual at HALO_STEP_RESIDUAL."""
    h0, cfg = hs[0], DIST["halo_step"]
    if (list(cfg["n_shell"]) != SHELL_FULL["n_shell"]
            or cfg["span"] != 4.0):
        raise AssertionError(f"the halo step {cfg} is not the plate of "
                             "shell oracle entry a")
    print(f"  shell halo step {tuple(cfg['n_shell'])} ({h0['n_cells']} "
          f"cells, {h0['n_dofs']} dofs, {h0['block'][0]} x "
          f"{h0['block'][0]} element blocks), {cfg['precond']}, CG rtol "
          f"{cfg['cg_rtol']:.0e}: layout L/G/S {h0['L']}/{h0['G']}/"
          f"{h0['S']}; build {h0['build_s']:.2f} s, step {h0['step_s']:.2f}"
          " s")
    launches = {k: [] for k in ("K1", "K2", "K4")}
    err = {k: 0.0 for k in launches}
    tol = SWEEP_TOL[torch.float64]
    for h in hs:
        sw = h["sweeps"]
        bar = max(tol, 10 * sw["spread"])
        k4_tol = SPMV_TOL[torch.float64] * h["k4_max_abs"]
        print(f"  rank {h['rank']}: {h['n_owned']} owned, {h['n_ghosts']} "
              f"ghosts, {h['n_elements']} elements; block Jacobi nb="
              f"{h['nb']} B={h['B']} (RCM bandwidth {h['bw']}), matrix "
              f"halo {h['n_import']} entries in, {h['n_export']} out; "
              f"assembly {h['assemble_s']:.3f} s, matrix halo "
              f"{h['matrix_halo_s']:.3f} s, fill {h['fill_s']:.3f} s, "
              f"factor {h['factor_s']:.3f} s; solves "
              + ", ".join(f"{s['iterations']} iterations {s['seconds']:.2f} "
                          f"s ({ms_per_it(s):.2f} ms an iteration) K1/K2/K4 "
                          f"{s['K1']}/{s['K2']}/{s['K4']}"
                          for s in h["solves"])
              + "; split (ms a call): "
              + ", ".join(f"{k} {v:.3f}" for k, v in h["split_ms"].items())
              + f"; peak {h['peak_gib']:.2f} GiB")
        print(f"    K1/K2 vs plain on the rank's factor: rel L2 "
              f"{sw['K1_rel']:.3e} / {sw['K2_rel']:.3e} (bar {bar:.1e}, "
              f"10x the plain solve's spread {sw['spread']:.3e} or "
              f"{tol:.0e}); step residuals {sw['step_residuals'][0]:.3e} / "
              f"{sw['step_residuals'][1]:.3e} (tol {tol:.0e}); K4 vs plain "
              f"max abs {h['k4_max_abs_err']:.3e} (tol {k4_tol:.1e})")
        for s in h["solves"]:
            want = s["iterations"] + 1
            if not (s["K1"] == s["K2"] == s["K4"] == want > 1):
                raise AssertionError(f"rank {h['rank']}: a solve launched "
                                     f"K1/K2/K4 {s['K1']}/{s['K2']}/"
                                     f"{s['K4']}, the code {want} each")
        if not (max(sw["K1_rel"], sw["K2_rel"]) <= bar
                and max(sw["step_residuals"]) <= tol):
            raise AssertionError(f"rank {h['rank']}: K1/K2 disagree with "
                                 "their plain versions")
        if not h["k4_max_abs_err"] <= k4_tol:
            raise AssertionError(f"rank {h['rank']}: K4 disagrees with its "
                                 "plain version")
        expect("halo step iterations on every rank",
               [s["iterations"] for s in h["solves"]],
               [s["iterations"] for s in h0["solves"]])
        if not (h["J"] == h0["J"] and np.array_equal(h["g"], h0["g"])):
            raise AssertionError("the halo step's value or gradient "
                                 "differs between the ranks")
        for k in launches:
            launches[k].append(sum(s[k] for s in h["solves"]))
        err["K1"] = max(err["K1"], sw["K1_max_abs_err"])
        err["K2"] = max(err["K2"], sw["K2_max_abs_err"])
        err["K4"] = max(err["K4"], h["k4_max_abs_err"])
    oracle = shell_oracle("a")
    gate = SHELL_GATES["a"]
    rE = abs(h0["J_E"] - float(oracle["a_JE"])) / abs(float(oracle["a_JE"]))
    print(f"  energy estimate J_E {h0['J_E']!r}, JAX {float(oracle['a_JE'])!r}"
          f", rel {rE:.3e} (tol {gate['JE']:.0e}); true residual of the "
          f"forward x {h0['true_residual']:.3e} (bar {HALO_STEP_RESIDUAL:.0e};"
          f" assembled {h0['true_residual_assembled']:.3e})")
    if not (rE <= gate["JE"] and h0["true_residual"] <= HALO_STEP_RESIDUAL):
        raise AssertionError("the shell halo step misses its energy "
                             "estimate or residual bar")
    check_oracle_values("shell halo step vs shell oracle a", h0["J"],
                        torch.as_tensor(h0["g"]), oracle["a_J"],
                        oracle["a_grad"], gate["J"], gate["grad"])
    return dict(
        launches=dict(distributed_shell_halo_step=launches),
        **{f"{k}_err": v for k, v in err.items()},
        ranks=[{k: v for k, v in h.items() if k not in ("g", "x")}
               for h in hs])


def motor_dryrun_want(md):
    """K4 and K4T of the dryrun's motor halo step from its Krylov counts
    (halo_solve_want): every solve but each state's last (its adjoint)
    forward; mesh motion GMRES on 2 blocks, EM CG on 1."""
    want = dict(K4=0, K4T=0)
    for key, kind, blocks in (("mm", "gmres", 2), ("em", "cg", 1)):
        counts = md[f"{key}_counts"]
        for i, c in enumerate(counts):
            w = halo_solve_want(dict(kind=kind, count=c,
                                     transpose=i == len(counts) - 1), blocks)
            want = {k: want[k] + w[k] for k in want}
    return want


def small_steps_checks(ss, oracle):
    """The steps at (3, 4), every rank's results (ss, rank 0 first):
    the dryrun's two lines; the shell halo step with bjacobi (the
    dryrun's), jacobi and Chebyshev degree 6, and the FSI halo step,
    against the JAX package's values at SMALL_STEP_GATES, the forward
    solves' iterations within HALO_ITERS of JAX's; the launches against
    the code's: K1 = K2 = K4 = the sum of iterations + 1 over the
    dryrun's solves (all block Jacobi), K4 = iterations + 1 a jacobi
    solve and (iterations + 1) x 6 a Chebyshev-6 solve (each application
    5 matvecs), no K1/K2; every rank's values equal.  The dryrun's motor
    line: K4 and K4T as its Krylov counts give them (motor_dryrun_want),
    its loss and counts equal on every rank."""
    s0 = ss[0]
    print("  " + "\n  ".join(s0["lines"] + s0["motor_dryrun"]["lines"]))
    launches = {p: {k: [] for k in ("K1", "K2", "K4")} for p in (
        "distributed_dryrun_halo_steps", "distributed_shell34_jacobi",
        "distributed_shell34_cheby6")}
    motor = {"K4": [], "K4T": []}
    for s in ss:
        its = [i for core in s["dryrun_iterations"] for i in core]
        want = sum(i + 1 for i in its)
        got = s["dryrun_launches"]
        if got != dict(K1=want, K2=want, K4=want):
            raise AssertionError(f"dryrun halo steps launched {got}, the "
                                 f"code {want} each")
        for k, n in got.items():
            launches["distributed_dryrun_halo_steps"][k].append(n)
        for key, per in (("jacobi", 1), ("cheby6", 6)):
            for sol in s[key]["solves"]:
                want = dict(K1=0, K2=0, K4=(sol["iterations"] + 1) * per)
                got = {k: sol[k] for k in want}
                if got != want:
                    raise AssertionError(f"{key} solve launched {got}, the "
                                         f"code {want}")
            for k, n in launches[f"distributed_shell34_{key}"].items():
                n.append(sum(sol[k] for sol in s[key]["solves"]))
        md = s["motor_dryrun"]
        want = motor_dryrun_want(md)
        if {k: md[k] for k in want} != want:
            raise AssertionError(f"the dryrun's motor halo step launched "
                                 f"{ {k: md[k] for k in want} }, the code "
                                 f"{want}")
        for k in want:
            motor[k].append(md[k])
        if (md["loss"], md["mm_counts"], md["em_counts"]) != (
                s0["motor_dryrun"]["loss"], s0["motor_dryrun"]["mm_counts"],
                s0["motor_dryrun"]["em_counts"]):
            raise AssertionError("the dryrun's motor halo step differs "
                                 "between the ranks")
        for key in ("shell", "fsi", "jacobi", "cheby6"):
            if not (s[key]["J"] == s0[key]["J"]
                    and np.array_equal(s[key]["g"], s0[key]["g"])):
                raise AssertionError(f"(3, 4) {key}: the ranks differ")
    iters = {"bjacobi": s0["dryrun_iterations"][0][0],
             **{k: s0[k]["solves"][0]["iterations"]
                for k in ("jacobi", "cheby6")}}
    for key, val, okey, bar in (
            ("bjacobi", s0["shell"], "shell34_halo_bjacobi", "shell"),
            ("jacobi", s0["jacobi"], "shell34_halo_jacobi", "shell"),
            ("cheby6", s0["cheby6"], "shell34_halo_cheby6", "shell"),
            ("fsi", s0["fsi"], "fsi34_halo", "fsi")):
        want = "tip" if key == "fsi" else "J"
        check_oracle_values(f"(3, 4) {key} halo step", val["J"],
                            torch.as_tensor(val["g"]),
                            oracle[f"{okey}_{want}"], oracle[f"{okey}_g"],
                            SMALL_STEP_GATES[bar], SMALL_STEP_GATES[bar])
        if key in iters:
            ji = int(oracle[f"{okey}_iters"])
            print(f"    forward solve {iters[key]} CG iterations, JAX {ji} "
                  f"(bar +-{HALO_ITERS:.0%})")
            if not abs(iters[key] - ji) <= HALO_ITERS * ji:
                raise AssertionError(f"(3, 4) {key}: CG iterations off "
                                     "JAX's")
    return dict(launches=launches, iterations=iters,
                motor_launches={"distributed_dryrun_motor_halo": motor},
                dryrun_s=s0["dryrun_s"],
                seconds={k: s0[k]["seconds"] for k in ("jacobi", "cheby6")})


def halo_solve_want(solve, blocks):
    """What one halo Newton Krylov solve launches and communicates, from
    the code (parallel/halo.py): GMRES 1 + cycles (m + 2) products, CG
    iterations + 1, each product K4 (K4T in the transpose) once per
    element block; GMRES 2 exchanges a product + 1 (the diagonal) and
    cycles (2 m + 2) + 1 all-reduces (2 an Arnoldi step, 2 a cycle, 1 at
    the start); CG 2 iterations + 4 exchanges and no all-reduce."""
    m = GMRES_RESTART
    if solve["kind"] == "gmres":
        products = 1 + solve["count"] * (m + 2)
        coll = dict(exchanges=2 * products + 1,
                    all_reduces=solve["count"] * (2 * m + 2) + 1)
    else:
        products = solve["count"] + 1
        coll = dict(exchanges=2 * solve["count"] + 4, all_reduces=0)
    k = "K4T" if solve["transpose"] else "K4"
    return dict({k: products * blocks, ("K4" if k == "K4T" else "K4T"): 0},
                **coll)


def motor_halo_checks(mh, oracle):
    """The motor halo step, every rank's results (mh, rank 0 first):
    loss and gradients against the port's single-device dense-LU step at
    the same settings, built and run here, and against the JAX package's
    f64 value of that step (MOTOR_HALO_KEY) at MOTOR_HALO_GATES; every
    rank's values and Krylov counts equal; each solve's K4/K4T launches
    and collectives equal to the code's (halo_solve_want); K4 and K4T
    against their plain versions on each rank's blocks of both states
    (SPMV_TOL of the largest entry); the times of an Arnoldi step and a
    CG iteration and their split."""
    h0, cfg = mh[0], DIST["motor_halo"]
    t_single, single = synced(lambda: distributed_check.motor_single(
        cfg, DEVICE))
    print(f"  motor halo step {cfg}: mesh motion {h0['mm']['n_dofs']} dofs "
          f"(blocks {h0['mm']['blocks']} a rank), EM {h0['em']['n_dofs']} "
          f"(blocks {h0['em']['blocks']}); layouts L/G/S mm "
          f"{h0['mm']['L']}/{h0['mm']['G']}/{h0['mm']['S']}, em "
          f"{h0['em']['L']}/{h0['em']['G']}/{h0['em']['S']}; build "
          f"{h0['build_s']:.2f} s, step {h0['step_s']:.2f} s (rank 0); the "
          f"single-device dense-LU step here {t_single:.2f} s")
    g = MOTOR_HALO_GATES
    for ref, (loss, g_dv, g_iq) in (
            ("the port's single-device step", single),
            ("JAX", tuple(oracle[f"{MOTOR_HALO_KEY}_{k}"]
                          for k in ("loss", "g_dv", "g_iq")))):
        rl = abs(h0["loss"] - float(loss)) / abs(float(loss))
        rg = rel(torch.as_tensor(h0["g_dv"]), torch.as_tensor(g_dv))
        ri = abs(h0["g_iq"] - float(g_iq)) / abs(float(g_iq))
        print(f"    vs {ref}: loss {h0['loss']!r} / {float(loss)!r} rel "
              f"{rl:.3e} (tol {g['loss']:.0e}); g_dv ({h0['n_dv']}) rel L2 "
              f"{rg:.3e}, g_iq rel {ri:.3e} (tol {g['grad']:.0e})")
        if not (rl <= g["loss"] and rg <= g["grad"] and ri <= g["grad"]):
            raise AssertionError(f"the motor halo step disagrees with {ref}")
    launches = {k: [] for k in ("K4", "K4T")}
    err = {k: 0.0 for k in launches}
    for h in mh:
        if not (h["loss"] == h0["loss"] and h["g_iq"] == h0["g_iq"]
                and np.array_equal(h["g_dv"], h0["g_dv"])):
            raise AssertionError("the motor halo step's values differ "
                                 "between the ranks")
        for key in ("mm", "em"):
            st, blocks = h[key], len(h[key]["blocks"])
            expect(f"motor halo {key} Krylov counts on every rank",
                   [x["count"] for x in st["solves"]],
                   [x["count"] for x in h0[key]["solves"]])
            for x in st["solves"]:
                want = halo_solve_want(x, blocks)
                got = {k: x[k] for k in want}
                if got != want:
                    raise AssertionError(f"rank {h['rank']} {key} solve: "
                                         f"{got}, the code {want}")
            for b in st["kernels"]:
                for k in ("K4", "K4T"):
                    e, mx = b[k]
                    if not e <= SPMV_TOL[torch.float64] * mx:
                        raise AssertionError(
                            f"rank {h['rank']} {key} {b['shape']}: {k} "
                            f"disagrees with its plain version ({e:.3e})")
                    err[k] = max(err[k], e)
        for k in launches:
            launches[k].append(sum(x[k] for key in ("mm", "em")
                                   for x in h[key]["solves"]))
    per = {}
    for key in ("mm", "em"):
        st = h0[key]
        gm = [x for x in st["solves"] if x["kind"] == "gmres"]
        steps = sum(x["count"] * GMRES_RESTART for x in gm)
        its = sum(x["count"] for x in st["solves"] if x["kind"] == "cg")
        secs = sum(x["seconds"] for x in st["solves"])
        per[key] = dict(
            solves=len(st["solves"]), counts=[x["count"]
                                              for x in st["solves"]],
            solve_s=secs, assembly_s=sum(st["assembly_s"]),
            assemblies=len(st["assembly_s"]),
            ms_per_arnoldi_step=secs / steps * 1e3 if steps else None,
            ms_per_cg_iteration=secs / its * 1e3 if its else None,
            split_ms=st["split_ms"], split_t_ms=st["split_t_ms"])
        print(f"    {key}: {per[key]['solves']} solves, counts "
              f"{per[key]['counts']} ({'GMRES cycles' if gm else 'CG iterations'}"
              f"), {secs:.2f} s of solves ("
              + (f"{per[key]['ms_per_arnoldi_step']:.3f} ms an Arnoldi step"
                 if gm else
                 f"{per[key]['ms_per_cg_iteration']:.3f} ms a CG iteration")
              + f"), {per[key]['assemblies']} Jacobian assemblies "
              f"{per[key]['assembly_s']:.2f} s; split (ms a call): "
              + ", ".join(f"{k} {v:.3f}" for k, v in st["split_ms"].items())
              + "; transpose: " + ", ".join(
                  f"{k} {v:.3f}" for k, v in st["split_t_ms"].items()))
    print(f"    K4/K4T vs plain on every rank's blocks: max abs "
          f"{err['K4']:.3e} / {err['K4T']:.3e}; launches a rank K4 "
          f"{launches['K4']}, K4T {launches['K4T']}; peak "
          f"{max(h['peak_gib'] for h in mh):.2f} GiB a rank")
    return dict(launches=dict(distributed_motor_halo_step=launches),
                err=err, single_s=t_single, step_s=h0["step_s"],
                build_s=h0["build_s"], per_state=per,
                loss=h0["loss"], peak_gib=[h["peak_gib"] for h in mh])


def motor_halo_times():
    """K4 and K4T at rank 0's blocks of the motor halo step (time_element):
    the mesh motion's cell term (6 x 6) and Nitsche facet term (12 x 12),
    EM's cell term (3 x 3), each alone on rank 0's local slots, assembled
    here at dv0 with the states at 0, on the otherwise idle card, without
    a process group."""
    from femo_tpu_torch.models.motor.model import (
        em_vals, mm_vals, motor_problem)
    from femo_tpu_torch.models.motor.pde import source_tables

    cfg = DIST["motor_halo"]
    dev = torch.device(DEVICE)
    mp = motor_problem(cfg["refine"], None, cfg["design_space"], dev)
    zmm = torch.zeros(mp.Vmm.n_dofs, dtype=torch.float64, device=dev)
    Ht, Jt = source_tables(torch.as_tensor(1e5, dtype=torch.float64,
                                           device=dev),
                           torch.zeros((), dtype=torch.float64, device=dev))
    out = []
    for key, cf, wrt, free, vals in (
            ("mesh motion", mp.mm_cf, "uhat", mp.free_mm,
             mm_vals(zmm, {"uhat_bc": mp.to_bc(mp.dv0)})),
            ("EM", mp.em_cf, "A_z", mp.free_em, em_vals(torch.zeros(
                mp.Vem.n_dofs, dtype=torch.float64, device=dev),
                {"uhat": zmm, "Htable": Ht, "Jtable": Jt}))):
        op = HaloShardedOperator.from_terms(
            cf.terms, wrt, cf.form.test.n_dofs,
            RankMesh(None, 0, DIST["ranks"], dev), free=free)
        with torch.no_grad():
            op.set_elements([v.matrix_blocks(vals, "__test__", wrt)[0]
                             * m[:, None, None] for v, m in op.views])
        for b, t in zip(op.local.blocks, cf.terms):
            ne, nr, nc = b.A.shape
            out.append(time_element(
                f"motor halo rank 0 of {DIST['ranks']} (refine "
                f"{cfg['refine']}), {key} {t.domain} term, {ne} {nr}x{nc} "
                "blocks, local slots",
                ElementMatrix([b], op.n_local, op.n_local), 47 + len(out)))
    return out


def halo_step_times(step):
    """K1/K2 at rank 0's block-Jacobi shape (nb, B), on a synthetic factor
    of that shape (time_sweeps), and K4 at rank 0's 27 x 27 element
    blocks (time_element): rank 0's cells of the full-width halo step
    assembled here, on the otherwise idle card, without a process
    group."""
    from femo_tpu_torch.parallel.halo_step import HaloShellCore
    from femo_tpu_torch.models.shell import plate_shell

    r0 = step["ranks"][0]
    fac, bb = synthetic(r0["nb"], r0["B"], torch.float64, 41)
    t_sw = time_sweeps(fac, bb, f"halo step rank 0 block Jacobi (nb="
                       f"{r0['nb']}, B={r0['B']})")
    cfg = DIST["halo_step"]
    shell, bcs = plate_shell(tuple(cfg["n_shell"]), span=cfg["span"],
                             device=DEVICE)
    core = HaloShellCore(shell, shell.make_state(bcs), RankMesh(
        None, 0, DIST["ranks"], torch.device(DEVICE)), cfg["cg_rtol"],
        cfg["cg_maxiter"], 0, "jacobi")
    core.op.set_elements(core.assemble(torch.full(
        (shell.Vt.n_dofs,), 0.01, dtype=torch.float64, device=DEVICE)))
    expect("rank 0's elements", core.op.n_elements, r0["n_elements"])
    t_k4 = time_element(f"halo step rank 0 of {DIST['ranks']} "
                        f"({tuple(cfg['n_shell'])}, 27 x 27 blocks, local "
                        "slots)", core.op.local, 43)
    return t_sw, t_k4


# ---------------------------------------------------------------------------
# run_scripts: the port's run scripts (femo_tpu_torch/examples/) and the
# L-BFGS-B driver on the card, each against the JAX package's run of its
# own script at the same arguments (oracles/examples_oracle.npz, written
# by oracles/examples_oracle.py)
# ---------------------------------------------------------------------------

# K1 and K2 launches per evaluation of run_motor_opt --jit on the card.
# The script's build_motor_jit_step(em_load_steps=3, mm_newton_iters=3,
# em_newton_iters=3, factorization="block_thomas") keeps pcg_iters=8 and
# refactor_every=1: ORACLE_CFG but for design_space ("basis"), which
# changes no solve.  Each Newton iteration (2 mesh-motion load steps x 3,
# 3 EM load steps x 3) and each of the 2 adjoints is one sweep solve, one
# PCG start and 8 PCG iterations, one K1 and one K2 launch each.
JIT_SWEEPS_PER_EVAL = (1 + 1 + 8) * (2 * 3 + 3 * 3 + 2)
# the other scripts, once each, at the arguments of the oracle entries.
# Not the shell thickness script: it has no argument, launches no kernel
# (host Newton with LinearSolver("scipy")), and its first SLSQP iteration
# alone took 39-65 s here, past this phase's time; tests/
# test_torch_examples_shell.py holds that iteration against the JAX run
SCRIPT_KEYS = ("poisson32", "nonlinear_poisson", "topo", "beam",
               "shell_modal", "roof", "aero_static", "aero_dynamic",
               "aero_vpm")


def script_counted(fn):
    """(wall seconds, fn(), launches of every kernel) with all the counts
    set to 0 just before fn and read just after."""
    reset(bt_sweeps.launches)
    reset(spmv.launches)
    t, out = synced(fn)
    return t, out, dict(bt_sweeps.launches, **spmv.launches)


def nonzero(launches):
    return {k: v for k, v in launches.items() if v}


def script_motor_jit(oracle):
    """run_motor_opt --jit --refine 4 --maxiter 3: f64, block Thomas, the
    script's own bounds and scaling.  Launches, every evaluation and the
    final (dv, iq) against the JAX run; per-evaluation wall times."""
    key = "motor_jit_r4"
    argv = config(oracle, key)["argv"]
    t, (res, calls), launches = script_counted(
        lambda: run_example(oracle, key))
    opt = check_optimizer(oracle, key, calls,
                          {"f_first": 1e-8, "f": 1e-7, "g0": 1e-6,
                           "x": 1e-6})
    want = JIT_SWEEPS_PER_EVAL * res["evaluations"]
    print(f"run_motor_opt {' '.join(argv)} (f64, block_thomas, mm/em "
          f"{res['bt']}): {res['evaluations']} evaluations, nit "
          f"{res['nit']}, {t:.2f} s; losses {res['losses']}")
    print(f"  vs JAX: evaluations {opt['nfev']} (equal), first loss rel "
          f"{opt['f_first']:.3e} (bar 1e-8), every loss max rel "
          f"{opt['f']:.3e} (bar 1e-7), first gradient rel {opt['g0']:.3e} "
          f"(bar 1e-6), final x rel {opt['x']:.3e} (bar 1e-6); x* "
          f"{list(res['x'])}")
    print(f"  launches K1 {launches['K1']}, K2 {launches['K2']} (expected "
          f"{JIT_SWEEPS_PER_EVAL} x {res['evaluations']} = {want}); "
          f"evaluation wall s {[round(s, 4) for s in res['seconds']]}, "
          f"warm mean {res['mean_step_ms']:.1f} ms")
    expect("run_motor_opt --jit K1/K2 launches",
           {k: launches[k] for k in ("K1", "K2")}, {"K1": want, "K2": want})
    return dict(launches=launches, seconds=t, evals=res["evaluations"],
                eval_s=res["seconds"], warm_ms=res["mean_step_ms"],
                errors=opt)


def script_w1_lbfgsb(oracle):
    """W1 at nel=260 through build_fea -> FEAModel -> Simulator ->
    OptimizationProblem -> LBFGSB(maxiter=5): K4/K4T launches against the
    BiCGStab iterations, every evaluation and the final controls against
    the JAX run, the wall time of each evaluation."""
    key = "w1_lbfgsb_nel260"
    c = config(oracle, key)
    sim, fea, d = w1_model(c["nel"], "cuda")
    sim.run()
    prob = OptimizationProblem(sim, "poisson_lbfgsb")
    times, obj_grad = [], prob.objective_and_grad

    def timed(x):  # float(value) inside waits for the card
        t0 = time.perf_counter()
        out = obj_grad(x)
        times.append(time.perf_counter() - t0)
        return out

    prob.objective_and_grad = timed
    with krylov_log() as log, minimize_log() as calls:
        t, res, launches = script_counted(
            lambda: LBFGSB(prob, maxiter=c["maxiter"]).solve())
        solves = log.take()
    want = matvecs(solves)
    opt = check_optimizer(oracle, key, calls, {"f": 1e-8, "x": 1e-6})
    print(f"W1 LBFGSB(maxiter={c['maxiter']}) at nel={c['nel']} "
          f"({d['W'].n_dofs} controls), f64: {opt['nfev']} evaluations "
          f"(JAX the same), nit {res.nit}, {t:.2f} s; objectives "
          f"{calls[0]['f']}")
    print(f"  vs JAX: every objective max rel {opt['f']:.3e} (bar 1e-8), "
          f"final controls rel {opt['x']:.3e} (bar 1e-6); BiCGStab "
          f"iterations {[(s[0], s[2]) for s in solves]}; launches K4 "
          f"{launches['K4']} K4T {launches['K4T']} (expected {want['K4']} "
          f"and {want['K4T']}); evaluation wall s "
          f"{[round(x, 4) for x in times]}")
    if not (launches["K4"] == want["K4"] > 0
            and launches["K4T"] == want["K4T"] > 0):
        raise AssertionError(f"W1 LBFGSB launches {launches}, want {want}")
    return dict(launches=launches, seconds=t, evals=opt["nfev"],
                eval_s=times, errors=opt)


def script_motor_snopt(oracle):
    """run_motor_opt --refine 1 --driver snopt --maxiter 1: SNOPT warns
    (no binding) and runs SLSQP; its whole path (evaluations, every
    objective 1e-7, the first gradient, the final design 1e-6) and the
    final loss_sum (1e-7) against the JAX run."""
    key = "motor_snopt_r1"
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        t, (res, calls), launches = script_counted(
            lambda: run_example(oracle, key))
    if not any("SNOPT binding not available" in str(x.message) for x in w):
        raise AssertionError("SNOPT did not warn of its missing binding")
    errs = check_example(oracle, key, res, calls)
    print(f"run_motor_opt {' '.join(config(oracle, key)['argv'])}: SNOPT "
          f"warned and ran SLSQP; {res['nit']} iterations, {t:.2f} s; "
          f"loss_sum {res['initial_loss_sum']!r} -> {res['loss_sum']!r}, "
          f"shape_dv {list(res['shape_dv'])}, iq {res['iq']!r}; launches "
          f"{nonzero(launches)}")
    print(f"  vs JAX: {errs['nfev']} evaluations (equal), every objective "
          f"max rel {errs['f']:.3e} (bar 1e-7), first gradient rel "
          f"{errs['g0']:.3e} (bar 1e-6), final x rel {errs['x']:.3e} (bar "
          f"1e-6), loss_sum rel {errs['loss_sum']:.3e} (bar 1e-7), shape_dv "
          f"{errs['shape_dv']:.3e}, iq {errs['iq']:.3e} (bars 1e-6)")
    return dict(launches=launches, seconds=t, errors=errs)


def phase_run_scripts():
    """The L-BFGS-B motor run at refine 4, W1 through LBFGSB at nel=260,
    the eager motor script through SNOPT's fallback, then every other
    script once; the launches of every kernel are counted from 0 around
    each run."""
    oracle = load_oracle()
    out = {"motor_jit_r4": script_motor_jit(oracle),
           "w1_lbfgsb": script_w1_lbfgsb(oracle),
           "motor_snopt_r1": script_motor_snopt(oracle)}
    for key in SCRIPT_KEYS:
        t, (res, calls), launches = script_counted(
            lambda key=key: run_example(oracle, key))
        errs = check_example(oracle, key, res, calls)
        print(f"{config(oracle, key)['script']} "
              f"{' '.join(config(oracle, key)['argv'])}: {t:.2f} s; vs "
              f"JAX {json.dumps(errs)}; launches {nonzero(launches)}")
        out[key] = dict(launches=launches, seconds=t, errors=errs)
    return out


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
                max_abs_err=t.get("max_abs_err", {}).get(k),
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


# Phases run beside the main sequence, each group in a process of its own
# started right after the build (`python3 chip_smoke.py --side NAME OUT`):
# the two FSI groups are the longest and share nothing with the rest, so
# running them beside it keeps the whole script inside its time limit
# with no path dropped.  The main sequence waits for them before the
# distributed phase, whose gloo collectives would feel the load.  Times
# taken while groups run beside each other share the card and the host
# cores with them (PERF.md §6).
SIDE_THREADS = "3"  # intra-op and BLAS threads of each side process
SIDE_LIMIT = 1000.0  # seconds from their start to the end of the last


def side_fsi():
    """Phases 23 and 24 (fsi, fsi_small)."""
    seconds, err = {}, {"K1": 0.0, "K2": 0.0}
    fsi, t_fsi, t_fm, k4_err, t_fsi32 = timed_phase(
        "fsi", seconds, phase_fsi, err)
    fsi_small = timed_phase("fsi_small", seconds, phase_fsi_small)
    print("fsi summary: " + json.dumps(dict(fsi, small=fsi_small)))
    return dict(seconds=seconds, err=err, fsi=fsi, fsi_small=fsi_small,
                t_fsi=t_fsi, t_fm=t_fm, k4_err=k4_err, t_fsi32=t_fsi32)


def side_fsi_dynamic():
    """Phase 25 (fsi_dynamic)."""
    seconds, err = {}, {"K1": 0.0, "K2": 0.0}
    dyn, t_dyn, t_dyn_fm, k4_err, t_dyn32 = timed_phase(
        "fsi_dynamic", seconds, phase_fsi_dynamic, err)
    print("fsi dynamic summary: " + json.dumps(dyn))
    return dict(seconds=seconds, err=err, dyn=dyn, t_dyn=t_dyn,
                t_dyn_fm=t_dyn_fm, k4_err=k4_err, t_dyn32=t_dyn32)


SIDES = {"fsi": side_fsi, "fsi_dynamic": side_fsi_dynamic}


def side_main(name, out):
    """A side process: load the kernels the main process built, run the
    group `name` and write what it returns to `out` as JSON.  Any failure
    raises, and the process exits non-zero."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    torch.set_num_threads(int(SIDE_THREADS))
    femo_tpu_torch.set_precision("float64")
    for m in (native, bt_sweeps, spmv):
        m.get_lib()
    res = SIDES[name]()
    with open(out, "w") as fh:
        json.dump(res, fh)


class Sides:
    """The side processes: started together, their output sent to files
    in a fresh temporary directory; `join` waits for them (within
    `limit` seconds of the start), prints each one's output and returns
    their results, raising if one failed or ran out of time; on leaving
    the block every one still running is killed and its output
    printed."""

    def __init__(self, limit):
        self.limit = limit

    def __enter__(self):
        self.dir = tempfile.TemporaryDirectory()
        env = dict(os.environ, OMP_NUM_THREADS=SIDE_THREADS,
                   MKL_NUM_THREADS=SIDE_THREADS,
                   OPENBLAS_NUM_THREADS=SIDE_THREADS)
        self.t0 = time.perf_counter()
        self.procs = {}
        for name in SIDES:
            log = open(os.path.join(self.dir.name, f"{name}.log"), "w")
            out = os.path.join(self.dir.name, f"{name}.json")
            self.procs[name] = (subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--side", name,
                 out], stdout=log, stderr=subprocess.STDOUT, env=env), log,
                out)
        print(f"started beside the main sequence: {', '.join(SIDES)}")
        return self

    def join(self):
        results, failed = {}, []
        for name, (proc, _, out) in list(self.procs.items()):
            left = self.limit - (time.perf_counter() - self.t0)
            try:
                rc = proc.wait(timeout=max(left, 1.0))
            except subprocess.TimeoutExpired:
                rc = None
            self.report(name)
            if rc is None:
                failed.append(f"{name} (out of time)")
            elif rc != 0:
                failed.append(f"{name} (exit {rc})")
            else:
                with open(out) as fh:
                    results[name] = json.load(fh)
        if failed:
            raise RuntimeError(f"side processes failed: {failed}")
        return results

    def report(self, name):
        """Kill side `name` if it still runs, print its output and forget
        it."""
        proc, log, _ = self.procs.pop(name)
        state = f"exit {proc.poll()}"
        if proc.poll() is None:
            proc.kill()
            proc.wait()
            state = "killed"
        log.close()
        with open(log.name) as fh:
            text = fh.read()
        print(f"--- side {name}: {state}, "
              f"{time.perf_counter() - self.t0:.1f} s after the start")
        print(text, end="" if text.endswith("\n") else "\n")
        print(f"--- end of side {name}")

    def __exit__(self, *exc):
        for name in list(self.procs):
            self.report(name)
        self.dir.cleanup()


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--side"]:
        return side_main(*argv[1:])
    t_start = time.perf_counter()
    seconds = {}
    femo_tpu_torch.set_precision("float64")
    card = timed_phase("device", seconds, phase_device)
    timed_phase("build", seconds, phase_build)
    with Sides(SIDE_LIMIT) as sides:
        return main_sequence(t_start, seconds, card, sides)


def main_sequence(t_start, seconds, card, sides):
    # the run scripts need only the build
    scripts = timed_phase("run_scripts", seconds, phase_run_scripts)
    print("run scripts summary: " + json.dumps(scripts))
    # every run of the phase, its launches counted from 0 around it
    script_paths = {(k if k == "w1_lbfgsb" else f"script_{k}"): v["launches"]
                    for k, v in scripts.items()}
    step1, (dv0, iq0), info1 = build_motor_jit_step(refine=1, device="cuda",
                                                    **ORACLE_CFG)
    t, err = timed_phase("kernels", seconds, phase_kernels, info1, dv0, iq0)
    launches, warm1 = timed_phase("refine1", seconds, phase_refine1, step1,
                                  dv0, iq0, info1)
    t4, warm4, info4, dv4 = timed_phase("refine4", seconds, phase_refine4,
                                        err)
    r4cr = timed_phase("refine4_cr", seconds, phase_refine4_cr)
    t_spmv, err_spmv, selftest = timed_phase("spmv", seconds, phase_spmv)
    w1_launches, _ = timed_phase("w1", seconds, phase_w1)
    timed_phase("w1_slsqp", seconds, phase_w1_slsqp)
    timed_phase("w1_card_vs_cpu", seconds, phase_w1_card_vs_cpu)
    det = timed_phase("determinism", seconds, phase_determinism, info4,
                      dv4)
    del info4
    paths = {"refine1_oracle": launches, "refine4_cr": r4cr["launches"]}
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
    jit_ref = slice_c["jit_step"].pop("ref")
    print("slice C summary: " + json.dumps(slice_c))
    shell, t_shell = timed_phase("shell", seconds, phase_shell, err)
    modal = timed_phase("shell_modal", seconds, phase_shell_modal)
    module = timed_phase("shell_module", seconds, phase_shell_module, err)
    print("shell summary: " + json.dumps(dict(shell, modal=modal,
                                              module=module)))
    for key in ("a", "b"):
        paths[f"shell_{key}"] = shell[key]["launches"]
    paths["shell_modal"] = modal["launches"]
    paths["shell_module"] = module["launches"]
    facets = timed_phase("facets_3d", seconds, phase_facets_3d)
    print("3D facets summary: " + json.dumps(facets))
    side = timed_phase("sides", seconds, sides.join)
    for r in side.values():
        seconds.update(r["seconds"])
        for k in ("K1", "K2"):
            err[k] = max(err[k], r["err"][k])
    s_fsi, s_dyn = side["fsi"], side["fsi_dynamic"]
    fsi, fsi_small, dyn = s_fsi["fsi"], s_fsi["fsi_small"], s_dyn["dyn"]
    t_fsi, t_fm, k4_fsi_err, t_fsi32 = (
        s_fsi[k] for k in ("t_fsi", "t_fm", "k4_err", "t_fsi32"))
    t_dyn, t_dyn_fm, k4_dyn_err, t_dyn32 = (
        s_dyn[k] for k in ("t_dyn", "t_dyn_fm", "k4_err", "t_dyn32"))
    # last, alone: the ranks' gloo collectives are host-bound
    dist = timed_phase("distributed", seconds, phase_distributed, jit_ref)
    print("distributed summary: " + json.dumps(
        {k: v for k, v in dist.items()
         if k not in ("k4_times", "k4_step_times", "sweep_times",
                      "motor_times")}))
    for k in ("K1", "K2"):
        err[k] = max(err[k], dist["sweep_err"][k])
    # mode b inside the steps, launches by rank: path -> kernel -> list
    step_by_rank = dist["step_launches"]
    fsi_paths = {"fsi_anchor": fsi["launches"],
                 "fsi_anchor_f64": fsi["anchor_f64"]["launches"],
                 "fsi_anchor_cr": fsi["anchor_cr"]["launches"],
                 **{f"fsi_{k}": fsi[k]["launches"]
                    for k in ("mid", "mid_f64", "rung", "rung_f64",
                              "rung_cr_f64")},
                 "fsi_small": fsi_small["launches"],
                 # W8 at the 77k rung (run_with_grad, f32 and f64 factor
                 # storage) and W9 there
                 "fsi_dynamic": dyn["rung"]["launches"],
                 "fsi_dynamic_f64": dyn["rung_f64"]["launches"],
                 # W8 with cyclic reduction and with the f32 factor
                 "fsi_dynamic_cr": dyn["rung_cr"]["launches"],
                 "fsi_dynamic_f32c": dyn["rung_f32c"]["launches"],
                 "fsi_dynamic_span600_f32c":
                     dyn["span600_f32c"]["launches"],
                 "fsi_w9": dyn["w9"]["launches"]}
    paths.update(fsi_paths)
    paths.update(script_paths)
    paths.update({"fsi_dynamic_run": dyn["rung"]["run_launches"],
                  **{f"fsi_dynamic_{k}": v["launches"]
                     for k, v in dyn["eager"].items()}})
    print(f"kernels vs plain on the steps' factors (refine 1 and 4, "
          f"unstructured, W1 weak, shell, FSI anchor): max |kernel - "
          f"plain| K1 "
          f"{err['K1']:.3e}, K2 {err['K2']:.3e}")
    # K4/K4T: max_abs_err over the nel=260 W1 operator, the Jacobians of
    # W1 weak, W2 and W4 and FSI's Fm, both designs
    for k in ("K4", "K4T"):
        err_spmv[k] = max([err_spmv[k], k4_fsi_err[k], k4_dyn_err[k]]
                          + [slice_c[p]["err"][k] for p in
                             ("w1_weak", "w2", "topopt")])
    err_spmv["K4"] = max(err_spmv["K4"], dist["k4_err"])
    for k in ("K4", "K4T"):
        err_spmv[k] = max(err_spmv[k], dist["motor_halo"]["err"][k])
    print("motor summary: " + json.dumps({
        "refine4_cr": r4cr,
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
        shapes=[sweep_shape(k, ts)
                for ts in [t] + t4 + [t_weak] + t_shell
                + [t_fsi, t_dyn, t_dyn32, t_fsi32, dist["sweep_times"]]],
        launches_by_path=dict({p: n[k] for p, n in paths.items()},
                              w1_weak=slice_c["w1_weak"]["launches"][k],
                              **{p: sum(v[k]) for p, v in
                                 step_by_rank.items()}),
        distributed_launches_by_rank={p: v[k] for p, v in
                                      step_by_rank.items()})
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
    # K4T: the FSI adjoint's Fm^T products; K4/K4T's times at each shape
    # (W1, W4, Fm), both designs: the top-level numbers are W1's
    rows[4]["launches_by_path"].update(
        {p: n["K4T"] for p, n in fsi_paths.items()})
    # K4/K4T on the run scripts' paths that launched them (W1 LBFGSB)
    for row, k in ((rows[3], "K4"), (rows[4], "K4T")):
        row["launches_by_path"].update(
            {p: n[k] for p, n in script_paths.items() if n[k]})
    # K4 in each rank of the distributed halo CG: the launches of each
    # rank's cold CG, counted from 0 just before it in that rank
    rows[3]["launches_by_path"]["distributed_halo_cg"] = dist["launches"]
    rows[3]["distributed_launches_by_rank"] = dist["launches_by_rank"]
    # K4 (and K1/K2 above) in each rank of mode b inside the steps: the
    # full-width shell halo step's two solves, the dryrun's shell and FSI
    # halo steps, the (3, 4) jacobi and Chebyshev steps
    rows[3]["launches_by_path"].update(
        {p: sum(v["K4"]) for p, v in step_by_rank.items()})
    rows[3]["distributed_step_launches_by_rank"] = {
        p: v["K4"] for p, v in step_by_rank.items()}
    # K4 and K4T in each rank of mode b inside the motor step: every
    # GMRES and CG product of both states, the adjoints' K4T
    for row, k in ((rows[3], "K4"), (rows[4], "K4T")):
        for p, v in dist["motor_launches"].items():
            row["launches_by_path"][p] = sum(v[k])
            row.setdefault("distributed_step_launches_by_rank", {})[p] = v[k]
    k4_shapes = t_spmv["K4_shapes"] + [slice_c["topopt"]["k4_times"], t_fm,
                                       t_dyn_fm, dist["k4_times"],
                                       dist["k4_step_times"]] + \
        dist["motor_times"]
    for row, k in ((rows[3], "K4"), (rows[4], "K4T")):
        row.update(design=t_spmv[k]["design"],
                   burst_ms=t_spmv[k]["burst_ms"], share=t_spmv[k]["share"],
                   shapes=[shape_row(ts, k) for ts in k4_shapes])
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
    print(f"phase seconds (fsi, fsi_small and fsi_dynamic beside the main "
          f"sequence, from the build to `sides`): {json.dumps(seconds)}; "
          f"{time.perf_counter() - t_start:.1f} s in all")
    print(card)  # again near the end, where a cut output still shows it
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
