"""Parity bars of the shell against the JAX package's values recorded in
oracles/shell_oracle.npz (written by oracles/shell_oracle.py): the
compliance-step paths of tests/test_shell_step_paths.py and the spread of
the JAX package's own paths of one kind, and ShellModule's bar per
output.  Read by tests/test_torch_shell*.py and chip_smoke.py; numpy
only.

Thin-shell conditioning (equilibrated cond ~6.6e7) lets two correct f64
solves of this system differ by ~1e-8 whatever the implementation, the
JAX package's own paths among themselves included, so each value is held
within 10 times the JAX package's spread between its paths of the same
kind: PCG-polished, direct, or with f32 factor storage.
"""

from __future__ import annotations

import itertools

import numpy as np

STEP_PATHS = {  # tests/test_shell_step_paths.py, baseline first
    "base": {},
    "reuse": dict(adjoint="reuse_symmetric", pcg_iters=2),
    "split": dict(split_programs=True, pcg_iters=2),
    "split_f32": dict(split_programs=True, pcg_iters=4,
                      factor_store_dtype="float32"),
    "jacobi": dict(jacobi_scale=True, pcg_iters=2),
    "dense": dict(solve_mode="jit_dense"),
    "mixed_f32": dict(split_programs=True, pcg_iters=4,
                      factor_compute_dtype="mixed",
                      factor_store_dtype="float32"),
    "mixed": dict(split_programs=True, pcg_iters=2,
                  factor_compute_dtype="mixed"),
}
# ShellModule outputs held at least to f64 rounding (mass is exact; the
# objective values agree to ~1e-14 in both packages' two solvers)
ROUNDING = 1e-12


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def path_kind(kw):
    """'f32' (f32 factor storage), 'pcg' (f64, PCG-polished) or 'direct'
    (f64, no polish: the fused step without PCG and the dense LU)."""
    if kw.get("factor_store_dtype") == "float32":
        return "f32"
    return "pcg" if kw.get("pcg_iters", 0) > 0 else "direct"


def step_spread(oracle, kind):
    """(J, gradient) spread of the JAX package's (6, 8) step paths of
    `kind`: the largest relative distance of J, and of the gradient
    (relative L2), between two of them."""
    names = [k for k, kw in STEP_PATHS.items() if path_kind(kw) == kind]
    J = {k: float(oracle[f"step_{k}_J"]) for k in names}
    g = {k: oracle[f"step_{k}_grad"] for k in names}
    pairs = list(itertools.combinations(names, 2))
    return (max(abs(J[a] - J[b]) / abs(J[b]) for a, b in pairs),
            max(rel_l2(g[a], g[b]) for a, b in pairs))


def module_bars(oracle, prefix, keys):
    """ShellModule's bar per output or gradient `key` (relative L2): 10
    times the JAX package's own spread between its jit_bt module
    (`{prefix}_{key}`) and its jit_dense one (`{prefix}_dense_{key}`), at
    least ROUNDING."""
    return {k: max(ROUNDING, 10 * rel_l2(oracle[f"{prefix}_{k}"],
                                         oracle[f"{prefix}_dense_{k}"]))
            for k in keys}
