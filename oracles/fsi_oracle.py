"""The JAX package's f64 reference values for the W7 static aeroelastic
FSI, at the sizes tests/test_torch_fsi.py and chip_smoke.py drive the
PyTorch/CUDA port at.

    JAX_PLATFORMS=cpu PYTHONPATH=. python oracles/fsi_oracle.py [entry ...]

Runs femo_tpu on the CPU in f64 and writes oracles/fsi_oracle.npz.  Each
entry is stored beside the configuration it was computed for
(`<key>_config`, a JSON string), which the tests and chip_smoke.py check
before they compare.  Named entries are recomputed and the others of the
file kept; the seconds of each entry are stored under `seconds`, and the
process's peak resident memory after it under `peak_rss_gib` (run an
entry alone to read its own).

* wing_jit_dense, wing_jit_bt, wing_eager: `build_wing_fsi` at n_shell=
  (4, 6), n_vlm=(2, 4) in each solve mode, `solve(t, tol, maxiter,
  relax)` with a tolerance no pass reaches, so both packages stop after
  `maxiter` passes: the tip, the two force totals, the lattice
  displacement; in the jit modes also the IFT gradient of the tip with
  respect to the thickness (through `fixed_point_solve_jit`, its adjoint
  stopping after `maxiter` passes as well).
* jit_*: `build_fsi_jit_step(...)["solve_with_grad"](t0, rounds)` at the
  same size: the tip, the totals, the compliance, the objective,
  rel_delta, adj_delta and the thickness gradient, for the tip objective
  with f64 and f32 factor storage, the compliance objective, Aitken
  relaxation and PCG to a tolerance; each `jit_X` has a `jit_X_mixed`
  beside it (the same path with the JAX package's mixed-precision
  Newton-Schulz block inverses): two correct solves of one iteration,
  whose distance is the JAX package's own spread.  jit_cr_f64 and
  jit_cr_f32 are jit_f64 and jit_f32 with block cyclic reduction
  (`factor_method="cr"`); jit_f32c is the equilibrated f32 factor
  (`factor_compute_dtype="float32"`) at thickness 0.05 with 8 PCG
  iterations, the regime the JAX package validates it in (at thickness
  0.01 its f32 factor plateaus), and jit_f32c_f64 the same with the f64
  factor, the JAX package's own spread beside it.
* small, small_f64, small_mixed: bench_scale.py's small rung, (16, 24) /
  (4, 8), span 4, thickness 0.01, in the anchor's solver configuration
  (gs_inner 4, f32 factor storage, PCG to 1e-7 with at most 10
  iterations, 5 rounds, 24 adjoint passes), and the same with f64
  storage and with the mixed inverses: the JAX package's own spread.
* mid, mid_f64: (4, 6720) / (4, 32), span 30, thickness 0.05 (53,760
  cells, 463,722 dofs, nb=3623), the anchor's wing at half its spanwise
  resolution, in the anchor's solver configuration and with f64
  storage.
* anchor_f64: the anchor itself, (4, 13440) / (4, 32) (107,520 cells,
  927,402 dofs, nb=7246), in the anchor's solver configuration with f64
  factor storage (~8 GiB and several minutes on the CPU host).
* rung, rung_f64, rung_mixed: the same wing at (4, 1680) (13,440 cells),
  chunked as the anchor is (assembly_chunk 4096), three ways;
  rung_cr_f64: rung_f64 with block cyclic reduction
  (`factor_method="cr"`);
  rung_residual: its composite residual at a seeded random state and
  force (seed 3, scale 1e-3), the operator without a solve.

The anchor has only its f64-storage entry: with f32 factor storage ten
PCG iterations do not converge on this wing (the gradient is not
meaningful there, see mid).  The state x is not stored.

    JAX_PLATFORMS=cpu PYTHONPATH=. python oracles/fsi_oracle.py \
        --element-matrices mid OUT.npz

writes instead the composite Jacobian's element blocks of a
configuration at its fill point (u = 0 with the BCs applied, thickness
t0, zero force), the matrices the block-Thomas operator is summed from,
to OUT.npz (A0, rows0, cols0, A1, ...; 0.3 GB at (4, 6720), too large
for the oracle file): `python -m femo_tpu_torch.tools.fsi_conditioning
--jax-elements OUT.npz` assembles and solves the port's operator from
them.
"""

import json
import os
import resource
import sys
import time

import numpy as np
import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

from femo_tpu.models.fsi import (  # noqa: E402
    build_fsi_jit_step, build_wing_fsi)

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "fsi_oracle.npz")
SMALL = dict(n_shell=[4, 6], n_vlm=[2, 4], span=4.0, chord=1.0)
WING = dict(SMALL, tol=1e-12, maxiter=2, relax=0.7)
JIT = dict(SMALL, gs_inner=4, relax=0.7, adj_passes=12, rounds=3)
JIT_PATHS = {
    "f64": dict(factor_store_dtype=None, pcg_iters=2),
    "f32": dict(factor_store_dtype="float32", pcg_iters=4),
    "compliance": dict(factor_store_dtype=None, pcg_iters=2,
                       objective="compliance"),
    "aitken": dict(factor_store_dtype=None, pcg_iters=2, accel="aitken"),
    "rtol": dict(factor_store_dtype="float32", pcg_rtol=1e-7,
                 pcg_maxiter=10),
}
ANCHOR_SOLVER = dict(gs_inner=4, factor_store_dtype="float32",
                     pcg_rtol=1e-7, pcg_maxiter=10, rounds=5)
CONFIGS = {
    **{f"wing_{m}": dict(WING, solve_mode=m)
       for m in ("jit_dense", "jit_bt", "eager")},
    **{f"jit_{k}": dict(JIT, **kw) for k, kw in JIT_PATHS.items()},
    **{f"jit_{k}_mixed": dict(JIT, **kw, factor_compute_dtype="mixed")
       for k, kw in JIT_PATHS.items()},
    "small": dict(n_shell=[16, 24], n_vlm=[4, 8], span=4.0,
                  thickness=0.01, **ANCHOR_SOLVER),
    "mid": dict(n_shell=[4, 6720], n_vlm=[4, 32], span=30.0,
                thickness=0.05, **ANCHOR_SOLVER),
}
CONFIGS["small_mixed"] = dict(CONFIGS["small"], factor_compute_dtype="mixed")
CONFIGS["mid_f64"] = dict(CONFIGS["mid"], factor_store_dtype=None)
CONFIGS["small_f64"] = dict(CONFIGS["small"], factor_store_dtype=None)
CONFIGS["anchor_f64"] = dict(CONFIGS["mid_f64"], n_shell=[4, 13440])
RUNG = dict(n_shell=[4, 1680], n_vlm=[4, 32], span=30.0, thickness=0.05,
            assembly_chunk=4096)
CONFIGS["rung"] = dict(RUNG, **ANCHOR_SOLVER)
CONFIGS["rung_f64"] = dict(CONFIGS["rung"], factor_store_dtype=None)
CONFIGS["rung_mixed"] = dict(CONFIGS["rung"], factor_compute_dtype="mixed")
CONFIGS["rung_residual"] = dict(RUNG, seed=3, scale=1e-3)
CONFIGS["rung_cr_f64"] = dict(CONFIGS["rung_f64"], factor_method="cr")
CONFIGS["jit_cr_f64"] = dict(CONFIGS["jit_f64"], factor_method="cr")
CONFIGS["jit_cr_f32"] = dict(CONFIGS["jit_f32"], factor_method="cr")
CONFIGS["jit_f32c"] = dict(JIT, thickness=0.05, factor_store_dtype=None,
                           factor_compute_dtype="float32", pcg_iters=8)
CONFIGS["jit_f32c_f64"] = dict(JIT, thickness=0.05, factor_store_dtype=None,
                               pcg_iters=8)


def _np(a):
    return np.asarray(a, np.float64)


def _kw(c, drop=()):
    return {k: (tuple(v) if isinstance(v, list) else v)
            for k, v in c.items() if k not in drop}


def wing(key, c):
    fsi = build_wing_fsi(**_kw(c, ("tol", "maxiter", "relax")))
    t0 = fsi["shell"].thickness.array
    run = dict(tol=c["tol"], maxiter=c["maxiter"], relax=c["relax"])
    out = fsi["solve"](t0, **run)
    vals = {f"{key}_tip": float(out["tip_disp"]),
            f"{key}_aero": _np(out["total_aero_force"]),
            f"{key}_mapped": _np(out["total_mapped_force"]),
            f"{key}_disp": _np(out["disp_fluid"])}
    if c["solve_mode"] != "eager":
        vals[f"{key}_grad"] = _np(jax.grad(
            lambda t: fsi["solve"](t, **run)["tip_disp"])(t0))
    return vals


def jit_step(key, c):
    fsi = build_fsi_jit_step(**_kw(c, ("rounds",)))
    out = fsi["solve_with_grad"](fsi["t0"], rounds=c["rounds"])
    return {f"{key}_tip": float(out["tip_disp"]),
            f"{key}_aero": _np(out["total_aero_force"]),
            f"{key}_mapped": _np(out["total_mapped_force"]),
            f"{key}_compliance": float(out["compliance"]),
            f"{key}_objective": float(out["objective"]),
            f"{key}_rel_delta": float(out["rel_delta"]),
            f"{key}_adj_delta": float(out["adj_delta"]),
            f"{key}_grad": _np(out["grad_thickness"]),
            f"{key}_n_dofs": int(fsi["n_dofs"]),
            f"{key}_nb": int(fsi["tpl"].nb), f"{key}_B": int(fsi["tpl"].B)}


def rung_residual(key, c):
    """The composite residual at a seeded random state and force, the
    operator without a solve."""
    fsi = build_fsi_jit_step(**_kw(c, ("seed", "scale")))
    rng = np.random.default_rng(c["seed"])
    x = c["scale"] * rng.standard_normal(fsi["n_dofs"])
    f = rng.standard_normal(fsi["shell"].Vf.n_dofs)
    p = dict(fsi["consts"], thickness=fsi["t0"], force=jnp.asarray(f))
    return {f"{key}_r": _np(fsi["residual"](jnp.asarray(x), p))}


def element_matrices(key, path):
    """CONFIGS[key]'s composite element blocks at the fill point of
    build_fsi_jit_step (its `jac_blocks` at u = apply_bc(0), thickness t0,
    zero force; each A as (ne, nr, nc)), written to `path`."""
    from femo_tpu.fea.bc import apply_bc

    c = CONFIGS[key]
    fsi = build_fsi_jit_step(**_kw(c, ("rounds",)))
    state, shell, consts = fsi["state"], fsi["shell"], fsi["consts"]
    off_th = shell.Vu.n_dofs
    u0 = apply_bc(jnp.zeros(fsi["n_dofs"]), state.free, state.bc_values)
    vals = {"u": u0[:off_th], "theta": u0[off_th:], "thickness": fsi["t0"],
            "force": jnp.zeros(shell.Vf.n_dofs)}
    chunk = c.get("assembly_chunk",
                  8192 if fsi["n_cells"] > 30000 else None)
    out = {}
    for cf, data, roff in ((fsi["ucf"], "__data_u__", 0),
                           (fsi["tcf"], "__data_th__", off_th)):
        for cname, coff in (("u", 0), ("theta", off_th)):
            for A, rows, cols in cf.matrix_blocks_from_data(
                    vals, cname, consts[data], chunk=chunk):
                i = len(out) // 3
                rows, cols = np.asarray(rows), np.asarray(cols)
                out[f"A{i}"] = _np(A).reshape(len(rows), rows.shape[1],
                                              cols.shape[1])
                out[f"rows{i}"], out[f"cols{i}"] = rows + roff, cols + coff
    np.savez(path, config=json.dumps(c, sort_keys=True), **out)
    print(f"wrote {path}: {len(out) // 3} blocks, "
          f"{sum(v.nbytes for v in out.values()) / 1e9:.2f} GB")


def main(keys):
    unknown = set(keys) - set(CONFIGS)
    if unknown:
        raise SystemExit(f"unknown entries {sorted(unknown)}; known: "
                         f"{list(CONFIGS)}")
    out, seconds, peak = {}, {}, {}
    if os.path.exists(OUT):
        with np.load(OUT) as old:
            out = {k: old[k] for k in old.files}
        seconds = json.loads(str(out.pop("seconds", "{}")))
        peak = json.loads(str(out.pop("peak_rss_gib", "{}")))
    t_all = time.time()
    for key in keys:
        t0 = time.time()
        fn = (wing if key.startswith("wing_") else
              rung_residual if key == "rung_residual" else jit_step)
        vals = fn(key, CONFIGS[key])
        seconds[key] = time.time() - t0
        # the process's peak resident memory so far (Linux: KiB)
        peak[key] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
        out.update(vals)
        out[f"{key}_config"] = json.dumps(CONFIGS[key], sort_keys=True)
        shown = {k: (v if np.ndim(v) == 0 else
                     f"|{np.linalg.norm(v)!r}| ({np.size(v)})"
                     if np.size(v) > 8 else list(np.asarray(v)))
                 for k, v in vals.items()}
        print(f"{key} ({seconds[key]:.1f} s, peak {peak[key]:.2f} GiB): "
              f"{shown}", flush=True)
        # written after every entry: a long run keeps what it finished
        np.savez_compressed(OUT, **out, seconds=json.dumps(seconds),
                            peak_rss_gib=json.dumps(peak))
    print(f"wrote {OUT} ({os.path.getsize(OUT) / 1e6:.2f} MB) in "
          f"{time.time() - t_all:.1f} s")


if __name__ == "__main__":
    if sys.argv[1:2] == ["--element-matrices"]:
        element_matrices(*sys.argv[2:4])
    else:
        main(sys.argv[1:] or list(CONFIGS))
