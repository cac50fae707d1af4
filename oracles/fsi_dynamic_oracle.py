"""The JAX package's f64 reference values for the W8 dynamic aeroelastic
FSI and the W9 external-load regime, at the sizes
tests/test_torch_fsi_dynamic.py and chip_smoke.py drive the PyTorch/CUDA
port at.

    JAX_PLATFORMS=cpu PYTHONPATH=. python oracles/fsi_dynamic_oracle.py \
        [entry ...]

Runs femo_tpu on the CPU in f64 and writes oracles/fsi_dynamic_oracle.npz.
Each entry is stored beside the configuration it was computed for
(`<key>_config`, a JSON string), which the tests and chip_smoke.py check
before they compare.  Named entries are recomputed and the others of the
file kept; the seconds of each entry are stored under `seconds`, and the
process's peak resident memory after it under `peak_rss_gib` (run an
entry alone to read its own).

* eager, eager_gust: `DynamicShellFSI(build_wing_fsi(n_shell=(4, 6),
  n_vlm=(2, 4)), dt=0.01, fsi_iters=6).run(3)`, the tip history; the
  second with the 1-cosine gust starting at t = 0 (t0 0, duration 0.03),
  so that it acts from the first step.
* jit, jit_gust, jit_mixed: `build_dynamic_fsi_jit_step` at that size
  (f64 factor storage, no PCG polish, fsi_iters 8, adj_passes 10), three
  steps of `run_with_grad`: the tips, J, the thickness gradient and the
  adjoint's per-step increments; jit_mixed is jit with the JAX package's
  mixed-precision block inverses, its own spread; jit_cr is jit with
  block cyclic reduction (`factor_method="cr"`), and jit_f32c the
  equilibrated f32 factor (`factor_compute_dtype="float32"`) with 4 PCG
  iterations (an f32 factor needs the f64 polish).
* w9: the external-load build at (6, 10) / (2, 4), pcg_iters 8, f64
  factor storage, under a seeded load series (seed 3, lift 40), four
  steps of `run_with_grad`: also the load gradient; w9_mixed the same
  with the mixed-precision block inverses.
* rung_f64, rung: W8 at bench_scale.py's 77k rung, (4, 9600) / (4, 24),
  span 21, thickness 0.05 (76,800 cells, 662,442 dofs), dt 0.01,
  fsi_iters 2, pcg_iters 4, twelve steps of `run_with_grad` (the gust
  starts at t = 0.1 and acts in steps 11 and 12), with f64 and f32 factor
  storage.
* span600_f64: rung_f64's wing and solver at 600 spanwise cells (4,800
  cells), where the equilibrated f32 factor is still an admissible
  preconditioner (at 4,800 spanwise cells the JAX package's own f32
  factor leaves ||A M b - b|| / ||b|| = 78 and its tips O(1) off).
* w9_rung_f64: W9 on that wing with f64 storage, twelve steps, under the
  synthetic restart series (`synthetic_restart`: 24 samples over
  n_steps * dt, seed 0) read back through `aero_forces_from_file` at the
  step midpoints.

The state vectors are not stored.
"""

import functools
import importlib.util
import json
import os
import resource
import sys
import tempfile
import time

import numpy as np
import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from femo_tpu.models.fsi import (  # noqa: E402
    DynamicShellFSI, aero_forces_from_file, build_dynamic_fsi_jit_step,
    build_wing_fsi, one_cosine_gust)

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                   "fsi_dynamic_oracle.npz")
SMALL = dict(n_shell=[4, 6], n_vlm=[2, 4])
GUST = dict(t0=0.0, duration=0.03)
EAGER = dict(SMALL, dt=0.01, fsi_iters=6, n_steps=3)
JIT = dict(SMALL, dt=0.01, fsi_iters=8, factor_store_dtype=None,
           pcg_iters=0, adj_passes=10, n_steps=3)
RUNG = dict(n_shell=[4, 9600], n_vlm=[4, 24], span=21.0, thickness=0.05,
            dt=0.01, fsi_iters=2, pcg_iters=4, adj_passes=6, n_steps=12)
CONFIGS = {
    "eager": EAGER,
    "eager_gust": dict(EAGER, gust=GUST),
    "jit": JIT,
    "jit_gust": dict(JIT, gust=GUST),
    "jit_mixed": dict(JIT, factor_compute_dtype="mixed"),
    "w9": dict(n_shell=[6, 10], n_vlm=[2, 4], span=4.0, thickness=0.01,
               dt=0.01, pcg_iters=8, factor_store_dtype=None,
               external_loads=True, n_steps=4,
               series=dict(kind="seeded", seed=3, scale=2.0, lift=40.0)),
    "w9_mixed": None,
    "rung_f64": dict(RUNG, factor_store_dtype=None),
    "rung": dict(RUNG, factor_store_dtype="float32"),
    "w9_rung_f64": dict(RUNG, factor_store_dtype=None, external_loads=True,
                        series=dict(kind="restart", seed=0, n_samples=24)),
}
CONFIGS["w9_mixed"] = dict(CONFIGS["w9"], factor_compute_dtype="mixed")
CONFIGS["jit_cr"] = dict(JIT, factor_method="cr")
CONFIGS["span600_f64"] = dict(RUNG, n_shell=[4, 600], factor_store_dtype=None)
CONFIGS["jit_f32c"] = dict(JIT, factor_compute_dtype="float32", pcg_iters=4)


def synthetic_restart(*args):
    """examples/run_aeroelasticity_vpm.py's synthetic restart writer."""
    spec = importlib.util.spec_from_file_location(
        "run_aeroelasticity_vpm",
        os.path.join(os.path.dirname(OUT), os.pardir, "examples",
                     "run_aeroelasticity_vpm.py"))
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    return ex.write_synthetic_restart(*args)


def load_series(c, n_pts):
    """The (n_steps, n_pts, 3) midpoint load series of a W9 entry."""
    s, n = c["series"], c["n_steps"]
    if s["kind"] == "seeded":
        rng = np.random.default_rng(s["seed"])
        series = rng.standard_normal((n, n_pts, 3)) * s["scale"]
        series[:, :, 2] += s["lift"]
        return series
    with tempfile.TemporaryDirectory() as tmp:
        fn = aero_forces_from_file(synthetic_restart(
            os.path.join(tmp, "restart.npz"), n_pts, n * c["dt"],
            s["n_samples"], s["seed"]))
        return np.stack([np.asarray(fn((k + 0.5) * c["dt"]))
                         for k in range(n)])


def _np(a):
    return np.asarray(a, np.float64)


def _gust(c):
    return (functools.partial(one_cosine_gust, **c["gust"])
            if "gust" in c else one_cosine_gust)


def eager(key, c):
    fsi = build_wing_fsi(n_shell=tuple(c["n_shell"]),
                         n_vlm=tuple(c["n_vlm"]))
    dyn = DynamicShellFSI(fsi, dt=c["dt"], fsi_iters=c["fsi_iters"],
                          gust=_gust(c))
    return {f"{key}_tips": _np(dyn.run(c["n_steps"])["tip_disp"])}


def jit_step(key, c):
    kw = {k: (tuple(v) if isinstance(v, list) else v) for k, v in c.items()
          if k not in ("n_steps", "gust", "series")}
    dyn = build_dynamic_fsi_jit_step(gust=_gust(c), **kw)
    series = (load_series(c, dyn["n_force_pts"])
              if c.get("external_loads") else None)
    out = dyn["run_with_grad"](dyn["t0"], c["n_steps"],
                               forces_series=series)
    vals = {f"{key}_tips": _np(out["tips"]), f"{key}_J": float(out["J"]),
            f"{key}_grad": _np(out["grad_thickness"]),
            f"{key}_adj_deltas": _np(out["adj_deltas"]),
            f"{key}_n_dofs": int(dyn["n_dofs"]),
            f"{key}_nb": int(dyn["tpl"].nb), f"{key}_B": int(dyn["tpl"].B),
            f"{key}_n_force_pts": int(dyn["n_force_pts"])}
    if series is not None:
        vals[f"{key}_series"] = _np(series)
        vals[f"{key}_grad_forces"] = _np(out["grad_forces"])
    return vals


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
        fn = eager if key.startswith("eager") else jit_step
        vals = fn(key, CONFIGS[key])
        seconds[key] = time.time() - t0
        # the process's peak resident memory so far (Linux: KiB)
        peak[key] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
        out.update(vals)
        out[f"{key}_config"] = json.dumps(CONFIGS[key], sort_keys=True)
        shown = {k: (v if np.ndim(v) == 0 else
                     f"|{np.linalg.norm(v)!r}| ({np.size(v)})"
                     if np.size(v) > 12 else list(np.asarray(v)))
                 for k, v in vals.items()}
        print(f"{key} ({seconds[key]:.1f} s, peak {peak[key]:.2f} GiB): "
              f"{shown}", flush=True)
        # written after every entry: a long run keeps what it finished
        np.savez_compressed(OUT, **out, seconds=json.dumps(seconds),
                            peak_rss_gib=json.dumps(peak))
    print(f"wrote {OUT} ({os.path.getsize(OUT) / 1e6:.2f} MB) in "
          f"{time.time() - t_all:.1f} s")


if __name__ == "__main__":
    main(sys.argv[1:] or list(CONFIGS))
