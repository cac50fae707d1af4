"""Distributed solve at the reference's FSI mesh scale (port of
examples/run_distributed_poisson.py): a 260 x 260 unit-square mesh
(135,200 triangles, 68,121 dofs), dof-sharded over the ranks with the
halo-exchange CG (parallel/halo.py), K4 inside each rank.

python -m femo_tpu_torch.examples.run_distributed_poisson --nel 260 --ranks 4

The ranks run on the card(s) (`config.device`): with fewer cards than
ranks they share them through gloo, which NCCL does not allow; on the CPU
(`config.device = "cpu"`) they are gloo CPU processes.  Rank 0 prints
what the JAX script prints.
"""

import argparse
import time

import numpy as np

from femo_tpu_torch.fea import (
    DirichletBC, FormDef, Function, FunctionSpace, assemble_matrix,
    bc_arrays, create_unit_square_mesh, dot, dx, grad)
from femo_tpu_torch.parallel.halo import HaloShardedOperator
from femo_tpu_torch.parallel.launch import spawn


def _say(mesh, *a):
    if mesh.rank == 0:
        print(*a, flush=True)


def _synced(mesh, fn):
    """(fn(), wall seconds), the rank's device drained before the clock
    stops."""
    import torch

    t0 = time.perf_counter()
    out = fn()
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    return out, time.perf_counter() - t0


def _rank(mesh, nel):
    m = create_unit_square_mesh(nel)
    _say(mesh, f"mesh: {m.n_cells} cells, devices: {mesh.size}")
    V = FunctionSpace(m, ("CG", 1), device=mesh.device)
    u = Function(V, "u")
    form = FormDef([dx(lambda w, g: dot(grad(w.u), grad(w.v)) + w.u * w.v)],
                   coeffs=[u], test=V)
    A, dt = _synced(mesh, lambda: assemble_matrix(form, "u"))
    _say(mesh, f"assembly: {dt:.2f}s")
    bc = DirichletBC(V, 0.0, where=lambda x: np.isclose(x[0], 0.0))
    free, _ = bc_arrays([bc], V.n_dofs, mesh.device)

    op, dt = _synced(mesh, lambda: HaloShardedOperator(
        A, V.dofmap, V.n_dofs, mesh, free=free))
    _say(mesh, f"partition+layout: {dt:.2f}s (owned/dev ~{op.layout.L}, "
               f"ghosts/dev <= {op.layout.G})")

    b = op.scatter_vector(np.ones(V.n_dofs))
    op.cg(b, rtol=1e-8)
    (xl, iters, rn), dt = _synced(mesh, lambda: op.cg(b, rtol=1e-8))
    _say(mesh, f"distributed CG: {iters} iterations, ||r||={float(rn):.2e}, "
               f"{dt:.2f}s ({dt / max(iters, 1) * 1e3:.2f} ms/iter)")
    return {"iterations": iters, "rnorm": float(rn), "seconds": dt,
            "L": op.layout.L, "G": op.layout.G, "S": op.layout.S,
            "n_cells": m.n_cells}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--nel", type=int, default=260)
    p.add_argument("--ranks", type=int, default=4)
    args = p.parse_args(argv)
    return spawn(_rank, args.ranks, args=(args.nel,))[0]


if __name__ == "__main__":
    main()
