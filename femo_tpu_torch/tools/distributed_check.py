"""The distributed paths on the card: one pool of ranks runs mode b (the
dof-sharded halo CG of run_distributed_poisson.py, with K4 inside each
rank) and mode a (the cells-sharded Poisson, motor and shell steps), and
returns what chip_smoke.py's `distributed` phase holds against the JAX
package's values.

    python -m femo_tpu_torch.tools.distributed_check [--ranks 4]

runs chip_smoke.py's configuration on the card and prints each rank's
results as JSON (x left out); chip_smoke.py calls `run` and does the
gates.  The ranks share the card through gloo when
there are more ranks than cards (parallel/launch.py).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
import torch.distributed as dist

from ..config import get_device
from ..fea import (
    DirichletBC, FormDef, Function, FunctionSpace, assemble_matrix,
    bc_arrays, create_unit_square_mesh, dot, dx, grad)
from ..ops import spmv
from ..parallel.halo import HaloShardedOperator
from ..parallel.launch import spawn
from ..parallel.sharding import RankMesh

# repeats of each piece of a CG iteration in the split of its time
SPLIT_REPS = 50
# the oracle configuration of the motor (em_load_steps, Newton counts,
# edge deltas) with the dense LU that mode a runs
MOTOR_CFG = dict(em_load_steps=3, mm_newton_iters=3, em_newton_iters=3,
                 factorization="lu", design_space="edge_deltas")


def halo_system(nel, device):
    """run_distributed_poisson.py's system: grad.grad + mass on the
    nel x nel unit square, u = 0 on x = 0.  Returns (A, free, V)."""
    V = FunctionSpace(create_unit_square_mesh(nel), ("CG", 1), device=device)
    u = Function(V, "u")
    A = assemble_matrix(
        FormDef([dx(lambda w, g: dot(grad(w.u), grad(w.v)) + w.u * w.v)],
                coeffs=[u], test=V), "u")
    free, _ = bc_arrays([DirichletBC(V, 0.0, where=lambda x: np.isclose(
        x[0], 0.0))], V.n_dofs, device)
    return A, free, V


def _sync(mesh):
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)


def _timed(mesh, fn):
    """(fn(), wall seconds ending in a device sync)."""
    t0 = time.perf_counter()
    out = fn()
    _sync(mesh)
    return out, time.perf_counter() - t0


def _per_call_ms(mesh, fn, reps=SPLIT_REPS):
    fn()
    _sync(mesh)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    _sync(mesh)
    return (time.perf_counter() - t0) / reps * 1e3


def _counted_cg(mesh, op, b, rtol):
    """One CG with K4's count set to 0 just before and read just after:
    (x, iterations, ||r||, seconds, K4 launches)."""
    spmv.launches["K4"] = 0
    (x, k, rn), t = _timed(mesh, lambda: op.cg(b, rtol=rtol))
    return x, k, float(rn), t, spmv.launches["K4"]


def _host(t):
    return t.detach().cpu().numpy()


def halo_rank(mesh, nel, rtol):
    """Mode b on this rank: the operator, K4 against its plain version on
    one local product, a cold and a warm CG (K4 counted in each), the
    split of an iteration's time, then the same CG on a group of rank 0
    alone."""
    out = {"rank": mesh.rank}
    (A, free, V), out["assembly_s"] = _timed(
        mesh, lambda: halo_system(nel, mesh.device))
    n = V.n_dofs
    op, out["layout_s"] = _timed(mesh, lambda: HaloShardedOperator(
        A, V.dofmap, n, mesh, free=free))
    lay = op.layout
    out.update(n_dofs=n, n_cells=V.mesh.n_cells, L=lay.L, G=lay.G, S=lay.S,
               n_owned=int(lay.n_owned[mesh.rank]),
               n_ghosts=len(op.ghosts), n_elements=op.n_elements)

    # K4 against its plain version on one local product (not counted)
    blk = op.local.blocks[0]
    rng = np.random.default_rng(100 + mesh.rank)
    x_loc = torch.as_tensor(rng.standard_normal(op.n_local),
                            device=mesh.device)
    y_k4 = op.local.matvec(x_loc)
    y_plain = spmv.element_spmv_plain(blk.A, blk.rows, blk.cols, x_loc,
                                      op.n_local)
    out["k4_max_abs_err"] = float((y_k4 - y_plain).abs().max())
    out["k4_max_abs"] = float(y_plain.abs().max())

    b = op.scatter_vector(np.ones(n))
    x, k, rn, t, k4 = _counted_cg(mesh, op, b, rtol)
    out["cold"] = dict(iterations=k, rnorm=rn, seconds=t, k4=k4)
    x, k, rn, t, k4 = _counted_cg(mesh, op, b, rtol)
    out["warm"] = dict(iterations=k, rnorm=rn, seconds=t, k4=k4,
                       ms_per_iteration=t / max(k, 1) * 1e3)
    xg = op.gather_vector(x)
    out["x"] = _host(xg) if mesh.rank == 0 else None

    # the split of an iteration: halo exchanges (gloo, staged through the
    # host), K4 alone, one all-reduced dot
    gh = torch.zeros(lay.G, dtype=x.dtype, device=mesh.device)
    x_cat = torch.cat([x, op.fwd_halo(x)])
    out["split_ms"] = dict(
        fwd_halo=_per_call_ms(mesh, lambda: op.fwd_halo(x)),
        rev_halo=_per_call_ms(mesh, lambda: op.rev_halo(gh)),
        k4=_per_call_ms(mesh, lambda: op.local.matvec(x_cat)),
        matvec=_per_call_ms(mesh, lambda: op.matvec(x)),
        dot=_per_call_ms(mesh, lambda: op.dot(x, x)))

    # the same CG on one rank (rank 0 alone; the others wait)
    solo = dist.new_group([0])
    if mesh.rank == 0:
        op1 = HaloShardedOperator(A, V.dofmap, n,
                                  RankMesh(solo, 0, 1, mesh.device),
                                  free=free)
        x1, k1, rn1, t1, k41 = _counted_cg(mesh, op1,
                                           op1.scatter_vector(np.ones(n)),
                                           rtol)
        out["one_rank"] = dict(iterations=k1, rnorm=rn1, seconds=t1, k4=k41,
                               x=_host(op1.gather_vector(x1)),
                               L=op1.layout.L, G=op1.layout.G)
    dist.barrier()
    return out


def mode_a_rank(mesh, poisson_nel, motor_refine, shell_shape):
    """Mode a on this rank: the Poisson step ("cg") at poisson_nel, the
    motor step at motor_refine (MOTOR_CFG), the shell step at
    shell_shape; each first call's value, gradient and seconds."""
    from ..models.motor.model import build_motor_jit_step
    from ..models.poisson import build_jit_opt_step
    from ..models.shell import build_shell_sharded_step

    out = {}
    step, f0 = build_jit_opt_step(nel=poisson_nel, device_mesh=mesh)
    (J, g), t = _timed(mesh, lambda: step(f0))
    out["poisson"] = dict(J=float(J), g=_host(g), seconds=t)
    step, (dv0, iq0), _ = build_motor_jit_step(
        refine=motor_refine, device_mesh=mesh, **MOTOR_CFG)
    (loss, (g_dv, g_iq)), t = _timed(mesh, lambda: step(dv0, iq0))
    out["motor"] = dict(loss=float(loss), g_dv=_host(g_dv),
                        g_iq=float(g_iq), seconds=t)
    step, t0, info = build_shell_sharded_step(n_shell=shell_shape,
                                              device_mesh=mesh)
    (J, g), t = _timed(mesh, lambda: step(t0))
    out["shell"] = dict(J=float(J), g=_host(g), seconds=t,
                        n_dofs=info["n_dofs"])
    return out


def chip_rank(mesh, nel, rtol, poisson_nel, motor_refine, shell_shape):
    """One rank of chip_smoke.py's `distributed` phase: mode b, then
    mode a, with the seconds of each."""
    t0 = time.perf_counter()
    out = {"halo": halo_rank(mesh, nel, rtol)}
    out["halo_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["mode_a"] = mode_a_rank(mesh, poisson_nel, motor_refine,
                                shell_shape)
    out["mode_a_s"] = time.perf_counter() - t0
    return out


def run(ranks=4, nel=260, rtol=1e-8, poisson_nel=260, motor_refine=1,
        shell_shape=(3, 4), device=None, timeout=600.0):
    """chip_rank on `ranks` ranks (on the card by default); the list of
    their results, rank 0 first.  On the card, K4's library is built here
    first, not by the ranks at once."""
    if get_device(device).type == "cuda":
        spmv.get_lib()
    return spawn(chip_rank, ranks, device=device, timeout=timeout,
                 args=(nel, rtol, poisson_nel, motor_refine,
                       tuple(shell_shape)))


def _jsonable(o):
    if isinstance(o, dict):
        return {k: _jsonable(v) for k, v in o.items()
                if not isinstance(v, np.ndarray)}
    return o


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--ranks", type=int, default=4)
    args = p.parse_args(argv)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    t0 = time.perf_counter()
    res = run(args.ranks)
    for r in res:
        print(json.dumps(_jsonable(r)))
    print(f"{time.perf_counter() - t0:.1f} s")
    return res


if __name__ == "__main__":
    main()
