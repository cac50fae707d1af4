"""How far f64 arithmetic fixes the W7 wing's coupled tip, rung by rung.

    python -m femo_tpu_torch.tools.fsi_conditioning [--spans 420 1680 6720
        13440] [--seeds 1 2] [--witness] [--operators [--jax-elements
        FILE]] [--out FILE] [--device cuda]

For each spanwise resolution n the wing of the FSI anchor
(`build_fsi_jit_step(n_shell=(4, n), n_vlm=(4, 32), span=30, thickness=
0.05)` in the anchor's solver, PCG to 1e-7 with at most 10 iterations, 5
rounds of 4 passes, with the factor stored in f64: the f32 store's
stagnating PCG would add its own noise) is solved

- as built, and again with every entry of the assembled element matrices
  multiplied by (1 + EPS r), r seeded standard normal per `--seeds`: a
  perturbation the size of the assembly's own rounding.  The relative
  change of the converged tip is how far the arithmetic fixes it.
- once more as a single linear solve (the first Gauss-Seidel pass's
  right-hand side) with 60 PCG iterations: the
  recursive residual, the true residual ||b - A x|| / ||b|| and the tip's
  displacement after k iterations.  The true residual stalls where f64
  can no longer resolve A x.
- with `--operators` instead, the first pass's system with its operator
  summed from element blocks computed on the device, on the CPU and (with
  `--jax-elements FILE`, from oracles/fsi_oracle.py --element-matrices)
  by the JAX package: three f64 computations of the same matrices, each
  operator's system solved exactly as `--witness` does.
- with `--witness`, the first pass's and the converged last pass's linear
  systems also by a solver independent of the block-Thomas factor and
  its PCG polish: LAPACK's banded LU with partial pivoting (dgbtrf, on
  the host) of the same assembled operator, then iterative refinement
  whose residuals are computed in numpy's longdouble (an 80-bit or wider
  float) with the solution accumulated there.  The refined solution is
  the exact solution of the f64 operator as assembled, to about cond x
  eps_longdouble; the port's solve, the unrefined LU and the refined
  solution are compared by their tips and their longdouble residuals.

Prints a line per rung and writes everything to `--out` as JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import numpy as np
import torch

from .. import set_precision
from ..fea.bc import apply_bc
from ..models.fsi import build_fsi_jit_step

ANCHOR_WING = dict(n_vlm=(4, 32), span=30.0, thickness=0.05, gs_inner=4,
                   factor_store_dtype=None, pcg_rtol=1e-7, pcg_maxiter=10)
EPS = 1e-15
ROUNDS = 5
PCG_REPORT = (0, 1, 2, 3, 5, 10, 20, 40, 60)


def perturbed(jac_blocks, eps, seed):
    """jac_blocks with every element-matrix entry times (1 + eps r)."""
    def jac(x, tarr):
        blocks = jac_blocks(x, tarr)
        g = torch.Generator(device=blocks[0][0].device).manual_seed(seed)
        return [(A * (1 + eps * torch.randn(A.shape, generator=g,
                                            dtype=A.dtype, device=A.device)),
                 r, c) for A, r, c in blocks]
    return jac


def pcg_history(f, iters=60):
    """One linear solve of the first pass (lattice at rest): (iteration,
    recursive relres, true relres, tip u_z) at PCG_REPORT's
    iterations."""
    st = f["step"]
    mat, fac = st.bt.unpack(st.bt.factor(f["t0"]))
    _, trac = st.traction(torch.zeros(st.n_lat * 3, dtype=f["t0"].dtype,
                                      device=f["t0"].device))
    _, b = st._rhs(f["t0"], trac.reshape(-1))
    tip = 3 * st.tip_idx + 2
    bn = torch.linalg.norm(b)
    x = fac.solve(b)
    r = b - mat.matvec(x)
    z = fac.solve(r)
    p, rz = z, torch.dot(r, z)
    out = []
    for k in range(iters + 1):
        if k:  # pcg_fixed's iteration, its zero guards included
            Ap = mat.matvec(p)
            denom = torch.dot(p, Ap)
            alpha = rz / torch.where(denom == 0, 1.0, denom)
            x, r = x + alpha * p, r - alpha * Ap
            z = fac.solve(r)
            rz, rz_old = torch.dot(r, z), rz
            p = z + (rz / torch.where(rz_old == 0, 1.0, rz_old)) * p
        if k in PCG_REPORT:
            true = torch.linalg.norm(b - mat.matvec(x)) / bn
            out.append((k, float(torch.linalg.norm(r) / bn), float(true),
                        float(x[tip])))
    return out


def band(D, L, U, kl):
    """The block-tridiagonal operator (D, L, U) (host, f64) in its block
    order as a LAPACK general band matrix with kl sub- and kl
    super-diagonals, in the (3 kl + 1, nb B) storage dgbtrf factors in
    place: A[R, C] at ab[2 kl + R - C, C].  Raises if a nonzero lies
    outside the band."""
    nb, B = D.shape[:2]
    ab = np.zeros((3 * kl + 1, nb * B))
    for d in range(-kl, kl + 1):  # d = R - C
        row = ab[2 * kl + d].reshape(nb, B)  # row[k, j]: column k B + j
        j = np.arange(max(0, -d), min(B, B - d))
        row[:, j] = D[:, j + d, j]  # R = k B + j + d
        if d > 0:  # L[k]: R = k B + i, C = (k - 1) B + j, i = j + d - B
            j = np.arange(B - d, B)
            row[:-1, j] = L[1:, j + d - B, j]
        elif d < 0:  # U[k]: R = k B + i, C = (k + 1) B + j, i = j + d + B
            j = np.arange(0, -d)
            row[1:, j] = U[:-1, j + d + B, j]
    nnz = (np.count_nonzero(D) + np.count_nonzero(L[1:])
           + np.count_nonzero(U[:-1]))
    if np.count_nonzero(ab) != nnz:
        raise ValueError(f"the operator has nonzeros outside bandwidth {kl}")
    return ab


def residual_ld(D, L, U, xb, bb, chunk=128):
    """b - A x in longdouble, block layout: (D, L, U) and bb f64 (host),
    xb longdouble (nb, B); chunks of blocks on a thread each (numpy's
    longdouble matmul releases the GIL)."""
    from concurrent.futures import ThreadPoolExecutor

    ld = np.longdouble
    z = np.zeros_like(xb[:1])
    xs = np.concatenate([z, xb, z])[..., None]  # xs[k + 1] = x_k
    r = np.empty(xb.shape, ld)

    def part(s):
        e = min(len(D), s + chunk)
        y = np.matmul(D[s:e].astype(ld), xs[s + 1:e + 1])
        y += np.matmul(L[s:e].astype(ld), xs[s:e])
        y += np.matmul(U[s:e].astype(ld), xs[s + 2:e + 2])
        r[s:e] = bb[s:e].astype(ld) - y[..., 0]

    with ThreadPoolExecutor(os.cpu_count()) as ex:
        list(ex.map(part, range(0, len(D), chunk)))
    return r


def direct_witness(mat, kl, b, x_port, tip, steps=6):
    """The system mat x = b (b, x_port in dof order, on the device)
    solved by banded LU with partial pivoting (host LAPACK dgbtrf /
    dgbtrs), then `steps` refinement steps with longdouble residuals
    and a longdouble solution.  Returns the port's solution's, the
    unrefined LU's and every refined iterate's tip and longdouble
    relative residual, and the f64 relative residual (mat.matvec, what
    PCG reads) of the port's and of the refined solution."""
    from scipy.linalg.lapack import dgbtrf, dgbtrs

    ld = np.longdouble
    D, L, U = (X.cpu().numpy() for X in (mat.D, mat.L, mat.U))
    nb, B = mat.nb, mat.B
    bb = mat.to_blocks(b).cpu().numpy()
    pos = int(mat.iperm[tip])
    bnorm = np.sqrt(np.sum(bb.astype(ld) ** 2))

    def relres(xl):
        r = residual_ld(D, L, U, xl, bb)
        return float(np.sqrt(np.sum(r ** 2)) / bnorm), r

    def f64_relres(xl):
        x = mat.from_blocks(torch.as_tensor(xl.astype(np.float64)).to(
            b.device).reshape(-1))
        return float(torch.linalg.norm(b - mat.matvec(x))
                     / torch.linalg.norm(b))

    out = dict(kl=kl)
    if x_port is not None:
        xp = mat.to_blocks(x_port).cpu().numpy().astype(ld)
        out.update(port_tip=float(xp.reshape(-1)[pos]),
                   port_relres_ld=relres(xp)[0],
                   port_relres_f64=f64_relres(xp))
    t0 = time.perf_counter()
    lu, piv, info = dgbtrf(band(D, L, U, kl), kl, kl, overwrite_ab=1)
    if info != 0:
        raise RuntimeError(f"dgbtrf info={info}")
    out["factor_s"] = time.perf_counter() - t0

    def lu_solve(r):
        x, info = dgbtrs(lu, kl, kl, r.reshape(-1), piv)
        if info != 0:
            raise RuntimeError(f"dgbtrs info={info}")
        return x.reshape(nb, B)

    xl = lu_solve(bb.astype(np.float64)).astype(ld)
    tips, res = [], []
    for k in range(steps + 1):
        rr, r = relres(xl)
        tips.append(float(xl.reshape(-1)[pos]))
        res.append(rr)
        if k < steps:
            xl = xl + lu_solve(r.astype(np.float64)).astype(ld)
    out.update(lu_tips=tips, lu_relres_ld=res,
               refined_relres_f64=f64_relres(xl),
               seconds=time.perf_counter() - t0)
    return out


def witnesses(f, tips):
    """direct_witness on the first pass's system (lattice at rest) and on
    the last pass's at the converged lattice of `solve`'s fixed point
    (ROUNDS rounds), each beside the port's own solve of it."""
    st = f["step"]
    carry = st.bt.factor(f["t0"])
    mat, fac = st.bt.unpack(carry)
    tip = 3 * st.tip_idx + 2
    kl = f["tpl"].bw
    d = torch.zeros(st.n_lat * 3, dtype=f["t0"].dtype, device=f["t0"].device)
    out = {}
    with torch.no_grad():
        for name in ("first", "last"):
            if name == "last":
                for _ in range(ROUNDS):
                    d = st.gs(carry, f["t0"], d)[0]
            _, trac = st.traction(d)
            _, b = st._rhs(f["t0"], trac.reshape(-1))
            out[name] = direct_witness(mat, kl, b, st.inv(mat, fac, b), tip)
    out["last"]["coupled_tip"] = tips[0]
    return out


def _jax_blocks(path, n):
    """The JAX package's element blocks of the wing at (4, n), written by
    oracles/fsi_oracle.py --element-matrices."""
    with np.load(path) as z:
        cfg = json.loads(str(z["config"]))
        want = dict(n_shell=[4, n], n_vlm=list(ANCHOR_WING["n_vlm"]),
                    span=ANCHOR_WING["span"],
                    thickness=ANCHOR_WING["thickness"])
        if any(cfg.get(k) != v for k, v in want.items()):
            raise ValueError(f"{path} holds {cfg}, not {want}")
        return [(z[f"A{i}"], z[f"rows{i}"], z[f"cols{i}"])
                for i in range(sum(k.startswith("A") for k in z.files))]


def _fill_blocks(f):
    """f's composite element blocks at the fill point (u = apply_bc(0),
    thickness t0, zero force): [(A, rows, cols)] on the host."""
    st, t0 = f["step"], f["t0"]
    u0 = apply_bc(torch.zeros(f["n_dofs"], dtype=t0.dtype, device=t0.device),
                  st.free, st.bv)
    with torch.no_grad():
        return [(A.cpu().numpy(), np.asarray(torch.as_tensor(r).cpu()),
                 np.asarray(torch.as_tensor(c).cpu()))
                for A, r, c in st.bt.jac_blocks(u0, t0)]


def operators(n, device, jax_path=None):
    """The first-pass system (lattice at rest) of the wing at (4, n),
    built on `device`, with its operator summed (the template's owner
    table on `device`) from element blocks computed three ways: on
    `device`, on the CPU (when `device` is not the CPU) and by the JAX
    package (`jax_path`).  Each operator's system is solved exactly
    (direct_witness); each source's blocks are compared with the
    first's entry by entry."""
    f = build_fsi_jit_step(n_shell=(4, n), device=device, **ANCHOR_WING)
    st, tpl, t0 = f["step"], f["tpl"], f["t0"]
    dev = t0.device
    sources = {dev.type: _fill_blocks(f)}
    if dev.type != "cpu":
        sources["cpu"] = _fill_blocks(build_fsi_jit_step(
            n_shell=(4, n), device="cpu", **ANCHOR_WING))
    if jax_path:
        sources["jax"] = _jax_blocks(jax_path, n)
    with torch.no_grad():
        _, trac = st.traction(torch.zeros(st.n_lat * 3, dtype=t0.dtype,
                                          device=dev))
        _, b = st._rhs(t0, trac.reshape(-1))
    ref = sources[dev.type]
    out = dict(n_shell=[4, n], n_cells=f["n_cells"], blocks={}, exact={})
    for name, blocks in sources.items():
        diffs = []
        for (A, r, c), (A0, r0, c0) in zip(blocks, ref):
            if not (np.array_equal(r, r0) and np.array_equal(c, c0)):
                raise ValueError(f"the {name} element blocks are laid out "
                                 "differently")
            d = np.abs(A - A0)
            big = np.abs(A0) > 1e-8 * np.abs(A0).max()
            diffs.append(dict(
                shape=list(A.shape),
                max_over_max=float(d.max() / np.abs(A0).max()),
                rel_entry_median=float(np.median(d[big] / np.abs(A0[big]))),
                rel_entry_max=float(np.max(d[big] / np.abs(A0[big]))),
                equal_share=float(np.mean(d == 0))))
        out["blocks"][name] = diffs
        with torch.no_grad():
            mat = st.bt.matrix(*tpl.fill([(torch.as_tensor(A, device=dev),
                                           r, c) for A, r, c in blocks]))
        out["exact"][name] = direct_witness(mat, tpl.bw, b, None,
                                            3 * st.tip_idx + 2, steps=3)
        del mat
    return out


def rung(n, seeds, device, witness=False):
    f = build_fsi_jit_step(n_shell=(4, n), device=device, **ANCHOR_WING)
    st = f["step"]
    jac = st.bt.jac_blocks
    tips = []
    for seed in (None,) + tuple(seeds):
        st.bt.jac_blocks = jac if seed is None else perturbed(jac, EPS,
                                                              seed)
        with torch.no_grad():
            tips.append(float(f["solve"](f["t0"],
                                         rounds=ROUNDS)["tip_disp"]))
    st.bt.jac_blocks = jac
    rel = [abs(t - tips[0]) / abs(tips[0]) for t in tips[1:]]
    hist = pcg_history(f)
    out = dict(n_shell=[4, n], n_cells=f["n_cells"], n_dofs=f["n_dofs"],
               nb=f["tpl"].nb, eps=EPS, seeds=list(seeds), tips=tips,
               tip_rel_change=rel, pcg=hist)
    if witness:
        out["witness"] = witnesses(f, tips)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--spans", type=int, nargs="+",
                    default=[420, 1680, 6720, 13440])
    ap.add_argument("--seeds", type=int, nargs="*", default=[1, 2])
    ap.add_argument("--witness", action="store_true")
    ap.add_argument("--operators", action="store_true")
    ap.add_argument("--jax-elements", metavar="FILE")
    ap.add_argument("--device", default=None)
    ap.add_argument("--out", default="chiprun_out/fsi_conditioning.json")
    args = ap.parse_args(argv)
    set_precision("float64")
    card = None
    if args.device in (None, "cuda"):
        card = subprocess.run(
            ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip()
        print(card)
    if args.operators:
        rows = []
        for n in args.spans:
            r = operators(n, args.device, args.jax_elements)
            for name, w in r["exact"].items():
                print(f"(4, {n}): the operator from the {name} element "
                      f"blocks, first pass, exact tip {w['lu_tips'][-1]!r} "
                      f"(unrefined LU {w['lu_tips'][0]!r}; longdouble "
                      f"residuals "
                      f"{[f'{v:.3e}' for v in w['lu_relres_ld']]}); "
                      f"blocks vs the first source: "
                      f"{[(d['max_over_max'], d['rel_entry_max']) for d in r['blocks'][name]]}",
                      flush=True)
            rows.append(r)
        _write(args.out, {"card": card, "operators": rows})
        return rows
    rows = []
    for n in args.spans:
        r = rung(n, args.seeds, args.device, args.witness)
        last = r["pcg"][-1]
        print(f"(4, {n}) {r['n_cells']} cells, nb={r['nb']}: tip "
              f"{r['tips'][0]!r}; perturbed by {EPS:g}: "
              f"{r['tips'][1:]}, relative change "
              f"{[f'{v:.3e}' for v in r['tip_rel_change']]}; one solve "
              f"after {last[0]} PCG iterations: recursive residual "
              f"{last[1]:.3e}, true residual {last[2]:.3e}, tip "
              f"{last[3]!r}", flush=True)
        for name, w in r.get("witness", {}).items():
            print(f"  {name} pass, banded LU (kl={w['kl']}, "
                  f"{w['factor_s']:.1f} s): port tip {w['port_tip']!r} "
                  f"(residual longdouble {w['port_relres_ld']:.3e}, f64 "
                  f"{w['port_relres_f64']:.3e}); LU and refined tips "
                  f"{w['lu_tips']} with longdouble residuals "
                  f"{[f'{v:.3e}' for v in w['lu_relres_ld']]} (f64 "
                  f"{w['refined_relres_f64']:.3e})", flush=True)
        rows.append(r)
    _write(args.out, {"card": card, "rungs": rows})
    return rows


def _write(path, obj):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as fh:
        json.dump(obj, fh, indent=1)
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
