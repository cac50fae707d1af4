"""Krylov solvers on device tensors (port of femo_tpu/solvers/krylov.py).

The JAX package runs each solver as one `lax.while_loop`; the port runs
the same iteration as a host loop over tensors that stay on the device.
The stopping rules, the `maxiter` clamps and the breakdown guards are the
JAX package's, tested every iteration: each loop test reads one device
boolean (one host-device sync per iteration).  The iteration counts are
then the reference's wherever both round alike; near the 1e-12 default
tolerance, rounding alone can move the last iterations.

All solvers are matrix-free: `matvec` is any callable, typically the
element-matrix SpMV (K4 on CUDA tensors).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..config import config


class KrylovResult(NamedTuple):
    x: torch.Tensor
    iters: int
    resnorm: torch.Tensor
    converged: bool


def _identity(x):
    return x


def cg(matvec: Callable, b: torch.Tensor, x0=None, M: Callable | None = None,
       rtol: float | None = None, atol: float | None = None,
       maxiter: int | None = None) -> KrylovResult:
    """Preconditioned conjugate gradients for SPD systems."""
    rtol = config.krylov_rtol if rtol is None else rtol
    atol = config.krylov_atol if atol is None else atol
    maxiter = min(config.krylov_maxiter if maxiter is None else maxiter,
                  b.shape[0] * 4)
    M = M or _identity
    x = torch.zeros_like(b) if x0 is None else x0

    r = b - matvec(x)
    z = M(r)
    p = z
    rz = torch.dot(r, z)
    tol2 = torch.clamp(rtol * torch.linalg.norm(b), min=atol) ** 2
    k = 0
    while k < maxiter and bool(torch.dot(r, r) > tol2):
        Ap = matvec(p)
        alpha = rz / torch.dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz_new = torch.dot(r, z)
        beta = rz_new / rz
        p = z + beta * p
        rz = rz_new
        k += 1
    rn = torch.linalg.norm(r)
    return KrylovResult(x, k, rn, bool(rn <= torch.sqrt(tol2)))


def bicgstab(matvec: Callable, b: torch.Tensor, x0=None,
             M: Callable | None = None, rtol: float | None = None,
             atol: float | None = None,
             maxiter: int | None = None) -> KrylovResult:
    """Preconditioned BiCGStab for general (nonsymmetric) systems."""
    rtol = config.krylov_rtol if rtol is None else rtol
    atol = config.krylov_atol if atol is None else atol
    maxiter = min(config.krylov_maxiter if maxiter is None else maxiter,
                  b.shape[0] * 4)
    M = M or _identity
    x = torch.zeros_like(b) if x0 is None else x0

    r = b - matvec(x)
    rhat = r
    tol = torch.clamp(rtol * torch.linalg.norm(b), min=atol)
    eps = torch.finfo(b.dtype).tiny
    p = torch.zeros_like(b)
    v = torch.zeros_like(b)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    rho, alpha, omega = one, one, one
    brk = torch.zeros((), dtype=torch.bool, device=b.device)

    def nz(a):  # the reference's division guard
        return torch.where(a == 0, eps, a)

    k = 0
    while k < maxiter and bool((torch.linalg.norm(r) > tol) & ~brk):
        rho_new = torch.dot(rhat, r)
        beta = (rho_new / nz(rho)) * (alpha / nz(omega))
        p = r + beta * (p - omega * v)
        phat = M(p)
        v = matvec(phat)
        alpha = rho_new / nz(torch.dot(rhat, v))
        s = r - alpha * v
        shat = M(s)
        t = matvec(shat)
        omega = torch.dot(t, s) / nz(torch.dot(t, t))
        x = x + alpha * phat + omega * shat
        r = s - omega * t
        brk = (torch.abs(rho_new) < eps) | (torch.abs(omega) < eps)
        rho = rho_new
        k += 1
    rn = torch.linalg.norm(r)
    return KrylovResult(x, k, rn, bool(rn <= tol))


def gmres(matvec: Callable, b: torch.Tensor, x0=None,
          M: Callable | None = None, restart: int = 50,
          rtol: float | None = None, atol: float | None = None,
          maxiter: int | None = None) -> KrylovResult:
    """Restarted GMRES(m), right-preconditioned (x = x0 + M z, so the
    reported residual is the true residual): Arnoldi with modified
    Gram-Schmidt and a Givens-rotation QR of the Hessenberg matrix.

    As in the reference, every cycle runs all m Arnoldi steps (columns
    past convergence are guarded in the back substitution), and the
    iteration count adds, per cycle, the column at which the residual
    estimate first met the tolerance."""
    rtol = config.krylov_rtol if rtol is None else rtol
    atol = config.krylov_atol if atol is None else atol
    maxiter = config.krylov_maxiter if maxiter is None else maxiter
    Mfn = M or _identity
    x = torch.zeros_like(b) if x0 is None else x0
    n = b.shape[0]
    # a single cycle never runs more Arnoldi steps than maxiter allows
    m = int(min(restart, maxiter, n))
    dt, dev = b.dtype, b.device
    eps = torch.finfo(dt).tiny * 1e3
    tol = torch.clamp(rtol * torch.linalg.norm(b), min=atol)
    n_cycles = max(1, -(-maxiter // m))

    def cycle(x):
        r = b - matvec(x)
        beta = torch.linalg.norm(r)
        V = torch.zeros((m + 1, n), dtype=dt, device=dev)
        V[0] = r / torch.clamp(beta, min=eps)
        H = torch.zeros((m, m), dtype=dt, device=dev)
        cs = torch.ones(m, dtype=dt, device=dev)
        sn = torch.zeros(m, dtype=dt, device=dev)
        g = torch.zeros(m + 1, dtype=dt, device=dev)
        g[0] = beta
        for j in range(m):
            w = matvec(Mfn(V[j]))
            hcol = torch.zeros(m + 1, dtype=dt, device=dev)
            for i in range(j + 1):
                hij = torch.dot(V[i], w)
                w = w - hij * V[i]
                hcol[i] = hij
            hlast = torch.linalg.norm(w)
            hcol[j + 1] = hlast
            V[j + 1] = w / torch.clamp(hlast, min=eps)
            # the rotations accumulated so far (those at >= j are the
            # identity in the reference)
            for i in range(j):
                t1 = cs[i] * hcol[i] + sn[i] * hcol[i + 1]
                t2 = -sn[i] * hcol[i] + cs[i] * hcol[i + 1]
                hcol[i], hcol[i + 1] = t1, t2
            d = torch.sqrt(hcol[j] ** 2 + hcol[j + 1] ** 2)
            dsafe = torch.clamp(d, min=eps)
            cj, sj = hcol[j] / dsafe, hcol[j + 1] / dsafe
            cs[j], sn[j] = cj, sj
            gj = g[j].clone()
            g[j + 1] = -sj * gj
            g[j] = cj * gj
            hcol[j] = d
            hcol[j + 1] = 0.0
            H[:, j] = hcol[:m]
        # back substitution on the rotated upper-triangular H; converged or
        # broken-down columns have ~0 diagonal and ~0 rhs: guard the pivot
        Hd = H + torch.diag((torch.abs(torch.diagonal(H)) < eps).to(dt))
        y = torch.linalg.solve_triangular(Hd, g[:m, None], upper=True)[:, 0]
        x = x + Mfn(V[:m].T @ y)
        rnew = torch.linalg.norm(b - matvec(x))
        conv = torch.abs(g[1:]) <= tol
        done = int(torch.argmax(conv.to(torch.int8))) + 1 \
            if bool(conv.any()) else m
        return x, rnew, done

    rn = torch.linalg.norm(b - matvec(x))
    k = iters = 0
    while k < n_cycles and bool(rn > tol):
        x, rn, done = cycle(x)
        k += 1
        iters += done
    return KrylovResult(x, iters, rn, bool(rn <= tol))


KRYLOV = {"cg": cg, "bicgstab": bicgstab, "gmres": gmres}
