"""Chebyshev polynomial preconditioner (port of
femo_tpu/solvers/precond.py).

A fixed-degree Chebyshev polynomial of the Jacobi-scaled operator: no
reductions inside its application, only matvecs.  The power iteration
that estimates the largest eigenvalue starts from a seeded torch random
vector; torch and jax give different numbers for one seed, so the
estimate, and with it the preconditioner, differs from the JAX package's
in the last digits unless `lam_max` is given.
"""

from __future__ import annotations

from typing import Callable

import torch


def estimate_lambda_max(matvec: Callable, diag_inv: torch.Tensor,
                        iters: int = 15, seed: int = 0):
    """Power iteration for the largest eigenvalue of D^{-1} A."""
    gen = torch.Generator().manual_seed(seed)
    v = torch.randn(diag_inv.shape[0], generator=gen,
                    dtype=diag_inv.dtype).to(diag_inv.device)
    v = v / torch.linalg.norm(v)
    lam = torch.ones((), dtype=v.dtype, device=v.device)
    for _ in range(iters):
        w = diag_inv * matvec(v)
        lam = torch.linalg.norm(w)
        v = w / (lam + 1e-30)
    return lam


def chebyshev_preconditioner(matvec: Callable, diag: torch.Tensor,
                             degree: int = 4, lam_max=None,
                             lam_min_ratio: float = 1 / 30.0,
                             eig_iters: int = 15):
    """Chebyshev acceleration (Saad, Alg. 12.1) of the Jacobi-scaled
    operator B = D^{-1} A on [lam_min_ratio * lam_max, lam_max], from
    x = 0, `degree` terms."""
    d = torch.where(torch.abs(diag) > 1e-30, diag, 1.0)
    dinv = 1.0 / d
    if lam_max is None:
        lam_max = estimate_lambda_max(matvec, dinv, eig_iters)
    lam_max = 1.02 * lam_max
    lam_min = lam_min_ratio * lam_max
    theta = 0.5 * (lam_max + lam_min)
    delta = 0.5 * (lam_max - lam_min)
    sigma1 = theta / delta

    def M(r):
        d_prev = dinv * r / theta
        x = d_prev
        rho_prev = 1.0 / sigma1
        for _ in range(1, degree):
            res = dinv * (r - matvec(x))
            rho = 1.0 / (2.0 * sigma1 - rho_prev)
            d_prev = rho * rho_prev * d_prev + (2.0 * rho / delta) * res
            x = x + d_prev
            rho_prev = rho
        return x

    return M
