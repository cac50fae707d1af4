"""Nonlinear B-H relative-permeability law: piecewise linear / cubic / exp
(port of femo_tpu/models/motor/permeability.py).

The fit is host numpy, identical to the JAX package's; evaluation is a
nested `torch.where` on tensors (differentiable, vmap-safe).
"""

from __future__ import annotations

import numpy as np
import torch


def default_silicon_steel(n: int = 40):
    """Synthetic (B [T], mu_r) samples resembling silicon core iron."""
    B = np.linspace(0.05, 2.6, n)
    mu = 1.0 + 3500.0 / (1.0 + (B / 1.45) ** 9) + 300.0 * B / (1 + B**2)
    return B, mu


class PiecewiseBHCurve:
    """mu_r(|B|), piecewise: linear (B < x1), cubic (x1..x2), exp (B > x2)."""

    def __init__(self, B_data=None, mu_data=None, x1: float = 0.8,
                 x2: float = 1.4):
        if B_data is None:
            B_data, mu_data = default_silicon_steel()
        B_data = np.asarray(B_data, float)
        mu_data = np.asarray(mu_data, float)
        self.x1, self.x2 = x1, x2

        # linear fit on the low-field region
        lin = B_data < x1
        A = np.stack([B_data[lin], np.ones(lin.sum())], axis=1)
        lin_a, lin_b = np.linalg.lstsq(A, mu_data[lin], rcond=None)[0]

        # exponential-decay fit mu = a*exp(b*B + c) + 1 on the saturated tail
        tail = B_data > x2
        Bt, mt = B_data[tail], mu_data[tail]
        y = np.log(np.maximum(mt - 1.0, 1e-12))
        A2 = np.stack([Bt, np.ones(len(Bt))], axis=1)
        b_, logac = np.linalg.lstsq(A2, y, rcond=None)[0]
        # python floats: a numpy scalar on the left of a tensor product
        # would route the product through numpy
        self.lin_a, self.lin_b = float(lin_a), float(lin_b)
        self.exp_a, self.exp_b, self.exp_c = float(np.exp(logac)), \
            float(b_), 0.0

        # C^1 cubic blend between x1 and x2
        f1 = self.lin_a * x1 + self.lin_b
        d1 = self.lin_a
        f2 = self.exp_a * np.exp(self.exp_b * x2 + self.exp_c) + 1.0
        d2 = (f2 - 1.0) * self.exp_b
        M = np.array([
            [3 * x1**2, 2 * x1, 1, 0],
            [3 * x2**2, 2 * x2, 1, 0],
            [x1**3, x1**2, x1, 1],
            [x2**3, x2**2, x2, 1],
        ])
        self.cubic = [float(c) for c in
                      np.linalg.solve(M, np.array([d1, d2, f1, f2]))]

    def __call__(self, B: torch.Tensor) -> torch.Tensor:
        """mu_r at |B|."""
        c = self.cubic
        lin = self.lin_a * B + self.lin_b
        cub = c[0] * B**3 + c[1] * B**2 + c[2] * B + c[3]
        expd = self.exp_a * torch.exp(self.exp_b * B + self.exp_c) + 1.0
        return torch.where(B < self.x1, lin,
                           torch.where(B < self.x2, cub, expd))
