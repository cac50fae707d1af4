"""RBF nodal transfer maps for fluid-structure coupling (port of
femo_tpu/models/coupling.py).

Radial-basis influence matrices between non-matching point clouds with
Gaussian, bump or thin-plate-spline kernels, row-normalized for
displacement transfer; force transfer uses the transpose (virtual-work
conservative), optionally weighted by the structure's lumped mass.  The
maps are built on the host in numpy; `NodalMap.W` is their copy on the
map's device, made at first use.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import config, get_device


def rbf_kernel_matrix(x_to: np.ndarray, x_from: np.ndarray,
                      kind: str = "gaussian", eps: float = 1.0):
    """Influence matrix G[i, j] = phi(|x_to_i - x_from_j|), from the
    squared distances d2 = |a|^2 + |b|^2 - 2 a.b^T (one gemm)."""
    d2 = (np.sum(x_to**2, axis=1)[:, None]
          + np.sum(x_from**2, axis=1)[None, :]
          - 2.0 * (x_to @ x_from.T))
    np.maximum(d2, 0.0, out=d2)  # clip gemm roundoff
    e2d2 = (eps * eps) * d2
    if kind == "gaussian":
        G = np.exp(-e2d2)
    elif kind == "bump":
        arg = np.where(e2d2 < 1.0, 1.0 - e2d2, 1.0)
        G = np.where(e2d2 < 1.0, np.exp(-1.0 / np.maximum(arg, 1e-14)),
                     0.0)
    elif kind == "thin_plate":
        # r^2 log r = 0.5 r^2 log(r^2)
        r2 = np.maximum(d2, 1e-28)
        G = 0.5 * r2 * np.log(r2)
    else:
        raise ValueError(kind)
    return G


class NodalMap:
    """Row-normalized RBF interpolation from source to target points.

    Displacement transfer: d_to = W @ d_from (per component).
    Conservative force transfer: f_from = W^T @ f_to (virtual work).
    """

    def __init__(self, x_from: np.ndarray, x_to: np.ndarray,
                 kind: str = "gaussian", eps: float | None = None,
                 device=None):
        x_from = np.asarray(x_from, float)
        x_to = np.asarray(x_to, float)
        self.device = get_device(device)
        if eps is None:
            # support of a few spacings of the coarser scale in play: the
            # source spacing and the target-to-nearest-source distance
            from scipy.spatial import cKDTree

            tree = cKDTree(x_from)
            dd, _ = tree.query(x_from, k=min(2, len(x_from)))
            h = float(np.mean(dd[:, -1])) if len(x_from) > 1 else 1.0
            d_to, _ = tree.query(x_to, k=1)
            h = max(h, float(np.mean(d_to)))
            eps = 1.0 / max(3.0 * h, 1e-12)
        G = rbf_kernel_matrix(x_to, x_from, kind, eps)
        rowsum = G.sum(axis=1, keepdims=True)
        self.W_np = G / np.maximum(rowsum, 1e-14)
        self._W_dev = None
        self.eps = eps

    @property
    def W(self) -> torch.Tensor:
        if self._W_dev is None:
            self._W_dev = torch.as_tensor(self.W_np, dtype=config.dtype,
                                          device=self.device)
        return self._W_dev

    def map_displacements(self, d_from: torch.Tensor) -> torch.Tensor:
        """(n_from, k) or (n_from,) -> (n_to, ...)."""
        return self.W @ d_from

    def map_forces_conservative(self, f_to: torch.Tensor) -> torch.Tensor:
        """Transpose map: conserves total force and virtual work."""
        return self.W.T @ f_to


def force_map_mass_weighted(nodal_map: NodalMap, lumped_mass: torch.Tensor):
    """fn(f_to) -> per-area nodal traction on the structure: W^T f
    divided by the structure's lumped mass."""

    def fmap(f_to):
        return (nodal_map.W.T @ f_to) / lumped_mass[:, None]

    return fmap
