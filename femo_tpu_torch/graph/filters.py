"""Density filter, a pre-processor operation (port of
femo_tpu/graph/filters.py).

A linear "hat-kernel" smoothing over element centroids within radius
beta * h_avg: w_ij = (r - d_ij) / sum_j (r - d_ij).  The weights are
built once on the host with a scipy cKDTree; the product sums through an
owner table (ops/scatter.py), in a fixed order, where the JAX package
uses segment_sum.  It is differentiable, so the filter chains into the
adjoint.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import config, get_device
from ..ops.scatter import OwnerTable


class DensityFilter:
    """Linear density filter over points (element centroids).

    Parameters
    ----------
    points : (n, dim) coordinates (element centroids for DG0 design fields)
    radius : filter radius; or pass beta and h_avg (radius = beta * h_avg)
    device : where the weights live (default `config.device`, the card)
    """

    def __init__(self, points: np.ndarray, radius: float | None = None,
                 beta: float = 2.0, h_avg: float | None = None,
                 device=None):
        from scipy.spatial import cKDTree

        device = get_device(device)
        points = np.asarray(points, float)
        n = len(points)
        if radius is None:
            radius = beta * float(h_avg)
        tree = cKDTree(points)
        pairs = tree.query_pairs(radius, output_type="ndarray")
        # symmetric neighbor list incl. self
        rows = np.concatenate([pairs[:, 0], pairs[:, 1], np.arange(n)])
        cols = np.concatenate([pairs[:, 1], pairs[:, 0], np.arange(n)])
        d = np.linalg.norm(points[rows] - points[cols], axis=1)
        w = radius - d
        wsum = np.bincount(rows, weights=w, minlength=n)
        w = w / wsum[rows]
        self.n = n
        self.rows = torch.as_tensor(rows.astype(np.int64), device=device)
        self.cols = torch.as_tensor(cols.astype(np.int64), device=device)
        self.weights = torch.as_tensor(w, dtype=config.dtype, device=device)
        self.radius = radius
        self._table = OwnerTable(rows, len(rows), n, device=device)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """Filtered field W x, differentiable."""
        return self._table.sum(self.weights * x[self.cols])

    def as_operation(self, name_in: str = "density_unfiltered",
                     name_out: str = "density"):
        """(fn, inputs, outputs) triple for Model.add_op."""
        return (lambda x: self(x)), [name_in], [name_out]
