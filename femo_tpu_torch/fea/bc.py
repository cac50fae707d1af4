"""Dirichlet boundary conditions (port of femo_tpu/fea/bc.py).

Strong BCs are enforced by row masking: the constrained residual is
``R_c = where(free, R(u), u - g)`` and constrained operators act as the
identity on fixed dofs.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import config, get_device
from .space import FunctionSpace


class DirichletBC:
    """u = value (scalar, or one per dof) on a set of dofs, given as
    `dofs` or located by the geometric predicate `where(x)` with x of
    shape (gdim, n)."""

    def __init__(self, space: FunctionSpace, value=0.0, dofs=None,
                 where=None, component=None):
        self.space = space
        if dofs is None:
            if where is None:
                raise ValueError("need dofs or where")
            dofs = space.locate_dofs_geometrical(where, component=component)
        self.dofs = np.asarray(dofs, np.int32)
        self.values = np.broadcast_to(
            np.asarray(value, float), (len(self.dofs),)).copy()


def bc_arrays(bcs, n_dofs: int, device=None):
    """Combine BCs into (free_mask (n,) bool, bc_values (n,)) tensors on
    `device` (default `config.device`, the card)."""
    device = get_device(device)
    mask = np.ones(n_dofs, bool)
    vals = np.zeros(n_dofs)
    for bc in bcs or ():
        mask[bc.dofs] = False
        vals[bc.dofs] = bc.values
    return (torch.as_tensor(mask, device=device),
            torch.as_tensor(vals, dtype=config.dtype, device=device))


def apply_bc(u, free_mask, bc_values):
    """Force BC values onto a dof vector."""
    return torch.where(free_mask, u, bc_values)


def constrain_residual(R, u, free_mask, bc_values):
    """R_c = R on free dofs; u - g on constrained dofs."""
    return torch.where(free_mask, R, u - bc_values)
