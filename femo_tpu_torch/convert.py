"""Carry the JAX package's state over to the port, as numpy arrays, so both
packages compute on the same mesh and inputs.  Reads only numpy fields
and imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import config, get_device
from .mesh.mesh import Mesh


def mesh_from_jax(jmesh) -> Mesh:
    """A port Mesh from a femo_tpu Mesh's numpy fields (coords, cells,
    cell type, cell tags, facet tags).  The facet tags are in the facet
    numbering that both packages derive identically from (coords,
    cells)."""
    mesh = Mesh(np.asarray(jmesh.coords), np.asarray(jmesh.cells),
                jmesh.cell_type,
                cell_tags=None if jmesh.cell_tags is None
                else np.asarray(jmesh.cell_tags))
    ft = np.asarray(jmesh.facet_tags)
    if ft.shape != (mesh.n_facets,):
        raise ValueError(f"facet_tags shape {ft.shape}, mesh has "
                         f"{mesh.n_facets} facets")
    mesh.facet_tags[:] = ft
    return mesh


def array_from_jax(a, device=None) -> torch.Tensor:
    """A tensor of the working dtype on `device` (default `config.device`)
    from a numpy array or anything np.asarray takes, e.g. a jax array or
    a femo_tpu Function's `.array` (the shell's thickness and force
    fields, a state vector)."""
    return torch.as_tensor(np.array(a, np.float64), dtype=config.dtype,
                           device=get_device(device))


def step_inputs(dv, iq, device=None):
    """(dv, iq) as tensors of the working dtype on `device` (default
    `config.device`)."""
    return tuple(array_from_jax(a, device) for a in (dv, iq))


def function_from_jax(jfunc, space):
    """A port Function on `space` (the port's counterpart of the JAX
    Function's space) with the JAX Function's name and dof values."""
    from .fea.space import Function

    arr = np.asarray(jfunc.array)
    if arr.shape != (space.n_dofs,):
        raise ValueError(f"{jfunc.name}: {arr.shape} dofs, the space has "
                         f"{space.n_dofs}")
    return Function(space, jfunc.name, array_from_jax(arr, space.device))
