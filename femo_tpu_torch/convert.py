"""Carry the JAX package's state over to the port, as numpy arrays, so both
packages compute on the same mesh and inputs.  Reads only numpy fields
and imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import config
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


def step_inputs(dv, iq, device="cpu"):
    """(dv, iq) as tensors of the working dtype on `device` (from numpy
    arrays or anything np.asarray takes, e.g. jax arrays)."""
    return tuple(torch.as_tensor(np.array(a, np.float64),
                                 dtype=config.dtype, device=device)
                 for a in (dv, iq))
