"""FEA utilities (port of femo_tpu/fea/utils.py): the error norm, partials
of a functional, nearest-node and polar dof lookups, and moved meshes."""

from __future__ import annotations

import numpy as np
import torch

from .assemble import assemble_scalar, compile_form
from .forms import FormDef, dx, grad
from .space import Function


def error_norm(f_ref: Function, f: Function, norm: str = "L2") -> float:
    """L2 (or, with any other `norm`, H1 = L2 + H1-seminorm) error norm
    between two Functions on the same space."""
    V = f.space
    a = Function(V, "a", f_ref.array)
    b = Function(V, "b", f.array)

    if norm == "L2":
        def integrand(w, g):
            d = w.a - w.b
            return torch.sum(d ** 2)
    else:
        def integrand(w, g):
            d = w.a - w.b
            gd = grad(w.a) - grad(w.b)
            return torch.sum(d ** 2) + torch.sum(gd ** 2)

    form = FormDef([dx(integrand)], coeffs=[a, b])
    return float(torch.sqrt(assemble_scalar(form)))


errorNorm = error_norm


def compute_partials(form: FormDef, wrt: str, values: dict | None = None):
    """dJ/d(coefficient `wrt`) of a scalar functional, by torch.autograd
    over the assembled form (the JAX package takes jax.grad)."""
    cf = compile_form(form)
    v = form.values()
    if values:
        v.update(values)
    x = v[wrt].detach().clone().requires_grad_(True)
    v[wrt] = x
    with torch.enable_grad():
        (g,) = torch.autograd.grad(cf.scalar(v), x)
    return g


assemble_partials = compute_partials


def find_node_indices(node_coordinates, coordinates) -> np.ndarray:
    """Index of the nearest mesh node of each point (cKDTree)."""
    from scipy.spatial import cKDTree

    tree = cKDTree(np.asarray(node_coordinates, float))
    _, idx = tree.query(np.asarray(coordinates, float))
    return np.atleast_1d(idx).astype(np.int32)


findNodeIndices = find_node_indices


def locate_dofs_polar(space, radius: float, angle_range=None,
                      atol: float = 1e-9, component=None) -> np.ndarray:
    """Dofs on a circle of the given radius, optionally within an angular
    window [lo, hi] (radians); for vector spaces every component's dof, or
    only `component`'s."""
    c = space.scalar_dof_coords
    r = np.hypot(c[:, 0], c[:, 1])
    mask = np.isclose(r, radius, atol=atol)
    if angle_range is not None:
        th = np.arctan2(c[:, 1], c[:, 0])
        lo, hi = angle_range
        mask &= (th >= lo) & (th <= hi)
    ids = np.nonzero(mask)[0]
    ncomp = space.ncomp
    if ncomp == 1:
        return ids.astype(np.int32)
    if component is None:
        return ((ids[:, None] * ncomp + np.arange(ncomp)[None, :])
                .reshape(-1).astype(np.int32))
    return (ids * ncomp + component).astype(np.int32)


locateDOFs = locate_dofs_polar


def move(mesh, displacement):
    """A NEW mesh with displaced coordinates: compiled forms keep their
    geometry, so build new spaces and forms on the moved mesh.

    displacement: (n_nodes, gdim) array or tensor, flat CG1 vector-dof
    array, or callable x(gdim, n) -> (gdim, n).
    """
    from ..mesh.mesh import Mesh

    coords = np.asarray(mesh.coords)
    if callable(displacement):
        d = np.asarray(displacement(coords.T)).T
    else:
        if isinstance(displacement, torch.Tensor):
            displacement = displacement.detach().cpu().numpy()
        d = np.asarray(displacement)
        if d.ndim == 1:
            d = d.reshape(-1, mesh.gdim)
    out = Mesh(coords + d, mesh.cells.copy(), mesh.cell_type,
               None if mesh.cell_tags is None else mesh.cell_tags.copy())
    out._facet_tag_array = mesh.facet_tags.copy()
    return out
