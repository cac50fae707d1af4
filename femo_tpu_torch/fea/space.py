"""Function spaces, dofmaps, and Functions (port of femo_tpu/fea/space.py).

A FunctionSpace is an Element + a host-built numpy dofmap (cell -> global
dof indices) + scalar-dof coordinates, plus the device that its Functions
and compiled forms live on.  A Function is a named handle around a flat
dof tensor.  The port covers degree-1 Lagrange spaces (the motor's and
W1's CG1, scalar and ncomp=2) and the cell-wise DG spaces (W1's DG0
control).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import config, get_device
from ..elements.element import Element
from ..mesh.mesh import Mesh

_FAMILY_ALIASES = {"CG": "P", "Lagrange": "P", "P": "P", "DG": "DG"}


class FunctionSpace:
    """A Lagrange or DG finite element space over a mesh, on one device.

    Parameters
    ----------
    mesh : Mesh
    spec : ("CG", 1) style tuple, or an Element
    ncomp : vector components
    device : where Functions and compiled forms of this space live
        (default `config.device`, the card)
    """

    def __init__(self, mesh: Mesh, spec, ncomp: int = 1, device=None):
        self.mesh = mesh
        self.device = get_device(device)
        if isinstance(spec, Element):
            self.element = spec
        else:
            family, degree = spec
            if family not in _FAMILY_ALIASES:
                raise NotImplementedError(
                    f"family {family!r}: the port has Lagrange and DG "
                    "spaces only")
            self.element = Element(
                mesh.cell_type, _FAMILY_ALIASES[family], int(degree), ncomp)
        if self.element.family not in ("P", "DG"):
            raise NotImplementedError(
                f"family {self.element.family!r}: the port has Lagrange "
                "and DG spaces only")
        self._build_dofmap()

    # -- dofmap construction (host, numpy) ------------------------------------
    def _build_dofmap(self):
        mesh, el = self.mesh, self.element
        per = el.entity_dofs  # scalar dofs per (vertex, edge, [face], [cell])
        nc = mesh.n_cells
        if el.family == "DG":
            nsd = el.nscalar_dofs
            scalar_map = (np.arange(nc, dtype=np.int64)[:, None] * nsd
                          + np.arange(nsd)[None, :])
            n_scalar = nc * nsd
            if nsd == 1:  # DG0: the cell centroid
                coords = mesh.coords[mesh.cells].mean(axis=1)
            else:  # DG1: vertex positions per cell
                coords = mesh.coords[mesh.cells].reshape(-1, mesh.gdim)
        else:
            if any(per[1:]) or el.nscalar_dofs != per[0] * mesh.cells.shape[1]:
                raise NotImplementedError(
                    "the port builds vertex-only (degree-1) Lagrange dofmaps")
            pv = per[0]
            vm = mesh.cells.astype(np.int64)  # (nc, nv)
            scalar_map = (vm[:, :, None] * pv
                          + np.arange(pv)[None, None, :]).reshape(nc, -1)
            n_scalar = mesh.n_nodes * pv
            coords = np.zeros((n_scalar, mesh.gdim))
            for k in range(pv):
                coords[np.arange(mesh.n_nodes) * pv + k] = mesh.coords

        self.n_scalar_dofs = int(n_scalar)
        ncp = el.ncomp
        if ncp == 1:
            dofmap = scalar_map
        else:
            dofmap = (
                scalar_map[:, :, None] * ncp + np.arange(ncp)[None, None, :]
            ).reshape(nc, -1)
        self.dofmap = dofmap.astype(np.int32)
        self.n_dofs = int(n_scalar * ncp)
        self.scalar_dof_coords = coords

    # -- public helpers --------------------------------------------------------
    @property
    def ncomp(self) -> int:
        return self.element.ncomp

    def locate_dofs_geometrical(self, predicate, component=None) -> np.ndarray:
        """Dof indices whose node satisfies predicate(x: (gdim, n)) -> bool."""
        mask = np.asarray(predicate(self.scalar_dof_coords.T), bool)
        scalar_ids = np.nonzero(mask)[0]
        if self.ncomp == 1:
            return scalar_ids.astype(np.int32)
        if component is None:
            return (
                (scalar_ids[:, None] * self.ncomp
                 + np.arange(self.ncomp)[None, :])
                .reshape(-1)
                .astype(np.int32)
            )
        return (scalar_ids * self.ncomp + component).astype(np.int32)

    def new_array(self, val: float = 0.0) -> torch.Tensor:
        return torch.full((self.n_dofs,), val, dtype=config.dtype,
                          device=self.device)

    def __repr__(self):
        e = self.element
        return (
            f"FunctionSpace({e.family}{e.degree}"
            + (f"^{e.ncomp}" if e.ncomp > 1 else "")
            + f" on {self.mesh}, n_dofs={self.n_dofs}, {self.device})"
        )


class Function:
    """A named dof vector in a FunctionSpace."""

    def __init__(self, space: FunctionSpace, name: str | None = None,
                 array=None):
        self.space = space
        self.name = name or "f"
        self.array = (
            space.new_array() if array is None
            else torch.as_tensor(array, dtype=config.dtype,
                                 device=space.device)
        )

    def rename(self, name: str, *_):
        self.name = name

    def set(self, val: float):
        self.array = self.space.new_array(val)

    def interpolate(self, fn):
        """Interpolate fn(x: (gdim, n)) -> values at the dof points (for
        vector spaces fn returns (ncomp, n)); evaluated on the host."""
        V = self.space
        vals = np.asarray(fn(V.scalar_dof_coords.T))
        arr = np.zeros(V.n_dofs)
        if V.ncomp == 1:
            arr[:] = vals if vals.ndim == 1 else vals[0]
        else:
            for c in range(V.ncomp):
                arr[c:: V.ncomp] = vals[c]
        self.array = torch.as_tensor(arr, dtype=config.dtype,
                                     device=V.device)
        return self

    def __repr__(self):
        return f"Function('{self.name}', {self.space})"
