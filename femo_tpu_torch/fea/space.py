"""Function spaces, dofmaps, and Functions (port of femo_tpu/fea/space.py).

A FunctionSpace is an Element + a host-built numpy dofmap (cell -> global
dof indices) + scalar-dof coordinates, plus the device that its Functions
and compiled forms live on.  A Function is a named handle around a flat
dof tensor.  The port covers Lagrange spaces of degree 1 and 2 (the
shell's CG2 on triangles and Q2 on quads: vertex, then edge, then
cell-interior dofs, in the JAX package's order), the cubic Hermite
interval element (W3's beam: a value and a derivative dof per vertex, the
derivative dof at its vertex's coordinates), and the cell-wise DG spaces
(W1's DG0 control).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import config, get_device
from ..elements.element import Element
from ..mesh.mesh import Mesh

_FAMILY_ALIASES = {"CG": "P", "Lagrange": "P", "P": "P", "DG": "DG",
                   "Hermite": "Hermite"}


class FunctionSpace:
    """A Lagrange, Hermite or DG finite element space over a mesh, on one
    device.

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
                    f"family {family!r}: the port has Lagrange, Hermite "
                    "and DG spaces only")
            self.element = Element(
                mesh.cell_type, _FAMILY_ALIASES[family], int(degree), ncomp)
        if self.element.family not in ("P", "DG", "Hermite"):
            raise NotImplementedError(
                f"family {self.element.family!r}: the port has Lagrange, "
                "Hermite and DG spaces only")
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
            # entity dofmap: vertex dofs first, then edge dofs in the order
            # of mesh.edges (the np.unique order), then cell-interior dofs
            # (Q2's centre); Hermite derivative dofs share their vertex's
            # coordinates, edge dofs sit at edge midpoints, interior dofs
            # at the cell centroid
            pv = per[0]
            pe = per[1] if len(per) > 1 else 0
            vm = mesh.cells.astype(np.int64)  # (nc, nv)
            blocks = [(vm[:, :, None] * pv
                       + np.arange(pv)[None, None, :]).reshape(nc, -1)]
            coords = [np.repeat(mesh.coords, pv, axis=0)]
            offset = mesh.n_nodes * pv
            if pe:
                em = mesh.cell_edge_map.astype(np.int64)
                blocks.append((offset + em[:, :, None] * pe
                               + np.arange(pe)[None, None, :]).reshape(nc, -1))
                coords.append(np.repeat(
                    mesh.coords[mesh.edges].mean(axis=1), pe, axis=0))
                offset += len(mesh.edges) * pe
            n_int = el.nscalar_dofs - sum(b.shape[1] for b in blocks)
            if n_int > 0:
                blocks.append(offset + np.arange(nc, dtype=np.int64)[:, None]
                              * n_int + np.arange(n_int)[None, :])
                coords.append(np.repeat(
                    mesh.coords[mesh.cells].mean(axis=1), n_int, axis=0))
                offset += nc * n_int
            scalar_map = np.concatenate(blocks, axis=1)
            n_scalar = offset
            coords = np.concatenate(coords)

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
        # 0 point evaluation, 1 derivative (Hermite, k = 1 at each vertex)
        self.scalar_dof_kind = np.zeros(n_scalar, np.int8)
        if el.family == "Hermite":
            self.scalar_dof_kind[1::2] = 1

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

    def interpolate(self, fn, deriv_fn=None):
        """Interpolate fn(x: (gdim, n)) -> values at the dof points (for
        vector spaces fn returns (ncomp, n)); evaluated on the host.  For
        Hermite spaces deriv_fn gives the derivative dofs (default 0)."""
        V = self.space
        vals = np.asarray(fn(V.scalar_dof_coords.T))
        arr = np.zeros(V.n_dofs)
        if V.ncomp == 1:
            arr[:] = vals if vals.ndim == 1 else vals[0]
        else:
            for c in range(V.ncomp):
                arr[c:: V.ncomp] = vals[c]
        deriv = V.scalar_dof_kind == 1
        if deriv.any():
            dmask = np.repeat(deriv, V.ncomp)
            arr[dmask] = (0.0 if deriv_fn is None else np.asarray(
                deriv_fn(V.scalar_dof_coords.T))[deriv])
        self.array = torch.as_tensor(arr, dtype=config.dtype,
                                     device=V.device)
        return self

    def __repr__(self):
        return f"Function('{self.name}', {self.space})"


class TestFunction:
    """Marker for the test space of a residual form (UFL TestFunction
    parity): `FormDef(..., test=TestFunction(V))` is `test=V`."""

    def __init__(self, space: FunctionSpace):
        self.space = space
