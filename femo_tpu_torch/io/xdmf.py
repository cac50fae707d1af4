"""XDMF/HDF5 output: meshes and time-series fields (port of
femo_tpu/io/xdmf.py, writing the same XML and HDF5 layout).

Replacement for dolfinx.io.XDMFFile recorders: one XDMF time series per
recorded variable, keyed by optimization iteration.  Heavy data goes to
HDF5 via h5py (imported when a writer is made); the XDMF XML indexes it
for ParaView.  A field's tensor is copied to the host once per write.
"""

from __future__ import annotations

import os
from xml.sax.saxutils import escape

import numpy as np
import torch

_XDMF_TOPOLOGY = {
    "interval": ("Polyline", 2),
    "triangle": ("Triangle", 3),
    "quad": ("Quadrilateral", 4),
    "tet": ("Tetrahedron", 4),
    "hex": ("Hexahedron", 8),
}


class XDMFWriter:
    """Write a mesh plus a time series of node/cell fields.

    Usage::

        with XDMFWriter("out/state_u.xdmf", mesh) as xdmf:
            xdmf.write_function(u, t=0)
    """

    def __init__(self, filename: str, mesh):
        import h5py

        self.filename = filename
        base = os.path.splitext(filename)[0]
        self.h5name = base + ".h5"
        d = os.path.dirname(filename)
        if d:
            os.makedirs(d, exist_ok=True)
        self.mesh = mesh
        self._h5 = h5py.File(self.h5name, "w")
        self._steps: list[tuple[float, list[tuple[str, str, int, str]]]] = []
        # store mesh
        coords = mesh.coords
        if coords.shape[1] == 2:
            coords = np.concatenate(
                [coords, np.zeros((len(coords), 1))], axis=1)
        self._h5.create_dataset("mesh/coords", data=coords)
        # XDMF expects VTK cyclic corner order for quad/hex; the framework
        # convention is tensor order (the permutation is self-inverse)
        from ..mesh.gmsh_io import _to_tensor_order

        self._h5.create_dataset(
            "mesh/cells", data=_to_tensor_order(mesh.cells, mesh.cell_type))
        self._closed = False

    # -- API -------------------------------------------------------------------
    def write_mesh(self, *_):
        return self  # mesh written at construction (dolfinx API parity)

    def write_function(self, func, t: float = 0.0):
        """Write a Function (nodal CG1/DG0 data) at time/iteration t."""
        name = func.name
        arr = func.array
        if isinstance(arr, torch.Tensor):
            arr = arr.detach().cpu().numpy()
        arr = np.asarray(arr, dtype=np.float64)
        V = func.space
        ncomp = V.ncomp
        if V.element.family == "DG" and V.element.degree == 0:
            center = "Cell"
            data = arr.reshape(-1, ncomp) if ncomp > 1 else arr
        else:
            # sample at vertex dofs (P1 exact; P2 edge dofs dropped)
            nvert = self.mesh.n_nodes
            if ncomp == 1:
                data = arr[:nvert]
            else:
                data = arr.reshape(-1, ncomp)[:nvert]
            center = "Node"
        if ncomp == 2:  # pad vectors to 3D for ParaView
            data = np.concatenate(
                [data, np.zeros((len(data), 1))], axis=1)
        step = len(self._steps)
        path = f"fields/{name}/{step}"
        self._h5.create_dataset(path, data=data)
        self._h5.flush()
        attr_type = "Scalar" if ncomp == 1 else "Vector"
        self._steps.append(
            (float(t), [(name, path, center, attr_type)]))
        # keep the XDMF index valid after every step (recorders are often
        # never closed explicitly during optimization runs)
        self._write_xml()
        return self

    # dolfinx spelling
    write = write_function

    def close(self):
        if self._closed:
            return
        self._h5.close()
        self._write_xml()
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- XML -------------------------------------------------------------------
    def _write_xml(self):
        mesh = self.mesh
        topo, nv = _XDMF_TOPOLOGY[mesh.cell_type]
        h5 = os.path.basename(self.h5name)
        grids = []
        # mesh-only file: one grid with no attributes (still a valid mesh
        # for ParaView and read_xdmf_mesh)
        steps = self._steps or [(0.0, [])]
        for t, fields in steps:
            attrs = []
            for name, path, center, attr_type in fields:
                attrs.append(f"""
      <Attribute Name="{escape(name)}" AttributeType="{attr_type}" Center="{center}">
        <DataItem Dimensions="{self._dims(path)}" Format="HDF">{h5}:/{path}</DataItem>
      </Attribute>""")
            grids.append(f"""
    <Grid Name="step" GridType="Uniform">
      <Time Value="{t}"/>
      <Topology TopologyType="{topo}" NumberOfElements="{mesh.n_cells}">
        <DataItem Dimensions="{mesh.n_cells} {nv}" Format="HDF" NumberType="Int">{h5}:/mesh/cells</DataItem>
      </Topology>
      <Geometry GeometryType="XYZ">
        <DataItem Dimensions="{mesh.n_nodes} 3" Format="HDF">{h5}:/mesh/coords</DataItem>
      </Geometry>{''.join(attrs)}
    </Grid>""")
        xml = f"""<?xml version="1.0"?>
<Xdmf Version="3.0">
  <Domain>
    <Grid Name="series" GridType="Collection" CollectionType="Temporal">{''.join(grids)}
    </Grid>
  </Domain>
</Xdmf>
"""
        with open(self.filename, "w") as f:
            f.write(xml)

    def _dims(self, path):
        shape = self._h5f()[path].shape if not self._closed else None
        if shape is None:
            import h5py

            with h5py.File(self.h5name, "r") as f:
                shape = f[path].shape
        return " ".join(str(s) for s in shape)

    def _h5f(self):
        import h5py

        if self._h5 and self._h5.id.valid:
            return self._h5
        return h5py.File(self.h5name, "r")


class Recorder:
    """Per-variable XDMF time-series recorder hub (FEA.createRecorder
    parity: one file per recorded variable, keyed by opt_iter)."""

    def __init__(self, path: str = "records"):
        self.path = path
        self._writers: dict[str, XDMFWriter] = {}

    def write(self, name: str, func, iteration: int):
        if name not in self._writers:
            self._writers[name] = XDMFWriter(
                os.path.join(self.path, f"record_{name}.xdmf"), func.space.mesh)
        self._writers[name].write_function(func, t=iteration)

    def close(self):
        for w in self._writers.values():
            w.close()
