"""Mesh import: gmsh ASCII (.msh v2.2/v4.1) and XDMF/HDF5.

A copy of femo_tpu/mesh/gmsh_io.py (numpy only; h5py is imported where
an XDMF file's HDF5 data is read), kept beside the port because importing
anything under femo_tpu imports jax.  Loads a mesh with subdomain (cell)
and boundary (facet) tags plus a name->tag association table (gmsh
physical names, or a configparser .ini sidecar).
"""

from __future__ import annotations

import os

import numpy as np

from .mesh import Mesh

# gmsh element type -> (cell_type, n_nodes)
_GMSH_CELL = {1: ("interval", 2), 2: ("triangle", 3), 3: ("quad", 4),
              4: ("tet", 4), 5: ("hex", 8)}
_DIM_OF = {"interval": 1, "triangle": 2, "quad": 4 // 2, "tet": 3, "hex": 3}


def read_msh(filename: str):
    """Parse a gmsh ASCII .msh (v2.2 or v4.1).

    Returns (coords, {cell_type: (conn, tags)}, physical_names).
    """
    with open(filename) as f:
        lines = f.read().splitlines()
    i = 0
    version = None
    nodes = {}
    elements: dict[str, list] = {}
    el_tags: dict[str, list] = {}
    physical = {}

    def section(name):
        nonlocal i
        while i < len(lines) and lines[i].strip() != f"${name}":
            i += 1
        if i >= len(lines):
            return False
        i += 1
        return True

    # version
    j = 0
    while j < len(lines):
        if lines[j].strip() == "$MeshFormat":
            version = float(lines[j + 1].split()[0])
            break
        j += 1
    if version is None:
        raise ValueError("not a gmsh file")

    i = 0
    if section("PhysicalNames"):
        n = int(lines[i])
        for k in range(n):
            parts = lines[i + 1 + k].split(maxsplit=2)
            physical[int(parts[1])] = parts[2].strip().strip('"')
        i += n + 1

    i = 0
    if version < 4.0:
        assert section("Nodes")
        n = int(lines[i])
        for k in range(n):
            p = lines[i + 1 + k].split()
            nodes[int(p[0])] = [float(p[1]), float(p[2]), float(p[3])]
        i = 0
        assert section("Elements")
        n = int(lines[i])
        for k in range(n):
            p = lines[i + 1 + k].split()
            etype = int(p[1])
            if etype not in _GMSH_CELL:
                continue
            ntags = int(p[2])
            phys = int(p[3]) if ntags >= 1 else 0
            ct, nv = _GMSH_CELL[etype]
            conn = [int(x) for x in p[3 + ntags : 3 + ntags + nv]]
            elements.setdefault(ct, []).append(conn)
            el_tags.setdefault(ct, []).append(phys)
    else:
        # v4.1: entity blocks
        assert section("Entities")
        # map (dim, entityTag) -> physical tag (first one)
        ent_phys = {}
        counts = [int(x) for x in lines[i].split()]
        i += 1
        for dim, cnt in enumerate(counts):
            for _ in range(cnt):
                p = lines[i].split()
                i += 1
                tag = int(p[0])
                nb = 7 if dim > 0 else 4
                nphys = int(p[nb])
                ent_phys[(dim, tag)] = (
                    int(p[nb + 1]) if nphys >= 1 else 0)
        i = 0
        assert section("Nodes")
        hdr = [int(x) for x in lines[i].split()]
        nblocks = hdr[0]
        i += 1
        for _ in range(nblocks):
            bd = [int(x) for x in lines[i].split()]
            nn = bd[3]
            ids = [int(lines[i + 1 + k]) for k in range(nn)]
            for k in range(nn):
                p = lines[i + 1 + nn + k].split()
                nodes[ids[k]] = [float(p[0]), float(p[1]), float(p[2])]
            i += 1 + 2 * nn
        i = 0
        assert section("Elements")
        hdr = [int(x) for x in lines[i].split()]
        nblocks = hdr[0]
        i += 1
        for _ in range(nblocks):
            dim, etag, etype, nel = [int(x) for x in lines[i].split()]
            phys = ent_phys.get((dim, etag), 0)
            for k in range(nel):
                p = [int(x) for x in lines[i + 1 + k].split()]
                if etype in _GMSH_CELL:
                    ct, nv = _GMSH_CELL[etype]
                    elements.setdefault(ct, []).append(p[1 : 1 + nv])
                    el_tags.setdefault(ct, []).append(phys)
            i += 1 + nel

    # renumber nodes densely
    ids = sorted(nodes)
    remap = {nid: k for k, nid in enumerate(ids)}
    coords = np.array([nodes[nid] for nid in ids])
    out = {}
    for ct, conn in elements.items():
        c = np.array([[remap[v] for v in e] for e in conn], np.int32)
        out[ct] = (c, np.array(el_tags[ct], np.int32))
    return coords, out, physical


# gmsh/VTK/XDMF list quad corners cyclically (counterclockwise) and hex
# corners as two cyclic faces; this framework's quad/hex convention is
# tensor/lexicographic order (elements/element.py REFERENCE_VERTICES), so
# vertices 2<->3 (and 6<->7) must swap on import or the bilinear/trilinear
# map becomes a bowtie (negative detJ on half the cell).
_CYCLIC_TO_TENSOR = {"quad": [0, 1, 3, 2], "hex": [0, 1, 3, 2, 4, 5, 7, 6]}


def _to_tensor_order(conn: np.ndarray, cell_type: str) -> np.ndarray:
    perm = _CYCLIC_TO_TENSOR.get(cell_type)
    return conn[:, perm] if perm is not None else conn


def import_mesh(path: str, cell_type: str | None = None) -> Mesh:
    """Load a mesh (gmsh .msh or XDMF .xdmf) with cell + facet tags.

    .msh: the highest-dimension element block becomes the cells (with
    subdomain tags); codimension-1 blocks become facet tags.  Physical
    names are attached as `mesh.region_names` (the reference's .ini
    association table role).  .xdmf dispatches to read_xdmf_mesh — the
    reference import_mesh reads XDMF (utils_dolfinx.py:69-123).
    """
    if os.path.splitext(path)[1].lower() in (".xdmf", ".xmf"):
        return read_xdmf_mesh(path)
    coords, blocks, physical = read_msh(path)
    order = ["hex", "tet", "quad", "triangle", "interval"]
    if cell_type is None:
        for ct in order:
            if ct in blocks:
                cell_type = ct
                break
    conn, tags = blocks[cell_type]
    conn = _to_tensor_order(conn, cell_type)
    from ..elements.element import CELL_DIM

    gdim = 3 if np.abs(coords[:, 2]).max() > 0 else CELL_DIM[cell_type]
    if CELL_DIM[cell_type] == 2 and np.abs(coords[:, 2]).max() == 0:
        coords_use = coords[:, :2]
    elif CELL_DIM[cell_type] == 1 and np.abs(coords[:, 1:]).max() == 0:
        coords_use = coords[:, :1]
    else:
        coords_use = coords
    mesh = Mesh(coords_use, conn, cell_type, cell_tags=tags)
    mesh.region_names = physical

    # facet tags from codim-1 blocks
    facet_ct = {"tet": "triangle", "hex": "quad", "triangle": "interval",
                "quad": "interval"}.get(cell_type)
    if facet_ct and facet_ct in blocks:
        fconn, ftags = blocks[facet_ct]
        keys = {tuple(sorted(f)): t for f, t in zip(fconn.tolist(),
                                                    ftags.tolist())}
        mf = mesh.facets
        arr = mesh.facet_tags
        for idx, fv in enumerate(mf.tolist()):
            t = keys.get(tuple(fv))
            if t is not None:
                arr[idx] = t
    return mesh


# ---------------------------------------------------------------------------
# XDMF/HDF5 import (the reference's import_mesh reads XDMF + meshtags,
# femo/fea/utils_dolfinx.py:69-123)
# ---------------------------------------------------------------------------

_XDMF_TO_CELL = {
    "polyline": "interval", "triangle": "triangle",
    "quadrilateral": "quad", "tetrahedron": "tet", "hexahedron": "hex",
}


def _read_dataitem(item, base_dir: str) -> np.ndarray:
    """Load one XDMF DataItem: HDF reference ("file.h5:/path") or inline."""
    fmt = (item.get("Format") or "XML").upper()
    text = (item.text or "").strip()
    if fmt == "HDF":
        import h5py

        fname, path = text.split(":", 1)
        with h5py.File(os.path.join(base_dir, fname), "r") as f:
            return np.asarray(f[path])
    arr = np.fromstring(text, sep=" ") if text else np.zeros(0)
    dims = [int(d) for d in (item.get("Dimensions") or "").split()]
    if dims:
        arr = arr.reshape(dims)
    if (item.get("NumberType") or "").lower() == "int":
        arr = arr.astype(np.int64)
    return arr


def _xdmf_grids(filename: str):
    """All Uniform grids in an XDMF file as
    (name, cell_type, conn, coords|None, cell_attr|None) tuples."""
    import xml.etree.ElementTree as ET

    base_dir = os.path.dirname(os.path.abspath(filename))
    root = ET.parse(filename).getroot()
    out = []
    for grid in root.iter("Grid"):
        topo = grid.find("Topology")
        if topo is None:
            continue  # collection wrapper
        tt = (topo.get("TopologyType") or topo.get("Type") or "").lower()
        ct = _XDMF_TO_CELL.get(tt)
        if ct is None:
            continue
        conn = _read_dataitem(topo.find("DataItem"), base_dir)
        conn = conn.reshape(len(conn), -1).astype(np.int64)
        geom = grid.find("Geometry")
        coords = None
        if geom is not None:
            coords = _read_dataitem(geom.find("DataItem"), base_dir)
            gt = (geom.get("GeometryType") or "XYZ").upper()
            coords = coords.reshape(len(coords), -1)[:, : (2 if gt == "XY"
                                                           else 3)]
        attr = None
        for a in grid.findall("Attribute"):
            if (a.get("Center") or "").lower() == "cell":
                attr = _read_dataitem(a.find("DataItem"), base_dir)
                attr = np.asarray(attr).reshape(-1).astype(np.int32)
                break
        out.append((grid.get("Name") or "", ct, conn, coords, attr))
    return out


def read_xdmf_mesh(filename: str, facet_tags_file: str | None = None,
                   cell_tags_file: str | None = None) -> Mesh:
    """Load a mesh (plus optional meshtags) from XDMF/HDF5.

    The first grid with geometry becomes the mesh; a same-file or
    separate-file grid of codimension-1 entities with a Cell-centered
    attribute becomes facet tags, a same-dimension one cell tags — the
    layout dolfinx XDMFFile.write_mesh/write_meshtags produces and the
    reference's import_mesh consumes (utils_dolfinx.py:69-123).
    """
    from ..elements.element import CELL_DIM

    grids = _xdmf_grids(filename)
    main = next((g for g in grids if g[3] is not None), None)
    if main is None:
        raise ValueError(f"no mesh grid with geometry in {filename}")
    _, ct, conn, coords, cattr = main
    conn = _to_tensor_order(conn, ct)
    tdim = CELL_DIM[ct]
    if coords.shape[1] == 3 and tdim <= 2 and np.abs(coords[:, 2]).max() == 0:
        coords = coords[:, :2]
    if coords.shape[1] == 2 and tdim == 1 and np.abs(coords[:, 1]).max() == 0:
        coords = coords[:, :1]
    mesh = Mesh(coords, conn.astype(np.int32), ct,
                cell_tags=cattr if cattr is not None else None)

    extra = [g for g in grids if g is not main]
    for f in (cell_tags_file, facet_tags_file):
        if f is not None:
            extra.extend(_xdmf_grids(f))
    facet_ct = {"tet": "triangle", "hex": "quad", "triangle": "interval",
                "quad": "interval", "interval": "point"}.get(ct)
    for _, gct, gconn, _, gattr in extra:
        if gattr is None:
            continue
        if gct == ct:  # subdomain tags on the cells themselves
            mesh.cell_tags = gattr.astype(np.int32)
        elif gct == facet_ct:  # boundary meshtags
            keys = {tuple(sorted(fv)): int(t)
                    for fv, t in zip(gconn.tolist(), gattr.tolist())}
            arr = mesh.facet_tags
            for idx, fv in enumerate(mesh.facets.tolist()):
                t = keys.get(tuple(fv))
                if t is not None:
                    arr[idx] = t
    return mesh


def read_association_table(path: str) -> dict:
    """Parse a .ini association table (name -> tag id), the reference's
    mesh-region naming sidecar (utils_dolfinx.py:110-118)."""
    import configparser

    cp = configparser.ConfigParser()
    cp.read(path)
    out = {}
    for sec in cp.sections():
        for name, val in cp.items(sec):
            try:
                out[name] = int(val)
            except ValueError:
                out[name] = val
    return out
