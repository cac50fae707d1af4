"""Structured mesh generators: the interval, the triangle/quad rectangle,
the unit square, the tet/hex box and unit cube, and the annulus with
tagged rings.

A copy of femo_tpu/mesh/generators.py (numpy only), kept beside the port
because importing anything under femo_tpu imports jax.  The node and cell
numbering must stay identical to the JAX package's, so both packages
assemble the same systems.
"""

from __future__ import annotations

import numpy as np

from .mesh import Mesh


def create_interval_mesh(n: int, a: float = 0.0, b: float = 1.0) -> Mesh:
    x = np.linspace(a, b, n + 1)[:, None]
    cells = np.stack([np.arange(n), np.arange(1, n + 1)], axis=1)
    return Mesh(x, cells, "interval")


def create_rectangle_mesh(
    nx: int, ny: int, x0=0.0, y0=0.0, x1=1.0, y1=1.0, cell_type: str = "triangle",
    diagonal: str = "right",
) -> Mesh:
    """Structured rectangle mesh of triangles or quads."""
    xs = np.linspace(x0, x1, nx + 1)
    ys = np.linspace(y0, y1, ny + 1)
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    coords = np.stack([X.ravel(), Y.ravel()], axis=1)

    def vid(i, j):
        return i * (ny + 1) + j

    I, J = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    I, J = I.ravel(), J.ravel()
    v00, v10 = vid(I, J), vid(I + 1, J)
    v01, v11 = vid(I, J + 1), vid(I + 1, J + 1)
    if cell_type == "quad":
        cells = np.stack([v00, v10, v01, v11], axis=1)
    elif cell_type == "triangle":
        if diagonal == "right":
            t1 = np.stack([v00, v10, v11], axis=1)
            t2 = np.stack([v00, v11, v01], axis=1)
        elif diagonal == "left":
            t1 = np.stack([v00, v10, v01], axis=1)
            t2 = np.stack([v10, v11, v01], axis=1)
        elif diagonal == "crossed":
            # union-jack style alternating diagonals for symmetry
            alt = ((I + J) % 2).astype(bool)
            t1 = np.where(alt[:, None],
                          np.stack([v00, v10, v01], axis=1),
                          np.stack([v00, v10, v11], axis=1))
            t2 = np.where(alt[:, None],
                          np.stack([v10, v11, v01], axis=1),
                          np.stack([v00, v11, v01], axis=1))
        else:
            raise ValueError(diagonal)
        cells = np.concatenate(
            [np.stack([t1, t2], axis=1).reshape(-1, 3)], axis=0
        )
    else:
        raise ValueError(cell_type)
    return Mesh(coords, cells, cell_type)


def create_unit_square_mesh(n: int, cell_type: str = "triangle") -> Mesh:
    """Parity: createUnitSquareMesh (utils_dolfinx.py:136-140)."""
    return create_rectangle_mesh(n, n, cell_type=cell_type)


def create_box_mesh(
    nx: int, ny: int, nz: int, x0=0.0, y0=0.0, z0=0.0, x1=1.0, y1=1.0, z1=1.0,
    cell_type: str = "tet",
) -> Mesh:
    xs = np.linspace(x0, x1, nx + 1)
    ys = np.linspace(y0, y1, ny + 1)
    zs = np.linspace(z0, z1, nz + 1)
    X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
    coords = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)

    def vid(i, j, k):
        return (i * (ny + 1) + j) * (nz + 1) + k

    I, J, K = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                          indexing="ij")
    I, J, K = I.ravel(), J.ravel(), K.ravel()
    c = [vid(I + a, J + b, K + d) for d in (0, 1) for b in (0, 1) for a in (0, 1)]
    # tensor vertex order: (x fastest) v0..v7
    v = np.stack([c[0], c[1], c[2], c[3], c[4], c[5], c[6], c[7]], axis=1)
    if cell_type == "hex":
        return Mesh(coords, v, "hex")
    if cell_type == "tet":
        # 6-tet (Kuhn) subdivision of each hex, consistent across faces
        idx = [(0, 1, 3, 7), (0, 1, 5, 7), (0, 2, 3, 7),
               (0, 2, 6, 7), (0, 4, 5, 7), (0, 4, 6, 7)]
        tets = np.concatenate(
            [v[:, list(t)] for t in idx], axis=0
        )
        return Mesh(coords, tets, "tet")
    raise ValueError(cell_type)


def create_unit_cube_mesh(n: int, cell_type: str = "tet") -> Mesh:
    return create_box_mesh(n, n, n, cell_type=cell_type)


def create_annulus_mesh(
    n_r: int, n_theta: int, r_inner: float, r_outer: float,
    radial_breaks: list[float] | None = None,
    ring_tags: list[int] | None = None,
    cell_type: str = "triangle",
) -> Mesh:
    """Annulus mesh with optional tagged concentric rings.

    This procedurally builds the multi-subdomain topology the reference motor
    workload imports from gmsh (`run_motor_opt.py:51-59`): concentric rings
    (rotor core / magnets / air gap / windings / stator core) become tagged
    cell subdomains.
    """
    radii_all = [r_inner] + (radial_breaks or []) + [r_outer]
    # distribute n_r layers over ring segments proportional to thickness
    segs = []
    total = r_outer - r_inner
    for i in range(len(radii_all) - 1):
        frac = (radii_all[i + 1] - radii_all[i]) / total
        segs.append(max(1, int(round(n_r * frac))))
    radii = []
    for i in range(len(radii_all) - 1):
        r = np.linspace(radii_all[i], radii_all[i + 1], segs[i] + 1)
        radii.extend(r[:-1] if i < len(radii_all) - 2 else r)
    radii = np.array(radii if radii else np.linspace(r_inner, r_outer, n_r + 1))
    nr = len(radii) - 1
    theta = np.linspace(0, 2 * np.pi, n_theta + 1)[:-1]
    R, T = np.meshgrid(radii, theta, indexing="ij")
    coords = np.stack([(R * np.cos(T)).ravel(), (R * np.sin(T)).ravel()], axis=1)

    def vid(i, j):
        return i * n_theta + (j % n_theta)

    I, J = np.meshgrid(np.arange(nr), np.arange(n_theta), indexing="ij")
    I, J = I.ravel(), J.ravel()
    v00, v10 = vid(I, J), vid(I + 1, J)
    v01, v11 = vid(I, J + 1), vid(I + 1, J + 1)
    if cell_type == "quad":
        cells = np.stack([v00, v10, v01, v11], axis=1)
        ring_of_cell = I
    else:
        t1 = np.stack([v00, v10, v11], axis=1)
        t2 = np.stack([v00, v11, v01], axis=1)
        cells = np.stack([t1, t2], axis=1).reshape(-1, 3)
        ring_of_cell = np.repeat(I, 2)
    mesh = Mesh(coords, cells, cell_type)
    if radial_breaks is not None and ring_tags is not None:
        # map each layer to its ring segment tag
        layer_tag = np.concatenate(
            [np.full(s, ring_tags[i], np.int32) for i, s in enumerate(segs)]
        )
        mesh.cell_tags = layer_tag[ring_of_cell]
    return mesh
