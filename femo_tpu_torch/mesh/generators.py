"""Structured mesh generators: the interval, the triangle/quad rectangle
and the unit square.

A copy of those three functions of femo_tpu/mesh/generators.py (numpy
only), kept beside the port because importing anything under femo_tpu
imports jax.  The node and cell numbering must stay identical to the JAX
package's, so both packages assemble the same systems.
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
