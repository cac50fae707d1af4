"""Reference finite elements: shape-function tabulation and dof layout.

A copy of femo_tpu/elements/element.py (numpy only), kept beside the port
because importing anything under femo_tpu imports jax.  The tabulation must
stay identical to the JAX package's so both assemble the same tables.

All tabulation happens host-side in numpy; the assembly engine copies the
tables to the device once per compiled form.

Conventions (self-consistent, independent of FEniCS):
  * cell vertices in tensor/lexicographic order (see quadrature.py)
  * cell edges/faces enumerated as sorted vertex tuples in lexicographic
    order, e.g. triangle edges: (0,1), (0,2), (1,2)
  * local dof ordering: vertex dofs, then edge dofs, then face, then interior
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .quadrature import cell_rule

# ---------------------------------------------------------------------------
# Cell topology tables
# ---------------------------------------------------------------------------

CELL_DIM = {"interval": 1, "triangle": 2, "quad": 2, "tet": 3, "hex": 3}
CELL_NUM_VERTICES = {"interval": 2, "triangle": 3, "quad": 4, "tet": 4, "hex": 8}

# local facets as tuples of local vertex indices (lexicographic order)
CELL_FACETS = {
    "interval": ((0,), (1,)),
    "triangle": ((0, 1), (0, 2), (1, 2)),
    "quad": ((0, 1), (0, 2), (1, 3), (2, 3)),
    "tet": ((0, 1, 2), (0, 1, 3), (0, 2, 3), (1, 2, 3)),
    "hex": (
        (0, 1, 2, 3), (0, 1, 4, 5), (0, 2, 4, 6),
        (1, 3, 5, 7), (2, 3, 6, 7), (4, 5, 6, 7),
    ),
}

# local edges (dim-1 entities for 2D cells coincide with facets)
CELL_EDGES = {
    "interval": (),
    "triangle": ((0, 1), (0, 2), (1, 2)),
    "quad": ((0, 1), (0, 2), (1, 3), (2, 3)),
    "tet": ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)),
    "hex": (
        (0, 1), (0, 2), (0, 4), (1, 3), (1, 5), (2, 3),
        (2, 6), (3, 7), (4, 5), (4, 6), (5, 7), (6, 7),
    ),
}

# facet cell type (for facet quadrature)
FACET_CELL = {"interval": "point", "triangle": "interval", "quad": "interval",
              "tet": "triangle", "hex": "quad"}

REFERENCE_VERTICES = {
    "interval": np.array([[0.0], [1.0]]),
    "triangle": np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]]),
    "quad": np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0], [1.0, 1.0]]),
    "tet": np.array(
        [[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]]
    ),
    "hex": np.array(
        [
            [0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [1.0, 1.0, 0.0],
            [0.0, 0.0, 1.0], [1.0, 0.0, 1.0], [0.0, 1.0, 1.0], [1.0, 1.0, 1.0],
        ]
    ),
}


def map_facet_points(cell: str, local_facet: int, fpts: np.ndarray) -> np.ndarray:
    """Map reference-facet quadrature points into the reference cell.

    fpts: (nq, dim-1) points on the reference facet cell (interval/triangle),
    or (1, 0) for vertices of an interval. Returns (nq, dim).
    """
    verts = REFERENCE_VERTICES[cell][list(CELL_FACETS[cell][local_facet])]
    if cell == "interval":
        return verts[0][None, :].repeat(max(len(fpts), 1), axis=0)
    v0 = verts[0]
    tangents = verts[1:] - v0  # (dim-1 or more, dim)
    if cell in ("triangle", "quad"):
        return v0[None, :] + fpts[:, 0:1] * tangents[0][None, :]
    if cell == "tet":
        return v0[None, :] + fpts @ tangents[:2]
    if cell == "hex":
        # bilinear quad facet: use first two independent tangents
        t1 = tangents[0]
        t2 = tangents[1]
        return v0[None, :] + fpts[:, 0:1] * t1[None, :] + fpts[:, 1:2] * t2[None, :]
    raise ValueError(cell)


# ---------------------------------------------------------------------------
# Scalar basis definitions
# ---------------------------------------------------------------------------


def _tab_p1_interval(x):
    t = x[:, 0]
    N = np.stack([1 - t, t], axis=1)
    dN = np.zeros((len(t), 2, 1))
    dN[:, 0, 0] = -1.0
    dN[:, 1, 0] = 1.0
    return N, dN


def _tab_p2_interval(x):
    t = x[:, 0]
    N = np.stack(
        [2 * (t - 0.5) * (t - 1), 2 * t * (t - 0.5), 4 * t * (1 - t)], axis=1
    )
    dN = np.zeros((len(t), 3, 1))
    dN[:, 0, 0] = 4 * t - 3
    dN[:, 1, 0] = 4 * t - 1
    dN[:, 2, 0] = 4 - 8 * t
    return N, dN


def _tab_p3_interval(x):
    # cubic Lagrange, nodes 0, 1, 1/3, 2/3 (vertex dofs first, then interior)
    t = x[:, 0]
    n0 = -4.5 * (t - 1 / 3) * (t - 2 / 3) * (t - 1)
    n1 = 4.5 * t * (t - 1 / 3) * (t - 2 / 3)
    n2 = 13.5 * t * (t - 2 / 3) * (t - 1)
    n3 = -13.5 * t * (t - 1 / 3) * (t - 1)
    N = np.stack([n0, n1, n2, n3], axis=1)
    dN = np.zeros((len(t), 4, 1))
    dN[:, 0, 0] = -4.5 * (3 * t * t - 4 * t + 11 / 9)
    dN[:, 1, 0] = 4.5 * (3 * t * t - 2 * t + 2 / 9)
    dN[:, 2, 0] = 13.5 * (3 * t * t - (10 / 3) * t + 2 / 3)
    dN[:, 3, 0] = -13.5 * (3 * t * t - (8 / 3) * t + 1 / 3)
    return N, dN


def _tab_hermite_interval(x):
    """Cubic Hermite: dofs (u(0), u'(0), u(1), u'(1)).

    Used for the Euler-Bernoulli beam (4th-order PDE, W3; reference builds
    this via custom basix element, run_thickness_opt_cantilever_beam.py:101).
    Derivative dofs require per-cell scaling by cell length h, handled by
    Element.dof_scaling.
    """
    t = x[:, 0]
    N = np.stack(
        [
            1 - 3 * t**2 + 2 * t**3,
            t - 2 * t**2 + t**3,
            3 * t**2 - 2 * t**3,
            -(t**2) + t**3,
        ],
        axis=1,
    )
    dN = np.zeros((len(t), 4, 1))
    dN[:, 0, 0] = -6 * t + 6 * t**2
    dN[:, 1, 0] = 1 - 4 * t + 3 * t**2
    dN[:, 2, 0] = 6 * t - 6 * t**2
    dN[:, 3, 0] = -2 * t + 3 * t**2
    return N, dN


def _tab_p1_triangle(x):
    xx, yy = x[:, 0], x[:, 1]
    N = np.stack([1 - xx - yy, xx, yy], axis=1)
    dN = np.zeros((len(xx), 3, 2))
    dN[:, 0] = [-1.0, -1.0]
    dN[:, 1] = [1.0, 0.0]
    dN[:, 2] = [0.0, 1.0]
    return N, dN


def _tab_p2_triangle(x):
    xx, yy = x[:, 0], x[:, 1]
    L = [1 - xx - yy, xx, yy]
    dL = [np.array([-1.0, -1.0]), np.array([1.0, 0.0]), np.array([0.0, 1.0])]
    nq = len(xx)
    N = np.zeros((nq, 6))
    dN = np.zeros((nq, 6, 2))
    for i in range(3):
        N[:, i] = L[i] * (2 * L[i] - 1)
        dN[:, i] = (4 * L[i] - 1)[:, None] * dL[i][None, :]
    # edge dofs on edges (0,1), (0,2), (1,2)
    for k, (a, b) in enumerate(CELL_EDGES["triangle"]):
        N[:, 3 + k] = 4 * L[a] * L[b]
        dN[:, 3 + k] = 4 * (
            L[a][:, None] * dL[b][None, :] + L[b][:, None] * dL[a][None, :]
        )
    return N, dN


def _tab_q1_quad(x):
    xx, yy = x[:, 0], x[:, 1]
    N = np.stack(
        [(1 - xx) * (1 - yy), xx * (1 - yy), (1 - xx) * yy, xx * yy], axis=1
    )
    nq = len(xx)
    dN = np.zeros((nq, 4, 2))
    dN[:, 0, 0] = -(1 - yy); dN[:, 0, 1] = -(1 - xx)
    dN[:, 1, 0] = 1 - yy;    dN[:, 1, 1] = -xx
    dN[:, 2, 0] = -yy;       dN[:, 2, 1] = 1 - xx
    dN[:, 3, 0] = yy;        dN[:, 3, 1] = xx
    return N, dN


def _lag2_1d(t):
    """1D quadratic Lagrange at nodes 0, 1, 0.5 with derivatives."""
    n = np.stack([2 * (t - 0.5) * (t - 1), 2 * t * (t - 0.5), 4 * t * (1 - t)], axis=1)
    dn = np.stack([4 * t - 3, 4 * t - 1, 4 - 8 * t], axis=1)
    return n, dn


def _tab_q2_quad(x):
    """Biquadratic: 4 vertex + 4 edge-midpoint + 1 center dofs."""
    nx, dnx = _lag2_1d(x[:, 0])
    ny, dny = _lag2_1d(x[:, 1])
    # (i, j) 1D-node index pairs per local dof:
    # vertices (0,0),(1,0),(0,1),(1,1); edges (0,1):(m,0), (0,2):(0,m),
    # (1,3):(1,m), (2,3):(m,1); interior (m,m)   [m = index 2]
    pairs = [(0, 0), (1, 0), (0, 1), (1, 1),
             (2, 0), (0, 2), (1, 2), (2, 1), (2, 2)]
    nq = len(x)
    N = np.zeros((nq, 9))
    dN = np.zeros((nq, 9, 2))
    for k, (i, j) in enumerate(pairs):
        N[:, k] = nx[:, i] * ny[:, j]
        dN[:, k, 0] = dnx[:, i] * ny[:, j]
        dN[:, k, 1] = nx[:, i] * dny[:, j]
    return N, dN


def _tab_p1_tet(x):
    xx, yy, zz = x[:, 0], x[:, 1], x[:, 2]
    N = np.stack([1 - xx - yy - zz, xx, yy, zz], axis=1)
    dN = np.zeros((len(xx), 4, 3))
    dN[:, 0] = [-1, -1, -1]
    dN[:, 1] = [1, 0, 0]
    dN[:, 2] = [0, 1, 0]
    dN[:, 3] = [0, 0, 1]
    return N, dN


def _tab_p2_tet(x):
    xx, yy, zz = x[:, 0], x[:, 1], x[:, 2]
    L = [1 - xx - yy - zz, xx, yy, zz]
    dL = [
        np.array([-1.0, -1.0, -1.0]),
        np.array([1.0, 0.0, 0.0]),
        np.array([0.0, 1.0, 0.0]),
        np.array([0.0, 0.0, 1.0]),
    ]
    nq = len(xx)
    N = np.zeros((nq, 10))
    dN = np.zeros((nq, 10, 3))
    for i in range(4):
        N[:, i] = L[i] * (2 * L[i] - 1)
        dN[:, i] = (4 * L[i] - 1)[:, None] * dL[i][None, :]
    for k, (a, b) in enumerate(CELL_EDGES["tet"]):
        N[:, 4 + k] = 4 * L[a] * L[b]
        dN[:, 4 + k] = 4 * (
            L[a][:, None] * dL[b][None, :] + L[b][:, None] * dL[a][None, :]
        )
    return N, dN


def _tab_q1_hex(x):
    xx, yy, zz = x[:, 0], x[:, 1], x[:, 2]
    nq = len(xx)
    N = np.zeros((nq, 8))
    dN = np.zeros((nq, 8, 3))
    for k in range(8):
        i, j, l = k & 1, (k >> 1) & 1, (k >> 2) & 1
        fx = xx if i else 1 - xx
        fy = yy if j else 1 - yy
        fz = zz if l else 1 - zz
        dfx = 1.0 if i else -1.0
        dfy = 1.0 if j else -1.0
        dfz = 1.0 if l else -1.0
        N[:, k] = fx * fy * fz
        dN[:, k, 0] = dfx * fy * fz
        dN[:, k, 1] = fx * dfy * fz
        dN[:, k, 2] = fx * fy * dfz
    return N, dN


def _tab_dg0(x, cell):
    nq = len(x)
    return np.ones((nq, 1)), np.zeros((nq, 1, CELL_DIM[cell]))


def _tab_dg1(x, cell):
    # discontinuous P1: same basis as P1 but cell-interior dofs
    return _SCALAR_TABULATORS[("P", 1, cell)](x)


def _tab2_hermite_interval(x):
    t = x[:, 0]
    d2 = np.zeros((len(t), 4, 1, 1))
    d2[:, 0, 0, 0] = -6 + 12 * t
    d2[:, 1, 0, 0] = -4 + 6 * t
    d2[:, 2, 0, 0] = 6 - 12 * t
    d2[:, 3, 0, 0] = -2 + 6 * t
    return d2


def _tab2_p2_interval(x):
    t = x[:, 0]
    d2 = np.zeros((len(t), 3, 1, 1))
    d2[:, 0, 0, 0] = 4.0
    d2[:, 1, 0, 0] = 4.0
    d2[:, 2, 0, 0] = -8.0
    return d2


def _tab2_p1(x, nd, dim):
    return np.zeros((len(x), nd, dim, dim))


# second-derivative tabulators (for 4th-order forms: Euler-Bernoulli beam,
# reference run_thickness_opt_cantilever_beam.py:72-79 uses div(grad(u)))
_SCALAR_TABULATORS2 = {
    ("Hermite", 3, "interval"): _tab2_hermite_interval,
    ("P", 2, "interval"): _tab2_p2_interval,
}


# registry: (family, degree, cell) -> tabulator(pts) -> (N, dN)
_SCALAR_TABULATORS = {
    ("P", 1, "interval"): _tab_p1_interval,
    ("P", 2, "interval"): _tab_p2_interval,
    ("P", 3, "interval"): _tab_p3_interval,
    ("Hermite", 3, "interval"): _tab_hermite_interval,
    ("P", 1, "triangle"): _tab_p1_triangle,
    ("P", 2, "triangle"): _tab_p2_triangle,
    ("P", 1, "quad"): _tab_q1_quad,
    ("P", 2, "quad"): _tab_q2_quad,
    ("P", 1, "tet"): _tab_p1_tet,
    ("P", 2, "tet"): _tab_p2_tet,
    ("P", 1, "hex"): _tab_q1_hex,
}


# entity dof counts: (family, degree, cell) -> dofs per (vertex, edge, face, cell)
def _entity_dofs(family: str, degree: int, cell: str):
    dim = CELL_DIM[cell]
    if family == "DG":
        nd = {0: 1}.get(degree)
        if degree == 0:
            per = [0, 0, 0, 0]
            per[dim] = 1
            return tuple(per[: dim + 1]), 1
        if degree == 1:
            nv = CELL_NUM_VERTICES[cell]
            per = [0, 0, 0, 0]
            per[dim] = nv
            return tuple(per[: dim + 1]), nv
        raise NotImplementedError(f"DG{degree}")
    if family == "Hermite":
        assert cell == "interval" and degree == 3
        return (2, 0), 4
    if family == "P":
        if degree == 1:
            per = [1, 0, 0, 0]
        elif degree == 2:
            per = [1, 1, 0, 0]
        elif degree == 3 and cell == "interval":
            per = [1, 2, 0, 0]
        else:
            raise NotImplementedError(f"P{degree} on {cell}")
        nv = CELL_NUM_VERTICES[cell]
        ne = len(CELL_EDGES[cell])
        if cell == "interval":
            ne = 1  # the cell itself is the dim-1 entity holding "edge" dofs
        counts = {0: nv, 1: ne, 2: 0, 3: 0}
        if cell == "quad" and degree == 2:
            # interior dof
            nd = nv * per[0] + ne * per[1] + 1
            return tuple(per[: dim + 1]), nd
        nd = sum(counts[d] * per[d] for d in range(dim + 1))
        return tuple(per[: dim + 1]), nd
    raise NotImplementedError(family)


@dataclass(frozen=True)
class Element:
    """A (possibly vector-valued) finite element on a reference cell.

    For vector elements (ncomp > 1) the scalar basis is blocked: local dof
    k*ncomp + c is component c of scalar basis function k (node-major,
    matching dolfinx blocked layout).
    """

    cell: str
    family: str  # "P" | "DG" | "Hermite"
    degree: int
    ncomp: int = 1  # number of vector components (1 = scalar)

    # -- static properties --------------------------------------------------
    @property
    def dim(self) -> int:
        return CELL_DIM[self.cell]

    @property
    def nscalar_dofs(self) -> int:
        _, nd = _entity_dofs(self.family, self.degree, self.cell)
        return nd

    @property
    def ndofs(self) -> int:
        return self.nscalar_dofs * self.ncomp

    @property
    def entity_dofs(self) -> tuple:
        """Scalar dofs per entity dim (vertex, edge, [face], [cell])."""
        per, _ = _entity_dofs(self.family, self.degree, self.cell)
        return per

    @property
    def value_shape(self) -> tuple:
        return () if self.ncomp == 1 else (self.ncomp,)

    @property
    def discontinuous(self) -> bool:
        return self.family == "DG"

    # -- tabulation ----------------------------------------------------------
    def tabulate(self, pts: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Scalar basis at points: N (nq, nsd), dN (nq, nsd, dim)."""
        if self.family == "DG" and self.degree == 0:
            return _tab_dg0(pts, self.cell)
        if self.family == "DG" and self.degree == 1:
            return _tab_dg1(pts, self.cell)
        key = (self.family, self.degree, self.cell)
        if key not in _SCALAR_TABULATORS:
            raise NotImplementedError(key)
        return _SCALAR_TABULATORS[key](pts)

    def has_hessian_tab(self) -> bool:
        return (self.family, self.degree, self.cell) in _SCALAR_TABULATORS2

    def tabulate2(self, pts: np.ndarray) -> np.ndarray:
        """Second derivatives d2N (nq, nsd, dim, dim) in reference coords."""
        key = (self.family, self.degree, self.cell)
        if key in _SCALAR_TABULATORS2:
            return _SCALAR_TABULATORS2[key](pts)
        if self.degree <= 1:
            return np.zeros(
                (len(pts), self.nscalar_dofs, self.dim, self.dim))
        raise NotImplementedError(key)

    def quadrature(self, degree: int | None = None):
        """Default quadrature rule integrating products of this element."""
        if degree is None:
            degree = max(2 * self.degree, 1)
            if self.family == "Hermite":
                degree = 6
        return cell_rule(self.cell, degree)

    def has_dof_scaling(self) -> bool:
        return self.family == "Hermite"

    def dof_scaling_scalar(self, coords_e: np.ndarray):
        """Per-cell scalar-dof scaling (Hermite derivative dofs scale by h).

        coords_e: (n_cell_vertices, gdim) tensor — works under torch.func.
        """
        if self.family != "Hermite":
            return None
        import torch

        h = torch.linalg.norm(coords_e[1] - coords_e[0])
        one = torch.ones_like(h)
        return torch.stack([one, h, one, h])


def geometry_element(cell: str) -> Element:
    """The P1/Q1 element used for cell geometry interpolation."""
    return Element(cell, "P", 1, 1)
