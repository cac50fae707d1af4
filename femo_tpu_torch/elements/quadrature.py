"""Quadrature rules on reference cells.

A copy of femo_tpu/elements/quadrature.py (numpy only): the analogue of
the Basix quadrature tables.  Rules are computed host-side with numpy once
and copied to the device by the assembly engine.

Reference cells (vertex coordinates):
  interval : [0, 1]
  triangle : (0,0), (1,0), (0,1)
  quad     : (0,0), (1,0), (0,1), (1,1)        (tensor / lexicographic order)
  tet      : (0,0,0), (1,0,0), (0,1,0), (0,0,1)
  hex      : tensor order over [0,1]^3
"""

from __future__ import annotations

import numpy as np


def gauss_legendre_01(n: int) -> tuple[np.ndarray, np.ndarray]:
    """n-point Gauss-Legendre rule on [0, 1]."""
    x, w = np.polynomial.legendre.leggauss(n)
    return (0.5 * (x + 1.0))[:, None], 0.5 * w


def interval_rule(degree: int):
    n = max(1, (degree + 2) // 2)
    return gauss_legendre_01(n)


# --- triangle (area = 1/2) ------------------------------------------------

_TRI_RULES: dict[int, tuple[np.ndarray, np.ndarray]] = {}


def _tri_rule(degree: int):
    if degree <= 1:
        pts = np.array([[1 / 3, 1 / 3]])
        wts = np.array([0.5])
    elif degree == 2:
        pts = np.array([[1 / 6, 1 / 6], [2 / 3, 1 / 6], [1 / 6, 2 / 3]])
        wts = np.full(3, 1 / 6)
    elif degree == 3:
        pts = np.array(
            [[1 / 3, 1 / 3], [0.6, 0.2], [0.2, 0.6], [0.2, 0.2]]
        )
        wts = np.array([-27 / 96, 25 / 96, 25 / 96, 25 / 96])
    elif degree == 4:
        a = 0.445948490915965
        b = 0.091576213509771
        wa = 0.223381589678011 / 2
        wb = 0.109951743655322 / 2
        pts = np.array(
            [
                [a, a], [1 - 2 * a, a], [a, 1 - 2 * a],
                [b, b], [1 - 2 * b, b], [b, 1 - 2 * b],
            ]
        )
        wts = np.array([wa, wa, wa, wb, wb, wb])
    else:  # degree 5 (Dunavant 7-point); good up to degree 5 exactly
        a = 0.470142064105115
        b = 0.101286507323456
        wa = 0.132394152788506 / 2
        wb = 0.125939180544827 / 2
        pts = np.array(
            [
                [1 / 3, 1 / 3],
                [a, a], [1 - 2 * a, a], [a, 1 - 2 * a],
                [b, b], [1 - 2 * b, b], [b, 1 - 2 * b],
            ]
        )
        wts = np.array([0.225 / 2, wa, wa, wa, wb, wb, wb])
    return pts, wts


def _jacobi_01(n: int, alpha: int):
    """n-point Gauss-Jacobi rule on [0,1] with weight (1-t)^alpha."""
    from scipy.special import roots_jacobi

    x, w = roots_jacobi(n, alpha, 0.0)
    return 0.5 * (x + 1.0), w / 2.0 ** (alpha + 1)


def triangle_conical_rule(degree: int):
    """Exact degree-`degree` rule on the reference triangle via the Duffy
    (collapsed-coordinate) conical product: Gauss-Legendre x Gauss-Jacobi(1,0).
    Arbitrary degree; (n^2) points."""
    n = degree // 2 + 1
    u, wu = gauss_legendre_01(n)
    u = u[:, 0]
    v, wv = _jacobi_01(n, 1)
    U, V = np.meshgrid(u, v, indexing="ij")
    pts = np.stack([(U * (1.0 - V)).ravel(), V.ravel()], axis=1)
    wts = np.outer(wu, wv).ravel()
    return pts, wts


def triangle_rule(degree: int):
    degree = max(degree, 1)
    if degree not in _TRI_RULES:
        _TRI_RULES[degree] = (_tri_rule(degree) if degree <= 5
                              else triangle_conical_rule(degree))
    return _TRI_RULES[degree]


def quad_rule(degree: int):
    """Tensor-product Gauss rule on [0,1]^2."""
    x1, w1 = interval_rule(degree)
    x = x1[:, 0]
    X, Y = np.meshgrid(x, x, indexing="ij")
    pts = np.stack([X.ravel(), Y.ravel()], axis=1)
    wts = np.outer(w1, w1).ravel()
    return pts, wts


_TET_RULES: dict[int, tuple[np.ndarray, np.ndarray]] = {}


def tet_conical_rule(degree: int):
    """Exact degree-`degree` rule on the reference tet via the collapsed
    conical product: GL x GJ(1,0) x GJ(2,0).  Arbitrary degree; n^3 points."""
    n = degree // 2 + 1
    u, wu = gauss_legendre_01(n)
    u = u[:, 0]
    v, wv = _jacobi_01(n, 1)
    w, ww = _jacobi_01(n, 2)
    U, V, W = np.meshgrid(u, v, w, indexing="ij")
    x = U * (1.0 - V) * (1.0 - W)
    y = V * (1.0 - W)
    pts = np.stack([x.ravel(), y.ravel(), W.ravel()], axis=1)
    wts = np.einsum("i,j,k->ijk", wu, wv, ww).ravel()
    return pts, wts


def tet_rule(degree: int):
    degree = max(degree, 1)
    if degree not in _TET_RULES:
        if degree <= 1:
            pts = np.array([[0.25, 0.25, 0.25]])
            wts = np.array([1 / 6])
        elif degree == 2:  # 4-point
            a = 0.585410196624969
            b = 0.138196601125011
            pts = np.array(
                [[a, b, b], [b, a, b], [b, b, a], [b, b, b]]
            )
            wts = np.full(4, 1 / 24)
        else:
            pts, wts = tet_conical_rule(degree)
        _TET_RULES[degree] = (pts, wts)
    return _TET_RULES[degree]


def hex_rule(degree: int):
    x1, w1 = interval_rule(degree)
    x = x1[:, 0]
    X, Y, Z = np.meshgrid(x, x, x, indexing="ij")
    pts = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)
    wts = np.einsum("i,j,k->ijk", w1, w1, w1).ravel()
    return pts, wts


_RULES = {
    "interval": interval_rule,
    "triangle": triangle_rule,
    "quad": quad_rule,
    "tet": tet_rule,
    "hex": hex_rule,
}


def cell_rule(cell: str, degree: int) -> tuple[np.ndarray, np.ndarray]:
    """Quadrature points (nq, dim) and weights (nq,) on the reference cell."""
    return _RULES[cell](degree)
