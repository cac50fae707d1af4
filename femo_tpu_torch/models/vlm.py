"""Differentiable fixed-wake Vortex Lattice Method (port of
femo_tpu/models/vlm.py).

The minimal VLM the FSI workloads couple to the shell (the reference
couples the external VAST solver, run_aeroelasticity_static_w_feedback.py:
258-355).  Everything is torch: the influence matrix is built by
broadcasting the Biot-Savart law over (collocation point, horseshoe)
pairs and the circulations come from one `torch.linalg.solve`, so the
forces are differentiable in the lattice node positions through
autograd, which is what the coupled adjoint's vector-Jacobian products
through `VLM.solve` need.  The system is small (128 panels at the FSI
anchor): a library solve, not a kernel.

Lattice convention: nodes (nc+1, ns+1, 3), chordwise index first, x
roughly streamwise.  Horseshoe vortices: bound segment at the panel
quarter chord, trailing legs to +x infinity.  Collocation at the panel's
3/4-chord centre.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import config, get_device

EPS = 1e-10


def _norm(v):
    return torch.linalg.norm(v, dim=-1)


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _biot_savart_segment(p, a, b):
    """Induced velocity at p of a unit vortex segment a->b (Biot-Savart);
    broadcasts over the leading dimensions."""
    r1 = p - a
    r2 = p - b
    r1n = _norm(r1) + EPS
    r2n = _norm(r2) + EPS
    cr = torch.linalg.cross(r1, r2, dim=-1)
    denom = r1n * r2n * (r1n * r2n + _dot(r1, r2)) + EPS
    return cr * (r1n + r2n)[..., None] / (4 * np.pi * denom)[..., None]


def _semi_inf(p, a, direction):
    """Induced velocity of a semi-infinite vortex from a along direction."""
    r = p - a
    rn = _norm(r) + EPS
    d = direction / torch.linalg.norm(direction)
    cr = torch.linalg.cross(d.expand_as(r), r, dim=-1)
    crn2 = torch.sum(cr**2, dim=-1) + EPS
    return cr / (4 * np.pi * crn2)[..., None] * (1.0 + _dot(d, r) / rn)[
        ..., None]


def _horseshoe_velocity(p, qA, qB, wake_dir):
    """Unit-strength horseshoes: trailing-in at qA, bound qA->qB,
    trailing-out at qB.  p (P, 1, 3), qA/qB (N, 3) -> (P, N, 3)."""
    v = _biot_savart_segment(p, qA, qB)
    v = v - _semi_inf(p, qA, wake_dir)  # inbound leg (reversed)
    v = v + _semi_inf(p, qB, wake_dir)
    return v


class VLM:
    """Fixed-wake VLM over an (nc, ns) panel lattice.

    solve(nodes, v_inf) -> dict with panel circulations, forces at the
    bound-vortex midpoints, the total force; coefficients() adds CL and
    CDi (induced, from the simple Kutta-Joukowski forces).  It runs on the
    device of the nodes it is given.
    """

    def __init__(self, nc: int, ns: int, rho: float = 1.0):
        self.nc, self.ns = nc, ns
        self.rho = rho

    @staticmethod
    def bound_midpoints_np(nodes):
        """Bound-vortex (quarter-chord) midpoints in numpy: the points of
        solve()'s forces ("points"), for building the RBF force maps on
        the host.  Must stay in step with _geometry's qA/qB."""
        lat = np.asarray(nodes)
        qA = lat[:-1, :-1] + 0.25 * (lat[1:, :-1] - lat[:-1, :-1])
        qB = lat[:-1, 1:] + 0.25 * (lat[1:, 1:] - lat[:-1, 1:])
        return (0.5 * (qA + qB)).reshape(-1, 3)

    def _geometry(self, nodes):
        # qA/qB have a numpy twin in bound_midpoints_np: change both
        n00 = nodes[:-1, :-1]
        n10 = nodes[1:, :-1]
        n01 = nodes[:-1, 1:]
        n11 = nodes[1:, 1:]
        # bound vortex at quarter chord (chordwise direction = axis 0)
        qA = n00 + 0.25 * (n10 - n00)
        qB = n01 + 0.25 * (n11 - n01)
        # collocation at 3/4 chord, mid span
        c0 = n00 + 0.75 * (n10 - n00)
        c1 = n01 + 0.75 * (n11 - n01)
        colloc = 0.5 * (c0 + c1)
        # panel normal
        nrm = torch.linalg.cross(n11 - n00, n01 - n10, dim=-1)
        nrm = nrm / (torch.linalg.norm(nrm, dim=-1, keepdim=True) + EPS)
        return (qA.reshape(-1, 3), qB.reshape(-1, 3),
                colloc.reshape(-1, 3), nrm.reshape(-1, 3))

    def solve(self, nodes, v_inf):
        """nodes (nc+1, ns+1, 3); v_inf (3,). Returns a dict of results."""
        v_inf = torch.as_tensor(v_inf, dtype=nodes.dtype, device=nodes.device)
        qA, qB, colloc, nrm = self._geometry(nodes)
        wake = v_inf / torch.linalg.norm(v_inf)

        vs = _horseshoe_velocity(colloc[:, None, :], qA, qB, wake)
        AIC = torch.einsum("ijk,ik->ij", vs, nrm)  # (np, np)
        rhs = -(nrm @ v_inf)  # no penetration: (v_inf + v_ind) . n = 0
        gamma = torch.linalg.solve(AIC, rhs)

        # Kutta-Joukowski forces at the bound-vortex midpoints:
        # F = rho (V x l) gamma, V = freestream + induced (all horseshoes)
        mid = 0.5 * (qA + qB)
        lvec = qB - qA
        vm = _horseshoe_velocity(mid[:, None, :], qA, qB, wake)
        vmid = v_inf + torch.einsum("j,ijk->ik", gamma, vm)
        forces = self.rho * torch.linalg.cross(vmid, lvec, dim=-1) \
            * gamma[:, None]
        total = forces.sum(dim=0)
        return dict(gamma=gamma, forces=forces, points=mid, total=total,
                    colloc=colloc, normals=nrm)

    def coefficients(self, nodes, v_inf, s_ref=None):
        out = self.solve(nodes, v_inf)
        v_inf = torch.as_tensor(v_inf, dtype=nodes.dtype, device=nodes.device)
        V = torch.linalg.norm(v_inf)
        if s_ref is None:
            s_ref = self._planform_area(nodes)  # projected planform area
        q = 0.5 * self.rho * V**2 * s_ref
        # lift: perpendicular to the freestream in the x-z plane
        vhat = v_inf / V
        lift_dir = torch.stack([-vhat[2], torch.zeros_like(vhat[0]),
                                vhat[0]])
        lift_dir = lift_dir / torch.linalg.norm(lift_dir)
        CL = torch.dot(out["total"], lift_dir) / q
        CDi = torch.dot(out["total"], vhat) / q
        return CL, CDi, out

    def _planform_area(self, nodes):
        n00 = nodes[:-1, :-1]
        n10 = nodes[1:, :-1]
        n01 = nodes[:-1, 1:]
        n11 = nodes[1:, 1:]
        d1 = (n11 - n00)[..., :2]
        d2 = (n01 - n10)[..., :2]
        area = 0.5 * torch.abs(
            d1[..., 0] * d2[..., 1] - d1[..., 1] * d2[..., 0])
        return area.sum()


def flat_wing_lattice_np(span: float, chord: float, nc: int, ns: int,
                         alpha_deg: float = 0.0) -> np.ndarray:
    """flat_wing_lattice's nodes in numpy (f64), for host-side setup."""
    x = np.linspace(0, chord, nc + 1)
    y = np.linspace(-span / 2, span / 2, ns + 1)
    X, Y = np.meshgrid(x, y, indexing="ij")
    a = np.deg2rad(alpha_deg)
    return np.stack([X * np.cos(a), Y, -X * np.sin(a)], axis=-1)


def flat_wing_lattice(span: float, chord: float, nc: int, ns: int,
                      alpha_deg: float = 0.0, device=None):
    """Rectangular planform lattice at incidence alpha (rotated about y),
    (nc+1, ns+1, 3) on `device` (default `config.device`, the card)."""
    return torch.as_tensor(
        flat_wing_lattice_np(span, chord, nc, ns, alpha_deg),
        dtype=config.dtype, device=get_device(device))
