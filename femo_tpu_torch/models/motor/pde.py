"""Motor PDE kernels (port of femo_tpu/models/motor/pde.py): nonlinear
magnetostatics in a deformed configuration, hyperelastic mesh motion with
Nitsche interface BCs, and the B-power loss functionals.

One fused cell kernel gathers per-cell material properties from
tag-indexed tables (steel B-H curve, magnet remanence, winding currents)
instead of one integral per subdomain.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import jvp

from ...fea.assemble import _det_small, _inv_small
from ...fea.forms import FormDef, dS, defF, detF, dot, ds, dx, grad
from .mesh import N_MAGNETS, RADII, MotorTags
from .permeability import PiecewiseBHCurve

T = MotorTags
VACUUM_PERM = 4e-7 * np.pi
EPS = 3e-16
NTAGS = 64  # table size >= max subdomain tag + 1


def source_tables(iq, angle, Hc=838.0e3):
    """Tag-indexed magnet-H and winding-current tables, differentiable in
    (iq, angle): built out of place from the sources, so autograd reaches
    iq.  Returns (Htable (NTAGS, 2), Jtable (NTAGS,))."""
    p = N_MAGNETS
    dt, dev = iq.dtype, iq.device
    base = 2 * np.pi / p / 2
    sweep = 2 * np.pi / p
    i = torch.arange(p, dtype=dt, device=dev)
    flux_angle = base + i * sweep + angle * 2 / p
    sgn = torch.as_tensor([(-1.0) ** k for k in range(p)], dtype=dt,
                          device=dev)
    Hx = sgn * Hc * torch.cos(flux_angle)
    Hy = sgn * Hc * torch.sin(flux_angle)

    def padded(rows, first):
        lead = torch.zeros((first,) + rows.shape[1:], dtype=dt, device=dev)
        tail = torch.zeros((NTAGS - first - rows.shape[0],) + rows.shape[1:],
                           dtype=dt, device=dev)
        return torch.cat([lead, rows, tail])

    Htable = padded(torch.stack([Hx, Hy], dim=1), T.MAGNET_FIRST)

    iA = iq * torch.sin(angle) + EPS
    iB = iq * torch.sin(angle - 2 * np.pi / 3) + EPS
    iC = iq * torch.sin(angle + 2 * np.pi / 3) + EPS
    coils = []
    for pole in range(p):  # three coils per pole: [B-, A+, C-] * (-1)^pole
        s = (-1.0) ** pole
        coils += [-s * iB, s * iA, -s * iC]
    Jtable = padded(torch.stack(coils), T.WINDING_FIRST)
    return Htable, Jtable


def relative_permeability(tag, B_norm, bh: PiecewiseBHCurve):
    """Tag-dispatched mu_r: B-H law in steel, 1.05 in magnets, else 1."""
    steel = (tag == T.ROTOR_STEEL) | (tag == T.STATOR_STEEL)
    magnet = (tag >= T.MAGNET_FIRST) & (tag <= T.MAGNET_LAST)
    return torch.where(steel, bh(B_norm),
                       torch.where(magnet, torch.full_like(B_norm, 1.05),
                                   torch.ones_like(B_norm)))


def em_residual_form(A_z, uhat, Htable, Jtable, bh: PiecewiseBHCurve,
                     test_space=None):
    """Magnetostatics residual: div(1/(mu0 mur) gradx A_z) = J_s on the
    deformed configuration, fused over all subdomains."""

    uname, hname = A_z.name, uhat.name

    def em(w, g):
        Fh = defF(getattr(w, hname))
        Jh = _det_small(Fh)
        Finv = _inv_small(Fh, Jh)
        gu = dot(grad(getattr(w, uname)), Finv)
        gv = dot(grad(w.v), Finv)
        Bn = torch.sqrt(gu[0] ** 2 + gu[1] ** 2 + EPS)
        mur = relative_permeability(g.tag, Bn, bh)
        res = (1.0 / VACUUM_PERM) * (1.0 / mur) * dot(gu, gv) * Jh
        # magnet source: inner(H, curl v)
        H = w.Htable.val[g.tag]
        curl_v = torch.stack([gv[1], -gv[0]])
        res = res - dot(H, curl_v) * Jh
        # winding source
        res = res - w.Jtable.val[g.tag] * w.v * Jh
        return res

    return FormDef([dx(em, qdeg=2)], coeffs=[A_z, uhat, Htable, Jtable],
                   test=test_space or A_z.space)


def em_nitsche_boundary_form(A_z, uhat, bh: PiecewiseBHCurve,
                             g_bc: float = 0.0, sym: bool = True,
                             beta: float = 1e6, tags=(1000, 1001),
                             test_space=None):
    """Nitsche weak enforcement of A_z = g on the exterior boundaries in
    the deformed configuration: the boundary normal and area element
    transform by Nanson's formula ds_x n_x = J F^{-T} n ds_X."""
    uname, hname = A_z.name, uhat.name
    sgn = 1.0 if sym else -1.0

    def bdry(w, g):
        Fh = defF(getattr(w, hname))
        Jh = _det_small(Fh)
        Finv = _inv_small(Fh, Jh)
        # Nanson: the deformed-area-weighted normal (not unit)
        nans = Jh * (Finv.transpose(-1, -2) @ g.n)
        gu = dot(grad(getattr(w, uname)), Finv)
        gv = dot(grad(w.v), Finv)
        Bn = torch.sqrt(gu[0] ** 2 + gu[1] ** 2 + EPS)
        # the material coefficient dispatches on the boundary CELL's
        # subdomain tag (g.ctag), not on the facet marker: on the stator
        # steel's outer rim the consistency term takes steel's permeability
        coeff = (1.0 / VACUUM_PERM) / relative_permeability(g.ctag, Bn, bh)
        u_g = getattr(w, uname) - g_bc
        r = coeff * (-dot(gu, nans) * w.v - sgn * dot(gv, nans) * u_g)
        if sym:
            norm_nans = torch.sqrt(torch.sum(nans**2) + EPS)
            r = r + beta / g.h * coeff * norm_nans * w.v * u_g
        return r

    return FormDef([ds(bdry, tag=tuple(tags), qdeg=2)],
                   coeffs=[A_z, uhat], test=test_space or A_z.space)


def _pk1(G):
    """First Piola-Kirchhoff stress of the stiffened fictitious material:
    K = mu = det(F)^-3.  Returns (P, det F)."""
    I = torch.eye(2, dtype=G.dtype, device=G.device)
    F = I + G
    detF = F[0, 0] * F[1, 1] - F[0, 1] * F[1, 0]
    E = 0.5 * (F.transpose(-1, -2) @ F - I)
    K = 1.0 / detF**3
    mu = 1.0 / detF**3
    trE = E[0, 0] + E[1, 1]
    S = K * trE * I + 2.0 * mu * (E - trE * I / 3.0)
    return F @ S, detF


def mesh_motion_residual_form(uhat, uhat_bc, beta: float = 5e3,
                              sym: bool = True,
                              interface_tag: int = T.MAGNET_INTERFACE,
                              test_space=None):
    """Fictitious-hyperelasticity mesh motion with Nitsche enforcement of
    uhat = uhat_bc on the interior interface facets.  The consistency
    term's linearized stress dP(uhat; v) is a `torch.func.jvp` of the
    stress kernel."""

    hname, bname = uhat.name, uhat_bc.name

    def interior(w, g):
        P, _ = _pk1(grad(getattr(w, hname)))
        return torch.sum(P * grad(w.v))

    def nitsche(w, g):
        total = 0.0
        for side, nsgn in (("+", 1.0), ("-", -1.0)):
            uh = getattr(w, hname)(side)
            vv = w.v(side)
            gb = getattr(w, bname)(side)
            n = nsgn * g.n
            Gu = uh.grad
            P, detFh = _pk1(Gu)
            # consistency
            total = total - dot(dot(P, n), vv.val)
            # adjoint-consistency: dP(uhat; v) . n . (uhat - g)
            dP = jvp(lambda G: _pk1(G)[0], (Gu,), (vv.grad,))[1]
            sgn = 1.0 if sym else -1.0
            total = total + sgn * dot(dot(dP, n), uh.val - gb.val)
            if sym:
                b = beta / detFh**3
                total = total + b / g.h * dot(vv.val, uh.val - gb.val)
        return total

    return FormDef(
        [dx(interior, qdeg=3), dS(nitsche, tag=interface_tag, qdeg=3)],
        coeffs=[uhat, uhat_bc], test=test_space or uhat.space)


def b_power_form(A_z, uhat, n_exp: float, subdomains=(1, 2)):
    """int |B|^n J(uhat) over tagged subdomains."""

    uname, hname = A_z.name, uhat.name

    def integrand(w, g):
        Fh = defF(getattr(w, hname))
        Jh = _det_small(Fh)
        Finv = _inv_small(Fh, Jh)
        gA = dot(grad(getattr(w, uname)), Finv)
        Bn = torch.sqrt(gA[0] ** 2 + gA[1] ** 2 + EPS)
        return Bn**n_exp * Jh

    return FormDef([dx(integrand, tag=tuple(subdomains), qdeg=2)],
                   coeffs=[A_z, uhat])


def area_form(uhat, subdomains):
    """Deformed-configuration area of the tagged subdomains."""

    hname = uhat.name

    def integrand(w, g):
        return detF(getattr(w, hname))

    return FormDef([dx(integrand, tag=tuple(subdomains), qdeg=2)],
                   coeffs=[uhat])


def power_losses(B_eddy, B_hyst, frequency=1000.0, motor_length=0.07,
                 hysteresis_coeff=55.0):
    """Loss post-model: eddy = 2 pi^2 f^2 L * B_infl_eddy * 0.07;
    hysteresis = 2 pi f * k_h * L * B_infl_hyst."""
    eddy = 2 * np.pi**2 * frequency**2 * motor_length * B_eddy * 0.07
    hyst = 2 * np.pi * frequency * hysteresis_coeff * motor_length * B_hyst
    return eddy, hyst


def b_field_output_form(A_z, uhat, V_cg1):
    """1-form projecting |B| = |grad_x A_z| onto CG1 (a field output)."""
    uname, hname = A_z.name, uhat.name

    def integrand(w, g):
        Fh = defF(getattr(w, hname))
        Jh = _det_small(Fh)
        Finv = _inv_small(Fh, Jh)
        gA = dot(grad(getattr(w, uname)), Finv)
        Bn = torch.sqrt(gA[0] ** 2 + gA[1] ** 2 + EPS)
        return Bn * w.v

    return FormDef([dx(integrand, qdeg=2)], coeffs=[A_z, uhat],
                   test=V_cg1)


def torque_form(A_z, uhat, gap_tags=(T.AIR,), r_in: float | None = None,
                r_out: float | None = None, length: float = 0.07):
    """Electromagnetic torque by Arkkio's method: the Maxwell stress
    r B_r B_theta / (mu0 (r_out - r_in)) integrated over the air-gap
    annulus, with B from grad_x A_z in the deformed configuration."""
    r_in = RADII["r3"] if r_in is None else r_in
    r_out = RADII["r4"] if r_out is None else r_out
    uname, hname = A_z.name, uhat.name

    def integrand(w, g):
        uh = getattr(w, hname)
        Fh = defF(uh)
        Jh = _det_small(Fh)
        Finv = _inv_small(Fh, Jh)
        gA = dot(grad(getattr(w, uname)), Finv)
        Bx, By = gA[1], -gA[0]  # B = (dA/dy, -dA/dx)
        # radius, radial decomposition and the annulus gate in the
        # deformed configuration, where B and the area element live
        xd = g.x + uh.val
        r = torch.sqrt(xd[0] ** 2 + xd[1] ** 2 + EPS)
        cx, cy = xd[0] / r, xd[1] / r
        Br = Bx * cx + By * cy
        Bt = -Bx * cy + By * cx
        # the AIR tag also covers other regions: gate by radius
        w_gap = ((r > r_in) & (r < r_out)).to(r.dtype)
        return (length / (VACUUM_PERM * (r_out - r_in))) \
            * w_gap * r * Br * Bt * Jh

    return FormDef([dx(integrand, tag=tuple(gap_tags), qdeg=2)],
                   coeffs=[A_z, uhat])
