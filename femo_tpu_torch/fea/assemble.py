"""Assembly engine: gather -> per-entity kernel -> owner-table scatter
(port of femo_tpu/fea/assemble.py: cell terms, and interior- and
exterior-facet terms on intervals, triangles and quads).

* Topology and tabulation are precomputed host-side in numpy and copied
  to the form's device once.
* The per-entity kernel evaluates the integrand per quadrature point
  under `torch.func.vmap` (quadrature points, then entities).
* Residual vectors: the integrand is linear in the test function, so the
  per-entity residual is `torch.func.grad` of the entity integral with
  respect to the test dofs.
* Jacobians: `torch.func.jacfwd` of that residual -> per-entity dense
  blocks (ne, nr, nc) ("element-matrix" form).
* The scatters (the residual vector, the Jacobian's diagonal and dense
  form) sum through owner tables (ops/scatter.py) in a fixed order,
  with no atomics.
* Hermite elements: Hessian tables (the affine physical Hessian
  K^T d2N K on cell terms, `hess(u)`) and the per-cell scaling of their
  derivative dofs.
* `ElementMatrix.matvec/rmatvec` run the element SpMV kernels K4/K4T on
  CUDA tensors (ops/spmv.py); each term keeps the kernels' row-owner
  maps of its pattern, built at first use.

Not ported (raise NotImplementedError): manifold cells, facet terms of
3D cells (tets, and the hex facets' dihedral variants), and the chunked
entity loop.
"""

from __future__ import annotations

from dataclasses import dataclass
from types import SimpleNamespace
from typing import Sequence

import numpy as np
import torch
from torch.func import grad as fgrad, jacfwd, vmap

from ..config import config
from ..elements.element import (
    CELL_FACETS, REFERENCE_VERTICES, geometry_element,
)
from ..elements.quadrature import cell_rule
from ..mesh.mesh import Mesh
from ..ops.scatter import OwnerTable
from ..ops.spmv import ElementSpMVPlan, element_matvec
from .forms import FormDef, Integral, Q, QR, integrand_device
from .space import FunctionSpace


def _det_small(G):
    """Batched determinant of (..., d, d) for d in {1, 2, 3}, closed-form."""
    d = G.shape[-1]
    if d == 1:
        return G[..., 0, 0]
    if d == 2:
        return G[..., 0, 0] * G[..., 1, 1] - G[..., 0, 1] * G[..., 1, 0]
    if d == 3:
        return (
            G[..., 0, 0] * (G[..., 1, 1] * G[..., 2, 2]
                            - G[..., 1, 2] * G[..., 2, 1])
            - G[..., 0, 1] * (G[..., 1, 0] * G[..., 2, 2]
                              - G[..., 1, 2] * G[..., 2, 0])
            + G[..., 0, 2] * (G[..., 1, 0] * G[..., 2, 1]
                              - G[..., 1, 1] * G[..., 2, 0])
        )
    raise NotImplementedError(d)


def _inv_small(G, detG=None):
    """Batched inverse of (..., d, d) for d in {1, 2, 3}, closed-form."""
    d = G.shape[-1]
    if detG is None:
        detG = _det_small(G)
    inv_det = 1.0 / detG
    if d == 1:
        return inv_det[..., None, None]
    if d == 2:
        a, b = G[..., 0, 0], G[..., 0, 1]
        c, e = G[..., 1, 0], G[..., 1, 1]
        row0 = torch.stack([e, -b], dim=-1)
        row1 = torch.stack([-c, a], dim=-1)
        return torch.stack([row0, row1], dim=-2) * inv_det[..., None, None]
    if d == 3:
        cof = torch.stack([
            torch.stack([
                G[..., 1, 1] * G[..., 2, 2] - G[..., 1, 2] * G[..., 2, 1],
                G[..., 0, 2] * G[..., 2, 1] - G[..., 0, 1] * G[..., 2, 2],
                G[..., 0, 1] * G[..., 1, 2] - G[..., 0, 2] * G[..., 1, 1],
            ], dim=-1),
            torch.stack([
                G[..., 1, 2] * G[..., 2, 0] - G[..., 1, 0] * G[..., 2, 2],
                G[..., 0, 0] * G[..., 2, 2] - G[..., 0, 2] * G[..., 2, 0],
                G[..., 0, 2] * G[..., 1, 0] - G[..., 0, 0] * G[..., 1, 2],
            ], dim=-1),
            torch.stack([
                G[..., 1, 0] * G[..., 2, 1] - G[..., 1, 1] * G[..., 2, 0],
                G[..., 0, 1] * G[..., 2, 0] - G[..., 0, 0] * G[..., 2, 1],
                G[..., 0, 0] * G[..., 1, 1] - G[..., 0, 1] * G[..., 1, 0],
            ], dim=-1),
        ], dim=-2)
        return cof * inv_det[..., None, None]
    raise NotImplementedError(d)


# ---------------------------------------------------------------------------
# Per-term precomputed data
# ---------------------------------------------------------------------------


@dataclass
class _SpaceTab:
    """Tabulation tables for one space on one term's quadrature points:
    cell terms N (nq, nsd), dN (nq, nsd, tdim) and, for elements with
    Hessian tables, d2N (nq, nsd, tdim, tdim); facet terms stacked over
    the facet-parametrization variants, (nvar, nq, nsd[, tdim])."""

    space: FunctionSpace
    N: torch.Tensor
    dN: torch.Tensor
    d2N: torch.Tensor | None = None


class _Term:
    """One compiled integral term: cells, or the interior or exterior
    facets of an interval, triangle or quad mesh."""

    def __init__(self, integral: Integral, form: "CompiledForm"):
        self.integral = integral
        self.form = form
        self._spmv_plans = {}  # (test, wrt) -> ElementSpMVPlan
        mesh = form.mesh
        self.domain = integral.domain
        spaces = form.spaces  # name -> FunctionSpace (test as "__test__")
        if mesh.tdim != mesh.gdim:
            raise NotImplementedError("manifold cells are not ported")

        qdeg = integral.qdeg or form.default_qdeg
        geo = geometry_element(mesh.cell_type)
        dev, f = form.device, config.dtype

        def tf(a):
            return torch.as_tensor(np.asarray(a, np.float64), dtype=f,
                                   device=dev)

        def ti(a):
            return torch.as_tensor(np.asarray(a, np.int64), device=dev)

        if self.domain == "cell":
            qp, qw = cell_rule(mesh.cell_type, qdeg)
            self.qw = tf(qw)
            self.tabs = {}
            for name, V in spaces.items():
                N, dN = V.element.tabulate(qp)
                d2N = (tf(V.element.tabulate2(qp))
                       if V.element.has_hessian_tab() else None)
                self.tabs[name] = _SpaceTab(V, tf(N), tf(dN), d2N)
            Ng, dNg = geo.tabulate(qp)
            self.Ng, self.dNg = tf(Ng), tf(dNg)
            if integral.tag is None:
                ents = np.arange(mesh.n_cells, dtype=np.int32)
            else:
                if mesh.cell_tags is None:
                    raise ValueError("mesh has no cell tags")
                sel = np.isin(mesh.cell_tags, np.atleast_1d(integral.tag))
                ents = np.nonzero(sel)[0].astype(np.int32)
            self.n_ent = len(ents)
            self.cells0 = ents
            self.coords0 = tf(mesh.coords[mesh.cells[ents]])
            self.h = tf(mesh.cell_sizes()[ents])
            tags = (mesh.cell_tags[ents] if mesh.cell_tags is not None
                    else np.zeros(len(ents), np.int32))
            self.tag = ti(tags)
            self.dofs0 = {name: V.dofmap[ents] for name, V in spaces.items()}
            self.gdofs0 = {n: ti(d) for n, d in self.dofs0.items()}
            return

        if self.domain not in ("interior_facet", "exterior_facet"):
            raise ValueError(f"unknown integral domain {self.domain!r}")
        if mesh.cell_type not in ("interval", "triangle", "quad"):
            raise NotImplementedError(
                "facet terms are ported for intervals, triangles and quads")
        point = mesh.tdim == 1
        if point:  # the facets of an interval are its end points
            fqp, fqw = np.zeros((1, 0)), np.ones(1)
        else:
            fqp, fqw = cell_rule("interval", qdeg)
        self.qw = tf(fqw)
        # variants: every facet of the reference cell in both orientations
        # (an edge's two directions; a point twice, to keep lf * 2 + orient
        # indexing), so the two sides of an interior facet integrate at
        # matching physical points; each is an affine map pts = o + fqp @ T,
        # and T doubles as the reference tangent frame for the normal
        rv = REFERENCE_VERTICES[mesh.cell_type]
        lfs_t = CELL_FACETS[mesh.cell_type]
        vmaps = []
        for lf in range(len(lfs_t)):
            verts = rv[list(lfs_t[lf])]
            if point:
                vmaps += [(verts[0], np.zeros((0, 1)))] * 2
            else:
                vmaps.append((verts[0], (verts[1] - verts[0])[None]))
                vmaps.append((verts[1], (verts[0] - verts[1])[None]))
        variants = [o[None, :] + fqp @ T for (o, T) in vmaps]
        self.Tref = tf(np.stack([T for (_, T) in vmaps]))

        def tab_variants(el):
            tabs = [el.tabulate(pts) for pts in variants]
            return (tf(np.stack([N for N, _ in tabs])),
                    tf(np.stack([dN for _, dN in tabs])))

        self.tabs = {name: _SpaceTab(V, *tab_variants(V.element))
                     for name, V in spaces.items()}
        self.Ng, self.dNg = tab_variants(geo)

        fids = (mesh.interior_facets if self.domain == "interior_facet"
                else mesh.exterior_facets)
        if integral.tag is not None:
            sel = np.isin(mesh.facet_tags[fids], np.atleast_1d(integral.tag))
            fids = fids[sel]
        self.n_ent = len(fids)
        fc = mesh.facet_cells[fids]  # (ne, 2)
        fl = mesh.facet_local[fids]
        fverts = mesh.facets[fids]  # sorted global vertex pairs
        lfs = np.asarray(CELL_FACETS[mesh.cell_type])

        def side_data(side):
            cells = fc[:, side]
            lf = fl[:, side]
            # orientation bit: does this side's local edge run against the
            # sorted facet key?
            local_first = mesh.cells[cells, lfs[lf, 0]]
            orient = (local_first != fverts[:, 0]).astype(np.int32)
            if point:
                orient[:] = 0
            return cells.astype(np.int32), lf * 2 + orient

        ct = mesh.cell_tags
        # owning-cell subdomain tags (g.ctag), for material-dispatched
        # facet terms
        zeros = np.zeros(self.n_ent, np.int32)
        self.cells0, var0 = side_data(0)
        self.var0 = ti(var0)
        self.coords0 = tf(mesh.coords[mesh.cells[self.cells0]])
        self.dofs0 = {n: V.dofmap[self.cells0] for n, V in spaces.items()}
        self.gdofs0 = {n: ti(d) for n, d in self.dofs0.items()}
        self.ctag0 = ti(ct[self.cells0] if ct is not None else zeros)
        self.h = tf(mesh.cell_sizes()[self.cells0])
        self.tag = ti(mesh.facet_tags[fids])
        # side-0 cell centroids orient the facet normal outward
        self.cent0 = tf(mesh.coords[mesh.cells[self.cells0]].mean(axis=1))
        if self.domain == "exterior_facet":
            return
        self.cells1, var1 = side_data(1)
        self.var1 = ti(var1)
        self.coords1 = tf(mesh.coords[mesh.cells[self.cells1]])
        self.dofs1 = {n: V.dofmap[self.cells1] for n, V in spaces.items()}
        self.gdofs1 = {n: ti(d) for n, d in self.dofs1.items()}
        self.ctag1 = ti(ct[self.cells1] if ct is not None else zeros)

    # -- kernel building ------------------------------------------------------

    @staticmethod
    def _geometry(coords_e, Ng, dNg):
        """Per-qp x (nq,gdim), detJ (nq,), K = Ginv@J^T (nq,tdim,gdim), J."""
        J = torch.einsum("ai,qat->qit", coords_e, dNg)  # (nq, gdim, tdim)
        G = torch.einsum("qit,qis->qts", J, J)
        detG = _det_small(G)
        detJ = torch.sqrt(detG)
        K = torch.einsum("qts,qis->qti", _inv_small(G, detG), J)
        x = torch.einsum("qa,ai->qi", Ng, coords_e)
        return x, detJ, K, J

    @staticmethod
    def _qp_values(tab: _SpaceTab, N, dNphys, u_e, d2phys=None):
        """(val, grad[, hess]) at all qps. N (nq,nsd), dNphys
        (nq,nsd,gdim), d2phys (nq,nsd,gdim,gdim) or None."""
        el = tab.space.element
        nsd, ncp = el.nscalar_dofs, el.ncomp
        if ncp == 1:
            out = (N @ u_e, torch.einsum("qsg,s->qg", dNphys, u_e))
            if d2phys is not None:
                out += (torch.einsum("qsij,s->qij", d2phys, u_e),)
            return out
        um = u_e.reshape(nsd, ncp)
        out = (torch.einsum("qs,sc->qc", N, um),
               torch.einsum("qsg,sc->qcg", dNphys, um))
        if d2phys is not None:
            out += (torch.einsum("qsij,sc->qcij", d2phys, um),)
        return out

    @staticmethod
    def _scale_local(V: FunctionSpace, coords_e, u_e):
        """Per-cell dof scaling (Hermite derivative dofs scale by h)."""
        el = V.element
        if not el.has_dof_scaling():
            return u_e
        s = el.dof_scaling_scalar(coords_e)
        if el.ncomp > 1:
            s = torch.repeat_interleave(s, el.ncomp)
        return u_e * s

    @staticmethod
    def _facet_geom(J, Tv, x, cent0):
        """Per-qp outward unit normal (nq, gdim) and facet measure (nq,):
        on an edge, tangent t = J @ Tv^T and normal = rot(t); on the point
        facet of an interval, the unit vector from the cell centroid and
        measure 1.  Oriented away from the side-0 cell centroid."""
        if Tv.shape[0] == 0:
            n = x - cent0[None, :]
            n = n / torch.linalg.norm(n, dim=-1, keepdim=True)
            return n, torch.ones(x.shape[0], dtype=x.dtype, device=x.device)
        t1 = torch.einsum("qit,ft->qif", J, Tv)[:, :, 0]
        a = torch.linalg.norm(t1, dim=-1)
        n = torch.stack([t1[:, 1], -t1[:, 0]], dim=-1) / a[:, None]
        sgn = torch.sign(torch.einsum("qi,qi->q", n, x - cent0[None, :]))
        return n * sgn[:, None], a

    def _seed(self, test_name, shape_lead=()):
        nd = self.tabs[test_name].space.element.ndofs
        return torch.zeros(shape_lead + (nd,), dtype=config.dtype,
                           device=self.form.device)

    def make_entity_kernel(self, test_name: str | None,
                           coeff_names: Sequence[str]):
        """Per-entity kernel: fn(locals, *entity data) -> scalar (no test)
        or the (nd_test,) residual ((2, nd_test) on interior facets, whose
        locals are (2, nd) stacked).  Global coefficients appear in locals
        unchanged (no gather)."""
        integral = self.integral
        gset = set(self.form.global_names)
        names = [n for n in coeff_names if n not in gset]
        gnames = [n for n in coeff_names if n in gset]
        keys = names + (["v"] if test_name else [])
        tabs = self.tabs
        all_names = set(names) | ({test_name} if test_name else set())
        scale = self._scale_local

        def side_values(locals_, v_e, coords_e, N_of, dNphys, d2phys=None):
            """{name: (val, grad[, hess]) at all qps} of one cell side."""
            d2phys = d2phys or {}
            qv = {n: self._qp_values(
                tabs[n], N_of(n), dNphys[n],
                scale(tabs[n].space, coords_e, locals_[n]), d2phys.get(n))
                for n in names}
            if test_name:
                tt = tabs[test_name]
                qv["v"] = self._qp_values(
                    tt, N_of(test_name), dNphys[test_name],
                    scale(tt.space, coords_e, v_e), d2phys.get(test_name))
            return qv

        def w_of(qv, gvals):
            return SimpleNamespace(**{n: Q(*qv[n]) for n in keys},
                                   **{n: Q(gvals[n]) for n in gnames})

        def value(r):
            return r.val if isinstance(r, Q) else r

        if self.domain == "cell":
            def kernel(locals_, coords_e, h_e, tag_e):
                x, detJ, K, _ = self._geometry(coords_e, self.Ng, self.dNg)
                dNphys = {n: torch.einsum("qst,qtg->qsg", tabs[n].dN, K)
                          for n in all_names}
                # physical Hessian on affine cells: K^T d2N K (no
                # curvature term; Hermite interval elements)
                d2phys = {n: torch.einsum("qti,qstr,qrj->qsij", K,
                                          tabs[n].d2N, K)
                          for n in all_names if tabs[n].d2N is not None}

                def total(v_e):
                    qv = side_values(locals_, v_e, coords_e,
                                     lambda n: tabs[n].N, dNphys, d2phys)

                    def at_qp(qv, x_q):
                        g = SimpleNamespace(x=x_q, h=h_e, tag=tag_e,
                                            ctag=tag_e, n=None)
                        return value(integral.fn(w_of(qv, locals_), g))

                    vals = vmap(at_qp)(qv, x)
                    return torch.sum(self.qw * detJ * vals)

                if test_name is None:
                    return total(None)
                return fgrad(total)(self._seed(test_name))

            return kernel

        if self.domain == "exterior_facet":
            def kernel(locals_, coords_e, var_e, cent_e, h_e, tag_e,
                       ctag_e):
                x, _, K, Jg = self._geometry(
                    coords_e, self.Ng[var_e], self.dNg[var_e])
                nrm, meas = self._facet_geom(Jg, self.Tref[var_e], x,
                                             cent_e)
                dNphys = {n: torch.einsum("qst,qtg->qsg",
                                          tabs[n].dN[var_e], K)
                          for n in all_names}

                def total(v_e):
                    qv = side_values(locals_, v_e, coords_e,
                                     lambda n: tabs[n].N[var_e], dNphys)

                    def at_qp(qv, x_q, n_q):
                        g = SimpleNamespace(x=x_q, h=h_e, tag=tag_e,
                                            ctag=ctag_e, n=n_q)
                        return value(integral.fn(w_of(qv, locals_), g))

                    vals = vmap(at_qp)(qv, x, nrm)
                    return torch.sum(self.qw * meas * vals)

                if test_name is None:
                    return total(None)
                return fgrad(total)(self._seed(test_name))

            return kernel

        def kernel(locals2, coords0_e, coords1_e, var0_e, var1_e,
                   cent_e, h_e, tag_e, ctag0_e, ctag1_e):
            x, _, K0, Jg0 = self._geometry(
                coords0_e, self.Ng[var0_e], self.dNg[var0_e])
            _, _, K1, _ = self._geometry(
                coords1_e, self.Ng[var1_e], self.dNg[var1_e])
            nrm, meas = self._facet_geom(Jg0, self.Tref[var0_e], x, cent_e)
            dN0 = {n: torch.einsum("qst,qtg->qsg", tabs[n].dN[var0_e], K0)
                   for n in all_names}
            dN1 = {n: torch.einsum("qst,qtg->qsg", tabs[n].dN[var1_e], K1)
                   for n in all_names}

            def total(v2):
                side = [{n: locals2[n][k] for n in names} for k in (0, 1)]
                qv0 = side_values(side[0], None if v2 is None else v2[0],
                                  coords0_e, lambda n: tabs[n].N[var0_e],
                                  dN0)
                qv1 = side_values(side[1], None if v2 is None else v2[1],
                                  coords1_e, lambda n: tabs[n].N[var1_e],
                                  dN1)

                def at_qp(q0, q1, x_q, n_q):
                    w = SimpleNamespace(
                        **{n: QR(Q(*q0[n]), Q(*q1[n])) for n in keys},
                        **{n: Q(locals2[n]) for n in gnames})
                    g = SimpleNamespace(x=x_q, h=h_e, tag=tag_e,
                                        ctag0=ctag0_e, ctag1=ctag1_e, n=n_q)
                    return value(integral.fn(w, g))

                vals = vmap(at_qp)(qv0, qv1, x, nrm)
                return torch.sum(self.qw * meas * vals)

            if test_name is None:
                return total(None)
            return fgrad(total)(self._seed(test_name, (2,)))

        return kernel

    # -- assembled entry points ------------------------------------------------

    def _entity_args(self):
        if self.domain == "cell":
            return (self.coords0, self.h, self.tag)
        if self.domain == "exterior_facet":
            return (self.coords0, self.var0, self.cent0, self.h, self.tag,
                    self.ctag0)
        return (self.coords0, self.coords1, self.var0, self.var1,
                self.cent0, self.h, self.tag, self.ctag0, self.ctag1)

    def gather_locals(self, values: dict):
        """Per-entity local dof values of each field coefficient ((ne, 2,
        nd) on interior facets); globals pass through unchanged."""
        g = self.form.global_names
        if self.domain == "interior_facet":
            return {n: (values[n] if n in g else torch.stack(
                [values[n][self.gdofs0[n]], values[n][self.gdofs1[n]]],
                dim=1)) for n in values}
        return {n: (values[n] if n in g else values[n][self.gdofs0[n]])
                for n in values}

    def _vmapped(self, fn, values, args=None):
        """vmap fn(locals, *entity args) over the entities: fields map
        over dim 0, globals broadcast.  args: the entity data, by default
        the term's own (`_entity_args`); shape derivatives pass data made
        from traced coordinates."""
        in_locals = {n: (None if n in self.form.global_names else 0)
                     for n in values}
        args = self._entity_args() if args is None else args
        with integrand_device(self.form.device):
            return vmap(fn, in_dims=(in_locals,) + (0,) * len(args))(
                self.gather_locals(values), *args)

    def _rows(self, name):
        if self.domain == "interior_facet":
            return torch.cat([self.gdofs0[name], self.gdofs1[name]], dim=1)
        return self.gdofs0[name]

    def spmv_plan(self, test_name: str, wrt: str) -> ElementSpMVPlan:
        """The element SpMV plan of this term's (test, wrt) block pattern,
        kept for every matrix assembled from it (its maps are built at
        the first CUDA matvec)."""
        key = (test_name, wrt)
        if key not in self._spmv_plans:
            self._spmv_plans[key] = ElementSpMVPlan(
                self._rows(test_name), self._rows(wrt),
                self.tabs[test_name].space.n_dofs, self.tabs[wrt].space.n_dofs)
        return self._spmv_plans[key]

    def scalar(self, values: dict, args=None) -> torch.Tensor:
        kern = self.make_entity_kernel(None, list(values))
        return torch.sum(self._vmapped(kern, values, args))

    def host_rows(self, name):
        """The host (ne, nd) dof ids of `name` per entity ((ne, 2 nd) on
        interior facets), in the order of residual_contrib's values."""
        if self.domain == "interior_facet":
            return np.concatenate([self.dofs0[name], self.dofs1[name]],
                                  axis=1)
        return self.dofs0[name]

    def residual_contrib(self, values: dict, test_name: str,
                         chunk: int | None = None):
        """Flat contributions, in the order of host_rows(test_name)."""
        if chunk is not None:
            raise NotImplementedError("chunked assembly is not ported")
        kern = self.make_entity_kernel(test_name, list(values))
        return self._vmapped(kern, values).reshape(-1)

    def matrix_blocks(self, values: dict, test_name: str, wrt: str,
                      chunk: int | None = None):
        """Element-matrix block: (A (ne, nr, nc), rows, cols)."""
        if chunk is not None:
            raise NotImplementedError("chunked assembly is not ported")
        kern = self.make_entity_kernel(test_name, list(values))

        def per_ent(locals_e, *args_e):
            def res(u):
                return kern({**locals_e, wrt: u}, *args_e)

            return jacfwd(res)(locals_e[wrt])

        Ae = self._vmapped(per_ent, values)
        if self.domain == "interior_facet":
            ne = Ae.shape[0]  # (ne, 2, nr, 2, nc)
            Ae = Ae.reshape(ne, Ae.shape[1] * Ae.shape[2], -1)
        # the SpMV kernels read A_e row-major: one copy per assembly
        return Ae.contiguous(), self._rows(test_name), self._rows(wrt)


# ---------------------------------------------------------------------------
# Element-matrix (assembled Jacobian) representation
# ---------------------------------------------------------------------------


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


@dataclass
class MatBlock:
    A: object  # (ne, nr, nc) tensor, or a host placeholder for patterns
    rows: object  # (ne, nr)
    cols: object  # (ne, nc)
    plan: ElementSpMVPlan | None = None  # K4's maps of (rows, cols)


class ElementMatrix:
    """Sparse matrix in unassembled element form: a list of MatBlocks.

    SpMV is gather -> per-element product -> scatter, one K4 (matvec) or
    K4T (rmatvec) launch per block on CUDA tensors, the plain PyTorch
    version on CPU tensors (ops/spmv.py)."""

    def __init__(self, blocks: list[MatBlock], n_rows: int, n_cols: int,
                 cache: dict | None = None):
        self.blocks = blocks
        self.shape = (n_rows, n_cols)
        # owner tables of `diagonal` and `to_dense`, shared by every matrix
        # a compiled form assembles from one pattern
        self._cache = {} if cache is None else cache
        for b in blocks:
            if b.plan is None and isinstance(b.rows, torch.Tensor):
                b.plan = ElementSpMVPlan(b.rows, b.cols, n_rows, n_cols)

    def matvec(self, x):
        return element_matvec(self.blocks, x, self.shape)

    def rmatvec(self, y):
        """Transpose matvec A^T y (adjoint solves)."""
        return element_matvec(self.blocks, y, self.shape, transpose=True)

    def diagonal(self):
        """The diagonal, summed through an owner table (ops/scatter.py)
        built at the first call and kept in the matrix's cache."""
        blocks = [b for b in self.blocks
                  if b.rows.shape[1] == b.cols.shape[1]]
        tab = self._cache.get("diagonal")
        if tab is None:
            tab = self._cache["diagonal"] = OwnerTable(
                np.concatenate([_host(b.rows).reshape(-1) for b in blocks]),
                sum(b.rows.numel() for b in blocks), self.shape[0],
                device=blocks[0].A.device)
        return tab.sum(torch.cat([
            (torch.diagonal(b.A, dim1=1, dim2=2)
             * (b.rows == b.cols)).reshape(-1) for b in blocks]))

    def to_dense(self):
        """The dense matrix, summed through an owner table of the
        flattened (row, col) destinations, built at the first call and
        kept in the matrix's cache."""
        n_rows, n_cols = self.shape
        tab = self._cache.get("dense")
        if tab is None:
            dest = [(_host(b.rows).astype(np.int64)[:, :, None] * n_cols
                     + _host(b.cols)[:, None, :]).reshape(-1)
                    for b in self.blocks]
            dest = np.concatenate(dest)
            tab = self._cache["dense"] = OwnerTable(
                dest, len(dest), device=self.blocks[0].A.device)
        vals = torch.cat([b.A.reshape(-1) for b in self.blocks])
        M = torch.zeros(n_rows * n_cols, dtype=vals.dtype,
                        device=vals.device)
        M[tab.ids] = tab.sum(vals)
        return M.reshape(n_rows, n_cols)

    def to_scipy_csr(self):
        """Host CSR, built as the JAX package builds it (the same COO
        order, so scipy sums duplicates in the same order)."""
        import scipy.sparse as sp

        rows, cols, vals = [], [], []
        for b in self.blocks:
            ne, nr, nc = b.A.shape
            rows.append(np.broadcast_to(
                _host(b.rows)[:, :, None], (ne, nr, nc)).ravel())
            cols.append(np.broadcast_to(
                _host(b.cols)[:, None, :], (ne, nr, nc)).ravel())
            vals.append(_host(b.A).ravel())
        M = sp.coo_matrix(
            (np.concatenate(vals), (np.concatenate(rows),
                                    np.concatenate(cols))), shape=self.shape)
        return M.tocsr()


# ---------------------------------------------------------------------------
# Compiled form
# ---------------------------------------------------------------------------


class CompiledForm:
    """A FormDef compiled against its mesh and device: precomputed terms
    plus the assembly entry points."""

    def __init__(self, form: FormDef):
        self.form = form
        self.global_names = list(form.globals.keys())
        spaces = {name: f.space for name, f in form.coeffs.items()}
        if form.test is not None:
            spaces["__test__"] = form.test
        if len({id(V.mesh) for V in spaces.values()}) > 1:
            raise ValueError("all spaces in a form must share one mesh")
        devices = {V.device for V in spaces.values()}
        if len(devices) > 1:
            raise ValueError(f"form spaces on several devices: {devices}")
        self.device = devices.pop()
        self.spaces = spaces
        self.mesh: Mesh = next(iter(spaces.values())).mesh
        self.default_qdeg = max(
            max((V.element.degree * 2) for V in spaces.values()), 2)
        if any(V.element.family == "Hermite" for V in spaces.values()):
            self.default_qdeg = max(self.default_qdeg, 6)
        self.terms = [_Term(i, self) for i in form.integrals]
        self.coeff_names = list(form.coeffs.keys())
        self.all_names = self.coeff_names + self.global_names
        # owner tables (ops/scatter.py), built at first use
        self._vector_table = None
        self._matrix_tables: dict = {}

    def scalar(self, values: dict) -> torch.Tensor:
        vals = {n: values[n] for n in self.all_names}
        return sum(t.scalar(vals) for t in self.terms)

    def vector(self, values: dict) -> torch.Tensor:
        if self.form.test is None:
            raise ValueError("vector assembly needs a test space")
        vals = {k: values[k] for k in self.all_names}
        if self._vector_table is None:
            rows = np.concatenate(
                [t.host_rows("__test__").reshape(-1) for t in self.terms])
            self._vector_table = OwnerTable(
                rows, len(rows), self.form.test.n_dofs, device=self.device)
        return self._vector_table.sum(torch.cat(
            [t.residual_contrib(vals, "__test__") for t in self.terms]))

    def matrix(self, values: dict, wrt: str) -> ElementMatrix:
        if self.form.test is None:
            raise ValueError("matrix assembly needs a test space")
        vals = {k: values[k] for k in self.all_names}
        blocks = [MatBlock(*t.matrix_blocks(vals, "__test__", wrt),
                           plan=t.spmv_plan("__test__", wrt))
                  for t in self.terms]
        ncols = self.form.coeffs[wrt].space.n_dofs
        return ElementMatrix(blocks, self.form.test.n_dofs, ncols,
                             cache=self._matrix_tables.setdefault(wrt, {}))

    def matrix_pattern(self, wrt: str) -> ElementMatrix:
        """Pattern-only ElementMatrix: host rows/cols from the dofmaps and
        a broadcast-zero placeholder for the values; runs no kernel.  For
        BlockTridiagTemplate prototypes."""
        if self.form.test is None:
            raise ValueError("matrix assembly needs a test space")
        blocks = []
        for t in self.terms:
            rows, cols = t.dofs0["__test__"], t.dofs0[wrt]
            if t.domain == "interior_facet":
                rows = np.concatenate([rows, t.dofs1["__test__"]], axis=1)
                cols = np.concatenate([cols, t.dofs1[wrt]], axis=1)
            A = np.broadcast_to(np.zeros(()), (rows.shape[0], rows.shape[1],
                                               cols.shape[1]))
            blocks.append(MatBlock(A, rows, cols))
        ncols = self.form.coeffs[wrt].space.n_dofs
        return ElementMatrix(blocks, self.form.test.n_dofs, ncols)


def compile_form(form: FormDef) -> CompiledForm:
    if form._assembler is None:
        form._assembler = CompiledForm(form)
    return form._assembler


# ---------------------------------------------------------------------------
# Public assembly API (the form's current coefficient arrays, updated by
# `values`)
# ---------------------------------------------------------------------------


def _form_values(form: FormDef, values: dict | None) -> dict:
    v = form.values()
    if values:
        v.update(values)
    return v


def assemble_scalar(form: FormDef, values: dict | None = None):
    return compile_form(form).scalar(_form_values(form, values))


def assemble_vector(form: FormDef, values: dict | None = None):
    return compile_form(form).vector(_form_values(form, values))


def assemble_matrix(form: FormDef, wrt: str,
                    values: dict | None = None) -> ElementMatrix:
    return compile_form(form).matrix(_form_values(form, values), wrt)
