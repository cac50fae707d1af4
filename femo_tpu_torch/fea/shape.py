"""Shape derivatives: dJ/d(mesh coordinates) by AD through the geometry
(port of femo_tpu/fea/shape.py, workload W10).

The mesh coordinates, which the compiled terms hold as constants, are
threaded into each term's entity data as a traced input, and the shape
gradient is one `torch.func.grad` of the assembled functional.  Cell,
exterior-facet and interior-facet terms are covered: facet normals and
measures derive from the cell geometry Jacobian, so the cell coordinates
carry the whole sensitivity, and the cell diameter `g.h` is recomputed
from them so that Nitsche-type terms carry theirs too.
"""

from __future__ import annotations

import torch
from torch.func import grad

from ..config import config
from .assemble import compile_form
from .forms import FormDef


def _term_args(term, coords):
    """The term's entity data (in `_Term._entity_args` order) with its
    geometry made from the (n_nodes, gdim) tensor `coords`."""
    mesh, dev = term.form.mesh, coords.device

    def side(cells):
        c = coords[torch.as_tensor(mesh.cells[cells], device=dev)]
        diff = c[:, :, None, :] - c[:, None, :, :]
        # cell diameter: the largest vertex distance
        h = torch.sqrt(torch.amax(torch.sum(diff**2, dim=-1), dim=(1, 2)))
        return c, h

    c0, h = side(term.cells0)
    if term.domain == "cell":
        return (c0, h, term.tag)
    cent0 = c0.mean(dim=1)
    if term.domain == "exterior_facet":
        return (c0, term.var0, cent0, h, term.tag, term.ctag0)
    c1, _ = side(term.cells1)
    return (c0, c1, term.var0, term.var1, cent0, h, term.tag, term.ctag0,
            term.ctag1)


def shape_functional(form: FormDef):
    """J(coords, values): the functional with the mesh coordinates
    (n_nodes, gdim) as an argument."""
    cf = compile_form(form)

    def J(coords, values):
        vals = {k: values[k] for k in cf.all_names}
        return sum(t.scalar(vals, _term_args(t, coords)) for t in cf.terms)

    return J


def shape_gradient(form: FormDef, values: dict | None = None):
    """dJ/d(coords): the (n_nodes, gdim) nodal shape gradient of a scalar
    functional (values default to the form's coefficient arrays), on the
    form's device."""
    cf = compile_form(form)
    v = form.values()
    if values:
        v.update(values)
    coords = torch.as_tensor(cf.mesh.coords, dtype=config.dtype,
                             device=cf.device)
    return grad(shape_functional(form))(coords, v)
