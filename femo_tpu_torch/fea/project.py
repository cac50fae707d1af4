"""L2 projection onto nodal spaces (port of femo_tpu/fea/project.py), used
by field outputs.

A field-output form is a 1-form against the target space's test
function: ``dx(lambda w, g: expr(w, g) * w.v)``.  Projection solves
M p = b: with the mass lumped (the default), p = b / rowsum(M),
differentiable by autograd; with `lump_mass=False`, the consistent mass
by Jacobi-preconditioned CG to a relative residual of 1e-12, as in the
JAX package.
"""

from __future__ import annotations

import torch

from .assemble import compile_form
from .forms import FormDef, dx
from .space import Function, FunctionSpace


def lumped_mass(space: FunctionSpace) -> torch.Tensor:
    """Row-sum lumped mass vector of the space, kept on the space (the JAX
    package caches it by id(space), which a later space can reuse)."""
    if getattr(space, "_lumped_mass", None) is None:
        if space.ncomp == 1:
            form = FormDef([dx(lambda w, g: w.v)], coeffs=[], test=space)
        else:
            form = FormDef([dx(lambda w, g: torch.sum(w.v.val))], coeffs=[],
                           test=space)
        space._lumped_mass = compile_form(form).vector({})
    return space._lumped_mass


def project_form(form: FormDef, space: FunctionSpace, values: dict,
                 lump_mass: bool = True) -> torch.Tensor:
    """Project the 1-form onto `space` (which must be its test space)."""
    b = compile_form(form).vector(values)
    if lump_mass:
        return b / lumped_mass(space)
    from ..solvers.krylov import cg

    p = Function(space, "p")
    if space.ncomp == 1:
        mform = FormDef([dx(lambda w, g: w.p * w.v)], coeffs=[p],
                        test=space)
    else:
        mform = FormDef([dx(lambda w, g: torch.sum(w.p.val * w.v.val))],
                        coeffs=[p], test=space)
    mcf = compile_form(mform)
    ml = lumped_mass(space)
    return cg(lambda x: mcf.vector({"p": x}), b, M=lambda x: x / ml,
              rtol=1e-12).x
