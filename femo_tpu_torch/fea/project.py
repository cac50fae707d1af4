"""L2 projection onto nodal spaces (port of femo_tpu/fea/project.py), used
by field outputs.

A field-output form is a 1-form against the target space's test
function: ``dx(lambda w, g: expr(w, g) * w.v)``.  Projection solves
M p = b with the mass lumped: p = b / rowsum(M), differentiable by
autograd.  The JAX package's consistent-mass option (`lump_mass=False`)
has no caller there and is not ported.
"""

from __future__ import annotations

import torch

from .assemble import compile_form
from .forms import FormDef, dx
from .space import FunctionSpace


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


def project_form(form: FormDef, space: FunctionSpace,
                 values: dict) -> torch.Tensor:
    """Project the 1-form onto `space` (which must be its test space)."""
    return compile_form(form).vector(values) / lumped_mass(space)
