"""FEA utilities (port of femo_tpu/fea/utils.py: the error norm)."""

from __future__ import annotations

import torch

from .assemble import assemble_scalar
from .forms import FormDef, dx, grad
from .space import Function


def error_norm(f_ref: Function, f: Function, norm: str = "L2") -> float:
    """L2 (or, with any other `norm`, H1 = L2 + H1-seminorm) error norm
    between two Functions on the same space."""
    V = f.space
    a = Function(V, "a", f_ref.array)
    b = Function(V, "b", f.array)

    if norm == "L2":
        def integrand(w, g):
            d = w.a - w.b
            return torch.sum(d ** 2)
    else:
        def integrand(w, g):
            d = w.a - w.b
            gd = grad(w.a) - grad(w.b)
            return torch.sum(d ** 2) + torch.sum(gd ** 2)

    form = FormDef([dx(integrand)], coeffs=[a, b])
    return float(torch.sqrt(assemble_scalar(form)))


errorNorm = error_norm
