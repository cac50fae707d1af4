"""Form language: quadrature-point values, operators and form definitions
(port of femo_tpu/fea/forms.py, as far as the motor forms reach).

Integrands are plain Python functions ``fn(w, g)`` evaluated per
quadrature point on torch tensors under `torch.func.vmap`; residuals and
Jacobians come from `torch.func.grad` / `torch.func.jacfwd` of the same
integrands (fea/assemble.py).

* ``w`` — namespace of coefficient values at the point.  Each field is a
  :class:`Q` carrying ``val`` and ``grad``; the test function is ``w.v``
  and the form must be linear in it.  On interior facets each is a
  :class:`QR` restricted with ``w.u("+")`` / ``w.u("-")``.
* ``g`` — geometry: ``g.x``, ``g.n`` (facets), ``g.h``, ``g.tag`` (the
  cell's tag, or the facet's on facets) and, on facets, the owning cells'
  tags: ``g.ctag`` (exterior), ``g.ctag0`` / ``g.ctag1`` (interior).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..config import config, get_device
from .space import Function, FunctionSpace


def _v(x):
    """Coerce Q -> value tensor."""
    return x.val if isinstance(x, Q) else x


class Q:
    """A coefficient's value at a quadrature point: ``val`` () or (ncomp,),
    ``grad`` (gdim,) or (ncomp, gdim).  Arithmetic coerces to plain
    tensors so expressions read like UFL."""

    __slots__ = ("val", "_grad")

    def __init__(self, val, grad=None):
        self.val = val
        self._grad = grad

    @property
    def grad(self):
        if self._grad is None:
            raise ValueError("gradient not available for this quantity")
        return self._grad

    def __getitem__(self, i):
        g = None if self._grad is None else self._grad[i]
        return Q(self.val[i], g)

    def __add__(self, o): return self.val + _v(o)
    def __radd__(self, o): return _v(o) + self.val
    def __sub__(self, o): return self.val - _v(o)
    def __rsub__(self, o): return _v(o) - self.val
    def __mul__(self, o): return self.val * _v(o)
    def __rmul__(self, o): return _v(o) * self.val
    def __truediv__(self, o): return self.val / _v(o)
    def __rtruediv__(self, o): return _v(o) / self.val
    def __pow__(self, p): return self.val ** p
    def __neg__(self): return -self.val


class GlobalCoefficient:
    """A named scalar or small-tensor parameter entering integrands
    uniformly (not a field), e.g. the motor's tag-indexed source tables."""

    def __init__(self, name: str, value=0.0, device=None):
        self.name = name
        self.array = torch.as_tensor(np.array(value, np.float64),
                                     dtype=config.dtype,
                                     device=get_device(device))

    def rename(self, name, *_):
        self.name = name


class QR:
    """Two-sided (interior-facet) restriction: u('+') / u('-')."""

    __slots__ = ("p", "m")

    def __init__(self, p: Q, m: Q):
        self.p = p
        self.m = m

    def __call__(self, side: str) -> Q:
        return self.p if side == "+" else self.m


# --- vector/tensor calculus helpers (UFL operator parity) -------------------

def grad(u):
    return u.grad if isinstance(u, Q) else u


def dot(a, b):
    a, b = _v(a), _v(b)
    if a.ndim == 0 or b.ndim == 0:
        return a * b
    if a.ndim == 1 and b.ndim == 1:
        return torch.dot(a, b)
    return torch.matmul(a, b)


# --- deformed-configuration operators ---------------------------------------

def defF(uhat):
    """Deformation gradient F = I + grad(uhat)."""
    g = grad(uhat)
    return torch.eye(g.shape[-1], dtype=g.dtype, device=g.device) + g


def detF(uhat):
    """J = det(F(uhat))."""
    from .assemble import _det_small

    return _det_small(defF(uhat))


# --- integral / form definitions --------------------------------------------

@dataclass
class Integral:
    fn: Callable
    domain: str = "cell"  # "cell" | "interior_facet" | "exterior_facet"
    tag: Optional[object] = None  # int, tuple of ints, or None (everywhere)
    qdeg: Optional[int] = None


def dx(fn, tag=None, qdeg=None) -> Integral:
    """Cell integral (UFL ``dx``)."""
    return Integral(fn, "cell", tag, qdeg)


def ds(fn, tag=None, qdeg=None) -> Integral:
    """Exterior-facet integral (UFL ``ds``)."""
    return Integral(fn, "exterior_facet", tag, qdeg)


def dS(fn, tag=None, qdeg=None) -> Integral:
    """Interior-facet integral (UFL ``dS``)."""
    return Integral(fn, "interior_facet", tag, qdeg)


class FormDef:
    """A sum of integrals over named coefficients; with `test` set it is a
    residual (1-form), linear in ``w.v``."""

    def __init__(self, integrals: Sequence[Integral],
                 coeffs: Sequence[Function | GlobalCoefficient] = (),
                 test: FunctionSpace | None = None):
        self.integrals = list(integrals)
        self.coeffs: dict[str, Function] = {}
        self.globals: dict[str, GlobalCoefficient] = {}
        for f in coeffs:
            target = (self.globals if isinstance(f, GlobalCoefficient)
                      else self.coeffs)
            if (f.name in self.coeffs or f.name in self.globals) \
                    and target.get(f.name) is not f:
                raise ValueError(f"duplicate coefficient name '{f.name}'")
            target[f.name] = f
        self.test: FunctionSpace | None = test
        self._assembler = None  # cache, built by the assemble module

    def __add__(self, other: "FormDef") -> "FormDef":
        """The sum of two forms (e.g. a residual and its Nitsche boundary
        terms): their integrals over the union of their coefficients."""
        if other is None or other == 0:
            return self
        if self.test is not None and other.test is not None \
                and self.test is not other.test:
            raise ValueError("cannot add forms with different test spaces")
        coeffs = {**self.coeffs, **other.coeffs,
                  **self.globals, **other.globals}
        return FormDef(self.integrals + other.integrals, coeffs.values(),
                       self.test or other.test)

    __radd__ = __add__

    def values(self) -> dict[str, torch.Tensor]:
        """Current coefficient arrays (defaults for assembly)."""
        out = {k: f.array for k, f in self.coeffs.items()}
        out.update({k: f.array for k, f in self.globals.items()})
        return out
