"""Form language: quadrature-point values, operators and form definitions
(port of femo_tpu/fea/forms.py).

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

Operators that make a tensor of their own (``Identity``, and the
functions of plain numbers) make it on the device of the form being
assembled, which the assembly engine sets with `integrand_device`.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..config import config, get_device
from .space import Function, FunctionSpace


_DEVICE = [None]  # the device of the form being assembled


@contextlib.contextmanager
def integrand_device(device):
    """Within the block, operators that make tensors make them on
    `device` (set by the assembly engine around its integrand calls)."""
    prev, _DEVICE[0] = _DEVICE[0], device
    try:
        yield
    finally:
        _DEVICE[0] = prev


def _device():
    return _DEVICE[0] if _DEVICE[0] is not None else get_device("cpu")


def _v(x):
    """Coerce Q -> value tensor."""
    return x.val if isinstance(x, Q) else x


def _t(x):
    """Coerce Q or a plain number -> tensor."""
    x = _v(x)
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(x, dtype=config.dtype, device=_device())


class Q:
    """A coefficient's value at a quadrature point: ``val`` () or (ncomp,),
    ``grad`` (gdim,) or (ncomp, gdim), and for elements with Hessian
    tables ``hess`` (gdim, gdim) or (ncomp, gdim, gdim).  Arithmetic
    coerces to plain tensors so expressions read like UFL."""

    __slots__ = ("val", "_grad", "_hess")

    def __init__(self, val, grad=None, hess=None):
        self.val = val
        self._grad = grad
        self._hess = hess

    @property
    def grad(self):
        if self._grad is None:
            raise ValueError("gradient not available for this quantity")
        return self._grad

    @property
    def hess(self):
        if self._hess is None:
            raise ValueError(
                "hessian not tabulated for this element (supported for "
                "Hermite/interval families)")
        return self._hess

    def __getitem__(self, i):
        g = None if self._grad is None else self._grad[i]
        h = None if self._hess is None else self._hess[i]
        return Q(self.val[i], g, h)

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
    def __abs__(self): return torch.abs(self.val)


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


def hess(u):
    """Second-derivative tensor (gdim, gdim), for 4th-order forms such as
    the Euler-Bernoulli beam."""
    return u.hess if isinstance(u, Q) else u


def _tr(a):
    return torch.diagonal(a, dim1=-2, dim2=-1).sum(-1)


def div_grad(u):
    """Laplacian tr(hess(u)) of a scalar field."""
    return _tr(hess(u))


def div(u):
    return _tr(u.grad if isinstance(u, Q) else u)


def curl2d(u):
    """Scalar curl of a 2D vector field; rotated gradient of a scalar."""
    g = grad(u)
    if g.ndim == 1:  # scalar field: perp gradient
        return torch.stack([g[1], -g[0]])
    return g[1, 0] - g[0, 1]


def dot(a, b):
    a, b = _t(a), _t(b)
    if a.ndim == 0 or b.ndim == 0:
        return a * b
    if a.ndim == 1 and b.ndim == 1:
        return torch.dot(a, b)
    return torch.matmul(a, b)


def inner(a, b):
    return torch.sum(_t(a) * _t(b))


def outer(a, b):
    return _t(a)[:, None] * _t(b)[None, :]


def cross(a, b):
    a, b = _t(a), _t(b)
    if a.shape[-1] == 2:  # 2D: the scalar z-component
        return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]
    return torch.linalg.cross(a, b)


def sym(a):
    a = _t(a)
    return 0.5 * (a + a.transpose(-1, -2))


def skew(a):
    a = _t(a)
    return 0.5 * (a - a.transpose(-1, -2))


def tr(a):
    return _tr(_t(a))


def dev(a):
    a = _t(a)
    d = a.shape[-1]
    return a - (_tr(a) / d) * torch.eye(d, dtype=a.dtype, device=a.device)


def Identity(d: int):
    return torch.eye(d, dtype=config.dtype, device=_device())


def det(a):
    from .assemble import _det_small

    return _det_small(_t(a))


def inv(a):
    from .assemble import _inv_small

    return _inv_small(_t(a))


def transpose(a):
    return _t(a).transpose(-1, -2)


def sqrt(a):
    return torch.sqrt(_t(a))


def exp(a):
    return torch.exp(_t(a))


def ln(a):
    return torch.log(_t(a))


def sin(a):
    return torch.sin(_t(a))


def cos(a):
    return torch.cos(_t(a))


def conditional(cond, a, b):
    """ufl.conditional: a where cond holds, else b."""
    return torch.where(cond, _t(a), _t(b))


def lt(a, b): return _t(a) < _t(b)
def gt(a, b): return _t(a) > _t(b)
def le(a, b): return _t(a) <= _t(b)
def ge(a, b): return _t(a) >= _t(b)


def avg(u):
    if isinstance(u, QR):
        return 0.5 * (u.p.val + u.m.val)
    return 0.5 * (_v(u("+")) + _v(u("-")))


def jump(u, n=None):
    if isinstance(u, QR):
        d = u.p.val - u.m.val
    else:
        d = _v(u("+")) - _v(u("-"))
    if n is None:
        return d
    d, n = _t(d), _t(n)
    return outer(d, n) if d.ndim else d * n


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
