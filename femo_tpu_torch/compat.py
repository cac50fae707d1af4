"""Reference-API compatibility surface (port of femo_tpu/compat.py).

The reference's users wildcard-import everything
(`from femo.fea.fea_dolfinx import *`).  This module mirrors that import
surface name for name, so a reference user can switch with few edits:

    from femo_tpu_torch.compat import *

    mesh = createUnitSquareMesh(16)
    V = FunctionSpace(mesh, ("CG", 1))
    u = Function(V)
    fea = FEA(mesh)
    ...
"""

from __future__ import annotations

import numpy as np
import torch

from .config import config
from .fea import *  # noqa: F401,F403  (FEA, spaces, forms, assembly, BCs)
from .fea import Function, FunctionSpace
from .graph.model import FEAModel  # noqa: F401
from .graph.simulator import Simulator  # noqa: F401
from .graph.optimizer import OptimizationProblem, SLSQP, LBFGSB  # noqa: F401
from .io.xdmf import XDMFWriter as XDMFFile, Recorder  # noqa: F401
from .mesh.gmsh_io import import_mesh  # noqa: F401
from .solvers.linear import LinearSolver  # noqa: F401
from .solvers.newton import newton_solve as solveNonlinear  # noqa: F401


def getFuncArray(f) -> np.ndarray:
    """PETSc-vector extraction parity: the dof vector on the host."""
    return f.array.detach().cpu().numpy()


def setFuncArray(f, arr) -> None:
    """PETSc-vector insertion parity: one assignment, on the Function's
    device, in the working dtype."""
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu().numpy()
    f.array = torch.as_tensor(np.asarray(arr), dtype=config.dtype,
                              device=f.space.device)


def getFormArray(form) -> np.ndarray:
    """Assemble a 1-form to numpy."""
    from .fea import assemble_vector

    return assemble_vector(form).detach().cpu().numpy()


def VectorFunctionSpace(mesh, spec, dim: int | None = None,
                        device=None) -> FunctionSpace:
    """dolfinx VectorFunctionSpace parity: a vector-valued space with gdim
    components by default."""
    return FunctionSpace(mesh, spec, ncomp=dim or mesh.gdim, device=device)


def update(f, arr) -> None:
    """The reference's `update` (utils_dolfinx.py:300-311)."""
    setFuncArray(f, arr)


def computePartials(form, wrt):
    """ufl.derivative + assemble parity."""
    from .fea.utils import compute_partials

    return compute_partials(form, wrt)
