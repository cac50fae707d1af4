"""Public FEA API (port of femo_tpu/fea/__init__.py): wildcard-import
friendly, with the reference helper names beside the snake_case ones.
Imports torch, numpy and the port's own modules only."""

from ..mesh.mesh import Mesh
from ..mesh.generators import (
    create_interval_mesh,
    create_rectangle_mesh,
    create_unit_square_mesh,
    create_box_mesh,
    create_unit_cube_mesh,
    create_annulus_mesh,
)
from ..elements.element import Element
from .space import FunctionSpace, Function, TestFunction
from .forms import (
    FormDef, Integral, dx, ds, dS, Q, QR,
    grad, hess, div_grad, div, curl2d, dot, inner, outer, cross, sym, skew, tr, dev,
    Identity, det, inv, transpose, sqrt, exp, ln, sin, cos,
    conditional, lt, gt, le, ge, avg, jump,
)
from .assemble import (
    assemble_scalar, assemble_vector, assemble_matrix, compile_form,
    CompiledForm, ElementMatrix, MatBlock,
)
from .bc import DirichletBC, bc_arrays, apply_bc, constrain_residual
from .project import project_form, lumped_mass
from .fea import FEA
from .utils import (errorNorm, error_norm, compute_partials,
                    find_node_indices, findNodeIndices, locate_dofs_polar,
                    locateDOFs, move)

# aliases matching the reference's helper names (utils_dolfinx.py)
createUnitSquareMesh = create_unit_square_mesh
createIntervalMesh = create_interval_mesh
createRectangleMesh = create_rectangle_mesh
