"""Scordelis-Lo roof: shell analysis against the -0.3024 theory oracle, and
nodal shape gradients of the compliance (W10; port of
examples/run_shape_opt_roof.py: `ufl.derivative(form, SpatialCoordinate)`
becomes one autograd pass through the geometry).

python -m femo_tpu_torch.examples.run_shape_opt_roof --n 16
"""

import argparse

import numpy as np
import torch

from femo_tpu_torch.config import config, get_device
from femo_tpu_torch.fea import assemble_scalar
from femo_tpu_torch.fea.bc import DirichletBC
from femo_tpu_torch.fea.shape import shape_gradient
from femo_tpu_torch.mesh.generators import create_rectangle_mesh
from femo_tpu_torch.mesh.mesh import Mesh
from femo_tpu_torch.models.shell import RMShellModel


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=16)
    args = p.parse_args(argv)

    # Scordelis-Lo: R=25 cylinder, L=50, t=0.25, E=4.32e8, self-weight 90
    R, L, t, E, q = 25.0, 50.0, 0.25, 4.32e8, 90.0
    phi_max = np.deg2rad(40.0)
    m2 = create_rectangle_mesh(args.n, args.n, -phi_max, 0.0, phi_max, L,
                               cell_type="triangle")
    phi, y = m2.coords[:, 0], m2.coords[:, 1]
    coords3 = np.stack([R * np.sin(phi), y, R * np.cos(phi)], axis=1)
    mesh = Mesh(coords3, m2.cells, "triangle")

    shell = RMShellModel(mesh, E=E, nu=0.0, drill=1e-3)
    shell.thickness.set(t)
    fa = np.zeros(shell.Vf.n_dofs)
    fa[2::3] = -q
    shell.force.array = torch.as_tensor(fa, dtype=config.dtype,
                                        device=get_device())
    diaph = lambda x: np.isclose(x[1], 0.0) | np.isclose(x[1], L)  # noqa
    bcs = [DirichletBC(shell.Vu, 0.0, where=diaph, component=0),
           DirichletBC(shell.Vu, 0.0, where=diaph, component=2)]
    state, op, x = shell.solve(bcs)

    # free-edge midspan vertical deflection vs theory oracle
    w = shell.u.array.detach().cpu().numpy().reshape(-1, 3)[:, 2]
    c = shell.Vu.scalar_dof_coords
    tgt = np.array([R * np.sin(phi_max), L / 2, R * np.cos(phi_max)])
    edge_mid = np.argmin(np.linalg.norm(c - tgt, axis=1))
    defl = float(w[edge_mid])
    print("=" * 40)
    print(f"Free-edge midspan deflection: {defl:+.4f} "
          f"(theory oracle: -0.3024, reference run_shape_opt_roof.py:224)")

    # nodal shape gradient of the compliance with the frozen state
    g = shape_gradient(shell.compliance_form).detach().cpu().numpy()
    comp = float(assemble_scalar(shell.compliance_form))
    print(f"Compliance: {comp:.6e}")
    print(f"Shape gradient dJ/d(coords): shape {g.shape}, "
          f"|g| = {np.linalg.norm(g):.4e}, "
          f"max |g_i| = {np.abs(g).max():.4e}")
    return {"deflection": defl, "compliance": comp, "shape_grad": g}


if __name__ == "__main__":
    main()
