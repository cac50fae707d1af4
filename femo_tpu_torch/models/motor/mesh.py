"""Procedural 2D PM-motor cross-section mesh with tagged subdomains.

A copy of femo_tpu/models/motor/mesh.py (numpy only).

The reference imports a gmsh-generated motor mesh with 50+ tagged regions
(the reference's examples/em_motor_opt/run_motor_opt.py:51-59, subdomain
semantics in motor_pde.py:12-35: 1/2 = rotor/stator electrical steel,
3..14 = twelve magnets, 15..50 = thirty-six windings, 51 = shaft,
>= 52 = air).  Here the same multi-subdomain topology is generated
procedurally on a polar grid — same tag semantics, self-contained.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ...mesh.mesh import Mesh


@dataclass(frozen=True)
class MotorTags:
    ROTOR_STEEL = 1
    STATOR_STEEL = 2
    MAGNET_FIRST = 3     # 3..14 (12 magnets)
    MAGNET_LAST = 14
    WINDING_FIRST = 15   # 15..50 (36 windings)
    WINDING_LAST = 50
    SHAFT = 51
    AIR = 52
    # facet tags
    OUTER_BOUNDARY = 1001
    INNER_BOUNDARY = 1000
    MAGNET_INTERFACE = 2000  # interior facets bounding the magnet ring


# ring radii (m): shaft | rotor core | magnet ring | air gap | winding ring
# | stator core
RADII = dict(r0=0.010, r1=0.020, r2=0.032, r3=0.037, r4=0.0395,
             r5=0.048, r6=0.060)

N_MAGNETS = 12
N_WINDINGS = 36


def create_motor_mesh(refine: float = 1):
    """Triangle mesh of the motor annulus with subdomain + facet tags.

    refine=1 -> 144 angular x 20 radial layers (~5.8k cells);
    each +1 doubles angular resolution.
    """
    r = RADII
    n_theta = int(144 * refine)
    assert n_theta % 72 == 0, "refine must be a multiple of 0.5"
    sc = max(refine, 0.5)
    # radial layers per ring (proportional to thickness, min resolution)
    layers = {
        "shaft": max(1, int(2 * sc)), "rotor": max(1, int(4 * sc)),
        "magnet": max(1, int(2 * sc)), "gap": max(1, int(1 * sc)),
        "winding": max(1, int(3 * sc)), "stator": max(1, int(4 * sc)),
    }
    bounds = [r["r0"], r["r1"], r["r2"], r["r3"], r["r4"], r["r5"], r["r6"]]
    names = ["shaft", "rotor", "magnet", "gap", "winding", "stator"]

    radii = [bounds[0]]
    ring_of_layer = []
    for i, nm in enumerate(names):
        nl = layers[nm]
        rr = np.linspace(bounds[i], bounds[i + 1], nl + 1)[1:]
        radii.extend(rr)
        ring_of_layer.extend([i] * nl)
    radii = np.array(radii)
    nr = len(radii) - 1

    theta = np.linspace(0, 2 * np.pi, n_theta + 1)[:-1]
    R, T = np.meshgrid(radii, theta, indexing="ij")
    coords = np.stack(
        [(R * np.cos(T)).ravel(), (R * np.sin(T)).ravel()], axis=1)

    def vid(i, j):
        return i * n_theta + (j % n_theta)

    I, J = np.meshgrid(np.arange(nr), np.arange(n_theta), indexing="ij")
    I, J = I.ravel(), J.ravel()
    v00, v10 = vid(I, J), vid(I + 1, J)
    v01, v11 = vid(I, J + 1), vid(I + 1, J + 1)
    t1 = np.stack([v00, v10, v11], axis=1)
    t2 = np.stack([v00, v11, v01], axis=1)
    cells = np.stack([t1, t2], axis=1).reshape(-1, 3)
    layer_of_cell = np.repeat(I, 2)
    jidx_of_cell = np.repeat(J, 2)
    ring_of_cell = np.asarray(ring_of_layer)[layer_of_cell]

    # angular sector tagging
    T = MotorTags
    tags = np.full(len(cells), T.AIR, np.int32)
    tags[ring_of_cell == 0] = T.SHAFT
    tags[ring_of_cell == 1] = T.ROTOR_STEEL
    tags[ring_of_cell == 3] = T.AIR  # air gap
    tags[ring_of_cell == 5] = T.STATOR_STEEL

    # magnet ring: 12 sectors of 30 deg = (n_theta//12) cells-columns each;
    # central 3/4 of each sector is magnet, the rest rotor-steel bridge
    sec = n_theta // N_MAGNETS
    mag_cols = jidx_of_cell % sec
    frac = mag_cols / sec
    in_mag = (frac >= 0.125) & (frac < 0.875)
    mag_id = jidx_of_cell // sec  # 0..11
    sel = ring_of_cell == 2
    tags[sel & in_mag] = (T.MAGNET_FIRST + mag_id[sel & in_mag]).astype(
        np.int32)
    tags[sel & ~in_mag] = T.ROTOR_STEEL

    # winding ring: 36 slots of 10 deg; central 3/4 is copper, rest stator
    # teeth
    secw = n_theta // N_WINDINGS
    wfrac = (jidx_of_cell % secw) / secw
    in_w = (wfrac >= 0.125) & (wfrac < 0.875)
    w_id = jidx_of_cell // secw  # 0..35
    selw = ring_of_cell == 4
    tags[selw & in_w] = (T.WINDING_FIRST + w_id[selw & in_w]).astype(np.int32)
    tags[selw & ~in_w] = T.STATOR_STEEL

    mesh = Mesh(coords, cells, "triangle", cell_tags=tags)

    # facet tags: inner/outer boundary; interior interfaces of the magnet
    # ring (the moving surfaces driven by shape design)
    rr = np.linalg.norm(coords, axis=1)
    mesh.mark_boundary_facets(
        T.OUTER_BOUNDARY,
        lambda x: np.hypot(x[0], x[1]) > r["r6"] - 1e-9)
    mesh.mark_boundary_facets(
        T.INNER_BOUNDARY,
        lambda x: np.hypot(x[0], x[1]) < r["r0"] + 1e-9)
    for rint in (r["r2"], r["r3"]):
        mesh.mark_facets(
            T.MAGNET_INTERFACE,
            lambda x, rint=rint: np.isclose(np.hypot(x[0], x[1]), rint,
                                            atol=1e-9))
    return mesh
