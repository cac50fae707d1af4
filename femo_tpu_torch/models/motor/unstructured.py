"""Unstructured gmsh-format motor mesh: generator and .msh writer.

A copy of femo_tpu/models/motor/unstructured.py (numpy only), kept beside
the port because importing anything under femo_tpu imports jax.  It
writes a genuinely unstructured motor cross-section .msh (v2.2 ASCII)
plus an .ini association table with the same 52-subdomain tag semantics
as the procedural polar mesh (mesh.py): every circle of nodes gets an
incommensurate angular count plus angular jitter, interior circles get
radial jitter, so vertex valences are irregular and the node numbering
carries no banded structure.  Material interfaces stay conforming, and
the circles at r0/r2/r3/r6 keep their nodes exactly on the circle, so the
model's rim and interface predicates work unchanged on the imported mesh.
"""

from __future__ import annotations

import os

import numpy as np

from .mesh import MotorTags, N_MAGNETS, N_WINDINGS, RADII

T = MotorTags


def _sector_boundary_angles(n_sectors: int) -> np.ndarray:
    """Exact angular positions of the material-sector boundaries used by
    the procedural mesh (mesh.py:106/117: central 3/4 of each sector is
    magnet/copper, i.e. boundaries at fractions 0.125 and 0.875)."""
    sec = 2 * np.pi / n_sectors
    s = np.arange(n_sectors)
    return np.sort(np.concatenate([(s + 0.125) * sec, (s + 0.875) * sec]))


def _circle_angles(n_base: int, insert: np.ndarray | None, rng,
                   jitter: float = 0.35) -> np.ndarray:
    """Sorted angles in [0, 2pi): n_base jittered quasi-uniform angles,
    with `insert` angles kept EXACT (base angles too close are dropped)."""
    sp = 2 * np.pi / n_base
    th = (np.arange(n_base) + 0.5) * sp
    th = np.mod(th + rng.uniform(-jitter, jitter, n_base) * sp, 2 * np.pi)
    if insert is not None and len(insert):
        ins = np.mod(np.asarray(insert, float), 2 * np.pi)
        d = np.abs((th[:, None] - ins[None, :] + np.pi) % (2 * np.pi)
                   - np.pi).min(axis=1)
        th = np.concatenate([th[d > 0.45 * sp], ins])
    th = np.sort(th)
    # guard against near-duplicate angles (degenerate slivers)
    keep = np.ones(len(th), bool)
    keep[1:] = np.diff(th) > 1e-6
    return th[keep]


def _zip_strip(inner_ids, inner_th, outer_ids, outer_th):
    """Triangulate the annular strip between two node circles (the classic
    zipper between two closed polylines sorted by angle).

    Advances the side whose NEXT vertex has the smaller angle; on ties
    (the exactly-inserted sector-boundary angles present in both circles)
    the inner side advances first, which makes the radial chord at the
    shared angle an edge of the triangulation — material sectors stay
    conforming.  Returns (ni + no, 3) int32 triangles (global node ids),
    counterclockwise.
    """
    ni, no = len(inner_th), len(outer_th)
    tris = np.empty((ni + no, 3), np.int64)
    k = 0
    i = j = 0

    def ia(m):
        return inner_th[m] if m < ni else inner_th[0] + 2 * np.pi

    def oa(m):
        return outer_th[m] if m < no else outer_th[0] + 2 * np.pi

    while i < ni or j < no:
        if i < ni and (j >= no or ia(i + 1) <= oa(j + 1)):
            # advance inner: (I_i, O_j, I_{i+1}) with CCW = (I_i, I_{i+1}, O_j)
            tris[k] = (inner_ids[i], inner_ids[(i + 1) % ni],
                       outer_ids[j % no])
            i += 1
        else:
            tris[k] = (inner_ids[i % ni], outer_ids[(j + 1) % no],
                       outer_ids[j % no])
            j += 1
        k += 1
    return tris[:k]


def _ring_layers(refine: float) -> list[tuple[str, int]]:
    """Radial sub-layer counts per ring, matching the procedural mesh's
    proportions (mesh.py:56-60)."""
    sc = max(refine, 0.5)
    return [("shaft", max(1, int(2 * sc))), ("rotor", max(1, int(4 * sc))),
            ("magnet", max(1, int(2 * sc))), ("gap", max(1, int(1 * sc))),
            ("winding", max(1, int(3 * sc))), ("stator", max(1, int(4 * sc)))]


def generate_motor_mesh_arrays(refine: float = 1, seed: int = 0):
    """Build the unstructured motor triangulation in memory.

    Returns (coords (n,2), tris (m,3), cell_tags (m,), facet_lines) where
    facet_lines is a list of (tag, (k,2) int array) line-element blocks.
    """
    rng = np.random.default_rng(seed)
    r = RADII
    bounds = [r["r0"], r["r1"], r["r2"], r["r3"], r["r4"], r["r5"], r["r6"]]
    layers = _ring_layers(refine)
    mag_b = _sector_boundary_angles(N_MAGNETS)
    wind_b = _sector_boundary_angles(N_WINDINGS)

    # global circle stack: shared circles at ring boundaries appear once.
    # Each circle: (radius, insert_angles, exact_radius: bool)
    circles: list[tuple[float, np.ndarray | None, bool]] = []
    ring_of_strip: list[str] = []  # ring name per inter-circle strip
    for ridx, (name, nl) in enumerate(layers):
        rr = np.linspace(bounds[ridx], bounds[ridx + 1], nl + 1)
        # which inserts does a circle of this ring need? interfaces must be
        # conforming on BOTH bounding circles and every interior circle
        ins = {"magnet": mag_b, "winding": wind_b}.get(name)
        for k, rad in enumerate(rr):
            if ridx > 0 and k == 0:
                # shared with previous ring: merge this ring's inserts into
                # the already-appended boundary circle
                if ins is not None:
                    prev_r, prev_ins, prev_exact = circles[-1]
                    merged = (ins if prev_ins is None
                              else np.unique(np.concatenate([prev_ins, ins])))
                    circles[-1] = (prev_r, merged, prev_exact)
                continue
            interior = 0 < k < nl
            circles.append((float(rad), ins,
                            not interior))  # ring-bound radii stay exact
        ring_of_strip.extend([name] * nl)

    # target spacing: match the procedural mesh's mid-radius resolution
    # (n_theta = 144*refine at every radius there)
    h_t = 2 * np.pi * r["r4"] / (144.0 * refine)

    coords_list = []
    circ_ids = []
    circ_th = []
    nid = 0
    for cidx, (rad, ins, exact) in enumerate(circles):
        n_base = max(20, int(round(2 * np.pi * rad / h_t)))
        # deterministic incommensurate offset: kills any accidental
        # commensurability between neighboring circles
        n_base += (cidx * 7) % 5 - 2
        th = _circle_angles(n_base, ins, rng)
        rr_pt = np.full(len(th), rad)
        if not exact:
            # radial jitter on interior circles (bounded: strips stay valid
            # for any radial perturbation since the zipper uses angles only)
            gap_lo = rad - circles[cidx - 1][0]
            gap_hi = circles[cidx + 1][0] - rad
            amp = 0.25 * min(gap_lo, gap_hi)
            rr_pt = rr_pt + rng.uniform(-amp, amp, len(th))
        coords_list.append(
            np.stack([rr_pt * np.cos(th), rr_pt * np.sin(th)], axis=1))
        circ_ids.append(np.arange(nid, nid + len(th), dtype=np.int64))
        circ_th.append(th)
        nid += len(th)
    coords = np.concatenate(coords_list, axis=0)

    all_tris = []
    all_tags = []
    for s, name in enumerate(ring_of_strip):
        tris = _zip_strip(circ_ids[s], circ_th[s],
                          circ_ids[s + 1], circ_th[s + 1])
        cents = coords[tris].mean(axis=1)
        thc = np.mod(np.arctan2(cents[:, 1], cents[:, 0]), 2 * np.pi)
        tags = np.full(len(tris), T.AIR, np.int32)
        if name == "shaft":
            tags[:] = T.SHAFT
        elif name in ("rotor",):
            tags[:] = T.ROTOR_STEEL
        elif name == "stator":
            tags[:] = T.STATOR_STEEL
        elif name == "gap":
            tags[:] = T.AIR
        elif name == "magnet":
            sec = 2 * np.pi / N_MAGNETS
            frac = np.mod(thc, sec) / sec
            sid = np.minimum((thc // sec).astype(int), N_MAGNETS - 1)
            in_m = (frac >= 0.125) & (frac < 0.875)
            tags[:] = T.ROTOR_STEEL
            tags[in_m] = (T.MAGNET_FIRST + sid[in_m]).astype(np.int32)
        elif name == "winding":
            sec = 2 * np.pi / N_WINDINGS
            frac = np.mod(thc, sec) / sec
            sid = np.minimum((thc // sec).astype(int), N_WINDINGS - 1)
            in_w = (frac >= 0.125) & (frac < 0.875)
            tags[:] = T.STATOR_STEEL
            tags[in_w] = (T.WINDING_FIRST + sid[in_w]).astype(np.int32)
        all_tris.append(tris)
        all_tags.append(tags)
    tris = np.concatenate(all_tris, axis=0)
    tags = np.concatenate(all_tags, axis=0)

    # enforce CCW orientation (positive area)
    p = coords[tris]
    area2 = ((p[:, 1, 0] - p[:, 0, 0]) * (p[:, 2, 1] - p[:, 0, 1])
             - (p[:, 1, 1] - p[:, 0, 1]) * (p[:, 2, 0] - p[:, 0, 0]))
    flip = area2 < 0
    tris[flip] = tris[flip][:, [0, 2, 1]]

    def circle_lines(ids):
        return np.stack([ids, np.roll(ids, -1)], axis=1)

    # facet line blocks: rims + both magnet-interface circles (the full
    # circles, matching mesh.py:134-138 mark_facets semantics)
    radius_of = [c[0] for c in circles]

    def circle_at(rad):
        return int(np.argmin(np.abs(np.asarray(radius_of) - rad)))

    facet_lines = [
        (T.INNER_BOUNDARY, circle_lines(circ_ids[circle_at(r["r0"])])),
        (T.OUTER_BOUNDARY, circle_lines(circ_ids[circle_at(r["r6"])])),
        (T.MAGNET_INTERFACE, circle_lines(circ_ids[circle_at(r["r2"])])),
        (T.MAGNET_INTERFACE, circle_lines(circ_ids[circle_at(r["r3"])])),
    ]
    return coords, tris.astype(np.int32), tags, facet_lines


def region_names() -> dict[str, int]:
    """The association-table entries (reference .ini semantics,
    utils_dolfinx.py:110-118)."""
    names = {"rotor_steel": T.ROTOR_STEEL, "stator_steel": T.STATOR_STEEL,
             "shaft": T.SHAFT, "air": T.AIR}
    for i in range(N_MAGNETS):
        names[f"magnet_{i + 1}"] = T.MAGNET_FIRST + i
    for i in range(N_WINDINGS):
        names[f"winding_{i + 1}"] = T.WINDING_FIRST + i
    names["inner_boundary"] = T.INNER_BOUNDARY
    names["outer_boundary"] = T.OUTER_BOUNDARY
    names["magnet_interface"] = T.MAGNET_INTERFACE
    return names


def write_motor_msh(path: str, refine: float = 1, seed: int = 0) -> str:
    """Write the unstructured motor mesh as gmsh v2.2 ASCII .msh plus a
    `.ini` association table next to it.  Returns the .ini path.

    Coordinates are written with %.17g so interface nodes survive the
    round-trip exactly (the model's rim/interface predicates use
    atol=1e-9 on the radius).
    """
    coords, tris, tags, facet_lines = generate_motor_mesh_arrays(
        refine, seed)
    names = region_names()
    lines = ["$MeshFormat", "2.2 0 8", "$EndMeshFormat"]
    lines.append("$PhysicalNames")
    lines.append(str(len(names)))
    for nm, tag in names.items():
        dim = 1 if tag >= 1000 else 2
        lines.append(f'{dim} {tag} "{nm}"')
    lines.append("$EndPhysicalNames")
    lines.append("$Nodes")
    lines.append(str(len(coords)))
    for i, (x, y) in enumerate(coords):
        lines.append("%d %.17g %.17g 0" % (i + 1, x, y))
    lines.append("$EndNodes")
    n_lines = sum(len(b) for _, b in facet_lines)
    lines.append("$Elements")
    lines.append(str(n_lines + len(tris)))
    eid = 1
    for ftag, block in facet_lines:
        for a, b in block:
            lines.append(f"{eid} 1 2 {ftag} {ftag} {a + 1} {b + 1}")
            eid += 1
    for tri, tag in zip(tris, tags):
        lines.append(f"{eid} 2 2 {tag} {tag} "
                     f"{tri[0] + 1} {tri[1] + 1} {tri[2] + 1}")
        eid += 1
    lines.append("$EndElements")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")

    ini_path = os.path.splitext(path)[0] + ".ini"
    with open(ini_path, "w") as f:
        f.write("[subdomains]\n")
        for nm, tag in names.items():
            if tag < 1000:
                f.write(f"{nm} = {tag}\n")
        f.write("\n[boundaries]\n")
        for nm, tag in names.items():
            if tag >= 1000:
                f.write(f"{nm} = {tag}\n")
    return ini_path
