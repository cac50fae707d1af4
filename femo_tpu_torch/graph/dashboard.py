"""Optimization dashboard: per-iteration history plots (port of
femo_tpu/graph/dashboard.py).

Parity with the reference's lsdo_dash hookup (frames of historic plotters
for objective, constraint and design-variable trajectories).  An
OptimizationProblem callback: every objective evaluation appends to the
history, whose values are host numpy arrays, and renders a PNG frame with
matplotlib, imported when a frame is drawn.
"""

from __future__ import annotations

import os

import numpy as np
import torch


class Dashboard:
    """Hooks into an OptimizationProblem and renders history frames.

    Parameters
    ----------
    prob : OptimizationProblem — the driver's problem (its `callbacks`
        list gets this dashboard's update method).
    outdir : directory for PNG frames + final summary plot.
    every : render a frame every N iterations (1 = every iteration, like
        lsdo_dash; rendering costs ~100 ms per frame).
    dv_names : subset of design variables to plot (default: all).
    """

    def __init__(self, prob, outdir: str = "dash_output", every: int = 1,
                 dv_names=None, mesh=None, field_fn=None,
                 field_name: str = "field"):
        self.prob = prob
        self.outdir = outdir
        self.every = max(1, int(every))
        self.dv_names = dv_names
        # 3D geometry/field frames (lsdo_dash parity: dash_pav.py:9-80
        # renders the wing geometry + stress field each frame): field_fn
        # (rec) -> per-vertex scalar drawn on `mesh` (3D trisurf for
        # surface meshes, flat tripcolor for planar ones)
        self.mesh = mesh
        self.field_fn = field_fn
        self.field_name = field_name
        os.makedirs(outdir, exist_ok=True)
        prob.callbacks.append(self.update)

    # -- callback -----------------------------------------------------------------
    def update(self, rec: dict):
        it = rec["iter"]
        if it % self.every == 0:
            self.render_frame(os.path.join(
                self.outdir, f"frame_{it:04d}.png"))

    # -- rendering ------------------------------------------------------------------
    def render_frame(self, path: str):
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        hist = self.prob.history
        if not hist:
            return
        iters = [h["iter"] for h in hist]
        objs = [h["obj"] for h in hist]
        dv_names = self.dv_names or list(hist[-1]["dvs"].keys())
        con_names = list(hist[-1].get("constraints", {}).keys())
        nrows = 1 + (1 if dv_names else 0) + (1 if con_names else 0)
        fig, axes = plt.subplots(
            nrows, 1, figsize=(7, 2.6 * nrows), sharex=True, squeeze=False)
        axes = axes[:, 0]
        ax = axes[0]
        ax.plot(iters, objs, "o-", ms=3)
        ax.set_ylabel(self.prob.model.objective["name"])
        ax.grid(alpha=0.3)
        k = 1
        if dv_names:
            ax = axes[k]
            for n in dv_names:
                vals = np.array([np.atleast_1d(h["dvs"][n]).ravel()
                                 for h in hist])
                for j in range(min(vals.shape[1], 8)):
                    ax.plot(iters, vals[:, j],
                            label=f"{n}[{j}]" if vals.shape[1] > 1 else n)
            ax.set_ylabel("design vars")
            ax.legend(fontsize=7, ncol=2)
            ax.grid(alpha=0.3)
            k += 1
        if con_names:
            ax = axes[k]
            for n in con_names:
                vals = [float(np.atleast_1d(h["constraints"][n]).ravel()[0])
                        for h in hist]
                ax.plot(iters, vals, label=n)
            ax.set_ylabel("constraints")
            ax.legend(fontsize=7)
            ax.grid(alpha=0.3)
        axes[-1].set_xlabel("optimization iteration")
        fig.tight_layout()
        fig.savefig(path, dpi=110)
        plt.close(fig)
        if self.mesh is not None and self.field_fn is not None:
            self.render_field_frame(
                path.replace(".png", f"_{self.field_name}.png"), hist[-1])

    def render_field_frame(self, path: str, rec: dict):
        """3D geometry + nodal-field frame (reference: lsdo_dash geometry/
        stress plotters, dash_pav.py:9-80).

        Returns the rendered color array (one value per plotted triangle
        for per-cell data / trisurf, one per node for planar nodal data)
        so callers and tests can check what was actually drawn."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        mesh = self.mesh
        vals = self.field_fn(rec)
        if isinstance(vals, torch.Tensor):
            vals = vals.detach().cpu().numpy()
        vals = np.asarray(vals).ravel()
        cells = np.asarray(mesh.cells)
        n_orig_cells = cells.shape[0]
        if cells.shape[1] == 4:  # split quads into triangles
            cells = np.concatenate(
                [cells[:, [0, 1, 2]], cells[:, [0, 2, 3]]], axis=0)
        # disambiguate explicitly: nodal wins when n_cells == n_nodes
        # (nodal data is the common case); anything matching neither
        # length is a user error worth a clear message rather than a
        # matplotlib exception mid-optimization
        if vals.shape[0] == mesh.n_nodes:
            per_cell = False
        elif vals.shape[0] == n_orig_cells:
            per_cell = True
        else:
            raise ValueError(
                f"field_fn returned {vals.shape[0]} values; expected "
                f"per-node ({mesh.n_nodes}) or per-cell ({n_orig_cells}) "
                "data (higher-order fields must be restricted to "
                "vertices before plotting)")
        if per_cell and cells.shape[0] != n_orig_cells:
            vals = np.concatenate([vals, vals])  # quad -> 2 tris
        coords = np.asarray(mesh.coords)
        fig = plt.figure(figsize=(7, 5))
        if coords.shape[1] == 3 and np.ptp(coords[:, 2]) / (
                np.ptp(coords[:, :2]) + 1e-30) > 1e-9:
            ax = fig.add_subplot(projection="3d")
            surf = ax.plot_trisurf(
                coords[:, 0], coords[:, 1], coords[:, 2],
                triangles=cells, cmap="viridis", linewidth=0.1)
            surf.set_array(vals if per_cell else vals[cells].mean(axis=1))
            fig.colorbar(surf, ax=ax, shrink=0.6, label=self.field_name)
            rendered = np.asarray(surf.get_array())
        else:
            ax = fig.add_subplot()
            tpc = ax.tripcolor(
                coords[:, 0], coords[:, 1], cells, vals,
                shading="flat" if per_cell else "gouraud", cmap="viridis")
            fig.colorbar(tpc, ax=ax, label=self.field_name)
            ax.set_aspect("equal")
            rendered = np.asarray(tpc.get_array())
        ax.set_title(f"{self.field_name} @ iter {rec['iter']}")
        fig.tight_layout()
        fig.savefig(path, dpi=110)
        plt.close(fig)
        return rendered

    def finalize(self):
        """Render the final summary frame (summary.png)."""
        self.render_frame(os.path.join(self.outdir, "summary.png"))
        return os.path.join(self.outdir, "summary.png")
