"""Dynamic aeroelasticity driven by external (VPM-style) restart loads
(W9; port of examples/run_aeroelasticity_vpm.py): precomputed loads are
read from a restart file and fed to the dynamic shell, with no in-loop
aerodynamic solve.

With no --restart file given, a synthetic rotor-wake-like load history
(models/fsi.py::synthetic_restart: ramp-up plus a per-rev oscillation) is
written to the temporary directory first, so the script runs out of the
box:

python -m femo_tpu_torch.examples.run_aeroelasticity_vpm --nsteps 20
python -m femo_tpu_torch.examples.run_aeroelasticity_vpm --restart loads.h5
"""

import argparse
import os
import tempfile

from femo_tpu_torch.models.fsi import (
    DynamicShellFSI, aero_forces_from_file, build_wing_fsi,
    synthetic_restart)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--restart", default=None,
                   help=".h5/.npz restart file with `time` (n_t,) and "
                        "`forces` (n_t, n_pts, 3) datasets")
    p.add_argument("--nsteps", type=int, default=20)
    p.add_argument("--dt", type=float, default=0.01)
    args = p.parse_args(argv)

    fsi = build_wing_fsi(n_shell=(4, 8), n_vlm=(2, 6))
    restart = args.restart
    if restart is None:
        n_pts = fsi["force_map"].W.shape[0]
        restart = synthetic_restart(
            os.path.join(tempfile.gettempdir(), "vpm_restart.npz"), n_pts,
            t_end=args.nsteps * args.dt)
        print(f"no --restart given; wrote synthetic loads to {restart}")

    loads = aero_forces_from_file(restart)
    dyn = DynamicShellFSI(fsi, dt=args.dt)
    hist = dyn.run(args.nsteps, report=True, aero_forces_fn=loads)
    tips = [float(v) for v in hist["tip_disp"]]
    print("=" * 40)
    print("tip-displacement history:", [round(v, 5) for v in tips])
    return {"tip_disp": tips, "restart": restart}


if __name__ == "__main__":
    main()
