"""Dynamic aeroelastic gust response (W8; port of
examples/run_aeroelasticity_dynamic.py).

python -m femo_tpu_torch.examples.run_aeroelasticity_dynamic --nsteps 20
"""

import argparse

from femo_tpu_torch.models.fsi import DynamicShellFSI, build_wing_fsi


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--nsteps", type=int, default=20)
    p.add_argument("--dt", type=float, default=0.01)
    args = p.parse_args(argv)

    fsi = build_wing_fsi(n_shell=(4, 8), n_vlm=(2, 6))
    dyn = DynamicShellFSI(fsi, dt=args.dt, fsi_iters=5)
    hist = dyn.run(args.nsteps, report=True)
    tips = [float(v) for v in hist["tip_disp"]]
    print("=" * 40)
    print("tip-displacement history:", [round(v, 5) for v in tips])
    return {"tip_disp": tips}


if __name__ == "__main__":
    main()
