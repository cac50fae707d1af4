"""Time a step of this port against the same step of another copy of it
(a checkout of another commit) in one process, alternating call by call.

    python -m femo_tpu_torch.tools.ab_step OTHER_ROOT [--refine 1 4]
        [--refactor-every 3] [--freeze-operator] [--w1 260]
        [--steps 20] [--out FILE]

OTHER_ROOT is the root of the other checkout.  Its `femo_tpu_torch/` is
copied, without its build outputs, to `femo_tpu_torch_b/` beside it (in
that checkout, where it finds the checkout's other files as it expects)
and imported under that name beside this one (the port imports itself
only relatively), so both steps share one process, one card and the
host's state of the moment.  Separate processes cannot
give that: on a shared host their warm medians drift by tens of percent
from run to run.

Each step (the motor step at each `--refine` in the f64 oracle
configuration with the reuse options given, as profile_step builds it;
W1's warm `objective_gradient` at each `--w1` nel) is built and warmed in
both copies, then called `--steps` times in pairs, A B, B A, A B ...,
each call timed on the host clock ending in a device sync.  A is this
checkout, B the other.  It prints per step both medians, the median of
the per-pair ratios B/A and the share of pairs in which B was slower,
and writes the times to `--out` as JSON.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import shutil
import statistics
import subprocess
import sys

import torch

from . import profile_step as ps_a

def import_other(root: str):
    """The other checkout's port, imported as `femo_tpu_torch_b`."""
    pkg = os.path.join(root, "femo_tpu_torch_b")
    shutil.rmtree(pkg, ignore_errors=True)
    shutil.copytree(os.path.join(root, "femo_tpu_torch"), pkg,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    sys.path.insert(0, root)
    return importlib.import_module("femo_tpu_torch_b.tools.profile_step")


def steps_of(ps, args):
    """[(name, step callable)] of one copy, built and warmed once."""
    ps.set_precision("float64")
    kw = {}
    if args.refactor_every != 1:
        kw["refactor_every"] = args.refactor_every
    if args.freeze_operator:
        kw["freeze_operator"] = True
    out = []
    for refine in args.refine:
        step, (dv0, iq0), _ = ps.build_motor_jit_step(
            refine=refine, device="cuda", **dict(ps.ORACLE_CFG, **kw))
        fn = (lambda s=step, d=dv0, i=iq0: s(d, i))
        out.append((f"motor refine {refine}"
                    + "".join(f", {k}={v}" for k, v in kw.items()), fn))
    for nel in args.w1:
        sim = ps.w1_simulator(nel)[0]
        out.append((f"W1 nel={nel} objective_gradient",
                    lambda s=sim: s.objective_gradient("l2_functional",
                                                       ["f"])))
    for _, fn in out:
        ps._sync_time(fn)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other", help="root of the other checkout")
    ap.add_argument("--refine", type=float, nargs="*", default=[1])
    ap.add_argument("--w1", type=int, nargs="*", default=[])
    ap.add_argument("--refactor-every", type=int, default=1)
    ap.add_argument("--freeze-operator", action="store_true")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--out", default="chiprun_out/ab_step.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ab_step needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    ps_b = import_other(os.path.abspath(args.other))
    a, b = steps_of(ps_a, args), steps_of(ps_b, args)
    results = []
    for (name, fa), (_, fb) in zip(a, b):
        ta, tb = [], []
        for k in range(args.steps):  # A first in even pairs, B in odd
            for fn, t in ((fa, ta), (fb, tb))[::1 if k % 2 == 0 else -1]:
                t.append(ps_a._sync_time(fn)[0])
        ratios = [y / x for x, y in zip(ta, tb)]
        r = dict(name=name, a_s=ta, b_s=tb,
                 a_median_s=statistics.median(ta),
                 b_median_s=statistics.median(tb),
                 ratio_median=statistics.median(ratios),
                 b_slower_share=sum(q > 1 for q in ratios) / len(ratios))
        print(f"{name}: A (this checkout) median {r['a_median_s']:.4f} s "
              f"({min(ta):.4f}-{max(ta):.4f}), B ({args.other}) median "
              f"{r['b_median_s']:.4f} s ({min(tb):.4f}-{max(tb):.4f}) over "
              f"{args.steps} alternating calls; B/A median ratio "
              f"{r['ratio_median']:.4f}, B slower in "
              f"{100 * r['b_slower_share']:.0f}% of pairs")
        results.append(r)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": card, "other": args.other, "runs": results}, f,
                  indent=1)


if __name__ == "__main__":
    main()
