"""The port's counterpart of the repository's `__graft_entry__.entry()`:
the W1 opt step at nel=32 with the dense-LU Newton step, on the card by
default.

    from femo_tpu_torch.entry import entry
    fn, args = entry()          # device=None: the card
    J, dJ_df = fn(*args)
"""

from __future__ import annotations

from .models.poisson import build_jit_opt_step


def entry(device=None):
    """(step, (f0,)): step(f) -> (J, dJ/df), W1 at nel=32, solver "dense",
    in the port's working dtype (f64 by default) on `device`."""
    step, f0 = build_jit_opt_step(nel=32, solver="dense", device=device)
    return step, (f0,)
