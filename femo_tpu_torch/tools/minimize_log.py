"""Record what scipy's optimizers see while a run script drives them.

    with minimize_log() as calls:
        main([...])
    calls[-1]["f"]  # the objective at every evaluation, in order

Every `scipy.optimize.minimize` call made inside the block (the drivers of
`graph/optimizer.py` and the run scripts import it at call time) appends
one record: the method, the objective value at each evaluation (`f`, as
the optimizer sees it: scaled), the gradient of the first evaluation
(`g0`), the final point (`x`), the evaluation count (`nfev`), the
iteration count (`nit`) and the final value (`fun`).  The same records,
taken from a run of the JAX package's script (oracles/examples_oracle.py)
and from a run of the port's, are what the tests and chip_smoke.py
compare.  Pure numpy and scipy: it imports neither torch nor jax.
"""

from __future__ import annotations

import contextlib

import numpy as np


@contextlib.contextmanager
def minimize_log():
    import scipy.optimize as so

    orig = so.minimize
    calls: list[dict] = []

    def minimize(fun, x0, *args, **kw):
        rec = {"method": kw.get("method"), "f": [], "g0": None}

        def logged(x, *a):
            out = fun(x, *a)
            f = out[0] if kw.get("jac") is True else out
            rec["f"].append(float(f))
            if rec["g0"] is None and kw.get("jac") is True:
                rec["g0"] = np.array(out[1], dtype=float)
            return out

        res = orig(logged, x0, *args, **kw)
        rec.update(x=np.array(res.x, dtype=float), nfev=len(rec["f"]),
                   nit=int(getattr(res, "nit", -1)), fun=float(res.fun))
        calls.append(rec)
        return res

    so.minimize = minimize
    try:
        yield calls
    finally:
        so.minimize = orig
