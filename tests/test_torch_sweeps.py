"""The port's block-Thomas sweeps (femo_tpu_torch/ops/bt_sweeps.py) against
the JAX package's, on CPU.

Here the wrapper runs its plain PyTorch version (CPU tensors); the CUDA
kernels K1/K2 are held against that plain version on the card by
chip_smoke.py.  Tolerances: 1e-6 relative in f32 (tests/test_pallas_bt.py's
bar, set by f32 rounding through the recurrence), 1e-12 in f64.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from femo_tpu.ops.block_tridiag import BlockTridiagonalMatrix as JMatrix
from femo_tpu.ops.pallas_bt import bt_sweep_solve as jax_bt_sweep_solve

from femo_tpu_torch.ops import bt_sweeps

B = 128

# the port's CPU path is dispatch-bound: extra intra-op threads only
# oversubscribe the cores that parallel test workers share
torch.set_num_threads(1)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _jax_factor(nb, dtype, seed=0):
    """tests/test_pallas_bt.py's well-conditioned system, factored by JAX."""
    rng = np.random.default_rng(seed)
    D = np.tile(np.eye(B) * 4.0, (nb, 1, 1)) \
        + 0.02 * rng.standard_normal((nb, B, B))
    D = 0.5 * (D + np.swapaxes(D, 1, 2))
    L = 0.1 * rng.standard_normal((nb, B, B))
    L[0] = 0
    U = np.swapaxes(np.roll(L, -1, axis=0), 1, 2).copy()
    U[-1] = 0
    mat = JMatrix(jnp.asarray(D, dtype), jnp.asarray(L, dtype),
                  jnp.asarray(U, dtype), np.arange(nb * B), nb * B)
    fac = mat.factor()
    bb = rng.standard_normal((nb, B)).astype(dtype)
    return fac, bb


def _torch(*arrays):
    return [torch.as_tensor(np.array(a)) for a in arrays]


@pytest.mark.parametrize("nb", [1, 3, 9])
def test_plain_sweeps_match_pallas_interpret_f32(nb):
    fac, bb = _jax_factor(nb, np.float32)
    x_j = jax_bt_sweep_solve(fac.Sinv, fac.mat.L, fac.C, jnp.asarray(bb),
                             interpret=True)
    Sinv, L, C, b = _torch(fac.Sinv, fac.mat.L, fac.C, bb)
    x_t = bt_sweeps.bt_sweep_solve(Sinv, L, C, b)
    assert x_t.dtype == torch.float32 and x_t.shape == (nb, B)
    assert _rel(x_t.numpy(), x_j) <= 1e-6


@pytest.mark.parametrize("nb", [1, 3, 9])
def test_plain_sweeps_match_jax_solve_f64(nb):
    fac, bb = _jax_factor(nb, np.float64, seed=nb)
    x_j = fac.solve(jnp.asarray(bb.reshape(-1)))  # lax.scan sweeps
    Sinv, L, C, b = _torch(fac.Sinv, fac.mat.L, fac.C, bb)
    x_t = bt_sweeps.bt_sweep_solve(Sinv, L, C, b)
    assert x_t.dtype == torch.float64
    assert _rel(x_t.numpy().reshape(-1), x_j) <= 1e-12


def test_cpu_tensors_do_not_launch():
    fac, bb = _jax_factor(3, np.float64)
    Sinv, L, C, b = _torch(fac.Sinv, fac.mat.L, fac.C, bb)
    before = dict(bt_sweeps.launches)
    bt_sweeps.bt_sweep_solve(Sinv, L, C, b)
    assert bt_sweeps.launches == before


def test_kernel_launchers_refuse_cpu_tensors():
    fac, bb = _jax_factor(1, np.float64)
    Sinv, L, C, b = _torch(fac.Sinv, fac.mat.L, fac.C, bb)
    with pytest.raises(ValueError, match="CUDA"):
        bt_sweeps.fwd_sweep_cuda(Sinv, L, b)
    with pytest.raises(ValueError, match="CUDA"):
        bt_sweeps.bwd_sweep_cuda(C, b)


@pytest.mark.parametrize("bad", ["block", "dtype", "layout", "shape"])
def test_wrapper_checks_its_inputs(bad):
    nb, Bb = 2, 64
    t = lambda *s: torch.zeros(s, dtype=torch.float64)
    Sinv, L, C, b = t(nb, Bb, Bb), t(nb, Bb, Bb), t(nb, Bb, Bb), t(nb, Bb)
    if bad == "block":
        Sinv, L, C, b = t(nb, 48, 48), t(nb, 48, 48), t(nb, 48, 48), \
            t(nb, 48)
    elif bad == "dtype":
        L = L.float()
    elif bad == "layout":
        C = C.transpose(1, 2)
        C[:, 0, 1] = 1.0  # a transposed view, not a symmetric copy
    else:
        Sinv = t(nb + 1, Bb, Bb)
    with pytest.raises(ValueError):
        bt_sweeps.bt_sweep_solve(Sinv, L, C, b)
