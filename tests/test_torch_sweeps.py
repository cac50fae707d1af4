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


def _jax_factor(nb, dtype, seed=0, B=B):
    """tests/test_pallas_bt.py's well-conditioned system, factored by JAX;
    above B=128 its random parts scale with sqrt(128/B), so that the
    conditioning does not grow with B (no change at B=128)."""
    rng = np.random.default_rng(seed)
    a = np.sqrt(128 / B)
    D = np.tile(np.eye(B) * 4.0, (nb, 1, 1)) \
        + 0.02 * a * rng.standard_normal((nb, B, B))
    D = 0.5 * (D + np.swapaxes(D, 1, 2))
    L = 0.1 * a * rng.standard_normal((nb, B, B))
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


@pytest.mark.parametrize("nb, width", [(1, B), (3, B), (9, B), (2, 512)],
                         ids=["1", "3", "9", "2-B512"])
def test_plain_sweeps_match_jax_solve_f64(nb, width):
    fac, bb = _jax_factor(nb, np.float64, seed=nb, B=width)
    x_j = fac.solve(jnp.asarray(bb.reshape(-1)))  # lax.scan sweeps
    Sinv, L, C, b = _torch(fac.Sinv, fac.mat.L, fac.C, bb)
    x_t = bt_sweeps.bt_sweep_solve(Sinv, L, C, b)
    assert x_t.dtype == torch.float64 and x_t.shape == (nb, width)
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("width", [128, 160, 256, 512])
def test_sweep_plan_geometry(width, dtype):
    """The launch geometry of both kernels on an H100 (132 SMs): the CTAs'
    row ranges tile [0, B) exactly, the CTAs fit one to an SM, the shared
    memory fits a block, and every bulk copy (one CTA's rows of one block)
    is 16-byte aligned in size and offset."""
    elem = torch.empty((), dtype=dtype).element_size()
    for kernel in ("K1", "K2"):
        for nb in (1, 2, 147):
            plan = bt_sweeps.sweep_plan(kernel, nb, width, dtype)
            R, G = plan.rows, plan.ctas
            rows = [range(g * R, min((g + 1) * R, width)) for g in range(G)]
            assert [r for rg in rows for r in rg] == list(range(width))
            assert all(len(rg) >= 1 for rg in rows)
            assert 1 <= G <= bt_sweeps.H100_SMS
            assert plan.smem <= bt_sweeps.SMEM_LIMIT == 232_448
            steps = nb if kernel == "K1" else nb - 1
            assert 1 <= plan.stages <= min(bt_sweeps.MAX_STAGES,
                                           max(steps, 1))
            for g, rg in enumerate(rows):
                for i in (0, nb - 1):
                    offset = ((i * width + rg.start) * width) * elem
                    assert offset % 16 == 0
                assert len(rg) * width * elem % 16 == 0


def test_sweep_plan_refuses_a_stage_too_wide():
    # one K1 stage of 11 rows of Sinv and L at B=1344 in f64 is 236,544 B
    with pytest.raises(ValueError, match="too wide"):
        bt_sweeps.sweep_plan("K1", 4, 1344, torch.float64)
    bt_sweeps.sweep_plan("K2", 4, 1344, torch.float64)  # half the stage


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_outputs_start_as_the_not_written_mark(dtype):
    """The wrapper's fill is the NaN bit pattern the kernels poll for."""
    itype, bits = bt_sweeps._EMPTY[dtype]
    out = bt_sweeps._empty((2, 3, 32), torch.zeros(1, dtype=dtype))
    assert out.dtype == dtype and out.shape == (2, 3, 32)
    assert bool(torch.isnan(out).all())
    assert bool((out.view(itype) == bits).all())
    want = {torch.float32: 0xFFBA5A5A, torch.float64: 0xFFF7A5A55A5AA5A5}
    width = 8 * out.element_size()
    assert bits % (1 << width) == want[dtype]

