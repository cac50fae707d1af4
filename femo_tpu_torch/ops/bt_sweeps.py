"""Block-Thomas triangular sweeps: the CUDA kernels K1/K2 and their plain
PyTorch version.

The solve phase of the block-tridiagonal factorization
(`BlockThomasFactor.solve`) is two length-nb sequential recurrences of
(B,B)@(B,) matvecs:

    K1 (forward):  z_i = Sinv_i (b_i - L_i z_{i-1}),  z_{-1} = 0
    K2 (backward): x_i = z_i - C_i x_{i+1},           x_nb = 0

`femo_tpu_torch/csrc/bt_sweeps.cu` implements them for Hopper, replacing
the Pallas TPU kernels `femo_tpu/ops/pallas_bt.py::_fwd_kernel` and
`::_bwd_kernel`.  Each sweep is one cooperative launch of G CTAs, each
owning R rows of every block: the CTAs stream their row slabs through a
ring of S shared-memory stages (bulk copies, ahead of the recurrence) and
pass the length-B carry to each other through the output itself, which the
wrapper fills with a "not yet written" NaN pattern (`_EMPTY`) before the
launch.  `sweep_plan` computes (R, G, S) and the shared memory; the source
note in the .cu file says why the design looks as it does.

The sweeps run in the working dtype (float32 or float64).  The Pallas
kernels were f32 only because Mosaic has no f64, which is why the JAX
package refuses `sweeps="pallas"` in f64 without a PCG polish
(femo_tpu/graph/implicit.py:382-389, femo_tpu/models/fsi.py:695-701); the
port's f64 sweeps need no such guard.

Dispatch is by device only: CUDA tensors launch the kernels (and raise if
the build or the launch fails), CPU tensors run `bt_sweep_solve_plain`.
`launches` counts each kernel's launches: `fwd_sweep_cuda` adds one to
"K1" and `bwd_sweep_cuda` one to "K2", each after its launch returned
without error, and nothing else touches them.
"""

from __future__ import annotations

import ctypes
import functools
import os
from dataclasses import dataclass

import torch

from ..native import build_shared

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "bt_sweeps.cu")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

launches = {"K1": 0, "K2": 0}  # successful kernel launches
build_log = ""  # nvcc/ptxas output of the build this process made

_lib = None
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
# the kernels' "not yet written" mark (kEmpty in bt_sweeps.cu): a NaN bit
# pattern that no sweep stores, as the signed integer of the same width
_EMPTY = {torch.float32: (torch.int32, 0xFFBA5A5A - (1 << 32)),
          torch.float64: (torch.int64, 0xFFF7A5A55A5AA5A5 - (1 << 64))}

# geometry limits of bt_sweeps.cu (kMaxStages, kBarrierBytes) and of sm_90
# (the shared memory one block may use)
MAX_STAGES = 4
_BARRIER_BYTES = 128
SMEM_LIMIT = 232_448
H100_SMS = 132
MIN_ROWS = 4


@dataclass(frozen=True)
class SweepPlan:
    """Launch geometry of one sweep kernel: G CTAs, CTA g owning rows
    [g R, min((g + 1) R, B)) of every block, S stages of row slabs each,
    `smem` bytes of dynamic shared memory a CTA."""
    rows: int  # R
    ctas: int  # G
    stages: int  # S
    smem: int


def sweep_plan(kernel: str, nb: int, B: int, dtype,
               sms: int = H100_SMS) -> SweepPlan:
    """Geometry of K1 ("K1") or K2 ("K2") for nb blocks of width B on a
    card with `sms` SMs.  R = max(MIN_ROWS, ceil(B / sms)) rows per CTA,
    so the G = ceil(B / R) CTAs fit one to an SM; at least MIN_ROWS (one
    per computing warp, half the CTA's warps) because every CTA polls the
    whole carry each phase, and fewer, larger CTAs poll less.  As many ring
    stages (up to MAX_STAGES, and no more than the chain has steps with
    blocks) as the shared memory holds.  Raises ValueError when one stage
    does not fit."""
    if kernel not in ("K1", "K2"):
        raise ValueError(f"kernel {kernel!r}: 'K1' or 'K2'")
    elem = torch.empty((), dtype=dtype).element_size()
    R = max(MIN_ROWS, -(-B // sms))
    G = -(-B // R)
    blocks, steps = (2, nb) if kernel == "K1" else (1, nb - 1)
    # bt_sweeps.cu::smem_bytes: mbarriers, two carries, two (R,) row
    # buffers, the ring
    fixed = _BARRIER_BYTES + (2 * B + 2 * R) * elem
    stage = blocks * R * B * elem
    S = min(MAX_STAGES, max(steps, 1), (SMEM_LIMIT - fixed) // stage)
    if S < 1:
        raise ValueError(f"B={B} is too wide for the sweep kernels: one "
                         f"stage of {stage} bytes does not fit the "
                         f"{SMEM_LIMIT}-byte shared memory of a CTA")
    return SweepPlan(R, G, S, fixed + S * stage)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found at {path} (set CUDA_HOME)")
    return path


def get_lib():
    """Build (first use, or when the source changed) and load the kernels."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    so, build_log = build_shared([_nvcc()] + NVCC_FLAGS, SRC,
                                 "libbt_sweeps")
    lib = ctypes.CDLL(so)
    p, i = ctypes.c_void_p, ctypes.c_int
    for dt in _SUFFIX.values():
        fwd = getattr(lib, f"bt_fwd_sweep_{dt}")
        fwd.argtypes = [p, p, p, p, p, i, i, i, i, p]
        fwd.restype = i
        bwd = getattr(lib, f"bt_bwd_sweep_{dt}")
        bwd.argtypes = [p, p, p, i, i, i, i, p]
        bwd.restype = i
    lib.bt_error_string.argtypes = [i]
    lib.bt_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def _check(bb, **blocks):
    """Raise unless bb (nb, B) and the (nb, B, B) blocks share one device
    and one float dtype, are contiguous, and B is a multiple of 32."""
    nb, B = bb.shape
    items = [("b", bb, (nb, B))] + [(k, t, (nb, B, B))
                                    for k, t in blocks.items()]
    for name, t, shape in items:
        if t.device != bb.device:
            raise ValueError(f"{name} on {t.device}, b on {bb.device}")
        if t.dtype != bb.dtype or t.dtype not in _SUFFIX:
            raise ValueError(f"{name} dtype {t.dtype}: the sweeps take "
                             "float32 or float64, all alike")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} shape {tuple(t.shape)}, want {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if nb < 1 or B % 32:
        raise ValueError(f"sweeps need nb >= 1 and B a multiple of 32, "
                         f"got nb={nb}, B={B}")


def _check_cuda(bb, **blocks):
    """_check, on CUDA tensors whose data is 16-byte aligned (the bulk
    copies' requirement)."""
    _check(bb, **blocks)
    if bb.device.type != "cuda":
        raise ValueError(f"the sweep kernels take CUDA tensors, got "
                         f"{bb.device}")
    for name, t in [("b", bb)] + list(blocks.items()):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} data must be 16-byte aligned")


def _empty(shape, like):
    """A tensor of `shape` on like's device and dtype, every element the
    kernels' "not yet written" mark."""
    itype, bits = _EMPTY[like.dtype]
    return torch.full(shape, bits, dtype=itype,
                      device=like.device).view(like.dtype)


def _raise_on(err: int, what: str):
    if err:
        msg = _lib.bt_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: {msg} ({err})")


def fwd_sweep_cuda(Sinv, L, bb):
    """Launch K1 alone on CUDA tensors: z (nb, B)."""
    _check_cuda(bb, Sinv=Sinv, L=L)
    lib = get_lib()
    nb, B = bb.shape
    plan = sweep_plan("K1", nb, B, bb.dtype, _sms(bb.device.index))
    z, t = _empty((2, nb, B), bb)  # the output and the scratch t_i
    with torch.cuda.device(bb.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, f"bt_fwd_sweep_{_SUFFIX[bb.dtype]}")(
            Sinv.data_ptr(), L.data_ptr(), bb.data_ptr(), t.data_ptr(),
            z.data_ptr(), nb, B, plan.rows, plan.stages, stream)
    _raise_on(err, "bt_fwd_sweep")
    launches["K1"] += 1
    return z


def bwd_sweep_cuda(C, z):
    """Launch K2 alone on CUDA tensors: x (nb, B)."""
    _check_cuda(z, C=C)
    lib = get_lib()
    nb, B = z.shape
    plan = sweep_plan("K2", nb, B, z.dtype, _sms(z.device.index))
    x = _empty((nb, B), z)
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, f"bt_bwd_sweep_{_SUFFIX[z.dtype]}")(
            C.data_ptr(), z.data_ptr(), x.data_ptr(), nb, B, plan.rows,
            plan.stages, stream)
    _raise_on(err, "bt_bwd_sweep")
    launches["K2"] += 1
    return x


def fwd_sweep_plain(Sinv, L, bb):
    """K1's plain version: a Python loop of matvecs over nb."""
    z = []
    z_prev = torch.zeros_like(bb[0])
    for i in range(bb.shape[0]):
        z_prev = Sinv[i] @ (bb[i] - L[i] @ z_prev)
        z.append(z_prev)
    return torch.stack(z)


def bwd_sweep_plain(C, z):
    """K2's plain version: a reversed Python loop of matvecs over nb."""
    nb = z.shape[0]
    x = [None] * nb
    x_next = torch.zeros_like(z[0])
    for i in range(nb - 1, -1, -1):
        x_next = z[i] - C[i] @ x_next
        x[i] = x_next
    return torch.stack(x)


def bt_sweep_solve_plain(Sinv, L, C, bb):
    """Both sweeps in plain PyTorch (the CPU path and the kernels' oracle)."""
    return bwd_sweep_plain(C, fwd_sweep_plain(Sinv, L, bb))


def bt_sweep_solve(Sinv, L, C, bb):
    """Both triangular sweeps.

    Sinv, L, C: (nb, B, B); bb: (nb, B) (RCM-block layout), one dtype
    (float32 or float64), contiguous.  Returns x (nb, B).  CUDA tensors
    run the CUDA kernels K1 then K2; CPU tensors run the plain version.
    """
    _check(bb, Sinv=Sinv, L=L, C=C)
    if bb.device.type == "cpu":
        return bt_sweep_solve_plain(Sinv, L, C, bb)
    return bwd_sweep_cuda(C, fwd_sweep_cuda(Sinv, L, bb))
