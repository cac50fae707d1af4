"""Working precision, device and solver defaults of the port.

f64 is the default: the motor step's IFT gradient is held to 1e-8 against
the JAX package, and the H100 runs f64 natively.  Every constructor in the
port takes its dtype from `config.dtype`, never from torch's global
default, which is float32.

The port runs on the card: every entry point that takes a `device` reads
its default from `config.device` ("cuda") through `get_device`, which
raises when there is no card rather than carrying on on the CPU.  CPU
runs (the parity tests) pass `device="cpu"` explicitly.

`set_precision` applies the whole policy on every call instead of relying
on state set at import time.  For float32 it keeps every matmul at full
float32: a float32 product on the card may otherwise run in TF32 (about
three decimal digits), the CUDA counterpart of the TPU's one-pass bf16
matmuls that cost the JAX package's f32 motor gradient two orders of
magnitude.

The solver defaults are the JAX package's (femo_tpu/config.py), copied
because importing that module imports jax.
"""

from __future__ import annotations

import os

import torch


class Config:
    """Module-level registry of the port's defaults (read by every
    constructor)."""

    def __init__(self) -> None:
        self.dtype = torch.float64
        self.device = "cuda"
        # dense-direct solver threshold (n_dofs); above it, Krylov is used
        self.dense_direct_max_dofs = int(
            os.environ.get("FEMO_TPU_DENSE_DIRECT_MAX", "4096"))
        # Krylov and Newton tolerances (the reference's SNES settings)
        self.krylov_rtol = 1e-12
        self.krylov_atol = 1e-14
        self.krylov_maxiter = 10000
        self.newton_rtol = 1e-12
        self.newton_atol = 1e-13
        self.newton_maxiter = 100
        self.report = False


config = Config()


def get_device(device=None) -> torch.device:
    """`device`, or the port's default `config.device` when it is None.
    Raises if the result is a CUDA device and there is no card."""
    dev = torch.device(config.device if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev}: no CUDA device is available.  The port runs "
            "on the card by default; pass device='cpu' to run on the CPU")
    return dev


def set_precision(dtype) -> None:
    """Set the working dtype ("float32"/"float64" or a torch dtype) and
    the matmul policy that goes with it.  Applied anew on every call."""
    dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    if dt not in (torch.float32, torch.float64):
        raise ValueError(f"unsupported working dtype {dtype!r}")
    config.dtype = dt
    # full-precision float32 products whatever the working dtype: f64 runs
    # never take TF32, and f32 runs must not
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
