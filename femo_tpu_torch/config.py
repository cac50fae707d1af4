"""Working precision of the port.

f64 is the default: the motor step's IFT gradient is held to 1e-8 against
the JAX package, and the H100 runs f64 natively.  Every constructor in the
port takes its dtype from `config.dtype` (and an explicit device), never
from torch's global default, which is float32.

`set_precision` applies the whole policy on every call instead of relying
on state set at import time.  For float32 it keeps every matmul at full
float32: a float32 product on the card may otherwise run in TF32 (about
three decimal digits), the CUDA counterpart of the TPU's one-pass bf16
matmuls that cost the JAX package's f32 motor gradient two orders of
magnitude.
"""

from __future__ import annotations

import torch


class Config:
    """Module-level precision registry (read by every constructor)."""

    def __init__(self) -> None:
        self.dtype = torch.float64


config = Config()


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
