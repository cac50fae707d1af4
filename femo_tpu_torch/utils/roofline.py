"""Roofline accounting for measured stages (port of
femo_tpu/utils/roofline.py).

Answers, per measured stage, how far it is from the card's limits and
which limit binds:

* ``compute``    - time ~ flops / peak: a faster stage needs fewer flops.
* ``memory``     - time ~ bytes / memory rate: fuse, shrink the working set
                   or lower the storage precision.
* ``dependency`` - time >> both ideals and the stage is a sequential
                   recursion (the block-Thomas sweeps): only a shallower
                   algorithm helps.
* ``latency``    - time >> both ideals with no stated critical path:
                   launch or host bound.

The card's figures are NVIDIA's published ones (H100 SXM data sheet,
dense rates, the full 700 W power limit); `chip_smoke.py`'s bounds read
them from `CHIP_SPECS`.  Flops come from analytic models
(`bt_factor_cost`, `bt_sweep_cost`) or from torch's flop counter
(`compiled_cost`).

Departures: the specs key CUDA device names, and an entry carries one
peak per dtype (`peak_flops_by_dtype`); `chip_spec` returns the entry
with `peak_flops` set to the peak of the working dtype, where the JAX
package keys TPU kinds and reports against the bf16 MXU peak.
`compiled_cost` counts flops with `torch.utils.flop_counter`, since torch
has no XLA cost model, and returns no bytes.
"""

from __future__ import annotations

import torch

from ..config import config

# Keyed by a substring of torch.cuda.get_device_name.  H100 SXM: 3.35 TB/s
# HBM3, 80 GB, and outside the tensor cores 34 TFLOP/s in f64 and 67
# TFLOP/s in f32 (NVIDIA's data sheet).
CHIP_SPECS = {
    "H100 80GB HBM3": dict(chip="NVIDIA H100 SXM", hbm_bw=3.35e12,
                           hbm_bytes=80e9,
                           peak_flops_by_dtype={"float64": 34e12,
                                                "float32": 67e12}),
}


def chip_spec(device=None, dtype=None):
    """The spec dict of a CUDA device (default: the current card), with
    `peak_flops` its peak for `dtype` (default: the working dtype,
    `config.dtype`); None on the CPU, without a card, on an unknown card
    or for a dtype it has no published peak for: callers skip the
    roofline fields rather than invent a peak."""
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device)
    key = str(dtype or config.dtype).replace("torch.", "")
    for sub, spec in CHIP_SPECS.items():
        if sub in name and key in spec["peak_flops_by_dtype"]:
            return dict(spec, peak_flops_by_dtype=dict(
                spec["peak_flops_by_dtype"]),
                peak_flops=spec["peak_flops_by_dtype"][key])
    return None


def compiled_cost(fn, *args):
    """(flops, None): the floating-point operations of fn(*args) as
    `torch.utils.flop_counter.FlopCounterMode` counts them (matmuls,
    convolutions and attention, 2 m n k for a matmul; elementwise work is
    not counted), from one call of fn.  torch has no cost model of bytes
    moved, so the second value is always None, where the JAX package
    reads both from XLA's cost analysis.  (None, None) when fn raises."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    try:
        with counter:
            fn(*args)
    except Exception:
        return None, None
    return counter.get_total_flops(), None


def bt_factor_cost(nb, B, spd=True, op_bytes=8, store_bytes=4):
    """Analytic flops/bytes for the block-Thomas factor recursion, per
    full factorization.

    Per block (SPD/Cholesky path): S = D - L@C_prev (2B^3), chol(S)
    (B^3/3), triangular solve to L^-1 (B^3), Linv^T@Linv (2B^3),
    C = Sinv@U (2B^3)  ->  ~22/3 B^3.  QR path (f64-general): ~10 B^3.
    Bytes: read D,L,U (3 B^2 op_bytes) + write Sinv,C (2 B^2 store_bytes)
    + carry traffic C (2 B^2 op_bytes r/w).
    Critical path: nb sequential steps.
    """
    per_block = (22.0 / 3.0 if spd else 10.0) * B ** 3
    bytes_per_block = B * B * (3 * op_bytes + 2 * store_bytes + 2 * op_bytes)
    return dict(flops=nb * per_block, bytes=nb * bytes_per_block,
                critical_steps=nb)


def bt_sweep_cost(nb, B, nrhs=1, store_bytes=4, n_sweeps=2):
    """Analytic flops/bytes for the forward+backward triangular sweeps
    (one preconditioner application, nrhs right-hand sides).

    Per block per sweep: one (B,B)@(B,nrhs) gemm pair - forward reads
    L_i and Sinv_i (4 B^2 nrhs flops), backward reads C_i (2 B^2 nrhs).
    Bytes dominated by streaming the factor blocks once per sweep.
    Critical path: n_sweeps * nb sequential steps.
    """
    flops = nb * (4 + 2 * (n_sweeps - 1)) * B * B * nrhs
    bytes_ = nb * 3 * B * B * store_bytes  # Sinv + C + L streamed once
    return dict(flops=flops, bytes=bytes_, critical_steps=n_sweeps * nb)


def roofline(time_s, flops, bytes_accessed, spec=None, critical_steps=None):
    """Classify a measured stage against the card's roofline.

    Returns a JSON-ready dict (or None when no spec / no counts): mfu
    (against spec["peak_flops"]), bandwidth_util, the two ideal times,
    and the binding constraint.
    """
    if spec is None:
        spec = chip_spec()
    if spec is None or not time_s or flops is None or bytes_accessed is None:
        return None
    t_comp = flops / spec["peak_flops"]
    t_mem = bytes_accessed / spec["hbm_bw"]
    ideal = max(t_comp, t_mem)
    if time_s > 3.0 * ideal:
        bound = "dependency" if critical_steps else "latency"
    elif t_comp >= t_mem:
        bound = "compute"
    else:
        bound = "memory"
    out = dict(
        chip=spec["chip"],
        flops=float(flops),
        bytes=float(bytes_accessed),
        mfu=round(flops / time_s / spec["peak_flops"], 6),
        bandwidth_util=round(bytes_accessed / time_s / spec["hbm_bw"], 6),
        t_compute_ideal_s=round(t_comp, 6),
        t_memory_ideal_s=round(t_mem, 6),
        bound=bound,
    )
    if critical_steps:
        out["critical_steps"] = int(critical_steps)
        out["per_step_us"] = round(time_s / critical_steps * 1e6, 3)
    return out
