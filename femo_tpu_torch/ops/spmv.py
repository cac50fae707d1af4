"""Sparse matrix-vector products of the assembled FE operator: the CUDA
kernels K3/K4/K5 and their plain PyTorch versions (port of
experiments/pallas_spmv.py).

* K4, element SpMV: `y = segment_sum(A_e @ x[cols_e], rows_e)`, and its
  transpose K4T, `x = segment_sum(A_e^T @ y[rows_e], cols_e)`.  This is
  `ElementMatrix.matvec/rmatvec` (fea/assemble.py), so every Krylov
  iteration of a LinearSolver runs it.  The kernel is row-owner: an
  `ElementSpMVPlan`, built once per element pattern and kept with the
  compiled form's term, maps every output row to its (element, local
  row) slots; one thread sums one row in a fixed order, without atomics.
* K3, ELL SpMV `y_i = sum_k vals[i,k] x[cols[i,k]]`, on an ELL packing
  of the matrix (`ell_from_element_matrix`, `ELLOperator`).
* K5, banded SpMV `y_i = sum_d band[i,d] x[i+d-b]`, on the RCM-reordered
  band (`banded_from_element_matrix`).  The kernel reads a
  `BandedSpMVPlan`, built once per band on its device: per tile of 32
  rows, only the diagonal segments that hold a nonzero.  The plain
  version reads the dense band.  The one difference: where a zero of the
  band meets an inf or NaN of x, the dense product (and the TPU kernel)
  gives NaN, and K5 does not when it skips that zero's segment; for finite
  x the two are the same product.

`femo_tpu_torch/csrc/spmv.cu` holds the kernels and a note on each one's
design and bound.  They are built with nvcc for sm_90a at first use into
`femo_tpu_torch/_build/`, never at import.

Dispatch is by device only: CUDA tensors launch the kernels (and raise
if the build or the launch fails), CPU tensors take the plain versions.
`launches` counts each kernel's launches: the `*_cuda` function of a
kernel adds one to its entry after its launch returned without error,
and nothing else touches them.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

from ..native import build_shared
from .bt_sweeps import NVCC_FLAGS, _nvcc
from .scatter import owner_csr

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "spmv.cu")

launches = {"K3": 0, "K4": 0, "K4T": 0, "K5": 0}  # successful launches
build_log = ""  # nvcc/ptxas output of the build this process made

_lib = None
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_I32_MAX = 2**31 - 1


def get_lib():
    """Build (first use, or when the source changed) and load the kernels."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    so, build_log = build_shared([_nvcc()] + NVCC_FLAGS, SRC, "libspmv")
    lib = ctypes.CDLL(so)
    p, i = ctypes.c_void_p, ctypes.c_int
    for dt in _SUFFIX.values():
        fn = getattr(lib, f"element_spmv_{dt}")
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, p]
        fn.restype = i
        fn = getattr(lib, f"ell_spmv_{dt}")
        fn.argtypes = [p, p, p, p, i, i, p]
        fn.restype = i
        fn = getattr(lib, f"banded_spmv_{dt}")
        fn.argtypes = [p, p, p, p, p, i, i, p]
        fn.restype = i
    lib.spmv_error_string.argtypes = [i]
    lib.spmv_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def _check_cuda(ref, floats=(), ints=()):
    """Raise unless every tensor is a contiguous CUDA tensor on ref's
    device, the floats share ref's dtype (float32 or float64) and the
    index tensors are int32."""
    if ref.device.type != "cuda":
        raise ValueError(f"the SpMV kernels take CUDA tensors, got "
                         f"{ref.device}")
    if ref.dtype not in _SUFFIX:
        raise ValueError(f"dtype {ref.dtype}: the SpMV kernels take "
                         "float32 or float64")
    for name, t, want in ([(n, t, ref.dtype) for n, t in floats]
                          + [(n, t, torch.int32) for n, t in ints]):
        if t.device != ref.device:
            raise ValueError(f"{name} on {t.device}, not {ref.device}")
        if t.dtype != want:
            raise ValueError(f"{name} dtype {t.dtype}, want {want}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _launch(kernel: str, fn_name: str, dtype, *args):
    lib = get_lib()
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(lib, f"{fn_name}_{_SUFFIX[dtype]}")(*args, stream)
    if err:
        msg = lib.spmv_error_string(err).decode()
        raise RuntimeError(f"{fn_name} ({kernel}) launch failed: {msg} "
                           f"({err})")
    launches[kernel] += 1


# ---------------------------------------------------------------------------
# K4: element SpMV (ElementMatrix.matvec / rmatvec)
# ---------------------------------------------------------------------------


def _owner_map(ids: np.ndarray, n: int, device):
    """CSR of the element slots (e * k + j of ids (ne, k)) owned by each
    of n output rows, in increasing slot (element) order: (ptr (n+1,),
    slot (ne*k,)) int32 on device (the assembly's owner tables,
    ops/scatter.py, come from the same `owner_csr`)."""
    if ids.size > _I32_MAX or n > _I32_MAX:
        raise ValueError("element pattern too large for int32 slot maps")
    ptr, slot = owner_csr(ids, n)
    return (torch.as_tensor(ptr.astype(np.int32), device=device),
            torch.as_tensor(slot.astype(np.int32), device=device))


class ElementSpMVPlan:
    """K4/K4T's row-owner maps of one element block pattern (rows (ne,
    nr), cols (ne, nc)) for an (n_rows, n_cols) matrix.

    Constructing a plan does no work; `maps()` builds, at first use and
    once, the int32 copies of rows and cols and, for each output side,
    the CSR of the (element, local row|column) slots it owns, on the
    pattern's device."""

    def __init__(self, rows, cols, n_rows: int, n_cols: int):
        self.rows, self.cols = rows, cols
        self.n_rows, self.n_cols = int(n_rows), int(n_cols)
        self._maps = None

    def maps(self) -> dict:
        if self._maps is None:
            dev = self.rows.device
            rows = self.rows.cpu().numpy().astype(np.int64)
            cols = self.cols.cpu().numpy().astype(np.int64)
            row_ptr, row_slot = _owner_map(rows, self.n_rows, dev)
            col_ptr, col_slot = _owner_map(cols, self.n_cols, dev)
            self._maps = dict(
                rows=torch.as_tensor(rows.astype(np.int32), device=dev),
                cols=torch.as_tensor(cols.astype(np.int32), device=dev),
                row_ptr=row_ptr, row_slot=row_slot,
                col_ptr=col_ptr, col_slot=col_slot)
        return self._maps


def element_spmv_plain(A, rows, cols, x, n_rows: int):
    """K4's plain version: gather, per-element product, index_add (the
    JAX package's ElementMatrix.matvec, femo_tpu/fea/assemble.py:860)."""
    ye = torch.einsum("eij,ej->ei", A, x[cols])
    return torch.zeros(n_rows, dtype=x.dtype, device=x.device).index_add_(
        0, rows.reshape(-1), ye.reshape(-1))


def element_rspmv_plain(A, rows, cols, y, n_cols: int):
    """K4T's plain version: the transpose product A^T y."""
    xe = torch.einsum("eij,ei->ej", A, y[rows])
    return torch.zeros(n_cols, dtype=y.dtype, device=y.device).index_add_(
        0, cols.reshape(-1), xe.reshape(-1))


def _element_cuda(kernel, A, plan, v, out, transpose):
    m = plan.maps()
    ne, nr, nc = A.shape
    n_in, n_out = ((plan.n_rows, plan.n_cols) if transpose
                   else (plan.n_cols, plan.n_rows))
    if tuple(m["rows"].shape) != (ne, nr) or \
            tuple(m["cols"].shape) != (ne, nc):
        raise ValueError(f"A_e {tuple(A.shape)} does not match the plan's "
                         f"pattern rows {tuple(m['rows'].shape)}, cols "
                         f"{tuple(m['cols'].shape)}")
    if tuple(v.shape) != (n_in,):
        raise ValueError(f"vector shape {tuple(v.shape)}, want ({n_in},)")
    ptr, slot, idx = ((m["col_ptr"], m["col_slot"], m["rows"]) if transpose
                      else (m["row_ptr"], m["row_slot"], m["cols"]))
    accumulate = out is not None
    if out is None:
        out = torch.empty(n_out, dtype=v.dtype, device=v.device)
    _check_cuda(v, floats=[("A_e", A), ("out", out)],
                ints=[("ptr", ptr), ("slot", slot), ("idx", idx)])
    if tuple(out.shape) != (n_out,):
        raise ValueError(f"out shape {tuple(out.shape)}, want ({n_out},)")
    with torch.cuda.device(v.device):
        _launch(kernel, "element_spmv", v.dtype, A.data_ptr(),
                ptr.data_ptr(), slot.data_ptr(), idx.data_ptr(),
                v.data_ptr(), out.data_ptr(), n_out, nr, nc,
                int(transpose), int(accumulate))
    return out


def element_spmv_cuda(A, plan: ElementSpMVPlan, x, out=None):
    """Launch K4 on CUDA tensors: A_e @ x scattered to the rows ((n_rows,)),
    added into `out` when it is given."""
    return _element_cuda("K4", A, plan, x, out, transpose=False)


def element_rspmv_cuda(A, plan: ElementSpMVPlan, y, out=None):
    """Launch K4T on CUDA tensors: A_e^T @ y scattered to the columns
    ((n_cols,)), added into `out` when it is given."""
    return _element_cuda("K4T", A, plan, y, out, transpose=True)


def element_matvec(blocks, x, shape, transpose: bool = False):
    """Sum over the element blocks of the matrix (transpose=False) or
    transpose (True) product.  blocks: objects with A, rows, cols and a
    `plan` (ElementSpMVPlan); shape (n_rows, n_cols).  CUDA tensors run
    K4/K4T, one launch per block (A contiguous, as CompiledForm.matrix
    makes it); CPU tensors the plain versions."""
    n_rows, n_cols = shape
    if x.device.type == "cpu":
        if transpose:
            return sum(element_rspmv_plain(b.A, b.rows, b.cols, x, n_cols)
                       for b in blocks)
        return sum(element_spmv_plain(b.A, b.rows, b.cols, x, n_rows)
                   for b in blocks)
    x = x.contiguous()
    out = None
    for b in blocks:
        if transpose:
            out = element_rspmv_cuda(b.A, b.plan, x, out)
        else:
            out = element_spmv_cuda(b.A, b.plan, x, out)
    return out


# ---------------------------------------------------------------------------
# K3: ELL SpMV
# ---------------------------------------------------------------------------


def ell_from_element_matrix(emat):
    """Padded ELL arrays (vals (n, k) in the matrix's dtype, cols (n, k)
    int32) of an ElementMatrix, k = the most nonzeros in a row, on the
    matrix's device; built once on the host (scipy CSR)."""
    A = emat.to_scipy_csr()
    n = A.shape[0]
    counts = np.diff(A.indptr)
    k = int(counts.max())
    r = np.repeat(np.arange(n), counts)
    pos = np.arange(A.nnz) - A.indptr[r]
    vals = np.zeros((n, k), A.data.dtype)
    cols = np.zeros((n, k), np.int32)
    vals[r, pos] = A.data
    cols[r, pos] = A.indices
    dev = emat.blocks[0].A.device
    return (torch.as_tensor(vals, device=dev),
            torch.as_tensor(cols, device=dev))


def ell_spmv_plain(vals, cols, x):
    """K3's plain version: y_i = sum_k vals[i,k] x[cols[i,k]]."""
    return torch.sum(vals * x[cols.long()], dim=1)


def ell_spmv_cuda(vals, cols, x):
    """Launch K3 on CUDA tensors."""
    n, k = vals.shape
    if tuple(cols.shape) != (n, k) or x.ndim != 1:
        raise ValueError(f"vals {tuple(vals.shape)}, cols "
                         f"{tuple(cols.shape)}, x {tuple(x.shape)}")
    y = torch.empty(n, dtype=x.dtype, device=x.device)
    _check_cuda(x, floats=[("vals", vals)], ints=[("cols", cols)])
    with torch.cuda.device(x.device):
        _launch("K3", "ell_spmv", x.dtype, vals.data_ptr(), cols.data_ptr(),
                x.data_ptr(), y.data_ptr(), n, k)
    return y


def ell_spmv(vals, cols, x):
    """ELL SpMV: K3 on CUDA tensors, the plain version on CPU tensors."""
    if x.device.type == "cpu":
        return ell_spmv_plain(vals, cols, x)
    return ell_spmv_cuda(vals, cols, x.contiguous())


class ELLOperator:
    """Matvec of an ElementMatrix through its ELL packing, made once (the
    counterpart of experiments/pallas_spmv.py::PallasELLOperator)."""

    def __init__(self, emat):
        self.vals, self.cols = ell_from_element_matrix(emat)
        self.shape = emat.shape

    def matvec(self, x):
        return ell_spmv(self.vals, self.cols, x)


# ---------------------------------------------------------------------------
# K5: banded SpMV in RCM order
# ---------------------------------------------------------------------------


def banded_from_element_matrix(emat, free=None):
    """(band (n, 2b+1) on the matrix's device, bandwidth b, perm) of an
    ElementMatrix after RCM reordering (the JAX package's native RCM
    order); with `free`, the BC-constrained operator P A P + (I - P)."""
    import scipy.sparse as sp

    from .. import native

    A = emat.to_scipy_csr()
    n = A.shape[0]
    if free is not None:
        fr = np.asarray(free)
        P = sp.diags(fr.astype(A.dtype))
        A = (P @ A @ P + sp.diags((~fr).astype(A.dtype))).tocsr()
    perm = native.rcm_order(A.indptr.astype(np.int64),
                            A.indices.astype(np.int32))
    Ap = A[perm][:, perm].tocoo()
    b = int(np.abs(Ap.row - Ap.col).max()) if Ap.nnz else 1
    band = np.zeros((n, 2 * b + 1), Ap.data.dtype)
    band[Ap.row, Ap.col - Ap.row + b] = Ap.data
    return (torch.as_tensor(band, device=emat.blocks[0].A.device), b,
            np.asarray(perm))


def banded_spmv_plain(band, x, bandwidth: int):
    """K5's plain version: y_i = sum_d band[i,d] x[i+d-b] (x zero outside
    [0, n)), through a strided window view of the padded x."""
    b = int(bandwidth)
    xp = torch.nn.functional.pad(x, (b, b))
    return torch.sum(band * xp.unfold(0, 2 * b + 1, 1), dim=1)


TILE = 32  # K5 rows per tile, one warp (kTile in csrc/spmv.cu)


class BandedSpMVPlan:
    """K5's layout of one band (n, 2b+1) in one dtype: the rows cut into
    tiles of TILE, and per tile only the diagonals d whose TILE values are
    not all zero, in increasing d.  Built with torch ops on the band's
    device (one host sync, for the segment count): tile_ptr (n_tiles + 1,)
    int32, diag (segments,) int32 and vals (segments, TILE) in the band's
    dtype, one segment's values contiguous (rows past n are zero)."""

    def __init__(self, band, bandwidth: int):
        n, nd = band.shape
        b = int(bandwidth)
        if nd != 2 * b + 1:
            raise ValueError(f"band {tuple(band.shape)} does not have 2b+1 "
                             f"columns for bandwidth {b}")
        if n + b + TILE > _I32_MAX:
            raise ValueError("band too large for int32 row indices")
        self.bandwidth, self.n = b, n
        self.n_tiles = -(-n // TILE)
        dev = band.device
        nz = torch.zeros((self.n_tiles * TILE, nd), dtype=torch.bool,
                         device=dev)
        nz[:n] = band != 0
        # row-major order: tiles in turn, d increasing within a tile
        tile, d = torch.nonzero(nz.view(self.n_tiles, TILE, nd).any(1),
                                as_tuple=True)
        if tile.numel() > _I32_MAX:
            raise ValueError("too many band segments for int32")
        rows = tile[:, None] * TILE + torch.arange(TILE, device=dev)
        self.vals = torch.where(
            rows < n, band[rows.clamp(max=n - 1), d[:, None]],
            torch.zeros((), dtype=band.dtype, device=dev)).contiguous()
        ptr = torch.zeros(self.n_tiles + 1, dtype=torch.int64, device=dev)
        torch.cumsum(torch.bincount(tile, minlength=self.n_tiles), 0,
                     out=ptr[1:])
        self.tile_ptr, self.diag = ptr.to(torch.int32), d.to(torch.int32)


def banded_spmv_cuda(plan: BandedSpMVPlan, x):
    """Launch K5 on CUDA tensors: the banded product from the plan's
    segments (the plan in x's dtype, on x's device)."""
    if tuple(x.shape) != (plan.n,):
        raise ValueError(f"x {tuple(x.shape)}, want ({plan.n},)")
    _check_cuda(x, floats=[("vals", plan.vals)],
                ints=[("tile_ptr", plan.tile_ptr), ("diag", plan.diag)])
    y = torch.empty(plan.n, dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        _launch("K5", "banded_spmv", x.dtype, plan.tile_ptr.data_ptr(),
                plan.diag.data_ptr(), plan.vals.data_ptr(), x.data_ptr(),
                y.data_ptr(), plan.n, plan.bandwidth)
    return y


def banded_spmv(band, x, bandwidth: int):
    """Banded SpMV (band and x in the same RCM order): K5 on CUDA tensors,
    the plain version (the dense band) on CPU tensors.  On CUDA tensors it
    builds a plan first, which reads the whole band once and syncs the
    host once: a caller that multiplies one band more than once keeps a
    `BandedSpMVPlan` and calls `banded_spmv_cuda(plan, x)`."""
    if x.device.type == "cpu":
        return banded_spmv_plain(band, x, bandwidth)
    return banded_spmv_cuda(BandedSpMVPlan(band, bandwidth), x.contiguous())
