"""ctypes bindings to the C++ host helpers (RCB partition, RCM order, CSR
pattern, block-tridiagonal destination map).

Builds femo_tpu_torch/csrc/femo_native.cpp, a byte-for-byte copy of the
JAX package's femo_tpu/native/femo_native.cpp (a test keeps the two
alike), with `g++ -O3 -shared -fPIC` into the port's build directory at
first use, and binds the helpers the block-tridiagonal template and the
distributed layouts (`parallel/`) need.  The shared source is what makes
the RCM order, and with it the whole block layout, and the RCB partition,
and with it every rank's cells and dofs, identical in both packages, so
there is deliberately no numpy fallback: a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_HERE, "csrc", "femo_native.cpp")
BUILD_DIR = os.path.join(_HERE, "_build")

_lib = None


def build_shared(cmd_head: list, src: str, stem: str) -> tuple[str, str]:
    """Compile `src` into BUILD_DIR/<stem>_<source hash>.so unless that file
    exists.  Returns (path, compiler output).  The output is written to a
    per-process temporary name and renamed into place, so concurrent test
    workers never load a half-written library."""
    with open(src, "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(cmd_head).encode())
    so = os.path.join(BUILD_DIR, f"{stem}_{digest.hexdigest()[:16]}.so")
    if os.path.exists(so):
        return so, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    res = subprocess.run(cmd_head + [src, "-o", tmp],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"building {src} failed ({' '.join(cmd_head)}):\n"
            f"{res.stdout}{res.stderr}")
    os.replace(tmp, so)
    return so, res.stdout + res.stderr


def get_lib():
    """Load the native library, building it on first use."""
    global _lib
    if _lib is not None:
        return _lib
    so, _ = build_shared(["g++", "-O3", "-shared", "-fPIC"], SRC,
                         "libfemo_native")
    lib = ctypes.CDLL(so)
    c_i32p = ctypes.POINTER(ctypes.c_int32)
    c_i64p = ctypes.POINTER(ctypes.c_int64)
    c_u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.rcb_partition.argtypes = [ctypes.POINTER(ctypes.c_double),
                                  ctypes.c_int64, ctypes.c_int,
                                  ctypes.c_int32, c_i32p]
    lib.rcb_partition.restype = None
    lib.rcm_order.argtypes = [c_i64p, c_i32p, ctypes.c_int64, c_i32p]
    lib.rcm_order.restype = None
    lib.bt_dest_map.argtypes = [c_i64p, c_i64p, ctypes.c_int64,
                                ctypes.c_int32, ctypes.c_int32, c_i64p,
                                c_u8p, ctypes.c_int64, ctypes.c_int64,
                                ctypes.c_int64, c_i64p]
    lib.bt_dest_map.restype = None
    lib.csr_block_count.argtypes = [c_i32p, ctypes.c_int64, ctypes.c_int64,
                                    ctypes.c_int64, c_i64p]
    lib.csr_block_count.restype = None
    lib.csr_block_fill.argtypes = [c_i32p, c_i32p, ctypes.c_int64,
                                   ctypes.c_int64, ctypes.c_int64, c_i64p,
                                   c_i32p]
    lib.csr_block_fill.restype = None
    lib.csr_pattern_finalize.argtypes = [c_i64p, c_i32p, ctypes.c_int64,
                                         c_i64p, c_i32p]
    lib.csr_pattern_finalize.restype = ctypes.c_int64
    lib.csr_bandwidth.argtypes = [c_i64p, c_i32p, c_i64p, ctypes.c_int64]
    lib.csr_bandwidth.restype = ctypes.c_int64
    _lib = lib
    return lib


def _ptr(a, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


def rcb_partition(centroids: np.ndarray, nparts: int) -> np.ndarray:
    """Recursive coordinate bisection of n points (n, dim) into nparts
    balanced spatial blocks: int32 (n,) part ids in [0, nparts).  Each
    split halves the points along the widest axis of the box they span
    (`std::nth_element`), so nparts should be a power of two."""
    lib = get_lib()
    centroids = np.ascontiguousarray(centroids, np.float64)
    if centroids.ndim != 2:
        raise ValueError(f"centroids must be (n, dim), got {centroids.shape}")
    if int(nparts) < 1:
        raise ValueError(f"nparts={nparts}: at least 1")
    n, dim = centroids.shape
    out = np.empty(n, np.int32)
    lib.rcb_partition(_ptr(centroids, ctypes.c_double), n, dim,
                      int(nparts), _ptr(out, ctypes.c_int32))
    return out


def rcm_order(indptr: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Reverse Cuthill-McKee permutation (new-to-old) of a CSR graph."""
    lib = get_lib()
    n = len(indptr) - 1
    indptr = np.ascontiguousarray(indptr, np.int64)
    indices = np.ascontiguousarray(indices, np.int32)
    out = np.empty(n, np.int32)
    lib.rcm_order(_ptr(indptr, ctypes.c_int64),
                  _ptr(indices, ctypes.c_int32), n,
                  _ptr(out, ctypes.c_int32))
    return out


def bt_dest_map(rows, cols, iperm, free_mask, B, nb, dump):
    """Per (e, i, j) element-matrix entry the flat (D, L, U) accumulator
    id of the block-tridiagonal template, or `dump` when BC-masked or
    off-tridiagonal.  Returns int64 (ne*nr*nc,)."""
    lib = get_lib()
    rows = np.ascontiguousarray(rows, np.int64)
    cols = np.ascontiguousarray(cols, np.int64)
    iperm = np.ascontiguousarray(iperm, np.int64)
    ne, nr = rows.shape
    nc = cols.shape[1]
    out = np.empty(ne * nr * nc, np.int64)
    fmp = None
    if free_mask is not None:
        fm = np.ascontiguousarray(np.asarray(free_mask).astype(np.uint8))
        fmp = fm.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    lib.bt_dest_map(_ptr(rows, ctypes.c_int64), _ptr(cols, ctypes.c_int64),
                    ne, nr, nc, _ptr(iperm, ctypes.c_int64), fmp,
                    int(B), int(nb), int(dump),
                    _ptr(out, ctypes.c_int64))
    return out


def csr_pattern_from_blocks(blocks, n):
    """Deduplicated CSR pattern (indptr int64 (n+1,), indices int32) of the
    element (rows, cols) id blocks [((ne,nr), (ne,nc)), ...]."""
    lib = get_lib()
    blocks = [(np.ascontiguousarray(r, np.int32),
               np.ascontiguousarray(c, np.int32)) for r, c in blocks]
    count = np.zeros(n + 1, np.int64)
    for r, c in blocks:
        ne, nr = r.shape
        lib.csr_block_count(_ptr(r, ctypes.c_int32), ne, nr, c.shape[1],
                            _ptr(count, ctypes.c_int64))
    off = np.cumsum(count)  # off[0] = 0: pair offsets with duplicates
    cols_buf = np.empty(off[-1], np.int32)
    cur = off[:-1].copy()
    for r, c in blocks:
        ne, nr = r.shape
        lib.csr_block_fill(_ptr(r, ctypes.c_int32), _ptr(c, ctypes.c_int32),
                           ne, nr, c.shape[1], _ptr(cur, ctypes.c_int64),
                           _ptr(cols_buf, ctypes.c_int32))
    indptr = np.empty(n + 1, np.int64)
    indices = np.empty(len(cols_buf), np.int32)
    nnz = lib.csr_pattern_finalize(_ptr(off, ctypes.c_int64),
                                   _ptr(cols_buf, ctypes.c_int32), n,
                                   _ptr(indptr, ctypes.c_int64),
                                   _ptr(indices, ctypes.c_int32))
    return indptr, indices[:nnz].copy()


def csr_bandwidth(indptr, indices, iperm) -> int:
    """max |iperm[r] - iperm[c]| over the CSR pattern."""
    lib = get_lib()
    indptr = np.ascontiguousarray(indptr, np.int64)
    indices = np.ascontiguousarray(indices, np.int32)
    iperm = np.ascontiguousarray(iperm, np.int64)
    return int(lib.csr_bandwidth(_ptr(indptr, ctypes.c_int64),
                                 _ptr(indices, ctypes.c_int32),
                                 _ptr(iperm, ctypes.c_int64),
                                 len(indptr) - 1))
