"""Block-tridiagonal operators and the block-Thomas direct solver (port of
femo_tpu/ops/block_tridiag.py: the Thomas path and its solver adapter).

After RCM reordering (femo_tpu_torch.native, the JAX package's C++), a FEM
matrix has bandwidth b; with block size B >= b (rounded up to a multiple of
128) the matrix is exactly block-tridiagonal, A = tridiag(L_i, D_i, U_i).

* matvec: three batched (B,B)@(B,) products.
* factor: block Thomas, S_i = D_i - L_i C_{i-1}, Sinv_i = S_i^{-1},
  C_i = Sinv_i U_i — a Python loop over nb of `torch.linalg.inv_ex` and
  `@` (the JAX package left this recursion to XLA, not to Pallas).  No
  inter-block pivoting; the block inverses pivot.  Like the JAX recursion
  it does not check for singular blocks: a failed inverse shows as
  non-finite values downstream, without a host sync per block.
* solve: the two triangular sweeps, ops/bt_sweeps.py (CUDA kernels on the
  card, plain loops on the CPU).
* jacobi_scaled / scale_vector: the symmetric equilibration S A S; the
  scaled solve x = S F'^{-1} S b is built by its callers (graph/implicit.py)
  around the factor F' of the scaled matrix.
* BlockTridiagFactorization: the `Factorization` adapter (solve, solve_t)
  of the `block_thomas` and `*_bt` LinearSolver backends.

Not ported (slice D): reduced-precision factor storage and sweeps, the SPD
(Cholesky) factor, cyclic reduction, the chunked and mixed-precision
factors and `pcg_tol`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..config import get_device
from .bt_sweeps import bt_sweep_solve


def _round_up(x, m):
    return ((x + m - 1) // m) * m


def _shift(xb, k):
    """Block rows shifted by k (+1: row i holds row i-1), zero-filled."""
    z = torch.zeros_like(xb[:1])
    return torch.cat([z, xb[:-1]]) if k == 1 else torch.cat([xb[1:], z])


class BlockTridiagonalMatrix:
    """Block-tridiagonal form of a sparse matrix after RCM reordering,
    with the new-to-old permutation so callers work in dof order."""

    def __init__(self, D, L, U, perm, n: int):
        self.D = D  # (nb, B, B)
        self.L = L  # (nb, B, B)  L[0] unused
        self.U = U  # (nb, B, B)  U[-1] unused
        self.perm = np.asarray(perm, np.int64)  # host copy
        self.n = n
        self.nb, self.B = D.shape[0], D.shape[1]
        inv = np.zeros(len(self.perm), np.int64)
        inv[self.perm] = np.arange(len(self.perm))
        self.iperm = torch.as_tensor(inv, device=D.device)
        self.perm_t = torch.as_tensor(self.perm, device=D.device)

    # -- construction ---------------------------------------------------------
    @classmethod
    def from_element_matrix(cls, emat, free=None):
        """The BC-constrained operator of an ElementMatrix (identity on
        fixed dofs), laid out and filled by a BlockTridiagTemplate on the
        device of the element blocks."""
        tpl = BlockTridiagTemplate(emat, free=free,
                                   device=emat.blocks[0].A.device)
        return tpl.matrix([(b.A, b.rows, b.cols) for b in emat.blocks])

    def _like(self, D, L, U):
        """A matrix of other blocks in this one's layout, sharing its
        permutation tensors."""
        m = object.__new__(BlockTridiagonalMatrix)
        m.__dict__.update(self.__dict__)
        m.D, m.L, m.U = D, L, U
        return m

    # -- vector permutation helpers ----------------------------------------------
    def to_blocks(self, x):
        pad = torch.zeros(self.nb * self.B - self.n, dtype=x.dtype,
                          device=x.device)
        return torch.cat([x, pad])[self.perm_t].reshape(self.nb, self.B)

    def from_blocks(self, xb):
        return xb.reshape(-1)[self.iperm][: self.n]

    # -- matvec --------------------------------------------------------------------
    def matvec(self, x):
        xb = self.to_blocks(x)
        y = torch.einsum("bij,bj->bi", self.D, xb)
        y = y + torch.einsum("bij,bj->bi", self.L, _shift(xb, 1))
        y = y + torch.einsum("bij,bj->bi", self.U, _shift(xb, -1))
        return self.from_blocks(y)

    def matvec_t(self, x):
        """Transpose matvec A^T x (same three batched products)."""
        xb = self.to_blocks(x)
        y = torch.einsum("bji,bj->bi", self.D, xb)
        # (A^T)_{i,i-1} = U_{i-1}^T ; (A^T)_{i,i+1} = L_{i+1}^T
        Um = torch.roll(self.U, 1, dims=0)
        Lp = torch.roll(self.L, -1, dims=0)
        y = y + torch.einsum("bji,bj->bi", Um, _shift(xb, 1))
        y = y + torch.einsum("bji,bj->bi", Lp, _shift(xb, -1))
        return self.from_blocks(y)

    # -- block Thomas factorization ---------------------------------------------
    def factor(self) -> "BlockThomasFactor":
        """Forward elimination: S_i = D_i - L_i C_{i-1}; stores S_i^{-1}
        and C_i = S_i^{-1} U_i."""
        C_prev = torch.zeros_like(self.D[0])
        Sinv, C = [], []
        for i in range(self.nb):
            S = self.D[i] - self.L[i] @ C_prev
            Si, _ = torch.linalg.inv_ex(S)
            C_prev = Si @ self.U[i]
            Sinv.append(Si)
            C.append(C_prev)
        return BlockThomasFactor(self, torch.stack(Sinv), torch.stack(C))

    def factor_t(self) -> "BlockThomasFactor":
        """Factorization of A^T (for adjoint solves)."""
        return self._transposed().factor()

    def _transposed(self):
        # contiguous copies: the sweep kernels read row-major blocks, so
        # they must not be handed transposed views
        return self._like(
            self.D.transpose(1, 2).contiguous(),
            # A^T lower block i = U_{i-1}^T
            torch.roll(self.U.transpose(1, 2), 1, dims=0).contiguous(),
            torch.roll(self.L.transpose(1, 2), -1, dims=0).contiguous())

    # -- symmetric Jacobi scaling ------------------------------------------
    def jacobi_scaled(self):
        """The symmetrically equilibrated copy A' = S A S, S = diag(1 /
        sqrt(|diag A|)), and the block-layout scale s (nb, B).  Identity
        padding and BC rows keep s = 1."""
        d = torch.diagonal(self.D, dim1=1, dim2=2)
        s = 1.0 / torch.sqrt(torch.clamp(torch.abs(d),
                                         min=torch.finfo(d.dtype).tiny))
        z = torch.zeros_like(s[:1])
        sm = torch.cat([z, s[:-1]])  # s of block row i - 1
        sp = torch.cat([s[1:], z])  # s of block row i + 1
        D2 = self.D * s[:, :, None] * s[:, None, :]
        L2 = self.L * s[:, :, None] * sm[:, None, :]
        U2 = self.U * s[:, :, None] * sp[:, None, :]
        return self._like(D2, L2, U2), s

    def scale_vector(self, x, s):
        """Apply the block-layout diagonal scale s to a dof vector."""
        return self.from_blocks(self.to_blocks(x) * s)


@dataclass
class BlockThomasFactor:
    """Solve phase of block Thomas.  The forward sweep reads `mat.L` beside
    `Sinv`: the factor's own lower blocks, which a caller reusing a stale
    factor must keep (graph/implicit.py)."""

    mat: BlockTridiagonalMatrix
    Sinv: torch.Tensor  # (nb, B, B)
    C: torch.Tensor  # (nb, B, B)

    def solve(self, b):
        """x = A^{-1} b through the two triangular sweeps."""
        m = self.mat
        return m.from_blocks(
            bt_sweep_solve(self.Sinv, m.L, self.C, m.to_blocks(b)))

    def solve_refined(self, b, refine: int = 0):
        """Solve with `refine` steps of iterative refinement against the
        factor's matrix (refine=0 is the plain solve)."""
        x = self.solve(b)
        for _ in range(refine):
            x = x + self.solve(b - self.mat.matvec(x))
        return x


class BlockTridiagFactorization:
    """Factorization-interface adapter (solvers/linear.py): the
    BC-constrained operator of an ElementMatrix in block-tridiagonal form,
    block-Thomas factored; `solve_t` factors the transpose at its first
    call."""

    def __init__(self, emat, free):
        self.mat = BlockTridiagonalMatrix.from_element_matrix(emat, free)
        self._f = self.mat.factor()
        self._ft = None

    def solve(self, b):
        return self._f.solve(b)

    def transpose_factor(self) -> BlockThomasFactor:
        if self._ft is None:
            self._ft = self.mat.factor_t()
        return self._ft

    def solve_t(self, b):
        return self.transpose_factor().solve(b)


class BlockTridiagTemplate:
    """Symbolic/numeric split: RCM ordering, block layout and the
    element-entry -> (D|L|U, block, i, j) destination map are computed
    once host-side from a pattern ElementMatrix; `fill` is then one
    index_add per Newton iteration."""

    def __init__(self, emat, free=None, block: int | None = None,
                 device=None):
        from .. import native

        device = get_device(device)

        def host(a):
            return a.cpu().numpy() if isinstance(a, torch.Tensor) \
                else np.asarray(a)

        n = emat.shape[0]
        self.n = n
        self.free = None if free is None else host(free)
        pattern = [(host(b.rows), host(b.cols)) for b in emat.blocks]
        indptr, indices = native.csr_pattern_from_blocks(pattern, n)
        perm = native.rcm_order(indptr, indices)
        iperm = np.zeros(n, np.int64)
        iperm[perm] = np.arange(n)
        bw = max(native.csr_bandwidth(indptr, indices, iperm), 1)
        self.bw = bw  # raw RCM bandwidth (before rounding to a block)
        B = block or max(128, _round_up(bw, 128))
        if bw > B:
            raise ValueError(f"bandwidth {bw} > block {B}")
        n_pad = _round_up(n, B)
        nb = n_pad // B
        self.B, self.nb = B, nb

        # destination id of every element-matrix entry in the flat
        # (3, nb, B, B) accumulator: which = 0 (D), 1 (L), 2 (U); id =
        # ((which*nb + blk)*B + li)*B + lj; BC-masked entries -> dump slot
        self.dest_size = 3 * nb * B * B + 1
        dump = self.dest_size - 1
        dest = np.concatenate([
            native.bt_dest_map(r, c, iperm, self.free, B, nb, dump)
            for r, c in pattern])
        self.dest = torch.as_tensor(dest, device=device)
        keep = np.nonzero(dest != dump)[0]
        self._keep = torch.as_tensor(keep, device=device)
        self._keep_dest = torch.as_tensor(dest[keep], device=device)

        # identity on fixed dofs and on the padding rows
        diag_ids = []
        if self.free is not None:
            pf = iperm[np.nonzero(~self.free)[0]]
            diag_ids.append(((0 * nb + pf // B) * B + pf % B) * B + pf % B)
        pad = np.arange(n, n_pad)
        diag_ids.append(((0 * nb + pad // B) * B + pad % B) * B + pad % B)
        self.diag_ids = torch.as_tensor(np.concatenate(diag_ids),
                                        device=device)
        self.perm_full = np.concatenate([perm.astype(np.int64),
                                         np.arange(n, n_pad)])

    def fill(self, emat_blocks):
        """Element blocks [(A, rows, cols), ...] -> (D, L, U)."""
        vals = torch.cat([A.reshape(-1) for A, _, _ in emat_blocks])
        acc = torch.zeros(self.dest_size - 1, dtype=vals.dtype,
                          device=vals.device)
        acc.index_add_(0, self._keep_dest, vals[self._keep])
        acc.index_add_(0, self.diag_ids, torch.ones_like(
            self.diag_ids, dtype=vals.dtype))
        T = acc.reshape(3, self.nb, self.B, self.B)
        return T[0], T[1], T[2]

    def matrix(self, emat_blocks) -> BlockTridiagonalMatrix:
        D, L, U = self.fill(emat_blocks)
        return BlockTridiagonalMatrix(D, L, U, self.perm_full, self.n)


def pcg_fixed(mat: BlockTridiagonalMatrix, fac: BlockThomasFactor | None,
              b, iters: int, x0=None, transpose: bool = False, M=None):
    """Fixed-iteration preconditioned CG: A = mat.matvec (or matvec_t),
    M = fac.solve or an explicit preconditioner callable.  No convergence
    branch, so no host sync."""
    mv = mat.matvec_t if transpose else mat.matvec
    M = M or fac.solve
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - mv(x)
    z = M(r)
    p = z
    rz = torch.dot(r, z)
    for _ in range(iters):
        Ap = mv(p)
        denom = torch.dot(p, Ap)
        alpha = rz / torch.where(denom == 0, 1.0, denom)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz_new = torch.dot(r, z)
        beta = rz_new / torch.where(rz == 0, 1.0, rz)
        p = z + beta * p
        rz = rz_new
    return x
