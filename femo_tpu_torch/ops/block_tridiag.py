"""Block-tridiagonal operators and their direct solvers (port of
femo_tpu/ops/block_tridiag.py: block Thomas, block cyclic reduction and
the solver adapter).

After RCM reordering (femo_tpu_torch.native, the JAX package's C++), a FEM
matrix has bandwidth b; with block size B >= b (rounded up to a multiple of
128) the matrix is exactly block-tridiagonal, A = tridiag(L_i, D_i, U_i).

* matvec: three batched (B,B)@(B,) products.
* factor: block Thomas, S_i = D_i - L_i C_{i-1}, Sinv_i = S_i^{-1},
  C_i = Sinv_i U_i — a Python loop over nb of `torch.linalg.inv_ex` and
  `@` (the JAX package left this recursion to XLA, not to Pallas).  No
  inter-block pivoting; the block inverses pivot.  Without `guard` it does
  not check for singular blocks: a failed inverse shows as non-finite
  values downstream, without a host sync per block.  `guard=True` is the
  JAX package's per-block rescue of low-precision recursions; see
  `factor` for it and for the departures.
* factor_cr: block cyclic (odd-even) reduction, ceil(log2 nb) levels of
  batched inverses and products (BlockCyclicFactor); no CUDA kernel of
  its own: the JAX package's was generated by XLA, and here each level is
  a few batched torch calls.
* factor_spd: the Cholesky-storage variant for SPD operators
  (BlockCholeskyFactor), on CPU tensors only: no kernel computes its
  triangular forward sweep, and nothing in either package solves with it
  outside the tests.
* solve: the two triangular sweeps, ops/bt_sweeps.py (CUDA kernels on the
  card, plain loops on the CPU), optionally in a lower dtype on an
  equilibrated factor (`BlockThomasFactor.sweep_dtype`, `scale`).
* jacobi_scaled / scale_vector: the symmetric equilibration S A S; the
  scaled solve x = S F'^{-1} S b is built by its callers (graph/implicit.py)
  around the factor F' of the scaled matrix.
* BlockTridiagFactorization: the `Factorization` adapter (solve, solve_t)
  of the `block_thomas` and `*_bt` LinearSolver backends.

* pcg_fixed / pcg_tol: preconditioned CG polish, a fixed count of
  iterations (no host sync) or to a tolerance (one host read of the
  residual norm per iteration).

Not ported: the chunked factors, which exist for the TPU runtime (one
factor loop serves every size here; `factor_cr_chunked` returns
`factor_cr`'s result).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..config import get_device
from .bt_sweeps import bt_sweep_solve, bwd_sweep_plain
from .scatter import OwnerTable


# the JAX package's guard (_inv_block_guarded's shift and cap)
GUARD_SHIFT = 1e-4
GUARD_CAP = 1e7


def _round_up(x, m):
    return ((x + m - 1) // m) * m


def _dtype(d):
    """None, or a torch float dtype from a torch dtype or its name."""
    if d is None or isinstance(d, torch.dtype):
        return d
    return getattr(torch, str(d))


def _stored(X, store_dtype):
    """X rounded to `store_dtype` and read back in X's dtype (None: X)."""
    if store_dtype is None or store_dtype == X.dtype:
        return X
    return X.to(store_dtype).to(X.dtype)


def _shift(xb, k):
    """Block rows shifted by k (+1: row i holds row i-1), zero-filled."""
    z = torch.zeros_like(xb[:1])
    return torch.cat([z, xb[:-1]]) if k == 1 else torch.cat([xb[1:], z])


def _bmv(A, x):
    """Batched (k, B, B) @ (k, B) -> (k, B)."""
    return torch.matmul(A, x.unsqueeze(-1)).squeeze(-1)


def _cr_level(D, L, U):
    """One cyclic-reduction level on (m, B, B) blocks, m even: eliminate
    the odd block rows.  Returns ((Dinv_odd, L_even, U_even, L_odd,
    U_odd), D2, L2, U2), the reduced system of the m / 2 even rows:

        D2_k = D_2k - L_2k Dinv_{2k-1} U_{2k-1} - U_2k Dinv_{2k+1} L_{2k+1}
        L2_k = -L_2k Dinv_{2k-1} L_{2k-1},  U2_k = -U_2k Dinv_{2k+1} U_{2k+1}

    (the JAX package's `_cr_level`, whose rows k - 1 come from rolled
    copies of whole arrays; here from slices, the k = 0 terms being zero)."""
    De, Do = D[0::2], D[1::2]
    Le, Lo = L[0::2], L[1::2]
    Ue, Uo = U[0::2], U[1::2]
    Dinv_o = torch.linalg.inv_ex(Do)[0]
    alpha = Le[1:] @ Dinv_o[:-1]  # L_2k Dinv_{2k-1}, k >= 1
    beta = Ue @ Dinv_o  # U_2k Dinv_{2k+1}
    D2 = De.clone()
    D2[1:] -= alpha @ Uo[:-1]
    D2 -= beta @ Lo
    L2 = torch.zeros_like(D2)
    L2[1:] = -(alpha @ Lo[:-1])
    U2 = -(beta @ Uo)
    return (Dinv_o, Le, Ue, Lo, Uo), D2, L2, U2


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
    def factor(self, store_dtype=None, spd: bool = False,
               guard: bool = False) -> "BlockThomasFactor":
        """Forward elimination: S_i = D_i - L_i C_{i-1}; stores S_i^{-1}
        and C_i = S_i^{-1} U_i.  The recursion always runs in the working
        dtype.

        store_dtype: round the stored Sinv and C to this dtype (e.g.
        "float32" in an f64 solve).  The JAX solve promotes them back to
        f64 in its einsums; here they are kept rounded in the working
        dtype, so the sweeps read the same values but the memory is not
        halved (a deliberate departure: a mixed-dtype K1/K2 is a later
        perf item).
        spd: the operator is SPD.  The block inverses stay the plain
        (pivoted) inverse `inv_ex`, which is the same S^{-1} a Cholesky
        inverse gives and the one the JAX package computes off the TPU;
        its Cholesky branch exists for the TPU's missing f64 LU.
        guard: the JAX package's singularity rescue for low-precision
        recursions (`_inv_block_guarded`): a block whose inverse is not
        finite or exceeds GUARD_CAP in magnitude is inverted again with
        the relative diagonal shift GUARD_SHIFT * max(max |diag S|, 1).
        The JAX package decides per block under `lax.cond`.  Here the
        recursion first runs unguarded and keeps each block's flag on the
        device; one host read after the loop finds the first flagged
        block, and only then does the recursion rerun from that block,
        with the rescue chosen per block by `torch.where` (both inverses
        computed).  The same blocks get the same shifted inverses; a
        healthy chain pays one small reduction a block and one sync.
        The factor's `rescued` counts the rescued blocks (a tensor; 0
        without a rescue)."""
        Sinv, C = [], []
        flags = self._thomas(0, Sinv, C, flag=guard)
        rescued = 0
        if guard:
            bad = torch.nonzero(torch.stack(flags))  # the one host sync
            if len(bad):
                start = int(bad[0, 0])
                del Sinv[start:], C[start:]
                rescued = torch.stack(
                    self._thomas(start, Sinv, C, rescue=True)).sum()
        store = _dtype(store_dtype)
        Sinv_t, C_t = torch.stack(Sinv), torch.stack(C)
        Sinv.clear()
        C.clear()
        return BlockThomasFactor(self, _stored(Sinv_t, store),
                                 _stored(C_t, store), rescued=rescued)

    def _thomas(self, start, Sinv, C, flag=False, rescue=False):
        """The recursion from block `start` (C_{start-1} is C[-1]),
        appending each Sinv_i and C_i.  flag / rescue: return each block's
        guard flag (a device bool) / and replace its flagged inverse by
        the shifted one (see `factor`)."""
        C_prev = C[-1] if start else torch.zeros_like(self.D[0])
        eye = torch.eye(self.B, dtype=self.D.dtype, device=self.D.device)
        flags = []
        for i in range(start, self.nb):
            S = self.D[i] - self.L[i] @ C_prev
            X, info = torch.linalg.inv_ex(S)
            if flag or rescue:
                bad = (info != 0) | ~(X.abs().amax() <= GUARD_CAP)
                if rescue:
                    s0 = torch.clamp(torch.diagonal(S).abs().amax(), min=1.0)
                    Xr, _ = torch.linalg.inv_ex(S + (GUARD_SHIFT * s0) * eye)
                    X = torch.where(bad, Xr, X)
                flags.append(bad)
            C_prev = X @ self.U[i]
            Sinv.append(X)
            C.append(C_prev)
        return flags

    def factor_t(self, store_dtype=None,
                 spd: bool = False) -> "BlockThomasFactor":
        """Factorization of A^T (for adjoint solves)."""
        return self._transposed().factor(store_dtype, spd)

    def factor_spd(self, store_dtype=None) -> "BlockCholeskyFactor":
        """Cholesky-storage block Thomas for SPD operators: stores Lc_i
        with S_i = Lc_i Lc_i^T and C_i = S_i^{-1} U_i, computed by two
        triangular solves.  A^T = A, so the same factor serves adjoint
        solves.  store_dtype rounds the stored Lc and C as in `factor`;
        the recursion carries the unrounded C."""
        store = _dtype(store_dtype)
        C_prev = torch.zeros_like(self.D[0])
        Lcs, C = [], []
        for i in range(self.nb):
            S = self.D[i] - self.L[i] @ C_prev
            Lc = torch.linalg.cholesky(S)
            Y = torch.linalg.solve_triangular(Lc, self.U[i], upper=False)
            C_prev = torch.linalg.solve_triangular(Lc.mT, Y, upper=True)
            Lcs.append(_stored(Lc, store))
            C.append(_stored(C_prev, store))
        return BlockCholeskyFactor(self, torch.stack(Lcs), torch.stack(C))

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

    # -- block cyclic reduction ----------------------------------------------
    def _cr_padded(self):
        """(D, L, U) padded to n2 = the next power of two >= nb blocks with
        identity D and zero L, U blocks, L[0] and U[-1] zeroed (the
        reduction's boundary), and n2.  Copies: the matrix stays as it
        was."""
        nb, B = self.nb, self.B
        n2 = 1 << max(nb - 1, 0).bit_length()
        pad = n2 - nb
        z = self.D.new_zeros((pad, B, B))
        eye = torch.eye(B, dtype=self.D.dtype, device=self.D.device)
        D = torch.cat([self.D, eye.expand(pad, B, B)])
        L = torch.cat([self.L, z])
        U = torch.cat([self.U, z])
        L[0] = 0.0
        U[-1] = 0.0
        return D, L, U, n2

    def factor_cr(self, store_dtype=None, spd: bool = False,
                  mixed_ns: int = 0,
                  mixed_tol: float = 1e-7) -> "BlockCyclicFactor":
        """Block cyclic (odd-even) reduction: each level eliminates every
        odd block row of the reduced system at once, with batched block
        inverses and products, down to one block after ceil(log2 nb)
        levels (about three times the Thomas factor's flops, in a
        dependency chain of log2 nb steps instead of nb).

        Each level stores (Dinv_odd, L_even, U_even, L_odd, U_odd); the
        L and U halves are views of that level's reduced L and U, so a
        factor holds about 5 n2 blocks (n2: nb padded to a power of two).
        store_dtype rounds the stored arrays (kept in the working dtype,
        as `factor` keeps them) while the reduction runs unrounded.  spd
        and mixed_ns / mixed_tol are the JAX signature's: the block
        inverses are the plain `inv_ex` (the JAX package's Cholesky and
        Newton-Schulz inverses exist for the TPU's emulated f64)."""
        store = _dtype(store_dtype)
        D, L, U, n2 = self._cr_padded()
        levels = []
        while D.shape[0] > 1:
            stored, D, L, U = _cr_level(D, L, U)
            levels.append(tuple(_stored(a, store) for a in stored))
        Dinv_root = _stored(torch.linalg.inv_ex(D[0])[0], store)
        return BlockCyclicFactor(self, levels, Dinv_root, n2)

    def factor_cr_chunked(self, store_dtype=None, spd: bool = False,
                          mixed_ns: int = 0, mixed_tol: float = 1e-7,
                          tail: int = 256) -> "BlockCyclicFactor":
        """`factor_cr`'s result.  The JAX package splits the reduction into
        one program per level to fit the TPU's 16 GB of HBM; the card
        holds the whole reduction at the FSI anchor, so this is a
        deliberate departure kept for the signature (`tail` unused)."""
        return self.factor_cr(store_dtype, spd, mixed_ns, mixed_tol)

    def factor_t_cr(self) -> "BlockCyclicFactor":
        """Cyclic-reduction factorization of A^T (for adjoint solves)."""
        return self._transposed().factor_cr()


@dataclass
class BlockThomasFactor:
    """Solve phase of block Thomas.  The forward sweep reads `mat.L` beside
    `Sinv`: the factor's own lower blocks, which a caller reusing a stale
    factor must keep (graph/implicit.py).

    sweep_dtype, scale, Lfac: a factor of the equilibrated operator
    S A S (S = diag(scale), (nb, B) in block layout) computed in a lower
    dtype (the FSI builders' factor_compute_dtype="float32"): Sinv, C and
    the scaled lower blocks Lfac = S_i L_i S_{i-1} in `sweep_dtype`, and
    the solve is x = S F^{-1} (S b), the sweeps run in sweep_dtype."""

    mat: BlockTridiagonalMatrix
    Sinv: torch.Tensor  # (nb, B, B)
    C: torch.Tensor  # (nb, B, B)
    sweep_dtype: object = None
    scale: torch.Tensor | None = None
    Lfac: torch.Tensor | None = None
    rescued: object = 0  # blocks factor(guard=True) rescued

    def solve(self, b):
        """x = A^{-1} b through the two triangular sweeps (K1 then K2 on
        CUDA tensors): b to blocks, times `scale`, cast to `sweep_dtype`,
        the sweeps on (Sinv, Lfac or mat.L, C), cast back, times
        `scale`."""
        m = self.mat
        bb = m.to_blocks(b)
        L = m.L
        if self.scale is not None:
            bb, L = bb * self.scale, self.Lfac
        if self.sweep_dtype is not None:
            bb = bb.to(_dtype(self.sweep_dtype))
        x = bt_sweep_solve(self.Sinv, L, self.C, bb).to(b.dtype)
        if self.scale is not None:
            x = x * self.scale
        return m.from_blocks(x)

    def solve_refined(self, b, refine: int = 0):
        """Solve with `refine` steps of iterative refinement against the
        factor's matrix (refine=0 is the plain solve)."""
        x = self.solve(b)
        for _ in range(refine):
            x = x + self.solve(b - self.mat.matvec(x))
        return x


@dataclass
class BlockCyclicFactor:
    """Solve phase of block cyclic reduction (`factor_cr`): a downward
    sweep reduces b level by level with t = Dinv_odd b_odd (so no
    multiplier matrices are stored), keeping each level's b_odd; the root
    solve; then an upward sweep recovers the odd unknowns of each level
    and interleaves them with the even ones.  Each level is a few batched
    matvecs (torch calls), on any device."""

    mat: BlockTridiagonalMatrix
    levels: list  # per level (Dinv_odd, L_even, U_even, L_odd, U_odd)
    Dinv_root: torch.Tensor  # (B, B)
    n2: int

    def solve(self, b):
        m = self.mat
        bb = m.to_blocks(b)
        if self.n2 > m.nb:
            bb = torch.cat([bb, bb.new_zeros((self.n2 - m.nb, m.B))])
        odd = []
        for Dinv_o, Le, Ue, Lo, Uo in self.levels:
            be, bo = bb[0::2], bb[1::2]
            t = _bmv(Dinv_o, bo)
            odd.append(bo)
            bb = be.clone()
            bb[1:] -= _bmv(Le[1:], t[:-1])
            bb -= _bmv(Ue, t)
        x = (self.Dinv_root @ bb[0])[None]
        for (Dinv_o, Le, Ue, Lo, Uo), bo in zip(reversed(self.levels),
                                                reversed(odd)):
            r = bo - _bmv(Lo, x)
            r[:-1] -= _bmv(Uo[:-1], x[1:])
            x = torch.stack([x, _bmv(Dinv_o, r)], dim=1).reshape(-1, m.B)
        return m.from_blocks(x[: m.nb])


@dataclass
class BlockCholeskyFactor:
    """Solve phase of the Cholesky-storage block Thomas (`factor_spd`):
    the forward sweep z_i = S_i^{-1}(b_i - L_i z_{i-1}) by two triangular
    solves per block, the backward sweep x_i = z_i - C_i x_{i+1}, both
    plain loops.  On CPU tensors only: a solve on the card goes through
    K1/K2 (`factor`) or raises."""

    mat: BlockTridiagonalMatrix
    Lc: torch.Tensor  # (nb, B, B) lower Cholesky factor of S_i
    C: torch.Tensor  # (nb, B, B) S_i^{-1} U_i

    def solve(self, b):
        if b.device.type != "cpu":
            raise RuntimeError(
                "BlockCholeskyFactor solves on CPU tensors only (no kernel "
                "computes its triangular sweep); use factor() on the card")
        m = self.mat
        bb = m.to_blocks(b)
        z, z_prev = [], torch.zeros_like(bb[0])
        for i in range(m.nb):
            rhs = (bb[i] - m.L[i] @ z_prev)[:, None]
            y = torch.linalg.solve_triangular(self.Lc[i], rhs, upper=False)
            z_prev = torch.linalg.solve_triangular(self.Lc[i].mT, y,
                                                   upper=True)[:, 0]
            z.append(z_prev)
        return m.from_blocks(bwd_sweep_plain(self.C, torch.stack(z)))


class BlockTridiagFactorization:
    """Factorization-interface adapter (solvers/linear.py): the
    BC-constrained operator of an ElementMatrix in block-tridiagonal form,
    block-Thomas factored; `solve_t` factors the transpose at its first
    call.  `refine` steps of iterative refinement follow every solve,
    against the matrix (`solve`) or its transpose (`solve_t`)."""

    def __init__(self, emat, free, refine: int = 0):
        self.mat = BlockTridiagonalMatrix.from_element_matrix(emat, free)
        self._f = self.mat.factor()
        self._ft = None
        self.refine = refine

    def solve(self, b):
        return self._f.solve_refined(b, self.refine)

    def transpose_factor(self) -> BlockThomasFactor:
        if self._ft is None:
            self._ft = self.mat.factor_t()
        return self._ft

    def solve_t(self, b):
        return self.transpose_factor().solve_refined(b, self.refine)


class BlockTridiagTemplate:
    """Symbolic/numeric split: RCM ordering, block layout and the
    element-entry -> (D|L|U, block, i, j) destination map are computed
    once host-side from a pattern ElementMatrix; `fill` is then one
    fixed-order gather and sum per Newton iteration."""

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

        # identity on fixed dofs and on the padding rows
        diag_ids = []
        if self.free is not None:
            pf = iperm[np.nonzero(~self.free)[0]]
            diag_ids.append(((0 * nb + pf // B) * B + pf % B) * B + pf % B)
        pad = np.arange(n, n_pad)
        diag_ids.append(((0 * nb + pad // B) * B + pad % B) * B + pad % B)
        diag_ids = np.concatenate(diag_ids)
        self.diag_ids = torch.as_tensor(diag_ids, device=device)
        self.perm_full = np.concatenate([perm.astype(np.int64),
                                         np.arange(n, n_pad)])

        # owner table of the fill: the source is the flat element values
        # followed by one 1 per identity entry
        keep = np.nonzero(dest != dump)[0]
        n_vals = len(dest)
        self._fill_table = OwnerTable(
            np.concatenate([dest[keep], diag_ids]),
            n_vals + len(diag_ids),
            src=np.concatenate([keep, n_vals + np.arange(len(diag_ids))]),
            device=device)

    def fill(self, emat_blocks):
        """Element blocks [(A, rows, cols), ...] -> (D, L, U), summed
        through the template's owner table (ops/scatter.py)."""
        vals = torch.cat([A.reshape(-1) for A, _, _ in emat_blocks])
        tab = self._fill_table
        src = torch.cat([vals, vals.new_ones(tab.n_src - len(vals))])
        acc = torch.zeros(self.dest_size - 1, dtype=vals.dtype,
                          device=vals.device)
        acc[tab.ids] = tab.sum(src)
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


def pcg_tol(mat: BlockTridiagonalMatrix, fac: BlockThomasFactor | None,
            b, rtol: float = 1e-10, maxiter: int = 100, x0=None,
            transpose: bool = False, M=None, atol: float = 0.0):
    """Preconditioned CG to a tolerance: iterate until ||r||_2 <=
    max(rtol ||b||_2, atol) or `maxiter` iterations, the converged-solve
    semantics of the reference (SNES atol/rtol 1e-13,
    utils_dolfinx.py:377-379).  A low-precision factor (f32 storage)
    then changes the iteration count, not the answer.

    The convergence test reads ||r|| on the host once per iteration (and
    once before the first): one device sync each, where the JAX package
    tests it inside a `lax.while_loop`.  Returns (x, iterations (int),
    relative residual ||r|| / ||b|| (a 0-d tensor)).  Reaching maxiter
    is no error: the count says so.  Preconditioner applications: one
    before the loop and one per iteration."""
    mv = mat.matvec_t if transpose else mat.matvec
    M = M or fac.solve
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - mv(x)
    z = M(r)
    p = z
    rz = torch.dot(r, z)
    bnorm = torch.linalg.norm(b)
    stop = max(rtol * float(bnorm), atol)
    k = 0
    while k < maxiter and float(torch.linalg.norm(r)) > stop:
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
        k += 1
    return x, k, torch.linalg.norm(r) / torch.where(bnorm == 0, 1.0, bnorm)
