// Sparse matrix-vector products of the assembled FE operator, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernels of experiments/pallas_spmv.py:
//
//   K3  ell_spmv_pallas      y_i = sum_k vals[i,k] x[cols[i,k]]
//   K4  element_spmv_pallas  y = segment_sum(A_e @ x[cols_e], rows_e)
//       (K4T, its transpose:  x = segment_sum(A_e^T @ y[rows_e], cols_e))
//   K5  banded_spmv_pallas   y_i = sum_d band[i,d] x[i+d-b]   (RCM order)
//
// K4 is the one on the port's solver path: ElementMatrix.matvec/rmatvec,
// i.e. every Krylov iteration of a LinearSolver (forward and adjoint).
//
// K4, element SpMV, row-owner.  The TPU kernel fused the gather and the
// per-element (nr, nc) product in VMEM tiles and left the scatter (a
// segment sum over the whole dof vector) to XLA.  Here the whole matvec is
// one kernel: a host-built CSR of the element pattern, made once per
// pattern (femo_tpu_torch/ops/spmv.py::ElementSpMVPlan), lists for every
// output row its (element, local row) slots in increasing element order.
// One thread owns one output row and sums A_e[r, :] . x[cols_e] over its
// slots, so there are no atomics and the result is the same on every run.
// K4T is the same kernel with the roles of rows and columns swapped and
// A_e read transposed.  Bound: bytes.  A_e is read once (9.7 MB at the
// slice's 135,200 P1 triangles in f64), the slot map and the element
// index arrays once, x through the read-only cache; 2 nr nc flops per
// element are nothing against that.  Each slot reads nc contiguous values
// of A_e (24 bytes in f64), so a warp's loads are not coalesced; an
// element-major order of those reads is a later tuning step.
//
// K3, ELL SpMV.  One thread per row for k <= 8 (the P1 stiffness has
// k = 7), one warp per row above that; x is read through the read-only
// cache (__ldg).  Bound: bytes (vals and cols once, x and y).
//
// K5, banded SpMV, on the band's nonzero diagonal segments.  The TPU kernel
// read the whole dense RCM band, n x (2b+1), because Mosaic lowers no
// gathers.  That band is ~99% zeros (the W1 stiffness at nel=260: n =
// 68,121, b = 261, 285 MB in f64 for 339,561 nonzeros), so reading it
// bounds any kernel at 85 us, 8x a library SpMV on the CSR.  Here the band
// is read once, on the device, into a plan (femo_tpu_torch/ops/spmv.py::
// BandedSpMVPlan): rows cut into tiles of kTile = 32, and per tile only the
// diagonals d whose 32 values are not all zero, in increasing d: tile_ptr
// (n_tiles + 1), diag (segments), vals (segments, 32) slot-major.  The
// band assembled on the card holds 409,449 nonzeros at nel=260: 69,888 of
// them are rounding leftovers (at most 1e-14 of the largest entry) of
// couplings that cancel exactly on the CPU, and they are kept, since the
// dense product multiplies them too.  Its plan holds 7.45 segments a tile
// (max 18), 4.1 MB; with the leftovers zeroed, 5.46 a tile, 3.0 MB.
// One warp owns one
// tile, lane r row 32t + r; for segment j the warp loads vals[j, 0..31]
// and x[32t + d_j - b + 0..31]: since d_j is the same across the warp,
// both are contiguous (256 bytes in f64), so the ELL form's gather becomes
// a coalesced load.  The warp reads up to 32 of its diag values at once and
// broadcasts them with shuffles; segments go four at a time, their loads
// issued before their products, so each warp keeps several loads in
// flight.  Blocks of two warps spread the tiles evenly over the SMs (at
// nel=260, 1,065 blocks, ~8 an SM).  x is read through the read-only path
// (545 KB at nel=260, it stays in L2); there is no shared-memory window, so
// no limit on b; x is zero outside [0, n) by a bounds test.  Bound: bytes,
// the band's nonzeros with x and y, 4.4 MB at nel=260, 1.30 us at 3.35
// TB/s (the plan's 5.2 MB with x and y, 1.56 us).  The kernel takes ~2.6 us
// on an H100 (chip_smoke.py) on every nel=260 band, from 5.46 to 7.45
// segments a tile, so the launch and each warp's chain of dependent loads
// (tile_ptr, diag, then vals and x) bound it, not the bandwidth: TMA and
// wgmma buy nothing here.  The terms are summed in
// increasing d, the dense loop's order; the terms skipped are products
// with zeros of the band, exact zeros for finite x.  The one difference
// from the dense form (and the TPU kernel): a zero of the band that meets
// an inf or NaN of x gives NaN there, and K5 does not produce that NaN
// when it skips the zero's segment.  Two launches give the same bits.
//
// Built by femo_tpu_torch/ops/spmv.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and bound through the plain C entry points at the end (ctypes).  Each
// entry point launches on the given stream and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 32;  // K5 rows per tile, one warp; ops/spmv.py TILE
constexpr int kK5Threads = 64;  // K5: two warps a block, ~8 blocks an SM
constexpr unsigned kFull = 0xffffffffu;

// K4 (TRANS = false): out[i] = sum over slots s = e*nr + r of row i of
//   sum_{k < nc} A[(e*nr + r)*nc + k] * v[idx[e*nc + k]],   idx = cols.
// K4T (TRANS = true): out[j] = sum over slots s = e*nc + c of column j of
//   sum_{k < nr} A[(e*nr + k)*nc + c] * v[idx[e*nr + k]],   idx = rows.
template <typename T, bool TRANS>
__global__ void __launch_bounds__(kThreads)
element_spmv_kernel(const T* __restrict__ A, const int* __restrict__ ptr,
                    const int* __restrict__ slot, const int* __restrict__ idx,
                    const T* __restrict__ v, T* __restrict__ out, int n_out,
                    int nr, int nc, int accumulate) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_out) return;
  T acc = T(0);
  const int s1 = ptr[i + 1];
  for (int s = ptr[i]; s < s1; ++s) {
    const int sl = slot[s];
    if (!TRANS) {
      const int e = sl / nr;
      const T* a = A + static_cast<size_t>(sl) * nc;
      const int* c = idx + static_cast<size_t>(e) * nc;
      for (int k = 0; k < nc; ++k) acc += __ldg(a + k) * __ldg(v + c[k]);
    } else {
      const int e = sl / nc;
      const int col = sl - e * nc;
      const T* a = A + static_cast<size_t>(e) * nr * nc + col;
      const int* r = idx + static_cast<size_t>(e) * nr;
      for (int k = 0; k < nr; ++k)
        acc += __ldg(a + static_cast<size_t>(k) * nc) * __ldg(v + r[k]);
    }
  }
  out[i] = accumulate ? out[i] + acc : acc;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ell_thread_kernel(const T* __restrict__ vals, const int* __restrict__ cols,
                  const T* __restrict__ x, T* __restrict__ y, int n, int k) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const size_t row = static_cast<size_t>(i) * k;
  T acc = T(0);
  for (int j = 0; j < k; ++j)
    acc += __ldg(vals + row + j) * __ldg(x + __ldg(cols + row + j));
  y[i] = acc;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ell_warp_kernel(const T* __restrict__ vals, const int* __restrict__ cols,
                const T* __restrict__ x, T* __restrict__ y, int n, int k) {
  const int i = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (i >= n) return;  // whole warps leave together
  const size_t row = static_cast<size_t>(i) * k;
  T acc = T(0);
  for (int j = lane; j < k; j += 32)
    acc += __ldg(vals + row + j) * __ldg(x + __ldg(cols + row + j));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (lane == 0) y[i] = acc;
}

// x[col], zero outside [0, n)
template <typename T>
__device__ __forceinline__ T x_at(const T* __restrict__ x, int col, int n) {
  return (col >= 0 && col < n) ? __ldg(x + col) : T(0);
}

// K5: y[32t + r] = sum over the segments j of tile t, in increasing
// diag[j], of vals[j, r] * x[32t + r + diag[j] - b].
template <typename T>
__global__ void __launch_bounds__(kK5Threads)
banded_segment_kernel(const int* __restrict__ tile_ptr,
                      const int* __restrict__ diag, const T* __restrict__ vals,
                      const T* __restrict__ x, T* __restrict__ y, int n,
                      int b, int n_tiles) {
  const int tile = (blockIdx.x * blockDim.x + threadIdx.x) / kTile;
  const int lane = threadIdx.x % kTile;
  if (tile >= n_tiles) return;  // whole warps leave together
  const int row = tile * kTile + lane;
  const int s1 = __ldg(tile_ptr + tile + 1);
  T acc = T(0);
  for (int base = __ldg(tile_ptr + tile); base < s1; base += kTile) {
    const int cnt = min(kTile, s1 - base);
    // lane k holds diag[base + k] - b; shuffles hand it to the whole warp
    const int off = (lane < cnt ? __ldg(diag + base + lane) : 0) - b;
    const T* v = vals + static_cast<size_t>(base) * kTile + lane;
    int k = 0;
    for (; k + 4 <= cnt; k += 4) {
      T a[4], xv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        a[u] = __ldg(v + static_cast<size_t>(k + u) * kTile);
        xv[u] = x_at(x, row + __shfl_sync(kFull, off, k + u), n);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) acc += a[u] * xv[u];
    }
    for (; k < cnt; ++k)
      acc += __ldg(v + static_cast<size_t>(k) * kTile) *
             x_at(x, row + __shfl_sync(kFull, off, k), n);
  }
  if (row < n) y[row] = acc;
}

inline int blocks_for(long long work, int per_block) {
  return static_cast<int>((work + per_block - 1) / per_block);
}

template <typename T>
int launch_element(const void* A, const void* ptr, const void* slot,
                   const void* idx, const void* v, void* out, int n_out,
                   int nr, int nc, int transpose, int accumulate,
                   void* stream) {
  if (n_out == 0) return static_cast<int>(cudaSuccess);
  const dim3 grid(blocks_for(n_out, kThreads));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* a = static_cast<const T*>(A);
  const int* p = static_cast<const int*>(ptr);
  const int* s = static_cast<const int*>(slot);
  const int* ix = static_cast<const int*>(idx);
  const T* vv = static_cast<const T*>(v);
  T* o = static_cast<T*>(out);
  if (transpose)
    element_spmv_kernel<T, true><<<grid, kThreads, 0, st>>>(
        a, p, s, ix, vv, o, n_out, nr, nc, accumulate);
  else
    element_spmv_kernel<T, false><<<grid, kThreads, 0, st>>>(
        a, p, s, ix, vv, o, n_out, nr, nc, accumulate);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_ell(const void* vals, const void* cols, const void* x, void* y,
               int n, int k, void* stream) {
  if (n == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* va = static_cast<const T*>(vals);
  const int* co = static_cast<const int*>(cols);
  const T* xx = static_cast<const T*>(x);
  T* yy = static_cast<T*>(y);
  if (k <= 8)
    ell_thread_kernel<T><<<blocks_for(n, kThreads), kThreads, 0, st>>>(
        va, co, xx, yy, n, k);
  else
    ell_warp_kernel<T>
        <<<blocks_for(static_cast<long long>(n) * 32, kThreads), kThreads, 0,
           st>>>(va, co, xx, yy, n, k);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_banded(const void* tile_ptr, const void* diag, const void* vals,
                  const void* x, void* y, int n, int b, void* stream) {
  if (n == 0) return static_cast<int>(cudaSuccess);
  const int n_tiles = (n + kTile - 1) / kTile;
  banded_segment_kernel<T>
      <<<blocks_for(static_cast<long long>(n_tiles) * kTile, kK5Threads),
         kK5Threads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const int*>(tile_ptr), static_cast<const int*>(diag),
          static_cast<const T*>(vals), static_cast<const T*>(x),
          static_cast<T*>(y), n, b, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int element_spmv_f32(const void* A, const void* ptr, const void* slot,
                     const void* idx, const void* v, void* out, int n_out,
                     int nr, int nc, int transpose, int accumulate,
                     void* stream) {
  return launch_element<float>(A, ptr, slot, idx, v, out, n_out, nr, nc,
                               transpose, accumulate, stream);
}

int element_spmv_f64(const void* A, const void* ptr, const void* slot,
                     const void* idx, const void* v, void* out, int n_out,
                     int nr, int nc, int transpose, int accumulate,
                     void* stream) {
  return launch_element<double>(A, ptr, slot, idx, v, out, n_out, nr, nc,
                                transpose, accumulate, stream);
}

int ell_spmv_f32(const void* vals, const void* cols, const void* x, void* y,
                 int n, int k, void* stream) {
  return launch_ell<float>(vals, cols, x, y, n, k, stream);
}

int ell_spmv_f64(const void* vals, const void* cols, const void* x, void* y,
                 int n, int k, void* stream) {
  return launch_ell<double>(vals, cols, x, y, n, k, stream);
}

int banded_spmv_f32(const void* tile_ptr, const void* diag, const void* vals,
                    const void* x, void* y, int n, int b, void* stream) {
  return launch_banded<float>(tile_ptr, diag, vals, x, y, n, b, stream);
}

int banded_spmv_f64(const void* tile_ptr, const void* diag, const void* vals,
                    const void* x, void* y, int n, int b, void* stream) {
  return launch_banded<double>(tile_ptr, diag, vals, x, y, n, b, stream);
}

const char* spmv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
