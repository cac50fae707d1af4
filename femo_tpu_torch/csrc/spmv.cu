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
// K5, banded SpMV.  Each block of kRows threads stages its window
// x[row0 - b, row0 + kRows + b) in shared memory once (zero outside
// [0, n)), and each thread reduces one row over the 2b+1 diagonals from
// shared memory: no gathers, as on the TPU.  Bound: bytes (the band,
// n (2b+1) values, dominates: most of it is the zeros of the band).
//
// Built by femo_tpu_torch/ops/spmv.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and bound through the plain C entry points at the end (ctypes).  Each
// entry point launches on the given stream and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 256;  // K5 rows per block

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

template <typename T>
__global__ void __launch_bounds__(kRows)
banded_kernel(const T* __restrict__ band, const T* __restrict__ x,
              T* __restrict__ y, int n, int b) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);  // x[row0 - b, row0 + kRows + b)
  const int row0 = blockIdx.x * kRows;
  const int w = kRows + 2 * b;
  for (int t = threadIdx.x; t < w; t += blockDim.x) {
    const int g = row0 - b + t;
    xs[t] = (g >= 0 && g < n) ? x[g] : T(0);
  }
  __syncthreads();
  const int i = row0 + threadIdx.x;
  if (i >= n) return;
  const int nd = 2 * b + 1;
  const T* row = band + static_cast<size_t>(i) * nd;
  const T* xw = xs + threadIdx.x;  // band[i, d] multiplies x[i + d - b]
  T acc = T(0);
  for (int d = 0; d < nd; ++d) acc += __ldg(row + d) * xw[d];
  y[i] = acc;
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
int launch_banded(const void* band, const void* x, void* y, int n, int b,
                  void* stream) {
  if (n == 0) return static_cast<int>(cudaSuccess);
  const size_t smem = static_cast<size_t>(kRows + 2 * b) * sizeof(T);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        banded_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  banded_kernel<T><<<blocks_for(n, kRows), kRows, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(band), static_cast<const T*>(x),
      static_cast<T*>(y), n, b);
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

int banded_spmv_f32(const void* band, const void* x, void* y, int n, int b,
                    void* stream) {
  return launch_banded<float>(band, x, y, n, b, stream);
}

int banded_spmv_f64(const void* band, const void* x, void* y, int n, int b,
                    void* stream) {
  return launch_banded<double>(band, x, y, n, b, stream);
}

const char* spmv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
