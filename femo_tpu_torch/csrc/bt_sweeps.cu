// Block-Thomas triangular sweeps for Hopper (sm_90a).
//
// Replaces femo_tpu/ops/pallas_bt.py::_fwd_kernel (K1) and ::_bwd_kernel
// (K2), the Pallas TPU kernels of the block-tridiagonal solve phase:
//
//   K1 (forward):  z_i = Sinv_i (b_i - L_i z_{i-1}),  z_{-1} = 0,  i = 0..nb-1
//   K2 (backward): x_i = z_i - C_i x_{i+1},           x_nb  = 0,  i = nb-1..0
//
// Sinv, L, C are (nb, B, B) row-major, b/z/x are (nb, B), all contiguous.
//
// The TPU ran each sweep as one sequential grid with the carry row in VMEM
// scratch.  Here ONE thread block walks the whole length-nb chain in a loop
// and the carry lives in shared memory.  Each block row is one warp-row
// reduction: the 32 lanes stride the columns of a row-major block (so each
// warp load is 32 consecutive elements, coalesced) and the partial sums are
// reduced with __shfl_down_sync.  The warps of the block take the B rows
// round-robin.
//
// Unlike the Pallas kernel, which was f32 only (Mosaic has no f64), the
// sweeps run in the working dtype: float and double instantiations, so an
// f64 solve stays f64 end to end.
//
// Bound: each step streams two (K1) or one (K2) (B, B) blocks from HBM
// through a single SM, and the steps are strictly sequential, so a sweep
// is bounded by one SM's achievable read bandwidth and the load latency of
// each step, not by flops (2 B^2 flops per block read of 8 B^2 bytes in
// f64).  The design keeps every load coalesced and issues the whole block's
// loads from all 32 warps at once; prefetching block i+1 (cp.async / TMA)
// while block i is reduced, or spreading the rows over a cluster, are the
// next steps.  Host-side: one launch per sweep instead of ~2 nb small
// library launches.
//
// Built by femo_tpu_torch/ops/bt_sweeps.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and bound through the plain C entry points at the end (ctypes).  Each
// entry point launches on the given stream and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;  // 32 warps

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Dot product of row r of the row-major (B, B) block M with the shared-memory
// vector v, reduced across the warp; valid in lane 0.
template <typename T>
__device__ __forceinline__ T row_dot(const T* __restrict__ M, int r,
                                     const T* v, int B, int lane) {
  const T* row = M + static_cast<size_t>(r) * B;
  T acc = T(0);
#pragma unroll 4
  for (int c = lane; c < B; c += 32) acc += __ldg(row + c) * v[c];
  return warp_sum(acc);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bt_fwd_kernel(const T* __restrict__ Sinv, const T* __restrict__ L,
              const T* __restrict__ b, T* __restrict__ z, int nb, int B) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* zc = reinterpret_cast<T*>(smem_raw);  // carry z_{i-1}
  T* t = zc + B;                            // b_i - L_i z_{i-1}
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int k = threadIdx.x; k < B; k += blockDim.x) zc[k] = T(0);
  __syncthreads();
  for (int i = 0; i < nb; ++i) {
    const size_t blk = static_cast<size_t>(i) * B * B;
    const T* bi = b + static_cast<size_t>(i) * B;
    for (int r = warp; r < B; r += nwarps) {
      T s = row_dot(L + blk, r, zc, B, lane);
      if (lane == 0) t[r] = bi[r] - s;
    }
    __syncthreads();  // t complete; every read of zc done
    T* zi = z + static_cast<size_t>(i) * B;
    for (int r = warp; r < B; r += nwarps) {
      T s = row_dot(Sinv + blk, r, t, B, lane);
      if (lane == 0) {
        zc[r] = s;
        zi[r] = s;
      }
    }
    __syncthreads();  // zc complete; every read of t done
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bt_bwd_kernel(const T* __restrict__ C, const T* __restrict__ z,
              T* __restrict__ x, int nb, int B) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* cur = reinterpret_cast<T*>(smem_raw);  // carry x_{i+1}
  T* nxt = cur + B;                          // x_i being formed
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int k = threadIdx.x; k < B; k += blockDim.x) cur[k] = T(0);
  __syncthreads();
  for (int i = nb - 1; i >= 0; --i) {
    const size_t blk = static_cast<size_t>(i) * B * B;
    const T* zi = z + static_cast<size_t>(i) * B;
    T* xi = x + static_cast<size_t>(i) * B;
    for (int r = warp; r < B; r += nwarps) {
      T s = row_dot(C + blk, r, cur, B, lane);
      if (lane == 0) {
        T v = zi[r] - s;
        nxt[r] = v;
        xi[r] = v;
      }
    }
    __syncthreads();  // nxt complete; every read of cur done
    T* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
}

template <typename K>
cudaError_t prepare(K kernel, size_t smem) {
  if (smem > 48 * 1024)
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
  return cudaSuccess;
}

template <typename T>
int launch_fwd(const void* Sinv, const void* L, const void* b, void* z,
               int nb, int B, void* stream) {
  const size_t smem = 2 * static_cast<size_t>(B) * sizeof(T);
  cudaError_t err = prepare(bt_fwd_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  bt_fwd_kernel<T><<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(Sinv), static_cast<const T*>(L),
      static_cast<const T*>(b), static_cast<T*>(z), nb, B);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* C, const void* z, void* x, int nb, int B,
               void* stream) {
  const size_t smem = 2 * static_cast<size_t>(B) * sizeof(T);
  cudaError_t err = prepare(bt_bwd_kernel<T>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  bt_bwd_kernel<T><<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(C), static_cast<const T*>(z), static_cast<T*>(x),
      nb, B);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int bt_fwd_sweep_f32(const void* Sinv, const void* L, const void* b, void* z,
                     int nb, int B, void* stream) {
  return launch_fwd<float>(Sinv, L, b, z, nb, B, stream);
}

int bt_fwd_sweep_f64(const void* Sinv, const void* L, const void* b, void* z,
                     int nb, int B, void* stream) {
  return launch_fwd<double>(Sinv, L, b, z, nb, B, stream);
}

int bt_bwd_sweep_f32(const void* C, const void* z, void* x, int nb, int B,
                     void* stream) {
  return launch_bwd<float>(C, z, x, nb, B, stream);
}

int bt_bwd_sweep_f64(const void* C, const void* z, void* x, int nb, int B,
                     void* stream) {
  return launch_bwd<double>(C, z, x, nb, B, stream);
}

const char* bt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
