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
// K4, element SpMV, element-major products then an owner sum.  The TPU
// kernel formed the per-element products A_e @ x[cols_e] in VMEM tiles
// and left the segment sum to XLA; here the same split takes two launches
// of one call (element_spmv_f32/_f64 below, design 1):
//
//   1. element_product_kernel: a block owns a tile of te consecutive
//      elements.  Their A_e are one contiguous run of memory, brought into
//      shared memory by one TMA bulk copy (cp.async.bulk on an mbarrier;
//      16-byte cp.async where the run is not 16-byte aligned), with an L2
//      policy that evicts A first: A streams through once, and the
//      gathered vector and the partials stay in L2.  Meanwhile the
//      block's threads gather the tile's x[cols_e] (K4) or y[rows_e]
//      (K4T) into shared memory, reading the index as nodes of bs
//      entries where a vector field numbers its components together (bs
//      3 on FSI's force-load operator Fm: a third of the index bytes).
//      One thread then forms one product, (A_e x_e)[r] or (A_e^T y_e)[c],
//      summed over k in increasing order, and stores it at its slot's
//      place in owner order (the plan's dest map) in a partials buffer of
//      ne * nr or ne * nc values that the wrapper allocates (ops/spmv.py
//      keeps it on the plan).  te is 256 / (products per element), capped
//      so the tile takes at most 48 KB and rounded to whole 16-byte runs:
//      84 elements of 3 x 3, 32 of 8 x 8, 28 of Fm's 18 x 9 for K4T (40
//      KB, five blocks an SM).  For K4 with an even nc the rows are stored
//      at an odd pitch (nc + 1), value by value, so the lanes reading
//      neighbouring rows do not share a bank.
//   2. owner_sum_kernel: one thread owns one output entry and sums its
//      run of partials, contiguous in owner order, in increasing slot
//      (element) order, then writes it or adds it into out.  No atomics:
//      the association is the plain version's (each element's product,
//      then the sum in element order) and two launches give the same
//      bits.
//
// Bound: bytes.  The function reads A_e, rows, cols and x once and writes
// y once (W1's 135,200 3 x 3 elements: 14.1 MB, 4.2 us at 3.35 TB/s; Fm,
// 107,520 18 x 9: 158 MB, 47 us); 2 nr nc flops per element are nothing
// against that.  The design adds the partials, written once and read once
// (7.7 MB at Fm, from L2), the dest map and the owner pointers (4.7 MB).
// What does not stream is the gather: 1.9 million reads of y on Fm, from
// L2, while A passes through.
//
// design 0, element_spmv_kernel, is the row-owner kernel the port started
// with: one thread per output entry walks its slots and reads each slot's
// row (K4) or column (K4T) of A_e straight from memory, in one launch.
// Where those values lie within 64 bytes (W1's 3 x 3 blocks both ways,
// W4's 8 x 8 rows in f64) that is two sectors a slot and the one launch
// wins; ops/spmv.py::element_design takes design 0 there and design 1
// elsewhere.  On Fm a column is nr loads 72 bytes apart, each its own
// sector, and the element's owners read it at different times, so A comes
// from DRAM more than once.
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

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kTileBytes = 48 * 1024;  // K4 products: shared memory a tile
constexpr int kTile = 32;  // K5 rows per tile, one warp; ops/spmv.py TILE
constexpr int kK5Threads = 64;  // K5: two warps a block, ~8 blocks an SM
constexpr unsigned kFull = 0xffffffffu;

// K4 design 0, row-owner.
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

// Asynchronous copies global -> shared: 16 bytes (cp.async.cg, around L1)
// with an L2 policy, and one value of T; both waited for by
// cp_async_wait_all.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           uint64_t policy) {
  asm volatile(
      "cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;\n" ::"r"(
          smem_addr(dst)),
      "l"(src), "l"(policy));
}

template <typename T>
__device__ __forceinline__ void cp_async1(T* dst, const T* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "n"(sizeof(T)));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// An L2 policy that evicts first the lines it brings in: the element
// matrices stream through once; the gathered vector and the partials
// should stay.
__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(p));
  return p;
}

// One TMA bulk copy of `bytes` (a positive multiple of 16, both ends
// 16-byte aligned) into shared memory, completing on the mbarrier `bar`
// (initialised for one arrival, the calling thread's).  Every thread then
// waits with bulk_wait(bar).
__device__ __forceinline__ void bulk_issue(uint64_t* bar, void* dst,
                                           const void* src, unsigned bytes,
                                           uint64_t policy) {
  const unsigned b = smem_addr(bar);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   b),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(b), "l"(policy)
      : "memory");
}

__device__ __forceinline__ void bulk_wait(uint64_t* bar) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], 0;\n"
      "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(smem_addr(bar))
      : "memory");
}

// n values of T rounded up to a whole number of 16 bytes
template <typename T>
__host__ __device__ constexpr int aligned16(int n) {
  return (n * static_cast<int>(sizeof(T)) + 15) / 16 * 16 /
         static_cast<int>(sizeof(T));
}

// K4 design 1, step 1: the products of the tile of elements
// [blockIdx.x * te, + te), each written to its owner-ordered place
// dest[s] of part, s = e*nr + r (K4) or e*nc + c (K4T):
//   K4:  sum_{k < nc} A[(e*nr + r)*nc + k] * x[cols[e*nc + k]]
//   K4T: sum_{k < nr} A[(e*nr + k)*nc + c] * y[rows[e*nr + k]]
// The index of the gathered side comes as nodes of bs consecutive entries:
// cols[e*nc + k] = bs * nodes[(e*nc + k) / bs] + k % bs (bs = 1: nodes is
// the index itself).  Shared memory: the gathered values (te * ni, rounded
// up to 16 bytes), then the tile's A_e at row pitch `pitch` (nc, or nc + 1)
// and 16 bytes of slack.  bulk: the tile is one TMA copy (A_e 16-byte
// aligned, te * nr * nc values a whole number of 16 bytes, pitch == nc);
// otherwise cp.async, 16 bytes at a time where pitch == nc.
template <typename T, bool TRANS>
__global__ void __launch_bounds__(kThreads)
element_product_kernel(const T* __restrict__ A, const int* __restrict__ nodes,
                       const int* __restrict__ dest, const T* __restrict__ v,
                       T* __restrict__ part, int ne, int nr, int nc, int bs,
                       int te, int pitch, int bulk) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) uint64_t bar;
  constexpr int kVec = 16 / sizeof(T);
  const int ni = TRANS ? nr : nc;  // gathered values per element
  const int no = TRANS ? nc : nr;  // products per element
  const int e0 = blockIdx.x * te;
  const int cnt = min(te, ne - e0);
  const int n = cnt * nr * nc;
  const T* g = A + static_cast<size_t>(e0) * nr * nc;
  T* sv = reinterpret_cast<T*>(smem);
  T* sA = sv + aligned16<T>(te * ni);
  const uint64_t policy = evict_first_policy();
  if (bulk) {
    if (threadIdx.x == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
          smem_addr(&bar)));
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    const int body = n / kVec * kVec;  // all but a last tile's odd values
    if (threadIdx.x == 0) {
      if (body > 0)
        bulk_issue(&bar, sA, g, body * sizeof(T), policy);
      else
        asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                         smem_addr(&bar))
                     : "memory");
    }
    for (int i = body + threadIdx.x; i < n; i += blockDim.x)
      cp_async1(sA + i, g + i);
  } else if (pitch == nc) {
    // one contiguous run: a head up to g's next 16-byte boundary, the body
    // in 16-byte copies, the tail; sA shifted so that sA + i and g + i
    // share their alignment
    const int shift = static_cast<int>(
        (reinterpret_cast<uintptr_t>(g) & 15) / sizeof(T));
    sA += shift;
    const int head = min(n, (kVec - shift) % kVec);
    const int body = (n - head) / kVec;
    for (int i = threadIdx.x; i < head; i += blockDim.x)
      cp_async1(sA + i, g + i);
    for (int i = threadIdx.x; i < body; i += blockDim.x)
      cp_async16(sA + head + i * kVec, g + head + i * kVec, policy);
    for (int i = head + body * kVec + threadIdx.x; i < n; i += blockDim.x)
      cp_async1(sA + i, g + i);
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int row = i / nc;
      cp_async1(sA + row * pitch + (i - row * nc), g + i);
    }
  }
  if (bs == 1) {
    const int* ix = nodes + static_cast<size_t>(e0) * ni;
    for (int i = threadIdx.x; i < cnt * ni; i += blockDim.x)
      sv[i] = __ldg(v + __ldg(ix + i));
  } else {
    const int* ix = nodes + static_cast<size_t>(e0) * (ni / bs);
    for (int i = threadIdx.x; i < cnt * ni; i += blockDim.x) {
      const int q = i / bs;
      sv[i] = __ldg(v + bs * __ldg(ix + q) + (i - q * bs));
    }
  }
  cp_async_wait_all();
  if (bulk) bulk_wait(&bar);
  __syncthreads();
  const size_t s0 = static_cast<size_t>(e0) * no;
  for (int o = threadIdx.x; o < cnt * no; o += blockDim.x) {
    const int le = o / no;
    const int j = o - le * no;
    const T* a = sA + le * nr * pitch;
    const T* x = sv + le * ni;
    T acc = T(0);
    if (TRANS) {
      for (int k = 0; k < nr; ++k) acc += a[k * pitch + j] * x[k];
    } else {
      for (int k = 0; k < nc; ++k) acc += a[j * pitch + k] * x[k];
    }
    part[__ldg(dest + s0 + o)] = acc;
  }
}

// K4 design 1, step 2: out[i] (+)= part[ptr[i]] + ... + part[ptr[i+1] - 1],
// the partials of output i, in increasing slot (element) order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
owner_sum_kernel(const int* __restrict__ ptr, const T* __restrict__ part,
                 T* __restrict__ out, int n_out, int accumulate) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_out) return;
  T acc = T(0);
  const int s1 = __ldg(ptr + i + 1);
  for (int s = __ldg(ptr + i); s < s1; ++s) acc += __ldg(part + s);
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

// K4 design 1's tile: elements per tile, row pitch, shared memory bytes,
// and whether one TMA copy brings it (see element_product_kernel)
template <typename T>
void product_tile(const void* A, int nr, int nc, int transpose, int* te,
                  int* pitch, int* smem, int* bulk) {
  const int ni = transpose ? nr : nc;
  const int no = transpose ? nc : nr;
  *pitch = (!transpose && nc % 2 == 0) ? nc + 1 : nc;
  const int per = (nr * *pitch + ni) * static_cast<int>(sizeof(T));
  *te = std::max(1, std::min(kThreads / no, kTileBytes / per));
  // tiles of a whole number of 16 bytes: te a multiple of m
  const int esz = nr * nc * static_cast<int>(sizeof(T));
  int m = 1;
  while ((esz * m) % 16) m *= 2;
  *bulk = *pitch == nc && *te >= m &&
          reinterpret_cast<uintptr_t>(A) % 16 == 0;
  if (*bulk) *te = *te / m * m;
  *smem = (aligned16<T>(*te * ni) + *te * nr * *pitch) *
              static_cast<int>(sizeof(T)) +
          16;
}

template <typename T, bool TRANS>
cudaError_t launch_products(const T* A, const int* nodes, const int* dest,
                            const T* v, T* part, int ne, int nr, int nc,
                            int bs, cudaStream_t st) {
  int te, pitch, smem, bulk;
  product_tile<T>(A, nr, nc, TRANS, &te, &pitch, &smem, &bulk);
  auto kernel = element_product_kernel<T, TRANS>;
  if (smem > 48 * 1024) {  // one element larger than the tile's budget
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<blocks_for(ne, te), kThreads, smem, st>>>(
      A, nodes, dest, v, part, ne, nr, nc, bs, te, pitch, bulk);
  return cudaGetLastError();
}

// design 0: the row-owner kernel (idx the full index of the gathered
// side, ptr/slot the owner CSR); design 1: the products into part, in
// owner order by dest (idx the nodes of bs entries), then the owner sum
// (ptr the owner CSR's row pointer)
template <typename T>
int launch_element(const void* A, const void* ptr, const void* slot,
                   const void* idx, const void* dest, const void* v,
                   void* part, void* out, int n_out, int ne, int nr, int nc,
                   int bs, int transpose, int accumulate, int design,
                   void* stream) {
  if (n_out == 0) return static_cast<int>(cudaSuccess);
  const dim3 grid(blocks_for(n_out, kThreads));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* a = static_cast<const T*>(A);
  const int* p = static_cast<const int*>(ptr);
  const int* ix = static_cast<const int*>(idx);
  const T* vv = static_cast<const T*>(v);
  T* o = static_cast<T*>(out);
  if (design == 0) {
    const int* s = static_cast<const int*>(slot);
    if (transpose)
      element_spmv_kernel<T, true><<<grid, kThreads, 0, st>>>(
          a, p, s, ix, vv, o, n_out, nr, nc, accumulate);
    else
      element_spmv_kernel<T, false><<<grid, kThreads, 0, st>>>(
          a, p, s, ix, vv, o, n_out, nr, nc, accumulate);
    return static_cast<int>(cudaGetLastError());
  }
  T* pt = static_cast<T*>(part);
  const int* d = static_cast<const int*>(dest);
  if (ne > 0) {
    const cudaError_t err =
        transpose
            ? launch_products<T, true>(a, ix, d, vv, pt, ne, nr, nc, bs, st)
            : launch_products<T, false>(a, ix, d, vv, pt, ne, nr, nc, bs, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  owner_sum_kernel<T><<<grid, kThreads, 0, st>>>(p, pt, o, n_out, accumulate);
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
                     const void* idx, const void* dest, const void* v,
                     void* part, void* out, int n_out, int ne, int nr, int nc,
                     int bs, int transpose, int accumulate, int design,
                     void* stream) {
  return launch_element<float>(A, ptr, slot, idx, dest, v, part, out, n_out,
                               ne, nr, nc, bs, transpose, accumulate, design,
                               stream);
}

int element_spmv_f64(const void* A, const void* ptr, const void* slot,
                     const void* idx, const void* dest, const void* v,
                     void* part, void* out, int n_out, int ne, int nr, int nc,
                     int bs, int transpose, int accumulate, int design,
                     void* stream) {
  return launch_element<double>(A, ptr, slot, idx, dest, v, part, out, n_out,
                                ne, nr, nc, bs, transpose, accumulate, design,
                                stream);
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
