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
// What bounds a sweep on this card.  Every (B, B) block is known before the
// sweep starts; only the length-B carry is sequential.  A sweep must read
// 2 nb B^2 (K1) or nb B^2 (K2) values and do 2 flops on each, so its floor
// is the bytes over the memory rate (0.18 ms for K1 at nb=147, B=512 in
// f64 on an H100 SXM).  On top of that, the chain has 2 nb - 1 (K1) or
// nb - 1 (K2) dependent phases, each a matvec that needs the whole carry
// of the phase before, and passing a value from one SM to another takes a
// store and a load through L2.  At the motor's shapes the chain, not the
// bytes, is the bound: chip_smoke.py reports the time per phase.  The TPU kernel ran the chain as a sequential grid
// whose BlockSpec pipeline fetched block i+1 during step i; one thread
// block walking the chain and reading each block when needed streams
// everything through one SM of 132 and pays the memory latency every step.
//
// The design:
//
// * Many CTAs, each owning R rows of every block.  A cooperative launch of
//   G = ceil(B / R) CTAs, at most one per SM, so all are resident (the
//   launch fails, and the wrapper raises, if they cannot be).  CTA g owns
//   rows [gR, gR + R) of every L_i, Sinv_i (K1) and C_i (K2): one
//   contiguous R*B*sizeof(T) span of each row-major block.
// * Prefetch that does not wait on the carry.  Each CTA keeps a ring of S
//   stages in shared memory, filled by 1-D bulk copies (TMA,
//   cp.async.bulk) that complete on one mbarrier per stage, issued by one
//   thread that publishes no row.  The copies for steps i+1 .. i+S-1 are in
//   flight while step i waits for its carry, so all G SMs stream the
//   blocks together and a step finds its rows already in shared memory.
// * One dependent phase per matvec, synchronised through the data itself.
//   Each output and scratch slot (z_i and x_i are the outputs themselves;
//   t_i = b_i - L_i z_{i-1} is an (nb, B) scratch) is written once per
//   launch, by one aligned 4- or 8-byte relaxed gpu-scope store.  The
//   wrapper fills them with a NaN bit pattern that no sweep writes (kEmpty;
//   a computed value with those bits is stored as the canonical NaN
//   instead).  A reader polls a slot with relaxed gpu-scope loads (through
//   L2: the read-only/L1 path is undefined for data written in the same
//   launch) until it leaves kEmpty, and the value it then sees is final.
//   Nothing else passes between CTAs, so a phase costs one store and one
//   L2 round trip; a grid barrier (a counter's release, its acquire, then
//   a read of the carry) would cost three.
// * The whole CTA gathers, one warp per row computes.  Each phase, the
//   CTA's 256 threads poll the carry into shared memory (each thread its
//   slots, all its loads in flight at once), and after a __syncthreads
//   warp r of the CTA forms row r: the lanes stride the row of the slab in
//   shared memory, a fixed __shfl_down_sync tree reduces them, lane 0
//   publishes.  Every sum has a fixed order, so every run gives the same
//   bits.  The rows' own inputs (b_i in K1, z_i in K2) are loaded a step
//   ahead, so no polling thread waits on memory first.
// * K1's step 0 has z_{-1} = 0: it reads b_0 and skips the unused L_0; K2's
//   first step writes x_{nb-1} = z_{nb-1} and skips the unused C_{nb-1}.
// * A spin that lasts more than kSpinLimitNs (far beyond any sweep) traps,
//   so a fault shows as a launch failure instead of a hang.
//
// Limits: B a multiple of 32, R <= kThreads, the shared memory of a stage.
// The float and double instantiations run in the working dtype
// (the Pallas kernels were f32 only because Mosaic has no f64).  The
// launch geometry (R rows per CTA, S stages) comes from the caller
// (femo_tpu_torch/ops/bt_sweeps.py::sweep_plan, whose shared-memory formula
// mirrors smem_bytes below).
//
// Built by femo_tpu_torch/ops/bt_sweeps.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and bound through the plain C entry points at the end (ctypes).  Each
// entry point launches on the given stream and returns the launch's error
// code (0 on success).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxStages = 4;
// issues the bulk copies: lane 0 of the last warp, which has no row unless
// a CTA owns more than kWarps - 1 rows
constexpr int kFetcher = kThreads - 32;
constexpr int kBarrierBytes = 128;  // the stages' mbarriers
constexpr unsigned long long kSpinLimitNs = 4000000000ull;

// kEmpty: the "not yet written" mark the wrapper fills outputs with
// (ops/bt_sweeps.py::_EMPTY holds the same bits); kNaN replaces a computed
// value that happens to carry those bits.
template <typename T>
struct Word;

template <>
struct Word<float> {
  using U = unsigned int;
  static constexpr U kEmpty = 0xFFBA5A5Au;
  static constexpr U kNaN = 0x7FFFFFFFu;
  static __device__ __forceinline__ U bits(float v) {
    return __float_as_uint(v);
  }
  static __device__ __forceinline__ float value(U u) {
    return __uint_as_float(u);
  }
};

template <>
struct Word<double> {
  using U = unsigned long long;
  static constexpr U kEmpty = 0xFFF7A5A55A5AA5A5ull;
  static constexpr U kNaN = 0x7FF8000000000000ull;
  static __device__ __forceinline__ U bits(double v) {
    return static_cast<U>(__double_as_longlong(v));
  }
  static __device__ __forceinline__ double value(U u) {
    return __longlong_as_double(static_cast<long long>(u));
  }
};

__device__ __forceinline__ unsigned int ld_relaxed(const unsigned int* p) {
  unsigned int v;
  asm volatile("ld.relaxed.gpu.global.b32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long ld_relaxed(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(unsigned int* p, unsigned int v) {
  asm volatile("st.relaxed.gpu.global.b32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ void st_relaxed(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

// Traps once a spin has lasted kSpinLimitNs.
struct Watchdog {
  unsigned long long start = 0;
  unsigned int spins = 0;
  __device__ __forceinline__ void tick() {
    if ((++spins & 255u) != 0) return;
    unsigned long long now;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
    if (start == 0)
      start = now;
    else if (now - start > kSpinLimitNs)
      __trap();
  }
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// Make the initialised mbarriers visible to the bulk copies (async proxy).
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Arrive on `bar` and expect `bytes` of bulk copies to complete on it.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Wait for the completion of the phase of `bar` with parity `parity`.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned addr = smem_u32(bar);
  Watchdog dog;
  for (;;) {
    unsigned done;
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (done) return;
    dog.tick();
  }
}

// 1-D bulk copy (TMA) of `bytes` from global to shared memory, completing
// on `bar`.  Addresses 16-byte aligned, bytes a multiple of 16.
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src,
                                         unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Store one carry value for the other CTAs.
template <typename T>
__device__ __forceinline__ void publish(T* dst, T v) {
  using W = Word<T>;
  using U = typename W::U;
  const U u = W::bits(v);
  st_relaxed(reinterpret_cast<U*>(dst), u == W::kEmpty ? U(W::kNaN) : u);
}

// Copy the length-B vector `src`, written by the CTAs of this launch, into
// shared memory `dst`, waiting for every element to leave kEmpty.  Each
// thread has up to four loads in flight and re-polls only those pending.
template <typename T>
__device__ __forceinline__ void gather_carry(const T* src, T* dst, int B) {
  using W = Word<T>;
  using U = typename W::U;
  const U* s = reinterpret_cast<const U*>(src);
  for (int base = threadIdx.x; base < B; base += 4 * kThreads) {
    U v[4];
    unsigned pending = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = base + j * kThreads;
      if (k < B) {
        v[j] = ld_relaxed(s + k);
        pending |= static_cast<unsigned>(v[j] == W::kEmpty) << j;
      }
    }
    Watchdog dog;
    while (pending) {
      dog.tick();
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (pending & (1u << j)) {
          v[j] = ld_relaxed(s + base + j * kThreads);
          if (v[j] != W::kEmpty) pending &= ~(1u << j);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = base + j * kThreads;
      if (k < B) dst[k] = W::value(v[j]);
    }
  }
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Dot product of a length-B row with the vector v, both in shared memory,
// reduced across the warp in a fixed order; valid in lane 0.
template <typename T>
__device__ __forceinline__ T row_dot(const T* row, const T* v, int B,
                                     int lane) {
  T a0 = T(0), a1 = T(0);
  int c = lane;
  for (; c + 32 < B; c += 64) {
    a0 += row[c] * v[c];
    a1 += row[c + 32] * v[c + 32];
  }
  if (c < B) a0 += row[c] * v[c];
  return warp_sum(a0 + a1);
}

// Dynamic shared memory of one CTA: the stages' mbarriers; two carry
// vectors; S stages of `blocks` (R, B) row slabs; two (R,) row buffers.
template <typename T>
size_t smem_bytes(int blocks, int B, int R, int S) {
  return kBarrierBytes +
         (2 * static_cast<size_t>(B) +
          static_cast<size_t>(S) * blocks * R * B + 2 * static_cast<size_t>(R))
             * sizeof(T);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
bt_fwd_kernel(const T* __restrict__ Sinv, const T* __restrict__ L,
              const T* __restrict__ b, T* t, T* z, int nb, int B, int R,
              int S) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);  // one per stage
  T* zc = reinterpret_cast<T*>(smem + kBarrierBytes);  // z_{i-1}
  T* tc = zc + B;                                      // t_i
  T* ring = tc + B;  // S stages of [L_i rows | Sinv_i rows]
  const size_t slab = static_cast<size_t>(R) * B;
  T* own = ring + S * 2 * slab;  // b_i on this CTA's rows
  const int row0 = blockIdx.x * R;
  const int rows = min(R, B - row0);
  const unsigned slab_bytes = static_cast<unsigned>(rows * B * sizeof(T));
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // (the fetcher) step i's rows of L_i (none at i = 0) and Sinv_i, into
  // stage i % S
  auto fetch = [&](int i) {
    T* dst = ring + (i % S) * 2 * slab;
    const size_t off = (static_cast<size_t>(i) * B + row0) * B;
    uint64_t* bar = &full[i % S];
    mbar_expect_tx(bar, (i > 0 ? 2u : 1u) * slab_bytes);
    if (i > 0) bulk_g2s(dst, L + off, slab_bytes, bar);
    bulk_g2s(dst + slab, Sinv + off, slab_bytes, bar);
  };
  if (threadIdx.x == kFetcher) {
    for (int s = 0; s < S; ++s) mbar_init(&full[s], 1);
    mbar_init_fence();
    for (int i = 0; i < min(S, nb); ++i) fetch(i);
  }
  // step 0: z_0 = Sinv_0 b_0
  for (int k = threadIdx.x; k < B; k += kThreads) tc[k] = b[k];
  __syncthreads();  // tc complete, the mbarriers initialised
  mbar_wait(&full[0], 0);
  for (int r = warp; r < rows; r += kWarps) {
    const T s = row_dot(ring + slab + static_cast<size_t>(r) * B, tc, B,
                        lane);
    if (lane == 0) publish(z + row0 + r, s);
  }

  // b_i on this CTA's rows, loaded one step ahead
  T b_next = T(0);
  if (threadIdx.x < rows && nb > 1) b_next = b[B + row0 + threadIdx.x];
  for (int i = 1; i < nb; ++i) {
    const T* Lr = ring + (i % S) * 2 * slab;
    const T* Sr = Lr + slab;
    const size_t vi = static_cast<size_t>(i) * B;
    if (threadIdx.x < rows) {
      own[threadIdx.x] = b_next;
      if (i + 1 < nb) b_next = b[vi + B + row0 + threadIdx.x];
    }
    // phase 1: t_i = b_i - L_i z_{i-1}
    gather_carry(z + vi - B, zc, B);
    __syncthreads();  // zc and own complete; every warp is past step i-1
    if (threadIdx.x == kFetcher && i - 1 + S < nb) fetch(i - 1 + S);
    mbar_wait(&full[i % S], (i / S) & 1);
    for (int r = warp; r < rows; r += kWarps) {
      const T s = row_dot(Lr + static_cast<size_t>(r) * B, zc, B, lane);
      if (lane == 0) publish(t + vi + row0 + r, own[r] - s);
    }
    // phase 2: z_i = Sinv_i t_i
    gather_carry(t + vi, tc, B);
    __syncthreads();  // tc complete; every warp is past phase 1
    for (int r = warp; r < rows; r += kWarps) {
      const T s = row_dot(Sr + static_cast<size_t>(r) * B, tc, B, lane);
      if (lane == 0) publish(z + vi + row0 + r, s);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
bt_bwd_kernel(const T* __restrict__ C, const T* __restrict__ z, T* x, int nb,
              int B, int R, int S) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  T* carry = reinterpret_cast<T*>(smem + kBarrierBytes);  // 2 x (B,)
  T* ring = carry + 2 * B;  // S stages of C_i rows
  const size_t slab = static_cast<size_t>(R) * B;
  T* own = ring + S * slab;  // 2 x z_i on this CTA's rows
  const int row0 = blockIdx.x * R;
  const int rows = min(R, B - row0);
  const unsigned slab_bytes = static_cast<unsigned>(rows * B * sizeof(T));
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // step q = 0 .. nb-2 forms x_i, i = nb-2-q; (the fetcher) its rows of
  // C_i into stage q % S
  auto fetch = [&](int q) {
    const size_t off = (static_cast<size_t>(nb - 2 - q) * B + row0) * B;
    uint64_t* bar = &full[q % S];
    mbar_expect_tx(bar, slab_bytes);
    bulk_g2s(ring + (q % S) * slab, C + off, slab_bytes, bar);
  };
  if (threadIdx.x == kFetcher) {
    for (int s = 0; s < S; ++s) mbar_init(&full[s], 1);
    mbar_init_fence();
    for (int q = 0; q < min(S, nb - 1); ++q) fetch(q);
  }
  // x_{nb-1} = z_{nb-1}
  const size_t last = static_cast<size_t>(nb - 1) * B + row0;
  if (threadIdx.x < rows)
    publish(x + last + threadIdx.x, z[last + threadIdx.x]);
  __syncthreads();  // the mbarriers are initialised

  // z_i on this CTA's rows, loaded one step ahead
  T z_next = T(0);
  if (threadIdx.x < rows && nb > 1) z_next = z[last - B + threadIdx.x];
  for (int q = 0; q < nb - 1; ++q) {
    const size_t vi = static_cast<size_t>(nb - 2 - q) * B;
    T* xc = carry + (q & 1) * B;
    T* zr = own + (q & 1) * R;
    if (threadIdx.x < rows) {
      zr[threadIdx.x] = z_next;
      if (q + 2 < nb) z_next = z[vi - B + row0 + threadIdx.x];
    }
    gather_carry(x + vi + B, xc, B);
    __syncthreads();  // xc and zr complete; every warp is past step q-1
    if (threadIdx.x == kFetcher && q > 0 && q - 1 + S < nb - 1)
      fetch(q - 1 + S);
    mbar_wait(&full[q % S], (q / S) & 1);
    const T* Cr = ring + (q % S) * slab;
    for (int r = warp; r < rows; r += kWarps) {
      const T s = row_dot(Cr + static_cast<size_t>(r) * B, xc, B, lane);
      if (lane == 0) publish(x + vi + row0 + r, zr[r] - s);
    }
  }
}

bool bad_geometry(int nb, int B, int R, int S) {
  return nb < 1 || B < 32 || B % 32 != 0 || R < 1 || R > B ||
         R > kThreads || S < 1 || S > kMaxStages;
}

template <typename K>
cudaError_t cooperative(K kernel, int B, int R, size_t smem, void** args,
                        void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(kernel), dim3((B + R - 1) / R),
      dim3(kThreads), args, smem, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
int launch_fwd(const void* Sinv, const void* L, const void* b, void* t,
               void* z, int nb, int B, int R, int S, void* stream) {
  if (bad_geometry(nb, B, R, S)) return static_cast<int>(cudaErrorInvalidValue);
  const T* a_sinv = static_cast<const T*>(Sinv);
  const T* a_l = static_cast<const T*>(L);
  const T* a_b = static_cast<const T*>(b);
  T* a_t = static_cast<T*>(t);
  T* a_z = static_cast<T*>(z);
  void* args[] = {&a_sinv, &a_l, &a_b, &a_t, &a_z, &nb, &B, &R, &S};
  return static_cast<int>(cooperative(bt_fwd_kernel<T>, B, R,
                                      smem_bytes<T>(2, B, R, S), args,
                                      stream));
}

template <typename T>
int launch_bwd(const void* C, const void* z, void* x, int nb, int B, int R,
               int S, void* stream) {
  if (bad_geometry(nb, B, R, S)) return static_cast<int>(cudaErrorInvalidValue);
  const T* a_c = static_cast<const T*>(C);
  const T* a_z = static_cast<const T*>(z);
  T* a_x = static_cast<T*>(x);
  void* args[] = {&a_c, &a_z, &a_x, &nb, &B, &R, &S};
  return static_cast<int>(cooperative(bt_bwd_kernel<T>, B, R,
                                      smem_bytes<T>(1, B, R, S), args,
                                      stream));
}

}  // namespace

extern "C" {

// z (nb, B) and t (nb, B) must hold kEmpty in every element.
int bt_fwd_sweep_f32(const void* Sinv, const void* L, const void* b, void* t,
                     void* z, int nb, int B, int R, int S, void* stream) {
  return launch_fwd<float>(Sinv, L, b, t, z, nb, B, R, S, stream);
}

int bt_fwd_sweep_f64(const void* Sinv, const void* L, const void* b, void* t,
                     void* z, int nb, int B, int R, int S, void* stream) {
  return launch_fwd<double>(Sinv, L, b, t, z, nb, B, R, S, stream);
}

// x (nb, B) must hold kEmpty in every element.
int bt_bwd_sweep_f32(const void* C, const void* z, void* x, int nb, int B,
                     int R, int S, void* stream) {
  return launch_bwd<float>(C, z, x, nb, B, R, S, stream);
}

int bt_bwd_sweep_f64(const void* C, const void* z, void* x, int nb, int B,
                     int R, int S, void* stream) {
  return launch_bwd<double>(C, z, x, nb, B, R, S, stream);
}

const char* bt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
