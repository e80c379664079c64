// Pieces shared by the persistent stack kernels, each one cooperative launch
// that walks its layers as grid-wide phases between grid barriers:
// sanm_stack.cu (kernels 1 and 8) and sanm_dql.cu (kernel 4). 128 threads a
// CTA; cp.async.cg stages (data written in an
// earlier phase is read through L2, never the non-coherent or L1 paths); a
// row of LayerNorm a warp; the arguments in shared memory, the grid barriers
// and the phase timer; a GEMM tile's cp.async ring and the arrival count
// that picks the last split of a tile (or part of an item) to arrive, which
// merges the others' partial sums in a fixed order; the scratch's layout;
// the cooperative launch.
#pragma once

#include <cooperative_groups.h>
#include <math.h>

#include "w8_gemm.cuh"

namespace lele {
namespace stk {

namespace cg = cooperative_groups;

constexpr int THREADS = 128;
constexpr float LN_EPS = 1e-12f;

__device__ __forceinline__ long long globaltimer() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void wait_groups() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 16 bytes into shared dst: of src, the first nbytes (the rest zero)
__device__ __forceinline__ void copy16(void* dst, const void* src, int nbytes) {
  if (nbytes >= 16 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    cp_async16(dst, src);
  } else if (nbytes <= 0) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  } else {
    __align__(16) unsigned char v[16];
    const unsigned char* s = static_cast<const unsigned char*>(src);
#pragma unroll
    for (int e = 0; e < 16; ++e) v[e] = e < nbytes ? __ldcg(s + e) : 0;
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
  }
}

// bytes at p into L2, a share of them for each of nparts CTAs
__device__ __forceinline__ void prefetch_l2(const void* p, long long bytes, int part,
                                            int nparts) {
  if (!p) return;
  const char* c = static_cast<const char*>(p);
  for (long long i = ((long long)part * THREADS + threadIdx.x) * 128; i < bytes;
       i += (long long)nparts * THREADS * 128)
    asm volatile("prefetch.global.L2 [%0];\n" ::"l"(c + i));
}

// a row's values sit in the 4 neighbouring lanes of one quad
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// One row of LN(x) (eps 1e-12) as bf16, by one warp, in the order of a
// 128-thread block (csrc/sanm_layer.cu layer_norm_rows: 128 threads sum
// strided elements, a butterfly in each warp, the four warps' sums in order,
// two-pass variance); lane l plays threads l, 32 + l, 64 + l and 96 + l.
// Every load is issued before any store.
__device__ __forceinline__ void ln_row(uint16_t* dst, const float* xr, int D, const float* g,
                                       const float* b) {
  const int lane = threadIdx.x & 31;
  constexpr int R = 32;  // values a lane holds (D <= 1024); the rest are read again
  float xv[R], gv[R], bv[R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int i = lane + 32 * j;
    xv[j] = i < D ? __ldcg(xr + i) : 0.f;
    gv[j] = i < D ? __ldg(g + i) : 0.f;
    bv[j] = i < D ? __ldg(b + i) : 0.f;
  }
  float s[4], s2[4];
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    s[v] = 0.f;
#pragma unroll
    for (int j = v; j < R; j += 4)
      if (lane + 32 * j < D) s[v] += xv[j];
    for (int j = v + R; lane + 32 * j < D; j += 4) s[v] += __ldcg(xr + lane + 32 * j);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s[v] += __shfl_xor_sync(0xffffffffu, s[v], o);
  }
  const float mu = (s[0] + s[1] + s[2] + s[3]) / D;
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    s2[v] = 0.f;
#pragma unroll
    for (int j = v; j < R; j += 4)
      if (lane + 32 * j < D) {
        const float d = xv[j] - mu;
        s2[v] += d * d;
      }
    for (int j = v + R; lane + 32 * j < D; j += 4) {
      const float d = __ldcg(xr + lane + 32 * j) - mu;
      s2[v] += d * d;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s2[v] += __shfl_xor_sync(0xffffffffu, s2[v], o);
  }
  const float r = rsqrtf((s2[0] + s2[1] + s2[2] + s2[3]) / D + LN_EPS);
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int i = lane + 32 * j;
    if (i < D) dst[i] = bf16_bits((xv[j] - mu) * r * gv[j] + bv[j]);
  }
  for (int i = lane + 32 * R; i < D; i += 32)
    dst[i] = bf16_bits((__ldcg(xr + i) - mu) * r * g[i] + b[i]);
}

// ---------------------------------------------------------------------------
// The kernel's frame: its arguments, the grid barriers and the phase timer

// The kernel's one argument copied into the kernel's __shared__ `a`: the
// phases take it by reference (a reference to the kernel parameter itself
// would copy it to each thread's local memory), and every thread reads it
// from shared memory.
template <typename A>
__device__ __forceinline__ void load_args(A& a, const A& args) {
  if (threadIdx.x == 0) a = args;
  __syncthreads();
}

constexpr int DETAIL = 16;  // timer stamps a phase

// The phase timer, off unless the trace is given: trace holds P n + 1 + P
// DETAIL int64 (n layers of P phases): the global timer (ns) at the start
// and after each phase's grid barrier (CTA 0 reads it), then, for layer 1 in
// CTA 0, DETAIL stamps inside each phase's first work item.
struct PhaseTimer {
  long long* trace;
  int P, n;
  bool on;
  __device__ PhaseTimer(long long* t, int phases, int layers)
      : trace(t), P(phases), n(layers), on(t && blockIdx.x == 0 && threadIdx.x == 0) {}
  __device__ __forceinline__ void start() {
    if (on) trace[0] = globaltimer();
  }
  // a grid barrier, then the time after it in entry k
  __device__ __forceinline__ void sync(cg::grid_group& grid, int k) {
    grid.sync();
    if (on) trace[k] = globaltimer();
  }
};

// stamp k of phase p of layer l: kept for layer 1, CTA 0, its first item
__device__ __forceinline__ void stamp_at(long long* trace, int P, int n, int l, int p, int k,
                                         bool first) {
  if (trace && l == 1 && first && blockIdx.x == 0 && threadIdx.x == 0 && k < DETAIL)
    trace[P * n + 1 + p * DETAIL + k] = globaltimer();
}

// ---------------------------------------------------------------------------
// GEMM tiles: the cp.async ring, the split-K arrival count

// A STAGES-slot cp.async ring over a tile's nsteps k steps; issue(s) fills
// slot s % STAGES with step s's data. ring_prime issues the first STAGES - 1
// steps; ring_next(step) waits until step's data (and, with LAG 3, step +
// 1's) has landed and every warp is done with step - 1's slot, then issues
// step + STAGES - 1: one barrier a step.
template <int STAGES, typename Issue>
__device__ __forceinline__ void ring_prime(int nsteps, Issue&& issue) {
#pragma unroll 1
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nsteps) issue(s);
    commit();
  }
}
template <int STAGES, int LAG = 2, typename Issue>
__device__ __forceinline__ void ring_next(int step, int nsteps, Issue&& issue) {
  wait_groups<STAGES - LAG>();
  __syncthreads();
  const int nx = step + STAGES - 1;
  if (nx < nsteps) issue(nx);
  commit();
}

// The last of n CTAs to arrive at *cnt (which it resets to 0 for the next
// use): every thread's earlier stores are visible to it.
__device__ __forceinline__ bool last_to_arrive(int* cnt, int n) {
  __threadfence();
  __syncthreads();
  __shared__ int last;
  if (threadIdx.x == 0) {
    last = atomicAdd(cnt, 1) == n - 1;
    if (last) *cnt = 0;
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// ---------------------------------------------------------------------------
// The launch

// Offsets of consecutive scratch buffers of the given byte sizes, each on a
// 256-byte boundary (off may be null); returns the bytes of them all.
template <int N>
inline size_t carve(const size_t (&sizes)[N], size_t* off) {
  size_t o = 0;
  for (int i = 0; i < N; ++i) {
    if (off) off[i] = o;
    o += (sizes[i] + 255) & ~size_t(255);
  }
  return o;
}

// Dynamic shared memory of a kernel: the larger of its GEMM phases' and its
// attention's at head dim hd (AT<HD>::BYTES)
template <template <int> class AT>
inline int smem_for(int gemm, int hd) {
  const int attn = hd == 32 ? AT<32>::BYTES : hd == 64 ? AT<64>::BYTES : AT<128>::BYTES;
  return gemm > attn ? gemm : attn;
}

// One cooperative launch of `kern` (THREADS a CTA, `smem` bytes of dynamic
// shared memory) with the one argument *args, up to max_per_sm CTAs on each
// SM: as many as can be co-resident, or the launch is refused.
template <typename A>
inline int launch_cooperative(void (*kern)(A), const A* args, int smem, int max_per_sm,
                              cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, THREADS, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  void* params[] = {const_cast<A*>(args)};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kern),
                                  dim3(sms * (per_sm < max_per_sm ? per_sm : max_per_sm)),
                                  dim3(THREADS), params, smem, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace stk
}  // namespace lele
