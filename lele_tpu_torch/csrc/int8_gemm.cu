// Exact int8 GEMM for Hopper (kernel 11): c[M,N] int32 = a[M,K] int8 @ b[K,N]
// int8, any M, K, N >= 1. Replaces lele_tpu/kernels/quant_matmul.py:
// pallas_int8_matmul.
//
// It is kernel 5's strip core (dq_gemm.cuh: dq_gemm_strip) with the raw
// int32 store for its epilogue and no quantize pass: the A operand is
// already i8 (SenseVoice's dynamic-int8 linears and the MatMulInteger
// emitter shift their u8 codes by -128 before the call).
//  - int8 tensor cores (`mma.sync.m16n8k32`, s8 x s8 -> s32): the sum is
//    exact for |sum| < 2^31 (K < 131,072 at the extremes), as the TPU's i32
//    accumulator is, and the same in any order, so every form gives the
//    plain product's bits.
//  - a block takes 64 MI rows by a 64-column strip of b; its K tiles of 64
//    come through a ring of ST stages whose first ST - 1 are all in flight
//    before the first MMA (all of the block's K at the path's shapes): one
//    thread's TMA boxes (64-byte swizzle, zeros past the edges) completing
//    on mbarriers where a's and b's rows are 16-byte aligned, every
//    thread's 16-byte cp.async otherwise (b's rows unaligned, as the int8
//    head's 25,055 leaves them; a's byte by byte for an odd K). Zeros past
//    M, N or K absorb in the integer dot, as the TPU kernel's zero padding
//    does (quant_matmul.py:368-373).
//  - b stays [k][n] in shared memory; at MI <= 2 the block transposes each
//    tile once ([n][k], 4 x 4 bytes a thread) and every fragment is an
//    ldmatrix, at MI >= 3 each warp transposes its B fragments in registers
//    (more m16 tiles share them).
//  - where the strips and row blocks alone are too few for the 132 SMs, a
//    cluster of S blocks splits K and sums its int32 tiles through
//    distributed shared memory, then stores them by whole row segments.
//  - a programmatic dependent launch: the blocks may start while the kernel
//    ahead of them in the stream finishes (griddepcontrol.wait before the
//    first load, so nothing is read or written early), and let the kernel
//    after them start once their first K tiles are asked for.
// What bounds it on the H100: at the dynamic-int8 linears' shapes
// ([B*T, 512 or 2048] x [512 or 2048, 512..2048]) the bytes of b and of the
// int32 output (one read, one write: 0.8 us for [171,512]x[512,2048] at
// 3.35 TB/s) and, far above them, the chain of one block's latencies
// (launch, first data, ~0.3-0.5 us a K tile at one SM's ~25-45 GB/s from
// L2, the cluster's sum, the stores); at 2,048^3 the int8 tensor-core work
// (8.7 us at 1,979 TOP/s). The parent form (a 64 x 64, 32 x 64 or 32 x 32
// tile, the next K tile fetched one step ahead into registers, no split K)
// waited out a load latency every K step. Times in PERF.md (kernel 11).
#include "dq_gemm.cuh"

namespace {

// ring depth by the block's rows: at most ~100 KB of shared memory
template <int MI>
constexpr int i8_stages() {
  return MI == 1 ? 8 : MI == 2 ? 6 : 4;
}

// a's and b's rows 16-byte aligned: TMA, launched programmatically (it may
// start while the kernel ahead of it finishes, and waits for it before its
// first load); otherwise cp.async
template <int MI>
cudaError_t launch_i8_mi(const int8_t* a, const int8_t* b, int32_t* c, int M, int K, int N,
                         int S, cudaStream_t s) {
  const bool a_vec = K % 16 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0;
  const bool aligned = N % 16 == 0 && reinterpret_cast<uintptr_t>(b) % 16 == 0;
  const lele::DqlSrc src{nullptr, nullptr, nullptr};
  const lele::DqEpilogue ep{nullptr, nullptr, 0.f, nullptr, nullptr, 0, nullptr};
  constexpr int ST = i8_stages<MI>();
  using lele::launch_strip;
  if (a_vec && aligned)
    return launch_strip<MI, ST, true, true, lele::kTma, true>(a, K, true, b, c, M, K, N, src,
                                                               ep, S, s);
  return aligned ? launch_strip<MI, ST, true, true>(a, K, a_vec, b, c, M, K, N, src, ep, S, s)
                 : launch_strip<MI, ST, false, true>(a, K, a_vec, b, c, M, K, N, src, ep, S, s);
}

// one launch with 64 mi rows a block and clusters of S splitting K
cudaError_t launch_i8(const int8_t* a, const int8_t* b, int32_t* c, int M, int K, int N, int mi,
                      int S, cudaStream_t s) {
  switch (mi) {
    case 1: return launch_i8_mi<1>(a, b, c, M, K, N, S, s);
    case 2: return launch_i8_mi<2>(a, b, c, M, K, N, S, s);
    case 3: return launch_i8_mi<3>(a, b, c, M, K, N, S, s);
    default: return launch_i8_mi<4>(a, b, c, M, K, N, S, s);
  }
}

// The block's rows (64 mi) and the cluster's K split S, from a sweep of
// every (mi, S) at the paths' shapes (scripts/torch_port_form_probe.py):
// one row block of 64 a block unless that gives more than two blocks an
// SM; then K split where the blocks are too few for the 132 SMs or a block
// would walk more than 8 K tiles. A cluster costs its sums' syncs (~1 us),
// more than it saves at 8 K tiles a block, and a cluster of 2 never paid.
void i8_config(int M, int K, int N, int& mi, int& S) {
  const int strips = (N + 63) / 64, ktiles = (K + 63) / 64;
  auto blocks = [&](int m) { return strips * ((M + 64 * m - 1) / (64 * m)); };
  mi = 1;
  while (mi < 4 && blocks(mi) > 2 * 132) ++mi;
  const int n = blocks(mi);
  S = n >= 132 ? 1 : n >= 64 ? (ktiles > 8 ? 4 : 1) : n >= 16 ? (ktiles > 8 ? 8 : 4) : 8;
  while (S > ktiles) S /= 2;
}

}  // namespace

// c[M,N] int32 = a[M,K] int8 @ b[K,N] int8, all row-major and contiguous.
// One launch on `stream`; returns cudaGetLastError().
extern "C" int int8_gemm(const void* a, const void* b, void* c, int M, int K, int N,
                         void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return static_cast<int>(cudaGetLastError());
  int mi, S;
  i8_config(M, K, N, mi, S);
  const cudaError_t err =
      launch_i8(static_cast<const int8_t*>(a), static_cast<const int8_t*>(b),
                static_cast<int32_t*>(c), M, K, N, mi, S,
                static_cast<cudaStream_t>(stream));
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}
