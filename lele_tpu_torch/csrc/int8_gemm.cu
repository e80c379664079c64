// Exact int8 GEMM for Hopper (kernel 11): c[M,N] int32 = a[M,K] int8 @ b[K,N]
// int8, any M, K, N >= 1. Replaces lele_tpu/kernels/quant_matmul.py:
// pallas_int8_matmul.
//
// It is dq_gemm.cuh's s8 tile core without the quantize pass and without the
// epilogue: the A operand is already i8 (SenseVoice's dynamic-int8 linears
// and the MatMulInteger emitter shift their u8 codes by -128 before the
// call), and the s32 accumulator is stored as it is.
//  - int8 tensor cores (`mma.sync.m16n8k32`, s8 x s8 -> s32): the sum is
//    exact for |sum| < 2^31 (K < 131,072 at the extremes), as the TPU's i32
//    accumulator is.
//  - one block of 4 warps computes a BM x BN tile over K in steps of 64,
//    fetching the next K tile into registers (16-byte loads) while the
//    tensor cores run; B is staged transposed ([n][k]) so each fragment is
//    one 32-bit shared load.
//  - tiles past M, N or K are filled with zeros on their way into shared
//    memory (zeros absorb in an integer dot), the TPU kernel's zero padding
//    (quant_matmul.py:368-373); stores past M or N are skipped.
//  - the tile (64x64, 32x64 or 32x32) is the largest that still gives the
//    132 SMs enough blocks, as kernel 5 picks it.
// What bounds it on the H100: at the dynamic-int8 linears' shapes
// ([B*T, 512 or 2048] x [512 or 2048, 512..2048]) the bytes of b and of the
// int32 output (one read, one write: 0.8 us for [171,512]x[512,2048] at
// 3.35 TB/s) and the launch; at 2,048^3 the int8 tensor-core work (8.7 us at
// 1,979 TOP/s). Not yet done: a cp.async/TMA pipeline, wgmma, split-K.
#include "dq_gemm.cuh"

namespace lele {

template <int BM, int BN>
__global__ void __launch_bounds__(128)
int8_gemm_mma(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
              int32_t* __restrict__ c, int M, int K, int N) {
  constexpr int BK = 64, LD = BK + 16;
  constexpr int MI = BM / 32, NI = BN / 16;
  constexpr int A_CHUNKS = BM * BK / 16 / 128;  // 16 codes per thread
  constexpr int B_CHUNKS = BK * BN / 16 / 128;  // 16 weights per thread
  static_assert(A_CHUNKS >= 1 && B_CHUNKS >= 1, "tile too small for 128 threads");
  __shared__ __align__(16) int8_t As[BM][LD];  // [m][k]
  __shared__ __align__(16) int8_t Bs[BN][LD];  // [n][k]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int g = lane >> 2, tg = lane & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const bool a_vec = (K % 16 == 0) && (reinterpret_cast<uintptr_t>(a) % 16 == 0);
  const bool b_vec = (N % 16 == 0) && (reinterpret_cast<uintptr_t>(b) % 16 == 0);

  uint4 ra[A_CHUNKS], rb[B_CHUNKS];  // the next tile, raw

  auto load_tile = [&](int k0) {
#pragma unroll
    for (int i = 0; i < A_CHUNKS; ++i) {
      const int q = tid + i * 128, r = q / (BK / 16), cc = (q % (BK / 16)) * 16;
      ra[i] = load_a16(a, m0 + r, k0 + cc, M, K, a_vec);
    }
#pragma unroll
    for (int i = 0; i < B_CHUNKS; ++i) {
      const int q = tid + i * 128, r = q / (BN / 16), cc = (q % (BN / 16)) * 16;
      rb[i] = load_w16(b, k0 + r, n0 + cc, K, N, b_vec);
    }
  };

  auto store_tile = [&]() {
#pragma unroll
    for (int i = 0; i < A_CHUNKS; ++i) {
      const int q = tid + i * 128, r = q / (BK / 16), cc = (q % (BK / 16)) * 16;
      *reinterpret_cast<uint4*>(&As[r][cc]) = ra[i];
    }
#pragma unroll
    for (int i = 0; i < B_CHUNKS; ++i) {
      const int q = tid + i * 128, r = q / (BN / 16), cc = (q % (BN / 16)) * 16;
      const int8_t* v = reinterpret_cast<const int8_t*>(&rb[i]);
#pragma unroll
      for (int e = 0; e < 16; ++e) Bs[cc + e][r] = v[e];
    }
  };

  int acc[MI][NI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

  load_tile(0);
  store_tile();
  __syncthreads();
  for (int k0 = 0; k0 < K; k0 += BK) {
    const bool has_next = k0 + BK < K;
    if (has_next) load_tile(k0 + BK);  // in flight during the MMAs below
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t fa[MI][4], fb[NI][2];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const int r = wm * (BM / 2) + mi * 16 + g;
        fa[mi][0] = *reinterpret_cast<const uint32_t*>(&As[r][kk + tg * 4]);
        fa[mi][1] = *reinterpret_cast<const uint32_t*>(&As[r + 8][kk + tg * 4]);
        fa[mi][2] = *reinterpret_cast<const uint32_t*>(&As[r][kk + 16 + tg * 4]);
        fa[mi][3] = *reinterpret_cast<const uint32_t*>(&As[r + 8][kk + 16 + tg * 4]);
      }
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int n = wn * (BN / 2) + ni * 8 + g;
        fb[ni][0] = *reinterpret_cast<const uint32_t*>(&Bs[n][kk + tg * 4]);
        fb[ni][1] = *reinterpret_cast<const uint32_t*>(&Bs[n][kk + 16 + tg * 4]);
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) mma_s8_16832(acc[mi][ni], fa[mi], fb[ni]);
    }
    __syncthreads();
    if (has_next) {
      store_tile();
      __syncthreads();
    }
  }

  // each thread holds column pairs (c, c + 1) of rows r and r + 8
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      const int r = m0 + wm * (BM / 2) + mi * 16 + g;
      const int col = n0 + wn * (BN / 2) + ni * 8 + tg * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = r + h * 8;
        if (m >= M || col >= N) continue;
        int32_t* dst = c + (size_t)m * N + col;
        if (col + 1 < N && (reinterpret_cast<uintptr_t>(dst) % 8 == 0)) {
          *reinterpret_cast<int2*>(dst) = make_int2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
        } else {
          dst[0] = acc[mi][ni][2 * h];
          if (col + 1 < N) dst[1] = acc[mi][ni][2 * h + 1];
        }
      }
    }
  }
}

}  // namespace lele

// c[M,N] int32 = a[M,K] int8 @ b[K,N] int8, all row-major and contiguous.
// Launches on `stream`; returns cudaGetLastError().
extern "C" int int8_gemm(const void* a, const void* b, void* c, int M, int K, int N,
                         void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return static_cast<int>(cudaGetLastError());
  const auto* ap = static_cast<const int8_t*>(a);
  const auto* bp = static_cast<const int8_t*>(b);
  auto* cp = static_cast<int32_t*>(c);
  const auto s = static_cast<cudaStream_t>(stream);
  auto blocks = [&](int bm, int bn) { return ((M + bm - 1) / bm) * ((N + bn - 1) / bn); };
  if (blocks(64, 64) >= 2 * 132) {
    lele::int8_gemm_mma<64, 64><<<dim3((N + 63) / 64, (M + 63) / 64), 128, 0, s>>>(
        ap, bp, cp, M, K, N);
  } else if (blocks(32, 64) >= 132) {
    lele::int8_gemm_mma<32, 64><<<dim3((N + 63) / 64, (M + 31) / 32), 128, 0, s>>>(
        ap, bp, cp, M, K, N);
  } else {
    lele::int8_gemm_mma<32, 32><<<dim3((N + 31) / 32, (M + 31) / 32), 128, 0, s>>>(
        ap, bp, cp, M, K, N);
  }
  return static_cast<int>(cudaGetLastError());
}
