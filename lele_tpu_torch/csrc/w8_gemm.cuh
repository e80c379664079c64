// w8a16 GEMM for Hopper: y[M,N] = (x[M,K] @ int8 W[K,N]) * scale[N], with an
// optional fused epilogue (bias, ReLU, residual add). Shared by w8_gemm.cu
// (the CTC head) and sanm_layer.cu (the four linears of a SAN-M layer);
// sanm_stack.cu takes its mma helpers and epilogue.
//
// Replaces lele_tpu/kernels/quant_matmul.py:w8_matmul_pallas and the `_w8dot`
// of lele_tpu/kernels/sanm_block.py.
//
// What bounds it on the H100: at the main path's shapes (M = T ~ 20..1000
// rows, K = 512/2048, N = 512..25055) the GEMM is skinny. Weights stream at
// one byte per element, and at M <= ~300 the int8 weight stream and the
// launch, not the tensor cores, set the floor; what sets the time today is
// each block's serial walk over K, one global-load latency per step, on too
// few blocks to hide it. The design:
//  - bf16 operands (x as bf16, or f32 rounded to bf16 on the way into shared
//    memory) run on the tensor cores through `mma.sync.m16n8k16` with f32
//    accumulation; int8 is converted to bf16 in registers (exact: |q| <= 127).
//  - f32 operands run as true f32 FMA on the SIMT cores, matching JAX's
//    Precision.HIGHEST.
//  - one block computes a BM x BN output tile (64 or 32 each: the largest that
//    still fills the 132 SMs) over K in steps of 64, fetching the next K tile
//    into registers with 16-byte loads while the tensor cores run.
//  - ragged M, K and N are masked at the tile edges; rows of an odd N (the
//    CTC head's 25,055) are read as aligned words and shifted into place.
// Not yet done (a later change): a deeper cp.async/TMA pipeline, split-K
// for the N = 512 linears, wgmma.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

extern "C" const char* lele_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

namespace lele {

// how the A operand (x) is read
enum AMode : int {
  A_F32 = 0,          // f32, multiplied in full f32
  A_BF16 = 1,         // bf16
  A_F32_AS_BF16 = 2,  // f32 in memory, rounded to bf16 (JAX's .astype(bf16))
};

struct Epilogue {
  const float* scale;  // [N] per-output-channel dequant scale
  const float* bias;   // [N] or null
  const float* res;    // [M, N] or null; may alias y (read before the write)
  int relu;            // ReLU after bias, before the residual
};

__device__ __forceinline__ float epilogue(float acc, int m, int n, int N,
                                          const Epilogue& ep) {
  float v = acc * ep.scale[n];
  if (ep.bias) v += ep.bias[n];
  if (ep.relu) v = fmaxf(v, 0.f);
  if (ep.res) v = ep.res[(size_t)m * N + n] + v;
  return v;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ uint16_t bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

__device__ __forceinline__ uint32_t ld_pair(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// B fragment of m16n8k16 from a [k][n] tile: lanes 0-15 address rows k..k+15
__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2], const uint16_t* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Tensor-core path. 4 warps in a 2 x 2 layout; each warp owns a
// (BM/2) x (BN/2) sub-tile: BM/32 m16 tiles by BN/16 n8 tiles. K advances in
// steps of 64. The next K tile is fetched into registers (16-byte loads where
// the row is aligned, element loads at a ragged edge) while the tensor cores
// work on the current one in shared memory. A is stored [m][k] and read as
// 32-bit pairs; B is stored [k][n] and read with ldmatrix.trans. Rows are
// padded by 8 elements (144-byte stride): fragment reads are conflict free.
template <int BM, int BN, typename AT>
__global__ void __launch_bounds__(128)
w8_gemm_mma(const AT* __restrict__ x, const int8_t* __restrict__ w, float* y,
            int M, int K, int N, Epilogue ep) {
  constexpr int BK = 64, LDA = BK + 8, LDB = BN + 8;
  constexpr int MI = BM / 32, NI = BN / 16;
  constexpr int A_VEC = 16 / sizeof(AT);            // elements per 16-byte chunk
  constexpr int A_CHUNKS = BM * BK / A_VEC / 128;   // chunks per thread
  constexpr int B_CHUNKS = BK * BN / 16 / 128;
  static_assert(A_CHUNKS >= 1 && B_CHUNKS >= 1, "tile too small for 128 threads");
  __shared__ __align__(16) uint16_t As[BM][LDA];  // [m][k], bf16 bits
  __shared__ __align__(16) uint16_t Bs[BK][LDB];  // [k][n], bf16 bits
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int g = lane >> 2, tg = lane & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const bool a_vec = (K % A_VEC == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  const bool b_vec = (N % 16 == 0) && (reinterpret_cast<uintptr_t>(w) % 16 == 0);

  uint4 ra[A_CHUNKS], rb[B_CHUNKS];  // the next tile, raw

  auto load_tile = [&](int k0) {
#pragma unroll
    for (int i = 0; i < A_CHUNKS; ++i) {
      const int c = tid + i * 128, r = c / (BK / A_VEC), cc = (c % (BK / A_VEC)) * A_VEC;
      const int gm = m0 + r, gk = k0 + cc;
      if (gm < M && a_vec && gk + A_VEC <= K) {
        ra[i] = *reinterpret_cast<const uint4*>(x + (size_t)gm * K + gk);
      } else {
        __align__(16) AT v[A_VEC];
#pragma unroll
        for (int e = 0; e < A_VEC; ++e)
          v[e] = (gm < M && gk + e < K) ? x[(size_t)gm * K + gk + e] : AT(0.f);
        ra[i] = *reinterpret_cast<const uint4*>(v);
      }
    }
#pragma unroll
    for (int i = 0; i < B_CHUNKS; ++i) {
      const int c = tid + i * 128, r = c / (BN / 16), cc = (c % (BN / 16)) * 16;
      const int gk = k0 + r, gn = n0 + cc;
      const size_t off = (size_t)gk * N + gn;
      if (gk < K && b_vec && gn + 16 <= N) {
        rb[i] = *reinterpret_cast<const uint4*>(w + off);
      } else if (gk < K && gn + 16 <= N && off + 20 <= (size_t)K * N) {
        // an unaligned row (odd N, as the CTC head's 25,055): five aligned
        // words, shifted into place
        const uintptr_t a = reinterpret_cast<uintptr_t>(w + off);
        const uint32_t* wd = reinterpret_cast<const uint32_t*>(a & ~uintptr_t(3));
        const unsigned sh = (a & 3) * 8;
        uint32_t u[5];
#pragma unroll
        for (int e = 0; e < 5; ++e) u[e] = wd[e];
        rb[i] = make_uint4(__funnelshift_r(u[0], u[1], sh), __funnelshift_r(u[1], u[2], sh),
                           __funnelshift_r(u[2], u[3], sh), __funnelshift_r(u[3], u[4], sh));
      } else {
        __align__(16) int8_t v[16];
#pragma unroll
        for (int e = 0; e < 16; ++e)
          v[e] = (gk < K && gn + e < N) ? w[(size_t)gk * N + gn + e] : int8_t(0);
        rb[i] = *reinterpret_cast<const uint4*>(v);
      }
    }
  };

  auto store_tile = [&]() {
#pragma unroll
    for (int i = 0; i < A_CHUNKS; ++i) {
      const int c = tid + i * 128, r = c / (BK / A_VEC), cc = (c % (BK / A_VEC)) * A_VEC;
      if constexpr (sizeof(AT) == 4) {
        const float* f = reinterpret_cast<const float*>(&ra[i]);
        uint2 packed;
        packed.x = bf16_bits(f[0]) | (uint32_t(bf16_bits(f[1])) << 16);
        packed.y = bf16_bits(f[2]) | (uint32_t(bf16_bits(f[3])) << 16);
        *reinterpret_cast<uint2*>(&As[r][cc]) = packed;
      } else {
        *reinterpret_cast<uint4*>(&As[r][cc]) = ra[i];
      }
    }
#pragma unroll
    for (int i = 0; i < B_CHUNKS; ++i) {
      const int c = tid + i * 128, r = c / (BN / 16), cc = (c % (BN / 16)) * 16;
      const int8_t* q = reinterpret_cast<const int8_t*>(&rb[i]);
      uint32_t h[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        h[e] = bf16_bits(static_cast<float>(q[2 * e])) |
               (uint32_t(bf16_bits(static_cast<float>(q[2 * e + 1]))) << 16);
      *reinterpret_cast<uint4*>(&Bs[r][cc]) = make_uint4(h[0], h[1], h[2], h[3]);
      *reinterpret_cast<uint4*>(&Bs[r][cc + 8]) = make_uint4(h[4], h[5], h[6], h[7]);
    }
  };

  float acc[MI][NI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  load_tile(0);
  store_tile();
  __syncthreads();
  for (int k0 = 0; k0 < K; k0 += BK) {
    const bool has_next = k0 + BK < K;
    if (has_next) load_tile(k0 + BK);  // in flight during the MMAs below
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[MI][4], b[NI][2];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const int r = wm * (BM / 2) + mi * 16 + g;
        a[mi][0] = ld_pair(&As[r][kk + tg * 2]);
        a[mi][1] = ld_pair(&As[r + 8][kk + tg * 2]);
        a[mi][2] = ld_pair(&As[r][kk + tg * 2 + 8]);
        a[mi][3] = ld_pair(&As[r + 8][kk + tg * 2 + 8]);
      }
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
        ldsm_x2_trans(b[ni], &Bs[kk + (lane & 15)][wn * (BN / 2) + ni * 8]);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) mma_bf16_16816(acc[mi][ni], a[mi], b[ni]);
    }
    __syncthreads();
    if (has_next) {
      store_tile();
      __syncthreads();
    }
  }

#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      const int r = m0 + wm * (BM / 2) + mi * 16 + g;
      const int c = n0 + wn * (BN / 2) + ni * 8 + tg * 2;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = r + (e >> 1) * 8, n = c + (e & 1);
        if (m < M && n < N) y[(size_t)m * N + n] = epilogue(acc[mi][ni][e], m, n, N, ep);
      }
    }
  }
}

// f32 path: true f32 FMA, 64 x 64 tile, 256 threads with 4 x 4 outputs each
// (strided by 16 so shared reads and global stores stay coalesced).
__global__ void __launch_bounds__(256)
w8_gemm_f32(const float* __restrict__ x, const int8_t* __restrict__ w, float* y,
            int M, int K, int N, Epilogue ep) {
  constexpr int BM = 64, BN = 64, BK = 16;
  __shared__ float As[BK][BM + 4];  // [k][m]
  __shared__ float Bs[BK][BN];      // [k][n]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = tid; i < BM * BK; i += 256) {
      const int r = i / BK, c = i % BK, gm = m0 + r, gk = k0 + c;
      As[c][r] = (gm < M && gk < K) ? x[(size_t)gm * K + gk] : 0.f;
    }
    for (int i = tid; i < BK * BN; i += 256) {
      const int r = i / BN, c = i % BN, gk = k0 + r, gn = n0 + c;
      Bs[r][c] = (gk < K && gn < N) ? static_cast<float>(w[(size_t)gk * N + gn]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + ty + 16 * i, n = n0 + tx + 16 * j;
      if (m < M && n < N) y[(size_t)m * N + n] = epilogue(acc[i][j], m, n, N, ep);
    }
}

template <typename AT>
inline void launch_w8_gemm_mma(const AT* x, const int8_t* w, float* y, int M, int K,
                               int N, const Epilogue& ep, cudaStream_t s) {
  // the largest tile that still gives the 132 SMs enough blocks
  auto blocks = [&](int bm, int bn) { return ((M + bm - 1) / bm) * ((N + bn - 1) / bn); };
  if (blocks(64, 64) >= 2 * 132) {
    w8_gemm_mma<64, 64, AT><<<dim3((N + 63) / 64, (M + 63) / 64), 128, 0, s>>>(
        x, w, y, M, K, N, ep);
  } else if (blocks(32, 64) >= 132) {
    w8_gemm_mma<32, 64, AT><<<dim3((N + 63) / 64, (M + 31) / 32), 128, 0, s>>>(
        x, w, y, M, K, N, ep);
  } else {
    w8_gemm_mma<32, 32, AT><<<dim3((N + 31) / 32, (M + 31) / 32), 128, 0, s>>>(
        x, w, y, M, K, N, ep);
  }
}

inline void launch_w8_gemm(const void* x, int amode, const int8_t* w, float* y, int M,
                           int K, int N, const Epilogue& ep, cudaStream_t s) {
  if (M == 0 || N == 0) return;
  switch (amode) {
    case A_F32:
      w8_gemm_f32<<<dim3((N + 63) / 64, (M + 63) / 64), 256, 0, s>>>(
          static_cast<const float*>(x), w, y, M, K, N, ep);
      break;
    case A_BF16:
      launch_w8_gemm_mma(static_cast<const __nv_bfloat16*>(x), w, y, M, K, N, ep, s);
      break;
    default:
      launch_w8_gemm_mma(static_cast<const float*>(x), w, y, M, K, N, ep, s);
      break;
  }
}

}  // namespace lele
