// Dynamic-quantized int8 GEMM for Hopper, with exact ONNX
// DynamicQuantizeLinear semantics:
//
//   y[M,N] = ((q(x) - 128) @ w - (zp - 128) * colsum) * (scale * ws[n]) (+ bias[n])
//            (ReLU) (+ res[M,N])
//   q(x)   = clamp(round_half_even(x / scale) + zp, 0, 255)
//
// x f32 [M,K]; w int8 [K,N] (u8 weights shifted by -128 at trace time);
// colsum int32 [N] = sum over k of w. Shared by dq_gemm.cu (the CTC head,
// kernel 5) and sanm_dql.cu (the four linears of a SAN-M layer, kernel 4).
//
// Replaces lele_tpu/kernels/quant_matmul.py:fused_dq_matmul_pallas and the
// `_dql_dot` of lele_tpu/kernels/sanm_block.py.
//
// The activation's scale and zero point come either from two device scalars
// (kernel 5: dql_scale_zp ran before it; no host round trip), or from the
// running max(x, 0) / max(-x, 0) pair its producer wrote with atomics
// (kernel 4), from which every block derives the same scale and zero point.
// Quantization divides by the scale (ONNX, and the JAX jnp path); the Pallas
// kernel multiplies by 1/scale, which lands one code off at rounding
// boundaries. rintf rounds half to even, as ONNX and torch.round do. The
// epilogue uses _rn intrinsics, so no multiply-add is contracted and the
// result is the plain version's, bit for bit, for the same scale and zp.
//
// What bounds it on the H100: at the main path's shapes (M = T ~ 36..196
// rows, K = 512/2048, N = 512..25055) the product is skinny. The int8 weights
// stream once (the CTC head: 12.8 MB) and, for the head, the f32 output
// (19.6 MB) is the larger stream: ~9.8 us at 3.35 TB/s, against ~2.5 us of
// int8 tensor-core work at 1,979 TOP/s. The design:
//  - f32 x is quantized to i8 codes once, by a pass over all of x on every
//    SM (`dql_quantize`, one IEEE division per element), into a scratch
//    buffer the caller gives; the GEMM then streams codes, a quarter of the
//    f32 bytes. (Quantizing inside the GEMM's tile loop, the first version,
//    repeated each division in every column block, N / BN times, on the few
//    warps a skinny GEMM has, and cost 3x the time.)
//  - int8 tensor cores (`mma.sync.m16n8k32`, s8 x s8 -> s32): the sum is
//    exact; the zero-point correction is one int per output.
//  - one block computes a BM x BN tile over K in steps of 64, fetching the
//    next K tile into registers (16-byte loads) while the tensor cores run.
//  - weights are staged transposed ([n][k]) so each B fragment is one 32-bit
//    shared load; rows of an odd N (the head's 25,055) are read as aligned
//    words and shifted into place, as w8_gemm.cuh does.
// Not yet done (a later change): a cp.async/TMA pipeline, wgmma, split-K
// for the N = 512 linears.
#pragma once

#include <math.h>

#include <algorithm>

#include "w8_gemm.cuh"

namespace lele {

// where a GEMM finds its activation's quantization parameters
struct DqlSrc {
  const float* scale;  // device scalar, or null
  const float* zp;     // device scalar, or null
  const int* minmax;   // [2]: bits of max(x, 0) and max(-x, 0), or null
};

// what the epilogue adds, and where it reports its output's range
struct DqEpilogue {
  const int* colsum;   // [N]
  const float* ws;     // [N] per-output-channel weight scale, or null
  float w_scale;       // the weight scale when ws is null
  const float* bias;   // [N] or null
  const float* res;    // [M, N] or null; may alias y (read before the write)
  int relu;
  int* minmax_out;     // [2]: the output's max(v, 0) / max(-v, 0), or null
};

// ONNX DQL: x_min = min(x, 0), x_max = max(x, 0), scale = (x_max - x_min)
// / 255, zp = round(clip(-x_min / scale, 0, 255)); scale 1 for zeros
__device__ __forceinline__ void dql_params(const DqlSrc& s, float& scale, float& safe,
                                           float& zp) {
  if (s.minmax) {
    const float x_max = __int_as_float(s.minmax[0]);
    const float x_min = -__int_as_float(s.minmax[1]);
    scale = __fdiv_rn(__fsub_rn(x_max, x_min), 255.f);
    safe = scale == 0.f ? 1.f : scale;
    zp = rintf(fminf(fmaxf(__fdiv_rn(-x_min, safe), 0.f), 255.f));
  } else {
    scale = *s.scale;
    safe = scale == 0.f ? 1.f : scale;
    zp = *s.zp;
  }
}

// the i8 code (q - 128) of one activation
__device__ __forceinline__ uint32_t dql_code(float x, float safe, float zp) {
  const float q = fminf(fmaxf(__fadd_rn(rintf(__fdiv_rn(x, safe)), zp), 0.f), 255.f);
  return static_cast<uint32_t>(static_cast<int>(q) - 128) & 0xffu;
}

// q[i] = the i8 code of x[i], n elements; 4 a thread, grid-stride
__global__ void __launch_bounds__(256)
dql_quantize(const float* __restrict__ x, int8_t* __restrict__ q, size_t n, DqlSrc src) {
  float scale, safe, zp;
  dql_params(src, scale, safe, zp);
  const size_t n4 = n / 4;
  const bool vec = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(q) % 4 == 0);
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * blockDim.x) {
    float4 v;
    if (vec) {
      v = reinterpret_cast<const float4*>(x)[i];
    } else {
      v = make_float4(x[4 * i], x[4 * i + 1], x[4 * i + 2], x[4 * i + 3]);
    }
    const uint32_t packed = dql_code(v.x, safe, zp) | (dql_code(v.y, safe, zp) << 8) |
                            (dql_code(v.z, safe, zp) << 16) | (dql_code(v.w, safe, zp) << 24);
    if (vec) {
      reinterpret_cast<uint32_t*>(q)[i] = packed;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) q[4 * i + e] = static_cast<int8_t>((packed >> (8 * e)) & 0xffu);
    }
  }
  if (blockIdx.x == 0 && threadIdx.x < n % 4) {
    const size_t i = 4 * n4 + threadIdx.x;
    q[i] = static_cast<int8_t>(dql_code(x[i], safe, zp));
  }
}

// a non-negative float's bits order like ints: atomicMax keeps the range
__device__ __forceinline__ void range_update(float v, float& pos, float& neg) {
  pos = fmaxf(pos, v);
  neg = fmaxf(neg, -v);
}

__device__ __forceinline__ void range_commit(float pos, float neg, int* mm) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    pos = fmaxf(pos, __shfl_xor_sync(0xffffffffu, pos, o));
    neg = fmaxf(neg, __shfl_xor_sync(0xffffffffu, neg, o));
  }
  if ((threadIdx.x & 31) == 0) {
    if (pos > 0.f) atomicMax(mm, __float_as_int(pos));
    if (neg > 0.f) atomicMax(mm + 1, __float_as_int(neg));
  }
}

__device__ __forceinline__ void mma_s8_16832(int (&d)[4], const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16 i8 codes a[m][k0 .. k0+15] (zeros past M or K)
__device__ __forceinline__ uint4 load_a16(const int8_t* __restrict__ a, int m, int k0,
                                          int M, int K, bool aligned) {
  const size_t off = (size_t)m * K + k0;
  if (m < M && aligned && k0 + 16 <= K) return *reinterpret_cast<const uint4*>(a + off);
  __align__(16) int8_t v[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) v[e] = (m < M && k0 + e < K) ? a[off + e] : int8_t(0);
  return *reinterpret_cast<const uint4*>(v);
}

// 16 weights w[k][n0 .. n0+15] (zeros past N or K)
__device__ __forceinline__ uint4 load_w16(const int8_t* __restrict__ w, int k, int n0,
                                          int K, int N, bool aligned) {
  const size_t off = (size_t)k * N + n0;
  if (k < K && aligned && n0 + 16 <= N) return *reinterpret_cast<const uint4*>(w + off);
  if (k < K && n0 + 16 <= N && off + 20 <= (size_t)K * N) {
    // an unaligned row (odd N): five aligned words, shifted into place
    const uintptr_t a = reinterpret_cast<uintptr_t>(w + off);
    const uint32_t* wd = reinterpret_cast<const uint32_t*>(a & ~uintptr_t(3));
    const unsigned sh = (a & 3) * 8;
    uint32_t u[5];
#pragma unroll
    for (int e = 0; e < 5; ++e) u[e] = wd[e];
    return make_uint4(__funnelshift_r(u[0], u[1], sh), __funnelshift_r(u[1], u[2], sh),
                      __funnelshift_r(u[2], u[3], sh), __funnelshift_r(u[3], u[4], sh));
  }
  __align__(16) int8_t v[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) v[e] = (k < K && n0 + e < N) ? w[off + e] : int8_t(0);
  return *reinterpret_cast<const uint4*>(v);
}

// 4 warps in a 2 x 2 layout; each warp owns a (BM/2) x (BN/2) sub-tile of
// BM/32 m16 tiles by BN/16 n8 tiles. K advances in steps of 64 (two k32 MMA
// steps). Shared rows are padded to 80 bytes: fragment reads are conflict free.
template <int BM, int BN>
__global__ void __launch_bounds__(128)
dq_gemm_mma(const int8_t* __restrict__ a, const int8_t* __restrict__ w, float* y, int M,
            int K, int N, DqlSrc src, DqEpilogue ep) {
  constexpr int BK = 64, LD = BK + 16;
  constexpr int MI = BM / 32, NI = BN / 16;
  constexpr int A_CHUNKS = BM * BK / 16 / 128;  // 16 codes per thread
  constexpr int B_CHUNKS = BK * BN / 16 / 128;  // 16 weights per thread
  static_assert(A_CHUNKS >= 1 && B_CHUNKS >= 1, "tile too small for 128 threads");
  __shared__ __align__(16) int8_t As[BM][LD];  // [m][k], i8 codes
  __shared__ __align__(16) int8_t Bs[BN][LD];  // [n][k]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int g = lane >> 2, tg = lane & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const bool a_vec = (K % 16 == 0) && (reinterpret_cast<uintptr_t>(a) % 16 == 0);
  const bool b_vec = (N % 16 == 0) && (reinterpret_cast<uintptr_t>(w) % 16 == 0);
  float scale, safe, zp;
  dql_params(src, scale, safe, zp);

  uint4 ra[A_CHUNKS], rb[B_CHUNKS];  // the next tile, raw

  auto load_tile = [&](int k0) {
#pragma unroll
    for (int i = 0; i < A_CHUNKS; ++i) {
      const int c = tid + i * 128, r = c / (BK / 16), cc = (c % (BK / 16)) * 16;
      ra[i] = load_a16(a, m0 + r, k0 + cc, M, K, a_vec);
    }
#pragma unroll
    for (int i = 0; i < B_CHUNKS; ++i) {
      const int c = tid + i * 128, r = c / (BN / 16), cc = (c % (BN / 16)) * 16;
      rb[i] = load_w16(w, k0 + r, n0 + cc, K, N, b_vec);
    }
  };

  auto store_tile = [&]() {
#pragma unroll
    for (int i = 0; i < A_CHUNKS; ++i) {
      const int c = tid + i * 128, r = c / (BK / 16), cc = (c % (BK / 16)) * 16;
      *reinterpret_cast<uint4*>(&As[r][cc]) = ra[i];
    }
#pragma unroll
    for (int i = 0; i < B_CHUNKS; ++i) {
      const int c = tid + i * 128, r = c / (BN / 16), cc = (c % (BN / 16)) * 16;
      const int8_t* q = reinterpret_cast<const int8_t*>(&rb[i]);
#pragma unroll
      for (int e = 0; e < 16; ++e) Bs[cc + e][r] = q[e];
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
      uint32_t a[MI][4], b[NI][2];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const int r = wm * (BM / 2) + mi * 16 + g;
        a[mi][0] = *reinterpret_cast<const uint32_t*>(&As[r][kk + tg * 4]);
        a[mi][1] = *reinterpret_cast<const uint32_t*>(&As[r + 8][kk + tg * 4]);
        a[mi][2] = *reinterpret_cast<const uint32_t*>(&As[r][kk + 16 + tg * 4]);
        a[mi][3] = *reinterpret_cast<const uint32_t*>(&As[r + 8][kk + 16 + tg * 4]);
      }
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int n = wn * (BN / 2) + ni * 8 + g;
        b[ni][0] = *reinterpret_cast<const uint32_t*>(&Bs[n][kk + tg * 4]);
        b[ni][1] = *reinterpret_cast<const uint32_t*>(&Bs[n][kk + 16 + tg * 4]);
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) mma_s8_16832(acc[mi][ni], a[mi], b[ni]);
    }
    __syncthreads();
    if (has_next) {
      store_tile();
      __syncthreads();
    }
  }

  const int zpi = static_cast<int>(zp) - 128;
  float pos = 0.f, neg = 0.f;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      const int r = m0 + wm * (BM / 2) + mi * 16 + g;
      const int c = n0 + wn * (BN / 2) + ni * 8 + tg * 2;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = r + (e >> 1) * 8, n = c + (e & 1);
        if (m >= M || n >= N) continue;
        const float s = __fmul_rn(scale, ep.ws ? ep.ws[n] : ep.w_scale);
        float v = __fmul_rn(__int2float_rn(acc[mi][ni][e] - zpi * ep.colsum[n]), s);
        if (ep.bias) v = __fadd_rn(v, ep.bias[n]);
        if (ep.relu) v = fmaxf(v, 0.f);
        if (ep.res) v = __fadd_rn(ep.res[(size_t)m * N + n], v);
        y[(size_t)m * N + n] = v;
        range_update(v, pos, neg);
      }
    }
  }
  if (ep.minmax_out) range_commit(pos, neg, ep.minmax_out);
}

// quantize x [M, K] into the codes qbuf [M, K], then the GEMM on them
inline void launch_dq_gemm(const float* x, int8_t* qbuf, const int8_t* w, float* y, int M,
                           int K, int N, const DqlSrc& src, const DqEpilogue& ep,
                           cudaStream_t s) {
  if (M == 0 || N == 0) return;
  const size_t n = (size_t)M * K;
  const int qblocks = static_cast<int>(std::min<size_t>((n / 4 + 255) / 256 + 1, 4 * 132));
  dql_quantize<<<qblocks, 256, 0, s>>>(x, qbuf, n, src);
  const int8_t* a = qbuf;
  // the largest tile that still gives the 132 SMs enough blocks
  auto blocks = [&](int bm, int bn) { return ((M + bm - 1) / bm) * ((N + bn - 1) / bn); };
  if (blocks(64, 64) >= 2 * 132) {
    dq_gemm_mma<64, 64><<<dim3((N + 63) / 64, (M + 63) / 64), 128, 0, s>>>(a, w, y, M, K, N,
                                                                          src, ep);
  } else if (blocks(32, 64) >= 132) {
    dq_gemm_mma<32, 64><<<dim3((N + 63) / 64, (M + 31) / 32), 128, 0, s>>>(a, w, y, M, K, N,
                                                                          src, ep);
  } else {
    dq_gemm_mma<32, 32><<<dim3((N + 31) / 32, (M + 31) / 32), 128, 0, s>>>(a, w, y, M, K, N,
                                                                          src, ep);
  }
}

}  // namespace lele
