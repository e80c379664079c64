// Dynamic-quantized int8 GEMM for Hopper, with exact ONNX
// DynamicQuantizeLinear semantics:
//
//   y[M,N] = ((q(x) - 128) @ w - (zp - 128) * colsum) * (scale * ws[n]) (+ bias[n])
//            (ReLU) (+ res[M,N])
//   q(x)   = clamp(round_half_even(x / scale) + zp, 0, 255)
//
// x f32 [M,K]; w int8 [K,N] (u8 weights shifted by -128 at trace time);
// colsum int32 [N] = sum over k of w. The GEMM forms serve dq_gemm.cu (the
// CTC head, kernel 5); int8_gemm.cu (kernel 11) runs the strip form with
// its raw int32 epilogue; sanm_dql.cu (kernel 4) takes pieces of this
// header (the quantization, the range fold, the int8 mma.sync, the byte
// transpose).
//
// Replaces lele_tpu/kernels/quant_matmul.py:fused_dq_matmul_pallas and the
// `_dql_dot` of lele_tpu/kernels/sanm_block.py.
//
// The activation's scale and zero point come either from two device scalars
// (kernel 5: dql_scale_zp ran before it; no host round trip), or from the
// running max(x, 0) / max(-x, 0) pair its producer wrote with atomics
// (kernel 4's form), from which every block derives the same scale and zero
// point.
// Quantization divides by the scale (ONNX, and the JAX jnp path); the Pallas
// kernel multiplies by 1/scale, which lands one code off at rounding
// boundaries. rintf rounds half to even, as ONNX and torch.round do. The
// epilogue uses _rn intrinsics, so no multiply-add is contracted and the
// result is the plain version's, bit for bit, for the same scale and zp.
//
// What bounds it on the H100: at the main path's shapes (M = T ~ 21..196
// rows, K = 512/2048, N = 512..25055) the product is skinny. The int8 weights
// stream once (the CTC head: 12.8 MB) and, for the head, the f32 output
// (19.6 MB) is the larger stream: 9.84 us at 3.35 TB/s at T = 196 (4.96 at
// T = 36), against ~2.5 us of int8 tensor-core work at 1,979 TOP/s.
// Both forms quantize f32 x to i8 codes once, by a pass over all of x
// (one IEEE division per element) into a scratch buffer the caller gives;
// the GEMM streams codes, a quarter of the f32 bytes. (Quantizing inside
// the tile loop, the first version, repeated each division in every column
// block and cost 3x the time.) The sums are exact on the int8 tensor cores
// (`mma.sync.m16n8k32`, s8 x s8 -> s32); the zero-point correction is one
// int per output.
//  - the tile form (dq_gemm_mma): BM x BN tiles over K
//    in steps of 64, the next K tile fetched into registers while the tensor
//    cores run; weights staged transposed ([n][k]), byte by byte.
//  - the strip form (dq_gemm_strip, kernel 5's C entries, but where N and K
//    are both at most 512, which the tile form takes): a block takes
//    every row up to 256 (64, 128, 192 or 256; dead m16 tiles skipped) by a
//    64-column strip, so each strip of the weight is read from device
//    memory once (the tile form read the head's weight four times). A
//    4-stage cp.async ring of 64-row K tiles; the weight tile stays [k][n]
//    as the card holds it (a 16-byte-aligned window a row where rows are
//    unaligned, as the head's 25,055 leaves them) and a 4 x 4 byte
//    transpose in registers (__byte_perm) turns 4 rows' words into 4 B
//    fragments. The int32 tile is staged in shared memory and stored by
//    whole row segments, lanes on consecutive columns. Where the strips
//    are few (the N = 512..2048 linears) a cluster of up to 8 blocks splits
//    K and sums its int32 tiles through distributed shared memory (exact in
//    any order). Same bits as the tile form and the plain version.
// Measured (NVIDIA H100 80GB HBM3, 700 W; scripts/torch_port_kernel_ab.py,
// 20 calls in a CUDA graph, quantize pass included): the head at T = 196
// 35.3 us (tile form 83.1; torch._int_mm 57.8 in chip_smoke.py), T = 36
// 19.7 (27.5), T = 100 26.8 (49.0); the [2048 -> 512] linear 8.3-13.2
// (19.1-23.7), [512 -> 1536] 7.0-11.1 (7.6-14.0), [512 -> 2048] 7.5-13.9
// (7.7-13.9: at T = 196 5% slower). On the strip form the [512 -> 512]
// linear took 10.0-10.9 against the tile form's 7.4-8.9 (a cluster's syncs
// and a 256-row tile on little work), so N and K both <= 512 stay on the
// tile form.
// Kernel 11 runs the strip form with 64-row blocks, the TMA loader and a
// programmatic dependent launch (int8_gemm.cu); kernel 5 keeps 64 MI rows
// for every row up to 256 and the cp.async loader, and the bits of both are
// the plain versions'.
// Not yet done (a later change): wgmma; folding the quantize pass (~2 us
// of each call) into the GEMM, which would need its divisions done once,
// not once a column block; kernel 5 on the TMA loader and 64-row blocks for
// its linears, after which dq_gemm_mma and dql_quantize could go, and
// kernel 4 onto the strip core (ROADMAP).
#pragma once

#include <cooperative_groups.h>
#include <cuda.h>
#include <cudaTypedefs.h>
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

// ---------------------------------------------------------------------------
// The strip form (dq_gemm.cu's C entries, but where N and K are both <= 512,
// which dq_gemm_mma above takes; and every product of int8_gemm.cu).

constexpr int kDqStages = 4;       // kernel 5's cp.async ring depth, K tiles of 64
constexpr int kDqBN = 64;          // columns of a block's strip
constexpr int kDqLD = 80;          // bytes a smem row: 64 + 16 (the window)
constexpr int kDqLDC = kDqBN + 4;  // int32 a row of the staged output tile

// Kp: the codes' row stride, K rounded up to 16, so every row of codes
// starts 16-byte aligned for cp.async
inline int dq_codes_stride(int K) { return (K + 15) / 16 * 16; }

// q[m][k] = the i8 code of x[m][k] for k < K, rows Kp apart; 4 a thread,
// grid (ceil(K / 1024), M)
__global__ void __launch_bounds__(256)
dql_quantize_rows(const float* __restrict__ x, int8_t* __restrict__ q, int K, int Kp,
                  DqlSrc src) {
  float scale, safe, zp;
  dql_params(src, scale, safe, zp);
  const int m = blockIdx.y, k = 4 * (blockIdx.x * 256 + threadIdx.x);
  if (k >= K) return;
  const float* xr = x + (size_t)m * K;
  uint32_t packed = 0;
  if (k + 4 <= K && reinterpret_cast<uintptr_t>(xr + k) % 16 == 0) {
    const float4 v = *reinterpret_cast<const float4*>(xr + k);
    packed = dql_code(v.x, safe, zp) | (dql_code(v.y, safe, zp) << 8) |
             (dql_code(v.z, safe, zp) << 16) | (dql_code(v.w, safe, zp) << 24);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (k + e < K) packed |= dql_code(xr[k + e], safe, zp) << (8 * e);
  }
  *reinterpret_cast<uint32_t*>(q + (size_t)m * Kp + k) = packed;  // Kp % 4 == 0
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8 x 16-byte matrices from shared memory, each lane giving one row's
// address (lanes 8 q .. 8 q + 7 the rows of matrix q): lane (g, tg) gets
// word tg of row g of each, the int8 mma.sync fragment layout
__device__ __forceinline__ void ldmatrix_x4(const void* row, uint32_t& r0, uint32_t& r1,
                                            uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(static_cast<unsigned>(__cvta_generic_to_shared(row))));
}

// 4 x 4 byte transpose: out[j] byte i = byte j of r[i]
__device__ __forceinline__ void transpose4x4(const uint32_t (&r)[4], uint32_t (&out)[4]) {
  const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140), t1 = __byte_perm(r[0], r[1], 0x7362);
  const uint32_t t2 = __byte_perm(r[2], r[3], 0x5140), t3 = __byte_perm(r[2], r[3], 0x7362);
  out[0] = __byte_perm(t0, t2, 0x5410);
  out[1] = __byte_perm(t0, t2, 0x7632);
  out[2] = __byte_perm(t1, t3, 0x5410);
  out[3] = __byte_perm(t1, t3, 0x7632);
}

// The loader of a strip block's K tiles: 16-byte cp.async by every thread
// (rows padded to kDqLD bytes in shared memory), or one thread's TMA copies
// of the whole A and B boxes (2-D tensor maps, zeros past the tensor's
// edges) completing on a stage's mbarrier, rows of 64 bytes with the
// 64-byte swizzle: 16-byte chunk c of row r lands at chunk c ^ ((r >> 1) &
// 3), so the fragment loads are free of bank conflicts.
enum StripLoad : int { kCpAsync = 0, kTma = 1 };

template <int LOAD>
__device__ __forceinline__ int strip_off(int r, int k) {  // byte k of row r of a tile
  if constexpr (LOAD == kCpAsync) return r * kDqLD + k;
  return r * 64 + ((((k >> 4) ^ (r >> 1)) & 3) << 4) + (k & 15);
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// One block: rows m0 .. m0 + 64 MI - 1 by a strip of 64 columns, over K
// tiles kt0 .. kt1 - 1 of its cluster rank; 8 warps, warp (wm, wn) takes
// m16 tiles wm, wm + 4, ... and the strip's 32-column half wn. A ring of ST
// stages: the first ST - 1 K tiles are in flight before the first MMA (all
// of a block's K where it has at most ST - 1 tiles). With the cp.async
// loader A's rows are `lda` bytes apart; with a_vec (rows 16-byte aligned,
// lda % 16 == 0) its 16-byte chunks come by cp.async, otherwise byte by
// byte through registers (an odd K of the MatMulInteger emitter), zeros
// past M and lda. The weight tile sits in shared memory as the card holds
// it, [k][n]: with cp.async a 16-byte-aligned window of each row (5 chunks
// where N leaves rows unaligned, as the head's 25,055 does; `sh` is the
// row's offset in it), with TMA (N % 16 == 0 only) the strip's 64 bytes.
// B fragments of mma.m16n8k32 need 4 k a word: with BT (the TMA loader at
// MI <= 2, where few m16 tiles share each fragment) the block transposes
// the tile once into Bt, [n][k], a 4 x 4 byte block a thread, and every
// fragment is an ldmatrix (A's too); otherwise a thread reads one word of
// 4 columns from each of 4 rows and transposes the bytes in registers, so
// n8 tile j's column g is the strip's column 4 g + j (the output is staged
// through shared memory, so the permutation costs nothing). Grid: (strips
// * S, row blocks), clusters of S along x splitting K; the int32 tiles are
// summed through distributed shared memory (exact in any order), rank r
// storing rows r, r + S, ... The epilogue: kernel 5's dequantization into
// f32 `out`, or with RAW the int32 sums themselves (kernel 11). With PDL
// the block may start while the kernel ahead of it in the stream still
// runs (programmatic dependent launch): it waits for that kernel
// (griddepcontrol.wait) before its first load, and lets the kernel after it
// start once its first K tiles are asked for.
template <int MI, int ST, bool ALIGNED, bool RAW, int LOAD, bool PDL>
__global__ void __launch_bounds__(256)
dq_gemm_strip(const int8_t* __restrict__ a, int lda, int a_vec, const int8_t* __restrict__ w,
              void* out, int M, int K, int N, DqlSrc src, DqEpilogue ep, int S,
              const __grid_constant__ CUtensorMap tma_a,
              const __grid_constant__ CUtensorMap tma_b) {
  constexpr int BM = 64 * MI, BK = 64;
  constexpr int LD = LOAD == kCpAsync ? kDqLD : 64;  // bytes a tile row
  constexpr bool BT = LOAD == kTma && MI <= 2;
  static_assert(LOAD == kCpAsync || ALIGNED, "TMA takes 16-byte-aligned weight rows");
  extern __shared__ __align__(16) int8_t dq_smem[];
  // TMA boxes land 1024-byte aligned (the swizzle's period)
  int8_t* ring = dq_smem + (LOAD == kCpAsync ? 0 :
      (1024 - (static_cast<unsigned>(__cvta_generic_to_shared(dq_smem)) & 1023)) & 1023);
  int8_t* As = ring;                  // [stage][BM][LD]
  int8_t* Bs = ring + ST * BM * LD;   // [stage][BK][LD]
  int8_t* Bt = ring + ST * (BM + BK) * LD;  // BT: [BK][kDqLD], the tile's weights [n][k]
  // TMA: a stage's tiles landed, one mbarrier a stage
  uint64_t* full = reinterpret_cast<uint64_t*>(Bt + (BT ? BK * kDqLD : 0));
  int* Cs = reinterpret_cast<int*>(ring);   // [BM][kDqLDC], after the loop
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1, g = lane >> 2, tg = lane & 3;
  const int rank = blockIdx.x % S, n0 = (blockIdx.x / S) * kDqBN, m0 = blockIdx.y * BM;
  const int ktiles = (K + BK - 1) / BK;
  const int kt0 = rank * ktiles / S, kt1 = (rank + 1) * ktiles / S;
  const int8_t* wend = w + (size_t)K * N;
  const unsigned bofs = static_cast<unsigned>((reinterpret_cast<uintptr_t>(w) + n0) & 15);
  constexpr int BCH = ALIGNED ? 4 : 5;  // 16-byte chunks of a weight row's window

  auto bar = [&](int stage) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(&full[stage]));
  };
  auto load_tile = [&](int kt, int stage) {
    const int k0 = kt * BK;
    if constexpr (LOAD == kTma) {  // thread 0: the stage's byte count, both boxes
      if (tid == 0) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar(stage)),
                     "r"((BM + BK) * 64)
                     : "memory");
        tma_load_2d(Bs + stage * BK * LD, &tma_b, n0, k0, bar(stage));
        tma_load_2d(As + stage * BM * LD, &tma_a, k0, m0, bar(stage));
      }
      return;
    }
    int8_t* as = As + stage * BM * LD;
    for (int c = tid; c < BM * 4; c += 256) {
      const int r = c >> 2, kc = k0 + (c & 3) * 16, m = m0 + r;
      if (RAW && !a_vec) {  // kernel 11's odd K; kernel 5's codes are Kp-aligned
        *reinterpret_cast<uint4*>(as + r * LD + (c & 3) * 16) = load_a16(a, m, kc, M, lda, false);
      } else {
        const bool ok = m < M && kc < lda;
        cp_async16(as + r * LD + (c & 3) * 16, ok ? a + (size_t)m * lda + kc : a, ok ? 16 : 0);
      }
    }
    int8_t* bs = Bs + stage * BK * LD;
    for (int c = tid; c < BK * BCH; c += 256) {
      const int r = c / BCH, j = c % BCH, k = k0 + r;
      const int8_t* row = w + (size_t)k * N + n0;
      const int8_t* p = reinterpret_cast<const int8_t*>(
                            reinterpret_cast<uintptr_t>(row) & ~uintptr_t(15)) + 16 * j;
      const long long left = k < K ? wend - p : 0;
      const int bytes = left <= 0 ? 0 : left >= 16 ? 16 : static_cast<int>(left);
      cp_async16(bs + r * LD + 16 * j, bytes ? p : w, bytes);
    }
  };

  if constexpr (LOAD == kTma) {
    if (tid == 0) {
      for (int s = 0; s < ST; ++s)
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar(s)) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }

  int acc[MI][4][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0;

  if constexpr (PDL) asm volatile("griddepcontrol.wait;\n" ::: "memory");
#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {
    if (kt0 + s < kt1) load_tile(kt0 + s, s);
    if constexpr (LOAD == kCpAsync) cp_async_commit();
  }
  if constexpr (PDL) asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  for (int kt = kt0; kt < kt1; ++kt) {
    const int stage = (kt - kt0) % ST;
    if constexpr (LOAD == kCpAsync)
      cp_async_wait<ST - 2>();
    else
      mbar_wait(bar(stage), ((kt - kt0) / ST) & 1);
    __syncthreads();  // tile kt landed for all; the stage refilled below is free
    if (kt + ST - 1 < kt1) load_tile(kt + ST - 1, (kt - kt0 + ST - 1) % ST);
    if constexpr (LOAD == kCpAsync) cp_async_commit();
    const int8_t* as = As + stage * BM * LD;
    const int8_t* bs = Bs + stage * BK * LD;
    if constexpr (BT) {
      {  // the weight tile transposed once, [n][k], 4 x 4 bytes a thread
        const int kb = tid & 15, nb = tid >> 4;
        uint32_t r4[4], t[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          r4[i] = *reinterpret_cast<const uint32_t*>(bs + strip_off<LOAD>(4 * kb + i, 4 * nb));
        transpose4x4(r4, t);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          *reinterpret_cast<uint32_t*>(Bt + (4 * nb + j) * kDqLD + 4 * kb) = t[j];
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; kk += 32) {
        const int q = lane >> 3;
        uint32_t b[4][2];
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {  // n8 tiles 2 jp and 2 jp + 1
          const int n = wn * 32 + 8 * (2 * jp + (q >> 1)) + (lane & 7);
          ldmatrix_x4(Bt + n * kDqLD + kk + 16 * (q & 1), b[2 * jp][0], b[2 * jp][1],
                      b[2 * jp + 1][0], b[2 * jp + 1][1]);
        }
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          const int r = (mi * 4 + wm) * 16;
          if (m0 + r >= M) continue;  // a dead m16 tile: the same for the warp
          uint32_t af[4];
          ldmatrix_x4(as + strip_off<LOAD>(r + (lane & 7) + 8 * (q & 1), kk + 16 * (q >> 1)),
                      af[0], af[1], af[2], af[3]);
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_s8_16832(acc[mi][j], af, b[j]);
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < BK; kk += 32) {
        uint32_t b[4][2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t r4[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = kk + 16 * h + tg * 4 + i;
            if constexpr (ALIGNED) {
              r4[i] = *reinterpret_cast<const uint32_t*>(bs + strip_off<LOAD>(r, 4 * (wn * 8 + g)));
            } else {
              const uint32_t* rw = reinterpret_cast<const uint32_t*>(bs + r * LD);
              const unsigned sh = (bofs + static_cast<unsigned>(kt * BK + r) *
                                   static_cast<unsigned>(N)) & 15u;
              const unsigned p = sh + wn * 32 + 4 * g;
              r4[i] = __funnelshift_r(rw[p >> 2], rw[(p >> 2) + 1], (p & 3) * 8);
            }
          }
          uint32_t t[4];
          transpose4x4(r4, t);
#pragma unroll
          for (int j = 0; j < 4; ++j) b[j][h] = t[j];
        }
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          const int r = (mi * 4 + wm) * 16;
          if (m0 + r >= M) continue;  // a dead m16 tile: the same for the warp
          uint32_t af[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            af[e] = *reinterpret_cast<const uint32_t*>(
                as + strip_off<LOAD>(r + g + 8 * (e & 1), kk + 16 * (e >> 1) + tg * 4));
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_s8_16832(acc[mi][j], af, b[j]);
        }
      }
    }
  }
  if constexpr (LOAD == kCpAsync) cp_async_wait<0>();
  __syncthreads();  // the ring is free: stage the int32 tile in its place

  // thread (g, tg) of n8 tile j holds columns 2 tg, 2 tg + 1 of rows g and
  // g + 8: strip columns wn * 32 + 8 j + 2 tg (+ 1) with BT, else
  // wn * 32 + 4 (2 tg) + j and wn * 32 + 4 (2 tg + 1) + j
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
    const int r = (mi * 4 + wm) * 16 + g;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if constexpr (BT) {
        const int c = wn * 32 + 8 * j + 2 * tg;
        *reinterpret_cast<int2*>(Cs + r * kDqLDC + c) = make_int2(acc[mi][j][0], acc[mi][j][1]);
        *reinterpret_cast<int2*>(Cs + (r + 8) * kDqLDC + c) =
            make_int2(acc[mi][j][2], acc[mi][j][3]);
      } else {
        const int c = wn * 32 + 8 * tg + j;
        Cs[r * kDqLDC + c] = acc[mi][j][0];
        Cs[r * kDqLDC + c + 4] = acc[mi][j][1];
        Cs[(r + 8) * kDqLDC + c] = acc[mi][j][2];
        Cs[(r + 8) * kDqLDC + c + 4] = acc[mi][j][3];
      }
    }
  }
  namespace cg = cooperative_groups;
  if (S > 1) cg::this_cluster().sync();
  else __syncthreads();

  // the epilogue, coalesced: a warp stores whole row segments, lane on column
  int cs[2] = {0, 0}, zpi = 0;
  float sc[2] = {0.f, 0.f};
  if constexpr (!RAW) {
    float scale, safe, zp;
    dql_params(src, scale, safe, zp);
    zpi = static_cast<int>(zp) - 128;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + lane + 32 * h;
      cs[h] = n < N ? ep.colsum[n] : 0;
      sc[h] = n < N ? __fmul_rn(scale, ep.ws ? ep.ws[n] : ep.w_scale) : 0.f;
    }
  }
  for (int r = rank + S * warp; r < BM && m0 + r < M; r += S * 8) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = lane + 32 * h, n = n0 + c;
      int v = Cs[r * kDqLDC + c];
      if (S > 1) {  // the other ranks' sums, all loads in flight at once
        int o[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          o[i] = i < S && i != rank
              ? *cg::this_cluster().map_shared_rank(Cs + r * kDqLDC + c, i) : 0;
#pragma unroll
        for (int i = 0; i < 8; ++i) v += o[i];
      }
      if (n >= N) continue;
      const size_t at = (size_t)(m0 + r) * N + n;
      if constexpr (RAW)
        static_cast<int32_t*>(out)[at] = v;
      else
        static_cast<float*>(out)[at] = __fmul_rn(__int2float_rn(v - zpi * cs[h]), sc[h]);
    }
  }
  if (S > 1) cg::this_cluster().sync();  // no block leaves while its tile is read
}

// the 2-D tensor map of a row-major [rows, cols] matrix of `type` (rows
// `stride` bytes apart) in boxes of box_rows x box_cols elements, zeros past
// its edges
inline cudaError_t tensor_map_2d(CUtensorMap* map, CUtensorMapDataType type, const void* base,
                                 int rows, int cols, size_t stride, int box_rows, int box_cols,
                                 CUtensorMapSwizzle swizzle) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult q;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", reinterpret_cast<void**>(&encode), cudaEnableDefault, &q);
    if (err != cudaSuccess || q != cudaDriverEntryPointSuccess || encode == nullptr) {
      encode = nullptr;
      return err != cudaSuccess ? err : cudaErrorNotSupported;
    }
  }
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(stride)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = encode(map, type, 2, const_cast<void*>(base), dims, strides, box, estr,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// an int8 [rows, cols] matrix in boxes of box_rows x 64 bytes, 64-byte
// swizzled
inline cudaError_t strip_tensor_map(CUtensorMap* map, const int8_t* base, int rows, int cols,
                                    int stride, int box_rows) {
  return tensor_map_2d(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, base, rows, cols, stride, box_rows,
                       64, CU_TENSOR_MAP_SWIZZLE_64B);
}

// One launch of the strip form: (strips * S) x ceil(M / 64 MI) blocks,
// clusters of S along x splitting K. The TMA loader needs a's rows and the
// weight's 16-byte aligned (a_vec and ALIGNED).
template <int MI, int ST, bool ALIGNED, bool RAW, int LOAD = kCpAsync, bool PDL = false>
inline cudaError_t launch_strip(const int8_t* a, int lda, bool a_vec, const int8_t* w,
                                void* out, int M, int K, int N, const DqlSrc& src,
                                const DqEpilogue& ep, int S, cudaStream_t s) {
  constexpr int BM = 64 * MI;
  constexpr bool BT = LOAD == kTma && MI <= 2;
  constexpr int smem = LOAD == kCpAsync
      ? ST * (BM + 64) * kDqLD
      : 1024 + ST * (BM + 64) * 64 + (BT ? 64 * kDqLD : 0) + ST * 8;
  static_assert(BM * kDqLDC * 4 <= ST * (BM + 64) * 64, "staging fits the ring");
  CUtensorMap ta{}, tb{};
  if constexpr (LOAD == kTma) {
    cudaError_t err = strip_tensor_map(&ta, a, M, K, lda, BM);
    if (err == cudaSuccess) err = strip_tensor_map(&tb, w, K, N, N, 64);
    if (err != cudaSuccess) return err;
  }
  auto kernel = dq_gemm_strip<MI, ST, ALIGNED, RAW, LOAD, PDL>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((N + kDqBN - 1) / kDqBN) * S, (M + BM - 1) / BM);
  cfg.blockDim = dim3(256);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[2];
  unsigned n_attr = 0;
  if (S > 1) {
    attr[n_attr].id = cudaLaunchAttributeClusterDimension;
    attr[n_attr].val.clusterDim.x = S;
    attr[n_attr].val.clusterDim.y = 1;
    attr[n_attr].val.clusterDim.z = 1;
    ++n_attr;
  }
  if (PDL) {
    attr[n_attr].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[n_attr].val.programmaticStreamSerializationAllowed = 1;
    ++n_attr;
  }
  cfg.attrs = attr;
  cfg.numAttrs = n_attr;
  return cudaLaunchKernelEx(&cfg, kernel, a, lda, static_cast<int>(a_vec), w, out, M, K, N,
                            src, ep, S, ta, tb);
}

template <int MI, bool ALIGNED>
inline cudaError_t launch_dq_strip_mi(const int8_t* a, int Kp, const int8_t* w, float* y, int M,
                                      int K, int N, const DqlSrc& src, const DqEpilogue& ep,
                                      cudaStream_t s) {
  const int strips = (N + kDqBN - 1) / kDqBN, rows = (M + 64 * MI - 1) / (64 * MI);
  const int ktiles = (K + 63) / 64;
  // a cluster splits K where the strips alone give fewer than ~2 blocks an
  // SM, keeping 2 K tiles a block
  int S = 1;
  while (S < 8 && strips * rows * S < 2 * 132 && 4 * S <= ktiles) S *= 2;
  return launch_strip<MI, kDqStages, ALIGNED, false>(a, Kp, true, w, y, M, K, N, src, ep, S, s);
}

// quantize x [M, K] into the codes qbuf [M, dq_codes_stride(K)], then the
// strip GEMM on them; the epilogue takes ep's colsum and ws / w_scale only.
// Where both N and K are at most 512 (the [512 -> 512] linear) the work is
// too small for a strip's 256-row tile and a cluster: the tile form takes
// it (the same bits; its codes are [M, K], which the buffer holds).
inline cudaError_t launch_dq_strip(const float* x, int8_t* qbuf, const int8_t* w, float* y,
                                   int M, int K, int N, const DqlSrc& src,
                                   const DqEpilogue& ep, cudaStream_t s) {
  if (M == 0 || N == 0) return cudaSuccess;
  if (N <= 512 && K <= 512) {
    launch_dq_gemm(x, qbuf, w, y, M, K, N, src, ep, s);
    return cudaSuccess;
  }
  const int Kp = dq_codes_stride(K);
  dql_quantize_rows<<<dim3(std::max(1, (K + 1023) / 1024), M), 256, 0, s>>>(x, qbuf, K, Kp, src);
  const bool aligned = N % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const int mi = M > 192 ? 4 : M > 128 ? 3 : M > 64 ? 2 : 1;
#define LELE_DQ_STRIP(MI_)                                                            \
  return aligned ? launch_dq_strip_mi<MI_, true>(qbuf, Kp, w, y, M, K, N, src, ep, s) \
                 : launch_dq_strip_mi<MI_, false>(qbuf, Kp, w, y, M, K, N, src, ep, s)
  if (mi == 1) LELE_DQ_STRIP(1);
  if (mi == 2) LELE_DQ_STRIP(2);
  if (mi == 3) LELE_DQ_STRIP(3);
  LELE_DQ_STRIP(4);
#undef LELE_DQ_STRIP
}

}  // namespace lele
