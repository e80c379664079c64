// The decode form of kernel 7 (w4_gemm.cu): y[M,N] = x[M,K] @ W[K,N] for
// few rows, W groupwise int4 in the block packing of w4_gemm.cuh. Replaces
// lele_tpu/kernels/w4_matmul.py:w4_matmul_pallas where the tile GEMM of
// w4_gemm.cuh wasted its M tile: w4_gemm.cu takes this form for up to 8
// rows in the group form and 4 in the others (w4_decode_rows, the
// crossover) and for every launch of the expert-indexed entry (QMoE decode:
// one row a block, each against its own expert stack). The shape alone
// picks it.
//
// What bounds it on the H100: the packed weight, read once. At Phi-3.5-MoE's
// expert widths ([1,4096]x[4096,6400] and [1,6400]x[6400,4096], group 128)
// that is 13.1 MB of weight and 0.8 MB of scales: 4.17 us at 3.35 TB/s; the
// 52 MFLOP are nothing. The tile form took 53-97 us of device time: one
// live row of 32, and ~200 KB of loads in flight where the stream needs
// ~3 MB.
// The design:
//  - a block owns a strip of columns; its warps walk packed rows with
//    16-byte loads, neighbouring lanes on neighbouring columns (rows of an
//    odd N are read as aligned words and shifted into place), several rows
//    in flight a lane. Each byte feeds its low-plane row k and its
//    high-plane row K/2 + k. Dequantisation stays in registers.
//  - the group-accumulator form (bf16 x, the QMoE and MatMulNBits decode
//    path) multiplies on the tensor cores, with the weight as the A operand
//    (16 columns an m16 tile, the rows of x the n8 side): a byte permute of
//    two rows, a mask and a bf16x2 subtract give a fragment pair, ~1.5
//    instructions a weight. A warp owns 128 columns and whole scale groups,
//    and streams them through its own cp.async ring, 4 k-steps deep.
//  - the dequantised-tile form (bf16 x; any group) and the exact f32 form
//    (f32 x, the qmoe_w4_f32 route) stay on the CUDA cores, as f32 FMA on
//    bf16(q * s) or q * s per element.
//  - K is split over the warps of a block and, where the strips and rows
//    alone give fewer than ~2 blocks an SM, over the blocks of a thread-block
//    cluster (2, 4 or 8). Partials are reduced in a fixed order: across
//    warps through shared memory, across the cluster's blocks through
//    distributed shared memory, read by block 0. No atomics: a repeat call
//    gives the same bits, and there is one launch and no scratch buffer.
//  - the three forms keep their rounding points; only f32 summation orders
//    differ from the plain version: the group form's slices of K are whole
//    scale groups, so each group's f32 partial of x*q (both planes' groups
//    close on the same packed row, as the group divides K/2) is whole before
//    acc = acc + partial * s, each rounded (_rn).
//  - any even K, any group from 1 to 512 that divides K (the group form:
//    multiples of 8 that divide K/2, in k-steps of 16 or 8), odd N; the tail
//    of K/2 past the last whole octet of rows is masked.
// Measured (NVIDIA H100 80GB HBM3, 700 W; scripts/torch_port_kernel_ab.py,
// 20 calls in a CUDA graph, cold L2): 16.3 us at [1,4096]x[4096,6400] and
// 19.4 at [1,6400]x[6400,4096] (the tile form 66 and 100; torch.matmul on
// the bf16 weight 22.6 and 20.0 in chip_smoke.py), 8.4 and 10.4 at the QMoE
// test widths (tile 13 and 22; torch.matmul 4.5 and 5.4). What holds it at
// ~4x its bound: building the fragments costs about as many issue slots as
// the loads take, and a warp's slice of K is whole groups, which caps the
// warps at small widths.
// Crossover (the A/B above, CUDA graph, warm / cold): at [M,4096]x[4096,6400]
// the group form takes 15.4-15.9 / 16.4-16.9 us for every M from 1 to 8,
// the tile form 47-54 / 59-67 at M = 1-9 and 52 / 55 at 16. So the decode
// form wins wherever it can take the rows; its limit, 8, is the n8 side of
// the MMA (more rows would need a second n8 tile, not yet done), and the
// CUDA-core forms stop at 4, the rows their sums hold in registers (their
// crossover is not measured).
// Left for later: a weight layout prepared for the fragments (one LOP3 a
// pair, as Marlin packs int4), the 196-row small-group MatMulNBits shapes
// (still the tile form, 1.3-1.4x torch.matmul; PERF.md), TMA, and wgmma
// for the tile form.
#pragma once

#include <cooperative_groups.h>

#include <algorithm>

#include "w4_gemm.cuh"

namespace lele {

// The expert-indexed entry: block z computes row z of x against stack
// idx[z]; the kernels move their pointers there and take M = 1.
#define LELE_W4_SELECT_ROW(idx, x, w, sc, y, M, K, N, group)  \
  if (idx) {                                                 \
    const size_t r_ = blockIdx.z;                            \
    const size_t e_ = static_cast<size_t>(__ldg(idx + r_));  \
    x += r_ * (K);                                           \
    y += r_ * (N);                                           \
    w += e_ * ((K) / 2) * (N);                               \
    sc += e_ * ((K) / (group)) * (N);                        \
    M = 1;                                                   \
  }

// The rows this form takes (the expert-indexed entry aside): the group form
// carries x's rows on the n8 side of mma.sync, so up to 8; the CUDA-core
// forms hold every row's sums in registers, so up to 4. Above, the tile form.
constexpr int kW4DecodeRowsMma = 8;
constexpr int kW4DecodeRows = 4;
inline int w4_decode_rows(bool group_form) {
  return group_form ? kW4DecodeRowsMma : kW4DecodeRows;
}
constexpr int kW4GemvWarps = 8;
constexpr int kW4GemvCols = 64;  // columns of a block's strip, CUDA-core form
constexpr int kW4MmaCols = 128;  // columns of a block's strip, group form
constexpr int kW4MmaWarps = 4;   // warps a block, group form
constexpr int kW4MmaStages = 4;  // k-steps in a warp's cp.async ring, group form
constexpr int kW4MmaBlocks = 3;  // blocks an SM the group form's registers allow

// 16 packed bytes w[row][c0 .. c0+15] of a [rows, N] stack; zeros past N
__device__ __forceinline__ uint4 w4_load16(const int8_t* __restrict__ w, int row, int c0, int N,
                                           size_t total, bool vec) {
  const size_t off = (size_t)row * N + c0;
  if (vec && c0 + 16 <= N) return __ldg(reinterpret_cast<const uint4*>(w + off));
  if (c0 + 16 <= N && off + 20 <= total) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(w + off);
    const uint32_t* wd = reinterpret_cast<const uint32_t*>(a & ~uintptr_t(3));
    const unsigned sh = (a & 3) * 8;
    uint32_t u[5];
#pragma unroll
    for (int e = 0; e < 5; ++e) u[e] = __ldg(wd + e);
    return make_uint4(__funnelshift_r(u[0], u[1], sh), __funnelshift_r(u[1], u[2], sh),
                      __funnelshift_r(u[2], u[3], sh), __funnelshift_r(u[3], u[4], sh));
  }
  uint32_t v[4] = {0u, 0u, 0u, 0u};  // the ragged end of a row, byte by byte
#pragma unroll
  for (int e = 0; e < 16; ++e)
    if (c0 + e < N)
      v[e / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(__ldg(w + off + e))) << (8 * (e % 4));
  return make_uint4(v[0], v[1], v[2], v[3]);
}

// word i of v, i a constant after unrolling: no address taken, so the
// loaded registers stay registers
__device__ __forceinline__ uint32_t w4_word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// 16 scales s[g][c0 .. c0+15]; zeros past N
__device__ __forceinline__ void w4_scales16(float (&s)[16], const float* __restrict__ sc, int g,
                                            int c0, int N, bool vec) {
  const float* p = sc + (size_t)g * N + c0;
  if (vec && c0 + 16 <= N) {
#pragma unroll
    for (int e = 0; e < 16; e += 4) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(p + e));
      s[e] = f.x, s[e + 1] = f.y, s[e + 2] = f.z, s[e + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < 16; ++e) s[e] = c0 + e < N ? __ldg(p + e) : 0.f;
  }
}

// Sums v over the 8 quads of a warp (lanes 4q + j) and scatters the result:
// lane 4q + j ends with columns 2q and 2q + 1 of its 16 in out[0], out[1].
// Fixed order: the same bits on every call.
template <int W>
__device__ __forceinline__ void quad_reduce_scatter(float (&v)[16][W], float (&out)[2][W],
                                                    int lane) {
  float a[8][W], b[4][W];
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
#pragma unroll
  for (int c = 0; c < 8; ++c)
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const float send = b4 ? v[c][j] : v[c + 8][j];
      a[c][j] = (b4 ? v[c + 8][j] : v[c][j]) + __shfl_xor_sync(0xffffffffu, send, 16);
    }
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const float send = b3 ? a[c][j] : a[c + 4][j];
      b[c][j] = (b3 ? a[c + 4][j] : a[c][j]) + __shfl_xor_sync(0xffffffffu, send, 8);
    }
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const float send = b2 ? b[c][j] : b[c + 2][j];
      out[c][j] = (b2 ? b[c + 2][j] : b[c][j]) + __shfl_xor_sync(0xffffffffu, send, 4);
    }
}

__device__ __forceinline__ float w4_x(const float* x, size_t i) { return __ldg(x + i); }
__device__ __forceinline__ float w4_x(const __nv_bfloat16* x, size_t i) {
  return __bfloat162float(x[i]);
}

// The slice of K/2's packed rows that warp `warp` of cluster rank `rank`
// walks: a contiguous run of whole chunks of `chunk` rows
__device__ __forceinline__ void w4_slice(int half, int chunk, int S, int nw, int rank, int warp,
                                         int& ra, int& rb) {
  const long long nch = (half + chunk - 1) / chunk, nsl = (long long)S * nw;
  const long long sl = (long long)rank * nw + warp;
  ra = static_cast<int>(sl * nch / nsl) * chunk;
  rb = min(static_cast<int>((sl + 1) * nch / nsl) * chunk, half);
}

// The end of both decode kernels: every warp has written its sums to
// red[warp][m][c]; sum the warps in order into part_out [MR][COLS], then,
// where a cluster split K, block 0 adds the other blocks' through
// distributed shared memory, in rank order. Rows m < M are stored.
template <int MR, int COLS>
__device__ __forceinline__ void w4_strip_store(float (*red)[MR][COLS], float* part_out,
                                               int nw, int S, int rank, float* y, int M, int N,
                                               int n0) {
  __syncthreads();
  for (int t = threadIdx.x; t < MR * COLS; t += blockDim.x) {
    const int m = t / COLS, c = t % COLS;
    float v = 0.f;
    for (int i = 0; i < nw; ++i) v += red[i][m][c];
    part_out[t] = v;
  }
  if (S > 1) {
    namespace cg = cooperative_groups;
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    if (rank == 0) {
      for (int t = threadIdx.x; t < MR * COLS; t += blockDim.x) {
        float o[8];  // all loads in flight at once, summed in rank order
#pragma unroll
        for (int i = 0; i < 8; ++i) o[i] = i < S ? *cluster.map_shared_rank(part_out + t, i) : 0.f;
        float v = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) v += o[i];
        part_out[t] = v;
      }
    }
    cluster.sync();  // no block leaves while its part is read
    if (rank != 0) return;
  }
  for (int t = threadIdx.x; t < MR * COLS; t += blockDim.x) {
    const int m = t / COLS, n = n0 + t % COLS;
    if (m < M && n < N) y[(size_t)m * N + n] = part_out[t];
  }
}

__device__ __forceinline__ void w4_cp_async(void* dst, const void* src, int cp, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (cp == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void w4_cp_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void w4_cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The group form's shared memory a warp: a ring of kW4MmaStages k-steps,
// each the lane's rows of the weight ([row][lane][16 bytes], or a 32-byte
// aligned window a lane-row where rows are unaligned) and its x pairs
// ([plane][pair][lane])
template <int KSTEP, bool ALIGNED>
struct W4MmaRing {
  static constexpr int RPT = KSTEP / 4, WIN = ALIGNED ? 16 : 32;
  static constexpr int W_BYTES = RPT * 32 * WIN, X_BYTES = 2 * (RPT / 2) * 32 * 4;
  static constexpr int STAGE = W_BYTES + X_BYTES;
  static constexpr int WARP = kW4MmaStages * STAGE;
};

// The group-accumulator form (bf16 x) on the tensor cores. y^T = W^T x^T
// by mma.sync with the weight as A: an m16 tile is 16 columns of W, n8 the
// (up to 8) rows of x, k the packed rows. A warp owns 128 columns and whole
// scale groups of K: lane (g, tg) streams 16 bytes (columns 16 g ..) of
// each of its KSTEP / 4 rows (4 tg ..) of a k-step through its own cp.async
// ring, kW4MmaStages k-steps deep, and reads back only what it copied.
// __byte_perm interleaves two rows' bytes, so one permute, a mask and a
// bf16x2 subtract give a fragment pair of 2 rows at one column. A-tile t's
// row g is column 16 g + 2 t, row g + 8 column 16 g + 2 t + 1; the low and
// the high nibbles are two A operands, each with its own partial, whole
// when its group closes: acc = acc + partial * s, each rounded. A k-step of
// 16 rows takes m16n8k16, of 8 rows (a group not a multiple of 16)
// m16n8k8. x rows past M are zeros in B.
template <int KSTEP, bool ALIGNED>
__global__ void __launch_bounds__(32 * kW4MmaWarps, kW4MmaBlocks)
w4_gemv_mma(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
            const float* __restrict__ sc, float* __restrict__ y, int M, int K, int N, int group,
            const int* __restrict__ idx, int S) {
  using Ring = W4MmaRing<KSTEP, ALIGNED>;
  constexpr int RPT = Ring::RPT, STG = kW4MmaStages;
  extern __shared__ __align__(16) unsigned char w4_ring[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const int rank = blockIdx.x % S, n0 = (blockIdx.x / S) * kW4MmaCols;
  LELE_W4_SELECT_ROW(idx, x, w, sc, y, M, K, N, group);
  const int half = K / 2, c0 = n0 + 16 * g;
  const bool s_vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(sc) % 16 == 0;
  const int8_t* wend = w + (size_t)half * N;
  int ra, rb;
  w4_slice(half, group, S, nw, rank, warp, ra, rb);  // whole groups
  const int nsteps = (rb - ra) / KSTEP;
  unsigned char* ring = w4_ring + warp * Ring::WARP;
  const __nv_bfloat16* xg = x + (size_t)g * K;  // B's column g: row g of x

  auto issue = [&](int st) {  // k-step st of the slice into its stage
    unsigned char* stage = ring + (st % STG) * Ring::STAGE;
    const int r0 = ra + st * KSTEP + RPT * tg;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int8_t* src = w + (size_t)(r0 + i) * N + c0;
      unsigned char* dst = stage + (i * 32 + lane) * Ring::WIN;
      if constexpr (ALIGNED) {
        w4_cp_async(dst, c0 < N ? src : w, 16, c0 < N ? 16 : 0);
      } else {  // the aligned 32 bytes around the lane's 16
        const int8_t* a0 = reinterpret_cast<const int8_t*>(
            reinterpret_cast<uintptr_t>(src) & ~uintptr_t(15));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long long left = c0 < N ? wend - (a0 + 16 * h) : 0;
          const int bytes = left <= 0 ? 0 : left >= 16 ? 16 : static_cast<int>(left);
          w4_cp_async(dst + 16 * h, bytes ? a0 + 16 * h : w, 16, bytes);
        }
      }
    }
    unsigned char* xs = stage + Ring::W_BYTES;
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int h = 0; h < RPT / 2; ++h)
        w4_cp_async(xs + ((p * (RPT / 2) + h) * 32 + lane) * 4,
                    g < M ? static_cast<const void*>(xg + p * half + r0 + 2 * h) : w, 4,
                    g < M ? 4 : 0);
  };

  float acc[8][4], part[2][8][4], s[2][16];
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
  int gpos = 0, grow = ra / group;
  const unsigned bofs = static_cast<unsigned>((reinterpret_cast<uintptr_t>(w) + c0) & 15);

#pragma unroll
  for (int st = 0; st < STG - 1; ++st) {
    if (st < nsteps) issue(st);
    w4_cp_commit();
  }
  for (int st = 0; st < nsteps; ++st) {
    w4_cp_wait<STG - 2>();  // this lane's copies of k-step st have landed
    if (st + STG - 1 < nsteps) issue(st + STG - 1);  // into the stage read last step
    w4_cp_commit();
    if (gpos == 0) {  // both planes' groups open
#pragma unroll
      for (int p = 0; p < 2; ++p) {
#pragma unroll
        for (int t = 0; t < 8; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[p][t][e] = 0.f;
        w4_scales16(s[p], sc, p * (half / group) + grow, c0, N, s_vec);
      }
    }
    const unsigned char* stage = ring + (st % STG) * Ring::STAGE;
    uint4 raw[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const unsigned char* src = stage + (i * 32 + lane) * Ring::WIN;
      if constexpr (ALIGNED) {
        raw[i] = *reinterpret_cast<const uint4*>(src);
      } else {  // the row's 16 bytes at their offset in the window
        const int r = ra + st * KSTEP + RPT * tg + i;
        const unsigned o = (bofs + static_cast<unsigned>(r) * static_cast<unsigned>(N)) & 15u;
        const uint32_t* wd = reinterpret_cast<const uint32_t*>(src) + (o >> 2);
        const unsigned sh = (o & 3) * 8;
        raw[i] = make_uint4(__funnelshift_r(wd[0], wd[1], sh), __funnelshift_r(wd[1], wd[2], sh),
                            __funnelshift_r(wd[2], wd[3], sh), __funnelshift_r(wd[3], wd[4], sh));
      }
    }
    const uint32_t* xs = reinterpret_cast<const uint32_t*>(stage + Ring::W_BYTES);
    uint32_t xb[2][RPT / 2];
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int h = 0; h < RPT / 2; ++h) xb[p][h] = xs[(p * (RPT / 2) + h) * 32 + lane];
#pragma unroll
    for (int wi = 0; wi < 4; ++wi) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {  // tile 2 wi + j: bytes 2 j, 2 j + 1 of word wi
        uint32_t lo[RPT / 2], hi[RPT / 2];
#pragma unroll
        for (int h = 0; h < RPT / 2; ++h) {
          const uint32_t pr = __byte_perm(w4_word(raw[2 * h], wi), w4_word(raw[2 * h + 1], wi),
                                          j ? 0x7362 : 0x5140);
          lo[h] = nibbles_biased(pr, 0);
          hi[h] = nibbles_biased(pr, 4);
        }
        const int t = 2 * wi + j;
        if constexpr (KSTEP == 16) {
          const uint32_t al[4] = {int4_pair_bf16(lo[0], 0), int4_pair_bf16(lo[0], 1),
                                  int4_pair_bf16(lo[1], 0), int4_pair_bf16(lo[1], 1)};
          const uint32_t ah[4] = {int4_pair_bf16(hi[0], 0), int4_pair_bf16(hi[0], 1),
                                  int4_pair_bf16(hi[1], 0), int4_pair_bf16(hi[1], 1)};
          const uint32_t bl[2] = {xb[0][0], xb[0][1]};
          const uint32_t bh[2] = {xb[1][0], xb[1][1]};
          mma_bf16_16816(part[0][t], al, bl);
          mma_bf16_16816(part[1][t], ah, bh);
        } else {
          const uint32_t al[2] = {int4_pair_bf16(lo[0], 0), int4_pair_bf16(lo[0], 1)};
          const uint32_t ah[2] = {int4_pair_bf16(hi[0], 0), int4_pair_bf16(hi[0], 1)};
          mma_bf16_1688(part[0][t], al, xb[0][0]);
          mma_bf16_1688(part[1][t], ah, xb[1][0]);
        }
      }
    }
    gpos += KSTEP;
    if (gpos == group) {  // both groups close: acc = acc + partial * s, each rounded
      gpos = 0, ++grow;
#pragma unroll
      for (int t = 0; t < 8; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 2 * t + (e >> 1);
          acc[t][e] = __fadd_rn(acc[t][e], __fmul_rn(part[0][t][e], s[0][c]));
          acc[t][e] = __fadd_rn(acc[t][e], __fmul_rn(part[1][t][e], s[1][c]));
        }
    }
  }
  w4_cp_wait<0>();
  __syncthreads();  // every warp is done with its ring: reuse it for the sums
  // C of tile t: rows g, g + 8 (columns 16 g + 2 t, + 1), columns 2 tg, + 1
  // (x rows): the warps' sums as red[warp][m][c], then part_out [8][cols]
  auto red = reinterpret_cast<float (*)[8][kW4MmaCols]>(w4_ring);
  float* part_out = reinterpret_cast<float*>(w4_ring) + nw * 8 * kW4MmaCols;
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) red[warp][2 * tg + (e & 1)][16 * g + 2 * t + (e >> 1)] = acc[t][e];
  w4_strip_store<8, kW4MmaCols>(red, part_out, nw, S, rank, y, M, N, n0);
}

// The dequantised-tile form (bf16 x) and the exact f32 form (f32 x) on the
// CUDA cores. A block owns 64 columns: the 4 lanes of a quad read one row's
// 64 bytes, the 8 quads of a warp 8 rows, U octets of rows in flight. Each
// lane keeps per-element scale rows of both planes for its quad's row
// (running counters; any group). MR: rows held (M <= MR; 1 for the
// expert-indexed entry). The lanes' sums are reduced over the quads by a
// reduce-scatter of shuffles, then as in w4_strip_store.
template <typename AT, int MR>
__global__ void __launch_bounds__(32 * kW4GemvWarps)
w4_gemv(const AT* __restrict__ x, const int8_t* __restrict__ w, const float* __restrict__ sc,
        float* __restrict__ y, int M, int K, int N, int group, const int* __restrict__ idx,
        int S) {
  constexpr bool F32 = sizeof(AT) == 4;
  constexpr int U = MR <= 2 ? 8 : 4;  // octets of rows in flight a lane
  __shared__ float red[kW4GemvWarps][MR][kW4GemvCols];
  __shared__ float part_out[MR * kW4GemvCols];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int q = lane >> 2, l4 = lane & 3;
  const int rank = blockIdx.x % S, n0 = (blockIdx.x / S) * kW4GemvCols;
  LELE_W4_SELECT_ROW(idx, x, w, sc, y, M, K, N, group);
  const int half = K / 2, c0 = n0 + l4 * 16;
  const size_t total = (size_t)half * N;
  const bool w_vec = N % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const bool s_vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(sc) % 16 == 0;
  int ra, rb;
  w4_slice(half, 8, S, nw, rank, warp, ra, rb);  // whole octets

  float acc[16][MR];
#pragma unroll
  for (int c = 0; c < 16; ++c)
#pragma unroll
    for (int m = 0; m < MR; ++m) acc[c][m] = 0.f;
  // each plane's scale row at this lane's 16 columns, for the scale group
  // of the quad's current row
  float s[2][16];
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int c = 0; c < 16; ++c) s[p][c] = 0.f;  // finite before a masked row
  int sg[2] = {-1, -1}, grow[2], gp[2];
  grow[0] = (ra + q) / group, gp[0] = (ra + q) % group;
  grow[1] = (half + ra + q) / group, gp[1] = (half + ra + q) % group;

  for (int r = ra; r < rb; r += 8 * U) {
    uint4 raw[U];
    float xv[U][2][MR];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int row = r + 8 * u + q;
      const bool ok = row < rb;
      raw[u] = ok ? w4_load16(w, row, c0, N, total, w_vec) : make_uint4(0, 0, 0, 0);
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int m = 0; m < MR; ++m)
          xv[u][p][m] = ok && m < M ? w4_x(x, (size_t)m * K + p * half + row) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (r + 8 * u >= rb) break;  // the same for the whole warp
      if (r + 8 * u + q < rb) {
#pragma unroll
        for (int p = 0; p < 2; ++p)
          if (sg[p] != grow[p]) {
            w4_scales16(s[p], sc, grow[p], c0, N, s_vec);
            sg[p] = grow[p];
          }
      }
#pragma unroll
      for (int wi = 0; wi < 4; ++wi) {
        const uint32_t word = w4_word(raw[u], wi);
        const uint32_t ul = nibbles_biased(word, 0), uh = nibbles_biased(word, 4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 4 * wi + e;
          float wlo = __fmul_rn(int4_f32(ul, e), s[0][c]);
          float whi = __fmul_rn(int4_f32(uh, e), s[1][c]);
          if constexpr (!F32) {  // bf16(q * s), the f32 product rounded once
            wlo = __bfloat162float(__float2bfloat16_rn(wlo));
            whi = __bfloat162float(__float2bfloat16_rn(whi));
          }
#pragma unroll
          for (int m = 0; m < MR; ++m)
            acc[c][m] = fmaf(xv[u][1][m], whi, fmaf(xv[u][0][m], wlo, acc[c][m]));
        }
      }
#pragma unroll
      for (int p = 0; p < 2; ++p)
        for (gp[p] += 8; gp[p] >= group; gp[p] -= group) ++grow[p];
    }
  }
  float mine[2][MR];
  quad_reduce_scatter<MR>(acc, mine, lane);
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int m = 0; m < MR; ++m) red[warp][m][l4 * 16 + 2 * q + c] = mine[c][m];
  w4_strip_store<MR, kW4GemvCols>(red, part_out, nw, S, rank, y, M, N, n0);
}

// A cluster launch of `kernel` on strips of `cols` columns, `nw` warps a
// block (`smem` bytes of dynamic shared memory), K split into `nch` chunks:
// a cluster of 2, 4 or 8 blocks splits K where the strips and rows alone
// give fewer than ~2 blocks an SM and the warps fewer slices than chunks.
template <typename Kernel, typename... Args>
inline cudaError_t launch_w4_decode(Kernel kernel, int cols, int nw, long long nch, int smem,
                                    int M, int N, const int* idx, cudaStream_t s,
                                    Args... args) {
  const int strips = (N + cols - 1) / cols, rows = idx ? M : 1;
  int S = 1;
  while (S < 8 && (long long)strips * rows * S < 2 * 132 && (long long)S * nw < nch) S *= 2;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(strips * S, 1, rows);
  cfg.blockDim = dim3(32 * nw);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = S > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, args..., S);
}

template <int KSTEP, bool ALIGNED>
inline cudaError_t launch_w4_gemv_mma(const __nv_bfloat16* x, const int8_t* w, const float* sc,
                                      float* y, int M, int K, int N, int group, const int* idx,
                                      cudaStream_t s) {
  using Ring = W4MmaRing<KSTEP, ALIGNED>;
  const long long nch = (K / 2) / group;
  const int nw = static_cast<int>(std::min<long long>(kW4MmaWarps, nch));
  // the rings; after them the sums, red [warps][8][cols] and part_out
  // [8][cols], in the same bytes: at least 8 KB a warp holds both
  const int smem = std::max(Ring::WARP, 2 * 8 * kW4MmaCols * 4) * nw;
  return launch_w4_decode(w4_gemv_mma<KSTEP, ALIGNED>, kW4MmaCols, nw, nch, smem, M, N, idx, s,
                          x, w, sc, y, M, K, N, group, idx);
}

// The decode form: M <= w4_decode_rows(form) rows, or the expert-indexed
// entry (any M, one row a block). bmode as w4_gemm.cu takes it (f32 x: the exact
// form). Returns the launch's error.
template <typename AT>
inline cudaError_t launch_w4_gemv(const AT* x, const int8_t* w, const float* sc, float* y,
                                  int M, int K, int N, int group, int bmode, const int* idx,
                                  cudaStream_t s) {
  if (M == 0 || N == 0) return cudaSuccess;
  const int half = K / 2;
  if constexpr (sizeof(AT) == 2) {
    if (bmode == W4_GROUP_ACC) {
      const bool aligned = N % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
      if (group % 16)
        return aligned ? launch_w4_gemv_mma<8, true>(x, w, sc, y, M, K, N, group, idx, s)
                       : launch_w4_gemv_mma<8, false>(x, w, sc, y, M, K, N, group, idx, s);
      return aligned ? launch_w4_gemv_mma<16, true>(x, w, sc, y, M, K, N, group, idx, s)
                     : launch_w4_gemv_mma<16, false>(x, w, sc, y, M, K, N, group, idx, s);
    }
  }
  const long long nch = (half + 7) / 8;  // octets of rows
  const int nw = static_cast<int>(std::min<long long>(kW4GemvWarps, nch));
  if (idx || M == 1)
    return launch_w4_decode(w4_gemv<AT, 1>, kW4GemvCols, nw, nch, 0, M, N, idx, s, x,
                            w, sc, y, M, K, N, group, idx);
  if (M == 2)
    return launch_w4_decode(w4_gemv<AT, 2>, kW4GemvCols, nw, nch, 0, M, N, idx, s, x,
                            w, sc, y, M, K, N, group, idx);
  return launch_w4_decode(w4_gemv<AT, 4>, kW4GemvCols, nw, nch, 0, M, N, idx, s, x, w,
                          sc, y, M, K, N, group, idx);
}

}  // namespace lele
