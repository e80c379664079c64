// w4a16 GEMM for Hopper: y[M,N] = x[M,K] @ W[K,N] with W stored as groupwise
// int4, optionally with a fused epilogue (bias, ReLU, residual add). Used by
// w4_gemm.cu (kernel 7: the CTC head and every MatMulNBits the compiler
// routes here); sanm_stack.cu (kernel 8) takes its unpacking helpers and
// the W4_DEQ_BF16 arithmetic for the w4 stack's tiles.
//
// Replaces lele_tpu/kernels/w4_matmul.py:w4_matmul_pallas and the `_w4dot`
// of lele_tpu/kernels/sanm_block.py.
//
// Layout (the JAX package's block packing): packed int8 [K/2, N], byte i of a
// column holds q[i] in its low nibble and q[i + K/2] in its high nibble, q in
// [-8, 7]; scales f32 [K/group, N].
//
// Two forms of B, chosen at compile time:
//  - W4_GROUP_ACC (kernel 7, bf16 x): B is the raw int4 value, exact in bf16.
//    Each scale group's product goes into an f32 partial, which is multiplied
//    by the group's scale row at the group's last k-step and added to the
//    accumulator, as the TPU kernel's group-accumulator form does. Scales
//    never touch the [K, N] operand.
//  - W4_DEQ_BF16 (groups the other form does not take, and the w4 SAN-M
//    stack's arithmetic): B is bf16(q * s), rounded once from the f32
//    product, exactly as `_w4dot` dequantises; then one f32 sum.
// f32 x (kernel 7's exact form) runs as true f32 FMA on the tile dequantised
// in f32 (q * s), as w8_gemm's f32 path does.
//
// What bounds it on the H100: at the main path's shapes (M = T ~ 20..1000
// rows, K = 512/2048, N = 512..25055) the product is skinny. The CTC head
// moves 24.1 MB (its f32 output is 71% of it) in 7.2 us at 3.35 TB/s, and
// needs 4.4 GFLOP (4.4 us of bf16 tensor cores): it is bound by bytes. At
// T ~ 171 a layer's GEMMs are launch- and latency-bound, as the w8 ones.
// The design:
//  - the K walk goes over packed rows in tiles of 32. Each packed byte is
//    loaded once (16-byte loads; rows of an odd N, as the CTC head's 25,055,
//    are read as aligned words and shifted into place) and unpacked into
//    both planes' bf16 B tiles in shared memory: 32 k-rows of the low plane
//    (logical rows k0..) and 32 of the high plane (logical rows K/2 + k0..).
//    The matching A columns of both planes come with them.
//  - the next tile is fetched into registers while the tensor cores
//    (`mma.sync.m16n8k16`, bf16 operands, f32 sums) work on the current one.
//  - shapes: any even K and any group from 1 to 512. The tail of K/2 past
//    the last whole tile is zero-filled in the loads. The group-accumulator
//    form takes groups that are multiples of 8 and divide K/2: a k-step of
//    16 rows (`m16n8k16`) where the group is a multiple of 16, of 8 rows
//    (`m16n8k8`) otherwise, so a k-step lies in one group. The
//    dequantised-tile form takes any group. Running counters track each
//    plane's group: a division by the runtime group on the serial K walk
//    cost 18% of the CTC head and 8% of the stack (PERF.md).
//  - the expert-indexed entry (QMoE decode) and every M <= 4 take the
//    decode form (w4_gemv.cuh).
//  - unpacking: a byte permute and one bf16x2 subtract give two exact bf16
//    int4 values; the stack's bf16(q * s) takes a permute and an add a value
//    for q and one paired f32 → bf16 conversion.
//  - tiles as w8_gemm's, except that the group form stops at 32 x 64: its
//    two partial accumulators take 179 registers at 64 x 64, two blocks an
//    SM, against 110 and four (the CTC head 13% faster; PERF.md).
// Not yet done (a later change): a deeper cp.async/TMA pipeline, split-K
// for the N = 512 linears, wgmma; at K = 2048, N = 512 the kernel is still
// ~1.7x w8_gemm's time, not understood (no ncu on the card's machine). Few
// rows take the decode form (w4_gemv.cuh).
#pragma once

#include "w8_gemm.cuh"

namespace lele {

enum W4BMode : int {
  W4_GROUP_ACC = 0,  // raw int4 B, scale on each group's f32 partial
  W4_DEQ_BF16 = 1,   // B = bf16(q * s) per element
};

struct W4Epilogue {
  const float* bias;  // [N] or null
  const float* res;   // [M, N] or null; may alias y (read before the write)
  int relu;           // ReLU after bias, before the residual
};

__device__ __forceinline__ float w4_epilogue(float v, int m, int n, int N,
                                             const W4Epilogue& ep) {
  if (ep.bias) v += ep.bias[n];
  if (ep.relu) v = fmaxf(v, 0.f);
  if (ep.res) v = ep.res[(size_t)m * N + n] + v;
  return v;
}

// the sign-extended low and high nibbles of a byte held in the low 8 bits
__device__ __forceinline__ int nib_lo(uint32_t b) { return static_cast<int>(b << 28) >> 28; }
__device__ __forceinline__ int nib_hi(uint32_t b) { return static_cast<int>(b << 24) >> 28; }

// The nibbles at bit `sh` (0: low, 4: high) of the four bytes of w, each as
// the byte q + 8 in [0, 15]: q is stored in two's complement, so q + 8 is
// the nibble with its top bit flipped.
__device__ __forceinline__ uint32_t nibbles_biased(uint32_t w, int sh) {
  return ((w >> sh) & 0x0F0F0F0Fu) ^ 0x08080808u;
}

// Bytes 2j and 2j + 1 of u (each q + 8) → the bf16 pair (q, q'), exactly:
// 0x4300 | (q + 8) is the bf16 of 128 + q + 8, and 136 is subtracted.
__device__ __forceinline__ uint32_t int4_pair_bf16(uint32_t u, int j) {
  const uint32_t t = __byte_perm(u, 0x43u, j ? 0x4342 : 0x4140);
  const __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&t),
                                   __float2bfloat162_rn(136.f));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// Byte k of u (q + 8) → q as f32, exactly: 0x4B000000 | (q + 8) is the f32
// of 2^23 + q + 8.
__device__ __forceinline__ float int4_f32(uint32_t u, int k) {
  return __int_as_float(__byte_perm(u, 0x4Bu, 0x4550 | k)) - 8388616.f;
}

// B fragment of m16n8k8 from a [k][n] tile: lanes 0-7 address rows k..k+7
__device__ __forceinline__ void ldsm_x1_trans(uint32_t& r, const uint16_t* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x1.trans.shared.b16 {%0}, [%1];\n"
               : "=r"(r)
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16_1688(float (&d)[4], const uint32_t (&a)[2],
                                              uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}

__device__ __forceinline__ uint32_t bf16_pair_rn(float a, float b) {
  const __nv_bfloat162 r = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&r);
}

// Tensor-core path. 4 warps in a 2 x 2 layout; each warp owns a
// (BM/2) x (BN/2) sub-tile: BM/32 m16 tiles by BN/16 n8 tiles. A tile covers
// BKP = 32 packed rows: 32 / KSTEP k-steps of the low plane and as many of
// the high plane. A is stored [plane][m][k] and read as 32-bit pairs; B
// [plane][k][n], read with ldmatrix.trans. Rows are padded by 8 elements:
// fragment reads are conflict free.
template <int BM, int BN, typename AT, int BMODE, int KSTEP = 16>
__global__ void __launch_bounds__(128)
w4_gemm_mma(const AT* __restrict__ x, const int8_t* __restrict__ w,
            const float* __restrict__ sc, float* y, int M, int K, int N, int group,
            W4Epilogue ep) {
  static_assert(KSTEP == 16 || (KSTEP == 8 && BMODE == W4_GROUP_ACC), "k-step");
  constexpr int BKP = 32, LDA = BKP + 8, LDB = BN + 8;
  constexpr int MI = BM / 32, NI = BN / 16;
  constexpr int A_VEC = 16 / sizeof(AT);        // elements per 16-byte chunk
  constexpr int A_TOTAL = BM * BKP / A_VEC;     // chunks per plane
  constexpr int A_CHUNKS = (A_TOTAL + 127) / 128;
  constexpr int B_TOTAL = BKP * BN / 16;
  constexpr int B_CHUNKS = (B_TOTAL + 127) / 128;
  constexpr bool DEQ = BMODE == W4_DEQ_BF16;
  __shared__ __align__(16) uint16_t As[2][BM][LDA];   // bf16 bits
  __shared__ __align__(16) uint16_t Bs[2][BKP][LDB];  // bf16 bits
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int g = lane >> 2, tg = lane & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int half = K / 2;
  // whole 16-byte chunks of A where each plane's rows start aligned
  const bool a_vec = (half % A_VEC == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  const bool b_vec = (N % 16 == 0) && (reinterpret_cast<uintptr_t>(w) % 16 == 0);
  const bool s_vec = (N % 4 == 0) && (reinterpret_cast<uintptr_t>(sc) % 16 == 0);

  uint4 ra[2][A_CHUNKS], rb[B_CHUNKS];  // the next tile, raw
  // W4_DEQ_BF16: the scales of the thread's B chunks in the next tile, and
  // the group of each chunk's row in it: its scale row and the row's place
  // in it (running counters, so that the K walk divides by the runtime
  // group only here)
  float rs[DEQ ? B_CHUNKS : 1][2][DEQ ? 16 : 1];
  int nx_row[DEQ ? B_CHUNKS : 1][2], nx_pos[DEQ ? B_CHUNKS : 1][2];
  if constexpr (DEQ) {
#pragma unroll
    for (int i = 0; i < B_CHUNKS; ++i)
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int lk = p * half + (tid + i * 128) / (BN / 16);
        nx_row[i][p] = lk / group;
        nx_pos[i][p] = lk % group;
      }
  }

  auto load_tile = [&](int k0) {
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int i = 0; i < A_CHUNKS; ++i) {
        const int c = tid + i * 128;
        if (c >= A_TOTAL) break;
        const int r = c / (BKP / A_VEC), cc = (c % (BKP / A_VEC)) * A_VEC;
        const int gm = m0 + r, kp = k0 + cc;  // a_vec: a chunk below half is whole
        const size_t off = (size_t)gm * K + p * half + kp;
        if (gm < M && kp < half && a_vec) {
          ra[p][i] = *reinterpret_cast<const uint4*>(x + off);
        } else {
          __align__(16) AT v[A_VEC];
#pragma unroll
          for (int e = 0; e < A_VEC; ++e)
            v[e] = (gm < M && kp + e < half) ? x[off + e] : AT(0.f);
          ra[p][i] = *reinterpret_cast<const uint4*>(v);
        }
      }
#pragma unroll
    for (int i = 0; i < B_CHUNKS; ++i) {
      const int c = tid + i * 128;
      if (c >= B_TOTAL) break;
      const int r = c / (BN / 16), cc = (c % (BN / 16)) * 16;
      const int kp = k0 + r, gn = n0 + cc;
      const size_t off = (size_t)kp * N + gn;
      if (kp < half && b_vec && gn + 16 <= N) {
        rb[i] = *reinterpret_cast<const uint4*>(w + off);
      } else if (kp < half && gn + 16 <= N && off + 20 <= (size_t)half * N) {
        // an unaligned row (odd N): five aligned words, shifted into place
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
          v[e] = (kp < half && gn + e < N) ? w[(size_t)kp * N + gn + e] : int8_t(0);
        rb[i] = *reinterpret_cast<const uint4*>(v);
      }
      if constexpr (DEQ) {
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const float* srow = sc + (size_t)nx_row[i][p] * N + gn;
          for (nx_pos[i][p] += BKP; nx_pos[i][p] >= group; nx_pos[i][p] -= group)
            ++nx_row[i][p];
          if (kp < half && s_vec && gn + 16 <= N) {
#pragma unroll
            for (int e = 0; e < 16; e += 4) {
              const float4 f = *reinterpret_cast<const float4*>(srow + e);
              rs[i][p][e] = f.x, rs[i][p][e + 1] = f.y, rs[i][p][e + 2] = f.z,
              rs[i][p][e + 3] = f.w;
            }
          } else {
#pragma unroll
            for (int e = 0; e < 16; ++e)
              rs[i][p][e] = (kp < half && gn + e < N) ? srow[e] : 0.f;
          }
        }
      }
    }
  };

  auto store_tile = [&]() {
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int i = 0; i < A_CHUNKS; ++i) {
        const int c = tid + i * 128;
        if (c >= A_TOTAL) break;
        const int r = c / (BKP / A_VEC), cc = (c % (BKP / A_VEC)) * A_VEC;
        if constexpr (sizeof(AT) == 4) {
          const float* f = reinterpret_cast<const float*>(&ra[p][i]);
          uint2 packed;
          packed.x = bf16_bits(f[0]) | (uint32_t(bf16_bits(f[1])) << 16);
          packed.y = bf16_bits(f[2]) | (uint32_t(bf16_bits(f[3])) << 16);
          *reinterpret_cast<uint2*>(&As[p][r][cc]) = packed;
        } else {
          *reinterpret_cast<uint4*>(&As[p][r][cc]) = ra[p][i];
        }
      }
#pragma unroll
    for (int i = 0; i < B_CHUNKS; ++i) {
      const int c = tid + i * 128;
      if (c >= B_TOTAL) break;
      const int r = c / (BN / 16), cc = (c % (BN / 16)) * 16;
      const uint32_t* words = reinterpret_cast<const uint32_t*>(&rb[i]);
      uint32_t lo[8], hi[8];
#pragma unroll
      for (int wi = 0; wi < 4; ++wi) {
        const uint32_t ul = nibbles_biased(words[wi], 0), uh = nibbles_biased(words[wi], 4);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if constexpr (DEQ) {  // bf16(q * s), the f32 product rounded once
            const int e = 4 * wi + 2 * j;
            lo[2 * wi + j] = bf16_pair_rn(int4_f32(ul, 2 * j) * rs[i][0][e],
                                          int4_f32(ul, 2 * j + 1) * rs[i][0][e + 1]);
            hi[2 * wi + j] = bf16_pair_rn(int4_f32(uh, 2 * j) * rs[i][1][e],
                                          int4_f32(uh, 2 * j + 1) * rs[i][1][e + 1]);
          } else {
            lo[2 * wi + j] = int4_pair_bf16(ul, j);
            hi[2 * wi + j] = int4_pair_bf16(uh, j);
          }
        }
      }
      *reinterpret_cast<uint4*>(&Bs[0][r][cc]) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
      *reinterpret_cast<uint4*>(&Bs[0][r][cc + 8]) = make_uint4(lo[4], lo[5], lo[6], lo[7]);
      *reinterpret_cast<uint4*>(&Bs[1][r][cc]) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(&Bs[1][r][cc + 8]) = make_uint4(hi[4], hi[5], hi[6], hi[7]);
    }
  };

  float acc[MI][NI][4];
  // W4_GROUP_ACC: each plane's open group, its f32 partial and its scale row
  // at the thread's two columns of each n8 tile
  float part[DEQ ? 1 : 2][MI][NI][4];
  float ps[DEQ ? 1 : 2][NI][2];
  // each plane's next k-step: its place in its group and the group's scale
  // row (the high plane starts at logical k = K/2, a group boundary: this
  // form takes only groups that divide K/2)
  int gpos[2] = {0, 0}, grow[2] = {0, half / group};
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  load_tile(0);
  store_tile();
  __syncthreads();
  for (int k0 = 0; k0 < half; k0 += BKP) {
    const bool has_next = k0 + BKP < half;
    if (has_next) load_tile(k0 + BKP);  // in flight during the MMAs below
#pragma unroll
    for (int p = 0; p < 2; ++p) {
#pragma unroll
      for (int kk = 0; kk < BKP; kk += KSTEP) {
        const int kp = k0 + kk;
        if (kp >= half) break;  // the same for the whole block
        if constexpr (!DEQ) {
          if (gpos[p] == 0) {  // a group opens
            const float* srow = sc + (size_t)grow[p] * N;
#pragma unroll
            for (int ni = 0; ni < NI; ++ni) {
              const int c = n0 + wn * (BN / 2) + ni * 8 + tg * 2;
              ps[p][ni][0] = c < N ? __ldg(srow + c) : 0.f;
              ps[p][ni][1] = c + 1 < N ? __ldg(srow + c + 1) : 0.f;
            }
#pragma unroll
            for (int mi = 0; mi < MI; ++mi)
#pragma unroll
              for (int ni = 0; ni < NI; ++ni)
#pragma unroll
                for (int e = 0; e < 4; ++e) part[p][mi][ni][e] = 0.f;
          }
        }
        if constexpr (KSTEP == 16) {
          uint32_t a[MI][4], b[NI][2];
#pragma unroll
          for (int mi = 0; mi < MI; ++mi) {
            const int r = wm * (BM / 2) + mi * 16 + g;
            a[mi][0] = ld_pair(&As[p][r][kk + tg * 2]);
            a[mi][1] = ld_pair(&As[p][r + 8][kk + tg * 2]);
            a[mi][2] = ld_pair(&As[p][r][kk + tg * 2 + 8]);
            a[mi][3] = ld_pair(&As[p][r + 8][kk + tg * 2 + 8]);
          }
#pragma unroll
          for (int ni = 0; ni < NI; ++ni)
            ldsm_x2_trans(b[ni], &Bs[p][kk + (lane & 15)][wn * (BN / 2) + ni * 8]);
#pragma unroll
          for (int mi = 0; mi < MI; ++mi)
#pragma unroll
            for (int ni = 0; ni < NI; ++ni) {
              if constexpr (DEQ) mma_bf16_16816(acc[mi][ni], a[mi], b[ni]);
              else mma_bf16_16816(part[p][mi][ni], a[mi], b[ni]);
            }
        } else {  // k-steps of 8 rows, for groups that are not multiples of 16
          uint32_t a[MI][2], b[NI];
#pragma unroll
          for (int mi = 0; mi < MI; ++mi) {
            const int r = wm * (BM / 2) + mi * 16 + g;
            a[mi][0] = ld_pair(&As[p][r][kk + tg * 2]);
            a[mi][1] = ld_pair(&As[p][r + 8][kk + tg * 2]);
          }
#pragma unroll
          for (int ni = 0; ni < NI; ++ni)
            ldsm_x1_trans(b[ni], &Bs[p][kk + (lane & 7)][wn * (BN / 2) + ni * 8]);
#pragma unroll
          for (int mi = 0; mi < MI; ++mi)
#pragma unroll
            for (int ni = 0; ni < NI; ++ni) mma_bf16_1688(part[p][mi][ni], a[mi], b[ni]);
        }
        if constexpr (!DEQ) {
          gpos[p] += KSTEP;
          if (gpos[p] == group) gpos[p] = 0, ++grow[p];
          if (gpos[p] == 0) {  // the group closes
#pragma unroll
            for (int mi = 0; mi < MI; ++mi)
#pragma unroll
              for (int ni = 0; ni < NI; ++ni)
#pragma unroll
                for (int e = 0; e < 4; ++e)
                  acc[mi][ni][e] += part[p][mi][ni][e] * ps[p][ni][e & 1];
          }
        }
      }
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
        if (m < M && n < N) y[(size_t)m * N + n] = w4_epilogue(acc[mi][ni][e], m, n, N, ep);
      }
    }
  }
}

// f32 path: true f32 FMA on the tile dequantised in f32, 64 x 64 outputs,
// 256 threads with 4 x 4 outputs each (strided by 16 so shared reads and
// global stores stay coalesced). A tile is 16 packed rows: each byte is read
// once and feeds the low and the high plane.
__global__ void __launch_bounds__(256)
w4_gemm_f32(const float* __restrict__ x, const int8_t* __restrict__ w,
            const float* __restrict__ sc, float* y, int M, int K, int N, int group,
            W4Epilogue ep) {
  constexpr int BM = 64, BN = 64, BKP = 16;
  __shared__ float As[2][BKP][BM + 4];  // [plane][k][m]
  __shared__ float Bs[2][BKP][BN];      // [plane][k][n]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int half = K / 2;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < half; k0 += BKP) {
    for (int i = tid; i < BM * BKP; i += 256) {
      const int r = i / BKP, c = i % BKP, gm = m0 + r, kp = k0 + c;
      const bool ok = gm < M && kp < half;
      As[0][c][r] = ok ? x[(size_t)gm * K + kp] : 0.f;
      As[1][c][r] = ok ? x[(size_t)gm * K + half + kp] : 0.f;
    }
    for (int i = tid; i < BKP * BN; i += 256) {
      const int r = i / BN, c = i % BN, kp = k0 + r, gn = n0 + c;
      float lo = 0.f, hi = 0.f;
      if (kp < half && gn < N) {
        const uint32_t b = static_cast<uint8_t>(w[(size_t)kp * N + gn]);
        lo = static_cast<float>(nib_lo(b)) * sc[(size_t)(kp / group) * N + gn];
        hi = static_cast<float>(nib_hi(b)) * sc[(size_t)((half + kp) / group) * N + gn];
      }
      Bs[0][r][c] = lo;
      Bs[1][r][c] = hi;
    }
    __syncthreads();
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int k = 0; k < BKP; ++k) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[p][k][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = Bs[p][k][tx + 16 * j];
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
      if (m < M && n < N) y[(size_t)m * N + n] = w4_epilogue(acc[i][j], m, n, N, ep);
    }
}

// the shapes kernel 8's stack takes: K/2 and the group multiples of 16
inline bool w4_stack_shape_ok(int K, int group) {
  return K % 32 == 0 && group >= 16 && group % 16 == 0;
}

// the shapes kernel 7 takes: any even K, any group from 1 to 512 that
// divides K; the group-accumulator form also needs the group to be a
// multiple of 8 that divides K/2
inline bool w4_shape_ok(int K, int group, int bmode) {
  if (K < 2 || K % 2 || group < 1 || group > 512 || K % group) return false;
  return bmode == W4_DEQ_BF16 || (group % 8 == 0 && (K / 2) % group == 0);
}

template <int BM, int BN, typename AT, int BMODE>
inline void launch_w4_tile(const AT* x, const int8_t* w, const float* sc, float* y, int M,
                           int K, int N, int group, const W4Epilogue& ep, cudaStream_t s) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if constexpr (BMODE == W4_GROUP_ACC) {
    if (group % 16) {
      w4_gemm_mma<BM, BN, AT, BMODE, 8><<<grid, 128, 0, s>>>(x, w, sc, y, M, K, N, group, ep);
      return;
    }
  }
  w4_gemm_mma<BM, BN, AT, BMODE><<<grid, 128, 0, s>>>(x, w, sc, y, M, K, N, group, ep);
}

template <int BMODE, typename AT>
inline void launch_w4_gemm_mma(const AT* x, const int8_t* w, const float* sc, float* y,
                               int M, int K, int N, int group, const W4Epilogue& ep,
                               cudaStream_t s) {
  if (M == 0 || N == 0) return;
  // the largest tile that still gives the 132 SMs enough blocks; the group
  // form holds two partial accumulators, and at 64 x 64 its registers (179)
  // leave two blocks an SM, so it stops at 32 x 64 (110)
  auto blocks = [&](int bm, int bn) { return ((M + bm - 1) / bm) * ((N + bn - 1) / bn); };
  if (BMODE == W4_DEQ_BF16 && blocks(64, 64) >= 2 * 132)
    launch_w4_tile<64, 64, AT, BMODE>(x, w, sc, y, M, K, N, group, ep, s);
  else if (blocks(32, 64) >= 132)
    launch_w4_tile<32, 64, AT, BMODE>(x, w, sc, y, M, K, N, group, ep, s);
  else
    launch_w4_tile<32, 32, AT, BMODE>(x, w, sc, y, M, K, N, group, ep, s);
}

inline void launch_w4_gemm_f32(const float* x, const int8_t* w, const float* sc, float* y,
                               int M, int K, int N, int group, const W4Epilogue& ep,
                               cudaStream_t s) {
  if (M == 0 || N == 0) return;
  const dim3 grid((N + 63) / 64, (M + 63) / 64);
  w4_gemm_f32<<<grid, 256, 0, s>>>(x, w, sc, y, M, K, N, group, ep);
}

}  // namespace lele
