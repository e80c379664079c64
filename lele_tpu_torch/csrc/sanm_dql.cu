// L SAN-M encoder layers of a compiled int8 ONNX graph, with exact ONNX
// DynamicQuantizeLinear semantics in each of the four linears (kernel 4), as
// one persistent launch that loops over the layers on the card. Replaces
// lele_tpu/kernels/sanm_block.py:sanm_stack_dql_pallas (`_stack_kernel_dql`,
// `_dql_dot`). One cooperative launch of two CTAs of 128 threads an SM walks
// the layers, each as eleven grid-wide phases between grid barriers, the
// activation x [T, D] f32 updated in place:
//
//   1. h = LN1(x), eps1          a row a warp (ONNX LayerNormalization's
//                                arithmetic); folds max(h, 0), max(-h, 0)
//   2. codes = q(h)              the whole grid quantizes h once
//   3. qkv = dql(h)              f32 out
//   4. a = attn + FSMN           one CTA a (head, 16 queries, part of the
//                                keys): f32 attention under the graph's key
//                                bias, products as 3xTF32 on mma.sync (never
//                                one TF32 or bf16 product), online softmax,
//                                the 4 warps splitting each 32-key tile, the
//                                warps and the key parts merged in a fixed
//                                order; + the FSMN over v * vmask with the
//                                graph's left pad; folds the range of a
//   5. codes = q(a)
//   6. x += dql(a)               K split while tiles are few
//   7. h = LN2(x), eps2          as 1
//   8. codes = q(h)
//   9. f = relu(dql(h))          folds the range of f
//  10. codes = q(f)
//  11. x += dql(f)               K split in up to 4 parts
//
// DQL needs each activation's global min and max before its GEMM. The
// producer phase folds its outputs into max(v, 0) and max(-v, 0) of its
// layer's pair with one atomicMax a warp on the floats' bits (dq_gemm.cuh
// range_update / range_commit: exact in any order). After the barrier, the
// quantize phase and every GEMM tile read the pair through L2 and derive
// scale and zero point with dq_gemm.cuh's dql_params arithmetic, so every
// CTA quantizes alike; the codes are dq_gemm.cuh's dql_code (the same IEEE
// division, rintf and clamps as the plain version), bit for bit. The pairs
// and the split counters are zeroed by CTA 0 before a first grid barrier,
// inside the launch. The kernel pads no rows: every range covers exactly the
// graph's T rows.
//
// Why the codes get a phase of their own: a CTA here moves ~7 GB/s through
// 16-byte cp.async (PERF.md), so a GEMM tile's time follows the bytes it
// streams. Quantizing each tile's own f32 A rows in the ring (12 KB a k
// step) measured 30-39 us a linear's phase; the i8 codes are a quarter of
// those bytes, for one more barrier (~1.3 us) a linear.
//
// The GEMM phases: 32 x 64 output tiles; a 6-stage cp.async ring carries
// each 64-deep k step's int8 weight rows, as the card holds them ([k][n]),
// and the A codes. The weight fragments of mma.sync.m16n8k32 (s8 x s8 ->
// s32) come from 4 rows' words by a 4 x 4 byte transpose in registers
// (dq_gemm.cuh transpose4x4), which permutes a warp's columns: lane (g, t)
// of n8 tile j holds columns 8 t + j and 8 t + j + 4, so each thread's
// outputs are 8 consecutive columns of a row. Integer sums are exact in any
// order, so the split K (int32 partials, the last part to arrive adds them
// up) keeps the GEMM's bits; the epilogue is dq_gemm.cuh's, with _rn
// intrinsics.
//
// The attention: at T = 196 the (head, 16 queries) items are 52 for 264
// CTAs, and each streams every key's f32 K and V (1 KB a key at hd 128).
// So an item's keys are split in up to 8 parts, one CTA a part; each part
// leaves its rows' (max, sum, O) in a record and the last part to arrive
// merges the records in part order.
//
// What bounds it on the H100, at 10 s of audio (T = 196): the int8 weights
// stream once, 3,145,728 B a layer, 157.3 MB for 50 layers, ~47 us at
// 3.35 TB/s; the int8 products are 61.7 GOP, ~31 us at 1,979 TOP/s; the f32
// attention is ~3.9 GFLOP, ~58 us at 67 TFLOP/s on the CUDA cores, or 3
// TF32 products of it at 495 TFLOP/s, ~24 us; 551 grid barriers, ~0.7 ms.
// What sets the time is each phase's bytes through each CTA's cp.async and
// its chain of dependent latencies with 4 warps a CTA, as for
// csrc/sanm_stack.cu: PERF.md has the phase timer's numbers
// (kernels.sanm_block.dql_phase_us).
//
// Stream capture takes the cooperative launch. The data one phase writes
// and a later one reads (x, h, qkv, a, f, the codes, the pairs, the split
// partials, the attention records) is read with ld.global.cg or
// cp.async.cg. Only the owner of an output tile reads and writes its rows of
// x in phases 6 and 11. No float atomics: the output is the same bits on a
// repeat call and in a CUDA-graph replay.
#include "dq_gemm.cuh"
#include "grid_stack.cuh"

namespace lele {
namespace dql {

using namespace stk;

constexpr int BM = 32;          // GEMM rows a tile (2 warps of 16)
constexpr int BN = 64;          // GEMM columns a tile (2 warps of 32)
constexpr int BK = 64;          // k a ring step
constexpr int STAGES = 6;       // ring depth
constexpr int MAX_PER_SM = 2;   // CTAs an SM
constexpr int SPLIT_MAX = 4;    // K splits of the residual linears, at most
constexpr int QROWS = 16;       // queries an attention item
constexpr int KEYS = 32;        // keys a tile (8 a warp)
constexpr int KSPLIT_MAX = 4;   // parts an attention item's keys are split in, at most
constexpr int FSMN_KMAX = 16;   // most FSMN taps
// a layer's: LN1, quantize, qkv, attention + FSMN, quantize, out, LN2,
// quantize, ffn1, quantize, ffn2
constexpr int PHASES = 11;

struct Args {
  float* x;                     // [T, D] f32, updated in place
  int T, D, H, F, L, fsmn_k, pad_left;
  float eps1, eps2, att_scale;
  const float* bias;            // [L, T] the graph's key bias
  const float* vmask;           // [L, T] the FSMN's value mask
  const int8_t* w[4];           // layer 0 of each linear (qkv, out, ffn1, ffn2): [K, N]
  const int* colsum[4];         // [N]
  const float* ws[4];           // [N]
  const float* b[4];            // [N]
  const float *g1, *b1, *g2, *b2;  // [D]
  const float* fsmn;            // [fsmn_k, D]
  float* h;                     // [T, D] LN1(x) or LN2(x)
  float* qkv;                   // [T, 3D]
  float* a;                     // [T, D] ctx + FSMN
  float* f;                     // [T, F] relu(ffn1)
  int8_t* codes;                // [T, kp(max(D, F))] the i8 codes of a linear's input
  int* part;                    // [SPLIT_MAX, T, D] int32 partial sums
  float* apart;                 // attention items' key-split partials (attn_rec floats each)
  int* acnt;                    // [H x query tiles] the key splits of each item that are in
  int* cnt;                     // [row tiles x column tiles of D] the parts of each tile in
  int* mm;                      // [L, 4, 2] bits of max(v, 0), max(-v, 0) of each linear's input
  // null, or PHASES L + 1 + PHASES DETAIL int64: the global timer (ns)
  // after the first barrier and after each phase's barrier; then, for layer
  // 1 in CTA 0, stamps inside each phase's first work item (see stamp)
  long long* trace;
};

// stamp k of phase p (layer 1, CTA 0, its first item): GEMM tiles 0 start,
// 1 ring primed, 2 + s step s's data in (s < 11), 13 steps done, 14 stored;
// attention 0 start, 1 taps staged, 2 first key tile in, 3 keys done, 4 the
// warps merged, 5 the part's O (and FSMN) formed, 6 the part's record in and
// the last part known, 7 stored
__device__ __forceinline__ void stamp(const Args& a, int l, int p, int k, bool first) {
  stamp_at(a.trace, PHASES, a.L, l, p, k, first);
}

// a row of codes: K rounded up to 16 bytes, so every row starts 16-byte aligned
__host__ __device__ __forceinline__ int kp(int K) { return (K + 15) / 16 * 16; }

__device__ __forceinline__ void lin_dims(const Args& a, int i, int& K, int& N) {
  K = i == 3 ? a.F : a.D;
  N = i == 0 ? 3 * a.D : i == 2 ? a.F : a.D;
}

// ---------------------------------------------------------------------------
// LayerNorm

// One row of ONNX LayerNormalization, by one warp: mean, two-pass variance,
// 1 / sqrt(var + eps), (x - mean) * inv * g + b, each rounded as its emitter
// (the _rn intrinsics: no contraction); the row's outputs folded into the
// lane's (pos, neg). Every load is issued before any store.
__device__ __forceinline__ void ln_row(float* dst, const float* xr, int D, const float* g,
                                       const float* b, float eps, float& pos, float& neg) {
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
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < R; ++j) s += xv[j];
  for (int i = lane + 32 * R; i < D; i += 32) s += __ldcg(xr + i);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  const float mu = __fdiv_rn(s, static_cast<float>(D));
  float s2 = 0.f;
#pragma unroll
  for (int j = 0; j < R; ++j)
    if (lane + 32 * j < D) {
      const float d = __fsub_rn(xv[j], mu);
      s2 = fmaf(d, d, s2);
    }
  for (int i = lane + 32 * R; i < D; i += 32) {
    const float d = __fsub_rn(__ldcg(xr + i), mu);
    s2 = fmaf(d, d, s2);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s2 += __shfl_xor_sync(0xffffffffu, s2, o);
  const float inv = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(__fdiv_rn(s2, static_cast<float>(D)),
                                                        eps)));
  auto y = [&](float x, float gi, float bi) {
    const float v = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(x, mu), inv), gi), bi);
    range_update(v, pos, neg);
    return v;
  };
#pragma unroll
  for (int j = 0; j < R; ++j)
    if (lane + 32 * j < D) dst[lane + 32 * j] = y(xv[j], gv[j], bv[j]);
  for (int i = lane + 32 * R; i < D; i += 32) dst[i] = y(__ldcg(xr + i), __ldg(g + i), __ldg(b + i));
}

// LN1 or LN2 of every row of x into h, a row a warp over the whole grid
__device__ void ln_phase(const Args& a, int l, bool second) {
  constexpr int WARPS = THREADS / 32;
  const size_t lo = (size_t)l * a.D;
  const float* g = (second ? a.g2 : a.g1) + lo;
  const float* b = (second ? a.b2 : a.b1) + lo;
  const float eps = second ? a.eps2 : a.eps1;
  float pos = 0.f, neg = 0.f;
  for (int m = blockIdx.x * WARPS + (threadIdx.x >> 5); m < a.T; m += gridDim.x * WARPS)
    ln_row(a.h + (size_t)m * a.D, a.x + (size_t)m * a.D, a.D, g, b, eps, pos, neg);
  range_commit(pos, neg, a.mm + 8 * l + (second ? 4 : 0));
}

// ---------------------------------------------------------------------------
// GEMM tiles

constexpr int LDB = BN + 16;        // bytes a weight row of a stage
constexpr int LDA = BK + 16;        // bytes a row of codes of a stage
constexpr int B_BYTES = BK * LDB;
constexpr int STAGE = B_BYTES + BM * LDA;
constexpr int GEMM_BYTES = STAGES * STAGE;

// the input of linear `lin` (0 qkv, 1 out, 2 ffn1, 3 ffn2), f32 [T, K]
__device__ __forceinline__ const float* lin_src(const Args& a, int lin) {
  return lin == 0 || lin == 2 ? a.h : lin == 1 ? a.a : a.f;
}

// DQL's scale, safe scale and zero point of linear lin's input, from its
// layer's pair (dq_gemm.cuh dql_params, the pair read through L2)
__device__ __forceinline__ void lin_params(const Args& a, int l, int lin, float& scale,
                                           float& safe, float& zp) {
  const int* pair = a.mm + 8 * l + 2 * lin;
  const float x_max = __int_as_float(__ldcg(pair));
  const float x_min = -__int_as_float(__ldcg(pair + 1));
  scale = __fdiv_rn(__fsub_rn(x_max, x_min), 255.f);
  safe = scale == 0.f ? 1.f : scale;
  zp = rintf(fminf(fmaxf(__fdiv_rn(-x_min, safe), 0.f), 255.f));
}

// The quantize phase before linear lin: its f32 input [T, K] -> the i8
// codes (dq_gemm.cuh dql_code: the plain version's division and rounding),
// 4 a thread a turn over the whole grid. Rows are kp(K) apart; the pad
// columns are never multiplied by a weight (the ring zero-fills k >= K).
__device__ void quant_phase(const Args& a, int l, int lin) {
  int K, N;
  lin_dims(a, lin, K, N);
  float scale, safe, zp;
  lin_params(a, l, lin, scale, safe, zp);
  const float* src = lin_src(a, lin);
  const int K4 = (K + 3) / 4, Kp = kp(K);
  const int n = a.T * K4, stride = gridDim.x * THREADS;
  constexpr int U = 4;  // quads a thread loads before its first store
  for (int i0 = blockIdx.x * THREADS + threadIdx.x; i0 < n; i0 += U * stride) {
    float v[U][4];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * stride, m = i / K4, k = 4 * (i - m * K4);
      const float* xr = src + (size_t)m * K + k;
#pragma unroll
      for (int e = 0; e < 4; ++e) v[u][e] = 0.f;
      if (i >= n) continue;
      if (k + 4 <= K && (K & 3) == 0) {
        const float4 f = __ldcg(reinterpret_cast<const float4*>(xr));
        v[u][0] = f.x, v[u][1] = f.y, v[u][2] = f.z, v[u][3] = f.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k + e < K) v[u][e] = __ldcg(xr + e);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * stride, m = i / K4, k = 4 * (i - m * K4);
      if (i >= n) break;
      uint32_t packed = 0;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (k + e < K) packed |= dql_code(v[u][e], safe, zp) << (8 * e);
      *reinterpret_cast<uint32_t*>(a.codes + (size_t)m * Kp + k) = packed;
    }
  }
}

// One ring step: weight rows k0 .. k0 + 63 (columns n0 .. n0 + 63) and the
// codes of rows m0 .. m0 + 31 (columns k0 .. k0 + 63); zeros past K, N and T
__device__ __forceinline__ void issue_stage(unsigned char* st, const int8_t* w,
                                            const int8_t* codes, int T, int K, int N, int m0,
                                            int n0, int step) {
  const int tid = threadIdx.x, k0 = step * BK, Kp = kp(K);
  for (int c = tid; c < BK * BN / 16; c += THREADS) {
    const int r = c / (BN / 16), cc = (c % (BN / 16)) * 16, gk = k0 + r, gn = n0 + cc;
    copy16(st + r * LDB + cc, w + (size_t)gk * N + gn, gk < K ? min(16, N - gn) : 0);
  }
  for (int c = tid; c < BM * BK / 16; c += THREADS) {
    const int r = c / (BK / 16), cc = (c % (BK / 16)) * 16, m = m0 + r, gk = k0 + cc;
    copy16(st + B_BYTES + r * LDA + cc, codes + (size_t)m * Kp + gk, (m < T && gk < Kp) ? 16 : 0);
  }
}

// One 32 x 64 output tile of linear `lin` over this split's k steps; one
// body serves the four linears. The epilogue: qkv (f32), x + out, f =
// relu(.) with its range, or x + ffn2.
__device__ __noinline__ void gemm_tile(const Args& a, int l, int lin, int m0, int n0, int split,
                                       int n_split, unsigned char* smem, bool first) {
  const int ph = lin == 0 ? 2 : lin == 1 ? 5 : lin == 2 ? 8 : 10;
  stamp(a, l, ph, 0, first);
  int K, N;
  lin_dims(a, lin, K, N);
  const int T = a.T, D = a.D;
  const int8_t* w = a.w[lin] + (size_t)l * K * N;
  const int* colsum = a.colsum[lin] + (size_t)l * N;
  const float* ws = a.ws[lin] + (size_t)l * N;
  const float* bias = a.b[lin] + (size_t)l * N;
  float scale, safe, zp;
  lin_params(a, l, lin, scale, safe, zp);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 1, wn = warp & 1, g = lane >> 2, tg = lane & 3;
  const int all = (K + BK - 1) / BK;
  const int s0 = all * split / n_split, nsteps = all * (split + 1) / n_split - s0;
  auto slot = [&](int s) { return smem + (s % STAGES) * STAGE; };
  const int8_t* codes = a.codes;
  auto issue = [=](int s) {  // by value: the ring's operands stay in registers
    issue_stage(slot(s), w, codes, T, K, N, m0, n0, s0 + s);
  };
  ring_prime<STAGES>(nsteps, issue);
  stamp(a, l, ph, 1, first);
  // the epilogue's operands, loaded while the ring fills: this thread's 8
  // columns n0 + 32 wn + 8 tg .. + 7 of rows r and r + 8
  const int r = wm * 16 + g, nb = n0 + wn * 32 + 8 * tg;
  const bool res = lin == 1 || lin == 3;
  int cs[8];
  float sc[8], bv[8], xr[2][8];
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int n = nb + q;
    cs[q] = n < N ? __ldg(colsum + n) : 0;
    sc[q] = n < N ? __fmul_rn(scale, __ldg(ws + n)) : 0.f;
    bv[q] = n < N ? __ldg(bias + n) : 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + r + 8 * h;
      xr[h][q] = (res && m < T && n < N) ? __ldcg(a.x + (size_t)m * N + n) : 0.f;
    }
  }
  int acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0;
#pragma unroll 1
  for (int step = 0; step < nsteps; ++step) {
    ring_next<STAGES>(step, nsteps, issue);
    if (step < 11) stamp(a, l, ph, 2 + step, first);
    const unsigned char* bs = slot(step);
    const unsigned char* as = bs + B_BYTES;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t af[4], b[4][2];
      af[0] = *reinterpret_cast<const uint32_t*>(as + r * LDA + kk + tg * 4);
      af[1] = *reinterpret_cast<const uint32_t*>(as + (r + 8) * LDA + kk + tg * 4);
      af[2] = *reinterpret_cast<const uint32_t*>(as + r * LDA + kk + 16 + tg * 4);
      af[3] = *reinterpret_cast<const uint32_t*>(as + (r + 8) * LDA + kk + 16 + tg * 4);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t r4[4], t[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          r4[i] = *reinterpret_cast<const uint32_t*>(bs + (kk + 16 * h + 4 * tg + i) * LDB +
                                                     wn * 32 + 4 * g);
        transpose4x4(r4, t);
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j][h] = t[j];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_s8_16832(acc[j], af, b[j]);
    }
  }
  wait_groups<0>();
  stamp(a, l, ph, 13, first);
  // acc[j][2 h + c]: row r + 8 h, column nb + j + 4 c
  if (n_split > 1) {
    // a split's int32 partial sums into the scratch; the last split of the
    // tile to arrive adds them up (exact in any order)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + r + 8 * h;
      if (m < T && nb + 8 <= N) {
        int* p = a.part + ((size_t)split * T + m) * N + nb;
        *reinterpret_cast<int4*>(p) = make_int4(acc[0][2 * h], acc[1][2 * h], acc[2][2 * h],
                                                acc[3][2 * h]);
        *reinterpret_cast<int4*>(p + 4) = make_int4(acc[0][2 * h + 1], acc[1][2 * h + 1],
                                                    acc[2][2 * h + 1], acc[3][2 * h + 1]);
      }
    }
    if (!last_to_arrive(a.cnt + (m0 / BM) * ((D + BN - 1) / BN) + n0 / BN, n_split)) return;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + r + 8 * h;
      int4 lo[SPLIT_MAX], hi[SPLIT_MAX];  // every partial loaded before the sums
#pragma unroll
      for (int sp = 0; sp < SPLIT_MAX; ++sp) {
        const bool ok = sp < n_split && m < T && nb + 8 <= N;
        const int* p = a.part + ((size_t)sp * T + m) * N + nb;
        lo[sp] = ok ? __ldcg(reinterpret_cast<const int4*>(p)) : make_int4(0, 0, 0, 0);
        hi[sp] = ok ? __ldcg(reinterpret_cast<const int4*>(p + 4)) : make_int4(0, 0, 0, 0);
      }
      int sum[8] = {0, 0, 0, 0, 0, 0, 0, 0};
#pragma unroll
      for (int sp = 0; sp < SPLIT_MAX; ++sp) {
        sum[0] += lo[sp].x, sum[1] += lo[sp].y, sum[2] += lo[sp].z, sum[3] += lo[sp].w;
        sum[4] += hi[sp].x, sum[5] += hi[sp].y, sum[6] += hi[sp].z, sum[7] += hi[sp].w;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[j][2 * h] = sum[j];
        acc[j][2 * h + 1] = sum[4 + j];
      }
    }
  }
  // the epilogue (dq_gemm.cuh's dq_gemm_mma): the zero-point correction,
  // the scale, the bias, ReLU, the residual, each rounded once
  const int zpi = static_cast<int>(zp) - 128;
  float pos = 0.f, neg = 0.f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m0 + r + 8 * h;
    float v[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      float y = __fmul_rn(__int2float_rn(acc[q & 3][2 * h + (q >> 2)] - zpi * cs[q]), sc[q]);
      y = __fadd_rn(y, bv[q]);
      if (lin == 2) {
        y = fmaxf(y, 0.f);
        if (m < T && nb + q < N) range_update(y, pos, neg);
      }
      v[q] = res ? __fadd_rn(xr[h][q], y) : y;
    }
    if (m >= T || nb >= N) continue;
    float* out = lin == 0 ? a.qkv : lin == 2 ? a.f : a.x;
    float* o = out + (size_t)m * N + nb;
    if (nb + 8 <= N && (N & 3) == 0) {
      *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<float4*>(o + 4) = make_float4(v[4], v[5], v[6], v[7]);
    } else {
#pragma unroll
      for (int q = 0; q < 8; ++q)
        if (nb + q < N) o[q] = v[q];
    }
  }
  if (lin == 2) range_commit(pos, neg, a.mm + 8 * l + 6);
  stamp(a, l, ph, 14, first);
  __syncthreads();  // the ring is free for the next tile
}

// the K splits of a linear: the residual linears (out, ffn2) split K while
// their tiles leave CTAs idle and each part keeps at least 8 k steps (the
// timer: a split's merge, ~3-5 us, costs what ~8-10 k steps do)
__device__ __forceinline__ int n_splits(const Args& a, int lin) {
  if (lin != 1 && lin != 3) return 1;
  int K, N;
  lin_dims(a, lin, K, N);
  const int tiles = ((a.T + BM - 1) / BM) * ((N + BN - 1) / BN), steps = (K + BK - 1) / BK;
  int n = 1;
  while (n < SPLIT_MAX && tiles * 2 * n <= (int)gridDim.x && steps >= 8 * 2 * n) n *= 2;
  return n;
}

__device__ void gemm_phase(const Args& a, int l, int lin, unsigned char* smem) {
  int K, N;
  lin_dims(a, lin, K, N);
  const int nt = (N + BN - 1) / BN, tiles = ((a.T + BM - 1) / BM) * nt;
  const int n_split = n_splits(a, lin), items = tiles * n_split;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int tile = it % tiles;
    gemm_tile(a, l, lin, (tile / nt) * BM, (tile % nt) * BN, it / tiles, n_split, smem,
              it == (int)blockIdx.x);
  }
}

// ---------------------------------------------------------------------------
// attention + FSMN

// x = hi + lo, both TF32 (round to nearest, ties away)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
}

// c += a . b, m16n8k8 TF32 with f32 accumulators
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a . b in 3xTF32 (a.b ~ a_hi.b_hi + a_hi.b_lo + a_lo.b_hi): the two
// small cross terms first
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], uint32_t bh0, uint32_t bh1,
                                           uint32_t bl0, uint32_t bl1) {
  mma_tf32(c, al, bh0, bh1);
  mma_tf32(c, ah, bl0, bl1);
  mma_tf32(c, ah, bh0, bh1);
}

template <int HD>
struct Attn {  // shared memory of an attention item, in floats
  static constexpr int LDP = HD + 4;                 // a row's pitch: conflict-free fragments
  static constexpr int Q = QROWS * LDP;              // the item's queries
  static constexpr int SLOT = 2 * KEYS * LDP + KEYS;  // a key tile: K, V, the keys' bias
  static constexpr int RING = 2 * SLOT;
  static constexpr int VROWS = QROWS + FSMN_KMAX - 1;  // the FSMN's V rows with their halo
  static constexpr int BYTES = 4 * (Q + RING + VROWS * LDP + 32 + FSMN_KMAX * HD);
  static_assert(4 * QROWS * LDP + 4 * QROWS * 2 <= RING, "the merge reuses the key ring");
};

// floats of an attention item's key-split record: the max and sum of its
// 16 rows, their O [16][HD], and (split 0's) the FSMN [16][HD]
__host__ __device__ __forceinline__ int attn_rec(int hd) { return 2 * QROWS + 2 * QROWS * hd; }

// the parts each (head, 16 queries) item's keys are split in: enough to
// give `grid` CTAs work (with one more CTA an item for its FSMN where the
// keys are split), each part keeping at least one key tile
__host__ __device__ __forceinline__ int attn_splits(int T, int H, int grid) {
  const int items = H * ((T + QROWS - 1) / QROWS), ntiles = (T + KEYS - 1) / KEYS;
  int s = grid / items - 1;
  s = s < ntiles ? s : ntiles;
  s = s < KSPLIT_MAX ? s : KSPLIT_MAX;
  return s < 2 ? 1 : s;
}

// Attention + FSMN for one (head h, 16-query tile qt), in S key parts. Part
// s < S: Q stays in shared memory; the part's 32-key tiles of K, V and the
// key bias come through a 2-slot cp.async ring; warp w takes keys 8 w ..
// 8 w + 7 of each tile with its own online softmax (max, sum and O in
// registers; S's accumulators become P's A fragments in place, the k index
// permuted as in csrc/flash_attn.cu), and the 4 warps' (max, sum, O) merge
// in warp order. The FSMN over V * vmask is formed by part 0 where S is 1,
// else by an item of its own (s == S), beside the key parts. With one part,
// a = ctx + FSMN is written at once; with more, each part leaves its (max,
// sum, O) or the FSMN in a record, and the last of the S + 1 to arrive
// merges the records in part order (the same bits whichever arrives last)
// and writes a. The writer folds a's range into the out linear's pair.
template <int HD>
__device__ __noinline__ void attn_item(const Args& a, int l, int h, int qt, int s, int S,
                                       unsigned char* smem, bool first) {
  stamp(a, l, 3, 0, first);
  using AT = Attn<HD>;
  constexpr int LDP = AT::LDP, NO = HD / 8, CC = HD / 8;
  const int T = a.T, D = a.D, D3 = 3 * D, q0 = qt * QROWS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3;
  float* qs = reinterpret_cast<float*>(smem);
  float* ring = qs + AT::Q;
  float* vs = ring + AT::RING;
  float* ms = vs + AT::VROWS * LDP;
  float* wsm = ms + 32;
  const float* Qg = a.qkv + h * HD;
  const float* Kg = a.qkv + D + h * HD;
  const float* Vg = a.qkv + 2 * D + h * HD;
  const float* kbias = a.bias + (size_t)l * T;
  const float* vmask = a.vmask + (size_t)l * T;
  const int fsmn_k = a.fsmn_k, tb = q0 - a.pad_left, nrows = QROWS + fsmn_k - 1;
  const bool fsmn = S == 1 || s == S, keys = s < S;
  const int ntiles = (T + KEYS - 1) / KEYS;
  const int t0 = keys ? ntiles * s / S : 0, t1 = keys ? ntiles * (s + 1) / S : 0;
  // part 0's FSMN operands: the value mask of its rows (a register, stored
  // once the first key tile is in), its V rows and taps (with Q, the first
  // cp.async group)
  const float mv = (fsmn && tid < nrows && tb + tid >= 0 && tb + tid < T) ? __ldg(vmask + tb + tid)
                                                                          : 0.f;
  constexpr int CH = HD / 4;  // 16-byte chunks a row
  if (keys)
    for (int c = tid; c < QROWS * CH; c += THREADS) {
      const int r = c / CH, cc = (c % CH) * 4, t = q0 + r;
      copy16(qs + r * LDP + cc, Qg + (size_t)t * D3 + cc, t < T ? 16 : 0);
    }
  if (fsmn) {
    for (int c = tid; c < nrows * CH; c += THREADS) {
      const int r = c / CH, cc = (c % CH) * 4, t = tb + r;
      copy16(vs + r * LDP + cc, Vg + (size_t)t * D3 + cc, (t >= 0 && t < T) ? 16 : 0);
    }
    const float* fw = a.fsmn + (size_t)l * fsmn_k * D + h * HD;
    for (int c = tid; c < fsmn_k * CH; c += THREADS)
      copy16(wsm + (c / CH) * HD + (c % CH) * 4, fw + (size_t)(c / CH) * D + (c % CH) * 4, 16);
  }
  commit();
  auto issue = [&](int k0, int slot) {
    float* ks = ring + slot * AT::SLOT;
    for (int c = tid; c < 2 * KEYS * CH; c += THREADS) {
      const int which = c / (KEYS * CH), r = (c / CH) % KEYS, cc = (c % CH) * 4, t = k0 + r;
      copy16(ks + (which * KEYS + r) * LDP + cc, (which ? Vg : Kg) + (size_t)t * D3 + cc,
             t < T ? 16 : 0);
    }
    if (tid < KEYS / 4)
      copy16(ks + 2 * KEYS * LDP + 4 * tid, kbias + k0 + 4 * tid, 4 * (T - k0 - 4 * tid));
  };
  if (keys) issue(t0 * KEYS, 0);
  commit();
  stamp(a, l, 3, 1, first);
  const float att_scale = a.att_scale;
  const int kw = 8 * warp;  // the warp's keys in each tile
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
#pragma unroll 1
  for (int t = t0; t < t1; ++t) {
    if (t + 1 < t1) issue((t + 1) * KEYS, (t + 1 - t0) & 1);
    commit();
    if (t == t0 && fsmn && tid < nrows) ms[tid] = mv;  // read after the barrier below
    wait_groups<1>();  // Q, the FSMN rows and taps, and key tile t landed
    __syncthreads();
    if (t == t0) stamp(a, l, 3, 2, first);
    const float* ks = ring + ((t - t0) & 1) * AT::SLOT;
    const float* vt = ks + KEYS * LDP;
    const float* bt = ks + 2 * KEYS * LDP;
    // S = Q K^T over the warp's 8 keys
    float sc[4] = {0.f, 0.f, 0.f, 0.f};
    const float* qa = qs + g * LDP + tg;
    const float* kr = ks + (kw + g) * LDP + tg;
#pragma unroll 4
    for (int d = 0; d < HD; d += 8) {
      uint32_t ah[4], al[4], bh0, bl0, bh1, bl1;
      split_tf32(qa[d], ah[0], al[0]);
      split_tf32(qa[d + 8 * LDP], ah[1], al[1]);
      split_tf32(qa[d + 4], ah[2], al[2]);
      split_tf32(qa[d + 8 * LDP + 4], ah[3], al[3]);
      split_tf32(kr[d], bh0, bl0);
      split_tf32(kr[d + 4], bh1, bl1);
      mma_3xtf32(sc, ah, al, bh0, bh1, bl0, bl1);
    }
    // sc[2 r + c]: row g + 8 r, key kw + 2 tg + c; the graph's score
    // (q . k) * att_scale + bias[key], keys past T -inf
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kj = kw + 2 * tg + (e & 1);
      sc[e] = t * KEYS + kj < T ? __fadd_rn(__fmul_rn(sc[e], att_scale), bt[kj]) : -INFINITY;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m_run[r], quad_max(fmaxf(sc[2 * r], sc[2 * r + 1])));
      const float off = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(m_run[r] - off);
      sc[2 * r] = expf(sc[2 * r] - off);
      sc[2 * r + 1] = expf(sc[2 * r + 1] - off);
      l_run[r] = l_run[r] * alpha + (sc[2 * r] + sc[2 * r + 1]);
      m_run[r] = m_new;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        o[n][2 * r] *= alpha;
        o[n][2 * r + 1] *= alpha;
      }
    }
    // O += P V: k index tg is key 2 tg of the warp's 8, tg + 4 key 2 tg + 1
    uint32_t ph[4], pl[4];
    split_tf32(sc[0], ph[0], pl[0]);
    split_tf32(sc[2], ph[1], pl[1]);
    split_tf32(sc[1], ph[2], pl[2]);
    split_tf32(sc[3], ph[3], pl[3]);
    const float* v0 = vt + (kw + 2 * tg) * LDP + g;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      uint32_t bh0, bl0, bh1, bl1;
      split_tf32(v0[8 * n], bh0, bl0);
      split_tf32(v0[8 * n + LDP], bh1, bl1);
      mma_3xtf32(o[n], ph, pl, bh0, bh1, bl0, bl1);
    }
    __syncthreads();  // every warp is done with the slot refilled next
  }
  wait_groups<0>();
  if (!keys) {
    if (tid < nrows) ms[tid] = mv;
    __syncthreads();  // the FSMN's rows and taps landed, its mask stored
  }
  stamp(a, l, 3, 3, first);
  // the warps' (max, sum, O) in the freed ring, merged in warp order
  float* part = ring;                          // [4][QROWS][LDP]
  float* red = ring + 4 * QROWS * LDP;         // [4][QROWS][2]
#pragma unroll
  for (int r = 0; r < 2 && keys; ++r) {
    const float lr = quad_sum(l_run[r]);
    if (tg == 0) {
      red[(warp * QROWS + g + 8 * r) * 2] = m_run[r];
      red[(warp * QROWS + g + 8 * r) * 2 + 1] = lr;
    }
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<float2*>(part + (warp * QROWS + g + 8 * r) * LDP + 8 * n + 2 * tg) =
          make_float2(o[n][2 * r], o[n][2 * r + 1]);
  }
  __syncthreads();
  stamp(a, l, 3, 4, first);
  // thread: row rr of the tile, columns c8 + 8 cc: this part's max, sum and O
  const int rr = tid >> 3, c8 = tid & 7, t = q0 + rr;
  float mp = -INFINITY, lp = 0.f, ov[CC], fs[CC];
  {
#pragma unroll
    for (int cc = 0; cc < CC; ++cc) ov[cc] = fs[cc] = 0.f;
    if (keys) {
      float mw[4];
#pragma unroll
      for (int w = 0; w < 4; ++w) mp = fmaxf(mp, red[(w * QROWS + rr) * 2]);
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const float mx = red[(w * QROWS + rr) * 2];
        mw[w] = mx == -INFINITY ? 0.f : expf(mx - mp);
        lp += red[(w * QROWS + rr) * 2 + 1] * mw[w];
      }
#pragma unroll
      for (int cc = 0; cc < CC; ++cc)
#pragma unroll
        for (int w = 0; w < 4; ++w) ov[cc] += part[(w * QROWS + rr) * LDP + c8 + 8 * cc] * mw[w];
    }
    // the FSMN, the row's columns side by side: V row rr + kk holds time
    // t - pad_left + kk
    if (fsmn)
      for (int kk = 0; kk < fsmn_k; ++kk) {
        const float mk = ms[rr + kk];
#pragma unroll
        for (int cc = 0; cc < CC; ++cc) {
          const int c = c8 + 8 * cc;
          fs[cc] = fmaf(__fmul_rn(vs[(rr + kk) * LDP + c], mk), wsm[kk * HD + c], fs[cc]);
        }
      }
  }
  stamp(a, l, 3, 5, first);
  float pos = 0.f, neg = 0.f;
  float* out = a.a + (size_t)t * D + h * HD;
  float v[CC];  // every value formed before the first store
  if (S == 1) {
    if (t < T) {
#pragma unroll
      for (int cc = 0; cc < CC; ++cc) v[cc] = __fadd_rn(__fdiv_rn(ov[cc], lp), fs[cc]);
#pragma unroll
      for (int cc = 0; cc < CC; ++cc) {
        out[c8 + 8 * cc] = v[cc];
        range_update(v[cc], pos, neg);
      }
    }
  } else {
    const int RS = attn_rec(HD);
    float* recs = a.apart + (size_t)(qt * a.H + h) * S * RS;
    if (keys) {
      float* rec = recs + (size_t)s * RS;
      if (c8 == 0) {
        rec[rr] = mp;
        rec[QROWS + rr] = lp;
      }
#pragma unroll
      for (int cc = 0; cc < CC; ++cc) rec[2 * QROWS + rr * HD + c8 + 8 * cc] = ov[cc];
    } else {
#pragma unroll
      for (int cc = 0; cc < CC; ++cc)
        recs[2 * QROWS + (QROWS + rr) * HD + c8 + 8 * cc] = fs[cc];  // in part 0's record
    }
    const bool last = last_to_arrive(a.acnt + qt * a.H + h, S + 1);  // S key parts, the FSMN
    stamp(a, l, 3, 6, first);
    if (last && t < T) {
      // every record's values loaded before any of the sums
      float mr[KSPLIT_MAX], lr[KSPLIT_MAX], ob[KSPLIT_MAX][CC], fv[CC], mx = -INFINITY, lsum = 0.f;
#pragma unroll
      for (int p = 0; p < KSPLIT_MAX; ++p) {
        const float* rec = recs + (size_t)p * RS;
        mr[p] = p < S ? __ldcg(rec + rr) : -INFINITY;
        lr[p] = p < S ? __ldcg(rec + QROWS + rr) : 0.f;
#pragma unroll
        for (int cc = 0; cc < CC; ++cc)
          ob[p][cc] = p < S ? __ldcg(rec + 2 * QROWS + rr * HD + c8 + 8 * cc) : 0.f;
      }
#pragma unroll
      for (int cc = 0; cc < CC; ++cc)
        fv[cc] = __ldcg(recs + 2 * QROWS + (QROWS + rr) * HD + c8 + 8 * cc);
#pragma unroll
      for (int p = 0; p < KSPLIT_MAX; ++p) mx = fmaxf(mx, mr[p]);
#pragma unroll
      for (int p = 0; p < KSPLIT_MAX; ++p) {
        mr[p] = mr[p] == -INFINITY ? 0.f : expf(mr[p] - mx);  // the part's weight
        lsum += lr[p] * mr[p];
      }
#pragma unroll
      for (int cc = 0; cc < CC; ++cc) {
        float sum = 0.f;
#pragma unroll
        for (int p = 0; p < KSPLIT_MAX; ++p) sum += ob[p][cc] * mr[p];
        v[cc] = __fadd_rn(__fdiv_rn(sum, lsum), fv[cc]);
      }
#pragma unroll
      for (int cc = 0; cc < CC; ++cc) {
        out[c8 + 8 * cc] = v[cc];
        range_update(v[cc], pos, neg);
      }
    }
  }
  range_commit(pos, neg, a.mm + 8 * l + 2);
  stamp(a, l, 3, 7, first);
  __syncthreads();  // shared memory is free for the next item
}

__device__ void attn_phase(const Args& a, int l, unsigned char* smem) {
  const int hd = a.D / a.H, hq = a.H * ((a.T + QROWS - 1) / QROWS);
  const int S = attn_splits(a.T, a.H, gridDim.x), items = hq * (S > 1 ? S + 1 : 1);
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int h = (it % hq) % a.H, qt = (it % hq) / a.H, s = it / hq;  // s == S: the FSMN
    const bool first = it == (int)blockIdx.x;
    if (hd == 32) attn_item<32>(a, l, h, qt, s, S, smem, first);
    else if (hd == 64) attn_item<64>(a, l, h, qt, s, S, smem, first);
    else attn_item<128>(a, l, h, qt, s, S, smem, first);
  }
}

__global__ void __launch_bounds__(THREADS) sanm_dql_kernel(Args args) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Args a;
  load_args(a, args);
  cg::grid_group grid = cg::this_grid();
  PhaseTimer timer(a.trace, PHASES, a.L);
  auto sync = [&](int k) { timer.sync(grid, k); };
  if (blockIdx.x == 0) {  // the range pairs and the split counters, before any use
    for (int i = threadIdx.x; i < 8 * a.L; i += THREADS) a.mm[i] = 0;
    for (int i = threadIdx.x; i < ((a.T + BM - 1) / BM) * ((a.D + BN - 1) / BN); i += THREADS)
      a.cnt[i] = 0;
    for (int i = threadIdx.x; i < a.H * ((a.T + QROWS - 1) / QROWS); i += THREADS) a.acnt[i] = 0;
  }
  sync(0);
  for (int l = 0; l < a.L; ++l) {
    const int t0 = PHASES * l;
    ln_phase(a, l, false);
    sync(t0 + 1);
    quant_phase(a, l, 0);
    sync(t0 + 2);
    gemm_phase(a, l, 0, smem);
    sync(t0 + 3);
    attn_phase(a, l, smem);
    sync(t0 + 4);
    quant_phase(a, l, 1);
    sync(t0 + 5);
    gemm_phase(a, l, 1, smem);
    sync(t0 + 6);
    ln_phase(a, l, true);
    sync(t0 + 7);
    quant_phase(a, l, 2);
    sync(t0 + 8);
    gemm_phase(a, l, 2, smem);
    sync(t0 + 9);
    quant_phase(a, l, 3);
    sync(t0 + 10);
    gemm_phase(a, l, 3, smem);
    sync(t0 + 11);
  }
}


// the grid a launch can have: at most MAX_PER_SM CTAs on each SM
inline int grid_max() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms * MAX_PER_SM;
}

// the scratch's layout: h, qkv, a, f (f32); the codes (i8); the split
// partials (int32); the split counters; the range pairs; the attention
// records and their counters
inline size_t work_bytes(int T, int D, int H, int F, int L, size_t off[10]) {
  const size_t items = (size_t)H * ((T + QROWS - 1) / QROWS);
  const size_t sizes[10] = {(size_t)T * D * 4, (size_t)T * 3 * D * 4, (size_t)T * D * 4,
                            (size_t)T * F * 4, (size_t)T * kp(D > F ? D : F),
                            (size_t)SPLIT_MAX * T * D * 4,
                            (size_t)((T + BM - 1) / BM) * ((D + BN - 1) / BN) * 4,
                            (size_t)L * 8 * 4,
                            items * attn_splits(T, H, grid_max()) * attn_rec(D / H) * 4,
                            items * 4};
  return carve(sizes, off);
}

}  // namespace dql
}  // namespace lele

// Bytes of scratch the stack needs (one buffer, carved in the kernel).
extern "C" long long sanm_dql_work_bytes(int T, int D, int H, int F, int L) {
  return static_cast<long long>(lele::dql::work_bytes(T, D, H, F, L, nullptr));
}

// The L-layer stack, in place on x [T, D] f32, in one cooperative launch.
// bias and vmask [L, T] f32. Linears (qkv [D,3D], out [D,D], ffn1 [D,F],
// ffn2 [F,D]): int8 w [L, K, N], int32 colsum, f32 ws and b [L, 1, N]. Norms
// g, b [L, 1, D] f32; fsmn_w [L, fsmn_k, D] f32. D / H in {32, 64, 128}, any
// F, any T, 1 <= fsmn_k <= 16, 0 <= pad_left < fsmn_k. work:
// sanm_dql_work_bytes(T, D, H, F, L) bytes. trace: null, or 11 L + 1 + 11 *
// 16 int64 that get the global timer (ns) after the first barrier and after
// each of the eleven phases' barriers of every layer, then stamps inside
// layer 1's phases. Returns cudaGetLastError() (or the
// launch's refusal).
extern "C" int sanm_stack_dql(
    void* x, int T, int D, int H, int F, int L, int fsmn_k, int pad_left, float eps1,
    float eps2, float att_scale, const void* bias, const void* vmask, const void* wqkv,
    const void* cqkv, const void* sqkv, const void* bqkv, const void* wo, const void* co,
    const void* so, const void* bo, const void* w1, const void* c1, const void* s1,
    const void* bf1, const void* w2, const void* c2, const void* s2, const void* bf2,
    const void* g1, const void* b1, const void* g2, const void* b2, const void* fsmn_w,
    void* work, void* trace, void* stream) {
  using namespace lele::dql;
  if (T == 0 || L == 0) return 0;
  const int hd = H > 0 ? D / H : 0;
  if (H <= 0 || hd * H != D || (hd != 32 && hd != 64 && hd != 128) || F < 1 || fsmn_k < 1 || fsmn_k > FSMN_KMAX || pad_left < 0 || pad_left >= fsmn_k)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.x = static_cast<float*>(x);
  a.T = T, a.D = D, a.H = H, a.F = F, a.L = L, a.fsmn_k = fsmn_k, a.pad_left = pad_left;
  a.eps1 = eps1, a.eps2 = eps2, a.att_scale = att_scale;
  a.bias = static_cast<const float*>(bias);
  a.vmask = static_cast<const float*>(vmask);
  const void* lin[4][4] = {{wqkv, cqkv, sqkv, bqkv}, {wo, co, so, bo}, {w1, c1, s1, bf1},
                           {w2, c2, s2, bf2}};
  for (int i = 0; i < 4; ++i) {
    a.w[i] = static_cast<const int8_t*>(lin[i][0]);
    a.colsum[i] = static_cast<const int*>(lin[i][1]);
    a.ws[i] = static_cast<const float*>(lin[i][2]);
    a.b[i] = static_cast<const float*>(lin[i][3]);
  }
  a.g1 = static_cast<const float*>(g1), a.b1 = static_cast<const float*>(b1);
  a.g2 = static_cast<const float*>(g2), a.b2 = static_cast<const float*>(b2);
  a.fsmn = static_cast<const float*>(fsmn_w);
  size_t off[10];
  work_bytes(T, D, H, F, L, off);
  char* wk = static_cast<char*>(work);
  a.h = reinterpret_cast<float*>(wk + off[0]);
  a.qkv = reinterpret_cast<float*>(wk + off[1]);
  a.a = reinterpret_cast<float*>(wk + off[2]);
  a.f = reinterpret_cast<float*>(wk + off[3]);
  a.codes = reinterpret_cast<int8_t*>(wk + off[4]);
  a.part = reinterpret_cast<int*>(wk + off[5]);
  a.cnt = reinterpret_cast<int*>(wk + off[6]);
  a.mm = reinterpret_cast<int*>(wk + off[7]);
  a.apart = reinterpret_cast<float*>(wk + off[8]);
  a.acnt = reinterpret_cast<int*>(wk + off[9]);
  a.trace = static_cast<long long*>(trace);
  return launch_cooperative(sanm_dql_kernel, &a, smem_for<Attn>(GEMM_BYTES, hd), MAX_PER_SM,
                            static_cast<cudaStream_t>(stream));
}
