// The SAN-M encoder stack at batch 1 as one persistent launch that loops over
// the layers on the card, with int8 (w8a16) or groupwise int4 (w4a16)
// weights. Replaces lele_tpu/kernels/sanm_block.py:sanm_stack_w8_pallas
// (`_stack_kernel`, kernel 1) and sanm_stack_w4_pallas (`_stack_kernel_w4`,
// kernel 8). The TPU kernels run the layers as a sequential grid with the
// activation in VMEM and the next layer's weights in flight; here one
// cooperative launch of two CTAs of 128 threads an SM walks the layers, each
// as seven grid-wide phases between cooperative groups' grid barriers:
//
//   1. h = LN1(x)                a row a warp over the whole grid, bf16
//   2. qkv = w(h)                q, k, v as bf16, v also as f32 (the FSMN's)
//   3. ctx = attn + FSMN         one CTA a (head, 16 queries); its 4 warps
//                                split each 64-key tile; two passes (max and
//                                sum, then P.V with P rounded to bf16),
//                                merged across the warps in a fixed order;
//                                + the FSMN over v * mask; bf16 out
//   4. x += w(ctx)               residual in the epilogue, in place
//   5. h = LN2(x)                as 1
//   6. f1 = relu(w(h))           bf16
//   7. x += w(f1)                K split in up to 4 parts while tiles are
//                                few; the last part of a tile to arrive sums
//                                the parts in order and adds the residual
//
// The GEMM phases stream A and the weights through a 6-stage cp.async ring
// (raw int8, or packed int4 with the scale rows a step needs); a step's B tile
// is converted to bf16 (w8: exact; w4: bf16(q * s) as `_w4dot`) during the
// previous step's mma.sync m16n8k16 products, so a step takes one barrier.
// Tiles are 32 x 32 where that takes no more rounds of the grid than
// 32 x 64. Without a split the K order is the parent's (csrc/sanm_layer.cu:
// w8_gemm_mma, w4_gemm_mma's W4_DEQ_BF16 form) and LN keeps the parent's
// reduction order; the attention's split keys and ffn2's split K sum in
// other orders, so the stack's bits differ from the parent's (the plain
// version's gate holds both). CTAs without work in a phase prefetch the
// weights of the phases ahead into L2 (measured: no change beyond the
// run-to-run spread; the weights are not what the phases wait on).
//
// What bounds it on the H100, at 10 s of audio (T = 171, d512, ffn 2048,
// 50 layers): the weights stream once, 157.3 MB as int8 (47 us at 3.35 TB/s;
// int4 with group scales 82.6 MB); the products are 56.8 GFLOP (57.4 us at
// the bf16 peak); and 350 grid barriers, each 1.1 us at 132 CTAs and 1.3 us
// at 264 (scripts/torch_port_stack_probe.py), ~0.45 ms. What sets the time
// is each phase's chain of dependent latencies with 4 warps a CTA: the
// kernel's own timer (kernels.sanm_block.stack_phase_us) puts a 32 x 64 tile
// at ~2.3 us to prime the ring, ~1.2 us a step while the first stages land,
// ~0.7 us a step after, and an attention item at ~12 us of fixed cost (its
// loads, the merge) plus ~2 us a key tile a pass. PERF.md has the numbers.
//
// Stream capture takes the cooperative launch (cudaLaunchCooperativeKernel
// and cudaLaunchKernelEx with the cooperative attribute both capture into a
// CUDA graph and replay at the same barrier cost). The data one phase writes
// and a later one reads (x, h, q/k/v, v, ctx, f1, ffn2's parts) is read with
// ld.global.cg or cp.async.cg, never through the non-coherent or L1 paths.
// Only the owner of an output tile reads and writes its rows of x in phases 4
// and 7. No float atomics (ffn2's arrival count is an int): the output is
// the same bits on a repeat call and in a CUDA-graph replay.
#include "grid_stack.cuh"
#include "w4_gemm.cuh"

namespace cg = cooperative_groups;

namespace lele {
namespace stk {

constexpr int BM = 32;          // GEMM rows a tile (2 warps of 16)
constexpr int STAGES = 6;       // weight ring depth
constexpr int MAX_PER_SM = 2;   // CTAs an SM (one an SM was slower at T >= 171)
constexpr int KEYS = 64;        // keys a tile
constexpr int QROWS = 16;       // queries an attention item
constexpr int FSMN_KMAX = 16;   // most FSMN taps
constexpr int SPLIT_MAX = 4;    // ffn2's K splits, at most

enum Fmt : int { W8 = 0, W4 = 1 };
// the per-layer operands, in the wrapper's order
enum Leaf : int { G1, B1, WQKV, SQKV, BQKV, FSMN, WO, SO, BO, G2, B2, W1, S1, BF1, W2, S2, BF2,
                  NLEAF };

struct Args {
  float* x;            // [T, D] f32, updated in place
  const float* mask;   // [T]
  int T, D, H, F, fsmn_k, group, L, fsmn_bf16;
  float inv_sqrt_hd;
  const char* leaf[NLEAF];   // layer 0 of each stacked leaf (null: no bias)
  long long stride[NLEAF];   // bytes from one layer to the next
  uint16_t* hb;        // [T, D] bf16 bits: LN1(x) or LN2(x)
  uint16_t* qkvb;      // [T, 3D] bf16 bits: q, k, v
  float* vf;           // [T, D] f32: v
  uint16_t* ctxb;      // [T, D] bf16 bits: ctx + FSMN
  uint16_t* f1;        // [T, F] bf16 bits: relu(ffn1)
  float* part;         // [SPLIT_MAX, T, D] f32: ffn2's split-K partial sums
  int* cnt;            // [ffn2's output tiles]: the splits of each that are in
  // null, or PHASES L + 1 + PHASES DETAIL int64: the global timer (ns) at the
  // start and after each phase's barrier; then, for layer 1 in CTA 0, stamps
  // inside each phase's first work item (see stamp)
  long long* trace;
};

constexpr int PHASES = 7;   // a layer's: LN1, qkv, attention + FSMN, out, LN2, ffn1, ffn2

// stamp k of phase p (layer 1, CTA 0, its first item): gemm tiles 0 start, 1
// ring primed, 2 + s step s's data in (s < 11), 13 steps done, 14 stored;
// attention 0 start, 1 pass 1 done, 2 pass 2 done, 3 FSMN staged, 4 stored
__device__ __forceinline__ void stamp(const Args& a, int l, int p, int k, bool first) {
  stamp_at(a.trace, PHASES, a.L, l, p, k, first);
}

template <typename P>
__device__ __forceinline__ const P* leaf(const Args& a, int i, int l) {
  return a.leaf[i] ? reinterpret_cast<const P*>(a.leaf[i] + (long long)l * a.stride[i])
                   : nullptr;
}

// linear i (0 qkv, 1 out, 2 ffn1, 3 ffn2): its weight, scale and bias leaves
__device__ __forceinline__ int lin_leaf(int i, int k) {
  return (i == 0 ? WQKV : i == 1 ? WO : i == 2 ? W1 : W2) + k;
}

__device__ __forceinline__ void lin_dims(const Args& a, int i, int& K, int& N) {
  K = i == 3 ? a.F : a.D;
  N = i == 0 ? 3 * a.D : i == 2 ? a.F : a.D;
}

// linear i of layer l into L2, a share of it for each of nparts CTAs
template <int FMT>
__device__ void prefetch_linear(const Args& a, int l, int i, int part, int nparts) {
  if (l >= a.L) return;
  int K, N;
  lin_dims(a, i, K, N);
  const long long wb = FMT == W8 ? (long long)K * N : (long long)(K / 2) * N;
  const long long sb = FMT == W8 ? 4LL * N : 4LL * (K / a.group) * N;
  prefetch_l2(leaf<char>(a, lin_leaf(i, 0), l), wb, part, nparts);
  prefetch_l2(leaf<char>(a, lin_leaf(i, 1), l), sb, part, nparts);
}

// the weights a phase's idle CTAs fetch: those of the phases ahead (phase:
// 0 LN1, 1 qkv, 2 attention, 3 out, 4 LN2, 5 ffn1, 6 ffn2)
template <int FMT>
__device__ __noinline__ void prefetch_ahead(const Args& a, int l, int phase, int items) {
  if ((int)blockIdx.x < items) return;
  const int part = blockIdx.x - items, n = gridDim.x - items;
  if (phase <= 2) {  // this layer's later linears
    for (int i = phase == 2 ? 1 : 0; i < 4; ++i) prefetch_linear<FMT>(a, l, i, part, n);
  } else {           // and the next layer's first
    for (int i = 0; i < phase - 2; ++i) prefetch_linear<FMT>(a, l + 1, i, part, n);
  }
}

// ---------------------------------------------------------------------------
// GEMM tiles

template <int FMT, int BN>
struct Tile {
  static constexpr int KROWS = FMT == W8 ? 64 : 32;      // weight rows a step (w4: packed)
  static constexpr int B_RAW = KROWS * BN;               // bytes of weights a step
  static constexpr int B_SC = FMT == W8 ? 0 : 4 * BN * 4;  // w4: 4 scale rows
  static constexpr int A_LD = FMT == W8 ? 64 + 8 : 32 + 8;  // ring A row, bf16
  static constexpr int A_RING = (FMT == W8 ? 1 : 2) * BM * A_LD * 2;
  static constexpr int STAGE = B_RAW + B_SC + A_RING;
  static constexpr int BS_LD = BN + 8;                   // bf16 B tile row
  static constexpr int BS = (FMT == W8 ? 64 : 2 * 32) * BS_LD * 2;
};

template <int FMT>
struct Layout {  // shared memory of the GEMM phases (offsets in bytes)
  static constexpr int RING = STAGES * Tile<FMT, 64>::STAGE;
  static constexpr int BS = RING;                          // two bf16 B tiles
  static constexpr int BYTES = BS + 2 * Tile<FMT, 64>::BS;
};

// LN1 or LN2 of every row of x into hb, a row a warp over the whole grid
template <int FMT>
__device__ void ln_phase(const Args& a, int l, int phase, const float* g, const float* b) {
  constexpr int WARPS = THREADS / 32;
  for (int m = blockIdx.x * WARPS + (threadIdx.x >> 5); m < a.T; m += gridDim.x * WARPS)
    ln_row(a.hb + (size_t)m * a.D, a.x + (size_t)m * a.D, a.D, g, b);
  prefetch_ahead<FMT>(a, l, phase, (a.T + WARPS - 1) / WARPS);
}

// One ring step: the weight rows of step `step` (w8: k rows 64 step..; w4:
// packed rows 32 step.., with the scale rows they need: at most two a plane,
// groups being multiples of 16), and the A columns of the step from the bf16
// [T, K] source.
template <int FMT, int BN>
__device__ __forceinline__ void issue_stage(unsigned char* st, const int8_t* w, const float* sc,
                            const uint16_t* a_src, int T, int K, int N, int m0, int n0,
                            int step, int group) {
  using TL = Tile<FMT, BN>;
  const int tid = threadIdx.x;
  uint16_t* as = reinterpret_cast<uint16_t*>(st + TL::B_RAW + TL::B_SC);
  if constexpr (FMT == W8) {
    const int k0 = step * 64;
    for (int c = tid; c < 64 * BN / 16; c += THREADS) {
      const int r = c / (BN / 16), cc = (c % (BN / 16)) * 16, gk = k0 + r, gn = n0 + cc;
      copy16(st + r * BN + cc, w + (size_t)gk * N + gn, gk < K ? min(16, N - gn) : 0);
    }
    for (int c = tid; c < BM * 8; c += THREADS) {
      const int r = c >> 3, cc = (c & 7) * 8, m = m0 + r, gk = k0 + cc;
      copy16(as + r * TL::A_LD + cc, a_src + (size_t)m * K + gk,
             (m < T && gk < K) ? 2 * min(8, K - gk) : 0);
    }
  } else {
    const int half = K / 2, kp0 = step * 32, last = min(kp0 + 31, half - 1);
    for (int c = tid; c < 32 * BN / 16; c += THREADS) {
      const int r = c / (BN / 16), cc = (c % (BN / 16)) * 16, kp = kp0 + r, gn = n0 + cc;
      copy16(st + r * BN + cc, w + (size_t)kp * N + gn, kp < half ? min(16, N - gn) : 0);
    }
    // scale rows: plane 0 at kp0 and at the last row, plane 1 the same
    float* ss = reinterpret_cast<float*>(st + TL::B_RAW);
    for (int c = tid; c < BN; c += THREADS) {
      const int q = c / (BN / 4), cc = (c % (BN / 4)) * 4, gn = n0 + cc;
      const int row = ((q >> 1) * half + ((q & 1) ? last : kp0)) / group;
      copy16(ss + q * BN + cc, sc + (size_t)row * N + gn, 4 * min(4, N - gn));
    }
    for (int c = tid; c < 2 * BM * 4; c += THREADS) {  // both planes' 32 columns
      const int p = c / (BM * 4), r = (c >> 2) % BM, cc = (c & 3) * 8, m = m0 + r;
      const int kp = kp0 + cc;
      copy16(as + (p * BM + r) * TL::A_LD + cc, a_src + (size_t)m * K + p * half + kp,
             (m < T && kp < half) ? 2 * min(8, half - kp) : 0);
    }
  }
}

// the step's raw weights → the bf16 B tile(s), as the parent's store_tile
template <int FMT, int BN>
__device__ __forceinline__ void convert_b(const unsigned char* st, uint16_t* Bs, int K, int step,
                                          int group) {
  using TL = Tile<FMT, BN>;
  constexpr int LD = TL::BS_LD;
  if constexpr (FMT == W8) {
    for (int c = threadIdx.x; c < 64 * BN / 16; c += THREADS) {
      const int r = c / (BN / 16), cc = (c % (BN / 16)) * 16;
      const uint4 raw = *reinterpret_cast<const uint4*>(st + r * BN + cc);
      const int8_t* q = reinterpret_cast<const int8_t*>(&raw);
      uint32_t h[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        h[e] = bf16_bits(static_cast<float>(q[2 * e])) |
               (uint32_t(bf16_bits(static_cast<float>(q[2 * e + 1]))) << 16);
      *reinterpret_cast<uint4*>(Bs + r * LD + cc) = make_uint4(h[0], h[1], h[2], h[3]);
      *reinterpret_cast<uint4*>(Bs + r * LD + cc + 8) = make_uint4(h[4], h[5], h[6], h[7]);
    }
  } else {
    const int half = K / 2, kp0 = step * 32;
    const int lo0 = kp0 / group, hi0 = (half + kp0) / group;
    const float* ss = reinterpret_cast<const float*>(st + TL::B_RAW);
    for (int c = threadIdx.x; c < 32 * BN / 16; c += THREADS) {
      const int r = c / (BN / 16), cc = (c % (BN / 16)) * 16, kp = kp0 + r;
      const float* slo = ss + ((kp / group == lo0) ? 0 : 1) * BN + cc;
      const float* shi = ss + (((half + kp) / group == hi0) ? 2 : 3) * BN + cc;
      const uint4 raw = *reinterpret_cast<const uint4*>(st + r * BN + cc);
      const uint32_t* words = reinterpret_cast<const uint32_t*>(&raw);
      uint32_t lo[8], hi[8];
#pragma unroll
      for (int wi = 0; wi < 4; ++wi) {
        const uint32_t ul = nibbles_biased(words[wi], 0), uh = nibbles_biased(words[wi], 4);
#pragma unroll
        for (int j = 0; j < 2; ++j) {  // bf16(q * s), the f32 product rounded once
          const int e = 4 * wi + 2 * j;
          lo[2 * wi + j] = bf16_pair_rn(int4_f32(ul, 2 * j) * slo[e],
                                        int4_f32(ul, 2 * j + 1) * slo[e + 1]);
          hi[2 * wi + j] = bf16_pair_rn(int4_f32(uh, 2 * j) * shi[e],
                                        int4_f32(uh, 2 * j + 1) * shi[e + 1]);
        }
      }
      uint16_t* b0 = Bs + r * LD + cc;
      uint16_t* b1 = Bs + (32 + r) * LD + cc;
      *reinterpret_cast<uint4*>(b0) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
      *reinterpret_cast<uint4*>(b0 + 8) = make_uint4(lo[4], lo[5], lo[6], lo[7]);
      *reinterpret_cast<uint4*>(b1) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(b1 + 8) = make_uint4(hi[4], hi[5], hi[6], hi[7]);
    }
  }
}

// the linear's value before any residual, as the parent's epilogues
// (w8_gemm.cuh `epilogue`, w4_gemm.cuh `w4_epilogue`) on loaded operands
template <int FMT>
__device__ __forceinline__ float lin_out(float acc, float s, const float* bias, float b,
                                         int relu) {
  float v = acc;
  if constexpr (FMT == W8) v = acc * s;
  if (bias) v += b;
  if (relu) v = fmaxf(v, 0.f);
  return v;
}

// One 32 x BN output tile of linear `lin` over all of K, A (bf16: LN1(x),
// ctx + FSMN, LN2(x) or f1) and the weights both through the ring. The
// epilogue stores q/k/v (bf16) and v (f32), x + out, f1 = relu(.) as bf16,
// or x + ffn2. One body serves the four linears, so the kernel's code stays
// small.
template <int FMT, int BN>
__device__ __noinline__ void gemm_tile(const Args& a, int l, int lin, int m0, int n0,
                                       int split, int n_split, unsigned char* smem,
                                       bool first) {
  const int ph = lin == 0 ? 1 : lin == 1 ? 3 : lin == 2 ? 5 : 6;
  stamp(a, l, ph, 0, first);
  using TL = Tile<FMT, BN>;
  constexpr int NI = BN / 16, LD = TL::BS_LD;
  int K, N;
  lin_dims(a, lin, K, N);
  const int T = a.T, D = a.D, group = a.group;
  const int8_t* w = leaf<int8_t>(a, lin_leaf(lin, 0), l);
  const float* sc = leaf<float>(a, lin_leaf(lin, 1), l);
  const float* bias = leaf<float>(a, lin_leaf(lin, 2), l);
  const uint16_t* a_ring = lin == 1 ? a.ctxb : lin == 3 ? a.f1 : a.hb;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 1, wn = warp & 1, g = lane >> 2, tg = lane & 3;
  // step s's bf16 B tile: converted during step s - 1's products
  auto bs = [&](int s) {
    return reinterpret_cast<uint16_t*>(smem + Layout<FMT>::BS + (s & 1) * Tile<FMT, 64>::BS);
  };
  const int half = K / 2;
  // this split's steps (w8: 64 k rows; w4: 32 packed rows, both planes)
  const int all = FMT == W8 ? (K + 63) / 64 : (half + 31) / 32;
  const int s0 = all * split / n_split, nsteps = all * (split + 1) / n_split - s0;
  auto slot = [&](int s) { return smem + (s % STAGES) * TL::STAGE; };
  auto issue = [=](int s) {  // by value: the ring's operands stay in registers
    issue_stage<FMT, BN>(slot(s), w, sc, a_ring, T, K, N, m0, n0, s0 + s, group);
  };
  ring_prime<STAGES>(nsteps, issue);
  stamp(a, l, ph, 1, first);
  const int r = wm * 16 + g;
  // the epilogue's operands (scales, biases, the residual), loaded while the
  // ring fills
  float sv[NI][2], bv[NI][2], xr[NI][4];
  const bool res = lin == 1 || lin == 3;
#pragma unroll
  for (int ni = 0; ni < NI; ++ni)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int n = n0 + wn * (BN / 2) + ni * 8 + tg * 2 + c;
      sv[ni][c] = (FMT == W8 && n < N) ? __ldg(sc + n) : 0.f;
      bv[ni][c] = (bias && n < N) ? __ldg(bias + n) : 0.f;
    }
#pragma unroll
  for (int ni = 0; ni < NI; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = m0 + r + (e >> 1) * 8, n = n0 + wn * (BN / 2) + ni * 8 + tg * 2 + (e & 1);
      xr[ni][e] = (res && m < T && n < N) ? __ldcg(a.x + (size_t)m * N + n) : 0.f;
    }
  float acc[NI][4];
#pragma unroll
  for (int ni = 0; ni < NI; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[ni][e] = 0.f;
  wait_groups<STAGES - 2>();
  __syncthreads();  // step 0's data landed
  convert_b<FMT, BN>(slot(0), bs(0), K, s0, group);
#pragma unroll 1
  for (int step = 0; step < nsteps; ++step) {
    // step + 1's data landed and step's B tile is converted; every warp is
    // done with step - 1's slot and B tile
    ring_next<STAGES, 3>(step, nsteps, issue);
    if (step < 11) stamp(a, l, ph, 2 + step, first);
    if (step + 1 < nsteps)
      convert_b<FMT, BN>(slot(step + 1), bs(step + 1), K, s0 + step + 1, group);
    const unsigned char* st = slot(step);
    const uint16_t* Bs = bs(step);
    const uint16_t* ar = reinterpret_cast<const uint16_t*>(st + TL::B_RAW + TL::B_SC);
    if constexpr (FMT == W8) {
      const uint16_t* A = ar;
      constexpr int lda = TL::A_LD;
#pragma unroll
      for (int kk = 0; kk < 64; kk += 16) {
        uint32_t af[4], bf[2];
        af[0] = ld_pair(A + r * lda + kk + tg * 2);
        af[1] = ld_pair(A + (r + 8) * lda + kk + tg * 2);
        af[2] = ld_pair(A + r * lda + kk + tg * 2 + 8);
        af[3] = ld_pair(A + (r + 8) * lda + kk + tg * 2 + 8);
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) {
          ldsm_x2_trans(bf, Bs + (kk + (lane & 15)) * LD + wn * (BN / 2) + ni * 8);
          mma_bf16_16816(acc[ni], af, bf);
        }
      }
    } else {
      const int kp0 = (s0 + step) * 32;
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const uint16_t* A = ar + p * BM * TL::A_LD;
        constexpr int lda = TL::A_LD;
#pragma unroll
        for (int kk = 0; kk < 32; kk += 16) {
          if (kp0 + kk >= half) break;  // the same for the whole CTA
          uint32_t af[4], bf[2];
          af[0] = ld_pair(A + r * lda + kk + tg * 2);
          af[1] = ld_pair(A + (r + 8) * lda + kk + tg * 2);
          af[2] = ld_pair(A + r * lda + kk + tg * 2 + 8);
          af[3] = ld_pair(A + (r + 8) * lda + kk + tg * 2 + 8);
#pragma unroll
          for (int ni = 0; ni < NI; ++ni) {
            ldsm_x2_trans(bf, Bs + (p * 32 + kk + (lane & 15)) * LD + wn * (BN / 2) + ni * 8);
            mma_bf16_16816(acc[ni], af, bf);
          }
        }
      }
    }
  }
  wait_groups<0>();
  stamp(a, l, ph, 13, first);
  if (n_split > 1) {
    // a split's partial sums into the scratch; the last split of the tile to
    // arrive adds them up in split order (the same bits whichever is last)
    float* part = a.part + (size_t)split * T * N;
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + r + (e >> 1) * 8, n = n0 + wn * (BN / 2) + ni * 8 + tg * 2 + (e & 1);
        if (m < T && n < N) part[(size_t)m * N + n] = acc[ni][e];
      }
    if (!last_to_arrive(a.cnt + (m0 / BM) * ((N + BN - 1) / BN) + n0 / BN, n_split)) return;
    float pv[NI][4][SPLIT_MAX];  // every partial loaded before the sums
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + r + (e >> 1) * 8, n = n0 + wn * (BN / 2) + ni * 8 + tg * 2 + (e & 1);
#pragma unroll
        for (int sp = 0; sp < SPLIT_MAX; ++sp)
          pv[ni][e][sp] = (sp < n_split && m < T && n < N)
                              ? __ldcg(a.part + ((size_t)sp * T + m) * N + n) : 0.f;
      }
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float sum = 0.f;
#pragma unroll
        for (int sp = 0; sp < SPLIT_MAX; ++sp)
          if (sp < n_split) sum += pv[ni][e][sp];
        acc[ni][e] = sum;
      }
  }
#pragma unroll
  for (int ni = 0; ni < NI; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = m0 + r + (e >> 1) * 8, n = n0 + wn * (BN / 2) + ni * 8 + tg * 2 + (e & 1);
      if (m >= T || n >= N) continue;
      const float v = lin_out<FMT>(acc[ni][e], sv[ni][e & 1], bias, bv[ni][e & 1], lin == 2);
      const size_t o = (size_t)m * N + n;
      if (lin == 0) {
        a.qkvb[o] = bf16_bits(v);
        if (n >= 2 * D) a.vf[(size_t)m * D + n - 2 * D] = v;
      } else if (lin == 2) {
        a.f1[o] = bf16_bits(v);
      } else {
        a.x[o] = xr[ni][e] + v;  // the parent's res + v
      }
    }
  __syncthreads();  // the ring and Bs are free for the next tile
  stamp(a, l, ph, 14, first);
}

template <int FMT, int BN>
__device__ void gemm_phase_bn(const Args& a, int l, int lin, int n_split, unsigned char* smem) {
  int K, N;
  lin_dims(a, lin, K, N);
  const int nt = (N + BN - 1) / BN, tiles = ((a.T + BM - 1) / BM) * nt;
  const int items = tiles * n_split;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int tile = it % tiles;
    gemm_tile<FMT, BN>(a, l, lin, (tile / nt) * BM, (tile % nt) * BN, it / tiles, n_split,
                       smem, it == (int)blockIdx.x);
  }
  prefetch_ahead<FMT>(a, l, lin == 0 ? 1 : lin == 1 ? 3 : lin == 2 ? 5 : 6, items);
}

// A linear's phase: 32 x 32 tiles where they take no more rounds of the grid
// than 32 x 64 tiles (a 32-wide tile's steps are shorter), else 32 x 64. ffn2
// (K = F) splits K in up to SPLIT_MAX parts while the tiles leave CTAs idle.
template <int FMT>
__device__ void gemm_phase(const Args& a, int l, int lin, unsigned char* smem) {
  int K, N;
  lin_dims(a, lin, K, N);
  const int mt = (a.T + BM - 1) / BM, G = gridDim.x;
  const int t64 = mt * ((N + 63) / 64), t32 = mt * ((N + 31) / 32);
  if (lin == 3) {
    const int steps = FMT == W8 ? (K + 63) / 64 : (K / 2 + 31) / 32;
    int n_split = 1;
    while (n_split < SPLIT_MAX && t64 * 2 * n_split <= G && steps >= 8 * 2 * n_split)
      n_split *= 2;
    if (n_split > 1) {
      gemm_phase_bn<FMT, 64>(a, l, lin, n_split, smem);
      return;
    }
  }
  if ((t32 + G - 1) / G <= (t64 + G - 1) / G)
    gemm_phase_bn<FMT, 32>(a, l, lin, 1, smem);
  else
    gemm_phase_bn<FMT, 64>(a, l, lin, 1, smem);
}

// ---------------------------------------------------------------------------
// attention + FSMN

template <int HD>
struct Attn {
  static constexpr int LDK = HD + 8;
  static constexpr int TILE = KEYS * LDK;               // bf16 elements of a K or V tile
  static constexpr int SLOT = 2 * TILE * 2 + KEYS * 4;  // pass 2: K, V, the keys' mask values
  static constexpr int KSLOT = TILE * 2 + KEYS * 4;     // pass 1: K, the mask values
  static constexpr int RING = 2 * SLOT > 4 * KSLOT ? 2 * SLOT : 4 * KSLOT;
  // after the passes, in the freed ring: the warps' partial O [4][QROWS][LDP];
  // beside the ring, staged while the passes run: the item's V rows and the
  // FSMN halo [VROWS][LDP], their mask values, the taps [FSMN_KMAX][HD] (f32)
  static constexpr int LDP = HD + 8, VROWS = QROWS + FSMN_KMAX - 1;
  static_assert(4 * QROWS * LDP * 4 <= RING, "the partial sums reuse the key ring");
  static constexpr int BYTES = RING + (VROWS * LDP + VROWS + 1 + FSMN_KMAX * HD) * 4;
};

// Attention + FSMN for one (head, 16-query tile). The 4 warps split each
// 64-key tile (16 keys a warp) over the same 16 queries, Q in registers as
// bf16 mma fragments; the key tiles and their mask values come through a
// 2-slot cp.async ring. Two passes, as the parent's attn_fsmn: the first keeps
// each warp's running max and sum of exp over its keys, merged across the
// warps in a fixed order; the second forms the normalised probabilities,
// rounds them to bf16 and multiplies V into each warp's partial O, summed
// across the warps in a fixed order. Keys past T are skipped (-inf), masked
// keys get (m - 1) * 1e9. Then ctx + FSMN over the unrounded V * mask, each
// thread 1/8 of a row's columns, written once as bf16.
template <int HD>
__device__ __noinline__ void attn_item(const Args& a, int l, int h, int q0, unsigned char* smem,
                                       bool first) {
  using AT = Attn<HD>;
  constexpr int KS = HD / 16, OT = HD / 8, LDK = AT::LDK, LDP = AT::LDP;
  const int T = a.T, D = a.D, D3 = 3 * D;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3;
  stamp(a, l, 2, 0, first);
  const uint16_t* Qg = a.qkvb + h * HD;
  const uint16_t* Kg = a.qkvb + D + h * HD;
  const uint16_t* Vg = a.qkvb + 2 * D + h * HD;
  const float* mask = a.mask;
  const float inv_sqrt_hd = a.inv_sqrt_hd;
  const int rows[2] = {q0 + g, q0 + g + 8};
  const int kw = warp * 16;  // the warp's keys in each tile

  auto q_pair = [&](int r, int c) -> uint32_t {
    return r < T ? __ldcg(reinterpret_cast<const unsigned*>(Qg + (size_t)r * D3 + c)) : 0u;
  };
  uint32_t qa[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int c = ks * 16 + tg * 2;
    qa[ks][0] = q_pair(rows[0], c);
    qa[ks][1] = q_pair(rows[1], c);
    qa[ks][2] = q_pair(rows[0], c + 8);
    qa[ks][3] = q_pair(rows[1], c + 8);
  }

  // pass 1's slot s (of 4): K, mask; pass 2's slot s (of 2): K, V, mask
  auto ks_of = [&](int s, bool with_v) {
    return reinterpret_cast<uint16_t*>(smem + s * (with_v ? AT::SLOT : AT::KSLOT));
  };
  auto mk_of = [&](int s, bool with_v) {
    return reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(ks_of(s, with_v)) +
                                    (with_v ? 2 : 1) * AT::TILE * 2);
  };
  auto issue = [&](int k0, bool with_v, int s) {
    constexpr int CH = HD / 8;  // 16-byte chunks a row
    uint16_t* Ks = ks_of(s, with_v);
    for (int c = tid; c < (with_v ? 2 : 1) * KEYS * CH; c += THREADS) {
      const int which = c / (KEYS * CH), r = (c / CH) % KEYS, cc = (c % CH) * 8, t = k0 + r;
      copy16(Ks + which * AT::TILE + r * LDK + cc, (which ? Vg : Kg) + (size_t)t * D3 + cc,
             t < T ? 16 : 0);
    }
    if (tid < KEYS / 4)
      copy16(mk_of(s, with_v) + 4 * tid, mask + k0 + 4 * tid, 4 * (T - k0 - 4 * tid));
  };
  // s[j][e]: row rows[e >> 1], key kw + j*8 + tg*2 + (e & 1) of the tile at
  // k0; the key's bias (m - 1) * 1e9 rounded as the parent's bias array
  auto scores = [&](float (&s)[2][4], const uint16_t* Ks, const float* mk, int k0) {
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t b[2];
        b[0] = ld_pair(Ks + (kw + j * 8 + g) * LDK + ks * 16 + tg * 2);
        b[1] = ld_pair(Ks + (kw + j * 8 + g) * LDK + ks * 16 + tg * 2 + 8);
        mma_bf16_16816(s[j], qa[ks], b);
      }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kj = kw + j * 8 + tg * 2 + (e & 1);
        const float bias =
            k0 + kj < T ? __fmul_rn(__fsub_rn(mk[kj], 1.f), 1e9f) : -INFINITY;
        s[j][e] = s[j][e] * inv_sqrt_hd + bias;
      }
  };
  // the FSMN's operands, staged while the passes run: rows q0 - pad ..
  // q0 + 15 + (k - 1 - pad) of V (f32, zero outside [0, T)), their mask
  // values, and the k taps
  float* vs = reinterpret_cast<float*>(smem + AT::RING);
  float* ms = vs + AT::VROWS * LDP;
  float* ws = ms + AT::VROWS + 1;
  const int fsmn_k = a.fsmn_k, pad = (fsmn_k - 1) / 2, tb = q0 - pad, nrows = QROWS + fsmn_k - 1;
  {
    const float* Vf = a.vf + h * HD;
    for (int c = tid; c < nrows * (HD / 4); c += THREADS) {
      const int r = c / (HD / 4), cc = (c % (HD / 4)) * 4, tt = tb + r;
      copy16(vs + r * LDP + cc, Vf + (size_t)tt * D + cc, (tt >= 0 && tt < T) ? 16 : 0);
    }
    commit();
  }
  const int ntiles = (T + KEYS - 1) / KEYS;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  for (int t = 0; t < 3; ++t) {  // pass 1 keeps three key tiles in flight
    if (t < ntiles) issue(t * KEYS, false, t);
    commit();
  }
  {  // with the first key tile in flight
    const char* fw = leaf<char>(a, FSMN, l);
    constexpr int PER = FSMN_KMAX * HD / THREADS;  // taps a thread stages, at most
    float tv[PER];
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int i = tid + u * THREADS;
      const size_t idx = (size_t)(i / HD) * D + h * HD + i % HD;
      tv[u] = i >= fsmn_k * HD ? 0.f
              : a.fsmn_bf16 ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(fw)[idx])
                            : reinterpret_cast<const float*>(fw)[idx];
    }
    const int tt = tb + tid;
    const float mv = (tid < nrows && tt >= 0 && tt < T) ? mask[tt] : 0.f;
#pragma unroll
    for (int u = 0; u < PER; ++u) ws[tid + u * THREADS] = tv[u];
    if (tid < nrows) ms[tid] = mv;
  }
#pragma unroll 1
  for (int t = 0; t < ntiles; ++t) {
    wait_groups<2>();  // the FSMN rows and key tiles 0..t landed
    __syncthreads();   // and every warp is done with tile t - 1's slot
    if (t + 3 < ntiles) issue((t + 3) * KEYS, false, (t + 3) & 3);
    commit();
    float s[2][4];
    scores(s, ks_of(t & 3, false), mk_of(t & 3, false), t * KEYS);
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const float mx = fmaxf(fmaxf(s[0][2 * hr], s[0][2 * hr + 1]),
                             fmaxf(s[1][2 * hr], s[1][2 * hr + 1]));
      const float m_new = fmaxf(m_run[hr], quad_max(mx));
      const bool live = m_new != -INFINITY;  // one of the warp's keys so far is below T
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j)
        if (live) psum += expf(s[j][2 * hr] - m_new) + expf(s[j][2 * hr + 1] - m_new);
      const float qs = quad_sum(psum);
      if (live) {
        l_run[hr] = l_run[hr] * expf(m_run[hr] - m_new) + qs;
        m_run[hr] = m_new;
      }
    }
  }
  wait_groups<0>();
  __syncthreads();  // every slot is free
  issue(0, true, 0);  // pass 2's first tile, in flight during the merge
  commit();
  // merge the warps' (max, sum) in warp order; key 0 < T, so the max is finite
  float* red = reinterpret_cast<float*>(smem + AT::RING - 4 * 16 * 2 * 4);
  if (tg == 0) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      red[(warp * 16 + g + 8 * hr) * 2] = m_run[hr];
      red[(warp * 16 + g + 8 * hr) * 2 + 1] = l_run[hr];
    }
  }
  __syncthreads();
  float mrow[2], lrow[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = g + 8 * hr;
    float m = -INFINITY;
#pragma unroll
    for (int w = 0; w < 4; ++w) m = fmaxf(m, red[(w * 16 + r) * 2]);
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float mw = red[(w * 16 + r) * 2];
      if (mw != -INFINITY) sum += red[(w * 16 + r) * 2 + 1] * expf(mw - m);
    }
    mrow[hr] = m;
    lrow[hr] = sum;
  }
  __syncthreads();  // red is read before pass 2 refills the ring
  stamp(a, l, 2, 1, first);

  float o[OT][4];
#pragma unroll
  for (int nt = 0; nt < OT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
#pragma unroll 1
  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) issue((t + 1) * KEYS, true, (t + 1) & 1);
    commit();
    wait_groups<1>();
    __syncthreads();
    const uint16_t* Ks = ks_of(t & 1, true);
    const uint16_t* Vs = Ks + AT::TILE;
    float s[2][4];
    scores(s, Ks, mk_of(t & 1, true), t * KEYS);
    uint32_t pa[4];  // P's bf16 A fragment: the warp's 16 keys
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        pa[2 * j + hr] = bf16_bits(expf(s[j][2 * hr] - mrow[hr]) / lrow[hr]) |
                         (uint32_t(bf16_bits(expf(s[j][2 * hr + 1] - mrow[hr]) / lrow[hr]))
                          << 16);
#pragma unroll
    for (int nt = 0; nt < OT; ++nt) {
      uint32_t b[2];
      ldsm_x2_trans(b, Vs + (kw + (lane & 15)) * LDK + nt * 8);
      mma_bf16_16816(o[nt], pa, b);
    }
    __syncthreads();
  }
  wait_groups<0>();
  stamp(a, l, 2, 2, first);

  float* part = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int nt = 0; nt < OT; ++nt)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
      *reinterpret_cast<float2*>(part + (warp * QROWS + g + 8 * hr) * LDP + nt * 8 + tg * 2) =
          make_float2(o[nt][2 * hr], o[nt][2 * hr + 1]);
  wait_groups<0>();
  __syncthreads();
  stamp(a, l, 2, 3, first);
  // thread: row r of the tile, columns c8 + 8 cc
  constexpr int CC = HD / 8;
  const int r = tid >> 3, c8 = tid & 7, t = q0 + r;
  if (t < T) {
    float f[CC];
#pragma unroll
    for (int cc = 0; cc < CC; ++cc) f[cc] = 0.f;
#pragma unroll 1
    for (int kk = 0; kk < fsmn_k; ++kk) {
      const float mm = ms[r + kk];  // V row r + kk holds t - pad + kk
#pragma unroll
      for (int cc = 0; cc < CC; ++cc) {
        const int c = c8 + 8 * cc;
        const float v = vs[(r + kk) * LDP + c] * mm;
        f[cc] += v * ws[kk * HD + c];
      }
    }
    uint16_t* out = a.ctxb + (size_t)t * D + h * HD;
#pragma unroll
    for (int cc = 0; cc < CC; ++cc) {  // ctx + fsmn, rounded as the out linear reads it
      const int c = c8 + 8 * cc;
      const float ctx = ((part[r * LDP + c] + part[(QROWS + r) * LDP + c]) +
                         part[(2 * QROWS + r) * LDP + c]) + part[(3 * QROWS + r) * LDP + c];
      out[c] = bf16_bits(ctx + f[cc]);
    }
  }
  __syncthreads();  // shared memory is free for the next item
  stamp(a, l, 2, 4, first);
}

template <int FMT>
__device__ void attn_phase(const Args& a, int l, unsigned char* smem) {
  const int hd = a.D / a.H, items = a.H * ((a.T + QROWS - 1) / QROWS);
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int h = it % a.H, q0 = (it / a.H) * QROWS;
    const bool first = it == (int)blockIdx.x;
    if (hd == 32) attn_item<32>(a, l, h, q0, smem, first);
    else if (hd == 64) attn_item<64>(a, l, h, q0, smem, first);
    else attn_item<128>(a, l, h, q0, smem, first);
  }
  prefetch_ahead<FMT>(a, l, 2, items);
}

template <int FMT>
__global__ void __launch_bounds__(THREADS) sanm_stack_kernel(Args args) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Args a;
  load_args(a, args);
  cg::grid_group grid = cg::this_grid();
  PhaseTimer timer(a.trace, PHASES, a.L);
  auto sync = [&](int k) { timer.sync(grid, k); };
  timer.start();
  if (blockIdx.x == 0)  // ffn2's split counters; the first barrier orders this
    for (int i = threadIdx.x; i < ((a.T + BM - 1) / BM) * ((a.D + 63) / 64); i += THREADS)
      a.cnt[i] = 0;
  for (int l = 0; l < a.L; ++l) {
    const int t0 = PHASES * l;
    ln_phase<FMT>(a, l, 0, leaf<float>(a, G1, l), leaf<float>(a, B1, l));
    sync(t0 + 1);
    gemm_phase<FMT>(a, l, 0, smem);
    sync(t0 + 2);
    attn_phase<FMT>(a, l, smem);
    sync(t0 + 3);
    gemm_phase<FMT>(a, l, 1, smem);
    sync(t0 + 4);
    ln_phase<FMT>(a, l, 4, leaf<float>(a, G2, l), leaf<float>(a, B2, l));
    sync(t0 + 5);
    gemm_phase<FMT>(a, l, 2, smem);
    sync(t0 + 6);
    gemm_phase<FMT>(a, l, 3, smem);
    sync(t0 + 7);
  }
}

inline int smem_bytes(int fmt, int hd) {
  return smem_for<Attn>(fmt == W8 ? Layout<W8>::BYTES : Layout<W4>::BYTES, hd);
}

// the scratch's layout: LN(x) bf16, q/k/v bf16, v f32, ctx + FSMN bf16, f1
// bf16, ffn2's partial sums f32 and split counters
inline size_t work_bytes(int T, int D, int F, size_t off[7]) {
  const size_t sizes[7] = {(size_t)T * D * 2, (size_t)T * 3 * D * 2, (size_t)T * D * 4,
                           (size_t)T * D * 2, (size_t)T * F * 2,
                           (size_t)SPLIT_MAX * T * D * 4,
                           (size_t)((T + BM - 1) / BM) * ((D + 63) / 64) * 4};
  return carve(sizes, off);
}

inline bool shape_ok(int D, int H, int fsmn_k) {
  const int hd = D / H;
  return H > 0 && hd * H == D && (hd == 32 || hd == 64 || hd == 128) && fsmn_k >= 1 &&
         fsmn_k <= FSMN_KMAX;
}

template <int FMT>
int launch(float* x, const float* mask, int T, int D, int H, int F, int fsmn_k, int group,
           int L, const void* const* leaves, const long long* strides, int fsmn_bf16,
           void* work, void* trace, cudaStream_t s) {
  Args a;
  a.trace = static_cast<long long*>(trace);
  a.x = x;
  a.mask = mask;
  a.T = T, a.D = D, a.H = H, a.F = F, a.fsmn_k = fsmn_k, a.group = group, a.L = L;
  a.fsmn_bf16 = fsmn_bf16;
  a.inv_sqrt_hd = static_cast<float>(1.0 / sqrt(static_cast<double>(D / H)));
  for (int i = 0; i < NLEAF; ++i) {
    a.leaf[i] = static_cast<const char*>(leaves[i]);
    a.stride[i] = strides[i];
  }
  size_t off[7];
  work_bytes(T, D, F, off);
  char* wk = static_cast<char*>(work);
  a.hb = reinterpret_cast<uint16_t*>(wk + off[0]);
  a.qkvb = reinterpret_cast<uint16_t*>(wk + off[1]);
  a.vf = reinterpret_cast<float*>(wk + off[2]);
  a.ctxb = reinterpret_cast<uint16_t*>(wk + off[3]);
  a.f1 = reinterpret_cast<uint16_t*>(wk + off[4]);
  a.part = reinterpret_cast<float*>(wk + off[5]);
  a.cnt = reinterpret_cast<int*>(wk + off[6]);
  return launch_cooperative(sanm_stack_kernel<FMT>, &a, smem_bytes(FMT, D / H), MAX_PER_SM, s);
}

}  // namespace stk

__global__ void __launch_bounds__(128) barrier_probe(int n) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  for (int i = 0; i < n; ++i) grid.sync();
}

}  // namespace lele

// Bytes of scratch the stack needs at T rows (one buffer, carved in the kernel).
extern "C" long long sanm_stack_work_bytes(int T, int D, int F) {
  return static_cast<long long>(lele::stk::work_bytes(T, D, F, nullptr));
}

// All L layers of the w8a16 stack in place on x [T, D] f32, in one cooperative
// launch. mask [T] f32 (1 = valid). leaves: layer 0 of the 17 stacked
// operands in this order: norm1 g, b; qkv int8 w [K, N], f32 scale [N], f32
// bias [N] (may be null); fsmn w [fsmn_k, D] (bf16 when fsmn_bf16, else
// f32); out w, scale, bias; norm2 g, b; ffn1 w, scale, bias; ffn2 w, scale,
// bias. strides: each operand's bytes from one layer to the next. work:
// sanm_stack_work_bytes(T, D, F) bytes. trace: null, or 7 L + 1 + 7 * 16
// int64 that get the global timer (ns) at the start and after each of the
// seven phases' barriers of every layer, then stamps inside layer 1's phases.
// Returns cudaGetLastError() (or the launch's refusal).
extern "C" int sanm_stack_w8(void* x, const void* mask, int T, int D, int H, int F, int fsmn_k,
                             int L, const void* const* leaves, const long long* strides,
                             int fsmn_bf16, void* work, void* trace, void* stream) {
  using namespace lele::stk;
  if (T == 0 || L == 0) return 0;
  if (!shape_ok(D, H, fsmn_k)) return static_cast<int>(cudaErrorInvalidValue);
  return launch<W8>(static_cast<float*>(x), static_cast<const float*>(mask), T, D, H, F,
                    fsmn_k, 0, L, leaves, strides, fsmn_bf16, work, trace,
                    static_cast<cudaStream_t>(stream));
}

// The w4a16 stack: as sanm_stack_w8, with each linear's packed int4 weight
// (int8 [K/2, N]) and f32 group scales [K/group, N] in place of the int8
// weight and its column scale, dequantised as `_w4dot` does (bf16(q * s)).
// K/2 and the group must be multiples of 16.
extern "C" int sanm_stack_w4(void* x, const void* mask, int T, int D, int H, int F, int fsmn_k,
                             int group, int L, const void* const* leaves,
                             const long long* strides, int fsmn_bf16, void* work, void* trace,
                             void* stream) {
  using namespace lele::stk;
  if (T == 0 || L == 0) return 0;
  if (!shape_ok(D, H, fsmn_k) || !lele::w4_stack_shape_ok(D, group) ||
      !lele::w4_stack_shape_ok(F, group))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch<W4>(static_cast<float*>(x), static_cast<const float*>(mask), T, D, H, F,
                    fsmn_k, group, L, leaves, strides, fsmn_bf16, work, trace,
                    static_cast<cudaStream_t>(stream));
}

// n grid barriers (cooperative groups' grid.sync) in one cooperative launch
// of `grid` CTAs of 128 threads: the floor of the stack's phases. mode 0
// launches with cudaLaunchCooperativeKernel, 1 with cudaLaunchKernelEx and
// the cooperative attribute. *most (where not null) gets the most CTAs that
// can be co-resident.
extern "C" int sanm_stack_barrier_probe(int n, int grid, int mode, int* most, void* stream) {
  using namespace lele;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (most) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, barrier_probe, 128, 0);
    *most = sms * per_sm;
  }
  cudaError_t e;
  if (mode == 0) {
    void* args[] = {&n};
    e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(barrier_probe), dim3(grid),
                                    dim3(128), args, 0, s);
  } else {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(grid);
    cfg.blockDim = dim3(128);
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeCooperative;
    attr[0].val.cooperative = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    e = cudaLaunchKernelEx(&cfg, barrier_probe, n);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
