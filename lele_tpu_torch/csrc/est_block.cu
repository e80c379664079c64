// The Supertonic flow estimator's 2L attention blocks (kernel 10), as a
// fixed sequence of launches on one stream. Replaces
// lele_tpu/kernels/est_block.py:estimator_blocks_pallas (`_kernel`).
//
// Blocks alternate self0, cross0, self1, ...; block i runs, in place on
// x [T, D] f32:
//
//   1. h = LN1(x)                         ln_rows
//      (cross: tn = LN1(text), the text memory under the same norm1 weights)
//   2. q = bf16(h) . Wq + bq              gemm_bf16
//   3. kv = bf16(h or tn) . Wkv + bkv     gemm_bf16
//   4. ctx = attention per (head, 64-query tile) over the block's own keys
//      (self: the T latent rows under the latent mask; cross: the Tk text
//      rows under the text mask), additive (mask - 1) * 1e9 key bias
//   5. x += bf16(ctx) . Wo + bo           gemm_bf16, residual in the epilogue
//   6. h = LN2(x)                         ln_rows
//   7. f = gelu_tanh(bf16(h) . W1 + b1)   gemm_bf16, GELU in the epilogue
//   8. x += bf16(f) . W2 + b2             gemm_bf16, residual in the epilogue
//
// Every product takes bf16 operands (activations rounded on the way into
// shared memory, weights stored bf16) and sums in f32 on the tensor cores
// (mma.sync m16n8k16); LN (two-pass statistics, rsqrt, eps 1e-12), the
// softmax and the GELU (0.7978845608028654, 0.044715) run in f32.
//
// Softmax form: two passes over 64-key tiles staged in shared memory as
// bf16. The first keeps each row's running max and sum of exp; the second
// forms the NORMALISED probabilities, rounds them to bf16 and multiplies V,
// as the TPU kernel rounds p before its P.V dot. The T x Tk scores are never
// stored, so any T and Tk fit: at T = 1,024 one head's K and V in bf16 would
// take 256 KB, over a block's 227 KB of shared memory.
//
// Not carried over from the TPU kernel, because they are Mosaic workarounds
// and not the function: it computes both attention branches and selects one
// with `where` (here only the block's own branch runs); it masks full-D head
// lanes (here each head reads its own hd columns; the masked lanes added
// exact zeros); it pads T and Tk to 16 (here ragged rows are masked).
//
// What bounds it on the H100: at T = 1,024, Tk = 320, D 256, F 1024 and 8
// blocks the function does ~17.8 GFLOP of bf16 products (18 us at 989
// TFLOP/s) and reads 12.6 MB of bf16 weights (3.8 us at 3.35 TB/s): it is
// bound by operations. This first version is a sequence of small launches
// (68 a call at 8 blocks) on skinny GEMMs (M = T rows, N = 256..1024), so
// launch latency and too few blocks in flight set its time. The TPU kernel
// keeps x on chip across the blocks and streams block i+1's weights during
// block i; a persistent form with that prefetch, wgmma and TMA is later work.
//
// Range (kernels/est_block.py `kernel_takes`): hd = D / H in {32, 64, 128},
// D and F multiples of 64, T and Tk >= 1.
#include <math.h>

#include "w8_gemm.cuh"

namespace lele {
namespace est {

// sum over a block of 128 threads
__device__ __forceinline__ float block_sum128(float v, float* sh) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = v;
  __syncthreads();
  const float t = sh[0] + sh[1] + sh[2] + sh[3];
  __syncthreads();
  return t;
}

// y[t] = (x[t] - mean) * rsqrt(var + eps) * g + b, one block per row,
// two-pass statistics as the JAX `_ln`.
__global__ void __launch_bounds__(128)
ln_rows(const float* __restrict__ x, const float* __restrict__ g,
        const float* __restrict__ b, float* __restrict__ y, int D, float eps) {
  __shared__ float sh[4];
  const float* xr = x + (size_t)blockIdx.x * D;
  float* yr = y + (size_t)blockIdx.x * D;
  float s = 0.f;
  for (int i = threadIdx.x; i < D; i += 128) s += xr[i];
  const float mu = block_sum128(s, sh) / D;
  float s2 = 0.f;
  for (int i = threadIdx.x; i < D; i += 128) {
    const float d = xr[i] - mu;
    s2 += d * d;
  }
  const float r = rsqrtf(block_sum128(s2, sh) / D + eps);
  for (int i = threadIdx.x; i < D; i += 128) yr[i] = (xr[i] - mu) * r * g[i] + b[i];
}

__device__ __forceinline__ float gelu_tanh(float f) {
  return 0.5f * f * (1.f + tanhf(0.7978845608028654f * (f + 0.044715f * f * f * f)));
}

// y[M, N] = bf16(a[M, K]) . w[K, N] (bf16) + bias[N], then tanh-GELU if
// `gelu`, then + res[M, N] if res (res may alias y: each element is read
// before it is written, by the same thread). K and N are multiples of 64 and
// BN; rows past M are masked. 4 warps in a 2 x 2 layout, each owning a
// (BM/2) x (BN/2) sub-tile; K advances in steps of 64, the next K tile
// fetched into registers with 16-byte loads while the tensor cores work on
// the current one. A is stored [m][k] and read as 32-bit pairs; B is stored
// [k][n] and read with ldmatrix.trans; rows padded by 8 elements.
template <int BM, int BN>
__global__ void __launch_bounds__(128)
gemm_bf16(const float* __restrict__ a, const __nv_bfloat16* __restrict__ w,
          const float* __restrict__ bias, const float* res, float* y, int M, int K, int N,
          int gelu) {
  constexpr int BK = 64, LDA = BK + 8, LDB = BN + 8;
  constexpr int MI = BM / 32, NI = BN / 16;
  constexpr int A_CHUNKS = BM * BK / 4 / 128;  // float4 chunks per thread
  constexpr int B_CHUNKS = BK * BN / 8 / 128;  // 8-bf16 chunks per thread
  static_assert(A_CHUNKS >= 1 && B_CHUNKS >= 1, "tile too small for 128 threads");
  __shared__ __align__(16) uint16_t As[BM][LDA];
  __shared__ __align__(16) uint16_t Bs[BK][LDB];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int g = lane >> 2, tg = lane & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  float4 ra[A_CHUNKS];
  uint4 rb[B_CHUNKS];
  auto load_tile = [&](int k0) {
#pragma unroll
    for (int i = 0; i < A_CHUNKS; ++i) {
      const int c = tid + i * 128, r = c / (BK / 4), cc = (c % (BK / 4)) * 4;
      const int gm = m0 + r;
      ra[i] = gm < M ? *reinterpret_cast<const float4*>(a + (size_t)gm * K + k0 + cc)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int i = 0; i < B_CHUNKS; ++i) {
      const int c = tid + i * 128, r = c / (BN / 8), cc = (c % (BN / 8)) * 8;
      rb[i] = *reinterpret_cast<const uint4*>(w + (size_t)(k0 + r) * N + n0 + cc);
    }
  };
  auto store_tile = [&]() {
#pragma unroll
    for (int i = 0; i < A_CHUNKS; ++i) {
      const int c = tid + i * 128, r = c / (BK / 4), cc = (c % (BK / 4)) * 4;
      uint2 p;
      p.x = bf16_bits(ra[i].x) | (uint32_t(bf16_bits(ra[i].y)) << 16);
      p.y = bf16_bits(ra[i].z) | (uint32_t(bf16_bits(ra[i].w)) << 16);
      *reinterpret_cast<uint2*>(&As[r][cc]) = p;
    }
#pragma unroll
    for (int i = 0; i < B_CHUNKS; ++i) {
      const int c = tid + i * 128, r = c / (BN / 8), cc = (c % (BN / 8)) * 8;
      *reinterpret_cast<uint4*>(&Bs[r][cc]) = rb[i];
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
      uint32_t af[MI][4], bf[NI][2];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const int r = wm * (BM / 2) + mi * 16 + g;
        af[mi][0] = ld_pair(&As[r][kk + tg * 2]);
        af[mi][1] = ld_pair(&As[r + 8][kk + tg * 2]);
        af[mi][2] = ld_pair(&As[r][kk + tg * 2 + 8]);
        af[mi][3] = ld_pair(&As[r + 8][kk + tg * 2 + 8]);
      }
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
        ldsm_x2_trans(bf[ni], &Bs[kk + (lane & 15)][wn * (BN / 2) + ni * 8]);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) mma_bf16_16816(acc[mi][ni], af[mi], bf[ni]);
    }
    __syncthreads();
    if (has_next) {
      store_tile();
      __syncthreads();
    }
  }

#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      const int r = m0 + wm * (BM / 2) + mi * 16 + g;
      const int c = n0 + wn * (BN / 2) + ni * 8 + tg * 2;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = r + (e >> 1) * 8, n = c + (e & 1);
        if (m >= M) continue;
        float v = acc[mi][ni][e] + bias[n];
        if (gelu) v = gelu_tanh(v);
        if (res) v = res[(size_t)m * N + n] + v;
        y[(size_t)m * N + n] = v;
      }
    }
}

inline void launch_gemm(const float* a, const __nv_bfloat16* w, const float* bias,
                        const float* res, float* y, int M, int K, int N, int gelu,
                        cudaStream_t s) {
  // the largest tile that still gives the 132 SMs enough blocks
  auto blocks = [&](int bm, int bn) { return ((M + bm - 1) / bm) * (N / bn); };
  if (blocks(64, 64) >= 2 * 132) {
    gemm_bf16<64, 64><<<dim3(N / 64, (M + 63) / 64), 128, 0, s>>>(a, w, bias, res, y, M, K,
                                                                    N, gelu);
  } else if (blocks(32, 64) >= 132) {
    gemm_bf16<32, 64><<<dim3(N / 64, (M + 31) / 32), 128, 0, s>>>(a, w, bias, res, y, M, K,
                                                                    N, gelu);
  } else {
    gemm_bf16<32, 32><<<dim3(N / 32, (M + 31) / 32), 128, 0, s>>>(a, w, bias, res, y, M, K,
                                                                    N, gelu);
  }
}

constexpr int ATT_BQ = 64;    // query rows per block: 16 per warp
constexpr int ATT_BKEY = 64;  // keys per tile

// rows [k0, k0 + ATT_BKEY) of one head (f32, row stride ld) → bf16 tile in
// shared memory; rows past T are zero
template <int HD>
__device__ __forceinline__ void stage_rows(uint16_t (*dst)[HD + 8], const float* src, int ld,
                                           int k0, int T) {
  for (int i = threadIdx.x; i < ATT_BKEY * HD / 4; i += 128) {
    const int r = i / (HD / 4), c = (i % (HD / 4)) * 4, t = k0 + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t < T) v = *reinterpret_cast<const float4*>(src + (size_t)t * ld + c);
    uint2 p;
    p.x = bf16_bits(v.x) | (uint32_t(bf16_bits(v.y)) << 16);
    p.y = bf16_bits(v.z) | (uint32_t(bf16_bits(v.w)) << 16);
    *reinterpret_cast<uint2*>(&dst[r][c]) = p;
  }
}

// ctx[t, h*HD:(h+1)*HD] for one (head h, 64-query tile): Q [Tq, D] (row
// stride D), K and V in kv [Tk, 2D] (columns [0, D) and [D, 2D)), key mask
// [Tk]. Each of the 4 warps owns 16 query rows, kept in registers as bf16
// mma fragments; S = Q.K^T and O = P.V are mma.sync m16n8k16 and the S
// accumulators are repacked in registers as P's A fragments. Keys past Tk
// are skipped (-inf); masked keys get the additive (m - 1) * 1e9 bias.
template <int HD>
__global__ void __launch_bounds__(128)
attention(const float* __restrict__ q, const float* __restrict__ kv,
          const float* __restrict__ kmask, float* __restrict__ ctx, int Tq, int Tk, int D,
          float inv_sqrt_hd) {
  constexpr int KS = HD / 16;       // k-steps over the head dim
  constexpr int NT = ATT_BKEY / 8;  // n8 tiles of keys
  constexpr int OT = HD / 8;        // n8 tiles of the output
  __shared__ __align__(16) uint16_t Ks[ATT_BKEY][HD + 8];
  __shared__ __align__(16) uint16_t Vs[ATT_BKEY][HD + 8];
  __shared__ float bias[ATT_BKEY];
  const int h = blockIdx.x, q0 = blockIdx.y * ATT_BQ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const int D2 = 2 * D;
  const float* Qg = q + h * HD;
  const float* Kg = kv + h * HD;
  const float* Vg = kv + D + h * HD;
  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};

  auto q_pair = [&](int r, int c) -> uint32_t {
    if (r >= Tq) return 0u;
    const float2 v = *reinterpret_cast<const float2*>(Qg + (size_t)r * D + c);
    return bf16_bits(v.x) | (uint32_t(bf16_bits(v.y)) << 16);
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

  auto stage = [&](int k0, bool with_v) {
    __syncthreads();  // the previous tile is consumed
    stage_rows<HD>(Ks, Kg, D2, k0, Tk);
    if (with_v) stage_rows<HD>(Vs, Vg, D2, k0, Tk);
    if (tid < ATT_BKEY) {
      const int t = k0 + tid;
      bias[tid] = t < Tk ? (kmask[t] - 1.f) * 1e9f : -INFINITY;
    }
    __syncthreads();
  };
  // s[j][e]: row rows[e >> 1], key j*8 + tg*2 + (e & 1) of the tile
  auto scores = [&](float (&s)[NT][4]) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t b[2];
        b[0] = ld_pair(&Ks[j * 8 + g][ks * 16 + tg * 2]);
        b[1] = ld_pair(&Ks[j * 8 + g][ks * 16 + tg * 2 + 8]);
        mma_bf16_16816(s[j], qa[ks], b);
      }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = s[j][e] * inv_sqrt_hd + bias[j * 8 + tg * 2 + (e & 1)];
  };
  // a row's values sit in the 4 neighbouring lanes of one quad
  auto quad_max = [](float v) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
    return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
  };
  auto quad_sum = [](float v) {
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    return v + __shfl_xor_sync(0xffffffffu, v, 2);
  };

  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  for (int k0 = 0; k0 < Tk; k0 += ATT_BKEY) {
    stage(k0, false);
    float s[NT][4];
    scores(s);
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < NT; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * hr], s[j][2 * hr + 1]));
      const float m_new = fmaxf(m_run[hr], quad_max(mx));  // finite: key k0 < Tk
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j)
        psum += expf(s[j][2 * hr] - m_new) + expf(s[j][2 * hr + 1] - m_new);
      l_run[hr] = l_run[hr] * expf(m_run[hr] - m_new) + quad_sum(psum);
      m_run[hr] = m_new;
    }
  }

  float o[OT][4];
#pragma unroll
  for (int nt = 0; nt < OT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;
  for (int k0 = 0; k0 < Tk; k0 += ATT_BKEY) {
    stage(k0, true);
    float s[NT][4];
    scores(s);
    uint32_t pb[NT][2];  // bf16 pairs of P: [j][0] row 0, [j][1] row 1
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        pb[j][hr] = bf16_bits(expf(s[j][2 * hr] - m_run[hr]) / l_run[hr]) |
                    (uint32_t(bf16_bits(expf(s[j][2 * hr + 1] - m_run[hr]) / l_run[hr])) << 16);
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      const uint32_t pa[4] = {pb[2 * kk][0], pb[2 * kk][1], pb[2 * kk + 1][0], pb[2 * kk + 1][1]};
#pragma unroll
      for (int nt = 0; nt < OT; ++nt) {
        uint32_t b[2];
        ldsm_x2_trans(b, &Vs[kk * 16 + (lane & 15)][nt * 8]);
        mma_bf16_16816(o[nt], pa, b);
      }
    }
  }

#pragma unroll
  for (int nt = 0; nt < OT; ++nt) {
    const int c = h * HD + nt * 8 + tg * 2;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
      if (rows[hr] < Tq)
        *reinterpret_cast<float2*>(ctx + (size_t)rows[hr] * D + c) =
            make_float2(o[nt][2 * hr], o[nt][2 * hr + 1]);
  }
}

template <int HD>
inline void launch_attention(const float* q, const float* kv, const float* kmask, float* ctx,
                             int Tq, int Tk, int D, cudaStream_t s) {
  const dim3 grid(D / HD, (Tq + ATT_BQ - 1) / ATT_BQ);
  const float inv = static_cast<float>(1.0 / sqrt(static_cast<double>(HD)));
  attention<HD><<<grid, 128, 0, s>>>(q, kv, kmask, ctx, Tq, Tk, D, inv);
}

inline bool shape_ok(int T, int Tk, int D, int H, int F) {
  if (T < 1 || Tk < 1 || H < 1 || D % H) return false;
  const int hd = D / H;
  return (hd == 32 || hd == 64 || hd == 128) && D % 64 == 0 && F % 64 == 0 && F > 0;
}

}  // namespace est
}  // namespace lele

#define EST_CHECK_LAUNCH()                              \
  do {                                                  \
    const cudaError_t e_ = cudaGetLastError();          \
    if (e_ != cudaSuccess) return static_cast<int>(e_); \
  } while (0)

// All n_blocks blocks, in place on x [T, D] f32. text [Tk, D] f32; lmask [T]
// and tmask [Tk] f32 (1 = valid). Weights stacked over the blocks: g1, b1,
// bq, bo, g2, b2, bf2 [n, D] f32; bkv [n, 2D] f32; bf1 [n, F] f32; wq, wo
// [n, D, D], wkv [n, D, 2D], w1 [n, D, F], w2 [n, F, D] bf16 ([in, out]).
// Scratch, all f32: h [T, D], tn [Tk, D], q [T, D], kv [max(T, Tk), 2D],
// ctx [T, D], f1 [T, F]. Launches on `stream`; returns cudaGetLastError().
extern "C" int estimator_blocks(
    void* x, const void* text, const void* lmask, const void* tmask, int T, int Tk, int D,
    int H, int F, int n_blocks, const void* g1, const void* b1, const void* wq, const void* bq,
    const void* wkv, const void* bkv, const void* wo, const void* bo, const void* g2,
    const void* b2, const void* w1, const void* bf1, const void* w2, const void* bf2, void* h,
    void* tn, void* q, void* kv, void* ctx, void* f1, void* stream) {
  using namespace lele::est;
  if (!shape_ok(T, Tk, D, H, F)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto f32 = [](const void* p, size_t off) { return static_cast<const float*>(p) + off; };
  auto bf = [](const void* p, size_t off) {
    return static_cast<const __nv_bfloat16*>(p) + off;
  };
  float* X = static_cast<float*>(x);
  float *Hb = static_cast<float*>(h), *TN = static_cast<float*>(tn);
  float *Q = static_cast<float*>(q), *KV = static_cast<float*>(kv);
  float *CTX = static_cast<float*>(ctx), *F1 = static_cast<float*>(f1);
  const float eps = 1e-12f;
  const int hd = D / H;
  for (int i = 0; i < n_blocks; ++i) {
    const size_t d = (size_t)i * D, dd = (size_t)i * D * D;
    const bool cross = i % 2 == 1;
    ln_rows<<<T, 128, 0, s>>>(X, f32(g1, d), f32(b1, d), Hb, D, eps);
    EST_CHECK_LAUNCH();
    launch_gemm(Hb, bf(wq, dd), f32(bq, d), nullptr, Q, T, D, D, 0, s);
    EST_CHECK_LAUNCH();
    int Tkv = T;
    const float* kmask = static_cast<const float*>(lmask);
    const float* kv_src = Hb;
    if (cross) {
      ln_rows<<<Tk, 128, 0, s>>>(static_cast<const float*>(text), f32(g1, d), f32(b1, d), TN,
                                 D, eps);
      EST_CHECK_LAUNCH();
      Tkv = Tk;
      kmask = static_cast<const float*>(tmask);
      kv_src = TN;
    }
    launch_gemm(kv_src, bf(wkv, 2 * dd), f32(bkv, 2 * d), nullptr, KV, Tkv, D, 2 * D, 0, s);
    EST_CHECK_LAUNCH();
    switch (hd) {
      case 32: launch_attention<32>(Q, KV, kmask, CTX, T, Tkv, D, s); break;
      case 64: launch_attention<64>(Q, KV, kmask, CTX, T, Tkv, D, s); break;
      default: launch_attention<128>(Q, KV, kmask, CTX, T, Tkv, D, s); break;
    }
    EST_CHECK_LAUNCH();
    launch_gemm(CTX, bf(wo, dd), f32(bo, d), X, X, T, D, D, 0, s);
    EST_CHECK_LAUNCH();
    ln_rows<<<T, 128, 0, s>>>(X, f32(g2, d), f32(b2, d), Hb, D, eps);
    EST_CHECK_LAUNCH();
    launch_gemm(Hb, bf(w1, (size_t)i * D * F), f32(bf1, (size_t)i * F), nullptr, F1, T, D, F, 1,
                s);
    EST_CHECK_LAUNCH();
    launch_gemm(F1, bf(w2, (size_t)i * F * D), f32(bf2, d), X, X, T, F, D, 0, s);
    EST_CHECK_LAUNCH();
  }
  return 0;
}
