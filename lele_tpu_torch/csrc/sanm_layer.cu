// One SAN-M encoder layer as a fixed sequence of launches on one stream,
// with int8 (w8a16) weights. Replaces
// lele_tpu/kernels/sanm_block.py:sanm_layer_w8_pallas (`_kernel`, kernel 3),
// which the port runs for layer params that are not stacked; the stacks
// (kernels 1 and 8) are csrc/sanm_stack.cu.
//
//   1. LN1                       layer_norm_rows
//   2. qkv = w8(h)               w8_gemm_mma (h rounded to bf16, mma.sync)
//   3. ctx + fsmn                attn_fsmn: tensor-core attention per (head,
//                                64-query tile), + FSMN over V*mask
//   4. x += w8(ctx + fsmn)       w8_gemm_mma, residual in the epilogue, in place
//   5. LN2                       layer_norm_rows
//   6. f1 = relu(w8(h2))         w8_gemm_mma, ReLU in the epilogue
//   7. x += w8(f1)               w8_gemm_mma, residual in the epilogue, in place
//
// What bounds it on the H100: the layer's int8 weights (3.1 MB at d512,
// ffn 2048) stream once, and at T ~ 171 rows each launch does little work,
// so the layer is bound by launch latency and the weight stream, not by the
// tensor cores. Attention grows as T^2: at the 60 s bucket (T ~ 1004) K and
// V of one head no longer fit shared memory, so attn_fsmn walks 64-key tiles
// (a running max and sum first, then P.V) and never holds the T x T scores.
// Head dims 32, 64 and 128 are compiled.
#include <math.h>

#include "w8_gemm.cuh"

namespace lele {

__device__ __forceinline__ float load_f32(const float* p, int i) { return p[i]; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p, int i) {
  return __bfloat162float(p[i]);
}

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
// two-pass statistics as in the JAX `_ln`.
__global__ void __launch_bounds__(128)
layer_norm_rows(const float* __restrict__ x, const float* __restrict__ g,
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

// The layer's four linears: y = (x f32 rounded to bf16 @ int8 W) * scale
// (+ bias) (ReLU) (+ res), the parent of kernel 2's tile form, kept here
// for this layer alone.
// Tensor-core path. 4 warps in a 2 x 2 layout; each warp owns a
// (BM/2) x (BN/2) sub-tile: BM/32 m16 tiles by BN/16 n8 tiles. K advances in
// steps of 64. The next K tile is fetched into registers (16-byte loads where
// the row is aligned, element loads at a ragged edge) while the tensor cores
// work on the current one in shared memory. A is stored [m][k] (x rounded
// to bf16 on the way in) and read as 32-bit pairs; B is stored [k][n] and
// read with ldmatrix.trans. Rows are padded by 8 elements (144-byte stride):
// fragment reads are conflict free.
template <int BM, int BN>
__global__ void __launch_bounds__(128)
w8_gemm_mma(const float* __restrict__ x, const int8_t* __restrict__ w, float* y,
            int M, int K, int N, Epilogue ep) {
  constexpr int BK = 64, LDA = BK + 8, LDB = BN + 8;
  constexpr int MI = BM / 32, NI = BN / 16;
  constexpr int A_VEC = 4;                          // elements per 16-byte chunk
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
        __align__(16) float v[A_VEC];
#pragma unroll
        for (int e = 0; e < A_VEC; ++e)
          v[e] = (gm < M && gk + e < K) ? x[(size_t)gm * K + gk + e] : 0.f;
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
      const float* f = reinterpret_cast<const float*>(&ra[i]);
      uint2 packed;
      packed.x = bf16_bits(f[0]) | (uint32_t(bf16_bits(f[1])) << 16);
      packed.y = bf16_bits(f[2]) | (uint32_t(bf16_bits(f[3])) << 16);
      *reinterpret_cast<uint2*>(&As[r][cc]) = packed;
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

inline void launch_w8_gemm_mma(const float* x, const int8_t* w, float* y, int M, int K,
                               int N, const Epilogue& ep, cudaStream_t s) {
  // the largest tile that still gives the 132 SMs enough blocks
  auto blocks = [&](int bm, int bn) { return ((M + bm - 1) / bm) * ((N + bn - 1) / bn); };
  if (blocks(64, 64) >= 2 * 132) {
    w8_gemm_mma<64, 64><<<dim3((N + 63) / 64, (M + 63) / 64), 128, 0, s>>>(
        x, w, y, M, K, N, ep);
  } else if (blocks(32, 64) >= 132) {
    w8_gemm_mma<32, 64><<<dim3((N + 63) / 64, (M + 31) / 32), 128, 0, s>>>(
        x, w, y, M, K, N, ep);
  } else {
    w8_gemm_mma<32, 32><<<dim3((N + 31) / 32, (M + 31) / 32), 128, 0, s>>>(
        x, w, y, M, K, N, ep);
  }
}

constexpr int ATT_BQ = 64;    // query rows per block: 16 per warp
constexpr int ATT_BKEY = 64;  // keys per tile
constexpr int FSMN_ROWS = 32; // output rows per FSMN chunk
constexpr int FSMN_KMAX = 16; // most FSMN taps

__host__ __device__ constexpr int attn_smem_bytes(int hd) {
  // max(K and V bf16 tiles, FSMN rows + halo and taps in f32)
  return 2 * ATT_BKEY * (hd + 8) * 2 > (FSMN_ROWS + 2 * FSMN_KMAX - 1) * hd * 4
             ? 2 * ATT_BKEY * (hd + 8) * 2
             : (FSMN_ROWS + 2 * FSMN_KMAX - 1) * hd * 4;
}

// rows [k0, k0 + ATT_BKEY) of one head of q/k/v (f32, row stride D3) → bf16
// tile in shared memory; rows past T are zero
template <int HD>
__device__ __forceinline__ void stage_rows(uint16_t (*dst)[HD + 8], const float* src,
                                           int D3, int k0, int T) {
  for (int i = threadIdx.x; i < ATT_BKEY * HD / 4; i += 128) {
    const int r = i / (HD / 4), c = (i % (HD / 4)) * 4, t = k0 + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t < T) v = *reinterpret_cast<const float4*>(src + (size_t)t * D3 + c);
    uint2 p;
    p.x = bf16_bits(v.x) | (uint32_t(bf16_bits(v.y)) << 16);
    p.y = bf16_bits(v.z) | (uint32_t(bf16_bits(v.w)) << 16);
    *reinterpret_cast<uint2*>(&dst[r][c]) = p;
  }
}

// Attention + FSMN for one (head, 64-query tile), on the tensor cores.
// Each of the 4 warps owns 16 query rows; Q stays in registers as bf16
// mma fragments. Two passes over 64-key tiles staged in shared memory (bf16):
// the first keeps each row's running max and sum of exp (online softmax), the
// second forms the normalised probabilities, rounds them to bf16 (as the TPU
// kernel does before its P.V dot) and multiplies V. S = Q.K^T and O = P.V are
// mma.sync m16n8k16 (bf16 operands, f32 sums); the S accumulators are repacked
// in registers as P's A fragments. The T x T scores are never stored. Keys
// past T are skipped (-inf); masked keys get the additive (m - 1) * 1e9 bias.
// Then out = ctx + FSMN, the depthwise k-tap conv over the unrounded V * mask
// (k <= 16), from rows staged in shared memory.
template <int HD, typename FW>
__global__ void __launch_bounds__(128)
attn_fsmn(const float* __restrict__ qkv, const float* __restrict__ mask,
          const FW* __restrict__ fsmn_w, float* __restrict__ out, int T, int D,
          int fsmn_k, float inv_sqrt_hd) {
  constexpr int KS = HD / 16;        // k-steps over the head dim
  constexpr int NT = ATT_BKEY / 8;   // n8 tiles of keys
  constexpr int OT = HD / 8;         // n8 tiles of the output
  // K and V tiles during attention; V * mask rows and FSMN taps after it
  __shared__ __align__(16) unsigned char smem[attn_smem_bytes(HD)];
  __shared__ float bias[ATT_BKEY];
  auto Ks = reinterpret_cast<uint16_t (*)[HD + 8]>(smem);
  auto Vs = reinterpret_cast<uint16_t (*)[HD + 8]>(smem + ATT_BKEY * (HD + 8) * 2);
  const int h = blockIdx.x, q0 = blockIdx.y * ATT_BQ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const int D3 = 3 * D;
  const float* Qg = qkv + h * HD;
  const float* Kg = qkv + D + h * HD;
  const float* Vg = qkv + 2 * D + h * HD;
  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};

  auto q_pair = [&](int r, int c) -> uint32_t {
    if (r >= T) return 0u;
    const float2 v = *reinterpret_cast<const float2*>(Qg + (size_t)r * D3 + c);
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
    stage_rows<HD>(Ks, Kg, D3, k0, T);
    if (with_v) stage_rows<HD>(Vs, Vg, D3, k0, T);
    if (tid < ATT_BKEY) {
      const int t = k0 + tid;
      bias[tid] = t < T ? (mask[t] - 1.f) * 1e9f : -INFINITY;
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
  for (int k0 = 0; k0 < T; k0 += ATT_BKEY) {
    stage(k0, false);
    float s[NT][4];
    scores(s);
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < NT; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * hr], s[j][2 * hr + 1]));
      const float m_new = fmaxf(m_run[hr], quad_max(mx));  // finite: key k0 < T
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
  for (int k0 = 0; k0 < T; k0 += ATT_BKEY) {
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

  __syncthreads();  // every warp is done with Ks and Vs
#pragma unroll
  for (int nt = 0; nt < OT; ++nt) {
    const int c = h * HD + nt * 8 + tg * 2;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      if (rows[hr] < T)
        *reinterpret_cast<float2*>(out + (size_t)rows[hr] * D + c) =
            make_float2(o[nt][2 * hr], o[nt][2 * hr + 1]);
    }
  }
  // FSMN over 32-row chunks: stage the chunk's V * mask rows (with the
  // conv's halo) and the taps in the freed shared memory, then each output
  // reads its k taps from there
  auto vm = reinterpret_cast<float (*)[HD]>(smem);
  auto ws = reinterpret_cast<float (*)[HD]>(smem + (FSMN_ROWS + FSMN_KMAX - 1) * HD * 4);
  const int pad = (fsmn_k - 1) / 2;
  for (int i = tid; i < fsmn_k * HD; i += 128)
    ws[i / HD][i % HD] = load_f32(fsmn_w, (i / HD) * D + h * HD + i % HD);
  for (int r0 = 0; r0 < ATT_BQ; r0 += FSMN_ROWS) {
    const int t0 = q0 + r0;
    if (t0 >= T) break;  // the same for the whole block
    __syncthreads();  // ctx is written (and the previous chunk consumed)
    for (int i = tid; i < (FSMN_ROWS + fsmn_k - 1) * HD; i += 128) {
      const int r = i / HD, d = i % HD, tt = t0 - pad + r;
      vm[r][d] = (tt >= 0 && tt < T) ? Vg[(size_t)tt * D3 + d] * mask[tt] : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < FSMN_ROWS * HD; i += 128) {
      const int r = i / HD, d = i % HD, t = t0 + r;
      if (t >= T) break;  // i only grows
      float f = 0.f;
      for (int kk = 0; kk < fsmn_k; ++kk) f += vm[r + kk][d] * ws[kk][d];
      out[(size_t)t * D + h * HD + d] += f;  // ctx + fsmn
    }
  }
}

template <int HD>
inline void launch_attn_fsmn(const float* qkv, const float* mask, const void* fsmn_w,
                             int fsmn_bf16, float* out, int T, int D, int H, int fsmn_k,
                             cudaStream_t s) {
  const dim3 grid(H, (T + ATT_BQ - 1) / ATT_BQ);
  const float inv = static_cast<float>(1.0 / sqrt(static_cast<double>(HD)));
  if (fsmn_bf16)
    attn_fsmn<HD, __nv_bfloat16><<<grid, 128, 0, s>>>(
        qkv, mask, static_cast<const __nv_bfloat16*>(fsmn_w), out, T, D, fsmn_k, inv);
  else
    attn_fsmn<HD, float><<<grid, 128, 0, s>>>(
        qkv, mask, static_cast<const float*>(fsmn_w), out, T, D, fsmn_k, inv);
}

}  // namespace lele

#define LELE_CHECK_LAUNCH()                          \
  do {                                               \
    const cudaError_t e_ = cudaGetLastError();       \
    if (e_ != cudaSuccess) return static_cast<int>(e_); \
  } while (0)

namespace lele {

// The seven launches of one layer, in place on X [T, D] f32. gemm(i, a, out,
// K, N, res, relu) launches linear i (0 qkv, 1 out, 2 ffn1, 3 ffn2) on rows
// of a, bias in its epilogue. Returns the first launch error.
template <typename Gemm>
int layer_launches(float* X, const float* mask, int T, int D, int H, int F, int fsmn_k,
                   const float* g1, const float* b1, const void* fsmn_w, int fsmn_bf16,
                   const float* g2, const float* b2, float* Hb, float* QKV, float* CTX,
                   float* F1, Gemm gemm, cudaStream_t s) {
  const float eps = 1e-12f;
  layer_norm_rows<<<T, 128, 0, s>>>(X, g1, b1, Hb, D, eps);
  LELE_CHECK_LAUNCH();
  gemm(0, Hb, QKV, D, 3 * D, nullptr, 0);
  LELE_CHECK_LAUNCH();
  switch (D / H) {
    case 32:
      launch_attn_fsmn<32>(QKV, mask, fsmn_w, fsmn_bf16, CTX, T, D, H, fsmn_k, s);
      break;
    case 64:
      launch_attn_fsmn<64>(QKV, mask, fsmn_w, fsmn_bf16, CTX, T, D, H, fsmn_k, s);
      break;
    default:
      launch_attn_fsmn<128>(QKV, mask, fsmn_w, fsmn_bf16, CTX, T, D, H, fsmn_k, s);
      break;
  }
  LELE_CHECK_LAUNCH();
  gemm(1, CTX, X, D, D, X, 0);
  LELE_CHECK_LAUNCH();
  layer_norm_rows<<<T, 128, 0, s>>>(X, g2, b2, Hb, D, eps);
  LELE_CHECK_LAUNCH();
  gemm(2, Hb, F1, D, F, nullptr, 1);
  LELE_CHECK_LAUNCH();
  gemm(3, F1, X, F, D, X, 0);
  LELE_CHECK_LAUNCH();
  return 0;
}

inline bool layer_shape_ok(int D, int H, int fsmn_k) {
  const int hd = D / H;
  return hd * H == D && (hd == 32 || hd == 64 || hd == 128) && fsmn_k >= 1 &&
         fsmn_k <= FSMN_KMAX;
}

}  // namespace lele

// One layer, in place on x [T, D] f32. mask [T] f32 (1 = valid). Linears:
// int8 w [K, N], f32 scale [N] and bias [N] (bias may be null). fsmn_w
// [fsmn_k, D] is bf16 when fsmn_bf16, else f32. Scratch: h [T, D],
// qkv [T, 3D], ctx [T, D], f1 [T, F], all f32. Returns cudaGetLastError().
extern "C" int sanm_layer_w8(
    void* x, const void* mask, int T, int D, int H, int F, int fsmn_k,
    const void* g1, const void* b1, const void* wqkv, const void* sqkv,
    const void* bqkv, const void* fsmn_w, int fsmn_bf16, const void* wo,
    const void* so, const void* bo, const void* g2, const void* b2, const void* w1,
    const void* s1, const void* bf1, const void* w2, const void* s2, const void* bf2,
    void* h, void* qkv, void* ctx, void* f1, void* stream) {
  using namespace lele;
  if (T == 0) return 0;
  if (!layer_shape_ok(D, H, fsmn_k)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto f32 = [](const void* p) { return static_cast<const float*>(p); };
  const int8_t* wq[4] = {static_cast<const int8_t*>(wqkv), static_cast<const int8_t*>(wo),
                         static_cast<const int8_t*>(w1), static_cast<const int8_t*>(w2)};
  const float* sc[4] = {f32(sqkv), f32(so), f32(s1), f32(s2)};
  const float* bias[4] = {f32(bqkv), f32(bo), f32(bf1), f32(bf2)};
  auto gemm = [&](int i, const float* a, float* out, int K, int N, const float* res,
                  int relu) {
    launch_w8_gemm_mma(a, wq[i], out, T, K, N, Epilogue{sc[i], bias[i], res, relu}, s);
  };
  return layer_launches(static_cast<float*>(x), f32(mask), T, D, H, F, fsmn_k, f32(g1),
                        f32(b1), fsmn_w, fsmn_bf16, f32(g2), f32(b2), static_cast<float*>(h),
                        static_cast<float*>(qkv), static_cast<float*>(ctx),
                        static_cast<float*>(f1), gemm, s);
}
