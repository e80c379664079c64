// Kernel 12: flash attention in f32. Replaces the library TPU flash-attention
// kernel that lele_tpu/ops/attention_ops.py:34 (_flash_attention_maybe)
// routes an eligible ONNX Attention node to; its plain version here is
// kernels/flash_attention.py:flash_attention_plain.
//
// What it computes. For q [B, H, Lq, D], k and v [B, KVH, Lk, D] (f32,
// contiguous), an optional additive bias read through broadcast strides
// (sb, sh, si, sj: 0 on a broadcast axis), and kv head h / (H / KVH) for
// query head h (GQA without the repeat):
//   s   = (q . k^T) * scale + bias          (the bias after scaling)
//   s   = -inf above the diagonal where causal (Lq == Lk, top-left)
//   out = softmax(s) . v                    [B, H, Lq, D] f32
// A bool mask arrives as a 0 / -1e9 bias (the wrapper), so a row whose keys
// are all masked gives the uniform average of v, as on both JAX routes.
//
// What bounds it on an H100: operations. 4 * B * H * Lq * Lk * D f32
// multiply-adds counted as two operations each, on the CUDA cores at 67
// TFLOP/s (the products run in full f32: FFMA, no TF32); the bytes (q, k, v,
// bias read once, out written once) take a small fraction of that at Phi-3
// prefill widths (96.6 GFLOP: 1.44 ms; ~0.1 GB: 0.03 ms).
//
// Design (simple and right first; tensor-core products, TMA and skipping
// fully masked key tiles are later work):
//  - One CTA of 256 threads per (64-row q tile, head, batch row). A thread
//    owns 4 query rows (row group t / 16) and, in the score tile, 4 keys
//    (t % 16); in the output, CPT columns. Both phases give a thread the
//    same rows, so the running max m and sum l stay in its registers.
//  - A loop over 64-key tiles: S = q . k^T in head-dim chunks of 32 (q and
//    k chunks staged transposed in shared memory, one float4 of each per
//    16 FMAs), scale, bias, causal; a one-pass online softmax (row max and
//    sum reduced over the 16 threads of a row group by shuffles), P to
//    shared memory, then acc = acc * exp(m_old - m_new) + P . V.
//  - Any D with D % 8 == 0: the output is produced in passes of 16 * CPT
//    columns (CPT 4 for D <= 64, 6 for D <= 96, 8 above, in passes of 128),
//    each pass recomputing S; zero-filled columns past D add nothing.
//  - Fully masked rows: the max starts at -inf and the exponent's offset is
//    0 while it is -inf, so exp never sees -inf - (-inf).
//  - Causal: key tiles past the q tile's last row are not visited.
// The range: Lq, Lk multiples of 64, D % 8 == 0, H % KVH == 0, any B and H
// (the gate in kernels/flash_attention.py asks multiples of 128, as JAX's).

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

namespace {

constexpr int kBQ = 64;       // query rows a CTA
constexpr int kBK = 64;       // keys a tile
constexpr int kDK = 32;       // head-dim chunk of the score product
constexpr int kThreads = 256;
constexpr int kSP = kBQ + 4;  // pitch of the transposed q, k and P tiles

__device__ __forceinline__ float group_max(float x) {  // over the 16 lanes of a row group
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 8));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
}

__device__ __forceinline__ float group_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 8);
  x += __shfl_xor_sync(0xffffffffu, x, 4);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x + __shfl_xor_sync(0xffffffffu, x, 1);
}

template <int CPT>
constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * kDK * kSP + kBK * kSP + kBK * (16 * CPT + 4));
}

template <int CPT>  // output columns a thread in one pass
__global__ void __launch_bounds__(kThreads, 2)
flash_attn_f32(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ bias, long long sb,
               long long sh, long long si, long long sj, float* __restrict__ out, int H,
               int KVH, int Lq, int Lk, int D, float scale, int causal) {
  constexpr int DO = 16 * CPT;  // output columns a pass
  constexpr int VP = DO + 4;    // pitch of the v tile
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;             // [kDK][kSP]: q chunk, transposed
  float* ks = qs + kDK * kSP;   // [kDK][kSP]: k chunk, transposed
  float* ps = ks + kDK * kSP;   // [kBK][kSP]: P, transposed (key-major)
  float* vs = ps + kBK * kSP;   // [kBK][VP]:  v columns of this pass

  const int t = threadIdx.x;
  const int rg = t >> 4;  // rows 4 rg .. 4 rg + 3 of the tile
  const int cg = t & 15;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const float* qb = q + (static_cast<size_t>(b) * H + h) * Lq * D + static_cast<size_t>(q0) * D;
  const float* kb = k + (static_cast<size_t>(b) * KVH + kvh) * Lk * D;
  const float* vb = v + (static_cast<size_t>(b) * KVH + kvh) * Lk * D;
  float* ob = out + (static_cast<size_t>(b) * H + h) * Lq * D + static_cast<size_t>(q0) * D;
  const float* bb = bias != nullptr ? bias + b * sb + h * sh : nullptr;
  const int n_tiles = causal ? min(Lk / kBK, (q0 + kBQ - 1) / kBK + 1) : Lk / kBK;

  for (int c0 = 0; c0 < D; c0 += DO) {
    float acc[4][CPT];
    float m[4], l[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      m[r] = -INFINITY;
      l[r] = 0.0f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[r][j] = 0.0f;
    }

    for (int kt = 0; kt < n_tiles; ++kt) {
      const int k0 = kt * kBK;
      float s[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = 0.0f;

      for (int d0 = 0; d0 < D; d0 += kDK) {
        __syncthreads();  // the last readers of qs, ks (and ps, vs) are done
        for (int i = t; i < kBQ * kDK / 4; i += kThreads) {
          const int row = i / (kDK / 4);
          const int c4 = (i % (kDK / 4)) * 4;
          float4 qv = make_float4(0.f, 0.f, 0.f, 0.f);
          float4 kv = qv;
          if (d0 + c4 < D) {  // D % 8 == 0: a float4 lies wholly inside or outside
            qv = *reinterpret_cast<const float4*>(qb + static_cast<size_t>(row) * D + d0 + c4);
            kv = *reinterpret_cast<const float4*>(kb + static_cast<size_t>(k0 + row) * D + d0 +
                                                  c4);
          }
          qs[(c4 + 0) * kSP + row] = qv.x;
          qs[(c4 + 1) * kSP + row] = qv.y;
          qs[(c4 + 2) * kSP + row] = qv.z;
          qs[(c4 + 3) * kSP + row] = qv.w;
          ks[(c4 + 0) * kSP + row] = kv.x;
          ks[(c4 + 1) * kSP + row] = kv.y;
          ks[(c4 + 2) * kSP + row] = kv.z;
          ks[(c4 + 3) * kSP + row] = kv.w;
        }
        __syncthreads();
#pragma unroll 8
        for (int dd = 0; dd < kDK; ++dd) {
          const float4 a = *reinterpret_cast<const float4*>(qs + dd * kSP + 4 * rg);
          const float4 c = *reinterpret_cast<const float4*>(ks + dd * kSP + 4 * cg);
          const float av[4] = {a.x, a.y, a.z, a.w};
          const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int cc = 0; cc < 4; ++cc) s[r][cc] = fmaf(av[r], cv[cc], s[r][cc]);
        }
      }

      // scale, bias, causal; then the online softmax of each row
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = q0 + 4 * rg + r;
        float mx = -INFINITY;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int key = k0 + 4 * cg + c;
          float x = s[r][c] * scale;
          if (bb != nullptr) x += bb[row * si + key * sj];
          if (causal && key > row) x = -INFINITY;
          s[r][c] = x;
          mx = fmaxf(mx, x);
        }
        const float m_new = fmaxf(m[r], group_max(mx));
        const float off = m_new == -INFINITY ? 0.0f : m_new;
        const float alpha = expf(m[r] - off);
        float sum = 0.0f;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[r][c] = expf(s[r][c] - off);
          sum += s[r][c];
        }
        l[r] = l[r] * alpha + group_sum(sum);
        m[r] = m_new;
#pragma unroll
        for (int j = 0; j < CPT; ++j) acc[r][j] *= alpha;
      }
#pragma unroll
      for (int c = 0; c < 4; ++c)
        *reinterpret_cast<float4*>(ps + (4 * cg + c) * kSP + 4 * rg) =
            make_float4(s[0][c], s[1][c], s[2][c], s[3][c]);
      for (int i = t; i < kBK * DO / 4; i += kThreads) {
        const int key = i / (DO / 4);
        const int c4 = (i % (DO / 4)) * 4;
        float4 vv = make_float4(0.f, 0.f, 0.f, 0.f);
        if (c0 + c4 < D)
          vv = *reinterpret_cast<const float4*>(vb + static_cast<size_t>(k0 + key) * D + c0 + c4);
        *reinterpret_cast<float4*>(vs + key * VP + c4) = vv;
      }
      __syncthreads();

#pragma unroll 4
      for (int kk = 0; kk < kBK; ++kk) {
        const float4 p4 = *reinterpret_cast<const float4*>(ps + kk * kSP + 4 * rg);
        const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
        float vv[CPT];
        const float* vrow = vs + kk * VP + CPT * cg;
        if constexpr (CPT % 4 == 0) {
#pragma unroll
          for (int j = 0; j < CPT; j += 4) {
            const float4 x = *reinterpret_cast<const float4*>(vrow + j);
            vv[j] = x.x;
            vv[j + 1] = x.y;
            vv[j + 2] = x.z;
            vv[j + 3] = x.w;
          }
        } else {
#pragma unroll
          for (int j = 0; j < CPT; j += 2) {
            const float2 x = *reinterpret_cast<const float2*>(vrow + j);
            vv[j] = x.x;
            vv[j + 1] = x.y;
          }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int j = 0; j < CPT; ++j) acc[r][j] = fmaf(pv[r], vv[j], acc[r][j]);
      }
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float inv = 1.0f / l[r];
      float* orow = ob + static_cast<size_t>(4 * rg + r) * D + c0 + CPT * cg;
#pragma unroll
      for (int j = 0; j < CPT; ++j)
        if (c0 + CPT * cg + j < D) orow[j] = acc[r][j] * inv;
    }
  }
}

template <int CPT>
int launch(const float* q, const float* k, const float* v, const float* bias, long long sb,
           long long sh, long long si, long long sj, float* out, int B, int H, int KVH, int Lq,
           int Lk, int D, float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<CPT>();
  auto kernel = flash_attn_f32<CPT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(Lq / kBQ, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(q, k, v, bias, sb, sh, si, sj, out, H, KVH, Lq, Lk,
                                           D, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* lele_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// out [B, H, Lq, D] f32 from q [B, H, Lq, D], k and v [B, KVH, Lk, D] f32,
// contiguous and 16-byte aligned on the card; bias is null or an f32 tensor
// read at b * sb + h * sh + i * si + j * sj (element strides, 0 where it
// broadcasts). Launches on `stream`; returns cudaGetLastError(), or
// cudaErrorInvalidValue outside the kernel's range (Lq, Lk multiples of 64,
// D % 8 == 0, H % KVH == 0, causal only where Lq == Lk).
extern "C" int flash_attn(const void* q, const void* k, const void* v, const void* bias,
                          long long sb, long long sh, long long si, long long sj, void* out,
                          int B, int H, int KVH, int Lq, int Lk, int D, float scale, int causal,
                          void* stream) {
  if (B < 1 || H < 1 || KVH < 1 || H % KVH || Lq < kBQ || Lq % kBQ || Lk < kBK || Lk % kBK ||
      D < 8 || D % 8 || (causal && Lq != Lk) || H > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* bf = static_cast<const float*>(bias);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 64)
    return launch<4>(qf, kf, vf, bf, sb, sh, si, sj, of, B, H, KVH, Lq, Lk, D, scale, causal, s);
  if (D <= 96)
    return launch<6>(qf, kf, vf, bf, sb, sh, si, sj, of, B, H, KVH, Lq, Lk, D, scale, causal, s);
  return launch<8>(qf, kf, vf, bf, sb, sh, si, sj, of, B, H, KVH, Lq, Lk, D, scale, causal, s);
}
