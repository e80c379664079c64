// L SAN-M encoder layers of a compiled int8 ONNX graph, with exact ONNX
// DynamicQuantizeLinear semantics in each of the four linears (kernel 4).
// Replaces lele_tpu/kernels/sanm_block.py:sanm_stack_dql_pallas
// (`_stack_kernel_dql`, `_dql_dot`). One C entry walks the layers on
// pointer offsets into the stacked [L, ...] weights, eleven launches a layer
// on one stream (each dq_gemm is a quantize pass and the GEMM), the
// activation updated in place:
//
//   1. h = LN1(x), eps1            ln_range: also max(h, 0) and max(-h, 0)
//   2. qkv = dql(h)                dq_gemm (dq_gemm.cuh), bias in the epilogue
//   3. a = attn(q, k, v) + fsmn    attn_fsmn_dql: f32 attention under the
//                                  graph's key bias, + the FSMN over
//                                  v * vmask with the graph's left pad;
//                                  also the range of a
//   4. x += dql(a)                 dq_gemm, bias + residual, in place
//   5. h = LN2(x), eps2            ln_range
//   6. f = relu(dql(h))            dq_gemm, bias + ReLU, range of f
//   7. x += dql(f)                 dq_gemm, bias + residual, in place
//
// DQL needs each activation's global min and max before its GEMM, a
// reduction across blocks. The producer of each activation (LN, attention,
// the ffn1 GEMM's epilogue) folds its outputs into max(v, 0) and max(-v, 0)
// with one atomicMax per warp on the floats' bits (non-negative floats order
// like ints); min and max are exact in any order, so this costs no
// determinism. Every consumer block derives the same scale and zero point
// from that pair. The kernel pads no rows: every range covers exactly the
// graph's T rows (the bucket's padded frames are real rows of the graph).
//
// What bounds it on the H100, at 10 s of audio (T = 196): the int8 weights
// stream once, 3,145,728 B a layer, 157.3 MB for 50 layers, ~47 us at
// 3.35 TB/s; the int8 products are 61.7 GOP, ~31 us at 1,979 TOP/s; the f32
// attention is ~3.9 GFLOP, ~58 us at 67 TFLOP/s on the SIMT cores. The
// design keeps attention in f32 on the CUDA cores (FMA, never TF32 or bf16
// tensor cores): a block holds 8 query rows' full score rows in shared
// memory (T <= 2048), so the softmax is the plain max / exp / sum / divide
// over the whole row. This version is far from that bound: attention runs
// on 4 heads x 25 query tiles of 4 warps at T = 196, too few warps to hide
// the latency of its shared-memory loads (the largest share of the stack's
// time), and each layer is 11 launches on one stream.
#include "dq_gemm.cuh"

namespace lele {

constexpr int DQ_ATT_BQ = 8;       // query rows per attention block
constexpr int DQ_ATT_BKEY = 64;    // keys per staged tile
constexpr int DQ_ATT_TMAX = 2048;  // most rows: 8 score rows of T floats in shared memory

__host__ __device__ constexpr int dq_att_smem(int hd, int T) {
  return (DQ_ATT_BQ * hd + DQ_ATT_BKEY * (hd + 1) + DQ_ATT_BQ * ((T + 3) & ~3)) * 4;
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

// y[t] = (x[t] - mean) * (1 / sqrt(var + eps)) * g + b, one block per row,
// as the ONNX LayerNormalization emitter computes it; adds the row's
// outputs to the range pair mm for the next DQL
__global__ void __launch_bounds__(128)
ln_range(const float* __restrict__ x, const float* __restrict__ g,
         const float* __restrict__ b, float* __restrict__ y, int D, float eps, int* mm) {
  __shared__ float sh[4];
  const float* xr = x + (size_t)blockIdx.x * D;
  float* yr = y + (size_t)blockIdx.x * D;
  float s = 0.f;
  for (int i = threadIdx.x; i < D; i += 128) s += xr[i];
  const float mu = __fdiv_rn(block_sum128(s, sh), static_cast<float>(D));
  float s2 = 0.f;
  for (int i = threadIdx.x; i < D; i += 128) {
    const float d = __fsub_rn(xr[i], mu);
    s2 = fmaf(d, d, s2);
  }
  const float var = __fdiv_rn(block_sum128(s2, sh), static_cast<float>(D));
  const float inv = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));
  float pos = 0.f, neg = 0.f;
  for (int i = threadIdx.x; i < D; i += 128) {
    const float v = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(xr[i], mu), inv), g[i]), b[i]);
    yr[i] = v;
    range_update(v, pos, neg);
  }
  range_commit(pos, neg, mm);
}

// rows [k0, k0 + DQ_ATT_BKEY) of one head of k or v (row stride D3) into
// shared memory [key][HD + 1] (the pad keeps column reads conflict free)
template <int HD>
__device__ __forceinline__ void stage_keys(float* dst, const float* src, int D3, int k0, int T) {
  for (int i = threadIdx.x; i < DQ_ATT_BKEY * HD; i += 128) {
    const int j = i / HD, d = i % HD, t = k0 + j;
    dst[j * (HD + 1) + d] = t < T ? src[(size_t)t * D3 + d] : 0.f;
  }
}

// Attention + FSMN for one (head, 8-query tile), in f32 on the CUDA cores.
// 1. scores: each thread owns one key of each 64-key tile and 4 query rows;
//    S = (Q . K) * att_scale + bias[key], kept whole in shared memory.
// 2. softmax: a warp per row, max, exp(s - max), sum, divide.
// 3. O = P . V over 64-key tiles of V; each thread owns one column.
// 4. out = O + sum_kk v[t + kk - pad_left] * vmask * w[kk] (zero outside
//    [0, T)), and the tile's range for the out-linear's DQL.
template <int HD>
__global__ void __launch_bounds__(128)
attn_fsmn_dql(const float* __restrict__ qkv, const float* __restrict__ bias,
              const float* __restrict__ vmask, const float* __restrict__ fsmn_w,
              float* __restrict__ out, int T, int D, int fsmn_k, int pad_left,
              float att_scale, int* mm) {
  constexpr int BQ = DQ_ATT_BQ, BK = DQ_ATT_BKEY, LDK = HD + 1;
  constexpr int RS = 128 / HD, RPT = BQ / RS;  // P.V: row stride, rows a thread
  extern __shared__ __align__(16) float smem[];
  const int TS = (T + 3) & ~3;
  float* Qs = smem;               // [BQ][HD]
  float* KVs = Qs + BQ * HD;      // [BK][HD + 1]
  float* S = KVs + BK * LDK;      // [BQ][TS]
  const int h = blockIdx.x, q0 = blockIdx.y * BQ, tid = threadIdx.x;
  const int D3 = 3 * D;
  const float* Qg = qkv + h * HD;
  const float* Kg = qkv + D + h * HD;
  const float* Vg = qkv + 2 * D + h * HD;

  for (int i = tid; i < BQ * HD; i += 128) {
    const int r = i / HD, t = q0 + r;
    Qs[i] = t < T ? Qg[(size_t)t * D3 + i % HD] : 0.f;
  }
  const int j = tid % BK, r0 = tid / BK;  // scores: key j, rows r0, r0 + 2, ...
  for (int k0 = 0; k0 < T; k0 += BK) {
    __syncthreads();  // Qs is written, the previous tile consumed
    stage_keys<HD>(KVs, Kg, D3, k0, T);
    __syncthreads();
    float acc[BQ / 2];
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) acc[i] = 0.f;
    for (int d = 0; d < HD; ++d) {
      const float kv = KVs[j * LDK + d];
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i) acc[i] = fmaf(Qs[(r0 + 2 * i) * HD + d], kv, acc[i]);
    }
    const int t = k0 + j;
    if (t < T) {
#pragma unroll
      for (int i = 0; i < BQ / 2; ++i)
        S[(r0 + 2 * i) * TS + t] = __fadd_rn(__fmul_rn(acc[i], att_scale), bias[t]);
    }
  }
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  for (int r = warp; r < BQ; r += 4) {
    float* Sr = S + r * TS;
    float mx = -INFINITY;
    for (int t = lane; t < T; t += 32) mx = fmaxf(mx, Sr[t]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.f;
    for (int t = lane; t < T; t += 32) {
      const float e = expf(__fsub_rn(Sr[t], mx));
      Sr[t] = e;
      sum += e;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    for (int t = lane; t < T; t += 32) Sr[t] = __fdiv_rn(Sr[t], sum);
  }

  const int d = tid % HD, rr = tid / HD;
  float o[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) o[i] = 0.f;
  for (int k0 = 0; k0 < T; k0 += BK) {
    __syncthreads();  // S is final, the previous tile consumed
    stage_keys<HD>(KVs, Vg, D3, k0, T);
    __syncthreads();
    const int n = min(BK, T - k0);
    for (int jj = 0; jj < n; ++jj) {
      const float v = KVs[jj * LDK + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i) o[i] = fmaf(S[(rr + RS * i) * TS + k0 + jj], v, o[i]);
    }
  }

  float pos = 0.f, neg = 0.f;
  const int c = h * HD + d;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int t = q0 + rr + RS * i;
    if (t >= T) continue;
    float f = 0.f;
    for (int kk = 0; kk < fsmn_k; ++kk) {
      const int tt = t + kk - pad_left;
      if (tt >= 0 && tt < T)
        f = fmaf(__fmul_rn(Vg[(size_t)tt * D3 + d], vmask[tt]), fsmn_w[kk * D + c], f);
    }
    const float v = __fadd_rn(o[i], f);
    out[(size_t)t * D + c] = v;
    range_update(v, pos, neg);
  }
  range_commit(pos, neg, mm);
}

// whether attn_fsmn_dql<HD> may take its largest shared memory yet, per head
// dim; internal linkage keeps the flags of this library its own (a static
// inside an inline template would be one object across every library loaded)
namespace {
bool smem_attr_set[3] = {false, false, false};
}

template <int HD>
inline cudaError_t launch_attn_fsmn_dql(const float* qkv, const float* bias, const float* vmask,
                                        const float* fsmn_w, float* out, int T, int D, int H,
                                        int fsmn_k, int pad_left, float att_scale, int* mm,
                                        cudaStream_t s) {
  bool& attr_set = smem_attr_set[HD == 32 ? 0 : HD == 64 ? 1 : 2];
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(attn_fsmn_dql<HD>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               dq_att_smem(HD, DQ_ATT_TMAX));
    if (e != cudaSuccess) return e;
    attr_set = true;
  }
  const dim3 grid(H, (T + DQ_ATT_BQ - 1) / DQ_ATT_BQ);
  attn_fsmn_dql<HD><<<grid, 128, dq_att_smem(HD, T), s>>>(qkv, bias, vmask, fsmn_w, out, T, D,
                                                          fsmn_k, pad_left, att_scale, mm);
  return cudaGetLastError();
}

}  // namespace lele

#define LELE_CHECK_LAUNCH()                          \
  do {                                               \
    const cudaError_t e_ = cudaGetLastError();       \
    if (e_ != cudaSuccess) return static_cast<int>(e_); \
  } while (0)

// The L-layer stack, in place on x [T, D] f32. bias and vmask [L, T] f32.
// Linears (qkv [D,3D], out [D,D], ffn1 [D,F], ffn2 [F,D]): int8 w [L, K, N],
// int32 colsum, f32 ws and b [L, 1, N]. Norms g, b [L, 1, D] f32; fsmn_w
// [L, fsmn_k, D] f32. Scratch: h [T, D], qkv [T, 3D], a [T, D], f [T, F]
// f32, the codes of a linear's input q [T, max(D, F)] int8, and minmax
// [L, 4, 2] int32 (zeroed here). Returns cudaGetLastError().
extern "C" int sanm_stack_dql(
    void* x, int T, int D, int H, int F, int L, int fsmn_k, int pad_left, float eps1,
    float eps2, float att_scale, const void* bias, const void* vmask, const void* wqkv,
    const void* cqkv, const void* sqkv, const void* bqkv, const void* wo, const void* co,
    const void* so, const void* bo, const void* w1, const void* c1, const void* s1,
    const void* bf1, const void* w2, const void* c2, const void* s2, const void* bf2,
    const void* g1, const void* b1, const void* g2, const void* b2, const void* fsmn_w,
    void* h, void* qkv, void* a, void* f1, void* q, void* minmax, void* stream) {
  using namespace lele;
  if (T == 0 || L == 0) return 0;
  const int hd = D / H;
  if (hd * H != D || (hd != 32 && hd != 64 && hd != 128) || T > DQ_ATT_TMAX ||
      fsmn_k < 1 || pad_left < 0 || pad_left >= fsmn_k)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* X = static_cast<float*>(x);
  float* Hb = static_cast<float*>(h);
  float* QKV = static_cast<float*>(qkv);
  float* A = static_cast<float*>(a);
  float* F1 = static_cast<float*>(f1);
  int8_t* Q = static_cast<int8_t*>(q);
  int* MM = static_cast<int*>(minmax);
  auto f32 = [](const void* p, size_t off) { return static_cast<const float*>(p) + off; };
  auto i32 = [](const void* p, size_t off) { return static_cast<const int*>(p) + off; };
  auto i8 = [](const void* p, size_t off) { return static_cast<const int8_t*>(p) + off; };
  const size_t D3 = 3 * static_cast<size_t>(D);

  if (cudaMemsetAsync(MM, 0, sizeof(int) * 8 * static_cast<size_t>(L), s) != cudaSuccess)
    return static_cast<int>(cudaGetLastError());
  for (int i = 0; i < L; ++i) {
    const size_t li = static_cast<size_t>(i);
    int* mm = MM + 8 * li;
    ln_range<<<T, 128, 0, s>>>(X, f32(g1, li * D), f32(b1, li * D), Hb, D, eps1, mm);
    LELE_CHECK_LAUNCH();
    launch_dq_gemm(Hb, Q, i8(wqkv, li * D * D3), QKV, T, D, 3 * D, DqlSrc{nullptr, nullptr, mm},
                   DqEpilogue{i32(cqkv, li * D3), f32(sqkv, li * D3), 0.f, f32(bqkv, li * D3),
                              nullptr, 0, nullptr},
                   s);
    LELE_CHECK_LAUNCH();
    cudaError_t e;
    const float* bias_i = f32(bias, li * T);
    const float* vmask_i = f32(vmask, li * T);
    const float* fw_i = f32(fsmn_w, li * fsmn_k * D);
    switch (hd) {
      case 32:
        e = launch_attn_fsmn_dql<32>(QKV, bias_i, vmask_i, fw_i, A, T, D, H, fsmn_k, pad_left,
                                     att_scale, mm + 2, s);
        break;
      case 64:
        e = launch_attn_fsmn_dql<64>(QKV, bias_i, vmask_i, fw_i, A, T, D, H, fsmn_k, pad_left,
                                     att_scale, mm + 2, s);
        break;
      default:
        e = launch_attn_fsmn_dql<128>(QKV, bias_i, vmask_i, fw_i, A, T, D, H, fsmn_k, pad_left,
                                      att_scale, mm + 2, s);
        break;
    }
    if (e != cudaSuccess) return static_cast<int>(e);
    launch_dq_gemm(A, Q, i8(wo, li * D * D), X, T, D, D, DqlSrc{nullptr, nullptr, mm + 2},
                   DqEpilogue{i32(co, li * D), f32(so, li * D), 0.f, f32(bo, li * D), X, 0,
                              nullptr},
                   s);
    LELE_CHECK_LAUNCH();
    ln_range<<<T, 128, 0, s>>>(X, f32(g2, li * D), f32(b2, li * D), Hb, D, eps2, mm + 4);
    LELE_CHECK_LAUNCH();
    launch_dq_gemm(Hb, Q, i8(w1, li * D * F), F1, T, D, F, DqlSrc{nullptr, nullptr, mm + 4},
                   DqEpilogue{i32(c1, li * F), f32(s1, li * F), 0.f, f32(bf1, li * F),
                              nullptr, 1, mm + 6},
                   s);
    LELE_CHECK_LAUNCH();
    launch_dq_gemm(F1, Q, i8(w2, li * F * D), X, T, F, D, DqlSrc{nullptr, nullptr, mm + 6},
                   DqEpilogue{i32(c2, li * D), f32(s2, li * D), 0.f, f32(bf2, li * D), X, 0,
                              nullptr},
                   s);
    LELE_CHECK_LAUNCH();
  }
  return 0;
}
