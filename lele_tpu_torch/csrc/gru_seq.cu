// Kernel 9: the whole GRU recurrence in one launch. Replaces
// lele_tpu/kernels/gru.py:gru_seq_pallas (line 18); its oracle there is
// gru_seq_reference (line 78), here kernels/gru.py:gru_seq_plain.
//
// What it computes. For each batch row b and t = 0 .. S-1, gates z, r, h in
// ONNX's order, xproj = x @ Wx + Wb computed outside, rb the recurrent bias:
//   d = h @ Rh + rb                               (f32, 3H values)
//   z = sigmoid(xz + d_z)   r = sigmoid(xr + d_r)
//   linear_before_reset:  hh = tanh(xh + r * d_h)
//   otherwise:            hh = tanh((xh + (r * h) @ Rh[:, 2H:]) + rb_h)
//   h = (1 - z) * hh + z * h;   hs[t, b] = h
// and h_S at the end. f32 FMA on the CUDA cores and the accurate
// expf/tanhf, as kernel 6, so the result stays within f32 rounding of the
// plain version over thousands of steps. The cells are rnn_seq.cuh's.
//
// What bounds it: as kernel 6, the latency of one dependent step. At
// H = 128 a step is 49,152 FMAs (65,536 without linear_before_reset) and
// 1.5 KB of xproj; the roofline bound is ~1.5 ns a step.
//
// Two forms, one C entry; the range is 1 <= H <= 1024, any S >= 1, B >= 1:
//  - H <= 128, the single-block form: kernel 6's skeleton, one block per
//    batch row and one thread per gate column (3H threads). Thread j keeps
//    rows [0, KR) of column j of Rh in registers (KR = 64 above H = 64) and
//    the rest in shared memory as float4 groups of four rows; at H = 128 Rh
//    is 192 KB, so 96 KB stay in shared memory. h lives in shared memory.
//    A step: the 2H z and r columns (and, with linear_before_reset, the H
//    h columns: d_h) in parallel, a barrier, H threads update h, a barrier.
//    Without linear_before_reset r * h must be whole before the h columns'
//    second product: z and r, a barrier, r * h, a barrier, the h columns on
//    r * h, a barrier, the update, a barrier. xproj[t+1] is loaded during
//    step t.
//  - 128 < H <= 1024, the general form of rnn_seq.cuh with GRU cells: a
//    cluster of 8 CTAs a batch row, h (and r * h) exchanged through
//    distributed shared memory.

#include <cuda_runtime.h>

#include <cstddef>

#include "rnn_seq.cuh"

namespace {

constexpr int kMaxH = 128;

using lele_rnn::gru_out;
using lele_rnn::sigmoid_acc;

template <int KR, bool LBR>  // KR: rows of Rh held in registers
__global__ void __launch_bounds__(3 * kMaxH, 1)
gru_seq_block(const float* __restrict__ xproj, const float* __restrict__ rh,
              const float* __restrict__ rb, const float* __restrict__ h0,
              float* __restrict__ hs, float* __restrict__ hf, int S, int B, int H) {
  extern __shared__ float4 smem[];
  const int G = 3 * H;
  const int nq = (H - KR + 3) / 4;  // float4 groups of shared rows
  const int hp = 4 * ((H + 3) / 4);
  float4* ws = smem;                                                         // [nq][G]
  float* hbuf = reinterpret_cast<float*>(ws + static_cast<size_t>(nq) * G);  // [hp]
  float* rbuf = hbuf + hp;                                                   // [hp]: r * h
  float* gbuf = rbuf + hp;                                                   // [G]
  const int j = threadIdx.x;
  const int b = blockIdx.x;
  const bool col = j < G;
  const int gate = col ? j / H : 3;

  float wr[KR > 0 ? KR : 1];
#pragma unroll
  for (int k = 0; k < KR; ++k) wr[k] = col ? rh[static_cast<size_t>(k) * G + j] : 0.0f;
  for (int idx = j; idx < nq * G; idx += blockDim.x) {
    const int q = idx / G;
    const int jj = idx - q * G;
    float v[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int k = KR + 4 * q + r;
      v[r] = k < H ? rh[static_cast<size_t>(k) * G + jj] : 0.0f;
    }
    ws[idx] = make_float4(v[0], v[1], v[2], v[3]);
  }
  for (int k = j; k < hp; k += blockDim.x) {
    hbuf[k] = k < H ? h0[static_cast<size_t>(b) * H + k] : 0.0f;
    rbuf[k] = 0.0f;
  }
  const float rbj = col ? rb[j] : 0.0f;
  const float rbh = j < H ? rb[2 * H + j] : 0.0f;  // the unit's h-gate bias
  float xnext = col ? xproj[static_cast<size_t>(b) * G + j] : 0.0f;
  float xhnext = j < H ? xproj[static_cast<size_t>(b) * G + 2 * H + j] : 0.0f;
  __syncthreads();

  const float4* wq = ws + j;
  // column j's product with v [hp]
  auto dot = [&](const float* v) -> float {
    const float4* v4 = reinterpret_cast<const float4*>(v);
    const float4* vq = v4 + KR / 4;
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
#pragma unroll
    for (int q = 0; q < KR / 4; ++q) {
      const float4 hv = v4[q];
      a0 = fmaf(hv.x, wr[4 * q], a0);
      a1 = fmaf(hv.y, wr[4 * q + 1], a1);
      a2 = fmaf(hv.z, wr[4 * q + 2], a2);
      a3 = fmaf(hv.w, wr[4 * q + 3], a3);
    }
#pragma unroll 4
    for (int q = 0; q < nq; ++q) {
      const float4 hv = vq[q];
      const float4 w = wq[static_cast<size_t>(q) * G];
      a0 = fmaf(hv.x, w.x, a0);
      a1 = fmaf(hv.y, w.y, a1);
      a2 = fmaf(hv.z, w.z, a2);
      a3 = fmaf(hv.w, w.w, a3);
    }
    return (a0 + a1) + (a2 + a3);
  };

  for (int t = 0; t < S; ++t) {
    const float x = xnext, xh = xhnext;
    if (t + 1 < S) {
      const size_t row = (static_cast<size_t>(t + 1) * B + b) * G;
      if (col) xnext = __ldg(xproj + row + j);
      if (j < H) xhnext = __ldg(xproj + row + 2 * H + j);
    }
    if constexpr (LBR) {
      if (col) {
        const float d = dot(hbuf) + rbj;
        gbuf[j] = gate < 2 ? sigmoid_acc(x + d) : d;  // z, r activated; d_h raw
      }
      __syncthreads();
      if (j < H) {
        const float h = gru_out(gbuf[j], tanhf(xh + gbuf[H + j] * gbuf[2 * H + j]), hbuf[j]);
        hbuf[j] = h;
        hs[(static_cast<size_t>(t) * B + b) * H + j] = h;
      }
      __syncthreads();
    } else {
      if (gate < 2) gbuf[j] = sigmoid_acc(x + (dot(hbuf) + rbj));
      __syncthreads();
      if (j < H) rbuf[j] = gbuf[H + j] * hbuf[j];
      __syncthreads();
      if (gate == 2) gbuf[j] = dot(rbuf);
      __syncthreads();
      if (j < H) {
        const float h = gru_out(gbuf[j], tanhf((xh + gbuf[2 * H + j]) + rbh), hbuf[j]);
        hbuf[j] = h;
        hs[(static_cast<size_t>(t) * B + b) * H + j] = h;
      }
      __syncthreads();
    }
  }
  if (j < H) hf[static_cast<size_t>(b) * H + j] = hbuf[j];
}

template <int KR, bool LBR>
int launch_block(const float* xproj, const float* rh, const float* rb, const float* h0,
                 float* hs, float* hf, int S, int B, int H, cudaStream_t stream) {
  const int G = 3 * H;
  const int threads = (G + 31) / 32 * 32;
  const int nq = (H - KR + 3) / 4;
  const int hp = 4 * ((H + 3) / 4);
  const size_t smem = static_cast<size_t>(nq) * G * sizeof(float4) +
                      static_cast<size_t>(2 * hp + G) * sizeof(float);
  auto kernel = gru_seq_block<KR, LBR>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<B, threads, smem, stream>>>(xproj, rh, rb, h0, hs, hf, S, B, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* lele_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// hs [S, B, H] and hf [B, H] f32 from xproj [S, B, 3H], rh [H, 3H], rb [3H]
// and h0 [B, H] f32, all contiguous on the card; lbr: linear_before_reset.
// One block per batch row up to H = 128, one cluster of 8 blocks above.
// Launches on `stream`; returns cudaGetLastError(), or
// cudaErrorInvalidValue outside the kernel's range (1 <= H <= 1024,
// S >= 1, B >= 1).
extern "C" int gru_seq(const void* xproj, const void* rh, const void* rb, const void* h0,
                       void* hs, void* hf, int S, int B, int H, int lbr, void* stream) {
  if (H < 1 || H > lele_rnn::kMaxGeneralH || S < 1 || B < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* x = static_cast<const float*>(xproj);
  const float* w = static_cast<const float*>(rh);
  const float* bias = static_cast<const float*>(rb);
  const float* h = static_cast<const float*>(h0);
  float* ys = static_cast<float*>(hs);
  float* yf = static_cast<float*>(hf);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H > kMaxH) {
    if (lbr)
      return lele_rnn::launch_rnn_cluster<lele_rnn::kGruLbr>(x, w, bias, h, nullptr, ys, yf,
                                                              nullptr, S, B, H, s);
    return lele_rnn::launch_rnn_cluster<lele_rnn::kGru>(x, w, bias, h, nullptr, ys, yf, nullptr,
                                                         S, B, H, s);
  }
  if (H > 64)
    return lbr ? launch_block<64, true>(x, w, bias, h, ys, yf, S, B, H, s)
               : launch_block<64, false>(x, w, bias, h, ys, yf, S, B, H, s);
  return lbr ? launch_block<0, true>(x, w, bias, h, ys, yf, S, B, H, s)
             : launch_block<0, false>(x, w, bias, h, ys, yf, S, B, H, s);
}
