// Kernel 6: the whole LSTM recurrence in one launch. Replaces
// lele_tpu/kernels/lstm.py:lstm_seq_pallas (line 21); its oracle there is
// lstm_seq_reference (line 84), here kernels/lstm.py:lstm_seq_plain.
//
// What it computes. For each batch row b and t = 0 .. S-1, in gate order
// i, f, g, o:
//   g = xproj[t, b] + h @ Wh                      (f32, 4H values)
//   i = sigmoid(g[0:H])   f = sigmoid(g[H:2H])   gg = tanh(g[2H:3H])
//   o = sigmoid(g[3H:4H]) c = f*c + i*gg          h = o*tanh(c)
//   hs[t, b] = h
// and h_S, c_S at the end. xproj = x @ Wx + b is computed outside, as the
// TPU kernel has it. f32 FMA on the CUDA cores (no TF32, no bf16) and the
// accurate expf/tanhf, so the result stays within f32 rounding of the
// plain version over thousands of steps.
//
// What bounds it. The recurrence is one dependent chain of S steps: step t
// needs all of h_{t-1}. At the VAD's H = 128 a step is 65,536 FMAs and 2 KB
// of xproj, so the roofline bound (S * 2*H*4H flops at 67 TFLOP/s, or the
// bytes at 3.35 TB/s) is ~2 ns a step, and the real limit is the latency of
// one step on one SM: its FMAs and shared-memory reads issue from one
// block, then two barriers. The kernel's time over S is the number to
// drive down.
//
// The design for Wh. At H = 128, Wh is 128 x 512 f32 = 256 KB: more than a
// block's 227 KB of shared memory, and all of an SM's registers. The TPU
// kernel keeps it in VMEM. Here one block runs one recurrence (one batch
// row) with one thread per gate column (4H threads). Thread j keeps rows
// [0, KR) of column j of Wh in registers for the whole run; rows [KR, H)
// sit in shared memory in groups of four rows, [(H-KR)/4][4H] float4, so a
// thread reads 16 bytes at a time and a warp 512 contiguous bytes. At
// H = 128, KR = 64: 64 registers a thread and 128 KB of shared memory; up
// to H = 64 the whole matrix fits in shared memory (KR = 0). h lives in
// shared memory and is read as a broadcast float4. A step: each thread's
// dot product and its gate's activation (all 4H in parallel) into shared
// memory, a barrier, H threads update (c, h), a barrier. xproj[t+1] is
// loaded during step t.
// Chosen, up to H = 128, over a cluster that splits the columns and
// exchanges h through distributed shared memory every step: one block needs
// no cluster barrier per step and no exchange, and its FMAs (512 cycles a
// step at H = 128 on one SM's 128 lanes) are of the order of such a
// barrier's latency.
//
// Two forms, one C entry. The range is 1 <= H <= 1024, any S >= 1 and
// B >= 1 (the LSTM emitter checks H before it launches):
//  - H <= 128: the single-block form above;
//  - 128 < H <= 1024: the general form of rnn_seq.cuh, a cluster of 8 CTAs
//    a batch row that exchanges h through distributed shared memory, with
//    the LSTM cell written there once (kernel 9 runs the same template with
//    GRU cells). At H = 1024 Wh is 16 MiB in f32, a third of the L2: the
//    rows past each thread's registers stream from L2 every step.
// The single-block form keeps its own split of the cell (each column's
// activation before the barrier, the unit update after), so its results
// stay bit for bit those of the first version.

#include <cuda_runtime.h>

#include <cstddef>

#include "rnn_seq.cuh"

namespace {

constexpr int kMaxH = 128;

using lele_rnn::sigmoid_acc;

template <int KR>  // rows of Wh held in registers
__global__ void __launch_bounds__(4 * kMaxH, 1)
lstm_seq_kernel(const float* __restrict__ xproj, const float* __restrict__ wh,
                const float* __restrict__ h0, const float* __restrict__ c0,
                float* __restrict__ hs, float* __restrict__ hf, float* __restrict__ cf,
                int S, int B, int H) {
  extern __shared__ float4 smem[];
  const int G = 4 * H;
  const int nq = (H - KR + 3) / 4;  // float4 groups of shared rows
  const int hp = 4 * ((H + 3) / 4);
  float4* ws = smem;                                          // [nq][G]
  float* hbuf = reinterpret_cast<float*>(ws + static_cast<size_t>(nq) * G);  // [hp]
  float* gbuf = hbuf + hp;                                    // [G]
  const int j = threadIdx.x;
  const int b = blockIdx.x;
  const bool col = j < G;

  float wr[KR > 0 ? KR : 1];
#pragma unroll
  for (int k = 0; k < KR; ++k) wr[k] = col ? wh[static_cast<size_t>(k) * G + j] : 0.0f;
  for (int idx = j; idx < nq * G; idx += blockDim.x) {
    const int q = idx / G;
    const int jj = idx - q * G;
    float v[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int k = KR + 4 * q + r;
      v[r] = k < H ? wh[static_cast<size_t>(k) * G + jj] : 0.0f;
    }
    ws[idx] = make_float4(v[0], v[1], v[2], v[3]);
  }
  for (int k = j; k < hp; k += blockDim.x)
    hbuf[k] = k < H ? h0[static_cast<size_t>(b) * H + k] : 0.0f;
  float c = j < H ? c0[static_cast<size_t>(b) * H + j] : 0.0f;
  __syncthreads();

  const float4* h4 = reinterpret_cast<const float4*>(hbuf);
  const float4* hq = h4 + KR / 4;
  const float4* wq = ws + j;
  float xnext = col ? xproj[static_cast<size_t>(b) * G + j] : 0.0f;
  for (int t = 0; t < S; ++t) {
    if (col) {
      float a0 = xnext, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
      if (t + 1 < S) xnext = __ldg(xproj + (static_cast<size_t>(t + 1) * B + b) * G + j);
#pragma unroll
      for (int q = 0; q < KR / 4; ++q) {
        const float4 hv = h4[q];
        a0 = fmaf(hv.x, wr[4 * q], a0);
        a1 = fmaf(hv.y, wr[4 * q + 1], a1);
        a2 = fmaf(hv.z, wr[4 * q + 2], a2);
        a3 = fmaf(hv.w, wr[4 * q + 3], a3);
      }
#pragma unroll 4
      for (int q = 0; q < nq; ++q) {
        const float4 hv = hq[q];
        const float4 w = wq[static_cast<size_t>(q) * G];
        a0 = fmaf(hv.x, w.x, a0);
        a1 = fmaf(hv.y, w.y, a1);
        a2 = fmaf(hv.z, w.z, a2);
        a3 = fmaf(hv.w, w.w, a3);
      }
      const float g = (a0 + a1) + (a2 + a3);
      gbuf[j] = j >= 2 * H && j < 3 * H ? tanhf(g) : sigmoid_acc(g);  // gate j's activation
    }
    __syncthreads();
    if (j < H) {
      c = gbuf[H + j] * c + gbuf[j] * gbuf[2 * H + j];
      const float h = gbuf[3 * H + j] * tanhf(c);
      hbuf[j] = h;
      hs[(static_cast<size_t>(t) * B + b) * H + j] = h;
    }
    __syncthreads();
  }
  if (j < H) {
    hf[static_cast<size_t>(b) * H + j] = hbuf[j];
    cf[static_cast<size_t>(b) * H + j] = c;
  }
}

}  // namespace

extern "C" const char* lele_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// hs [S, B, H], hf and cf [B, H] f32 from xproj [S, B, 4H], wh [H, 4H],
// h0 and c0 [B, H] f32, all contiguous on the card. One block per batch
// row up to H = 128, one cluster of 8 blocks above. Launches on `stream`;
// returns cudaGetLastError(), or cudaErrorInvalidValue outside the kernel's
// range (1 <= H <= 1024, S >= 1, B >= 1).
extern "C" int lstm_seq(const void* xproj, const void* wh, const void* h0, const void* c0,
                        void* hs, void* hf, void* cf, int S, int B, int H, void* stream) {
  if (H < 1 || H > lele_rnn::kMaxGeneralH || S < 1 || B < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (H > kMaxH)
    return lele_rnn::launch_rnn_cluster<lele_rnn::kLstm>(
        static_cast<const float*>(xproj), static_cast<const float*>(wh), nullptr,
        static_cast<const float*>(h0), static_cast<const float*>(c0), static_cast<float*>(hs),
        static_cast<float*>(hf), static_cast<float*>(cf), S, B, H,
        static_cast<cudaStream_t>(stream));
  const int G = 4 * H;
  const int threads = (G + 31) / 32 * 32;
  const int kr = H > 64 ? 64 : 0;
  const int nq = (H - kr + 3) / 4;
  const int hp = 4 * ((H + 3) / 4);
  const size_t smem = static_cast<size_t>(nq) * G * sizeof(float4) +
                      static_cast<size_t>(hp + G) * sizeof(float);
  void (*kernel)(const float*, const float*, const float*, const float*, float*, float*,
                 float*, int, int, int) = kr ? lstm_seq_kernel<64> : lstm_seq_kernel<0>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xproj), static_cast<const float*>(wh),
      static_cast<const float*>(h0), static_cast<const float*>(c0), static_cast<float*>(hs),
      static_cast<float*>(hf), static_cast<float*>(cf), S, B, H);
  return static_cast<int>(cudaGetLastError());
}
