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
// Two forms, one C entry, chosen by H alone; the range is 1 <= H <= 1024,
// any S >= 1, B >= 1:
//  - H <= 128, the register form (gru_seq_reg): one block of 256 threads
//    (2H rounded up to a warp below H = 128) per batch row, and no
//    recurrent weight read from shared memory in the step. Thread 4q + p
//    holds rows [32p, 32p + 32) of units 2q and 2q + 1's three columns of
//    Rh (z, r and h: 192 weights, all in registers; rows and units past H
//    are zeros), so the 4 K-parts of a unit sit in adjacent lanes and two
//    __shfl_xor_sync rounds sum them. Every lane of the unit pair then has
//    its d_z, d_r, d_h and runs the cell itself, no barrier between the
//    product and the cell: lanes 2k and 2k + 1 work for unit 2q + k, the
//    one taking z's sigmoid and the other r's in one stream, each reading
//    both back by a shuffle (the accurate expf and tanhf are the step's
//    longest chain, so a warp runs one sigmoid and one tanh, not three).
//    h is double-buffered in shared memory, part p at word 36p (a pad of 4
//    words a part), so the 4 parts' 16-byte loads fall in distinct banks;
//    one block barrier a step with linear_before_reset; without it r * h
//    must be whole before the h column's product: z and r, r * h to shared
//    memory, a barrier, the h column on r * h, a barrier. A lane's two
//    xproj words of step t+1 are loaded during step t.
//    Why two units a thread: every thread reads its part of h (32 words)
//    from shared memory each step, so 512 threads of one unit each need
//    512 wavefronts of shared-memory reads a step against 256 here, and
//    each loaded h word feeds 6 FMAs, not 3. Step times at H = 128 (NVIDIA
//    H100 80GB HBM3, 700 W; chip_smoke.graph_us; S = 1,875 and 18,750, with
//    / without linear_before_reset): this form 0.52 and 0.71 us
//    (scripts/torch_port_kernel_ab.py); cuDNN's GRU 0.69 (linear_before_
//    reset); a thread a gate column with rows 64-127 re-read from shared
//    memory every step (~1,150 wavefronts) 1.18 and 1.31. Builds not kept:
//    512 threads of 96 weights (no spill) 0.78 and 1.07, 0.73 and 1.00
//    with the single sigmoid stream; this form with two accumulators a
//    column 0.58 and 0.71. Registers: 255 a thread; ptxas spills 88
//    bytes (104 without linear_before_reset), which the SASS (cuobjdump)
//    shows as stores in the weight-loading prologue and one reload each
//    (LDL.LU) before the step loop: the step itself touches no local
//    memory.
//  - 128 < H <= 1024, the general form of rnn_seq.cuh with GRU cells: a
//    cluster of 8 CTAs a batch row, h (and r * h) exchanged through
//    distributed shared memory.

#include <cuda_runtime.h>

#include <cstddef>

#include "rnn_seq.cuh"

namespace {

constexpr int kMaxH = 128;
constexpr int kUnits = 2;                // units a thread
constexpr int kParts = 4;                // K-parts of a unit, adjacent lanes
constexpr int kPartRows = kMaxH / kParts;  // 32 rows of Rh a thread
constexpr int kPartPitch = kPartRows + 4;  // words between parts in shared memory
constexpr int kHWords = kParts * kPartPitch;

using lele_rnn::gru_out;
using lele_rnn::sigmoid_acc;

__device__ __forceinline__ int hslot(int i) { return i + 4 * (i / kPartRows); }

// The column sums of a thread's units over its part's 32 rows: column c of
// each of its two units against hv (this part's 32 words of h, 16-byte
// aligned), summed over the unit's 4 lanes; columns c0 .. c0 + NC - 1.
template <int NC>
__device__ __forceinline__ void part_dot(const float (&w)[kUnits][3][kPartRows], const float* hv,
                                         float (&d)[kUnits][3], int c0) {
  float a[kUnits][NC];
#pragma unroll
  for (int k = 0; k < kUnits; ++k)
#pragma unroll
    for (int c = 0; c < NC; ++c) a[k][c] = 0.0f;
#pragma unroll
  for (int i = 0; i < kPartRows; i += 4) {
    const float4 h4 = *reinterpret_cast<const float4*>(hv + i);
#pragma unroll
    for (int k = 0; k < kUnits; ++k)
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        a[k][c] = fmaf(h4.x, w[k][c0 + c][i], a[k][c]);
        a[k][c] = fmaf(h4.y, w[k][c0 + c][i + 1], a[k][c]);
        a[k][c] = fmaf(h4.z, w[k][c0 + c][i + 2], a[k][c]);
        a[k][c] = fmaf(h4.w, w[k][c0 + c][i + 3], a[k][c]);
      }
  }
#pragma unroll
  for (int k = 0; k < kUnits; ++k)
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      float x = a[k][c];
      x += __shfl_xor_sync(0xffffffffu, x, 1);
      x += __shfl_xor_sync(0xffffffffu, x, 2);
      d[k][c0 + c] = x;
    }
}

// one of this thread's two units' values, by the lane's own unit
__device__ __forceinline__ float pick(const float (&v)[kUnits], int k) {
  return k ? v[1] : v[0];
}

template <bool LBR>
__global__ void __launch_bounds__(kParts * kMaxH / kUnits, 1)
gru_seq_reg(const float* __restrict__ xproj, const float* __restrict__ rh,
            const float* __restrict__ rb, const float* __restrict__ h0,
            float* __restrict__ hs, float* __restrict__ hf, int S, int B, int H) {
  __shared__ __align__(16) float hbuf[2][kHWords];
  __shared__ __align__(16) float rbuf[kHWords];  // r * h, without linear_before_reset
  const int G = 3 * H;
  const int p = threadIdx.x & (kParts - 1);
  const int q = threadIdx.x / kParts;  // units 2q and 2q + 1
  const int b = blockIdx.x;
  // the cell: lanes 2k and 2k + 1 work for unit 2q + k; lane 2k takes its z
  // sigmoid, lane 2k + 1 its r, in one stream
  const int k_me = p >> 1;
  const int u_me = kUnits * q + k_me;
  const bool live = u_me < H;
  const bool writer = live && (p & 1) == 0;

  float w[kUnits][3][kPartRows];
#pragma unroll
  for (int k = 0; k < kUnits; ++k)
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
      for (int i = 0; i < kPartRows; ++i) {
        const int row = kPartRows * p + i, u = kUnits * q + k;
        w[k][c][i] = u < H && row < H ? rh[static_cast<size_t>(row) * G + c * H + u] : 0.0f;
      }
  for (int i = threadIdx.x; i < kHWords; i += blockDim.x) {
    hbuf[0][i] = 0.0f;
    hbuf[1][i] = 0.0f;
    rbuf[i] = 0.0f;
  }
  __syncthreads();
  if (writer) hbuf[0][hslot(u_me)] = h0[static_cast<size_t>(b) * H + u_me];
  // a lane needs one gate's sigmoid inputs (z on even lanes, r on odd) and
  // the h gate's: two xproj words a step, prefetched a step ahead
  const int gs = p & 1;
  const float rbs = live ? rb[gs * H + u_me] : 0.0f;
  const float rbh = live ? rb[2 * H + u_me] : 0.0f;
  const float* xp = xproj + static_cast<size_t>(b) * G + u_me;  // step t's row
  const size_t x_step = static_cast<size_t>(B) * G;
  float xs_next = live ? xp[gs * H] : 0.0f;
  float xh_next = live ? xp[2 * H] : 0.0f;
  float* hp = hs + static_cast<size_t>(b) * H + u_me;
  const size_t h_step = static_cast<size_t>(B) * H;
  __syncthreads();

  const int my = hslot(live ? u_me : 0);
  const int lead = threadIdx.x & 31 & ~(kParts - 1);
  for (int t = 0; t < S; ++t) {
    const float xs = xs_next, xh = xh_next;
    if (t + 1 < S && live) {
      xp += x_step;
      xs_next = __ldg(xp + gs * H);
      xh_next = __ldg(xp + 2 * H);
    }
    const float* hc = hbuf[t & 1];
    float* hn = hbuf[(t + 1) & 1];
    const float hold = hc[my];
    float d[kUnits][3];
    if constexpr (LBR)
      part_dot<3>(w, hc + kPartPitch * p, d, 0);
    else
      part_dot<2>(w, hc + kPartPitch * p, d, 0);
    float dz[kUnits], dr[kUnits];
#pragma unroll
    for (int k = 0; k < kUnits; ++k) {
      dz[k] = d[k][0];
      dr[k] = d[k][1];
    }
    // every lane of a unit holds d; the z and r sigmoids of the thread's
    // units run in one stream, and each lane reads its unit's back
    const float sg = sigmoid_acc(xs + ((gs ? pick(dr, k_me) : pick(dz, k_me)) + rbs));
    const float z = __shfl_sync(0xffffffffu, sg, lead + 2 * k_me);
    const float r = __shfl_sync(0xffffffffu, sg, lead + 2 * k_me + 1);
    float h;
    if constexpr (LBR) {
      float dh[kUnits];
#pragma unroll
      for (int k = 0; k < kUnits; ++k) dh[k] = d[k][2];
      h = gru_out(z, tanhf(xh + r * (pick(dh, k_me) + rbh)), hold);
    } else {
      if (writer) rbuf[my] = r * hold;
      __syncthreads();
      part_dot<1>(w, rbuf + kPartPitch * p, d, 2);
      float dh[kUnits];
#pragma unroll
      for (int k = 0; k < kUnits; ++k) dh[k] = d[k][2];
      h = gru_out(z, tanhf((xh + pick(dh, k_me)) + rbh), hold);
    }
    if (writer) {
      hn[my] = h;
      *hp = h;
    }
    hp += h_step;
    __syncthreads();
  }
  if (writer) hf[static_cast<size_t>(b) * H + u_me] = hbuf[S & 1][my];
}

template <bool LBR>
int launch_reg(const float* xproj, const float* rh, const float* rb, const float* h0,
               float* hs, float* hf, int S, int B, int H, cudaStream_t stream) {
  const int threads = (kParts * ((H + kUnits - 1) / kUnits) + 31) / 32 * 32;
  gru_seq_reg<LBR><<<B, threads, 0, stream>>>(xproj, rh, rb, h0, hs, hf, S, B, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* lele_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// hs [S, B, H] and hf [B, H] f32 from xproj [S, B, 3H], rh [H, 3H], rb [3H]
// and h0 [B, H] f32, all contiguous on the card; lbr: linear_before_reset.
// One block (the register form) per batch row up to H = 128, one cluster
// of 8 blocks above.
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
  return lbr ? launch_reg<true>(x, w, bias, h, ys, yf, S, B, H, s)
             : launch_reg<false>(x, w, bias, h, ys, yf, S, B, H, s);
}
