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
// one step on one SM: its FMAs (512 issue cycles on the SM's 128 lanes),
// its shared-memory reads, the cell's chain of transcendentals and one
// barrier. The kernel's time over S is the number to drive down; a short
// call (SileroOnnx: S = 3 a chunk) is its prologue, Wh's 256 KB into one SM.
//
// The register form, H <= 128: one block of 256 threads a batch row, and
// no recurrent weight of a register row read from shared memory in the
// step. Thread (warp w, lane l) takes K-part p = l / 8 of the rows (rows p,
// p + 4, ..., 32 of them) for units u0 = 16 w + l % 8 and u0 + 8, all four
// gate columns of both: 8 columns. The first 24 of its rows (192 weights)
// sit in its registers for the whole run, the last 8 in shared memory as
// float4s (one row's four gates of one unit), thread-major, so a warp reads
// 512 contiguous bytes (64 KB a step for the block, 512 wavefronts). h is
// double-buffered in shared memory, part p's rows together from word 36 p
// (the parts' 16-byte loads fall in distinct banks). The 4 K-parts of a
// unit sit 8 lanes apart and two __shfl_xor_sync rounds sum them; then the
// lanes of parts 2k and 2k + 1 work for unit k: the even one takes i's
// sigmoid and g's tanh, the odd one f's sigmoid and o's as 0.5 + 0.5
// tanh(x / 2) (one tanh each, so the warp does not split), the even one
// reads f and o back by shuffles, updates c and writes h: one block
// barrier a step. A lane's two xproj words of step t+1 are loaded during
// step t. The prologue brings Wh through shared memory in four chunks of
// 32 rows (one bulk copy a row, double-buffered on mbarriers): chunk c
// holds rows 8c .. 8c + 7 of every part, so every thread takes 64 of its
// weights from each, and the staged rows' pitch (520 floats, 8 mod 32)
// keeps those reads free of bank conflicts.
// Chosen over forms with fewer register rows (every row moved to shared
// memory costs its 64 wavefronts a step), over a cluster of 2 blocks a batch
// row with all of Wh in registers and h exchanged through distributed
// shared memory (its cluster barrier every step costs more than the shared
// rows), and over weights loaded straight from global memory into
// registers (a slower prologue); the times are in PERF.md (kernel 6). ptxas:
// 255 registers, a few spilled bytes in the prologue.
//
// Two forms, one C entry. The range is 1 <= H <= 1024, any S >= 1 and
// B >= 1 (the LSTM emitter checks H before it launches):
//  - H <= 128: the register form above (units and rows past H are zeros);
//  - 128 < H <= 1024: the general form of rnn_seq.cuh, a cluster of 8 CTAs
//    a batch row that exchanges h through distributed shared memory, with
//    the LSTM cell written there once (kernel 9 runs the same template with
//    GRU cells). At H = 1024 Wh is 16 MiB in f32, a third of the L2: the
//    rows past each thread's registers stream from L2 every step.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "rnn_seq.cuh"

namespace {

constexpr int kMaxH = 128;
constexpr int kThreads = 256;
constexpr int kUnits = 2;                  // units a thread
constexpr int kParts = 4;                  // K-parts of a unit, 8 lanes apart
constexpr int kLanes = 32 / kParts;        // lanes between the parts of a unit
constexpr int kPartRows = kMaxH / kParts;  // 32 rows of Wh a part
constexpr int kRegRows = 24;               // of them in registers
constexpr int kSmemRows = kPartRows - kRegRows;
constexpr int kHPitch = kPartRows + 4;     // words between parts of h
constexpr int kHWords = kParts * kHPitch;  // words of an h buffer
constexpr int kStageRows = 32;             // rows of Wh a staged chunk
constexpr int kStagePitch = 520;           // floats a staged row: 8 mod 32

using lele_rnn::sigmoid_acc;

// the word of h's row i in an h buffer: part i % 4, word i / 4 of it
__device__ __forceinline__ int hslot(int i) { return (i % kParts) * kHPitch + i / kParts; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

constexpr size_t kSmemBytes =
    static_cast<size_t>(kSmemRows) * kUnits * kThreads * sizeof(float4) +
    2 * kHWords * sizeof(float) + 2 * kStageRows * kStagePitch * sizeof(float);

__global__ void __launch_bounds__(kThreads, 1)
lstm_seq_reg(const float* __restrict__ xproj, const float* __restrict__ wh,
             const float* __restrict__ h0, const float* __restrict__ c0, float* __restrict__ hs,
             float* __restrict__ hf, float* __restrict__ cf, int S, int B, int H) {
  extern __shared__ float4 lstm_smem[];
  __shared__ __align__(8) uint64_t staged[2];                  // a chunk of Wh landed
  float4* sw = lstm_smem;                                     // [kSmemRows][kUnits][kThreads]
  float* hbuf = reinterpret_cast<float*>(sw + kSmemRows * kUnits * kThreads);  // [2][kHWords]
  float* stage = hbuf + 2 * kHWords;                          // [2][kStageRows][kStagePitch]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int p = lane / kLanes;
  const int b = blockIdx.x;
  const int G = 4 * H;
  const int u0 = warp * kUnits * kLanes + lane % kLanes;  // unit k: u0 + 8 k

  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(&staged[0])) : "memory");
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(&staged[1])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // warp 0: chunk c (rows 32c .. 32c + 31 below H, a bulk copy each) into
  // buffer c & 1
  auto issue = [&](int c) {
    const int rows = min(kStageRows, H - kStageRows * c);
    if (warp != 0 || rows <= 0) return;
    const uint32_t bar = smem_addr(&staged[c & 1]);
    float* dst = stage + (c & 1) * kStageRows * kStagePitch;
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    if (lane == 0)
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
                   "r"(rows * G * 4)
                   : "memory");
    __syncwarp();
    if (lane < rows)
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
          "[%3];\n" ::"r"(smem_addr(dst + lane * kStagePitch)),
          "l"(wh + static_cast<size_t>(kStageRows * c + lane) * G), "r"(G * 4), "r"(bar)
          : "memory");
  };
  issue(0);
  issue(1);
  float w[kUnits][4][kRegRows];
#pragma unroll
  for (int c = 0; c < kMaxH / kStageRows; ++c) {
    if (kStageRows * c < H) mbar_wait(smem_addr(&staged[c & 1]), (c >> 1) & 1);
    const float* src = stage + (c & 1) * kStageRows * kStagePitch;
#pragma unroll
    for (int il = 0; il < kStageRows / kParts; ++il) {
      const int i = kStageRows / kParts * c + il, row = kParts * i + p;
#pragma unroll
      for (int k = 0; k < kUnits; ++k) {
        const int u = u0 + kLanes * k;
        float v[4];
#pragma unroll
        for (int g = 0; g < 4; ++g)
          v[g] = u < H && row < H ? src[(kParts * il + p) * kStagePitch + g * H + u] : 0.0f;
        if (i < kRegRows) {
#pragma unroll
          for (int g = 0; g < 4; ++g) w[k][g][i < kRegRows ? i : 0] = v[g];
        } else {
          sw[((i - kRegRows) * kUnits + k) * kThreads + tid] = make_float4(v[0], v[1], v[2], v[3]);
        }
      }
    }
    __syncthreads();  // buffer c & 1 read by all: chunk c + 2 may land there
    if (c + 2 < kMaxH / kStageRows) issue(c + 2);
  }
  for (int i = tid; i < 2 * kHWords; i += kThreads) hbuf[i] = 0.0f;
  __syncthreads();
  for (int i = tid; i < H; i += kThreads) hbuf[hslot(i)] = h0[static_cast<size_t>(b) * H + i];

  // the cell: the lanes of parts 2k and 2k + 1 work for unit k, the even
  // one on gates i and g (it keeps c and writes h), the odd one on f and o
  const int k_me = p >> 1, role = p & 1;
  const int u_me = u0 + kLanes * k_me;
  const bool live = u_me < H;
  const bool writer = live && role == 0;
  const int my = hslot(u_me);
  const float* xp = xproj + static_cast<size_t>(b) * G + u_me;  // step t's row
  const size_t x_step = static_cast<size_t>(B) * G;
  float xa_next = live ? xp[role * H] : 0.0f;        // i or f
  float xb_next = live ? xp[(2 + role) * H] : 0.0f;  // g or o
  float c = writer ? c0[static_cast<size_t>(b) * H + u_me] : 0.0f;
  float h = 0.0f;
  float* hp = hs + static_cast<size_t>(b) * H + u_me;
  const size_t h_step = static_cast<size_t>(B) * H;
  __syncthreads();

  for (int t = 0; t < S; ++t) {
    const float xa = xa_next, xb = xb_next;
    if (live && t + 1 < S) {
      xp += x_step;
      xa_next = __ldg(xp + role * H);
      xb_next = __ldg(xp + (2 + role) * H);
    }
    const float* hc = hbuf + (t & 1) * kHWords + kHPitch * p;
    float acc[kUnits][4];
#pragma unroll
    for (int k = 0; k < kUnits; ++k)
#pragma unroll
      for (int g = 0; g < 4; ++g) acc[k][g] = 0.0f;
#pragma unroll
    for (int i = 0; i < kRegRows; i += 4) {
      const float4 hv = *reinterpret_cast<const float4*>(hc + i);
#pragma unroll
      for (int k = 0; k < kUnits; ++k)
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          acc[k][g] = fmaf(hv.x, w[k][g][i], acc[k][g]);
          acc[k][g] = fmaf(hv.y, w[k][g][i + 1], acc[k][g]);
          acc[k][g] = fmaf(hv.z, w[k][g][i + 2], acc[k][g]);
          acc[k][g] = fmaf(hv.w, w[k][g][i + 3], acc[k][g]);
        }
    }
#pragma unroll
    for (int i = 0; i < kSmemRows; i += 4) {
      const float4 hv = *reinterpret_cast<const float4*>(hc + kRegRows + i);
      const float hr[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int k = 0; k < kUnits; ++k) {
          const float4 wv = sw[((i + r) * kUnits + k) * kThreads + tid];
          acc[k][0] = fmaf(hr[r], wv.x, acc[k][0]);
          acc[k][1] = fmaf(hr[r], wv.y, acc[k][1]);
          acc[k][2] = fmaf(hr[r], wv.z, acc[k][2]);
          acc[k][3] = fmaf(hr[r], wv.w, acc[k][3]);
        }
    }
    // the parts' sums, in every lane of the unit pair
#pragma unroll
    for (int o = kLanes; o < 32; o <<= 1)
#pragma unroll
      for (int k = 0; k < kUnits; ++k)
#pragma unroll
        for (int g = 0; g < 4; ++g) acc[k][g] += __shfl_xor_sync(0xffffffffu, acc[k][g], o);
    float d[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) d[g] = k_me ? acc[1][g] : acc[0][g];
    const float va = sigmoid_acc(xa + (role ? d[1] : d[0]));
    const float yb = xb + (role ? d[3] : d[2]);
    const float tb = tanhf(role ? 0.5f * yb : yb);
    const float vb = role ? fmaf(0.5f, tb, 0.5f) : tb;
    const float f = __shfl_down_sync(0xffffffffu, va, kLanes);
    const float o = __shfl_down_sync(0xffffffffu, vb, kLanes);
    if (writer) {
      c = f * c + va * vb;
      h = o * tanhf(c);
      hbuf[((t + 1) & 1) * kHWords + my] = h;
      *hp = h;
    }
    hp += h_step;
    __syncthreads();
  }
  if (writer) {
    hf[static_cast<size_t>(b) * H + u_me] = h;
    cf[static_cast<size_t>(b) * H + u_me] = c;
  }
}

}  // namespace

extern "C" const char* lele_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// hs [S, B, H], hf and cf [B, H] f32 from xproj [S, B, 4H], wh [H, 4H],
// h0 and c0 [B, H] f32, all contiguous on the card (wh 16-byte aligned).
// One block per batch row up to H = 128, one cluster of 8 blocks above.
// Launches on `stream`; returns cudaGetLastError(), or
// cudaErrorInvalidValue outside the kernel's range (1 <= H <= 1024, S >= 1,
// B >= 1) and cudaErrorMisalignedAddress for an unaligned wh.
extern "C" int lstm_seq(const void* xproj, const void* wh, const void* h0, const void* c0,
                        void* hs, void* hf, void* cf, int S, int B, int H, void* stream) {
  if (H < 1 || H > lele_rnn::kMaxGeneralH || S < 1 || B < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* x = static_cast<const float*>(xproj);
  const auto* w = static_cast<const float*>(wh);
  const auto* h = static_cast<const float*>(h0);
  const auto* c = static_cast<const float*>(c0);
  auto* ys = static_cast<float*>(hs);
  auto* yh = static_cast<float*>(hf);
  auto* yc = static_cast<float*>(cf);
  const auto s = static_cast<cudaStream_t>(stream);
  if (H > kMaxH)
    return lele_rnn::launch_rnn_cluster<lele_rnn::kLstm>(x, w, nullptr, h, c, ys, yh, yc, S, B,
                                                         H, s);
  if (reinterpret_cast<uintptr_t>(wh) % 16) return static_cast<int>(cudaErrorMisalignedAddress);
  cudaError_t err = cudaFuncSetAttribute(lstm_seq_reg, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  lstm_seq_reg<<<B, kThreads, kSmemBytes, s>>>(x, w, h, c, ys, yh, yc, S, B, H);
  return static_cast<int>(cudaGetLastError());
}
