// The recurrence cells of kernels 6 (LSTM) and 9 (GRU), written once, and the
// general form of both kernels: the whole recurrence over S steps in one
// launch for H above what one SM holds (128), on a thread-block cluster.
//
// The cells, in the kernels' gate orders (f32, accurate expf/tanhf):
//   LSTM (i, f, g, o), g_x = xproj[t] + h @ Wh:
//     c = sigmoid(f) * c + sigmoid(i) * tanh(g);   h = sigmoid(o) * tanh(c)
//   GRU (z, r, h; ONNX's order), d_x = h @ Rh[:, x] + rb_x:
//     z = sigmoid(x_z + d_z);  r = sigmoid(x_r + d_r)
//     linear_before_reset: hh = tanh(x_h + r * d_h)
//     otherwise:           hh = tanh((x_h + (r * h) @ Rh[:, 2H:]) + rb_h)
//     h = (1 - z) * hh + z * h
// as lele_tpu/kernels/lstm.py:lstm_seq_reference and
// lele_tpu/kernels/gru.py:gru_seq_reference compute them.
//
// The general form. Above H = 128 the recurrent weights no longer fit one SM
// (at H = 256 the LSTM's Wh is 1 MiB, at H = 1024 16 MiB), so one cluster of
// kClusterCtas = 8 CTAs (the portable cluster size) runs one batch row:
//  - CTA q owns the units [q*U, (q+1)*U), U = ceil(H/8), and all NG gate
//    columns of them (NG*U columns), so the cell update of a unit is local;
//  - its 512 threads split the columns' dot products over H into KS parts
//    of R rows (thread: one column, one part). The first 64 rows of a part
//    sit in the thread's registers for the whole run (all of them up to
//    H = 256), the rest in shared memory where the CTA's share fits and
//    otherwise are read from global memory, where they stay L2-resident
//    (H = 1024: 16 MiB of Wh for the LSTM, a third of the L2);
//  - each step the partial sums meet in shared memory, U threads update the
//    units, and each writes its new h into every CTA's copy of h through
//    distributed shared memory (h is double-buffered), then one cluster
//    barrier. The GRU without linear_before_reset needs r * h whole before
//    its second product: a second exchange and barrier a step.
// One launch per direction; no host loop over steps. Clusters of different
// batch rows are independent. What bounds it: each step is a dependent
// chain (one exchange and barrier across 8 SMs), and above H = 256 the
// weight stream from L2 each step; the roofline bound (2*H*NG*H*S flops at
// 67 TFLOP/s) is far below either.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace lele_rnn {

namespace cg = cooperative_groups;

__device__ __forceinline__ float sigmoid_acc(float x) { return 1.0f / (1.0f + expf(-x)); }

enum CellKind : int { kLstm = 0, kGruLbr = 1, kGru = 2 };

template <int KIND>
__host__ __device__ constexpr int n_gates() {
  return KIND == kLstm ? 4 : 3;
}

// the LSTM cell: gate pre-activations i, f, g, o → the new (c, h)
__device__ __forceinline__ float lstm_cell(float gi, float gf, float gg, float go, float& c) {
  c = sigmoid_acc(gf) * c + sigmoid_acc(gi) * tanhf(gg);
  return sigmoid_acc(go) * tanhf(c);
}

// the GRU's last line, from the update gate z and the candidate hh
__device__ __forceinline__ float gru_out(float z, float hh, float h) {
  return (1.0f - z) * hh + z * h;
}

constexpr int kClusterCtas = 8;
constexpr int kClusterThreads = 512;
constexpr int kClusterRegRows = 64;
constexpr int kMaxGeneralH = 1024;
constexpr size_t kSmemBudget = 227 * 1024;

struct ClusterGeom {
  int U;       // units per CTA
  int NCOL;    // gate columns per CTA: NG * U
  int KS;      // parts the dot products are split in
  int R;       // rows per part (a multiple of 4)
  int RR;      // rows per part past the registers
  int HP;      // padded length of the h buffers: KS * R
  int smem_w;  // the RR rows in shared memory (else read from global memory)
  size_t smem_bytes;
};

inline ClusterGeom cluster_geom(int H, int NG) {
  ClusterGeom g{};
  g.U = (H + kClusterCtas - 1) / kClusterCtas;
  g.NCOL = NG * g.U;
  g.KS = kClusterThreads / g.NCOL > 0 ? kClusterThreads / g.NCOL : 1;
  g.R = ((H + g.KS - 1) / g.KS + 3) / 4 * 4;
  g.RR = g.R > kClusterRegRows ? g.R - kClusterRegRows : 0;
  g.HP = g.KS * g.R;
  const size_t base = (static_cast<size_t>(3) * g.HP + static_cast<size_t>(g.KS) * g.NCOL) *
                      sizeof(float);
  const size_t wbytes = static_cast<size_t>(g.KS) * g.RR * g.NCOL * sizeof(float);
  g.smem_w = g.RR > 0 && base + wbytes <= kSmemBudget;
  g.smem_bytes = base + (g.smem_w ? wbytes : 0);
  return g;
}

// xproj [S, B, NG*H], w [H, NG*H] (columns in gate order), rb [NG*H] (GRU;
// null for the LSTM), h0 and c0 [B, H] (c0, cf: LSTM only) → hs [S, B, H],
// hf and cf [B, H]. Grid: kClusterCtas * B CTAs in clusters of kClusterCtas.
template <int KIND>
__global__ void __launch_bounds__(kClusterThreads, 1)
rnn_seq_cluster(const float* __restrict__ xproj, const float* __restrict__ w,
                const float* __restrict__ rb, const float* __restrict__ h0,
                const float* __restrict__ c0, float* __restrict__ hs, float* __restrict__ hf,
                float* __restrict__ cf, int S, int B, int H, ClusterGeom gm) {
  constexpr int NG = n_gates<KIND>();
  constexpr int KR = kClusterRegRows;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / kClusterCtas;
  const int G = NG * H;
  const int U = gm.U, NCOL = gm.NCOL, R = gm.R, RR = gm.RR, HP = gm.HP;
  extern __shared__ float4 smem4[];
  float* hbuf = reinterpret_cast<float*>(smem4);  // [2][HP]: h of steps t, t + 1
  float* rbuf = hbuf + 2 * HP;                     // [HP]: r * h (GRU)
  float* red = rbuf + HP;                          // [KS][NCOL]: partial sums
  float* ws = red + static_cast<size_t>(gm.KS) * NCOL;  // [KS][RR][NCOL]

  const int tid = threadIdx.x;
  const int col = tid % NCOL, part = tid / NCOL;
  const int gate = col / U, unit = rank * U + col % U;
  const bool col_ok = part < gm.KS && unit < H;
  const int gc = gate * H + unit;  // the column of w this thread reads
  const int k0 = part * R;
  const int nreg = R < KR ? R : KR;

  float wr[KR];
#pragma unroll
  for (int i = 0; i < KR; ++i) {
    const int k = k0 + i;
    wr[i] = (col_ok && i < nreg && k < H) ? w[static_cast<size_t>(k) * G + gc] : 0.0f;
  }
  if (gm.smem_w && part < gm.KS)
    for (int i = 0; i < RR; ++i) {
      const int k = k0 + KR + i;
      ws[(static_cast<size_t>(part) * RR + i) * NCOL + col] =
          (col_ok && k < H) ? w[static_cast<size_t>(k) * G + gc] : 0.0f;
    }
  for (int k = tid; k < 3 * HP; k += blockDim.x)
    hbuf[k] = k < H ? h0[static_cast<size_t>(b) * H + k] : 0.0f;

  // the unit this thread updates (threads below U)
  const int my = rank * U + tid;
  const bool unit_thr = tid < U && my < H;
  float c = 0.0f, h = 0.0f, xn[NG], rbv[NG];
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    xn[g] = unit_thr ? xproj[static_cast<size_t>(b) * G + g * H + my] : 0.0f;
    rbv[g] = (unit_thr && rb) ? rb[g * H + my] : 0.0f;
  }
  if (unit_thr && KIND == kLstm) c = c0[static_cast<size_t>(b) * H + my];
  cluster.sync();  // every CTA's buffers are set before the first remote write

  // this thread's part of its column's dot product with v [HP]
  auto dot = [&](const float* v) -> float {
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
    const float4* v4 = reinterpret_cast<const float4*>(v + k0);
#pragma unroll
    for (int q = 0; q < KR / 4; ++q) {
      if (4 * q < nreg) {
        const float4 hv = v4[q];
        a0 = fmaf(hv.x, wr[4 * q], a0);
        a1 = fmaf(hv.y, wr[4 * q + 1], a1);
        a2 = fmaf(hv.z, wr[4 * q + 2], a2);
        a3 = fmaf(hv.w, wr[4 * q + 3], a3);
      }
    }
    if (RR > 0 && gm.smem_w) {
      const float* wp = ws + static_cast<size_t>(part) * RR * NCOL + col;
#pragma unroll 2
      for (int i = 0; i < RR; i += 4) {
        const float4 hv = v4[KR / 4 + i / 4];
        a0 = fmaf(hv.x, wp[static_cast<size_t>(i) * NCOL], a0);
        a1 = fmaf(hv.y, wp[static_cast<size_t>(i + 1) * NCOL], a1);
        a2 = fmaf(hv.z, wp[static_cast<size_t>(i + 2) * NCOL], a2);
        a3 = fmaf(hv.w, wp[static_cast<size_t>(i + 3) * NCOL], a3);
      }
    } else if (RR > 0) {
      const int lim = H - (k0 + KR) < RR ? H - (k0 + KR) : RR;  // rows below H
      const float* wp = w + static_cast<size_t>(k0 + KR) * G + gc;
      const float* vp = v + k0 + KR;
#pragma unroll 4
      for (int i = 0; i < lim; ++i) a0 = fmaf(vp[i], __ldg(wp + static_cast<size_t>(i) * G), a0);
    }
    return (a0 + a1) + (a2 + a3);
  };
  // the sum of the parts of gate g's column for this thread's unit
  auto gsum = [&](int g) -> float {
    float s = 0.0f;
    for (int p = 0; p < gm.KS; ++p) s += red[p * NCOL + g * U + tid];
    return s;
  };
  // write v to element i of buffer `buf` of every CTA in the cluster
  auto broadcast = [&](float* buf, int i, float v) {
#pragma unroll
    for (int q = 0; q < kClusterCtas; ++q) *cluster.map_shared_rank(buf + i, q) = v;
  };

  for (int t = 0; t < S; ++t) {
    const float* hc = hbuf + (t & 1) * HP;
    float* hn = hbuf + ((t + 1) & 1) * HP;
    float xs[NG];
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      xs[g] = xn[g];
      if (unit_thr && t + 1 < S)
        xn[g] = __ldg(xproj + (static_cast<size_t>(t + 1) * B + b) * G + g * H + my);
    }
    if (col_ok && (KIND != kGru || gate < 2)) red[part * NCOL + col] = dot(hc);
    __syncthreads();
    float z = 0.0f;
    if (unit_thr) {
      if constexpr (KIND == kLstm) {
        h = lstm_cell(xs[0] + gsum(0), xs[1] + gsum(1), xs[2] + gsum(2), xs[3] + gsum(3), c);
      } else {
        z = sigmoid_acc(xs[0] + (gsum(0) + rbv[0]));
        const float r = sigmoid_acc(xs[1] + (gsum(1) + rbv[1]));
        if constexpr (KIND == kGruLbr) {
          h = gru_out(z, tanhf(xs[2] + r * (gsum(2) + rbv[2])), hc[my]);
        } else {
          broadcast(rbuf, my, r * hc[my]);
        }
      }
    }
    if constexpr (KIND == kGru) {
      cluster.sync();  // r * h whole in every CTA
      if (col_ok && gate == 2) red[part * NCOL + col] = dot(rbuf);
      __syncthreads();
      if (unit_thr) h = gru_out(z, tanhf((xs[2] + gsum(2)) + rbv[2]), hc[my]);
    }
    if (unit_thr) {
      broadcast(hn, my, h);
      hs[(static_cast<size_t>(t) * B + b) * H + my] = h;
    }
    cluster.sync();  // h of step t + 1 whole in every CTA
  }
  if (unit_thr) {
    hf[static_cast<size_t>(b) * H + my] = h;
    if (KIND == kLstm) cf[static_cast<size_t>(b) * H + my] = c;
  }
}

// Launch the general form on `stream`; returns the launch's error code.
template <int KIND>
inline int launch_rnn_cluster(const float* xproj, const float* w, const float* rb,
                              const float* h0, const float* c0, float* hs, float* hf, float* cf,
                              int S, int B, int H, cudaStream_t stream) {
  const ClusterGeom gm = cluster_geom(H, n_gates<KIND>());
  auto kernel = rnn_seq_cluster<KIND>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(gm.smem_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kClusterCtas * B);
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = gm.smem_bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kClusterCtas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, xproj, w, rb, h0, c0, hs, hf, cf, S, B, H, gm);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace lele_rnn
