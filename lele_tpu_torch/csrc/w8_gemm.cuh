// Shared pieces of the port's bf16 tensor-core kernels, and kernel 2's f32
// form: y[M,N] = (x[M,K] f32 @ int8 W[K,N]) * scale[N] as true f32 FMA on the
// SIMT cores (JAX's Precision.HIGHEST), 64 x 64 tiles of 256 threads. Kernel
// 2's bf16 form is w8_wgmma.cuh; w8_gemm.cu is kernel 2's C entry.
//
// Replaces, with w8_wgmma.cuh, lele_tpu/kernels/quant_matmul.py:
// w8_matmul_pallas. The helpers (Epilogue, the mma.sync bf16 fragment
// loads and product, bf16_bits) serve sanm_layer.cu, sanm_stack.cu,
// grid_stack.cuh, dq_gemm.cuh, w4_gemm.cuh and est_block.cu.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

extern "C" const char* lele_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

namespace lele {

// how the A operand (x) is read
enum AMode : int {
  A_F32 = 0,   // f32, multiplied in full f32
  A_BF16 = 1,  // bf16
};

struct Epilogue {
  const float* scale;  // [N] per-output-channel dequant scale
  const float* bias;   // [N] or null
  const float* res;    // [M, N] or null; may alias y (read before the write)
  int relu;            // ReLU after bias, before the residual
};

__device__ __forceinline__ float epilogue(float acc, int m, int n, int N,
                                          const Epilogue& ep) {
  float v = acc * ep.scale[n];
  if (ep.bias) v += ep.bias[n];
  if (ep.relu) v = fmaxf(v, 0.f);
  if (ep.res) v = ep.res[(size_t)m * N + n] + v;
  return v;
}

__device__ __forceinline__ uint16_t bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

__device__ __forceinline__ uint32_t ld_pair(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// B fragment of m16n8k16 from a [k][n] tile: lanes 0-15 address rows k..k+15
__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2], const uint16_t* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// f32 path: true f32 FMA, 64 x 64 tile, 256 threads with 4 x 4 outputs each
// (strided by 16 so shared reads and global stores stay coalesced).
__global__ void __launch_bounds__(256)
w8_gemm_f32(const float* __restrict__ x, const int8_t* __restrict__ w, int ldw, float* y,
            int M, int K, int N, Epilogue ep) {
  constexpr int BM = 64, BN = 64, BK = 16;
  __shared__ float As[BK][BM + 4];  // [k][m]
  __shared__ float Bs[BK][BN];      // [k][n]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = tid; i < BM * BK; i += 256) {
      const int r = i / BK, c = i % BK, gm = m0 + r, gk = k0 + c;
      As[c][r] = (gm < M && gk < K) ? x[(size_t)gm * K + gk] : 0.f;
    }
    for (int i = tid; i < BK * BN; i += 256) {
      const int r = i / BN, c = i % BN, gk = k0 + r, gn = n0 + c;
      Bs[r][c] = (gk < K && gn < N) ? static_cast<float>(w[(size_t)gk * ldw + gn]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + ty + 16 * i, n = n0 + tx + 16 * j;
      if (m < M && n < N) y[(size_t)m * N + n] = epilogue(acc[i][j], m, n, N, ep);
    }
}

}  // namespace lele
