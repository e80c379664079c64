// C entry of kernel 2, the w8a16 GEMM: bf16 x on the warpgroup MMA
// (w8_wgmma.cuh, the design), f32 x as true f32 FMA (w8_gemm.cuh).
#include "w8_wgmma.cuh"

// y[M,N] f32 = (x[M,K] @ w[K,N] int8) * scale[N], row-major: x's rows ldx
// >= K elements apart, w's ldw >= N bytes apart, y's ldy floats; scale
// contiguous; amode: 0 = f32 x in full f32 (ldx = K, ldy = N), 1 = bf16 x
// (x and w 16-byte aligned, ldx a multiple of 8 and ldw of 16: the TMA
// loads; y 16-byte aligned, ldy >= N rounded up to 4). M, N, K >= 1. One
// launch on `stream`; returns its error or cudaGetLastError().
extern "C" int w8_gemm(const void* x, int ldx, int amode, const void* w, int ldw,
                       const void* scale, void* y, int ldy, int M, int K, int N, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || ldx < K || ldw < N || ldy < N ||
      (amode == lele::A_F32 && (ldx != K || ldy != N)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* wq = static_cast<const int8_t*>(w);
  const float* sc = static_cast<const float*>(scale);
  if (amode == lele::A_F32) {
    const lele::Epilogue ep{sc, nullptr, nullptr, 0};
    lele::w8_gemm_f32<<<dim3((N + 63) / 64, (M + 63) / 64), 256, 0, s>>>(
        static_cast<const float*>(x), wq, ldw, static_cast<float*>(y), M, K, N, ep);
    return static_cast<int>(cudaGetLastError());
  }
  if (amode != lele::A_BF16) return static_cast<int>(cudaErrorInvalidValue);
  int mx, S;
  lele::w8_config(M, K, N, mx, S);
  const cudaError_t err =
      lele::launch_w8_wgmma(static_cast<const __nv_bfloat16*>(x), ldx, wq, ldw, sc,
                            static_cast<float*>(y), ldy, M, K, N, mx, S, s);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}
