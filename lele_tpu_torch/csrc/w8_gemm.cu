// C entry for the w8a16 GEMM (see w8_gemm.cuh for the design).
#include "w8_gemm.cuh"

// y[M,N] f32 = (x[M,K] @ w[K,N] int8) * scale[N] (+ bias[N]) (ReLU) (+ res[M,N]).
// amode: 0 = f32 x in full f32, 1 = bf16 x, 2 = f32 x rounded to bf16.
// bias and res may be null. Launches on `stream`; returns cudaGetLastError().
extern "C" int w8_gemm(const void* x, int amode, const void* w, const void* scale,
                       const void* bias, const void* res, void* y, int M, int K,
                       int N, int relu, void* stream) {
  const lele::Epilogue ep{static_cast<const float*>(scale),
                          static_cast<const float*>(bias),
                          static_cast<const float*>(res), relu};
  lele::launch_w8_gemm(x, amode, static_cast<const int8_t*>(w), static_cast<float*>(y),
                       M, K, N, ep, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
