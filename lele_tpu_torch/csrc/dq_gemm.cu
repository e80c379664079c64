// C entry for the dynamic-quantized int8 GEMM (kernel 5; design and bounds
// in dq_gemm.cuh). Replaces lele_tpu/kernels/quant_matmul.py:
// fused_dq_matmul_pallas.
#include "dq_gemm.cuh"

// y[M,N] f32 = ((q(x) - 128) @ w - (zp - 128) * colsum) * (a_scale * w_scale),
// q(x) = clamp(rint(x / a_scale) + zp, 0, 255). x f32 [M,K], w int8 [K,N],
// colsum int32 [N]; a_scale and a_zp are f32 scalars on the device; qbuf is
// int8 scratch [M, Kp] for the codes of x, Kp = K rounded up to 16
// (dq_codes_stride). Launches on `stream`; returns cudaGetLastError().
extern "C" int dq_gemm(const void* x, const void* w, const void* colsum,
                       const void* a_scale, const void* a_zp, float w_scale, void* y,
                       void* qbuf, int M, int K, int N, void* stream) {
  const lele::DqlSrc src{static_cast<const float*>(a_scale),
                         static_cast<const float*>(a_zp), nullptr};
  const lele::DqEpilogue ep{static_cast<const int*>(colsum), nullptr, w_scale,
                            nullptr, nullptr, 0, nullptr};
  const cudaError_t err = lele::launch_dq_strip(
      static_cast<const float*>(x), static_cast<int8_t*>(qbuf), static_cast<const int8_t*>(w),
      static_cast<float*>(y), M, K, N, src, ep, static_cast<cudaStream_t>(stream));
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// The same with the weight scale read on the device: ws f32 [N] (the
// per-tensor scale of a dynamic-int8 linear, broadcast by the caller), so no
// linear waits on the host for it. ws[n] takes w_scale's place in the
// epilogue's one product, so the bits are dq_gemm's for the same value.
extern "C" int dq_gemm_ws(const void* x, const void* w, const void* colsum,
                          const void* a_scale, const void* a_zp, const void* ws, void* y,
                          void* qbuf, int M, int K, int N, void* stream) {
  const lele::DqlSrc src{static_cast<const float*>(a_scale),
                         static_cast<const float*>(a_zp), nullptr};
  const lele::DqEpilogue ep{static_cast<const int*>(colsum), static_cast<const float*>(ws),
                            0.f, nullptr, nullptr, 0, nullptr};
  const cudaError_t err = lele::launch_dq_strip(
      static_cast<const float*>(x), static_cast<int8_t*>(qbuf), static_cast<const int8_t*>(w),
      static_cast<float*>(y), M, K, N, src, ep, static_cast<cudaStream_t>(stream));
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}
