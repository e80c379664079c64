// C entry for the w4a16 GEMM, kernel 7 (see w4_gemm.cuh for the design).
#include "w4_gemm.cuh"

// y[M,N] f32 = x[M,K] @ W, W groupwise int4: packed int8 w [K/2, N] (block
// layout), scales [K/group, N] f32. amode: 0 = f32 x, dequantised in f32 and
// multiplied in full f32; 1 = bf16 x, the group-accumulator form on the
// tensor cores. K/2 and the group must be multiples of 16. Launches on
// `stream`; returns cudaGetLastError().
extern "C" int w4_gemm(const void* x, int amode, const void* w, const void* scales, void* y,
                       int M, int K, int N, int group, void* stream) {
  if (!lele::w4_shape_ok(K, group) || (amode != lele::A_F32 && amode != lele::A_BF16))
    return static_cast<int>(cudaErrorInvalidValue);
  const lele::W4Epilogue ep{nullptr, nullptr, 0};
  const int8_t* wq = static_cast<const int8_t*>(w);
  const float* sc = static_cast<const float*>(scales);
  float* out = static_cast<float*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (amode == lele::A_F32)
    lele::launch_w4_gemm_f32(static_cast<const float*>(x), wq, sc, out, M, K, N, group, ep, s);
  else
    lele::launch_w4_gemm_mma<lele::W4_GROUP_ACC>(static_cast<const __nv_bfloat16*>(x), wq, sc,
                                                 out, M, K, N, group, ep, s);
  return static_cast<int>(cudaGetLastError());
}
