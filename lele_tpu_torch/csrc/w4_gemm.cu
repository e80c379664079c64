// C entry for the w4a16 GEMM, kernel 7 (see w4_gemm.cuh for the design).
#include "w4_gemm.cuh"

// y[M,N] f32 = x[M,K] @ W, W groupwise int4: packed int8 w [K/2, N] (block
// layout), scales [K/group, N] f32. amode: 0 = f32 x, dequantised in f32 and
// multiplied in full f32; 1 = bf16 x on the tensor cores, in the form bmode
// names: 0 the group-accumulator form (the group a multiple of 8 dividing
// K/2), 1 the dequantised-tile form, B = bf16(q * s). K even, the group from
// 1 to 512 and dividing K. idx: null, or int32 [M] for the expert-indexed
// entry, where w is [E, K/2, N], scales [E, K/group, N] and row r of x runs
// against stack idx[r]. Launches on `stream`; returns cudaGetLastError().
extern "C" int w4_gemm(const void* x, int amode, int bmode, const void* w, const void* scales,
                       const void* idx, void* y, int M, int K, int N, int group,
                       void* stream) {
  if (amode != lele::A_F32 && amode != lele::A_BF16) return static_cast<int>(cudaErrorInvalidValue);
  if (amode == lele::A_F32) bmode = lele::W4_DEQ_BF16;  // any shape: the f32 form
  if ((bmode != lele::W4_GROUP_ACC && bmode != lele::W4_DEQ_BF16) ||
      !lele::w4_shape_ok(K, group, bmode))
    return static_cast<int>(cudaErrorInvalidValue);
  const lele::W4Epilogue ep{nullptr, nullptr, 0};
  const int8_t* wq = static_cast<const int8_t*>(w);
  const float* sc = static_cast<const float*>(scales);
  const int* ix = static_cast<const int*>(idx);
  float* out = static_cast<float*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  if (amode == lele::A_F32)
    lele::launch_w4_gemm_f32(static_cast<const float*>(x), wq, sc, out, M, K, N, group, ep, s,
                             ix);
  else if (bmode == lele::W4_GROUP_ACC)
    lele::launch_w4_gemm_mma<lele::W4_GROUP_ACC>(xb, wq, sc, out, M, K, N, group, ep, s, ix);
  else
    lele::launch_w4_gemm_mma<lele::W4_DEQ_BF16>(xb, wq, sc, out, M, K, N, group, ep, s, ix);
  return static_cast<int>(cudaGetLastError());
}
