// C entry for the w4a16 GEMM, kernel 7: the tile form of w4_gemm.cuh, and
// the decode form of w4_gemv.cuh for few rows (M <= 8 in the group form,
// M <= 4 in the others: w4_decode_rows) and for every launch of the
// expert-indexed entry. The shape and the form alone pick the kernel.
#include "w4_gemv.cuh"

// y[M,N] f32 = x[M,K] @ W, W groupwise int4: packed int8 w [K/2, N] (block
// layout), scales [K/group, N] f32. amode: 0 = f32 x, dequantised in f32 and
// multiplied in full f32; 1 = bf16 x on the tensor cores, in the form bmode
// names: 0 the group-accumulator form (the group a multiple of 8 dividing
// K/2), 1 the dequantised-tile form, B = bf16(q * s). K even, the group from
// 1 to 512 and dividing K. idx: null, or int32 [M] for the expert-indexed
// entry, where w is [E, K/2, N], scales [E, K/group, N] and row r of x runs
// against stack idx[r]. The two forms compute the same numbers up to the f32
// summation order. Launches on `stream`; returns cudaGetLastError().
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
  const bool group_form = amode == lele::A_BF16 && bmode == lele::W4_GROUP_ACC;
  if (ix || M <= lele::w4_decode_rows(group_form)) {
    const cudaError_t err =
        amode == lele::A_F32
            ? lele::launch_w4_gemv(static_cast<const float*>(x), wq, sc, out, M, K, N, group,
                                   bmode, ix, s)
            : lele::launch_w4_gemv(xb, wq, sc, out, M, K, N, group, bmode, ix, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  } else if (amode == lele::A_F32)
    lele::launch_w4_gemm_f32(static_cast<const float*>(x), wq, sc, out, M, K, N, group, ep, s);
  else if (bmode == lele::W4_GROUP_ACC)
    lele::launch_w4_gemm_mma<lele::W4_GROUP_ACC>(xb, wq, sc, out, M, K, N, group, ep, s);
  else
    lele::launch_w4_gemm_mma<lele::W4_DEQ_BF16>(xb, wq, sc, out, M, K, N, group, ep, s);
  return static_cast<int>(cudaGetLastError());
}
