// w8a16 GEMM on Hopper's warpgroup MMA (kernel 2's bf16 form):
// y[M,N] f32 = (x[M,K] bf16 @ int8 W[K,N]) * scale[N], any M, K, N >= 1.
// Replaces lele_tpu/kernels/quant_matmul.py:w8_matmul_pallas for bf16 x
// (the f32 form, true f32 FMA, is w8_gemm.cuh's w8_gemm_f32).
//
// What bounds it on the H100: at its paths' shapes (M = 171 to 1,512 rows,
// K = 512 or 2,048, N = 512 to 25,055) the bytes: the int8 weight read
// once, x read once, the f32 output written once (the CTC head's output,
// 17-152 MB, is the larger stream), 0.2-50 us at 3.35 TB/s; the bf16
// tensor-core work is a tenth of that or less. The parent form waited out
// one load latency every 64-deep K step on 4-warp blocks (10-36 us a layer
// linear, 3-5x torch.matmul). The design computes y^T = W^T x^T, so the
// narrow type is the operand that lives in registers:
//  - a block is one producer warp and two consumer warpgroups: 128 output
//    channels (columns of W) by MX rows of x (MX = 64 to 256, a multiple of
//    8: wgmma's N, so 171 rows are one block of 176 and each weight strip is
//    read once). The producer keeps a ring of ST K tiles of 64 in flight on
//    mbarriers, both by TMA: x's [MX x 64] box with the 128-byte swizzle
//    (wgmma's K-major B operand as it lands) and the int8 weight's [64 x
//    128] box with the 128-byte swizzle (so the fragment loads below are
//    free of bank conflicts). TMA needs rows 16-byte aligned: the wrapper
//    pads any others (kernels/quant_matmul.py:align_rows; the model keeps
//    its CTC head's 25,055 columns in rows of 25,056 bytes,
//    models/sensevoice.py), and zeros past K and N come from the boxes'
//    out-of-bounds fill.
//  - each consumer warp takes 16 channels: one ldmatrix.x4.trans of the
//    int8 tile (read as 16-bit pairs of channels) gives each thread the
//    bytes of two k pairs of two channels a word, which widen exactly
//    (|q| <= 127) to the bf16 pairs of wgmma's A fragment. So no byte is
//    transposed and nothing is written back to shared memory: the warp's
//    16 A rows are its channels in the order 0, 2, .., 14, 1, 3, .., 15,
//    undone when the output tile is staged. Then
//    `wgmma.mma_async.m64nMXk16.f32.bf16.bf16` (A from registers, B by
//    descriptor), f32 sums; once `wgmma.wait_group` says a tile's products
//    are done, its stage goes back to the producer (the other warpgroup's
//    fragments are widened while these products run).
//  - where the output tiles are too few for the 132 SMs, a cluster of S
//    blocks splits K; the raw f32 tiles are staged in shared memory and
//    summed through distributed shared memory in rank order (the same bits
//    on every call and in a graph replay), then scaled (`__fmul_rn`) and
//    stored by whole row segments, 16 bytes a lane: y's rows are 16-byte
//    aligned (the wrapper pads a row of N % 4 != 0 floats, as the CTC
//    head's 25,055, and returns the [M, N] view).
//  - a programmatic dependent launch: the block's prologue (barriers,
//    tensor maps) overlaps the kernel ahead in the stream, and nothing is
//    read before griddepcontrol.wait.
//  - (MX, S) come from the shape alone (w8_config).
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>

#include "dq_gemm.cuh"

namespace lele {


__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// a wgmma shared-memory descriptor with the 128-byte swizzle: start address,
// leading and stride byte offsets (16-byte units)
__device__ __forceinline__ uint64_t wgmma_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) >> 4) & 0x3FFF) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void named_bar(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// wgmma m64nNk16, D f32 += A x B: A (bf16 pairs) from registers, B K-major
// by descriptor; the predicate keeps the sums
__device__ __forceinline__ void wgmma_rs_m64n64k16(float (&d)[32], const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_m64n128k16(float (&d)[64], const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_m64n176k16(float (&d)[88], const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %93, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n176k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87"
      "}, {%88, %89, %90, %91}, %92, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_m64n256k16(float (&d)[128], const uint32_t (&a)[4],
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int MX>
__device__ __forceinline__ void wgmma_rs(float (&d)[MX / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (MX == 64)
    wgmma_rs_m64n64k16(d, a, db);
  else if constexpr (MX == 128)
    wgmma_rs_m64n128k16(d, a, db);
  else if constexpr (MX == 176)
    wgmma_rs_m64n176k16(d, a, db);
  else
    wgmma_rs_m64n256k16(d, a, db);
}

// four 8 x 8 matrices of 16-bit elements, transposed: lanes 8 i .. 8 i + 7
// give the rows of matrix i; thread (g, t) gets rows 2 t and 2 t + 1 of
// column g of each
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(row));
}

// a word [W[k][c], W[k][c + 1], W[k + 1][c], W[k + 1][c + 1]] (int8) -> the
// bf16 k pairs of channel c (lo) and c + 1 (hi), exactly: 2^23 + (q + 128)
// as an f32's bits, minus 2^23 + 128
__device__ __forceinline__ void i8_pairs_bf16(uint32_t q, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = q ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 | i)) - 8388736.f;
  const __nv_bfloat162 a = __floats2bfloat162_rn(f[0], f[2]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(f[1], f[3]);
  lo = *reinterpret_cast<const uint32_t*>(&a);
  hi = *reinterpret_cast<const uint32_t*>(&b);
}

// A block's tile: BN = 128 channels by MX rows of x. Shared memory: the
// ring's x tiles [ST][MX][128 B] and int8 weight tiles [ST][64][128 B], and
// after the loop the raw f32 output tile [MX][CS_LD] in their place.
template <int MX>
struct W8Tile {
  static constexpr int BN = 128;
  static constexpr int THREADS = 2 * 128 + 32;
  static constexpr int X_BYTES = MX * 128;
  static constexpr int W8_BYTES = 64 * BN;
  static constexpr int CS_LD = BN + 4;
  // the ring's depth: ~100 KB for the small tiles (two blocks an SM),
  // ~200 KB for the others
  static constexpr int ST_FIT = (MX * BN <= 8192 ? 100000 : 200000) / (X_BYTES + W8_BYTES);
  static constexpr int ST = ST_FIT > 8 ? 8 : ST_FIT;
  static constexpr int RING = ST * (X_BYTES + W8_BYTES);
  static constexpr int BODY = RING > MX * CS_LD * 4 ? RING : MX * CS_LD * 4;
  static constexpr int SMEM = 1024 + BODY + 2 * ST * 8;
  static_assert(ST >= 2 && X_BYTES % 1024 == 0 && W8_BYTES % 1024 == 0,
                "the ring holds two stages; TMA boxes stay on their swizzle's period");
};

// byte offset of 16-byte chunk `chunk` of row r in a weight tile (rows of
// 128 bytes, the 128-byte swizzle)
__device__ __forceinline__ int w_off(int r, int chunk) {
  return r * 128 + ((chunk ^ (r & 7)) << 4);
}

// Grid: (channel tiles * S, row tiles); clusters of S along x split K, rank
// r walking K tiles [r T / S, (r + 1) T / S) of T. tx, tw: the TMA maps of
// x [M, K] bf16 and the weight [K, N] int8.
template <int MX>
__global__ void __launch_bounds__(W8Tile<MX>::THREADS, 1)
w8_wgmma(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
         const float* __restrict__ scale, float* __restrict__ y, int M, int K, int N, int ldy,
         int S) {
  using T = W8Tile<MX>;
  constexpr int BN = T::BN, ST = T::ST;
  extern __shared__ __align__(16) uint8_t w8_smem[];
  uint8_t* base = w8_smem + ((1024 - (smem_u32(w8_smem) & 1023)) & 1023);
  uint8_t* Xs = base;
  uint8_t* W8 = Xs + ST * T::X_BYTES;
  float* Cs = reinterpret_cast<float*>(base);
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + T::BODY);  // full[ST], empty[ST]
  auto full = [&](int s) { return smem_u32(bars + s); };
  auto empty = [&](int s) { return smem_u32(bars + ST + s); };
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rank = blockIdx.x % S, n0 = (blockIdx.x / S) * BN, m0 = blockIdx.y * MX;
  const int ktiles = (K + 63) / 64;
  const int kt0 = rank * ktiles / S, kt1 = (rank + 1) * ktiles / S;

  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // a programmatic dependent launch: the prologue above overlapped the
  // kernel ahead; nothing is read or written before it has finished, and
  // the kernel after this one may start its own prologue now
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");

  if (warp == 8) {
    // the producer: stage s of tile i is refilled once its last products
    // (tile i - ST) are done
    if (lane == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(&tx) : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(&tw) : "memory");
    }
    for (int kt = kt0; kt < kt1; ++kt) {
      const int i = kt - kt0, s = i % ST, k0 = kt * 64;
      if (i >= ST) mbar_wait(empty(s), ((i / ST) & 1) ^ 1);
      if (lane == 0) {
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(full(s)),
                     "r"(T::X_BYTES + T::W8_BYTES)
                     : "memory");
        tma_load_2d(Xs + s * T::X_BYTES, &tx, k0, m0, full(s));
        tma_load_2d(W8 + s * T::W8_BYTES, &tw, n0, k0, full(s));
      }
    }
  } else {
    // the consumers: warp (g, w4) of warpgroup g takes channels c0 .. c0 + 15
    const int g = warp >> 2, c0 = 64 * g + 16 * (warp & 3);
    const int gq = lane >> 2, tq = lane & 3;
    float acc[MX / 2];
#pragma unroll
    for (int e = 0; e < MX / 2; ++e) acc[e] = 0.f;
    // the A fragments of one K tile: k16 step kk's a[kk][0..3] = rows (g, g +
    // 8) x k pairs (2t, 2t + 8), rows g and g + 8 being channels c0 + 2g and
    // c0 + 2g + 1
    auto fragments = [&](const uint8_t* ws, uint32_t (&a)[4][4]) {
      uint32_t q[8];  // k16 step kk: q[2 kk] k pair 2t, q[2 kk + 1] k pair 2t + 8
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // rows 32 h + lane, chunk c0 / 16
        uint32_t r4[4];
        ldsm_x4_trans(r4, smem_u32(ws + w_off(32 * h + lane, c0 >> 4)));
#pragma unroll
        for (int e = 0; e < 4; ++e) q[4 * h + e] = r4[e];
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        i8_pairs_bf16(q[2 * kk], a[kk][0], a[kk][1]);
        i8_pairs_bf16(q[2 * kk + 1], a[kk][2], a[kk][3]);
      }
    };
    // tile i: its fragments, its products, and its stage back to the
    // producer once they are done (the next tile's fragments are not written
    // while products are in flight: ptxas would serialize every wgmma)
    for (int kt = kt0; kt < kt1; ++kt) {
      const int i = kt - kt0, s = i % ST;
      mbar_wait(full(s), (i / ST) & 1);
      uint32_t a[4][4];
      fragments(W8 + s * T::W8_BYTES, a);
      wgmma_fence();
      const uint64_t db = wgmma_desc(Xs + s * T::X_BYTES, 16, 1024);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs<MX>(acc, a[kk], db + 2 * kk);
      wgmma_commit();
      wgmma_wait<0>();
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(s));
    }
    fence_regs(acc);
    named_bar(1, 256);  // every product is done: the ring is free for the output tile
    // thread (gq, tq) holds channels c0 + 2 gq (d[4j], d[4j + 1]) and c0 + 2 gq
    // + 1 (d[4j + 2], d[4j + 3]) at rows 8 j + 2 tq and 8 j + 2 tq + 1
#pragma unroll
    for (int j = 0; j < MX / 8; ++j) {
      float* row = Cs + (8 * j + 2 * tq) * T::CS_LD + c0 + 2 * gq;
      *reinterpret_cast<float2*>(row) = make_float2(acc[4 * j], acc[4 * j + 2]);
      *reinterpret_cast<float2*>(row + T::CS_LD) = make_float2(acc[4 * j + 1], acc[4 * j + 3]);
    }
  }
  namespace cg = cooperative_groups;
  if (S > 1) cg::this_cluster().sync();
  else __syncthreads();

  // the epilogue: every warp stores whole row segments, 16 bytes a lane
  // (y's rows are 16-byte aligned: the last group of a row may run past N
  // into its padding), summing the ranks' tiles in rank order (rank r
  // stores rows r, r + S, ...); a lane keeps its columns' scales, and RU
  // rows' loads are in flight at once
  constexpr int NW = 9, RU = 4, G = (BN / 4 + 31) / 32;  // G: a lane's groups
  const int rows = min(MX, M - m0);
  float4 sc[G];
#pragma unroll
  for (int q = 0; q < G; ++q) {  // zeros past N
    const int c = 4 * (lane + 32 * q), n = n0 + c;
    const bool in = c < BN;
    sc[q] = make_float4(in && n < N ? scale[n] : 0.f, in && n + 1 < N ? scale[n + 1] : 0.f,
                        in && n + 2 < N ? scale[n + 2] : 0.f, in && n + 3 < N ? scale[n + 3] : 0.f);
  }
  for (int r0 = rank + S * warp; r0 < rows; r0 += S * NW * RU) {
    float4 v[RU][G];
#pragma unroll
    for (int u = 0; u < RU; ++u)
#pragma unroll
      for (int q = 0; q < G; ++q) {
        const int r = r0 + u * S * NW, c = 4 * (lane + 32 * q);
        v[u][q] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (r >= rows || c >= BN || n0 + c >= N) continue;
        const float* src = Cs + r * T::CS_LD + c;
        for (int o = 0; o < S; ++o) {
          const float4 t = *reinterpret_cast<const float4*>(
              S > 1 ? cg::this_cluster().map_shared_rank(src, o) : src);
          v[u][q] = o == 0 ? t : make_float4(v[u][q].x + t.x, v[u][q].y + t.y,
                                             v[u][q].z + t.z, v[u][q].w + t.w);
        }
      }
#pragma unroll
    for (int u = 0; u < RU; ++u)
#pragma unroll
      for (int q = 0; q < G; ++q) {
        const int r = r0 + u * S * NW, c = 4 * (lane + 32 * q);
        if (r >= rows || c >= BN || n0 + c >= N) continue;
        *reinterpret_cast<float4*>(y + (size_t)(m0 + r) * ldy + n0 + c) = make_float4(
            __fmul_rn(v[u][q].x, sc[q].x), __fmul_rn(v[u][q].y, sc[q].y),
            __fmul_rn(v[u][q].z, sc[q].z), __fmul_rn(v[u][q].w, sc[q].w));
      }
  }
  if (S > 1) cg::this_cluster().sync();  // no block leaves while its tile is read
}

template <int MX>
inline cudaError_t launch_w8_wgmma_t(const __nv_bfloat16* x, int ldx, const int8_t* w, int ldw,
                                     const float* scale, float* y, int ldy, int M, int K, int N,
                                     int S, cudaStream_t s) {
  using T = W8Tile<MX>;
  CUtensorMap tx{}, tw{};
  cudaError_t err = tensor_map_2d(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, M, K,
                                  (size_t)ldx * 2, MX, 64, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == cudaSuccess)
    err = tensor_map_2d(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, K, N, ldw, 64, T::BN,
                        CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  auto kernel = w8_wgmma<MX>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((N + T::BN - 1) / T::BN) * S, (M + MX - 1) / MX);
  cfg.blockDim = dim3(T::THREADS);
  cfg.dynamicSmemBytes = T::SMEM;
  cfg.stream = s;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  attr[1].id = cudaLaunchAttributeClusterDimension;
  attr[1].val.clusterDim.x = S;
  attr[1].val.clusterDim.y = 1;
  attr[1].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = S > 1 ? 2 : 1;
  return cudaLaunchKernelEx(&cfg, kernel, tx, tw, scale, y, M, K, N, ldy, S);
}

// one launch: 128 channels by MX rows a block, clusters of S (1, 2 or 4, at
// most the K tiles) splitting K. TMA's rows: x's ldx >= K elements apart, a
// multiple of 8, the weight's ldw >= N bytes apart, a multiple of 16, both
// 16-byte aligned; y's ldy >= N rounded up to 4 floats, y 16-byte aligned.
inline cudaError_t launch_w8_wgmma(const __nv_bfloat16* x, int ldx, const int8_t* w, int ldw,
                                   const float* scale, float* y, int ldy, int M, int K, int N,
                                   int mx, int S, cudaStream_t s) {
  if (S < 1 || S > 4 || (S & (S - 1)) || S > (K + 63) / 64 || ldx < K || ldx % 8 ||
      ldw < N || ldw % 16 || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16 || ldy % 4 || ldy < (N + 3) / 4 * 4 ||
      reinterpret_cast<uintptr_t>(y) % 16)
    return cudaErrorInvalidValue;
  switch (mx) {
    case 64: return launch_w8_wgmma_t<64>(x, ldx, w, ldw, scale, y, ldy, M, K, N, S, s);
    case 128: return launch_w8_wgmma_t<128>(x, ldx, w, ldw, scale, y, ldy, M, K, N, S, s);
    case 176: return launch_w8_wgmma_t<176>(x, ldx, w, ldw, scale, y, ldy, M, K, N, S, s);
    case 256: return launch_w8_wgmma_t<256>(x, ldx, w, ldw, scale, y, ldy, M, K, N, S, s);
    default: return cudaErrorInvalidValue;
  }
}

// The block's rows and K split from the problem's shape, a rule fitted to a
// sweep of every (MX, S) at the paths' shapes (scripts/torch_port_w8_probe.py
// --parts sweep): for S = 1, 2, 4 (4, 2, 1 at K >= 2,048; S at most half
// the K tiles), the most rows a block (256, 176, 128 or 64) whose blocks
// reach 80 (64 with a split) for the 132 SMs; failing
// all, 64 rows at the largest split. Of two row counts that give as many
// blocks, the smaller; no 176-row block with a split (it lost to 128 rows at
// every split shape).
inline void w8_config(int M, int K, int N, int& mx, int& S) {
  const int ktiles = (K + 63) / 64, smax = ktiles >= 16 ? 4 : ktiles >= 4 ? ktiles / 2 : 1;
  const int cols = (N + 127) / 128;
  const int splits[3] = {ktiles >= 32 ? 4 : 1, 2, ktiles >= 32 ? 1 : 4};
  const int rows[4] = {256, 176, 128, 64};
  auto blocks = [&](int r) { return (M + r - 1) / r; };
  for (int s : splits) {
    if (s > smax) continue;
    for (int i = 0; i < 4; ++i) {
      if (i < 3 && blocks(rows[i]) == blocks(rows[i + 1])) continue;  // fewer rows do as well
      if (s > 1 && rows[i] == 176) continue;
      if (blocks(rows[i]) * cols * s >= (s == 1 ? 80 : 64)) {
        mx = rows[i], S = s;
        return;
      }
    }
  }
  mx = 64, S = smax >= 4 ? 4 : smax >= 2 ? 2 : 1;
}

}  // namespace lele
