// Kernel 12: flash attention in f32. Replaces the library TPU flash-attention
// kernel that lele_tpu/ops/attention_ops.py:34 (_flash_attention_maybe)
// routes an eligible ONNX Attention node to; its plain version here is
// kernels/flash_attention.py:flash_attention_plain.
//
// What it computes. For q [B, H, Lq, D], k and v [B, KVH, Lk, D] (f32,
// contiguous), an optional additive bias read through broadcast strides
// (sb, sh, si, sj: 0 on a broadcast axis), and kv head h / (H / KVH) for
// query head h (GQA without the repeat):
//   s   = (q . k^T) * scale + bias          (the bias after scaling)
//   s   = -inf above the diagonal where causal (Lq == Lk, top-left)
//   out = softmax(s) . v                    [B, H, Lq, D] f32
// A bool mask arrives as a 0 / -1e9 bias (the wrapper), so a row whose keys
// are all masked gives the uniform average of v, as on both JAX routes.
//
// What bounds it on an H100: operations, on the pairs whose term can be
// non-zero. The products run as 3xTF32 on the tensor cores: 3 TF32
// products a multiply-add (a.b ~ a_hi.b_hi + a_hi.b_lo + a_lo.b_hi, f32
// sums) at 495 TFLOP/s, 4 * D operations a (query, key) pair. At the
// Phi-3 prefill from slot 0 (B 1, H 32, Lq 1,920 over a 4,096-slot cache,
// the graph's 0 / -1e9 mask) 24% of the 64 x 64 tiles carry a live term.
//
// Design, for D <= 256 (flash_attn_tf32):
//  - Exact skipping of masked key tiles. A prepass (two small kernels of
//    this file, launched by the same C entry, a block a tile) reads the
//    bias once per mask head (not per query head: the mask broadcasts over
//    heads) and writes, per (64-row q tile, 64-key tile), the tile's largest
//    bias tmax, and per row its largest bias over the keys causal leaves
//    (an atomicMax on order-preserving bits); it also writes each key
//    tile's largest k-row norm. The main kernel takes rowmin, the least of
//    its q tile's row maxima, and its q tile's largest row norm qn.
//    A row's final maximum is at least its largest bias (at some key j*)
//    plus scale q.k_j*, so >= rowmin - |scale| qn K_all (K_all: the largest
//    k-row norm of the kv head), and every score of the key tile is
//    <= tmax + |scale| qn K_tile. With S2 = |scale| qn (K_tile + K_all),
//    where
//        tmax + S2 + 105 + 1e-6 (|tmax| + |rowmin| + S2) < rowmin
//    every term of the tile is below e^-104 of the row's largest, which
//    expf rounds to exactly 0 in f32 (e^-104 is below half the smallest
//    subnormal), whatever the final maximum. The relative slack covers the
//    f32 rounding of the scores and of the maximum; every operation of the
//    test rounds toward not skipping (__fadd_ru, __fmul_ru), and the norms
//    are taken 0.1% high. A -inf tmax skips; a fully masked row (every bias
//    -1e9) makes rowmin -1e9, so its q tile skips nothing and keeps the
//    plain version's uniform average. kernels/flash_attention.py:
//    skippable_tiles is the same test in plain PyTorch (float64).
//  - One CTA of 8 warps per (64-row q tile, head, batch row), heaviest q
//    tiles first (causal and prefill masks load the last tiles most). The q
//    tile is loaded once into shared memory and stays there for the whole
//    key loop; K and V tiles stream through a ring of STAGES cp.async
//    stages (3 for D <= 96, 2 for D <= 128, 1 above), so the next tiles'
//    loads overlap this tile's products. A shared-memory pitch of D + 4
//    words makes every fragment load below free of bank conflicts.
//  - Products on mma.sync.m16n8k8 TF32 (the flash-attention-2 structure):
//    warp w owns query rows 16 (w % 4) .. + 15 and keys 32 (w / 4) .. + 31
//    of every key tile, with its own running max, sum and accumulators; the
//    two key halves of a row merge once at the end through shared memory.
//    Two warps a row group, not one: with one CTA an SM (shared memory), 4
//    warps left every latency exposed (a build with 4 warps, not kept, took
//    1,036 us at the causal shape below against 657 with 8, before the
//    unrolling; chip_smoke.graph_us). S = q k^T in k-steps of 8 over D (unrolled where D is
//    64, 96 or 128); each operand split as hi = cvt.rna.tf32(x), lo =
//    cvt.rna.tf32(x - hi), and three MMAs (lo.hi, hi.lo, hi.hi). The online
//    softmax stays in registers (the row's max reduced over its 4 lanes; the
//    sum kept per lane and reduced once at the end); accurate expf. P . V
//    takes P straight from S's accumulator layout: a thread holds keys 2t
//    and 2t+1 of each 8, so the k index of the MMA is permuted (k = t ->
//    key 2t, k = t + 4 -> key 2t + 1) on both operands, and P never goes
//    through shared memory.
//  - Rounding. The tensor cores add into their accumulator with truncation,
//    so a long chain of MMAs into one register drifts: a build (not kept)
//    accumulating P . V over a whole row of keys read 1.1e-5 max|ref|
//    against the plain version at GQA 32/8, Lq 512, Lk 1,024 with a bool
//    mask (FLASH_REL is 1e-5). So each pair of k-steps of S, and each key tile of P . V (4 n8
//    tiles at a time), goes into fresh accumulators that are then added in
//    f32 (round to nearest): every case of chip_smoke.FLASH_SHAPES then
//    lands within 2e-6 max|ref| of the plain version and within 1e-6 of the
//    f64 oracle. One TF32 product would land near 3e-4 (the CPU emulation
//    in tests/test_torch_port_flash.py).
//  - The bias of a visited tile is read from device memory in the
//    accumulator's layout before the products, so its latency hides under
//    them. Causal: key tiles past the diagonal are not visited; the
//    diagonal tile masks key > row.
//  - D <= 128 in one pass (accumulators of 8 * NT columns); 128 < D <= 256
//    in passes of 128 output columns, each pass visiting the key tiles again.
// For D > 256 the q tile and a key tile no longer fit in shared memory
// together, so flash_attn_ffma takes those: f32 FFMA on the CUDA cores with
// the q tile re-staged in 32-wide d-chunks for every key tile, and the same
// tile skipping.
// The range: Lq, Lk multiples of 64, D % 8 == 0, H % KVH == 0, any B and H
// (the gate in kernels/flash_attention.py asks multiples of 128, as JAX's).
// Each CTA writes how many key tiles it visited into the workspace, for the
// caller to read (chip_smoke.py checks it against the plain skip test).
// Measured (NVIDIA H100 80GB HBM3, 700 W, 20 calls in a CUDA graph;
// scripts/torch_port_kernel_ab.py against flash_attn_ffma's design at every
// D, and chip_smoke.py): the Phi-3 prefill (B 1, H 32, Lq 1,920, Lk 4,096,
// D 96, its mask; 14,880 of 61,440 tiles visited) 842 us, of which the
// prepass ~65, against the FFMA form's 4,227 and SDPA's (f32, TF32 off)
// 3,281; the TPU script's causal shape (B 2, H 8, L 2,048, D 128) 464 us,
// the FFMA form 1,053, SDPA 514. What holds it at 16-22% of its bound (137
// and 104 us): two warps a scheduler, and about five instructions of
// splitting, loading and folding beside each MMA.

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kBQ = 64;  // query rows a CTA
constexpr int kBK = 64;  // keys a tile

// where a CTA finds its tile statistics (null pointers where there is no bias)
struct TileStats {
  const float* knorm;     // [B][KVH][nk]: a key tile's largest k-row norm
  const float* tmax;      // [nBb][nHb][nq][nk]: a tile's largest bias
  const unsigned* rowmax;  // [nBb][nHb][Lq]: a row's largest bias (over the keys
                           // causal leaves), as ordered_bits
  int* visits;            // [B][H][nq]: key tiles a CTA visited
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// f32 <-> unsigned bits whose unsigned order is the floats' order, so that
// atomicMax takes a float maximum; 0 lies below every float
__device__ __forceinline__ unsigned ordered_bits(float x) {
  const unsigned b = __float_as_uint(x);
  return b & 0x80000000u ? ~b : b | 0x80000000u;
}
__device__ __forceinline__ float from_ordered(unsigned e) {
  return __uint_as_float(e & 0x80000000u ? e & 0x7fffffffu : ~e);
}

// The block's maximum (min = false) or minimum of x; red holds blockDim / 32
// floats. Every thread gets the result.
__device__ float block_reduce(float x, bool min, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float y = __shfl_xor_sync(0xffffffffu, x, o);
    x = min ? fminf(x, y) : fmaxf(x, y);
  }
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  x = red[0];
  for (int i = 1; i < static_cast<int>(blockDim.x >> 5); ++i)
    x = min ? fminf(x, red[i]) : fmaxf(x, red[i]);
  __syncthreads();  // red may be reused
  return x;
}

// The largest row norm of a 64-row tile (rows `pitch` floats apart, D
// columns): a warp a row at a time, its lanes on neighbouring columns.
__device__ float tile_norm_max(const float* base, int pitch, int D, float* red) {
  const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  float mx = 0.0f;
  for (int row = threadIdx.x >> 5; row < kBQ; row += warps) {
    float ss = 0.0f;
    for (int c = lane; c < D; c += 32) {
      const float x = base[static_cast<size_t>(row) * pitch + c];
      ss = fmaf(x, x, ss);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    mx = fmaxf(mx, sqrtf(ss));
  }
  return block_reduce(mx, false, red);
}

// The exact skip test of the source note, rounded toward not skipping.
__device__ __forceinline__ bool tile_dead(float tmax, float rowmin, float s2) {
  const float tm = fmaxf(tmax, -1e30f);  // -inf stays far below any finite row max
  float lhs = __fadd_ru(__fadd_ru(tm, s2), 105.0f);
  const float slack = __fmul_ru(1e-6f, __fadd_ru(__fadd_ru(fabsf(tm), fabsf(rowmin)), s2));
  lhs = __fadd_ru(lhs, slack);
  return lhs < rowmin;
}

// Walks the key tiles of one q tile in order, past the dead ones.
struct Skipper {
  bool on;
  float rowmin, sq, kall;  // S2 = sq (knorm[kt] + kall), 0.1% high
  const float* tmax;
  const float* knorm;

  __device__ int next(int kt, int end) const {
    if (on)
      while (kt < end &&
             tile_dead(tmax[kt], rowmin, __fmul_ru(sq, __fadd_ru(knorm[kt], kall))))
        ++kt;
    return kt;
  }
};

// Sets up the walk of q tile qt of (b, h) from its q tile's norm qn; every
// thread of the block calls it (a block reduction over the tile's rows).
__device__ Skipper make_skipper(const TileStats& st, bool has_bias, float qn, float scale,
                                long long sb, long long sh, int b, int h, int kvh, int H,
                                int KVH, int Lq, int nk, int qt, float* red) {
  Skipper sk{false, 0.0f, 0.0f, 0.0f, nullptr, nullptr};
  if (!has_bias || st.tmax == nullptr) return sk;
  const int nhb = sh ? H : 1;
  const size_t head = static_cast<size_t>(sb ? b : 0) * nhb + (sh ? h : 0);
  const float r = threadIdx.x < kBQ ? from_ordered(st.rowmax[head * Lq + qt * kBQ + threadIdx.x])
                                    : INFINITY;
  sk.on = true;
  sk.rowmin = block_reduce(r, true, red);
  sk.tmax = st.tmax + (head * (Lq / kBQ) + qt) * nk;
  sk.knorm = st.knorm + (static_cast<size_t>(b) * KVH + kvh) * nk;
  sk.sq = __fmul_ru(__fmul_ru(1.001f, fabsf(scale)), qn);
  for (int kt = 0; kt < nk; ++kt) sk.kall = fmaxf(sk.kall, sk.knorm[kt]);
  return sk;
}

constexpr int kStatThreads = 256;

// Prepass 1: knorm of every key tile. Grid (nk, KVH, B).
__global__ void __launch_bounds__(kStatThreads)
flash_kstats(const float* __restrict__ k, float* __restrict__ knorm, int Lk, int D) {
  __shared__ float red[kStatThreads / 32];
  const int nk = Lk / kBK;
  const size_t head = static_cast<size_t>(blockIdx.z) * gridDim.y + blockIdx.y;
  const float n = tile_norm_max(k + (head * Lk + static_cast<size_t>(blockIdx.x) * kBK) * D, D,
                                D, red);
  if (threadIdx.x == 0) knorm[head * nk + blockIdx.x] = n;
}

// Prepass 2: per mask head, each (q tile, key tile)'s largest bias, and
// each row's largest bias over the keys causal leaves (an atomicMax a row
// group of the tile into rowmax, which starts at 0). Grid (nk, nq, nBb *
// nHb): thread t reads column t % 64 of rows t / 64, t / 64 + 4, ...
// (coalesced where sj == 1). Causal skips the tiles past the diagonal.
__global__ void __launch_bounds__(kStatThreads)
flash_bstats(const float* __restrict__ bias, long long sb, long long sh, long long si,
             long long sj, float* __restrict__ tmax, unsigned* __restrict__ rowmax, int Lq,
             int Lk, int nhb, int causal) {
  __shared__ float red[kStatThreads / 32];
  const int kt = blockIdx.x, qt = blockIdx.y;
  if (causal && kt > qt) return;
  const int nk = Lk / kBK, nq = Lq / kBQ;
  const int c = threadIdx.x & 63, rg = threadIdx.x >> 6, lane = threadIdx.x & 31;
  const int hb = blockIdx.z % nhb, bb = blockIdx.z / nhb;
  const float* bp = bias + bb * sb + hb * sh;
  const int q0 = qt * kBQ, j = kt * kBK + c;
  float cm = -INFINITY;
#pragma unroll
  for (int m = 0; m < 16; ++m) {
    const int i = q0 + rg + 4 * m;
    const float x = __ldg(bp + i * si + j * sj);
    cm = fmaxf(cm, x);
    float r = !causal || j <= i ? x : -INFINITY;
    r = warp_max(r);
    if (lane == 0) atomicMax(rowmax + static_cast<size_t>(blockIdx.z) * Lq + i, ordered_bits(r));
  }
  cm = block_reduce(cm, false, red);
  if (threadIdx.x == 0) tmax[(static_cast<size_t>(blockIdx.z) * nq + qt) * nk + kt] = cm;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// x = hi + lo, both TF32 (round to nearest, ties away)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
}

// c += a . b, m16n8k8 TF32 with f32 accumulators
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a . b in 3xTF32: the two small cross terms first
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], uint32_t bh0, uint32_t bh1,
                                           uint32_t bl0, uint32_t bl1) {
  mma_tf32(c, al, bh0, bh1);
  mma_tf32(c, ah, bl0, bl1);
  mma_tf32(c, ah, bh0, bh1);
}

constexpr int kThreadsTc = 256;  // 8 warps: 4 row groups of 16 x 2 key halves of 32

template <int STAGES>
size_t tc_smem_bytes(int D) {
  return sizeof(float) * static_cast<size_t>(kBQ) * (D + 4) * (1 + 2 * STAGES);
}

// NT: n8 tiles of output columns a pass; DK: D where it is known at compile
// time (the k-step loop then unrolls), 0 for any D
template <int NT, int STAGES, int DK>
__global__ void __launch_bounds__(kThreadsTc, 1)
flash_attn_tf32(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ bias, long long sb,
                long long sh, long long si, long long sj, float* __restrict__ out, int H,
                int KVH, int Lq, int Lk, int D, float scale, int causal, TileStats st) {
  constexpr int DP = 8 * NT;  // output columns a pass
  constexpr int NG = 4;       // n8 tiles a group of fresh P . V accumulators
  constexpr int MW = 4 * NT + 4;  // words a thread hands its partner at a pass's end
  extern __shared__ __align__(16) float smem[];
  __shared__ float red[kThreadsTc / 32];
  if constexpr (DK > 0) D = DK;
  const int P = D + 4;  // pitch of every tile in shared memory
  float* qs = smem;     // [kBQ][P]
  float* kvs = qs + kBQ * P;  // STAGES x ([kBK][P] of k, [kBK][P] of v)

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rw = w & 3;   // rows 16 rw .. 16 rw + 15 of the q tile
  const int kh = w >> 2;  // keys 32 kh .. 32 kh + 31 of every key tile
  const int h = blockIdx.x;
  const int nq = Lq / kBQ, nk = Lk / kBK;
  const int qt = nq - 1 - static_cast<int>(blockIdx.y);  // heaviest q tiles first
  const int b = blockIdx.z;
  const int q0 = qt * kBQ;
  const int kvh = h / (H / KVH);
  const float* qb = q + ((static_cast<size_t>(b) * H + h) * Lq + q0) * D;
  const float* kb = k + (static_cast<size_t>(b) * KVH + kvh) * Lk * D;
  const float* vb = v + (static_cast<size_t>(b) * KVH + kvh) * Lk * D;
  float* ob = out + ((static_cast<size_t>(b) * H + h) * Lq + q0) * D;
  const float* bb = bias != nullptr ? bias + b * sb + h * sh : nullptr;
  const int end = causal ? min(nk, qt + 1) : nk;
  const int d4 = D / 4;

  for (int i = tid; i < kBQ * d4; i += kThreadsTc) {
    const int row = i / d4, c4 = (i - row * d4) * 4;
    cp_async16(qs + row * P + c4, qb + static_cast<size_t>(row) * D + c4);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const float qn = bias != nullptr ? tile_norm_max(qs, P, D, red) : 0.0f;
  const Skipper sk =
      make_skipper(st, bias != nullptr, qn, scale, sb, sh, b, h, kvh, H, KVH, Lq, nk, qt, red);

  auto load_tile = [&](int kt, int slot) {
    float* ks = kvs + static_cast<size_t>(slot) * 2 * kBK * P;
    float* vs = ks + kBK * P;
    const size_t base = static_cast<size_t>(kt) * kBK * D;
    for (int i = tid; i < kBK * d4; i += kThreadsTc) {
      const int row = i / d4, c4 = (i - row * d4) * 4;
      const size_t off = base + static_cast<size_t>(row) * D + c4;
      cp_async16(ks + row * P + c4, kb + off);
      cp_async16(vs + row * P + c4, vb + off);
    }
  };

  const int r0 = 16 * rw + g;  // this thread's rows of the tile: r0 and r0 + 8
  const int kq = 32 * kh;      // first key of this warp's half of a tile
  int visits = 0;
  for (int c0 = 0; c0 < D; c0 += DP) {
    float acc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};

    int ld = sk.next(0, end), use = ld;
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (ld < end) {
        load_tile(ld, s);
        ld = sk.next(ld + 1, end);
      }
      cp_async_commit();
    }
    int slot = 0;
    while (use < end) {
      if constexpr (STAGES == 1) {
        load_tile(use, 0);
        cp_async_commit();
        cp_async_wait<0>();
      } else {
        cp_async_wait<STAGES - 2>();
      }
      __syncthreads();  // tile `use` landed; every thread left the slot refilled below
      if constexpr (STAGES > 1) {
        if (ld < end) {
          load_tile(ld, (slot + STAGES - 1) % STAGES);
          ld = sk.next(ld + 1, end);
        }
        cp_async_commit();
      }
      const float* ks = kvs + static_cast<size_t>(slot) * 2 * kBK * P;
      const float* vs = ks + kBK * P;
      const int k0 = use * kBK;

      float bv[4][4];  // the bias in the accumulator's layout, read ahead of the products
      if (bb != nullptr) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const long long key = k0 + kq + 8 * j + 2 * t;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const long long row = q0 + r0 + (e >= 2 ? 8 : 0);
            bv[j][e] = __ldg(bb + row * si + (key + (e & 1)) * sj);
          }
        }
      }

      // S = q k^T over this warp's 32 keys; each pair of k-steps' products
      // go into fresh accumulators, added to S in f32 (round to nearest)
      float sc[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.0f;
      const float* qa = qs + r0 * P + t;
      const float* kr = ks + (kq + g) * P + t;
      auto k_step = [&](int d, float (&part)[4][4]) {
        uint32_t ah[4], al[4];
        split_tf32(qa[d], ah[0], al[0]);
        split_tf32(qa[d + 8 * P], ah[1], al[1]);
        split_tf32(qa[d + 4], ah[2], al[2]);
        split_tf32(qa[d + 8 * P + 4], ah[3], al[3]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(kr[8 * j * P + d], bh0, bl0);
          split_tf32(kr[8 * j * P + d + 4], bh1, bl1);
          mma_3xtf32(part[j], ah, al, bh0, bh1, bl0, bl1);
        }
      };
      auto fold = [&](float (&part)[4][4]) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            sc[j][e] += part[j][e];
            part[j][e] = 0.0f;
          }
      };
      {
        float part[4][4] = {};
#pragma unroll
        for (int d = 0; d + 16 <= (DK > 0 ? DK : D); d += 16) {
          k_step(d, part);
          k_step(d + 8, part);
          fold(part);
        }
        if (D & 8) {  // an odd count of k-steps
          k_step(D - 8, part);
          fold(part);
        }
      }

      const bool diag = causal && use == qt;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[j][e] * scale;
          if (bb != nullptr) x += bv[j][e];
          if (diag && kq + 8 * j + 2 * t + (e & 1) > r0 + (e >= 2 ? 8 : 0)) x = -INFINITY;
          sc[j][e] = x;
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < 4; ++j) mx = fmaxf(mx, fmaxf(sc[j][2 * r], sc[j][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[r], mx);
        const float off = m_new == -INFINITY ? 0.0f : m_new;
        const float alpha = expf(m[r] - off);
        float sum = 0.0f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sc[j][2 * r] = expf(sc[j][2 * r] - off);
          sc[j][2 * r + 1] = expf(sc[j][2 * r + 1] - off);
          sum += sc[j][2 * r] + sc[j][2 * r + 1];
        }
        l[r] = l[r] * alpha + sum;
        m[r] = m_new;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          acc[n][2 * r] *= alpha;
          acc[n][2 * r + 1] *= alpha;
        }
      }

      // acc += P . V over the warp's 4 k-steps of 8 keys; k index t is key
      // 2t of the step, t + 4 key 2t + 1 (the accumulator layout of S). The
      // tile's sum goes into fresh accumulators, NG n8 tiles at a time, and
      // then into acc in f32 (round to nearest).
      uint32_t ph[4][4], pl[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        split_tf32(sc[kk][0], ph[kk][0], pl[kk][0]);
        split_tf32(sc[kk][2], ph[kk][1], pl[kk][1]);
        split_tf32(sc[kk][1], ph[kk][2], pl[kk][2]);
        split_tf32(sc[kk][3], ph[kk][3], pl[kk][3]);
      }
#pragma unroll
      for (int n0 = 0; n0 < NT; n0 += NG) {
        if (c0 + 8 * n0 >= D) break;
        float part[NG][4];
#pragma unroll
        for (int n = 0; n < NG; ++n) part[n][0] = part[n][1] = part[n][2] = part[n][3] = 0.0f;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float* v0 = vs + (kq + 8 * kk + 2 * t) * P + c0 + 8 * n0 + g;
#pragma unroll
          for (int n = 0; n < NG; ++n) {
            if (n0 + n < NT && c0 + 8 * (n0 + n) < D) {
              uint32_t bh0, bl0, bh1, bl1;
              split_tf32(v0[8 * n], bh0, bl0);
              split_tf32(v0[8 * n + P], bh1, bl1);
              mma_3xtf32(part[n], ph[kk], pl[kk], bh0, bh1, bl0, bl1);
            }
          }
        }
#pragma unroll
        for (int n = 0; n < NG; ++n)
          if (n0 + n < NT)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[n0 + n][e] += part[n][e];
      }
      if constexpr (STAGES == 1) __syncthreads();  // before the next load overwrites it
      slot = (slot + 1) % STAGES;
      use = sk.next(use + 1, end);
      if (c0 == 0) ++visits;
    }
    cp_async_wait<0>();
    __syncthreads();  // every stage is free: it carries the merge below

    // the two key halves of each row meet: warp rw + 4 hands (m, l, acc) to
    // warp rw through shared memory
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    float* mine = kvs + static_cast<size_t>(tid & (kThreadsTc / 2 - 1)) * MW;
    if (kh == 1) {
      mine[0] = m[0];
      mine[1] = m[1];
      mine[2] = l[0];
      mine[3] = l[1];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) mine[4 + 4 * n + e] = acc[n][e];
    }
    __syncthreads();
    if (kh == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m1 = mine[r];
        const float mm = fmaxf(m[r], m1);
        const float off = mm == -INFINITY ? 0.0f : mm;
        const float a0 = expf(m[r] - off), a1 = expf(m1 - off);
        const float inv = 1.0f / (l[r] * a0 + mine[2 + r] * a1);
        float* orow = ob + static_cast<size_t>(r0 + 8 * r) * D + c0 + 2 * t;
#pragma unroll
        for (int n = 0; n < NT; ++n)
          if (c0 + 8 * n < D) {
            const float x0 = acc[n][2 * r] * a0 + mine[4 + 4 * n + 2 * r] * a1;
            const float x1 = acc[n][2 * r + 1] * a0 + mine[4 + 4 * n + 2 * r + 1] * a1;
            *reinterpret_cast<float2*>(orow + 8 * n) = make_float2(x0 * inv, x1 * inv);
          }
      }
    }
    __syncthreads();  // the next pass reloads the stages
  }
  if (tid == 0 && st.visits != nullptr)
    st.visits[(static_cast<size_t>(b) * H + h) * nq + qt] = visits;
}

// the FFMA form (D > 256)
constexpr int kDK = 32;       // head-dim chunk of the score product
constexpr int kThreads = 256;
constexpr int kSP = kBQ + 4;  // pitch of the transposed q, k and P tiles

__device__ __forceinline__ float group_max(float x) {  // over the 16 lanes of a row group
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 8));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
}

__device__ __forceinline__ float group_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 8);
  x += __shfl_xor_sync(0xffffffffu, x, 4);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x + __shfl_xor_sync(0xffffffffu, x, 1);
}

template <int CPT>
constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * kDK * kSP + kBK * kSP + kBK * (16 * CPT + 4));
}

template <int CPT>  // output columns a thread in one pass
__global__ void __launch_bounds__(kThreads, 2)
flash_attn_ffma(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ bias, long long sb,
               long long sh, long long si, long long sj, float* __restrict__ out, int H,
               int KVH, int Lq, int Lk, int D, float scale, int causal, TileStats st) {
  constexpr int DO = 16 * CPT;  // output columns a pass
  constexpr int VP = DO + 4;    // pitch of the v tile
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;             // [kDK][kSP]: q chunk, transposed
  float* ks = qs + kDK * kSP;   // [kDK][kSP]: k chunk, transposed
  float* ps = ks + kDK * kSP;   // [kBK][kSP]: P, transposed (key-major)
  float* vs = ps + kBK * kSP;   // [kBK][VP]:  v columns of this pass

  const int t = threadIdx.x;
  const int rg = t >> 4;  // rows 4 rg .. 4 rg + 3 of the tile
  const int cg = t & 15;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const float* qb = q + (static_cast<size_t>(b) * H + h) * Lq * D + static_cast<size_t>(q0) * D;
  const float* kb = k + (static_cast<size_t>(b) * KVH + kvh) * Lk * D;
  const float* vb = v + (static_cast<size_t>(b) * KVH + kvh) * Lk * D;
  float* ob = out + (static_cast<size_t>(b) * H + h) * Lq * D + static_cast<size_t>(q0) * D;
  const float* bb = bias != nullptr ? bias + b * sb + h * sh : nullptr;
  const int n_tiles = causal ? min(Lk / kBK, (q0 + kBQ - 1) / kBK + 1) : Lk / kBK;
  __shared__ float red[kThreads / 32];
  const float qn = bias != nullptr ? tile_norm_max(qb, D, D, red) : 0.0f;
  const Skipper sk = make_skipper(st, bias != nullptr, qn, scale, sb, sh, b, h, kvh, H, KVH,
                                  Lq, Lk / kBK, blockIdx.x, red);
  int visits = 0;

  for (int c0 = 0; c0 < D; c0 += DO) {
    float acc[4][CPT];
    float m[4], l[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      m[r] = -INFINITY;
      l[r] = 0.0f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[r][j] = 0.0f;
    }

    for (int kt = sk.next(0, n_tiles); kt < n_tiles; kt = sk.next(kt + 1, n_tiles)) {
      const int k0 = kt * kBK;
      if (c0 == 0) ++visits;
      float s[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = 0.0f;

      for (int d0 = 0; d0 < D; d0 += kDK) {
        __syncthreads();  // the last readers of qs, ks (and ps, vs) are done
        for (int i = t; i < kBQ * kDK / 4; i += kThreads) {
          const int row = i / (kDK / 4);
          const int c4 = (i % (kDK / 4)) * 4;
          float4 qv = make_float4(0.f, 0.f, 0.f, 0.f);
          float4 kv = qv;
          if (d0 + c4 < D) {  // D % 8 == 0: a float4 lies wholly inside or outside
            qv = *reinterpret_cast<const float4*>(qb + static_cast<size_t>(row) * D + d0 + c4);
            kv = *reinterpret_cast<const float4*>(kb + static_cast<size_t>(k0 + row) * D + d0 +
                                                  c4);
          }
          qs[(c4 + 0) * kSP + row] = qv.x;
          qs[(c4 + 1) * kSP + row] = qv.y;
          qs[(c4 + 2) * kSP + row] = qv.z;
          qs[(c4 + 3) * kSP + row] = qv.w;
          ks[(c4 + 0) * kSP + row] = kv.x;
          ks[(c4 + 1) * kSP + row] = kv.y;
          ks[(c4 + 2) * kSP + row] = kv.z;
          ks[(c4 + 3) * kSP + row] = kv.w;
        }
        __syncthreads();
#pragma unroll 8
        for (int dd = 0; dd < kDK; ++dd) {
          const float4 a = *reinterpret_cast<const float4*>(qs + dd * kSP + 4 * rg);
          const float4 c = *reinterpret_cast<const float4*>(ks + dd * kSP + 4 * cg);
          const float av[4] = {a.x, a.y, a.z, a.w};
          const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int cc = 0; cc < 4; ++cc) s[r][cc] = fmaf(av[r], cv[cc], s[r][cc]);
        }
      }

      // scale, bias, causal; then the online softmax of each row
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = q0 + 4 * rg + r;
        float mx = -INFINITY;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int key = k0 + 4 * cg + c;
          float x = s[r][c] * scale;
          if (bb != nullptr) x += bb[row * si + key * sj];
          if (causal && key > row) x = -INFINITY;
          s[r][c] = x;
          mx = fmaxf(mx, x);
        }
        const float m_new = fmaxf(m[r], group_max(mx));
        const float off = m_new == -INFINITY ? 0.0f : m_new;
        const float alpha = expf(m[r] - off);
        float sum = 0.0f;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[r][c] = expf(s[r][c] - off);
          sum += s[r][c];
        }
        l[r] = l[r] * alpha + group_sum(sum);
        m[r] = m_new;
#pragma unroll
        for (int j = 0; j < CPT; ++j) acc[r][j] *= alpha;
      }
#pragma unroll
      for (int c = 0; c < 4; ++c)
        *reinterpret_cast<float4*>(ps + (4 * cg + c) * kSP + 4 * rg) =
            make_float4(s[0][c], s[1][c], s[2][c], s[3][c]);
      for (int i = t; i < kBK * DO / 4; i += kThreads) {
        const int key = i / (DO / 4);
        const int c4 = (i % (DO / 4)) * 4;
        float4 vv = make_float4(0.f, 0.f, 0.f, 0.f);
        if (c0 + c4 < D)
          vv = *reinterpret_cast<const float4*>(vb + static_cast<size_t>(k0 + key) * D + c0 + c4);
        *reinterpret_cast<float4*>(vs + key * VP + c4) = vv;
      }
      __syncthreads();

#pragma unroll 4
      for (int kk = 0; kk < kBK; ++kk) {
        const float4 p4 = *reinterpret_cast<const float4*>(ps + kk * kSP + 4 * rg);
        const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
        float vv[CPT];
        const float* vrow = vs + kk * VP + CPT * cg;
        if constexpr (CPT % 4 == 0) {
#pragma unroll
          for (int j = 0; j < CPT; j += 4) {
            const float4 x = *reinterpret_cast<const float4*>(vrow + j);
            vv[j] = x.x;
            vv[j + 1] = x.y;
            vv[j + 2] = x.z;
            vv[j + 3] = x.w;
          }
        } else {
#pragma unroll
          for (int j = 0; j < CPT; j += 2) {
            const float2 x = *reinterpret_cast<const float2*>(vrow + j);
            vv[j] = x.x;
            vv[j + 1] = x.y;
          }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int j = 0; j < CPT; ++j) acc[r][j] = fmaf(pv[r], vv[j], acc[r][j]);
      }
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float inv = 1.0f / l[r];
      float* orow = ob + static_cast<size_t>(4 * rg + r) * D + c0 + CPT * cg;
#pragma unroll
      for (int j = 0; j < CPT; ++j)
        if (c0 + CPT * cg + j < D) orow[j] = acc[r][j] * inv;
    }
  }
  if (t == 0 && st.visits != nullptr)
    st.visits[(static_cast<size_t>(b) * H + h) * (Lq / kBQ) + blockIdx.x] = visits;
}

template <int NT, int STAGES, int DK = 0>
int launch_tc(const float* q, const float* k, const float* v, const float* bias, long long sb,
              long long sh, long long si, long long sj, float* out, int B, int H, int KVH,
              int Lq, int Lk, int D, float scale, int causal, TileStats st,
              cudaStream_t stream) {
  const size_t smem = tc_smem_bytes<STAGES>(D);
  auto kernel = flash_attn_tf32<NT, STAGES, DK>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(H, Lq / kBQ, B);
  kernel<<<grid, kThreadsTc, smem, stream>>>(q, k, v, bias, sb, sh, si, sj, out, H, KVH, Lq,
                                             Lk, D, scale, causal, st);
  return static_cast<int>(cudaGetLastError());
}

template <int CPT>
int launch_ffma(const float* q, const float* k, const float* v, const float* bias, long long sb,
                long long sh, long long si, long long sj, float* out, int B, int H, int KVH,
                int Lq, int Lk, int D, float scale, int causal, TileStats st,
                cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<CPT>();
  auto kernel = flash_attn_ffma<CPT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(Lq / kBQ, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(q, k, v, bias, sb, sh, si, sj, out, H, KVH, Lq, Lk,
                                           D, scale, causal, st);
  return static_cast<int>(cudaGetLastError());
}

// the workspace's layout, in 4-byte words: visits, then (with a bias)
// knorm, tmax, rowmax
struct Layout {
  size_t visits, knorm, tmax, rowmax, words;
};

Layout layout(int B, int H, int KVH, int Lq, int Lk, bool has_bias, long long sb,
              long long sh) {
  const size_t nq = Lq / kBQ, nk = Lk / kBK;
  const size_t nbb = sb ? B : 1, nhb = sh ? H : 1;
  Layout lo{};
  lo.visits = 0;
  lo.knorm = static_cast<size_t>(B) * H * nq;
  lo.tmax = lo.knorm + (has_bias ? static_cast<size_t>(B) * KVH * nk : 0);
  lo.rowmax = lo.tmax + (has_bias ? nbb * nhb * nq * nk : 0);
  lo.words = lo.rowmax + (has_bias ? nbb * nhb * static_cast<size_t>(Lq) : 0);
  return lo;
}

bool in_range(int B, int H, int KVH, int Lq, int Lk, int D, int causal) {
  return !(B < 1 || H < 1 || KVH < 1 || H % KVH || Lq < kBQ || Lq % kBQ || Lk < kBK ||
           Lk % kBK || D < 8 || D % 8 || (causal && Lq != Lk) || H > 65535 || B > 65535 ||
           Lq / kBQ > 65535);
}

}  // namespace

extern "C" const char* lele_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Bytes of the workspace flash_attn needs for these shapes (has_bias: a
// bias is passed; sb, sh its batch and head strides), or -1 outside the
// kernel's range. Its first B * H * (Lq / 64) int32 words receive, per
// (batch row, head, q tile), the key tiles the kernel visited.
extern "C" long long flash_attn_work_bytes(int B, int H, int KVH, int Lq, int Lk, int D,
                                           int causal, int has_bias, long long sb,
                                           long long sh) {
  if (!in_range(B, H, KVH, Lq, Lk, D, causal)) return -1;
  return 4 * static_cast<long long>(layout(B, H, KVH, Lq, Lk, has_bias, sb, sh).words);
}

// out [B, H, Lq, D] f32 from q [B, H, Lq, D], k and v [B, KVH, Lk, D] f32,
// contiguous and 16-byte aligned on the card; bias is null or an f32 tensor
// read at b * sb + h * sh + i * si + j * sj (element strides, 0 where it
// broadcasts); work: flash_attn_work_bytes(...) bytes of scratch, 4-byte
// aligned. With a bias, launches the two prepass kernels, then the main
// kernel (the tensor-core form up to D = 256, the FFMA form above), all on
// `stream`; returns cudaGetLastError(), or cudaErrorInvalidValue outside
// the kernel's range (Lq, Lk multiples of 64, D % 8 == 0, H % KVH == 0,
// causal only where Lq == Lk).
extern "C" int flash_attn(const void* q, const void* k, const void* v, const void* bias,
                          long long sb, long long sh, long long si, long long sj, void* out,
                          int B, int H, int KVH, int Lq, int Lk, int D, float scale, int causal,
                          void* work, void* stream) {
  if (!in_range(B, H, KVH, Lq, Lk, D, causal) || work == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* bf = static_cast<const float*>(bias);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Layout lo = layout(B, H, KVH, Lq, Lk, bf != nullptr, sb, sh);
  float* ws = static_cast<float*>(work);
  TileStats st{nullptr, nullptr, nullptr, reinterpret_cast<int*>(ws + lo.visits)};
  if (bf != nullptr) {
    const int nbb = sb ? B : 1, nhb = sh ? H : 1;
    unsigned* rowmax = reinterpret_cast<unsigned*>(ws + lo.rowmax);
    cudaError_t err = cudaMemsetAsync(rowmax, 0, 4 * (lo.words - lo.rowmax), s);
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_kstats<<<dim3(Lk / kBK, KVH, B), kStatThreads, 0, s>>>(kf, ws + lo.knorm, Lk, D);
    flash_bstats<<<dim3(Lk / kBK, Lq / kBQ, nbb * nhb), kStatThreads, 0, s>>>(
        bf, sb, sh, si, sj, ws + lo.tmax, rowmax, Lq, Lk, nhb, causal);
    st.knorm = ws + lo.knorm;
    st.tmax = ws + lo.tmax;
    st.rowmax = rowmax;
  }
#define LELE_FLASH_ARGS \
  qf, kf, vf, bf, sb, sh, si, sj, of, B, H, KVH, Lq, Lk, D, scale, causal, st, s
  if (D == 64) return launch_tc<8, 3, 64>(LELE_FLASH_ARGS);
  if (D == 96) return launch_tc<12, 3, 96>(LELE_FLASH_ARGS);
  if (D == 128) return launch_tc<16, 2, 128>(LELE_FLASH_ARGS);
  if (D <= 32) return launch_tc<4, 3>(LELE_FLASH_ARGS);
  if (D <= 64) return launch_tc<8, 3>(LELE_FLASH_ARGS);
  if (D <= 96) return launch_tc<12, 3>(LELE_FLASH_ARGS);
  if (D <= 128) return launch_tc<16, 2>(LELE_FLASH_ARGS);
  if (D <= 256) return launch_tc<16, 1>(LELE_FLASH_ARGS);
  return launch_ffma<8>(LELE_FLASH_ARGS);
#undef LELE_FLASH_ARGS
}
