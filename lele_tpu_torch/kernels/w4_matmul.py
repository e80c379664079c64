"""Weight-only int4 GEMM (w4a16, groupwise scales): counterpart of
lele_tpu/kernels/w4_matmul.py.

`w4_matmul` replaces `w4_matmul_pallas` (lele_tpu/kernels/w4_matmul.py:144).
The kernel is csrc/w4_gemm.cu: a tile GEMM (csrc/w4_gemm.cuh), and for few
rows (M <= 8 in the group-accumulator form, M <= 4 in the others) and every
expert-indexed launch a decode form (csrc/w4_gemv.cuh, a split-K GEMV); the
shape picks the form, and the two agree to the f32 summation order.

Packing is the JAX package's block layout: byte i of the packed [K/2, N]
tensor holds q[i] in its low nibble and q[i + K/2] in its high nibble, with
q in [-8, 7] (`quantize_weight_int4` makes [-7, 7]; the MatMulNBits and QMoE
patterns recentre ORT's [0, 15] to [-8, 7]). Scales are groupwise along K,
f32 [K/group, N].

The form follows the JAX wrapper's routing on the TPU
(lele_tpu/kernels/w4_matmul.py:106-129), without its VMEM budget, which
belongs to the TPU:

- f32 x, the exact form: the weight is dequantised in f32 (q·s) and
  multiplied in full f32 (no TF32), as both the Pallas kernel's f32 form and
  `_w4_matmul_jnp` compute it;
- bf16 x, the group-accumulator form, where JAX's tile test passes (a tile
  of 512, 256 or 128, capped at K/2, divides K/2 and is a multiple of the
  group; `group_acc_form`): each scale group gives one f32 dot of bf16 x
  with the raw int4 values (exact in bf16), times that group's scale row,
  added to an f32 accumulator;
- bf16 x, the dequantised-tile form, everywhere else: B = bf16(q·s), the f32
  product rounded once, then one f32-accumulated product, as
  `_w4_matmul_jnp` computes it.

One departure: the card's smallest bf16 MMA k-step is 8 rows, so a group
that passes JAX's tile test but is not a multiple of 8 (1, 2, 4, 12, ...)
takes the dequantised-tile form, where the TPU kernel would take the group
form; the two differ by the bf16 rounding of q·s. Every even K and every
group from 1 to 512 that divides K is taken (`kernel_supports`); the K/2
tail of a tile is zero-filled in the kernel's loads.

`w4_matmul(..., idx=...)` is the expert-indexed entry (QMoE decode): x
[R, K], stacks [E, K/2, N] and [E, K/group, N], idx int32 [R] on the card;
row r runs against stack idx[r], in one launch and without a host sync.

The plain version follows the same rule, so the card's check covers every
form. A wrapper takes its plain version only for a CPU tensor; for a CUDA
tensor it launches the kernel or raises. `w4_matmul.launches` counts
launches.
"""

from __future__ import annotations

import torch

from . import _build, _library

_STEM = "w4_gemm"
_AMODE = {torch.float32: 0, torch.bfloat16: 1}
_fn = None


def quantize_weight_int4(w: torch.Tensor, group: int = 128):
    """Groupwise symmetric int4 quantisation of a [K, N] weight → (packed
    int8 [K/2, N], scales f32 [K/group, N]). Values in [-7, 7], scale =
    amax/7 (1 where a group is all zero). Needs K even and K % group == 0."""
    w = w.float()
    K, N = w.shape
    if K % 2 or K % group:
        raise ValueError(f"K={K} must be even and divisible by group={group}")
    g = K // group
    wg = w.reshape(g, group, N)
    amax = wg.abs().amax(dim=1, keepdim=True)
    # a tensor divisor: on a card torch divides by a host scalar as a
    # multiplication by its reciprocal, which is not the IEEE quotient
    scale = torch.where(amax == 0, torch.ones_like(amax), amax / torch.full_like(amax, 7.0))
    q = torch.clamp(torch.round(wg / scale), -7, 7).to(torch.int32).reshape(K, N)
    half = K // 2
    # shift and OR in int32: the result lies in [-128, 127], so it casts to
    # int8 as jnp's int8 `left_shift` / `bitwise_or` give it
    packed = ((q[:half] & 0xF) | (q[half:] << 4)).to(torch.int8)
    return packed, scale.reshape(g, N)


def _unpack_nibbles(p: torch.Tensor):
    """packed int8 → (low int32, high int32), both sign-extended int4 values.
    The low nibble as ((p & 15) ^ 8) − 8 equals JAX's (p << 28) >> 28."""
    pi = p.to(torch.int32)
    return ((pi & 0xF) ^ 8) - 8, pi >> 4


def dequantize_int4(packed: torch.Tensor, scales: torch.Tensor, group: int = 128):
    """Inverse of quantize_weight_int4 → f32 [K, N] (q·s in f32)."""
    lo, hi = _unpack_nibbles(packed)
    q = torch.cat([lo, hi], dim=0).float()
    return q * scales.float().repeat_interleave(group, dim=0)


def _check(x, packed, scales, group: int, idx=None):
    lead = 0 if idx is None else 1  # the expert axis of the stacks
    if (x.dim() != 2 or packed.dim() != 2 + lead or scales.dim() != 2 + lead
            or x.shape[1] != 2 * packed.shape[-2]):
        raise ValueError(f"w4_matmul: shapes {tuple(x.shape)} @ packed {tuple(packed.shape)}")
    if x.dtype not in _AMODE or packed.dtype != torch.int8 or scales.dtype != torch.float32:
        raise TypeError(f"w4_matmul: dtypes {x.dtype}, {packed.dtype}, {scales.dtype}")
    K, N = x.shape[1], packed.shape[-1]
    if group < 1 or K % group or tuple(scales.shape[lead:]) != (K // group, N):
        raise ValueError(f"w4_matmul: scales {tuple(scales.shape)} for K={K}, N={N}, "
                         f"group={group}")
    if idx is not None:
        if (idx.shape != (x.shape[0],) or idx.dtype != torch.int32
                or scales.shape[0] != packed.shape[0]):
            raise ValueError(f"w4_matmul: idx {tuple(idx.shape)} {idx.dtype} for "
                             f"{x.shape[0]} rows and {packed.shape[0]} stacks")
    for t in (packed, scales) + (() if idx is None else (idx,)):
        if t.device != x.device:
            raise ValueError("w4_matmul: tensors on different devices")


def group_acc_form(K: int, group: int) -> bool:
    """Whether bf16 x takes the group-accumulator form: JAX's tile test
    (lele_tpu/kernels/w4_matmul.py:110-114) and a group that is a multiple of
    the card's smallest MMA k-step, 8."""
    half = K // 2
    for tile in (512, 256, 128):
        tk = min(tile, half)
        if half % tk == 0 and tk % group == 0:
            return group % 8 == 0
    return False


def _plain_2d(xf, q, scales, group: int, bf16: bool, acc_form: bool):
    """One product in the form for x's type: xf f32 [M, K] (or [R, 1, K]),
    q f32 [K, N] (or [R, K, N]), scales [K/group, N] (or [R, K/group, N])."""
    if acc_form:
        acc = 0
        for g in range(scales.shape[-2]):
            sl = slice(g * group, (g + 1) * group)
            acc = acc + (xf[..., sl] @ q[..., sl, :]) * scales[..., g:g + 1, :]
        return acc
    w = q * scales.repeat_interleave(group, dim=-2)
    if bf16:
        w = w.to(torch.bfloat16).float()
    return xf @ w


def w4_matmul_plain(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                    group: int = 128, idx: torch.Tensor | None = None) -> torch.Tensor:
    """x [M, K] bf16/f32 @ int4 packed [K/2, N] with scales [K/group, N] →
    f32 [M, N], in the kernel's form for x's type and the shape (see the
    module docstring); with idx int32 [M], row r against stacks
    packed[idx[r]] and scales[idx[r]]. Products of bf16 and int4 values, and
    of bf16 values, are exact in f32; a card needs allow_tf32 off."""
    _check(x, packed, scales, group, idx)
    bf16 = x.dtype == torch.bfloat16
    acc_form = bf16 and group_acc_form(x.shape[1], group)
    xf = x.float()
    if idx is not None:  # gather the rows' stacks: [M, K/2, N], [M, K/group, N]
        idx = idx.long()
        packed, scales, xf = packed[idx], scales[idx], xf[:, None, :]
    lo, hi = _unpack_nibbles(packed)
    q = torch.cat([lo, hi], dim=-2).float()  # [.., K, N]
    out = _plain_2d(xf, q, scales, group, bf16, acc_form)
    return out if idx is None else out[:, 0]


def kernel_supports(K: int, group: int) -> bool:
    """Whether csrc/w4_gemm.cu takes K and the group: any even K, any group
    from 1 to 512 that divides K."""
    return K >= 2 and K % 2 == 0 and 1 <= group <= 512 and K % group == 0


def w4_matmul_kernel(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                     group: int = 128, idx: torch.Tensor | None = None) -> torch.Tensor:
    """Launch csrc/w4_gemm.cu on x's card and stream."""
    global _fn
    if not x.is_cuda:
        raise ValueError(f"w4_matmul_kernel: x lies on {x.device}, not on a CUDA card")
    _check(x, packed, scales, group, idx)
    M, K = x.shape
    if not kernel_supports(K, group):
        raise ValueError(f"w4_matmul_kernel: K={K}, group={group}: the kernel needs an even "
                         "K and a group from 1 to 512 that divides it")
    if _fn is None:
        P, I = _build.P, _build.I
        _fn = _build.bind(_STEM, "w4_gemm", [P, I, I, P, P, P, P, I, I, I, I, P])
    x, packed, scales = x.contiguous(), packed.contiguous(), scales.contiguous()
    idx = None if idx is None else idx.contiguous()
    idx_ptr = None if idx is None else idx.data_ptr()
    bmode = 0 if group_acc_form(K, group) else 1
    N = packed.shape[-1]
    y = torch.empty((M, N), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = _fn(x.data_ptr(), _AMODE[x.dtype], bmode, packed.data_ptr(), scales.data_ptr(),
               idx_ptr, y.data_ptr(), M, K, N, group, stream)
    _build.check(_STEM, "w4_gemm", code)
    w4_matmul.launches += 1
    return y


def w4_matmul(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
              group: int = 128, idx: torch.Tensor | None = None) -> torch.Tensor:
    """x [M, K] bf16/f32, packed int8 [K/2, N], scales f32 [K/group, N] →
    f32 [M, N] ≈ x @ dequantize_int4(packed, scales, group). With idx int32
    [M], packed [E, K/2, N] and scales [E, K/group, N]: row r against stack
    idx[r]. Calls the registered op `lele_tpu_torch::w4_gemm`
    (kernels/_library.py)."""
    return _OP(x, packed, scales, group, idx)


_OP = _library.register(
    "w4_gemm", "(Tensor x, Tensor packed, Tensor scales, int group, Tensor? idx) -> Tensor",
    w4_matmul_plain, w4_matmul_kernel,
    lambda x, packed, *_: x.new_empty((x.shape[0], packed.shape[-1]), dtype=torch.float32))
w4_matmul.launches = 0
