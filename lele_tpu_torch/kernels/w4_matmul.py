"""Weight-only int4 GEMM (w4a16, groupwise scales): counterpart of
lele_tpu/kernels/w4_matmul.py.

`w4_matmul` replaces `w4_matmul_pallas` (lele_tpu/kernels/w4_matmul.py:144).
The kernel is csrc/w4_gemm.cu (design and bounds in csrc/w4_gemm.cuh).

Packing is the JAX package's block layout: byte i of the packed [K/2, N]
tensor holds q[i] in its low nibble and q[i + K/2] in its high nibble, with
q in [-8, 7] (`quantize_weight_int4` makes [-7, 7]; the MatMulNBits pattern
recentres ORT's [0, 15] to [-8, 7]). Scales are groupwise along K, f32
[K/group, N].

Numerics are the TPU kernel's, picked by the activation type:

- bf16 x, the group-accumulator form: each scale group gives one f32 dot of
  bf16 x with the raw int4 values (exact in bf16), times that group's scale
  row, added to an f32 accumulator;
- f32 x, the exact form: the weight is dequantised in f32 (q·s) and
  multiplied in full f32 (no TF32).

Both have exact products and differ from the kernel only in the order of
f32 sums. On the CPU the JAX package reaches `_w4_matmul_jnp`
(lele_tpu/kernels/w4_matmul.py:132) instead, which rounds q·s to x's type
before one dot: for bf16 x the two forms differ by that bf16 rounding.

Routing departs from the JAX wrapper in one place: where it falls to its jnp
path because no Pallas tile fits (lele_tpu/kernels/w4_matmul.py:111-129,
e.g. K/2 not a multiple of the group), the port still launches the kernel,
which takes any group that is a multiple of 16 and any K/2 that is a
multiple of 16; it raises for other shapes. A wrapper takes its plain
version only for a CPU tensor; for a CUDA tensor it launches the kernel or
raises. `w4_matmul.launches` counts launches.
"""

from __future__ import annotations

import torch

from . import _build

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


def _check(x, packed, scales, group: int):
    if x.dim() != 2 or packed.dim() != 2 or x.shape[1] != 2 * packed.shape[0]:
        raise ValueError(f"w4_matmul: shapes {tuple(x.shape)} @ packed {tuple(packed.shape)}")
    if x.dtype not in _AMODE or packed.dtype != torch.int8 or scales.dtype != torch.float32:
        raise TypeError(f"w4_matmul: dtypes {x.dtype}, {packed.dtype}, {scales.dtype}")
    K, N = x.shape[1], packed.shape[1]
    if group < 1 or K % group or tuple(scales.shape) != (K // group, N):
        raise ValueError(f"w4_matmul: scales {tuple(scales.shape)} for K={K}, N={N}, "
                         f"group={group}")
    for t in (packed, scales):
        if t.device != x.device:
            raise ValueError("w4_matmul: tensors on different devices")


def w4_matmul_plain(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                    group: int = 128) -> torch.Tensor:
    """x [M, K] bf16/f32 @ int4 packed [K/2, N] with scales [K/group, N] →
    f32 [M, N], in the TPU kernel's form for x's type (see the module
    docstring). Products of bf16 and int4 values are exact in f32; a card
    needs allow_tf32 off."""
    _check(x, packed, scales, group)
    lo, hi = _unpack_nibbles(packed)
    q = torch.cat([lo, hi], dim=0).float()  # [K, N]
    xf = x.float()
    if x.dtype == torch.float32:
        return xf @ (q * scales.repeat_interleave(group, dim=0))
    acc = torch.zeros((x.shape[0], q.shape[1]), dtype=torch.float32, device=x.device)
    for g in range(scales.shape[0]):
        sl = slice(g * group, (g + 1) * group)
        acc = acc + (xf[:, sl] @ q[sl]) * scales[g]
    return acc


def kernel_supports(K: int, group: int) -> bool:
    """Whether csrc/w4_gemm.cu takes K and the group: K/2 and the group
    multiples of 16."""
    return K % 32 == 0 and group >= 16 and group % 16 == 0


def w4_matmul_kernel(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                     group: int = 128) -> torch.Tensor:
    """Launch csrc/w4_gemm.cu on x's card and stream."""
    global _fn
    if not x.is_cuda:
        raise ValueError(f"w4_matmul_kernel: x lies on {x.device}, not on a CUDA card")
    _check(x, packed, scales, group)
    M, K = x.shape
    if not kernel_supports(K, group):
        raise ValueError(f"w4_matmul_kernel: K={K}, group={group}: the kernel needs K/2 "
                         "and the group to be multiples of 16")
    if _fn is None:
        P, I = _build.P, _build.I
        _fn = _build.bind(_STEM, "w4_gemm", [P, I, P, P, P, I, I, I, I, P])
    x, packed, scales = x.contiguous(), packed.contiguous(), scales.contiguous()
    N = packed.shape[1]
    y = torch.empty((M, N), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = _fn(x.data_ptr(), _AMODE[x.dtype], packed.data_ptr(), scales.data_ptr(),
               y.data_ptr(), M, K, N, group, stream)
    _build.check(_STEM, "w4_gemm", code)
    w4_matmul.launches += 1
    return y


def w4_matmul(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
              group: int = 128) -> torch.Tensor:
    """x [M, K] bf16/f32, packed int8 [K/2, N], scales f32 [K/group, N] →
    f32 [M, N] ≈ x @ dequantize_int4(packed, scales, group)."""
    if x.device.type == "cpu":
        return w4_matmul_plain(x, packed, scales, group)
    return w4_matmul_kernel(x, packed, scales, group)


w4_matmul.launches = 0
