"""Weight-only int8 GEMM (w8a16): counterpart of lele_tpu/kernels/quant_matmul.py.

`w8_matmul` replaces `w8_matmul_pallas` (lele_tpu/kernels/quant_matmul.py:267).
The kernel is csrc/w8_gemm.cu (design and bounds in csrc/w8_gemm.cuh):
bf16 x runs on the tensor cores (`mma.sync`, f32 accumulate), f32 x as true
f32 FMA; int8 weights are converted in registers and the per-output-channel
scale is applied in the epilogue. On the main path it is the CTC head,
[T, 512] x [512, 25055]. JAX's default there is its jnp dequant-dot; the
port launches the kernel.

`w8_matmul` takes the plain version only for a CPU tensor; for a CUDA tensor
it launches the kernel or raises. `w8_matmul.launches` counts launches.
"""

from __future__ import annotations

import torch

from . import _build

_STEM = "w8_gemm"
_AMODE = {torch.float32: 0, torch.bfloat16: 1}
_fn = None


def quantize_weight_int8(w: torch.Tensor, axis: int = 0):
    """Per-output-channel symmetric int8 quantisation of a [K, N] weight
    (reduce over `axis`): returns (wq int8, scale f32 [N])."""
    w = w.float()
    amax = w.abs().amax(dim=axis, keepdim=True)
    scale = torch.where(amax == 0, torch.ones_like(amax), amax / 127.0)
    wq = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return wq, scale.reshape(-1)


def w8_matmul_plain(x: torch.Tensor, wq: torch.Tensor, w_scale: torch.Tensor) -> torch.Tensor:
    """x [M, K] bf16/f32 @ int8 wq [K, N], × w_scale [N] → f32 [M, N].

    One float32 product: bf16 and int8 values are exact in float32, so this
    is "bf16 operands, f32 accumulate" for bf16 x and full f32 for f32 x
    (needs allow_tf32 off on a card)."""
    return (x.float() @ wq.float()) * w_scale.float().reshape(1, -1)


def _check(x, wq, w_scale):
    if x.dim() != 2 or wq.dim() != 2 or x.shape[1] != wq.shape[0]:
        raise ValueError(f"w8_matmul: shapes {tuple(x.shape)} @ {tuple(wq.shape)}")
    if x.dtype not in _AMODE or wq.dtype != torch.int8 or w_scale.dtype != torch.float32:
        raise TypeError(f"w8_matmul: dtypes {x.dtype}, {wq.dtype}, {w_scale.dtype}")
    if w_scale.numel() != wq.shape[1]:
        raise ValueError("w8_matmul: one scale per output channel")
    for t in (x, wq, w_scale):
        if t.device != x.device:
            raise ValueError("w8_matmul: tensors on different devices")


def w8_matmul_kernel(x: torch.Tensor, wq: torch.Tensor, w_scale: torch.Tensor) -> torch.Tensor:
    """Launch csrc/w8_gemm.cu on x's card and stream."""
    global _fn
    if not x.is_cuda:
        raise ValueError(f"w8_matmul_kernel: x lies on {x.device}, not on a CUDA card")
    _check(x, wq, w_scale)
    if _fn is None:
        P, I = _build.P, _build.I
        _fn = _build.bind(_STEM, "w8_gemm", [P, I, P, P, P, P, P, I, I, I, I, P])
    x, wq, w_scale = x.contiguous(), wq.contiguous(), w_scale.contiguous()
    M, K = x.shape
    N = wq.shape[1]
    y = torch.empty((M, N), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = _fn(x.data_ptr(), _AMODE[x.dtype], wq.data_ptr(), w_scale.data_ptr(),
               None, None, y.data_ptr(), M, K, N, 0, stream)
    _build.check(_STEM, "w8_gemm", code)
    w8_matmul.launches += 1
    return y


def w8_matmul(x: torch.Tensor, wq: torch.Tensor, w_scale: torch.Tensor) -> torch.Tensor:
    """x [M, K] bf16/f32, wq int8 [K, N], w_scale f32 [N] → f32 [M, N]."""
    if x.device.type == "cpu":
        return w8_matmul_plain(x, wq, w_scale)
    return w8_matmul_kernel(x, wq, w_scale)


w8_matmul.launches = 0
