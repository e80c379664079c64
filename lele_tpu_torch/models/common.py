"""Shared building blocks (counterpart of lele_tpu/models/common.py).

Params are nested dicts of tensors, in the JAX package's layouts: linear
weights [d_in, d_out], conv weights [C_out, C_in/g, k] and
[C_out, C_in/g, k, k], LSTM weights [d_in, 4H] and [H, 4H] (gates i, f, g,
o), activations feature-last ([B, T, D]; images NHWC).

"bf16 operands, f32 accumulation" (JAX's `preferred_element_type=f32`) is
written as a float32 product of bf16-rounded operands: the product of two
bf16 values is exact in float32, whereas torch's bf16 matmul would return
bf16. On a card this needs `torch.backends.cuda.matmul.allow_tf32 = False`
(PyTorch's default).
"""

from __future__ import annotations

import functools
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from ..config import cudnn_tf32
from ..utils.consts import real_tensors
from ..params import tree_map

Params = dict[str, Any]


def init_linear(gen: torch.Generator, d_in: int, d_out: int,
                bias: bool = True) -> Params:
    """Uniform(-1/sqrt(d_in), 1/sqrt(d_in)) weight [d_in, d_out], zero bias."""
    scale = 1.0 / np.sqrt(d_in)
    w = torch.rand((d_in, d_out), generator=gen, device=gen.device) * (2 * scale) - scale
    p = {"w": w}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=torch.float32, device=gen.device)
    return p


def init_layer_norm(gen: torch.Generator, d: int) -> Params:
    return {"g": torch.ones((d,), dtype=torch.float32, device=gen.device),
            "b": torch.zeros((d,), dtype=torch.float32, device=gen.device)}


def round_to(x: torch.Tensor, dtype: torch.dtype | None) -> torch.Tensor:
    """x rounded to `dtype` and carried as float32 (no-op for None/float32)."""
    if dtype is None:
        return x.float()
    return x.to(dtype).float()


def linear(p: Params, x: torch.Tensor, dtype: torch.dtype | None = None) -> torch.Tensor:
    """x @ w (+ b) with operands rounded to `dtype`, accumulated in float32."""
    y = round_to(x, dtype) @ round_to(p["w"], dtype)
    if "b" in p:
        y = y + p["b"]
    return y


def layer_norm(p: Params, x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * p["g"] + p["b"]).to(x.dtype)


def _uniform(gen: torch.Generator, shape: tuple, scale: float) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=gen.device) * (2 * scale) - scale


def init_conv1d(gen: torch.Generator, c_in: int, c_out: int, k: int,
                groups: int = 1) -> Params:
    """Uniform(±1/sqrt(C_in/g·k)) weight [C_out, C_in/g, k], zero bias."""
    scale = 1.0 / np.sqrt(c_in // groups * k)
    return {"w": _uniform(gen, (c_out, c_in // groups, k), scale),
            "b": torch.zeros((c_out,), dtype=torch.float32, device=gen.device)}


def same_pads(t: int, k: int, stride: int = 1, dilation: int = 1) -> tuple[int, int]:
    """XLA's "SAME" split: out = ceil(t/stride), lo = total//2, hi = total - lo.
    It is asymmetric wherever the total is odd (stride-2 convs of even t)."""
    out = -(-t // stride)
    total = max((out - 1) * stride + (k - 1) * dilation + 1 - t, 0)
    return total // 2, total - total // 2


def conv1d(p: Params, x: torch.Tensor, stride: int = 1, padding="SAME", groups: int = 1,
           dilation: int = 1) -> torch.Tensor:
    """x [B, T, C] (feature-last, as the JAX package) → [B, T', C_out], f32.

    `padding` is "SAME", "VALID" or (lo, hi); F.conv1d pads symmetrically
    only, so the input is padded first. cuDNN's TF32 is off inside, so a
    card computes it in full f32."""
    w = p["w"]
    k = w.shape[-1]
    if padding == "SAME":
        lo, hi = same_pads(x.shape[1], k, stride, dilation)
    elif padding == "VALID":
        lo, hi = 0, 0
    else:
        lo, hi = padding
    xt = F.pad(x.float().transpose(1, 2), (lo, hi))
    with torch.backends.cudnn.flags(enabled=torch.backends.cudnn.enabled,
                                    allow_tf32=cudnn_tf32()):
        y = F.conv1d(xt, w.float(), None, stride=stride, dilation=dilation, groups=groups)
    return y.transpose(1, 2) + p["b"]


def init_conv2d(gen: torch.Generator, c_in: int, c_out: int, k: int,
                groups: int = 1) -> Params:
    """Uniform(±1/sqrt(C_in/g·k·k)) weight [C_out, C_in/g, k, k], zero bias."""
    scale = 1.0 / np.sqrt(c_in // groups * k * k)
    return {"w": _uniform(gen, (c_out, c_in // groups, k, k), scale),
            "b": torch.zeros((c_out,), dtype=torch.float32, device=gen.device)}


def conv2d(p: Params, x: torch.Tensor, stride: int = 1, padding="SAME", groups: int = 1,
           dtype: torch.dtype | None = None) -> torch.Tensor:
    """x [B, H, W, C] (NHWC, as the JAX package) → [B, H', W', C_out], f32.

    JAX rounds x and w to `dtype` and keeps the f32 accumulator
    (`preferred_element_type=f32`) and the f32 bias: here an f32 conv of the
    rounded operands. `padding` is "SAME", "VALID" or ((lo, hi), (lo, hi));
    XLA's SAME is asymmetric where the total is odd (a stride-2 3x3 conv of
    an even size pads (0, 1)), so the NHWC input is padded first. The conv
    runs channels_last: the padded NHWC tensor, permuted, already is that
    layout, and so is cuDNN's output, so neither side copies. cuDNN's TF32
    is on for a 16-bit `dtype` (its values are exact in TF32 and their
    products exact in f32: the same arithmetic on tensor cores), and
    otherwise where the precision in force allows it (config.cudnn_tf32:
    not at "highest", the default)."""
    w = p["w"]
    if padding == "SAME":
        pads = [same_pads(x.shape[1 + i], w.shape[2 + i], stride) for i in range(2)]
    elif padding == "VALID":
        pads = [(0, 0), (0, 0)]
    else:
        pads = padding
    (hl, hh), (wl, wh) = pads
    xp = F.pad(round_to(x, dtype), (0, 0, wl, wh, hl, hh))
    tf32 = dtype in (torch.bfloat16, torch.float16) or cudnn_tf32()
    with torch.backends.cudnn.flags(enabled=torch.backends.cudnn.enabled, allow_tf32=tf32):
        y = F.conv2d(xp.permute(0, 3, 1, 2), round_to(w, dtype), None, stride=stride,
                     groups=groups)
    return y.permute(0, 2, 3, 1) + p["b"]


def conv_transpose1d(x: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
    """x [B, T, C_in], w [k, C_in, C_out] → [B, T·stride, C_out], f32: the
    counterpart of `lax.conv_transpose(x, w, (stride,), "SAME",
    dimension_numbers=("NHC", "HIO", "NHC"))`, with no bias.

    lax does not flip the kernel; F.conv_transpose1d, the adjoint of a
    convolution, does, so the kernel goes in reversed. lax pads the
    stride-dilated input by (a, b) (its SAME rule below) and correlates;
    F's `padding` p = k - 1 - a gives the same alignment, and the tail
    b - a becomes F's output padding where it is positive and a trim where
    it is negative. cuDNN's TF32 is off inside, as in `conv1d`."""
    k = w.shape[0]
    pad_len = k + stride - 2
    a = k - 1 if stride > k - 1 else -(-pad_len // 2)
    b = pad_len - a
    wt = w.float().flip(0).permute(1, 2, 0)  # [C_in, C_out, k]
    with torch.backends.cudnn.flags(enabled=torch.backends.cudnn.enabled,
                                    allow_tf32=cudnn_tf32()):
        y = F.conv_transpose1d(x.float().transpose(1, 2), wt, stride=stride,
                               padding=k - 1 - a, output_padding=max(b - a, 0))
    if b < a:
        y = y[..., : y.shape[-1] - (a - b)]
    return y.transpose(1, 2)


def init_lstm_cell(gen: torch.Generator, d_in: int, d_hidden: int) -> Params:
    """wx [d_in, 4H] and wh [H, 4H] uniform(±1/sqrt(fan-in)), zero bias [4H]."""
    return {"wx": _uniform(gen, (d_in, 4 * d_hidden), 1.0 / np.sqrt(d_in)),
            "wh": _uniform(gen, (d_hidden, 4 * d_hidden), 1.0 / np.sqrt(d_hidden)),
            "b": torch.zeros((4 * d_hidden,), dtype=torch.float32, device=gen.device)}


def lstm_cell(p: Params, x: torch.Tensor, h: torch.Tensor, c: torch.Tensor):
    """One step in f32; gate order i, f, g, o. Returns (h', c')."""
    gates = x @ p["wx"] + h @ p["wh"] + p["b"]
    hd = h.shape[-1]
    i = torch.sigmoid(gates[..., :hd])
    f = torch.sigmoid(gates[..., hd:2 * hd])
    g = torch.tanh(gates[..., 2 * hd:3 * hd])
    o = torch.sigmoid(gates[..., 3 * hd:])
    c_new = f * c + i * g
    return o * torch.tanh(c_new), c_new


def sinusoidal_positions(t: int, d: int, offset: int = 1) -> np.ndarray:
    """FunASR-style sinusoidal position encoding (positions start at 1)."""
    pos = np.arange(offset, t + offset, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, d, 2, dtype=np.float64) * -(np.log(10000.0) / d))
    pe = np.zeros((t, d), np.float64)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return pe.astype(np.float32)


@functools.lru_cache(maxsize=None)
def positions_on(t: int, d: int, device: torch.device) -> torch.Tensor:
    """`sinusoidal_positions(t, d)` as a float32 tensor on `device`, made once
    per (t, d, device): one per bucket, as the JAX program bakes it in as a
    constant. Callers must not write to it. Never evicted: a captured graph
    reads it by address (the keys are bounded by the buckets)."""
    with real_tensors():
        return torch.from_numpy(sinusoidal_positions(t, d)).to(device)


def count_params(p) -> int:
    """Elements over every leaf (tensor or array) of a param tree; None
    leaves count nothing, as in JAX's tree walk."""
    if p is None:
        return 0
    if isinstance(p, dict):
        return sum(count_params(v) for v in p.values())
    if isinstance(p, (list, tuple)):
        return sum(count_params(v) for v in p)
    return int(np.prod(p.shape))


def cast_big_params(params: Params, dtype: torch.dtype) -> Params:
    """Every floating leaf of rank ≥ 2 (linear weights, `prefix`, `fsmn.w`)
    becomes `dtype`; norms, biases and int8 weights stay as they are."""
    def cast(a):
        if a.ndim >= 2 and a.is_floating_point():
            return a.to(dtype)
        return a

    return tree_map(cast, params)
