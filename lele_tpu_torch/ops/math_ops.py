"""Math emitters (counterpart of lele_tpu/ops/math_ops.py): the ones the
SAN-M int8 graph uses, plus Div and ReduceSum, which its common export
variants use (a Div-form attention scale, a side-tap reduction), and
Equal, Log, Gemm, ReduceMean and STFT, which the Silero-class graphs use, and
Neg, which control-flow bodies use."""

from __future__ import annotations

import numpy as np
import torch

from ..features.framing import frame_signal
from .registry import OpContext, op, static_ints


def _promote(a, b):
    """Two float operands of different types in the wider one, as jnp
    promotes them: torch keeps a bf16 tensor bf16 against an f32 0-dim
    tensor, where jnp gives f32 (a compiled graph's f32 scalar constant
    meeting its bf16 activations under a compute dtype)."""
    if (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor) and a.dtype != b.dtype
            and a.is_floating_point() and b.is_floating_point()):
        dt = torch.promote_types(a.dtype, b.dtype)
        return a.to(dt), b.to(dt)
    return a, b


@op("Add")
def add(ctx: OpContext, a, b):
    return ctx.xp.add(*_promote(a, b))


@op("Sub")
def sub(ctx: OpContext, a, b):
    return ctx.xp.subtract(*_promote(a, b))


@op("Mul")
def mul(ctx: OpContext, a, b):
    return ctx.xp.multiply(*_promote(a, b))


@op("Div")
def div(ctx: OpContext, a, b):
    a, b = _promote(a, b)
    if ctx.is_fold:
        a_ = np.asarray(a)
        if np.issubdtype(a_.dtype, np.integer):
            # ONNX integer Div truncates toward zero (C semantics)
            q = np.floor_divide(a, b)
            r = a_ - q * np.asarray(b)
            neg = (a_ < 0) != (np.asarray(b) < 0)
            return np.where((r != 0) & neg, q + 1, q)
        return np.divide(a, b)
    if not a.is_floating_point():
        return torch.div(a, b, rounding_mode="trunc")
    return torch.div(a, b)


@op("Neg")
def neg(ctx: OpContext, x):
    return ctx.xp.negative(x)


@op("Less")
def less(ctx: OpContext, a, b):
    return ctx.xp.less(a, b)


@op("Equal")
def equal(ctx: OpContext, a, b):
    return np.equal(a, b) if ctx.is_fold else torch.eq(a, b)


@op("Log")
def log(ctx: OpContext, x):
    return ctx.xp.log(x)


@op("Erf", foldable=False)
def erf(ctx: OpContext, x):
    """The exact GELU's erf, as torch.onnx.export writes it."""
    return torch.special.erf(x)


@op("MatMul", foldable=False)
def matmul(ctx: OpContext, a, b):
    """f32 products in full f32: a card needs allow_tf32 off (torch's
    default)."""
    return torch.matmul(a, b)


@op("Gemm", foldable=False)
def gemm(ctx: OpContext, a, b, c=None):
    """alpha · op(A) @ op(B) + beta · C, in f32 as MatMul."""
    alpha = ctx.attr("alpha", 1.0)
    beta = ctx.attr("beta", 1.0)
    if ctx.attr("transA", 0):
        a = a.transpose(0, 1)
    if ctx.attr("transB", 0):
        b = b.transpose(0, 1)
    out = torch.matmul(a, b)
    if alpha != 1.0:
        out = out * alpha
    if c is not None and beta != 0.0:
        out = out + (c if beta == 1.0 else beta * c)
    return out


@op("Range", static_args=(0, 1, 2))
def range_(ctx: OpContext, start, limit, delta):
    # the output's shape depends on the values, so it must fold
    s, lim, d = np.asarray(start), np.asarray(limit), np.asarray(delta)
    return np.arange(s.item(), lim.item(), d.item(), dtype=s.dtype)


def _reduce(ctx: OpContext, x, axes, np_fn, torch_fn):
    """ONNX reduce semantics: axes as an input (opset >= 13/18) or attribute;
    none or empty means all axes, or the input itself with
    noop_with_empty_axes."""
    keep = bool(ctx.attr("keepdims", 1))
    if axes is None:
        axes = ctx.attr_ints("axes")
    if axes is None or len(static_ints(axes, "reduce axes")) == 0:
        if ctx.attr("noop_with_empty_axes", 0):
            return x
        ax = tuple(range(np.ndim(x)))
    else:
        ax = tuple(a % max(np.ndim(x), 1) for a in static_ints(axes, "reduce axes"))
    if ctx.is_fold:
        return np_fn(x, axis=ax, keepdims=keep)
    if not ax:  # a 0-d tensor
        return x
    return torch_fn(x, dim=ax, keepdim=keep)


@op("ReduceSum", static_args=(1,))
def reduce_sum(ctx: OpContext, x, axes=None):
    return _reduce(ctx, x, axes, np.sum, torch.sum)


@op("ReduceMean", static_args=(1,))
def reduce_mean(ctx: OpContext, x, axes=None):
    return _reduce(ctx, x, axes, np.mean, torch.mean)


@op("STFT", foldable=False, static_args=(1, 3))
def stft(ctx: OpContext, signal, frame_step, window=None, frame_length=None):
    """ONNX STFT (opset 17): framing + FFT → [B, frames, bins, 2] (real,
    imaginary), f32."""
    step = static_ints(frame_step, "frame_step")[0]
    if signal.dim() == 3:  # [B, L, 1]
        signal = signal[..., 0]
    if window is not None:
        flen = int(window.shape[-1])
    elif frame_length is not None:
        flen = static_ints(frame_length, "frame_length")[0]
    else:
        raise ValueError("STFT requires window or frame_length")
    frames = frame_signal(signal, flen, step)  # [B, frames, flen]
    if window is not None:
        frames = frames * window
    fft = torch.fft.rfft if ctx.attr("onesided", 1) else torch.fft.fft
    spec = fft(frames, n=flen, dim=-1)
    return torch.stack([spec.real, spec.imag], dim=-1).float()
