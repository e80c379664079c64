"""The com.microsoft ops of ORT's diffusion-model optimizer (counterpart of
lele_tpu/ops/diffusion_ops.py): GroupNorm, SkipGroupNorm, NhwcConv,
BiasSplitGelu, BiasAdd and GemmFastGelu.

ORT's transformer optimizer (`--model_type unet / vae / clip`, the form the
published Stable Diffusion ONNX releases ship in) rewrites UNet and VAE
graphs into these nodes. NhwcConv is cuDNN's conv on the NHWC tensor viewed
as a channels_last NCHW one (no transposes, TF32 off), as the port's YOLO
and ResNet-50 convs run; GroupNorm's statistics are f32 whatever the input
type.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..config import cudnn_tf32
from .nn_ops import _CONV_FNS, _resolve_pads
from .registry import OpContext, op


@op("GroupNorm", foldable=False, domain="com.microsoft")
def ms_group_norm(ctx: OpContext, x, gamma, beta):
    """The math of ai.onnx GroupNormalization, NHWC by default
    (`channels_last=1`), f32 gamma and beta of size C, and an optional fused
    swish (`activation=1`: y · sigmoid(y))."""
    eps = float(np.float32(ctx.attr("epsilon", 1e-5)))
    g = int(ctx.attr("groups"))
    last = int(ctx.attr("channels_last", 1))
    shape = tuple(x.shape)
    if last:
        c = shape[-1]
        xg = x.reshape(shape[:-1] + (g, c // g))
        # each group over every spatial dim and its channels
        axes = tuple(range(1, len(shape) - 1)) + (len(shape),)
    else:
        c = shape[1]
        xg = x.reshape((shape[0], g, c // g) + shape[2:])
        axes = (2,) + tuple(range(3, len(shape) + 1))
    xg = xg.float()
    mean = torch.mean(xg, dim=axes, keepdim=True)
    var = torch.var(xg, dim=axes, keepdim=True, correction=0)
    out = ((xg - mean) / torch.sqrt(var + eps)).reshape(shape)
    brd = (-1,) if last else (1, -1) + (1,) * (len(shape) - 2)
    out = out * gamma.float().reshape(brd) + beta.float().reshape(brd)
    if int(ctx.attr("activation", 0)):
        out = out * torch.sigmoid(out)
    return out.to(x.dtype)


@op("SkipGroupNorm", foldable=False, domain="com.microsoft")
def skip_group_norm(ctx: OpContext, x, gamma, beta, skip, bias=None):
    """GroupNorm over x + skip (+ bias); the skip full-shape [N, H, W, C],
    [N, 1, 1, C], or [N, C]. A second output, where the node names one, is
    the sum before the norm (the next residual)."""
    if skip.dim() == 2:  # [N, C] over every spatial position
        skip = skip.reshape((skip.shape[0],) + (1,) * (x.dim() - 2) + (skip.shape[-1],))
    tot = x + skip.to(x.dtype)
    if bias is not None:
        tot = tot + bias.to(x.dtype)
    y = ms_group_norm(ctx, tot, gamma, beta)
    if ctx.node is not None and len(ctx.node.output) >= 2 and ctx.node.output[1]:
        return y, tot
    return y


@op("NhwcConv", foldable=False, domain="com.microsoft")
def nhwc_conv(ctx: OpContext, x, w, b=None):
    """Conv with NHWC input and output and the ONNX OIHW weight: the input
    viewed as channels_last NCHW, one cuDNN conv, the output viewed back."""
    rank = x.dim() - 2
    kshape = ctx.attr_ints("kernel_shape", list(w.shape[2:]))
    strides = ctx.attr_ints("strides", [1] * rank)
    dilations = ctx.attr_ints("dilations", [1] * rank)
    xc = torch.movedim(x, -1, 1)  # a view: NCHW over channels_last memory
    pads = _resolve_pads(ctx, tuple(xc.shape), kshape, strides, dilations)
    if all(lo == hi for lo, hi in pads):
        padding = [lo for lo, _ in pads]
    else:
        xc = F.pad(xc, [p for lo_hi in reversed(pads) for p in lo_hi])
        padding = 0
    with torch.backends.cudnn.flags(enabled=torch.backends.cudnn.enabled, allow_tf32=cudnn_tf32()):
        out = _CONV_FNS[rank](xc, w.to(x.dtype), None, stride=strides, padding=padding,
                              dilation=dilations, groups=ctx.attr("group", 1))
    out = torch.movedim(out, 1, -1)
    if b is not None:
        out = out + b.to(out.dtype)  # the bias [C] on the last axis
    return out


@op("BiasSplitGelu", foldable=False, domain="com.microsoft")
def bias_split_gelu(ctx: OpContext, x, bias):
    """The GEGLU gate of SD UNet MLPs: (x + bias) split in half on the last
    axis, first half · Gelu(second half) (erf)."""
    s = x + bias.to(x.dtype)
    h = s.shape[-1] // 2
    return s[..., :h] * F.gelu(s[..., h:])


@op("BiasAdd", foldable=False, domain="com.microsoft")
def bias_add(ctx: OpContext, x, bias, skip):
    """x + bias[C] + skip: the residual add around SD attention blocks."""
    return x + bias.to(x.dtype) + skip


@op("GemmFastGelu", foldable=False, domain="com.microsoft")
def gemm_fast_gelu(ctx: OpContext, x, w, bias=None):
    """FastGelu(x @ w + bias): the tanh GELU behind the projection (f32 in
    full f32, as MatMul)."""
    y = torch.matmul(x, w.to(x.dtype))
    if bias is not None:
        y = y + bias.to(y.dtype)
    return F.gelu(y, approximate="tanh")
