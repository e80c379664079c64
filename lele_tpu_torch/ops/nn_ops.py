"""NN emitters (counterpart of lele_tpu/ops/nn_ops.py): LayerNormalization,
and Conv for the 1-D case (the FSMN's depthwise memory conv)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .registry import OpContext, op


def _resolve_pads(ctx: OpContext, x_shape, k_shape, strides, dilations):
    """auto_pad / pads resolution, as lele_tpu/ops/nn_ops.py:_resolve_pads."""
    rank = len(k_shape)
    auto = ctx.attr("auto_pad", "NOTSET")
    if auto in ("NOTSET", "", None):
        pads = ctx.attr_ints("pads", [0] * (2 * rank))
        return [(pads[i], pads[i + rank]) for i in range(rank)]
    if auto == "VALID":
        return [(0, 0)] * rank
    out = []
    for i in range(rank):
        in_dim = x_shape[2 + i]
        eff_k = (k_shape[i] - 1) * dilations[i] + 1
        out_dim = -(-in_dim // strides[i])
        total = max(0, (out_dim - 1) * strides[i] + eff_k - in_dim)
        half = total // 2
        if auto == "SAME_UPPER":
            out.append((half, total - half))
        else:  # SAME_LOWER
            out.append((total - half, half))
    return out


@op("Conv", foldable=False)
def conv(ctx: OpContext, x, w, b=None):
    """1-D convolution [N, C, T] (grouped, strided, dilated, padded). cuDNN's
    TF32 is turned off for it, so a card computes it in full f32."""
    rank = x.dim() - 2
    if rank != 1:
        raise NotImplementedError(f"Conv over {rank} spatial dims is not ported "
                                  "yet (the port has the 1-D case)")
    kshape = ctx.attr_ints("kernel_shape", list(w.shape[2:]))
    strides = ctx.attr_ints("strides", [1])
    dilations = ctx.attr_ints("dilations", [1])
    group = ctx.attr("group", 1)
    (p0, p1), = _resolve_pads(ctx, tuple(x.shape), kshape, strides, dilations)
    xp = F.pad(x, (p0, p1))
    with torch.backends.cudnn.flags(enabled=torch.backends.cudnn.enabled,
                                    allow_tf32=False):
        out = F.conv1d(xp, w.to(x.dtype), None, stride=strides[0],
                       dilation=dilations[0], groups=group)
    if b is not None:
        out = out + b.to(out.dtype).reshape(1, -1, 1)
    return out


@op("LayerNormalization", foldable=False)
def layer_norm(ctx: OpContext, x, scale, b=None):
    axis = ctx.attr("axis", -1)
    eps = ctx.attr("epsilon", 1e-5)
    rank = x.dim()
    axis = axis if axis >= 0 else axis + rank
    axes = tuple(range(axis, rank))
    mean = torch.mean(x, dim=axes, keepdim=True)
    var = torch.mean(torch.square(x - mean), dim=axes, keepdim=True)
    inv_std = 1.0 / torch.sqrt(var + eps)
    out = (x - mean) * inv_std * scale
    if b is not None:
        out = out + b
    n_out = len(ctx.node.output) if ctx.node is not None else 1
    if n_out <= 1:
        return out
    return (out, mean, inv_std)[:n_out]

