"""Math emitters (counterpart of lele_tpu/ops/math_ops.py): the ones the
SAN-M int8 graph uses, plus Div and ReduceSum, which its common export
variants use (a Div-form attention scale, a side-tap reduction)."""

from __future__ import annotations

import numpy as np
import torch

from .registry import OpContext, op, static_ints


@op("Add")
def add(ctx: OpContext, a, b):
    return ctx.xp.add(a, b)


@op("Sub")
def sub(ctx: OpContext, a, b):
    return ctx.xp.subtract(a, b)


@op("Mul")
def mul(ctx: OpContext, a, b):
    return ctx.xp.multiply(a, b)


@op("Div")
def div(ctx: OpContext, a, b):
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


@op("Less")
def less(ctx: OpContext, a, b):
    return ctx.xp.less(a, b)


@op("MatMul", foldable=False)
def matmul(ctx: OpContext, a, b):
    """f32 products in full f32: a card needs allow_tf32 off (torch's
    default)."""
    return torch.matmul(a, b)


@op("Range", static_args=(0, 1, 2))
def range_(ctx: OpContext, start, limit, delta):
    # the output's shape depends on the values, so it must fold
    s, lim, d = np.asarray(start), np.asarray(limit), np.asarray(delta)
    return np.arange(s.item(), lim.item(), d.item(), dtype=s.dtype)


@op("ReduceSum", static_args=(1,))
def reduce_sum(ctx: OpContext, x, axes=None):
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
        return np.sum(x, axis=ax, keepdims=keep)
    if not ax:  # a 0-d tensor
        return x
    return torch.sum(x, dim=ax, keepdim=keep)
