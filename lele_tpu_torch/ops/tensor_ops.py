"""Tensor-manipulation emitters (counterpart of lele_tpu/ops/tensor_ops.py):
the ones the SAN-M int8 graph uses, plus Identity, which exports put
between any two nodes, and Constant, ConstantOfShape, Expand and Where,
which the Supertonic graphs add.

Shape-carrying chains (Shape → Slice/Gather → Concat → Reshape) fold to
numpy at trace time, so every reshape below sees static shape arguments.
"""

from __future__ import annotations

import numpy as np
import torch

from ..onnx.loader import DTYPE_MAP
from .registry import OpContext, op, static_ints

_TORCH_DTYPES = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
    np.dtype(np.float16): torch.float16,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.bool_): torch.bool,
}


def torch_dtype(dt) -> torch.dtype:
    """The torch dtype of a numpy dtype (bf16 and fp8 included where
    ml_dtypes is)."""
    dt = np.dtype(dt)
    if dt.name == "bfloat16":
        return torch.bfloat16
    if dt.name.startswith("float8_"):
        return getattr(torch, dt.name)
    if dt not in _TORCH_DTYPES:
        raise TypeError(f"no torch dtype for numpy {dt} on the device")
    return _TORCH_DTYPES[dt]


@op("Identity")
def identity(ctx: OpContext, x):
    return x


@op("Transpose")
def transpose(ctx: OpContext, x):
    perm = ctx.attr_ints("perm")
    if perm is None:
        perm = list(range(np.ndim(x) if ctx.is_fold else x.dim()))[::-1]
    if ctx.is_fold:
        return np.transpose(x, axes=perm)
    return x.permute(*perm)


@op("Reshape", static_args=(1,))
def reshape(ctx: OpContext, x, shape=None):
    dims = static_ints(shape if shape is not None else ctx.attr("shape"), "reshape")
    allowzero = bool(ctx.attr("allowzero", 0))
    in_shape = list(np.shape(x))
    out = []
    for i, d in enumerate(dims):
        if d == 0 and not allowzero:
            out.append(in_shape[i])
        else:
            out.append(d)
    if -1 in out:
        known = int(np.prod([d for d in out if d != -1])) or 1
        total = int(np.prod(in_shape)) if in_shape else 1
        out[out.index(-1)] = total // known
    return x.reshape(tuple(out))


@op("Unsqueeze", static_args=(1,))
def unsqueeze(ctx: OpContext, x, axes=None):
    ax = static_ints(axes if axes is not None else ctx.attr("axes"), "unsqueeze")
    out_rank = np.ndim(x) + len(ax)
    ax = sorted(a if a >= 0 else a + out_rank for a in ax)
    out = x
    for a in ax:
        out = np.expand_dims(out, a) if ctx.is_fold else out.unsqueeze(a)
    return out


@op("Squeeze", static_args=(1,))
def squeeze(ctx: OpContext, x, axes=None):
    ax = axes if axes is not None else ctx.attr("axes")
    if ax is None:
        return np.squeeze(x) if ctx.is_fold else x.squeeze()
    rank = np.ndim(x)
    ax = tuple(a if a >= 0 else a + rank for a in static_ints(ax, "squeeze"))
    return np.squeeze(x, axis=ax) if ctx.is_fold else x.squeeze(ax)


@op("Concat")
def concat(ctx: OpContext, *xs):
    axis = ctx.attr("axis", 0)
    xs = [x for x in xs if x is not None]
    if ctx.is_fold:
        return np.concatenate([np.asarray(x) for x in xs], axis=axis)
    return torch.cat(xs, dim=axis)


@op("Gather")
def gather(ctx: OpContext, x, indices):
    axis = ctx.attr("axis", 0)
    if ctx.is_fold:
        return np.take(x, np.asarray(indices, dtype=np.int64), axis=axis)
    rank = x.dim()
    axis = axis if axis >= 0 else axis + rank
    dim = x.shape[axis]
    idx = indices.to(torch.int64)
    idx = torch.where(idx < 0, idx + dim, idx)  # ONNX allows negative indices
    out = torch.index_select(x, axis, idx.reshape(-1))
    return out.reshape(tuple(x.shape[:axis]) + tuple(idx.shape)
                       + tuple(x.shape[axis + 1:]))


@op("Shape")
def shape_(ctx: OpContext, x):
    # always static: shapes are trace-time constants, even of device values
    s = list(np.shape(x)) if ctx.is_fold else list(x.shape)
    start = ctx.attr("start", 0) or 0
    end = ctx.attr("end")
    s = s[start:] if end is None else s[start:end]
    return np.asarray(s, dtype=np.int64)


@op("Cast")
def cast(ctx: OpContext, x):
    np_dt = DTYPE_MAP[int(ctx.attr("to"))]
    if ctx.is_fold:
        return np.asarray(x).astype(np_dt)
    return x.to(torch_dtype(np_dt))


def _slice_axis(x, ax: int, st: int, en, sp: int, fold: bool):
    sl = slice(st, en, sp)
    if fold or sp > 0:
        ix = [slice(None)] * (np.ndim(x) if fold else x.dim())
        ix[ax] = sl
        return x[tuple(ix)]
    # torch slicing takes no negative step: gather the rows instead
    idx = torch.arange(*sl.indices(x.shape[ax]), device=x.device)
    return torch.index_select(x, ax, idx)


@op("Slice", static_args=(1, 2, 3, 4))
def slice_(ctx: OpContext, x, starts=None, ends=None, axes=None, steps=None):
    if starts is None:  # opset < 10: attributes
        starts = ctx.attr_ints("starts")
        ends = ctx.attr_ints("ends")
        axes = ctx.attr_ints("axes")
    starts = static_ints(starts, "slice starts")
    ends = static_ints(ends, "slice ends")
    axes_l = static_ints(axes, "slice axes") if axes is not None else list(
        range(len(starts)))
    steps_l = static_ints(steps, "slice steps") if steps is not None else [1] * len(
        starts)
    rank = np.ndim(x)
    INT_MAX = 2**31 - 1
    out = x
    for st, en, ax, sp in zip(starts, ends, axes_l, steps_l):
        ax = ax if ax >= 0 else ax + rank
        # huge sentinels (i64 max / INT_MAX) mean "to the end"
        if en >= INT_MAX:
            en = None
        elif en <= -INT_MAX:
            en = None if sp < 0 else 0
        out = _slice_axis(out, ax, st, en, sp, ctx.is_fold)
    return out


@op("Split", static_args=(1,))
def split(ctx: OpContext, x, split_sizes=None):
    axis = ctx.attr("axis", 0)
    rank = np.ndim(x)
    axis = axis if axis >= 0 else axis + rank
    dim = np.shape(x)[axis]
    sizes = None
    if split_sizes is not None:
        sizes = static_ints(split_sizes, "split sizes")
    elif ctx.attr("split") is not None:
        sizes = ctx.attr_ints("split")
    if sizes is None:
        n = ctx.attr("num_outputs")
        if n is None:
            n = len(ctx.node.output) if ctx.node is not None else 2
        base = -(-dim // n)
        sizes = [base] * (n - 1) + [dim - base * (n - 1)]
    offsets = np.cumsum([0] + sizes)
    outs = []
    for i in range(len(sizes)):
        sl = [slice(None)] * rank
        sl[axis] = slice(int(offsets[i]), int(offsets[i + 1]))
        outs.append(x[tuple(sl)])
    return tuple(outs)


@op("Constant")
def constant(ctx: OpContext):
    for key in ("value", "value_float", "value_int", "value_ints", "value_floats"):
        v = ctx.attr(key)
        if v is not None:
            if key == "value":
                return v
            if key in ("value_int", "value_ints"):
                return np.asarray(v, np.int64)
            return np.asarray(v, np.float32)
    raise ValueError("Constant node without a value attribute")


@op("ConstantOfShape", static_args=(0,))
def constant_of_shape(ctx: OpContext, shape):
    dims = static_ints(shape, "ConstantOfShape")
    v = ctx.attr("value")
    if v is None:
        return np.zeros(dims, dtype=np.float32)
    v = np.asarray(v)
    return np.full(dims, v.reshape(-1)[0], dtype=v.dtype)


@op("Expand", static_args=(1,))
def expand(ctx: OpContext, x, shape):
    target = np.broadcast_shapes(tuple(np.shape(x)), tuple(static_ints(shape, "expand shape")))
    return np.broadcast_to(x, target) if ctx.is_fold else x.expand(target)


@op("Where")
def where(ctx: OpContext, cond, a, b):
    if ctx.is_fold:
        return np.where(np.asarray(cond).astype(bool), a, b)
    return torch.where(cond.to(torch.bool), a, b)
