"""Tensor-manipulation emitters (counterpart of lele_tpu/ops/tensor_ops.py):
shapes and layouts, gathers and scatters, Pad, Tile, TopK, ArgMax and
ArgMin, OneHot, Dropout, the Random ops, and the data-dependent-shape ops
(NonZero, Unique, Compress), which run on concrete values only, as the
JAX package's `_require_concrete` makes them; NonMaxSuppression is refused
on every input, as there.

Ties and duplicates take JAX's CPU order on both devices: TopK and
ArgMax/ArgMin the lower index first, ScatterND and ScatterElements without
a reduction the last update. The Random ops draw at trace time from a key
made as JAX's `_rng_key` makes it, so every call of a compiled model, a
captured one too, gives the same numbers.

Shape-carrying chains (Shape → Slice/Gather → Concat → Reshape) fold to
numpy at trace time, so every reshape below sees static shape arguments.
"""

from __future__ import annotations

import zlib

import numpy as np
import torch
import torch.nn.functional as F

from ..config import config
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


@op("Flatten")
def flatten(ctx: OpContext, x):
    shape = tuple(np.shape(x))
    axis = ctx.attr("axis", 1)
    axis = axis if axis >= 0 else axis + len(shape)
    dims = (int(np.prod(shape[:axis])), int(np.prod(shape[axis:])))
    return np.reshape(x, dims) if ctx.is_fold else x.reshape(dims)


@op("Size")
def size_(ctx: OpContext, x):
    # static, as Shape: the element count is a trace-time constant
    return np.asarray(int(np.prod(np.shape(x))), dtype=np.int64)


@op("CastLike")
def cast_like(ctx: OpContext, x, like):
    if ctx.is_fold:
        return np.asarray(x).astype(np.asarray(like).dtype)
    return x.to(like.dtype)


@op("Tile", static_args=(1,))
def tile(ctx: OpContext, x, repeats):
    reps = tuple(static_ints(repeats, "tile repeats"))
    return np.tile(x, reps) if ctx.is_fold else torch.tile(x, reps)


def _wrapped(idx: torch.Tensor, dim) -> torch.Tensor:
    """ONNX's negative indices counted from the end, as int64."""
    idx = idx.to(torch.int64)
    return torch.where(idx < 0, idx + dim, idx)


@op("GatherElements")
def gather_elements(ctx: OpContext, x, indices):
    axis = ctx.attr("axis", 0)
    if ctx.is_fold:
        return np.take_along_axis(x, np.asarray(indices, np.int64), axis=axis)
    axis = axis % x.dim()
    return torch.gather(x, axis, _wrapped(indices, x.shape[axis]))


@op("GatherND", foldable=False)
def gather_nd(ctx: OpContext, x, indices):
    """The last index axis addresses the data's axes after `batch_dims`
    shared leading ones."""
    b = int(ctx.attr("batch_dims", 0))
    k = indices.shape[-1]
    # one index column an addressed axis, each wrapped by its extent
    cols = [_wrapped(indices[..., i], x.shape[b + i]) for i in range(k)]
    if b == 0:
        return x[tuple(cols)]
    # the shared batch dims collapsed to one axis, indexed explicitly
    xb = x.reshape((-1,) + tuple(x.shape[b:]))
    cols = [c.reshape((-1,) + tuple(c.shape[b:])) for c in cols]
    lead = tuple(indices.shape[:-1])
    bidx = torch.arange(xb.shape[0], device=x.device).reshape(
        (-1,) + (1,) * (len(lead) - b))
    bidx = torch.broadcast_to(bidx, (xb.shape[0],) + lead[b:])
    out = xb[(bidx,) + tuple(cols)]
    return out.reshape(lead[:b] + tuple(out.shape[1:]))


def _pad_index(n: int, lo: int, hi: int, mode: str, device) -> torch.Tensor:
    """The source positions of a padded axis of extent n (lo before, hi
    after) in reflect, edge or wrap mode, made on the device."""
    j = torch.arange(-lo, n + hi, device=device)
    if mode == "edge" or n == 1:
        return j.clamp(0, n - 1)
    if mode == "wrap":
        return torch.remainder(j, n)
    period = 2 * (n - 1)  # reflect: ... 2 1 | 0 1 2 ... n-1 | n-2 ...
    m = torch.remainder(j, period)
    return torch.where(m >= n, period - m, m)


@op("Pad", static_args=(1, 3))
def pad(ctx: OpContext, x, pads=None, constant_value=None, axes=None):
    """constant, reflect, edge and wrap; pads as an input (opset >= 11) or
    attribute (with the fill in `value`), restricted to `axes`; negative
    pads crop first."""
    mode = ctx.attr("mode", "constant")
    if pads is None:
        plist = ctx.attr_ints("pads")
        if constant_value is None:  # opset < 11 carries the fill in an attribute
            constant_value = ctx.attr("value", None)
    else:
        plist = static_ints(pads, "pads")
    rank = np.ndim(x)
    if axes is not None:
        ax_l = static_ints(axes, "pad axes")
        full = [0] * (2 * rank)
        for i, a in enumerate(ax_l):
            a = a if a >= 0 else a + rank
            full[a] = plist[i]
            full[rank + a] = plist[len(ax_l) + i]
        plist = full
    pairs = [(plist[i], plist[i + rank]) for i in range(rank)]
    if any(p < 0 for pair in pairs for p in pair):
        shape = np.shape(x)
        x = x[tuple(slice(-b if b < 0 else 0, shape[i] + e if e < 0 else None)
                    for i, (b, e) in enumerate(pairs))]
        pairs = [(max(b, 0), max(e, 0)) for b, e in pairs]
    if ctx.is_fold:
        if mode == "constant":
            cv = 0 if constant_value is None else np.asarray(constant_value).item()
            return np.pad(x, pairs, mode="constant", constant_values=cv)
        return np.pad(x, pairs, mode=mode)
    if mode == "constant":
        flat = [p for lo_hi in reversed(pairs) for p in lo_hi]  # last dim first
        if constant_value is None:
            return F.pad(x, flat)
        if isinstance(constant_value, torch.Tensor):
            # a device fill: pad with zeros, then put the fill where they went
            inner = F.pad(torch.ones_like(x, dtype=torch.bool), flat)
            return torch.where(inner, F.pad(x, flat), constant_value.to(x.dtype))
        return F.pad(x, flat, value=np.asarray(constant_value).item())
    if mode not in ("reflect", "edge", "wrap"):
        raise NotImplementedError(f"Pad mode {mode!r}")
    for a, (lo, hi) in enumerate(pairs):
        if lo or hi:
            x = torch.index_select(x, a, _pad_index(x.shape[a], lo, hi, mode, x.device))
    return x


@op("TopK", foldable=False, static_args=(1,))
def topk(ctx: OpContext, x, k):
    """The k largest (or smallest) along `axis`, ties to the lower index as
    lax.top_k gives them: a stable sort, on both devices."""
    kk = static_ints(k, "topk k")[0]
    axis = ctx.attr("axis", -1) % x.dim()
    largest = bool(ctx.attr("largest", 1))
    vals, idx = torch.sort(x, dim=axis, descending=largest, stable=True)
    return vals.narrow(axis, 0, kk), idx.narrow(axis, 0, kk)


def _arg(ctx: OpContext, x, np_fn, torch_fn):
    """ArgMax / ArgMin: the first extreme index, or the last with
    select_last_index; int64."""
    axis = ctx.attr("axis", 0)
    keep = bool(ctx.attr("keepdims", 1))
    last = bool(ctx.attr("select_last_index", 0))
    if ctx.is_fold:
        axis = axis % max(np.ndim(x), 1)
        idx = np_fn(np.flip(x, axis=axis) if last else x, axis=axis)
        if last:
            idx = np.shape(x)[axis] - 1 - idx
        return (np.expand_dims(idx, axis) if keep else idx).astype(np.int64)
    axis = axis % max(x.dim(), 1)
    idx = torch_fn(torch.flip(x, dims=(axis,)) if last else x, dim=axis, keepdim=keep)
    return x.shape[axis] - 1 - idx if last else idx


@op("ArgMax")
def argmax(ctx: OpContext, x):
    return _arg(ctx, x, np.argmax, torch.argmax)


@op("ArgMin")
def argmin(ctx: OpContext, x):
    return _arg(ctx, x, np.argmin, torch.argmin)


@op("OneHot", static_args=(1,))
def onehot(ctx: OpContext, indices, depth, values):
    d = static_ints(depth, "onehot depth")[0]
    axis = ctx.attr("axis", -1)
    if ctx.is_fold:
        vals, idx = np.asarray(values), np.asarray(indices)
        idx = np.where(idx < 0, idx + d, idx)
        out = np.where(np.expand_dims(idx, -1) == np.arange(d), vals[1], vals[0])
    else:
        idx = torch.where(indices < 0, indices + d, indices)
        hot = idx.unsqueeze(-1) == torch.arange(d, device=idx.device)
        out = torch.where(hot, values[1], values[0])
    if axis != -1:
        axis = axis if axis >= 0 else axis + np.ndim(out)
        out = np.moveaxis(out, -1, axis) if ctx.is_fold else torch.movedim(out, -1, axis)
    return out


@op("DepthToSpace")
def depth_to_space(ctx: OpContext, x):
    b = ctx.attr("blocksize")
    n, c, h, w = np.shape(x)
    if ctx.attr("mode", "DCR") == "DCR":
        dims, perm = (n, b, b, c // (b * b), h, w), (0, 3, 4, 1, 5, 2)
    else:  # CRD
        dims, perm = (n, c // (b * b), b, b, h, w), (0, 1, 4, 2, 5, 3)
    out = (n, c // (b * b), h * b, w * b)
    if ctx.is_fold:
        return np.reshape(np.transpose(np.reshape(x, dims), perm), out)
    return x.reshape(dims).permute(perm).reshape(out)


@op("SpaceToDepth")
def space_to_depth(ctx: OpContext, x):
    b = ctx.attr("blocksize")
    n, c, h, w = np.shape(x)
    dims, perm = (n, c, h // b, b, w // b, b), (0, 3, 5, 1, 2, 4)
    out = (n, c * b * b, h // b, w // b)
    if ctx.is_fold:
        return np.reshape(np.transpose(np.reshape(x, dims), perm), out)
    return x.reshape(dims).permute(perm).reshape(out)


def _scatter(data: torch.Tensor, pos: torch.Tensor, upd: torch.Tensor,
             reduction: str) -> torch.Tensor:
    """data with upd put at the flat element positions pos (pos and upd of
    one shape). Without a reduction a position written twice takes the last
    update (JAX's CPU order): each position keeps the update of the highest
    rank, found by a scatter-max of the ranks, and the others go to a
    discarded slot, so the write is deterministic on a card too."""
    flat, pos, upd = data.reshape(-1), pos.reshape(-1), upd.reshape(-1).to(data.dtype)
    if reduction in ("add", "mul", "max", "min"):
        how = {"add": "sum", "mul": "prod", "max": "amax", "min": "amin"}[reduction]
        return flat.scatter_reduce(0, pos, upd, how, include_self=True).reshape(data.shape)
    if reduction != "none":
        raise NotImplementedError(f"scatter reduction {reduction!r}")
    n = flat.numel()
    rank = torch.arange(pos.numel(), device=pos.device)
    winner = torch.full((n,), -1, dtype=torch.int64, device=pos.device)
    winner = winner.scatter_reduce(0, pos, rank, "amax", include_self=True)
    pos = torch.where(winner.gather(0, pos) == rank, pos, n)
    out = torch.cat([flat, flat[:1]]).scatter(0, pos, upd)
    return out[:n].reshape(data.shape)


@op("ScatterND", foldable=False)
def scatter_nd(ctx: OpContext, data, indices, updates):
    """Each index row addresses a slice of data (its first k axes); every
    `reduction` of ONNX (none, add, mul, max, min)."""
    k = indices.shape[-1]
    row = torch.zeros(indices.shape[:-1], dtype=torch.int64, device=indices.device)
    for i in range(k):  # the row-major position of each addressed slice
        row = row * data.shape[i] + _wrapped(indices[..., i], data.shape[i])
    block = int(np.prod(data.shape[k:]))
    pos = row.unsqueeze(-1) * block + torch.arange(block, device=indices.device)
    return _scatter(data, pos.reshape(updates.shape), updates, ctx.attr("reduction", "none"))


@op("ScatterElements", foldable=False)
def scatter_elements(ctx: OpContext, data, indices, updates):
    axis = ctx.attr("axis", 0) % data.dim()
    idx = _wrapped(indices, data.shape[axis])
    pos = torch.zeros_like(idx)
    for a in range(data.dim()):
        coord = idx if a == axis else torch.arange(
            idx.shape[a], device=idx.device).reshape((-1,) + (1,) * (idx.dim() - a - 1))
        pos = pos * data.shape[a] + coord
    return _scatter(data, pos, updates, ctx.attr("reduction", "none"))


@op("ReduceSumSquare", static_args=(1,))
def reduce_sum_square(ctx: OpContext, x, axes=None):
    from .math_ops import _reduce

    return _reduce(ctx, ctx.xp.square(x), axes, np.sum, torch.sum)


@op("Dropout")
def dropout(ctx: OpContext, x, ratio=None, training_mode=None):
    """Inference dropout: the identity, and an all-true mask when asked."""
    if ctx.node is None or len(ctx.node.output) <= 1 or not ctx.node.output[1]:
        return x
    if ctx.is_fold:
        return x, np.ones(np.shape(x), dtype=bool)
    return x, torch.ones_like(x, dtype=torch.bool)


# -- Random ops ---------------------------------------------------------------


def rng_key(ctx: OpContext) -> int:
    """JAX's `_rng_key` (lele_tpu/ops/tensor_ops.py:430-448): an explicit
    `seed` attribute alone sets the stream (its float32 bits, so that +x and
    -x differ), else the crc32 of the node's tag (name, or first output),
    each folded into `config.rng_seed`, read while tracing, as JAX reads it."""
    node_seed = ctx.attr("seed") if ctx.node is not None else None
    if node_seed is not None:
        fold = int(np.float32(node_seed).view(np.uint32))
    else:
        tag = (ctx.node.name or ctx.node.output[0]) if ctx.node is not None else ""
        fold = zlib.crc32(tag.encode())
    return (int(config.rng_seed) << 32) | fold


def _random(ctx: OpContext, shape, dtype, normal: bool) -> np.ndarray:
    """A trace-time draw (the Random ops are `host` emitters: called once
    while tracing, never merged with another node's draw): a host constant,
    hoisted once, so every call (and every replay of a captured graph) gives
    the same numbers, as JAX's trace-time key does. Philox from numpy, not
    JAX's threefry: the streams hold the same properties (range, moments,
    one stream a seed), not the same bits."""
    gen = np.random.Generator(np.random.Philox(key=rng_key(ctx)))
    shape = tuple(int(d) for d in shape)
    if normal:
        v = ctx.attr("mean", 0.0) + ctx.attr("scale", 1.0) * gen.standard_normal(shape)
        return v.astype(dtype)
    lo, hi = ctx.attr("low", 0.0), ctx.attr("high", 1.0)
    v = (lo + (hi - lo) * gen.random(shape)).astype(dtype)
    return np.minimum(v, np.nextafter(np.asarray(hi, dtype), np.asarray(lo, dtype)))


def _random_dtype(ctx: OpContext, like=None) -> np.dtype:
    dt = ctx.attr("dtype")
    if dt is not None:
        return np.dtype(DTYPE_MAP[int(dt)])
    if like is None:
        return np.dtype(np.float32)
    return np.dtype(like.dtype) if isinstance(like, np.ndarray) else np.dtype(
        str(like.dtype).replace("torch.", ""))


@op("RandomNormal", foldable=False, host=True)
def random_normal(ctx: OpContext):
    return _random(ctx, ctx.attr_ints("shape"), _random_dtype(ctx), normal=True)


@op("RandomNormalLike", foldable=False, host=True)
def random_normal_like(ctx: OpContext, x):
    return _random(ctx, np.shape(x), _random_dtype(ctx, x), normal=True)


@op("RandomUniform", foldable=False, host=True)
def random_uniform(ctx: OpContext):
    return _random(ctx, ctx.attr_ints("shape"), _random_dtype(ctx), normal=False)


@op("RandomUniformLike", foldable=False, host=True)
def random_uniform_like(ctx: OpContext, x):
    return _random(ctx, np.shape(x), _random_dtype(ctx, x), normal=False)


# -- data-dependent output shapes ---------------------------------------------


def _require_concrete(op_name: str, v, what: str, hint: str) -> np.ndarray:
    """The output's shape follows the values: a trace-time value (a
    constant, or a constant subgraph the tracer folded) runs, a device
    value raises with the JAX package's hint (lele_tpu/ops/tensor_ops.py:
    536-548)."""
    if isinstance(v, torch.Tensor):
        raise NotImplementedError(
            f"{op_name} produces data-dependent output shapes, which a captured "
            f"program's static shapes cannot express for runtime inputs. {what} must "
            f"be trace-time static. {hint}")
    return np.asarray(v)


_NONZERO_HINT = ("Use a fixed-size mask (Where/Greater) or postprocess on "
                 "host; the model families here are NMS-free by design.")


@op("NonZero")
def nonzero(ctx: OpContext, x):
    x = _require_concrete("NonZero", x, "the input", _NONZERO_HINT)
    return np.stack(np.nonzero(x)).astype(np.int64).reshape(np.ndim(x), -1)


@op("Unique")
def unique(ctx: OpContext, x):
    x = _require_concrete("Unique", x, "the input", "Deduplicate on host after inference.")
    axis = ctx.attr("axis")
    if axis is not None:
        axis = int(axis) % max(x.ndim, 1)
    y, idx, inv, cnt = np.unique(x, return_index=True, return_inverse=True,
                                 return_counts=True, axis=axis)
    inv = inv.reshape(-1)
    if not int(ctx.attr("sorted", 1)):  # first-occurrence order
        order = np.argsort(idx, kind="stable")
        rank = np.empty_like(order)
        rank[order] = np.arange(order.size)
        y = y[order] if axis is None else np.take(y, order, axis=axis)
        idx, cnt, inv = idx[order], cnt[order], rank[inv]
    return y, idx.astype(np.int64), inv.astype(np.int64), cnt.astype(np.int64)


@op("Compress", foldable=False, static_args=(1,), records=True)
def compress(ctx: OpContext, data, condition):
    """The output's length is the condition's count of trues: static once
    the condition is, so a constant condition makes a plain gather over
    runtime data. Its index vector is a constant of the trace, held by the
    compiled model (an upload at every call would stop a capture)."""
    cond = _require_concrete("Compress", condition, "the condition",
                             "Select with a constant mask, or Where + fixed-size "
                             "postprocess.")
    idx = np.nonzero(cond.reshape(-1).astype(bool))[0]
    axis = ctx.attr("axis")
    extent = int(np.prod(np.shape(data))) if axis is None else int(np.shape(data)[int(axis)])
    if idx.size and int(idx.max()) >= extent:
        raise ValueError(f"Compress: condition marks index {int(idx.max())} but the "
                         f"compressed axis has extent {extent}")
    if ctx.state is None:  # on constants, once on the host
        return _compress(data, axis, torch.from_numpy(idx))
    index = ctx.state.to_device(f"{ctx.scope}{ctx.node.output[0]}/index", idx)
    return ctx.state.run(_compress, data, axis, index)


def _compress(data: torch.Tensor, axis, index: torch.Tensor) -> torch.Tensor:
    if axis is None:
        return torch.index_select(data.reshape(-1), 0, index)
    return torch.index_select(data, int(axis) % data.dim(), index)


_NMS_HINT = ("Use an NMS-free head (top-k + threshold, as YOLO26 does) or run "
             "NMS on host over the fixed-size candidate set.")


@op("NonMaxSuppression", foldable=False)
def non_max_suppression(ctx: OpContext, *args):
    """Refused on every input, as the JAX package refuses it: its count of
    kept boxes follows the values."""
    raise NotImplementedError(
        "NonMaxSuppression produces data-dependent output shapes, which a captured "
        f"program's static shapes cannot express for runtime inputs. {_NMS_HINT}")
