"""NN emitters (counterpart of lele_tpu/ops/nn_ops.py): Conv and
ConvTranspose over 1-3 spatial dims (cuDNN, TF32 off), the pools (MaxPool
with its Indices output, AveragePool, the global pools) on JAX's window
geometry, Resize and Upsample as JAX's per-axis gathers, the norms (Batch,
Instance, Group, MeanVariance, Lp, Layer, RMS), and the recurrent LSTM, GRU
and RNN."""

from __future__ import annotations

import functools
import itertools

import numpy as np
import torch
import torch.nn.functional as F

from ..config import cudnn_tf32
from ..utils.consts import real_tensors
from ..kernels.gru import gru_seq, gru_seq_plain
from ..kernels.gru import kernel_takes as gru_kernel_takes
from ..kernels.lstm import kernel_takes, lstm_seq, lstm_seq_plain
from .registry import OpContext, op, static_ints


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


def _flat_pads(pads) -> list[int]:
    return [p for lo_hi in reversed(pads) for p in lo_hi]  # F.pad: last dim first


_CONV_FNS = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


@op("Conv", foldable=False)
def conv(ctx: OpContext, x, w, b=None):
    """Convolution over 1-3 spatial dims, [N, C, *spatial] (grouped, strided,
    dilated, padded): the pads, asymmetric or SAME_*, are applied by F.pad
    first. cuDNN's TF32 is turned off for it (its default is on), so a card
    computes an f32 conv in full f32."""
    rank = x.dim() - 2
    if rank not in _CONV_FNS:
        raise NotImplementedError(f"Conv over {rank} spatial dims: the port has 1-3")
    kshape = ctx.attr_ints("kernel_shape", list(w.shape[2:]))
    strides = ctx.attr_ints("strides", [1] * rank)
    dilations = ctx.attr_ints("dilations", [1] * rank)
    group = ctx.attr("group", 1)
    pads = _resolve_pads(ctx, tuple(x.shape), kshape, strides, dilations)
    xp = F.pad(x, _flat_pads(pads))
    with torch.backends.cudnn.flags(enabled=torch.backends.cudnn.enabled,
                                    allow_tf32=cudnn_tf32()):
        out = _CONV_FNS[rank](xp, w.to(x.dtype), None, stride=strides,
                              dilation=dilations, groups=group)
    if b is not None:
        out = out + b.to(out.dtype).reshape((1, -1) + (1,) * rank)
    return out


def _conv_transpose_pads(ctx: OpContext, in_dims, kshape, strides, dilations,
                         out_pad) -> list[tuple[int, int]]:
    """(begin, end) pads of each spatial axis of a ConvTranspose, as
    lele_tpu/ops/nn_ops.py resolves them: `output_shape` overrides `pads`;
    SAME_* make the output input x stride."""
    rank = len(kshape)
    auto = ctx.attr("auto_pad", "NOTSET")
    out_shape = ctx.attr_ints("output_shape")
    pads = ctx.attr_ints("pads")
    res = []
    for i in range(rank):
        eff_k = (kshape[i] - 1) * dilations[i] + 1
        if out_shape is not None:
            total = max(0, strides[i] * (in_dims[i] - 1) + out_pad[i] + eff_k
                        - int(out_shape[-rank:][i]))
            half = total // 2
            res.append((total - half, half) if auto == "SAME_UPPER" else (half, total - half))
        elif pads is not None:
            res.append((pads[i], pads[rank + i]))
        elif auto in ("NOTSET", "", None, "VALID"):
            res.append((0, 0))
        else:
            total = max(0, eff_k - strides[i] + out_pad[i])
            half = total // 2
            res.append((half, total - half) if auto == "SAME_UPPER" else (total - half, half))
    return res


_CONV_T_FNS = {1: F.conv_transpose1d, 2: F.conv_transpose2d, 3: F.conv_transpose3d}


@op("ConvTranspose", foldable=False)
def conv_transpose(ctx: OpContext, x, w, b=None):
    """Transposed convolution over 1-3 spatial dims, [N, C_in, *spatial],
    ONNX weight [C_in, C_out/g, *k] (torch's own layout and semantics;
    groups, dilations): the full-size product, then each axis padded at its
    end by `output_padding` and cropped by the pads. cuDNN's TF32 is off."""
    rank = x.dim() - 2
    if rank not in _CONV_T_FNS:
        raise NotImplementedError(f"ConvTranspose over {rank} spatial dims: the port "
                                  "has 1-3")
    kshape = list(w.shape[2:])
    strides = ctx.attr_ints("strides", [1] * rank)
    dilations = ctx.attr_ints("dilations", [1] * rank)
    out_pad = ctx.attr_ints("output_padding", [0] * rank)
    pads = _conv_transpose_pads(ctx, list(x.shape[2:]), kshape, strides, dilations, out_pad)
    with torch.backends.cudnn.flags(enabled=torch.backends.cudnn.enabled,
                                    allow_tf32=cudnn_tf32()):
        full = _CONV_T_FNS[rank](x, w.to(x.dtype), None, stride=strides, dilation=dilations,
                                 groups=ctx.attr("group", 1))
    # F.pad's negative widths crop; last dim first
    out = F.pad(full, [v for (p0, p1), op_ in zip(reversed(pads), reversed(out_pad))
                       for v in (-p0, op_ - p1)])
    if b is not None:
        out = out + b.to(out.dtype).reshape((1, -1) + (1,) * rank)
    return out


# -- pooling -----------------------------------------------------------------


def _pool_geometry(ctx: OpContext, xshape):
    """kernel, strides, dilations and pads of the pooling family, as
    lele_tpu/ops/nn_ops.py:_pool_geometry: ceil_mode extends the tail pad
    so that the last partial window is included (a window may start in
    the pad, unlike torch's ceil_mode)."""
    rank = len(xshape) - 2
    kshape = ctx.attr_ints("kernel_shape")
    strides = ctx.attr_ints("strides", [1] * len(kshape))
    dilations = ctx.attr_ints("dilations", [1] * len(kshape))
    pads = _resolve_pads(ctx, xshape, kshape, strides, dilations)
    if ctx.attr("ceil_mode", 0):
        new_pads = []
        for i in range(rank):
            eff_k = (kshape[i] - 1) * dilations[i] + 1
            padded = xshape[2 + i] + pads[i][0] + pads[i][1]
            out_f = (padded - eff_k) / strides[i] + 1
            out_c = -(-(padded - eff_k) // strides[i]) + 1
            extra = (out_c - 1) * strides[i] + eff_k - padded if out_c > out_f else 0
            new_pads.append((pads[i][0], pads[i][1] + max(0, extra)))
        pads = new_pads
    return kshape, strides, dilations, pads


def _taps(xp: torch.Tensor, kshape, strides, dilations):
    """Each window offset's strided view of a padded input: the pooled
    output is a reduction over them."""
    rank = len(kshape)
    out = [(xp.shape[2 + i] - (kshape[i] - 1) * dilations[i] - 1) // strides[i] + 1
           for i in range(rank)]
    for offs in itertools.product(*(range(k) for k in kshape)):
        yield xp[(slice(None), slice(None)) + tuple(
            slice(o * d, o * d + (n - 1) * s + 1, s)
            for o, d, s, n in zip(offs, dilations, strides, out))]


_MAX_POOL_FNS = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}


@op("MaxPool", foldable=False)
def max_pool(ctx: OpContext, x):
    """The window maximum over an input padded with -inf (integer types
    through a float type that holds them exactly); the Indices output, when
    asked, is the first maximum of each window as a flat position in the
    whole [N, C, *spatial] tensor, row-major (storage_order 0) or with the
    spatial axes column-major (storage_order 1)."""
    rank = x.dim() - 2
    kshape, strides, dilations, pads = _pool_geometry(ctx, tuple(x.shape))
    wide = x if x.is_floating_point() else x.to(
        torch.float32 if x.element_size() <= 2 else torch.float64)
    xp = F.pad(wide, _flat_pads(pads), value=-float("inf"))
    want_idx = ctx.node is not None and len(ctx.node.output) > 1 and bool(ctx.node.output[1])
    res = _MAX_POOL_FNS[rank](xp, kshape, strides, 0, dilations, return_indices=want_idx)
    if not want_idx:
        return res.to(x.dtype)
    out, idx = res
    # the padded plane's flat index → each input coordinate → the flat
    # position ONNX counts over the whole tensor
    dims, pdims = list(x.shape[2:]), list(xp.shape[2:])
    order = range(rank) if not ctx.attr("storage_order", 0) else reversed(range(rank))
    coords = []
    for i in reversed(range(rank)):
        coords.append(idx % pdims[i] - pads[i][0])
        idx = idx // pdims[i]
    coords.reverse()
    flat = torch.zeros_like(coords[0])
    for i in order:
        flat = flat * dims[i] + coords[i]
    n, c = x.shape[:2]
    plane = (torch.arange(n, device=x.device).reshape((-1, 1) + (1,) * rank) * c
             + torch.arange(c, device=x.device).reshape((1, -1) + (1,) * rank))
    return out.to(x.dtype), plane * int(np.prod(dims)) + flat


@op("AveragePool", foldable=False)
def average_pool(ctx: OpContext, x):
    """The window sum over a zero-padded input, over the window's size
    (count_include_pad) or over its count of input elements."""
    kshape, strides, dilations, pads = _pool_geometry(ctx, tuple(x.shape))
    flat = _flat_pads(pads)
    total = sum(_taps(F.pad(x, flat), kshape, strides, dilations))
    if ctx.attr("count_include_pad", 0):
        return total / float(np.prod(kshape))
    ones = F.pad(torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype, device=x.device),
                 flat)
    return total / sum(_taps(ones, kshape, strides, dilations))


@op("GlobalAveragePool", foldable=False)
def global_average_pool(ctx: OpContext, x):
    return torch.mean(x, dim=tuple(range(2, x.dim())), keepdim=True)


@op("GlobalMaxPool", foldable=False)
def global_max_pool(ctx: OpContext, x):
    return torch.amax(x, dim=tuple(range(2, x.dim())), keepdim=True)


# -- Resize ------------------------------------------------------------------


def _coords(out_size: int, in_size: int, scale: float, mode: str, device,
            roi: tuple[float, float] = (0.0, 1.0)) -> torch.Tensor:
    """Each output position's source coordinate on one axis, f32, as JAX's
    lele_tpu/ops/nn_ops.py:_coords computes its four modes; ONNX's
    half_pixel_symmetric and tf_crop_and_resize (over `roi`'s start and end
    on this axis) besides."""
    x = torch.arange(out_size, dtype=torch.float32, device=device)
    if mode == "half_pixel":
        return (x + 0.5) / scale - 0.5
    if mode == "pytorch_half_pixel":
        return (x + 0.5) / scale - 0.5 if out_size > 1 else torch.zeros_like(x)
    if mode == "align_corners":
        if out_size == 1:
            return torch.zeros_like(x)
        return x * (in_size - 1) / (out_size - 1)
    if mode == "asymmetric":
        return x / scale
    if mode == "half_pixel_symmetric":
        adjust = out_size / (scale * in_size)
        return in_size / 2 * (1 - adjust) + (x + 0.5) / scale - 0.5
    if mode == "tf_crop_and_resize":
        lo, hi = roi
        if out_size == 1:
            return torch.full_like(x, 0.5 * (lo + hi) * (in_size - 1))
        return lo * (in_size - 1) + x * ((hi - lo) * (in_size - 1) / (out_size - 1))
    raise NotImplementedError(f"coordinate_transformation_mode {mode}")


def _cubic_weights(t: torch.Tensor, a: float) -> list[torch.Tensor]:
    """The cubic convolution weights of the four taps floor(c) - 1 .. + 2 at
    fraction t (ONNX's, with its `cubic_coeff_a`)."""
    def near(d):  # |d| <= 1
        return ((a + 2) * d - (a + 3)) * d * d + 1

    def far(d):  # 1 < |d| < 2
        return ((a * d - 5 * a) * d + 8 * a) * d - 4 * a

    return [far(t + 1), near(t), near(1 - t), far(2 - t)]


def _resize_axis(out: torch.Tensor, ax: int, c: torch.Tensor, n: int, ctx: OpContext,
                 mode: str) -> torch.Tensor:
    """Resample axis `ax` of `out` at source coordinates c."""
    shape = [1] * out.dim()
    shape[ax] = -1
    if mode == "nearest":
        nearest_mode = ctx.attr("nearest_mode", "round_prefer_floor")
        idx = {"round_prefer_floor": lambda: torch.ceil(c - 0.5),
               "round_prefer_ceil": lambda: torch.floor(c + 0.5),
               "floor": lambda: torch.floor(c)}.get(nearest_mode, lambda: torch.ceil(c))()
        return torch.index_select(out, ax, idx.clamp(0, n - 1).to(torch.int64))
    if mode == "linear":
        c = c.clamp(0.0, n - 1)
        lo = torch.floor(c).to(torch.int64)
        hi = torch.clamp(lo + 1, max=n - 1)
        w_hi = (c - lo).to(out.dtype).reshape(shape)
        return (torch.index_select(out, ax, lo) * (1 - w_hi)
                + torch.index_select(out, ax, hi) * w_hi)
    if mode == "cubic":
        base = torch.floor(c)
        taps = [base + k for k in (-1, 0, 1, 2)]
        ws = _cubic_weights(c - base, ctx.attr("cubic_coeff_a", -0.75))
        if ctx.attr("exclude_outside", 0):  # taps off the axis weigh 0, the rest renormalised
            ws = [torch.where((t >= 0) & (t <= n - 1), w, torch.zeros_like(w))
                  for t, w in zip(taps, ws)]
            total = sum(ws)
            ws = [w / total for w in ws]
        res = 0
        for t, w in zip(taps, ws):  # taps off the axis read its edge
            res = res + torch.index_select(out, ax, t.clamp(0, n - 1).to(torch.int64)) * (
                w.to(out.dtype).reshape(shape))
        return res
    raise NotImplementedError(f"Resize mode {mode}")


@op("Resize", foldable=False, static_args=(1, 2, 3))
def resize(ctx: OpContext, x, roi=None, scales=None, sizes=None):
    """ONNX Resize as JAX writes it, per resized axis: one gather (nearest,
    every nearest_mode) or two and a blend (linear) at the source
    coordinates of the coordinate_transformation_mode, from `sizes` or
    `scales`. Past JAX: cubic (four gathers; `cubic_coeff_a`,
    `exclude_outside`), half_pixel_symmetric, tf_crop_and_resize (`roi`, a
    trace-time value here, and `extrapolation_value` off the crop) and
    opset 18's `axes`."""
    mode = ctx.attr("mode", "nearest")
    ct_mode = ctx.attr("coordinate_transformation_mode", "half_pixel")
    if ctx.attr("antialias", 0) or ctx.attr("keep_aspect_ratio_policy", "stretch") != "stretch":
        raise NotImplementedError("Resize: antialias and keep_aspect_ratio_policy")
    in_shape = list(x.shape)
    rank = len(in_shape)
    axes = [a % rank for a in (ctx.attr_ints("axes") or range(rank))]
    scale_l = [1.0] * rank
    out_shape = list(in_shape)
    if sizes is not None and np.size(sizes):
        for a, v in zip(axes, static_ints(sizes, "resize sizes")):
            out_shape[a], scale_l[a] = v, v / in_shape[a]
    else:
        for a, v in zip(axes, np.asarray(scales).reshape(-1)):
            scale_l[a] = float(v)
            out_shape[a] = int(np.floor(in_shape[a] * scale_l[a]))
    rois = [(0.0, 1.0)] * rank
    if ct_mode == "tf_crop_and_resize":
        r = [float(v) for v in np.asarray(roi).reshape(-1)]
        for i, a in enumerate(axes):
            rois[a] = (r[i], r[len(axes) + i])
    out = x
    for ax in range(rank):
        if out_shape[ax] == in_shape[ax] and ct_mode != "tf_crop_and_resize":
            continue
        n = in_shape[ax]
        c = _coords(out_shape[ax], n, scale_l[ax], ct_mode, x.device, rois[ax])
        out = _resize_axis(out, ax, c, n, ctx, mode)
        if ct_mode == "tf_crop_and_resize":  # off the crop: the extrapolation value
            shape = [1] * out.dim()
            shape[ax] = -1
            off = ((c < 0) | (c > n - 1)).reshape(shape)
            out = torch.where(off, torch.full_like(out, ctx.attr("extrapolation_value", 0.0)),
                              out)
    return out


@op("Upsample", foldable=False, static_args=(1,))
def upsample(ctx: OpContext, x, scales=None):
    """Resize with `asymmetric` coordinates and `floor` rounding (opset 7-9)."""
    sc = scales if scales is not None else np.asarray(ctx.attr("scales"), np.float32)
    ctx.attrs.setdefault("coordinate_transformation_mode", "asymmetric")
    ctx.attrs.setdefault("nearest_mode", "floor")
    return resize(ctx, x, None, sc, None)


# -- normalization -----------------------------------------------------------


def _channel(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A per-channel vector shaped to broadcast over [N, C, *spatial]."""
    return v.to(x.dtype).reshape((1, -1) + (1,) * (x.dim() - 2))


@op("BatchNormalization", foldable=False)
def batch_norm(ctx: OpContext, x, scale, b, mean, var):
    """Inference form, JAX's arithmetic: (x - mean) * (scale / sqrt(var +
    eps)) + b."""
    inv = torch.pow(var.to(x.dtype) + ctx.attr("epsilon", 1e-5), -0.5)
    return (x - _channel(mean, x)) * _channel(scale.to(x.dtype) * inv, x) + _channel(b, x)


def _normalize(x: torch.Tensor, dims, eps: float) -> torch.Tensor:
    mean = torch.mean(x, dim=dims, keepdim=True)
    var = torch.var(x, dim=dims, keepdim=True, correction=0)
    return (x - mean) / torch.sqrt(var + eps)


@op("InstanceNormalization", foldable=False)
def instance_norm(ctx: OpContext, x, scale, b):
    y = _normalize(x, tuple(range(2, x.dim())), ctx.attr("epsilon", 1e-5))
    return y * _channel(scale, x) + _channel(b, x)


@op("GroupNormalization", foldable=False)
def group_norm(ctx: OpContext, x, scale, b):
    """num_groups groups of channels, each normalised over its channels and
    the spatial axes; scale and bias per channel (opset 21's form, which
    JAX's emitter applies at every opset)."""
    g = ctx.attr("num_groups")
    n, c = x.shape[:2]
    xg = x.reshape((n, g, c // g) + tuple(x.shape[2:]))
    y = _normalize(xg, tuple(range(2, xg.dim())), ctx.attr("epsilon", 1e-5))
    return y.reshape(x.shape) * _channel(scale, x) + _channel(b, x)


@op("MeanVarianceNormalization", foldable=False)
def mvn(ctx: OpContext, x):
    return _normalize(x, tuple(ctx.attr_ints("axes", [0, 2, 3])), 1e-9)


@op("LpNormalization", foldable=False)
def lp_norm(ctx: OpContext, x):
    axis = ctx.attr("axis", -1)
    if ctx.attr("p", 2) == 1:
        return x / torch.sum(torch.abs(x), dim=axis, keepdim=True)
    return x / torch.sqrt(torch.sum(torch.square(x), dim=axis, keepdim=True))


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


@op("RMSNormalization", foldable=False)
def rms_norm(ctx: OpContext, x, scale):
    """x / sqrt(mean(x^2) + eps) * scale over the one `axis` JAX's emitter
    reduces (lele_tpu/ops/nn_ops.py:449-456)."""
    axis = ctx.attr("axis", -1)
    eps = ctx.attr("epsilon", 1e-5)
    ms = torch.mean(torch.square(x), dim=axis, keepdim=True)
    return x / torch.sqrt(ms + eps) * scale



# -- recurrent ---------------------------------------------------------------

# LSTM and GRU directions run, by route: "lstm_seq" or "gru_seq" (the kernel
# on a card, its plain version on the CPU) or "loop" (the masked loop in
# plain PyTorch)
RNN_ROUTES = {"lstm_seq": 0, "gru_seq": 0, "loop": 0}


def _static(v) -> bool:
    return isinstance(v, (np.ndarray, np.generic))


def _on(x: torch.Tensor, v):
    """A host value as a tensor on x's device (None and tensors pass)."""
    return torch.from_numpy(np.array(v)).to(x.device) if _static(v) else v


def _kernel_gate_order(hidden: int) -> np.ndarray:
    """Gate columns in ONNX's order i, o, f, c, taken in the kernel's order
    i, f, g (= c), o."""
    H = hidden
    return np.concatenate([np.arange(0, H), np.arange(2 * H, 4 * H), np.arange(H, 2 * H)])


@functools.lru_cache(maxsize=16)
def _gate_order_on(hidden: int, device: torch.device) -> torch.Tensor:
    """`_kernel_gate_order` on `device`, made once: a host-made index at every
    call would be an upload, which a captured CUDA graph refuses."""
    with real_tensors():
        return torch.from_numpy(_kernel_gate_order(hidden)).to(device)


def _take(a, perm: np.ndarray, axis: int, hidden: int):
    """a's gate columns in the kernel's order (perm = `_kernel_gate_order(
    hidden)`)."""
    if isinstance(a, torch.Tensor):
        return a.index_select(axis, _gate_order_on(hidden, a.device))
    return np.take(np.asarray(a), perm, axis=axis)


def _lstm_weights(w, r, b, hidden: int):
    """ONNX W [D, 4H, I], R [D, 4H, H], B [D, 8H] (gates i, o, f, c) → the
    kernel's layout and gate order i, f, g, o: Wx [D, I, 4H], Rh [D, H, 4H]
    and bias Wb + Rb [D, 4H] (None without B). numpy for static weights, so
    the tracer runs it once and hoists the results; torch for device ones."""
    perm = _kernel_gate_order(hidden)

    def cols_last(a):
        a = _take(a, perm, 1, hidden)
        if isinstance(a, torch.Tensor):
            return a.transpose(1, 2).contiguous()
        return np.ascontiguousarray(a.transpose(0, 2, 1))

    bias = None
    if b is not None:
        bias = _take(b[:, :4 * hidden] + b[:, 4 * hidden:], perm, 1, hidden)
    return cols_last(w), cols_last(r), bias


def _directions(direction: str):
    if direction == "bidirectional":
        return [False, True]
    return [direction == "reverse"]


def _ragged_lens(seq_lens, S: int):
    """sequence_lens: None when absent or statically full-length; else the
    int lengths [B] (host or device)."""
    if seq_lens is None:
        return None
    if _static(seq_lens):
        arr = np.asarray(seq_lens)
        if arr.size and np.all(arr == S):
            return None
        return arr.astype(np.int64)
    return seq_lens


def _seq_reverse(x: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Per-batch time reversal of x [S, B, ...] within each valid region
    [0, lens[b]); rows past the length keep their place."""
    t = torch.arange(x.shape[0], device=x.device)[:, None]
    L = lens.to(device=x.device, dtype=torch.int64)[None, :]
    src = torch.where(t < L, L - 1 - t, t)
    idx = src.reshape(src.shape + (1,) * (x.dim() - 2)).expand(x.shape)
    return torch.gather(x, 0, idx)


def _seq_mask(lens: torch.Tensor, S: int, device) -> torch.Tensor:
    """[S, B, 1] bool validity mask (t < lens[b])."""
    t = torch.arange(S, device=device)[:, None]
    return (t < lens.to(device=device, dtype=torch.int64)[None, :])[..., None]


def _lstm_loop(xproj, rh, h0, c0, hidden: int, p, msk):
    """The recurrence as a loop in plain PyTorch, gates in the kernel's order,
    with peepholes p = [Pi, Po, Pf] (i and f see c_{t-1}, o sees c_t) and a
    ragged mask: rows past a length are zero and the state holds."""
    H = hidden
    pi = po = pf = None
    if p is not None:
        pi, po, pf = p[:H], p[H:2 * H], p[2 * H:]
    h, c = h0, c0
    ys = []
    for t in range(xproj.shape[0]):
        g = xproj[t] + h @ rh
        gi, gf, go = g[:, :H], g[:, H:2 * H], g[:, 3 * H:]
        if pi is not None:
            gi = gi + pi * c
            gf = gf + pf * c
        c_new = torch.sigmoid(gf) * c + torch.sigmoid(gi) * torch.tanh(g[:, 2 * H:3 * H])
        if po is not None:
            go = go + po * c_new
        h_new = torch.sigmoid(go) * torch.tanh(c_new)
        if msk is None:
            h, c = h_new, c_new
            ys.append(h_new)
        else:
            m = msk[t]
            h, c = torch.where(m, h_new, h), torch.where(m, c_new, c)
            ys.append(torch.where(m, h_new, torch.zeros_like(h_new)))
    return torch.stack(ys), h, c


def _lstm_run(x, wx, rh, bias, lens, init_h, init_c, p, *, hidden: int, direction: str,
              layout: int, seq):
    """ONNX LSTM on prepared weights (`_lstm_weights`); `seq` is `lstm_seq`
    or its plain version. A direction without peepholes or ragged lengths
    takes `seq` where the kernel's range has H (on the CPU always); the rest
    takes the masked loop. Reverse directions are flipped around it."""
    wx, rh, bias, lens, init_h, init_c, p = (
        _on(x, v) for v in (wx, rh, bias, lens, init_h, init_c, p))
    if layout == 1:  # [B, S, I] → [S, B, I]; states [B, D, H] → [D, B, H]
        x = x.transpose(0, 1)
        init_h = None if init_h is None else init_h.transpose(0, 1)
        init_c = None if init_c is None else init_c.transpose(0, 1)
    S, B = x.shape[0], x.shape[1]
    msk = _seq_mask(lens, S, x.device) if lens is not None else None
    outs, h_outs, c_outs = [], [], []
    for d, rev in enumerate(_directions(direction)):
        xs = x
        if rev:
            xs = _seq_reverse(x, lens) if lens is not None else x.flip(0)
        xproj = xs @ wx[d]  # the input projection for all steps: [S, B, 4H]
        if bias is not None:
            xproj = xproj + bias[d]
        zeros = torch.zeros((B, hidden), dtype=x.dtype, device=x.device)
        h0 = zeros if init_h is None else init_h[d]
        c0 = zeros if init_c is None else init_c[d]
        if p is None and lens is None and (not x.is_cuda or kernel_takes(hidden)):
            RNN_ROUTES["lstm_seq"] += 1
            hs, h_f, c_f = seq(xproj, rh[d], h0, c0)
        else:
            RNN_ROUTES["loop"] += 1
            hs, h_f, c_f = _lstm_loop(xproj, rh[d], h0, c0, hidden,
                                      None if p is None else p[d], msk)
        if rev:
            hs = _seq_reverse(hs, lens) if lens is not None else hs.flip(0)
        outs.append(hs)
        h_outs.append(h_f)
        c_outs.append(c_f)
    y = torch.stack(outs, dim=1)  # [S, D, B, H]
    y_h, y_c = torch.stack(h_outs), torch.stack(c_outs)
    if layout == 1:
        return y.permute(2, 0, 1, 3), y_h.transpose(0, 1), y_c.transpose(0, 1)
    return y, y_h, y_c


def _lstm_args(ctx: OpContext, x, r, seq_lens):
    hidden = ctx.attr("hidden_size", np.shape(r)[-1])
    layout = ctx.attr("layout", 0)
    S = x.shape[1] if layout == 1 else x.shape[0]
    run = functools.partial(_lstm_run, hidden=hidden, layout=layout,
                            direction=ctx.attr("direction", "forward"))
    return hidden, _ragged_lens(seq_lens, S), run


@op("LSTM", foldable=False, static_args=(1, 2, 3, 4, 7), records=True)
def lstm(ctx: OpContext, x, w, r, b=None, seq_lens=None, init_h=None, init_c=None, p=None):
    """ONNX LSTM (gates i, o, f, c): forward, reverse and bidirectional,
    layout 0 and 1, initial states, peepholes, ragged sequence_lens (rows
    past a length are zero; Y_h and Y_c hold the last valid step).

    The input projection of all steps is one product; the recurrence of a
    direction without peepholes or ragged lengths is one launch of the
    `lstm_seq` kernel (on the card, for 1 <= H <= 1024, the kernel's stated
    range; the plain version on the CPU), as the JAX emitter takes its Pallas
    kernel; the rest run the masked loop (`RNN_ROUTES` counts both). Static
    W, R and B are put in the kernel's gate order and layout once, at trace
    time, and hoisted as such; only the recurrence is recorded."""
    hidden, lens, run = _lstm_args(ctx, x, r, seq_lens)
    run = functools.partial(run, seq=lstm_seq)
    st = ctx.state
    if st is None:
        return run(x, *_lstm_weights(w, r, b, hidden), lens, init_h, init_c, p)
    def name(k: int) -> str:
        return ctx.scope + ctx.node.input[k]

    prepared = st.run(_lstm_weights, w, r, b, hidden)
    wx, rh, bias = (st.to_device(f"{name(k)}#lstm_{tag}", v) if _static(v) else v
                    for k, tag, v in zip((1, 2, 3), ("wx", "rh", "bias"), prepared))
    if _static(lens):
        lens = st.to_device(name(4), lens)
    if _static(p):
        p = st.to_device(name(7), p)
    return st.run(run, x, wx, rh, bias, lens, init_h, init_c, p)


def lstm_plain(ctx: OpContext, x, w, r, b=None, seq_lens=None, init_h=None, init_c=None,
               p=None):
    """The LSTM emitter with `lstm_seq_plain` in place of the kernel, its
    weights prepared at every call: an override
    (`overrides={"LSTM": lstm_plain}`) that compiles a graph's plain oracle
    for the card."""
    hidden, lens, run = _lstm_args(ctx, x, r, seq_lens)
    return run(x, *_lstm_weights(w, r, b, hidden), lens, init_h, init_c, p,
               seq=lstm_seq_plain)


# -- GRU and RNN ----------------------------------------------------------------


def _gru_weights(w, r, b, hidden: int):
    """ONNX W [D, 3H, I], R [D, 3H, H], B [D, 6H] (gates z, r, h, the kernel's
    order too) → Wx [D, I, 3H], Rh [D, H, 3H] (R transposed), Wb [D, 3H]
    (None without B) and Rb [D, 3H] (zeros without B, as the JAX emitter
    hands the kernel, lele_tpu/ops/nn_ops.py:738-740). numpy for static
    weights, so the tracer runs it once and hoists the results; torch for
    device ones."""
    def cols_last(a):
        if isinstance(a, torch.Tensor):
            return a.transpose(1, 2).contiguous()
        return np.ascontiguousarray(np.asarray(a).transpose(0, 2, 1))

    if b is None:
        wb = None
        shape = (np.shape(r)[0], 3 * hidden)
        rb = (torch.zeros(shape, dtype=r.dtype, device=r.device) if isinstance(r, torch.Tensor)
              else np.zeros(shape, np.asarray(r).dtype))
    else:
        wb, rb = b[:, :3 * hidden], b[:, 3 * hidden:]
        if not isinstance(b, torch.Tensor):
            wb, rb = np.ascontiguousarray(wb), np.ascontiguousarray(rb)
    return cols_last(w), cols_last(r), wb, rb


def _gru_loop(xproj, rh, rb, h0, hidden: int, lbr: bool, msk):
    """The GRU recurrence as a loop in plain PyTorch, the JAX emitter's scan
    (lele_tpu/ops/nn_ops.py:753-776), with a ragged mask: rows past a length
    are zero and the state holds."""
    H = hidden
    h = h0
    ys = []
    for t in range(xproj.shape[0]):
        xp = xproj[t]
        gzr = xp[:, :2 * H] + h @ rh[:, :2 * H] + rb[:2 * H]
        z = torch.sigmoid(gzr[:, :H])
        rr = torch.sigmoid(gzr[:, H:])
        if lbr:
            g_h = xp[:, 2 * H:] + rr * (h @ rh[:, 2 * H:] + rb[2 * H:])
        else:
            g_h = xp[:, 2 * H:] + (rr * h) @ rh[:, 2 * H:] + rb[2 * H:]
        h_new = (1 - z) * torch.tanh(g_h) + z * h
        if msk is None:
            h = h_new
            ys.append(h_new)
        else:
            m = msk[t]
            h = torch.where(m, h_new, h)
            ys.append(torch.where(m, h_new, torch.zeros_like(h_new)))
    return torch.stack(ys), h


def _gru_run(x, wx, rh, wb, rb, lens, init_h, *, hidden: int, direction: str, layout: int,
             lbr: bool, seq):
    """ONNX GRU on prepared weights (`_gru_weights`); `seq` is `gru_seq` or
    its plain version. A direction without ragged lengths takes `seq` where
    the kernel's range has H (on the CPU always); a ragged one the masked
    loop. Reverse directions are flipped around it."""
    wx, rh, wb, rb, lens, init_h = (_on(x, v) for v in (wx, rh, wb, rb, lens, init_h))
    if layout == 1:  # [B, S, I] → [S, B, I]; states [B, D, H] → [D, B, H]
        x = x.transpose(0, 1)
        init_h = None if init_h is None else init_h.transpose(0, 1)
    S, B = x.shape[0], x.shape[1]
    msk = _seq_mask(lens, S, x.device) if lens is not None else None
    outs, h_outs = [], []
    for d, rev in enumerate(_directions(direction)):
        xs = x
        if rev:
            xs = _seq_reverse(x, lens) if lens is not None else x.flip(0)
        xproj = xs @ wx[d].to(x.dtype)  # the input projection for all steps: [S, B, 3H]
        if wb is not None:
            xproj = xproj + wb[d].to(x.dtype)
        h0 = (torch.zeros((B, hidden), dtype=x.dtype, device=x.device) if init_h is None
              else init_h[d])
        if lens is None and (not x.is_cuda or gru_kernel_takes(hidden)):
            RNN_ROUTES["gru_seq"] += 1
            hs, h_f = seq(xproj, rh[d], rb[d], h0, lbr)
        else:
            RNN_ROUTES["loop"] += 1
            hs, h_f = _gru_loop(xproj, rh[d].to(x.dtype), rb[d].to(x.dtype), h0, hidden, lbr,
                                msk)
        if rev:
            hs = _seq_reverse(hs, lens) if lens is not None else hs.flip(0)
        outs.append(hs)
        h_outs.append(h_f)
    y = torch.stack(outs, dim=1)  # [S, D, B, H]
    y_h = torch.stack(h_outs)
    if layout == 1:
        return y.permute(2, 0, 1, 3), y_h.transpose(0, 1)
    return y, y_h


def _gru_args(ctx: OpContext, x, r, seq_lens):
    hidden = ctx.attr("hidden_size", np.shape(r)[-1])
    layout = ctx.attr("layout", 0)
    S = x.shape[1] if layout == 1 else x.shape[0]
    run = functools.partial(_gru_run, hidden=hidden, layout=layout,
                            direction=ctx.attr("direction", "forward"),
                            lbr=bool(ctx.attr("linear_before_reset", 0)))
    return hidden, _ragged_lens(seq_lens, S), run


@op("GRU", foldable=False, static_args=(1, 2, 3, 4), records=True)
def gru(ctx: OpContext, x, w, r, b=None, seq_lens=None, init_h=None):
    """ONNX GRU (gates z, r, h): forward, reverse and bidirectional, layout 0
    and 1, an initial state, bias present or absent, both
    `linear_before_reset` forms, ragged sequence_lens (rows past a length are
    zero; Y_h holds the last valid step). As the JAX emitter, it ignores the
    `activations` and `clip` attributes (lele_tpu/ops/nn_ops.py:700-789).

    The input projection of all steps is one product; the recurrence of a
    direction without ragged lengths is one launch of the `gru_seq` kernel
    (on the card, where its range has H; the plain version on the CPU), as
    the JAX emitter takes its Pallas kernel; ragged directions run the masked
    loop (`RNN_ROUTES` counts both). Static W, R and B are laid out once, at
    trace time (R transposed to [H, 3H]), and hoisted as such; only the
    recurrence is recorded."""
    hidden, lens, run = _gru_args(ctx, x, r, seq_lens)
    run = functools.partial(run, seq=gru_seq)
    st = ctx.state
    if st is None:
        return run(x, *_gru_weights(w, r, b, hidden), lens, init_h)

    def name(k: int) -> str:
        return ctx.scope + ctx.node.input[k]

    prepared = st.run(_gru_weights, w, r, b, hidden)
    keys = ((1, "wx"), (2, "rh"), (3, "wb"), (2 if b is None else 3, "rb"))
    wx, rh, wb, rb = (st.to_device(f"{name(k)}#gru_{tag}", v) if _static(v) else v
                      for (k, tag), v in zip(keys, prepared))
    if _static(lens):
        lens = st.to_device(name(4), lens)
    return st.run(run, x, wx, rh, wb, rb, lens, init_h)


def gru_plain(ctx: OpContext, x, w, r, b=None, seq_lens=None, init_h=None):
    """The GRU emitter with `gru_seq_plain` in place of the kernel, its
    weights prepared at every call: an override (`overrides={"GRU":
    gru_plain}`) that compiles a graph's plain oracle for the card."""
    hidden, lens, run = _gru_args(ctx, x, r, seq_lens)
    return run(x, *_gru_weights(w, r, b, hidden), lens, init_h, seq=gru_seq_plain)


_RNN_ACTS = {"Tanh": torch.tanh, "Relu": torch.relu, "Sigmoid": torch.sigmoid}


@op("RNN", foldable=False, static_args=(4,))
def rnn_op(ctx: OpContext, x, w, r, b=None, seq_lens=None, init_h=None):
    """ONNX vanilla (Elman) RNN, the JAX emitter's loop (lele_tpu/ops/
    nn_ops.py:642-697): forward, reverse and bidirectional, layout 0 and 1,
    per-direction `activations` (Tanh, Relu, Sigmoid), ragged sequence_lens.
    It has no kernel."""
    hidden = ctx.attr("hidden_size", np.shape(r)[-1])
    layout = ctx.attr("layout", 0)
    acts = ctx.attr("activations", None) or ["Tanh"] * 2
    if layout == 1:
        x = x.transpose(0, 1)
        init_h = None if init_h is None else init_h.transpose(0, 1)
    S, B = x.shape[0], x.shape[1]
    lens = _on(x, _ragged_lens(seq_lens, S))
    msk = _seq_mask(lens, S, x.device) if lens is not None else None
    outs, h_outs = [], []
    for d, rev in enumerate(_directions(ctx.attr("direction", "forward"))):
        act = _RNN_ACTS[acts[d] if d < len(acts) else acts[0]]
        wd, rd = w[d].to(x.dtype), r[d].to(x.dtype)  # [H, I], [H, H]
        h = (torch.zeros((B, hidden), dtype=x.dtype, device=x.device) if init_h is None
             else init_h[d])
        xs = x
        if rev:
            xs = _seq_reverse(x, lens) if lens is not None else x.flip(0)
        xproj = xs @ wd.T
        if b is not None:
            xproj = xproj + (b[d, :hidden] + b[d, hidden:]).to(x.dtype)
        ys = []
        for t in range(S):
            h_new = act(xproj[t] + h @ rd.T)
            if msk is None:
                h = h_new
                ys.append(h_new)
            else:
                h = torch.where(msk[t], h_new, h)
                ys.append(torch.where(msk[t], h_new, torch.zeros_like(h_new)))
        hs = torch.stack(ys)
        if rev:
            hs = _seq_reverse(hs, lens) if lens is not None else hs.flip(0)
        outs.append(hs)
        h_outs.append(h)
    y = torch.stack(outs, dim=1)
    y_h = torch.stack(h_outs)
    if layout == 1:
        return y.permute(2, 0, 1, 3), y_h.transpose(0, 1)
    return y, y_h
