"""The long-tail ai.onnx emitters (counterpart of lele_tpu/ops/extra_ops.py):
the inverse hyperbolics and bitwise ops, Shrink, Hardmax, EyeLike, Det,
ReduceLogSum, LRN and the Lp pools, ReverseSequence, the spectral ops (the
three cosine windows, MelWeightMatrix, DFT), Bernoulli and Multinomial, the
two losses, CenterCropPad, Col2Im, MaxUnpool, the sampling ops (GridSample,
RoiAlign, MaxRoiPool), the deprecated Scatter, and the sequence and optional
values.

Each computes what JAX's emitter computes, with its attributes, defaults
and refusals: numpy when the tracer folds a node, torch on the device. The
windows and MelWeightMatrix fold on the host in float64 and are cast, as
JAX folds them. DFT is `torch.fft` (cuFFT on a card: the tracer's walk runs
it once, so its plan exists before a capture). Where an emitter needs a
host-built index (Col2Im, the Random ops' draws), it is a recording emitter
that hoists the array once through `ctx.state.to_device`, so the compiled
model owns it and a call uploads nothing.

The Random ops (Bernoulli, Multinomial) draw their uniforms once while
tracing, from numpy's Philox on `tensor_ops.rng_key` (as RandomUniform
does); on the device Bernoulli compares them with the probabilities and
Multinomial inverts the softmax's CDF at them, so every call, captured or
not, gives the same numbers. They hold the properties JAX's tests assert,
not threefry's bits.

RoiAlign keeps JAX's departure from the spec: `sampling_ratio=0` is a fixed
grid of 2 samples a bin side, not the adaptive grid. GridSample takes 4-D
input and refuses the cubic mode, as JAX does. MaxRoiPool is one masked
maximum over every ROI at once over the whole plane (a static window).

ONNX sequences and optionals are trace-time structure, as in the JAX
package: a sequence is a host list of values (`TensorSeq`) whose length is
fixed while tracing, an optional a host wrapper (`OptionalVal`) that holds a
value or nothing. The ops that only restructure them (Optional,
OptionalHasElement, OptionalGetElement, SequenceEmpty, SequenceConstruct,
SequenceLength, SequenceAt, SequenceInsert, SequenceErase) are `host`
emitters: they run once while tracing and record no device step, and
SequenceLength and OptionalHasElement give static values. SplitToSequence
and ConcatFromSequence compute on the device: one recorded step each.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..onnx.loader import DTYPE_MAP
from .math_ops import _reduce
from .nn_ops import _flat_pads, _pool_geometry, _seq_reverse, _taps
from .registry import OpContext, host_const, op, run_step, static_ints
from .tensor_ops import rng_key, scatter_elements, torch_dtype


def _dtype(ctx: OpContext, code, like=None):
    """ONNX type `code` as numpy's (folding) or torch's (on the device); the
    type of `like` where the attribute is absent."""
    if code is None:
        return like.dtype
    dt = np.dtype(DTYPE_MAP[int(code)])
    return dt if ctx.is_fold else torch_dtype(dt)


# -- elementwise ------------------------------------------------------------------


@op("Acosh")
def acosh(ctx: OpContext, x):
    return ctx.xp.arccosh(x)


@op("Asinh")
def asinh(ctx: OpContext, x):
    return ctx.xp.arcsinh(x)


@op("Atanh")
def atanh(ctx: OpContext, x):
    return ctx.xp.arctanh(x)


@op("BitShift")
def bit_shift(ctx: OpContext, x, y):
    left = ctx.attr("direction", "LEFT") == "LEFT"
    if ctx.is_fold:
        return np.left_shift(x, y) if left else np.right_shift(x, y)
    return torch.bitwise_left_shift(x, y) if left else torch.bitwise_right_shift(x, y)


@op("BitwiseAnd")
def bitwise_and(ctx: OpContext, x, y):
    return ctx.xp.bitwise_and(x, y)


@op("BitwiseOr")
def bitwise_or(ctx: OpContext, x, y):
    return ctx.xp.bitwise_or(x, y)


@op("BitwiseXor")
def bitwise_xor(ctx: OpContext, x, y):
    return ctx.xp.bitwise_xor(x, y)


@op("BitwiseNot")
def bitwise_not(ctx: OpContext, x):
    return np.invert(x) if ctx.is_fold else torch.bitwise_not(x)


@op("Shrink")
def shrink(ctx: OpContext, x):
    lambd = ctx.attr("lambd", 0.5)
    bias = ctx.attr("bias", 0.0)
    if ctx.is_fold:
        x = np.asarray(x)
        return np.where(x < -lambd, x + bias, np.where(x > lambd, x - bias, 0.0)).astype(x.dtype)
    out = torch.where(x < -lambd, x + bias, torch.where(x > lambd, x - bias, 0.0))
    return out.to(x.dtype)


def _one_hot(ctx: OpContext, idx, n: int, dtype):
    """One-hot rows of `idx` on a new last axis of n."""
    if ctx.is_fold:
        return np.eye(n, dtype=dtype)[idx]
    return F.one_hot(idx, n).to(dtype)


@op("Hardmax")
def hardmax(ctx: OpContext, x):
    """One at the first maximum along `axis` (opset 13), or of each row of
    the input flattened to 2-D at `axis` (before 13)."""
    xp = ctx.xp
    axis = ctx.attr("axis", -1 if ctx.opset >= 13 else 1)
    shape = tuple(np.shape(x))
    if ctx.opset < 13:
        axis = axis if axis >= 0 else axis + len(shape)
        lead = int(np.prod(shape[:axis], dtype=np.int64)) if axis else 1
        flat = xp.reshape(x, (lead, -1))
        idx = flat.argmax(-1) if not ctx.is_fold else np.argmax(flat, axis=-1)
        return xp.reshape(_one_hot(ctx, idx, np.shape(flat)[-1], x.dtype), shape)
    axis = axis % len(shape)
    idx = np.argmax(x, axis=axis) if ctx.is_fold else torch.argmax(x, dim=axis)
    out = _one_hot(ctx, idx, shape[axis], x.dtype)  # the one-hot on the last axis
    return np.moveaxis(out, -1, axis) if ctx.is_fold else torch.movedim(out, -1, axis)


@op("EyeLike")
def eye_like(ctx: OpContext, x):
    k = int(ctx.attr("k", 0))
    dtype = _dtype(ctx, ctx.attr("dtype"), x)
    n, m = np.shape(x)
    if ctx.is_fold:
        return np.eye(n, m, k=k, dtype=dtype)
    rows = torch.arange(n, device=x.device)[:, None]
    return (torch.arange(m, device=x.device)[None, :] - rows == k).to(dtype)


@op("Det")
def det(ctx: OpContext, x):
    return np.linalg.det(x) if ctx.is_fold else torch.linalg.det(x)


@op("ReduceLogSum", static_args=(1,))
def reduce_log_sum(ctx: OpContext, x, axes=None):
    return ctx.xp.log(_reduce(ctx, x, axes, np.sum, torch.sum))


# -- normalization and pooling ----------------------------------------------------


@op("LRN", foldable=False)
def lrn(ctx: OpContext, x):
    """Local response normalization across channels (axis 1): the window's
    square sum from a cumulative sum, as JAX's emitter takes it."""
    size = int(ctx.attr("size"))
    alpha = ctx.attr("alpha", 1e-4)
    beta = ctx.attr("beta", 0.75)
    bias = ctx.attr("bias", 1.0)
    C = x.shape[1]
    lo, hi = (size - 1) // 2, size // 2  # the window [c - lo, c + hi]
    cs = torch.cumsum(torch.square(x), dim=1)
    cs = torch.cat([torch.zeros_like(cs[:, :1]), cs], dim=1)  # prefix sums
    c = torch.arange(C, device=x.device)
    win = (torch.index_select(cs, 1, (c + hi + 1).clamp(max=C))
           - torch.index_select(cs, 1, (c - lo).clamp(min=0)))
    return x / torch.pow(bias + (alpha / size) * win, beta)


@op("GlobalLpPool", foldable=False)
def global_lp_pool(ctx: OpContext, x):
    p = int(ctx.attr("p", 2))
    s = torch.sum(torch.pow(torch.abs(x), p), dim=tuple(range(2, x.dim())), keepdim=True)
    return torch.pow(s, 1.0 / p)


@op("LpPool", foldable=False)
def lp_pool(ctx: OpContext, x):
    """The window sum of |x|^p over a zero-padded input (the pool family's
    geometry, ceil_mode included), to the power 1/p."""
    p = int(ctx.attr("p", 2))
    kshape, strides, dilations, pads = _pool_geometry(ctx, tuple(x.shape))
    xp = F.pad(torch.pow(torch.abs(x), p), _flat_pads(pads))
    return torch.pow(sum(_taps(xp, kshape, strides, dilations)), 1.0 / p)


@op("ReverseSequence", foldable=False)
def reverse_sequence(ctx: OpContext, x, seq_lens):
    """Each batch row reversed within [0, seq_lens[b]) along time_axis (the
    gather the ragged RNNs use)."""
    batch_axis = int(ctx.attr("batch_axis", 1))
    time_axis = int(ctx.attr("time_axis", 0))
    xt = torch.movedim(x, (time_axis, batch_axis), (0, 1))
    return torch.movedim(_seq_reverse(xt, seq_lens), (0, 1), (time_axis, batch_axis))


# -- spectral ---------------------------------------------------------------------


def _cosine_window(ctx: OpContext, size, a0, a1, a2=0.0) -> np.ndarray:
    """a0 - a1 cos(2 pi i / d) + a2 cos(4 pi i / d), d = n (periodic) or n - 1,
    in float64 on the host, then cast to output_datatype."""
    n = int(np.asarray(size))
    denom = n if int(ctx.attr("periodic", 1)) else n - 1
    i = np.arange(n)
    w = a0 - a1 * np.cos(2 * np.pi * i / denom) + a2 * np.cos(4 * np.pi * i / denom)
    return w.astype(DTYPE_MAP[int(ctx.attr("output_datatype", 1))])


@op("HannWindow", static_args=(0,))
def hann_window(ctx: OpContext, size):
    return _cosine_window(ctx, size, 0.5, 0.5)


@op("HammingWindow", static_args=(0,))
def hamming_window(ctx: OpContext, size):
    return _cosine_window(ctx, size, 25.0 / 46.0, 1 - 25.0 / 46.0)  # the spec's 25/46


@op("BlackmanWindow", static_args=(0,))
def blackman_window(ctx: OpContext, size):
    return _cosine_window(ctx, size, 0.42, 0.5, 0.08)


@op("MelWeightMatrix", static_args=(0, 1, 2, 3, 4))
def mel_weight_matrix(ctx: OpContext, num_mel_bins, dft_length, sample_rate,
                      lower_edge_hertz, upper_edge_hertz) -> np.ndarray:
    """The HTK-mel triangles on integer DFT bins of the onnx reference
    algorithm, [dft_length // 2 + 1, num_mel_bins], built on the host in
    float64 (not the audio front-end's mel bank, features/filters.py)."""
    nm = int(np.asarray(num_mel_bins))
    nfft = int(np.asarray(dft_length))
    sr = int(np.asarray(sample_rate))
    f_lo = float(np.asarray(lower_edge_hertz))
    f_hi = float(np.asarray(upper_edge_hertz))
    n_spec = nfft // 2 + 1

    def mel(f):
        return 2595.0 * np.log10(1.0 + f / 700.0)

    m = np.arange(nm + 2, dtype=np.float64)
    m = m * (mel(f_hi) - mel(f_lo)) / (nm + 2) + mel(f_lo)
    hz = 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    bins = (((nfft + 1) * hz) // sr).astype(np.int64)  # [nm + 2]
    lower, center, upper = bins[:-2], bins[1:-1], bins[2:]
    j = np.arange(n_spec, dtype=np.int64)[:, None]
    up = (j - lower) / np.maximum(center - lower, 1)
    down = (upper - j) / np.maximum(upper - center, 1)
    w = np.where((j >= lower) & (j < center), up,
                 np.where((j >= center) & (j < upper), down, 0.0))
    return w.astype(DTYPE_MAP[int(ctx.attr("output_datatype", 1))])


@op("DFT", foldable=False, static_args=(1, 2))
def dft(ctx: OpContext, x, dft_length=None, axis_in=None):
    """ONNX DFT: the opset-17 `axis` attribute or the opset-20 axis input; the
    last input axis holds the real (1) or real and imaginary (2) parts. A
    negative axis counts from the full rank, the component axis included (-2
    on [B, n, 2] is 1). Computed in complex64 (`torch.fft`, cuFFT on a
    card), the result cast to the input's type; `onesided` keeps the first
    n // 2 + 1 bins of the full transform; `inverse` has ifft's 1/n."""
    inverse = int(ctx.attr("inverse", 0))
    onesided = int(ctx.attr("onesided", 0))
    axis = int(np.asarray(axis_in)) if axis_in is not None else int(ctx.attr("axis", 1))
    if axis < 0:
        axis += x.dim()
    if x.shape[-1] == 2:
        sig = torch.complex(x[..., 0].float(), x[..., 1].float())
    else:
        sig = x[..., 0].float()
    n = int(np.asarray(dft_length)) if dft_length is not None else sig.shape[axis]
    out = (torch.fft.ifft if inverse else torch.fft.fft)(sig, n=n, dim=axis)
    if onesided:
        out = out.narrow(axis, 0, n // 2 + 1)
    return torch.stack([out.real, out.imag], dim=-1).to(x.dtype)


# -- random -----------------------------------------------------------------------


def _uniforms(ctx: OpContext, shape) -> np.ndarray:
    """The node's trace-time uniforms in [0, 1), float32: Philox on its key."""
    gen = np.random.Generator(np.random.Philox(key=rng_key(ctx)))
    return gen.random(tuple(int(d) for d in shape), dtype=np.float32)


def _bernoulli(p: torch.Tensor, u: torch.Tensor, dtype) -> torch.Tensor:
    return (u < p.float()).to(dtype)


@op("Bernoulli", foldable=False, records=True, draws=True)
def bernoulli(ctx: OpContext, x):
    dtype = _dtype(ctx, ctx.attr("dtype"), x)
    u = host_const(ctx, "uniforms", _uniforms(ctx, x.shape))
    return run_step(ctx, _bernoulli, x, u, dtype)


def _multinomial(logits: torch.Tensor, u: torch.Tensor, dtype) -> torch.Tensor:
    """The class of each uniform under softmax(logits): the first whose CDF
    exceeds it (a class of probability 0 is never taken)."""
    cdf = torch.cumsum(torch.softmax(logits.float(), dim=-1), dim=-1)
    idx = torch.searchsorted(cdf.contiguous(), (u * cdf[..., -1:]).contiguous(), right=True)
    return idx.clamp(max=logits.shape[-1] - 1).to(dtype)


@op("Multinomial", foldable=False, records=True, draws=True)
def multinomial(ctx: OpContext, x):
    """sample_size draws a row of x [batch, classes], unnormalized log
    probabilities (the spec: no log here) → [batch, sample_size]."""
    n = int(ctx.attr("sample_size", 1))
    dtype = _dtype(ctx, ctx.attr("dtype", 6))  # int32 by default
    u = host_const(ctx, "uniforms", _uniforms(ctx, (x.shape[0], n)))
    return run_step(ctx, _multinomial, x, u, dtype)


# -- losses -----------------------------------------------------------------------


def _nll(ctx: OpContext, log_p, target, weight):
    """The NLL core on log probabilities [N, C, d...] and targets [N, d...]:
    ignore_index, per-class weights, and each reduction (the mean over the
    picked weights, or over the valid targets)."""
    reduction = ctx.attr("reduction", "mean")
    ignore_index = ctx.attr("ignore_index")
    tgt = target.long()
    valid = None
    if ignore_index is not None:
        valid = tgt != int(ignore_index)
        tgt = torch.where(valid, tgt, 0)
    loss = -torch.gather(log_p, 1, tgt.unsqueeze(1)).squeeze(1)
    w = weight[tgt] if weight is not None else None
    if w is not None:
        loss = loss * w
    if valid is not None:
        loss = torch.where(valid, loss, 0.0)
    if reduction == "none":
        return loss
    if reduction == "sum":
        return torch.sum(loss)
    if w is not None:
        return torch.sum(loss) / torch.sum(torch.where(valid, w, 0.0) if valid is not None
                                           else w)
    if valid is not None:
        return torch.sum(loss) / torch.sum(valid.to(loss.dtype))
    return torch.mean(loss)


@op("NegativeLogLikelihoodLoss", foldable=False)
def negative_log_likelihood_loss(ctx: OpContext, x, target, weight=None):
    return _nll(ctx, x, target, weight)


@op("SoftmaxCrossEntropyLoss", foldable=False)
def softmax_cross_entropy_loss(ctx: OpContext, scores, labels, weight=None):
    log_p = torch.log_softmax(scores, dim=1)
    loss = _nll(ctx, log_p, labels, weight)
    if ctx.node is not None and len(ctx.node.output) > 1 and ctx.node.output[1]:
        return loss, log_p
    return loss


# -- layout -----------------------------------------------------------------------


@op("CenterCropPad", foldable=False, static_args=(1,))
def center_crop_pad(ctx: OpContext, x, shape):
    """Each selected axis center-cropped or zero-padded to its extent (the
    odd element after the crop's start, or at the pad's end)."""
    want = static_ints(shape, "CenterCropPad shape")
    axes = ctx.attr_ints("axes", list(range(len(want))))
    out = x
    for a, tgt in zip((a % x.dim() for a in axes), want):
        cur = out.shape[a]
        if tgt < cur:
            out = out.narrow(a, (cur - tgt) // 2, tgt)
        elif tgt > cur:
            before = (tgt - cur) // 2
            out = F.pad(out, [0, 0] * (out.dim() - 1 - a) + [before, tgt - cur - before])
    return out


def _col2im(cols: torch.Tensor, flat: torch.Tensor, n_c: int, total: int, img) -> torch.Tensor:
    N = cols.shape[0]
    vals = cols.reshape(N, n_c, -1)
    out = torch.zeros((N, n_c, total + 1), dtype=cols.dtype, device=cols.device)
    out.index_add_(2, flat, vals)  # out-of-image taps land in the spare column
    return out[:, :, :total].reshape((N, n_c) + tuple(img))


@op("Col2Im", foldable=False, static_args=(1, 2), records=True)
def col2im(ctx: OpContext, cols, image_shape, block_shape):
    """Inverse im2col: column patches [N, C·prod(block), L] summed back into
    the image [N, C, *image] (any spatial rank; strides, dilations, pads).
    The tap → image index is built on the host, once."""
    img = static_ints(image_shape, "Col2Im image_shape")
    blk = static_ints(block_shape, "Col2Im block_shape")
    nd = len(img)
    dil = ctx.attr_ints("dilations", [1] * nd)
    pads = ctx.attr_ints("pads", [0] * (2 * nd))
    strides = ctx.attr_ints("strides", [1] * nd)
    steps = [(img[i] + pads[i] + pads[nd + i] - dil[i] * (blk[i] - 1) - 1) // strides[i] + 1
             for i in range(nd)]
    K, L = int(np.prod(blk)), int(np.prod(steps))
    k_off = np.stack(np.unravel_index(np.arange(K), blk))  # [nd, K]
    s_off = np.stack(np.unravel_index(np.arange(L), steps))  # [nd, L]
    inbound = np.ones((K, L), bool)
    flat = np.zeros((K, L), np.int64)
    for i in range(nd):
        coord = k_off[i][:, None] * dil[i] + s_off[i][None, :] * strides[i] - pads[i]
        inbound &= (coord >= 0) & (coord < img[i])
        flat = flat * img[i] + np.clip(coord, 0, img[i] - 1)
    total = int(np.prod(img))
    flat = np.where(inbound, flat, total).reshape(-1)
    index = host_const(ctx, "index", flat)
    return run_step(ctx, _col2im, cols, index, cols.shape[1] // K, total, tuple(img))


@op("MaxUnpool", foldable=False, static_args=(2,))
def max_unpool(ctx: OpContext, x, indices, output_shape=None):
    """The pooled values written back at their indices (ONNX-flat over the
    whole output), zeros elsewhere."""
    kshape = ctx.attr_ints("kernel_shape")
    nd = len(kshape)
    strides = ctx.attr_ints("strides", [1] * nd)
    pads = ctx.attr_ints("pads", [0] * (2 * nd))
    if output_shape is not None:
        out_shape = tuple(static_ints(output_shape, "MaxUnpool output_shape"))
    else:
        out_shape = tuple(x.shape[:2]) + tuple(
            (x.shape[2 + i] - 1) * strides[i] - pads[i] - pads[nd + i] + kshape[i]
            for i in range(nd))
    flat = x.new_zeros(int(np.prod(out_shape)))
    flat[indices.reshape(-1).long()] = x.reshape(-1)
    return flat.reshape(out_shape)


@op("Scatter", foldable=False)
def scatter_deprecated(ctx: OpContext, data, indices, updates):
    """The deprecated opset-9/10 name of ScatterElements."""
    return scatter_elements(ctx, data, indices, updates)


# -- spatial sampling ----------------------------------------------------------------


def _bilinear_gather(img: torch.Tensor, iy: torch.Tensor, ix: torch.Tensor,
                     pad_zeros: bool) -> torch.Tensor:
    """img [M, C, H, W]; iy, ix [M, ...] float sample coordinates. The four
    border-clamped corners blended bilinearly, a corner outside reading 0
    where pad_zeros; → [M, C, ...]."""
    H, W = img.shape[-2], img.shape[-1]
    y0, x0 = torch.floor(iy), torch.floor(ix)
    wy, wx = iy - y0, ix - x0

    def at(yy, xx):
        v = _gather_plane(img, yy, xx)
        if pad_zeros:
            ok = (yy >= 0) & (yy <= H - 1) & (xx >= 0) & (xx <= W - 1)
            v = torch.where(ok.unsqueeze(1), v, 0.0)
        return v

    wy, wx = wy.unsqueeze(1), wx.unsqueeze(1)
    return (at(y0, x0) * (1 - wy) * (1 - wx)
            + at(y0, x0 + 1) * (1 - wy) * wx
            + at(y0 + 1, x0) * wy * (1 - wx)
            + at(y0 + 1, x0 + 1) * wy * wx)


def _gather_plane(img: torch.Tensor, yy: torch.Tensor, xx: torch.Tensor) -> torch.Tensor:
    """img [M, C, H, W] read at the clamped float coordinates yy, xx [M, ...]
    of each image → [M, C, ...]."""
    M, C, H, W = img.shape
    yc = yy.clamp(0, H - 1).long()
    xc = xx.clamp(0, W - 1).long()
    idx = (yc * W + xc).reshape(M, 1, -1).expand(M, C, -1)
    return torch.gather(img.reshape(M, C, H * W), 2, idx).reshape((M, C) + tuple(yy.shape[1:]))


@op("GridSample", foldable=False)
def grid_sample(ctx: OpContext, x, grid):
    """4-D GridSample: modes linear / bilinear and nearest (ties round up:
    floor(v + 0.5)), padding zeros, border, or reflection (coordinates
    reflected, then border), as JAX's emitter gathers; cubic raises."""
    mode = ctx.attr("mode", "linear")
    if mode not in ("linear", "bilinear", "nearest"):
        # bicubic would silently evaluate as bilinear: wrong numbers are worse
        # than an error (Resize raises for cubic the same way)
        raise NotImplementedError(f"GridSample mode {mode!r} unsupported")
    padding = ctx.attr("padding_mode", "zeros")
    align = int(ctx.attr("align_corners", 0))
    if x.dim() != 4:
        raise NotImplementedError("GridSample: only 4-D inputs supported")
    H, W = x.shape[2], x.shape[3]
    gx, gy = grid[..., 0], grid[..., 1]  # [N, Ho, Wo]

    def unnorm(g, size):
        return (g + 1) / 2 * (size - 1) if align else ((g + 1) * size - 1) / 2

    ix, iy = unnorm(gx, W), unnorm(gy, H)
    if padding == "reflection":
        def reflect(v, lo, hi):
            span = hi - lo
            v = torch.abs(torch.remainder(v - lo, 2 * span + 1e-12))
            return torch.where(v > span, 2 * span - v, v) + lo

        if align:
            ix, iy = reflect(ix, 0.0, W - 1.0), reflect(iy, 0.0, H - 1.0)
        else:
            ix = reflect(ix, -0.5, W - 0.5).clamp(0, W - 1)
            iy = reflect(iy, -0.5, H - 0.5).clamp(0, H - 1)
    zeros = padding == "zeros"
    if mode != "nearest":
        return _bilinear_gather(x, iy, ix, zeros)
    yy, xx = torch.floor(iy + 0.5), torch.floor(ix + 0.5)
    v = _gather_plane(x, yy, xx)
    if zeros:
        ok = (yy >= 0) & (yy <= H - 1) & (xx >= 0) & (xx <= W - 1)
        v = torch.where(ok.unsqueeze(1), v, 0.0)
    return v


@op("RoiAlign", foldable=False)
def roi_align(ctx: OpContext, x, rois, batch_indices):
    """ROI Align: bilinear samples on a fixed sr x sr grid a bin, averaged or
    maxed. `sampling_ratio=0` takes sr = 2, JAX's static grid, not the spec's
    adaptive one (ROADMAP §3 "Known")."""
    oh = int(ctx.attr("output_height", 1))
    ow = int(ctx.attr("output_width", 1))
    sr = int(ctx.attr("sampling_ratio", 0)) or 2
    scale = ctx.attr("spatial_scale", 1.0)
    rois = rois.float() * scale
    if ctx.attr("coordinate_transformation_mode", "half_pixel") == "half_pixel":
        rois = rois - 0.5
    x1, y1, x2, y2 = rois.unbind(-1)  # [R] each
    R, dev = rois.shape[0], rois.device
    sub = (torch.arange(sr, device=dev)[None, :] + 0.5) / sr  # [1, sr]
    gy = y1[:, None, None] + (torch.arange(oh, device=dev)[:, None] + sub) * (
        (y2 - y1) / oh)[:, None, None]  # [R, oh, sr]
    gx = x1[:, None, None] + (torch.arange(ow, device=dev)[:, None] + sub) * (
        (x2 - x1) / ow)[:, None, None]  # [R, ow, sr]
    iy = gy[:, :, None, :, None].expand(R, oh, ow, sr, sr)
    ix = gx[:, None, :, None, :].expand(R, oh, ow, sr, sr)
    img = torch.index_select(x, 0, batch_indices.long())
    v = _bilinear_gather(img, iy, ix, pad_zeros=False)  # [R, C, oh, ow, sr, sr]
    if ctx.attr("mode", "avg") == "max":
        return torch.amax(v, dim=(-2, -1))
    return torch.mean(v, dim=(-2, -1))


@op("MaxRoiPool", foldable=False)
def max_roi_pool(ctx: OpContext, x, rois):
    """Caffe-style ROI max pooling (opset 1): ROI corners rounded half away
    from zero, floor / ceil bin edges, an empty bin 0. Every ROI at once: each
    bin's rows and columns are masks over the whole plane (a static window),
    maxed rows first, then columns."""
    ph, pw = static_ints(ctx.attr("pooled_shape"), "pooled_shape")
    scale = float(ctx.attr("spatial_scale", 1.0))
    H, W = x.shape[2], x.shape[3]
    rois = rois.float()
    dev = x.device
    neg = torch.finfo(torch.float32).min
    # corners >= 0, so floor(v + 0.5) is round half away from zero
    x1, y1, x2, y2 = torch.floor(rois[:, 1:] * scale + 0.5).unbind(-1)
    roi_h = torch.clamp(y2 - y1 + 1.0, min=1.0)[:, None]
    roi_w = torch.clamp(x2 - x1 + 1.0, min=1.0)[:, None]
    ib = torch.arange(ph, dtype=torch.float32, device=dev)[None, :]
    jb = torch.arange(pw, dtype=torch.float32, device=dev)[None, :]
    hs = torch.clamp(torch.floor(ib * roi_h / ph) + y1[:, None], 0, H)  # [R, ph]
    he = torch.clamp(torch.ceil((ib + 1.0) * roi_h / ph) + y1[:, None], 0, H)
    ws = torch.clamp(torch.floor(jb * roi_w / pw) + x1[:, None], 0, W)  # [R, pw]
    we = torch.clamp(torch.ceil((jb + 1.0) * roi_w / pw) + x1[:, None], 0, W)
    ys = torch.arange(H, dtype=torch.float32, device=dev)
    xs = torch.arange(W, dtype=torch.float32, device=dev)
    my = (ys >= hs[..., None]) & (ys < he[..., None])  # [R, ph, H]
    mx = (xs >= ws[..., None]) & (xs < we[..., None])  # [R, pw, W]
    xb = torch.index_select(x, 0, rois[:, 0].long())  # [R, C, H, W]
    rowm = torch.where(my[:, :, None, :, None], xb[:, None], neg).amax(dim=3)  # [R, ph, C, W]
    v = torch.where(mx[:, None, :, None, :], rowm[:, :, None], neg).amax(dim=-1)  # [R, ph, pw, C]
    nonempty = my.any(-1)[:, :, None] & mx.any(-1)[:, None, :]  # [R, ph, pw]
    return torch.where(nonempty[:, None], v.permute(0, 3, 1, 2), 0.0)


# -- optionals ------------------------------------------------------------------


class OptionalVal:
    """ONNX optional value: a trace-time wrapper holding a tensor, a sequence
    or nothing. Its structure is static (OptionalHasElement folds), so it has
    no device representation."""

    def __init__(self, value=None):
        self.value = value


@op("Optional", foldable=False, host=True)
def optional(ctx: OpContext, x=None):
    return OptionalVal(x)


@op("OptionalHasElement", foldable=False, host=True)
def optional_has_element(ctx: OpContext, x=None):
    if isinstance(x, OptionalVal):
        x = x.value
    return np.array(x is not None)


@op("OptionalGetElement", foldable=False, host=True)
def optional_get_element(ctx: OpContext, x):
    if isinstance(x, OptionalVal):
        if x.value is None:
            raise ValueError("OptionalGetElement on an empty optional")
        return x.value
    return x  # opset 18 takes a tensor or a sequence directly


# -- sequences --------------------------------------------------------------------


class TensorSeq(list):
    """ONNX sequence value: a trace-time list whose elements are tensors or
    static arrays. Its length is static; its elements may be device values."""


@op("SequenceEmpty", foldable=False, host=True)
def sequence_empty(ctx: OpContext):
    return TensorSeq()


@op("SequenceConstruct", foldable=False, host=True)
def sequence_construct(ctx: OpContext, *tensors):
    return TensorSeq(tensors)


@op("SequenceLength", foldable=False, host=True)
def sequence_length(ctx: OpContext, seq):
    return np.array(len(seq), np.int64)


def _seq_pos(position, n, default):
    if position is None:
        return default
    p = int(np.asarray(position))
    return p + n if p < 0 else p


@op("SequenceAt", foldable=False, static_args=(1,), host=True)
def sequence_at(ctx: OpContext, seq, position):
    return seq[_seq_pos(position, len(seq), 0)]


@op("SequenceInsert", foldable=False, static_args=(2,), host=True)
def sequence_insert(ctx: OpContext, seq, tensor, position=None):
    out = TensorSeq(seq)
    out.insert(_seq_pos(position, len(seq), len(seq)), tensor)
    return out


@op("SequenceErase", foldable=False, static_args=(1,), host=True)
def sequence_erase(ctx: OpContext, seq, position=None):
    out = TensorSeq(seq)
    del out[_seq_pos(position, len(seq), len(seq) - 1)]
    return out


@op("SplitToSequence", foldable=False, static_args=(1,))
def split_to_sequence(ctx: OpContext, x, split=None):
    axis = int(ctx.attr("axis", 0))
    axis = axis if axis >= 0 else axis + x.dim()
    n = x.shape[axis]
    if split is None:
        parts = torch.split(x, 1, dim=axis)
        if not int(ctx.attr("keepdims", 1)):
            parts = [p.squeeze(axis) for p in parts]
        return TensorSeq(parts)
    sp = np.asarray(split)
    if sp.ndim == 0:
        size = int(sp)
        sizes = [size] * (n // size) + ([n % size] if n % size else [])
    else:
        sizes = [int(s) for s in sp[:-1]]
        sizes.append(n - sum(sizes))  # the last part takes the rest, as jnp.split's cuts
    return TensorSeq(torch.split(x, sizes, dim=axis))


@op("ConcatFromSequence", foldable=False)
def concat_from_sequence(ctx: OpContext, seq):
    axis = int(ctx.attr("axis"))
    if int(ctx.attr("new_axis", 0)):
        return torch.stack(list(seq), dim=axis)
    return torch.cat(list(seq), dim=axis)
