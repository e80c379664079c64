"""NN emitters (counterpart of lele_tpu/ops/nn_ops.py): LayerNormalization,
RMSNormalization, Conv over 1-3 spatial dims (the FSMN's depthwise memory
conv, Silero's STFT and conv stack, YOLO-class image backbones),
ConvTranspose for the 1-D case (the Supertonic vocoder's upsampling), and the
recurrent LSTM, GRU and RNN."""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels.gru import gru_seq, gru_seq_plain
from ..kernels.gru import kernel_takes as gru_kernel_takes
from ..kernels.lstm import kernel_takes, lstm_seq, lstm_seq_plain
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
    xp = F.pad(x, [p for lo_hi in reversed(pads) for p in lo_hi])  # last dim first
    with torch.backends.cudnn.flags(enabled=torch.backends.cudnn.enabled,
                                    allow_tf32=False):
        out = _CONV_FNS[rank](xp, w.to(x.dtype), None, stride=strides,
                              dilation=dilations, groups=group)
    if b is not None:
        out = out + b.to(out.dtype).reshape((1, -1) + (1,) * rank)
    return out


def _conv_transpose_pads(ctx: OpContext, in_dim: int, k: int, stride: int, dilation: int,
                         out_pad: int) -> tuple[int, int]:
    """(begin, end) pads of a 1-D ConvTranspose, as lele_tpu/ops/nn_ops.py
    resolves them: `output_shape` overrides `pads`; SAME_* make the output
    input x stride."""
    eff_k = (k - 1) * dilation + 1
    auto = ctx.attr("auto_pad", "NOTSET")
    out_shape = ctx.attr_ints("output_shape")
    if out_shape is not None:
        total = max(0, stride * (in_dim - 1) + out_pad + eff_k - int(out_shape[-1]))
        half = total // 2
        return (total - half, half) if auto == "SAME_UPPER" else (half, total - half)
    pads = ctx.attr_ints("pads")
    if pads is not None:
        return pads[0], pads[1]
    if auto in ("NOTSET", "", None, "VALID"):
        return 0, 0
    total = max(0, eff_k - stride + out_pad)
    half = total // 2
    return (half, total - half) if auto == "SAME_UPPER" else (total - half, half)


@op("ConvTranspose", foldable=False)
def conv_transpose(ctx: OpContext, x, w, b=None):
    """1-D transposed convolution [N, C_in, T], ONNX weight [C_in, C_out/g, k]
    (torch's own layout and semantics): the full-length product, output
    padding zeros at its end, then the pads cropped. cuDNN's TF32 is off."""
    if x.dim() != 3:
        raise NotImplementedError(f"ConvTranspose over {x.dim() - 2} spatial dims is not "
                                  "ported yet (the port has the 1-D case)")
    k = int(w.shape[-1])
    (stride,) = ctx.attr_ints("strides", [1])
    (dilation,) = ctx.attr_ints("dilations", [1])
    (out_pad,) = ctx.attr_ints("output_padding", [0])
    p0, p1 = _conv_transpose_pads(ctx, int(x.shape[-1]), k, stride, dilation, out_pad)
    with torch.backends.cudnn.flags(enabled=torch.backends.cudnn.enabled,
                                    allow_tf32=False):
        full = F.conv_transpose1d(x, w.to(x.dtype), None, stride=stride, dilation=dilation,
                                  groups=ctx.attr("group", 1))
    full = F.pad(full, (0, out_pad))
    out = full[..., p0: full.shape[-1] - p1]
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
