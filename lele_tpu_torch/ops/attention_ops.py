"""Opset-23/24 attention-family emitters (counterpart of
lele_tpu/ops/attention_ops.py): Attention, RotaryEmbedding, Swish and
TensorScatter, the ops modern LLM exports write for a decoder step, and
AffineGrid (opset 20), GridSample's sampling grid.

Attention routes an eligible node (`flash_attention.kernel_takes`: JAX's gate
without its TPU test) to `flash_attention`, kernel 12 on a card and its plain
version on the CPU, as the JAX emitter routes it to the TPU flash kernel.
Every other node takes the einsum path, JAX's XLA path in plain PyTorch.
`ATTENTION_ROUTES` counts nodes run by route. JAX's `LELE_FLASH_ATTENTION`
knob and its fall-back on a kernel error are not ported: on a CUDA tensor an
eligible node launches the kernel or raises. `attention_plain` is the
emitter with the plain version on the flash route, an override
(`overrides={"Attention": attention_plain}`) that compiles a graph's oracle
for the card.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.flash_attention import flash_attention, flash_attention_plain, kernel_takes
from ..onnx.loader import DTYPE_MAP
from .registry import OpContext, op
from .tensor_ops import torch_dtype

# Attention nodes run, by route: "flash_attn" (kernel 12 on a card, its
# plain version on the CPU) or "einsum" (the XLA path's counterpart)
ATTENTION_ROUTES = {"flash_attn": 0, "einsum": 0}

_SOFTMAX_DTYPES = {np.dtype(np.float64): np.dtype(np.float32)}  # x64 off, as JAX's config


def _split_heads(x, n_heads):
    """[B, S, H*D] → [B, H, S, D]."""
    b, s, hd = x.shape
    return x.reshape(b, s, n_heads, hd // n_heads).permute(0, 2, 1, 3)


def _merge_heads(y):
    """[B, H, S, D] → [B, S, H*D]."""
    b, h, s, d = y.shape
    return y.permute(0, 2, 1, 3).reshape(b, s, h * d)


def _n_out(ctx: OpContext) -> int:
    return len(ctx.node.output) if ctx.node is not None else 1


def _attention(ctx: OpContext, q, k, v, attn_mask, past_key, past_value, flash):
    three_d = q.dim() == 3
    if three_d:
        qh = int(ctx.attr("q_num_heads", 0))
        kvh = int(ctx.attr("kv_num_heads", 0))
        if not qh or not kvh:
            raise ValueError("Attention with 3D inputs requires q_num_heads and "
                             "kv_num_heads attributes (ONNX opset 23)")
        q, k, v = _split_heads(q, qh), _split_heads(k, kvh), _split_heads(v, kvh)
    qh, kvh = q.shape[1], k.shape[1]
    scale = ctx.attr("scale")
    scale = (1.0 / float(np.sqrt(q.shape[-1]))) if scale is None else float(scale)
    softcap = float(ctx.attr("softcap", 0.0))
    is_causal = bool(ctx.attr("is_causal", 0))
    mode = int(ctx.attr("qk_matmul_output_mode", 0))
    n_out = _n_out(ctx)

    if past_key is not None:
        k = torch.cat([past_key, k], dim=2)
    if past_value is not None:
        v = torch.cat([past_value, v], dim=2)
    present_key, present_value = k, v
    if qh != kvh and qh % kvh:
        raise ValueError(f"Attention: q_num_heads {qh} not divisible by kv_num_heads {kvh}")

    if kernel_takes(q.shape, k.shape, is_causal=is_causal, has_mask=attn_mask is not None,
                    scale=scale, softcap=softcap, n_out=n_out, mode=mode):
        ATTENTION_ROUTES["flash_attn"] += 1
        y = flash(q, k, v, attn_mask, is_causal, scale)  # reads kv head h // rep itself
        if three_d:
            y = _merge_heads(y)
        return y if n_out <= 1 else (y, present_key, present_value)[:n_out]

    ATTENTION_ROUTES["einsum"] += 1
    if qh != kvh:
        k = k.repeat_interleave(qh // kvh, dim=1)
        v = v.repeat_interleave(qh // kvh, dim=1)
    Lq, Lk = q.shape[2], k.shape[2]
    acc = torch.promote_types(q.dtype, torch.float32)
    cdt = acc if softcap else q.dtype
    qk = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2)).to(cdt) * scale
    taps = {0: qk}
    neg = torch.finfo(cdt).min
    if is_causal:  # top-left alignment (tril diagonal 0), the torch sdpa rule
        keep = torch.ones((Lq, Lk), dtype=torch.bool, device=q.device).tril()
        qk = torch.where(keep, qk, neg)
    if attn_mask is not None:
        if attn_mask.dtype == torch.bool:
            qk = torch.where(attn_mask, qk, neg)
        else:
            qk = qk + attn_mask.to(cdt)
    taps[1] = qk
    if softcap > 0.0:
        qk = softcap * torch.tanh(qk / softcap)
    taps[2] = qk
    sp = ctx.attr("softmax_precision")
    if sp is not None:
        sdt = DTYPE_MAP[int(sp)]
        sdt = torch_dtype(_SOFTMAX_DTYPES.get(sdt, sdt))
    else:
        sdt = torch.promote_types(qk.dtype, torch.float32)
    w = torch.softmax(qk.to(sdt), dim=-1)
    taps[3] = w
    # w rounded to v's dtype, the product summed in f32 (XLA's CPU dot)
    y = torch.matmul(w.to(v.dtype).to(acc), v.to(acc)).to(v.dtype)
    if three_d:
        y = _merge_heads(y)
    if n_out <= 1:
        return y
    return (y, present_key, present_value, taps[mode].to(q.dtype))[:n_out]


@op("Attention", foldable=False)
def attention(ctx: OpContext, q, k, v, attn_mask=None, past_key=None, past_value=None):
    """ONNX Attention (opset 23): scaled dot-product attention with optional
    GQA (q_num_heads > kv_num_heads), bool/float masks, top-left-aligned
    causal masking, softcap, KV cache (past_*/present_*), softmax_precision,
    and the qk_matmul_output taps: scaled QK (0) → +mask (1) → softcap (2) →
    softmax (3). An eligible node takes kernel 12 (see the module note)."""
    return _attention(ctx, q, k, v, attn_mask, past_key, past_value, flash_attention)


def attention_plain(ctx: OpContext, q, k, v, attn_mask=None, past_key=None, past_value=None):
    """The Attention emitter with `flash_attention_plain` on the flash route:
    an override (`overrides={"Attention": attention_plain}`) that compiles a
    graph's plain oracle for the card."""
    return _attention(ctx, q, k, v, attn_mask, past_key, past_value, flash_attention_plain)


@op("RotaryEmbedding", foldable=False)
def rotary_embedding(ctx: OpContext, x, cos_cache, sin_cache, position_ids=None):
    """ONNX RotaryEmbedding (opset 23). X is [B,H,S,D] or [B,S,H*D]
    (num_heads attr). Caches are [max_pos, r/2] indexed by position_ids
    [B,S], or pre-gathered [B,S,r/2] when position_ids is absent.
    rotary_embedding_dim (default 0 = full head dim) rotates only the
    leading slice of each head; interleaved=1 pairs (even, odd) lanes."""
    three_d = x.dim() == 3
    if three_d:
        nh = int(ctx.attr("num_heads", 0))
        if not nh:
            raise ValueError("RotaryEmbedding with 3D input requires num_heads (opset 23)")
        orig = tuple(x.shape)
        x = _split_heads(x, nh)
    d = x.shape[-1]
    r = int(ctx.attr("rotary_embedding_dim", 0)) or d
    interleaved = bool(ctx.attr("interleaved", 0))
    if position_ids is not None:
        idx = position_ids.to(torch.int64)
        cos, sin = cos_cache[idx], sin_cache[idx]  # [B,S,r/2]
    else:
        cos, sin = cos_cache, sin_cache
    cos = cos[:, None, :, : r // 2]  # [B,1,S,r/2]
    sin = sin[:, None, :, : r // 2]
    out = apply_rotary(x, cos, sin, r, interleaved)
    if three_d:
        out = out.permute(0, 2, 1, 3).reshape(orig)
    return out


def apply_rotary(x, cos, sin, r, interleaved):
    """Rotate the leading `r` lanes of each head of x [B,H,S,D] by cos/sin
    [B|1, 1, S, r/2] (lele_tpu/ops/attention_ops.py:273-293)."""
    d = x.shape[-1]
    xr, rest = x[..., :r], x[..., r:]
    if interleaved:
        x1, x2 = xr[..., 0::2], xr[..., 1::2]
    else:
        x1, x2 = xr[..., : r // 2], xr[..., r // 2:]
    o1 = x1 * cos - x2 * sin
    o2 = x1 * sin + x2 * cos
    if interleaved:
        rot = torch.stack([o1, o2], dim=-1).reshape(xr.shape)
    else:
        rot = torch.cat([o1, o2], dim=-1)
    out = torch.cat([rot, rest], dim=-1) if r < d else rot
    return out.to(x.dtype)


@op("Swish", foldable=False)
def swish(ctx: OpContext, x):
    """Swish (opset 22): x·sigmoid(alpha·x)."""
    alpha = float(ctx.attr("alpha", 1.0))
    return x * torch.sigmoid(alpha * x)


@op("TensorScatter", foldable=False)
def tensor_scatter(ctx: OpContext, past_cache, update, write_indices=None):
    """ONNX TensorScatter (opset 24): write `update` into a copy of
    `past_cache` along `axis` from per-batch `write_indices` (default 0), the
    KV-cache append. mode "linear" wraps a negative start once and clamps it
    so the update fits, as JAX's dynamic_update_slice does; "circular" wraps
    positions mod max_seq."""
    nd = past_cache.dim()
    axis = int(ctx.attr("axis", -2)) % nd
    mode = ctx.attr("mode", "linear")
    if axis == 0:
        raise ValueError("TensorScatter: axis 0 is the batch dimension write_indices "
                         "indexes over; the sequence axis must be ≥1")
    b, max_seq, s = past_cache.shape[0], past_cache.shape[axis], update.shape[axis]
    dev = past_cache.device
    if write_indices is None:
        w = torch.zeros((b,), dtype=torch.int64, device=dev)
    else:
        w = write_indices.to(torch.int64).reshape(b)
    steps = torch.arange(s, device=dev)
    if mode == "circular":
        pos = (w[:, None] + steps[None, :]) % max_seq
    else:
        w = torch.where(w < 0, w + max_seq, w)  # lax.dynamic_update_slice's index rule
        pos = w.clamp(0, max_seq - s)[:, None] + steps[None, :]
    out = past_cache.movedim(axis, 1).clone()  # [B, max_seq, ...]
    out[torch.arange(b, device=dev)[:, None], pos] = update.movedim(axis, 1).to(out.dtype)
    return out.movedim(1, axis)


@op("AffineGrid", foldable=False, static_args=(1,))
def affine_grid(ctx: OpContext, theta, size):
    """The sampling grid of batched affine matrices (theta [N, 2, 3] or
    [N, 3, 4]) for GridSample: `size` is the static (N, C, H, W) or (N, C,
    D, H, W); align_corners follows torch's rule. The grid's coordinates are
    (x, y[, z]): x runs along the last spatial axis."""
    size = [int(v) for v in np.asarray(size).reshape(-1)]
    align = bool(ctx.attr("align_corners", 0))
    dev = theta.device

    def axis_coords(n):
        if align:
            return (torch.linspace(-1.0, 1.0, n, device=dev) if n > 1
                    else torch.zeros(1, device=dev))
        step = 2.0 / n  # the pixel centres of an n-cell grid over [-1, 1]
        return -1.0 + step / 2 + step * torch.arange(n, device=dev)

    mesh = torch.meshgrid(*[axis_coords(n) for n in size[2:]], indexing="ij")
    coords = torch.stack(list(reversed(mesh)) + [torch.ones_like(mesh[0])], dim=-1)
    return torch.einsum("...i,ndi->n...d", coords.to(theta.dtype), theta)
