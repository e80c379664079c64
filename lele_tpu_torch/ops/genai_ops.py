"""com.microsoft attention ops of ORT-GenAI decoder exports (counterpart of
lele_tpu/ops/genai_ops.py): GroupQueryAttention, SparseAttention,
MultiHeadAttention, DecoderMaskedSelfAttention and
DecoderMaskedMultiHeadAttention.

Every shape is static. The KV cache is the caller's max-length buffer that
the export carries (past_key / past_value); the per-row valid lengths ride
in `seqlens_k` (or `key_total_sequence_lengths`, `past_sequence_length`)
as device data, so no emitter reads the host: a decode step captures in
one CUDA graph. The cache append writes the new rows at each row's offset,
a negative one wrapped once and then clamped into [0, L − S], as JAX's
`lax.dynamic_update_slice` places it (the arithmetic of
`attention_ops.tensor_scatter`'s linear mode); the present
outputs are the whole updated buffers, which a caller donates
(`CompiledModel(donate=...)`) to keep them in place. Causal, window, length
and block-layout masks are index arithmetic on the device.

None of these reaches a kernel in JAX (its einsums run at f32 HIGHEST), so
they run as plain f32 torch products here (a card needs allow_tf32 off,
torch's default). GroupQueryAttention's kv-head repetition is a grouped
product: query head h reads kv head h // (num_heads / kv_num_heads), as
`jnp.repeat` makes it read, without materialising the repeated cache.
"""

from __future__ import annotations

import numpy as np
import torch

from .attention_ops import _n_out, apply_rotary
from .contrib_ops import _f32
from .registry import OpContext, op


def _bhsd(x, n_heads):
    """[B, S, H*D] → [B, H, S, D]."""
    b, s, hd = x.shape
    return x.reshape(b, s, n_heads, hd // n_heads).permute(0, 2, 1, 3)


def _cache_append(past, new, start):
    """Write `new` [B,H,S,D] into a copy of `past` [B,H,L,D] at per-row
    sequence offsets `start` [B] (device data): a negative offset wraps once
    (+ L), then each is clamped into [0, L − S], as lax.dynamic_update_slice
    places it."""
    b, h, s, d = new.shape
    L = past.shape[2]
    w = start.long()
    w = torch.where(w < 0, w + L, w).clamp(0, L - s)
    pos = w[:, None] + torch.arange(s, device=past.device)
    idx = pos[:, None, :, None].expand(b, h, s, d)
    return past.scatter(2, idx, new.to(past.dtype))


def _masked_softmax(scores, valid, smooth=False, filter_value=None):
    """Softmax over the last axis in f32 with a bool validity mask.

    filter_value None masks by replacement with -1e9 (the GQA rule); a float
    masks by ADDITION of mask_filter_value (the MHA rule: ORT adds the filter
    to masked scores rather than replacing them). smooth=True adds a virtual
    always-zero logit to the denominator (ORT's smooth_softmax: a head may
    attend to nothing)."""
    s = scores.to(_f32(scores.dtype))
    if valid is not None:
        if filter_value is None:
            s = s.masked_fill(~valid, -1e9)
        else:
            s = torch.where(valid, s, s + filter_value)
    m = s.amax(dim=-1, keepdim=True)
    if smooth:
        m = m.clamp_min(0.0)  # the virtual zero logit joins the max
    e = torch.exp(s - m)
    denom = e.sum(dim=-1, keepdim=True)
    if smooth:
        denom = denom + torch.exp(-m)
    return e / denom


def _grouped_scores(q, k_all, scale):
    """q [B,qh,S,D] · k_all [B,kvh,L,D]ᵀ → [B,qh,S,L] in f32: query head h
    against kv head h // rep, as one product a kv head over its rep·S query
    rows (no copy of the cache)."""
    b, qh, s, d = q.shape
    kvh, L = k_all.shape[1], k_all.shape[2]
    acc = _f32(q.dtype)
    qg = q.to(acc).reshape(b, kvh, (qh // kvh) * s, d)
    sc = torch.matmul(qg, k_all.to(q.dtype).to(acc).transpose(-1, -2))
    return sc.reshape(b, qh, s, L) * scale


def _grouped_values(w, v_all):
    """w [B,qh,S,L] · v_all [B,kvh,L,D] → [B,qh,S,D], query head h against
    kv head h // rep; w rounded to v's type, summed in f32."""
    b, qh, s, L = w.shape
    kvh = v_all.shape[1]
    acc = _f32(v_all.dtype)
    wg = w.to(v_all.dtype).to(acc).reshape(b, kvh, (qh // kvh) * s, L)
    y = torch.matmul(wg, v_all.to(acc))
    return y.reshape(b, qh, s, -1).to(v_all.dtype)


def _split_qkv(what: str, query, key, value, qh: int, kvh: int):
    """q, k, v as [B,H,S,D] from separate or packed [B,S,(qh+2·kvh)·D] QKV."""
    hidden = query.shape[-1]
    if key is None or value is None:
        if key is not None or value is not None:
            raise ValueError(f"{what}: packed QKV requires BOTH key and value absent")
        head = hidden // (qh + 2 * kvh)
        q = query[..., : qh * head]
        k = query[..., qh * head: (qh + kvh) * head]
        v = query[..., (qh + kvh) * head:]
    else:
        head = hidden // qh
        q, k, v = query, key, value
    return _bhsd(q, qh), _bhsd(k, kvh), _bhsd(v, kvh), head


def _rotary_qk(ctx: OpContext, what: str, q, k, cos_cache, sin_cache, pos):
    if cos_cache is None or sin_cache is None:
        raise ValueError(f"{what}: do_rotary=1 requires cos_cache and sin_cache")
    interleaved = bool(ctx.attr("rotary_interleaved", 0))
    r = int(cos_cache.shape[-1]) * 2
    cos = cos_cache[pos][:, None, :, : r // 2]  # [B,1,S,r/2]
    sin = sin_cache[pos][:, None, :, : r // 2]
    return apply_rotary(q, cos, sin, r, interleaved), apply_rotary(k, cos, sin, r, interleaved)


def _heads(ctx: OpContext, what: str) -> tuple[int, int]:
    qh = int(ctx.attr("num_heads", 0))
    kvh = int(ctx.attr("kv_num_heads", 0))
    if not qh or not kvh:
        raise ValueError(f"{what} requires num_heads and kv_num_heads")
    if qh % kvh:
        raise ValueError(f"{what}: num_heads {qh} not divisible by kv_num_heads {kvh}")
    return qh, kvh


def _scale(ctx: OpContext, head: int) -> float:
    scale = ctx.attr("scale")
    return float(scale) if scale else 1.0 / float(np.sqrt(head))


@op("GroupQueryAttention", foldable=False, domain="com.microsoft")
def group_query_attention(ctx: OpContext, query, key=None, value=None, past_key=None,
                          past_value=None, seqlens_k=None, total_sequence_length=None,
                          cos_cache=None, sin_cache=None, position_ids=None,
                          attention_bias=None, head_sink=None):
    """com.microsoft::GroupQueryAttention, the attention node of every
    ORT-GenAI decoder export.

    query [B,S,qh·D] (or packed [B,S,(qh+2·kvh)·D] with key and value
    absent); past_key / past_value the static cache buffers [B,kvh,L,D];
    seqlens_k [B] holds total_length − 1 a row (ORT's convention), so
    past_len = seqlens_k + 1 − S; the new rows are written at [past_len,
    past_len + S) and attention is causal over global positions, which
    also hides the buffer's stale tail. do_rotary rotates q and the new k
    at those positions (or at position_ids). local_window_size > 0 is the
    sliding window, softcap the tanh cap, smooth_softmax a virtual zero
    logit. total_sequence_length only sizes ORT's dynamic buffers: accepted
    and unused. head_sink raises."""
    what = "GroupQueryAttention"
    if head_sink is not None:
        raise NotImplementedError(f"{what}: head_sink (attention-sink logits) is not "
                                  "supported")
    qh, kvh = _heads(ctx, what)
    b, s, _ = query.shape
    q, k, v, head = _split_qkv(what, query, key, value, qh, kvh)
    dev = query.device
    if seqlens_k is None:  # a prefill graph without the length input
        past_len = torch.zeros((b,), dtype=torch.long, device=dev)
    else:
        past_len = seqlens_k.reshape(b).long() + 1 - s
    steps = torch.arange(s, device=dev)
    if bool(ctx.attr("do_rotary", 0)):
        if position_ids is not None:
            pid = position_ids.long()
            pos = (pid.reshape(()) + steps)[None, :].expand(b, s) if pid.numel() == 1 \
                else pid.reshape(b, s)
        else:
            pos = past_len[:, None] + steps[None, :]
        q, k = _rotary_qk(ctx, what, q, k, cos_cache, sin_cache, pos)
    if past_key is not None:
        k_all = _cache_append(past_key, k, past_len)
        v_all = _cache_append(past_value, v, past_len)
    else:
        k_all, v_all = k, v
    L = k_all.shape[2]
    scores = _grouped_scores(q, k_all, _scale(ctx, head))
    softcap = float(ctx.attr("softcap", 0.0))
    if softcap > 0.0:
        scores = softcap * torch.tanh(scores / softcap)
    if attention_bias is not None:
        scores = scores + attention_bias.to(scores.dtype)
    p = past_len[:, None] + steps[None, :]  # [B,S] global query positions
    j = torch.arange(L, device=dev)
    valid = j[None, None, :] <= p[:, :, None]  # [B,S,L]
    window = int(ctx.attr("local_window_size", -1))
    if window > 0:
        valid = valid & (j[None, None, :] > p[:, :, None] - window)
    w = _masked_softmax(scores, valid[:, None], smooth=bool(ctx.attr("smooth_softmax", 0)))
    y = _grouped_values(w, v_all).permute(0, 2, 1, 3).reshape(b, s, qh * head)
    n_out = _n_out(ctx)
    if n_out <= 1:
        return y
    return (y, k_all, v_all)[:n_out]


def _csr_block_mask(block_row_indices, block_col_indices, nblocks: int):
    """Dense [num_layout, nblocks, nblocks] bool from the CSR block layout
    (block_row_indices [num_layout, nblocks+1] row pointers,
    block_col_indices [num_layout, max_nnz] column ids padded with -1)."""
    rp = block_row_indices.long()
    cols = block_col_indices.long()
    i = torch.arange(cols.shape[-1], device=cols.device)
    # in_row[l, r, n]: nnz slot n belongs to row r of layout l
    in_row = ((i[None, None, :] >= rp[:, :nblocks, None])
              & (i[None, None, :] < rp[:, 1: nblocks + 1, None]))
    match = cols[:, None, :, None] == torch.arange(nblocks, device=cols.device)
    return (in_row[:, :, :, None] & match).any(dim=2)


@op("SparseAttention", foldable=False, domain="com.microsoft")
def sparse_attention(ctx: OpContext, query, key=None, value=None, past_key=None,
                     past_value=None, block_row_indices=None, block_col_indices=None,
                     total_sequence_length=None, key_total_sequence_lengths=None,
                     cos_cache=None, sin_cache=None):
    """com.microsoft::SparseAttention (Phi-3-small's block-sparse attention
    over the shared static KV buffer): GroupQueryAttention's cache, rotary
    and length conventions, with the per-row totals given directly
    (past_len = total − S), and the causal mask intersected with a per-head
    block layout: query block qb sees key block kb only where the CSR layout
    (head h uses layout h % num_layout) holds (qb, kb); blocks are
    `sparse_block_size` positions."""
    what = "SparseAttention"
    qh = int(ctx.attr("num_heads", 0))
    kvh = int(ctx.attr("kv_num_heads", 0))
    bs_blk = int(ctx.attr("sparse_block_size", 0))
    if not qh or not kvh or not bs_blk:
        raise ValueError(f"{what} requires num_heads, kv_num_heads and sparse_block_size")
    if qh % kvh:
        raise ValueError(f"{what}: num_heads {qh} not divisible by kv_num_heads {kvh}")
    if past_key is None or past_value is None:
        raise NotImplementedError(f"{what}: the shared past_key/past_value buffers are "
                                  "required (every published export carries them)")
    if block_row_indices is None or block_col_indices is None:
        raise ValueError(f"{what} requires block_row_indices/block_col_indices")
    if key_total_sequence_lengths is None:
        raise ValueError(f"{what} requires key_total_sequence_lengths")
    b, s, _ = query.shape
    q, k, v, head = _split_qkv(what, query, key, value, qh, kvh)
    dev = query.device
    past_len = key_total_sequence_lengths.reshape(b).long() - s
    p = past_len[:, None] + torch.arange(s, device=dev)[None, :]  # [B,S]
    if bool(ctx.attr("do_rotary", 0)):
        q, k = _rotary_qk(ctx, what, q, k, cos_cache, sin_cache, p)
    k_all = _cache_append(past_key, k, past_len)
    v_all = _cache_append(past_value, v, past_len)
    L = k_all.shape[2]
    if L % bs_blk:
        raise ValueError(f"{what}: cache length {L} is not a multiple of "
                         f"sparse_block_size {bs_blk}")
    scores = _grouped_scores(q, k_all, _scale(ctx, head))
    j = torch.arange(L, device=dev)
    causal = j[None, None, :] <= p[:, :, None]  # [B,S,L]
    allowed = _csr_block_mask(block_row_indices, block_col_indices, L // bs_blk)
    lay = torch.arange(qh, device=dev) % allowed.shape[0]
    per_head = allowed[lay]  # [H, nb, nb]
    blk = per_head[:, p // bs_blk][:, :, :, j // bs_blk]  # [H,B,S,L]
    valid = blk.permute(1, 0, 2, 3) & causal[:, None]
    w = _masked_softmax(scores, valid)
    y = _grouped_values(w, v_all).permute(0, 2, 1, 3).reshape(b, s, qh * head)
    n_out = _n_out(ctx)
    if n_out <= 1:
        return y
    return (y, k_all, v_all)[:n_out]


def _sdpa(q, k, v, scale, bias, valid, filter_value):
    """Scores in f32, additive bias, the MHA mask rule, the weighted sum."""
    acc = _f32(q.dtype)
    scores = torch.matmul(q.to(acc), k.to(q.dtype).to(acc).transpose(-1, -2)) * scale
    if bias is not None:
        scores = scores + bias.to(scores.dtype)
    w = _masked_softmax(scores, valid, filter_value=filter_value)
    vacc = _f32(v.dtype)
    return torch.matmul(w.to(v.dtype).to(vacc), v.to(vacc)).to(v.dtype)


@op("MultiHeadAttention", foldable=False, domain="com.microsoft")
def multi_head_attention(ctx: OpContext, query, key=None, value=None, bias=None,
                         key_padding_mask=None, attention_bias=None, past_key=None,
                         past_value=None):
    """com.microsoft::MultiHeadAttention: attention over projected q/k/v
    (ORT's form for cross-attention and non-GQA self-attention). Inputs:
    query [B,Sq,H·D] with key [B,Skv,H·D] and value [B,Skv,H·Dv]; packed QKV
    query [B,S,H,3,D]; packed KV key [B,Skv,H,2,D]; or cached key/value
    [B,H,Skv,D]. bias is the fused [q|k|v] projection bias;
    key_padding_mask [B] right-side key lengths or [B, total_kv] binary
    (masked scores get mask_filter_value ADDED, ORT's rule); attention_bias
    additive; past_key / past_value [B,H,P,D] concatenated and returned as
    present_key / present_value."""
    heads = int(ctx.attr("num_heads", 0))
    if not heads:
        raise ValueError("MultiHeadAttention requires num_heads")
    b = query.shape[0]
    if query.dim() == 5:  # packed qkv [B,S,H,3,D]
        if key is not None or value is not None:
            raise ValueError("MultiHeadAttention: packed QKV query forbids key/value")
        if bias is not None:
            raise NotImplementedError("MultiHeadAttention: bias with packed QKV not "
                                      "supported")
        q, k, v = (query[:, :, :, i].permute(0, 2, 1, 3) for i in range(3))
    else:
        if key is None:
            raise ValueError("MultiHeadAttention: 3D query requires key (packed forms use "
                             "a 5D query)")
        if bias is not None:
            if key.dim() == 3 and value is not None and value.dim() == 3:
                dq, dk, dv = query.shape[-1], key.shape[-1], value.shape[-1]
                query = query + bias[:dq]
                key = key + bias[dq: dq + dk]
                value = value + bias[dq + dk: dq + dk + dv]
            else:
                raise NotImplementedError(
                    "MultiHeadAttention: bias is only supported with 3D key/value (ORT "
                    "forbids it for cached/packed KV too)")
        q = _bhsd(query, heads)
        if key.dim() == 5:  # packed kv [B,Skv,H,2,D]
            if value is not None:
                raise ValueError("MultiHeadAttention: packed KV key forbids value")
            k = key[:, :, :, 0].permute(0, 2, 1, 3)
            v = key[:, :, :, 1].permute(0, 2, 1, 3)
        elif key.dim() == 4:  # already [B,H,Skv,D]
            k, v = key, value
        else:
            k, v = _bhsd(key, heads), _bhsd(value, heads)
    if past_key is not None:
        k = torch.cat([past_key, k], dim=2)
    if past_value is not None:
        v = torch.cat([past_value, v], dim=2)
    sq, skv = q.shape[2], k.shape[2]
    dev = q.device
    valid = None
    if key_padding_mask is not None:
        kpm = key_padding_mask
        if kpm.dim() == 1 and kpm.shape[0] == b:
            valid = (torch.arange(skv, device=dev)[None, :]
                     < kpm.long()[:, None])[:, None, None, :]
        elif kpm.dim() == 2 and tuple(kpm.shape) == (b, skv):
            valid = kpm.bool()[:, None, None, :]
        else:
            raise NotImplementedError(
                "MultiHeadAttention: key_padding_mask must be [batch] right-side lengths "
                f"or [batch, total_kv], got shape {tuple(kpm.shape)}")
    if bool(ctx.attr("unidirectional", 0)):  # query row i at (skv - sq) + i
        causal = (torch.arange(skv, device=dev)[None, :]
                  <= (skv - sq + torch.arange(sq, device=dev))[:, None])[None, None]
        valid = causal if valid is None else (valid & causal)
    y = _sdpa(q, k, v, _scale(ctx, q.shape[-1]), attention_bias, valid,
              float(ctx.attr("mask_filter_value", -10000.0)))
    y = y.permute(0, 2, 1, 3).reshape(b, sq, heads * v.shape[-1])
    n_out = _n_out(ctx)
    if n_out <= 1:
        return y
    return (y, k, v)[:n_out]


# DecoderMasked*: ORT's static-buffer decode attention. The past IS the
# max-length buffer (past_present_share_buffer); the new rows land at
# past_sequence_length (device data), and validity is global causality
# j <= pseq + i, which masks the buffer's unwritten tail.


def _dm_core(ctx: OpContext, q, k, v, past_k, past_v, pseq, mask_index, rel_bias,
             what: str):
    """The shared DecoderMasked math: q/k/v [B,H,S,dh]; past [B,H,L,dh]
    buffers, or None (cross mode: attend k/v directly, no causality)."""
    b, h, s, dh = q.shape
    if past_k is not None:
        if pseq is None:
            raise ValueError(f"{what}: past_present_share_buffer form needs the "
                             "past_sequence_length input")
        p0 = pseq.reshape(()).long().expand(b)
        k_all = _cache_append(past_k, k, p0)
        v_all = _cache_append(past_v, v, p0)
        length = k_all.shape[2]
        pos = pseq.reshape(()).long() + torch.arange(s, device=q.device)  # global rows
        valid = (torch.arange(length, device=q.device)[None, None, None, :]
                 <= pos[None, None, :, None])
    else:
        k_all, v_all, valid = k, v, None
        length = k_all.shape[2]
    if mask_index is not None:
        mi = mask_index
        if mi.dim() == 2 and tuple(mi.shape) == (b, length):
            pad_ok = mi.bool()[:, None, None, :]
            valid = pad_ok if valid is None else (valid & pad_ok)
        else:
            raise NotImplementedError(f"{what}: mask_index must be [batch, "
                                      f"max_sequence_length] binary, got {tuple(mi.shape)}")
    y = _sdpa(q, k_all, v_all, _scale(ctx, dh), rel_bias, valid,
              float(ctx.attr("mask_filter_value", -10000.0)))
    return y.permute(0, 2, 1, 3).reshape(b, s, h * dh), k_all, v_all


def _dm_guards(ctx: OpContext, what: str, cache_indirection) -> None:
    if cache_indirection is not None:
        raise NotImplementedError(
            f"{what}: cache_indirection (in-kernel beam reordering) is not supported: "
            "the search ops reorder beams by physical gather")
    if bool(ctx.attr("do_rotary", 0)):
        raise NotImplementedError(
            f"{what}: do_rotary is not supported: published exports apply "
            "com.microsoft::RotaryEmbedding as a separate node")
    if bool(ctx.attr("output_qk", 0)):
        raise NotImplementedError(f"{what}: output_qk is not supported")


@op("DecoderMaskedSelfAttention", foldable=False, domain="com.microsoft")
def decoder_masked_self_attention(ctx: OpContext, x, weights, bias=None, mask_index=None,
                                  past=None, relative_position_bias=None,
                                  past_sequence_length=None, beam_width=None,
                                  cache_indirection=None):
    """com.microsoft::DecoderMaskedSelfAttention: fused-projection decode
    self-attention over the shared max-length buffer (stacked past
    [2,B,H,L,dh]); beam_width is accepted and unused."""
    what = "DecoderMaskedSelfAttention"
    _dm_guards(ctx, what, cache_indirection)
    heads = int(ctx.attr("num_heads", 0))
    if not heads:
        raise ValueError(f"{what} requires num_heads")
    if past is not None and not int(ctx.attr("past_present_share_buffer", 0)):
        raise NotImplementedError(f"{what}: only the past_present_share_buffer=1 form "
                                  "exists in ORT exports")
    qkv = torch.matmul(x, weights)
    if bias is not None:
        qkv = qkv + bias
    q, k, v = (_bhsd(t, heads) for t in qkv.chunk(3, dim=-1))
    y, k_all, v_all = _dm_core(ctx, q, k, v, past[0] if past is not None else None,
                               past[1] if past is not None else None, past_sequence_length,
                               mask_index, relative_position_bias, what)
    n_out = _n_out(ctx)
    if n_out <= 1:
        return y
    return (y, torch.stack([k_all, v_all], dim=0))[:n_out]


@op("DecoderMaskedMultiHeadAttention", foldable=False, domain="com.microsoft")
def decoder_masked_mha(ctx: OpContext, query, key=None, value=None, mask_index=None,
                       attention_bias=None, past_key=None, past_value=None,
                       past_sequence_length=None, beam_width=None, cache_indirection=None,
                       bias=None):
    """com.microsoft::DecoderMaskedMultiHeadAttention: projected decode
    attention. Self mode: 3D q/k/v, split share buffers [B,H,L,dh] and
    past_sequence_length. Cross mode: 4D key/value (the encoder's constant
    KV) and no past: the queries attend everything but what mask_index or
    attention_bias hides."""
    what = "DecoderMaskedMultiHeadAttention"
    _dm_guards(ctx, what, cache_indirection)
    heads = int(ctx.attr("num_heads", 0))
    if not heads:
        raise ValueError(f"{what} requires num_heads")
    if past_key is not None and not int(ctx.attr("past_present_share_buffer", 0)):
        raise NotImplementedError(f"{what}: only the past_present_share_buffer=1 form "
                                  "exists in ORT exports")
    if bias is not None:
        dq = query.shape[-1]
        query = query + bias[:dq]
        if key is not None and key.dim() == 3:
            dk = key.shape[-1]
            key = key + bias[dq:dq + dk]
            value = value + bias[dq + dk:]
    q = _bhsd(query, heads)
    if key is None or value is None:
        raise ValueError(f"{what} requires key and value")
    if key.dim() == 4:  # cross mode: already [B,H,T,dh]
        k, v = key, value
    else:
        k, v = _bhsd(key, heads), _bhsd(value, heads)
    y, k_all, v_all = _dm_core(ctx, q, k, v, past_key, past_value, past_sequence_length,
                               mask_index, attention_bias, what)
    n_out = _n_out(ctx)
    if n_out <= 1:
        return y
    return (y, k_all, v_all)[:n_out]
