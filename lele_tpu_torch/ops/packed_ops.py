"""com.microsoft varlen ("effective transformer") ops: RemovePadding,
RestorePadding, PackedAttention, PackedMultiHeadAttention (counterpart of
lele_tpu/ops/packed_ops.py).

ORT's GPU transformer optimizer rewrites padded BERT batches into a packed
token stream: RemovePadding compacts [B, S, H] to the valid tokens, the
Packed* attentions run over the stream by cumulative sequence lengths, and
RestorePadding scatters back. In ORT the packed length is a dynamic dimension
(the real tokens); a static program keeps the bucketed worst case, as the JAX
package does: the packed dimension is B·S, the compaction is a stable argsort
(valid tokens first, in row-major order: ORT's token_offset), and how many
are real is carried as data (cumulated_seq_len), not as a shape. RestorePadding
zero-fills padding positions and the packed attentions mask keys by each
sequence's length, so the dead tail rows never reach a real output. The
attention is f32 torch, as JAX's einsums are.
"""

from __future__ import annotations

import numpy as np
import torch

from .registry import OpContext, op


def _acc(dt: torch.dtype) -> torch.dtype:
    return torch.promote_types(dt, torch.float32)


def _token_order(seq_lens, b: int, s: int):
    """The stable permutation of [0, B·S) with the valid (row-major) tokens
    first: ORT's token_offset. seq_lens [B] int."""
    valid = (torch.arange(s, device=seq_lens.device)[None, :]
             < seq_lens.reshape(b, 1).to(torch.int32))
    return torch.argsort(torch.where(valid, 0, 1).reshape(-1), stable=True).to(torch.int32)


@op("RemovePadding", foldable=False, domain="com.microsoft")
def remove_padding(ctx: OpContext, x, sequence_token_count):
    """com.microsoft::RemovePadding: [B,S,H] + per-batch lengths → (packed
    [B·S, H] with the valid tokens compacted to the front, token_offset
    [B,S], cumulated_seq_len [B+1], max_seq_len [1])."""
    b, s, h = x.shape
    lens = sequence_token_count.reshape(b).to(torch.int32)
    order = _token_order(lens, b, s)
    packed = x.reshape(b * s, h)[order.long()]
    cum = torch.cat([lens.new_zeros(1), lens.cumsum(0, dtype=torch.int32)])
    outs = (packed, order.reshape(b, s), cum, lens.amax().reshape(1))
    n_out = len(ctx.node.output) if ctx.node is not None else 4
    return outs[:n_out] if n_out > 1 else outs[0]


@op("RestorePadding", foldable=False, domain="com.microsoft")
def restore_padding(ctx: OpContext, x, token_offset):
    """com.microsoft::RestorePadding: packed [B·S, H] + token_offset →
    [B, S, H] with padding positions zero (the ORT contract).

    The real-token count, a dynamic shape in ORT, is recovered from
    token_offset as JAX recovers it: the real prefix is strictly ascending
    (row-major compaction) and the first descent marks where the padding
    ranks begin. JAX's disclosed deviation holds too: with every padding
    position in the tail of the last row, token_offset is the identity and
    those positions pass through instead of zeroing."""
    b, s = token_offset.shape
    n = b * s
    h = x.shape[-1]
    off = token_offset.reshape(n).long()
    descent = off[1:] < off[:-1]
    total = torch.where(descent.any(), descent.to(torch.int32).argmax() + 1, n)
    real = torch.arange(n, device=x.device) < total
    vals = torch.where(real[:, None], x.reshape(n, h), 0).to(x.dtype)
    out = torch.zeros((n, h), dtype=x.dtype, device=x.device).index_copy(0, off, vals)
    return out.reshape(b, s, h)


def _packed_mha_core(ctx: OpContext, q, k, v, token_offset, cum_seq, attention_bias,
                     heads: int):
    """The shared packed-attention core: q/k/v [B·S, H, dh] (split),
    token_offset [B,S], cum_seq [B+1] → the packed output [B·S, H·dh]."""
    b, s = token_offset.shape
    n = b * s
    off = token_offset.reshape(n).long()
    inv = torch.zeros_like(off).index_copy_(0, off, torch.arange(n, device=off.device))
    lens = (cum_seq[1:] - cum_seq[:-1]).to(torch.int32)
    valid = torch.arange(s, device=off.device)[None, :] < lens[:, None]  # [B,S]

    def unpack(t):  # [B·S, H, dh] → [B, H, S, dh]
        return t[inv].reshape(b, s, *t.shape[1:]).permute(0, 2, 1, 3)

    qp, kp, vp = unpack(q), unpack(k), unpack(v)
    dh = qp.shape[-1]
    scale = ctx.attr("scale")
    scale = float(scale) if scale else 1.0 / float(np.sqrt(dh))
    acc = _acc(qp.dtype)
    att = torch.matmul(qp.to(acc), kp.to(acc).transpose(-1, -2)) * scale
    if attention_bias is not None:
        att = att + attention_bias.to(att.dtype)
    att = torch.where(valid[:, None, None, :], att, -1e9)
    w = torch.softmax(att.to(_acc(att.dtype)), dim=-1)
    y = torch.matmul(w.to(vp.dtype).to(_acc(vp.dtype)), vp.to(_acc(vp.dtype))).to(vp.dtype)
    y = y.permute(0, 2, 1, 3).reshape(n, heads * dh)
    return y[off]  # re-packed


@op("PackedMultiHeadAttention", foldable=False, domain="com.microsoft")
def packed_mha(ctx: OpContext, query, key=None, value=None, bias=None, token_offset=None,
               cumulative_sequence_length=None, attention_bias=None):
    """com.microsoft::PackedMultiHeadAttention: MHA over the compacted token
    stream. query [total, H·dh] with key and value alike, or packed QKV
    [total, H, 3, dh] with key and value absent; bias is the fused [q|k|v]
    projection bias."""
    heads = int(ctx.attr("num_heads", 0))
    if not heads:
        raise ValueError("PackedMultiHeadAttention requires num_heads")
    if token_offset is None or cumulative_sequence_length is None:
        raise ValueError("PackedMultiHeadAttention requires token_offset and "
                         "cumulative_sequence_length")
    if query.dim() == 4:  # packed [total, H, 3, dh]
        if key is not None or value is not None:
            raise ValueError("PackedMultiHeadAttention: packed QKV forbids key/value")
        if bias is not None:
            raise NotImplementedError("PackedMultiHeadAttention: bias with packed QKV is "
                                      "not supported")
        q, k, v = query[:, :, 0], query[:, :, 1], query[:, :, 2]
    else:
        if key is None or value is None:
            raise ValueError("PackedMultiHeadAttention: 3-input form needs key/value")
        if bias is not None:
            d = query.shape[-1]
            query = query + bias[:d]
            key = key + bias[d:2 * d]
            value = value + bias[2 * d:]
        n = query.shape[0]
        q, k, v = (t.reshape(n, heads, -1) for t in (query, key, value))
    out = _packed_mha_core(ctx, q, k, v, token_offset, cumulative_sequence_length,
                           attention_bias, heads)
    return out.to(query.dtype)


@op("PackedAttention", foldable=False, domain="com.microsoft")
def packed_attention(ctx: OpContext, x, weights, bias=None, token_offset=None,
                     cumulative_sequence_length=None, attention_bias=None):
    """com.microsoft::PackedAttention: the fused-projection twin (input
    [total, D] @ weights [D, 3·H·dh] + bias, then the packed MHA core).
    Asymmetric qkv_hidden_sizes are refused, as for contrib Attention."""
    heads = int(ctx.attr("num_heads", 0))
    if not heads:
        raise ValueError("PackedAttention requires num_heads")
    sizes = ctx.attr_ints("qkv_hidden_sizes")
    if sizes and len(set(sizes)) != 1:
        raise NotImplementedError("PackedAttention: asymmetric qkv_hidden_sizes not "
                                  "supported")
    if token_offset is None or cumulative_sequence_length is None:
        raise ValueError("PackedAttention requires token_offset and "
                         "cumulative_sequence_length")
    acc = _acc(x.dtype)
    qkv = torch.matmul(x.to(acc), weights.to(acc)).to(torch.promote_types(x.dtype,
                                                                          weights.dtype))
    if bias is not None:
        qkv = qkv + bias
    n = qkv.shape[0]
    dh = qkv.shape[-1] // 3 // heads
    q, k, v = qkv.chunk(3, dim=-1)
    out = _packed_mha_core(ctx, q.reshape(n, heads, dh), k.reshape(n, heads, dh),
                           v.reshape(n, heads, dh), token_offset, cumulative_sequence_length,
                           attention_bias, heads)
    return out.to(x.dtype)
