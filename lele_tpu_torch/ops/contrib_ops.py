"""com.microsoft contrib ops (counterpart of lele_tpu/ops/contrib_ops.py):
the forms ORT's optimizer and quantizer write into published exports.

The registry keys these emitters on (domain, op_type), so a contrib node
never falls into a same-named ai.onnx emitter (`Attention`,
`RotaryEmbedding`: the same names, other schemas):

- MatMulNBits: ORT's n-bit weight-only layout (packed nibbles or bytes,
  groupwise scales and zero points), the form every published int4 ONNX
  export takes. The emitter is the per-op path (`patterns=[]`): it
  dequantises on the device at every request and multiplies with plain
  torch products in full f32, as the JAX emitter leaves the dot to XLA at
  its highest precision. The compiler's `matmul_nbits_w4` pattern
  (compiler/patterns.py) instead repacks bits=4 weights once at trace time
  and sends the product through the w4 GEMM kernel (kernel 7).
- SimplifiedLayerNormalization (RMSNorm under ORT's name, in both the
  default and the com.microsoft domain, as ORT registers it),
  SkipLayerNormalization and SkipSimplifiedLayerNormalization (the
  residual-add norms, with their optional outputs as real values).
- RotaryEmbedding, contrib schema: (input, position_ids, cos_cache,
  sin_cache), on `attention_ops.apply_rotary`.
- Attention (the packed-QKV fused attention of BERT-style and GPT-2 decoder
  exports, with `_packed_qkv_attention`), FusedMatMul, QuickGelu,
  EmbedLayerNormalization, BiasGelu, FastGelu.
- GatherBlockQuantized (quantized embedding tables) and MatMulBnb4
  (bitsandbytes FP4 / NF4).

Every product is a plain f32 torch product (a card needs allow_tf32 off,
torch's default), as JAX's run at its highest precision.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .attention_ops import _n_out, apply_rotary
from .registry import OpContext, op


@op("MatMulNBits", foldable=False, domain="com.microsoft")
def matmul_nbits(ctx: OpContext, a, b, scales, zero_points=None, g_idx=None, bias=None):
    """A @ dequant(B)ᵀ for ORT's n-bit blob: bits=4 packs B as uint8
    [N, k_blocks, block/2] (two K-adjacent values a byte, low nibble first)
    with zero points packed 4-bit [N, ceil(k_blocks/2)] or one a value;
    bits=8 stores one byte a value, [N, k_blocks, block]. scales [N,
    k_blocks] (or flat); the zero point defaults to 2^(bits-1); g_idx [K]
    maps each K column to its group (GPTQ act-order); K is ceil-padded to
    the block. Without g_idx, bits=4 runs the JAX emitter's deinterleaved
    form: y = a[..., 0::2] · dq(lo)ᵀ + a[..., 1::2] · dq(hi)ᵀ."""
    K = int(ctx.attr("K"))
    N = int(ctx.attr("N"))
    bits = int(ctx.attr("bits", 4))
    block = int(ctx.attr("block_size"))
    k_blocks = (K + block - 1) // block
    if bits == 4:
        bq = b.to(torch.uint8).reshape(N, k_blocks, block // 2)
        lo, hi = bq & 0x0F, bq >> 4
        if g_idx is None:
            return _nbits4_deinterleaved(a, lo, hi, scales, zero_points, bias, K, N, block)
        vals = torch.stack([lo, hi], dim=-1).reshape(N, k_blocks * block)
    elif bits == 8:
        vals = b.to(torch.uint8).reshape(N, k_blocks * block)
    else:
        raise NotImplementedError(
            f"MatMulNBits: only bits=4 and bits=8 are implemented (got {bits})")
    w = vals.float()
    zp2 = _nbits_zp(zero_points, bits, N, k_blocks)
    sc = scales.float().reshape(N, k_blocks)
    scalar_zp = not isinstance(zp2, torch.Tensor)
    if g_idx is not None:
        g = g_idx.to(torch.long).reshape(-1)
        w = w[:, :K]
        zp_g = zp2 if scalar_zp else zp2[:, g]
        w = (w - zp_g) * sc[:, g]
    else:
        zb = zp2 if scalar_zp else zp2[:, :, None]
        w = ((w.reshape(N, k_blocks, block) - zb) * sc[:, :, None])
        w = w.reshape(N, k_blocks * block)[:, :K]  # trim the ceil padding
    adt = a.dtype
    pet = torch.promote_types(adt, torch.float32)
    lead = a.shape[:-1]
    w = w.to(adt).to(pet)  # the JAX emitter casts w to a's type first
    out = (a.reshape(-1, K).to(pet) @ w.T).reshape(*lead, N).to(adt)
    if bias is not None:
        out = out + bias
    return out


def _nbits_zp(zero_points, bits: int, N: int, k_blocks: int):
    """Zero points as f32 [N, k_blocks] (or the scalar 2^(bits-1) default);
    bits=4 ones may come packed two a byte along k_blocks. Takes a numpy
    array (the pattern, at trace time) or a tensor (the emitter)."""
    if zero_points is None:
        return np.float32(1 << (bits - 1))
    z = zero_points
    is_np = isinstance(z, np.ndarray)
    u8 = z.dtype == (np.uint8 if is_np else torch.uint8)
    packed_len = N * ((k_blocks + 1) // 2)
    if bits == 4 and u8 and (z.size if is_np else z.numel()) == packed_len:
        zpk = z.reshape(N, (k_blocks + 1) // 2)
        stack = np.stack if is_np else torch.stack
        z = stack([zpk & 0x0F, zpk >> 4], -1).reshape(N, -1)[:, :k_blocks]
    else:
        z = z.reshape(N, k_blocks)
    return z.astype(np.float32) if is_np else z.float()


def _nbits4_deinterleaved(a, lo, hi, scales, zero_points, bias, K: int, N: int,
                          block: int):
    """bits=4 without g_idx: ORT packs K-adjacent pairs, so even K columns
    are the low plane and odd ones the high plane. Each plane is
    dequantised in its packed order and multiplied by the matching columns
    of a; a K that the block ceil-pads is padded with zero columns of a."""
    k_blocks = (K + block - 1) // block
    zp2 = _nbits_zp(zero_points, 4, N, k_blocks)
    sc = scales.float().reshape(N, k_blocks)[:, :, None]
    zb = zp2[:, :, None] if isinstance(zp2, torch.Tensor) else zp2
    half = k_blocks * block // 2
    dq_lo = ((lo.float() - zb) * sc).reshape(N, half)
    dq_hi = ((hi.float() - zb) * sc).reshape(N, half)
    adt = a.dtype
    pet = torch.promote_types(adt, torch.float32)
    dq_lo, dq_hi = dq_lo.to(adt).to(pet), dq_hi.to(adt).to(pet)
    lead = a.shape[:-1]
    a2 = a.reshape(-1, K)
    if k_blocks * block != K:
        a2 = F.pad(a2, (0, k_blocks * block - K))
    a3 = a2.reshape(a2.shape[0], half, 2).to(pet)
    out = a3[:, :, 0] @ dq_lo.T + a3[:, :, 1] @ dq_hi.T
    out = out.reshape(*lead, N).to(adt)
    if bias is not None:
        out = out + bias
    return out


def _f32(dt: torch.dtype) -> torch.dtype:
    return torch.promote_types(dt, torch.float32)


def _nk_dot(a, w, K: int, N: int):
    """a[..., K] · w[N, K]ᵀ, w rounded to a's type, summed in f32 or wider."""
    adt = a.dtype
    pet = _f32(adt)
    lead = a.shape[:-1]
    out = a.reshape(-1, K).to(pet) @ w.to(adt).to(pet).T
    return out.reshape(*lead, N).to(adt)


@op("SimplifiedLayerNormalization", foldable=False)  # ORT's kOnnxDomain entry
@op("SimplifiedLayerNormalization", foldable=False, domain="com.microsoft")
def simplified_layer_norm(ctx: OpContext, x, weight):
    """RMSNorm under its onnxruntime name. Like LayerNormalization, the mean
    square reduces over [axis, rank), not over one axis."""
    eps = float(ctx.attr("epsilon", 1e-5))
    axis = int(ctx.attr("axis", -1)) % x.dim()
    red = tuple(range(axis, x.dim()))
    xf = x.to(_f32(x.dtype))
    ms = (xf * xf).mean(dim=red, keepdim=True)
    return (xf * torch.rsqrt(ms + eps)).to(x.dtype) * weight


@op("SkipLayerNormalization", foldable=False, domain="com.microsoft")
def skip_layer_norm(ctx: OpContext, x, skip, gamma, beta=None, bias=None):
    """LN(x + skip [+ bias]); the optional outputs are (mean, inv_std_var,
    input_skip_bias_sum)."""
    eps = float(ctx.attr("epsilon", 1e-12))
    s = x + skip
    if bias is not None:
        s = s + bias
    sf = s.to(_f32(s.dtype))
    mean = sf.mean(dim=-1, keepdim=True)
    var = ((sf - mean) ** 2).mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps)
    y = ((sf - mean) * inv).to(s.dtype) * gamma
    if beta is not None:
        y = y + beta
    n_out = _n_out(ctx)
    if n_out <= 1:
        return y
    return (y, mean.to(s.dtype), inv.to(s.dtype), s)[:n_out]


@op("SkipSimplifiedLayerNormalization", foldable=False, domain="com.microsoft")
def skip_simplified_layer_norm(ctx: OpContext, x, skip, gamma, bias=None):
    """RMSNorm(x + skip [+ bias]), the residual form ORT-GenAI's model
    builder writes between decoder layers. Output 4 (input_skip_bias_sum)
    is the pre-norm sum the next layer's residual reads; output 2, the mean,
    is zero (RMSNorm has none)."""
    eps = float(ctx.attr("epsilon", 1e-12))
    s = x + skip
    if bias is not None:
        s = s + bias
    sf = s.to(_f32(s.dtype))
    inv = torch.rsqrt((sf * sf).mean(dim=-1, keepdim=True) + eps)
    y = (sf * inv).to(s.dtype) * gamma
    n_out = _n_out(ctx)
    if n_out <= 1:
        return y
    return (y, torch.zeros_like(inv, dtype=s.dtype), inv.to(s.dtype), s)[:n_out]


@op("FusedMatMul", foldable=False, domain="com.microsoft")
def fused_matmul(ctx: OpContext, a, b):
    if ctx.attr("transBatchA", 0) or ctx.attr("transBatchB", 0):
        raise NotImplementedError("FusedMatMul: transBatch* not supported")
    if ctx.attr("transA", 0):
        a = a.transpose(-1, -2)
    if ctx.attr("transB", 0):
        b = b.transpose(-1, -2)
    alpha = float(ctx.attr("alpha", 1.0))
    out = torch.matmul(a, b)
    return out * alpha if alpha != 1.0 else out


@op("QuickGelu", foldable=False, domain="com.microsoft")
def quick_gelu(ctx: OpContext, x):
    return x * torch.sigmoid(float(ctx.attr("alpha", 1.702)) * x)


@op("EmbedLayerNormalization", foldable=False, domain="com.microsoft")
def embed_layer_norm(ctx: OpContext, input_ids, segment_ids, word_emb, pos_emb,
                     seg_emb=None, gamma=None, beta=None, mask=None, position_ids=None):
    """BERT's fused word + position + segment embedding, then LayerNorm.
    Outputs (output, mask_index: each row's count of valid tokens,
    embedding_sum)."""
    eps = float(ctx.attr("epsilon", 1e-12))
    ids = input_ids.long()
    b, s = ids.shape
    emb = word_emb[ids]
    if position_ids is not None:
        emb = emb + pos_emb[position_ids.long()]
    else:
        emb = emb + pos_emb[None, :s, :]
    if seg_emb is not None:
        if segment_ids is None:
            raise ValueError("EmbedLayerNormalization: segment_embedding given without "
                             "segment_ids")
        emb = emb + seg_emb[segment_ids.long()]
    ef = emb.to(_f32(emb.dtype))
    mean = ef.mean(dim=-1, keepdim=True)
    var = ((ef - mean) ** 2).mean(dim=-1, keepdim=True)
    y = ((ef - mean) * torch.rsqrt(var + eps)).to(emb.dtype)
    if gamma is not None:
        y = y * gamma
    if beta is not None:
        y = y + beta
    if mask is not None:
        mask_index = mask.to(torch.int32).sum(dim=1, dtype=torch.int32)
    else:
        mask_index = torch.zeros((b,), dtype=torch.int32, device=emb.device)
    n_out = _n_out(ctx)
    if n_out <= 1:
        return y
    return (y, mask_index, emb)[:n_out]


@op("BiasGelu", foldable=False, domain="com.microsoft")
def bias_gelu(ctx: OpContext, x, bias):
    return F.gelu(x + bias)


@op("FastGelu", foldable=False, domain="com.microsoft")
def fast_gelu(ctx: OpContext, x, bias=None):
    if bias is not None:
        x = x + bias
    return F.gelu(x, approximate="tanh")


@op("Attention", foldable=False, domain="com.microsoft")
def ms_attention(ctx: OpContext, x, weights, bias=None, mask_index=None, past=None,
                 attention_bias=None, past_seq_len=None):
    """com.microsoft::Attention: the packed-QKV attention of BERT-style and
    GPT-2 decoder exports. qkv packed in one weight [D, 3·H·dh] (+ bias);
    mask_index None, [B] right-side key lengths or a [B, total_kv] padding
    mask; `unidirectional` causal masking; additive `attention_bias`; the
    stacked [2, B, H, P, dh] past, concatenated, with the updated stack as
    output 2. past_present_share_buffer (with past_seq_len) and asymmetric
    qkv_hidden_sizes raise, as in JAX."""
    if past_seq_len is not None or ctx.attr("past_present_share_buffer", 0):
        raise NotImplementedError(
            "com.microsoft::Attention: past_present_share_buffer is not supported: "
            "ORT-GenAI exports carry GroupQueryAttention for the static-buffer cache, "
            "which is implemented")
    heads = int(ctx.attr("num_heads", 0))
    if not heads:
        raise ValueError("com.microsoft::Attention requires num_heads")
    qkv_sizes = ctx.attr_ints("qkv_hidden_sizes")
    if qkv_sizes and len(set(qkv_sizes)) != 1:
        raise NotImplementedError("com.microsoft::Attention: asymmetric "
                                  "qkv_hidden_sizes not supported")
    unidir = bool(ctx.attr("unidirectional", 0))
    qkv = torch.matmul(x, weights)
    if bias is not None:
        qkv = qkv + bias
    return _packed_qkv_attention(ctx, qkv, heads, unidir, mask_index, past, attention_bias)


def _packed_qkv_attention(ctx: OpContext, qkv, heads, unidir, mask_index, past,
                          attention_bias):
    """The post-projection core of the packed-QKV contrib attentions: split
    heads, concatenate the past, mask per ORT's mask_index convention (the
    masked scores replaced by -1e9), softmax in f32, weighted sum.
    qkv: [B, S, 3·H·dh]."""
    b, s, h3 = qkv.shape
    dh = h3 // 3 // heads
    q, k, v = qkv.chunk(3, dim=-1)

    def split_heads(t):
        return t.reshape(b, s, heads, dh).permute(0, 2, 1, 3)

    q, k, v = split_heads(q), split_heads(k), split_heads(v)
    if past is not None:  # stacked [2, B, H, P, dh]
        k = torch.cat([past[0], k], dim=2)
        v = torch.cat([past[1], v], dim=2)
    t = k.shape[2]
    present = torch.stack([k, v], dim=0)
    scale = ctx.attr("scale")
    scale = float(scale) if scale is not None else 1.0 / float(np.sqrt(dh))
    acc = _f32(qkv.dtype)
    att = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2)) * scale
    if attention_bias is not None:
        att = att + attention_bias.to(att.dtype)
    dev = qkv.device
    if mask_index is not None:
        mi = mask_index
        if mi.dim() == 1 and mi.shape[0] == b:  # right-side lengths over the total kv
            valid = torch.arange(t, device=dev)[None, :] < mi.long()[:, None]
            att = att.masked_fill(~valid[:, None, None, :], -1e9)
        elif mi.dim() == 2 and tuple(mi.shape) == (b, t):
            att = att.masked_fill(~mi.bool()[:, None, None, :], -1e9)
        else:
            raise NotImplementedError(
                "com.microsoft::Attention: only [batch] right-side lengths or [batch, "
                f"total_kv] key padding masks supported, got shape {tuple(mi.shape)}")
    if unidir:  # query row i sits at global position (t - s) + i
        causal = (torch.arange(t, device=dev)[None, :]
                  <= (t - s + torch.arange(s, device=dev))[:, None])
        att = att.masked_fill(~causal[None, None], -1e9)
    w_att = torch.softmax(att.to(_f32(att.dtype)), dim=-1)
    y = torch.matmul(w_att.to(v.dtype).to(acc), v.to(acc)).to(v.dtype)
    y = y.permute(0, 2, 1, 3).reshape(b, s, heads * dh)
    n_out = _n_out(ctx)
    if n_out <= 1:
        return y
    return (y, present)[:n_out]


@op("RotaryEmbedding", foldable=False, domain="com.microsoft")
def ms_rotary_embedding(ctx: OpContext, x, position_ids, cos_cache, sin_cache):
    """com.microsoft::RotaryEmbedding (ORT-GenAI decoder exports). Its inputs
    are (input, position_ids, cos_cache, sin_cache), not the opset-23
    order. input: [B, S, hidden] (num_heads, or heads inferred from the
    cache) or [B, H, S, head]; position_ids: [1] (a start position, the
    decode step) or [B, S]; caches [max_pos, rot/2]. scale != 1 and
    is_packed_batching raise."""
    if float(ctx.attr("scale", 1.0)) != 1.0:
        raise NotImplementedError("com.microsoft::RotaryEmbedding: scale != 1.0 not "
                                  "supported")
    if int(ctx.attr("is_packed_batching", 0)):
        raise NotImplementedError(
            "com.microsoft::RotaryEmbedding: is_packed_batching (varlen packed batches) "
            "not supported: unpack to [B, S, H] first")
    interleaved = bool(ctx.attr("interleaved", 0))
    rot_dim = int(ctx.attr("rotary_embedding_dim", 0))
    three_d = x.dim() == 3
    if three_d:
        b, s, hidden = x.shape
        nh = int(ctx.attr("num_heads", 0))
        if not nh:
            if rot_dim:
                raise ValueError(
                    "com.microsoft::RotaryEmbedding: num_heads is required for 3D input "
                    "with rotary_embedding_dim set (head size cannot be inferred from the "
                    "cache)")
            head = int(cos_cache.shape[-1]) * 2  # full-head rotation
            if hidden % head:
                raise ValueError(f"com.microsoft::RotaryEmbedding: hidden {hidden} not "
                                 f"divisible by inferred head size {head}")
            nh = hidden // head
        orig = tuple(x.shape)
        x = x.reshape(b, s, nh, hidden // nh).permute(0, 2, 1, 3)
    b, _h, s, head = x.shape
    r = rot_dim or (int(cos_cache.shape[-1]) * 2)
    if r > head:
        raise ValueError(f"com.microsoft::RotaryEmbedding: rotary dim {r} exceeds head "
                         f"size {head}")
    pos = _positions(position_ids, b, s, "com.microsoft::RotaryEmbedding")
    cos = cos_cache[pos][:, None, :, : r // 2]  # [B,1,S,r/2]
    sin = sin_cache[pos][:, None, :, : r // 2]
    out = apply_rotary(x, cos, sin, r, interleaved)
    if three_d:
        out = out.permute(0, 2, 1, 3).reshape(orig)
    return out


def _positions(position_ids, b: int, s: int, what: str):
    """[B, S] positions from [1] (a start position: start + arange(S)) or
    [B, S] position_ids, on the device (no host read)."""
    pid = position_ids.long()
    if pid.dim() <= 1 and pid.numel() == 1:
        pos = pid.reshape(()) + torch.arange(s, device=pid.device)
        return pos[None, :].expand(b, s)
    if pid.dim() == 2:
        return pid
    raise ValueError(f"{what}: position_ids must be shape [1] or [batch, seq], got "
                     f"{tuple(position_ids.shape)}")


def _unpack_axis(d, axis: int):
    """uint8 bytes → their two nibbles along `axis` (low first)."""
    vals = torch.stack([d & 0x0F, d >> 4], dim=axis + 1)
    shp = list(d.shape)
    shp[axis] *= 2
    return vals.reshape(shp)


def _trim_axis(t, axis: int, n: int):
    sl = [slice(None)] * t.dim()
    sl[axis] = slice(0, n)
    return t[tuple(sl)]


@op("GatherBlockQuantized", foldable=False, domain="com.microsoft")
def gather_block_quantized(ctx: OpContext, data, indices, scales, zero_points=None):
    """Gather over a block-quantized table (the quantized embedding and tied
    head of ORT-GenAI exports). data: int4 / uint4 (unpacked by the loader to
    int8 / uint8) or uint8 packed two a byte along quantize_axis, told apart
    by the scales' block count; zero_points like scales, packed 4-bit
    allowed, defaulting to the midpoint (0 signed, 8 unsigned). The rows
    are gathered first and only they are dequantised."""
    nd = data.dim()
    gather_axis = int(ctx.attr("gather_axis", 0)) % nd
    q_axis = int(ctx.attr("quantize_axis", 1)) % nd
    block = int(ctx.attr("block_size", 128))
    if gather_axis == q_axis:
        raise NotImplementedError(
            "GatherBlockQuantized: gather_axis == quantize_axis is not supported (no "
            "published export gathers along the quantized axis)")
    blocks = int(scales.shape[q_axis])
    d_q = int(data.shape[q_axis])
    signed = data.dtype == torch.int8
    unpacked = -(-d_q // block) == blocks
    if data.dtype == torch.uint8 and not unpacked and -(-2 * d_q // block) == blocks:
        vals = _unpack_axis(data, q_axis)
    elif unpacked:
        vals = data
    else:
        raise ValueError(
            f"GatherBlockQuantized: data dim {d_q} along quantize_axis {q_axis} matches "
            f"neither unpacked nor packed layout for {blocks} blocks of {block}")
    idx = indices.long().reshape(-1)
    g_vals = vals.index_select(gather_axis, idx)
    n_q = g_vals.shape[q_axis]
    if zero_points is None:
        g_zp = 0.0 if signed else 8.0
    else:
        zp = zero_points
        if tuple(zp.shape) != tuple(scales.shape):  # packed 4-bit zero points
            z2 = _trim_axis(_unpack_axis(zp.to(torch.uint8), q_axis), q_axis, blocks)
            zp = torch.where(z2 > 7, z2.int() - 16, z2.int()) if signed else z2
        g_zp = zp.float().index_select(gather_axis, idx)
        g_zp = _trim_axis(g_zp.repeat_interleave(block, dim=q_axis), q_axis, n_q)
    sc = scales.float().index_select(gather_axis, idx)
    sc = _trim_axis(sc.repeat_interleave(block, dim=q_axis), q_axis, n_q)
    out = ((g_vals.float() - g_zp) * sc).to(scales.dtype)
    out_shape = (tuple(out.shape[:gather_axis]) + tuple(indices.shape)
                 + tuple(out.shape[gather_axis + 1:]))
    return out.reshape(out_shape)


# bitsandbytes' 4-bit dequantisation tables (MatMulBnb4's quant_type 0 = FP4:
# 1 sign, 2 exponent, 1 mantissa bits; 1 = NF4: 16 normal quantiles)
_FP4_LUT = np.array(
    [0.0, 0.0625, 8.0, 12.0, 4.0, 6.0, 2.0, 3.0,
     -0.0, -0.0625, -8.0, -12.0, -4.0, -6.0, -2.0, -3.0], np.float32)
_NF4_LUT = np.array(
    [-1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
     -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
     0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
     0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
     0.7229568362236023, 1.0], np.float32)
_LUTS: dict = {}  # (quant_type, device) → the table on that device, made once


def _bnb4_lut(quant_type: int, device) -> torch.Tensor:
    key = (quant_type, str(device))
    if key not in _LUTS:
        _LUTS[key] = torch.from_numpy(_FP4_LUT if quant_type == 0 else _NF4_LUT).to(device)
    return _LUTS[key]


@op("MatMulBnb4", foldable=False, domain="com.microsoft")
def matmul_bnb4(ctx: OpContext, a, b, absmax):
    """A @ dequant(B)ᵀ for bitsandbytes' 4-bit blockwise layout: B is a flat
    uint8 buffer of the row-major [N, K] codes, two a byte, the first code in
    the HIGH nibble (the opposite of MatMulNBits); absmax one f32 a run of
    block_size codes; value = LUT[code] · absmax[i // block_size]."""
    K = int(ctx.attr("K"))
    N = int(ctx.attr("N"))
    block = int(ctx.attr("block_size"))
    lut = _bnb4_lut(int(ctx.attr("quant_type", 1)), a.device)
    bb = b.to(torch.uint8).reshape(-1)
    codes = torch.stack([bb >> 4, bb & 0x0F], dim=-1).reshape(-1)[: N * K]
    w = lut[codes.long()]
    scale = absmax.float().repeat_interleave(block)[: N * K]
    return _nk_dot(a, (w * scale).reshape(N, K), K, N)
