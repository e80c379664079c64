"""com.microsoft contrib ops (counterpart of lele_tpu/ops/contrib_ops.py).

The registry keys these emitters on (domain, op_type), so a contrib node
never falls into a same-named ai.onnx emitter. Ported so far:

- MatMulNBits: ORT's n-bit weight-only layout (packed nibbles or bytes,
  groupwise scales and zero points), the form every published int4 ONNX
  export takes.

The emitter is the per-op path (`patterns=[]`): it dequantises on the device
at every request and multiplies with plain torch products in full f32 (a
card needs allow_tf32 off, torch's default), as the JAX emitter leaves the
dot to XLA at its highest precision. The compiler's `matmul_nbits_w4`
pattern (compiler/patterns.py) instead repacks bits=4 weights once at trace
time and sends the product through the w4 GEMM kernel.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

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
