"""Quantization emitters (counterpart of lele_tpu/ops/quant_ops.py):
DynamicQuantizeLinear and MatMulInteger, with exact ONNX semantics.

Quantization divides by the scale and rounds half to even (numpy's and
torch's `round`), as the spec and the JAX emitter do.

MatMulInteger on a card runs as the JAX emitter does: u8 operands and their
zero points shift into the i8 domain, the product runs on kernel 11
(`int8_matmul`, csrc/int8_gemm.cu; i8 × i8 → i32, exact), and the zero
points come back as rank-1 corrections in int32. A static weight is shifted
and its column sums formed once, while tracing (`prepare_weight_i8`), on
either device. On the CPU, and as the
card's plain oracle (`overrides={"MatMulInteger": matmul_integer_plain}`),
the exact int32 sum is a float64 product of the centred operands: every
operand is an integer below 2^8 in magnitude and |sum| <= K * 255 * 255 <
2^53 for any K below 2^37, so no partial sum rounds. Both routes give the
same integers.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.quant_matmul import int8_matmul
from .registry import OpContext, op


@op("DynamicQuantizeLinear")
def dynamic_quantize_linear(ctx: OpContext, x):
    """y_scale = (max(x,0)-min(x,0))/255; zp = round(clip(-min/scale,0,255))."""
    if ctx.is_fold:
        x = np.asarray(x, dtype=np.float32)
        x_min = np.minimum(np.min(x), 0.0)
        x_max = np.maximum(np.max(x), 0.0)
        scale = (x_max - x_min) / 255.0
        safe = np.where(scale == 0, np.asarray(1.0, np.float32), scale)
        zp_f = np.round(np.clip(-x_min / safe, 0.0, 255.0))
        y = np.clip(np.round(x / safe) + zp_f, 0.0, 255.0).astype(np.uint8)
        return y, scale.astype(np.float32), zp_f.astype(np.uint8)
    from ..kernels.quant_matmul import dql_quantize, dql_scale_zp

    scale, zp_f = dql_scale_zp(x)  # shared with the fused paths, bit for bit
    return dql_quantize(x, scale, zp_f).to(torch.uint8), scale, zp_f.to(torch.uint8)


def _centered_f64(v, zp, zp_axis_shape):
    """An integer operand minus its zero point, as exact float64."""
    v = v.to(torch.float64)
    if zp is None:
        return v
    zp = zp.to(torch.float64)
    return v - (zp if zp.dim() == 0 else zp.reshape(zp_axis_shape))


def matmul_integer_plain(ctx: OpContext, a, b, azp=None, bzp=None):
    """MatMulInteger as one exact float64 product: the CPU route, and an
    override (`overrides={"MatMulInteger": matmul_integer_plain}`) that
    compiles a graph's plain oracle for the card."""
    c = torch.matmul(_centered_f64(a, azp, (-1, 1)), _centered_f64(b, bzp, (1, -1)))
    return c.to(torch.int32)


def _to_i8_domain(v, zp):
    """A u8 operand and its zero point shifted by −128 into i8 (the zero
    point as int32; an absent one is 0, so −128 after the shift); i8
    operands pass through."""
    if v.dtype == torch.uint8:
        vi = (v.to(torch.int32) - 128).to(torch.int8)
        zpi = (zp.to(torch.int32) - 128 if zp is not None
               else torch.full((), -128, dtype=torch.int32, device=v.device))
        return vi, zpi
    zpi = (zp.to(torch.int32) if zp is not None
           else torch.zeros((), dtype=torch.int32, device=v.device))
    return v.to(torch.int8), zpi


def _int8_product(ai, bi, product):
    """ai [..., M, K] @ bi [..., K, N] → int32, by `product` on 2-D
    operands: A's leading dims flatten into rows when B is 2-D; otherwise
    one product per broadcast batch entry."""
    K, N = bi.shape[-2:]
    if bi.dim() == 2:
        return product(ai.reshape(-1, K), bi).reshape(*ai.shape[:-1], N)
    lead = torch.broadcast_shapes(ai.shape[:-2], bi.shape[:-2])
    a3 = ai.expand(*lead, *ai.shape[-2:]).reshape(-1, *ai.shape[-2:])
    b3 = bi.expand(*lead, K, N).reshape(-1, K, N)
    return torch.stack([product(x, w) for x, w in zip(a3, b3)]).reshape(
        *lead, ai.shape[-2], N)


def matmul_integer_i8(a, b, azp=None, bzp=None, product=int8_matmul):
    """(A − azp) @ (B − bzp) → int32 in the i8 domain: the JAX emitter's
    algebra (lele_tpu/ops/quant_ops.py:146-166) with `product` for the
    i8 × i8 → i32 dot; per-row azp [M] and per-column bzp [N] supported.
    A 1-D operand is promoted and its axis dropped again, as in matmul. B's
    shift and column sums are formed here, at every call; a static B has
    them prepared once (`prepare_weight_i8`)."""
    bi, bzp_i = _to_i8_domain(b.unsqueeze(-1) if b.dim() == 1 else b, bzp)
    colsum_b = bi.to(torch.int32).sum(dim=-2, keepdim=True, dtype=torch.int32)
    c = matmul_integer_prepared(a, bi, colsum_b, bzp_i, azp=azp, product=product)
    return c.squeeze(-1) if b.dim() == 1 else c


def _static(v) -> bool:
    return isinstance(v, (np.ndarray, np.generic))


def prepare_weight_i8(b: np.ndarray, bzp):
    """A static B and its zero point in the i8 domain, once (the JAX
    emitter's per-call shift and column sum, done at trace time): (bi int8,
    bzp_i int32 or None for a dynamic zero point, colsum_b int32 [.., 1, N])."""
    u8 = b.dtype == np.uint8
    bi = (b.astype(np.int32) - 128).astype(np.int8) if u8 else b.astype(np.int8)
    colsum = bi.astype(np.int32).sum(axis=-2, keepdims=True, dtype=np.int32)
    if bzp is None:
        bzp_i = np.asarray(-128 if u8 else 0, np.int32)
    elif _static(bzp):
        bzp_i = np.asarray(bzp).astype(np.int32) - (128 if u8 else 0)
    else:
        bzp_i = None
    return bi, bzp_i, colsum


def matmul_integer_prepared(a, bi, colsum_b, bzp_i, b_u8: bool = False, azp=None,
                            product=int8_matmul):
    """(A − azp) @ (B − bzp) → int32 on B in the i8 domain (bi, its column
    sums, its zero point bzp_i as int32; a zero point still in B's stored
    type is shifted here when B was u8): the rank-1 corrections in int32
    around one i8 product. A 1-D A is promoted and its axis dropped again."""
    ai, azp_i = _to_i8_domain(a.unsqueeze(0) if a.dim() == 1 else a, azp)
    if bzp_i.dtype != torch.int32:  # a dynamic zero point
        bzp_i = bzp_i.to(torch.int32) - (128 if b_u8 else 0)
    k = ai.shape[-1]
    c = _int8_product(ai, bi, product)
    rowsum_a = ai.to(torch.int32).sum(dim=-1, keepdim=True, dtype=torch.int32)
    azp_t = azp_i if azp_i.dim() == 0 else azp_i.reshape(-1, 1)
    bzp_t = bzp_i if bzp_i.dim() == 0 else bzp_i.reshape(1, -1)
    c = c - azp_t * colsum_b - bzp_t * rowsum_a + k * azp_t * bzp_t
    return c.squeeze(-2) if a.dim() == 1 else c


@op("MatMulInteger", foldable=False, static_args=(1, 3), records=True)
def matmul_integer(ctx: OpContext | None, a, b, azp=None, bzp=None):
    """(A - azp) @ (B - bzp) → int32; per-row azp [M] and per-column bzp
    [N] are supported. While tracing, a static B of rank >= 2 (a weight) is
    shifted into the i8 domain and its column sums formed once and hoisted
    as such (as the LSTM emitter prepares its weights): a replay runs only
    `matmul_integer_prepared`, its product on kernel 11 (the plain version
    on the CPU: the same integers). Otherwise the JAX emitter's algebra runs
    on kernel 11 on a card, the float64 product on the CPU."""
    st = ctx.state if ctx is not None else None
    if st is None:
        b, bzp = (torch.from_numpy(np.array(v)).to(a.device) if _static(v) else v
                  for v in (b, bzp))
        if a.device.type == "cpu":
            return matmul_integer_plain(ctx, a, b, azp, bzp)
        return matmul_integer_i8(a, b, azp, bzp)
    name = ctx.scope + ctx.node.input[1]
    if _static(b) and np.ndim(b) >= 2:
        bi, bzp_i, colsum = prepare_weight_i8(np.asarray(b), bzp)
        bi, colsum = st.to_device(f"{name}#i8", bi), st.to_device(f"{name}#colsum", colsum)
        bzp_i = bzp if bzp_i is None else st.to_device(f"{name}#zp_i8", bzp_i)
        return st.run(matmul_integer_prepared, a, bi, colsum, bzp_i,
                      np.asarray(b).dtype == np.uint8, azp)
    if _static(b):
        b = st.to_device(name, b)
    if _static(bzp):
        bzp = st.to_device(ctx.scope + ctx.node.input[3], bzp)
    return st.run(matmul_integer, None, a, b, azp, bzp)
