"""com.microsoft QLinear* (QOperator-format) emitters: counterpart of
lele_tpu/ops/qlinear_ops.py.

ORT's static int8 quantizer writes one of two formats: QDQ (Quantize/
Dequantize pairs around float ops, ops/quant_ops.py) and QOperator, which
rewrites each float op into a fused com.microsoft QLinear* node carrying
its own scales and zero points. The published ORT-quantized CNNs are in
QOperator form.

Semantics, shared by the family (ORT's kernel contract):
    y = saturate(round_half_even(f(dequant(inputs)) / y_scale) + y_zp)
with f computed in f32 from the dequantized inputs, each elementwise step
a torch op of its own in JAX's order (no fused kernel, so no contraction
moves a code at the half-step). Every integer product (QGemm,
MatMulIntegerToFloat, DynamicQuantizeMatMul, QAttention) is the
MatMulInteger core of ops/quant_ops.py: kernel 11 on a card, a constant
weight shifted and its column sums formed once while tracing.
"""

from __future__ import annotations

import numpy as np
import torch

from .quant_ops import _np_dtype as _qdt
from .quant_ops import dynamic_quantize_linear, matmul_i32, weight_prep
from .registry import OpContext, op


def _dq(x, scale, zp=None):
    xf = x.to(torch.float32)
    if zp is not None:
        xf = xf - zp.to(torch.float32)
    return xf * scale.to(torch.float32)


def _q(y, scale, zp, qdt=None):
    from .tensor_ops import torch_dtype

    if qdt is None:
        qdt = _qdt(zp) if zp is not None else np.dtype(np.uint8)
    info = np.iinfo(qdt)
    yq = torch.round(y / scale.to(torch.float32))
    if zp is not None:
        yq = yq + zp.to(torch.float32)
    return torch.clamp(yq, int(info.min), int(info.max)).to(torch_dtype(qdt))


@op("QLinearAdd", foldable=False, domain="com.microsoft")
def qlinear_add(ctx: OpContext, a, a_scale, a_zp, b, b_scale, b_zp, c_scale, c_zp=None):
    return _q(_dq(a, a_scale, a_zp) + _dq(b, b_scale, b_zp), c_scale, c_zp, _qdt(a))


@op("QLinearMul", foldable=False, domain="com.microsoft")
def qlinear_mul(ctx: OpContext, a, a_scale, a_zp, b, b_scale, b_zp, c_scale, c_zp=None):
    return _q(_dq(a, a_scale, a_zp) * _dq(b, b_scale, b_zp), c_scale, c_zp, _qdt(a))


@op("QLinearSigmoid", foldable=False, domain="com.microsoft")
def qlinear_sigmoid(ctx: OpContext, x, x_scale, x_zp, y_scale, y_zp=None):
    return _q(torch.sigmoid(_dq(x, x_scale, x_zp)), y_scale, y_zp, _qdt(x))


@op("QLinearLeakyRelu", foldable=False, domain="com.microsoft")
def qlinear_leaky_relu(ctx: OpContext, x, x_scale, x_zp, y_scale, y_zp=None):
    alpha = float(np.float32(ctx.attr("alpha", 0.01)))
    xf = _dq(x, x_scale, x_zp)
    return _q(torch.where(xf < 0, alpha * xf, xf), y_scale, y_zp, _qdt(x))


@op("QLinearSoftmax", foldable=False, domain="com.microsoft")
def qlinear_softmax(ctx: OpContext, x, x_scale, x_zp, y_scale, y_zp=None):
    """The `opset` attribute selects the ai.onnx Softmax semantics of the
    float core (the quantizer records the model's opset): below 13 the
    flatten-to-2-D rule, from 13 on one axis."""
    xf = _dq(x, x_scale, x_zp)
    if int(ctx.attr("opset", 13)) >= 13:
        sm = torch.softmax(xf, dim=ctx.attr("axis", -1))
    else:
        shape = tuple(xf.shape)
        axis = ctx.attr("axis", 1)
        axis = axis if axis >= 0 else axis + len(shape)
        lead = int(np.prod(shape[:axis])) if axis else 1
        sm = torch.softmax(xf.reshape(lead, -1), dim=-1).reshape(shape)
    return _q(sm, y_scale, y_zp, _qdt(x))


def _nhwc_to_nchw(x):
    rank = x.dim()
    return x.permute(0, rank - 1, *range(1, rank - 1))


def _nchw_to_nhwc(x):
    return x.permute(0, *range(2, x.dim()), 1)


@op("QLinearAveragePool", foldable=False, domain="com.microsoft")
def qlinear_average_pool(ctx: OpContext, x, x_scale, x_zp, y_scale, y_zp=None):
    from .nn_ops import average_pool

    last = int(ctx.attr("channels_last", 0))
    xf = _dq(x, x_scale, x_zp)
    y = average_pool(ctx, _nhwc_to_nchw(xf) if last else xf)
    return _q(_nchw_to_nhwc(y) if last else y, y_scale, y_zp, _qdt(x))


@op("QLinearGlobalAveragePool", foldable=False, domain="com.microsoft")
def qlinear_global_average_pool(ctx: OpContext, x, x_scale, x_zp, y_scale, y_zp=None):
    """The mean over the spatial axes of the dequantized f32 input."""
    xf = _dq(x, x_scale, x_zp)
    axes = tuple(range(1, xf.dim() - 1)) if int(ctx.attr("channels_last", 0)) \
        else tuple(range(2, xf.dim()))
    return _q(torch.mean(xf, dim=axes, keepdim=True), y_scale, y_zp, _qdt(x))


@op("QLinearConcat", foldable=False, domain="com.microsoft")
def qlinear_concat(ctx: OpContext, y_scale, y_zp, *rest):
    """(tensor, scale, zero point) triples after the output's scale and
    zero point: each input dequantized with its own pair, concatenated
    along `axis`, requantized to the output grid."""
    if len(rest) % 3:
        raise ValueError(f"QLinearConcat: inputs after y_scale/y_zp must be "
                         f"(tensor, scale, zero_point) triples, got {len(rest)}")
    parts = [_dq(rest[i], rest[i + 1], rest[i + 2]) for i in range(0, len(rest), 3)]
    return _q(torch.cat(parts, dim=int(ctx.attr("axis"))), y_scale, y_zp, _qdt(rest[0]))


def _int_product(ctx: OpContext, a, azp, b, i_b: int, bzp, i_bzp: int, trans: bool = False):
    """(A − azp) @ (B − bzp) → int32 as a recorded step of its own: B
    (transposed first where `trans`) prepared once while tracing where it
    is a constant of the trace. Outside a trace (all inputs constant), the
    product at once."""
    st = ctx.state
    prep = weight_prep(ctx, i_b, b, i_bzp, bzp, trans) if st is not None else None
    if prep is not None:
        return st.run(matmul_i32, a, azp, prep)
    return _run(ctx, matmul_i32, a, azp, None, b, bzp, trans)


def _plain(ctx: OpContext) -> OpContext:
    """The node's attributes in a context of their own, for a recorded step
    (a step must not hold the tracer's state)."""
    return OpContext(xp=torch, attrs=dict(ctx.attrs), opset=ctx.opset)


def _run(ctx: OpContext, fn, *args):
    """fn(*args), recorded as a step when the emitter is tracing."""
    return fn(*args) if ctx.state is None else ctx.state.run(fn, *args)


def _qgemm_out(acc, c, a_scale, b_scale, alpha, y_scale, y_zp, qdt):
    if c is not None:
        acc = acc + c.to(torch.int32)
    sw = b_scale.to(torch.float32)
    if sw.dim() == 1:
        sw = sw.reshape(1, -1)
    yf = acc.to(torch.float32) * (alpha * a_scale.to(torch.float32) * sw)
    return yf if y_scale is None else _q(yf, y_scale, y_zp, qdt)


@op("QGemm", foldable=False, domain="com.microsoft", records=True)
def qgemm(ctx: OpContext, a, a_scale, a_zp, b, b_scale, b_zp, c=None, y_scale=None,
          y_zp=None):
    """Quantized Gemm: the integer product with zero-point corrections, the
    int32 bias C at scale alpha·a_scale·b_scale, then requantized, or
    dequantized to f32 when y_scale is absent (both output modes of ORT's
    schema). b_scale and b_zp may be per output column."""
    alpha = float(np.float32(ctx.attr("alpha", 1.0)))
    if int(ctx.attr("transA", 0)):
        a = _run(ctx, torch.transpose, a, -1, -2)
    acc = _int_product(ctx, a, a_zp, b, 3, b_zp, 5, trans=bool(int(ctx.attr("transB", 0))))
    return _run(ctx, _qgemm_out, acc, c, a_scale, b_scale, alpha, y_scale, y_zp, _qdt(a))


def _to_float(acc, a_scale, b_scale, bias):
    sb = b_scale.to(torch.float32)
    if sb.dim() == 1:
        sb = sb.reshape(1, -1)
    sa = a_scale.to(torch.float32)
    if sa.dim() == 1:
        sa = sa.reshape(-1, 1)
    y = acc.to(torch.float32) * (sa * sb)
    if bias is not None:
        y = y + bias.to(torch.float32)
    return y


@op("MatMulIntegerToFloat", foldable=False, domain="com.microsoft", records=True)
def matmul_integer_to_float(ctx: OpContext, a, b, a_scale, b_scale, a_zp=None, b_zp=None,
                            bias=None):
    """(A − a_zp)·(B − b_zp) · a_scale·b_scale + bias in f32: ORT's dynamic
    quantizer's MatMul fusion (MatMulInteger + Cast + Mul as one node).
    b_scale and b_zp may be per column [N]."""
    acc = _int_product(ctx, a, a_zp, b, 1, b_zp, 5)
    return _run(ctx, _to_float, acc, a_scale, b_scale, bias)


@op("DynamicQuantizeMatMul", foldable=False, domain="com.microsoft", records=True)
def dynamic_quantize_matmul(ctx: OpContext, a, b, b_scale, b_zp=None, bias=None):
    """A (f32) dynamically quantized to u8 by DynamicQuantizeLinear's rule,
    then the MatMulIntegerToFloat core: ORT's other dynamic-MatMul fusion."""
    aq, a_scale, a_zp = _run(ctx, dynamic_quantize_linear, _plain(ctx), a)
    acc = _int_product(ctx, aq, a_zp, b, 1, b_zp, 3)
    return _run(ctx, _to_float, acc, a_scale, b_scale, bias)


def _qattention_qkv(acc, input_scale, weight_scale, bias):
    sw = weight_scale.to(torch.float32)
    if sw.dim() == 1 and sw.numel() > 1:
        sw = sw.reshape(1, 1, -1)  # per output column
    qkv = acc.to(torch.float32) * (input_scale.to(torch.float32) * sw)
    if bias is not None:
        qkv = qkv + bias.to(torch.float32)
    return qkv


@op("QAttention", foldable=False, domain="com.microsoft", records=True)
def qattention(ctx: OpContext, x, weight, bias, input_scale, weight_scale, mask_index=None,
               input_zp=None, weight_zp=None, past=None):
    """com.microsoft::QAttention, the quantized packed-QKV attention of
    ORT's int8 BERT exports: the projection as the integer product,
    dequantized by input_scale·weight_scale (weight_scale and weight_zp may
    be per output column), the float bias added after; then the contrib
    attention core (head split, past, ORT's mask_index, `unidirectional`).
    past_present_share_buffer raises, as in JAX."""
    from .contrib_ops import _packed_qkv_attention

    heads = int(ctx.attr("num_heads", 0))
    if not heads:
        raise ValueError("com.microsoft::QAttention requires num_heads")
    if ctx.attr("past_present_share_buffer", 0):
        raise NotImplementedError(
            "com.microsoft::QAttention: past_present_share_buffer is not supported "
            "(GQA's static buffer is the share-buffer path)")
    unidir = bool(ctx.attr("unidirectional", 0))
    acc = _int_product(ctx, x, input_zp, weight, 1, weight_zp, 7)
    qkv = _run(ctx, _qattention_qkv, acc, input_scale, weight_scale, bias)
    return _run(ctx, _packed_qkv_attention, _plain(ctx), qkv, heads, unidir, mask_index,
                past, None)
