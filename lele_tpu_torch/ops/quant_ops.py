"""Quantization emitters (counterpart of lele_tpu/ops/quant_ops.py):
DynamicQuantizeLinear, QuantizeLinear, DequantizeLinear, MatMulInteger,
ConvInteger, QLinearMatMul and QLinearConv, with exact ONNX semantics.

Quantization divides by the scale and rounds half to even (numpy's and
torch's `round`), as the spec and the JAX emitter do; on a card every
divisor is a device tensor (torch divides by a host scalar as a product
with its reciprocal there). Requantization forms its multiplier in f32 in
JAX's order, `scale_in * scale_w / y_scale`, then `acc * mult`: another
order moves codes at the half-step.

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

ConvInteger (and QLinearConv's core) on a card is the same algebra on an
im2col matrix: the raw input, shifted into the i8 domain, is padded with
its own zero point (so each padded entry is exactly cancelled by the
rank-1 correction, as JAX's zero padding of the centred input is), its
patches are gathered by `Tensor.unfold` views into an int8 [rows, K]
matrix, and one kernel-11 product a group (a grouped conv is one product
per group) meets the weight as an int8 [K, C_out / group] matrix, shifted
and its column sums formed once while tracing where it is a constant of
the trace. On the CPU, and as the card's plain oracle
(`overrides={"ConvInteger": conv_integer_plain}`), it is one float64
convolution of the centred operands (every partial sum an integer below
2^53): the same integers.

QuantizeLinear keeps JAX's static zero point (`static_args=(2,)`), so a
4-bit zero point's `Int4Array` marker survives: its codes clip at [-8, 7]
or [0, 15] on 8-bit storage. The emitters that prepare a static weight
(MatMulInteger, ConvInteger, QLinearMatMul, QLinearConv) and QuantizeLinear
(which hoists its static zero point itself) record their own device steps.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels.quant_matmul import int8_matmul
from ..onnx.loader import DTYPE_MAP
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


def prepare_weight_i8_t(b: torch.Tensor, bzp):
    """`prepare_weight_i8` on a tensor: (bi int8, colsum int32 [.., 1, N],
    bzp_i int32) of B in the i8 domain (`_to_i8_domain`)."""
    bi, bzp_i = _to_i8_domain(b, bzp)
    colsum = bi.to(torch.int32).sum(dim=-2, keepdim=True, dtype=torch.int32)
    return bi.contiguous(), colsum, bzp_i


def matmul_integer_i8(a, b, azp=None, bzp=None, product=int8_matmul):
    """(A − azp) @ (B − bzp) → int32 in the i8 domain: the JAX emitter's
    algebra (lele_tpu/ops/quant_ops.py:146-166) with `product` for the
    i8 × i8 → i32 dot; per-row azp [M] and per-column bzp [N] supported.
    A 1-D operand is promoted and its axis dropped again, as in matmul. B's
    shift and column sums are formed here, at every call; a static B has
    them prepared once (`prepare_weight_i8`)."""
    bi, colsum_b, bzp_i = prepare_weight_i8_t(b.unsqueeze(-1) if b.dim() == 1 else b, bzp)
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


# -- trace constants ---------------------------------------------------------


def trace_const(ctx: OpContext, i: int, v) -> bool:
    """Whether input i of a recording emitter's node is a constant of the
    trace: a static value the tracer hoisted to the device by name."""
    st = ctx.state
    return st is not None and isinstance(v, torch.Tensor) and (
        st.params.get(ctx.scope + ctx.node.input[i]) is v)


def derived(ctx: OpContext, i: int, tag: str, make) -> tuple:
    """Device tensors made once from input i's constant (`make()` returns
    them, run while tracing), held by the compiled model as params under the
    input's name, `tag` and their place: a weight's prepared form lives as
    long as the graphs that read it."""
    st = ctx.state
    base = f"{ctx.scope}{ctx.node.input[i]}#{tag}"
    if f"{base}.0" not in st.params:
        for k, t in enumerate(make()):
            st.params[f"{base}.{k}"] = st.tape.const(t)
    out, k = [], 0
    while f"{base}.{k}" in st.params:
        out.append(st.params[f"{base}.{k}"])
        k += 1
    return tuple(out)


def _input_name(ctx: OpContext, i: int) -> str:
    inputs = ctx.node.input
    return inputs[i] if i < len(inputs) else ""


def _np_dtype(v) -> np.dtype:
    """The numpy dtype of a host value or a tensor."""
    if isinstance(v, torch.Tensor):
        return np.dtype(str(v.dtype).removeprefix("torch."))
    return np.asarray(v).dtype


# -- QuantizeLinear / DequantizeLinear ----------------------------------------


def _expand_np(p, x, axis: int, block: int):
    """JAX's broadcast of a scale or zero point to x (lele_tpu/ops/
    quant_ops.py:92-107): per-tensor (0-D), per-axis (1-D along `axis`), or
    blocked (opset 21: same rank as x, each entry repeated `block` times
    along `axis` and trimmed to x's extent)."""
    p = np.asarray(p)
    if np.ndim(p) == 0 or np.ndim(x) <= 1:
        return p
    if np.ndim(p) == 1:
        shape = [1] * np.ndim(x)
        shape[axis] = -1
        return p.reshape(shape)
    if block > 0:
        rep = np.repeat(p, block, axis=axis)
        sl = [slice(None)] * np.ndim(x)
        sl[axis] = slice(0, np.shape(x)[axis])
        return rep[tuple(sl)]
    return p


def _expand_t(p: torch.Tensor, x_shape, axis: int, block: int) -> torch.Tensor:
    """`_expand_np` in torch; the blocked repeat as a view and one reshape,
    which a capture takes (no size is read on the host)."""
    rank = len(x_shape)
    if p.dim() == 0 or rank <= 1:
        return p
    axis = axis % rank
    if p.dim() == 1:
        shape = [1] * rank
        shape[axis] = -1
        return p.reshape(shape)
    if block > 0:
        rep = p.unsqueeze(axis + 1).expand(
            *p.shape[:axis + 1], block, *p.shape[axis + 1:]).flatten(axis, axis + 1)
        return rep.narrow(axis, 0, x_shape[axis])
    return p


def _q_range(ctx: OpContext, zp) -> tuple[np.dtype, int, int]:
    """QuantizeLinear's output storage type and value range: opset 21's
    `output_dtype` wins over the zero point's type; 4-bit outputs (uint4 21,
    int4 22, from the attribute or the zero point's marker) clip at [0, 15]
    / [-8, 7] on 8-bit storage; no zero point means uint8."""
    out_dt = ctx.attr("output_dtype")
    int4_kind = None
    if out_dt is not None and int(out_dt) in (21, 22):
        int4_kind = int(out_dt)
    elif getattr(zp, "onnx_dtype", None) in (21, 22):
        int4_kind = int(zp.onnx_dtype)
    if int4_kind is not None:
        qdt = np.dtype(np.uint8 if int4_kind == 21 else np.int8)
        lo, hi = (0, 15) if int4_kind == 21 else (-8, 7)
        return qdt, lo, hi
    if out_dt is not None:
        qdt = DTYPE_MAP[int(out_dt)]
    elif zp is None:
        qdt = np.dtype(np.uint8)
    else:
        qdt = _np_dtype(zp)
    info = np.iinfo(qdt)
    return qdt, int(info.min), int(info.max)


def quantize_t(x, scale, zp, axis: int, block: int, lo: int, hi: int, qdt: torch.dtype):
    """QuantizeLinear on tensors: clip(round_half_even(x / scale) + zp,
    lo, hi), dividing in the type jnp promotes x and the scale to."""
    dt = torch.promote_types(x.dtype, scale.dtype)
    y = torch.round(x.to(dt) / _expand_t(scale.to(dt), x.shape, axis, block))
    if zp is not None:
        y = y.to(torch.promote_types(dt, torch.float32))
        y = y + _expand_t(zp, x.shape, axis, block).to(torch.float32)
    return torch.clamp(y, lo, hi).to(qdt)


@op("QuantizeLinear", static_args=(2,), records=True)
def quantize_linear(ctx: OpContext, x, scale, zp=None):
    """The zero point stays host-side when static (static_args), so the
    loader's Int4Array marker survives: int4/uint4 zero points unpack to
    int8/uint8 storage but clip at the 4-bit value range.
    Opset 21's `output_dtype` is honored too (it wins over the zero
    point's type); per-tensor, per-axis and blocked scales. While tracing,
    the static zero point goes to the device once, by name, and the node
    records one step."""
    from .tensor_ops import torch_dtype

    axis = ctx.attr("axis", 1)
    block = int(ctx.attr("block_size", 0))
    qdt, lo, hi = _q_range(ctx, zp)
    if ctx.is_fold:
        y = np.round(x / _expand_np(scale, x, axis, block))
        if zp is not None:
            y = y + _expand_np(zp, x, axis, block).astype(np.float32)
        return np.clip(y, lo, hi).astype(qdt)
    st = ctx.state
    tq = torch_dtype(qdt)
    if zp is not None and not isinstance(zp, torch.Tensor):  # static: its marker read above
        zp = (torch.from_numpy(np.array(zp)).to(x.device) if st is None
              else st.to_device(ctx.scope + ctx.node.input[2], np.asarray(zp)))
    if st is None:  # constants evaluated on the host
        return quantize_t(x, scale, zp, axis, block, lo, hi, tq)
    return st.run(quantize_t, x, scale, zp, axis, block, lo, hi, tq)


@op("DequantizeLinear")
def dequantize_linear(ctx: OpContext, x, scale, zp=None):
    """(x - zp) * scale in f32, the scale and zero point per tensor, per
    axis or blocked; 4-bit and fp8 inputs as the loader gives them. Foldable:
    a weight-side DequantizeLinear folds while tracing."""
    axis = ctx.attr("axis", 1)
    block = int(ctx.attr("block_size", 0))
    if ctx.is_fold:
        xf = np.asarray(x).astype(np.float32)
        if zp is not None:
            xf = xf - _expand_np(zp, x, axis, block).astype(np.float32)
        return xf * _expand_np(scale, x, axis, block).astype(np.float32)
    xf = x.to(torch.float32)
    if zp is not None:
        xf = xf - _expand_t(zp.to(torch.float32), x.shape, axis, block)
    return xf * _expand_t(scale.to(torch.float32), x.shape, axis, block)


# -- the prepared weight of a recording emitter ------------------------------


def weight_prep(ctx: OpContext, i: int, b, i_zp: int, bzp, trans: bool = False):
    """(bi, colsum, bzp_i) of input i, B of a product (transposed first
    where `trans`), made once while tracing where B and its zero point are
    constants of the trace; else None (the product shifts B at every
    call)."""
    if not (trace_const(ctx, i, b) and b.dim() >= 2
            and (bzp is None or trace_const(ctx, i_zp, bzp))):
        return None
    bb = b.transpose(-1, -2) if trans else b
    return derived(ctx, i, f"i8{'T' if trans else ''}:{_input_name(ctx, i_zp)}",
                   lambda: prepare_weight_i8_t(bb, bzp))


def matmul_i32(a, azp, prep, b=None, bzp=None, trans: bool = False):
    """(A − azp) @ (B − bzp) → int32: on B's prepared i8 form where given
    (`weight_prep`), else by MatMulInteger's direct route (kernel 11 on a
    card, the float64 product on the CPU) on B, transposed first where
    `trans`."""
    if prep is not None:
        bi, colsum, bzp_i = prep
        return matmul_integer_prepared(a, bi, colsum, bzp_i, azp=azp)
    return matmul_integer(None, a, b.transpose(-1, -2) if trans else b, azp, bzp)


# -- ConvInteger ---------------------------------------------------------------


def conv_geometry(ctx: OpContext, x_shape, w_shape) -> tuple:
    """(strides, dilations, pads [(lo, hi)] a spatial dim, group) of a conv
    node, the pads resolved as the Conv emitter resolves them."""
    from .nn_ops import _resolve_pads

    rank = len(x_shape) - 2
    if rank not in (1, 2, 3):
        raise NotImplementedError(f"ConvInteger over {rank} spatial dims: the port has 1-3")
    kshape = ctx.attr_ints("kernel_shape", list(w_shape[2:]))
    strides = ctx.attr_ints("strides", [1] * rank)
    dilations = ctx.attr_ints("dilations", [1] * rank)
    pads = _resolve_pads(ctx, tuple(x_shape), kshape, strides, dilations)
    return (tuple(strides), tuple(dilations), tuple(tuple(p) for p in pads),
            int(ctx.attr("group", 1)))


_CONV_FNS = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def _conv_f64(xc: torch.Tensor, wc: torch.Tensor, geo) -> torch.Tensor:
    """The float64 convolution of centred operands, rounded to int32."""
    from .nn_ops import _flat_pads

    strides, dilations, pads, group = geo
    out = _CONV_FNS[xc.dim() - 2](F.pad(xc, _flat_pads(pads)), wc, None, stride=strides,
                                  dilation=dilations, groups=group)
    return torch.round(out).to(torch.int32)


def _centred_w(w, wzp) -> torch.Tensor:
    wc = w.to(torch.float64)
    if wzp is None:
        return wc
    wz = wzp.to(torch.float64)
    if wz.dim() == 1:  # per output channel: W's leading axis (lele_tpu quant_ops.py:186-191)
        wz = wz.reshape((-1,) + (1,) * (w.dim() - 1))
    return wc - wz


def conv_integer_plain(ctx: OpContext, x, w, xzp=None, wzp=None):
    """ConvInteger as one exact float64 convolution of the centred operands:
    the CPU route, and an override (`overrides={"ConvInteger":
    conv_integer_plain}`) that compiles a graph's plain oracle for a card."""
    xc = x.to(torch.float64) - (xzp.to(torch.float64) if xzp is not None else 0.0)
    return _conv_f64(xc, _centred_w(w, wzp), conv_geometry(ctx, x.shape, w.shape))


def conv_weight_i8(w: torch.Tensor, wzp, group: int):
    """A conv weight [C_out, C_in / group, *k] in the i8 domain as group
    matrices (wmat int8 [group, K, C_out / group], K = (C_in / group)·Πk in
    (channel, *k) order, the im2col rows' order), their column sums (int32
    [group, 1, C_out / group]) and the zero point as int32 [C_out]."""
    cout = w.shape[0]
    bi, _, bzp_i = prepare_weight_i8_t(w.reshape(cout, -1).t(), wzp)
    wmat = bi.reshape(-1, group, cout // group).permute(1, 0, 2).contiguous()
    colsum = wmat.to(torch.int32).sum(dim=1, keepdim=True, dtype=torch.int32)
    return wmat, colsum, bzp_i.reshape(-1).expand(cout).contiguous()


def im2col_i8(xi: torch.Tensor, fill: torch.Tensor, kshape, geo) -> torch.Tensor:
    """The patches of xi (int8 [N, C, *sp]) padded with `fill` (an int8
    device scalar), as a view [N, *out, C, *k]: `Tensor.unfold` a spatial
    dim, the dilation a stride of the window."""
    strides, dilations, pads, _ = geo
    rank = xi.dim() - 2
    if any(lo or hi for lo, hi in pads):
        shape = list(xi.shape[:2]) + [n + lo + hi for n, (lo, hi) in zip(xi.shape[2:], pads)]
        xp = fill.reshape((1,) * xi.dim()).expand(shape).contiguous()
        xp[(slice(None), slice(None)) + tuple(
            slice(lo, lo + n) for n, (lo, _) in zip(xi.shape[2:], pads))] = xi
    else:
        xp = xi
    v = xp
    for i in range(rank):
        v = v.unfold(2 + i, (kshape[i] - 1) * dilations[i] + 1, strides[i])
        if dilations[i] > 1:
            v = v[..., ::dilations[i]]
    return v.permute(0, *range(2, 2 + rank), 1, *range(2 + rank, 2 + 2 * rank))


def conv_integer_i8(x, xzp, wmat, colsum, wzp_i, kshape, geo, product=int8_matmul):
    """(X − xzp) ⋆ (W − wzp) → int32 [N, C_out, *out] in the i8 domain:
    im2col of the shifted input padded with its shifted zero point, one
    `product` (kernel 11) a group, the rank-1 corrections in int32 (the
    JAX emitter's MatMulInteger algebra on the patch matrix)."""
    if xzp is not None and xzp.numel() != 1:
        raise NotImplementedError("ConvInteger: x_zero_point must be a scalar (per tensor)")
    xi, xzp_i = _to_i8_domain(x, xzp.reshape(()) if xzp is not None else None)
    group, kg, cg = wmat.shape
    cols = im2col_i8(xi, xzp_i.to(torch.int8), kshape, geo)
    out_sp = cols.shape[1:1 + len(kshape)]
    cin_g = xi.shape[1] // group
    accs = []
    for g in range(group):
        a = cols[..., g * cin_g:(g + 1) * cin_g, *([slice(None)] * len(kshape))]
        a = a.reshape(-1, kg)
        c = product(a, wmat[g])
        rowsum = a.sum(dim=-1, keepdim=True, dtype=torch.int32)
        wz = wzp_i[g * cg:(g + 1) * cg].reshape(1, -1)
        accs.append(c - xzp_i * colsum[g] - wz * rowsum + kg * xzp_i * wz)
    acc = accs[0] if group == 1 else torch.cat(accs, dim=-1)
    rank = len(kshape)
    return acc.reshape(x.shape[0], *out_sp, -1).permute(0, rank + 1, *range(1, rank + 1))


def conv_i32(x, xzp, prep, w, wzp, geo):
    """ConvInteger's int32 sum: on the CPU the float64 convolution of the
    centred operands; on a card im2col and kernel 11, on the weight's
    prepared group matrices where given (`conv_prep`), else prepared here."""
    if x.device.type == "cpu":
        xc = x.to(torch.float64) - (xzp.to(torch.float64) if xzp is not None else 0.0)
        return _conv_f64(xc, _centred_w(w, wzp), geo)
    wmat, colsum, wzp_i = prep if prep is not None else conv_weight_i8(w, wzp, geo[3])
    return conv_integer_i8(x, xzp, wmat, colsum, wzp_i, tuple(w.shape[2:]), geo)


def conv_prep(ctx: OpContext, i: int, w, i_zp: int, wzp, group: int):
    """(wmat, colsum, wzp_i) of input i, a conv weight, made once while
    tracing where it and its zero point are constants of the trace; else
    None."""
    if not (trace_const(ctx, i, w) and (wzp is None or trace_const(ctx, i_zp, wzp))):
        return None
    return derived(ctx, i, f"conv{group}:{_input_name(ctx, i_zp)}",
                   lambda: conv_weight_i8(w, wzp, group))


@op("ConvInteger", foldable=False, records=True)
def conv_integer(ctx: OpContext, x, w, xzp=None, wzp=None):
    """(X − x_zero_point) ⋆ (W − w_zero_point) → int32: groups, strides,
    dilations, auto_pad, 1-3 spatial dims, a per-output-channel weight zero
    point aligned with W's leading axis. A constant weight is prepared once
    while tracing (`conv_prep`); the node records one step."""
    geo = conv_geometry(ctx, tuple(x.shape), tuple(w.shape))
    st = ctx.state
    if st is None:
        return conv_i32(x, xzp, None, w, wzp, geo)
    return st.run(conv_i32, x, xzp, conv_prep(ctx, 1, w, 3, wzp, geo[3]), w, wzp, geo)


# -- QLinearMatMul / QLinearConv -----------------------------------------------


def requant(acc: torch.Tensor, mult: torch.Tensor, y_zp, qdt: torch.dtype) -> torch.Tensor:
    """int32 accumulator → quantized output: saturate(round_half_even(acc *
    mult) + y_zp) (lele_tpu/ops/quant_ops.py:204-213)."""
    info = torch.iinfo(qdt)
    y = torch.round(acc.to(torch.float32) * mult)
    if y_zp is not None:
        y = y + y_zp.to(torch.float32)
    return torch.clamp(y, info.min, info.max).to(qdt)


def requant_mult(scale_in, scale_w, y_scale) -> torch.Tensor:
    """(scale_in * scale_w / y_scale) in f32, JAX's order."""
    return (scale_in * scale_w / y_scale).to(torch.float32)


def _mult(ctx: OpContext, idx: tuple, vals: tuple, shape_w=None):
    """requant_mult of the inputs at positions idx (a per-channel weight
    scale reshaped to `shape_w`): made once while tracing where all three
    are constants, else None (formed at every call)."""
    if not all(trace_const(ctx, i, v) for i, v in zip(idx, vals)):
        return None
    s_in, s_w, s_y = vals
    if shape_w is not None and s_w.dim() == 1:
        s_w = s_w.reshape(shape_w)
    return derived(ctx, idx[1], "mult:" + ":".join(_input_name(ctx, i) for i in idx),
                   lambda: (requant_mult(s_in, s_w, s_y),))[0]


def _out_qdt(y_zp):
    from .tensor_ops import torch_dtype

    return torch_dtype(_np_dtype(y_zp)) if y_zp is not None else torch.uint8


def qlinear_matmul_step(a, a_scale, a_zp, prep, b, b_zp, b_scale, y_scale, y_zp, mult, qdt):
    c = matmul_i32(a, a_zp, prep, b, b_zp)
    if mult is None:
        mult = requant_mult(a_scale, b_scale, y_scale)
    return requant(c, mult, y_zp, qdt)


@op("QLinearMatMul", foldable=False, records=True)
def qlinear_matmul(ctx: OpContext, a, a_scale, a_zp, b, b_scale, b_zp, y_scale, y_zp):
    """Statically quantized matmul: the MatMulInteger core (kernel 11 on a
    card), then requantize."""
    args = (a, a_scale, a_zp, None, b, b_zp, b_scale, y_scale, y_zp, None, _out_qdt(y_zp))
    st = ctx.state
    if st is None:
        return qlinear_matmul_step(*args)
    args = list(args)
    args[3] = weight_prep(ctx, 3, b, 5, b_zp)
    args[9] = _mult(ctx, (1, 4, 6), (a_scale, b_scale, y_scale))
    return st.run(qlinear_matmul_step, *args)


def qlinear_conv_step(x, x_scale, x_zp, prep, w, w_zp, w_scale, y_scale, y_zp, b, mult,
                      geo, qdt):
    acc = conv_i32(x, x_zp, prep, w, w_zp, geo)
    if b is not None:  # int32 bias at scale x_scale * w_scale
        acc = acc + b.to(torch.int32).reshape((1, -1) + (1,) * (acc.dim() - 2))
    if mult is None:
        ws = w_scale.reshape((1, -1) + (1,) * (acc.dim() - 2)) if w_scale.dim() == 1 \
            else w_scale
        mult = requant_mult(x_scale, ws, y_scale)
    return requant(acc, mult, y_zp, qdt)


@op("QLinearConv", foldable=False, records=True)
def qlinear_conv(ctx: OpContext, x, x_scale, x_zp, w, w_scale, w_zp, y_scale, y_zp, b=None):
    """Statically quantized conv: the ConvInteger core (im2col and kernel 11
    on a card), an int32 bias, then requantize; a per-output-channel
    w_scale (axis 0)."""
    geo = conv_geometry(ctx, tuple(x.shape), tuple(w.shape))
    args = [x, x_scale, x_zp, None, w, w_zp, w_scale, y_scale, y_zp, b, None, geo,
            _out_qdt(y_zp)]
    st = ctx.state
    if st is None:
        return qlinear_conv_step(*args)
    args[3] = conv_prep(ctx, 3, w, 5, w_zp, geo[3])
    args[10] = _mult(ctx, (1, 4, 6), (x_scale, w_scale, y_scale),
                     (1, -1) + (1,) * (x.dim() - 2))
    return st.run(qlinear_conv_step, *args)
