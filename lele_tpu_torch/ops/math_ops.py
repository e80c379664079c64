"""Math emitters (counterpart of lele_tpu/ops/math_ops.py): elementwise
arithmetic, the unary table, comparisons and logic, the reductions, CumSum,
MatMul, Gemm, Einsum, Range, Trilu and STFT, each as the JAX package writes
it. Integer Div and Mod are safe on a zero divisor (the tracer walks every
dynamic step on zero placeholders) and give JAX's CPU values there."""

from __future__ import annotations

import numpy as np
import torch

from ..features.framing import frame_signal
from .registry import OpContext, op, static_ints


def _promote(a, b):
    """Two float operands of different types in the wider one, as jnp
    promotes them: torch keeps a bf16 tensor bf16 against an f32 0-dim
    tensor, where jnp gives f32 (a compiled graph's f32 scalar constant
    meeting its bf16 activations under a compute dtype)."""
    if (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor) and a.dtype != b.dtype
            and a.is_floating_point() and b.is_floating_point()):
        dt = torch.promote_types(a.dtype, b.dtype)
        return a.to(dt), b.to(dt)
    return a, b


@op("Add")
def add(ctx: OpContext, a, b):
    return ctx.xp.add(*_promote(a, b))


@op("Sub")
def sub(ctx: OpContext, a, b):
    return ctx.xp.subtract(*_promote(a, b))


@op("Mul")
def mul(ctx: OpContext, a, b):
    return ctx.xp.multiply(*_promote(a, b))


def _int_safe(b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """An integer divisor with its zeros replaced by one, and where they
    were: torch raises on an integer division by zero on the CPU, which the
    tracer's walk on zero placeholders would meet at every dynamic divisor."""
    zero = b == 0
    return torch.where(zero, torch.ones_like(b), b), zero


def _int_div_by_zero(a: torch.Tensor) -> torch.Tensor:
    """JAX's integer Div where the divisor is zero (lele_tpu/ops/math_ops.py:
    45-55 on XLA's x / 0 = -1, x % 0 = x): the floor quotient -1, moved down
    to -2 where x != 0, then up by one where x < 0 — so x > 0 gives -2 and
    x <= 0 gives -1 for a signed type, and every x gives all ones for an
    unsigned one."""
    if not a.dtype.is_signed:
        return torch.full_like(a, torch.iinfo(a.dtype).max)
    return torch.where(a > 0, torch.full_like(a, -2), torch.full_like(a, -1))


@op("Div")
def div(ctx: OpContext, a, b):
    a, b = _promote(a, b)
    if ctx.is_fold:
        a_ = np.asarray(a)
        if np.issubdtype(a_.dtype, np.integer):
            # ONNX integer Div truncates toward zero (C semantics)
            q = np.floor_divide(a, b)
            r = a_ - q * np.asarray(b)
            neg = (a_ < 0) != (np.asarray(b) < 0)
            return np.where((r != 0) & neg, q + 1, q)
        return np.divide(a, b)
    if not a.is_floating_point():
        safe, zero = _int_safe(b)
        q = torch.div(a, safe, rounding_mode="trunc")
        return torch.where(zero, _int_div_by_zero(torch.broadcast_to(a, q.shape)), q)
    return torch.div(a, b)


@op("Neg")
def neg(ctx: OpContext, x):
    return ctx.xp.negative(x)


@op("Mod")
def mod(ctx: OpContext, a, b):
    """fmod=1: C's fmod (the dividend's sign); fmod=0: the divisor's sign,
    as numpy.mod. An integer divisor of zero gives 0, as jnp.mod and
    jnp.fmod give it (they divide by one there)."""
    fmod = bool(ctx.attr("fmod", 0))
    if ctx.is_fold:
        return np.fmod(a, b) if fmod else np.mod(a, b)
    a, b = _promote(a, b)
    if not (a.is_floating_point() or b.is_floating_point()):
        b, _ = _int_safe(b)
    return torch.fmod(a, b) if fmod else torch.remainder(a, b)


@op("Pow")
def pow_(ctx: OpContext, a, b):
    """In the base's dtype (the exponent cast to it first). An integer power
    is jnp.power's on a traced exponent: binary exponentiation over the
    exponent's low 6 bits, wrapping in the base's dtype, so a negative
    exponent gives jnp's wrapped value (3^-2 -> 3^62 mod 2^32 in int32)
    where torch refuses."""
    if ctx.is_fold:
        a_ = np.asarray(a)
        return np.power(a_, np.asarray(b).astype(a_.dtype)).astype(a_.dtype)
    b = b.to(a.dtype)
    if a.is_floating_point():
        return torch.pow(a, b)
    # 0^b is 0 for b != 0, as jnp's accumulator starts
    acc = torch.where((a == 0) & (b != 0), torch.zeros_like(a), torch.ones_like(a))
    for i in range(6):  # bit i of b: an arithmetic shift agrees with jnp's logical one
        acc = torch.where((b >> i) & 1 == 1, acc * a, acc)
        a = a * a
    return acc


def _variadic(ctx: OpContext, np_fn, torch_fn, xs):
    """Max, Min, Sum: a binary op folded over the inputs, left to right."""
    out = xs[0]
    for x in xs[1:]:
        out = np_fn(out, x) if ctx.is_fold else torch_fn(*_promote(out, x))
    return out


@op("Max")
def max_(ctx: OpContext, *xs):
    return _variadic(ctx, np.maximum, torch.maximum, xs)


@op("Min")
def min_(ctx: OpContext, *xs):
    return _variadic(ctx, np.minimum, torch.minimum, xs)


@op("Sum")
def sum_variadic(ctx: OpContext, *xs):
    return _variadic(ctx, np.add, torch.add, xs)


@op("Mean")
def mean_variadic(ctx: OpContext, *xs):
    return sum_variadic(ctx, *xs) / len(xs)


@op("PRelu")
def prelu(ctx: OpContext, x, slope):
    return ctx.xp.where(x < 0, x * slope, x)


@op("Clip")
def clip(ctx: OpContext, x, lo=None, hi=None):
    """min and max as inputs (opset >= 11) or attributes, each optional."""
    if lo is None and "min" in ctx.attrs:
        lo = ctx.attr("min")
    if hi is None and "max" in ctx.attrs:
        hi = ctx.attr("max")
    out = x
    for bound, np_fn, torch_fn, kw in ((lo, np.maximum, torch.maximum, "min"),
                                       (hi, np.minimum, torch.minimum, "max")):
        if bound is None:
            continue
        if ctx.is_fold:
            out = np_fn(out, bound)
        elif isinstance(bound, torch.Tensor):
            out = torch_fn(*_promote(out, bound))
        else:  # an attribute
            out = torch.clamp(out, **{kw: bound})
    return out


# -- unary -------------------------------------------------------------------

_UNARY = {  # ONNX name: (numpy, torch)
    "Sqrt": (np.sqrt, torch.sqrt), "Exp": (np.exp, torch.exp),
    "Sin": (np.sin, torch.sin), "Cos": (np.cos, torch.cos), "Tan": (np.tan, torch.tan),
    "Asin": (np.arcsin, torch.asin), "Acos": (np.arccos, torch.acos),
    "Atan": (np.arctan, torch.atan), "Sinh": (np.sinh, torch.sinh),
    "Cosh": (np.cosh, torch.cosh), "Abs": (np.abs, torch.abs),
    "Floor": (np.floor, torch.floor), "Ceil": (np.ceil, torch.ceil),
    "Sign": (np.sign, torch.sign),
}


def _unary(np_fn, torch_fn):
    def emitter(ctx: OpContext, x):
        if ctx.is_fold:
            return np_fn(x)
        if torch_fn in (torch.floor, torch.ceil) and not x.is_floating_point():
            return x
        if torch_fn is torch.sign and x.is_floating_point():
            return torch.where(torch.isnan(x), x, torch.sign(x))  # NaN stays, as in jnp
        return torch_fn(x)
    return emitter


for _name, (_np_fn, _torch_fn) in _UNARY.items():
    op(_name)(_unary(_np_fn, _torch_fn))


@op("Reciprocal")
def reciprocal(ctx: OpContext, x):
    if ctx.is_fold:
        return np.asarray(1.0, dtype=np.asarray(x).dtype) / x
    return torch.reciprocal(x) if x.is_floating_point() else 1.0 / x


@op("Round")
def round_(ctx: OpContext, x):
    return ctx.xp.round(x)  # half to even in both, as ONNX


@op("IsNaN")
def isnan(ctx: OpContext, x):
    return ctx.xp.isnan(x)


@op("IsInf")
def isinf(ctx: OpContext, x):
    """detect_positive / detect_negative (both 1 by default, the only form
    JAX's emitter has: it ignores them)."""
    pos, neg = ctx.attr("detect_positive", 1), ctx.attr("detect_negative", 1)
    if pos and neg:
        return ctx.xp.isinf(x)
    inf = np.inf if pos else -np.inf
    if not (pos or neg):
        return np.zeros(np.shape(x), bool) if ctx.is_fold else torch.zeros_like(
            x, dtype=torch.bool)
    return np.equal(x, inf) if ctx.is_fold else torch.eq(x, inf)


@op("Less")
def less(ctx: OpContext, a, b):
    return ctx.xp.less(a, b)


@op("Equal")
def equal(ctx: OpContext, a, b):
    return np.equal(a, b) if ctx.is_fold else torch.eq(a, b)


@op("LessOrEqual")
def less_equal(ctx: OpContext, a, b):
    return ctx.xp.less_equal(a, b)


@op("Greater")
def greater(ctx: OpContext, a, b):
    return ctx.xp.greater(a, b)


@op("GreaterOrEqual")
def greater_equal(ctx: OpContext, a, b):
    return ctx.xp.greater_equal(a, b)


@op("Not")
def not_(ctx: OpContext, x):
    return ctx.xp.logical_not(x)


@op("And")
def and_(ctx: OpContext, a, b):
    return ctx.xp.logical_and(a, b)


@op("Or")
def or_(ctx: OpContext, a, b):
    return ctx.xp.logical_or(a, b)


@op("Xor")
def xor_(ctx: OpContext, a, b):
    return ctx.xp.logical_xor(a, b)


@op("Log")
def log(ctx: OpContext, x):
    return ctx.xp.log(x)


@op("Erf", foldable=False)
def erf(ctx: OpContext, x):
    """The exact GELU's erf, as torch.onnx.export writes it."""
    return torch.special.erf(x)


@op("MatMul", foldable=False)
def matmul(ctx: OpContext, a, b):
    """f32 products in full f32: a card needs allow_tf32 off (torch's
    default)."""
    return torch.matmul(a, b)


@op("Gemm", foldable=False)
def gemm(ctx: OpContext, a, b, c=None):
    """alpha · op(A) @ op(B) + beta · C, in f32 as MatMul."""
    alpha = ctx.attr("alpha", 1.0)
    beta = ctx.attr("beta", 1.0)
    if ctx.attr("transA", 0):
        a = a.transpose(0, 1)
    if ctx.attr("transB", 0):
        b = b.transpose(0, 1)
    out = torch.matmul(a, b)
    if alpha != 1.0:
        out = out * alpha
    if c is not None and beta != 0.0:
        out = out + (c if beta == 1.0 else beta * c)
    return out


@op("Einsum", foldable=False)
def einsum(ctx: OpContext, *xs):
    """f32 products in full f32, as MatMul."""
    return torch.einsum(ctx.attr("equation"), *xs)


@op("Range", static_args=(0, 1, 2))
def range_(ctx: OpContext, start, limit, delta):
    # the output's shape depends on the values, so it must fold
    s, lim, d = np.asarray(start), np.asarray(limit), np.asarray(delta)
    return np.arange(s.item(), lim.item(), d.item(), dtype=s.dtype)


@op("Trilu", static_args=(1,))
def trilu(ctx: OpContext, x, k=None):
    kk = static_ints(k, "trilu k")[0] if k is not None else 0
    upper = bool(ctx.attr("upper", 1))
    if ctx.is_fold:
        return np.triu(x, kk) if upper else np.tril(x, kk)
    return torch.triu(x, kk) if upper else torch.tril(x, kk)


def _reduce(ctx: OpContext, x, axes, np_fn, torch_fn):
    """ONNX reduce semantics: axes as an input (opset >= 13/18) or attribute;
    none or empty means all axes, or the input itself with
    noop_with_empty_axes. `torch_fn` takes a tuple of dims, or one dim where
    it is torch.prod (reduced one axis at a time, the last first)."""
    keep = bool(ctx.attr("keepdims", 1))
    if axes is None:
        axes = ctx.attr_ints("axes")
    if axes is None or len(static_ints(axes, "reduce axes")) == 0:
        if ctx.attr("noop_with_empty_axes", 0):
            return x
        ax = tuple(range(np.ndim(x)))
    else:
        ax = tuple(a % max(np.ndim(x), 1) for a in static_ints(axes, "reduce axes"))
    if ctx.is_fold:
        return np_fn(x, axis=ax, keepdims=keep)
    if not ax:  # a 0-d tensor
        return x
    if torch_fn is torch.mean and not x.is_floating_point():
        x = x.float()  # jnp.mean's type for an integer input
    if torch_fn is torch.prod:
        out = x
        for a in sorted(set(ax), reverse=True):
            out = torch.prod(out, dim=a, keepdim=keep)
    else:
        out = torch_fn(x, dim=ax, keepdim=keep)
    # torch widens integer sums and products to int64; jnp keeps the type
    return out if out.dtype == x.dtype or x.dtype == torch.bool else out.to(x.dtype)


@op("ReduceSum", static_args=(1,))
def reduce_sum(ctx: OpContext, x, axes=None):
    return _reduce(ctx, x, axes, np.sum, torch.sum)


@op("ReduceMean", static_args=(1,))
def reduce_mean(ctx: OpContext, x, axes=None):
    return _reduce(ctx, x, axes, np.mean, torch.mean)


@op("ReduceMax", static_args=(1,))
def reduce_max(ctx: OpContext, x, axes=None):
    return _reduce(ctx, x, axes, np.max, torch.amax)


@op("ReduceMin", static_args=(1,))
def reduce_min(ctx: OpContext, x, axes=None):
    return _reduce(ctx, x, axes, np.min, torch.amin)


@op("ReduceProd", static_args=(1,))
def reduce_prod(ctx: OpContext, x, axes=None):
    return _reduce(ctx, x, axes, np.prod, torch.prod)


@op("ReduceL2", static_args=(1,))
def reduce_l2(ctx: OpContext, x, axes=None):
    return ctx.xp.sqrt(_reduce(ctx, ctx.xp.square(x), axes, np.sum, torch.sum))


@op("ReduceL1", static_args=(1,))
def reduce_l1(ctx: OpContext, x, axes=None):
    return _reduce(ctx, ctx.xp.abs(x), axes, np.sum, torch.sum)


@op("ReduceLogSumExp", static_args=(1,))
def reduce_lse(ctx: OpContext, x, axes=None):
    """log(sum(exp(x - max))) + max, JAX's form."""
    m = _reduce(ctx, x, axes, np.max, torch.amax)
    keep = OpContext(ctx.xp, {**ctx.attrs, "keepdims": 1}, ctx.opset)
    mb = _reduce(keep, x, axes, np.max, torch.amax)
    return ctx.xp.log(_reduce(ctx, ctx.xp.exp(x - mb), axes, np.sum, torch.sum)) + m


@op("CumSum", static_args=(1,))
def cumsum(ctx: OpContext, x, axis):
    """`exclusive` shifts the sums one place along the axis (a zero first),
    `reverse` sums from the end; in x's dtype."""
    ax = static_ints(axis, "cumsum axis")[0] % max(np.ndim(x), 1)
    rev, excl = bool(ctx.attr("reverse", 0)), bool(ctx.attr("exclusive", 0))
    if ctx.is_fold:
        xx = np.flip(x, axis=ax) if rev else x
        c = np.cumsum(xx, axis=ax, dtype=np.asarray(x).dtype)
        if excl:
            c = np.roll(c, 1, axis=ax)
            c[(slice(None),) * ax + (0,)] = 0
        return np.flip(c, axis=ax) if rev else c
    xx = torch.flip(x, dims=(ax,)) if rev else x
    c = torch.cumsum(xx, dim=ax).to(x.dtype)
    if excl:
        n = c.shape[ax]
        c = torch.cat([torch.zeros_like(c.narrow(ax, 0, min(n, 1))),
                       c.narrow(ax, 0, max(n - 1, 0))], dim=ax)
    return torch.flip(c, dims=(ax,)) if rev else c


@op("STFT", foldable=False, static_args=(1, 3))
def stft(ctx: OpContext, signal, frame_step, window=None, frame_length=None):
    """ONNX STFT (opset 17): framing + FFT → [B, frames, bins, 2] (real,
    imaginary), f32."""
    step = static_ints(frame_step, "frame_step")[0]
    if signal.dim() == 3:  # [B, L, 1]
        signal = signal[..., 0]
    if window is not None:
        flen = int(window.shape[-1])
    elif frame_length is not None:
        flen = static_ints(frame_length, "frame_length")[0]
    else:
        raise ValueError("STFT requires window or frame_length")
    frames = frame_signal(signal, flen, step)  # [B, frames, flen]
    if window is not None:
        frames = frames * window
    fft = torch.fft.rfft if ctx.attr("onesided", 1) else torch.fft.fft
    spec = fft(frames, n=flen, dim=-1)
    return torch.stack([spec.real, spec.imag], dim=-1).float()
