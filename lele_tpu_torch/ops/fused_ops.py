"""The com.microsoft fused ops ORT's graph optimizer writes into CNN and
encoder exports (counterpart of lele_tpu/ops/fused_ops.py): FusedConv,
FusedGemm, ConvTransposeWithDynamicPads, BiasSoftmax and
RelativePositionBias.

None is new math: each is an ai.onnx op with an activation or a bias folded
in by onnxruntime's level-2/3 transformers, so each maps back onto the
port's ai.onnx emitter (cuDNN's conv, the f32 GEMM) and an epilogue with
JAX's activation table.
"""

from __future__ import annotations

import numpy as np
import torch

from .math_ops import gemm
from .nn_ops import conv, conv_transpose
from .registry import OpContext, host_const, op, run_step


def _apply_activation(y: torch.Tensor, act: str | None, params) -> torch.Tensor:
    """The ORT fused-activation epilogue (FusedConv's `activation` and
    `activation_params`; FusedGemm passes its scalars the same way)."""
    if not act:
        return y
    p = list(params or [])
    if act == "Relu":
        return torch.clamp(y, min=0)
    if act == "Tanh":
        return torch.tanh(y)
    if act == "Sigmoid":
        return 1.0 / (1.0 + torch.exp(-y))
    if act == "LeakyRelu":
        alpha = p[0] if p else 0.01
        return torch.where(y >= 0, y, alpha * y)
    if act == "HardSigmoid":
        alpha = p[0] if len(p) > 0 else 0.2
        beta = p[1] if len(p) > 1 else 0.5
        return torch.clamp(alpha * y + beta, 0.0, 1.0)
    if act == "Clip":
        lo = p[0] if len(p) > 0 else -np.inf
        hi = p[1] if len(p) > 1 else np.inf
        return torch.clamp(y, lo, hi)
    raise NotImplementedError(f"fused activation {act!r} is not implemented")


@op("FusedConv", foldable=False, domain="com.microsoft")
def fused_conv(ctx: OpContext, x, w, b=None, z=None):
    """Conv [+ the residual Z] + activation (ORT's ConvActivation and
    ConvAddActivation): Z is added before the activation."""
    y = conv(ctx, x, w, b)
    if z is not None:
        y = y + z.to(y.dtype)
    return _apply_activation(y, ctx.attr("activation"), ctx.attr("activation_params"))


@op("FusedGemm", foldable=False, domain="com.microsoft")
def fused_gemm(ctx: OpContext, a, b, c=None):
    """Gemm + activation (ORT's GemmActivation): the activation's scalars
    come as activation_alpha and activation_beta."""
    y = gemm(ctx, a, b, c)
    params = [v for v in (ctx.attr("activation_alpha"), ctx.attr("activation_beta"))
              if v is not None]
    return _apply_activation(y, ctx.attr("activation"), params)


@op("ConvTransposeWithDynamicPads", foldable=False, static_args=(2,),
    domain="com.microsoft")
def conv_transpose_dynamic_pads(ctx: OpContext, x, w, pads=None, b=None):
    """ConvTranspose whose pads come as an input (a static one: an
    initializer or a shape computation that folds)."""
    if pads is not None:
        ctx.attrs = dict(ctx.attrs)
        ctx.attrs["pads"] = [int(v) for v in np.asarray(pads).reshape(-1)]
        ctx.attrs.pop("auto_pad", None)
    return conv_transpose(ctx, x, w, b)


@op("BiasSoftmax", foldable=False, domain="com.microsoft")
def bias_softmax(ctx: OpContext, x, bias):
    """softmax(x + bias) over the flattened dims [axis:]. Viewing x as [N, D]
    and the bias as [Nb, D], row i adds bias row i // (N // Nb) where
    is_inner_broadcast=1 (the bias varies on the leading dims) and i % Nb
    where it is 0 (on the trailing ones)."""
    axis = int(ctx.attr("axis", 1)) % x.dim()
    shape = tuple(x.shape)
    d = int(np.prod(shape[axis:]))
    n = int(np.prod(shape[:axis])) if axis else 1
    if bias.numel() % d != 0:
        raise ValueError(f"BiasSoftmax: bias size {bias.numel()} is not a multiple of the "
                         f"softmax row size {d}")
    nb = bias.numel() // d
    if n % nb:
        raise ValueError(f"BiasSoftmax: {nb} bias rows do not divide {n} input rows")
    bf = bias.to(x.dtype).reshape(nb, d)
    if nb == n:
        rows = bf
    elif int(ctx.attr("is_inner_broadcast", 0)):
        rows = torch.repeat_interleave(bf, n // nb, dim=0)
    else:
        rows = bf.repeat(n // nb, 1)
    return torch.softmax(x.reshape(n, d) + rows, dim=-1).reshape(shape)


def _relative_bias(table: torch.Tensor, bucket: torch.Tensor, q: int, k: int) -> torch.Tensor:
    out = torch.index_select(table, 0, bucket).reshape(q, k, table.shape[1])
    return out.permute(2, 0, 1)[None]


@op("RelativePositionBias", foldable=False, static_args=(1, 2), records=True,
    domain="com.microsoft")
def relative_position_bias(ctx: OpContext, bias_table, query_length, key_length):
    """T5's bucketed relative position bias: bias_table [num_buckets,
    num_heads] → [1, num_heads, q, k], bucket(j - i) exact for half the
    buckets and log-spaced out to max_distance for the rest (each direction
    its half where is_bidirectional). The buckets are host math over the
    static lengths, hoisted once as the step's index."""
    num_buckets = int(bias_table.shape[0])
    q = int(np.asarray(query_length).reshape(-1)[0])
    k = int(np.asarray(key_length).reshape(-1)[0])
    max_distance = int(ctx.attr("max_distance", 128))
    rel = np.arange(k)[None, :] - np.arange(q)[:, None]  # j - i
    nb = num_buckets
    bucket = np.zeros((q, k), np.int64)
    if ctx.attr("is_bidirectional", 0):
        nb //= 2
        bucket += (rel > 0).astype(np.int64) * nb
        rel = np.abs(rel)
    else:
        rel = -np.minimum(rel, 0)
    max_exact = nb // 2
    large = max_exact + (np.log(np.maximum(rel, 1) / max_exact)
                         / np.log(max_distance / max_exact) * (nb - max_exact)).astype(np.int64)
    bucket += np.where(rel < max_exact, rel, np.minimum(large, nb - 1))
    idx = host_const(ctx, "bucket", bucket.reshape(-1))
    return run_step(ctx, _relative_bias, bias_table, idx, q, k)
