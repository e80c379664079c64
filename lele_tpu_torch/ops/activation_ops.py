"""Activation emitters (counterpart of lele_tpu/ops/activation_ops.py):
Relu, LeakyRelu, Sigmoid, Softmax, LogSoftmax, Tanh, Softplus, Gelu, Elu,
Selu, Celu, HardSigmoid, HardSwish, Softsign, Mish and ThresholdedRelu, in
JAX's formulas (exp(x) - 1 where JAX writes it, not expm1)."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .registry import OpContext, op


@op("Relu")
def relu(ctx: OpContext, x):
    if ctx.is_fold:
        return np.maximum(x, np.asarray(0, dtype=np.asarray(x).dtype))
    return torch.relu(x)


@op("LeakyRelu", foldable=False)
def leaky_relu(ctx: OpContext, x):
    # alpha is an operand of the kernel, not an upload; f32 products as jnp's
    alpha = ctx.attr("alpha", 0.01)
    return torch.where(x >= 0, x, x * alpha)


@op("Sigmoid", foldable=False)
def sigmoid(ctx: OpContext, x):
    return torch.sigmoid(x)


def _flat_softmax(ctx: OpContext, x, fn):
    """Softmax and LogSoftmax: over `axis` from opset 13; before, over the
    whole trailing block from `axis` (default 1), flattened to 2-D."""
    if ctx.opset >= 13:
        return fn(x, dim=ctx.attr("axis", -1))
    axis = ctx.attr("axis", 1)
    shape = tuple(x.shape)
    axis = axis if axis >= 0 else axis + len(shape)
    lead = int(np.prod(shape[:axis])) if axis else 1
    return fn(x.reshape(lead, -1), dim=-1).reshape(shape)


@op("Softmax", foldable=False)
def softmax(ctx: OpContext, x):
    return _flat_softmax(ctx, x, torch.softmax)


@op("LogSoftmax", foldable=False)
def log_softmax(ctx: OpContext, x):
    return _flat_softmax(ctx, x, torch.log_softmax)


@op("Tanh")
def tanh(ctx: OpContext, x):
    return np.tanh(x) if ctx.is_fold else torch.tanh(x)


@op("Softplus", foldable=False)
def softplus(ctx: OpContext, x):
    # jax.nn.softplus's definition: logaddexp(x, 0)
    return torch.logaddexp(x, torch.zeros_like(x))


@op("Gelu", foldable=False)
def gelu(ctx: OpContext, x):
    """Both forms of jax.nn.gelu: erf (approximate "none") and tanh."""
    tanh = ctx.attr("approximate", "none") == "tanh"
    return F.gelu(x, approximate="tanh" if tanh else "none")


@op("Elu", foldable=False)
def elu(ctx: OpContext, x):
    return torch.where(x > 0, x, ctx.attr("alpha", 1.0) * (torch.exp(x) - 1))


@op("Selu", foldable=False)
def selu(ctx: OpContext, x):
    alpha = ctx.attr("alpha", 1.6732632423543772)
    gamma = ctx.attr("gamma", 1.0507009873554805)
    return gamma * torch.where(x > 0, x, alpha * (torch.exp(x) - 1))


@op("Celu", foldable=False)
def celu(ctx: OpContext, x):
    alpha = ctx.attr("alpha", 1.0)
    return torch.clamp(x, min=0) + torch.clamp(alpha * (torch.exp(x / alpha) - 1), max=0)


@op("HardSigmoid")
def hard_sigmoid(ctx: OpContext, x):
    alpha, beta = ctx.attr("alpha", 0.2), ctx.attr("beta", 0.5)
    if ctx.is_fold:
        return np.clip(alpha * x + beta, 0.0, 1.0).astype(np.asarray(x).dtype)
    return torch.clamp(alpha * x + beta, 0.0, 1.0).to(x.dtype)


@op("HardSwish", foldable=False)
def hard_swish(ctx: OpContext, x):
    return x * torch.clamp(x / 6.0 + 0.5, 0.0, 1.0)


@op("Softsign")
def softsign(ctx: OpContext, x):
    return x / (1 + ctx.xp.abs(x))


@op("Mish", foldable=False)
def mish(ctx: OpContext, x):
    return x * torch.tanh(softplus(ctx, x))


@op("ThresholdedRelu", foldable=False)
def thresholded_relu(ctx: OpContext, x):
    return torch.where(x > ctx.attr("alpha", 1.0), x, torch.zeros_like(x))
