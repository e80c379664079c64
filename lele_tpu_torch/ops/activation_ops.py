"""Activation emitters (counterpart of lele_tpu/ops/activation_ops.py):
Relu, LeakyRelu, Sigmoid, Softmax, Tanh, Softplus and Gelu."""

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


@op("Softmax", foldable=False)
def softmax(ctx: OpContext, x):
    if ctx.opset >= 13:
        return torch.softmax(x, dim=ctx.attr("axis", -1))
    # opset < 13: flatten to 2-D at axis, softmax over the trailing block
    axis = ctx.attr("axis", 1)
    shape = tuple(x.shape)
    axis = axis if axis >= 0 else axis + len(shape)
    lead = int(np.prod(shape[:axis])) if axis else 1
    return torch.softmax(x.reshape(lead, -1), dim=-1).reshape(shape)


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
