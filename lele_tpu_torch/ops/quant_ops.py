"""Quantization emitters (counterpart of lele_tpu/ops/quant_ops.py):
DynamicQuantizeLinear and MatMulInteger, with exact ONNX semantics.

Quantization divides by the scale and rounds half to even (numpy's and
torch's `round`), as the spec and the JAX emitter do. torch's matmul takes
no integer operands on a card, so MatMulInteger forms its exact int32 sum as
a float64 product: every operand is an integer below 2^8 in magnitude and
|sum| <= K * 255 * 255 < 2^53 for any K below 2^37, so no partial sum
rounds. It is a plain product outside any kernel, as MatMulInteger is a
plain XLA dot in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

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


@op("MatMulInteger", foldable=False)
def matmul_integer(ctx: OpContext, a, b, azp=None, bzp=None):
    """(A - azp) @ (B - bzp) → int32; per-row azp [M] and per-column bzp
    [N] are supported."""
    c = torch.matmul(_centered_f64(a, azp, (-1, 1)), _centered_f64(b, bzp, (1, -1)))
    return c.to(torch.int32)
