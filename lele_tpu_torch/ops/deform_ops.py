"""DeformConv (opset 19/22; counterpart of lele_tpu/ops/deform_ops.py):
deformable convolution v2.

The sampling grid follows an input (the offsets), so no fixed-grid conv
computes it: every bilinear corner sample is gathered at once (im2col-sized),
then one grouped product with the kernel (`torch.einsum`, a library GEMM, as
JAX's einsum is XLA's). Offsets are laid out [offset_group, kH, kW, (dy,
dx)], the DCNv2 mask [offset_group, kH, kW]; outside the input a corner reads
0 and the others still blend.
"""

from __future__ import annotations

import torch

from .registry import OpContext, op


@op("DeformConv", foldable=False)
def deform_conv(ctx: OpContext, x, w, offset, b=None, mask=None):
    if x.dim() != 4:
        raise NotImplementedError(
            "DeformConv: only 2-D spatial input [N,C,H,W] is supported "
            "(the ONNX spec itself is 2-D-only as of opset 22)")
    n, c, h, w_in = x.shape
    oc, cpg, kh, kw = w.shape
    group = int(ctx.attr("group", 1))
    og = int(ctx.attr("offset_group", 1))
    strides = ctx.attr_ints("strides", [1, 1])
    pads = ctx.attr_ints("pads", [0, 0, 0, 0])
    dil = ctx.attr_ints("dilations", [1, 1])
    ks = ctx.attr_ints("kernel_shape", [kh, kw])
    if list(ks) != [kh, kw]:
        raise ValueError(f"DeformConv kernel_shape {ks} disagrees with W {[kh, kw]}")
    oh, ow = offset.shape[-2], offset.shape[-1]
    dev = x.device
    f32 = torch.promote_types(x.dtype, torch.float32)
    # the base sampling grid, [kH, oH] and [kW, oW]
    base_y = ((torch.arange(oh, device=dev) * strides[0] - pads[0])[None, :]
              + (torch.arange(kh, device=dev) * dil[0])[:, None])
    base_x = ((torch.arange(ow, device=dev) * strides[1] - pads[1])[None, :]
              + (torch.arange(kw, device=dev) * dil[1])[:, None])
    off = offset.reshape(n, og, kh, kw, 2, oh, ow)
    # sample coordinates [N, og, kH, kW, oH, oW]
    sy = base_y[None, None, :, None, :, None].to(f32) + off[:, :, :, :, 0].to(f32)
    sx = base_x[None, None, None, :, None, :].to(f32) + off[:, :, :, :, 1].to(f32)
    y0, x0 = torch.floor(sy), torch.floor(sx)
    wy1, wx1 = sy - y0, sx - x0  # the weights of the y0 + 1 and x0 + 1 corners
    xf = x.reshape(n, c, h * w_in)
    per = c // og

    def expand(t):  # [N, og, ...] → [N, C, kH, kW, oH, oW]: a channel's offset group
        return torch.repeat_interleave(t.reshape(n, og, -1), per, dim=1).reshape(
            n, c, kh, kw, oh, ow)

    def corner(yi, xi):
        valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w_in)
        flat = (yi.clamp(0, h - 1).long() * w_in + xi.clamp(0, w_in - 1).long())
        idx = torch.repeat_interleave(flat.reshape(n, og, -1), per, dim=1)  # [N, C, T]
        smp = torch.gather(xf, 2, idx).reshape(n, c, kh, kw, oh, ow)
        return torch.where(expand(valid), smp, 0)

    wy, wx = expand(wy1), expand(wx1)
    samples = (corner(y0, x0) * (1 - wy) * (1 - wx)
               + corner(y0, x0 + 1) * (1 - wy) * wx
               + corner(y0 + 1, x0) * wy * (1 - wx)
               + corner(y0 + 1, x0 + 1) * wy * wx)
    if mask is not None:
        samples = samples * expand(mask.reshape(n, og, kh, kw, oh, ow))
    # the grouped product: [N, G, C/G, kH, kW, oH, oW] x [G, oC/G, C/G, kH, kW]
    sg = samples.reshape(n, group, c // group, kh, kw, oh, ow).to(f32)
    wg = w.reshape(group, oc // group, cpg, kh, kw).to(f32)
    out = torch.einsum("ngcklhw,gockl->ngohw", sg, wg).reshape(n, oc, oh, ow).to(x.dtype)
    if b is not None:
        out = out + b.reshape(1, oc, 1, 1)
    return out
