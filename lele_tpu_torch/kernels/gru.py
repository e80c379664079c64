"""GRU recurrence: counterpart of lele_tpu/kernels/gru.py.

`gru_seq` replaces `gru_seq_pallas` (lele_tpu/kernels/gru.py:18): the whole
recurrence over S steps in one launch, with the input projection
xproj = x @ Wx + Wb computed outside (one large product), gates z, r, h in
ONNX's order, both `linear_before_reset` forms, all in f32. The kernel is
csrc/gru_seq.cu (design and bounds in its source note), in two forms: one
block per batch row up to H = 128, with all of the recurrent weight in
registers, and a cluster of 8 blocks above (the general
form of csrc/rnn_seq.cuh, which kernel 6 shares). Its range is
1 <= H <= MAX_H, any S and B (`kernel_takes`); callers check it before they
launch.

`gru_seq_plain` is the same function in plain PyTorch, a Python loop over S
with `gru_seq_reference`'s arithmetic (lele_tpu/kernels/gru.py:78-99). The
wrapper takes it only for a CPU tensor; for a CUDA tensor it launches the
kernel or raises. `gru_seq.launches` counts launches.
"""

from __future__ import annotations

import torch

from . import _build, _library

_STEM = "gru_seq"
MAX_H = 1024
_fn = None


def kernel_takes(hidden: int) -> bool:
    """The kernel's stated range: 1 <= H <= 1024 (any S and B). It covers
    JAX's Pallas gate (`_use_pallas_rnn`, lele_tpu/ops/nn_ops.py:475-489:
    S·B·4H·4 B < 4 MiB and B·H·4 B < 256 KiB) up to H = 1024 and any S
    beyond it. Above H = 1024 the emitter keeps the loop: Rh (12 MiB at
    H = 1024, 48 MiB at 2048) would no longer stay resident in the L2 from
    which the general form streams it every step."""
    return 1 <= hidden <= MAX_H


def gru_seq_plain(xproj: torch.Tensor, rh: torch.Tensor, rb: torch.Tensor, h0: torch.Tensor,
                  linear_before_reset: bool = True):
    """xproj [S, B, 3H], rh [H, 3H], rb [3H], h0 [B, H] → (hs [S, B, H],
    h_S), f32. Needs allow_tf32 off on a card (PyTorch's default)."""
    xproj, rh, rb = xproj.float(), rh.float(), rb.float().reshape(-1)
    h = h0.float()
    S, B, H3 = xproj.shape
    H = H3 // 3
    hs = torch.empty((S, B, H), dtype=torch.float32, device=xproj.device)
    for t in range(S):
        g = xproj[t]
        rproj = h @ rh + rb
        z = torch.sigmoid(g[:, :H] + rproj[:, :H])
        r = torch.sigmoid(g[:, H:2 * H] + rproj[:, H:2 * H])
        if linear_before_reset:
            hh = torch.tanh(g[:, 2 * H:] + r * rproj[:, 2 * H:])
        else:
            hh = torch.tanh(g[:, 2 * H:] + (r * h) @ rh[:, 2 * H:] + rb[2 * H:])
        h = (1.0 - z) * hh + z * h
        hs[t] = h
    return hs, h


def _check(xproj, rh, rb, h0):
    if xproj.dim() != 3 or xproj.shape[-1] % 3:
        raise ValueError(f"gru_seq: xproj must be [S, B, 3H], got {tuple(xproj.shape)}")
    S, B, H3 = xproj.shape
    H = H3 // 3
    if tuple(rh.shape) != (H, H3) or rb.numel() != H3 or tuple(h0.shape) != (B, H):
        raise ValueError(f"gru_seq: rh {tuple(rh.shape)}, rb {tuple(rb.shape)}, "
                         f"h0 {tuple(h0.shape)} for xproj {tuple(xproj.shape)}")
    for t in (rh, rb, h0):
        if t.device != xproj.device:
            raise ValueError("gru_seq: tensors on different devices")


def gru_seq_kernel(xproj: torch.Tensor, rh: torch.Tensor, rb: torch.Tensor, h0: torch.Tensor,
                   linear_before_reset: bool = True):
    """Launch csrc/gru_seq.cu on xproj's card and stream."""
    global _fn
    if not xproj.is_cuda:
        raise ValueError(f"gru_seq_kernel: xproj lies on {xproj.device}, not on a CUDA card")
    _check(xproj, rh, rb, h0)
    S, B, H3 = xproj.shape
    H = H3 // 3
    if not kernel_takes(H) or S < 1:
        raise ValueError(f"gru_seq_kernel: H = {H}, S = {S} is outside the kernel's "
                         f"range (1 <= H <= {MAX_H}, S >= 1)")
    if _fn is None:
        P, I = _build.P, _build.I
        _fn = _build.bind(_STEM, "gru_seq", [P, P, P, P, P, P, I, I, I, I, P])
    xproj, rh, rb, h0 = (t.float().contiguous() for t in (xproj, rh, rb.reshape(-1), h0))
    hs = torch.empty((S, B, H), dtype=torch.float32, device=xproj.device)
    hf = torch.empty((B, H), dtype=torch.float32, device=xproj.device)
    stream = torch.cuda.current_stream(xproj.device).cuda_stream
    code = _fn(xproj.data_ptr(), rh.data_ptr(), rb.data_ptr(), h0.data_ptr(), hs.data_ptr(),
               hf.data_ptr(), S, B, H, int(bool(linear_before_reset)), stream)
    _build.check(_STEM, "gru_seq", code)
    gru_seq.launches += 1
    return hs, hf


def gru_seq(xproj: torch.Tensor, rh: torch.Tensor, rb: torch.Tensor, h0: torch.Tensor,
            linear_before_reset: bool = True):
    """xproj [S, B, 3H] (x @ Wx + Wb), rh [H, 3H] (R transposed), rb [3H]
    (zeros if absent), h0 [B, H] → (hs [S, B, H], h_S [B, H]), f32. Calls
    the registered op `lele_tpu_torch::gru_seq` (kernels/_library.py)."""
    return _OP(xproj, rh, rb, h0, bool(linear_before_reset))


def _plain(xproj, rh, rb, h0, linear_before_reset):
    _check(xproj, rh, rb, h0)
    return gru_seq_plain(xproj, rh, rb, h0, linear_before_reset)


def _fake(xproj, rh, rb, h0, linear_before_reset):
    S, B, H3 = xproj.shape
    return (xproj.new_empty((S, B, H3 // 3), dtype=torch.float32),
            xproj.new_empty((B, H3 // 3), dtype=torch.float32))


_OP = _library.register(
    "gru_seq", "(Tensor xproj, Tensor rh, Tensor rb, Tensor h0, bool linear_before_reset) "
    "-> (Tensor, Tensor)", _plain, gru_seq_kernel, _fake)
gru_seq.launches = 0
