"""LSTM recurrence: counterpart of lele_tpu/kernels/lstm.py.

`lstm_seq` replaces `lstm_seq_pallas` (lele_tpu/kernels/lstm.py:21): the
whole recurrence over S steps in one launch, with the input projection
xproj = x @ Wx + b computed outside (one large product), gate order
i, f, g, o, all in f32. The kernel is csrc/lstm_seq.cu (design and bounds in
its source note), in two forms:

- H <= 128: the register form, one block of 256 threads per batch row,
  each thread two units' four gate columns over a quarter of the rows, 24
  of its 32 rows of Wh in registers and 8 in shared memory, the quarters
  summed by warp shuffles, h exchanged through shared memory with one
  barrier a step;
- 128 < H <= 1024: the general form of csrc/rnn_seq.cuh (kernel 9 shares
  it), a cluster of 8 blocks per batch row, each owning an eighth of the
  units, with h exchanged through distributed shared memory and one cluster
  barrier a step.

Its range is 1 <= H <= MAX_H, any S and B (`kernel_takes`); callers check
it before they launch.

`lstm_seq_plain` is the same function in plain PyTorch, a Python loop over
S (as `lstm_seq_reference` is a `lax.scan`). The wrapper takes it only for
a CPU tensor; for a CUDA tensor it launches the kernel or raises.
`lstm_seq.launches` counts launches.
"""

from __future__ import annotations

import torch

from . import _build

_STEM = "lstm_seq"
MAX_H = 1024
_fn = None


def kernel_takes(hidden: int) -> bool:
    """The kernel's stated range: 1 <= H <= 1024 (any S and B). It covers
    JAX's Pallas gate (`_use_pallas_rnn`, lele_tpu/ops/nn_ops.py:475-489:
    S·B·4H·4 B < 4 MiB and B·H·4 B < 256 KiB) up to H = 1024 and any S
    beyond it. Above H = 1024 the emitter keeps the loop: Wh (16 MiB at
    H = 1024, 64 MiB at 2048) would no longer stay resident in the L2 from
    which the general form streams it every step."""
    return 1 <= hidden <= MAX_H


def lstm_seq_plain(xproj: torch.Tensor, wh: torch.Tensor, h0: torch.Tensor,
                   c0: torch.Tensor):
    """xproj [S, B, 4H], wh [H, 4H], h0 and c0 [B, H] → (hs [S, B, H], h_S,
    c_S), f32. Needs allow_tf32 off on a card (PyTorch's default)."""
    xproj, wh = xproj.float(), wh.float()
    h, c = h0.float(), c0.float()
    S, B, H4 = xproj.shape
    H = H4 // 4
    hs = torch.empty((S, B, H), dtype=torch.float32, device=xproj.device)
    for t in range(S):
        g = xproj[t] + h @ wh
        i = torch.sigmoid(g[:, :H])
        f = torch.sigmoid(g[:, H:2 * H])
        gg = torch.tanh(g[:, 2 * H:3 * H])
        o = torch.sigmoid(g[:, 3 * H:])
        c = f * c + i * gg
        h = o * torch.tanh(c)
        hs[t] = h
    return hs, h, c


def _check(xproj, wh, h0, c0):
    if xproj.dim() != 3 or xproj.shape[-1] % 4:
        raise ValueError(f"lstm_seq: xproj must be [S, B, 4H], got {tuple(xproj.shape)}")
    S, B, H4 = xproj.shape
    H = H4 // 4
    if tuple(wh.shape) != (H, H4) or tuple(h0.shape) != (B, H) or tuple(c0.shape) != (B, H):
        raise ValueError(f"lstm_seq: wh {tuple(wh.shape)}, h0 {tuple(h0.shape)}, "
                         f"c0 {tuple(c0.shape)} for xproj {tuple(xproj.shape)}")
    for t in (wh, h0, c0):
        if t.device != xproj.device:
            raise ValueError("lstm_seq: tensors on different devices")


def lstm_seq_kernel(xproj: torch.Tensor, wh: torch.Tensor, h0: torch.Tensor,
                    c0: torch.Tensor):
    """Launch csrc/lstm_seq.cu on xproj's card and stream."""
    global _fn
    if not xproj.is_cuda:
        raise ValueError(f"lstm_seq_kernel: xproj lies on {xproj.device}, not on a CUDA card")
    _check(xproj, wh, h0, c0)
    S, B, H4 = xproj.shape
    H = H4 // 4
    if not kernel_takes(H) or S < 1:
        raise ValueError(f"lstm_seq_kernel: H = {H}, S = {S} is outside the kernel's "
                         f"range (1 <= H <= {MAX_H}, S >= 1)")
    if _fn is None:
        P, I = _build.P, _build.I
        _fn = _build.bind(_STEM, "lstm_seq", [P, P, P, P, P, P, P, I, I, I, P])
    xproj, wh, h0, c0 = (t.float().contiguous() for t in (xproj, wh, h0, c0))
    if wh.data_ptr() % 16:  # the register form copies Wh's rows in 16-byte units
        wh = wh.clone()
    hs = torch.empty((S, B, H), dtype=torch.float32, device=xproj.device)
    hf = torch.empty((B, H), dtype=torch.float32, device=xproj.device)
    cf = torch.empty((B, H), dtype=torch.float32, device=xproj.device)
    stream = torch.cuda.current_stream(xproj.device).cuda_stream
    code = _fn(xproj.data_ptr(), wh.data_ptr(), h0.data_ptr(), c0.data_ptr(),
               hs.data_ptr(), hf.data_ptr(), cf.data_ptr(), S, B, H, stream)
    _build.check(_STEM, "lstm_seq", code)
    lstm_seq.launches += 1
    return hs, hf, cf


def lstm_seq(xproj: torch.Tensor, wh: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor):
    """xproj [S, B, 4H] (x @ Wx + b), wh [H, 4H], h0 and c0 [B, H] →
    (hs [S, B, H], h_S [B, H], c_S [B, H]), f32."""
    if xproj.device.type == "cpu":
        _check(xproj, wh, h0, c0)
        return lstm_seq_plain(xproj, wh, h0, c0)
    return lstm_seq_kernel(xproj, wh, h0, c0)


lstm_seq.launches = 0
