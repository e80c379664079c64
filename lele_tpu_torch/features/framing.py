"""Overlapping-frame extraction (counterpart of lele_tpu/features/framing.py).

The JAX version builds frames from static slices because a gather is slow
on a TPU. PyTorch's `Tensor.unfold` is a strided view with the same
semantics: frame t = x[t*hop : t*hop + frame_len].
"""

from __future__ import annotations

import torch


def frame_signal(x: torch.Tensor, frame_len: int, hop: int) -> torch.Tensor:
    """[..., n] → [..., n_frames, frame_len], n_frames = (n - frame_len)//hop + 1.

    Any dtype (int16 PCM included). The result is a view of `x`."""
    n = int(x.shape[-1])
    if (n - frame_len) // hop + 1 <= 0:
        return x.new_zeros((*x.shape[:-1], 0, frame_len))
    return x.unfold(-1, frame_len, hop)
