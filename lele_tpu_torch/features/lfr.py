"""Low-frame-rate stacking (counterpart of lele_tpu/features/lfr.py).

[T, D] → [ceil(T/n), D*m]: output row i stacks frames i*n-pad .. i*n-pad+m-1
(pad = (m-1)//2) with indices clamped to [0, T-1]. One gather.
"""

from __future__ import annotations

import torch


def lfr_stack(x: torch.Tensor, m: int = 7, n: int = 6,
              n_valid: int | torch.Tensor | None = None) -> torch.Tensor:
    """n_valid: clamp stacking at the last VALID frame, so a padded buffer
    gives the same rows as an exact-length one (the bucketing path). An int,
    or a one-element tensor on x's device that is never read back (a
    captured CUDA graph then serves every length)."""
    t, d = x.shape
    if t == 0:
        return x.new_zeros((0, d * m))
    t_lfr = -(-t // n)
    pad = (m - 1) // 2
    # built on x's device: a host-made index would cost a synchronising copy
    idx = (torch.arange(t_lfr, device=x.device)[:, None] * n
           + torch.arange(m, device=x.device)[None, :] - pad).clamp(0, t - 1)
    if isinstance(n_valid, torch.Tensor):
        idx = torch.minimum(idx, torch.clamp(n_valid.reshape(()) - 1, min=0))
    elif n_valid is not None:
        idx = idx.clamp(max=max(int(n_valid) - 1, 0))
    return x[idx].reshape(t_lfr, d * m)
