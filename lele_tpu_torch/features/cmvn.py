"""Cepstral mean/variance normalisation (counterpart of lele_tpu/features/cmvn.py).

Utterance-level: per-dim mean/std over time with biased variance and
std = sqrt(max(var, 0) + eps).
"""

from __future__ import annotations

import torch


def cmvn(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    mean = x.mean(dim=0, keepdim=True)
    var = torch.clamp(x.square().mean(dim=0, keepdim=True) - mean**2, min=0.0)
    return (x - mean) / torch.sqrt(var + eps)
