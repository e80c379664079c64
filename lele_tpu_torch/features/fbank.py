"""Kaldi-style fbank front-end (counterpart of lele_tpu/features/fbank.py).

×32768 scale → per-frame mean subtraction → pre-emphasis 0.97 (y[0] kept) →
symmetric Hann window → zero-pad to n_fft → rFFT (float32) → power
spectrum → 80-bin HTK mel (a plain matmul) → log(max(x, 1e-5)) → LFR → CMVN.
All frames at once, on the device the PCM lies on. The window and the mel
filterbank come from the port's `filters` module.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import default_device
from .cmvn import cmvn
from .filters import hann_window, mel_filterbank
from .framing import frame_signal
from .lfr import lfr_stack

__all__ = ["FbankConfig", "FbankFrontend", "fbank_features"]


@dataclass
class FbankConfig:
    """The front-end's settings (those of lele_tpu/features/fbank.py)."""

    sample_rate: int = 16000
    n_mels: int = 80
    frame_length_ms: float = 25.0
    frame_shift_ms: float = 10.0
    f_min: float = 20.0
    preemphasis: float = 0.97
    scale: float = 32768.0
    log_floor: float = 1e-5
    lfr_m: int = 7
    lfr_n: int = 6
    apply_lfr: bool = True
    apply_cmvn: bool = True

    @property
    def frame_len(self) -> int:
        return int(self.sample_rate * self.frame_length_ms / 1000.0)

    @property
    def hop_len(self) -> int:
        return int(self.sample_rate * self.frame_shift_ms / 1000.0)

    @property
    def n_fft(self) -> int:
        return 1024 if self.frame_len > 400 else 512

    def num_frames(self, n_samples: int) -> int:
        return (n_samples - self.frame_len) // self.hop_len + 1


class FbankFrontend:
    """Holds the window and mel constants on `device`; __call__(pcm) → features.
    `device` defaults to `default_device()`, which raises where there is no
    CUDA card: the CPU is taken only when the caller passes device="cpu"."""

    def __init__(self, config: FbankConfig | None = None,
                 device: torch.device | str | None = None):
        self.config = config or FbankConfig()
        self.device = torch.device(device) if device is not None else default_device()
        c = self.config
        self.window = torch.from_numpy(hann_window(c.frame_len)).to(self.device)
        # transposed [n_freqs, n_mels] so the device does power @ mel
        self.mel_t = torch.from_numpy(
            mel_filterbank(c.sample_rate, c.n_fft, c.n_mels, c.f_min).T.copy()
        ).to(self.device)

    def __call__(self, pcm):
        return fbank_features(pcm, self.config, self.window, self.mel_t)


def fbank_features(pcm, config: FbankConfig, window: torch.Tensor,
                   mel_t: torch.Tensor, n_valid: int | None = None):
    """pcm: [n_samples] f32 in [-1, 1] (or int16, already ×32768), numpy or
    tensor → [T_lfr, n_mels*lfr_m] f32 on `window`'s device.

    With `n_valid` (≤ n_samples, the length-bucketing path) CMVN covers only
    the valid frames and the function returns (features, frame_mask)."""
    c = config
    dev = window.device
    if isinstance(pcm, np.ndarray):
        pcm = torch.from_numpy(np.ascontiguousarray(pcm))
    pcm = pcm.to(dev)
    n = int(pcm.shape[-1])
    frame_len, hop = c.frame_len, c.hop_len
    if n < frame_len:
        d = c.n_mels * (c.lfr_m if c.apply_lfr else 1)
        empty = torch.zeros((0, d), dtype=torch.float32, device=dev)
        if n_valid is not None:
            return empty, torch.zeros((0,), dtype=torch.float32, device=dev)
        return empty
    n_frames = c.num_frames(n)
    raw = frame_signal(pcm, frame_len, hop)
    if pcm.dtype == torch.int16:
        frames = raw.float()  # i16 PCM carries the ×32768 scale natively
    else:
        frames = raw.float() * c.scale
    frames = frames - frames.mean(dim=1, keepdim=True)
    pre = torch.cat(
        [frames[:, :1], frames[:, 1:] - c.preemphasis * frames[:, :-1]], dim=1
    )
    spec = torch.fft.rfft(pre * window, n=c.n_fft, dim=1)
    power = spec.real.square() + spec.imag.square()  # [T, n_freqs]
    mel = power @ mel_t
    out = torch.log(torch.clamp(mel, min=c.log_floor))
    mask = None
    valid_frames = None
    if n_valid is not None:
        valid_frames = max((int(n_valid) - frame_len) // hop + 1, 0)
        mask = (torch.arange(n_frames, device=dev) < valid_frames).float()
    if c.apply_lfr:
        out = lfr_stack(out, c.lfr_m, c.lfr_n, n_valid=valid_frames)
        if mask is not None:
            valid_lfr = -(-valid_frames // c.lfr_n)
            mask = (torch.arange(out.shape[0], device=dev) < valid_lfr).float()
    if c.apply_cmvn:
        if mask is not None:
            denom = torch.clamp(mask.sum(), min=1.0)
            mean = (out * mask[:, None]).sum(dim=0, keepdim=True) / denom
            var = torch.clamp(
                (out.square() * mask[:, None]).sum(dim=0, keepdim=True) / denom
                - mean**2,
                min=0.0,
            )
            out = (out - mean) / torch.sqrt(var + 1e-5)
        else:
            out = cmvn(out)
    out = out.float()
    return (out, mask) if n_valid is not None else out
