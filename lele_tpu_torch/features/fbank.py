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

__all__ = ["FbankConfig", "FbankFrontend", "fbank_features", "fbank_features_batch"]


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
                   mel_t: torch.Tensor, n_valid: int | torch.Tensor | None = None):
    """pcm: [n_samples] f32 in [-1, 1] (or int16, already ×32768), numpy or
    tensor → [T_lfr, n_mels*lfr_m] f32 on `window`'s device.

    With `n_valid` (≤ n_samples, the length-bucketing path) CMVN covers only
    the valid frames and the function returns (features, frame_mask): the
    batched front-end's row. `n_valid` may be an int or a one-element
    tensor on the device; a tensor stays there (it is never read back), so
    one captured CUDA graph serves every length of a bucket, as JAX's traced
    `n_valid` does."""
    c = config
    dev = window.device
    if isinstance(pcm, np.ndarray):
        pcm = torch.from_numpy(np.ascontiguousarray(pcm))
    pcm = pcm.to(dev)
    if n_valid is not None:
        n_valid = n_valid.reshape(1) if isinstance(n_valid, torch.Tensor) else [int(n_valid)]
        feats, masks = fbank_features_batch(pcm[None], c, window, mel_t, n_valid)
        return feats[0], masks[0]
    if int(pcm.shape[-1]) < c.frame_len:
        return torch.zeros((0, c.n_mels * (c.lfr_m if c.apply_lfr else 1)),
                           dtype=torch.float32, device=dev)
    out = _log_mel(pcm, c, window, mel_t)
    if c.apply_lfr:
        out = lfr_stack(out, c.lfr_m, c.lfr_n)
    if c.apply_cmvn:
        out = cmvn(out)
    return out.float()


def _log_mel(pcm: torch.Tensor, c: FbankConfig, window: torch.Tensor,
             mel_t: torch.Tensor) -> torch.Tensor:
    """[..., n] PCM (n ≥ one frame) → log-mel [..., n_frames, n_mels]."""
    raw = frame_signal(pcm, c.frame_len, c.hop_len)
    if pcm.dtype == torch.int16:
        frames = raw.float()  # i16 PCM carries the ×32768 scale natively
    else:
        frames = raw.float() * c.scale
    frames = frames - frames.mean(dim=-1, keepdim=True)
    pre = torch.cat(
        [frames[..., :1], frames[..., 1:] - c.preemphasis * frames[..., :-1]], dim=-1
    )
    spec = torch.fft.rfft(pre * window, n=c.n_fft, dim=-1)
    power = spec.real.square() + spec.imag.square()  # [..., T, n_freqs]
    mel = power @ mel_t
    return torch.log(torch.clamp(mel, min=c.log_floor))


def fbank_features_batch(pcm, config: FbankConfig, window: torch.Tensor,
                         mel_t: torch.Tensor, n_valid):
    """The bucketing path over a batch: pcm [B, n] padded (numpy or tensor)
    and n_valid [B] valid lengths → (features [B, T_lfr, n_mels*lfr_m],
    frame masks [B, T_lfr]) on `window`'s device; row b is
    `fbank_features(pcm[b], ..., n_valid=n_valid[b])` (JAX vmaps that
    function). The lengths stay on the device: no row waits on the host.
    A row with n_valid = 0 has an all-zero mask, and its CMVN divides by
    max(Σmask, 1)."""
    c = config
    dev = window.device
    if isinstance(pcm, np.ndarray):
        pcm = torch.from_numpy(np.ascontiguousarray(pcm))
    pcm = pcm.to(dev)
    n_valid = torch.as_tensor(n_valid).to(device=dev, dtype=torch.int64)
    B, n = pcm.shape
    if n < c.frame_len:
        d = c.n_mels * (c.lfr_m if c.apply_lfr else 1)
        return (torch.zeros((B, 0, d), dtype=torch.float32, device=dev),
                torch.zeros((B, 0), dtype=torch.float32, device=dev))
    out = _log_mel(pcm, c, window, mel_t)  # [B, T, n_mels]
    n_frames = out.shape[1]
    valid_frames = torch.clamp(
        torch.div(n_valid - c.frame_len, c.hop_len, rounding_mode="floor") + 1, min=0)
    mask = (torch.arange(n_frames, device=dev)[None] < valid_frames[:, None]).float()
    if c.apply_lfr:
        m, step = c.lfr_m, c.lfr_n
        t_lfr = -(-n_frames // step)
        idx = (torch.arange(t_lfr, device=dev)[:, None] * step
               + torch.arange(m, device=dev)[None, :] - (m - 1) // 2).clamp(0, n_frames - 1)
        idx = torch.minimum(idx[None], torch.clamp(valid_frames - 1, min=0)[:, None, None])
        rows = torch.arange(B, device=dev)[:, None, None]
        out = out[rows, idx].reshape(B, t_lfr, m * out.shape[-1])
        valid_lfr = torch.div(valid_frames + step - 1, step, rounding_mode="floor")
        mask = (torch.arange(t_lfr, device=dev)[None] < valid_lfr[:, None]).float()
    if c.apply_cmvn:
        denom = torch.clamp(mask.sum(dim=1), min=1.0)[:, None, None]
        mean = (out * mask[..., None]).sum(dim=1, keepdim=True) / denom
        var = torch.clamp(
            (out.square() * mask[..., None]).sum(dim=1, keepdim=True) / denom - mean**2,
            min=0.0,
        )
        out = (out - mean) / torch.sqrt(var + 1e-5)
    return out.float(), mask
