"""Window and mel-filterbank construction (host-side numpy; counterpart of
lele_tpu/features/filters.py, kept as the port's own copy).

`hann_window` is symmetric (denominator size - 1); `mel_filterbank` is the
HTK triangular filterbank with n_mels + 2 mel points spaced linearly between
f_min and f_max, strict inequality at each triangle's left edge. Both are
computed once per front-end; the device sees only the constants.
"""

from __future__ import annotations

import numpy as np


def hann_window(size: int, dtype=np.float32) -> np.ndarray:
    if size == 0:
        return np.zeros(0, dtype)
    if size == 1:
        return np.ones(1, dtype)
    n = np.arange(size, dtype=np.float64)
    return (0.5 * (1.0 - np.cos(2.0 * np.pi * n / (size - 1)))).astype(dtype)


def hz_to_mel_htk(hz):
    return 2595.0 * np.log10(1.0 + np.asarray(hz, np.float64) / 700.0)


def mel_to_hz_htk(mel):
    return 700.0 * (10.0 ** (np.asarray(mel, np.float64) / 2595.0) - 1.0)


def mel_filterbank(
    sample_rate: float,
    n_fft: int,
    n_mels: int,
    f_min: float = 0.0,
    f_max: float | None = None,
    dtype=np.float32,
) -> np.ndarray:
    """[n_mels, n_fft//2+1] triangular HTK filterbank."""
    f_max = sample_rate / 2.0 if f_max is None else f_max
    n_freqs = n_fft // 2 + 1
    mel_min = hz_to_mel_htk(f_min)
    mel_max = hz_to_mel_htk(f_max)
    mel_pts = mel_min + (mel_max - mel_min) / (n_mels + 1) * np.arange(n_mels + 2)
    hz_pts = mel_to_hz_htk(mel_pts)
    fft_freqs = np.arange(n_freqs, dtype=np.float64) * sample_rate / n_fft
    f_left = hz_pts[:-2, None]
    f_center = hz_pts[1:-1, None]
    f_right = hz_pts[2:, None]
    f = fft_freqs[None, :]
    up = (f - f_left) / (f_center - f_left)
    down = (f_right - f) / (f_right - f_center)
    w = np.where(
        (f > f_left) & (f < f_center),
        up,
        np.where((f >= f_center) & (f < f_right), down, 0.0),
    )
    return w.astype(dtype)
