"""Serving engine for ASR (counterpart of lele_tpu/serving.py): WAV bytes in,
token ids (or text, with a tokenizer) out."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np

from .utils.wav import decode_wav_bytes


def decode_wav(data: bytes) -> tuple[np.ndarray, int]:
    """WAV bytes → (mono f32 samples, sample_rate), by the port's pure-Python
    parser."""
    return decode_wav_bytes(data, label="<request>")


def resample(pcm: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Polyphase resampling (scipy)."""
    if sr_in == sr_out:
        return pcm
    from math import gcd

    from scipy.signal import resample_poly

    g = gcd(sr_in, sr_out)
    return resample_poly(pcm, sr_out // g, sr_in // g).astype(np.float32)


@dataclass
class SenseVoiceEngine:
    """recognize(wav_bytes) → token ids (or text with a tokenizer). With no
    model it builds a random-weight `SenseVoiceModel` on `default_device()`,
    which raises where there is no CUDA card."""

    model: Any = None
    tokenizer: Any = None

    def __post_init__(self):
        if self.model is None:
            from .models import SenseVoiceModel

            self.model = SenseVoiceModel()
            self.model.init(0)

    def warm(self, seconds: float = 2.0, sr: int = 16000):
        """Run one request of silence before taking traffic (builds the
        kernels on a card)."""
        self.model.transcribe_ids(np.zeros(int(seconds * sr), np.float32))
        return self

    def recognize(self, wav_bytes: bytes):
        pcm, sr = decode_wav(wav_bytes)
        if sr != 16000:
            pcm = resample(pcm, sr, 16000)
        ids = self.model.transcribe_ids(pcm)
        if self.tokenizer is not None:
            return self.tokenizer.decode(ids)
        return ids
