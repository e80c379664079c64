"""Compiled ONNX checkpoints with a model family's pipeline around them
(counterpart of lele_tpu/models/checkpoints.py): SenseVoice so far.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from .. import default_device
from ..features import FbankConfig, FbankFrontend, fbank_features
from .sensevoice import _collapse_ids


class SenseVoiceOnnx:
    """WAV → CTC ids through a compiled SenseVoice-class encoder graph.

    Takes the ONNX file's path or its bytes. Handles the FunASR 4-input
    signature (speech, speech_lengths, language, textnorm) and speech-only
    exports. PCM pads to length buckets and frames to multiples of
    FRAME_BUCKET, so the number of compiled traces stays bounded: one per
    bucket, each compiled at first use (`compile_count`). `device` defaults
    to `default_device()`, which raises where there is no CUDA card;
    `patterns` goes to `compile_model` ([] gives the per-op path)."""

    FRAME_BUCKET = 32

    def __init__(self, model: str | Path | bytes, language: int = 3, textnorm: int = 0,
                 device: torch.device | str | None = None, patterns=None):
        from ..onnx.loader import OnnxModel

        if isinstance(model, (bytes, bytearray, memoryview)):
            self.model = OnnxModel.from_bytes(bytes(model))
        else:
            self.model = OnnxModel.load(str(model))
        self.device = torch.device(device) if device is not None else default_device()
        self.in_names = self.model.input_names()
        self.language = language
        self.textnorm = textnorm
        self.patterns = patterns
        self._cms: dict[int, object] = {}
        self._buckets: dict[int, int] = {}  # pcm bucket → t_pad
        self.frontend = FbankFrontend(FbankConfig(), self.device)

    def _compiled(self, t_pad: int):
        if t_pad not in self._cms:
            from ..compiler import compile_model

            self._cms[t_pad] = compile_model(
                self.model, input_shapes={"speech": (1, t_pad, 560)},
                patterns=self.patterns, device=self.device)
        return self._cms[t_pad]

    def _inputs(self, padded: torch.Tensor, valid: int) -> dict:
        kwargs = {"speech": padded}
        if "speech_lengths" in self.in_names:
            kwargs["speech_lengths"] = np.asarray([valid], np.int64)
        if "language" in self.in_names:
            kwargs["language"] = np.asarray([self.language], np.int32)
        if "textnorm" in self.in_names:
            kwargs["textnorm"] = np.asarray([self.textnorm], np.int32)
        return {k: v for k, v in kwargs.items() if k in self.in_names}

    def _pad_frames(self, feats: torch.Tensor, t_pad: int) -> torch.Tensor:
        padded = torch.zeros((1, t_pad, feats.shape[-1]), dtype=torch.float32,
                             device=self.device)
        padded[0, : feats.shape[0]] = feats
        return padded

    @torch.inference_mode()
    def logits(self, pcm: np.ndarray) -> torch.Tensor:
        """Unbucketed waveform → logits [1, n_prefix + T, vocab] on the device."""
        feats = self.frontend(np.asarray(pcm, np.float32))
        t = feats.shape[0]
        t_pad = -(-t // self.FRAME_BUCKET) * self.FRAME_BUCKET
        cm = self._compiled(t_pad)
        logits = cm(**self._inputs(self._pad_frames(feats, t_pad), t))[0]
        n_prefix = logits.shape[1] - t_pad
        return logits[:, : n_prefix + t]

    def _pcm_bucket(self, n_pcm: int) -> int:
        """Smallest pcm-length bucket covering n_pcm: steps of FRAME_BUCKET
        LFR frames of audio, so the fbank's shape and the encoder's frame
        padding are shared by every input in the bucket."""
        c = self.frontend.config
        step = self.FRAME_BUCKET * c.lfr_n * c.hop_len
        return max(-(-n_pcm // step) * step, step)

    def _true_frames(self, n_pcm: int) -> int:
        """LFR frames the unpadded waveform produces (the front-end's formula)."""
        c = self.frontend.config
        t_raw = max(c.num_frames(n_pcm), 0)
        return -(-t_raw // c.lfr_n) if c.apply_lfr else t_raw

    @torch.inference_mode()
    def transcribe(self, pcm: np.ndarray, blank_id: int = 0,
                   n_prefix: int | None = None) -> list[int]:
        """Waveform → CTC ids. The fbank (mask-aware CMVN over the valid
        samples only), the frame padding, the compiled graph and the
        per-frame argmax run on the device; only [T] int32 ids come back."""
        pcm = np.asarray(pcm, np.float32)
        n_bucket = self._pcm_bucket(len(pcm))
        padded_pcm = np.zeros(n_bucket, np.float32)
        padded_pcm[: len(pcm)] = pcm
        fb = self.frontend
        feats, _ = fbank_features(padded_pcm, fb.config, fb.window, fb.mel_t,
                                  n_valid=len(pcm))
        t_pad = self._buckets.setdefault(
            n_bucket, -(-feats.shape[0] // self.FRAME_BUCKET) * self.FRAME_BUCKET)
        t = self._true_frames(len(pcm))
        cm = self._compiled(t_pad)
        logits = cm(**self._inputs(self._pad_frames(feats, t_pad), t))[0]
        if n_prefix is None:
            n_prefix = logits.shape[1] - t_pad
        ids = logits[0, n_prefix : n_prefix + t].argmax(dim=-1).to(torch.int32)
        return _collapse_ids(ids.cpu().numpy(), blank_id)

    def compile_count(self) -> int:
        """Distinct compiled traces so far (one per bucket)."""
        return len(self._cms)
