"""Serving engines (counterpart of lele_tpu/serving.py): ASR, WAV bytes in,
token ids (or text, with a tokenizer) out; detection, an image (array or
encoded bytes) in, detections out; TTS, text in, WAV bytes out.

The engines may be called from several threads at once (the HTTP daemon's
handlers and its batchers' threads): each holds `runtime.graphs.CARD_LOCK`
around a request's card work, so that one request's programs, captures and
read-backs never interleave with another's. Decoding WAV and image bytes
runs outside it."""

from __future__ import annotations

import io
from dataclasses import dataclass, field
from typing import Any

import numpy as np

from .runtime.graphs import CARD_LOCK
from .utils.wav import decode_wav_bytes, encode_wav


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
    """recognize(wav_bytes) and recognize_batch([wav_bytes]) → token ids (or
    text with a tokenizer, e.g. `utils.tokenizer.CtcTokenizer`). With no
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
        """Run one request of silence before taking traffic: on a card it
        builds the kernels and captures the CUDA graph of that request's
        bucket, as JAX's warm-up compiles its program."""
        with CARD_LOCK:
            self.model.transcribe_ids(np.zeros(int(seconds * sr), np.float32))
        return self

    def recognize(self, wav_bytes: bytes):
        pcm, sr = decode_wav(wav_bytes)
        if sr != 16000:
            pcm = resample(pcm, sr, 16000)
        with CARD_LOCK:
            ids = self.model.transcribe_ids(pcm)
        if self.tokenizer is not None:
            return self.tokenizer.decode(ids)
        return ids

    def recognize_batch(self, wavs: list[bytes]):
        """Utterances decoded and resampled one by one, then run as one batch
        (`SenseVoiceModel.transcribe_batch`)."""
        pcms = []
        for data in wavs:
            pcm, sr = decode_wav(data)
            if sr != 16000:
                pcm = resample(pcm, sr, 16000)
            pcms.append(pcm)
        with CARD_LOCK:
            ids = self.model.transcribe_batch(pcms)
        if self.tokenizer is not None:
            return [self.tokenizer.decode(i) for i in ids]
        return ids


@dataclass
class Yolo26Engine:
    """detect(image array | JPEG/PNG bytes) and detect_batch(images) → lists
    of detections. With no model it builds a random-weight `Yolo26Model` on
    `device` (by default `default_device()`, which raises where there is no
    CUDA card). The forward is one program a batch bucket (JAX jits it): on
    a card one CUDA graph, captured at the bucket's first request with the
    model's params of that time, the images copied into its input buffer;
    `model.forward_fn()` is the uncaptured oracle. JAX's `mesh`
    (data-parallel serving) is not ported."""

    model: Any = None
    conf_threshold: float = 0.25
    device: Any = None
    programs: Any = field(default=None, init=False, repr=False)

    def __post_init__(self):
        from .runtime.graphs import Programs

        if self.model is None:
            from .models import Yolo26Model

            self.model = Yolo26Model(device=self.device)
            self.model.init(0)
        self.programs = Programs(self.model.device)

    def forward(self, x: np.ndarray):
        """[B, H, W, 3] f32 images (B a batch bucket) → the forward's outputs
        on the device, through the bucket's program."""
        from .models.yolo26 import yolo26_forward

        params, cfg = self.model.params, self.model.cfg
        return self.programs.run(("forward", x.shape), lambda: lambda img: yolo26_forward(
            params, img, cfg), x, params=params)

    def _to_input(self, image) -> np.ndarray:
        from .utils.image import preprocess

        if isinstance(image, (bytes, bytearray)):
            from PIL import Image

            image = np.asarray(Image.open(io.BytesIO(image)).convert("RGB"))
        return preprocess(image, self.model.cfg.img_size)[0]

    def detect(self, image) -> list[dict]:
        return self.detect_batch([image])[0]

    def batch(self, images: list) -> np.ndarray:
        """N images as `forward`'s input: one C-contiguous [B, size, size, 3]
        f32 batch, B padded to a power of two up to 8
        (`runtime.bucketing.pad_batch_pow2`) with zero images."""
        from .runtime.bucketing import pad_batch_pow2

        arrs = [self._to_input(im) for im in images]
        x = np.zeros((pad_batch_pow2(len(arrs)),) + arrs[0].shape, np.float32)
        for i, a in enumerate(arrs):
            x[i] = a
        return x

    def detect_batch(self, images: list) -> list[list[dict]]:
        """One forward for N images (`batch`)."""
        from .models import decode_detections

        if not images:
            return []
        n = len(images)
        x = self.batch(images)
        with CARD_LOCK:
            outs = self.forward(x)
            scores, boxes = (o[:n].cpu().numpy() for o in outs[:2])
        return [decode_detections(scores[i : i + 1], boxes[i : i + 1], self.conf_threshold)
                for i in range(n)]


@dataclass
class TtsEngine:
    """load_style(path) + synthesize(text) → WAV bytes, through the TTS's
    default route: one captured program a chunk (duration → mask → synth at
    a guessed bucket). With no model it builds a random-weight
    `SupertonicTts` on `device` (by default `default_device()`, which raises
    where there is no CUDA card)."""

    tts: Any = None
    styles: dict = field(default_factory=dict)
    device: Any = None

    def __post_init__(self):
        if self.tts is None:
            from .models import SupertonicTts

            self.tts = SupertonicTts(device=self.device)
            self.tts.init(0)

    def load_style(self, path: str, name: str | None = None):
        from .models import load_voice_style

        style = load_voice_style(path)
        self.styles[name or path] = style
        return style

    def synthesize(self, text: str, voice: str | None = None, lang: str = "en",
                   seed: int = 0) -> bytes:
        if voice and voice in self.styles:
            style = self.styles[voice]
        elif self.styles:
            style = next(iter(self.styles.values()))
        else:
            rng = np.random.default_rng(7)
            style = {
                "ttl": rng.standard_normal(self.tts.cfg.d_style).astype(np.float32),
                "dp": rng.standard_normal(self.tts.cfg.d_style).astype(np.float32),
            }
        with CARD_LOCK:
            wave = self.tts.synthesize(text, style, lang=lang, seed=seed)
        return encode_wav(wave, self.tts.cfg.sample_rate)
