"""Silero-style streaming VAD (counterpart of lele_tpu/models/silero.py).

STFT magnitude front-end → conv encoder (SiLU, stride-2 time reduction) →
LSTM cell carrying (h, c) across 512-sample chunks → sigmoid speech
probability; a hysteresis automaton turns probabilities into segments.
The 8 kHz branch upsamples 2x (each sample repeated) and takes the 16 kHz
front-end, resolved on the host as JAX resolves it at trace time.

Offline (`speech_probs`, `segments`): every chunk goes through the
front-end in one batch, the input projection for all chunks is one
product, and the whole recurrence is one launch of the `lstm_seq` kernel
(the TPU routing of `scan_fn`, silero.py:134-168), the whole of it one
captured CUDA graph a chunk count on a card. Streaming (`step_fn`): one
chunk and the state per call, through `lstm_cell`, with the state
donated. `segments` reads
back the N probabilities and runs the JAX package's on-device automaton
(silero.py:204-300) on the host, in float32 as it does, so its lists are
JAX's exactly.

`plain=True` runs the kernel's plain version on any device: it is the
oracle the kernel path is held against on the card, never the main path.
cuDNN's TF32 is off inside `conv1d`; products are f32 with PyTorch's
default `allow_tf32 = False`.
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import default_device
from ..features.framing import frame_signal
from ..kernels import lstm_seq, lstm_seq_plain
from ..runtime.graphs import Programs
from ..utils.consts import real_tensors
from .common import Params, conv1d, init_conv1d, init_linear, init_lstm_cell, linear, lstm_cell


@dataclass
class SileroConfig:
    chunk: int = 512
    context: int = 64  # leading context samples carried between chunks
    n_fft: int = 256
    hop: int = 64
    d_hidden: int = 128
    channels: tuple = (128, 64, 64, 128)
    sample_rate: int = 16000


def init_silero(gen: torch.Generator, cfg: SileroConfig) -> Params:
    """Random f32 params on `gen`'s device, shapes and scales as the JAX init."""
    p: Params = {"convs": []}
    c_in = cfg.n_fft // 2 + 1
    for c_out in cfg.channels:
        p["convs"].append(init_conv1d(gen, c_in, c_out, 3))
        c_in = c_out
    p["lstm"] = init_lstm_cell(gen, c_in, cfg.d_hidden)
    p["head"] = init_linear(gen, cfg.d_hidden, 1)
    return p


@functools.lru_cache(maxsize=8)
def _periodic_hann(n: int, device: torch.device) -> torch.Tensor:
    """The periodic Hann window on `device`, made once per (n, device): a
    host-made tensor inside a captured CUDA graph would be an upload each
    call, which a capture refuses. Callers must not write to it."""
    with real_tensors():
        return torch.from_numpy(np.hanning(n + 1)[:-1].astype(np.float32)).to(device)


def silero_features(params: Params, chunks: torch.Tensor, cfg: SileroConfig,
                    sr: int = 16000) -> torch.Tensor:
    """Batched front-end: chunks [B, chunk+context] → features [B, C]."""
    if sr not in (16000, 8000):
        raise ValueError("sr must be 16000 or 8000")
    x = chunks.float()
    if sr == 8000:
        x = torch.repeat_interleave(x, 2, dim=-1)  # jnp.repeat: each sample twice
    frames = frame_signal(x, cfg.n_fft, cfg.hop)
    win = _periodic_hann(cfg.n_fft, x.device)
    spec = torch.fft.rfft(frames * win, dim=-1)
    h = torch.sqrt(spec.real.square() + spec.imag.square() + 1e-12)  # [B, T, bins]
    for i, cp in enumerate(params["convs"]):
        h = torch.nn.functional.silu(conv1d(cp, h, stride=2 if i > 0 else 1, padding="SAME"))
    return h.mean(dim=1)  # [B, C], pooled over the reduced time


def silero_step(params: Params, chunk: torch.Tensor, state: torch.Tensor,
                cfg: SileroConfig, sr: int = 16000):
    """chunk [B, chunk+context], state [2, B, d_hidden] (h; c) →
    (prob [B, 1], new state)."""
    feat = silero_features(params, chunk, cfg, sr)
    h_new, c_new = lstm_cell(params["lstm"], feat, state[0], state[1])
    prob = torch.sigmoid(linear(params["head"], h_new))
    return prob, torch.stack([h_new, c_new])


def silero_scan(params: Params, chunks: torch.Tensor, cfg: SileroConfig, sr: int = 16000,
                plain: bool = False):
    """chunks [N, chunk+context] → (probs [N], state [2, 1, H]): the
    front-end for all chunks at once, one product for the input projection,
    one `lstm_seq` launch for the recurrence (its plain version with
    plain=True). Eager: `SileroVad.scan_fn` runs it as a captured program."""
    seq = lstm_seq_plain if plain else lstm_seq
    feats = silero_features(params, chunks, cfg, sr)  # [N, C]
    lp = params["lstm"]
    xproj = (feats @ lp["wx"] + lp["b"])[:, None, :]  # [N, 1, 4H]
    h0 = torch.zeros((1, cfg.d_hidden), dtype=torch.float32, device=feats.device)
    hs, hf, cf = seq(xproj, lp["wh"], h0, torch.zeros_like(h0))
    probs = torch.sigmoid(linear(params["head"], hs[:, 0]))[:, 0]
    return probs, torch.stack([hf, cf])


def zero_state(cfg: SileroConfig, batch: int = 1, device: torch.device | str | None = None):
    """The [2, batch, d_hidden] zero (h; c) state, on `device` (by default
    `default_device()`, which raises where there is no CUDA card)."""
    device = torch.device(device) if device is not None else default_device()
    return torch.zeros((2, batch, cfg.d_hidden), dtype=torch.float32, device=device)


@dataclass
class SileroVad:
    """Streaming and offline VAD on one device. `device` defaults to
    `default_device()`, which raises where there is no CUDA card: the CPU is
    taken only when the caller passes device="cpu".

    `step_fn` and `scan_fn` return programs (JAX's jitted `step_fn`, state
    donated, and `scan_fn`): on a card each is one CUDA graph a shape,
    captured at its first use (runtime/graphs.py), that holds the params it
    was called with first; on the CPU they run eagerly. `silero_step` and
    `silero_scan` are the uncaptured functions."""

    cfg: SileroConfig = field(default_factory=SileroConfig)
    params: Params | None = None
    device: torch.device | str | None = None
    programs: Programs | None = field(default=None, init=False, repr=False)

    def __post_init__(self):
        self.device = torch.device(self.device) if self.device is not None else default_device()
        self.programs = Programs(self.device)

    def init(self, seed: int = 0) -> Params:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        self.params = init_silero(gen, self.cfg)
        return self.params

    def step_fn(self, sr: int = 16000):
        """(params, chunk [B, chunk+context], state [2, B, H]) → (prob [B, 1],
        new state): one streaming step, its state donated (the new state
        is a copy the caller owns: pass it back in)."""
        cfg = self.cfg

        def fn(params, chunk, state):
            return self.programs.run(
                ("step", sr, tuple(chunk.shape)),
                lambda: lambda c, s: silero_step(params, c, s, cfg, sr),
                chunk, state, params=params, donate={1: 1})

        return fn

    def scan_fn(self, sr: int = 16000, plain: bool = False):
        """(params, chunks [N, chunk+context]) → (probs [N], state [2, 1, H]):
        `silero_scan`, a program per chunk count N; with plain=True the
        plain version, eagerly (the oracle)."""
        cfg = self.cfg

        if plain:
            @torch.inference_mode()
            def oracle(params, chunks):
                return silero_scan(params, torch.as_tensor(chunks, device=self.device), cfg,
                                   sr, plain=True)

            return oracle

        def fn(params, chunks):
            return self.programs.run(
                ("scan", sr, chunks.shape[0]),
                lambda: lambda c: silero_scan(params, c, cfg, sr),
                chunks, params=params)

        return fn

    def frame_chunks(self, pcm: np.ndarray) -> np.ndarray:
        """pcm → [N, context+chunk]: window i holds the last `context` samples
        of chunk i-1 (zeros before the first), then chunk i; every complete
        chunk is scored."""
        cfg = self.cfg
        pcm = np.asarray(pcm, np.float32)
        n = len(pcm) // cfg.chunk
        if n <= 0:
            return np.zeros((0, cfg.chunk + cfg.context), np.float32)
        padded = np.concatenate([np.zeros(cfg.context, pcm.dtype), pcm])
        idx = np.arange(n)[:, None] * cfg.chunk + np.arange(cfg.chunk + cfg.context)[None, :]
        return np.ascontiguousarray(padded[idx])

    def _probs(self, pcm: np.ndarray, sr: int, plain: bool = False) -> torch.Tensor:
        if self.params is None:
            self.init()
        chunks = self.frame_chunks(pcm)
        if chunks.shape[0] == 0:
            return torch.zeros((0,), dtype=torch.float32, device=self.device)
        return self.scan_fn(sr, plain)(self.params, torch.from_numpy(chunks))[0]

    def speech_probs(self, pcm: np.ndarray, sr: int = 16000, plain: bool = False) -> np.ndarray:
        """Per-chunk speech probabilities over a whole waveform (one
        `lstm_seq` launch; the plain version with plain=True)."""
        return self._probs(pcm, sr, plain).cpu().numpy()

    def segments(self, pcm: np.ndarray, seg_cfg: "VadSegmentConfig | None" = None,
                 sr: int = 16000) -> list[tuple[float, float]]:
        """Waveform → merged speech segments: the JAX package's device
        automaton (f32 times, at most MAX_SEGMENTS raw segments) on the
        read-back probabilities, then padding and merging."""
        seg_cfg = seg_cfg or VadSegmentConfig()
        if (seg_cfg.chunk, seg_cfg.sample_rate) != (self.cfg.chunk, self.cfg.sample_rate):
            # the automaton's chunk → seconds conversion uses the real chunking
            seg_cfg = dataclasses.replace(seg_cfg, chunk=self.cfg.chunk,
                                          sample_rate=self.cfg.sample_rate)
        probs = self._probs(pcm, sr).cpu().numpy()
        if probs.size == 0:
            return []
        return _pad_and_merge(_segments_f32(probs, seg_cfg), seg_cfg)


@dataclass
class VadSegmentConfig:
    """Hysteresis segmenter parameters (the JAX package's defaults)."""

    threshold: float = 0.3
    neg_threshold: float = 0.15
    min_silence_ms: float = 200.0
    min_speech_ms: float = 400.0
    pad_ms: float = 120.0
    merge_ms: float = 200.0
    chunk: int = 512
    sample_rate: int = 16000


# raw segments the JAX package's device automaton keeps (its segments_fn
# default, a fixed-size read-back buffer)
MAX_SEGMENTS = 64


def _segments_f32(probs: np.ndarray, cfg: VadSegmentConfig) -> list[list[np.float32]]:
    """Raw [start, end] segments as the JAX device automaton computes them
    (lele_tpu/models/silero.py:226-269): times in float32, each Python
    constant rounded to float32 first (JAX's weak typing), at most
    MAX_SEGMENTS kept, a trailing open segment flushed."""
    f32 = np.float32
    chunk_s = f32(cfg.chunk / cfg.sample_rate)
    thr, neg = f32(cfg.threshold), f32(cfg.neg_threshold)
    min_sil, min_speech = f32(cfg.min_silence_ms / 1000.0), f32(cfg.min_speech_ms / 1000.0)
    raw: list[list[np.float32]] = []

    def emit(start, end):
        if end - start >= min_speech and len(raw) < MAX_SEGMENTS:
            raw.append([start, end])

    in_speech, start, sil = False, f32(0.0), f32(0.0)
    for i, p in enumerate(np.asarray(probs, np.float32)):
        t = f32(i) * chunk_s
        enter = not in_speech and p >= thr
        if enter:
            start, sil = t, f32(0.0)
        below = in_speech and p < neg
        sil = sil + chunk_s if below else (f32(0.0) if in_speech else sil)
        if below and sil >= min_sil:
            emit(start, t + chunk_s - sil)
            in_speech = False
        else:
            in_speech = in_speech or enter
    if in_speech:
        emit(start, f32(len(probs) * (cfg.chunk / cfg.sample_rate)))
    return raw


def collect_segments(probs: np.ndarray, cfg: VadSegmentConfig) -> list[tuple[float, float]]:
    """Threshold/hysteresis collection → merged (start_s, end_s) segments
    (the JAX package's host collector, in float64)."""
    chunk_s = cfg.chunk / cfg.sample_rate
    min_sil = cfg.min_silence_ms / 1000.0
    min_speech = cfg.min_speech_ms / 1000.0
    raw: list[list[float]] = []
    in_speech = False
    start = 0.0
    silence_run = 0.0
    for i, p in enumerate(probs):
        t = i * chunk_s
        if not in_speech:
            if p >= cfg.threshold:
                in_speech = True
                start = t
                silence_run = 0.0
        elif p < cfg.neg_threshold:
            silence_run += chunk_s
            if silence_run >= min_sil:
                end = t + chunk_s - silence_run
                if end - start >= min_speech:
                    raw.append([start, end])
                in_speech = False
        else:
            silence_run = 0.0
    if in_speech:
        end = len(probs) * chunk_s
        if end - start >= min_speech:
            raw.append([start, end])
    return _pad_and_merge(raw, cfg)


def _pad_and_merge(raw, cfg: VadSegmentConfig) -> list[tuple[float, float]]:
    pad = cfg.pad_ms / 1000.0
    merge_gap = cfg.merge_ms / 1000.0
    merged: list[list[float]] = []
    for seg in raw:
        s, e = max(0.0, float(seg[0]) - pad), float(seg[1]) + pad
        if merged and s - merged[-1][1] <= merge_gap:
            merged[-1][1] = e
        else:
            merged.append([s, e])
    return [(round(s, 3), round(e, 3)) for s, e in merged]
