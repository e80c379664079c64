"""WAV reader and writer (the port's copy of lele_tpu/utils/wav.py): RIFF
PCM 8/16/24/32-bit and IEEE float in, mono-ized by averaging the channels;
PCM16 mono out. Reading goes through the native decoder
(runtime/native.py, built with g++ at first use; a failed build raises)
unless `try_native=False`, which keeps the pure-Python parser; both give
the same samples."""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np


def read_wav(path: str | Path, try_native: bool = True) -> tuple[np.ndarray, int]:
    """A WAV file → (mono float32 samples in [-1, 1], sample_rate)."""
    return decode_wav_bytes(Path(path).read_bytes(), label=str(path), try_native=try_native)


def decode_wav_bytes(data: bytes, label: str = "<bytes>",
                     try_native: bool = True) -> tuple[np.ndarray, int]:
    """WAV bytes → (mono float32 samples in [-1, 1], sample_rate)."""
    if try_native:
        from ..runtime.native import get_native

        try:
            raw, sr = get_native().decode_wav(data)
        except ValueError as e:
            raise ValueError(f"{label}: {e}") from None
        return np.frombuffer(raw, np.float32).copy(), sr
    return _parse_wav(data, label)


def _parse_wav(data: bytes, label: str) -> tuple[np.ndarray, int]:
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"{label}: not a RIFF/WAVE file")
    pos = 12
    fmt = None
    fmt_body = b""
    pcm = None
    while pos + 8 <= len(data):
        cid = data[pos : pos + 4]
        size = struct.unpack_from("<I", data, pos + 4)[0]
        body = data[pos + 8 : pos + 8 + size]
        if cid == b"fmt ":
            fmt = struct.unpack_from("<HHIIHH", body, 0)
            fmt_body = body
        elif cid == b"data":
            pcm = body
        pos += 8 + size + (size & 1)
    if fmt is None or pcm is None:
        raise ValueError(f"{label}: missing fmt/data chunk")
    audio_fmt, n_ch, sr, _, _, bits = fmt
    if audio_fmt == 0xFFFE:
        # WAVE_FORMAT_EXTENSIBLE: the real format code is the first two
        # bytes of the SubFormat GUID (fmt-body offset 24)
        if len(fmt_body) >= 26:
            audio_fmt = struct.unpack_from("<H", fmt_body, 24)[0]
        else:
            audio_fmt = 1
    if audio_fmt == 3:  # IEEE float
        x = np.frombuffer(pcm, dtype=np.float32 if bits == 32 else np.float64)
        x = x.astype(np.float32)
    elif audio_fmt == 1:
        if bits == 16:
            x = np.frombuffer(pcm, dtype="<i2").astype(np.float32) / 32768.0
        elif bits == 32:
            x = np.frombuffer(pcm, dtype="<i4").astype(np.float32) / 2147483648.0
        elif bits == 24:
            b = np.frombuffer(pcm, dtype=np.uint8).reshape(-1, 3)
            x = (
                b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16)
            )
            x = np.where(x >= 1 << 23, x - (1 << 24), x).astype(np.float32) / float(
                1 << 23
            )
        elif bits == 8:
            x = (np.frombuffer(pcm, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
        else:
            raise ValueError(f"unsupported PCM bit depth {bits}")
    else:
        raise ValueError(f"unsupported WAV format code {audio_fmt}")
    if n_ch > 1:
        x = x[: len(x) // n_ch * n_ch].reshape(-1, n_ch).mean(axis=1)
    return x, sr


def encode_wav(samples: np.ndarray, sr: int) -> bytes:
    """Samples → the bytes of a PCM16 mono WAV file (clamped to [-1, 1])."""
    x = np.clip(np.asarray(samples, np.float32), -1.0, 1.0)
    pcm = (x * 32767.0).astype("<i2").tobytes()
    hdr = b"RIFF" + struct.pack("<I", 36 + len(pcm)) + b"WAVE"
    fmt = b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, sr, sr * 2, 2, 16)
    dat = b"data" + struct.pack("<I", len(pcm))
    return hdr + fmt + dat + pcm


def write_wav(path: str | Path, samples: np.ndarray, sr: int) -> None:
    """PCM16 mono writer (clamped), matching the reference runners' output."""
    Path(path).write_bytes(encode_wav(samples, sr))
