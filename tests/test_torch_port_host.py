"""The port's own copies of the JAX package's host modules, and the rule that
its entry points run on the card.

The port imports nothing from lele_tpu, so it keeps copies of the numpy-only
modules it needs: the front-end's window and mel filterbank, FbankConfig,
the length buckets and the WAV parser. Each copy is held against the JAX
module on the same inputs: filters and bucket tables bit for bit, decoded
samples equal. With no CUDA card, `default_device()` and every entry point
called without `device="cpu"` raise instead of running on the CPU.
"""

import dataclasses
import struct

import numpy as np
import pytest
import torch

from lele_tpu.features.fbank import FbankConfig as JFbankConfig
from lele_tpu.features.filters import hann_window as j_hann
from lele_tpu.features.filters import mel_filterbank as j_mel
from lele_tpu.runtime import bucketing as jbucket
from lele_tpu.utils.wav import decode_wav_bytes as j_decode
from lele_tpu_torch.features.fbank import FbankConfig
from lele_tpu_torch.features.filters import hann_window, mel_filterbank
from lele_tpu_torch.runtime import bucketing
from lele_tpu_torch.utils.wav import decode_wav_bytes


@pytest.mark.parametrize("size", [0, 1, 2, 400, 401, 512])
def test_hann_window_is_the_jax_copy_bit_for_bit(size):
    for dtype in (np.float32, np.float64):
        got, want = hann_window(size, dtype), j_hann(size, dtype)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


@pytest.mark.parametrize("sr,n_fft,n_mels,f_min,f_max", [
    (16000, 512, 80, 20.0, None), (16000, 512, 80, 0.0, 7600.0),
    (8000, 256, 40, 20.0, None), (22050, 1024, 128, 0.0, None)])
def test_mel_filterbank_is_the_jax_copy_bit_for_bit(sr, n_fft, n_mels, f_min, f_max):
    got = mel_filterbank(sr, n_fft, n_mels, f_min, f_max)
    want = j_mel(sr, n_fft, n_mels, f_min, f_max)
    assert got.shape == want.shape and got.tobytes() == want.tobytes()


def test_fbank_config_matches_jax():
    got, want = FbankConfig(), JFbankConfig()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for sr in (8000, 16000, 48000):
        g, w = FbankConfig(sample_rate=sr), JFbankConfig(sample_rate=sr)
        assert (g.frame_len, g.hop_len, g.n_fft) == (w.frame_len, w.hop_len, w.n_fft)
        for n in (0, 399, 400, 16000, 160_000):
            assert g.num_frames(n) == w.num_frames(n)


def test_bucket_table_and_padding_match_jax():
    assert bucketing.DEFAULT_AUDIO_BUCKETS_S == jbucket.DEFAULT_AUDIO_BUCKETS_S
    assert bucketing.max_bucket_samples() == jbucket.max_bucket_samples()
    assert bucketing.max_bucket_samples(8000, (1, 2)) == jbucket.max_bucket_samples(8000, (1, 2))
    rng = np.random.default_rng(0)
    for n in (0, 1, 15999, 16000, 16001, 68_800, 160_000, 960_000):
        pcm = rng.standard_normal(n).astype(np.float32)
        (got, gn), (want, wn) = bucketing.pad_pcm(pcm), jbucket.pad_pcm(pcm)
        assert gn == wn and got.dtype == want.dtype and got.tobytes() == want.tobytes()
        assert bucketing.bucket_for(n, (1, 5, 9)) == jbucket.bucket_for(n, (1, 5, 9))
    too_long = np.zeros(960_001, np.float32)
    for mod in (bucketing, jbucket):
        with pytest.raises(ValueError):
            mod.pad_pcm(too_long)


def _wav(samples: bytes, fmt_code: int, channels: int, sr: int, bits: int,
         extensible: bool = False) -> bytes:
    block = channels * bits // 8
    if extensible:
        body = struct.pack("<HHIIHHHHI", 0xFFFE, channels, sr, sr * block, block, bits,
                           22, bits, 0) + struct.pack("<H", fmt_code) + bytes(14)
    else:
        body = struct.pack("<HHIIHH", fmt_code, channels, sr, sr * block, block, bits)
    chunks = b"fmt " + struct.pack("<I", len(body)) + body
    chunks += b"LIST" + struct.pack("<I", 3) + b"abc\x00"  # an odd chunk, padded
    chunks += b"data" + struct.pack("<I", len(samples)) + samples
    return b"RIFF" + struct.pack("<I", 4 + len(chunks)) + b"WAVE" + chunks


def _wav_cases():
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, 300)
    i16 = (x * 32767).astype("<i2").tobytes()
    u8 = (x * 127 + 128).astype(np.uint8).tobytes()
    i32 = (x * 2**31 * 0.99).astype("<i4").tobytes()
    i24 = b"".join(int(v).to_bytes(3, "little", signed=True)
                   for v in (x * 2**23 * 0.99).astype(np.int64))
    f32 = x.astype("<f4").tobytes()
    f64 = x.astype("<f8").tobytes()
    return {
        "pcm16_mono": _wav(i16, 1, 1, 16000, 16),
        "pcm16_stereo": _wav(i16, 1, 2, 8000, 16),
        "pcm8": _wav(u8, 1, 1, 16000, 8),
        "pcm24": _wav(i24, 1, 1, 16000, 24),
        "pcm32": _wav(i32, 1, 1, 44100, 32),
        "float32": _wav(f32, 3, 1, 16000, 32),
        "float64_stereo": _wav(f64, 3, 2, 16000, 64),
        "extensible_float": _wav(f32, 3, 1, 16000, 32, extensible=True),
    }


@pytest.mark.parametrize("case", list(_wav_cases()))
def test_wav_parser_matches_jax(case):
    data = _wav_cases()[case]
    got, gsr = decode_wav_bytes(data)
    want, wsr = j_decode(data, try_native=False)
    assert gsr == wsr and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("data", [b"", b"RIFF\x00\x00\x00\x00WAVX", b"RIFF\x04\x00\x00\x00WAVE"],
                         ids=["empty", "not_wave", "no_chunks"])
def test_wav_parser_refuses_what_jax_refuses(data):
    with pytest.raises(ValueError):
        j_decode(data, try_native=False)
    with pytest.raises(ValueError):
        decode_wav_bytes(data)


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_raises_without_a_card(no_card):
    from lele_tpu_torch import default_device

    with pytest.raises(RuntimeError, match="no CUDA card"):
        default_device()


def test_entry_points_raise_without_a_card(no_card):
    """Each entry point called without device="cpu" raises; it does not
    carry on on the CPU."""
    from lele_tpu_torch.compiler import compile_model
    from lele_tpu_torch.models import SenseVoiceConfig, SenseVoiceModel
    from lele_tpu_torch.models.checkpoints import SenseVoiceOnnx
    from lele_tpu_torch.onnx.synth import build_sanm_int8_model
    from lele_tpu_torch.serving import SenseVoiceEngine

    graph = build_sanm_int8_model(L=1, d=64, h=2, ffn=96, vocab=32)
    for make in (lambda: SenseVoiceModel(SenseVoiceConfig(n_layers=1)),
                 lambda: SenseVoiceEngine(),
                 lambda: SenseVoiceOnnx(graph),
                 lambda: compile_model(graph, input_shapes={"speech": (1, 8, 560)})):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            make()
    # the same calls run where the caller asks for the CPU
    SenseVoiceOnnx(graph, device="cpu")
    compile_model(graph, input_shapes={"speech": (1, 8, 560)}, device="cpu")


def test_frontend_and_vad_state_raise_without_a_card(no_card):
    """FbankFrontend and zero_state default to the card as the model
    constructors do: without one they raise, and run where the caller asks
    for the CPU."""
    from lele_tpu_torch.features import FbankFrontend
    from lele_tpu_torch.models import SileroConfig, zero_state

    for make in (lambda: FbankFrontend(), lambda: zero_state(SileroConfig())):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            make()
    assert FbankFrontend(device="cpu").window.device.type == "cpu"
    assert zero_state(SileroConfig(), 2, device="cpu").shape == (2, 2, 128)
