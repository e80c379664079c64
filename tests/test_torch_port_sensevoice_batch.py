"""The port's batch and long-form SenseVoice paths against lele_tpu's, at
small sizes: length and batch bucketing, the batched front-end,
`transcribe_batch`, `transcribe_long`, a quantized batch and
`SenseVoiceEngine.recognize_batch`.

Weights are made by the JAX package and carried over with
`from_numpy_tree`; PCM is made with numpy from seeds. On the CPU the port's
kernels take their plain versions.
"""

import io
import wave

import jax
import numpy as np
import pytest
import torch

from lele_tpu.models import SenseVoiceConfig as JConfig
from lele_tpu.models import SenseVoiceModel as JModel
from lele_tpu.models.sensevoice import prepare_quantized_params as jprepare_q
from lele_tpu.models.sensevoice import prepare_w8_params as jprepare_w8
from lele_tpu.runtime import bucketing as jb
from lele_tpu.serving import SenseVoiceEngine as JEngine
from lele_tpu.utils.tokenizer import CtcTokenizer as JTokenizer
from lele_tpu_torch.features import FbankFrontend, fbank_features, fbank_features_batch
from lele_tpu_torch.models import SenseVoiceConfig, SenseVoiceModel
from lele_tpu_torch.models import sensevoice as sv
from lele_tpu_torch.params import from_numpy_tree
from lele_tpu_torch.runtime import bucketing as tb
from lele_tpu_torch.serving import SenseVoiceEngine
from lele_tpu_torch.utils.tokenizer import CtcTokenizer, synthetic_vocab

TINY = dict(n_layers=2, d_model=64, n_heads=2, ffn_dim=96, vocab_size=40, dtype="float32")


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _pcms(n, seed=31):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(9_000 + 700 * i) * 0.1).astype(np.float32) for i in range(n)]


@pytest.fixture(scope="module")
def models():
    """A tiny f32 model on both sides, the same weights."""
    jm = JModel(JConfig(**TINY))
    jm.init(0)
    tm = SenseVoiceModel(SenseVoiceConfig(**TINY), device="cpu")
    tm.params = from_numpy_tree(_np_tree(jm.params))
    return jm, tm


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 9, 33])
def test_pad_batch_pow2_matches_jax(n):
    assert tb.pad_batch_pow2(n) == jb.pad_batch_pow2(n)
    assert tb.pad_batch_pow2(n, cap=4) == jb.pad_batch_pow2(n, cap=4)


@pytest.mark.parametrize("true,padded", [(16000, 32000), (0, 16000), (399, 16000),
                                         (400, 16000), (12345, 48000)])
def test_frames_and_feat_mask_match_jax(true, padded):
    assert tb.frames_for_samples(true) == jb.frames_for_samples(true)
    np.testing.assert_array_equal(tb.feat_mask_for(true, padded),
                                  jb.feat_mask_for(true, padded))


def test_batched_front_end_equals_single_rows():
    """Row b of the batch is the single-row bucketed front-end at n_valid[b],
    exactly, a padding row (n_valid = 0) and a row under one frame included."""
    fb = FbankFrontend(device="cpu")
    rng = np.random.default_rng(2)
    lens = np.array([48000, 30000, 0, 350, 401])
    batch = np.zeros((len(lens), 48000), np.float32)
    for i, n in enumerate(lens):
        batch[i, :n] = rng.standard_normal(n) * 0.1
    feats, masks = fbank_features_batch(batch, fb.config, fb.window, fb.mel_t, lens)
    assert tuple(feats.shape) == (5, 50, 560) and tuple(masks.shape) == (5, 50)
    for i, n in enumerate(lens):
        f, m = fbank_features(batch[i], fb.config, fb.window, fb.mel_t, n_valid=int(n))
        torch.testing.assert_close(feats[i], f, rtol=0, atol=0)
        torch.testing.assert_close(masks[i], m, rtol=0, atol=0)
    assert masks[2].sum() == 0 and torch.isfinite(feats[2]).all()


def test_batched_front_end_matches_jax_vmap():
    """Against JAX's vmapped fbank (sensevoice.py:597-603), rows and masks."""
    from lele_tpu.features import FbankFrontend as JFbank
    from lele_tpu.features.fbank import fbank_features as jfbank

    jf, fb = JFbank(), FbankFrontend(device="cpu")
    rng = np.random.default_rng(3)
    lens = np.array([32000, 17000, 0, 9000], np.int32)
    batch = np.zeros((4, 32000), np.float32)
    for i, n in enumerate(lens):
        batch[i, :n] = rng.standard_normal(n) * 0.1
    want_f, want_m = jax.vmap(lambda p, n: jfbank(p, jf.config, jf.window, jf.mel_t,
                                                  n_valid=n))(batch, lens)
    got_f, got_m = fbank_features_batch(batch, fb.config, fb.window, fb.mel_t, lens)
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    # float32 summation orders of the rFFT and mel product, scaled up by
    # CMVN: the single-row gate (atol 1e-3, test_torch_port_features.py)
    # plus 1e-3 of the value, as the gap grows with the feature (the first
    # run read 2.1e-3 at |ref| 7.4 in the row with 9,000 of 32,000 samples;
    # JAX's vmap equals its single rows exactly, as the port's batch does)
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
def test_transcribe_batch_matches_jax_and_single(models, n):
    """JAX's tests/test_bucketing.py:126-160 on the port at f32: the batch
    (padded to a power of two) gives each utterance's own transcribe_ids,
    and JAX's transcribe_batch."""
    jm, tm = models
    pcms = _pcms(n)
    got = tm.transcribe_batch(pcms)
    assert got == jm.transcribe_batch(pcms)
    assert got == [tm.transcribe_ids(p) for p in pcms]


def test_batch_inputs_pad_to_the_bucket_and_a_power_of_two(models):
    _, tm = models
    batch, lens = tm.batch_inputs(_pcms(3))
    assert batch.shape == (4, 16000) and lens.tolist() == [9000, 9700, 10400, 0]


def test_w8_batch_runs_kernel_2_per_layer_and_no_layer_kernel(monkeypatch):
    """At B > 1 the w8 model takes the per-layer path: every layer linear on
    the w8 GEMM at M = B·T rows, plus the CTC head; never the layer or stack
    kernel (they are batch-1 only, as the TPU's)."""
    cfg = dict(n_layers=2, d_model=256, n_heads=2, ffn_dim=384, vocab_size=40,
               weight_int8=True)
    jm = JModel(JConfig(**cfg))
    jm.init(1)
    params = sv.stack_layer_params(from_numpy_tree(_np_tree(jprepare_w8(jm.params))))
    rows = []

    def w8(x, *args):
        rows.append(x.shape[0])
        return sv.w8_matmul(x, *args)

    def refuse(*args):
        raise AssertionError("a batch-1 kernel ran at B > 1")

    monkeypatch.setattr(sv, "_KERNELS", dict(sv._KERNELS, w8=w8, layer=refuse, stack=refuse))
    tm = SenseVoiceModel(SenseVoiceConfig(**cfg), device="cpu")
    tm.params = params
    tm.transcribe_batch(_pcms(3))
    T = 4 + 17
    assert rows == [4 * T] * (4 * 2 + 1)


def test_quantized_batch_matches_jax_quantized_batch():
    """One DQL scale over the whole [B, T, D] activation, padding rows and
    batch neighbours included, as in JAX: compared with JAX's batch, not with
    single requests. Per-frame ids of the batch (a last-bit difference of the
    front-end can move a DQL code: the first run agreed on every frame)."""
    cfg = dict(n_layers=2, d_model=64, n_heads=2, ffn_dim=96, vocab_size=40,
               quantized=True)
    jm = JModel(JConfig(**cfg))
    jm.init(2)
    prepared = _np_tree(jprepare_q(jm.params))
    jm.params = prepared
    tm = SenseVoiceModel(SenseVoiceConfig(**cfg), device="cpu")
    tm.params = from_numpy_tree(prepared)
    batch, lens = tm.batch_inputs(_pcms(3, seed=4))
    want_ids, want_m = jm._batched_ids(batch, lens)
    got_ids, got_m = tm._batched_ids(batch, lens)
    np.testing.assert_array_equal(got_m, want_m)
    valid = got_m > 0
    assert (got_ids[valid] == want_ids[valid]).mean() >= 0.98


def test_transcribe_long_matches_jax(models):
    """JAX's test_bucketing.py window test: 7 s in windows of 3 s with 1 s of
    overlap (one batched program, margins dropped, seams not merged)."""
    jm, tm = models
    rng = np.random.default_rng(32)
    pcm = (rng.standard_normal(16000 * 7) * 0.1).astype(np.float32)
    got = tm.transcribe_long(pcm, window_s=3.0, overlap_s=1.0)
    assert len(got) > 0 and got == jm.transcribe_long(pcm, window_s=3.0, overlap_s=1.0)
    short = (rng.standard_normal(8000) * 0.1).astype(np.float32)
    assert tm.transcribe_long(short, window_s=3.0) == tm.transcribe_ids(short)


def test_transcribe_batch_sends_over_long_items_to_transcribe_long(models):
    jm, tm = models
    rng = np.random.default_rng(33)
    pcms = [(rng.standard_normal(16000 * 61) * 0.1).astype(np.float32),
            (rng.standard_normal(9000) * 0.1).astype(np.float32)]
    got = tm.transcribe_batch(pcms)
    assert got == [tm.transcribe_long(p) for p in pcms] == jm.transcribe_batch(pcms)


def _wav(pcm, sr=16000):
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((np.clip(pcm, -1, 1) * 32767).astype("<i2").tobytes())
    return buf.getvalue()


def test_recognize_batch_with_tokenizer_matches_jax(models):
    """WAV bytes (one at 8 kHz, resampled) → text through one batch."""
    jm, tm = models
    vocab = synthetic_vocab(40, seed=5)
    rng = np.random.default_rng(34)
    wavs = [_wav(rng.standard_normal(12000) * 0.1), _wav(rng.standard_normal(20000) * 0.1),
            _wav(rng.standard_normal(7000) * 0.1, sr=8000)]
    got = SenseVoiceEngine(model=tm, tokenizer=CtcTokenizer(vocab)).recognize_batch(wavs)
    want = JEngine(model=jm, tokenizer=JTokenizer(vocab)).recognize_batch(wavs)
    assert got == want and all(isinstance(t, str) for t in got)
    ids = SenseVoiceEngine(model=tm).recognize_batch(wavs)
    assert [CtcTokenizer(vocab).decode(i) for i in ids] == got
