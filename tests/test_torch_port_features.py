"""The port's audio front-end (lele_tpu_torch.features) against lele_tpu.features.

The same PCM, made with numpy from a seed, goes through both. Framing and
LFR stacking are copies and gathers, so they must agree exactly; CMVN and
the fbank pipeline (rFFT, mel matmul, log) differ in float32 summation order
only, so features are held to atol 1e-3 after CMVN; masks must be exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lele_tpu.features import FbankConfig as JFbankConfig
from lele_tpu.features import FbankFrontend as JFbankFrontend
from lele_tpu.features import cmvn as jcmvn
from lele_tpu.features import fbank_features as jfbank_features
from lele_tpu.features import lfr_stack as jlfr_stack
from lele_tpu.features.framing import frame_signal as jframe_signal
from lele_tpu.runtime.bucketing import pad_pcm
from lele_tpu_torch.features import (
    FbankFrontend,
    cmvn,
    fbank_features,
    frame_signal,
    lfr_stack,
)

FEAT_ATOL = 1e-3
# < frame_len (empty), exactly one frame, ragged, and a bucket-padded buffer
LENGTHS = {"empty": 300, "exact": 400, "ragged": 16000 + 77, "bucket": 20800}


def _pcm(n, seed=0):
    """Non-stationary audio: a chirp and noise under a loudness envelope that
    swings by ~40 dB, so every mel bin varies over time as in speech (a
    stationary tone leaves CMVN dividing by a near-zero std)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    env = 10.0 ** (-2.0 * (0.5 + 0.5 * np.sin(2 * np.pi * 3.0 * t)))
    sig = np.sin(2 * np.pi * (150 + 2000 * t) * t) + 0.5 * rng.standard_normal(n)
    return (0.3 * env * sig).astype(np.float32)


@pytest.mark.parametrize("n", list(LENGTHS.values()), ids=list(LENGTHS))
@pytest.mark.parametrize("dtype", [np.float32, np.int16])
def test_frame_signal_matches_jax(n, dtype):
    pcm = _pcm(n)
    if dtype == np.int16:
        pcm = (pcm * 32767).astype(np.int16)
    want = np.asarray(jframe_signal(jnp.asarray(pcm), 400, 160))
    got = frame_signal(torch.from_numpy(pcm), 400, 160).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("t", [0, 1, 6, 37, 100])
@pytest.mark.parametrize("n_valid", [None, 0, 5, 30])
def test_lfr_stack_matches_jax(t, n_valid):
    x = np.random.default_rng(t).standard_normal((t, 80)).astype(np.float32)
    if n_valid is not None and n_valid > t:
        n_valid = t
    want = np.asarray(jlfr_stack(jnp.asarray(x), 7, 6, n_valid=n_valid))
    got = lfr_stack(torch.from_numpy(x), 7, 6, n_valid=n_valid).numpy()
    np.testing.assert_array_equal(got, want)


def test_cmvn_matches_jax():
    x = np.random.default_rng(1).standard_normal((57, 560)).astype(np.float32) * 3 + 1
    want = np.asarray(jcmvn(jnp.asarray(x)))
    got = cmvn(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("n", list(LENGTHS.values()), ids=list(LENGTHS))
@pytest.mark.parametrize("int16", [False, True])
def test_fbank_features_match_jax(n, int16):
    pcm = _pcm(n, seed=n)
    if int16:
        pcm = (pcm * 32767).astype(np.int16)
    jf = JFbankFrontend(JFbankConfig())
    want = np.asarray(jfbank_features(jnp.asarray(pcm), jf.config, jf.window, jf.mel_t))
    tf = FbankFrontend(device="cpu")
    got = tf(pcm).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=FEAT_ATOL)


@pytest.mark.parametrize("n", [300, 400, 16000 + 77, 12000, 32000], ids=
                         ["below_one_frame", "exact", "ragged", "mid", "full"])
def test_fbank_features_masked_match_jax(n):
    """The bucketing path: padded PCM with n_valid gives (features, mask)."""
    padded, n_valid = pad_pcm(_pcm(n, seed=n + 1))
    jf = JFbankFrontend(JFbankConfig())
    want_f, want_m = jfbank_features(jnp.asarray(padded), jf.config, jf.window,
                                     jf.mel_t, n_valid=jnp.int32(n_valid))
    tf = FbankFrontend(device="cpu")
    got_f, got_m = fbank_features(padded, tf.config, tf.window, tf.mel_t, n_valid=n_valid)
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    assert got_f.shape == tuple(want_f.shape)
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), atol=FEAT_ATOL)


def test_short_pcm_gives_empty_features_and_mask():
    tf = FbankFrontend(device="cpu")
    f, m = fbank_features(np.zeros(100, np.float32), tf.config, tf.window, tf.mel_t,
                          n_valid=100)
    assert tuple(f.shape) == (0, 560) and tuple(m.shape) == (0,)
