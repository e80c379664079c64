"""The port's Supertonic TTS against the JAX package's: the text pipeline,
`conv_transpose1d`, each sub-model, the vocoder, `synthesize` on both of
JAX's bucket routes, the fused estimator route, the Supertonic 3 settings and
`TtsEngine`.

Weights are made by the JAX init and carried across with
`supertonic_params_from_jax`; inputs are numpy arrays from the seeds named
in each test. JAX's noise comes from `jax.random`, which torch cannot draw,
so the port takes it through the synth core's `noise` seam. The JAX side
runs on the CPU; its fused estimator route runs the Pallas kernel in
interpret mode. Tolerances:

- text pipeline, indexer ids, config, voice styles, frame counts: exact;
- `conv_transpose1d`, the sub-models and the unfused waveform: 1e-5 of the
  largest magnitude (both sides f32 on the CPU; only summation orders
  differ), except the duration predictor's f32 convs at 1e-5 absolute too;
- the vocoder against JAX's lane-packed vocoder: rtol 1e-4, atol 1e-5,
  the gate of tests/test_packed1d.py;
- the fused route (bf16 products) against JAX: correlation > 0.999, the gate
  of tests/test_est_block.py, and within 2e-3 of the largest magnitude
  (measured 2e-4: both sides round the same operands to bf16).
"""

import dataclasses
import io
import wave
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_text_parity import CASES

from lele_tpu.models import supertonic as jst
from lele_tpu.kernels import est_block as jest
from lele_tpu.kernels import quant_matmul as jqm
from lele_tpu_torch.models import common, supertonic as tst
from lele_tpu.serving import encode_wav as j_encode_wav
from lele_tpu.utils.wav import write_wav as j_write_wav
from lele_tpu_torch.serving import TtsEngine, encode_wav
from lele_tpu_torch.utils.wav import decode_wav_bytes, write_wav

REPO = Path(__file__).resolve().parent.parent
EXAMPLES = REPO / "examples"
F32_RTOL = 1e-5
FUSED_CORR = 0.999
FUSED_RTOL = 2e-3
# two sub-model layers each, d 64 with 2 heads (hd 32), latent buckets
# (32, 64): the port's and JAX's functions at a size the CPU runs in seconds
SMALL = dict(d_text=64, n_heads=2, n_text_layers=2, n_est_layers=2, ffn_mult=2,
             latent_buckets=(32, 64), token_buckets=(48, 96))
TEXT = "The quick brown fox jumps over the lazy dog."
LONG_TEXT = ("Speech synthesis turns text into sound. " * 5 + "It is chunked at sentence "
             "boundaries! Every character is spoken? Yes. " * 4)


def _close(got, want, rtol=F32_RTOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(np.abs(want).max(), 1e-30))


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _pair(seed=0, **kw):
    cfg = dict(SMALL, **kw)
    jm = jst.SupertonicTts(jst.SupertonicConfig(**cfg))
    jm.init(seed)
    tm = tst.SupertonicTts(tst.SupertonicConfig(**cfg), device="cpu",
                           params=tst.supertonic_params_from_jax(
                               jax.tree.map(np.asarray, jm.params), "cpu"))
    return jm, tm


@pytest.fixture(scope="module")
def models():
    return _pair()


def _style(seed=7, d=128):
    rng = np.random.default_rng(seed)
    return {"ttl": rng.standard_normal(d).astype(np.float32),
            "dp": rng.standard_normal(d).astype(np.float32)}


def _jax_noise(cfg, seed=0):
    """The noise JAX's synth core draws for `seed`, at the largest bucket."""
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed),
                                        (1, cfg.latent_buckets[-1], cfg.d_latent),
                                        jnp.float32))


# ---------------------------------------------------------------------------
# Text pipeline


@pytest.mark.parametrize("raw,body", CASES, ids=[f"case{i + 1:02d}" for i in range(len(CASES))])
def test_text_pipeline_bytes_match_jax(raw, body):
    for lang in ("en", "ko"):
        got = tst.normalize_text(raw, lang)
        assert got.encode() == jst.normalize_text(raw, lang).encode()
        assert tst.prepare_chunks(raw, lang) == jst.prepare_chunks(raw, lang)
    assert got == f"<ko>{body}</ko>"


def test_chunking_and_langs_match_jax():
    assert tst.AVAILABLE_LANGS == jst.AVAILABLE_LANGS
    for lang in ("en", "zh", "xx", ""):
        assert tst.is_valid_lang(lang) == jst.is_valid_lang(lang)
    with pytest.raises(ValueError, match="Invalid language"):
        tst.normalize_text("hi", "xx")
    for max_len in (40, 120, 300):
        assert tst.chunk_text(LONG_TEXT, max_len) == jst.chunk_text(LONG_TEXT, max_len)
        chunks = tst.prepare_chunks(LONG_TEXT, "en", max_len)
        assert chunks == jst.prepare_chunks(LONG_TEXT, "en", max_len)
    assert len(tst.prepare_chunks(LONG_TEXT)) > 1


@pytest.mark.parametrize("indexer", ["json", "default"])
def test_indexer_ids_match_jax(indexer):
    if indexer == "json":
        path = EXAMPLES / "supertonic" / "unicode_indexer.json"
        ti, ji = tst.UnicodeIndexer.from_json(path), jst.UnicodeIndexer.from_json(path)
    else:
        ti, ji = tst.UnicodeIndexer(vocab_size=300), jst.UnicodeIndexer(vocab_size=300)
    for raw, _ in CASES + [(LONG_TEXT, None), ("héllo 世界 ☃ ok", None)]:
        for chunk in tst.prepare_chunks(raw):
            got, want = ti(chunk), ji(chunk)
            assert got.dtype == np.int64
            np.testing.assert_array_equal(got, want)


def test_config_and_voice_styles_match_jax():
    path = EXAMPLES / "supertonic" / "tts.json"
    got = dataclasses.asdict(tst.SupertonicConfig.from_json(path))
    want = dataclasses.asdict(jst.SupertonicConfig.from_json(path))
    # every field, the fused-duration route's bucket guess included
    assert set(want) == set(got)
    assert got == want
    assert tst.SupertonicConfig(dtype="bfloat16").compute_dtype == torch.bfloat16
    assert tst.SupertonicConfig().compute_dtype == torch.float32
    styles = sorted((EXAMPLES / "supertonic").glob("voice_styles/*.json"))
    styles += sorted((EXAMPLES / "supertonic3").glob("voice_styles/*.json"))
    assert len(styles) == 20
    for p in styles:
        got, want = tst.load_voice_style(p), jst.load_voice_style(p)
        assert got.keys() == want.keys() == {"ttl", "dp"}
        for k in got:
            assert got[k].dtype == np.float32 and got[k].shape == (128,)
            np.testing.assert_array_equal(got[k], want[k])


# ---------------------------------------------------------------------------
# Layers and sub-models


@pytest.mark.parametrize("k,stride,T,cin,cout", [
    (8, 4, 13, 64, 128),  # the vocoder's levels
    (8, 4, 1, 16, 8),
    (3, 4, 7, 5, 6),      # stride > k - 1: lax pads (k - 1, stride - 1)
    (5, 2, 9, 4, 3),      # odd total pad
    (4, 4, 6, 3, 2),
])
def test_conv_transpose1d_matches_lax(k, stride, T, cin, cout):
    rng = np.random.default_rng(k * 100 + T)
    x = rng.standard_normal((2, T, cin)).astype(np.float32)
    w = rng.standard_normal((k, cin, cout)).astype(np.float32)
    want = jax.lax.conv_transpose(jnp.asarray(x), jnp.asarray(w), strides=(stride,),
                                  padding="SAME", dimension_numbers=("NHC", "HIO", "NHC"))
    got = common.conv_transpose1d(_t(x), _t(w), stride)
    assert got.shape == (2, T * stride, cout)
    _close(got, want)


def test_port_init_draws_jax_shapes(models):
    """The port's own init makes the tree JAX's makes (without the TPU-only
    packed vocoder), with the blocks also stacked for kernel 10."""
    jm, _ = models
    tm = tst.SupertonicTts(tst.SupertonicConfig(**SMALL), device="cpu")
    tm.init(3)
    jtree = jax.tree.map(np.asarray, jm.params)
    jtree["vocoder"].pop("packed")
    est = dict(tm.params["estimator"])
    stacked = est.pop("blocks_stacked")
    got = jax.tree.map(lambda t: tuple(t.shape), dict(tm.params, estimator=est))
    assert got == jax.tree.map(lambda a: a.shape, jtree)
    assert stacked["q"]["w"].shape == (2 * SMALL["n_est_layers"], 64, 64)
    assert stacked["q"]["w"].dtype == torch.bfloat16
    assert stacked["norm1"]["g"].dtype == torch.float32


def test_text_encoder_matches_jax(models):
    jm, tm = models
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 512, (2, 48))
    mask = np.ones((2, 48), np.float32)
    mask[1, 30:] = 0.0
    style = rng.standard_normal((2, 128)).astype(np.float32)
    want = jst.text_encoder_forward(jm.params["text"], jnp.asarray(ids), jnp.asarray(style),
                                    jnp.asarray(mask), jm.cfg)
    got = tst.text_encoder_forward(tm.params["text"], _t(ids, torch.int64), _t(style),
                                   _t(mask), tm.cfg)
    _close(got, want)


def test_duration_predictor_matches_jax_and_is_mask_exact(models):
    jm, tm = models
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 512, (1, 48))
    mask = np.zeros((1, 48), np.float32)
    mask[:, :29] = 1.0
    style = rng.standard_normal((1, 128)).astype(np.float32)
    want = jst.duration_predictor_forward(jm.params["duration"], jnp.asarray(ids),
                                          jnp.asarray(style), jnp.asarray(mask), jm.cfg)
    got = tst.duration_predictor_forward(tm.params["duration"], _t(ids, torch.int64),
                                         _t(style), _t(mask), tm.cfg)
    _close(got, want)
    short = tst.duration_predictor_forward(tm.params["duration"], _t(ids[:, :29], torch.int64),
                                           _t(style), _t(mask[:, :29]), tm.cfg)
    np.testing.assert_allclose(got[:, :29].numpy(), short.numpy(), rtol=1e-6, atol=1e-6)
    assert (got[:, 29:] == 0).all()


@pytest.mark.parametrize("t_step", [0.0, 0.6])
def test_vector_estimator_matches_jax(models, t_step):
    jm, tm = models
    rng = np.random.default_rng(3)
    T, Tk = 64, 48
    xt = rng.standard_normal((1, T, 64)).astype(np.float32)
    text = rng.standard_normal((1, Tk, 64)).astype(np.float32)
    style = rng.standard_normal((1, 128)).astype(np.float32)
    lm = np.zeros((1, T), np.float32)
    lm[:, :41] = 1.0
    tm_ = np.zeros((1, Tk), np.float32)
    tm_[:, :30] = 1.0
    want = jst.vector_estimator_forward(jm.params["estimator"], jnp.asarray(xt),
                                        jnp.asarray(text), jnp.asarray(style), jnp.asarray(lm),
                                        jnp.asarray(tm_), jnp.float32(t_step), jm.cfg)
    got = tst.vector_estimator_forward(tm.params["estimator"], _t(xt), _t(text), _t(style),
                                       _t(lm), _t(tm_), torch.tensor(t_step), tm.cfg)
    _close(got, want)


@pytest.mark.parametrize("T", [3, 32])
def test_vocoder_matches_jax_packed_vocoder(models, T):
    jm, tm = models
    assert "packed" in jm.params["vocoder"]
    latent = np.random.default_rng(4).standard_normal((1, T, 64)).astype(np.float32)
    want = jst.vocoder_forward(jm.params["vocoder"], jnp.asarray(latent), jm.cfg)
    got = tst.vocoder_forward(tm.params["vocoder"], _t(latent), tm.cfg)
    assert got.shape == (1, T * 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# The whole synth


def _jax_synth(jm, text, style, seed, fused_duration):
    return np.asarray(jm.synthesize(text, style, seed=seed, fused_duration=fused_duration))


@pytest.mark.parametrize("fused_duration", [True, False], ids=["e2e", "two_dispatch"])
def test_synthesize_matches_jax(models, fused_duration):
    jm, tm = models
    style = _style()
    for text, seed in ((TEXT, 0), ("Hi.", 5)):
        want = _jax_synth(jm, text, style, seed, fused_duration)
        got = tm.synthesize(text, style, seed=seed, noise=_t(_jax_noise(jm.cfg, seed)))
        assert got.shape == want.shape and len(got) % 256 == 0
        _close(got, want)


def test_synthesize_frames_and_chunks(models):
    """Frame counts follow the host formula max(8, floor(sum(dur)/speed)),
    chunk by chunk; the same seed gives the same audio."""
    jm, tm = models
    style = _style(11)
    chunks = tst.prepare_chunks(LONG_TEXT)
    frames = 0
    for c in chunks:
        ids, mask = tm.pad_tokens(tm.indexer(c)[None])
        dur = tst.duration_predictor_forward(tm.params["duration"], _t(ids, torch.int64),
                                             _t(style["dp"])[None], _t(mask), tm.cfg).numpy()
        jdur = np.asarray(jst.duration_predictor_forward(
            jm.params["duration"], jnp.asarray(ids), jnp.asarray(style["dp"])[None],
            jnp.asarray(mask), jm.cfg))
        t = max(8, int(dur.sum()))
        assert t == max(8, int(jdur.sum()))
        frames += min(t, tm._bucket(t))
    a = tm.synthesize(LONG_TEXT, style, seed=3)
    assert a.shape == (frames * 256,) and np.isfinite(a).all() and np.abs(a).max() <= 1.0
    np.testing.assert_array_equal(a, tm.synthesize(LONG_TEXT, style, seed=3))


@pytest.fixture
def jax_fused_estimator(monkeypatch):
    """JAX's TPU route for the estimator on the CPU: `_on_tpu` True and the
    Pallas kernel in interpret mode."""
    monkeypatch.setattr(jqm, "_on_tpu", lambda: True)
    real = jest.estimator_blocks_pallas
    monkeypatch.setattr(jest, "estimator_blocks_pallas",
                        lambda *a, **k: real(*a, **dict(k, interpret=True)))


def test_fused_route_matches_jax(jax_fused_estimator):
    jm, tm = _pair(fused_estimator=True)
    style = _style(13)
    noise = _t(_jax_noise(jm.cfg))
    want = _jax_synth(jm, TEXT, style, 0, True)
    got = tm.synthesize(TEXT, style, seed=0, noise=noise)
    assert got.shape == want.shape
    assert np.corrcoef(got, want)[0, 1] > FUSED_CORR
    _close(got, want, FUSED_RTOL)
    # and against the unfused f32 route (the estimator's oracle)
    unfused = dataclasses.replace(tm, cfg=dataclasses.replace(tm.cfg, fused_estimator=False))
    ref = unfused.synthesize(TEXT, style, seed=0, noise=noise)
    assert np.corrcoef(got, ref)[0, 1] > FUSED_CORR


def test_fused_route_calls_the_wrapper_once_a_step(monkeypatch):
    tm = tst.SupertonicTts(tst.SupertonicConfig(**SMALL, fused_estimator=True), device="cpu")
    tm.init(0)
    calls = []
    real = tst.estimator_blocks

    def spy(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)

    monkeypatch.setattr(tst, "estimator_blocks", spy)
    tm.synthesize(TEXT, _style(), seed=0)
    assert len(calls) == tm.cfg.flow_steps * len(tst.prepare_chunks(TEXT))
    assert all(s[1] == 64 for s in calls)


def test_supertonic3_settings_match_jax():
    """Supertonic 3: no latent mask/denorm block, speed 1.05, a v3 voice."""
    jm, tm = _pair(seed=1, apply_latent_denorm=False, speed=1.05, normalizer_scale=0.5)
    style = jst.load_voice_style(EXAMPLES / "supertonic3" / "voice_styles" / "M2.json")
    for fused_duration in (True, False):
        want = _jax_synth(jm, TEXT, style, 2, fused_duration)
        got = tm.synthesize(TEXT, style, seed=2, noise=_t(_jax_noise(jm.cfg, 2)))
        assert got.shape == want.shape
        _close(got, want)


def test_tts_engine_returns_wav_bytes(models):
    _, tm = models
    eng = TtsEngine(tts=tm)
    eng.load_style(str(EXAMPLES / "supertonic" / "voice_styles" / "F1.json"), name="F1")
    data = eng.synthesize(TEXT, voice="F1", seed=1)
    with wave.open(io.BytesIO(data)) as w:
        assert (w.getframerate(), w.getnchannels(), w.getsampwidth()) == (24000, 1, 2)
    pcm, sr = decode_wav_bytes(data)
    want = tm.synthesize(TEXT, eng.styles["F1"], seed=1)
    assert sr == 24000 and pcm.shape == want.shape
    np.testing.assert_allclose(pcm, want, atol=1.0 / 32767 + 1e-6)
    # no style loaded: JAX's fixed fallback style
    assert len(TtsEngine(tts=tm).synthesize("Ok.")) > 44


def test_wav_writer_bytes_match_jax(tmp_path):
    x = np.random.default_rng(5).standard_normal(1001).astype(np.float32) * 0.7  # clips
    write_wav(tmp_path / "port.wav", x, 24000)
    j_write_wav(tmp_path / "jax.wav", x, 24000)
    assert (tmp_path / "port.wav").read_bytes() == (tmp_path / "jax.wav").read_bytes()
    assert encode_wav(x, 16000) == j_encode_wav(x, 16000)


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tst.SupertonicTts(tst.SupertonicConfig(**SMALL))
    with pytest.raises(RuntimeError, match="CUDA"):
        TtsEngine()
