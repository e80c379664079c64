"""The port's native Silero VAD against the JAX package's: kernel 6's plain
version, conv1d, lstm_cell, the front-end, the streaming step, the offline
probabilities and the segments.

Weights are made by the JAX init and carried across with
lele_tpu_torch.params; inputs are numpy arrays from seeds. The JAX side runs
on the CPU, its Pallas LSTM kernel in interpret mode. Tolerances:

- kernel 6: atol 1e-5, the bound tests/test_pallas_parity.py uses for it
  (both sides f32; only the summation order of h @ Wh differs);
- conv1d, lstm_cell, features, step, probabilities: 1e-5 of the largest
  magnitude (JAX on the CPU computes its convs, FFT and products in f32, as
  the port does);
- frame_chunks, the weight tree and the segment lists: exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lele_tpu.kernels.lstm import lstm_seq_pallas, lstm_seq_reference
from lele_tpu.models import common as jcommon
from lele_tpu.models import silero as jsilero
from lele_tpu_torch import kernels as K
from lele_tpu_torch.models import common, silero
from lele_tpu_torch.params import from_numpy_tree

LSTM_ATOL = 1e-5
F32_RTOL = 1e-5
SEG_CONFIGS = {  # tests/test_models.py:142-153, and the defaults
    "hysteresis": dict(threshold=0.5, neg_threshold=0.45, min_speech_ms=100.0,
                       min_silence_ms=100.0),
    "flush": dict(threshold=0.0, neg_threshold=-1.0, min_speech_ms=100.0),
    "defaults": {},
}


def _close(got, want, rtol=F32_RTOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(np.abs(want).max(), 1e-30))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def models():
    """The full-width VAD (d_hidden 128, convs 128/64/64/128), JAX and port
    on the same weights."""
    jv = jsilero.SileroVad(jsilero.SileroConfig())
    jv.init(0)
    tv = silero.SileroVad(silero.SileroConfig(), params=from_numpy_tree(_np_tree(jv.params)),
                          device="cpu")
    return jv, tv


def _speechlike(seconds, sr, seed):
    rng = np.random.default_rng(seed)
    n = int(seconds * sr)
    t = np.arange(n) / sr
    env = 0.5 + 0.5 * np.sin(2 * np.pi * 1.3 * t)
    pcm = 0.3 * env * np.sin(2 * np.pi * 180 * t) + 0.02 * rng.standard_normal(n)
    pcm[n // 3: n // 2] *= 8  # a loud stretch
    return pcm.astype(np.float32)


# -- kernel 6 -----------------------------------------------------------------


# the last three: SileroOnnx's chunk (S = 3) at B = 2, and the widths on
# either side of the card's register form's unit pairs (96, 128)
@pytest.mark.parametrize("S,B,H", [(23, 1, 32), (9, 3, 16), (40, 1, 128), (3, 2, 128),
                                   (3, 2, 96), (17, 1, 96)])
def test_lstm_seq_plain_matches_pallas_and_reference(S, B, H):
    rng = np.random.default_rng(S * 100 + B * 10 + H)
    xproj = rng.standard_normal((S, B, 4 * H)).astype(np.float32)
    wh = (rng.standard_normal((H, 4 * H)) / np.sqrt(H)).astype(np.float32)
    h0 = (rng.standard_normal((B, H)) * 0.5).astype(np.float32)
    c0 = (rng.standard_normal((B, H)) * 0.5).astype(np.float32)
    args = [jnp.asarray(a) for a in (xproj, wh, h0, c0)]
    got = K.lstm_seq_plain(*(torch.from_numpy(a) for a in (xproj, wh, h0, c0)))
    for want in (lstm_seq_pallas(*args, interpret=True), lstm_seq_reference(*args)):
        for g, w in zip(got, want):
            assert g.shape == w.shape
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=LSTM_ATOL)


def test_lstm_seq_takes_plain_on_cpu_and_counts_no_launch():
    rng = np.random.default_rng(3)
    args = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in ((5, 2, 64), (16, 64), (2, 16), (2, 16))]
    K.reset_launch_counts()
    for g, w in zip(K.lstm_seq(*args), K.lstm_seq_plain(*args)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert K.launch_counts()["lstm_seq"] == 0
    with pytest.raises(ValueError, match="lstm_seq"):
        K.lstm_seq(args[0], args[1][:, :32], args[2], args[3])


def test_lstm_seq_kernel_refuses_a_cpu_tensor_and_states_its_range():
    from lele_tpu_torch.kernels import lstm

    x = torch.zeros((3, 1, 16))
    with pytest.raises(ValueError, match="CUDA"):
        lstm.lstm_seq_kernel(x, torch.zeros((4, 16)), torch.zeros((1, 4)), torch.zeros((1, 4)))
    # one block up to H = 128, a cluster of 8 blocks up to 1024
    assert lstm.kernel_takes(1) and lstm.kernel_takes(128) and lstm.kernel_takes(129)
    assert lstm.kernel_takes(1024)
    assert not lstm.kernel_takes(0) and not lstm.kernel_takes(1025)


# -- models/common ------------------------------------------------------------


@pytest.mark.parametrize("padding", ["SAME", "VALID"])
@pytest.mark.parametrize("T", [6, 7])
@pytest.mark.parametrize("stride", [1, 2])
def test_conv1d_matches_jax(stride, T, padding):
    rng = np.random.default_rng(stride * 10 + T)
    p = {"w": (rng.standard_normal((12, 9, 3)) * 0.3).astype(np.float32),
         "b": rng.standard_normal(12).astype(np.float32)}
    x = rng.standard_normal((2, T, 9)).astype(np.float32)
    want = jcommon.conv1d(jax.tree.map(jnp.asarray, p), jnp.asarray(x), stride=stride,
                          padding=padding)
    got = common.conv1d(from_numpy_tree(p), torch.from_numpy(x), stride=stride,
                        padding=padding)
    _close(got, want)


@pytest.mark.parametrize("t,stride,pads", [(6, 1, (1, 1)), (6, 2, (0, 1)), (3, 2, (1, 1)),
                                           (2, 2, (0, 1)), (15, 2, (1, 1))])
def test_same_pads_are_xla_split_at_silero_shapes(t, stride, pads):
    """The asymmetric SAME split of the VAD's convs at 16 kHz (6 → 3 → 2 → 1
    frames) and 8 kHz (15 → 8): JAX's output lengths, and the pads."""
    assert common.same_pads(t, 3, stride) == pads
    x = jnp.zeros((1, t, 1))
    y = jcommon.conv1d({"w": jnp.ones((1, 1, 3)), "b": jnp.zeros(1)}, x, stride=stride)
    assert y.shape[1] == -(-t // stride) == (t + sum(pads) - 3) // stride + 1


def test_lstm_cell_matches_jax():
    rng = np.random.default_rng(5)
    jp = jcommon.init_lstm_cell(jax.random.PRNGKey(1), 24, 32)
    jp = {**jp, "b": jnp.asarray(rng.standard_normal(128).astype(np.float32) * 0.1)}
    x, h, c = (rng.standard_normal((3, n)).astype(np.float32) for n in (24, 32, 32))
    want = jcommon.lstm_cell(jp, *(jnp.asarray(a) for a in (x, h, c)))
    got = common.lstm_cell(from_numpy_tree(_np_tree(jp)),
                           *(torch.from_numpy(a) for a in (x, h, c)))
    for g, w in zip(got, want):
        _close(g, w)


def test_init_shapes_match_jax():
    gen = torch.Generator().manual_seed(0)
    for make, jmake, args in (
            (common.init_conv1d, jcommon.init_conv1d, (129, 128, 3)),
            (common.init_lstm_cell, jcommon.init_lstm_cell, (128, 128))):
        got, want = make(gen, *args), jmake(jax.random.PRNGKey(0), *args)
        assert {k: tuple(v.shape) for k, v in got.items()} == \
            {k: tuple(v.shape) for k, v in want.items()}
        bound = 1.0 / np.sqrt(args[0] * (args[2] if len(args) > 2 else 1))
        w = got["w"] if "w" in got else got["wx"]
        assert float(w.abs().max()) <= bound and float(got["b"].abs().max()) == 0.0
    cfg = silero.SileroConfig()
    got = silero.init_silero(gen, cfg)
    want = jsilero.init_silero(jax.random.PRNGKey(0), jsilero.SileroConfig())
    assert jax.tree.structure(jax.tree.map(lambda a: 0, _np_tree(want))) == \
        jax.tree.structure(jax.tree.map(lambda a: 0, {k: v for k, v in got.items()}))


def test_init_silero_tree_carries_across_bit_for_bit():
    """params.from_numpy_tree maps init_silero's nested dicts and list
    (convs[i].{w,b}, lstm.{wx,wh,b}, head.{w,b}) with no second converter."""
    want = _np_tree(jsilero.init_silero(jax.random.PRNGKey(7), jsilero.SileroConfig()))
    got = from_numpy_tree(want)
    flat_w, tree_w = jax.tree.flatten(want)
    flat_g, tree_g = jax.tree.flatten(jax.tree.map(lambda t: t.numpy(), got))
    assert tree_w == tree_g and len(flat_w) == 4 * 2 + 3 + 2
    for g, w in zip(flat_g, flat_w):
        assert g.dtype == w.dtype and g.shape == w.shape and g.tobytes() == w.tobytes()


# -- models/silero ------------------------------------------------------------


@pytest.mark.parametrize("n", [0, 511, 512, 513, 3 * 16000])
def test_frame_chunks_match_jax_bit_for_bit(models, n):
    jv, tv = models
    pcm = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    got, want = tv.frame_chunks(pcm), jv.frame_chunks(pcm)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("sr", [16000, 8000])
def test_features_and_step_match_jax(models, sr):
    jv, tv = models
    chunks = tv.frame_chunks(_speechlike(0.2, 16000, 1))[:4]  # [4, 576]
    want = jsilero.silero_features(jv.params, jnp.asarray(chunks), jv.cfg, sr)
    got = silero.silero_features(tv.params, torch.from_numpy(chunks), tv.cfg, sr)
    _close(got, want)
    jstep, tstep = jv.step_fn(sr), tv.step_fn(sr)
    jstate = jsilero.zero_state(jv.cfg)
    tstate = silero.zero_state(tv.cfg, device="cpu")
    for i in range(3):  # the state carried across streaming steps
        chunk = chunks[i:i + 1]
        jp, jstate = jstep(jv.params, jnp.asarray(chunk), jstate)
        tp, tstate = tstep(tv.params, torch.from_numpy(chunk), tstate)
        _close(tp, jp)
        _close(tstate, jstate)


@pytest.mark.parametrize("sr", [16000, 8000])
def test_speech_probs_match_jax(models, sr):
    jv, tv = models
    pcm = _speechlike(3.0, sr, 2)
    want = jv.speech_probs(pcm, sr)
    got = tv.speech_probs(pcm, sr)
    assert got.dtype == np.float32 and got.shape == want.shape == (len(pcm) // 512,)
    _close(got, want)
    np.testing.assert_array_equal(tv.speech_probs(pcm, sr, plain=True), got)
    assert tv.speech_probs(pcm[:100], sr).shape == (0,)


def test_offline_scan_launches_the_sequence_once_and_matches_the_steps(models, monkeypatch):
    """speech_probs runs one lstm_seq call for the whole waveform, and agrees
    with the streaming step carried chunk by chunk."""
    _, tv = models
    pcm = _speechlike(1.0, 16000, 3)
    calls = []
    seq = silero.lstm_seq
    monkeypatch.setattr(silero, "lstm_seq", lambda *a: calls.append(a[0].shape) or seq(*a))
    probs = tv.speech_probs(pcm)
    assert calls == [(len(pcm) // 512, 1, 4 * 128)]
    step, state = tv.step_fn(), silero.zero_state(tv.cfg, device="cpu")
    chunks = torch.from_numpy(tv.frame_chunks(pcm))
    for i, want in enumerate(probs):
        p, state = step(tv.params, chunks[i:i + 1], state)
        assert abs(float(p) - float(want)) <= F32_RTOL


@pytest.mark.parametrize("cfg", list(SEG_CONFIGS))
def test_segments_match_jax_exactly(models, cfg):
    jv, tv = models
    rng = np.random.default_rng(9)
    pcm = (rng.standard_normal(16000 * 3) * 0.05).astype(np.float32)
    pcm[16000:32000] *= 20  # a loud middle second
    kw = SEG_CONFIGS[cfg]
    want = jv.segments(pcm, jsilero.VadSegmentConfig(**kw))
    got = tv.segments(pcm, silero.VadSegmentConfig(**kw))
    assert got == want
    assert got == silero.collect_segments(tv.speech_probs(pcm), silero.VadSegmentConfig(**kw))


def _jax_automaton(probs, seg_cfg):
    """The JAX package's device automaton on given probabilities: its scan
    program with the probabilities in place of the model's."""
    jv = jsilero.SileroVad(jsilero.SileroConfig())
    jv.scan_fn = lambda n, sr: (lambda params, chunks: (jnp.asarray(probs), None))
    segs, count, _ = jv.segments_fn(len(probs), seg_cfg)(None, None)
    return jsilero._pad_and_merge(np.asarray(segs)[: int(count)], seg_cfg)


@pytest.mark.parametrize("seed,kw", [
    (0, dict(min_speech_ms=64.0, min_silence_ms=64.0, merge_ms=0.0, pad_ms=0.0)),
    (1, dict(min_speech_ms=96.0, min_silence_ms=32.0, merge_ms=0.0, pad_ms=16.0)),
    (2, dict(threshold=0.6, neg_threshold=0.4)),
    (3, dict(min_speech_ms=0.0, min_silence_ms=0.0, merge_ms=0.0, pad_ms=0.0)),
], ids=["two_chunk_boundaries", "one_chunk_silence", "hysteresis", "past_64_segments"])
def test_host_automaton_is_the_jax_device_automaton(seed, kw):
    """Durations that land on multiples of the 32 ms chunk put f32 rounding
    on the >= comparisons; the last case opens more than the 64 raw segments
    JAX keeps."""
    rng = np.random.default_rng(seed)
    probs = np.repeat(rng.random(120), rng.integers(1, 5, 120))[:400].astype(np.float32)
    if seed == 3:
        probs = np.tile(np.float32([0.9, 0.0]), 200)
    seg_cfg = jsilero.VadSegmentConfig(**kw)
    want = _jax_automaton(probs, seg_cfg)
    cfg = silero.VadSegmentConfig(**kw)
    got = silero._pad_and_merge(silero._segments_f32(probs, cfg), cfg)
    assert got == want and len(want) == (silero.MAX_SEGMENTS if seed == 3 else len(want)) > 0


@pytest.mark.parametrize("case", ["one_segment", "too_short", "merged"])
def test_collect_segments_matches_jax(case):
    """The hand-made probabilities of tests/test_models.py:111-129."""
    probs = np.zeros(300, np.float32)
    if case == "one_segment":
        probs[50:100] = 0.9
    elif case == "too_short":
        probs[10:15] = 0.9
    else:
        probs[50:80] = 0.9
        probs[88:120] = 0.9
    want = jsilero.collect_segments(probs, jsilero.VadSegmentConfig())
    assert silero.collect_segments(probs, silero.VadSegmentConfig()) == want
    assert len(want) == (0 if case == "too_short" else 1)


def test_segment_config_and_model_config_match_jax():
    assert dataclasses.asdict(silero.VadSegmentConfig()) == \
        dataclasses.asdict(jsilero.VadSegmentConfig())
    j = dataclasses.asdict(jsilero.SileroConfig())
    assert dataclasses.asdict(silero.SileroConfig()) == \
        {k: v for k, v in j.items() if k not in ("dtype", "use_pallas_lstm")}


def test_silero_entry_points_raise_without_a_card(monkeypatch):
    from pathlib import Path

    from lele_tpu_torch.models import SileroOnnx

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fixture = Path(__file__).resolve().parent.parent / "fixtures" / "silero.onnx"
    for make in (lambda: silero.SileroVad(), lambda: SileroOnnx(fixture)):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            make()
    silero.SileroVad(device="cpu")
    SileroOnnx(fixture, device="cpu")
