"""The port's streaming SenseVoice (models/sensevoice_stream.py) against
lele_tpu's, at small sizes: the same f32 weights (made by the JAX package,
carried over with `from_numpy_tree`) and the same features, made with numpy
from seeds."""

from dataclasses import replace

import jax
import numpy as np
import pytest
import torch

from lele_tpu.models import SenseVoiceConfig as JConfig
from lele_tpu.models import SenseVoiceModel as JModel
from lele_tpu.models.sensevoice_stream import StreamConfig as JStreamConfig
from lele_tpu.models.sensevoice_stream import StreamingSenseVoice as JStreaming
from lele_tpu.models.sensevoice_stream import init_stream_state as jinit_state
from lele_tpu.models.sensevoice_stream import stream_step as jstream_step
from lele_tpu_torch.models import (
    SenseVoiceConfig,
    StreamConfig,
    StreamingSenseVoice,
    init_stream_state,
    sensevoice_encode,
    stream_step,
)
from lele_tpu_torch.params import from_numpy_tree

TINY = dict(n_layers=2, d_model=32, ffn_dim=64, vocab_size=40, n_heads=2, dtype="float32")
# f32 on both sides, only summation orders differ; the caches hold layer
# inputs that pass through up to two layers (the first run read <= 3.5e-7)
REL = 1e-4


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def weights():
    m = JModel(JConfig(**TINY))
    m.init(0)
    return m, _np_tree(m.params)


def _rel(got, want):
    return np.abs(np.asarray(got) - np.asarray(want)).max() / max(
        np.abs(np.asarray(want)).max(), 1e-30)


def test_stream_step_logits_and_state_match_jax_over_three_chunks(weights):
    """Three chunks of 8 frames (the last one half valid) with a 12-frame
    context: logits, every cache and the position after each step."""
    jm, params = weights
    jcfg, cfg = jm.cfg, SenseVoiceConfig(**TINY)
    s = dict(chunk_frames=8, context_frames=12)
    jstate = jinit_state(jcfg, JStreamConfig(**s))
    state = init_stream_state(cfg, StreamConfig(**s), device="cpu")
    tp = from_numpy_tree(params)
    rng = np.random.default_rng(14)
    for step in range(3):
        feats = rng.standard_normal((1, 8, 560)).astype(np.float32)
        mask = np.ones((1, 8), np.float32)
        if step == 2:
            mask[0, 4:] = 0.0
        jl, jstate = jstream_step(params, feats, mask, jstate, jcfg)
        tl, state = stream_step(tp, torch.from_numpy(feats), torch.from_numpy(mask), state,
                                cfg)
        assert tl.shape == (1, 8, 40) and _rel(tl, jl) <= REL, (step, _rel(tl, jl))
        assert int(state["pos"]) == int(jstate["pos"]) == 8 * (step + 1) - (4 if step == 2
                                                                            else 0)
        assert state["pos"].dtype == torch.int32
        for tc, jc in zip(state["layers"], jstate["layers"]):
            for key in ("ctx", "ctx_mask", "fsmn_tail"):
                assert tuple(tc[key].shape) == jc[key].shape
                np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                           rtol=0, atol=REL * np.abs(np.asarray(jc[key])).max())


def test_stream_step_leaves_its_input_state_untouched(weights):
    """The port returns new state tensors where JAX donates its buffers."""
    _, params = weights
    cfg = SenseVoiceConfig(**TINY)
    state = init_stream_state(cfg, StreamConfig(chunk_frames=6, context_frames=12), device="cpu")
    before = {k: v.clone() for k, v in state["layers"][0].items()}
    feats = torch.from_numpy(np.random.default_rng(15).standard_normal((1, 6, 560))
                             .astype(np.float32))
    _, new = stream_step(from_numpy_tree(params), feats, torch.ones((1, 6)), state, cfg)
    for k, v in before.items():
        torch.testing.assert_close(state["layers"][0][k], v, rtol=0, atol=0)
    assert int(state["pos"]) == 0 and int(new["pos"]) == 6


def test_transcribe_stream_ids_equal_jax(weights):
    jm, params = weights
    rng = np.random.default_rng(16)
    pcm = (rng.standard_normal(16000 * 2) * 0.1).astype(np.float32)
    js = JStreaming(cfg=jm.cfg, stream=JStreamConfig(chunk_frames=8))
    js.params = params
    ts = StreamingSenseVoice(cfg=SenseVoiceConfig(**TINY), stream=StreamConfig(chunk_frames=8),
                             device="cpu")
    ts.params = from_numpy_tree(params)
    got = ts.transcribe_stream(pcm)
    assert got == js.transcribe_stream(pcm)
    assert got == ts.transcribe_stream(pcm) and all(0 <= i < 40 for i in got)


def test_stream_first_chunk_matches_offline_prefixless(weights):
    """tests/test_streaming_asr.py:47-80 on the port: chunk 1 with an empty
    cache against offline prefixless encoding (FSMN k = 11 is centred
    offline and causal here, so top-1 ids mostly agree); with k = 1 the two
    agree to atol 1e-3."""
    jm, params = weights
    cfg = SenseVoiceConfig(**TINY)
    feats = torch.from_numpy(np.random.default_rng(77).standard_normal((1, 12, 560))
                             .astype(np.float32))
    mask = torch.ones((1, 12))
    tp = from_numpy_tree(params)
    state = init_stream_state(cfg, StreamConfig(chunk_frames=12, context_frames=8), device="cpu")
    stream, _ = stream_step(tp, feats, mask, state, cfg)
    offline = sensevoice_encode(tp, feats, mask, replace(cfg, n_prefix=0))
    assert (stream[0].argmax(-1) == offline[0].argmax(-1)).float().mean() > 0.5
    cfg1 = replace(cfg, fsmn_kernel=1)
    tp1 = from_numpy_tree(params)
    for lp in tp1["layers"]:
        lp["fsmn"]["w"] = lp["fsmn"]["w"][5:6]  # the centre tap only
    stream1, _ = stream_step(tp1, feats, mask, init_stream_state(
        cfg1, StreamConfig(chunk_frames=12, context_frames=8), device="cpu"), cfg1)
    offline1 = sensevoice_encode(tp1, feats, mask, replace(cfg1, n_prefix=0))
    torch.testing.assert_close(stream1, offline1, rtol=0, atol=1e-3)


def test_two_chunk_stream_matches_offline_with_full_context():
    """tests/test_streaming_asr.py:128-165 on the port: one layer, FSMN k = 1,
    a context that holds every past frame: chunk 2 reproduces offline
    prefixless encoding (atol 2e-4, JAX's gate)."""
    cfg = dict(n_layers=1, d_model=32, ffn_dim=64, vocab_size=40, n_heads=2,
               dtype="float32", fsmn_kernel=1)
    m = JModel(JConfig(**cfg))
    m.init(0)
    tp = from_numpy_tree(_np_tree(m.params))
    tcfg = SenseVoiceConfig(**cfg)
    feats = torch.from_numpy(np.random.default_rng(55).standard_normal((1, 16, 560))
                             .astype(np.float32))
    offline = sensevoice_encode(tp, feats, torch.ones((1, 16)), replace(tcfg, n_prefix=0))
    st = init_stream_state(tcfg, StreamConfig(chunk_frames=8, context_frames=16), device="cpu")
    _, st = stream_step(tp, feats[:, :8], torch.ones((1, 8)), st, tcfg)
    l2, _ = stream_step(tp, feats[:, 8:], torch.ones((1, 8)), st, tcfg)
    torch.testing.assert_close(l2[0], offline[0, 8:], rtol=0, atol=2e-4)
