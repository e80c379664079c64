"""The port's generative runtime (runtime/decode.py, runtime/seq2seq.py) and
its `onnx/torch_shim.py`, held against the JAX package on the CPU, on the
same `torch.onnx.export`-ed step graphs (tests/test_torch_onnx.py's
`TinyDecoderStep`, `TinyS2SEncoder` and `TinyS2SDecoderStep`, exported once
through the port's shim and compiled by both packages):

- the port's shim exports what JAX's shim exports, byte for byte;
- `StaticKVDecoder`: greedy ids equal JAX's (its host loop and its fused
  program) on both decode paths, and the last logits agree at 1e-4; the
  fused program equals the port's host loop, greedy and sampled, ids
  exactly (the sampled draws are torch's, so they are held to the port's
  own host loop and to JAX's test's distribution checks: the same seed gives
  the same ids, every id is in the vocabulary, a tiny temperature gives the
  greedy ids); batched rows decode independently; the exact-capacity
  guard raises as JAX's does;
- `beam_search`: ids equal JAX's and the score within 1e-5, with and without
  EOS and a length penalty; beam 1 equals greedy; beam != batch raises;
- `Seq2SeqGenerator`: `generate`, `generate_hostloop` and `generate_beam`
  equal JAX's.

On the CPU nothing is captured: the step program's function runs once a
token, as the captured graph is replayed once a token on a card.
"""

import io
import sys

import numpy as np
import pytest
import torch
from test_torch_onnx import TinyDecoderStep, TinyS2SDecoderStep, TinyS2SEncoder

from lele_tpu.compiler import compile_model as j_compile
from lele_tpu.onnx import torch_shim as j_shim
from lele_tpu.runtime.decode import StaticKVDecoder as JDecoder
from lele_tpu.runtime.seq2seq import Seq2SeqGenerator as JSeq2Seq
from lele_tpu_torch.compiler import compile_model
from lele_tpu_torch.onnx import torch_shim
from lele_tpu_torch.runtime import Seq2SeqGenerator, StaticKVDecoder

SCORE_ATOL = 1e-5
LOGITS_TOL = 1e-4


def _export(m, args, shim=torch_shim, names=None) -> bytes:
    """m exported by torch.onnx.export (opset 17, TorchScript) with `shim`
    registered as the `onnx` module."""
    sys.modules.pop("onnx", None)
    shim.install()
    f = io.BytesIO()
    kw = {} if names is None else dict(input_names=names[0], output_names=names[1])
    with torch.no_grad():
        torch.onnx.export(m.eval(), args, f, opset_version=17, dynamo=False, **kw)
    return f.getvalue()


def _step_args(B, L, H, P, hd, Te=None):
    args = [torch.zeros(B, 1, dtype=torch.long), torch.zeros(B, 1, dtype=torch.long),
            torch.zeros(L, B, H, P, hd), torch.zeros(L, B, H, P, hd),
            torch.zeros(B, 1, 1, P + 1)]
    if Te is not None:
        args += [torch.zeros(L, B, H, Te, hd), torch.zeros(L, B, H, Te, hd)]
    return tuple(args)


STEP_NAMES = (["ids", "pos", "ck", "cv", "mask"], ["logits", "nk", "nv"])


def _decoders(seed, V, d, H, L, MAXLEN, B=1):
    """The same step graph's bytes compiled by both packages → (port, JAX)
    decoders."""
    torch.manual_seed(seed)
    m = TinyDecoderStep(V, d, H, L, MAXLEN)
    bs = _export(m, _step_args(B, L, H, MAXLEN - 1, d // H), names=STEP_NAMES)
    kw = dict(num_layers=L, num_heads=H, head_dim=d // H, max_len=MAXLEN, batch=B)
    return (StaticKVDecoder(compile_model(bs, device="cpu"), **kw),
            JDecoder(j_compile(bs), **kw))


# the configurations of tests/test_torch_onnx.py's decode tests
GREEDY = {"kv_cache": (21, 97, 64, 4, 2, 24, [5, 17, 3], 12),
          "fused": (22, 61, 32, 2, 2, 20, [7, 11], 10)}


@pytest.fixture(scope="module")
def small():
    """(port, JAX) decoders at tests/test_torch_onnx.py's batched-rows width."""
    return _decoders(24, 53, 32, 2, 2, 16)


@pytest.mark.parametrize("model", [
    lambda: (TinyDecoderStep(31, 16, 2, 1, 8), _step_args(1, 1, 2, 7, 8)),
    lambda: (TinyS2SEncoder(16, 32, 2, 2), (torch.randn(1, 5, 16),)),
    lambda: (TinyS2SDecoderStep(31, 32, 2, 2, 12), _step_args(1, 2, 2, 11, 16, Te=5)),
], ids=["decoder_step", "s2s_encoder", "s2s_decoder_step"])
def test_torch_shim_exports_what_jax_shim_exports(model):
    torch.manual_seed(3)
    m, args = model()
    try:
        want = _export(m, args, shim=j_shim)
        assert sys.modules["onnx"].__version__ == "0.0.0+lele_tpu_shim"
        got = _export(m, args)
        assert sys.modules["onnx"].__version__ == "0.0.0+lele_tpu_torch_shim"
    finally:
        torch_shim.install(force=True)
    assert len(got) > 1000 and got == want


def test_torch_shim_stands_in_for_onnx():
    torch_shim.install(force=True)
    mod = sys.modules["onnx"]
    bs = _export(TinyDecoderStep(31, 16, 2, 1, 8), _step_args(1, 1, 2, 7, 8))
    shim = mod.load_model_from_string(bs)
    assert shim.SerializeToString() == bs
    assert {n.op_type for n in shim.graph.node} >= {"Gather", "MatMul", "Softmax", "Erf"}
    shim.functions.append(object())
    with pytest.raises(NotImplementedError):
        shim.SerializeToString()
    assert torch_shim.install() is True  # already registered: kept


@pytest.mark.parametrize("case", list(GREEDY))
def test_greedy_ids_equal_jax(case):
    seed, V, d, H, L, MAXLEN, prompt, steps = GREEDY[case]
    dec, jdec = _decoders(seed, V, d, H, L, MAXLEN)
    want, want_logits = jdec.generate_hostloop(prompt, steps)
    assert jdec.generate_fused(prompt, steps)[0] == want
    got, logits = dec.generate(prompt, steps)
    got_h, logits_h = dec.generate_hostloop(prompt, steps)
    assert got == got_h == want
    np.testing.assert_allclose(logits.reshape(-1), np.asarray(want_logits).reshape(-1),
                               rtol=LOGITS_TOL, atol=LOGITS_TOL)
    np.testing.assert_array_equal(logits.reshape(-1), logits_h.reshape(-1))


@pytest.mark.parametrize("temperature", [0.0, 1.5], ids=["greedy", "sampled"])
def test_fused_equals_hostloop(small, temperature):
    dec, _ = small
    for prompt, seed in (([3, 7], 7), ([11, 2, 5], 9)):
        got, logits = dec.generate_fused(prompt, 8, temperature=temperature, seed=seed)
        want, logits_h = dec.generate_hostloop(prompt, 8, rng=seed, temperature=temperature)
        assert got == want
        np.testing.assert_array_equal(logits.reshape(-1), logits_h.reshape(-1))


def test_sampling_distribution_checks(small):
    """tests/test_torch_onnx.py:513's checks of the sampled path."""
    dec, _ = small
    pa = [3, 7]
    s1, _ = dec.generate_fused(pa, 8, temperature=1.5, seed=7)
    s2, _ = dec.generate_fused(pa, 8, temperature=1.5, seed=7)
    assert s1 == s2 and all(0 <= t < 53 for t in s1)
    assert dec.generate_fused(pa, 8, temperature=1.5, seed=8)[0] != s1
    cold, _ = dec.generate_fused(pa, 8, temperature=1e-4, seed=7)
    assert cold == dec.generate_fused(pa, 8)[0]  # tiny temperature → greedy


def test_batched_rows_equal_jax(small):
    """B = 2: each row equals the B = 1 run of its own prompt, and JAX's B = 2
    program."""
    dec1, _ = small
    dec2, jdec2 = _decoders(24, 53, 32, 2, 2, 16, B=2)
    pa, pb = [3, 7], [11, 2]
    ids2, _ = dec2.generate_fused(np.array([pa, pb]), 8)
    assert ids2 == [dec1.generate_fused(pa, 8)[0], dec1.generate_fused(pb, 8)[0]]
    assert ids2 == jdec2.generate_fused(np.array([pa, pb]), 8)[0]


def test_exact_capacity_and_guard():
    """prompt + steps == max_len runs on every path (the last token's K/V
    rides in-step, its slot write is skipped); one past it raises."""
    MAXLEN = 8
    dec, jdec = _decoders(23, 31, 16, 2, 1, MAXLEN)
    prompt = [3, 5]
    steps = MAXLEN - len(prompt)
    want, _ = jdec.generate_fused(prompt, steps)
    assert dec.generate_fused(prompt, steps)[0] == dec.generate_hostloop(prompt, steps)[0] == want
    for fn in (dec.generate_fused, dec.generate_hostloop, jdec.generate_fused,
               jdec.generate_hostloop):
        with pytest.raises(ValueError, match="max_len=8"):
            fn(prompt, steps + 1)
    with pytest.raises(ValueError, match="prompt batch"):
        dec.generate_fused(np.zeros((2, 2), np.int64), 3)


@pytest.fixture(scope="module")
def beam4():
    return _decoders(43, 53, 32, 4, 2, 18, B=4)


@pytest.mark.parametrize("prompt,eos,penalty", [
    ([5], 11, 0.0), ([5, 9], None, 0.0), ([2], 11, 0.6), ([4, 4, 1], 7, 1.0)])
def test_beam_search_equals_jax(beam4, prompt, eos, penalty):
    dec, jdec = beam4
    want, want_score = jdec.beam_search(prompt, 8, beam=4, eos_id=eos, length_penalty=penalty)
    got, score = dec.beam_search(prompt, 8, beam=4, eos_id=eos, length_penalty=penalty)
    assert got == want
    assert abs(score - want_score) <= SCORE_ATOL


def test_beam1_equals_greedy_and_guards():
    dec, jdec = _decoders(41, 53, 32, 4, 2, 18)
    greedy, _ = dec.generate_fused([3, 7], 10)
    ids, score = dec.beam_search([3, 7], 10, beam=1)
    assert ids == greedy == jdec.beam_search([3, 7], 10, beam=1)[0] and np.isfinite(score)
    with pytest.raises(ValueError, match="beam"):
        dec.beam_search([3], 4, beam=2)
    with pytest.raises(ValueError, match="max_len"):
        dec.beam_search([3, 7], 17, beam=1)


def _s2s(seed, V, d, H, L, MAXLEN, Te, F, B=1):
    """(port, JAX) generators on one encoder's and one decoder step's bytes."""
    torch.manual_seed(seed)
    enc = TinyS2SEncoder(F, d, H, L)
    dec = TinyS2SDecoderStep(V, d, H, L, MAXLEN)
    src = torch.randn(1, Te, F)
    enc_b = _export(enc, (src,), names=(["src"], ["cross_k", "cross_v"]))
    dec_b = _export(dec, _step_args(B, L, H, MAXLEN - 1, d // H, Te=Te),
                    names=(STEP_NAMES[0] + ["cross_k", "cross_v"], STEP_NAMES[1]))
    kw = dict(num_layers=L, num_heads=H, head_dim=d // H, max_len=MAXLEN, bos_id=1, eos_id=0,
              batch=B)
    return (Seq2SeqGenerator(compile_model(enc_b, device="cpu"),
                             compile_model(dec_b, device="cpu"), **kw),
            JSeq2Seq(j_compile(enc_b), j_compile(dec_b), **kw), src.numpy())


def test_seq2seq_generate_equals_jax():
    gen, jgen, src = _s2s(33, 61, 64, 4, 2, 20, 9, 16)
    want = jgen.generate(src, max_steps=12)
    assert want == jgen.generate_hostloop(src, max_steps=12)
    assert gen.generate(src, max_steps=12) == gen.generate_hostloop(src, max_steps=12) == want


def test_seq2seq_beam_equals_jax():
    gen, jgen, src = _s2s(51, 61, 64, 4, 2, 16, 7, 16, B=2)
    want, want_score = jgen.generate_beam(src, beam=2, max_steps=8)
    got, score = gen.generate_beam(src, beam=2, max_steps=8)
    assert got == want and len(got) <= 8
    assert abs(score - want_score) <= SCORE_ATOL
