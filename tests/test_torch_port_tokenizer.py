"""The port's CTC tokenizer and prefix beam search against lele_tpu's: the
same vocabularies (synthetic, made from a seed: the repo carries no
published SenseVoice vocabulary) and the same logits, made with numpy."""

import json

import numpy as np
import pytest
import torch

from lele_tpu.utils.ctc_decode import ctc_beam_decode as j_beam_decode
from lele_tpu.utils.ctc_decode import ctc_prefix_beam_search as j_beam_search
from lele_tpu.utils.tokenizer import CtcTokenizer as JTokenizer
from lele_tpu_torch.utils.ctc_decode import ctc_beam_decode, ctc_prefix_beam_search
from lele_tpu_torch.utils.tokenizer import CtcTokenizer, synthetic_vocab

VOCAB = synthetic_vocab(60, seed=3)


def _write(tmp_path, fmt):
    if fmt == "json_list":
        p = tmp_path / "tokens.json"
        p.write_text(json.dumps(VOCAB), encoding="utf-8")
    elif fmt == "json_dict":
        p = tmp_path / "tokens.json"
        p.write_text(json.dumps({t: i for i, t in enumerate(VOCAB)}), encoding="utf-8")
    else:
        p = tmp_path / "tokens.txt"
        p.write_text("".join(f"{t} {i}\n" for i, t in enumerate(VOCAB)), encoding="utf-8")
    return p


def test_synthetic_vocab_has_the_sensevoice_shape():
    assert len(VOCAB) == 60 and VOCAB[0] == "<blank>" and "<|zh|>" in VOCAB
    assert any(t.startswith("▁") for t in VOCAB) and len(set(VOCAB)) == 60
    assert synthetic_vocab(60, seed=3) == VOCAB != synthetic_vocab(60, seed=4)


@pytest.mark.parametrize("fmt", ["json_list", "json_dict", "text"])
def test_load_and_decode_match_jax(tmp_path, fmt):
    """All three vocabulary formats; blanks, <|…|> tags, specials and ids out
    of range are skipped, ▁ becomes a space, the text is stripped."""
    path = _write(tmp_path, fmt)
    tok, jtok = CtcTokenizer.load(path), JTokenizer.load(path)
    assert tok.tokens == jtok.tokens == VOCAB
    rng = np.random.default_rng(7)
    for n in (0, 1, 5, 40):
        ids = [int(i) for i in rng.integers(-3, 70, n)]
        assert tok.decode(ids) == jtok.decode(ids)
    assert tok.decode([0, 4, 1, 2, 3, 99, -1]) == ""
    assert tok.id_to_token(59) == jtok.id_to_token(59) and tok.id_to_token(60) == ""


def test_decode_greedy_matches_jax():
    tok, jtok = CtcTokenizer(VOCAB), JTokenizer(VOCAB)
    logits = np.random.default_rng(8).standard_normal((50, 60)).astype(np.float32)
    want = jtok.decode_greedy(logits)
    assert tok.decode_greedy(logits) == want
    assert tok.decode_greedy(torch.from_numpy(logits)) == want
    assert CtcTokenizer(VOCAB, blank_id=5).decode_greedy(logits) == \
        JTokenizer(VOCAB, blank_id=5).decode_greedy(logits)


@pytest.mark.parametrize("beam,topk,T,V", [(8, 16, 30, 12), (1, 16, 25, 10),
                                          (4, 5, 40, 60), (16, 8, 12, 6)])
def test_prefix_beam_search_matches_jax(beam, topk, T, V):
    """The same beams in the same order, the same log probabilities (float64
    host arithmetic on both sides: equal to 1e-12)."""
    logits = (np.random.default_rng(T * V + beam).standard_normal((T, V)) * 3).astype(
        np.float32)
    want = j_beam_search(logits, beam, 0, topk)
    got = ctc_prefix_beam_search(logits, beam, 0, topk)
    assert [b for b, _ in got] == [b for b, _ in want]
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want], rtol=1e-12)
    assert ctc_beam_decode(logits, beam) == j_beam_decode(logits, beam)


def test_beam_search_with_peaked_posteriors_is_greedy():
    from lele_tpu_torch.models import greedy_ctc_decode

    ids = [3, 3, 0, 5, 5, 5, 0, 0, 3, 7]
    logits = np.full((len(ids), 9), -20.0, np.float32)
    logits[np.arange(len(ids)), ids] = 5.0
    assert ctc_beam_decode(logits, beam_size=1) == greedy_ctc_decode(logits) == [3, 5, 3, 7]
