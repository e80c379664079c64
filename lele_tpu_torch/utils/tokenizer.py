"""SenseVoice CTC tokenizer (the port's copy of lele_tpu/utils/tokenizer.py):
vocabulary lookup, then greedy decoding that skips the blank, `<|…|>` tags
and specials and turns the sentencepiece underline into a space."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np


class CtcTokenizer:
    """Vocabulary formats: a JSON list ["<blank>", "a", ...], a JSON dict
    {token: id}, or text with one token per line (the first field)."""

    def __init__(self, tokens: list[str], blank_id: int = 0):
        self.tokens = tokens
        self.blank_id = blank_id

    @classmethod
    def load(cls, path: str | Path, blank_id: int = 0) -> "CtcTokenizer":
        p = Path(path)
        text = p.read_text(encoding="utf-8")
        if p.suffix == ".json":
            raw = json.loads(text)
            if isinstance(raw, dict):
                tokens = [""] * (max(raw.values()) + 1)
                for tok, i in raw.items():
                    tokens[i] = tok
            else:
                tokens = list(raw)
        else:
            tokens = [line.split("\t")[0].split(" ")[0]
                      for line in text.splitlines() if line]
        return cls(tokens, blank_id)

    def id_to_token(self, i: int) -> str:
        return self.tokens[i] if 0 <= i < len(self.tokens) else ""

    def decode(self, ids: list[int]) -> str:
        """ids → text: skip blanks and <|...|> control tags, ▁ → space."""
        out = []
        for i in ids:
            if i == self.blank_id:
                continue
            tok = self.id_to_token(int(i))
            if tok.startswith("<|") and tok.endswith("|>"):
                continue
            if tok in ("<blank>", "<unk>", "<s>", "</s>", ""):
                continue
            out.append(tok.replace("▁", " "))
        return "".join(out).strip()

    def decode_greedy(self, logits) -> str:
        """Frame logits [T, V] (numpy or tensor) → text (argmax, collapse,
        decode)."""
        from ..models.sensevoice import greedy_ctc_decode

        return self.decode(greedy_ctc_decode(logits, self.blank_id))


def synthetic_vocab(n: int, seed: int = 0) -> list[str]:
    """A made-up vocabulary of n tokens in SenseVoice's shape, from a seed:
    the blank, <unk>, <s>, </s>, a few <|…|> tags, then word pieces, some
    with the ▁ word-start mark (the repo carries no published vocabulary)."""
    rng = np.random.default_rng(seed)
    head = ["<blank>", "<unk>", "<s>", "</s>", "<|zh|>", "<|en|>", "<|Speech|>",
            "<|NEUTRAL|>", "<|withitn|>"][:n]
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    pieces = []
    for i in range(n - len(head)):
        word = "".join(rng.choice(letters, rng.integers(1, 6)))
        pieces.append(("▁" if rng.random() < 0.4 else "") + word + str(i))
    return head + pieces
