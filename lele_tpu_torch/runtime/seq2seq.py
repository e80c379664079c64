"""Encoder–decoder (seq2seq) generation over compiled ONNX graphs
(counterpart of lele_tpu/runtime/seq2seq.py).

Whisper-class ASR and translation: the encoder runs once an utterance and
gives the cross-attention keys and values once; the decoder step graph
takes them as fixed extras (copied once into its step program's static
buffers) while its self-attention cache advances through the whole
generation program (runtime/decode.py).

Graph contract:
  encoder graph:  source features → (cross_k, cross_v), each
                  [L, B, H, T_enc, D]: the per-layer cross-attention
                  projections of the encoder states.
  decoder graph:  the StaticKVDecoder step contract (decode.py docstring)
                  plus two trailing inputs cross_k, cross_v.

Two programs an utterance: the encoder's and the decode's.
"""

from __future__ import annotations

from .decode import StaticKVDecoder


class Seq2SeqGenerator:
    def __init__(self, encoder_cm, decoder_cm, num_layers: int,
                 num_heads: int, head_dim: int, max_len: int,
                 bos_id: int = 1, eos_id: int = 2, batch: int = 1):
        """batch: the decoder step graph's compiled batch dimension, 1 for
        greedy and sampling, the beam width for `generate_beam`."""
        self.encoder = encoder_cm
        self.decoder = StaticKVDecoder(
            decoder_cm, num_layers=num_layers, num_heads=num_heads,
            head_dim=head_dim, max_len=max_len, batch=batch,
        )
        self.bos_id = bos_id
        self.eos_id = eos_id
        self.max_len = max_len

    def encode(self, *source) -> tuple:
        """→ (cross_k, cross_v) on the device, computed once an utterance."""
        outs = self.encoder(*source)
        return tuple(outs[:2])

    def generate(self, *source, max_steps: int | None = None,
                 temperature: float = 0.0, seed: int = 0) -> list[int]:
        """source features → token ids, BOS-primed and cut at EOS on the
        host (the program runs the static step count)."""
        steps = max_steps or (self.max_len - 1)
        cross = self.encode(*source)
        ids, _ = self.decoder.generate(
            [self.bos_id], steps, temperature=temperature, seed=seed,
            extras=cross,
        )
        return self._cut_eos(ids)

    def generate_beam(self, *source, beam: int | None = None,
                      max_steps: int | None = None,
                      length_penalty: float = 0.0) -> tuple[list[int], float]:
        """Beam search (decode.py `beam_search`): the decoder step graph is
        compiled with batch = beam; the encoder's cross K/V (batch 1) are
        broadcast across the beam rows. → (ids, score)."""
        steps = max_steps or (self.max_len - 1)
        K = beam or self.decoder.B
        cross = tuple(c.expand((c.shape[0], K) + tuple(c.shape[2:]))
                      for c in self.encode(*source))
        return self.decoder.beam_search(
            [self.bos_id], steps, beam=K, eos_id=self.eos_id,
            length_penalty=length_penalty, extras=cross,
        )

    def generate_hostloop(self, *source, max_steps: int | None = None
                          ) -> list[int]:
        """The per-token host-loop oracle of `generate`."""
        steps = max_steps or (self.max_len - 1)
        cross = self.encode(*source)
        ids, _ = self.decoder.generate_hostloop(
            [self.bos_id], steps, extras=cross)
        return self._cut_eos(ids)

    def _cut_eos(self, ids) -> list[int]:
        if ids and isinstance(ids[0], (list, tuple)):
            # a decoder compiled with batch > 1 returns a list a row; this
            # single-sequence API reports row 0 (generate_beam is the
            # batched surface)
            ids = ids[0]
        out = []
        for t in ids:
            if int(t) == self.eos_id:
                break
            out.append(int(t))
        return out
