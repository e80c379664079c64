"""Autoregressive decoding over compiled ONNX decoder-step graphs
(counterpart of lele_tpu/runtime/decode.py).

The cache is static: instead of "past/present" graphs whose cache grows one
slot a step (a new shape every token), the step graph keeps a fixed-capacity
cache and returns only the new slot, which the decoder writes at the
current position. One program serves every step.

Step-graph contract (the JAX package's; tests/test_torch_onnx.py exports a
real instance with torch.onnx.export):

  inputs (in graph order):
    ids      int64  [B, 1]           current token
    pos      int64  [B, 1]           its absolute position
    cache_k  f32    [L, B, H, P, D]  static key cache (P = max length - 1)
    cache_v  f32    [L, B, H, P, D]  static value cache
    mask     f32    [B, 1, 1, P+1]   additive attention mask (0 / -inf);
                                     slot P is the current token
    ...extras                        further per-utterance constants (the
                                     encoder's cross-attention K/V of the
                                     seq2seq path, runtime/seq2seq.py),
                                     passed as `extras=`
  outputs:
    logits   f32    [B, V] or [B, 1, V]
    new_k    f32    [L, B, H, 1, D]  this step's key, one slot
    new_v    f32    [L, B, H, 1, D]

Whole-generation decode (`generate_fused`, `beam_search`) is one step
program a (B, P) (runtime/graphs.py): the token sequence, the position, both
caches and (for the beam) the scores, parents' sequences and EOS flags live
in the program's static buffers, which each run updates in place (a donated
state); the mask is built from the position on the card, the slot write
min(pos, P-1) is skipped at pos = P, and the next token is picked on the
card (argmax, or sampled at temperature > 0). On a card the captured graph
is replayed n_prompt + steps times back to back and the ids are read once at
the end; on the CPU the same function runs that many times. The prompt
length is a device scalar, so one program serves every prompt length.

Sampling draws from uniforms made before the program runs: `torch.rand` of
a `torch.Generator(device)` seeded from `seed`, one row a position, 1 - u
so that every draw is in (0, 1]; the token is the inverse CDF of the
softmax at that draw. `jax.random` bits cannot be drawn in torch, so the
sampled ids are the port's own: `generate_hostloop` takes the same draws.
"""

from __future__ import annotations

import numpy as np
import torch

from .graphs import Programs


def _pick(logits: torch.Tensor, u: torch.Tensor | None, temperature: float | torch.Tensor):
    """The next token of each row of logits [B, V]: argmax, or with uniforms
    u [B] the inverse CDF of softmax(logits / temperature) at u."""
    if u is None:
        return torch.argmax(logits, dim=-1)
    c = torch.cumsum(torch.softmax(logits.float() / temperature, dim=-1), dim=-1)
    idx = (c < u[:, None] * c[:, -1:]).sum(dim=-1)
    return idx.clamp(max=logits.shape[-1] - 1)


class StaticKVDecoder:
    """Greedy, sampled and beam decoding around a CompiledModel step graph."""

    def __init__(self, cm, num_layers: int, num_heads: int, head_dim: int,
                 max_len: int, batch: int = 1, neg: float = -1e9):
        self.cm = cm
        self.L, self.H, self.D = num_layers, num_heads, head_dim
        self.P = max_len - 1  # cache slots; slot P rides in the step itself
        self.B = batch
        self.neg = np.float32(neg)
        self.programs = Programs(cm.device)

    def _mask(self, pos: int) -> np.ndarray:
        """Additive mask: allow cache slots < pos and the current slot P."""
        m = np.full((self.B, 1, 1, self.P + 1), self.neg, np.float32)
        m[..., :pos] = 0.0
        m[..., self.P] = 0.0
        return m

    def _check_length(self, n_prompt: int, steps: int) -> None:
        if n_prompt + steps > self.P + 1:
            raise ValueError(f"decode length exceeds max_len={self.P + 1}")

    def _uniforms(self, seed: int) -> torch.Tensor:
        """The sampling draws [P + 2, B] for `seed`: row q picks the token
        fed at position q."""
        gen = torch.Generator(device=self.cm.device)
        gen.manual_seed(int(seed))
        return 1.0 - torch.rand((self.P + 2, self.B), generator=gen, device=self.cm.device)

    def _caches(self, batch: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
        shape = (self.L, batch or self.B, self.H, self.P, self.D)
        return tuple(torch.zeros(shape, dtype=torch.float32, device=self.cm.device)
                     for _ in range(2))

    def _extras(self, extras) -> tuple:
        return tuple(e.to(self.cm.device) if isinstance(e, torch.Tensor)
                     else torch.from_numpy(np.asarray(e)).to(self.cm.device) for e in extras)

    def _step(self, ck, cv, tok, pos, extras) -> torch.Tensor:
        """One run of the step graph on the card: tok [B], pos a 0-d int64
        tensor → logits [B, V]. Writes the step's K/V into slot min(pos, P-1)
        of ck and cv in place, unless pos = P (the last token of a full
        cache rides in-step only: nothing attends after it)."""
        cm, B, P = self.cm, tok.shape[0], self.P
        slots = torch.arange(P + 1, device=pos.device)
        mask = torch.where((slots < pos) | (slots == P), 0.0, float(self.neg))
        mask = mask.to(torch.float32).reshape(1, 1, 1, P + 1).expand(B, 1, 1, P + 1)
        feeds = [tok.reshape(B, 1), pos.reshape(1, 1).expand(B, 1), ck, cv, mask, *extras]
        outs = cm._walk([v.to(cm._dtypes[n]) for n, v in zip(cm.input_order, feeds)])
        logits, nk, nv = outs[0], outs[1], outs[2]
        wp = pos.clamp(max=P - 1).reshape(1)
        write = pos < P
        for cache, new in ((ck, nk), (cv, nv)):
            cache.index_copy_(3, wp, torch.where(write, new.to(cache.dtype),
                                                 cache.index_select(3, wp)))
        return logits.reshape(B, -1)

    def generate(self, prompt_ids, steps: int, temperature: float = 0.0,
                 seed: int = 0, extras: tuple = ()):
        """The default decode: `generate_fused`, one step program replayed
        for the whole generation. `generate_hostloop` is its oracle."""
        return self.generate_fused(prompt_ids, steps, temperature=temperature,
                                   seed=seed, extras=extras)

    def generate_hostloop(self, prompt_ids, steps: int, rng=None,
                          temperature: float = 0.0, extras: tuple = ()):
        """Feed the prompt token by token (prefill), then pick `steps`
        tokens, one call of the step graph a token with the logits read
        back each time: the oracle of `generate_fused`. Row 0's pick feeds
        every row, as the JAX package's host loop does. `rng` is the seed of
        the sampling draws (None is 0; `_uniforms`). Returns (generated ids,
        the last logits)."""
        B, P = self.B, self.P
        self._check_length(len(prompt_ids), steps)
        ck, cv = self._caches()
        u = self._uniforms(0 if rng is None else rng) if temperature > 0.0 else None
        extras = self._extras(extras)
        logits = None
        pos = 0
        out_ids: list[int] = []

        def step(tok: int):
            nonlocal logits, pos
            outs = self.cm(np.full((B, 1), tok, np.int64), np.full((B, 1), pos, np.int64),
                           ck, cv, self._mask(pos), *extras)
            logits, nk, nv = outs[0], outs[1], outs[2]
            if pos < P:  # the final (pos == P) token rides in-step only
                ck[:, :, :, pos] = nk[:, :, :, 0]
                cv[:, :, :, pos] = nv[:, :, :, 0]
            pos += 1

        with torch.inference_mode():
            for tok in prompt_ids:
                step(int(tok))
            for _ in range(steps):
                lg = logits.reshape(B, -1)[:1]
                nxt = int(_pick(lg, None if u is None else u[pos, :1], temperature)[0])
                out_ids.append(nxt)
                step(nxt)
        return out_ids, logits.cpu().numpy()

    def _decode_fn(self, sample: bool):
        """One decode step on the program's state (seq [B, P + 2], pos, ck,
        cv): the token at pos goes through the graph, and the pick from its
        logits is written at pos + 1 once the prompt is behind."""

        def fn(state, n_prompt, u, temperature, extras):
            seq, pos, ck, cv = state
            tok = seq.index_select(1, pos.reshape(1)).reshape(-1)
            logits = self._step(ck, cv, tok, pos, extras)
            nxt_pos = (pos + 1).reshape(1)
            nxt = _pick(logits, u.index_select(0, nxt_pos).reshape(-1) if sample else None,
                        temperature)
            fed = seq.index_select(1, nxt_pos).reshape(-1)
            seq.index_copy_(1, nxt_pos, torch.where(nxt_pos >= n_prompt, nxt.to(seq.dtype),
                                                    fed).reshape(-1, 1))
            pos.add_(1)
            return logits, (seq, pos, ck, cv)

        return fn

    @torch.inference_mode()
    def generate_fused(self, prompt_ids, steps: int, temperature: float = 0.0,
                       seed: int = 0, extras: tuple = ()):
        """The whole generation as one step program (module docstring): the
        prefill and `steps` picks, no host read between tokens. `prompt_ids`
        is [n] (shared by every row) or [B, n]; rows decode independently.
        temperature > 0 samples (deterministic for a seed). Returns a flat id
        list for B = 1, else B lists, and the last step's logits."""
        B, P = self.B, self.P
        dev = self.cm.device
        prompt = np.asarray(prompt_ids, np.int64)
        if prompt.ndim == 1:
            prompt = np.broadcast_to(prompt, (B, prompt.shape[0]))
        if prompt.shape[0] != B:
            raise ValueError(f"prompt batch {prompt.shape[0]} != decoder batch {B}")
        n = prompt.shape[1]
        self._check_length(n, steps)
        sample = temperature > 0.0
        seq = np.zeros((B, P + 2), np.int64)
        seq[:, :n] = prompt
        state = (torch.from_numpy(seq).to(dev), torch.zeros((), dtype=torch.int64, device=dev),
                 *self._caches())
        u = (self._uniforms(seed) if sample
             else torch.zeros((P + 2, B), dtype=torch.float32, device=dev))
        consts = (torch.tensor(n, dtype=torch.int64).to(dev), u,
                  torch.tensor(max(temperature, 0.0), dtype=torch.float32).to(dev),
                  self._extras(extras))
        logits, state = self.programs.run(("decode", sample), lambda: self._decode_fn(sample),
                                          state, *consts, params=self.cm.params,
                                          donate={0: 1}, repeat=n + steps)
        ids = state[0][:, n:n + steps].cpu().numpy()
        logits = logits.cpu().numpy()
        if B == 1:
            return [int(t) for t in ids[0]], logits
        return [[int(t) for t in row] for row in ids], logits

    def _beam_fn(self, eos_id: int | None):
        """One beam step on the program's state (ck, cv, logits, scores, seqs,
        finished, pos): before the prompt's end the prompt token at pos goes
        through every row; after it, the top K of the K·V continuations are
        kept, the per-beam state reordered by parent, and the K tokens go
        through the graph."""
        K, neg = self.B, float(self.neg)

        def fn(state, prompt, n_prompt, extras):
            ck, cv, logits, scores, seqs, finished, pos = state
            V = logits.shape[-1]
            pre = pos < n_prompt
            logp = torch.log_softmax(logits.float(), dim=-1)
            if eos_id is not None:
                # frozen rows may only emit EOS, at unchanged score
                vocab = torch.arange(V, device=logits.device)
                frozen = torch.where(vocab == eos_id, 0.0, neg).to(logp.dtype)
                logp = torch.where(finished[:, None], frozen, logp)
            top_v, top_i = torch.topk((scores[:, None] + logp).reshape(-1), K)
            rows = torch.arange(K, device=logits.device)
            parent = torch.where(pre, rows, top_i // V)
            tok = torch.where(pre, prompt.index_select(0, pos.reshape(1)).expand(K), top_i % V)
            for buf in (ck, cv):
                buf.copy_(buf.index_select(1, parent))
            seqs.copy_(seqs.index_select(0, parent))
            col = (pos - n_prompt).clamp(min=0).reshape(1)
            seqs.index_copy_(1, col, torch.where(pre, seqs.index_select(1, col),
                                                 tok.reshape(K, 1)))
            done = finished.index_select(0, parent)
            if eos_id is not None:
                done = done | (~pre & (tok == eos_id))
            finished.copy_(done)
            scores.copy_(torch.where(pre, scores, top_v))
            logits.copy_(self._step(ck, cv, tok, pos, extras))
            pos.add_(1)
            return (ck, cv, logits, scores, seqs, finished, pos),

        return fn

    @torch.inference_mode()
    def beam_search(self, prompt_ids, steps: int, beam: int | None = None,
                    eos_id: int | None = None, length_penalty: float = 0.0,
                    extras: tuple = ()):
        """Beam search as one step program replayed for the whole search.

        The beam lives in the step graph's batch dimension (compile the step
        graph with B = beam): every step scores all beam×V continuations,
        keeps the global top `beam`, and reorders the KV caches and the
        sequences by parent beam with a gather on the card. EOS rows freeze:
        they may only extend with EOS at unchanged score. Returns (best_ids,
        best_score) with `best_ids` cut at EOS; `length_penalty` α applies
        GNMT's score / len^α at the final selection. The search always runs
        `steps` steps; the cut discards the tail."""
        B, P = self.B, self.P
        dev = self.cm.device
        K = beam or B
        if K != B:
            raise ValueError(
                f"beam ({K}) must equal the decoder batch ({B}) — compile "
                "the step graph with B = beam")
        prompt = np.asarray(prompt_ids, np.int64).reshape(-1)
        n = prompt.shape[0]
        self._check_length(n, steps)
        V = self.cm._tape.out_meta[0][0][-1]
        scores = torch.full((K,), float(self.neg), dtype=torch.float32, device=dev)
        scores[0] = 0.0  # row 0 is live; the first expansion takes the top K of its row
        padded = np.zeros(P + 1, np.int64)
        padded[:n] = prompt
        state = (*self._caches(), torch.zeros((K, V), dtype=torch.float32, device=dev),
                 scores, torch.zeros((K, P + 1), dtype=torch.int64, device=dev),
                 torch.zeros((K,), dtype=torch.bool, device=dev),
                 torch.zeros((), dtype=torch.int64, device=dev))
        (state,) = self.programs.run(
            ("beam", eos_id), lambda: self._beam_fn(eos_id), state,
            torch.from_numpy(padded).to(dev), torch.tensor(n, dtype=torch.int64).to(dev),
            self._extras(extras), params=self.cm.params, donate={0: 0}, repeat=n + steps)
        scores, seqs = state[3], state[4][:, :steps]
        if length_penalty > 0.0 and eos_id is not None:
            is_eos = seqs == eos_id
            lengths = torch.where(is_eos.any(-1), torch.argmax(is_eos.to(torch.int32), -1) + 1,
                                  steps)
            norm = scores / lengths.to(torch.float32) ** length_penalty
        else:
            norm = scores
        best = torch.argmax(norm)
        ids = [int(t) for t in seqs[best].cpu().numpy()]
        if eos_id is not None and eos_id in ids:
            ids = ids[: ids.index(eos_id)]
        return ids, float(norm[best])
