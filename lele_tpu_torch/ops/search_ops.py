"""com.microsoft generative search ops: BeamSearch, GreedySearch, Sampling,
WhisperBeamSearch and NGramRepeatBlock (counterpart of
lele_tpu/ops/search_ops.py).

ORT's generative exports (GPT-2 through onnxruntime's convert_generation.py,
Whisper, T5) carry the whole generation loop as one node whose decoder, and
for model_type 1 and 2 the encoder_decoder_init graph, rides as a graph
attribute. The JAX package traces the loop into one `lax.scan`; here the node
becomes one recorded step, so a compiled model replays the whole search as
one captured CUDA graph:

- **Two walks, one set of params.** The prefill (or the encoder and the
  first decoder pass) is walked inline on the node's tape. The decoder's
  step graph is walked once more onto a sub-tape, on device placeholders at
  the static buffer shapes (`GraphTracer.walk_body`). Both walks hoist the
  decoder's initializers under one scope (one scope a node and tag), so
  they share one copy of the params; the step walk starts from an empty CSE
  table, so it reads nothing of the prefill but those params.
- **The loop** (`compiler/tracer._SearchStep`) replays the sub-tape
  `max_length - prompt_len - 1` times. Each past input has a static
  `max_length` buffer: a step's new row lands at the step's slot
  (`index_copy_` at a device index), a running key-validity mask covers the
  unwritten tail, and the beams' reorders copy back into the same buffers.
  The step counter is a device `arange` indexed a step, and a finished row
  is frozen by `where`, never by a break: nothing is read on the host, so
  the tape stays capturable.
- **Ties.** `lax.top_k` puts the lower index first among equal values, and
  the JAX scorer relies on it (masked scores tie at `NEG`; the incumbent
  finished pool stays ahead of new hypotheses). `torch.topk` promises no
  order among ties, so every select is a stable descending sort and a
  slice (`_top_k`).
- **Sampling's draws** are Gumbel-max over uniforms made on the device from
  a counter-based hash of the `seed` attribute, the `seed` input, the step,
  the row and the column (`_uniforms`): the same seed gives the same
  rollout, captured or not, and another seed another rollout. They are not
  threefry's bits (ROADMAP §3 "Known"), as the port's Random ops are not.

Decoder contracts, scorer semantics (ORT's legacy-HF BeamSearchScorer:
log-softmax before the processors, the length penalty over the full
hypothesis length, EOS into the finished pool only from the top `num_beams`
ranks, `early_stopping=0` searching until the worst finished score cannot be
beaten) and refusals are JAX's. The T5/Whisper step graphs carry no
self-attention mask: the running mask goes into their own MultiHeadAttention
and Attention nodes that read a self-past buffer (a recording override, so
the mask is the sub-tape's input). Exports that derive positions from
`Shape(past_*)` would read the buffer's capacity and are not supported.
`max_length`, `num_beams` and `num_return_sequences` fix shapes: bind them
(`onnx.loader.bind_inputs`) where an export feeds them at run time.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F

from .registry import CONTRIB_OPS, OpContext, op, static_ints

NEG = -1e30  # a finite stand-in for -inf: keeps the where-arithmetic NaN-free
MASK_FEED = "\0search/self_mask"  # the injected mask's place among the step's inputs

# --------------------------------------------------------------- subgraph io


def _scope(ctx: OpContext, tag: str) -> str:
    name = ctx.node.name if (ctx.node is not None and ctx.node.name) else "s"
    return f"{ctx.scope}{name}/{tag}/"


def _run_decoder(ctx: OpContext, g, feeds: dict, tag: str):
    """Walk a subgraph inline on the node's tape with the given bindings
    (the prefill, the encoder). The scope is the same for every walk of one
    node and tag, so the subgraph's initializers hoist once."""
    if ctx.tracer is None or ctx.state is None:
        raise RuntimeError("search ops need the tracer's walk state (ctx.state); they "
                           "only run under the graph tracer")
    env: dict[str, Any] = {"": None}
    env.update(feeds)
    return ctx.tracer._walk_graph(ctx.state, g, env, _scope(ctx, tag))


def _inject(saved: dict, name: str, mask_pos: int, self_past: frozenset, mask):
    """An override of com.microsoft `name` that fills its mask input with
    the running key-validity mask where the node reads a self-past buffer.
    It records its own step, so the mask is an argument of that step (the
    sub-tape's input), not a value held from the walk."""
    base = saved.get(f"com.microsoft::{name}")
    orig = base if base is not None else CONTRIB_OPS[("com.microsoft", name)].fn

    def ov(octx, *ins):
        if any(nm in self_past for nm in octx.node.input):
            ins = list(ins) + [None] * max(0, mask_pos + 1 - len(ins))
            if ins[mask_pos] is None:
                ins[mask_pos] = mask
        return octx.state.run(orig, octx, *ins)

    ov.records = True
    return ov


def _walk_step(ctx: OpContext, g, feeds: dict, tag: str, self_past=None):
    """The decoder step's sub-tape (`GraphTracer.walk_body`, from an empty
    CSE table) on the placeholders in `feeds`; with `self_past`, the mask under MASK_FEED is
    injected into the graph's own self-attention nodes (ORT's
    DecoderMasked* static-buffer semantics for step graphs with no mask
    input of their own)."""
    tr = ctx.tracer

    def walk():
        return tr.walk_body(ctx.state, g, {"": None}, _scope(ctx, tag), feeds.items(),
                            "Search step outputs", cse={})[0]

    if self_past is None:
        return walk()
    saved = tr.overrides
    try:
        tr.overrides = dict(saved)
        tr.overrides["com.microsoft::MultiHeadAttention"] = _inject(
            saved, "MultiHeadAttention", 4, self_past, feeds[MASK_FEED])  # key_padding_mask
        tr.overrides["com.microsoft::Attention"] = _inject(
            saved, "Attention", 3, self_past, feeds[MASK_FEED])  # mask_index
        return walk()
    finally:
        tr.overrides = saved


# ------------------------------------------------------------- logits rules


@dataclass
class _SearchOpts:
    max_length: int
    prompt_len: int
    eos: int
    pad: int
    nb: int = 1
    nret: int = 1
    early_stopping: bool = False
    ngram: int = 0
    min_length: Any = None  # a device scalar or None
    rep_penalty: Any = None  # a device scalar or None
    length_penalty: Any = None  # a device scalar (beam only)
    vocab_mask: Any = None  # [V] or None
    prefix_mask: Any = None  # [B, V] or None (first step only)
    seed: int = 0


def _scatter_any(tokens, flags, vocab: int):
    """tokens [R, W] int, flags [R, W] bool → [R, vocab] bool: does any
    flagged position hold token t? (A token outside [0, vocab) is dropped,
    as JAX's scatter drops it.)"""
    t = tokens.long()
    ok = (t >= 0) & (t < vocab)
    out = torch.zeros((t.shape[0], vocab), dtype=torch.int32, device=t.device)
    out.scatter_reduce_(1, t.clamp(0, vocab - 1), (flags & ok).to(torch.int32), reduce="amax")
    return out > 0


def _ngram_ban(scores, seqs, p, n: int):
    """HF/ORT NoRepeatNGram: ban token t when the (n-1)-gram ending at the
    current position p (an int or a device scalar) already occurred in
    seq[0:p) followed by t."""
    r, vocab = scores.shape
    ml = seqs.shape[-1]
    w = ml - n + 1
    if w <= 0:
        return scores
    dev = seqs.device
    if n > 1:
        wins = torch.stack([seqs[:, i:i + w] for i in range(n - 1)], dim=-1)
        idx = (torch.arange(n - 1, device=dev) + (p - (n - 1))).clamp(0, ml - 1)
        prefix = seqs.index_select(1, idx.long())
        match = (wins == prefix[:, None, :]).all(-1)  # [R, W]
    else:
        match = torch.ones((r, w), dtype=torch.bool, device=dev)
    # the historic n-gram [j, j+n) must lie inside the generated prefix [0, p)
    jvalid = torch.arange(w, device=dev) + (n - 1) < p
    nxt = seqs[:, n - 1:n - 1 + w]
    banned = _scatter_any(nxt, match & jvalid[None, :], vocab)
    return torch.where(banned, NEG, scores)


def _process_scores(scores, seqs, p, opts: _SearchOpts, first: bool):
    """ORT's logits-processor stack over [rows, V] scores (raw logits for
    greedy and sampling, log-probabilities for beam, as ORT applies them).
    seqs [rows, max_length] holds the tokens so far; p (a device scalar) is
    the position the new token takes."""
    vocab = scores.shape[-1]
    if opts.rep_penalty is not None:
        valid = (torch.arange(seqs.shape[-1], device=seqs.device)[None, :] < p).expand(
            seqs.shape)
        appeared = _scatter_any(seqs, valid, vocab)
        rp = opts.rep_penalty
        pen = torch.where(scores < 0, scores * rp, scores / rp)
        scores = torch.where(appeared, pen, scores)
    if opts.ngram > 0:
        scores = _ngram_ban(scores, seqs, p, opts.ngram)
    if opts.vocab_mask is not None:
        scores = torch.where(opts.vocab_mask.bool()[None, :], scores, NEG)
    if first and opts.prefix_mask is not None:
        pm = opts.prefix_mask.bool().repeat_interleave(opts.nb, dim=0)
        scores = torch.where(pm, scores, NEG)
    if opts.min_length is not None:
        ban = (torch.arange(vocab, device=scores.device) == opts.eos) & (p < opts.min_length)
        scores = torch.where(ban[None, :], NEG, scores)
    return scores


def _top_k(x, k: int):
    """`lax.top_k` over the last axis: the k largest, descending, the lower
    index first among equal values (a stable sort; torch.topk orders ties
    as it likes)."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


# ---------------------------------------------------------- the decoder fronts


@dataclass
class _Front:
    """A decoder front end: what the loop reads of the walk (`dyn`: tape
    values, the search step's arguments; "logits0" the prefill's last
    logits, "presents" its KV, which `_bufs` pads into the static buffers)
    and how it runs one decode step.

    step_fn(step, dyn, tok, slot, key_mask, bufs) → (logits [BB, V] f32,
    the new key_mask): replays the step sub-tape on this step's feeds and
    writes each present's new row into its buffer in place."""

    seq_init: Any  # [B, S] int32 tape value
    dyn: dict
    tape: Any  # the step sub-tape
    init_mask: Callable  # (dyn) → key_mask [BB, ML] int32
    step_fn: Callable


def _batch_repeat(v, nb: int):
    """Expand the batch axis to batch·beams for any KV layout ([B, ...],
    [B, H, L, dh], [2, B, H, L, dh]) or rank-≤3 activation."""
    return v.repeat_interleave(nb, dim=v.dim() - 4 if v.dim() >= 4 else 0)


def _positions(mask):
    return (mask.cumsum(1, dtype=torch.int32) - 1).clamp(min=0)


def _last_logits(logits, nb: int = 1):
    return _batch_repeat(logits[:, -1, :].float(), nb)


def _pad_to(x, length: int):
    return F.pad(x, (0, 0, 0, length - x.shape[-2]))


def _buf_tail_write_(present, buf, slot) -> None:
    """Merge a step's present into its static buffer, in place. A
    concat-form present (length buffer + 1: contrib Attention, MHA) gives
    its last row at `slot`; a share-buffer present (length buffer: the
    DecoderMasked ops, which write the buffer at past_sequence_length
    themselves) is the new buffer. The length axis is ndim - 2 for every
    KV layout."""
    ax = buf.dim() - 2
    if present.shape[ax] == buf.shape[ax]:
        buf.copy_(present)
        return
    tail = present.narrow(ax, present.shape[ax] - 1, 1)
    buf.index_copy_(ax, slot.reshape(1), tail.to(buf.dtype))


def _mark(key_mask, slot):
    """key_mask with column `slot` (a device scalar) set."""
    cols = torch.arange(key_mask.shape[1], device=key_mask.device)
    return torch.where(cols[None, :] == slot, 1, key_mask)


def _bufs(d: dict, ml: int) -> list:
    """The static KV buffers: each prefill present padded to max_length."""
    return [_pad_to(p, ml) for p in d["presents"]]


def _gpt_io(g, what: str):
    ins = [vi.name for vi in g.input]
    outs = [vi.name for vi in g.output]
    if len(ins) < 3:
        raise ValueError(f"{what}: GPT decoder subgraph must declare (input_ids, "
                         f"position_ids, attention_mask, past_*) inputs, got {ins}")
    n_past = len(ins) - 3
    if len(outs) != 1 + n_past:
        raise ValueError(f"{what}: decoder subgraph declares {n_past} past inputs but "
                         f"{len(outs) - 1} present outputs; they must pair positionally")
    return ins, n_past


def _gpt_front(ctx, g, what, ids, mask, nb, ml, tag) -> _Front:
    """convert_generation.py's GPT contract: the decoder's attention_mask
    input carries the running key-validity mask."""
    st = ctx.state
    in_names, n_past = _gpt_io(g, what)
    ids_x, mask_x = st.run(_batch_repeat, ids, nb), st.run(_batch_repeat, mask, nb)
    bb, s = ids_x.shape
    feeds = {in_names[0]: ids_x, in_names[1]: st.run(_positions, mask_x),
             in_names[2]: mask_x}
    for nm in in_names[3:]:
        feeds[nm] = None  # the prefill runs with no past
    outs = _run_decoder(ctx, g, feeds, tag)
    presents = list(outs[1:1 + n_past])
    dyn = {"logits0": st.run(_last_logits, outs[0]), "presents": presents, "mask": mask_x}

    z = torch.zeros((bb, 1), dtype=torch.int32, device=st.device)
    holders = {in_names[0]: z, in_names[1]: z.clone(),
               in_names[2]: torch.zeros((bb, ml + 1), dtype=torch.int32, device=st.device)}
    for nm, pr in zip(in_names[3:], presents):
        holders[nm] = _pad_to(pr, ml).zero_()
    tape = _walk_step(ctx, g, holders, tag)

    def init_mask(d):
        return F.pad(d["mask"], (0, ml - s))

    def step_fn(step, d, tok, slot, key_mask, bufs):
        mask_t = F.pad(key_mask, (0, 1), value=1)
        pos = (d["mask"].sum(1) + (slot - s)).to(torch.int32)  # the real prompt length + i
        outs = step([tok[:, None], pos[:, None], mask_t, *bufs])
        for pr, buf in zip(outs[1:1 + n_past], bufs):
            _buf_tail_write_(pr, buf, slot)
        return outs[0][:, -1, :].float(), _mark(key_mask, slot)

    return _Front(ids, dyn, tape, init_mask, step_fn)


def _encdec_front(ctx, what, enc_g, dec_g, feats, enc_mask, start, nb, ml, tag) -> _Front:
    """ORT's encoder_decoder_init + step decoder (model_type 1 and 2). feats
    is the node's input 0 (token ids for T5, features for Whisper); start
    [B, S0] the decoder's prompt. Subgraph inputs and outputs are classified
    by name, as ORT's t5_decoder.cc does."""
    st = ctx.state
    b, s0 = start.shape
    bb = b * nb

    feeds = {}
    for vi in enc_g.input:
        ln = vi.name.lower()
        if "decoder_input_ids" in ln:
            feeds[vi.name] = start
        elif "mask" in ln:
            if enc_mask is None:
                raise ValueError(f"{what}: the encoder subgraph declares {vi.name!r} but "
                                 "no attention_mask input was given")
            feeds[vi.name] = enc_mask
        else:
            feeds[vi.name] = feats
    enc_outs = _run_decoder(ctx, enc_g, feeds, tag + "_init")
    by_name = {vi.name: v for vi, v in zip(enc_g.output, enc_outs)}
    logits_name = enc_g.output[0].name
    if "logits" not in logits_name.lower():
        raise ValueError(f"{what}: encoder_decoder_init's first output must be the "
                         f"logits, got {logits_name!r}")

    dec_in = [vi.name for vi in dec_g.input]
    self_past, cross_past, special = [], [], {}
    for i, nm in enumerate(dec_in):
        ln = nm.lower()
        if i == 0:
            continue  # input_ids
        elif "cache_indirection" in ln:
            raise NotImplementedError(
                f"{what}: cache_indirection (in-kernel beam reordering) is not "
                "supported; beams are reordered by physical gather")
        elif "past_sequence_length" in ln or ln == "past_seq_len":
            special["pseq"] = nm
        elif "past" in ln and "cross" in ln:
            cross_past.append(nm)
        elif "past" in ln:
            self_past.append(nm)
        elif "mask" in ln:
            special["emask"] = nm
        elif "hidden" in ln:
            special["ehid"] = nm
        elif "beam_width" in ln:
            special["beam"] = nm
        else:
            raise ValueError(
                f"{what}: unrecognized decoder-step input {nm!r} (expected input_ids / "
                "encoder_attention_mask / encoder_hidden_states / past_sequence_length / "
                "beam_width / past_*_self / past_*_cross names)")
    if not self_past:
        raise ValueError(f"{what}: the decoder step graph declares no self-attention "
                         "past inputs; nothing to cache")

    def present_of(past_name, names, what_side):
        want = past_name.lower().replace("past", "present", 1)
        for nm in names:
            if nm.lower() == want:
                return nm
        raise ValueError(f"{what}: no {what_side} output pairs with {past_name!r} "
                         f"(expected a tensor named {want!r})")

    enc_out_names = list(by_name)
    rep = lambda v: st.run(_batch_repeat, v, nb)  # noqa: E731
    presents = [rep(by_name[present_of(nm, enc_out_names, "encoder_decoder_init")])
                for nm in self_past]
    consts = {nm: rep(by_name[present_of(nm, enc_out_names, "encoder_decoder_init")])
              for nm in cross_past}
    if "emask" in special:
        if enc_mask is None:
            raise ValueError(f"{what}: decoder declares {special['emask']!r} but no "
                             "attention_mask input was given")
        consts[special["emask"]] = rep(enc_mask)
    if "ehid" in special:
        eh = next((v for k, v in by_name.items() if "hidden" in k.lower()), None)
        if eh is None:
            raise ValueError(f"{what}: decoder consumes encoder_hidden_states but the "
                             "encoder subgraph does not emit it")
        consts[special["ehid"]] = rep(eh)
    statics = {special["beam"]: np.asarray([nb], np.int32)} if "beam" in special else {}
    dec_out_names = [vi.name for vi in dec_g.output]
    present_ix = [dec_out_names.index(present_of(nm, dec_out_names, "decoder step"))
                  for nm in self_past]
    dyn = {"logits0": st.run(_last_logits, by_name[logits_name], nb), "presents": presents,
           "consts": [consts[k] for k in consts]}

    dev = st.device
    holders = {dec_in[0]: torch.zeros((bb, 1), dtype=torch.int32, device=dev)}
    holders.update((k, v.clone()) for k, v in consts.items())
    if "pseq" in special:
        holders[special["pseq"]] = torch.zeros((1,), dtype=torch.int32, device=dev)
    for nm, pr in zip(self_past, presents):
        holders[nm] = _pad_to(pr, ml).zero_()
    holders[MASK_FEED] = torch.zeros((bb, ml + 1), dtype=torch.int32, device=dev)
    holders.update(statics)
    tape = _walk_step(ctx, dec_g, holders, tag, self_past=frozenset(self_past))

    def init_mask(d):
        return (torch.arange(ml, device=d["logits0"].device) < s0).to(torch.int32).repeat(bb, 1)

    def step_fn(step, d, tok, slot, key_mask, bufs):
        feeds = [tok[:, None], *d["consts"]]
        if "pseq" in special:
            feeds.append(slot.reshape(1).to(torch.int32))
        feeds += [*bufs, F.pad(key_mask, (0, 1), value=1)]
        outs = step(feeds)
        for j, buf in zip(present_ix, bufs):
            _buf_tail_write_(outs[j], buf, slot)
        return outs[0][:, -1, :].float(), _mark(key_mask, slot)

    return _Front(start, dyn, tape, init_mask, step_fn)


# --------------------------------------------------------- shared front door


def _as_i32(x):
    return x.to(torch.int32)


def _setup(ctx, what, input_ids, max_length, attention_mask, decoder_input_ids=None):
    """Parse the node's scalars and prompt (before beam expansion). Returns
    (decoder, model_type, encoder side, prompt, max_length, eos, pad)."""
    st = ctx.state
    g = ctx.attr("decoder")
    if g is None:
        raise ValueError(f"{what} requires the `decoder` graph attribute")
    model_type = int(ctx.attr("model_type", 0))
    if model_type not in (0, 1, 2):
        raise NotImplementedError(f"{what}: model_type {model_type}")
    ml = static_ints(max_length, f"{what} max_length")[0]
    eos, pad = ctx.attr("eos_token_id"), ctx.attr("pad_token_id")
    if eos is None or pad is None:
        raise ValueError(f"{what} requires eos_token_id and pad_token_id")

    if model_type == 0:
        if ctx.attr("encoder") is not None or ctx.attr("init_decoder") is not None:
            raise NotImplementedError(f"{what}: model_type=0 with encoder/init_decoder "
                                      "subgraphs")
        if decoder_input_ids is not None:
            raise ValueError(f"{what}: decoder_input_ids is a T5/Whisper input")
        if input_ids.dim() != 2:
            raise ValueError(f"{what}: input_ids must be [batch, seq]")
        ids = st.run(_as_i32, input_ids)
        b, s = ids.shape
        # no attention_mask: all ones (JAX's rule, kept on both sides)
        mask = (st.run(torch.ones_like, ids) if attention_mask is None
                else st.run(lambda m: m.to(torch.int32).reshape(b, s), attention_mask))
        prompt, enc = (ids, mask), None
    else:
        enc_g = ctx.attr("encoder")
        if enc_g is None:
            raise NotImplementedError(
                f"{what}: model_type {model_type} requires the `encoder` "
                "(encoder_decoder_init) subgraph; init_decoder-only exports are not "
                "supported")
        feats = st.run(_as_i32, input_ids) if model_type == 1 else input_ids
        b = feats.shape[0]
        if decoder_input_ids is not None:
            start = st.run(lambda t: t.to(torch.int32).reshape(b, -1), decoder_input_ids)
        else:
            sid = ctx.attr("decoder_start_token_id")
            if sid is None:
                raise ValueError(f"{what}: model_type {model_type} needs decoder_input_ids "
                                 "or decoder_start_token_id")
            start = st.to_device(_scope(ctx, "start_ids"),
                                 np.full((b, 1), int(sid), np.int32))
        emask = None if attention_mask is None else st.run(_as_i32, attention_mask)
        s = start.shape[1]
        prompt, enc = (start, None), (enc_g, feats, emask)
    if s >= ml:
        raise ValueError(f"{what}: max_length ({ml}) must exceed the prompt length ({s})")
    return g, model_type, enc, prompt, ml, int(eos), int(pad)


def _make_front(ctx, what, g, model_type, enc, prompt, nb, ml, tag) -> _Front:
    if model_type == 0:
        ids, mask = prompt
        return _gpt_front(ctx, g, what, ids, mask, nb, ml, tag)
    enc_g, feats, emask = enc
    return _encdec_front(ctx, what, enc_g, g, feats, emask, prompt[0], nb, ml, tag)


def _scalar(v, dtype):
    return None if v is None else v.reshape(()).to(dtype)


def _record(ctx, front: _Front, loop: Callable, label: str, args: dict, outs):
    """The whole search as one recorded step (compiler/tracer._SearchStep),
    not run while tracing: on the walk's placeholder inputs its result would
    mean nothing, so zeros of its outputs' (shape, dtype) pairs in `outs`
    (None for an absent one; one pair, one tensor) stand in for it, as a
    while loop's inits do."""
    from ..compiler.tracer import _SearchStep

    st = ctx.state
    s = front.seq_init.shape[1]
    ml = args["ml"]
    args = dict(args, seq_init=front.seq_init, front=front.dyn,
                ks=st.tape.const(torch.arange(ml - s, device=st.device)))

    def zeros(meta):
        return None if meta is None else torch.zeros(meta[0], dtype=meta[1], device=st.device)

    out = tuple(map(zeros, outs))
    out = out[0] if len(out) == 1 else out
    return st.tape.record(_SearchStep(front.tape, loop, label),
                          (args, list(front.tape.captured)), out)


def _dyn_opts(opts: _SearchOpts, a: dict) -> _SearchOpts:
    """The node's tensor-valued options for one replay, from its arguments."""
    return dataclasses.replace(
        opts, min_length=_scalar(a["min_length"], torch.int64),
        rep_penalty=_scalar(a["rep_penalty"], torch.float32),
        length_penalty=(None if "length_penalty" not in a else
                        torch.ones((), device=a["ks"].device) if a["length_penalty"] is None
                        else _scalar(a["length_penalty"], torch.float32)),
        vocab_mask=a["vocab_mask"], prefix_mask=a["prefix_mask"])


# ----------------------------------------------------- greedy and sampling


def _simple_loop(front: _Front, opts: _SearchOpts, pick: Callable) -> Callable:
    """The greedy / sampling loop (one beam): pick(processed scores, k, a) →
    [BB] token ids at select k. A finished row emits pad (the HF/ORT freeze:
    the EOS itself is written, everything after is pad)."""
    ml, s = opts.max_length, opts.prompt_len

    def loop(step, a):
        o = _dyn_opts(opts, a)
        d, ks = a["front"], a["ks"]
        seq_init = a["seq_init"]
        bb = seq_init.shape[0]
        cols = torch.arange(ml, device=seq_init.device)
        seqs = F.pad(seq_init, (0, ml - s), value=opts.pad)
        done = torch.zeros((bb,), dtype=torch.bool, device=seq_init.device)

        def select(logits, seqs, done, p, first, k):
            sc = _process_scores(logits, seqs, p, o, first)
            tok = pick(sc, k, a).to(torch.int32)
            tok = torch.where(done, opts.pad, tok)
            seqs = torch.where(cols[None, :] == p, tok[:, None], seqs)
            return tok, seqs, done | (tok == opts.eos)

        tok, seqs, done = select(d["logits0"], seqs, done, s + ks[0], True, ks[0])
        bufs, key_mask = _bufs(d, ml), front.init_mask(d)
        for k in range(1, ml - s):
            slot = s + ks[k - 1]
            logits, key_mask = front.step_fn(step, d, tok, slot, key_mask, bufs)
            tok, seqs, done = select(logits, seqs, done, slot + 1, False, ks[k])
        return seqs

    return loop


def _seqs_meta(front: _Front, ml: int):
    return [((front.seq_init.shape[0], ml), torch.int32)]


def _search_args(ml, min_length, repetition_penalty, vocab_mask, prefix_vocab_mask) -> dict:
    return {"ml": ml, "min_length": min_length, "rep_penalty": repetition_penalty,
            "vocab_mask": vocab_mask, "prefix_mask": prefix_vocab_mask}


@op("GreedySearch", foldable=False, domain="com.microsoft", static_args=(1,),
    subgraph=True)
def greedy_search(ctx: OpContext, input_ids, max_length, min_length=None,
                  repetition_penalty=None, vocab_mask=None, prefix_vocab_mask=None,
                  attention_mask=None):
    """com.microsoft::GreedySearch: argmax generation, the whole loop one
    recorded step (the module docstring)."""
    g, mt, enc, prompt, ml, eos, pad = _setup(ctx, "GreedySearch", input_ids, max_length,
                                              attention_mask)
    front = _make_front(ctx, "GreedySearch", g, mt, enc, prompt, 1, ml, "greedy")
    opts = _SearchOpts(max_length=ml, prompt_len=front.seq_init.shape[1], eos=eos, pad=pad,
                       ngram=int(ctx.attr("no_repeat_ngram_size", 0)))
    loop = _simple_loop(front, opts, lambda sc, k, a: sc.argmax(-1))
    return _record(ctx, front, loop, "GreedySearch",
                   _search_args(ml, min_length, repetition_penalty, vocab_mask,
                                prefix_vocab_mask), _seqs_meta(front, ml))


M32 = 0xFFFFFFFF


def _mix(x):
    """A 32-bit integer hash (xorshift-multiply rounds) on int64 values in
    [0, 2^32), or on a Python int: multipliers below 2^31 keep every product
    inside int64."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & M32
    x = x ^ (x >> 15)
    x = (x * 0x2C1B3C6D) & M32
    return x ^ (x >> 16)


def _uniforms(seed: int, seed_in, k, shape) -> torch.Tensor:
    """Uniforms in (0, 1) of `shape` [rows, V] for select k: a counter-based
    hash of the attribute seed, the seed input (a device value, or None),
    the step k, the row and the column, in plain integer tensor ops on the
    device (the same on the CPU and the card, captured or not)."""
    dev = k.device
    h = _mix((k.to(torch.int64) + _mix((seed & M32) ^ 0x5EED)) & M32)
    if seed_in is not None:
        h = _mix(h ^ (seed_in.reshape(()).to(torch.int64) & M32))
    rows = _mix(h ^ _mix(torch.arange(shape[0], device=dev, dtype=torch.int64) + 0x9E37))
    cols = _mix(torch.arange(shape[1], device=dev, dtype=torch.int64) + 0x79B9)
    x = _mix(rows[:, None] ^ cols[None, :])
    return ((x >> 8).to(torch.float32) + 0.5) * (2.0 ** -24)


@op("Sampling", foldable=False, domain="com.microsoft", static_args=(1,), subgraph=True)
def sampling(ctx: OpContext, input_ids, max_length, min_length=None, repetition_penalty=None,
             vocab_mask=None, prefix_vocab_mask=None, attention_mask=None,
             presence_mask=None, seed=None):
    """com.microsoft::Sampling: top-p / temperature sampling generation, in
    the HF warper order ORT ports (temperature, penalties, top-p filter).
    The draws are Gumbel-max over `_uniforms`, not ORT's mt19937 nor JAX's
    threefry: rollouts differ from both by design; the processed
    distribution is what the tests pin down."""
    if int(ctx.attr("custom", 0)):
        raise NotImplementedError("Sampling: custom=1 (external sampling function) is not "
                                  "supported")
    if ctx.node is not None and len(ctx.node.output) > 1 and ctx.node.output[1]:
        raise NotImplementedError("Sampling: the filtered_logits output is not supported")
    g, mt, enc, prompt, ml, eos, pad = _setup(ctx, "Sampling", input_ids, max_length,
                                              attention_mask)
    front = _make_front(ctx, "Sampling", g, mt, enc, prompt, 1, ml, "sampling")
    temperature = float(ctx.attr("temperature", 1.0)) or 1.0
    top_p = float(ctx.attr("top_p", 0.0))
    filter_value = float(ctx.attr("filter_value", NEG))
    presence_penalty = float(ctx.attr("presence_penalty", 0.0))
    opts = _SearchOpts(max_length=ml, prompt_len=front.seq_init.shape[1], eos=eos, pad=pad,
                       ngram=int(ctx.attr("no_repeat_ngram_size", 0)),
                       seed=int(ctx.attr("seed", 0)))

    def pick(sc, k, a):
        sc = sc / temperature
        if presence_penalty and a["presence_mask"] is not None:
            sc = sc - presence_penalty * a["presence_mask"].to(sc.dtype)
        if top_p > 0.0:
            srt = torch.sort(sc, dim=-1, descending=True).values
            cum = torch.softmax(srt, dim=-1).cumsum(-1)
            keep = torch.cat([torch.ones_like(cum[:, :1], dtype=torch.bool),
                              cum[:, :-1] < top_p], dim=1)
            thr = torch.where(keep, srt, torch.inf).amin(-1, keepdim=True)
            sc = torch.where(sc >= thr, sc, filter_value)
        u = _uniforms(opts.seed, a["seed"], k, sc.shape)
        return (sc - torch.log(-torch.log(u))).argmax(-1)

    args = _search_args(ml, min_length, repetition_penalty, vocab_mask, prefix_vocab_mask)
    args.update(presence_mask=presence_mask, seed=seed)
    return _record(ctx, front, _simple_loop(front, opts, pick), "Sampling", args,
                   _seqs_meta(front, ml))


# ------------------------------------------------------------- beam search


def _lp_on(v) -> bool:
    """Is the logits_processor input set? A runtime value cannot be read
    while tracing, so it counts as set."""
    if v is None:
        return False
    if isinstance(v, torch.Tensor):
        return True
    return bool(np.any(np.asarray(v)))


def _beam_loop(front: _Front, opts: _SearchOpts, b: int, want_scores: bool) -> Callable:
    """The legacy-HF scorer's loop over [batch, beams] state (module
    docstring): returns (sequences, sequences_scores, the per-step
    processed log-probabilities or None)."""
    ml, s, nb, nret = opts.max_length, opts.prompt_len, opts.nb, opts.nret
    eos, pad = opts.eos, opts.pad
    bb = b * nb

    def loop(step, a):
        o = _dyn_opts(opts, a)
        lp = o.length_penalty
        d, ks = a["front"], a["ks"]
        seq_init = a["seq_init"]
        dev = seq_init.device
        cols = torch.arange(ml, device=dev)
        rank = torch.arange(2 * nb, device=dev)
        beams = torch.arange(nb, device=dev)
        seqs = F.pad(seq_init, (0, ml - s), value=pad)[:, None, :].repeat(1, nb, 1)
        bscore = torch.zeros((b, nb), device=dev)
        bscore[:, 1:] = -1e9  # HF/ORT: only beam 0 is live at the first expansion
        fseq = torch.full((b, nb, ml), pad, dtype=torch.int32, device=dev)
        fsc = torch.full((b, nb), NEG, device=dev)
        done = torch.zeros((b,), dtype=torch.bool, device=dev)

        def take(x, idx):  # take_along_axis over axis 1 of [b, n, ml]
            return torch.gather(x, 1, idx[:, :, None].expand(-1, -1, x.shape[2]))

        def select(logits, state, p, first):
            seqs, bscore, fseq, fsc, done = state
            logp = torch.log_softmax(logits, dim=-1)
            logp = _process_scores(logp, seqs.reshape(bb, ml), p, o, first)
            vocab = logp.shape[-1]
            cand = (bscore[:, :, None] + logp.reshape(b, nb, vocab)).reshape(b, nb * vocab)
            top_sc, top_ix = _top_k(cand, 2 * nb)
            tok = (top_ix % vocab).to(torch.int32)
            parent = top_ix // vocab
            is_eos = tok == eos
            plen = p.to(torch.float32)
            # the finished pool: EOS candidates ranked inside the top nb join with
            # the legacy score sum_logprobs / full_len^penalty (the hypothesis
            # stored without the EOS, its logprob counted)
            add = is_eos & (rank < nb)[None, :] & ~done[:, None]
            cand_f = torch.where(add, top_sc / plen ** lp, NEG)
            at_p = cols[None, None, :] == p
            cand_seq = torch.where(at_p, eos, take(seqs, parent))
            # the old pool first: the stable select keeps the incumbent on a tie
            # (the legacy scorer's strict `score > worst_score` replacement)
            new_fsc, sel = _top_k(torch.cat([fsc, cand_f], 1), nb)
            new_fseq = take(torch.cat([fseq, cand_seq], 1), sel)
            # running beams: the best nb non-EOS continuations, in rank order
            a_sc, aix = _top_k(torch.where(is_eos, NEG, top_sc), nb)
            a_tok = torch.gather(tok, 1, aix)
            a_par = torch.gather(parent, 1, aix)
            new_seqs = torch.where(at_p, a_tok[:, :, None], take(seqs, a_par))
            # done (legacy scorer): a full pool, and early stopping or no running
            # sum that can still beat the worst finished score
            n_fin = (new_fsc > NEG / 2).sum(1)
            done_now = n_fin >= nb
            if not opts.early_stopping:
                done_now = done_now & (new_fsc[:, -1] >= top_sc[:, 0] / plen ** lp)
            keep = done[:, None]
            out_tok = torch.where(keep, pad, a_tok)
            out_par = torch.where(keep, beams[None, :], a_par)
            state = (torch.where(keep[:, :, None], seqs, new_seqs),
                     torch.where(keep, bscore, a_sc),
                     torch.where(keep[:, :, None], fseq, new_fseq),
                     torch.where(keep, fsc, new_fsc),
                     done | done_now)
            flat_par = (torch.arange(b, device=dev)[:, None] * nb + out_par).reshape(bb)
            return out_tok.reshape(bb), flat_par, state, logp.reshape(b, nb, vocab)

        def reorder_(bufs, flat_idx):
            for buf in bufs:  # back into the same buffers: a replay keeps its addresses
                buf.copy_(buf.index_select(buf.dim() - 4, flat_idx))

        state = (seqs, bscore, fseq, fsc, done)
        tok, flat_par, state, logp = select(d["logits0"], state, s + ks[0], True)
        ys = [logp] if want_scores else None
        bufs, key_mask = _bufs(d, ml), front.init_mask(d)
        reorder_(bufs, flat_par)
        for k in range(1, ml - s):
            slot = s + ks[k - 1]
            logits, key_mask = front.step_fn(step, d, tok, slot, key_mask, bufs)
            tok, flat_par, state, logp = select(logits, state, slot + 1, False)
            reorder_(bufs, flat_par)
            if want_scores:
                ys.append(logp)
        seqs, bscore, fseq, fsc, done = state
        # finalize (legacy scorer): a batch that never went done adds all its
        # running beams at full length; the best nret hypotheses win
        alive_f = torch.where(done[:, None], NEG, bscore / float(ml) ** lp)
        fin_sc, sel = _top_k(torch.cat([fsc, alive_f], 1), nb)
        fin_seq = take(torch.cat([fseq, seqs], 1), sel)
        return (fin_seq[:, :nret], fin_sc[:, :nret],
                torch.stack(ys) if want_scores else None)

    return loop


@op("BeamSearch", foldable=False, domain="com.microsoft", static_args=(1, 3, 4, 11),
    subgraph=True)
def beam_search(ctx: OpContext, input_ids, max_length, min_length=None, num_beams=None,
                num_return_sequences=None, length_penalty=None, repetition_penalty=None,
                vocab_mask=None, prefix_vocab_mask=None, attention_mask=None,
                decoder_input_ids=None, logits_processor=None):
    """com.microsoft::BeamSearch: the whole beam search one recorded step (the
    module docstring; the semantics are ORT's legacy-HF scorer, held in the
    tests to an independent torch implementation of it)."""
    if _lp_on(logits_processor):
        raise NotImplementedError("BeamSearch: logits_processor=1 (Whisper timestamp "
                                  "rules) is not supported")
    g, mt, enc, prompt, ml, eos, pad = _setup(ctx, "BeamSearch", input_ids, max_length,
                                              attention_mask,
                                              decoder_input_ids=decoder_input_ids)
    if num_beams is None or num_return_sequences is None:
        raise ValueError("BeamSearch requires num_beams and num_return_sequences")
    nb = static_ints(num_beams, "BeamSearch num_beams")[0]
    nret = static_ints(num_return_sequences, "BeamSearch num_return_sequences")[0]
    if nret > nb:
        raise ValueError(f"BeamSearch: num_return_sequences ({nret}) > num_beams ({nb})")
    n_out = len(ctx.node.output) if ctx.node is not None else 1
    if n_out > 3:
        raise NotImplementedError("BeamSearch: Whisper cross_qk / no_speech_probs outputs "
                                  "are not supported")
    want_scores = n_out > 2 and bool(ctx.node.output[2])
    front = _make_front(ctx, "BeamSearch", g, mt, enc, prompt, nb, ml, "beam")
    b = front.seq_init.shape[0]
    opts = _SearchOpts(max_length=ml, prompt_len=front.seq_init.shape[1], eos=eos, pad=pad,
                       nb=nb, nret=nret, early_stopping=bool(ctx.attr("early_stopping", 0)),
                       ngram=int(ctx.attr("no_repeat_ngram_size", 0)))
    args = _search_args(ml, min_length, repetition_penalty, vocab_mask, prefix_vocab_mask)
    args["length_penalty"] = length_penalty
    vocab = front.dyn["logits0"].shape[-1]
    seqs, scores, ys = _record(
        ctx, front, _beam_loop(front, opts, b, want_scores), "BeamSearch", args,
        (((b, nret, ml), torch.int32), ((b, nret), torch.float32),
         ((ml - opts.prompt_len, b, nb, vocab), torch.float32) if want_scores else None))
    if n_out <= 1:
        return seqs
    outs = [seqs, scores]
    if n_out > 2:
        outs.append(ys if want_scores else
                    ctx.state.to_device(_scope(ctx, "no_scores"), np.zeros((0,), np.float32)))
    return tuple(outs[:n_out])


@op("WhisperBeamSearch", foldable=False, domain="com.microsoft",
    static_args=(1, 3, 4, 11, 14), subgraph=True)
def whisper_beam_search(ctx: OpContext, input_features, max_length, min_length=None,
                        num_beams=None, num_return_sequences=None, length_penalty=None,
                        repetition_penalty=None, vocab_mask=None, prefix_vocab_mask=None,
                        attention_mask=None, decoder_input_ids=None, logits_processor=None,
                        cross_qk_layer_head=None, extra_decoding_ids=None, temperature=None):
    """com.microsoft::WhisperBeamSearch: the node newer ORT Whisper exports
    carry; BeamSearch (model_type 2) with Whisper's extra inputs, the
    unsupported ones refused."""
    if cross_qk_layer_head is not None:
        raise NotImplementedError("WhisperBeamSearch: cross_qk_layer_head (word-level "
                                  "timestamp QK extraction) is not supported")
    if extra_decoding_ids is not None:
        raise NotImplementedError("WhisperBeamSearch: extra_decoding_ids is not supported")
    if temperature is not None:
        t = (np.asarray(temperature).reshape(-1) if not isinstance(temperature, torch.Tensor)
             else None)
        if t is None or not (t.size == 1 and float(t[0]) == 1.0):
            raise NotImplementedError("WhisperBeamSearch: temperature != 1.0 is not "
                                      "supported in beam mode (ORT only uses it for its "
                                      "sampling fork)")
    return beam_search(ctx, input_features, max_length, min_length, num_beams,
                       num_return_sequences, length_penalty, repetition_penalty, vocab_mask,
                       prefix_vocab_mask, attention_mask, decoder_input_ids, logits_processor)


@op("NGramRepeatBlock", foldable=False, domain="com.microsoft")
def ngram_repeat_block(ctx: OpContext, input_ids, scores):
    """com.microsoft::NGramRepeatBlock: the standalone no-repeat-n-gram
    processor (fairseq-lineage exports carry it beside a host search loop).
    Bans token t where the (ngram_size-1)-gram ending at the current
    position already occurred in input_ids followed by t; a banned score
    becomes NEG. The in-search processor's math (`_ngram_ban`), the current
    length being input_ids' static trailing dim."""
    n = int(ctx.attr("ngram_size", 0))
    if n <= 0:
        raise ValueError("NGramRepeatBlock requires ngram_size > 0")
    seqs = input_ids.to(torch.int32)
    return _ngram_ban(scores, seqs, seqs.shape[1], n).to(scores.dtype)
