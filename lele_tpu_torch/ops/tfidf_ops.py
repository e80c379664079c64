"""TfIdfVectorizer (opset 9; counterpart of lele_tpu/ops/tfidf_ops.py):
n-gram counts over int64 or string tokens.

The pool's section j holds the grams of length j + 1 (`ngram_counts` gives
the sections' starts); only lengths in [min_gram_length, max_gram_length]
count; skips apply to n >= 2 (a skipped unigram is the same unigram), each
skip in 0..max_skip_count counting on its own; mode TF gives the counts,
IDF weights · [count > 0], TFIDF weights · counts (weights 1 by default).

The int mode runs on the device: each (gram length, skip) slices the input
into strided windows (`unfold`) and compares them with the whole section in
one broadcast equality. The pool and the output columns are constants of
the trace, hoisted once (a recording emitter), so a call uploads nothing.
The string mode maps tokens to pool ids at trace time and folds (strings
exist only there: string_ops).
"""

from __future__ import annotations

import numpy as np
import torch

from .registry import OpContext, host_const, op, run_step


def _sections(ctx: OpContext, pool_len: int):
    """(section's first pool index, gram length, its count of grams, its
    first output column's place in ngram_indexes) of each counted section."""
    starts = list(ctx.attr_ints("ngram_counts", []))
    min_n = int(ctx.attr("min_gram_length", 1))
    max_n = int(ctx.attr("max_gram_length", 1))
    out, pos = [], 0
    for sec, start in enumerate(starts):
        n = sec + 1
        end = starts[sec + 1] if sec + 1 < len(starts) else pool_len
        n_grams = (end - start) // n
        if n_grams > 0 and min_n <= n <= max_n:
            out.append((start, n, n_grams, pos))
        pos += max(n_grams, 0)
    return out


def _count_np(x: np.ndarray, grams: np.ndarray, stride: int) -> np.ndarray:
    """x [N, C] ints, grams [G, n] → how often each gram occurs [N, G]."""
    n, c = grams.shape[1], x.shape[1]
    span = (n - 1) * stride + 1
    if span > c:
        return np.zeros((x.shape[0], grams.shape[0]), np.int32)
    idx = np.arange(c - span + 1)[:, None] + np.arange(n)[None, :] * stride
    eq = x[:, idx][:, :, None, :] == grams[None, None]
    return eq.all(-1).sum(1).astype(np.int32)


def _count(x: torch.Tensor, grams: torch.Tensor, stride: int) -> torch.Tensor:
    n, c = grams.shape[1], x.shape[1]
    span = (n - 1) * stride + 1
    if span > c:
        return torch.zeros((x.shape[0], grams.shape[0]), dtype=torch.float32,
                           device=x.device)
    win = x.unfold(1, span, 1)[..., ::stride]  # [N, W, n]
    eq = win[:, :, None, :] == grams[None, None]
    return eq.all(-1).sum(1).to(torch.float32)


def _tfidf(x: torch.Tensor, sections: list, n_cols: int, mode: str, wvec, one_d: bool):
    x = x.long()
    if one_d:
        x = x.unsqueeze(0)
    counts = torch.zeros((x.shape[0], n_cols), dtype=torch.float32, device=x.device)
    for grams, cols, skips in sections:
        sec = sum(_count(x, grams, s + 1) for s in range(skips))
        counts.index_add_(1, cols, sec)
    out = _weigh(counts, mode, wvec)
    return out[0] if one_d else out


def _weigh(counts, mode: str, wvec):
    if mode == "TF":
        return counts
    if mode == "IDF":
        present = (counts > 0).astype(np.float32) if isinstance(counts, np.ndarray) \
            else (counts > 0).to(torch.float32)
        return present * wvec if wvec is not None else present
    if mode == "TFIDF":
        return counts * wvec if wvec is not None else counts
    raise ValueError(f"TfIdfVectorizer: unknown mode {mode!r}")


@op("TfIdfVectorizer", records=True)  # foldable: the string mode must fold
def tfidf_vectorizer(ctx: OpContext, x):
    mode = ctx.attr("mode", "TF")
    max_skip = int(ctx.attr("max_skip_count", 0))
    out_idx = np.asarray(ctx.attr_ints("ngram_indexes", []), dtype=np.int64)
    pool_i, pool_s = ctx.attr("pool_int64s"), ctx.attr("pool_strings")
    weights = ctx.attr("weights")
    n_cols = int(out_idx.max()) + 1 if out_idx.size else 0
    wvec = None
    if weights is not None:
        wvec = np.zeros((n_cols,), np.float32)
        wvec[out_idx] = np.asarray(weights, dtype=np.float32)

    if pool_s is not None and pool_i is None:  # the string mode: trace time only
        if not ctx.is_fold:
            raise NotImplementedError(
                "TfIdfVectorizer(pool_strings) needs trace-time string input "
                "(strings exist only at trace time)")
        vocab: dict[str, int] = {}
        pool = np.asarray([vocab.setdefault(s, len(vocab)) for s in pool_s], np.int64)
        xa = np.asarray(x, dtype=object)
        x = np.asarray([[vocab.get(str(t), -1) for t in row]
                        for row in (xa[None, :] if xa.ndim == 1 else xa)], dtype=np.int64)
        one_d = xa.ndim == 1
    else:
        pool = np.asarray(pool_i, dtype=np.int64)
        one_d = np.ndim(x) == 1
    secs = [(pool[start:start + n * g].reshape(g, n), out_idx[pos:pos + g],
             1 if n == 1 else max_skip + 1) for start, n, g, pos in _sections(ctx, len(pool))]

    if ctx.is_fold:
        xi = np.asarray(x).astype(np.int64)
        xi = xi[None, :] if xi.ndim == 1 else xi
        counts = np.zeros((xi.shape[0], n_cols), np.float32)
        for grams, cols, skips in secs:
            sec = sum(_count_np(xi, grams, s + 1) for s in range(skips))
            np.add.at(counts, (slice(None), cols), sec.astype(np.float32))
        out = _weigh(counts, mode, wvec)
        return out[0] if one_d else out
    sections = [(host_const(ctx, f"grams{i}", grams), host_const(ctx, f"cols{i}", cols), skips)
                for i, (grams, cols, skips) in enumerate(secs)]
    w = host_const(ctx, "weights", wvec) if wvec is not None else None
    return run_step(ctx, _tfidf, x, sections, n_cols, mode, w, one_d)
