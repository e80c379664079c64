"""String-tensor emitters (counterpart of lele_tpu/ops/string_ops.py):
StringConcat, StringSplit, StringNormalizer and RegexFullMatch
(TfIdfVectorizer's string mode is in tfidf_ops).

A string tensor has no device representation: these ops run only at trace
time, on numpy object arrays, where their inputs are initializers or
Constants (the preprocessing islands real exports carry, which fold away
into numeric tensors). A string value that reaches a node with a device
input raises NotImplementedError with JAX's hint, and a string graph output
is refused as JAX refuses it (compiler/tracer.py).

RegexFullMatch: the spec pins RE2 syntax; Python's `re` matches the common
constructs alike, accepts back-references (absent in RE2), and refuses RE2's
\\C and unicode-class spellings, as the JAX package does.
"""

from __future__ import annotations

import re

import numpy as np

from .registry import OpContext, op


def _require_fold(ctx: OpContext, name: str) -> None:
    if not ctx.is_fold:
        raise NotImplementedError(
            f"{name} ran against a device value: string tensors exist only at "
            "trace time. Hint: string inputs must be initializers/Constants "
            "(preprocessing islands fold away).")


def _obj(a) -> np.ndarray:
    return np.asarray(a, dtype=object)


@op("StringConcat")
def string_concat(ctx: OpContext, x, y):
    _require_fold(ctx, "StringConcat")
    xb, yb = np.broadcast_arrays(_obj(x), _obj(y))
    out = np.empty(xb.shape, dtype=object)
    flat = out.reshape(-1)
    for i, (a, b) in enumerate(zip(xb.reshape(-1), yb.reshape(-1))):
        flat[i] = str(a) + str(b)
    return out


@op("StringSplit")
def string_split(ctx: OpContext, x):
    """Y [..., max_tokens] padded with "", Z the int64 counts. An explicit
    delimiter keeps the empty strings between delimiters; without one, runs
    of whitespace split and no empty string is kept."""
    _require_fold(ctx, "StringSplit")
    x = _obj(x)
    delim = ctx.attr("delimiter")
    maxsplit = ctx.attr("maxsplit")
    sep = delim if delim else None
    parts = [str(s).split(sep, maxsplit) if maxsplit is not None else str(s).split(sep)
             for s in x.reshape(-1)]
    counts = np.asarray([len(p) for p in parts], dtype=np.int64)
    width = int(counts.max()) if len(counts) else 0
    y = np.empty((len(parts), width), dtype=object)
    y[:] = ""
    for i, p in enumerate(parts):
        y[i, : len(p)] = p
    return y.reshape(*x.shape, width), counts.reshape(x.shape)


@op("StringNormalizer")
def string_normalizer(ctx: OpContext, x):
    """Opset 10: stopword removal, then the case action, over [C] or [1, C];
    an emptied tensor becomes one "" (the spec's shape floor)."""
    _require_fold(ctx, "StringNormalizer")
    x = _obj(x)
    two_d = x.ndim == 2
    if two_d and x.shape[0] != 1:
        raise ValueError(f"StringNormalizer input must be [C] or [1,C], got {x.shape}")
    flat = [str(s) for s in x.reshape(-1)]
    action = ctx.attr("case_change_action", "NONE")
    stop = ctx.attr("stopwords") or []
    if stop:
        if ctx.attr("is_case_sensitive", 0):
            keep = [s for s in flat if s not in set(stop)]
        else:
            low = {s.lower() for s in stop}
            keep = [s for s in flat if s.lower() not in low]
    else:
        keep = flat
    if action == "LOWER":
        keep = [s.lower() for s in keep]
    elif action == "UPPER":
        keep = [s.upper() for s in keep]
    out = np.empty(len(keep) or 1, dtype=object)
    out[:] = keep or [""]
    return out.reshape(1, -1) if two_d else out


@op("RegexFullMatch")
def regex_full_match(ctx: OpContext, x):
    _require_fold(ctx, "RegexFullMatch")
    x = _obj(x)
    pattern = ctx.attr("pattern", "")
    if re.search(r"\\C|\\p\{|\\P\{", pattern):
        raise NotImplementedError("RegexFullMatch: RE2-specific escapes (\\C, \\p{...}) are "
                                  "not supported by this engine")
    rx = re.compile(pattern)
    out = np.empty(x.shape, dtype=bool)
    flat = out.reshape(-1)
    for i, s in enumerate(x.reshape(-1)):
        flat[i] = rx.fullmatch(str(s)) is not None
    return out
