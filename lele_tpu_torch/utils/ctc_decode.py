"""CTC decoders (the port's copy of lele_tpu/utils/ctc_decode.py): prefix
beam search over host-side numpy, as in JAX; greedy decoding is
`models.sensevoice.greedy_ctc_decode`.

Prefix beam search merges the probability of every alignment of each
prefix; with beam_size=1 and peaked posteriors it coincides with greedy.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

NEG_INF = -np.inf


def _logsumexp2(a: float, b: float) -> float:
    if a == NEG_INF:
        return b
    if b == NEG_INF:
        return a
    m = max(a, b)
    return m + np.log(np.exp(a - m) + np.exp(b - m))


def ctc_prefix_beam_search(logits: np.ndarray, beam_size: int = 8, blank_id: int = 0,
                           topk_per_frame: int = 16) -> list[tuple[list[int], float]]:
    """logits [T, V] (unnormalised, host numpy) → [(token ids, log prob)],
    best first."""
    logits = np.asarray(logits)
    logp = logits - logits.max(-1, keepdims=True)
    logp = logp - np.log(np.exp(logp).sum(-1, keepdims=True))
    T, V = logp.shape
    k = min(topk_per_frame, V)

    # beams: prefix → [log P(prefix ending in blank), log P(... in non-blank)]
    beams: dict[tuple, list[float]] = {(): [0.0, NEG_INF]}
    for t in range(T):
        frame = logp[t]
        cand = np.argpartition(frame, -k)[-k:]
        next_beams: dict[tuple, list[float]] = defaultdict(lambda: [NEG_INF, NEG_INF])
        for prefix, (pb, pnb) in beams.items():
            p_total = _logsumexp2(pb, pnb)
            for c in cand:
                c = int(c)
                p = float(frame[c])
                if c == blank_id:
                    nb = next_beams[prefix]
                    nb[0] = _logsumexp2(nb[0], p_total + p)
                elif prefix and c == prefix[-1]:
                    # a repeat extends the blank-ending mass only; the
                    # non-blank-ending mass collapses into the same prefix
                    nb = next_beams[prefix]
                    nb[1] = _logsumexp2(nb[1], pnb + p)
                    ext = next_beams[prefix + (c,)]
                    ext[1] = _logsumexp2(ext[1], pb + p)
                else:
                    ext = next_beams[prefix + (c,)]
                    ext[1] = _logsumexp2(ext[1], p_total + p)
        scored = sorted(next_beams.items(),
                        key=lambda kv: -_logsumexp2(kv[1][0], kv[1][1]))[:beam_size]
        beams = dict(scored)
    out = [(list(prefix), _logsumexp2(pb, pnb)) for prefix, (pb, pnb) in beams.items()]
    out.sort(key=lambda kv: -kv[1])
    return out


def ctc_beam_decode(logits: np.ndarray, beam_size: int = 8, blank_id: int = 0) -> list[int]:
    """The best beam's token ids."""
    return ctc_prefix_beam_search(logits, beam_size, blank_id)[0][0]
