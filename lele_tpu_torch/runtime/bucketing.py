"""Length bucketing for variable-length audio (the port's copy of what it
needs from lele_tpu/runtime/bucketing.py).

Each audio length pads up to one of a few buckets, so a model sees a small
set of input shapes; the true length travels beside the padded PCM and masks
the padding downstream.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

# powers-of-√2-ish audio buckets in seconds at 16 kHz: ≤29% padding waste
DEFAULT_AUDIO_BUCKETS_S = (1, 2, 3, 5, 7, 10, 15, 20, 30, 45, 60)


def bucket_for(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return int(buckets[-1])


def pad_batch_pow2(n: int, cap: int = 8) -> int:
    """Batch-dimension bucket: the next power of two up to `cap` (a few
    batch shapes for queues that hand every size 1..max_batch), the exact
    size above it (padding 33 to 64 would double the work on dead rows)."""
    if n > cap:
        return n
    p = 1
    while p < n:
        p *= 2
    return p


def max_bucket_samples(
    sr: int = 16000, buckets_s: Sequence[int] = DEFAULT_AUDIO_BUCKETS_S
) -> int:
    return int(buckets_s[-1]) * sr


def pad_pcm(
    pcm: np.ndarray, sr: int = 16000, buckets_s: Sequence[int] = DEFAULT_AUDIO_BUCKETS_S
) -> tuple[np.ndarray, int]:
    """→ (padded_pcm, true_len), zero-padded to the smallest bucket that
    holds it. Audio longer than the largest bucket raises."""
    n = len(pcm)
    limit = max_bucket_samples(sr, buckets_s)
    if n > limit:
        raise ValueError(
            f"audio of {n} samples ({n / sr:.1f}s) exceeds the largest bucket "
            f"({buckets_s[-1]}s); long-form audio needs transcribe_long"
        )
    target = bucket_for(n, [b * sr for b in buckets_s])
    if n == target:
        return np.asarray(pcm, np.float32), n
    out = np.zeros(target, np.float32)
    out[:n] = pcm
    return out, n


def frames_for_samples(n_samples: int, frame_len: int = 400, hop: int = 160) -> int:
    return max(0, (n_samples - frame_len) // hop + 1)


def feat_mask_for(
    true_samples: int, padded_samples: int, frame_len: int = 400, hop: int = 160,
    lfr_n: int = 6,
) -> np.ndarray:
    """[T_lfr_padded] float mask with 1s over the real frames (after LFR)."""
    t_true = -(-frames_for_samples(true_samples, frame_len, hop) // lfr_n)
    t_pad = -(-frames_for_samples(padded_samples, frame_len, hop) // lfr_n)
    m = np.zeros(t_pad, np.float32)
    m[:t_true] = 1.0
    return m
