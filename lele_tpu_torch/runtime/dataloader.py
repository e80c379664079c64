"""Batched audio data loader with background prefetch (the port's copy of
lele_tpu/runtime/dataloader.py): one prefetch thread decodes batch i+1
while the card works on batch i, so audio IO never waits behind the card.

    loader = WavBatchLoader(paths, batch_size=8)
    for batch in loader:            # list of (np.float32 pcm, sr)
        model.transcribe_batch([p for p, _ in batch])

Decoding is the native threaded decoder (runtime/native.py): the files are
read and decoded on a pool of C++ threads with the GIL released, as in the
JAX package.
"""

from __future__ import annotations

import queue
import threading
from pathlib import Path
from typing import Iterator, Sequence

import numpy as np

from .native import get_native


def decode_wav_files(paths: Sequence[str | Path]) -> list[tuple[np.ndarray, int]]:
    """→ [(float32 mono pcm, sample_rate), ...]; ValueError naming the first
    file that does not decode."""
    return [(np.frombuffer(b, np.float32), sr)
            for b, sr in get_native().decode_wav_files([str(p) for p in paths])]


class WavBatchLoader:
    """Iterates `paths` in batches with one-batch-ahead prefetch."""

    def __init__(self, paths: Sequence[str | Path], batch_size: int = 8,
                 prefetch: int = 1):
        self.paths = [str(p) for p in paths]
        self.batch_size = batch_size
        self.prefetch = max(1, prefetch)

    def __len__(self) -> int:
        return -(-len(self.paths) // self.batch_size)

    def __iter__(self) -> Iterator[list[tuple[np.ndarray, int]]]:
        batches = [
            self.paths[i : i + self.batch_size]
            for i in range(0, len(self.paths), self.batch_size)
        ]
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        _SENTINEL = object()
        stop = threading.Event()

        def _put(item) -> bool:
            # bounded put that notices consumer abandonment: a plain
            # q.put() would block FOREVER holding a decoded batch when the
            # caller breaks out of the loop early
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                for b in batches:
                    if not _put(decode_wav_files(b)):
                        return
            except Exception as e:  # raised in the consumer's thread
                _put(e)
                return
            _put(_SENTINEL)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is _SENTINEL:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()  # releases a producer blocked on a full queue
