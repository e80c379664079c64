"""Micro-batching request queue for serving (the port's copy of
lele_tpu/runtime/batcher.py): concurrent requests that arrive within a
short window coalesce into ONE batched program on the card, so k requests
cost about one request's latency instead of k serialized calls.

Used by server.py: /recognize routes through a MicroBatcher wrapping
`SenseVoiceEngine.recognize_batch`, /detect through one wrapping
`Yolo26Engine.detect_batch`.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Sequence


@dataclass
class _Pending:
    item: Any
    event: threading.Event = field(default_factory=threading.Event)
    result: Any = None
    error: BaseException | None = None


class MicroBatcher:
    """Collects submissions for up to `window_ms` (or until `max_batch`),
    runs `process_batch(items) -> results` on the collector thread, and
    wakes the submitters. `submit` blocks the calling thread until its
    result is ready — the natural shape for thread-per-request HTTP
    servers (server.py uses ThreadingHTTPServer)."""

    def __init__(self, process_batch: Callable[[Sequence[Any]], Sequence[Any]],
                 max_batch: int = 8, window_ms: float = 5.0):
        self.process_batch = process_batch
        self.max_batch = max_batch
        self.window_s = window_ms / 1e3
        self._lock = threading.Condition()
        self._queue: list[_Pending] = []
        self._worker: threading.Thread | None = None
        self._closed = False
        self.batch_sizes: list[int] = []  # observability: size per flush

    def submit(self, item) -> Any:
        p = _Pending(item)
        with self._lock:
            if self._closed:
                raise RuntimeError("batcher closed")
            self._queue.append(p)
            if self._worker is None or not self._worker.is_alive():
                self._worker = threading.Thread(target=self._run, daemon=True)
                self._worker.start()
            self._lock.notify_all()
        p.event.wait()
        if p.error is not None:
            raise p.error
        return p.result

    def _run(self):
        while True:
            with self._lock:
                if not self._queue:
                    # linger one window for stragglers, then retire. Two
                    # races to close: (a) a timed-out wait() can lose to a
                    # submit() that already enqueued — re-check the queue;
                    # (b) submit() trusts is_alive(), which stays True for
                    # a few instructions after this return — clear
                    # self._worker UNDER THE LOCK first so the next
                    # submit() spawns a replacement
                    timed_out = not self._lock.wait(timeout=self.window_s)
                    if timed_out and not self._queue:
                        self._worker = None
                        return
                    continue
                # window: let the batch fill up to max_batch, bounded by an
                # ABSOLUTE deadline (a per-wait timeout would let a trickle
                # of stragglers extend the window forever)
                end = time.monotonic() + self.window_s
                while len(self._queue) < self.max_batch:
                    remaining = end - time.monotonic()
                    if remaining <= 0:
                        break
                    self._lock.wait(timeout=remaining)
                batch = self._queue[: self.max_batch]
                del self._queue[: self.max_batch]
            self.batch_sizes.append(len(batch))
            try:
                results = self.process_batch([p.item for p in batch])
                if len(results) != len(batch):
                    raise RuntimeError(
                        f"process_batch returned {len(results)} results "
                        f"for {len(batch)} items")
                for p, r in zip(batch, results):
                    p.result = r
            except BaseException as e:  # handed to every waiter, raised there
                for p in batch:
                    p.error = e
            finally:
                for p in batch:
                    p.event.set()

    def close(self):
        with self._lock:
            self._closed = True
            self._lock.notify_all()
