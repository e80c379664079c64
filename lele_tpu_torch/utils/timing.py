"""Stage timing utilities (the port's copy of lele_tpu/utils/timing.py):
`ScopeTimer` for the labelled host wall-time breakdown the runners print,
`bench_stats` for a summary of timings, and `profile_trace`, a
torch.profiler context that writes a Chrome trace of the host and the card.
"""

from __future__ import annotations

import os
import tempfile
import time
from collections import OrderedDict
from contextlib import contextmanager

import numpy as np


class ScopeTimer:
    """Accumulates labeled wall-time; print_scope() dumps the breakdown."""

    def __init__(self):
        self.acc: OrderedDict[str, float] = OrderedDict()

    @contextmanager
    def scope(self, label: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.acc[label] = self.acc.get(label, 0.0) + time.perf_counter() - t0

    def print_scope(self, prefix: str = "[STAGE]"):
        total = sum(self.acc.values())
        for label, t in self.acc.items():
            pct = 100.0 * t / total if total else 0.0
            print(f"{prefix} {label}: {t * 1000:.2f} ms ({pct:.1f}%)")
        print(f"{prefix} total: {total * 1000:.2f} ms")


def bench_stats(times_s: list[float]) -> dict:
    """p50/mean/std/min/max summary."""
    a = np.asarray(times_s)
    return {
        "mean": float(a.mean()),
        "p50": float(np.median(a)),
        "std": float(a.std()),
        "min": float(a.min()),
        "max": float(a.max()),
    }


@contextmanager
def profile_trace(path: str | None = None):
    """torch.profiler over the block (the card's activity too, where there
    is one); writes a Chrome trace to `path` (by default
    lele_tpu_torch_trace.json in the temp directory) and yields the
    profiler, whose `key_averages()` gives the op-level times."""
    from torch.profiler import ProfilerActivity, profile

    import torch

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(path or os.path.join(tempfile.gettempdir(),
                                                  "lele_tpu_torch_trace.json"))
