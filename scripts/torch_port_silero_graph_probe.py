#!/usr/bin/env python3
"""Silero's 10 s utterance as one captured Scan / Loop graph, timed in repeats.

    python3 scripts/torch_port_silero_graph_probe.py [--repeats 8] [--sr 16000]

Builds `chip_smoke.silero_utterance_model` (the fixtures/silero.onnx step as
one Scan and as one pure for-loop Loop over 312 chunks), compiles both with
the port's `compile_model` and captures each as one CUDA graph, beside
`SileroOnnx.speech_probs` on the same PCM. Each repeat times, in turns
(Scan, Loop, speech_probs, then the reverse order on odd repeats):
  - the graph's replay by CUDA events (median of 10), which counts the gaps
    between its kernels;
  - the sum of its kernels' device times from one profiled call, and kernel
    6's (lstm_seq) share of it;
  - a call by host clock (median of 20), the output read back;
  - the card's SM clock as nvidia-smi reads it just before.
Then each form's spread over the repeats, which tells a spread in the work
(the kernel sum moves) from one in the gaps (only the events move). Checks
that each form gives speech_probs' bits. Prints the card's name and power
limit. Needs a card; imports no jax.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def sm_clock() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def kernel_sums(fn) -> tuple[float, float]:
    """(all kernels, lstm_seq kernels) device ms of one fn() under torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if cs.dev_time(e) > 0 and e.device_type != DeviceType.CPU]
    total = sum(cs.dev_time(e) for e in rows) / 1e3
    lstm = sum(cs.dev_time(e) for e in rows if "lstm" in e.key.lower()) / 1e3
    return total, lstm


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repeats", type=int, default=8)
    ap.add_argument("--sr", type=int, default=16000)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_port_silero_graph_probe: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from lele_tpu_torch.compiler import compile_model
    from lele_tpu_torch.models import SileroOnnx

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card, dev = cs.card_identity(), torch.device("cuda", 0)
    pcm = cs.vad_pcm(10.0, args.sr, np.random.default_rng(cs.SEED + 34))
    sv = SileroOnnx(cs.SILERO_FIXTURE, device=dev)
    ref = sv.speech_probs(pcm, args.sr)
    chunks = torch.from_numpy(sv._chunks(pcm, None)[:, None]).to(dev)
    inputs = {"chunks": chunks, "state": torch.zeros((2, 1, 128), device=dev)}
    cms = {}
    for form in ("scan", "loop"):
        cm = compile_model(cs.silero_utterance_model(form, chunks.shape[0], args.sr), device=dev)
        cm.compile()
        got = cm(**inputs)[0].cpu().numpy()
        if not np.array_equal(got, ref):
            print(f"{form}: not speech_probs' bits (max|d| {np.abs(got - ref).max():.3e})",
                  file=sys.stderr)
            return 1
        cms[form] = cm
    print(f"Silero {len(ref)} chunks at {args.sr} Hz; Scan and Loop give speech_probs' bits  "
          f"({card})")

    def host(fn, runs=20):
        fn()
        times = []
        for _ in range(runs):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    paths = {
        "scan": (lambda: cms["scan"]._program.graph.replay(),
                 lambda: cms["scan"](**inputs)[0].cpu()),
        "loop": (lambda: cms["loop"]._program.graph.replay(),
                 lambda: cms["loop"](**inputs)[0].cpu()),
        "speech_probs": (lambda: sv.speech_probs(pcm, args.sr),
                         lambda: sv.speech_probs(pcm, args.sr)),
    }
    rows: dict[str, list[tuple[float, float, float, float]]] = {k: [] for k in paths}
    for r in range(args.repeats):
        order = list(paths) if r % 2 == 0 else list(paths)[::-1]
        for name in order:
            device_call, host_call = paths[name]
            clock = sm_clock()
            ev = cs.time_ms(device_call, runs=10)
            total, lstm = kernel_sums(device_call)
            h = host(host_call)
            rows[name].append((ev, total, lstm, h))
            print(f"  repeat {r} {name:>12}: events {ev:.3f} ms, kernel sum {total:.3f} ms "
                  f"(lstm_seq {lstm:.3f}), host clock {h:.3f} ms; SM clock before {clock}")
    print(f"over {args.repeats} repeats, min / median / max (ms)  ({card}):")
    for name, vals in rows.items():
        cols = list(zip(*vals))
        stats = ["/".join(f"{f(c):.3f}" for f in (min, statistics.median, max)) for c in cols]
        print(f"  {name:>12}: events {stats[0]}, kernel sum {stats[1]}, lstm_seq {stats[2]}, "
              f"host clock {stats[3]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
