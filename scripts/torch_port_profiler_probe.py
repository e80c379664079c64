#!/usr/bin/env python3
"""What torch.profiler costs on one card, with and without CPU-side tracing.

    python3 scripts/torch_port_profiler_probe.py [LAUNCHES]

Runs LAUNCHES (default 20,000) small elementwise kernels in one call and
profiles that call twice: with CPU and CUDA activity, then with CUDA
activity alone. For each it prints the device rows' kernel count and device
time, the host span of the call, the seconds the profile took to close and
`key_averages()` took, so the two traces can be held to the same device
rows; and the seconds `chip_smoke.device_rows` took to sum the same rows
from the raw trace, and whether its rows are key_averages()'s (the same
names and counts, device times within 1e-9 relative). Prints the card's
name and power limit first.
"""

import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from chip_smoke import device_rows  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 20000
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
          .stdout.strip())
    x = torch.randn(256, 256, device="cuda")

    def call():
        y = x
        for _ in range(n // 2):  # a multiply and an add each
            y = y * 1.0001 + 0.5
        torch.cuda.synchronize()

    call()
    for acts in ([ProfilerActivity.CPU, ProfilerActivity.CUDA], [ProfilerActivity.CUDA]):
        t0 = time.perf_counter()
        with profile(activities=acts) as prof:
            t1 = time.perf_counter()
            call()
            span = time.perf_counter() - t1
        t2 = time.perf_counter()
        rows = [e for e in prof.key_averages() if e.device_type != DeviceType.CPU
                and (getattr(e, "self_device_time_total", 0) or 0) > 0]
        t3 = time.perf_counter()
        raw = device_rows(prof)
        t4 = time.perf_counter()
        same = (set(raw) == {e.key for e in rows}
                and all(raw[e.key][1] == e.count
                        and abs(raw[e.key][0] - e.self_device_time_total)
                        <= 1e-9 * e.self_device_time_total for e in rows))
        print(f"{'+'.join(a.name for a in acts)}: {sum(e.count for e in rows)} kernels, device "
              f"{sum(e.self_device_time_total for e in rows) / 1e3:.2f} ms, span "
              f"{span * 1e3:.2f} ms; the profile closed in {t2 - t0:.2f} s, key_averages "
              f"{t3 - t2:.2f} s; device_rows {t4 - t3:.3f} s, the same rows: {same}", flush=True)
        if not same and acts == [ProfilerActivity.CUDA]:  # chip_smoke's traces
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
