#!/usr/bin/env python3
"""Every route of the port's HTTP daemon at once, on one card.

    python3 scripts/torch_port_mixed_traffic.py [PACKAGE_ROOT] [ROUNDS]

Serves `lele_tpu_torch.server.build_engines()` (the JAX package's
full-width configurations, random weights from seed 0) of the package under
PACKAGE_ROOT (by default this checkout; another checkout, such as a parent
commit unpacked by `git archive`, to compare two versions) on 127.0.0.1,
and runs ROUNDS (default 3) rounds of `chip_smoke.mixed_traffic` from this
checkout against it: 8 /recognize, 2 /recognize_batch, 2 /detect and 4
/synthesize in flight together, each answer then held to the engine called
directly (bits). Round 0 also captures each new bucket's program while the
other requests are in flight. Prints each round's disagreements and, last,
one JSON line {"root", "bad_per_round"}.
"""

import importlib.util
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def main() -> int:
    root = Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else HERE
    rounds = int(sys.argv[2]) if len(sys.argv) > 2 else 3
    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location("chip_smoke_here", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import torch

    import lele_tpu_torch
    from lele_tpu_torch.server import build_engines

    if not torch.cuda.is_available():
        print("torch_port_mixed_traffic: no CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"package {Path(lele_tpu_torch.__file__).parent}")
    t0 = time.perf_counter()
    srv = cs.Served(build_engines(device="cuda"))
    print(f"engines built in {time.perf_counter() - t0:.1f} s")
    counts = []
    try:
        for r in range(rounds):
            t0 = time.perf_counter()
            try:
                bad, asr_sizes, det_sizes = cs.mixed_traffic(
                    srv.url, srv.engines, srv.batches, srv.det_batches, cs.SEED + 385 + r)
            except Exception as e:  # a direct call that fails after a broken round
                bad, asr_sizes, det_sizes = [f"raised {type(e).__name__}: {e}"], [], []
            print(f"round {r}: {len(bad)} disagreements in {time.perf_counter() - t0:.2f} s; "
                  f"ASR batches {asr_sizes}, detection {det_sizes}")
            for b in bad:
                print(f"    {b[:400]}")
            counts.append(len(bad))
    finally:
        srv.close()
    print(json.dumps({"root": str(root), "bad_per_round": counts}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
