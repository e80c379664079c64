#!/usr/bin/env python3
"""/recognize latency of the port's HTTP daemon against its listen backlog,
on one card.

    python3 scripts/torch_port_serve_latency.py [BACKLOG ...]

Builds the main path's ASR engine as `chip_smoke.py` phase 38 does (w8a16
SenseVoice at full width, random weights from chip_smoke's seed; kernels 1
and 2) and, for each BACKLOG in turn (default 64 5 5 64: the daemon's
backlog and socketserver's, the JAX server's), serves it from a
`DaemonServer` listening with that backlog, through a fresh MicroBatcher (8
requests, 5 ms), and runs `chip_smoke.latency_runs`: ENTRY_REQUESTS
/recognize requests at each of 1, 4 and 8 concurrent clients, p50 / p90 /
max by host clock over all of them and requests/s over the whole window.
Prints the card's name and power limit, each run, and one JSON line last.
"""

import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent


def main() -> int:
    sys.path.insert(0, str(HERE))
    spec = importlib.util.spec_from_file_location("chip_smoke_here", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import torch

    if not torch.cuda.is_available():
        print("torch_port_serve_latency: no CUDA card", file=sys.stderr)
        return 1
    from lele_tpu_torch import server
    from lele_tpu_torch.kernels import _build
    from lele_tpu_torch.models import (SenseVoiceConfig, SenseVoiceModel, cast_big_params,
                                       prepare_w8_params, stack_layer_params)
    from lele_tpu_torch.runtime.batcher import MicroBatcher
    from lele_tpu_torch.serving import SenseVoiceEngine

    backlogs = [int(a) for a in sys.argv[1:]] or [64, 5, 5, 64]
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_identity()
    _build.build()
    dev = torch.device("cuda", 0)
    model = SenseVoiceModel(SenseVoiceConfig(weight_int8=True), device=dev)
    model.init(cs.SEED)
    model.params = stack_layer_params(prepare_w8_params(cast_big_params(model.params,
                                                                        torch.bfloat16)))
    asr = SenseVoiceEngine(model=model)
    runs = []
    for backlog in backlogs:
        server.DaemonServer.request_queue_size = backlog
        srv = cs.Served({"asr": asr, "asr_batcher": MicroBatcher(asr.recognize_batch, 8, 5.0)})
        try:
            print(f"backlog {backlog}:")
            stats = cs.latency_runs(srv, card)
        finally:
            srv.close()
        runs.append({"backlog": backlog, "clients": stats})
    print(json.dumps({"card": card, "runs": runs}))
    return 0 if all(s["ok"] for r in runs for s in r["clients"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
