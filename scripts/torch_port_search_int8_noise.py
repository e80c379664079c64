#!/usr/bin/env python3
"""How far the int8 GPT-2-small BeamSearch export (chip_smoke phase 40 (a))
moves under a last-bit change, on one card, for several weight scales.

    python3 scripts/torch_port_search_int8_noise.py [--f32] [--draws N] [SCHEME ...]

Every linear of the int8 decoder quantizes its input with ONNX
DynamicQuantizeLinear against the input's global min/max, so two f32
implementations that differ in the last bit of one activation can put it on
neighbouring codes, and twelve layers and the beam search carry the step on.
For each scheme the script builds phase 40's export (chip_smoke's params,
prompts and search settings) with the embedding (tied to the head) rescaled,
runs it on the CPU and on the card, and prints:

- the card against the CPU: ids equal per prompt, the largest relative
  difference of the returned scores, and the CPU's top-2 margin per prompt
  (the relative gap between its two returned scores);
- the card against itself with the hoisted embedding 1e-7 (relative) away,
  N draws (default 4): ids equal per prompt and the scores' relative change.

Schemes: `std<s>` draws the embedding at standard deviation s (GPT-2's init
is 0.02, the default `std0.02`); `tail<t>` multiplies each embedding row of
the std-0.02 draw by exp(t z), z standard normal (heavy-tailed row norms).
With --f32 the same search over the f32 decoder is measured too. Weights are
random, from chip_smoke's seed; nothing is downloaded.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def scheme_params(scheme: str) -> dict:
    import chip_smoke as cs

    p = cs.gpt2_search_params()
    if scheme.startswith("std"):
        p["wte"] = p["wte"] * np.float32(float(scheme[3:]) / 0.02)
    elif scheme.startswith("tail"):
        z = np.random.default_rng(cs.SEARCH_SEED + 99).standard_normal((p["wte"].shape[0], 1))
        p["wte"] = p["wte"] * np.exp(float(scheme[4:]) * z).astype(np.float32)
    else:
        raise SystemExit(f"unknown scheme {scheme!r}: std<s> or tail<t>")
    p["lm_w"] = np.ascontiguousarray(p["wte"].T)
    return p


def measure(label: str, bs: bytes, bind: dict, draws: int) -> None:
    import torch

    import chip_smoke as cs
    from lele_tpu_torch.compiler import compile_model
    from lele_tpu_torch.onnx import OnnxModel, bind_inputs

    t0 = time.perf_counter()
    ids, mask = cs.search_prompts(cs.GPT2["vocab"])
    feeds = {"input_ids": ids, "attention_mask": mask}
    model = bind_inputs(OnnxModel.from_bytes(bs), bind)
    rseq, rsc = compile_model(model, device="cpu", strict=True).run_np(**feeds)
    cm = compile_model(model, device="cuda", strict=True)
    tf = {k: torch.from_numpy(v).cuda() for k, v in feeds.items()}
    seq, sc = (o.cpu().numpy() for o in cm.replay(**tf))

    def same(a, b):
        return [bool(np.array_equal(a[r], b[r])) for r in range(a.shape[0])]

    def rel(a, b):
        return (np.abs(a - b) / np.abs(b)).max(1).tolist()

    margin = (np.abs(rsc[:, 0] - rsc[:, 1]) / np.abs(rsc[:, 0])).tolist()
    print(f"{label}: CPU scores {rsc.tolist()}, the CPU's top-2 margin {margin}; the card "
          f"against the CPU: ids equal {same(seq, rseq)}, scores rel|d| {rel(sc, rsc)} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    wte = next(t for name, t in cm.params.items() if name.endswith("/wte"))
    orig = wte.clone()
    gen = torch.Generator(device="cuda")
    for k in range(draws):
        gen.manual_seed(k)
        with torch.inference_mode():  # the params are inference tensors
            wte.copy_(orig * (1 + 1e-7 * torch.randn(orig.shape, generator=gen, device="cuda")))
        s2, c2 = (o.cpu().numpy() for o in cm.replay(**tf))
        print(f"    the card, embedding 1e-7 away (draw {k}): ids equal {same(s2, seq)}, "
              f"scores rel|d| {rel(c2, sc)}", flush=True)


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("schemes", nargs="*", default=["std0.02"])
    ap.add_argument("--f32", action="store_true", help="also the search over the f32 decoder")
    ap.add_argument("--draws", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_port_search_int8_noise: no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 products, as chip_smoke runs them
    print(cs.card_identity())
    for scheme in args.schemes:
        beam, f32_beam, _, binds = cs.gpt2_search_models(scheme_params(scheme))
        measure(f"{scheme} int8", beam, binds["beam"], args.draws)
        del beam
        if args.f32:
            measure(f"{scheme} f32", f32_beam, binds["beam"], args.draws)
    return 0


if __name__ == "__main__":
    sys.exit(main())
