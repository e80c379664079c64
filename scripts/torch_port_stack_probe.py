#!/usr/bin/env python3
"""Time the persistent stacks (kernels 1, 8, 4 and 10) and the kernels beside
them on one card, and probe the cost of a grid barrier (their floor).

    python3 scripts/torch_port_stack_probe.py [--parts barrier,stacks,rows,forward,dql_est,est]

- barrier: one launch of csrc/sanm_stack.cu's probe kernel doing n grid
  barriers (cooperative groups' `grid.sync()`), launched through
  `cudaLaunchCooperativeKernel` and through `cudaLaunchKernelEx` with the
  cooperative attribute, at 132 CTAs, 264 and the most that can be
  co-resident; the cost of a barrier is the slope between n = 16 and
  n = 1,040, by CUDA events, eagerly and replayed from a CUDA graph
  (whether stream capture takes the launch is printed);
- stacks: `sanm_stack_w8` and `sanm_stack_w4` (kernels 1 and 8: 50 layers at
  d512, 4 heads, ffn 2048, FSMN 11, random weights from a seed) at T = 21,
  87 (76 valid rows), 171, 196 and 1,004 (the 60 s bucket), each with the
  kernel's own per-phase split (`sanm_block.stack_phase_us`: the global
  timer after each grid barrier) and, at T = 171, the stamps inside CTA 0's
  first item of each of layer 1's phases;
- rows: `sanm_layer_w8` (kernel 3) at T = 171 and `lstm_seq` (kernel 6) at
  S = 1,875 and 18,750, H = 128 (kernels 4 and 10 are dql_est's);
- forward: `SenseVoiceModel.forward_fn()` on 10 s of audio, w8a16 and w4a16;
- dql_est: `sanm_stack_dql` (kernel 4, 50 layers) at the compiled path's
  buckets, T = 36, 100 and 196 (171 valid), and the ragged 100 with 76
  valid; `estimator_blocks` (kernel 10, 8 blocks) at (T, Tk) = (1,024, 320)
  and (512, 160), and at the TTS requests' buckets (256, 320), (128, 96),
  (64, 96) (`--parts est` runs kernel 10's half alone); each with one
  call's device time split by kernel name (one profiler trace of one call)
  and, for kernel 4, its own phase timer's split
  (`sanm_block.dql_phase_us`).

Each is timed by CUDA events around the call (median of 20 warm runs), by
torch.profiler (the device's own time a call; "not measured" where no trace
came back whole) and as 20 calls in one CUDA graph (chip_smoke.graph_us).
It prints the card's name and power limit beside every time.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

STACK_T = ((21, 21), (87, 76), (171, 171), (196, 196), (1004, 1004))  # (T, valid)
BARRIERS = (16, 1040)


def timed(cs, label, fn, card, graph_n=20, runs=20):
    """Print events, profiler and graph times of fn() (which may fail to
    capture: then the graph time is not measured)."""
    ev = cs.time_ms(fn, runs=runs)
    d = cs.device_us(fn, n=min(graph_n, 20))
    dev_us = None if d is None else sum(d.values())
    try:
        g = f"{cs.graph_us(fn, n=graph_n, reps=10 if graph_n >= 20 else 3):.2f} us"
    except RuntimeError as e:
        g = f"not measured (capture: {str(e).splitlines()[0][:100]})"
    print(f"  {label}: events {ev:.4f} ms; device by the profiler {cs.fmt_us(dev_us)}; "
          f"in a CUDA graph {g}  ({card})")


def barrier_part(card):
    import ctypes

    import torch

    import chip_smoke as cs
    from lele_tpu_torch.kernels import _build

    P, I = _build.P, _build.I
    probe = _build.bind("sanm_stack", "sanm_stack_barrier_probe", [I, I, I, P, P])
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    most = ctypes.c_int(0)
    _build.check("sanm_stack", "barrier_probe", probe(0, 1, 0, ctypes.byref(most), stream()))
    names = {0: "cudaLaunchCooperativeKernel", 1: "cudaLaunchKernelEx cooperative"}
    print(f"== barrier probe (cooperative groups' grid.sync): at most {most.value} "
          "co-resident CTAs of 128 threads")
    for mode, name in names.items():
        for grid in sorted({132, 264, most.value}):
            if grid > most.value:
                continue
            t, tg = {}, {}
            for n in BARRIERS:
                def call(n=n):
                    _build.check("sanm_stack", "barrier_probe",
                                 probe(n, grid, mode, None, stream()))
                t[n] = cs.time_ms(call)
                try:
                    tg[n] = cs.graph_us(call, n=5, reps=5)
                except RuntimeError as e:
                    tg[n] = str(e).splitlines()[0][:100]
            slope = (t[BARRIERS[1]] - t[BARRIERS[0]]) * 1e3 / (BARRIERS[1] - BARRIERS[0])
            if all(isinstance(v, float) for v in tg.values()):
                gs = (tg[BARRIERS[1]] - tg[BARRIERS[0]]) / (BARRIERS[1] - BARRIERS[0])
                graph = (f"in a CUDA graph {gs:.3f} us a barrier ({tg[BARRIERS[0]]:.2f} us "
                         f"for {BARRIERS[0]})")
            else:
                graph = f"no CUDA graph: {tg}"
            print(f"  {name}, {grid} CTAs: {slope:.3f} us a barrier by events "
                  f"({t[BARRIERS[0]] * 1e3:.2f} us for {BARRIERS[0]}); {graph}  ({card})")


def stack_models(dev):
    import torch

    from lele_tpu_torch.models import (
        SenseVoiceConfig,
        SenseVoiceModel,
        cast_big_params,
        prepare_w4_params,
        prepare_w8_params,
        stack_layer_params,
    )

    out = {}
    for flag, prep in (("weight_int8", prepare_w8_params), ("weight_int4", prepare_w4_params)):
        m = SenseVoiceModel(SenseVoiceConfig(**{flag: True}), device=dev)
        m.init(0)
        m.params = stack_layer_params(prep(cast_big_params(m.params, torch.bfloat16)))
        out[flag] = m
    return out


def stacks_part(card, dev, gen, models):
    import torch

    import chip_smoke as cs
    from lele_tpu_torch import kernels as K
    from lele_tpu_torch.kernels import sanm_block

    print("== stacks (50 layers, d512, 4 heads, ffn 2048, FSMN 11)")
    for flag, fn in (("weight_int8", K.sanm_stack_w8), ("weight_int4", K.sanm_stack_w4)):
        st = models[flag].params["layers_stacked"]
        for T, valid in STACK_T:
            x = torch.randn((T, 512), generator=gen, device=dev) * 0.5
            mask = torch.zeros((T,), device=dev)
            mask[:valid] = 1.0
            timed(cs, f"{fn.__name__} T={T} valid={valid}",
                  lambda fn=fn, x=x, mask=mask, st=st: fn(x, mask, st, 4, 11), card,
                  graph_n=20 if T < 500 else 5)
            fmt = "w8" if flag == "weight_int8" else "w4"
            sanm_block.stack_phase_us(x, mask, st, 4, 11, fmt)  # warm
            ph = sanm_block.stack_phase_us(x, mask, st, 4, 11, fmt)
            names = sanm_block.STACK_PHASES
            mean = ", ".join(f"{n} {v:.2f}" for n, v in zip(names, ph.mean(0).tolist()))
            print(f"    phases a layer (us, mean of {ph.shape[0]} layers, each to the end of "
                  f"its barrier): {mean}; the launch's timer span {ph.sum().item():.1f} us  "
                  f"({card})")
            if T != 171:
                continue
            raw, L, P = sanm_block.stack_phase_us.raw, ph.shape[0], len(names)
            det = raw[P * L + 1:].reshape(P, -1)
            for p, name in enumerate(names):
                begin = int(raw[P + p])  # layer 1's phase p begins after the barrier before it
                rel = [f"{(int(v) - begin) / 1e3:.2f}" for v in det[p].tolist() if v]
                if rel:
                    print(f"    layer 1 {name}, CTA 0's first item, us after the phase began: "
                          f"{', '.join(rel)}")


def rows_part(card, dev, gen, models):
    import torch

    import chip_smoke as cs
    from lele_tpu_torch import kernels as K
    from lele_tpu_torch.kernels.sanm_block import layer_view

    print("== rows 3 and 6")
    lp0 = layer_view(models["weight_int8"].params["layers_stacked"], 0)
    x = torch.randn((171, 512), generator=gen, device=dev) * 0.5
    mask = torch.ones((171,), device=dev)
    timed(cs, "sanm_layer_w8 T=171", lambda: K.sanm_layer_w8(x, mask, lp0, 4, 11), card)
    for S in (1875, 18750):
        args = cs.lstm_inputs(S, 1, 128, dev, gen)
        timed(cs, f"lstm_seq S={S} B=1 H=128", lambda args=args: K.lstm_seq(*args), card,
              graph_n=20 if S < 5000 else 2)


DQL_T = ((36, 36), (100, 100), (196, 171), (100, 76))  # (T, valid rows)
EST_T = ((1024, 320), (512, 160), (256, 320), (128, 96), (64, 96))  # and the TTS requests' buckets


def _split(cs, label, fn, card):
    """One call's device time by kernel name (the profiler, one call)."""
    rows = cs.device_us(fn, n=1)
    if rows is None:
        print(f"    {label}, one call by kernel: not measured (no whole trace)")
        return
    parts = sorted(rows.items(), key=lambda kv: -kv[1])
    print(f"    {label}, one call by kernel ({len(parts)} kernels, {sum(rows.values()):.1f} us): "
          + "; ".join(f"{k[:70]} {v:.1f}" for k, v in parts) + f"  ({card})")


def _stamps(raw, n, names, what):
    """The stamps inside the phases of layer (block) 1, CTA 0's first item,
    in us after the phase began (the kernels' `stamp`)."""
    P = len(names)
    det = raw[P * n + 1:].reshape(P, -1)
    for p, name in enumerate(names):
        begin = int(raw[P + p])  # phase p of layer 1 begins after the barrier before it
        rel = [f"{(int(v) - begin) / 1e3:.2f}" for v in det[p].tolist() if v]
        if rel:
            print(f"    {what} 1 {name}, CTA 0's first item, us after the phase began: "
                  f"{', '.join(rel)}")


def _phases(ph, names, what, card):
    """Mean us of each phase over the rows of ph (the kernel's own timer:
    the global timer after each grid barrier)."""
    mean = ", ".join(f"{n} {v:.2f}" for n, v in zip(names, ph.mean(0).tolist()))
    print(f"    phases a {what} (us, mean of {ph.shape[0]}, each to the end of its barrier): "
          f"{mean}; sum {ph.sum().item():.1f} us  ({card})")


def dql_est_part(card, dev, gen, dql_too=True):
    import dataclasses

    import torch

    import chip_smoke as cs
    from lele_tpu_torch import kernels as K
    from lele_tpu_torch.kernels import sanm_block
    from lele_tpu_torch.models import SupertonicConfig
    from lele_tpu_torch.models.supertonic import init_vector_estimator

    print("== kernel 4 (sanm_stack_dql, 50 layers) and kernel 10 (estimator_blocks, 8 blocks)")
    dql = cs.random_dql_stack(50, 512, 2048, 11, dev, gen) if dql_too else None
    for T, valid in DQL_T if dql_too else ():
        bias, vmask = cs.dql_masks(50, T, valid, dev)
        x = torch.randn((T, 512), generator=gen, device=dev)
        call = lambda x=x, b=bias, v=vmask: K.sanm_stack_dql(x, b, v, dql, 4, 11, 5)  # noqa: E731
        label = f"sanm_stack_dql T={T} valid={valid} L=50"
        timed(cs, label, call, card)
        _split(cs, label, call, card)
        sanm_block.dql_phase_us(x, bias, vmask, dql, 4, 11, 5)  # warm
        _phases(sanm_block.dql_phase_us(x, bias, vmask, dql, 4, 11, 5), sanm_block.DQL_PHASES,
                "layer", card)
        if T == 196:
            _stamps(sanm_block.dql_phase_us.raw, 50, sanm_block.DQL_PHASES, "layer")
    cfg = dataclasses.replace(
        SupertonicConfig.from_json(REPO / "examples" / "supertonic" / "tts.json"),
        fused_estimator=True)
    blocks = init_vector_estimator(gen, cfg)["blocks_stacked"]
    for T, Tk in EST_T:
        xe = torch.randn((T, cfg.d_text), generator=gen, device=dev)
        text = torch.randn((Tk, cfg.d_text), generator=gen, device=dev)
        lm, tm = torch.ones((T,), device=dev), torch.ones((Tk,), device=dev)
        call = lambda a=(xe, text, lm, tm): K.estimator_blocks(*a, blocks, cfg.n_heads)  # noqa: E731
        label = f"est_block T={T} Tk={Tk}, 8 blocks"
        timed(cs, label, call, card)
        _split(cs, label, call, card)


def forward_part(card, dev, models):
    import numpy as np
    import torch

    import chip_smoke as cs

    print("== forward_fn, 10 s of audio")
    pcm = torch.from_numpy(cs.synth_speechlike(10.0, np.random.default_rng(1))).to(dev)
    for flag, m in models.items():
        fwd = m.forward_fn()
        timed(cs, f"forward_fn 10 s {flag}", lambda fwd=fwd, m=m: fwd(m.params, pcm), card)


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from lele_tpu_torch.kernels import _build

    ap = argparse.ArgumentParser()
    ap.add_argument("--parts", default="barrier,stacks,rows,forward")
    parts = ap.parse_args(argv).parts.split(",")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build()
    card = cs.card_identity()
    print(card)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    if "barrier" in parts:
        barrier_part(card)
    models = stack_models(dev) if {"stacks", "rows", "forward"} & set(parts) else {}
    if "stacks" in parts:
        stacks_part(card, dev, gen, models)
    if "rows" in parts:
        rows_part(card, dev, gen, models)
    if "forward" in parts:
        forward_part(card, dev, models)
    if "dql_est" in parts or "est" in parts:
        dql_est_part(card, dev, gen, dql_too="dql_est" in parts)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
