#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (lele_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

1. builds every kernel under lele_tpu_torch/csrc/ with nvcc;
2. prints the card's name and power limit;
3. holds each kernel against its plain PyTorch version on the card, at the
   main path's shapes and in its working types;
4. drives the main path at full width: SenseVoice w8a16 (50 layers, d512,
   vocab 25,055, random weights from a seed) behind SenseVoiceEngine,
   answering three WAV requests (1.0 s, 4.3 s, 10 s), and checks from the
   launch counts that every kernel ran; then holds the 10 s logits of the
   kernel path against the plain path;
5. times each kernel and its plain version, and the 10 s forward, with CUDA
   events (median of warm runs);
6. prints one JSON line of kernels, and last {"ok": true, "device": ...}.

Exits non-zero, and prints no result, when there is no CUDA card or any
check fails. Imports no jax.
"""

from __future__ import annotations

import io
import json
import statistics
import subprocess
import sys
import time
import wave

SEED = 0
SR = 16000
REQUEST_SECONDS = (1.0, 4.3, 10.0)
T_MAIN = 171  # 10 s: 998 fbank frames → 167 LFR frames + 4 prefix frames
T_RAGGED = 87  # 4.3 s padded to the 5 s bucket: 83 LFR + 4, of which 76 valid
VALID_RAGGED = 76
GEMM_SHAPES = ((512, 1536), (512, 512), (512, 2048), (2048, 512), (512, 25055))
TIMED_RUNS = 20


class Checks:
    def __init__(self):
        self.failures: list[str] = []

    def require(self, ok: bool, what: str) -> bool:
        print(f"  [{'ok' if ok else 'FAIL'}] {what}")
        if not ok:
            self.failures.append(what)
        return ok


def card_identity() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def wav_bytes(pcm, sr: int = SR) -> bytes:
    import numpy as np

    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((np.clip(pcm, -1, 1) * 32767).astype("<i2").tobytes())
    return buf.getvalue()


def synth_speechlike(seconds: float, rng):
    """Tones with a slow amplitude envelope plus noise, in [-1, 1]."""
    import numpy as np

    t = np.arange(int(seconds * SR)) / SR
    f0 = rng.uniform(120, 300)
    env = 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(2, 5) * t)
    sig = sum(np.sin(2 * np.pi * f0 * k * t) / k for k in (1, 2, 3))
    return (0.2 * env * sig + 0.01 * rng.standard_normal(t.size)).astype(np.float32)


def time_ms(fn, runs: int = TIMED_RUNS, warm: int = 3) -> float:
    """Median of `runs` CUDA-event timings of fn(), after `warm` runs."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card; the port's kernels run only on one",
              file=sys.stderr)
        return 1

    import numpy as np

    from lele_tpu_torch import kernels as K
    from lele_tpu_torch.kernels import _build
    from lele_tpu_torch.kernels.sanm_block import layer_view
    from lele_tpu_torch.models import (
        SenseVoiceConfig,
        SenseVoiceModel,
        cast_big_params,
        prepare_w8_params,
        stack_layer_params,
    )
    from lele_tpu_torch.serving import SenseVoiceEngine

    # the plain versions are the oracle: full f32 products, no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    checks = Checks()
    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)

    print("== 1. build")
    t0 = time.perf_counter()
    _build.build()
    print(f"  built {_build.sources()} in {time.perf_counter() - t0:.2f} s")

    print("== 2. card")
    card = card_identity()
    print(card)
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    # the full-width model: its layers also give phase 3 its real shapes
    cfg = SenseVoiceConfig(weight_int8=True)
    model = SenseVoiceModel(cfg, device=dev)
    model.init(SEED)
    model.params = stack_layer_params(
        prepare_w8_params(cast_big_params(model.params, torch.bfloat16)))
    stacked = model.params["layers_stacked"]
    wbytes = sum(t.numel() for t in (
        *(stacked[k]["wq8"] for k in ("qkv", "out", "ffn1", "ffn2")),
        model.params["ctc"]["wq8"]))
    print(f"  model: {cfg.n_layers} layers, d{cfg.d_model}, vocab {cfg.vocab_size}, "
          f"{wbytes / 1e6:.1f} MB of int8 weights resident")

    err = {name: 0.0 for name in K.KERNEL_WRAPPERS}
    print("== 3. kernels vs plain on the card")
    for T in (T_MAIN, T_RAGGED):
        for (k_, n_) in GEMM_SHAPES:
            wq = torch.randint(-127, 128, (k_, n_), generator=gen, device=dev,
                               dtype=torch.int8)
            ws = torch.rand((n_,), generator=gen, device=dev) * 2e-3 + 1e-4
            for dtype, tol in ((torch.bfloat16, 1e-3), (torch.float32, 1e-5)):
                x = torch.randn((T, k_), generator=gen, device=dev).to(dtype)
                got = K.w8_matmul(x, wq, ws)
                ref = K.w8_matmul_plain(x, wq, ws)
                torch.cuda.synchronize()
                d = (got - ref).abs().max().item()
                scale = ref.abs().max().item()
                err["w8_gemm"] = max(err["w8_gemm"], d)
                checks.require(
                    got.shape == ref.shape and d <= tol * scale,
                    f"w8_gemm [{T},{k_}]x[{k_},{n_}] {str(dtype)[6:]}: "
                    f"max|d| {d:.3e} <= {tol:g} * {scale:.3e}")

    def layer_check(T, n_valid, lp, name, fn, plain):
        x = torch.randn((T, cfg.d_model), generator=gen, device=dev) * 0.5
        mask = torch.zeros((T,), device=dev)
        mask[:n_valid] = 1.0
        got = fn(x, mask, lp, cfg.n_heads, cfg.fsmn_kernel)
        ref = plain(x, mask, lp, cfg.n_heads, cfg.fsmn_kernel)
        torch.cuda.synchronize()
        g, r = got[:n_valid], ref[:n_valid]
        d = (g - r).abs().max().item()
        scale = r.abs().max().item()
        ok = bool(torch.isfinite(g).all()) and torch.allclose(
            g, r, rtol=2e-2, atol=2e-2 * scale)
        err[name] = max(err[name], d)
        checks.require(ok, f"{name} T={T} valid={n_valid}: max|d| {d:.3e}, "
                           f"rtol 2e-2, atol 2e-2 * {scale:.3e}")

    lp0 = layer_view(stacked, 0)
    layer_check(T_MAIN, T_MAIN, lp0, "sanm_layer_w8", K.sanm_layer_w8,
                K.sanm_layer_w8_plain)
    layer_check(T_RAGGED, VALID_RAGGED, lp0, "sanm_layer_w8", K.sanm_layer_w8,
                K.sanm_layer_w8_plain)
    layer_check(T_MAIN, T_MAIN, stacked, "sanm_stack_w8", K.sanm_stack_w8,
                K.sanm_stack_w8_plain)

    print("== 4. main path: SenseVoiceEngine.recognize at full width")
    engine = SenseVoiceEngine(model=model)
    requests = [wav_bytes(synth_speechlike(s, rng)) for s in REQUEST_SECONDS]
    K.reset_launch_counts()
    answers = [engine.recognize(r) for r in requests]
    torch.cuda.synchronize()
    launches = K.launch_counts()
    for s, ids in zip(REQUEST_SECONDS, answers):
        checks.require(all(0 <= i < cfg.vocab_size for i in ids),
                       f"request {s} s: {len(ids)} tokens, ids in [0, vocab)")
    n_req = len(requests)
    print(f"  launch counts over {n_req} requests: {launches}")
    checks.require(launches["sanm_layer_w8"] == cfg.n_layers * n_req,
                   f"sanm_layer_w8 launched {cfg.n_layers} times per request")
    checks.require(launches["sanm_stack_w8"] == n_req, "sanm_stack_w8 once per request")
    checks.require(launches["w8_gemm"] == n_req, "w8_gemm (CTC head) once per request")

    pcm10 = synth_speechlike(10.0, np.random.default_rng(SEED + 1))
    fwd, fwd_plain = model.forward_fn(), model.forward_fn(plain=True)
    got = fwd(model.params, pcm10)
    ref = fwd_plain(model.params, pcm10)
    torch.cuda.synchronize()
    rel = ((got - ref).abs().max() / ref.abs().max()).item()
    agree = (got.argmax(-1) == ref.argmax(-1)).float().mean().item()
    checks.require(tuple(got.shape) == (1, T_MAIN, cfg.vocab_size)
                   and bool(torch.isfinite(got).all()),
                   f"10 s logits {tuple(got.shape)} finite")
    checks.require(rel <= 5e-2, f"10 s logits kernel vs plain: max|d|/max|ref| {rel:.3e} <= 5e-2")
    checks.require(agree >= 0.98, f"10 s frame-argmax agreement {agree:.4f} >= 0.98")

    print(f"== 5. timings (CUDA events, median of {TIMED_RUNS}; {card})")
    ms, plain_ms = {}, {}
    for (k_, n_) in GEMM_SHAPES:
        x = torch.randn((T_MAIN, k_), generator=gen, device=dev).to(torch.bfloat16)
        wq = torch.randint(-127, 128, (k_, n_), generator=gen, device=dev,
                           dtype=torch.int8)
        ws = torch.rand((n_,), generator=gen, device=dev) * 2e-3
        a = time_ms(lambda: K.w8_matmul(x, wq, ws))
        b = time_ms(lambda: K.w8_matmul_plain(x, wq, ws))
        print(f"  w8_gemm [{T_MAIN},{k_}]x[{k_},{n_}] bf16: kernel {a:.4f} ms, "
              f"plain {b:.4f} ms  ({card})")
        ms["w8_gemm"], plain_ms["w8_gemm"] = a, b  # the last is the CTC head
    x = torch.randn((T_MAIN, cfg.d_model), generator=gen, device=dev) * 0.5
    mask = torch.ones((T_MAIN,), device=dev)
    for name, tree in (("sanm_layer_w8", lp0), ("sanm_stack_w8", stacked)):
        fn, plain = K.KERNEL_WRAPPERS[name], getattr(K, f"{name}_plain")
        ms[name] = time_ms(lambda: fn(x, mask, tree, cfg.n_heads, cfg.fsmn_kernel))
        plain_ms[name] = time_ms(
            lambda: plain(x, mask, tree, cfg.n_heads, cfg.fsmn_kernel))
        print(f"  {name} T={T_MAIN}: kernel {ms[name]:.4f} ms, "
              f"plain {plain_ms[name]:.4f} ms  ({card})")
    f_ms = time_ms(lambda: fwd(model.params, pcm10))
    fp_ms = time_ms(lambda: fwd_plain(model.params, pcm10))
    print(f"  forward_fn 10 s: kernel path {f_ms:.4f} ms (RTF {f_ms / 1e4:.3e}), "
          f"plain path {fp_ms:.4f} ms (RTF {fp_ms / 1e4:.3e})  ({card})")

    if checks.failures:
        print(f"chip_smoke: {len(checks.failures)} check(s) failed:", file=sys.stderr)
        for f in checks.failures:
            print(f"  {f}", file=sys.stderr)
        return 1

    replaces = {
        "w8_gemm": ("lele_tpu_torch/csrc/w8_gemm.cu",
                    "lele_tpu/kernels/quant_matmul.py:267",
                    "bf16 max|d| <= 1e-3*max|ref|, f32 <= 1e-5*max|ref|"),
        "sanm_layer_w8": ("lele_tpu_torch/csrc/sanm_layer.cu",
                          "lele_tpu/kernels/sanm_block.py:110",
                          "rtol 2e-2, atol 2e-2*max|ref| on valid rows"),
        "sanm_stack_w8": ("lele_tpu_torch/csrc/sanm_layer.cu",
                          "lele_tpu/kernels/sanm_block.py:229",
                          "rtol 2e-2, atol 2e-2*max|ref| on valid rows"),
    }
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": err[name], "tolerance": tol,
         "ms": ms[name], "plain_ms": plain_ms[name]}
        for name, (src, rep, tol) in replaces.items()
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
