#!/usr/bin/env python3
"""The quantization-noise level of the int8 SAN-M graph, on the CPU.

    JAX_PLATFORMS=cpu python scripts/torch_port_dql_noise.py [--full]

Every linear of the compiled int8 graph quantizes its input with ONNX
DynamicQuantizeLinear against the input's global min/max. Two f32
implementations that differ in the last bit of one activation put it on
neighbouring codes when it sits at a rounding boundary, and the step carries
through the layers. This script measures how far such a last-bit difference
moves the results, so that the gates between the port (lele_tpu_torch) and
the JAX package, and between the port's kernels and their plain versions,
can be set at that level:

1. the fixture gate (fixtures/sensevoice.onnx against sensevoice_logits.npy)
   for the JAX package and the port, per-op, on the fixture input and on 7
   inputs 1e-7 (relative) away from it;
2. the port's plain exact-DQL stack against the JAX Pallas kernel
   (interpret mode), L=2, D=128, T=100, seeds 0-7;
3. with --full, at full width (L=50, d512, ffn 2048, T=196): the plain stack,
   each layer and whole, and the compiled graph's logits (int8 CTC head,
   vocab 25,055), each against itself on an input 1e-7 away.

It needs both packages (JAX and torch); it runs no device code.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
FIX = REPO / "fixtures"


def fixture_gate():
    import os

    os.environ["LELE_SANM_FUSE"] = "0"
    from lele_tpu.compiler import compile_model as j_compile
    from lele_tpu.onnx.loader import OnnxModel as JOnnxModel
    from lele_tpu_torch.compiler import compile_model

    feats = np.load(FIX / "sensevoice_input.npy")
    want = np.load(FIX / "sensevoice_logits.npy")
    t = feats.shape[1]
    t_pad = -(-t // 32) * 32
    shapes = {"speech": (1, t_pad, 560)}
    models = {"jax": j_compile(JOnnxModel.load(FIX / "sensevoice.onnx"), input_shapes=shapes),
              "port": compile_model(FIX / "sensevoice.onnx", input_shapes=shapes,
                                    patterns=[], device="cpu")}
    rng = np.random.default_rng(0)
    print(f"1. fixture gate, per-op, t_pad {t_pad} (oracle gate MAE <= 0.02, agreement > 0.97)")
    for trial in range(8):
        f = feats if trial == 0 else (
            feats * (1 + 1e-7 * rng.standard_normal(feats.shape))).astype(np.float32)
        padded = np.zeros((1, t_pad, 560), np.float32)
        padded[:, :t] = f
        kw = dict(speech=padded, speech_lengths=np.asarray([t], np.int64),
                  language=np.asarray([3], np.int32), textnorm=np.asarray([0], np.int32))
        line = []
        for name, cm in models.items():
            o = np.asarray(cm.run_np(**kw)[0])[:, : want.shape[1]]
            line.append(f"{name} MAE {np.abs(o - want).mean():.4f} agreement "
                        f"{(o.argmax(-1) == want.argmax(-1)).mean():.4f}")
        print(f"  input {trial} ({'the fixture' if trial == 0 else '1e-7 away'}): "
              + "; ".join(line))


def _stack_inputs(L, D, F, k, T, n_valid, rng):
    st = {}
    for key, k_, n_ in (("qkv", D, 3 * D), ("out", D, D), ("ffn1", D, F), ("ffn2", F, D)):
        wq = rng.integers(-127, 128, (L, k_, n_)).astype(np.int8)
        st[key] = {"wq": wq, "colsum": wq.astype(np.int32).sum(1, keepdims=True, dtype=np.int32),
                   "ws": np.full((L, 1, n_), 1 / np.sqrt(k_) / 127, np.float32),
                   "b": (0.02 * rng.standard_normal((L, 1, n_))).astype(np.float32)}
    for key in ("norm1", "norm2"):
        st[key] = {"g": (1 + 0.1 * rng.standard_normal((L, 1, D))).astype(np.float32),
                   "b": (0.1 * rng.standard_normal((L, 1, D))).astype(np.float32)}
    st["fsmn"] = (rng.standard_normal((L, k, D)) / np.sqrt(k)).astype(np.float32)
    x = rng.standard_normal((T, D)).astype(np.float32)
    bias = np.zeros((L, T), np.float32)
    bias[:, n_valid:] = -1e4
    vmask = np.ones((L, T), np.float32)
    vmask[:, n_valid:] = 0.0
    return x, bias, vmask, st


def _torch_tree(st):
    import torch

    return {k: ({a: torch.from_numpy(b) for a, b in v.items()} if isinstance(v, dict)
                else torch.from_numpy(v)) for k, v in st.items()}


def stack_vs_pallas():
    import jax
    import jax.numpy as jnp
    import torch

    from lele_tpu.kernels.sanm_block import sanm_stack_dql_pallas
    from lele_tpu_torch.kernels import sanm_stack_dql

    print("2. plain exact-DQL stack vs the Pallas kernel (interpret), L=2 D=128 T=100")
    for seed in range(8):
        x, bias, vmask, st = _stack_inputs(2, 128, 256, 11, 100, 93,
                                           np.random.default_rng(seed))
        want = np.asarray(sanm_stack_dql_pallas(
            jnp.asarray(x), jnp.asarray(bias), jnp.asarray(vmask),
            jax.tree_util.tree_map(jnp.asarray, st), 4, 11, 5, interpret=True))
        got = sanm_stack_dql(torch.from_numpy(x), torch.from_numpy(bias),
                             torch.from_numpy(vmask), _torch_tree(st), 4, 11, 5).numpy()
        d = np.abs(got - want)
        print(f"  seed {seed}: max|d| {d.max():.3e}, max|ref| {np.abs(want).max():.3f}, "
              f"elements over 2e-3: {(d > 2e-3).sum()} of {d.size}")


def full_width():
    import torch

    from lele_tpu_torch.compiler import compile_model
    from lele_tpu_torch.kernels import sanm_stack_dql
    from lele_tpu_torch.onnx.synth import build_sanm_int8_model

    L, D, F, T = 50, 512, 2048, 196
    rng = np.random.default_rng(0)
    x, bias, vmask, st = _stack_inputs(L, D, F, 11, T, 171, rng)
    st, x = _torch_tree(st), torch.from_numpy(x)
    bias, vmask = torch.from_numpy(bias), torch.from_numpy(vmask)
    gen = torch.Generator().manual_seed(1)

    def step(v):
        return v * (1 + 1e-7 * torch.randn(v.shape, generator=gen))

    print(f"3. full width, the plain stack against itself at a 1e-7 input step, T={T}")
    worst, a = 0.0, x
    for i in range(L):
        li = {k: ({kk: vv[i:i + 1] for kk, vv in v.items()} if isinstance(v, dict)
                  else v[i:i + 1]) for k, v in st.items()}
        ya = sanm_stack_dql(a, bias[i:i + 1], vmask[i:i + 1], li, 4, 11, 5)
        yb = sanm_stack_dql(step(a), bias[i:i + 1], vmask[i:i + 1], li, 4, 11, 5)
        worst = max(worst, ((ya - yb).abs().max() / ya.abs().max()).item())
        a = ya
    print(f"  each layer on its own input: worst max|d|/max|ref| {worst:.3e}")
    ya = sanm_stack_dql(x, bias, vmask, st, 4, 11, 5)
    yb = sanm_stack_dql(step(x), bias, vmask, st, 4, 11, 5)
    d = (ya - yb).abs()
    print(f"  {L} layers whole: mean|d| {(d.mean() / ya.std()).item():.4f} std, "
          f"max|d|/max|ref| {(d.max() / ya.abs().max()).item():.4f}")

    graph = build_sanm_int8_model(L=50, d=512, h=4, ffn=2048, vocab=25055,
                                  int8_head=True, seed=2026)
    cm = compile_model(graph, input_shapes={"speech": (1, 192, 560)}, device="cpu")
    feats = np.random.default_rng(0).standard_normal((1, 192, 560)).astype(np.float32)
    feats[:, 167:] = 0.0
    kw = dict(speech=feats, speech_lengths=np.asarray([167], np.int64),
              language=np.asarray([3], np.int32), textnorm=np.asarray([0], np.int32))
    ref = cm.run_np(**kw)[0][:, :171]
    prng = np.random.default_rng(1)
    for trial in range(3):
        f2 = (feats * (1 + 1e-7 * prng.standard_normal(feats.shape))).astype(np.float32)
        o = cm.run_np(**dict(kw, speech=f2))[0][:, :171]
        print(f"  compiled logits at a 1e-7 input step ({trial}): MAE "
              f"{np.abs(o - ref).mean() / ref.std():.4f} std, argmax agreement "
              f"{(o.argmax(-1) == ref.argmax(-1)).mean():.4f}")


if __name__ == "__main__":
    import torch

    torch.set_num_threads(4)
    fixture_gate()
    stack_vs_pallas()
    if "--full" in sys.argv:
        full_width()
