#!/usr/bin/env python3
"""Host cost of the kernel wrappers' dispatch, one checkout against another.

    python3 scripts/torch_port_dispatch_probe.py ROOT [ROOT ...]

For each ROOT (a checkout of the repo, e.g. the parent commit unpacked by
`git archive` and this tree) a fresh process imports `lele_tpu_torch` from
there and prints one JSON line with, on the card:

- the host microseconds of one call of `w8_matmul` (x bf16 [1, 512] @ int8
  [512, 2048]), `fused_dq_matmul` (x f32 [1, 512] @ [512, 2048]) and
  `int8_matmul` ([1, 512] @ [512, 2048]), outside and inside
  torch.inference_mode (median of 20 blocks of 100 calls, a device sync
  between blocks);
- host ms of two paths (median of 5 warm runs, each ending in a sync): the
  dynamic-int8 SenseVoice at full width run uncaptured (`_ids_fn()`
  eagerly: 50 layers, 200 int8_gemm launches a call, 10 s of audio), and the
  streaming ASR step (`StreamingSenseVoice.decode_step_fn`, f32, captured);
- the host microseconds of a trivial op (an add on the card) called
  directly, as a `torch.library.custom_op` and as a `Library.impl` op;
- the card's name and power limit.

Run the roots interleaved (A B B A) in one call and compare within it.
"""

from __future__ import annotations

import json
import subprocess
import sys

CHILD = r"""
import json, statistics, subprocess, sys, time
sys.path.insert(0, sys.argv[1])
import numpy as np, torch
import lele_tpu_torch
from lele_tpu_torch import kernels as K
from lele_tpu_torch.kernels import _build
from lele_tpu_torch.models import SenseVoiceConfig, SenseVoiceModel, stack_layer_params
from lele_tpu_torch.models.sensevoice import prepare_quantized_params
from lele_tpu_torch.models.sensevoice_stream import (StreamConfig, StreamingSenseVoice,
                                                     init_stream_state)

assert lele_tpu_torch.__file__.startswith(sys.argv[1]), lele_tpu_torch.__file__
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
_build.build(["w8_gemm", "dq_gemm", "int8_gemm"])
dev = torch.device("cuda", 0)
g = torch.Generator(device=dev).manual_seed(0)


def host_us(fn):
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(20):
        t0 = time.perf_counter()
        for _ in range(100):
            fn()
        per.append((time.perf_counter() - t0) * 1e4)
        torch.cuda.synchronize()
    return statistics.median(per)


def host_ms(fn, runs=5):
    fn()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


x8 = torch.randn((1, 512), device=dev, generator=g).to(torch.bfloat16)
wq = torch.randint(-127, 128, (512, 2048), device=dev, dtype=torch.int8, generator=g)
ws = torch.rand((2048,), device=dev, generator=g) * 1e-3
xd = torch.randn((1, 512), device=dev, generator=g)
colsum = wq.to(torch.int32).sum(0, dtype=torch.int32)
a_scale, a_zp = K.quant_matmul.dql_scale_zp(xd)
a8 = torch.randint(-127, 128, (1, 512), device=dev, dtype=torch.int8, generator=g)
calls = {"w8_matmul": lambda: K.w8_matmul(x8, wq, ws),
         "fused_dq_matmul": lambda: K.fused_dq_matmul(xd, wq, colsum, a_scale, a_zp, 2.5e-3),
         "int8_matmul": lambda: K.int8_matmul(a8, wq)}
out = {"root": sys.argv[1]}
for name, fn in calls.items():
    out[name + "_us"] = host_us(fn)
    with torch.inference_mode():
        out[name + "_us_inference_mode"] = host_us(fn)

# the two ways to register an op, on one trivial CUDA op (an add): what the
# dispatcher alone costs a call
from torch.library import Library, custom_op


def add(a, b):
    return a + b


trivial = custom_op("dispatch_probe::add_c", add, mutates_args=(), device_types="cuda",
                    schema="(Tensor a, Tensor b) -> Tensor")
trivial.register_fake(lambda a, b: torch.empty_like(a))
lib = Library("dispatch_probe", "FRAGMENT")
lib.define("add_l(Tensor a, Tensor b) -> Tensor")
lib.impl("add_l", add, "CUDA")
t1 = torch.ones(4, device=dev)
for label, fn in (("direct", lambda: add(t1, t1)),
                  ("custom_op", lambda: torch.ops.dispatch_probe.add_c.default(t1, t1)),
                  ("library_impl", lambda: torch.ops.dispatch_probe.add_l.default(t1, t1))):
    out[f"trivial_{label}_us"] = host_us(fn)
    with torch.inference_mode():
        out[f"trivial_{label}_us_inference_mode"] = host_us(fn)

cfg = SenseVoiceConfig(quantized=True)
model = SenseVoiceModel(cfg, device=dev)
f32 = model.init(0)
model.params = stack_layer_params(prepare_quantized_params(f32, drop_fp=True))
pcm = torch.from_numpy((np.random.default_rng(1).standard_normal((1, 160000)) * 0.1)
                       .astype(np.float32)).to(dev)
lens = torch.tensor([160000], dtype=torch.int64, device=dev)
fn = model._ids_fn()
K.reset_launch_counts()
with torch.inference_mode():
    fn(pcm, lens)
out["int8_uncaptured_launches"] = K.launch_counts()["int8_gemm"]
with torch.inference_mode():
    out["int8_uncaptured_ms"] = host_ms(lambda: fn(pcm, lens))

st = StreamingSenseVoice(cfg=SenseVoiceConfig(), stream=StreamConfig(chunk_frames=16), device=dev)
st.params = f32
feats = st.fbank(pcm[0].cpu().numpy())[None, :16].contiguous()
mask = torch.ones((1, 16), device=dev)
state = init_stream_state(st.cfg, st.stream, device=dev)
out["stream_step_ms"] = host_ms(lambda: st.decode_step_fn()(st.params, feats, mask, state))
out["card"] = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip()
print(json.dumps(out))
"""


def main(argv: list[str]) -> int:
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    rc = 0
    for root in argv:
        r = subprocess.run([sys.executable, "-c", CHILD, root], capture_output=True, text=True)
        if r.returncode != 0:
            print(f"{root}: exit {r.returncode}\n{r.stderr[-3000:]}", file=sys.stderr)
            rc = 1
            continue
        print(r.stdout.strip().splitlines()[-1], flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
