#!/usr/bin/env python3
"""A/B of two versions of the port's kernels 1, 4, 5, 6, 7 and 8 on one card.

    python3 scripts/torch_port_kernel_ab.py OLD_CSRC_DIR [NEW_CSRC_DIR] [--stems a,b]

Builds csrc/dq_gemm.cu, csrc/sanm_dql.cu, csrc/lstm_seq.cu,
csrc/w4_gemm.cu and csrc/sanm_layer.cu, those of them that both
directories hold (or those `--stems` names), from both (the new one
defaults to lele_tpu_torch/csrc), binds each through the port's own
wrappers (the C entries must share their signatures), and times in turns,
old new new old, with CUDA events (median of 30 warm runs each):

- `dq_gemm` at the compiled graph's four layer linears and its CTC head,
  T = 196 rows (10 s of audio);
- `sanm_stack_dql`, 50 layers at d512, ffn 2048, T = 196;
- `lstm_seq` at H = 128, B = 1 over S = 3 (a chunk of the Silero fixture),
  1,875 (60 s) and 18,750 (600 s) steps;
- `w4_gemm` (bf16 x, group 128) at the layer linears and the CTC head,
  T = 171 rows;
- `sanm_stack_w8` and, where both versions have its C entry,
  `sanm_stack_w4`: 50 layers at d512, ffn 2048, T = 171, random weights.

It checks that the two versions give the same bits (both compute the same
exact arithmetic) and prints the card's name and power limit beside every
time. Random operands come from a seed on the card.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
STEMS = ("dq_gemm", "sanm_dql", "lstm_seq", "w4_gemm", "sanm_layer")
LSTM_STEPS = (3, 1875, 18750)
T, L, D, F, H, FK = 196, 50, 512, 2048, 4, 11
SHAPES = ((512, 1536), (512, 512), (512, 2048), (2048, 512), (512, 25055))
T_W = 171  # the native path's rows at 10 s


def build(csrc: Path, out: Path, stems) -> dict[str, ctypes.CDLL]:
    from lele_tpu_torch.kernels import _build

    procs = {}
    for stem in stems:
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc), "-o",
               str(out / f"lib{stem}.so"), str(csrc / f"{stem}.cu")]
        procs[stem] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for stem, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"{csrc}/{stem}.cu:\n{log}")
        lib = ctypes.CDLL(str(out / f"lib{stem}.so"))
        lib.lele_error_string.argtypes = [ctypes.c_int]
        lib.lele_error_string.restype = ctypes.c_char_p
        libs[stem] = lib
    return libs


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from lele_tpu_torch import kernels as K
    from lele_tpu_torch.kernels import _build, lstm, quant_matmul, sanm_block

    w4 = sys.modules[K.w4_matmul.__module__]

    wanted = STEMS
    if "--stems" in argv:
        i = argv.index("--stems")
        wanted = tuple(argv[i + 1].split(","))
        argv = argv[:i] + argv[i + 2:]
    old = Path(argv[0]).resolve()
    new = Path(argv[1]).resolve() if len(argv) > 1 else REPO / "lele_tpu_torch" / "csrc"
    stems = [s for s in STEMS if s in wanted and (old / f"{s}.cu").exists()
             and (new / f"{s}.cu").exists()]
    card = cs.card_identity()
    with tempfile.TemporaryDirectory() as d:
        (Path(d) / "old").mkdir()
        (Path(d) / "new").mkdir()
        libs = {"old": build(old, Path(d) / "old", stems),
                "new": build(new, Path(d) / "new", stems)}

        def use(version):
            for stem in stems:
                _build._libs[stem] = libs[version][stem]
            quant_matmul._dq_fn = None
            sanm_block._dql_fn = None
            sanm_block._fns.clear()
            lstm._fn = None
            w4._fn = None

        dev = torch.device("cuda", 0)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        cases = []
        for k_, n_ in SHAPES if "dq_gemm" in stems else ():
            wq = torch.randint(-127, 128, (k_, n_), generator=gen, device=dev,
                               dtype=torch.int8)
            colsum = wq.to(torch.int32).sum(0, dtype=torch.int32)
            x = torch.randn((T, k_), generator=gen, device=dev)
            _, s, zp = K.dynamic_quantize_u8(x)
            cases.append((f"dq_gemm [{T},{k_}]x[{k_},{n_}]",
                          lambda x=x, wq=wq, c=colsum, s=s, zp=zp:
                          K.fused_dq_matmul(x, wq, c, s, zp, 2.5e-3)))
        if "sanm_dql" in stems:
            st = cs.random_dql_stack(L, D, F, FK, dev, gen)
            bias, vmask = cs.dql_masks(L, T, 171, dev)
            x = torch.randn((T, D), generator=gen, device=dev)
            cases.append((f"sanm_stack_dql T={T} L={L}",
                          lambda: K.sanm_stack_dql(x, bias, vmask, st, H, FK, (FK - 1) // 2)))
        for S in LSTM_STEPS if "lstm_seq" in stems else ():
            args = cs.lstm_inputs(S, 1, 128, dev, gen)
            cases.append((f"lstm_seq S={S} B=1 H=128",
                          lambda args=args: torch.cat([t.reshape(-1) for t in K.lstm_seq(*args)])))
        for k_, n_ in SHAPES if "w4_gemm" in stems else ():
            packed, scales = w4.quantize_weight_int4(
                torch.randn((k_, n_), generator=gen, device=dev) / k_ ** 0.5, 128)
            xw = torch.randn((T_W, k_), generator=gen, device=dev).to(torch.bfloat16)
            cases.append((f"w4_gemm [{T_W},{k_}]x[{k_},{n_}] g128 bf16",
                          lambda x=xw, p=packed, s=scales: K.w4_matmul(x, p, s, 128)))
        if "sanm_layer" in stems:
            cases += _layer_cases(stems, libs, dev, gen)
        for name, fn in cases:
            times = {"old": [], "new": []}
            outs = {}
            for version in ("old", "new", "new", "old"):
                use(version)
                try:
                    outs[version] = fn()
                    torch.cuda.synchronize()
                except RuntimeError as e:
                    print(f"{name}: the {version} version fails: {e}")
                    return 1
                times[version].append(cs.time_ms(fn, runs=30))
            same = torch.equal(outs["old"], outs["new"])
            print(f"{name}: old {statistics.mean(times['old']):.4f} ms "
                  f"({', '.join(f'{t:.4f}' for t in times['old'])}), new "
                  f"{statistics.mean(times['new']):.4f} ms "
                  f"({', '.join(f'{t:.4f}' for t in times['new'])}), same bits {same}  ({card})")
    return 0


def _layer_cases(stems, libs, dev, gen):
    """The w8 stack and, where both builds have it, the w4 stack, at the
    native path's full width and T = 171."""
    import torch

    from lele_tpu_torch import kernels as K
    from lele_tpu_torch.models import (
        SenseVoiceConfig,
        SenseVoiceModel,
        cast_big_params,
        prepare_w4_params,
        prepare_w8_params,
        stack_layer_params,
    )

    x = torch.randn((T_W, D), generator=gen, device=dev) * 0.5
    mask = torch.ones((T_W,), device=dev)
    cases = []
    for flag, prep, fn in (("weight_int8", prepare_w8_params, K.sanm_stack_w8),
                           ("weight_int4", prepare_w4_params, K.sanm_stack_w4)):
        if flag == "weight_int4" and not all(hasattr(lib["sanm_layer"], "sanm_layer_w4")
                                             for lib in libs.values()):
            continue
        m = SenseVoiceModel(SenseVoiceConfig(**{flag: True}), device=dev)
        m.init(0)
        st = stack_layer_params(prep(cast_big_params(m.params, torch.bfloat16)))
        st = st["layers_stacked"]
        cases.append((f"{fn.__name__} T={T_W} L={L}",
                      lambda fn=fn, st=st: fn(x, mask, st, H, FK)))
    return cases


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
