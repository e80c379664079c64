#!/usr/bin/env python3
"""Kernels 11 and 6 against their parent forms, and kernel 11's (rows,
K split) sweep, on one card.

    python3 scripts/torch_port_form_probe.py OLD_CSRC_DIR [--parts i8,lstm]

Builds OLD_CSRC_DIR's csrc/int8_gemm.cu and csrc/lstm_seq.cu (the parent
forms) and this tree's, the new int8_gemm.cu with one more C entry that
takes the block's rows (64 mi) and the cluster's K split S instead of
choosing them (`i8_config`), and prints `ptxas -v`'s registers and spills.

- int8_gemm: every (mi, S) int32-equal to `int8_matmul_plain` at the
  paths' shapes (a layer's four linears at M = 21, 171, 684, 196; the int8
  head [196,512]x[512,25055]; 2,048^3) and odd edges, the extremes at
  K = 2,048, and 40 calls on an operand written by the kernel just ahead
  (the programmatic dependent launch waits for it); then, in a CUDA graph of
  20 calls (chip_smoke.graph_us): the parent, the new choice, torch._int_mm
  (N padded to 8) and every (mi, S).
- lstm_seq: within chip_smoke.LSTM_TOL of `lstm_seq_plain` and the same bits
  on a repeat call at Silero's and ragged shapes up to S = 18,750; the
  cluster form above H = 128 the parent's bits (H = 129 to 1,024); then the
  parent and the new form at H = 128, B = 1, S = 1, 3, 10, 312, 1,875 and
  18,750 (and B = 3) in a CUDA graph, beside one fill kernel (the floor of
  a graph node).

Every time is printed with the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
P, I = ctypes.c_void_p, ctypes.c_int
SHIM = r'''#include "int8_gemm.cu"
extern "C" int int8_gemm_cfg(const void* a, const void* b, void* c, int M, int K, int N, int mi,
                             int S, void* stream) {
  const cudaError_t err = launch_i8(static_cast<const int8_t*>(a), static_cast<const int8_t*>(b),
                                    static_cast<int32_t*>(c), M, K, N, mi, S,
                                    static_cast<cudaStream_t>(stream));
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}
extern "C" void int8_gemm_choice(int M, int K, int N, int* mi, int* S) {
  i8_config(M, K, N, *mi, *S);
}
'''
PAIRS = ((512, 1536), (512, 512), (512, 2048), (2048, 512))
PATH = [(m, k, n) for m in (21, 171, 684, 196) for k, n in PAIRS] + [(196, 512, 25055),
                                                                  (2048, 2048, 2048)]
EDGES = [(50, 70, 30), (37, 70, 30), (1, 2048, 512), (1, 512, 2048), (1, 1, 1), (17, 33, 65),
         (300, 1040, 136), (5, 16, 24)]
LSTM_CHECKS = ((1875, 1, 128), (3, 1, 128), (2, 1, 128), (312, 1, 128), (37, 3, 48), (5, 2, 1),
               (100, 3, 96), (50, 1, 16), (50, 1, 64), (3, 2, 128), (18750, 1, 128))


def build(jobs, out: Path) -> dict[str, ctypes.CDLL]:
    from lele_tpu_torch.kernels import _build

    procs = {}
    for name, src, inc in jobs:
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(inc), "-o",
               str(out / f"{name}.so"), str(src)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"{name}:\n{log}")
        keep = [l for l in log.splitlines() if "registers" in l or "spill" in l]
        print(f"-- {name}: ptxas\n" + "\n".join(keep), flush=True)
        libs[name] = ctypes.CDLL(str(out / f"{name}.so"))
    return libs


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from lele_tpu_torch.kernels.lstm import lstm_seq_plain
    from lele_tpu_torch.kernels.quant_matmul import int8_matmul_plain

    parts = ["i8", "lstm"]
    if "--parts" in argv:
        i = argv.index("--parts")
        parts = argv[i + 1].split(",")
        argv = argv[:i] + argv[i + 2:]
    old = Path(argv[0]).resolve()
    new = REPO / "lele_tpu_torch" / "csrc"
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    card = cs.card_identity()
    ok = True

    def stream():
        return torch.cuda.current_stream().cuda_stream

    with tempfile.TemporaryDirectory() as d:
        tmp = Path(d)
        (tmp / "i8_shim.cu").write_text(SHIM)
        jobs = []
        if "i8" in parts:
            jobs += [("i8_old", old / "int8_gemm.cu", old), ("i8_new", tmp / "i8_shim.cu", new)]
        if "lstm" in parts:
            jobs += [("lstm_old", old / "lstm_seq.cu", old), ("lstm_new", new / "lstm_seq.cu", new)]
        libs = build(jobs, tmp)
        print(card, flush=True)

        if "i8" in parts:
            f_old, f_new = libs["i8_old"].int8_gemm, libs["i8_new"].int8_gemm
            for f in (f_old, f_new):
                f.argtypes = [P, P, P, I, I, I, P]
            f_cfg = libs["i8_new"].int8_gemm_cfg
            f_cfg.argtypes = [P, P, P, I, I, I, I, I, P]
            f_choice = libs["i8_new"].int8_gemm_choice
            f_choice.argtypes = [I, I, I, ctypes.POINTER(I), ctypes.POINTER(I)]

            def choice(M, K, N):
                mi, S = I(), I()
                f_choice(M, K, N, ctypes.byref(mi), ctypes.byref(S))
                return mi.value, S.value

            def call(f, a, b, *extra):
                M, K = a.shape
                N = b.shape[1]
                c = torch.empty((M, N), dtype=torch.int32, device=dev)
                code = f(a.data_ptr(), b.data_ptr(), c.data_ptr(), M, K, N, *extra, stream())
                if code:
                    raise RuntimeError(f"int8_gemm [{M},{K}]x[{K},{N}] {extra}: CUDA error {code}")
                return c

            def configs(M, K, N):
                kt = (K + 63) // 64
                rows = [mi for mi in (1, 2, 3, 4)
                        if mi == 1 or -(-M // (64 * mi)) != -(-M // (64 * (mi - 1)))]
                return [(mi, S) for mi in rows for S in (1, 2, 4, 8) if S <= kt]

            print("== int8_gemm: int32-equal to plain, every (mi, S)", flush=True)
            for M, K, N in PATH + EDGES:
                a = torch.randint(-128, 128, (M, K), generator=gen, device=dev, dtype=torch.int8)
                b = torch.randint(-128, 128, (K, N), generator=gen, device=dev, dtype=torch.int8)
                ref = int8_matmul_plain(a, b)
                bad = [c for c in configs(M, K, N) if not torch.equal(call(f_cfg, a, b, *c), ref)]
                bad += [v for v, f in (("old", f_old), ("new", f_new))
                        if not torch.equal(call(f, a, b), ref)]
                ok &= not bad
                print(f"  [{M},{K}]x[{K},{N}] choice {choice(M, K, N)}: "
                      f"{'equal' if not bad else f'DIFFER {bad}'}", flush=True)
            for fa, fb in ((-128, -128), (127, -128), (127, 127)):
                a = torch.full((171, 2048), fa, device=dev, dtype=torch.int8)
                b = torch.full((2048, 512), fb, device=dev, dtype=torch.int8)
                good = torch.equal(call(f_new, a, b), int8_matmul_plain(a, b))
                ok &= good
                print(f"  extremes ({fa}, {fb}) at K = 2,048: equal {good}", flush=True)
            af = torch.empty((171, 2048), device=dev)
            bq = torch.randint(-128, 128, (2048, 512), generator=gen, device=dev, dtype=torch.int8)
            dep_ok = True
            for it in range(40):
                af.normal_(generator=gen)
                aq = (af * (40 if it % 2 else -30)).clamp(-128, 127).to(torch.int8)
                dep_ok &= torch.equal(call(f_cfg, aq, bq, 1, 8 if it % 2 else 1),
                                      int8_matmul_plain(aq, bq))
            ok &= dep_ok
            print(f"  40 calls on an operand the kernel just ahead wrote: equal {dep_ok}",
                  flush=True)
            if ok:
                print(f"== int8_gemm, us a call in a CUDA graph of 20 calls  ({card})", flush=True)
                for M, K, N in PATH:
                    a = torch.randint(-128, 128, (M, K), generator=gen, device=dev,
                                      dtype=torch.int8)
                    b = torch.randint(-128, 128, (K, N), generator=gen, device=dev,
                                      dtype=torch.int8)
                    b8 = torch.nn.functional.pad(b, (0, -N % 8))
                    t = {v: [cs.graph_us(lambda f=f: call(f, a, b)) for _ in range(2)]
                         for v, f in (("old", f_old), ("new", f_new))}
                    t_lib = cs.graph_us(lambda: torch._int_mm(a, b8))
                    sweep = {c: cs.graph_us(lambda c=c: call(f_cfg, a, b, *c))
                             for c in configs(M, K, N)}
                    best = min(sweep, key=sweep.get)
                    print(f"  [{M},{K}]x[{K},{N}]: old {t['old'][0]:.2f} / {t['old'][1]:.2f}, "
                          f"new {t['new'][0]:.2f} / {t['new'][1]:.2f} (mi, S) = "
                          f"{choice(M, K, N)}, torch._int_mm {t_lib:.2f}; best {best} "
                          f"{sweep[best]:.2f}; sweep "
                          + " ".join(f"{mi}x{S}:{v:.2f}" for (mi, S), v in sweep.items()),
                          flush=True)

        if "lstm" in parts:
            fns = {"old": libs["lstm_old"].lstm_seq, "new": libs["lstm_new"].lstm_seq}
            for f in fns.values():
                f.argtypes = [P] * 7 + [I, I, I, P]

            def launch(f, args, outs):
                x, wh, h0, c0 = args
                S, B, G = x.shape
                code = f(x.data_ptr(), wh.data_ptr(), h0.data_ptr(), c0.data_ptr(),
                         *(t.data_ptr() for t in outs), S, B, G // 4, stream())
                if code:
                    raise RuntimeError(f"lstm_seq S={S} B={B}: CUDA error {code}")
                return outs

            def outputs(S, B, H):
                return (torch.empty((S, B, H), device=dev), torch.empty((B, H), device=dev),
                        torch.empty((B, H), device=dev))

            print("== lstm_seq: max|d| against plain (hs, h_S, c_S)", flush=True)
            for S, B, H in LSTM_CHECKS:
                args = cs.lstm_inputs(S, B, H, dev, gen)
                ref = torch.cat([t.reshape(-1) for t in lstm_seq_plain(*args)])
                row = []
                for v, f in fns.items():
                    g1 = torch.cat([t.reshape(-1) for t in launch(f, args, outputs(S, B, H))])
                    g2 = torch.cat([t.reshape(-1) for t in launch(f, args, outputs(S, B, H))])
                    d = (g1 - ref).abs().max().item()
                    good = d <= cs.LSTM_TOL and torch.equal(g1, g2)
                    ok &= good or v == "old"
                    row.append(f"{v} {d:.2e}{'' if good else ' FAILS'}")
                print(f"  S={S} B={B} H={H}: " + ", ".join(row), flush=True)
            # above H = 128 both trees run rnn_seq.cuh's cluster form: the same bits
            for S, B, H in ((1023, 1, 256), (255, 1, 1024), (37, 3, 200), (100, 2, 129)):
                args = cs.lstm_inputs(S, B, H, dev, gen)
                got = {v: torch.cat([t.reshape(-1) for t in launch(f, args, outputs(S, B, H))])
                       for v, f in fns.items()}
                same = torch.equal(got["old"], got["new"])
                ok &= same
                print(f"  cluster form S={S} B={B} H={H}: old and new the same bits {same}",
                      flush=True)
            z = torch.zeros(1, device=dev)
            print(f"== lstm_seq H=128, us a call in a CUDA graph  ({card}); one fill kernel "
                  f"{cs.graph_us(lambda: z.zero_()):.2f}", flush=True)
            for S, B in ((1, 1), (3, 1), (10, 1), (312, 1), (1875, 1), (18750, 1), (1875, 3)):
                args = cs.lstm_inputs(S, B, 128, dev, gen)
                outs = outputs(S, B, 128)
                n, reps = (2, 3) if S > 2000 else (20, 10)
                t = {"old": [], "new": []}
                for v in ("old", "new", "new", "old"):
                    t[v].append(cs.graph_us(lambda f=fns[v]: launch(f, args, outs), n=n,
                                            reps=reps))
                print(f"  S={S} B={B}: " + ", ".join(
                    f"{v} {min(ts):.2f} ({' / '.join(f'{x:.2f}' for x in ts)}; "
                    f"{min(ts) / S:.4f} a step)" for v, ts in t.items()), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
