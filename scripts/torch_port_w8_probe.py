#!/usr/bin/env python3
"""Kernel 2 (the w8a16 GEMM) at every shape its paths run, and kernel 3 (one
w8a16 SAN-M layer) beside the stack kernel at L = 1, on one card.

    python3 scripts/torch_port_w8_probe.py [OLD_CSRC_DIR] [--parts check,sweep,gemm,layer]

- gemm: `w8_matmul` (this tree's csrc/w8_gemm.cu) at chip_smoke.W8_TIMED:
  the B = 1 CTC head [171,512]x[512,25055], the batch (M = 684) and
  long-form (M = 1,512) heads and four layer linears, and MoE's qkv and
  out at M = 171, the weight kept as the model keeps it (`align_rows`:
  the heads' rows padded to 25,056 bytes); each
  within chip_smoke's gate of `w8_matmul_plain` (bf16 x: max|d| <= 1e-3
  max|ref|), timed as 20 calls in one CUDA graph (chip_smoke.graph_us) beside
  `torch.matmul` on the weight dequantised to bf16 and the bound (x, the
  int8 weight and the scales read once, the f32 output written once;
  2 M K N bf16 operations). With OLD_CSRC_DIR, that directory's w8_gemm.cu
  (built here) runs in turns with this tree's: old new new old.
- layer: one layer at d512, ffn 2,048, head dim 128 at T = 21, 87 (76
  valid), 171 and 1,004, and head dims 32 and 64 at T = 171: the seven
  launches of a csrc/sanm_layer.cu (this tree's, or OLD_CSRC_DIR's), the
  stack kernel (csrc/sanm_stack.cu) called with L = 1 on a one-layer slice,
  and `sanm_layer_w8` as this tree routes it, each within the layer gate of
  `sanm_layer_w8_plain` (rtol 2e-2, atol 2e-2 max|ref| on the valid rows),
  timed in a CUDA graph, in turns.

- check: this tree's csrc/w8_gemm.cu with one more C entry that takes the
  block's rows and K split instead of choosing them (`w8_config`), built
  with `-Xptxas -v` printed: every (rows, K split) against
  `w8_matmul_plain` at ragged and path shapes, and on operands offset by
  slicing, each operand through `align_rows` as the wrapper passes it
  (bf16 x: max|d| <= 1e-3 max|ref|).
- sweep: every (rows, K split), if the check passed, at every gemm shape,
  in a CUDA graph, beside `w8_config`'s choice.

Every time is printed with the card's name and power limit.
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
from lele_tpu_torch.kernels.quant_matmul import align_rows  # noqa: E402
P, I = ctypes.c_void_p, ctypes.c_int
# (M, K, N) held against the plain version at every config: ragged edges,
# odd N (an unaligned weight, copied into padded rows), K % 8 != 0
CHECK = ((64, 64, 64), (64, 64, 128), (1, 16, 16), (37, 70, 30), (130, 256, 72), (5, 2048, 512),
         (300, 1040, 136), (513, 520, 25055), (171, 512, 25055), (684, 512, 1536),
         (684, 2048, 512), (200, 512, 1000))
CONFIGS = tuple((r, s_) for r in (64, 128, 176, 256) for s_ in (1, 2, 4))
SHIM = r'''#include "w8_gemm.cu"
extern "C" int w8_gemm_cfg(const void* x, int ldx, const void* w, int ldw, const void* scale,
                           void* y, int ldy, int M, int K, int N, int mx, int S, void* stream) {
  const cudaError_t err = lele::launch_w8_wgmma(
      static_cast<const __nv_bfloat16*>(x), ldx, static_cast<const int8_t*>(w), ldw,
      static_cast<const float*>(scale), static_cast<float*>(y), ldy, M, K, N, mx, S,
      static_cast<cudaStream_t>(stream));
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}
extern "C" void w8_gemm_choice(int M, int K, int N, int* mx, int* S) {
  lele::w8_config(M, K, N, *mx, *S);
}
'''
# (T, valid rows, head dim)
LAYER = ((21, 21, 128), (87, 76, 128), (171, 171, 128), (1004, 1004, 128), (171, 171, 32),
         (171, 171, 64))


def build(stems, csrc: Path, out: Path) -> dict[str, ctypes.CDLL]:
    from lele_tpu_torch.kernels import _build

    procs = {s: subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc), "-o",
                                  str(out / f"lib{s}.so"), str(csrc / f"{s}.cu")],
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for s in stems}
    libs = {}
    for s, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"{csrc}/{s}.cu:\n{log}")
        libs[s] = ctypes.CDLL(str(out / f"lib{s}.so"))
    return libs


def old_w8(lib):
    """A parent w8_gemm.cu's entry (x, amode, w, scale, bias, res, y, M, K,
    N, relu, stream) as a w8_matmul-like call."""
    import torch

    fn = lib.w8_gemm
    fn.argtypes = [P, I, P, P, P, P, P, I, I, I, I, P]
    fn.restype = I

    def call(x, wq, ws):
        M, K = x.shape
        N = wq.shape[1]
        y = torch.empty((M, N), dtype=torch.float32, device=x.device)
        code = fn(x.data_ptr(), 1 if x.dtype == torch.bfloat16 else 0, wq.data_ptr(),
                  ws.data_ptr(), None, None, y.data_ptr(), M, K, N, 0,
                  torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"old w8_gemm: CUDA error {code}")
        return y
    return call


def seven_launches(lib):
    """A sanm_layer.cu's seven-launch entry on one layer's params."""
    import torch

    from lele_tpu_torch.kernels import sanm_block

    fn = lib.sanm_layer_w8
    fn.argtypes = [P, P] + [I] * 5 + [P] * 5 + [P, I] + [P] * 11 + [P] * 5
    fn.restype = I

    def call(x, mask, lp, H, FK):
        y = x.to(torch.float32).contiguous().clone()
        T, D = y.shape
        _, ts, F, p, _ = sanm_block.layer_pointers(lp, y.device, D, FK, "w8", 0, "seven",
                                                   stacked=False)
        scratch = [torch.empty((T, n), dtype=torch.float32, device=y.device)
                   for n in (D, 3 * D, D, F)]
        code = fn(y.data_ptr(), mask.data_ptr(), T, D, H, F, FK, *p[0:5], p[5],
                  int(ts[5].dtype == torch.bfloat16), *p[6:17],
                  *(s.data_ptr() for s in scratch), torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"sanm_layer_w8 (seven launches): CUDA error {code}")
        return y
    return call


def turns(versions: dict, fn_of, n: int, reps: int) -> dict[str, list[float]]:
    """Each version timed in a CUDA graph in turns: forward, then backward."""
    import chip_smoke as cs

    order = list(versions) + list(versions)[::-1]
    out = {v: [] for v in versions}
    for v in order:
        out[v].append(cs.graph_us(fn_of(v), n=n, reps=reps))
    return out


def fmt(ts: list[float]) -> str:
    return f"{statistics.mean(ts):.2f} ({', '.join(f'{t:.2f}' for t in ts)})"


def gemm_part(cs, K, dev, gen, old, card) -> bool:
    import torch

    for m, n_ in ((684, 1536), (171, 25055)):  # the card's own write rate, as a yardstick
        y = torch.empty((m, n_), device=dev)
        t = cs.graph_us(lambda: y.fill_(1.0))
        print(f"fill_ of an f32 [{m},{n_}] ({m * n_ * 4 / 1e6:.1f} MB): {t:.2f} us in a CUDA "
              f"graph, {m * n_ * 4 / t / 1e6:.2f} TB/s  ({card})", flush=True)
    ok_all = True
    for m, k_, n_ in cs.W8_TIMED:
        x = torch.randn((m, k_), generator=gen, device=dev).to(torch.bfloat16)
        wq = torch.randint(-127, 128, (k_, n_), generator=gen, device=dev, dtype=torch.int8)
        ws = torch.rand((n_,), generator=gen, device=dev) * 2e-3 + 1e-4
        w_bf16 = (wq.float() * ws).to(torch.bfloat16)
        wp = align_rows(wq)  # as the model keeps it; the parent's entry takes wq
        versions = {"new": lambda: K.w8_matmul(x, wp, ws)}
        if old is not None:
            versions = {"old": lambda: old(x, wq, ws), **versions}
        ref = K.w8_matmul_plain(x, wq, ws)
        scale = ref.abs().max().item()
        errs = []
        for v, fn in versions.items():
            d = (fn() - ref).abs().max().item()
            errs.append(f"{v} max|d| {d:.3e}")
            ok_all &= d <= 1e-3 * scale
        t = turns(versions, lambda v: versions[v], 20, 10)
        lib = cs.graph_us(lambda: torch.matmul(x, w_bf16))
        b, by = cs.w8_bound(m, k_, n_)
        print(f"w8_gemm [{m},{k_}]x[{k_},{n_}] bf16, us in a CUDA graph: "
              + "; ".join(f"{v} {fmt(ts)}" for v, ts in t.items())
              + f"; torch.matmul {lib:.2f}; bound {b * 1e3:.2f} ({by}); {', '.join(errs)} "
              f"<= 1e-3 * {scale:.3e}  ({card})", flush=True)
    return ok_all


def layer_part(cs, K, dev, gen, seven, card) -> bool:
    import torch

    from lele_tpu_torch.kernels.sanm_block import layer_view

    ok_all = True
    for T, valid, hd in LAYER:
        st = cs.stack_tree("weight_int8", dev, n_layers=1, n_heads=512 // hd)
        H, FK = 512 // hd, 11
        lp = layer_view(st, 0)
        x = torch.randn((T, 512), generator=gen, device=dev) * 0.5
        mask = torch.zeros((T,), device=dev)
        mask[:valid] = 1.0
        versions = {"seven launches": lambda: seven(x, mask, lp, H, FK),
                    "stack L=1": lambda: K.sanm_stack_w8(x, mask, st, H, FK),
                    "sanm_layer_w8": lambda: K.sanm_layer_w8(x, mask, lp, H, FK)}
        if seven is None:
            del versions["seven launches"]
        ref = K.sanm_layer_w8_plain(x, mask, lp, H, FK)[:valid]
        scale = ref.abs().max().item()
        errs = []
        for v, fn in versions.items():
            got = fn()[:valid]
            ok = torch.allclose(got, ref, rtol=2e-2, atol=2e-2 * scale)
            errs.append(f"{v} max|d| {(got - ref).abs().max().item():.3e} {ok}")
            ok_all &= ok
        t = turns(versions, lambda v: versions[v], 5 if T > 500 else 20, 5 if T > 500 else 10)
        print(f"layer T={T} valid={valid} head dim {hd}, us in a CUDA graph: "
              + "; ".join(f"{v} {fmt(ts)}" for v, ts in t.items())
              + f"; vs plain (rtol 2e-2, atol 2e-2 * {scale:.3e}): {', '.join(errs)}  ({card})",
              flush=True)
    return ok_all


def build_shim(out: Path) -> ctypes.CDLL | None:
    """The shim over this tree's w8_gemm.cu; ptxas's registers and spills
    printed."""
    from lele_tpu_torch.kernels import _build

    (out / "shim.cu").write_text(SHIM)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(_build.CSRC), "-o",
           str(out / "shim.so"), str(out / "shim.cu")]
    p = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if p.returncode:
        print(f"-- shim fails to build:\n{p.stdout}", flush=True)
        return None
    keep = [ln for ln in p.stdout.splitlines() if "registers" in ln or "spill" in ln
            or "w8_wgmma" in ln]
    print("-- shim: ptxas\n" + "\n".join(keep[:40]), flush=True)
    lib = ctypes.CDLL(str(out / "shim.so"))
    lib.w8_gemm_cfg.argtypes = [P, I, P, I, P, P, I, I, I, I, I, I, P]
    lib.w8_gemm_cfg.restype = I
    return lib


def cfg_call(lib, x, wq, ws, cfg, fill=False):
    import torch

    x, wq = align_rows(x), align_rows(wq)  # as the wrapper passes them
    M, K = x.shape
    N = wq.shape[1]
    ldy = -(-N // 4) * 4  # as the wrapper pads y's rows
    y = (torch.full((M, ldy), float("nan"), device=x.device) if fill
         else torch.empty((M, ldy), device=x.device))[:, :N]
    code = lib.w8_gemm_cfg(x.data_ptr(), x.stride(0), wq.data_ptr(), wq.stride(0),
                           ws.data_ptr(), y.data_ptr(), ldy, M, K, N, *cfg,
                           torch.cuda.current_stream().cuda_stream)
    if code:
        raise RuntimeError(f"w8_gemm_cfg {cfg}: CUDA error {code}")
    return y


def check_part(cs, K, dev, gen, lib, card) -> bool:
    """Every config of the shim against the plain version."""
    import torch

    cases = []
    for m, k_, n_ in CHECK:
        x = torch.randn((m, k_), generator=gen, device=dev).to(torch.bfloat16)
        wq = torch.randint(-127, 128, (k_, n_), generator=gen, device=dev, dtype=torch.int8)
        ws = torch.rand((n_,), generator=gen, device=dev) * 2e-3 + 1e-4
        cases.append((f"[{m},{k_}]x[{k_},{n_}]", x, wq, ws))
    bx = torch.randn((176, 520), generator=gen, device=dev).to(torch.bfloat16)
    bw = torch.randint(-127, 128, (525, 1003), generator=gen, device=dev, dtype=torch.int8)
    bs = torch.rand((1004,), generator=gen, device=dev) * 2e-3 + 1e-4
    cases.append(("offset x[3:], w[5:], scale[1:]", bx[3:], bw[5:], bs[1:]))
    for m, k_, n_ in ((171, 512, 25055), (513, 520, 1003)):  # weights as the model keeps them
        x = torch.randn((m, k_), generator=gen, device=dev).to(torch.bfloat16)
        wq = torch.randint(-127, 128, (k_, n_), generator=gen, device=dev, dtype=torch.int8)
        ws = torch.rand((n_,), generator=gen, device=dev) * 2e-3 + 1e-4
        cases.append((f"[{m},{k_}]x[{k_},{n_}] padded rows", x, align_rows(wq), ws))
    bad = []
    for cfg in CONFIGS:
        for label, x, wq, ws in cases:
            if cfg[1] > (x.shape[1] + 63) // 64:
                continue
            ref = K.w8_matmul_plain(x, wq, ws)
            try:
                got = cfg_call(lib, x, wq, ws, cfg, fill=True)
                torch.cuda.synchronize()
            except RuntimeError as e:
                bad.append(f"{cfg} {label}: {e}")
                continue
            d = (got - ref).abs()
            scale = ref.abs().max().item()
            if not d.max().item() <= 1e-3 * scale:  # NaN fails too
                wrong = (d > 1e-3 * scale) | d.isnan()
                cols = wrong.any(0).nonzero().flatten()[:12].tolist()
                rows = wrong.any(1).nonzero().flatten()[:12].tolist()
                bad.append(f"{cfg} {label}: max|d| {d.max().item():.3e} > 1e-3 * "
                           f"{scale:.3e}; {wrong.float().mean().item():.3f} of entries, "
                           f"columns {cols}, rows {rows}")
    print(f"-- check: {len(bad)} failures" + "".join(f"\n   {b}" for b in bad[:30])
          + f"  ({card})", flush=True)
    return not bad


def sweep_part(cs, dev, gen, lib, card) -> None:
    import torch

    for m, k_, n_ in cs.W8_TIMED:
        x = torch.randn((m, k_), generator=gen, device=dev).to(torch.bfloat16)
        wq = align_rows(torch.randint(-127, 128, (k_, n_), generator=gen, device=dev,
                                      dtype=torch.int8))
        ws = torch.rand((n_,), generator=gen, device=dev) * 2e-3 + 1e-4
        times = {}
        for cfg in CONFIGS:
            if cfg[1] > (k_ + 63) // 64:
                continue
            times[cfg] = cs.graph_us(lambda cfg=cfg: cfg_call(lib, x, wq, ws, cfg))
        got = [ctypes.c_int(), ctypes.c_int()]
        lib.w8_gemm_choice(m, k_, n_, *(ctypes.byref(v) for v in got))
        pick = tuple(v.value for v in got)
        best = sorted(times.items(), key=lambda kv: kv[1])
        print(f"sweep [{m},{k_}]x[{k_},{n_}], us in a CUDA graph (rows, split): "
              + ", ".join(f"{c} {t:.2f}" for c, t in best)
              + f"; w8_config picks {pick} {times.get(pick, float('nan')):.2f}  ({card})",
              flush=True)


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from lele_tpu_torch import kernels as K
    from lele_tpu_torch.kernels import _build

    parts = ("check", "gemm", "layer")
    if "--parts" in argv:
        i = argv.index("--parts")
        parts = tuple(argv[i + 1].split(","))
        argv = argv[:i] + argv[i + 2:]
    old_dir = Path(argv[0]).resolve() if argv else None
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_identity()
    print(card)
    _build.build([s for s in ("w8_gemm", "sanm_stack", "sanm_layer") if s in _build.sources()])
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(cs.SEED)
    ok = True
    with tempfile.TemporaryDirectory() as d:
        if {"check", "sweep"} & set(parts):
            shim = build_shim(Path(d))
            good = shim is not None and ("check" not in parts
                                         or check_part(cs, K, dev, gen, shim, card))
            ok &= good
            if "sweep" in parts and good:
                sweep_part(cs, dev, gen, shim, card)
        libs = {}
        if old_dir is not None:
            libs = build([s for s in ("w8_gemm", "sanm_layer") if (old_dir / f"{s}.cu").exists()],
                         old_dir, Path(d))
        if "gemm" in parts:
            ok &= gemm_part(cs, K, dev, gen, old_w8(libs["w8_gemm"]) if "w8_gemm" in libs
                            else None, card)
        if "layer" in parts:
            lib = libs.get("sanm_layer")
            if lib is None and "sanm_layer" in _build.sources():
                lib = _build.library("sanm_layer")
            ok &= layer_part(cs, K, dev, gen, None if lib is None else seven_launches(lib), card)
    print(f"every result within its gate: {ok}  ({card})")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
