#!/usr/bin/env python3
"""A/B of two versions of the port's kernels 1-12 on one card.

    python3 scripts/torch_port_kernel_ab.py OLD_CSRC_DIR [NEW_CSRC_DIR] [--stems a,b]

Builds csrc/dq_gemm.cu, csrc/sanm_dql.cu, csrc/lstm_seq.cu,
csrc/w4_gemm.cu, csrc/sanm_layer.cu, csrc/sanm_stack.cu, csrc/int8_gemm.cu,
csrc/gru_seq.cu, csrc/flash_attn.cu, csrc/w8_gemm.cu and csrc/est_block.cu,
those of them
that both directories hold (or those `--stems` names), from both (the new
one defaults to lele_tpu_torch/csrc), binds each through the port's own
wrappers (the C entries must share their signatures, but for
`flash_attn`'s workspace argument, which a build without it is called
without; `sanm_stack_dql`, whose parent form took its scratch buffers
apart and is given them here; and the stacks: a version without
csrc/sanm_stack.cu runs them as its csrc/sanm_layer.cu's seven-launch
`sanm_layer_w8` / `sanm_layer_w4` entries looped over the layers), and
times in turns,
old new new old: CUDA events around the call (median of 30 warm runs each),
the device time a call by torch.profiler (the kernels' own time, which
events around a short launch overstate by the host's issue; "not measured"
where no trace came back whole: chip_smoke.device_us), and the time a call
of 20 calls captured in one CUDA graph (the device's time with the gaps
between launches; chip_smoke.graph_us):

- `dq_gemm` at the compiled graph's CTC head at the three buckets' rows
  (T = 36, 100, 196), and its four layer linears at T = 196, 171 and 21;
- `sanm_stack_dql`, 50 layers at d512, ffn 2048, at T = 36, 100, 196 (171
  valid) and 100 (76 valid), both versions within chip_smoke's whole-stack
  noise gate of the plain version (max|d| <= 0.1 max|ref|);
- `lstm_seq` at H = 128, B = 1 over S = 3 (a chunk of the Silero fixture),
  312 (a 10 s native request), 1,875 (60 s) and 18,750 (600 s) steps, with
  cuDNN's `nn.LSTM` on xproj beside it, both versions within
  chip_smoke.LSTM_TOL of the plain version; and a SileroOnnx 10 s request
  (312 calls of S = 3), within chip_smoke.VAD_PROB_TOL of the plain
  override, by events and the profiler only;
- `w4_gemm` (bf16 x, group 128) at the layer linears and the CTC head,
  T = 171 rows; at the decode shapes (M = 1: the QMoE layer's expert widths
  and Phi-3.5-MoE's, both directions; M = 2 and 4 to 9 and 16 at
  Phi-3.5-MoE's [4096 -> 6400], where the decode form (M <= 8 in the group
  form) meets the tile form; the expert-indexed fc1 of a 1-row top-2 step,
  bf16 and f32), each warm (one
  weight, resident in the 50 MB L2) and cold (calls rotate over enough
  copies of the weight to exceed the L2);
- `int8_gemm` at a layer's four linears at M = 21, 171, 684 (the
  quantized batch of 4) and 196 (the per-op compiled graph), at that
  graph's int8 head [196,512]x[512,25055] and at 2,048^3, with
  `torch._int_mm` beside it (N padded to a multiple of 8);
- `sanm_layer_w8` (one layer, T = 171), and `sanm_stack_w8` and
  `sanm_stack_w4`: 50 layers at d512, ffn 2048, random weights, at
  chip_smoke.STACK_T (T = 21, 87 with 76 valid, 171, 196, 1,004), each
  version held to the plain version's layer gate (rtol 2e-2, atol
  2e-2·max|ref| on the valid rows) and reported as the same bits or max|d|;
- `gru_seq` at H = 128 over S = 1,875 and 18,750 steps, B = 1 and 4, both
  `linear_before_reset` forms, with cuDNN's `nn.GRU` on xproj beside it;
- `flash_attn` at chip_smoke's two timed shapes (the TPU script's causal
  B 2 H 8 L 2,048 D 128, and the Phi-3 prefill B 1 H 32 Lq 1,920 Lk 4,096
  D 96 with the graph's own mask), with `F.scaled_dot_product_attention`
  (f32, TF32 off) beside it;
- `w8_gemm` at chip_smoke.W8_TIMED (the B = 1, batch and long-form CTC
  heads, a layer's four linears on the batch path at M = 684 and 1,512,
  MoE's qkv and out at 171), both versions within the plain version's
  bf16 gate (the wgmma form changed its summation order), with `torch.matmul`
  on the weight dequantised to bf16 beside it; each version's C entry is
  called directly on contiguous operands (a parent entry that took bias,
  res and relu gets none of them);
- `estimator_blocks` (tts.json's widths, 8 blocks) at (T, Tk) = (1,024,
  320) and (512, 160), both versions within chip_smoke.EST_TOL of the plain
  version; and on the TTS main path's own traffic: chip_smoke's
  `TtsEngine.synthesize` requests (TTS_TEXTS, the Supertonic 2 and 3
  settings) run once to record each chunk's kernel-10 inputs, a case at
  each (T, Tk) they gave on that call's own tensors, and every request end
  to end (the decoded WAV, by events only: a request reads its durations on
  the host, so it has no CUDA graph), both versions within
  chip_smoke.TTS_REL of the unfused route.

It checks that the two versions give the same bits where both compute the
same exact arithmetic (`dq_gemm`, `int8_gemm`, the layer, `w4_gemm`'s
tile form). Where a redesign sums in another order on
purpose, both versions are held to the plain version's gate instead:
`lstm_seq` to max|d| <= 1e-5 (chip_smoke.LSTM_TOL),
`w4_gemm`'s decode form to 1e-5·max|ref|, `gru_seq` to max|d| <= 1e-5
(chip_smoke.GRU_TOL), `flash_attn` to 1e-5·max|ref| (chip_smoke.FLASH_REL).
A case with a library call times it in the same turns, by events and in a
CUDA graph. It prints the card's name and power limit beside every time.
Random operands come from a seed on the card.
"""

from __future__ import annotations

import ctypes
import statistics
from collections import namedtuple
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
STEMS = ("dq_gemm", "sanm_dql", "lstm_seq", "w4_gemm", "sanm_layer", "sanm_stack", "int8_gemm",
         "gru_seq", "flash_attn", "w8_gemm", "est_block")
DQL_T = ((36, 36), (100, 100), (196, 171), (100, 76))  # kernel 4: (T, valid rows)
EST_T = ((1024, 320), (512, 160))  # kernel 10: (T, Tk)
LSTM_STEPS = (3, 312, 1875, 18750)  # a SileroOnnx chunk, a 10 s native request, 60 s, 600 s
T, L, D, F, H, FK = 196, 50, 512, 2048, 4, 11
SHAPES = ((512, 1536), (512, 512), (512, 2048), (2048, 512), (512, 25055))
T_W = 171  # the native path's rows at 10 s
DQ_HEAD_ROWS = (36, 100)  # the compiled head's other buckets (196 is in SHAPES)
T_SHORT = 21  # the native path's rows at 1 s
# (M, K, N): the decode shapes of kernel 7 (the QMoE layer's expert widths,
# Phi-3.5-MoE's, and the rows where the decode form meets the tile form)
W4_DECODE = ((1, 1024, 1792), (1, 1792, 1024), (1, 4096, 6400), (1, 6400, 4096),
             *((m, 4096, 6400) for m in (2, 4, 5, 6, 7, 8, 9, 16)))
L2_BYTES = 50e6  # the H100's L2
W4_REL = 1e-5
GRU_STEPS = (1875, 18750)
# kernel 11's rows: the dynamic-int8 request at 1 s and 10 s, the quantized
# batch of 4 in the 10 s bucket, the per-op compiled graph's 10 s bucket
I8_ROWS = (T_SHORT, T_W, 4 * T_W, 196)
# a case: fn() and, where its bits may differ between versions, the plain
# version with its gate (relative to max|ref|, or absolute; with `close`,
# torch.allclose at rtol tol and atol tol·max|ref|); a library call timed
# beside it; the calls a CUDA graph holds (fewer for long calls)
Case = namedtuple("Case", "name fn plain tol rel library graph_n close",
                  defaults=(None, W4_REL, True, None, 20, False))


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
    from lele_tpu_torch.kernels import _build, gru, lstm, quant_matmul, sanm_block

    w4 = sys.modules[K.w4_matmul.__module__]
    flash = sys.modules[K.flash_attention.__module__]
    est = K.est_block

    wanted = STEMS
    if "--stems" in argv:
        i = argv.index("--stems")
        wanted = tuple(argv[i + 1].split(","))
        argv = argv[:i] + argv[i + 2:]
    old = Path(argv[0]).resolve()
    new = Path(argv[1]).resolve() if len(argv) > 1 else REPO / "lele_tpu_torch" / "csrc"
    stems = [s for s in STEMS if s in wanted and (old / f"{s}.cu").exists()
             and (new / f"{s}.cu").exists()]
    # the stacks: the new version's sanm_stack.cu against the old version's
    # own (or, without one, its sanm_layer.cu looped)
    stack = "sanm_stack" in wanted and (new / "sanm_stack.cu").exists() and (
        (old / "sanm_stack.cu").exists() or (old / "sanm_layer.cu").exists())
    own = {v: [s for s in STEMS if s in stems or (stack and s in ("sanm_stack", "sanm_layer")
                                                  and (root / f"{s}.cu").exists())]
           for v, root in (("old", old), ("new", new))}
    card = cs.card_identity()
    root_of = {"old": old, "new": new}
    state = {}
    with tempfile.TemporaryDirectory() as d:
        (Path(d) / "old").mkdir()
        (Path(d) / "new").mkdir()
        libs = {"old": build(old, Path(d) / "old", own["old"]),
                "new": build(new, Path(d) / "new", own["new"])}

        def use(version):
            state["version"] = version
            for stem in own[version]:
                _build._libs[stem] = libs[version][stem]
            quant_matmul._dq_fn = None
            sanm_block._dql_fn = None
            sanm_block._layer_fn = None
            sanm_block._stack_fns.clear()
            sanm_block._work_fn = None
            lstm._fn = None
            w4._fn = None
            quant_matmul._i8_fn = None
            quant_matmul._dq_ws_fn = None
            quant_matmul._fn = None
            gru._fn = None
            flash._fn = None
            if "flash_attn" in stems:  # bound here: the parent's entry had no workspace
                _bind_flash(flash, libs[version]["flash_attn"], libs["new"]["flash_attn"])
            if "sanm_dql" in stems:  # bound here: the parent's entry took its scratch apart
                _bind_dql(sanm_block, libs[version]["sanm_dql"])
            if "est_block" in stems:
                _bind_est(est, libs[version]["est_block"])
            if "w8_gemm" in stems:  # the parent's entry, called directly (its signature differs)
                state["w8"] = _w8_direct(libs[version]["w8_gemm"],
                                         "int relu" in (root_of[version] / "w8_gemm.cu").read_text())

        dev = torch.device("cuda", 0)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        cases = []
        dq_shapes = (*((T, k_, n_) for k_, n_ in SHAPES),
                     *((m, *SHAPES[-1]) for m in DQ_HEAD_ROWS),
                     *((t, k_, n_) for t in (T_W, T_SHORT) for k_, n_ in SHAPES[:-1]))
        for m, k_, n_ in dq_shapes if "dq_gemm" in stems else ():
            wq = torch.randint(-127, 128, (k_, n_), generator=gen, device=dev,
                               dtype=torch.int8)
            colsum = wq.to(torch.int32).sum(0, dtype=torch.int32)
            x = torch.randn((m, k_), generator=gen, device=dev)
            _, s, zp = K.dynamic_quantize_u8(x)
            cases.append((f"dq_gemm [{m},{k_}]x[{k_},{n_}]",
                          lambda x=x, wq=wq, c=colsum, s=s, zp=zp:
                          K.fused_dq_matmul(x, wq, c, s, zp, 2.5e-3), None))
        if "sanm_dql" in stems:
            cases += _dql_cases(cs, dev, gen)
        if "lstm_seq" in stems:
            cases += _lstm_cases(cs, dev, gen)
        for k_, n_ in SHAPES if "w4_gemm" in stems else ():
            packed, scales = w4.quantize_weight_int4(
                torch.randn((k_, n_), generator=gen, device=dev) / k_ ** 0.5, 128)
            xw = torch.randn((T_W, k_), generator=gen, device=dev).to(torch.bfloat16)
            cases.append((f"w4_gemm [{T_W},{k_}]x[{k_},{n_}] g128 bf16",
                          lambda x=xw, p=packed, s=scales: K.w4_matmul(x, p, s, 128), None))
        if "w4_gemm" in stems:
            cases += _w4_decode_cases(dev, gen, w4)
        if "int8_gemm" in stems:
            cases += _i8_cases(dev, gen)
        if "sanm_layer" in stems or stack:
            cases += _layer_cases(cs, stems, stack, libs, state, dev, gen)
        if "gru_seq" in stems:
            cases += _gru_cases(cs, dev, gen)
        if "flash_attn" in stems:
            cases += _flash_cases(cs, dev, gen)
        if "w8_gemm" in stems:
            cases += _w8_cases(cs, dev, gen, state)
        if "est_block" in stems:
            cases += _est_cases(cs, dev, gen)
            use("new")
            cases += _tts_cases(cs, dev, est)
        failed = False
        for name, fn, plain, tol, rel, library, graph_n, close in (Case(*c) for c in cases):
            times = {"old": [], "new": []}
            dev_us = {"old": [], "new": []}
            outs, split = {}, {}
            graph = {"old": [], "new": []}
            reps = 10 if graph_n >= 20 else 3
            for version in ("old", "new", "new", "old"):
                use(version)
                try:
                    outs[version] = fn()
                    torch.cuda.synchronize()
                except RuntimeError as e:
                    print(f"{name}: the {version} version fails: {e}")
                    return 1
                # a whole request (no CUDA graph): 5 runs, one call a trace
                times[version].append(cs.time_ms(fn, runs=30 if graph_n else 5))
                rows = cs.device_us(fn, n=graph_n or 1)
                dev_us[version].append(None if rows is None else sum(rows.values()))
                if graph_n:
                    graph[version].append(cs.graph_us(fn, n=graph_n, reps=reps))
                split[version] = ("no whole trace" if rows is None else
                                  ", ".join(f"{k[:40]} {v:.2f}" for k, v in sorted(rows.items())))
            if plain is None:
                ok = torch.equal(outs["old"], outs["new"])
                verdict = f"same bits {ok}"
            else:  # both versions within the gate of the plain version
                ref = plain()
                scale = ref.abs().max().item() if rel else 1.0
                d = {v: (outs[v] - ref).abs().max().item() for v in ("old", "new")}
                if close:
                    ok = all(torch.allclose(outs[v], ref, rtol=tol, atol=tol * scale)
                             for v in ("old", "new"))
                    gate = f"allclose rtol {tol:g}, atol {tol:g} * {scale:.3e}"
                else:
                    ok = all(x <= tol * scale for x in d.values())
                    gate = f"<= {tol:g}{f' * {scale:.3e}' if rel else ''}"
                same = torch.equal(outs["old"], outs["new"])
                d_on = (outs["old"] - outs["new"]).abs().max().item()
                verdict = (f"vs plain max|d| old {d['old']:.3e}, new {d['new']:.3e}, {gate}: "
                           f"{ok}; old vs new same bits {same}, max|d| {d_on:.3e}")
            failed |= not ok
            if library is not None:  # the PyTorch call, by events and in a CUDA graph
                lib_ms = cs.time_ms(library, runs=30)
                try:
                    lib_g = f"{cs.graph_us(library, n=graph_n, reps=reps):.2f} us"
                except RuntimeError as e:
                    lib_g = f"not measured (no capture: {str(e)[:80]})"
                verdict += (f"; library {lib_ms:.4f} ms by events, {lib_g} in a CUDA graph; "
                            f"new / library by events "
                            f"{statistics.mean(times['new']) / lib_ms:.3f}")
            in_graph = (f"in a CUDA graph old {statistics.mean(graph['old']):.2f} us "
                        f"({', '.join(f'{t:.2f}' for t in graph['old'])}), new "
                        f"{statistics.mean(graph['new']):.2f} us "
                        f"({', '.join(f'{t:.2f}' for t in graph['new'])})" if graph_n
                        else "no CUDA graph")
            print(f"{name}: old {statistics.mean(times['old']):.4f} ms "
                  f"({', '.join(f'{t:.4f}' for t in times['old'])}), new "
                  f"{statistics.mean(times['new']):.4f} ms "
                  f"({', '.join(f'{t:.4f}' for t in times['new'])}) by events; device "
                  f"by the profiler old {_mean_us(dev_us['old'])}, new "
                  f"{_mean_us(dev_us['new'])}; {in_graph} [kernels, us: old "
                  f"{split['old']}; new {split['new']}]; {verdict}  ({card})")
    return 1 if failed else 0


def _w8_direct(lib, with_epilogue: bool):
    """A version's kernel-2 entry as a w8_matmul-like call on contiguous
    operands (a parent entry that also took bias, res and relu gets none of
    them; the new form writes rows padded to 16 bytes)."""
    import torch

    P, I = ctypes.c_void_p, ctypes.c_int
    fn = lib.w8_gemm
    fn.restype = ctypes.c_int
    fn.argtypes = ([P, I, P, P, P, P, P, I, I, I, I, P] if with_epilogue
                   else [P, I, P, I, P, P, I, I, I, I, P])

    def call(x, wq, ws):
        M, K = x.shape
        N = wq.shape[1]
        ldy = N if with_epilogue else -(-N // 4) * 4  # the new form's rows 16-byte aligned
        y = torch.empty((M, ldy), dtype=torch.float32, device=x.device)[:, :N]
        st = torch.cuda.current_stream().cuda_stream
        args = ((x.data_ptr(), 1, wq.data_ptr(), ws.data_ptr(), None, None, y.data_ptr(), M, K,
                 N, 0, st) if with_epilogue else
                (x.data_ptr(), 1, wq.data_ptr(), N, ws.data_ptr(), y.data_ptr(), ldy, M, K, N, st))
        code = fn(*args)
        if code:
            raise RuntimeError(f"w8_gemm: CUDA error {code}: {lib.lele_error_string(code)}")
        return y
    return call


def _bind_flash(flash, lib, new_lib) -> None:
    """Kernel 12's entries for the wrapper: `flash_attn` of the version
    timed, and the workspace's size from the new build. The redesign added a
    workspace pointer before the stream; a build without it is called
    without that argument."""
    P, I, F, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    args = [P, P, P, P, LL, LL, LL, LL, P, I, I, I, I, I, I, F, I]
    fn = lib.flash_attn
    fn.restype = ctypes.c_int
    if hasattr(lib, "flash_attn_work_bytes"):
        fn.argtypes = args + [P, P]
    else:
        fn.argtypes = args + [P]
        fn = (lambda f: lambda *a: f(*a[:-2], a[-1]))(fn)
    work = new_lib.flash_attn_work_bytes
    work.argtypes = [I, I, I, I, I, I, I, I, LL, LL]
    work.restype = LL
    flash._fn, flash._work_fn = fn, work


def _bind_dql(sanm_block, lib) -> None:
    """Kernel 4's entry for the wrapper. The one-launch form takes one work
    buffer and a trace pointer; the parent's eleven-launch form took h, qkv,
    a, f1 (f32), the codes (int8) and the range pairs, which are made here."""
    import torch

    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    head = [P, I, I, I, I, I, I, I, F, F, F, P, P] + [P] * 21
    fn = lib.sanm_stack_dql
    fn.restype = ctypes.c_int
    if hasattr(lib, "sanm_dql_work_bytes"):
        fn.argtypes = head + [P, P, P]
        work = lib.sanm_dql_work_bytes
        work.argtypes = [I] * 5
        work.restype = ctypes.c_longlong
        sanm_block._dql_fn, sanm_block._dql_work_fn = fn, work
        return
    fn.argtypes = head + [P] * 6 + [P]

    def old(*a):
        T, D, F_, L = a[1], a[2], a[4], a[5]
        dev = torch.device("cuda", torch.cuda.current_device())
        bufs = [torch.empty((T, n), dtype=torch.float32, device=dev) for n in (D, 3 * D, D, F_)]
        bufs.append(torch.empty((T, max(D, F_)), dtype=torch.int8, device=dev))
        bufs.append(torch.empty((L, 4, 2), dtype=torch.int32, device=dev))
        return fn(*a[:-3], *(b.data_ptr() for b in bufs), a[-1])

    sanm_block._dql_fn, sanm_block._dql_work_fn = old, lambda *a: 0


def _bind_est(est, lib) -> None:
    """Kernel 10's entry for the wrapper: `estimator_blocks` of the version
    timed, bound here (the wrapper binds its own build once)."""
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = lib.estimator_blocks
    fn.argtypes = [P, P, P, P, I, I, I, I, I, I] + [P] * 14 + [P] * 6 + [P]
    fn.restype = ctypes.c_int
    est._fn = fn


def _dql_cases(cs, dev, gen):
    """Kernel 4, 50 layers at d512, ffn 2048, at the compiled buckets' rows
    and the ragged bucket: both versions within chip_smoke's whole-stack
    noise gate of the plain version (max|d| <= 0.1 max|ref|)."""
    import torch

    from lele_tpu_torch import kernels as K

    st = cs.random_dql_stack(L, D, F, FK, dev, gen)
    cases = []
    for t, valid in DQL_T:
        bias, vmask = cs.dql_masks(L, t, valid, dev)
        x = torch.randn((t, D), generator=gen, device=dev)
        args = (x, bias, vmask, st, H, FK, (FK - 1) // 2)
        cases.append(Case(f"sanm_stack_dql T={t} valid={valid} L={L}",
                          lambda args=args: K.sanm_stack_dql(*args),
                          lambda args=args: K.sanm_stack_dql_plain(*args), cs.STACK_NOISE_MAX))
    return cases


def _est_cases(cs, dev, gen):
    """Kernel 10, tts.json's widths (D 256, 4 heads, F 1,024, 8 blocks), at
    chip_smoke's two timed shapes: both versions within chip_smoke.EST_TOL of
    the plain version."""
    import dataclasses

    import torch

    from lele_tpu_torch import kernels as K
    from lele_tpu_torch.models import SupertonicConfig
    from lele_tpu_torch.models.supertonic import init_vector_estimator

    cfg = dataclasses.replace(
        SupertonicConfig.from_json(REPO / "examples" / "supertonic" / "tts.json"),
        fused_estimator=True)
    blocks = init_vector_estimator(gen, cfg)["blocks_stacked"]
    cases = []
    for t, tk in EST_T:
        args = (torch.randn((t, cfg.d_text), generator=gen, device=dev),
                torch.randn((tk, cfg.d_text), generator=gen, device=dev),
                torch.ones((t,), device=dev), torch.ones((tk,), device=dev), blocks, cfg.n_heads)
        cases.append(Case(f"est_block T={t} Tk={tk}, 8 blocks",
                          lambda args=args: K.estimator_blocks(*args),
                          lambda args=args: K.estimator_blocks_plain(*args), cs.EST_TOL))
    return cases


def _tts_cases(cs, dev, est):
    """Kernel 10 on the TTS main path's traffic (chip_smoke phase 20's
    engines and requests): each distinct (T, Tk) a request's chunks give,
    on the first such call's own inputs, within chip_smoke.EST_TOL of the
    plain version; then each request end to end, the decoded WAV within
    chip_smoke.TTS_REL of the unfused route."""
    import dataclasses

    import torch

    from lele_tpu_torch import kernels as K
    from lele_tpu_torch.models import SupertonicConfig, SupertonicTts
    from lele_tpu_torch.serving import TtsEngine
    from lele_tpu_torch.utils.wav import decode_wav_bytes

    cfg = dataclasses.replace(
        SupertonicConfig.from_json(REPO / "examples" / "supertonic" / "tts.json"),
        fused_estimator=True)
    tts2 = SupertonicTts(cfg, device=dev)
    tts2.init(cs.SEED)
    cfg3 = dataclasses.replace(cfg, apply_latent_denorm=False, speed=1.05)
    engines = {"v2": TtsEngine(tts=tts2),
               "v3": TtsEngine(tts=SupertonicTts(cfg3, params=tts2.params, device=dev))}
    engines["v2"].load_style(str(REPO / "examples" / "supertonic" / "voice_styles" / "F1.json"),
                             "F1")
    engines["v3"].load_style(str(REPO / "examples" / "supertonic3" / "voice_styles" / "M2.json"),
                             "M2")
    seen = {}
    launch = est.estimator_blocks_kernel

    def record(x, text, lm, tm, stacked, H):
        key = (x.shape[0], text.shape[0])
        seen.setdefault(key, [tuple(t.clone() for t in (x, text, lm, tm)) + (stacked, H), 0])
        seen[key][1] += 1
        return launch(x, text, lm, tm, stacked, H)

    est.estimator_blocks_kernel = record
    try:  # uncaptured, so that every call of the wrapper is a launch
        for eng in engines.values():
            for i, t in enumerate(cs.TTS_TEXTS):
                eng.tts.synthesize_uncaptured(t, next(iter(eng.styles.values())), seed=i)
    finally:
        est.estimator_blocks_kernel = launch
    print("kernel 10 on the TTS requests: (T, Tk): calls "
          + ", ".join(f"{k}: {n}" for k, (_, n) in sorted(seen.items())))
    cases = []
    for (t, tk), (args, n) in sorted(seen.items()):
        valid = (int(args[2].sum().item()), int(args[3].sum().item()))
        cases.append(Case(f"est_block T={t} Tk={tk} (a TTS chunk, valid {valid}, {n} calls "
                          "over the requests)",
                          lambda args=args: K.estimator_blocks(*args),
                          lambda args=args: K.estimator_blocks_plain(*args), cs.EST_TOL))

    def pcm(eng, text, seed):
        return torch.from_numpy(decode_wav_bytes(eng.synthesize(text, seed=seed))[0])

    def unfused(eng, text, seed):
        un = dataclasses.replace(eng.tts, cfg=dataclasses.replace(eng.tts.cfg,
                                                                  fused_estimator=False))
        style = next(iter(eng.styles.values()))
        return torch.from_numpy(un.synthesize(text, style, seed=seed))

    for v, eng in engines.items():
        for i, text in enumerate(cs.TTS_TEXTS):
            cases.append(Case(f"TtsEngine.synthesize {v} request {i} ({len(text)} chars)",
                              lambda e=eng, t=text, s=i: pcm(e, t, s),
                              lambda e=eng, t=text, s=i: unfused(e, t, s), cs.TTS_REL,
                              graph_n=0))
    return cases


def _mean_us(ts) -> str:
    """The mean of the profiler's readings and each one; a trace that never
    came back whole reads "not measured" and is left out of the mean."""
    got = [t for t in ts if t is not None]
    each = ", ".join("not measured" if t is None else f"{t:.2f}" for t in ts)
    return f"{statistics.mean(got):.2f} us ({each})" if got else f"not measured ({each})"


def _gru_cases(cs, dev, gen):
    """Kernel 9 at H = 128, B = 1 and 4, both forms, with cuDNN's nn.GRU
    (linear_before_reset only: its one form) on the same xproj."""
    import torch

    from lele_tpu_torch import kernels as K

    cases = []
    for S in GRU_STEPS:
        for B in (1, 4):
            args = cs.gru_inputs(S, B, 128, dev, gen)
            net = cs.cudnn_gru(args[1], args[2], dev)

            def library(net=net, args=args):
                with torch.no_grad(), torch.backends.cudnn.flags(enabled=True,
                                                                 allow_tf32=False):
                    return net(args[0], args[3][None])[0]

            for lbr in (True, False):
                cases.append(Case(
                    f"gru_seq S={S} B={B} H=128 linear_before_reset={int(lbr)}",
                    lambda args=args, lbr=lbr: torch.cat(
                        [t.reshape(-1) for t in K.gru_seq(*args, lbr)]),
                    lambda args=args, lbr=lbr: torch.cat(
                        [t.reshape(-1) for t in K.gru_seq_plain(*args, lbr)]),
                    cs.GRU_TOL, False, library if lbr else None, 2 if S > 2000 else 20))
    return cases


def _flash_cases(cs, dev, gen):
    """Kernel 12 at chip_smoke's two timed shapes, with SDPA beside it."""
    import torch.nn.functional as F

    from lele_tpu_torch import kernels as K

    cases = []
    for shape in cs.FLASH_SHAPES:
        B, H, KVH, Lq, Lk, D, causal, kind = shape
        if (B, H, Lq, D) not in cs.FLASH_TIMED:
            continue
        q, k, v, mask, scale = cs.flash_inputs(shape, dev, gen)
        sdpa_mask = None if mask is None else mask.expand(B, H, Lq, Lk)
        cases.append(Case(
            f"flash_attn B={B} H={H}/{KVH} Lq={Lq} Lk={Lk} D={D} causal={causal} mask={kind}",
            lambda q=q, k=k, v=v, m=mask, c=causal, s=scale: K.flash_attention(q, k, v, m, c, s),
            lambda q=q, k=k, v=v, m=mask, c=causal, s=scale:
                K.flash_attention_plain(q, k, v, m, c, s),
            cs.FLASH_REL, True,
            lambda q=q, k=k, v=v, m=sdpa_mask, c=causal, s=scale:
                F.scaled_dot_product_attention(q, k, v, attn_mask=m, is_causal=c, scale=s)))
    return cases


def _w8_cases(cs, dev, gen, state):
    """Kernel 2 at every shape its paths run (chip_smoke.W8_TIMED), both
    versions within chip_smoke's bf16 gate of the plain version (max|d| <=
    1e-3 max|ref|: the wgmma form sums in another order), with
    torch.matmul on the weight dequantised to bf16 (chip_smoke's library
    call). Each version's entry is called directly on contiguous operands
    (a new form takes the same call as the parent's)."""
    import torch

    from lele_tpu_torch import kernels as K

    cases = []
    for m, k_, n_ in cs.W8_TIMED:
        x = torch.randn((m, k_), generator=gen, device=dev).to(torch.bfloat16)
        wq = torch.randint(-127, 128, (k_, n_), generator=gen, device=dev, dtype=torch.int8)
        ws = torch.rand((n_,), generator=gen, device=dev) * 2e-3
        w_bf16 = (wq.float() * ws).to(torch.bfloat16)
        cases.append(Case(f"w8_gemm [{m},{k_}]x[{k_},{n_}] bf16",
                          lambda x=x, wq=wq, ws=ws: state["w8"](x, wq, ws),
                          lambda x=x, wq=wq, ws=ws: K.w8_matmul_plain(x, wq, ws), 1e-3,
                          library=lambda x=x, w=w_bf16: torch.matmul(x, w)))
    return cases


def _i8_cases(dev, gen):
    """Kernel 11 at every shape its paths run (a layer's four linears at
    I8_ROWS, the per-op graph's int8 head at T = 196) and 2,048^3, with
    torch._int_mm beside it (N padded to a multiple of 8 where it needs it;
    the padding's column is not timed apart)."""
    import torch

    from lele_tpu_torch import kernels as K

    shapes = (*((m, k_, n_) for m in I8_ROWS for k_, n_ in SHAPES[:-1]),
              (196, *SHAPES[-1]), (2048, 2048, 2048))
    cases = []
    for m, k_, n_ in shapes:
        a = torch.randint(-128, 128, (m, k_), generator=gen, device=dev, dtype=torch.int8)
        b = torch.randint(-128, 128, (k_, n_), generator=gen, device=dev, dtype=torch.int8)
        b8 = torch.nn.functional.pad(b, (0, -n_ % 8))
        cases.append(Case(f"int8_gemm [{m},{k_}]x[{k_},{n_}]",
                          lambda a=a, b=b: K.int8_matmul(a, b),
                          library=lambda a=a, b=b8: torch._int_mm(a, b)))
    return cases


def _lstm_cases(cs, dev, gen):
    """Kernel 6 at H = 128, B = 1 over LSTM_STEPS, with cuDNN's nn.LSTM on
    the same xproj (W_ih = I, chip_smoke phase 10's form); then a SileroOnnx
    10 s request at 16 kHz (312 kernel-6 calls of S = 3), both versions
    within chip_smoke.VAD_PROB_TOL of the lstm_plain override, timed by
    events and by the profiler's device time (no CUDA graph: a request reads
    its probabilities back)."""
    import numpy as np
    import torch

    from lele_tpu_torch import kernels as K
    from lele_tpu_torch.models import SileroOnnx
    from lele_tpu_torch.ops import nn_ops

    cases = []
    for S in LSTM_STEPS:
        args = cs.lstm_inputs(S, 1, 128, dev, gen)
        net = cs.cudnn_lstm(args[1], dev)

        def library(net=net, args=args):
            with torch.no_grad(), torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
                return net(args[0], (args[2][None], args[3][None]))[0]

        cases.append(Case(f"lstm_seq S={S} B=1 H=128",
                          lambda args=args: torch.cat([t.reshape(-1) for t in K.lstm_seq(*args)]),
                          lambda args=args: torch.cat(
                              [t.reshape(-1) for t in K.lstm_seq_plain(*args)]),
                          cs.LSTM_TOL, False, library, 2 if S > 2000 else 20))
    sv = SileroOnnx(cs.SILERO_FIXTURE, device=dev)
    sv_plain = SileroOnnx(cs.SILERO_FIXTURE, device=dev, overrides={"LSTM": nn_ops.lstm_plain})
    pcm = cs.vad_pcm(10.0, cs.VAD_SR, np.random.default_rng(cs.SEED + 3))
    cases.append(Case(f"SileroOnnx.speech_probs 10 s at {cs.VAD_SR} Hz ({len(pcm) // 512} "
                      "chunks, lstm_seq S=3 each)",
                      lambda: torch.from_numpy(sv.speech_probs(pcm, cs.VAD_SR)),
                      lambda: torch.from_numpy(sv_plain.speech_probs(pcm, cs.VAD_SR)),
                      cs.VAD_PROB_TOL, False, graph_n=0))
    return cases


def _w4_decode_cases(dev, gen, w4):
    """Kernel 7 at the decode shapes, warm and cold, and the expert-indexed
    fc1 of a 1-row top-2 decode step; each case carries its plain version."""
    import torch

    from lele_tpu_torch import kernels as K

    cases = []
    for m, k_, n_ in W4_DECODE:
        w = torch.randn((k_, n_), generator=gen, device=dev) / k_ ** 0.5
        packed, scales = w4.quantize_weight_int4(w, 128)
        x = torch.randn((m, k_), generator=gen, device=dev).to(torch.bfloat16)
        nbytes = packed.numel() + 4 * scales.numel()
        copies = int(L2_BYTES // nbytes) + 2  # a set larger than the L2
        ws = [(packed.clone(), scales.clone()) for _ in range(copies)]
        turn = [0]

        def cold(x=x, ws=ws, turn=turn):
            turn[0] = (turn[0] + 1) % len(ws)
            return K.w4_matmul(x, *ws[turn[0]], 128)

        def plain_cold(x=x, ws=ws, turn=turn):
            return w4.w4_matmul_plain(x, *ws[turn[0]], 128)

        shape = f"[{m},{k_}]x[{k_},{n_}] g128 bf16"
        cases.append((f"w4_gemm decode {shape} warm",
                      lambda x=x, p=packed, s=scales: K.w4_matmul(x, p, s, 128),
                      lambda x=x, p=packed, s=scales: w4.w4_matmul_plain(x, p, s, 128)))
        cases.append((f"w4_gemm decode {shape} cold ({copies} weights, "
                      f"{copies * nbytes / 1e6:.0f} MB)", cold, plain_cold))
    e, hidden, inter = 8, 1024, 1792
    packed = torch.randint(-128, 128, (e, hidden // 2, inter), generator=gen, device=dev,
                           dtype=torch.int8)
    scales = torch.rand((e, hidden // 128, inter), generator=gen, device=dev) * 0.01 + 1e-3
    idx = torch.tensor([3, 6], dtype=torch.int32, device=dev)
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.randn((2, hidden), generator=gen, device=dev).to(dtype)
        cases.append((f"w4_gemm expert-indexed [2,{hidden}] x stacks [{e},{hidden // 2},"
                      f"{inter}] g128 {str(dtype)[6:]}",
                      lambda x=x: K.w4_matmul(x, packed, scales, 128, idx),
                      lambda x=x: w4.w4_matmul_plain(x, packed, scales, 128, idx)))
    return cases


def _looped_layers(lib, fmt, x, mask, st, H, FK, group=128):
    """A stack as a version without csrc/sanm_stack.cu runs it: its
    sanm_layer.cu's seven-launch entry for each layer, on per-layer pointers
    into the stacked weights, in place on one [T, D] f32 buffer."""
    import torch

    from lele_tpu_torch.kernels import sanm_block

    P, I = ctypes.c_void_p, ctypes.c_int
    fn = getattr(lib, f"sanm_layer_{fmt}")
    fn.argtypes = ([P, P] + [I] * (5 if fmt == "w8" else 6) + [P] * 5 + [P, I] + [P] * 11
                   + [P] * 5)
    fn.restype = ctypes.c_int
    y = x.to(torch.float32).contiguous().clone()
    T, D = y.shape
    n_layers, ts, F, ptrs, strides = sanm_block.layer_pointers(st, y.device, D, FK, fmt, group,
                                                               "looped", stacked=True)
    scratch = [torch.empty((T, n), dtype=torch.float32, device=y.device)
               for n in (D, 3 * D, D, F)]
    ints = (T, D, H, F, FK) + ((group,) if fmt == "w4" else ())
    stream = torch.cuda.current_stream(y.device).cuda_stream
    for i in range(n_layers):
        p = [None if q is None else q + i * b for q, b in zip(ptrs, strides)]
        code = fn(y.data_ptr(), mask.data_ptr(), *ints, *p[0:5], p[5],
                  int(ts[5].dtype == torch.bfloat16), *p[6:17],
                  *(s_.data_ptr() for s_ in scratch), stream)
        if code:
            raise RuntimeError(f"sanm_layer_{fmt}: CUDA error {code}: "
                               f"{lib.lele_error_string(code).decode()}")
    return y


def _layer_cases(cs, stems, stack, libs, state, dev, gen):
    """Kernel 3 (one layer, T = 171), and the w8 and w4 stacks at the native
    path's full width at chip_smoke.STACK_T, each version against the plain
    version's layer gate."""
    import torch

    from lele_tpu_torch import kernels as K
    from lele_tpu_torch.kernels.sanm_block import layer_view

    cases = []
    trees = {fmt: cs.stack_tree(flag, dev) for fmt, flag in (("w8", "weight_int8"),
                                                              ("w4", "weight_int4"))}
    if "sanm_layer" in stems:
        x = torch.randn((T_W, D), generator=gen, device=dev) * 0.5
        mask = torch.ones((T_W,), device=dev)
        lp0 = layer_view(trees["w8"], 0)
        cases.append(Case(f"sanm_layer_w8 T={T_W}", lambda: K.sanm_layer_w8(x, mask, lp0, H, FK)))
    if not stack:
        return cases
    for fmt, st in trees.items():
        fn, plain = K.KERNEL_WRAPPERS[f"sanm_stack_{fmt}"], getattr(K, f"sanm_stack_{fmt}_plain")
        for T, valid in cs.STACK_T:
            x = torch.randn((T, D), generator=gen, device=dev) * 0.5
            mask = torch.zeros((T,), device=dev)
            mask[:valid] = 1.0

            def run(fn=fn, fmt=fmt, st=st, x=x, mask=mask, valid=valid):
                lib = libs[state["version"]]
                if "sanm_stack" in lib:
                    return fn(x, mask, st, H, FK)[:valid]
                return _looped_layers(lib["sanm_layer"], fmt, x, mask, st, H, FK)[:valid]

            cases.append(Case(f"sanm_stack_{fmt} T={T} valid={valid} L={L}", run,
                              lambda plain=plain, st=st, x=x, mask=mask, valid=valid:
                              plain(x, mask, st, H, FK)[:valid],
                              2e-2, True, None, 5 if T > 500 else 20, True))
    return cases


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
