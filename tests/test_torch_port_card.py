"""Kernels 1, 2, 4, 5, 6, 7, 8, 9, 11 and 12 in their redesigned forms, and
kernels 3 and 10, held against their plain versions on an NVIDIA card.

Kernel 7's decode form (csrc/w4_gemv.cuh: few rows and the expert-indexed
entry) sums in another f32 order than `w4_matmul_plain`, so it is held to
1e-5·max|ref| (the gate chip_smoke.py holds every form of kernel 7 to) and
to the same bits on a repeat call. Kernel 5's strip form, and its tile form
where N and K are both at most 512 (csrc/dq_gemm.cuh), form exact int32
sums and the plain version's f32 epilogue, so they must give
`fused_dq_matmul_plain`'s bits.

Kernel 9's register form (csrc/gru_seq.cu, H <= 128) is held to
chip_smoke.GRU_TOL (max|d| <= 1e-5 of hs and h_S) in both
linear_before_reset forms at H = 1, 33, 64, 100 and 128. Kernel 12
(csrc/flash_attn.cu: 3xTF32 on mma.sync, exact skipping of dead key tiles)
takes every case of chip_smoke.FLASH_SHAPES at phase 23's gates
(FLASH_REL against the plain version; against an f64 oracle within 2e-2
and 3 x max(the plain version's error, 1e-6)), and must visit exactly the
key tiles that `skippable_tiles` leaves; and a small Phi-3-form decoder's
prefill (from slot 0 and a chunk from slot 128) on the kernel against the
plain-Attention compile at chip_smoke.LLM_REL.

Kernels 1 and 8 (csrc/sanm_stack.cu: the w8a16 and w4a16 SAN-M stacks as one
cooperative launch) are held to their plain versions at the layer gate
(rtol 2e-2, atol 2e-2·max|ref| on the valid rows) at the full width (50
layers, d512, 4 heads of 128, ffn 2048) for T = 1, 21, 64, 65, 87 (76 valid),
171, 196 and 1,004, and at d256 with head dims 32, 64 and 128, 1 and 2
layers, f32 and bf16 FSMN taps; a repeat call and a CUDA-graph replay must
give the eager call's bits, each call is one launch, and one call's
profiler trace holds one stack kernel and no other kernel of the port.

Kernel 4 (csrc/sanm_dql.cu: the compiled int8 SAN-M stack as one
cooperative launch) is held to its plain version at the layer gate on two
small layers (d256, ffn 512) at head dims 32, 64 and 128 for T = 36, 100,
196 (171 valid), 100 (76 valid) and 2,048, at the DQL edges (an all-zero
LN1 output, a constant input, the FSMN's pad at 0 and k - 1), and at the
full width (50 layers) to chip_smoke's whole-stack noise gate; a repeat call
and a CUDA-graph replay must give the eager call's bits, and one call is one
kernel node in a CUDA graph. Kernel 10 (csrc/est_block.cu, its
launches a block) is held to chip_smoke.EST_TOL at every
chip_smoke.EST_SHAPES case, at the TTS requests' buckets, at head dims 32
and 128, Tk = 1, many key tiles and T past 4,096, with the repeat and
graph-replay bits.

Kernel 11 (csrc/int8_gemm.cu, on kernel 5's strip core) forms exact int32
sums: it must equal `int8_matmul_plain` at the dynamic-int8 and per-op
paths' shapes (M = 1, 21, 171, 684, 196; the int8 head; 2,048^3), at odd
M, K and N and at the +-127 / -128 extremes at K = 2,048, in one launch a
call. Kernel 6 (csrc/lstm_seq.cu: the register form up to H = 128, the
cluster form above) is held to chip_smoke.LSTM_TOL at S = 1, 3, 312 and
1,875, B = 1 and 3, H = 1, 16, 64, 96, 128 and 129, with the repeat and
graph-replay bits.

Kernel 2 (csrc/w8_gemm.cu: bf16 x on the warpgroup MMA, csrc/w8_wgmma.cuh;
f32 x as f32 FMA) is held to chip_smoke's gates (max|d| <= 1e-3·max|ref|
for bf16 x, 1e-5·max|ref| for f32 x) at M = 1, 171, 513, 684 and 1,512 for
every chip_smoke.GEMM_SHAPES entry, at K = 520 with N = 25,055, on
operands offset by slicing and on the heads' weights with their rows padded
as the model keeps them; a repeat call and a CUDA-graph replay must
give the eager call's bits, and each call is one launch. Kernel 3
(csrc/sanm_layer.cu, seven launches a layer) is held to its plain version
at the layer gate at T = 21, 87 (76 valid), 171 and 1,004, head dims 32,
64 and 128, f32 and bf16 FSMN taps.

The TTS synth programs (kernel 10 inside the graph), two TtsEngine requests
at two buckets alternating through one `Programs`, `compose_models`,
SupertonicOnnx's composed program, and the decode step program (greedy,
sampled, beam, two decoders alternating) are held to their uncaptured
oracles: the same bits and launch counts. A program dropped in a reference
cycle is not collected while another is captured (destroying its graph
there would invalidate the capture): the collector is off inside every
capture and the dropped program goes at the next collection after it.

YOLO26 runs no kernel of the port's own: the Conv emitter's 2-D forms and
the native head maps (detect and seg, f32 and bf16, full width) are held to
the CPU on the card, at 1e-5·max|ref| and chip_smoke.YOLO_MAP_REL.

The tracer's Scan and Loop (chip_smoke phase 34): Silero's utterance as one
Scan and one Loop over the fixture's step at both rates (one captured graph
a call, kernel 6 a chunk, SileroOnnx.speech_probs' bits), a padded Loop
and a reversed Scan against their step-by-step replays, and a
function-packaged int8 SAN-M export (4 layers at full width: kernel 4 once
a call, the flat export's bits).

The ORT-GenAI decoder form (chip_smoke phase 35): a GroupQueryAttention
decode step at B = 2 with unequal lengths captured with its caches donated
against its replay's bits; the small GenAI decoder from a side file with
its caches donated in graph order (each present on its own past) against
its replay and the CPU; fp8 initializers on the card as torch float8.

The entry points (chip_smoke phase 38): the CLI's generated wrapper of a
small int8 SAN-M graph captured against its `replay()` bits with kernels 4
and 5 once a call, and a changed blob changing its output; a burst of 8
concurrent /recognize requests to the port's server over a small w8a16
engine, each answer what `recognize_batch` gives the batch it joined;
every route at once over the tiny engines on the card, twice (the first
round captures its programs while other requests are in flight), each
answer the engine's direct call; a deduplicated leaf of `load_pytree` on
the card written in place without changing its twin.

The com.microsoft search and packed sets (chip_smoke phase 40) at small
widths: an int8 GPT-2 BeamSearch export bound by bind_inputs with kernel 5
in every decoder walk of the captured loop, GreedySearch and Sampling (the
same seed the same rollout on every captured call), WhisperBeamSearch over
the DecoderMasked step graph and the packed BERT stack, each captured
against its replay (also under sync debug mode "error") and the CPU.

Training (chip_smoke phase 41) at dryrun_multichip's config: one train
step's loss, gradients and update on the card against the port's CPU run,
and remat's gradients the same bits as without it.

The multi-device layer (chip_smoke phase 42) in an NCCL group of one rank
(every mesh axis of size 1, so no collective runs): a GPipe pipeline
stage of kernel 1 over a stacked w8 tree, 4 rows in 2 microbatches, the
bits of one launch a row; the MHA encoder compiled over a one-rank mesh
with Megatron rules and seq_axis, captured, the mesh-free compile's bits;
the small GenAI decoder with `_q` / `_s` column rules, kernel 7 on the
rank's columns, the mesh-free compile's bits.

Every case needs the card and skips without one. The repository's conftest
imports jax, which the card's machine does not have, so run this file there
without it:

    python -m pytest tests/test_torch_port_card.py --noconftest -q
"""

from __future__ import annotations

import importlib
import json

import numpy as np
import pytest
import torch

import chip_smoke as cs

from lele_tpu_torch import kernels as K

W4 = importlib.import_module("lele_tpu_torch.kernels.w4_matmul")
W4_REL = 1e-5
# MOE_DECODE's expert widths (lele_tpu_torch/onnx/synth.py) and Phi-3.5-MoE's
MOE = (8, 1024, 1792)
PHI = (4096, 6400)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: kernels 5 and 7 are CUDA C++ (csrc/) with no CPU "
                    "form; chip_smoke.py runs these checks on the card too")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _w4_operands(gen, dev, k, n, group, stacks=None):
    lead = () if stacks is None else (stacks,)
    packed = torch.randint(-128, 128, (*lead, k // 2, n), generator=gen, device=dev,
                           dtype=torch.int8)
    scales = torch.rand((*lead, k // group, n), generator=gen, device=dev) * 0.01 + 1e-3
    return packed, scales


def _w4_check(x, packed, scales, group, idx=None):
    got = K.w4_matmul(x, packed, scales, group, idx)
    again = K.w4_matmul(x, packed, scales, group, idx)
    ref = W4.w4_matmul_plain(x, packed, scales, group, idx)
    torch.cuda.synchronize()
    d = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    assert got.shape == ref.shape and bool(torch.isfinite(got).all())
    assert d <= W4_REL * scale, f"max|d| {d:.3e} > {W4_REL:g} * {scale:.3e}"
    assert torch.equal(got, again), "a repeat call changed the bits"


# (M, K, N, group): the group-accumulator form at M = 1, 2, 4, 5, 7, 8 (the
# decode form takes it up to 8 rows; the f32 and dequantised-tile forms up
# to 4, then the tile form); its k-step-8 groups (8, 24, and 24 at M = 6);
# the dequantised-tile form (K = 1,040 group 8, a
# group of 12, group 1, and group 128 straddling the nibble planes at
# K = 384); odd N; Phi-3.5-MoE's widths, where a cluster splits K
W4_SHAPES = [
    (1, 1024, 1792, 128), (2, 1024, 1792, 128), (4, 1024, 1792, 128), (8, 1024, 1792, 128),
    (5, 1024, 1792, 128), (7, 1024, 1001, 128), (6, 768, 1536, 24),
    (1, 512, 1536, 8), (3, 768, 1536, 24), (1, 1040, 1536, 8), (2, 1032, 1000, 12),
    (1, 1024, 520, 1), (4, 384, 256, 128), (1, 1024, 1001, 128), (3, 1792, 1003, 64),
    (1, *PHI, 128), (1, *PHI[::-1], 128),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("m,k,n,group", W4_SHAPES)
def test_w4_decode_form_matches_plain(dev, dtype, m, k, n, group):
    gen = torch.Generator(device=dev).manual_seed(m + k + n + group)
    packed, scales = _w4_operands(gen, dev, k, n, group)
    x = torch.randn((m, k), generator=gen, device=dev).to(dtype)
    _w4_check(x, packed, scales, group)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("rows", [2, 8])
@pytest.mark.parametrize("fc", ["fc1", "fc2", "odd_n"])
def test_w4_decode_form_expert_indexed(dev, dtype, rows, fc):
    e, hidden, inter = MOE
    k, n = {"fc1": (hidden, inter), "fc2": (inter, hidden), "odd_n": (hidden, 999)}[fc]
    group = 128 if (k // 2) % 128 == 0 else 64
    gen = torch.Generator(device=dev).manual_seed(rows + k + n)
    packed, scales = _w4_operands(gen, dev, k, n, group, stacks=e)
    idx = torch.randint(0, e, (rows,), generator=gen, device=dev, dtype=torch.int32)
    x = torch.randn((rows, k), generator=gen, device=dev).to(dtype)
    _w4_check(x, packed, scales, group, idx)


# kernel 5: the compiled head at the three buckets' rows, the four layer
# linears at 10 s (171) and 1 s (21) rows, and ragged K and odd N in both
# forms (the tile form takes N and K both at most 512)
DQ_SHAPES = [
    *((m, 512, 25055) for m in (36, 100, 196)),
    *((m, k, n) for m in (21, 171) for k, n in ((512, 1536), (512, 512), (512, 2048),
                                               (2048, 512))),
    (5, 130, 33), (300, 96, 77), (5, 130, 1033), (300, 96, 777),
]


@pytest.mark.cuda
@pytest.mark.parametrize("per_column", [False, True], ids=["w_scale", "ws"])
@pytest.mark.parametrize("m,k,n", DQ_SHAPES)
def test_dq_strip_form_equals_plain(dev, per_column, m, k, n):
    gen = torch.Generator(device=dev).manual_seed(m + k + n)
    wq = torch.randint(-127, 128, (k, n), generator=gen, device=dev, dtype=torch.int8)
    colsum = wq.to(torch.int32).sum(0, dtype=torch.int32)
    x = torch.randn((m, k), generator=gen, device=dev) * 2.0
    _, a_scale, a_zp = K.dynamic_quantize_u8(x)
    w_scale = torch.tensor([2.5e-3], device=dev) if per_column else 2.5e-3
    got = K.fused_dq_matmul(x, wq, colsum, a_scale, a_zp, w_scale)
    ref = K.fused_dq_matmul_plain(x, wq, colsum, a_scale, a_zp, w_scale)
    torch.cuda.synchronize()
    assert torch.equal(got, ref), f"max|d| {(got - ref).abs().max().item():.3e}"


# kernel 9: the register form at B = 2 (H 128 is the GRU graph's width)
@pytest.mark.cuda
@pytest.mark.parametrize("lbr", [True, False], ids=["lbr", "no_lbr"])
@pytest.mark.parametrize("hidden", [1, 33, 64, 100, 128])
def test_gru_register_form_matches_plain(dev, hidden, lbr):
    gen = torch.Generator(device=dev).manual_seed(hidden)
    args = cs.gru_inputs(300, 2, hidden, dev, gen)
    got = K.gru_seq(*args, lbr)
    ref = K.gru_seq_plain(*args, lbr)
    torch.cuda.synchronize()
    d = max((g - r).abs().max().item() for g, r in zip(got, ref))
    assert all(bool(torch.isfinite(g).all()) for g in got)
    assert d <= cs.GRU_TOL, f"max|d| {d:.3e} > {cs.GRU_TOL:g}"


@pytest.mark.cuda
@pytest.mark.parametrize("shape", cs.FLASH_SHAPES,
                         ids=[f"{s[3]}x{s[4]}-D{s[5]}-{s[7]}{'-causal' if s[6] else ''}"
                              for s in cs.FLASH_SHAPES])
def test_flash_matches_plain_oracle_and_skip_test(dev, shape):
    gen = torch.Generator(device=dev).manual_seed(sum(shape[:6]))
    before = K.flash_attention.launches
    res = cs.flash_check(shape, dev, gen)
    assert K.flash_attention.launches == before + 1
    assert res["ok"], res["what"]


@pytest.mark.cuda
@pytest.mark.parametrize("start", [0, 128], ids=["prefill", "chunk"])
def test_small_decoder_prefill_on_kernel_12(dev, start):
    from lele_tpu_torch.compiler import compile_model
    from lele_tpu_torch.onnx.synth import (
        attn23_decoder_params,
        attn23_step_feeds,
        build_attn23_decoder,
    )
    from lele_tpu_torch.ops import attention_ops

    cfg = dict(hidden=256, heads=4, kv_heads=2, head_dim=64, ffn=512, layers=2, vocab=1000,
               eps=1e-5, theta=10000.0, max_pos=512, l_max=512, batch=1)
    bs = build_attn23_decoder(attn23_decoder_params(np.random.default_rng(7), cfg), "S", cfg)
    cm = compile_model(bs, dim_values={"S": 128}, device=dev, strict=True)
    ref = compile_model(bs, dim_values={"S": 128}, device=dev, strict=True,
                        overrides={"Attention": attention_ops.attention_plain})
    rng = np.random.default_rng(start)
    caches = {f"c{kv}{i}": torch.from_numpy(
        (rng.standard_normal((1, 2, 512, 64)) * (np.arange(512) < start)[:, None])
        .astype(np.float32)).to(dev) for i in range(cfg["layers"]) for kv in "kv"}
    ids = rng.integers(0, cfg["vocab"], (1, 128))
    feeds = {key: torch.from_numpy(a).to(dev)
             for key, a in attn23_step_feeds(ids, start, 512).items()}
    before = K.flash_attention.launches
    got = cm(**feeds, **caches)[0]
    want = ref(**feeds, **caches)[0]
    torch.cuda.synchronize()
    assert K.flash_attention.launches == before + cfg["layers"]
    rel = ((got - want).abs().max() / want.abs().max()).item()
    assert bool(torch.isfinite(got).all()) and rel <= cs.LLM_REL, rel


# kernels 1 and 8: (T, valid rows) at the full width, and the small widths'
# head dims, depths and FSMN tap types
STACK_T = [(1, 1), (21, 21), (64, 64), (65, 65), (87, 76), (171, 171), (196, 196),
           (1004, 1004)]
STACKS = {"w8": ("weight_int8", "sanm_stack_w8"), "w4": ("weight_int4", "sanm_stack_w4")}
_full: dict = {}


def _stack_fns(fmt):
    name = STACKS[fmt][1]
    return getattr(K, name), getattr(K, f"{name}_plain")


def _full_stack(fmt, dev):
    if fmt not in _full:
        _full[fmt] = cs.stack_tree(STACKS[fmt][0], dev)
    return _full[fmt]


def _stack_inputs(dev, T, valid, D, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((T, D), generator=gen, device=dev) * 0.5
    mask = torch.zeros((T,), device=dev)
    mask[:valid] = 1.0
    return x, mask


@pytest.mark.cuda
@pytest.mark.parametrize("t,valid", STACK_T, ids=[f"T{t}-{v}" for t, v in STACK_T])
@pytest.mark.parametrize("fmt", list(STACKS))
def test_stack_matches_plain_full_width(dev, fmt, t, valid):
    fn, plain = _stack_fns(fmt)
    st = _full_stack(fmt, dev)
    x, mask = _stack_inputs(dev, t, valid, 512, t)
    before = fn.launches
    res = cs.stack_check(fn, plain, x, mask, valid, st, 4, 11)
    assert fn.launches == before + 2, "one launch a call"
    assert res["ok"], f"max|d| {res['d']:.3e}, max|ref| {res['scale']:.3e}"
    assert res["same"], "a repeat call changed the bits"


@pytest.mark.cuda
@pytest.mark.parametrize("taps", [torch.float32, torch.bfloat16], ids=["f32_taps", "bf16_taps"])
@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("fmt", list(STACKS))
def test_stack_matches_plain_small(dev, fmt, hd, layers, taps):
    fn, plain = _stack_fns(fmt)
    H = 256 // hd
    st = cs.stack_tree(STACKS[fmt][0], dev, n_layers=layers, d_model=256, n_heads=H, ffn=512,
                       seed=hd + layers, fsmn_dtype=taps)
    for t, valid in ((21, 21), (65, 60), (87, 76)):
        x, mask = _stack_inputs(dev, t, valid, 256, t + hd)
        res = cs.stack_check(fn, plain, x, mask, valid, st, H, 11)
        assert res["ok"], f"T={t}: max|d| {res['d']:.3e}, max|ref| {res['scale']:.3e}"
        assert res["same"], f"T={t}: a repeat call changed the bits"


@pytest.mark.cuda
@pytest.mark.parametrize("t", [171, 1004])
@pytest.mark.parametrize("fmt", list(STACKS))
def test_stack_graph_replay_gives_eager_bits(dev, fmt, t):
    fn, _ = _stack_fns(fmt)
    st = _full_stack(fmt, dev)
    x, mask = _stack_inputs(dev, t, t, 512, t + 1)
    assert cs.graph_same_bits(lambda: fn(x, mask, st, 4, 11))


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", list(STACKS))
def test_stack_one_call_traces_one_kernel(dev, fmt):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn, _ = _stack_fns(fmt)
    st = _full_stack(fmt, dev)
    x, mask = _stack_inputs(dev, 171, 171, 512, 3)
    fn(x, mask, st, 4, 11)
    kernels = []
    for _ in range(6):  # a trace now and then comes back with no device record
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn(x, mask, st, 4, 11)
            torch.cuda.synchronize()
        kernels = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
        if kernels:
            break
    assert kernels, "no trace with a device record came back"
    assert sum("sanm_stack_kernel" in k for k in kernels) == 1, kernels
    assert not any("lele::" in k and "sanm_stack_kernel" not in k for k in kernels), kernels


# kernel 4 (csrc/sanm_dql.cu: the compiled int8 SAN-M stack as one
# cooperative launch): against its plain version at the layer gate on small
# layers (d256, ffn 512, head dims 32, 64, 128), at the compiled buckets'
# rows, the ragged bucket and T = 2,048 (DQL_T_MAX)
DQL_T = [(36, 36), (100, 100), (196, 171), (100, 76), (2048, 2000)]
DQL_HD = [32, 64, 128]


def _dql_small(dev, hd, layers, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return cs.random_dql_stack(layers, 256, 512, 11, dev, gen), gen


def _dql_call(x, bias, vmask, st, heads, pad_left=5):
    return lambda: K.sanm_stack_dql(x, bias, vmask, st, heads, 11, pad_left)


@pytest.mark.cuda
@pytest.mark.parametrize("t,valid", DQL_T, ids=[f"T{t}-{v}" for t, v in DQL_T])
@pytest.mark.parametrize("hd", DQL_HD)
def test_dql_stack_matches_plain(dev, hd, t, valid):
    """chip_smoke's gates: each layer on the plain version's own input at the
    layer gate and within LAYER_NOISE_MEAN, and the two layers whole at the
    quantization-noise gate (a last-bit difference moves DQL codes, which the
    next layer carries)."""
    st, gen = _dql_small(dev, hd, 2, hd + t)
    bias, vmask = cs.dql_masks(2, t, valid, dev)
    x = torch.randn((t, 256), generator=gen, device=dev)
    heads = 256 // hd
    call = _dql_call(x, bias, vmask, st, heads)
    before = K.sanm_stack_dql.launches
    got, again = call(), call()
    ref = K.sanm_stack_dql_plain(x, bias, vmask, st, heads, 11, 5)
    torch.cuda.synchronize()
    assert K.sanm_stack_dql.launches == before + 2, "one launch a call"
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, again), "a repeat call changed the bits"
    d, scale, mean = cs.compare(got, ref)
    assert mean <= cs.STACK_NOISE_MEAN and d <= cs.STACK_NOISE_MAX * scale, (mean, d / scale)
    xi = x
    for i in range(2):
        li = cs.layer_slice(st, i)
        got_i = K.sanm_stack_dql(xi, bias[i:i + 1], vmask[i:i + 1], li, heads, 11, 5)
        ref_i = K.sanm_stack_dql_plain(xi, bias[i:i + 1], vmask[i:i + 1], li, heads, 11, 5)
        d_i, s_i, mean_i = cs.compare(got_i, ref_i)
        assert torch.allclose(got_i, ref_i, rtol=2e-2, atol=2e-2 * s_i), \
            f"layer {i}: max|d| {d_i:.3e}, max|ref| {s_i:.3e}"
        assert mean_i <= cs.LAYER_NOISE_MEAN, f"layer {i}: mean|d| {mean_i:.3e} std"
        xi = ref_i


@pytest.mark.cuda
@pytest.mark.parametrize("pad_left", [0, 10])
@pytest.mark.parametrize("case", ["zero_norm", "const_x"])
def test_dql_stack_edges_match_plain(dev, case, pad_left):
    """A layer whose LN1 output is all zero (DQL's scale 0: the safe scale
    1), a constant input, and the FSMN's pad at both ends."""
    st, gen = _dql_small(dev, 64, 1, 7)
    bias, vmask = cs.dql_masks(1, 45, 40, dev)
    x = torch.randn((45, 256), generator=gen, device=dev)
    if case == "zero_norm":
        st["norm1"]["g"].zero_()
        st["norm1"]["b"].zero_()
    else:
        x = torch.full_like(x, 0.75)
    got = K.sanm_stack_dql(x, bias, vmask, st, 4, 11, pad_left)
    ref = K.sanm_stack_dql_plain(x, bias, vmask, st, 4, 11, pad_left)
    scale = ref.abs().max().item()
    assert torch.allclose(got, ref, rtol=2e-2, atol=2e-2 * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", DQL_HD)
def test_dql_stack_graph_replay_gives_eager_bits(dev, hd):
    st, gen = _dql_small(dev, hd, 2, hd)
    bias, vmask = cs.dql_masks(2, 196, 171, dev)
    x = torch.randn((196, 256), generator=gen, device=dev)
    assert cs.graph_same_bits(_dql_call(x, bias, vmask, st, 256 // hd))


@pytest.mark.cuda
@pytest.mark.parametrize("t,valid", [(196, 171), (100, 76)], ids=["T196", "T100-76"])
def test_dql_stack_full_width_within_the_noise_gate(dev, t, valid):
    """50 layers at d512, ffn 2048: the whole stack within chip_smoke's
    noise gate of the plain version, and one call one kernel in the trace."""
    gen = torch.Generator(device=dev).manual_seed(t)
    st = cs.random_dql_stack(50, 512, 2048, 11, dev, gen)
    bias, vmask = cs.dql_masks(50, t, valid, dev)
    x = torch.randn((t, 512), generator=gen, device=dev)
    call = _dql_call(x, bias, vmask, st, 4)
    got = call()
    ref = K.sanm_stack_dql_plain(x, bias, vmask, st, 4, 11, 5)
    d, scale, mean = cs.compare(got, ref)
    assert mean <= cs.STACK_NOISE_MEAN and d <= cs.STACK_NOISE_MAX * scale, (mean, d / scale)
    for i in range(0, 50, 7):  # every seventh layer alone, on the same input
        li = cs.layer_slice(st, i)
        args = (x, bias[i:i + 1], vmask[i:i + 1], li, 4, 11, 5)
        _, _, mean_i = cs.compare(K.sanm_stack_dql(*args), K.sanm_stack_dql_plain(*args))
        assert mean_i <= cs.LAYER_NOISE_MEAN, (i, mean_i)
    checks = cs.Checks()
    cs.one_launch_check(checks, "sanm_stack_dql", call, "sanm_dql_kernel")
    assert not checks.failures, checks.failures


# kernel 10 (csrc/est_block.cu: the estimator's blocks, 8 or 9 launches a
# block): against its plain version at chip_smoke.EST_TOL at every
# EST_SHAPES case and the TTS requests' buckets (tts.json's widths, 8
# blocks), and at head dims 32 and 128 on 2 blocks
def _est_stack(dev, n_blocks, d, heads, ffn, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    st = {}
    for name, shape in (("norm1", None), ("q", (d, d)), ("kv", (d, 2 * d)), ("out", (d, d)),
                        ("norm2", None), ("ffn1", (d, ffn)), ("ffn2", (ffn, d))):
        if shape is None:
            st[name] = {"g": 1 + 0.1 * torch.randn((n_blocks, d), generator=gen, device=dev),
                        "b": 0.1 * torch.randn((n_blocks, d), generator=gen, device=dev)}
        else:
            w = torch.randn((n_blocks, *shape), generator=gen, device=dev) / shape[0] ** 0.5
            st[name] = {"w": w.to(torch.bfloat16).contiguous(),
                        "b": 0.1 * torch.randn((n_blocks, shape[1]), generator=gen, device=dev)}
    return st, gen


def _est_inputs(gen, dev, t, tk, tv, tkv, d):
    x = torch.randn((t, d), generator=gen, device=dev)
    text = torch.randn((tk, d), generator=gen, device=dev)
    lm, tm = torch.zeros((t,), device=dev), torch.zeros((tk,), device=dev)
    lm[:tv], tm[:tkv] = 1.0, 1.0
    return x, text, lm, tm


# chip_smoke's shapes; the TTS requests' buckets; head dims 32 and 128;
# Tk = 1; many key tiles; T past 4,096
EST_CASES = [(*shape, 256, 4, 8) for shape in cs.EST_SHAPES] + [
    (64, 96, 42, 54, 256, 4, 8), (128, 96, 66, 84, 256, 4, 8), (256, 320, 217, 277, 256, 4, 8),
    (100, 37, 90, 30, 256, 8, 2), (100, 37, 90, 30, 256, 2, 2), (64, 1, 64, 1, 256, 4, 2),
    (64, 600, 60, 590, 256, 4, 2), (4500, 37, 4400, 30, 256, 4, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("t,tk,tv,tkv,d,heads,n", EST_CASES,
                         ids=[f"T{c[0]}-Tk{c[1]}-hd{c[4] // c[5]}-n{c[6]}" for c in EST_CASES])
def test_est_blocks_match_plain(dev, t, tk, tv, tkv, d, heads, n):
    st, gen = _est_stack(dev, n, d, heads, 4 * d, t + tk)
    args = _est_inputs(gen, dev, t, tk, tv, tkv, d)
    before = K.estimator_blocks.launches
    got, again = (K.estimator_blocks(*args, st, heads) for _ in range(2))
    ref = K.estimator_blocks_plain(*args, st, heads)
    torch.cuda.synchronize()
    assert K.estimator_blocks.launches == before + 2, "the wrapper counts one a call"
    d_, scale, _ = cs.compare(got, ref)
    assert bool(torch.isfinite(got).all()) and d_ <= cs.EST_TOL * scale, (d_, scale)
    assert torch.equal(got, again), "a repeat call changed the bits"


@pytest.mark.cuda
@pytest.mark.parametrize("shape", cs.EST_SHAPES, ids=[f"T{s[0]}" for s in cs.EST_SHAPES])
def test_est_blocks_graph_replay_gives_eager_bits(dev, shape):
    st, gen = _est_stack(dev, 8, 256, 4, 1024, 1)
    args = _est_inputs(gen, dev, *shape, 256)
    assert cs.graph_same_bits(lambda: K.estimator_blocks(*args, st, 4))



# kernel 11 (csrc/int8_gemm.cu: kernel 5's strip core with the raw int32
# store): exact, so int32-equal to the plain version everywhere. The path's
# shapes (a layer's four linears at M = 1, 21, 171, 684 and 196, the per-op
# graph's int8 head, 2,048^3), odd M, K and N, and the extremes at K = 2,048.
I8_PAIRS = cs.I8_PAIRS
I8_CASES = ([(m, k, n) for m in (1, 21, 171, 684, 196) for k, n in I8_PAIRS]
            + [(196, 512, 25055), (2048, 2048, 2048), (50, 70, 30), (37, 70, 30), (1, 1, 1),
               (17, 33, 65), (300, 1040, 136), (5, 16, 24), (129, 2047, 513)])


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", I8_CASES, ids=[f"{m}x{k}x{n}" for m, k, n in I8_CASES])
def test_int8_gemm_equals_plain(dev, m, k, n):
    gen = torch.Generator(device=dev).manual_seed(m * 7 + k * 3 + n)
    a = torch.randint(-128, 128, (m, k), generator=gen, device=dev, dtype=torch.int8)
    b = torch.randint(-128, 128, (k, n), generator=gen, device=dev, dtype=torch.int8)
    before = K.int8_matmul.launches
    got = K.int8_matmul(a, b)
    ref = K.int8_matmul_plain(a, b)
    torch.cuda.synchronize()
    assert K.int8_matmul.launches == before + 1
    assert got.dtype == torch.int32 and torch.equal(got, ref), \
        f"max|d| {(got - ref).abs().max().item()}"


@pytest.mark.cuda
@pytest.mark.parametrize("fa,fb", [(-128, -128), (127, -128), (-128, 127), (127, 127)])
def test_int8_gemm_extremes_at_k2048(dev, fa, fb):
    a = torch.full((171, 2048), fa, device=dev, dtype=torch.int8)
    b = torch.full((2048, 512), fb, device=dev, dtype=torch.int8)
    a[5, :7] = 3
    got = K.int8_matmul(a, b)
    torch.cuda.synchronize()
    assert torch.equal(got, K.int8_matmul_plain(a, b))
    assert got[0, 0].item() == 2048 * fa * fb


@pytest.mark.cuda
def test_int8_gemm_one_launch_a_call_and_graph_bits(dev):
    gen = torch.Generator(device=dev).manual_seed(1)
    a = torch.randint(-128, 128, (171, 2048), generator=gen, device=dev, dtype=torch.int8)
    b = torch.randint(-128, 128, (2048, 512), generator=gen, device=dev, dtype=torch.int8)
    kernels = [n for kind, n in cs.graph_nodes(lambda: K.int8_matmul(a, b)) if kind == "KERNEL"]
    assert len(kernels) == 1 and "dq_gemm_strip" in kernels[0], kernels
    assert cs.graph_same_bits(lambda: K.int8_matmul(a, b))


# kernel 6 (csrc/lstm_seq.cu): the register form up to H = 128, the cluster
# form of rnn_seq.cuh at 129; within chip_smoke.LSTM_TOL of the plain
# version, the same bits on a repeat call and a CUDA-graph replay
LSTM_CASES = [(s, b, h) for s in (1, 3, 312, 1875) for b in (1, 3)
              for h in (1, 16, 64, 96, 128, 129)]


@pytest.mark.cuda
@pytest.mark.parametrize("s,b,h", LSTM_CASES, ids=[f"S{s}-B{b}-H{h}" for s, b, h in LSTM_CASES])
def test_lstm_seq_matches_plain(dev, s, b, h):
    gen = torch.Generator(device=dev).manual_seed(s + 10 * b + 100 * h)
    args = cs.lstm_inputs(s, b, h, dev, gen)
    got, again = K.lstm_seq(*args), K.lstm_seq(*args)
    ref = K.lstm_seq_plain(*args)
    torch.cuda.synchronize()
    d = max((g - r).abs().max().item() for g, r in zip(got, ref))
    assert all(bool(torch.isfinite(g).all()) for g in got)
    assert d <= cs.LSTM_TOL, f"max|d| {d:.3e} > {cs.LSTM_TOL:g}"
    assert all(torch.equal(g, a) for g, a in zip(got, again)), "a repeat call changed the bits"


@pytest.mark.cuda
@pytest.mark.parametrize("h", [128, 129])
def test_lstm_seq_graph_replay_and_one_launch(dev, h):
    gen = torch.Generator(device=dev).manual_seed(h)
    args = cs.lstm_inputs(312, 1, h, dev, gen)

    def call():
        return torch.cat([t.reshape(-1) for t in K.lstm_seq(*args)])

    assert cs.graph_same_bits(call)
    kernels = [n for kind, n in cs.graph_nodes(lambda: K.lstm_seq(*args)) if kind == "KERNEL"]
    assert len(kernels) == 1 and ("lstm_seq_reg" in kernels[0] or "rnn_seq_cluster" in kernels[0])


# kernel 2 (csrc/w8_gemm.cu): chip_smoke's gates, every row count of its
# paths and a ragged one, every GEMM_SHAPES entry, and a ragged K
W8_CASES = [(m, k, n) for m in (1, 171, 513, 684, 1512) for k, n in cs.GEMM_SHAPES] + [
    (171, 520, 25055), (37, 70, 30)]
W8_TOL = {torch.bfloat16: 1e-3, torch.float32: 1e-5}


def _w8_operands(dev, m, k, n, dtype, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((m, k), generator=gen, device=dev).to(dtype)
    wq = torch.randint(-127, 128, (k, n), generator=gen, device=dev, dtype=torch.int8)
    ws = torch.rand((n,), generator=gen, device=dev) * 2e-3 + 1e-4
    return x, wq, ws


def _w8_check(x, wq, ws):
    got = K.w8_matmul(x, wq, ws)
    ref = K.w8_matmul_plain(x, wq, ws)
    torch.cuda.synchronize()
    d, scale = (got - ref).abs().max().item(), ref.abs().max().item()
    assert got.shape == ref.shape and bool(torch.isfinite(got).all())
    assert d <= W8_TOL[x.dtype] * scale, f"max|d| {d:.3e} > {W8_TOL[x.dtype]:g} * {scale:.3e}"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("m,k,n", W8_CASES, ids=[f"{m}x{k}x{n}" for m, k, n in W8_CASES])
def test_w8_gemm_matches_plain(dev, dtype, m, k, n):
    _w8_check(*_w8_operands(dev, m, k, n, dtype, m + k + n))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_w8_gemm_offset_operands(dev, dtype):
    gen = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn((176, 520), generator=gen, device=dev).to(dtype)
    wq = torch.randint(-127, 128, (525, 1003), generator=gen, device=dev, dtype=torch.int8)
    ws = torch.rand((1004,), generator=gen, device=dev) * 2e-3 + 1e-4
    _w8_check(x[3:], wq[5:], ws[1:])  # bases off 16-byte alignment, rows unaligned


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(171, 512, 25055), (684, 512, 25055), (1512, 512, 25055),
                                   (513, 520, 1003)])
def test_w8_gemm_padded_rows(dev, m, k, n):
    """The weight as prepare_w8_params keeps the CTC head: rows padded to a
    multiple of 16 bytes, loaded by TMA."""
    from lele_tpu_torch.kernels.quant_matmul import align_rows

    x, wq, ws = _w8_operands(dev, m, k, n, torch.bfloat16, m + n)
    _w8_check(x, align_rows(wq), ws)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(171, 512, 25055), (684, 2048, 512), (1512, 512, 1536),
                                   (171, 512, 512)])
def test_w8_gemm_one_launch_and_same_bits(dev, m, k, n):
    from lele_tpu_torch.kernels.quant_matmul import align_rows

    x, wq, ws = _w8_operands(dev, m, k, n, torch.bfloat16, 3)
    wq = align_rows(wq)
    assert torch.equal(K.w8_matmul(x, wq, ws), K.w8_matmul(x, wq, ws))
    assert cs.graph_same_bits(lambda: K.w8_matmul(x, wq, ws))
    kernels = [n_ for kind, n_ in cs.graph_nodes(lambda: K.w8_matmul(x, wq, ws))
               if kind == "KERNEL"]
    assert len(kernels) == 1 and "w8_wgmma" in kernels[0], kernels


# kernel 3 (csrc/sanm_layer.cu): one layer at the layer gate
LAYER_T = ((21, 21), (87, 76), (171, 171), (1004, 1004))


@pytest.mark.cuda
@pytest.mark.parametrize("taps", [torch.float32, torch.bfloat16], ids=["f32_taps", "bf16_taps"])
@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("t,valid", LAYER_T, ids=[f"T{t}-{v}" for t, v in LAYER_T])
def test_sanm_layer_matches_plain(dev, t, valid, hd, taps):
    from lele_tpu_torch.kernels.sanm_block import layer_view

    tree = cs.stack_tree("weight_int8", dev, n_layers=1, n_heads=512 // hd, seed=hd,
                         fsmn_dtype=taps)
    lp, heads, fk = layer_view(tree, 0), 512 // hd, 11
    x, mask = _stack_inputs(dev, t, valid, 512, t + hd)
    got = K.sanm_layer_w8(x, mask, lp, heads, fk)
    ref = K.sanm_layer_w8_plain(x, mask, lp, heads, fk)
    torch.cuda.synchronize()
    g, r = got[:valid], ref[:valid]
    scale = r.abs().max().item()
    assert bool(torch.isfinite(g).all())
    assert torch.allclose(g, r, rtol=2e-2, atol=2e-2 * scale), (g - r).abs().max().item()


# YOLO26: no kernel of the port's own (its convs are cuDNN's); the Conv
# emitter's 2-D forms and the native head maps on the card against the CPU.
# cuDNN's global TF32 flag is set on here: the emitter and an f32 conv2d
# must turn it off themselves
CONV2D_CARD = {
    "stride2_pads1": ((2, 3, 64, 64), (16, 3, 3, 3), dict(strides=[2, 2], pads=[1, 1, 1, 1])),
    "asym_pads": ((1, 8, 33, 20), (12, 8, 3, 2), dict(pads=[0, 2, 1, 0])),
    "same_upper_even": ((1, 16, 40, 40), (32, 16, 3, 3),
                        dict(strides=[2, 2], auto_pad="SAME_UPPER")),
    "same_lower_odd": ((1, 16, 41, 39), (32, 16, 3, 3),
                       dict(strides=[2, 2], auto_pad="SAME_LOWER")),
    "dilation2": ((1, 8, 30, 30), (8, 8, 3, 3), dict(dilations=[2, 2], pads=[2, 2, 2, 2])),
    "groups4": ((1, 32, 20, 20), (32, 8, 3, 3), dict(group=4, pads=[1, 1, 1, 1])),
    "depthwise": ((1, 64, 20, 20), (64, 1, 3, 3), dict(group=64, pads=[1, 1, 1, 1])),
    "1x1_head": ((1, 64, 20, 20), (20, 64, 1, 1), {}),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CONV2D_CARD))
def test_conv_emitter_on_card_matches_cpu(dev, case):
    from lele_tpu_torch.onnx import OnnxModel
    from lele_tpu_torch.onnx import builder as ob
    from lele_tpu_torch.ops import make_ctx, nn_ops

    xs, ws, attrs = CONV2D_CARD[case]
    data = ob.build_model_bytes([ob.node("Conv", ["x", "w", "b"], ["y"], **attrs)],
                                [ob.value_info(n, 1, []) for n in ("x", "w", "b")],
                                [ob.value_info("y", 1, [])])
    ctx = make_ctx(torch, OnnxModel.from_bytes(data).graph.node[0], 17)
    rng = np.random.default_rng(len(case))
    x, w, b = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in (xs, ws, (ws[0],)))
    ref = nn_ops.conv(ctx, x, w, b)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        got = nn_ops.conv(ctx, x.to(dev), w.to(dev), b.to(dev)).cpu()
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    assert got.shape == ref.shape
    assert (got - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seg", [False, True], ids=["detect", "seg"])
def test_yolo_head_maps_on_card_match_cpu(dev, seg, dtype):
    """Yolo26Config() at full width (640, widths 32-256), one u8 image, at
    chip_smoke's phase-31 gates (cs.YOLO_MAP_REL)."""
    from lele_tpu_torch.models import Yolo26Config, Yolo26Model
    from lele_tpu_torch.models.yolo26 import yolo26_head_maps
    from lele_tpu_torch.params import tree_map

    cfg = Yolo26Config(segmentation=seg, dtype=dtype)
    m = Yolo26Model(cfg, device=dev)
    m.init(31)
    img = torch.from_numpy(np.random.default_rng(31).integers(0, 256, (1, 640, 640, 3),
                                                              dtype=np.uint8))
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        with torch.inference_mode():
            got = yolo26_head_maps(m.params, img.to(dev), cfg)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    with torch.inference_mode():
        ref = yolo26_head_maps(tree_map(lambda t: t.cpu(), m.params), img, cfg)
    assert sorted(got) == sorted(ref)
    for k, r in ref.items():
        g = got[k].cpu()
        assert g.dtype == torch.float32 and g.shape == r.shape and bool(torch.isfinite(g).all())
        assert (g - r).abs().max().item() <= cs.YOLO_MAP_REL[dtype] * r.abs().max().item(), k


# -- captured CUDA graphs (runtime/graphs.py) against the uncaptured paths -----------


def _flat(out) -> list:
    from lele_tpu_torch.runtime.graphs import flatten

    return [torch.from_numpy(v) if isinstance(v, np.ndarray) else v
            for v in flatten(out)[0] if isinstance(v, (np.ndarray, torch.Tensor))]


def _capture_case(after, before, rel=None):
    """after(i) / before(i): the captured and the uncaptured path on inputs
    i = 0, 1, 2. Asserts the same bits (rel None) or max|d| <= rel·max|ref|
    (printed), equal launch counts, and that later calls leave the first
    call's outputs as they were."""
    K.reset_launch_counts()
    first = _flat(after(0))
    torch.cuda.synchronize()
    got_counts = K.launch_counts()
    kept = [t.clone() for t in first]
    K.reset_launch_counts()
    ref0 = _flat(before(0))
    torch.cuda.synchronize()
    assert got_counts == K.launch_counts()
    worst = 0.0
    for i, (a, b) in enumerate([(first, ref0)] + [(_flat(after(i)), _flat(before(i)))
                                                  for i in (1, 2)]):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert x.shape == y.shape and x.dtype == y.dtype
            if rel is None:
                assert torch.equal(x.cpu(), y.cpu()), f"input {i}: not the same bits"
            elif y.numel():
                d = (x.double() - y.double()).abs().max().item()
                worst = max(worst, d / max(y.double().abs().max().item(), 1e-30))
    print(f"captured vs uncaptured: max|d|/max|ref| {worst:.3e}")
    assert worst <= (rel or 0.0)
    assert all(torch.equal(k, f) for k, f in zip(kept, first))


@pytest.mark.cuda
def test_compiled_model_captures_with_donated_state(dev):
    """SileroOnnx's rate-bound step: one graph, the state donated (each
    call's state is a copy of the caller's own, passed back in), the same
    bits and launches as the step-by-step replay."""
    from lele_tpu_torch.models import SileroOnnx

    cm = SileroOnnx(cs.SILERO_FIXTURE, device=dev).compiled(16000)
    rng = np.random.default_rng(5)
    xs = [torch.from_numpy((rng.standard_normal((1, 512)) * 3000).astype(np.float32)).to(dev)
          for _ in range(3)]
    zero = torch.zeros((2, 1, 128), device=dev)
    _capture_case(lambda i: cm(xs[i], zero), lambda i: cm.replay(xs[i], zero))
    assert cm.stats["captured"] is True and cm.donated == {"state": 1}
    state, rstate, states = zero, zero, []
    for x in xs:  # the state recirculates; every returned state stays as it was
        rprob, rstate = cm.replay(x, rstate)
        prob, state = cm(x, state)
        states.append((state, rstate))
        assert torch.equal(prob, rprob)
    assert all(torch.equal(a, b) for a, b in states)


@pytest.mark.cuda
def test_compiled_model_compile_captures_ahead(dev):
    """`compile()` captures on zero inputs; the first call is then a replay
    with the step-by-step replay's bits and launch counts."""
    from lele_tpu_torch.models import SileroOnnx

    cm = SileroOnnx(cs.SILERO_FIXTURE, device=dev).compiled(16000)
    assert cm.compile() is cm and cm._program.graph is not None and cm.stats["captured"]
    x = torch.from_numpy((np.random.default_rng(8).standard_normal((1, 512)) * 3000)
                         .astype(np.float32)).to(dev)
    state = torch.full((2, 1, 128), 0.25, device=dev)
    graph = cm._program.graph
    _capture_case(lambda i: cm(x * (i + 1), state), lambda i: cm.replay(x * (i + 1), state))
    assert cm._program.graph is graph


def _interleave(step, chunks, states):
    """Streams 0 and 1 through step(chunk, state) → (out, state), their calls
    alternating, each carrying its own state → outputs and last states."""
    states, outs = list(states), []
    for t in range(len(chunks[0])):
        for k in (0, 1):
            out, states[k] = step(chunks[k][t], states[k])
            outs.append(out)
    return _flat(outs) + _flat(states)


@pytest.mark.cuda
def test_sessions_interleaved_through_one_silero_step_program(dev):
    """Two streams alternating through `SileroVad.step_fn`'s one program give
    what each gives through `silero_step` on its own."""
    from lele_tpu_torch.models import SileroVad
    from lele_tpu_torch.models.silero import silero_step, zero_state

    vad = SileroVad(device=dev)
    vad.init(2)
    rng = np.random.default_rng(6)
    chunks = [[torch.from_numpy(c[None]).to(dev)
               for c in vad.frame_chunks(cs.vad_pcm(0.2, 16000, rng))[:5]] for _ in range(2)]
    step = vad.step_fn(16000)
    with torch.inference_mode():
        got = _interleave(lambda c, s: step(vad.params, c, s), chunks,
                          [zero_state(vad.cfg, device=dev)] * 2)
        ref = _interleave(lambda c, s: silero_step(vad.params, c, s, vad.cfg, 16000), chunks,
                          [zero_state(vad.cfg, device=dev)] * 2)
    assert len(vad.programs) == 1
    assert len(got) == len(ref) and all(torch.equal(a, b) for a, b in zip(got, ref))


@pytest.mark.cuda
def test_sessions_interleaved_through_one_stream_step_program(dev):
    """Two streams alternating through `StreamingSenseVoice.step_fn`'s one
    program give what each gives through `stream_step` on its own."""
    from lele_tpu_torch.models import SenseVoiceConfig, SenseVoiceModel, StreamingSenseVoice
    from lele_tpu_torch.models.sensevoice_stream import (StreamConfig, init_stream_state,
                                                         stream_step)

    cfg = SenseVoiceConfig(n_layers=2, d_model=256, n_heads=4, ffn_dim=512, vocab_size=300)
    st = StreamingSenseVoice(cfg=cfg, stream=StreamConfig(chunk_frames=8, context_frames=16),
                             device=dev)
    st.params = SenseVoiceModel(cfg, device=dev).init(4)
    gen = torch.Generator(device=dev).manual_seed(3)
    chunks = [list(torch.randn((4, 1, 8, 560), generator=gen, device=dev)) for _ in range(2)]
    mask = torch.ones((1, 8), device=dev)
    step = st.step_fn()
    with torch.inference_mode():
        got = _interleave(lambda f, s: step(st.params, f, mask, s), chunks,
                          [init_stream_state(cfg, st.stream, device=dev) for _ in range(2)])
        ref = _interleave(lambda f, s: stream_step(st.params, f, mask, s, cfg), chunks,
                          [init_stream_state(cfg, st.stream, device=dev) for _ in range(2)])
    assert len(st.programs) == 1
    assert len(got) == len(ref) and all(torch.equal(a, b) for a, b in zip(got, ref))


@pytest.mark.cuda
def test_dynamic_if_tape_replays_step_by_step(dev):
    from lele_tpu_torch.compiler import compile_model

    cm = compile_model(str(cs.SILERO_FIXTURE), device=dev)
    x = torch.randn((1, 512), device=dev) * 3000
    out = cm(x, torch.zeros((2, 1, 128), device=dev), np.asarray([8000], np.int64))
    assert cm.stats["capturable"] is False and cm.stats["captured"] is False
    ref = cm.replay(x, torch.zeros((2, 1, 128), device=dev), np.asarray([8000], np.int64))
    assert all(torch.equal(a, b) for a, b in zip(out, ref))


@pytest.mark.cuda
@pytest.mark.parametrize("block", [1, 4, 32])
def test_silero_onnx_blocks_give_the_stepwise_bits(dev, block):
    from lele_tpu_torch.models import SileroOnnx

    sv = SileroOnnx(cs.SILERO_FIXTURE, device=dev)
    sv.BLOCK = block
    sv.compiled(16000)  # traced before the counted calls (the walk launches kernel 6)
    pcms = [cs.vad_pcm(s, 16000, np.random.default_rng(k)) for k, s in
            enumerate((2.3, 1.1, 3.0))]
    _capture_case(lambda i: sv.speech_probs(pcms[i], 16000),
                  lambda i: cs.silero_onnx_stepwise(sv, pcms[i], 16000))


def _small_sensevoice(dev, **kw):
    from lele_tpu_torch.models import (SenseVoiceConfig, SenseVoiceModel, cast_big_params,
                                       prepare_quantized_params, prepare_w4_params,
                                       prepare_w8_params, stack_layer_params)

    cfg = SenseVoiceConfig(n_layers=2, d_model=256, n_heads=4, ffn_dim=512, vocab_size=300,
                           **kw)
    m = SenseVoiceModel(cfg, device=dev)
    p = m.init(3)
    if cfg.quantized:
        p = stack_layer_params(prepare_quantized_params(p, drop_fp=True))
    elif cfg.weight_int4:
        p = stack_layer_params(prepare_w4_params(cast_big_params(p, torch.bfloat16)))
    elif cfg.weight_int8:
        p = prepare_w8_params(cast_big_params(p, torch.bfloat16))
        p = p if cfg.n_experts else stack_layer_params(p)
    m.params = p
    return m


SV_CASES = {"w8": dict(weight_int8=True), "w4": dict(weight_int4=True),
            "int8": dict(quantized=True), "int8_k5": dict(quantized=True, quant_pallas=True),
            "moe": dict(weight_int8=True, n_experts=4)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(SV_CASES))
def test_sensevoice_bucket_program_serves_every_length(dev, case):
    """Three lengths of one bucket through one captured program: each the
    eager body's bits (`_ids_fn`), and one program in all."""
    from lele_tpu_torch.runtime.bucketing import pad_pcm

    m = _small_sensevoice(dev, **SV_CASES[case])
    ins = [pad_pcm(cs.synth_speechlike(s, np.random.default_rng(k)))
           for k, s in enumerate((2.9, 2.1, 2.5))]
    ins = [(p[None], [n]) for p, n in ins]

    def before(i):
        return m._ids_fn()(torch.from_numpy(ins[i][0]).to(dev),
                           torch.tensor(ins[i][1], device=dev))

    with torch.inference_mode():
        _capture_case(lambda i: m._run_ids(*ins[i]), before)
    assert len(m.programs) == 1


@pytest.mark.cuda
def test_sensevoice_batch_and_long_programs(dev):
    from lele_tpu_torch.models.sensevoice import pad_rows

    m = _small_sensevoice(dev, weight_int8=True)
    rng = np.random.default_rng(9)
    batches = [m.batch_inputs([cs.synth_speechlike(s, rng) for s in lens])
               for lens in ((1.0, 2.5, 2.9), (2.0, 0.5, 1.2), (2.2, 2.2, 2.2))]
    wins = [pad_rows(m.long_windows(cs.synth_speechlike(s, rng))[0], 30 * 16000)
            for s in (64.0, 70.0, 75.0)]
    for inputs in (batches, wins):
        def before(i, inputs=inputs):
            return m._ids_fn()(torch.from_numpy(inputs[i][0]).to(dev),
                               torch.from_numpy(inputs[i][1].astype(np.int64)).to(dev))

        with torch.inference_mode():
            _capture_case(lambda i, inputs=inputs: m._run_ids(*inputs[i]), before)


@pytest.mark.cuda
def test_stream_steps_capture_with_donated_state(dev):
    from lele_tpu_torch.models import SenseVoiceConfig, SenseVoiceModel, StreamingSenseVoice
    from lele_tpu_torch.models.sensevoice_stream import (StreamConfig, init_stream_state,
                                                         stream_step)

    cfg = SenseVoiceConfig(n_layers=2, d_model=256, n_heads=4, ffn_dim=512, vocab_size=300)
    st = StreamingSenseVoice(cfg=cfg, stream=StreamConfig(chunk_frames=8, context_frames=16),
                             device=dev)
    st.params = SenseVoiceModel(cfg, device=dev).init(4)
    feats = torch.randn((5, 1, 8, 560), device=dev)
    mask = torch.ones((1, 8), device=dev)
    state = init_stream_state(cfg, st.stream, device=dev)
    ref = init_stream_state(cfg, st.stream, device=dev)
    step = st.decode_step_fn()
    for f in feats:
        ids, state = step(st.params, f, mask, state)
        with torch.inference_mode():
            logits, ref = stream_step(st.params, f, mask, ref, cfg)
        assert torch.equal(ids, logits.argmax(-1).to(torch.int32))
        assert all(torch.equal(a, b) for a, b in zip(_flat(state), _flat(ref)))
    assert len(st.programs) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_yolo_engine_program_within_the_card_gate(dev, dtype):
    """cuDNN may take another algorithm under capture: held to
    cs.YOLO_MAP_REL, the largest difference printed."""
    from lele_tpu_torch.models import Yolo26Config, Yolo26Model
    from lele_tpu_torch.serving import Yolo26Engine

    m = Yolo26Model(Yolo26Config(dtype=dtype), device=dev)
    m.init(7)
    eng = Yolo26Engine(model=m)
    xs = [np.random.default_rng(k).random((1, 640, 640, 3)).astype(np.float32)
          for k in range(3)]
    _capture_case(lambda i: eng.forward(xs[i]),
                  lambda i: m.forward_fn()(m.params, torch.from_numpy(xs[i]).to(dev)),
                  rel=cs.YOLO_MAP_REL[dtype])


@pytest.mark.cuda
def test_a_capture_that_reads_the_host_raises_naming_the_step(dev):
    from lele_tpu_torch.runtime.graphs import CaptureError, Programs

    def make():
        def host_read(x):
            return x * float(x.sum().item())

        return host_read

    with pytest.raises(CaptureError, match="in host_read"):
        Programs(dev).run("k", make, torch.ones(3, device=dev))


@pytest.mark.cuda
def test_a_dropped_program_is_not_collected_inside_a_capture(dev):
    import gc
    import weakref

    from lele_tpu_torch.runtime.graphs import Programs

    def make():
        return lambda x: x @ x.transpose(-1, -2)

    class Owner:
        def __init__(self):
            self.me = self  # a cycle: only the collector frees it
            self.programs = Programs(dev)
            self.programs.run("old", make, torch.ones(4, 64, 32, device=dev))

    owner = Owner()
    assert owner.programs._progs["old"].graph is not None
    dropped = weakref.ref(owner)
    del owner
    seen = []

    def make_new():
        def fn(x):
            seen.append((torch.cuda.is_current_stream_capturing(), gc.isenabled()))
            return make()(x) @ x
        return fn

    x = torch.randn(8, 96, 64, device=dev)
    assert gc.isenabled()
    programs = Programs(dev)
    out = programs.run("new", make_new, x)
    assert programs._progs["new"].graph is not None
    # the warm-up runs with the collector on; the capture with it off
    assert seen == [(False, True), (True, False)]
    assert gc.isenabled()
    gc.collect()
    assert dropped() is None
    torch.testing.assert_close(programs.run("new", make_new, x), out, rtol=0, atol=0)


# -- the TTS synth, composed models and generative decode as captured programs ---------

TTS_SMALL = dict(d_text=256, n_heads=4, n_text_layers=2, n_est_layers=2,
                 latent_buckets=(64, 128, 256), token_buckets=(48, 96), fused_estimator=True)


def _small_tts(dev, **kw):
    from lele_tpu_torch.models import SupertonicConfig, SupertonicTts

    tts = SupertonicTts(SupertonicConfig(**dict(TTS_SMALL, **kw)), device=dev)
    tts.init(5)
    return tts


def _tts_style(seed=4):
    rng = np.random.default_rng(seed)
    return {"ttl": rng.standard_normal(128).astype(np.float32),
            "dp": rng.standard_normal(128).astype(np.float32)}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["synth", "synth_e2e"])
def test_tts_programs_replay_their_eager_bits(dev, kind):
    """The synth program (two-dispatch route) and the duration → mask →
    synth program at one bucket, captured, against their functions run
    eagerly: the same bits and launch counts (kernel 10 once a flow step),
    one program for three inputs of the bucket."""
    tts = _small_tts(dev)
    T, Tk = 128, 48
    gen = torch.Generator(device=dev).manual_seed(1)
    ins = []
    for i in range(3):
        ids = torch.randint(0, 512, (1, Tk), generator=gen, device=dev)
        tmask = torch.zeros((1, Tk), device=dev)
        tmask[:, :Tk - 5 * i] = 1.0
        style = torch.randn((2, 128), generator=gen, device=dev)
        lmask = torch.zeros((1, T), device=dev)
        lmask[:, :T - 20 * i] = 1.0
        extra = (lmask,) if kind == "synth" else ()
        ins.append((ids, tmask, style[0], style[1], *extra, tts.noise(i)[:, :T]))
    make = (lambda: tts.synth_fn(T)) if kind == "synth" else (lambda: tts.synth_e2e_fn(T, 8))
    _capture_case(lambda i: tts.programs.run((kind, Tk, T), make, *ins[i], params=tts.params),
                  lambda i: make()(*ins[i]))
    assert len(tts.programs) == 1
    K.reset_launch_counts()
    tts.programs.run((kind, Tk, T), make, *ins[0], params=tts.params)
    assert K.launch_counts()["est_block"] == tts.cfg.flow_steps


@pytest.mark.cuda
def test_tts_engine_requests_at_two_buckets_interleaved(dev):
    """Two TtsEngine requests at different latent buckets, alternating
    through one `Programs`: each gives the uncaptured route's WAV bits."""
    from lele_tpu_torch.serving import TtsEngine, encode_wav

    tts = _small_tts(dev)
    eng = TtsEngine(tts=tts)
    style = _tts_style()
    eng.styles["s"] = style
    texts = ("Hi there.", "A longer request takes a larger latent bucket than a short one, "
                          "so its program is another one.")
    want = [encode_wav(tts.synthesize_uncaptured(t, style, seed=k), 24000)
            for k, t in enumerate(texts)]
    got = [eng.synthesize(texts[k % 2], seed=k % 2) for k in range(4)]
    assert got == want + want
    buckets = {key[2] for key in tts.programs._progs}
    assert len(buckets) >= 2 and all(p.graph is not None for p in tts.programs._progs.values())


@pytest.mark.cuda
@pytest.mark.parametrize("fused_duration", [True, False], ids=["e2e", "two_dispatch"])
def test_tts_synthesize_captured_equals_uncaptured(dev, fused_duration):
    tts = _small_tts(dev, apply_latent_denorm=False, speed=1.05)
    style = _tts_style(8)
    for seed, text in enumerate(("Capture once.", "Then replay the graph for every chunk!")):
        tts._fpt_ema = None
        got = tts.synthesize(text, style, seed=seed, fused_duration=fused_duration)
        tts._fpt_ema = None
        want = tts.synthesize_uncaptured(text, style, seed=seed, fused_duration=fused_duration)
        np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
def test_supertonic_onnx_composed_program(dev):
    """SupertonicOnnx.synthesize_latent (one composed program) against the
    pipeline run eagerly (bits) and the host loop (1e-6)."""
    from lele_tpu_torch.models import SupertonicOnnx

    st = SupertonicOnnx(cs.FIXTURES, device=dev)
    io = dict(np.load(cs.FIXTURES / "supertonic_io.npz"))
    n = io["xt"].shape[-1]
    args = (io["ids"], io["style"], io["mask"])
    fused = st.fused(n)
    noises = [st._noise(st._emb_shape()[1], n, seed) for seed in (1, 2, 3)]
    _capture_case(lambda i: st.synthesize_latent(*args, latent_len=n, seed=i + 1),
                  lambda i: fused.uncaptured(*args, noises[i]))
    assert len(fused.programs) == 1
    dur, wave = st.synthesize_latent(*args, latent_len=n, seed=1)
    dur_h, wave_h = st.synthesize_latent_hostloop(*args, latent_len=n, seed=1)
    assert np.abs(wave - wave_h).max() <= 1e-6 and np.array_equal(dur, dur_h)


@pytest.mark.cuda
def test_compose_models_program_per_signature(dev):
    from lele_tpu_torch.compiler import compile_model
    from lele_tpu_torch.onnx import builder as ob
    from lele_tpu_torch.runtime import compose_models

    rng = np.random.default_rng(12)

    def linear(d_in, d_out):
        w = rng.standard_normal((d_in, d_out)).astype(np.float32)
        bs = ob.build_model_bytes(
            [ob.node("MatMul", ["x", "w"], ["mm"]), ob.node("Tanh", ["mm"], ["y"])],
            inputs=[ob.value_info("x", 1, [2, d_in])],
            outputs=[ob.value_info("y", 1, [2, d_out])],
            initializers=[ob.tensor_from_array(w, "w")])
        return compile_model(bs, device=dev)

    def pipeline(call, x):
        for _ in range(3):
            x = x + 0.5 * call("dec", x=call("enc", x=x)[0])[0]
        return x

    pipe = compose_models({"enc": linear(8, 16), "dec": linear(16, 8)}, pipeline)
    xs = [rng.standard_normal((2, 8)).astype(np.float32) for _ in range(3)]
    _capture_case(lambda i: pipe(xs[i]), lambda i: pipe.uncaptured(xs[i]))
    assert len(pipe.programs) == 1


def _gpt2_like(dev, B=1, layers=2, vocab=5000, max_len=96):
    cfg = dict(cs.GPT2, layers=layers, vocab=vocab, max_len=max_len)
    decs, _ = cs.gpt2_decoders(dev, cfg=cfg, beam=B)
    return decs


@pytest.mark.cuda
@pytest.mark.parametrize("temperature", [0.0, 0.8], ids=["greedy", "sampled"])
def test_decode_program_equals_hostloop(dev, temperature):
    """The whole generation as one step program replayed a token, at GPT-2
    small's width (2 layers): the host loop's ids and last logits, one
    program for prompts of two lengths."""
    dec = _gpt2_like(dev)[1]
    prompts = cs.decode_prompts(5000)
    for k, prompt in enumerate(prompts):
        got, lg = dec.generate(prompt, 24, temperature=temperature, seed=k)
        want, lh = dec.generate_hostloop(prompt, 24, rng=k, temperature=temperature)
        assert got == want and np.array_equal(lg, lh)
    assert len(dec.programs) == 1


@pytest.mark.cuda
def test_decode_donated_caches_across_two_interleaved_decoders(dev):
    """Two decoders on one step graph, their generations alternating, and
    one decoder alternating two prompts: each run gives its solo ids."""
    from lele_tpu_torch.runtime import StaticKVDecoder

    d1 = _gpt2_like(dev)[1]
    d2 = StaticKVDecoder(d1.cm, d1.L, d1.H, d1.D, d1.P + 1)
    pa, pb = cs.decode_prompts(5000)
    solo = [d1.generate_hostloop(p, 20)[0] for p in (pa, pb)]
    for _ in range(2):
        assert d1.generate(pa, 20)[0] == solo[0]
        assert d2.generate(pb, 20)[0] == solo[1]
        assert d1.generate(pb, 20)[0] == solo[1]
    assert len(d1.programs) == len(d2.programs) == 1


@pytest.mark.cuda
def test_beam_search_program_equals_hostloop(dev):
    beam = _gpt2_like(dev, B=4)[4]
    prompt = cs.decode_prompts(5000)[1][:3]
    for eos in (None, 7):
        ids, score = beam.beam_search(prompt, 16, beam=4, eos_id=eos)
        ids_h, score_h = cs.beam_hostloop(beam, prompt, 16, eos_id=eos)
        assert ids == ids_h and abs(score - score_h) <= 1e-5 * max(abs(score_h), 1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("sr", [16000, 8000])
@pytest.mark.parametrize("form", ["scan", "loop"])
def test_silero_utterance_scan_and_loop_capture(dev, form, sr):
    """Silero's utterance as one ONNX Scan or Loop (chip_smoke phase 34, at
    2.3 s): one captured graph a call, kernel 6 once a chunk as kernel nodes
    of that graph, SileroOnnx.speech_probs' bits, the step-by-step replay's
    bits, and the plain-LSTM compile within VAD_PROB_TOL."""
    from lele_tpu_torch.compiler import compile_model
    from lele_tpu_torch.models import SileroOnnx
    from lele_tpu_torch.ops import nn_ops

    pcms = [cs.vad_pcm(2.3, sr, np.random.default_rng(k)) for k in range(3)]
    sv = SileroOnnx(cs.SILERO_FIXTURE, device=dev)
    chunks = [torch.from_numpy(sv._chunks(p, None)[:, None]).to(dev) for p in pcms]
    n = chunks[0].shape[0]
    bs = cs.silero_utterance_model(form, n, sr)
    cm = compile_model(bs, device=dev)
    plain = compile_model(bs, device=dev, overrides={"LSTM": nn_ops.lstm_plain})
    state = torch.zeros((2, 1, 128), device=dev)
    _capture_case(lambda i: cm(chunks=chunks[i], state=state),
                  lambda i: cm.replay(chunks=chunks[i], state=state))
    assert cm.stats["captured"] and cm._program._delta[0]["lstm_seq"] == n
    checks = cs.Checks()
    cs.program_launch_check(checks, form, [cm._program])
    assert not checks.failures
    for p, c in zip(pcms, chunks):
        probs = cm(chunks=c, state=state)[0].cpu().numpy()
        assert np.array_equal(probs, sv.speech_probs(p, sr))
        ref = plain(chunks=c, state=state)[0].cpu().numpy()
        assert np.abs(probs - ref).max() <= cs.VAD_PROB_TOL


@pytest.mark.cuda
def test_padded_loop_and_scan_capture_with_their_bits(dev):
    """The padded exit (an active flag on the card) and a Scan with reverse
    axes capture and give the step-by-step replay's bits on three inputs."""
    from lele_tpu_torch.compiler import compile_model
    from lele_tpu_torch.onnx import builder as ob

    body = ob.graph(
        [ob.node("Add", ["v_in", "v_in"], ["v_out"]),
         ob.node("ReduceSum", ["v_out"], ["s"], keepdims=0),
         ob.node("Less", ["s", "lim"], ["cond_out"]),
         ob.node("Identity", ["v_out"], ["scan0"])],
        name="body",
        inputs=[ob.value_info("iter", 7, []), ob.value_info("cond_in", 9, []),
                ob.value_info("v_in", 1, [2])],
        outputs=[ob.value_info("cond_out", 9, []), ob.value_info("v_out", 1, [2]),
                 ob.value_info("scan0", 1, [2])])
    sbody = ob.graph(
        [ob.node("Add", ["s_in", "x_t"], ["s_out"]), ob.node("Neg", ["s_out"], ["y_t"])],
        name="sbody",
        inputs=[ob.value_info("s_in", 1, [2]), ob.value_info("x_t", 1, [2])],
        outputs=[ob.value_info("s_out", 1, [2]), ob.value_info("y_t", 1, [2])])
    nodes = [ob.node("Loop", ["M", "", "x"], ["y", "ys"], body=body),
             ob.node("Scan", ["y", "xs"], ["s", "zs"], body=sbody, num_scan_inputs=1,
                     scan_input_axes=[1], scan_input_directions=[1])]
    bs = ob.build_model_bytes(
        nodes, [ob.value_info("x", 1, [2]), ob.value_info("xs", 1, [2, 5])],
        [ob.value_info(o, 1, []) for o in ("ys", "s", "zs")],
        [ob.tensor_from_array(np.array(6, np.int64), "M"),
         ob.tensor_from_array(np.float32(30.0), "lim")])
    cm = compile_model(bs, device=dev)
    assert cm.stats["capturable"]
    gen = torch.Generator(device=dev).manual_seed(3)
    ins = [dict(x=torch.rand(2, generator=gen, device=dev) * k,
                xs=torch.randn(2, 5, generator=gen, device=dev)) for k in (1, 3, 0.1)]
    _capture_case(lambda i: cm(**ins[i]), lambda i: cm.replay(**ins[i]))
    assert cm.stats["captured"]


@pytest.mark.cuda
def test_function_packaged_sanm_export_fuses_on_the_card(dev):
    """A function-packaged int8 SAN-M export (chip_smoke phase 34's, at 4 of
    its 50 layers): 4 fused layers, kernel 4 once a call in a captured
    graph, the flat export's bits, the per-op trace within
    chip_smoke.LOGIT_NOISE_MAE on the valid rows."""
    from lele_tpu_torch.compiler import compile_model
    from lele_tpu_torch.onnx.quantize import quantize_dynamic

    L, T, valid = 4, cs.T_DQL, cs.VALID_DQL
    layer, encoder = cs.sanm_modules(T, 512, 4, 2048, 11)
    torch.manual_seed(1)
    enc = encoder(L).eval()
    x = torch.randn(1, T, 512)
    bias, vmask = torch.zeros(1, 1, 1, T), torch.ones(1, 1, T)
    bias[..., valid:] = -1e4
    vmask[..., valid:] = 0.0
    args = (x, bias, vmask)
    # one export with functions a module: torch's function extraction
    # asserts on a second one of the same instance
    q_fn = quantize_dynamic(cs.sanm_export(enc, layer, args, True))
    cm = compile_model(q_fn, device=dev)
    flat = compile_model(quantize_dynamic(cs.sanm_export(enc, layer, args, False)), device=dev)
    per_op = compile_model(q_fn, device=dev, patterns=[])
    assert cm.stats["pattern_hits"]["sanm_fused_layers"] == L
    inputs = {"x": x.to(dev), "attn_bias": bias.to(dev), "vmask": vmask.to(dev)}
    _capture_case(lambda i: cm(**inputs), lambda i: cm.replay(**inputs))
    assert cm._program._delta[0]["sanm_stack_dql"] == 1
    out = cm(**inputs)[0]
    assert torch.equal(out, flat(**inputs)[0])
    _, _, mae = cs.compare(out[:, :valid], per_op(**inputs)[0][:, :valid])
    assert mae <= cs.LOGIT_NOISE_MAE


# -- the ORT-GenAI decoder form (chip_smoke phase 35) --------------------------


def _gqa_step_graph(B, qh, kvh, head, L):
    from lele_tpu_torch.onnx import builder as ob

    ms = dict(domain="com.microsoft")
    node = ob.node("GroupQueryAttention", ["q", "k", "v", "pk", "pv", "slk", "tot"],
                   ["y", "npk", "npv"], num_heads=qh, kv_num_heads=kvh, **ms)
    ins = [ob.value_info("q", 1, [B, 1, qh * head]), ob.value_info("k", 1, [B, 1, kvh * head]),
           ob.value_info("v", 1, [B, 1, kvh * head]),
           ob.value_info("pk", 1, [B, kvh, L, head]), ob.value_info("pv", 1, [B, kvh, L, head]),
           ob.value_info("slk", 6, [B]), ob.value_info("tot", 6, [1])]
    return ob.build_model_bytes([node], inputs=ins,
                                outputs=[ob.value_info(n, 1, []) for n in ("y", "npk", "npv")])


@pytest.mark.cuda
def test_genai_gqa_decode_step_captured_at_b2_unequal_lengths(dev):
    """A GroupQueryAttention decode step at B = 2 with unequal seqlens_k (the
    append's offsets on the card), captured in one CUDA graph with its caches
    donated, gives the bits of the uncaptured, undonated replay(), call after
    call with the caches fed back."""
    from lele_tpu_torch.compiler import compile_model

    B, qh, kvh, head, L = 2, 8, 2, 64, 256
    cm = compile_model(_gqa_step_graph(B, qh, kvh, head, L), device=dev, strict=True,
                       donate=["pk", "pv"])
    gen = torch.Generator(device=dev).manual_seed(0)
    pk, pv = (torch.randn((B, kvh, L, head), generator=gen, device=dev) for _ in range(2))
    lens = torch.tensor([9, 200], dtype=torch.int32, device=dev)
    for step in range(4):
        f = {n: torch.randn((B, 1, w * head), generator=gen, device=dev)
             for n, w in (("q", qh), ("k", kvh), ("v", kvh))}
        f.update(pk=pk, pv=pv, slk=lens + step,
                 tot=torch.full((1,), 201 + step, dtype=torch.int32, device=dev))
        got, want = cm(**f), cm.replay(**f)
        assert cm.stats["captured"]
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        rows = (lens + step).long()
        for r in range(B):  # each row's new key landed at its own offset
            assert torch.equal(got[1][r, :, rows[r]], f["k"][r, 0].reshape(kvh, head))
        pk, pv = got[1], got[2]


@pytest.mark.cuda
def test_genai_donated_caches_pair_k_with_k_and_v_with_v(dev, tmp_path):
    """The small GenAI decoder (2 layers) from a side file, its 2·nl caches
    donated in graph order: a prefill and 4 greedy steps through captured
    graphs give the replay()'s bits, each present lands on its own past (k
    and v differ, so a swap would show), and every output is within
    chip_smoke.NBITS_RELNORM (relative Frobenius) of the CPU's run of the
    same files on the same feeds (kernel 7's plain version there, the same
    bf16 activations)."""
    from lele_tpu_torch.compiler import compile_model
    from lele_tpu_torch.onnx import builder as ob
    from lele_tpu_torch.onnx.synth import (GENAI_CFG, build_genai_decoder, genai_decoder_params,
                                           genai_feeds)

    cfg = dict(GENAI_CFG, B=1, ffn=64)
    inits, _ = genai_decoder_params(np.random.default_rng(0), cfg)
    paths = []
    for s in (4, 1):
        paths.append(tmp_path / f"s{s}.onnx")
        ob.save_with_external_data(build_genai_decoder(inits, s, cfg, raw=True), paths[-1],
                                   size_threshold=64)
    donate = [f"p{kv}{i}" for i in range(cfg["nl"]) for kv in "kv"]
    cms = [compile_model(str(p), device=dev, strict=True, donate=donate) for p in paths]
    cpu = [compile_model(str(p), device="cpu", strict=True) for p in paths]
    for cm in cms:
        assert {k: cm.output_names[j] for k, j in cm.donated.items()} == {
            k: "n" + k for k in donate}
    shape = (1, cfg["kvh"], cfg["L"], cfg["hd"])
    caches = [np.zeros(shape, np.float32)] * (2 * cfg["nl"])
    ids = np.array([[3, 1, 4, 1]], np.int64)
    f = genai_feeds(ids, np.arange(4)[None], 0, 4, caches[0::2], caches[1::2], cfg)
    for step in range(5):
        cm = cms[min(step, 1)]
        fd = {k: torch.from_numpy(np.asarray(v)).to(dev) for k, v in f.items()}
        got, want = cm(**fd), cm.replay(**fd)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        ref = cpu[min(step, 1)].run_np(**f)
        for i, (a, b) in enumerate(zip(got, ref)):
            a = a.cpu().numpy()
            rel = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)
            assert rel <= cs.NBITS_RELNORM, (step, i, rel)
        for i in range(cfg["nl"]):
            assert not torch.equal(got[1 + 2 * i], got[2 + 2 * i])
        tok = got[0][:, -1].argmax(-1).cpu().numpy()[:, None].astype(np.int64)
        plen = 4 + step
        ks = [g.cpu().numpy() for g in got[1:]]
        f = genai_feeds(tok, np.full((1, 1), plen, np.int64), plen, 1, ks[0::2], ks[1::2], cfg)


@pytest.mark.cuda
def test_fp8_initializers_reach_the_card_as_float8(dev, monkeypatch):
    """An fp8 initializer goes to the card as a torch float8 tensor, from
    ml_dtypes' storage and from its bits where ml_dtypes is absent (the card
    machine's case), and a Cast of it runs."""
    from lele_tpu_torch.compiler import compile_model
    from lele_tpu_torch.onnx import builder as ob
    from lele_tpu_torch.onnx import loader

    bits = np.array([0x38, 0xC0, 0x30, 0x48], np.uint8)  # e4m3fn 1, -2, 0.5, 4
    td = {"name": "w", "dims": [4], "data_type": 17, "raw_data": bits.tobytes()}
    bs = ob.build_model_bytes(
        [ob.node("Cast", ["w"], ["wf"], to=1), ob.node("Add", ["x", "wf"], ["y"]),
         ob.node("Identity", ["w"], ["w8"])],
        inputs=[ob.value_info("x", 1, [4])],
        outputs=[ob.value_info("y", 1, [4]), ob.value_info("w8", 17, [4])],
        initializers=[td], opset=21)
    for no_ml_dtypes in (False, True):
        if no_ml_dtypes:
            for k in (17, 18, 19, 20):
                monkeypatch.delitem(loader.DTYPE_MAP, k, raising=False)
        y, w8 = compile_model(bs, device=dev, strict=True)(x=torch.ones(4, device=dev))
        assert w8.dtype == torch.float8_e4m3fn and w8.is_cuda
        assert torch.equal(w8.float().cpu(), torch.tensor([1.0, -2.0, 0.5, 4.0]))
        assert torch.equal(y.cpu(), torch.tensor([2.0, -1.0, 1.5, 5.0]))


# -- the ONNX op layer's math, tensor, nn and activation emitters (phase 36) ------


def _one_op(op_type, inputs, inits=None, n_out=1, opset=17, names=None, **attrs):
    from lele_tpu_torch.onnx import builder as ob

    outs = [f"y{i}" for i in range(n_out)]
    return ob.build_model_bytes(
        [ob.node(op_type, names or list(inputs) + list(inits or {}), outs, **attrs)],
        [ob.vi_from_array(k, v) for k, v in inputs.items()],
        [ob.value_info(o, 1, []) for o in outs],
        [ob.tensor_from_array(v, k) for k, v in (inits or {}).items()], opset=opset)


def _card_and_cpu(bs, inputs, bits=True):
    """(the captured card call's outputs, the CPU's) of the same bytes; the
    card's call must capture and give its replay()'s bits (`bits`; else
    within 1e-5 relative: atomic sums land in any order)."""
    from lele_tpu_torch.compiler import compile_model

    cm = compile_model(bs, device="cuda", strict=True)
    got = [o.clone() for o in cm(**inputs)]
    again = cm.replay(**inputs)
    assert cm.stats["captured"]
    for a, b in zip(got, again):
        assert torch.equal(a, b) if bits else torch.allclose(a, b, rtol=1e-5, atol=1e-6)
    cpu = compile_model(bs, device="cpu", strict=True).run_np(**inputs)
    return [g.cpu().numpy() for g in got], cpu


@pytest.mark.cuda
def test_topk_and_argmax_ties_take_the_lower_index_on_cuda(dev):
    """lax.top_k's order among equal values (the lower index first) and
    ArgMax's first / last extreme, on the card, where torch.topk's order of
    ties is not defined: wide rows of few distinct values."""
    rng = np.random.default_rng(0)
    x = rng.integers(0, 4, (64, 4096)).astype(np.float32)
    for largest in (1, 0):
        (vals, idx), (cv, ci) = _card_and_cpu(
            _one_op("TopK", {"x": x}, {"k": np.array([300], np.int64)}, n_out=2,
                    largest=largest), {"x": x})
        order = np.argsort(-x if largest else x, axis=1, kind="stable")[:, :300]
        np.testing.assert_array_equal(idx, order)
        np.testing.assert_array_equal(idx, ci)
        np.testing.assert_array_equal(vals, cv)
    for op_type, last in (("ArgMax", 0), ("ArgMax", 1), ("ArgMin", 0), ("ArgMin", 1)):
        (got,), (cpu,) = _card_and_cpu(
            _one_op(op_type, {"x": x}, axis=1, keepdims=0, select_last_index=last), {"x": x})
        ext = (x.max if op_type == "ArgMax" else x.min)(1, keepdims=True)
        hits = x == ext
        want = 4095 - np.argmax(hits[:, ::-1], 1) if last else np.argmax(hits, 1)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, cpu)


@pytest.mark.cuda
def test_maxpool_indices_on_cuda(dev):
    """MaxPool's Indices output on the card: the first maximum of each
    window as a flat position over the whole [N, C, H, W] tensor (and with
    the spatial axes column-major at storage_order 1), padded windows and
    ceil_mode's extra window included, equal to the CPU's; windows full of
    equal values pick their first entry."""
    rng = np.random.default_rng(1)
    x = np.round(rng.standard_normal((2, 3, 9, 10)), 0).astype(np.float32)
    for order in (0, 1):
        (vals, idx), (cv, ci) = _card_and_cpu(
            _one_op("MaxPool", {"x": x}, n_out=2, kernel_shape=[3, 3], strides=[2, 2],
                    pads=[1, 1, 0, 1], ceil_mode=1, storage_order=order), {"x": x})
        np.testing.assert_array_equal(idx, ci)
        np.testing.assert_array_equal(vals, cv)
        n, c, h, w = np.unravel_index(idx, x.shape) if not order else (
            idx // (3 * 90), idx // 90 % 3, idx % 90 % 9, idx % 90 // 9)
        np.testing.assert_array_equal(x[n, c, h, w], vals)


@pytest.mark.cuda
def test_scatter_duplicates_take_the_last_update_on_cuda(dev):
    """ScatterND and ScatterElements without a reduction write a position
    named twice with its last update (JAX's CPU order), deterministically on
    the card; with add and mul every update counts (in the order the card's
    atomics take them, so those calls agree to rounding, not bits)."""
    rng = np.random.default_rng(2)
    d = rng.standard_normal((8, 16)).astype(np.float32)
    idx = rng.integers(0, 8, (64, 1)).astype(np.int64)  # many duplicates
    u = rng.standard_normal((64, 16)).astype(np.float32)
    want = d.copy()
    for i, row in enumerate(idx[:, 0]):
        want[row] = u[i]
    for red in ("none", "add", "mul"):
        (got,), (cpu,) = _card_and_cpu(
            _one_op("ScatterND", {"d": d, "u": u}, {"i": idx}, names=["d", "i", "u"],
                    opset=18, reduction=red), {"d": d, "u": u}, bits=red == "none")
        if red == "none":
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(cpu, want)
        else:
            np.testing.assert_allclose(got, cpu, rtol=1e-5, atol=1e-5)
    ie = rng.integers(0, 16, (8, 40)).astype(np.int64)
    ue = rng.standard_normal((8, 40)).astype(np.float32)
    want = d.copy()
    for r in range(8):
        for j in range(40):
            want[r, ie[r, j]] = ue[r, j]
    (got,), (cpu,) = _card_and_cpu(
        _one_op("ScatterElements", {"d": d, "u": ue}, {"i": ie}, names=["d", "i", "u"],
                axis=1), {"d": d, "u": ue})
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(cpu, want)


@pytest.mark.cuda
def test_random_ops_give_the_same_numbers_every_captured_call(dev):
    """The Random ops draw once at trace time (JAX's key is a trace-time
    constant): two replays of the captured graph, and the CPU's compile of
    the same bytes, give the same numbers; nodes with different seeds give
    different ones."""
    from lele_tpu_torch.compiler import compile_model
    from lele_tpu_torch.onnx import builder as ob

    bs = ob.build_model_bytes(
        [ob.node("RandomNormalLike", ["x"], ["n"], seed=1.0),
         ob.node("RandomUniform", [], ["u"], shape=[64, 64], seed=2.0),
         ob.node("Add", ["x", "n"], ["a"]), ob.node("Add", ["a", "u"], ["y"]),
         ob.node("RandomUniformLike", ["x"], ["v"], seed=3.0), ob.node("Mul", ["v", "x"], ["z"])],
        [ob.value_info("x", 1, [64, 64])], [ob.value_info("y", 1, []), ob.value_info("z", 1, [])])
    cm = compile_model(bs, device=dev, strict=True)
    x = torch.ones((64, 64), device=dev)
    first = [o.clone() for o in cm(x=x)]
    second = cm(x=x)
    assert cm.stats["captured"]
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    cpu = compile_model(bs, device="cpu", strict=True).run_np(x=np.ones((64, 64), np.float32))
    for a, b in zip(first, cpu):
        np.testing.assert_array_equal(a.cpu().numpy(), b)
    z = first[1].cpu().numpy()
    assert 0.0 <= z.min() and z.max() < 1.0 and not np.array_equal(z, first[0].cpu().numpy())


@pytest.mark.cuda
def test_int_div_and_mod_by_zero_give_jax_values_on_cuda(dev):
    """Integer Div and Mod on the card where the divisor is zero give the
    JAX package's CPU values ([7, -7, 0] / 0 -> [-2, -1, -1]; Mod and fmod
    by zero -> 0; all ones for uint8 Div), and the CPU's elsewhere."""
    for dt in (np.int32, np.int64, np.uint8):
        a = np.array([7, 250, 0, 9, 5] if dt == np.uint8 else [7, -7, 0, -9, 5], dt)
        b = np.array([0, 0, 0, 2, 3], dt)
        for op_type, attrs in (("Div", {}), ("Mod", {}), ("Mod", {"fmod": 1})):
            (got,), (cpu,) = _card_and_cpu(_one_op(op_type, {"a": a, "b": b}, **attrs),
                                           {"a": a, "b": b})
            np.testing.assert_array_equal(got, cpu)
            if op_type == "Div":
                zero = [255] * 3 if dt == np.uint8 else [-2, -1, -1]
                np.testing.assert_array_equal(got[:3], zero)
            else:
                np.testing.assert_array_equal(got[:3], 0)


@pytest.mark.cuda
def test_int_pow_wraps_like_jax_on_cuda(dev):
    """Integer Pow on the card gives the CPU's bits, jnp.power's wrapped
    values under negative exponents included (3^-2 -> 703,701,817 in int32)."""
    rng = np.random.default_rng(4)
    for dt in (np.int8, np.int32, np.int64):
        a = rng.integers(-6, 7, 256).astype(dt)
        b = rng.integers(-70, 70, 256).astype(dt)
        a[:3], b[:3] = [3, 0, 0], [-2, 0, 64]
        (got,), (cpu,) = _card_and_cpu(_one_op("Pow", {"a": a, "b": b}), {"a": a, "b": b})
        np.testing.assert_array_equal(got, cpu)
        if dt == np.int32:
            assert got[0] == 703_701_817 and got[1] == 1 and got[2] == 0


@pytest.mark.cuda
def test_index_graphs_keep_their_device_constants(dev):
    """GatherND, ScatterND and Compress compiled and captured, then 300 other
    Compress models compiled and run on the card and freed memory
    refilled with -1: a replay of the first models still gives their first
    call's bits and the CPU's. Their device constants (Compress's index
    vector, the hoisted indices) belong to each compiled model."""
    from lele_tpu_torch.compiler import compile_model

    rng = np.random.default_rng(5)
    x = rng.standard_normal((4, 16, 3)).astype(np.float32)
    d = rng.standard_normal((8, 16)).astype(np.float32)
    u = rng.standard_normal((6, 16)).astype(np.float32)
    graphs = [
        (_one_op("ScatterND", {"d": d, "u": u},
                 {"i": np.array([[-1], [2], [0], [-8], [5], [2]], np.int64)},
                 names=["d", "i", "u"]), {"d": d, "u": u}),
        (_one_op("GatherND", {"x": x},
                 {"i": np.stack([rng.integers(-16, 16, (4, 7)), rng.integers(-3, 3, (4, 7))],
                                -1).astype(np.int64)}, batch_dims=1), {"x": x}),
        (_one_op("Compress", {"x": x}, {"c": rng.random(16) < 0.5}, axis=1), {"x": x}),
    ]
    held = []
    for bs, feeds in graphs:
        cm = compile_model(bs, device=dev, strict=True)
        first = [o.cpu().numpy() for o in cm(**feeds)]
        assert cm.stats["captured"]
        cpu = compile_model(bs, device="cpu", strict=True).run_np(**feeds)
        for a, b in zip(first, cpu):
            np.testing.assert_array_equal(a, b)
        held.append((cm, feeds, first))
    for _ in range(300):  # a distinct index vector a model
        other = _one_op("Compress", {"x": x}, {"c": rng.random(16) < 0.5}, axis=1)
        compile_model(other, device=dev, strict=True)(x=x)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    junk = [torch.full((int(n),), -1, dtype=torch.int64, device=dev)
            for n in rng.integers(1, 4096, 512)]
    del junk
    for cm, feeds, first in held:
        again = [o.cpu().numpy() for o in cm(**feeds)]
        for a, b in zip(first, again):
            np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("name", [c["name"] for c in cs.emitter_graphs()])
def test_emitter_graph_on_the_card(dev, name):
    """Each of phase 36's graphs on the card, captured (or folded on
    concrete values), against the CPU at its gate."""
    c = next(c for c in cs.emitter_graphs() if c["name"] == name)
    from lele_tpu_torch.compiler import compile_model

    bs = cs.emitter_graph_bytes(c)
    cm = compile_model(bs, device=dev, strict=True)
    got = [o.cpu().numpy() for o in cm(**c["inputs"])]
    assert cm.stats["captured"] or c["concrete"]
    cpu = compile_model(bs, device="cpu", strict=True).run_np(**c["inputs"])
    for g, w in zip(got, cpu):
        assert g.shape == w.shape
        fin = np.isfinite(w)
        np.testing.assert_array_equal(g[~fin], w[~fin])
        if fin.any():
            scale = max(1.0, float(np.abs(w[fin]).max()))
            assert np.abs(g[fin].astype(np.float64) - w[fin]).max() <= c["tol"] * scale


# -- static int8 quantization (chip_smoke phase 37) ------------------------------


def _ints(rng, shape, dt):
    info = np.iinfo(dt)
    return rng.integers(info.min, info.max + 1, shape).astype(dt)


# name → (x shape, w shape, x type, w type, attributes, x zero point)
CONV_INTEGER_CARD = {
    "stem 7 x 7 / 2, K = 147": ((2, 3, 64, 64), (64, 3, 7, 7), np.uint8, np.int8,
                                dict(strides=[2, 2], pads=[3, 3, 3, 3]), 121),
    "grouped 3 x 3, C_out 20": ((2, 8, 15, 15), (20, 2, 3, 3), np.uint8, np.uint8,
                                dict(group=4, pads=[1, 1, 1, 1]), 7),
    "3-D, dilated": ((1, 4, 6, 9, 9), (6, 4, 2, 3, 3), np.int8, np.int8,
                     dict(dilations=[1, 2, 2], pads=[0, 1, 2, 1, 1, 0]), -5),
    "16-aligned 1 x 1": ((4, 64, 14, 14), (128, 64, 1, 1), np.uint8, np.int8, {}, 128),
    "padded 3 x 3 / 2, SAME_UPPER": ((3, 32, 17, 16), (48, 32, 3, 3), np.uint8, np.int8,
                                     dict(strides=[2, 2], auto_pad="SAME_UPPER"), 200),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CONV_INTEGER_CARD))
def test_conv_integer_on_kernel_11(dev, name):
    """ConvInteger on the card: im2col and kernel 11 (one launch a group,
    the stem's K = 147 and C_out = 20 on its cp.async form, the 1 x 1 at
    K = 64 and C_out = 128 on its TMA form), a per-channel weight zero point
    and a nonzero input zero point padding the input: the CPU's int32
    outputs (the float64 convolution) and the plain override's on the card,
    captured with replay()'s bits."""
    from lele_tpu_torch.compiler import compile_model
    from lele_tpu_torch.onnx import builder as ob
    from lele_tpu_torch.ops import quant_ops

    xs, ws, xdt, wdt, attrs, xzp = CONV_INTEGER_CARD[name]
    rng = np.random.default_rng(len(name))
    x, w = _ints(rng, xs, xdt), _ints(rng, ws, wdt)
    inits = {"w": w, "xz": np.asarray(xzp, xdt), "wz": _ints(rng, (ws[0],), wdt) // 8}
    bs = ob.build_model_bytes(
        [ob.node("ConvInteger", ["x", "w", "xz", "wz"], ["y"], **attrs)],
        [ob.vi_from_array("x", x)], [ob.value_info("y", 6, [])],
        [ob.tensor_from_array(v, k) for k, v in inits.items()])
    K.reset_launch_counts()
    (got,), (cpu,) = _card_and_cpu(bs, {"x": x})
    assert K.launch_counts()["int8_gemm"] >= attrs.get("group", 1)
    np.testing.assert_array_equal(got, cpu)
    plain = compile_model(bs, device=dev, strict=True,
                          overrides={"ConvInteger": quant_ops.conv_integer_plain})
    np.testing.assert_array_equal(plain(x=x)[0].cpu().numpy(), cpu)


@pytest.mark.cuda
def test_qlinear_conv_and_qgemm_requantize_on_the_card(dev):
    """QLinearConv (per-channel w_scale, int32 bias, stride 2) and QGemm
    (per-column b_scale, alpha, transB, both output modes) on the card give
    the CPU's codes and floats bit for bit: the integer sums are exact and
    the requantization the same f32 steps in the same order."""
    from lele_tpu_torch.onnx import builder as ob

    rng = np.random.default_rng(11)
    x, w = _ints(rng, (2, 16, 20, 20), np.uint8), _ints(rng, (24, 16, 3, 3), np.int8)
    inits = {"xs": np.float32(0.02), "xz": np.uint8(121), "w": w,
             "ws": (rng.random(24) * 0.01 + 0.002).astype(np.float32),
             "wz": np.zeros(24, np.int8), "ys": np.float32(0.6), "yz": np.uint8(20),
             "b": rng.integers(-9000, 9000, 24).astype(np.int32)}
    bs = ob.build_model_bytes(
        [ob.node("QLinearConv", ["x", *inits], ["y"], strides=[2, 2], pads=[1, 1, 1, 1])],
        [ob.vi_from_array("x", x)], [ob.value_info("y", 2, [])],
        [ob.tensor_from_array(v, k) for k, v in inits.items()])
    (got,), (cpu,) = _card_and_cpu(bs, {"x": x})
    assert got.dtype == np.uint8 and 0 < (got > 20).mean() < 1
    np.testing.assert_array_equal(got, cpu)
    a = _ints(rng, (37, 300), np.uint8)
    g = {"sa": np.float32(0.02), "za": np.uint8(120), "b": _ints(rng, (100, 300), np.int8),
         "sb": (rng.random(100) * 0.01 + 0.001).astype(np.float32), "zb": np.zeros(100, np.int8),
         "c": rng.integers(-5000, 5000, 100).astype(np.int32)}
    for extra in ({}, {"sy": np.float32(0.5), "zy": np.uint8(100)}):
        bs = ob.build_model_bytes(
            [ob.node("QGemm", ["a", *g, *extra], ["y"], domain="com.microsoft", alpha=0.5,
                     transB=1)],
            [ob.vi_from_array("a", a)], [ob.value_info("y", 1, [])],
            [ob.tensor_from_array(v, k) for k, v in {**g, **extra}.items()])
        (got,), (cpu,) = _card_and_cpu(bs, {"a": a})
        np.testing.assert_array_equal(got, cpu)


@pytest.mark.cuda
def test_u8_maxpool_and_int4_zero_point_on_cuda(dev):
    """MaxPool on u8 codes comes back as u8 with the CPU's values (through an
    exact f32 copy); QuantizeLinear with an int4 zero point clips at [-8, 7]
    on the card as on the CPU."""
    from lele_tpu_torch.onnx import builder as ob

    rng = np.random.default_rng(12)
    x = _ints(rng, (2, 8, 13, 13), np.uint8)
    (got,), (cpu,) = _card_and_cpu(_one_op("MaxPool", {"x": x}, kernel_shape=[3, 3],
                                           strides=[2, 2], pads=[1, 1, 1, 1]), {"x": x})
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, cpu)
    xf = np.linspace(-40, 40, 96, dtype=np.float32).reshape(4, 24)
    bs = ob.build_model_bytes(
        [ob.node("QuantizeLinear", ["x", "s", "z"], ["y"])], [ob.vi_from_array("x", xf)],
        [ob.value_info("y", 3, [])],
        [ob.tensor_from_array(np.float32(2.0), "s"), ob.tensor_int4(np.asarray(-2), "z")],
        opset=21)
    (got,), (cpu,) = _card_and_cpu(bs, {"x": xf})
    np.testing.assert_array_equal(got, cpu)
    assert got.dtype == np.int8 and got.min() == -8 and got.max() == 7


@pytest.mark.cuda
@pytest.mark.parametrize("name", [c["name"] for c in cs.quant_emitter_graphs()])
def test_quant_emitter_graph_on_the_card(dev, name):
    """Each of phase 37's 17 emitter graphs on the card, captured, against
    the CPU at its gate (integer codes within `codes`, floats within
    `tol`)."""
    c = next(c for c in cs.quant_emitter_graphs() if c["name"] == name)
    got, cpu = _card_and_cpu(cs.emitter_graph_bytes(c), c["inputs"])
    for g, w in zip(got, cpu):
        assert g.shape == w.shape and g.dtype == w.dtype
        if np.issubdtype(w.dtype, np.integer):
            assert np.abs(g.astype(np.int64) - w).max() <= c["codes"]
        else:
            assert np.abs(g.astype(np.float64) - w).max() <= c["tol"] * max(
                1.0, float(np.abs(w).max()))


def _sanm_feeds(T, seed):
    rng = np.random.default_rng(seed)
    return {"speech": rng.standard_normal((1, T, 560)).astype(np.float32),
            "speech_lengths": np.array([T - 3], np.int64), "language": np.array([3], np.int32),
            "textnorm": np.array([0], np.int32)}


@pytest.mark.cuda
def test_cli_wrapper_captured_against_replay(dev, tmp_path):
    """The CLI's wrapper of a small int8 SAN-M graph on the card (phase 38's
    form at 2 layers, d256): its captured call gives `replay()`'s bits with
    kernels 4 and 5 launched once a call, and a blob with the head's int8
    weight negated changes the output (the blob loads in place)."""
    import importlib.util

    from lele_tpu_torch.cli import compile_to_dir
    from lele_tpu_torch.compiler.weights import load_weights, save_weights
    from lele_tpu_torch.onnx.synth import build_sanm_int8_model

    p = tmp_path / "sanm.onnx"
    p.write_bytes(build_sanm_int8_model(L=2, d=256, h=4, ffn=512, vocab=300, int8_head=True))
    wrapper = compile_to_dir(str(p), str(tmp_path / "g"), "CardSanm", dim_values={"T": 32})
    spec = importlib.util.spec_from_file_location("card_wrapper_sanm", wrapper)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    m = mod.CardSanm()
    assert m._cm.device.type == "cuda" and m._cm.stats["capturable"]
    feeds = _sanm_feeds(32, 5)
    K.reset_launch_counts()
    got = m.forward(**feeds)
    counts = K.launch_counts()
    assert counts["sanm_stack_dql"] == 1 and counts["dq_gemm"] == 1, counts
    assert m._cm.stats["captured"]
    want = [o.cpu().numpy() for o in m._cm.replay(**feeds)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    blob = load_weights(tmp_path / "g" / "CardSanm_weights")
    head = next(k for k in blob if k.endswith("::i8"))
    save_weights(tmp_path / "neg", {**blob, head: -blob[head]})
    other = mod.CardSanm(weights_prefix=str(tmp_path / "neg")).forward(**feeds)
    assert not np.array_equal(other[0], got[0])


@pytest.mark.cuda
def test_server_burst_against_recognize_batch(dev):
    """A burst of 8 concurrent /recognize requests of different lengths to the
    port's server over a small w8a16 engine on the card: each answer is what
    `recognize_batch` gives the batch it was coalesced into, and some batch
    holds more than one request."""
    import concurrent.futures
    import threading
    import urllib.request

    from lele_tpu_torch.models import (SenseVoiceConfig, SenseVoiceModel, cast_big_params,
                                       prepare_w8_params, stack_layer_params)
    from lele_tpu_torch.runtime.batcher import MicroBatcher
    from lele_tpu_torch.server import serve
    from lele_tpu_torch.serving import SenseVoiceEngine

    model = SenseVoiceModel(SenseVoiceConfig(n_layers=2, d_model=256, n_heads=4, ffn_dim=512,
                                             vocab_size=300, weight_int8=True), device=dev)
    model.init(0)
    model.params = stack_layer_params(prepare_w8_params(cast_big_params(model.params,
                                                                        torch.bfloat16)))
    asr = SenseVoiceEngine(model=model)
    batches = []

    def recorded(items):
        batches.append(list(items))
        return asr.recognize_batch(items)

    batcher = MicroBatcher(recorded, max_batch=8, window_ms=50.0)
    httpd = serve(port=0, engines={"asr": asr, "asr_batcher": batcher})
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}/recognize"
    rng = np.random.default_rng(8)
    wavs = [cs.wav_bytes(cs.synth_speechlike(s, rng)) for s in np.linspace(0.6, 4.0, 8)]

    def post(w):
        with urllib.request.urlopen(urllib.request.Request(url, data=w), timeout=300) as r:
            return r.status, json.loads(r.read())["ids"]

    try:
        with concurrent.futures.ThreadPoolExecutor(max_workers=8) as ex:
            answers = dict(zip(wavs, ex.map(post, wavs)))
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(30)
    assert all(status == 200 for status, _ in answers.values())
    assert sum(len(b) for b in batches) == 8 and max(len(b) for b in batches) > 1
    for b in batches:
        assert [answers[w][1] for w in b] == asr.recognize_batch(b)


@pytest.mark.cuda
def test_server_every_route_at_once(dev):
    """Phase 38's mixed round over the tiny engines on the card: 8
    /recognize, 2 /recognize_batch of 3 (padded to the batch of 4 a
    batcher's batch of 4 runs at), 2 /detect and 4 /synthesize in flight
    together, twice. The first round captures programs while other requests
    are in flight; in both, each answer is the engine's direct call (bits):
    the engines' `CARD_LOCK` keeps one request's copies into a program's
    static buffers, its replay and its read-back from interleaving with
    another's."""
    from lele_tpu_torch.server import build_engines

    srv = cs.Served(build_engines(tiny=True, device=dev))
    try:
        for seed in (38, 39):
            bad, asr_sizes, det_sizes = cs.mixed_traffic(srv.url, srv.engines, srv.batches,
                                                         srv.det_batches, seed)
            assert not bad, (seed, bad)
            assert sum(asr_sizes) == cs.ENTRY_BURST and sum(det_sizes) == 2
    finally:
        srv.close()


@pytest.mark.cuda
def test_load_pytree_deduplicated_leaves_on_the_card(dev, tmp_path):
    """On the card `load_pytree` cuts the leaves from one device copy of the
    blob; two equal leaves share a record, yet writing one in place leaves
    the other as it was."""
    from lele_tpu_torch.runtime.artifact import load_pytree, save_pytree

    save_pytree(tmp_path / "t", {"a": np.ones(6, np.float32), "b": np.ones(6, np.float32),
                                 "c": np.arange(4, dtype=np.int32)})
    tree = load_pytree(tmp_path / "t", device=dev)
    assert all(t.is_cuda for t in tree.values())
    tree["a"].mul_(5.0)
    assert torch.equal(tree["b"].cpu(), torch.ones(6))
    assert torch.equal(tree["c"].cpu(), torch.arange(4, dtype=torch.int32))


SEARCH_SMALL = dict(vocab=301, d=64, heads=4, layers=2, max_len=64, ffn=256)
WHISPER_SMALL = dict(vocab=51865, d=64, heads=4, layers=2, max_len=40, ffn=128, frames=60,
                     mels=16)


def _search_on_card(dev, bs: bytes, feeds: dict, bind=None):
    """A search export compiled on the card and on the CPU: the captured
    call against the replay (chip_smoke.capture_checks), the CPU's outputs
    and the card's launches."""
    from lele_tpu_torch.compiler import compile_model
    from lele_tpu_torch.onnx import OnnxModel, bind_inputs

    model = OnnxModel.from_bytes(bs)
    if bind:
        model = bind_inputs(model, bind)
    ref = compile_model(model, device="cpu", strict=True).run_np(**feeds)
    cm = compile_model(model, device=dev, strict=True).compile()
    checks = cs.Checks()
    got, launches = cs.capture_checks(checks, "search", cm,
                                      {k: torch.from_numpy(v).to(dev) for k, v in feeds.items()})
    assert not checks.failures, checks.failures
    return cm, [g.cpu().numpy() for g in got], ref, launches


@pytest.mark.cuda
def test_search_beam_int8_runs_kernel_5_in_the_captured_loop(dev):
    """Phase 40 (a) at a small width: the int8 GPT-2 BeamSearch export bound
    by bind_inputs, one captured program: kernel 5 3 times a layer and once
    for the head in every decoder walk (the prefill and each step), the
    replay's bits and launches, the CPU's ids and scores within
    SEARCH_SCORE_REL."""
    params = cs.gpt2_search_params(cfg=SEARCH_SMALL)
    beam, _, _, binds = cs.gpt2_search_models(params, SEARCH_SMALL)
    ids, mask = cs.search_prompts(SEARCH_SMALL["vocab"])
    cm, (seq, sc), (rseq, rsc), launches = _search_on_card(
        dev, beam, {"input_ids": ids, "attention_mask": mask}, binds["beam"])
    walk = 3 * SEARCH_SMALL["layers"] + 1
    assert launches["dq_gemm"] == walk * (cs.SEARCH_MAX_LENGTH - ids.shape[1])
    assert cm.stats["pattern_hits"]["dql_matmul_dataflow"] == 2 * walk
    np.testing.assert_array_equal(seq, rseq)
    assert (np.abs(sc - rsc) <= cs.SEARCH_SCORE_REL * np.abs(rsc)).all()


@pytest.mark.cuda
def test_search_greedy_and_sampling_captured(dev):
    """GreedySearch and Sampling (top-p 0.9, a runtime seed input) captured
    on the card: the replay's bits; greedy the CPU's ids; the same seed the
    same rollout on every captured call, another seed another."""
    from lele_tpu_torch.compiler import compile_model
    from lele_tpu_torch.onnx.synth import build_gpt2_decoder_graph, build_search_model

    params = cs.gpt2_search_params(cfg=SEARCH_SMALL)
    _, _, greedy, binds = cs.gpt2_search_models(params, SEARCH_SMALL)
    ids, mask = cs.search_prompts(SEARCH_SMALL["vocab"])
    feeds = {"input_ids": ids, "attention_mask": mask}
    _, (seq,), (rseq,), _ = _search_on_card(dev, greedy, feeds, binds["greedy"])
    np.testing.assert_array_equal(seq, rseq)
    dec = build_gpt2_decoder_graph(params, SEARCH_SMALL["layers"], SEARCH_SMALL["heads"])
    eos = SEARCH_SMALL["vocab"] - 1
    bs = build_search_model("Sampling", dec, ids.shape,
                            {"max_length": np.asarray([24], np.int32), "attention_mask": None,
                             "seed": np.asarray([0], np.int32)},
                            dict(eos_token_id=eos, pad_token_id=eos, model_type=0, top_p=0.9,
                                 temperature=1.2, seed=4), runtime_scalars=("seed",))
    cm = compile_model(bs, device=dev, strict=True)
    tfeeds = {k: torch.from_numpy(v).to(dev) for k, v in feeds.items()}
    run = lambda s: cm(**tfeeds, seed=torch.tensor([s], dtype=torch.int32, device=dev))[0] \
        .cpu().numpy()  # noqa: E731
    a, b, a2 = run(7), run(8), run(7)
    assert cm.stats["captured"]
    np.testing.assert_array_equal(a, a2)
    np.testing.assert_array_equal(
        a, cm.replay(**tfeeds, seed=torch.tensor([7], dtype=torch.int32, device=dev))[0]
        .cpu().numpy())
    assert (a != b).any()


@pytest.mark.cuda
def test_search_whisper_masked_and_packed_stack_on_the_card(dev):
    """Phase 40 (c) and (d) at small widths: WhisperBeamSearch over the
    DecoderMasked step graph (the CPU's ids) and the packed BERT stack
    (within PACKED_REL of the CPU, padding rows zero), each captured
    against its replay."""
    bs, feeds = cs.whisper_search_model(cs.whisper_search_params(cfg=WHISPER_SMALL),
                                        WHISPER_SMALL)
    _, (seq, sc), (rseq, rsc), _ = _search_on_card(dev, bs, feeds)
    np.testing.assert_array_equal(seq, rseq)
    assert (np.abs(sc - rsc) <= cs.SEARCH_SCORE_REL * np.abs(rsc)).all()
    packed, _, pfeeds = cs.packed_bert_models(4, 32, layers=2, d=64, heads=4, ffn=128)
    _, (y,), (ry,), _ = _search_on_card(dev, packed, pfeeds)
    assert np.abs(y - ry).max() <= cs.PACKED_REL * np.abs(ry).max()
    valid = np.arange(32)[None, :] < pfeeds["lens"][:, None]
    assert (y[~valid] == 0).all()


def _train_inputs(cfg_kw, seed=cs.TRAIN_SEED):
    from lele_tpu_torch.models import SenseVoiceConfig
    from lele_tpu_torch.models.sensevoice import init_sensevoice

    cfg = SenseVoiceConfig(**cfg_kw)
    params = init_sensevoice(torch.Generator().manual_seed(seed), cfg)
    return cfg, params, cs.train_batch(2, 24, 6, cfg.vocab_size, seed)


@pytest.mark.cuda
@pytest.mark.parametrize("n_experts", [0, 4])
def test_train_step_on_the_card_against_the_cpu(dev, n_experts):
    """Phase 41 (a): one train step (loss, every gradient leaf, then the
    AdamW update) at dryrun_multichip's config on the card against the
    port's CPU run, TF32 off."""
    from lele_tpu_torch.params import tree_leaves, tree_map
    from lele_tpu_torch.train import make_train_step
    from lele_tpu_torch.train.trainer import value_and_grad

    cfg, params, batch = _train_inputs(dict(cs.TRAIN_SMALL, n_experts=n_experts))
    card = tree_map(lambda t: t.to(dev), params)
    ref_loss, ref_grads = value_and_grad(params, batch, cfg)
    loss, grads = value_and_grad(card, batch, cfg)
    assert abs(float(loss) - float(ref_loss)) <= cs.TRAIN_LOSS_REL * abs(float(ref_loss))
    for g, r in zip(grads, ref_grads):
        assert (g.cpu() - r).abs().max() <= cs.TRAIN_GRAD_REL * r.abs().max().clamp(min=1e-30)
    tx, step = make_train_step(cfg, lr=1e-3)
    step(params, tx.init(params), batch)
    step(card, tx.init(card), batch)
    # an element whose gradient is rounding noise (the key bias's: 0 in exact
    # arithmetic) moves by lr either way; every other element within
    # TRAIN_STEP_ATOL, those within 2·lr
    for a, b, r in zip(tree_leaves(card), tree_leaves(params), ref_grads):
        d = (a.cpu() - b).abs()
        noise = r.abs() < cs.TRAIN_NOISE_REL * r.abs().max()
        assert d[~noise].max() <= cs.TRAIN_STEP_ATOL and d.max() <= 2e-3


@pytest.mark.cuda
def test_remat_gradients_on_the_card(dev):
    """remat recomputes each block in backward: on the card the loss and
    every gradient the same bits as without it."""
    from lele_tpu_torch.models import SenseVoiceConfig
    from lele_tpu_torch.params import tree_map
    from lele_tpu_torch.train.trainer import value_and_grad

    cfg, params, batch = _train_inputs(cs.TRAIN_SMALL)
    card = tree_map(lambda t: t.to(dev), params)
    loss, grads = value_and_grad(card, batch, cfg)
    loss_r, grads_r = value_and_grad(card, batch, SenseVoiceConfig(**cs.TRAIN_SMALL, remat=True))
    assert float(loss) == float(loss_r)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads_r))


@pytest.fixture
def nccl_one(dev, tmp_path):
    """An NCCL process group of one rank on the card, destroyed after."""
    import torch.distributed as dist

    from lele_tpu_torch.parallel.mesh import init_distributed

    init_distributed(0, 1, f"file://{tmp_path / 'rendezvous'}", device="cuda")
    yield dev
    dist.destroy_process_group()


@pytest.mark.cuda
def test_pipeline_stage_on_kernel_1(nccl_one):
    """A one-stage GPipe pipeline whose stage runs kernel 1 a row over a
    stacked w8 tree (2 layers, d 256): 4 rows of T = 21 in 2 microbatches,
    the bits of one launch a row, 4 launches."""
    from lele_tpu_torch.parallel import pipeline_apply, stack_stage_params
    from lele_tpu_torch.parallel.pipeline import pipe_mesh

    dev = nccl_one
    st = cs.stack_tree("weight_int8", dev, n_layers=2, d_model=256, n_heads=4, ffn=512)
    x = torch.randn((4, 21, 256), generator=torch.Generator(device=dev).manual_seed(3),
                    device=dev)
    mask = torch.ones(21, device=dev)

    def stage(p, mb):
        return torch.stack([K.sanm_stack_w8(r, mask, p, 4, 11) for r in mb])

    K.reset_launch_counts()
    got = pipeline_apply(stage, stack_stage_params([st]), x, pipe_mesh(1), n_microbatch=2)
    torch.cuda.synchronize()
    assert K.launch_counts()["sanm_stack_w8"] == 4
    assert torch.equal(got, stage(st, x))


@pytest.mark.cuda
def test_compile_model_over_one_rank_nccl_mesh(nccl_one):
    """The MHA encoder over a one-rank mesh with Megatron rules and
    seq_axis: captured, the mesh-free compile's bits; the small GenAI
    decoder with `_q` / `_s` column rules: kernel 7 a MatMulNBits node, the
    mesh-free compile's bits."""
    from lele_tpu_torch.compiler import compile_model
    from lele_tpu_torch.parallel import make_mesh

    dev = nccl_one
    mesh = make_mesh(1, seq=1)
    bs, x, _, _ = cs.dryrun_onnx(2, 8)
    cm = compile_model(bs, dim_values={"B": 2, "T": 8}, mesh=mesh, batch_axis=0, seq_axis=1,
                       param_rules=cs.mha_rules)
    ref = compile_model(bs, dim_values={"B": 2, "T": 8}, device=dev)
    assert cm.device.type == "cuda"
    assert np.array_equal(cm.run_np(x)[0], ref.run_np(x)[0]) and cm.stats["captured"]

    g, feeds = cs.dryrun_genai(2)
    gm = compile_model(g, mesh=mesh, param_rules=cs.nbits_rules)
    gf = compile_model(g, device=dev)
    gm.run_np(**feeds)
    K.reset_launch_counts()
    got = gm.run_np(**feeds)
    assert K.launch_counts()["w4_gemm"] == gm.stats["pattern_hits"]["matmul_nbits_w4"] // 2
    assert all(np.array_equal(a, b) for a, b in zip(got, gf.run_np(**feeds)))


# -- slice 27: registered ops, AOT, precision, the native decoder ---------------


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(K.KERNEL_WRAPPERS))
def test_registered_op_opcheck_on_the_card(dev, name):
    op = getattr(torch.ops.lele_tpu_torch, name).default
    res = torch.library.opcheck(op, K.op_samples(dev)[name])
    assert set(res.values()) == {"SUCCESS"}, res


def _small_sanm(dev):
    from lele_tpu_torch.compiler import compile_model
    from lele_tpu_torch.onnx.synth import build_sanm_int8_model

    graph = build_sanm_int8_model(L=2, d=128, h=2, ffn=256, vocab=300, int8_head=True, seed=5)
    cm = compile_model(graph, dim_values={"T": 64}, device=dev)
    rng = np.random.default_rng(5)
    feeds = {"speech": torch.from_numpy(rng.standard_normal((1, 64, 560)).astype(np.float32)
                                        ).to(dev),
             "speech_lengths": np.array([60]), "language": np.array([0], np.int32),
             "textnorm": np.array([1], np.int32)}
    return graph, cm, feeds


@pytest.mark.cuda
def test_exported_program_on_the_card_gives_the_tapes_bits(dev, tmp_path):
    from lele_tpu_torch.compiler.aot import export_model, load_exported, program_ops

    _, cm, feeds = _small_sanm(dev)
    want = cm.replay(**feeds)
    call = load_exported(export_model(cm, tmp_path / "sv"))
    assert program_ops(call.program) == ["dq_gemm", "sanm_stack_dql"]
    K.reset_launch_counts()
    got = call(cm.params, (), [cm._prep(n, feeds[n]) for n in cm.input_order])
    torch.cuda.synchronize()
    assert {k: v for k, v in K.launch_counts().items() if v} == {"dq_gemm": 1,
                                                                 "sanm_stack_dql": 1}
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
def test_use_aot_captures_the_loaded_program(dev, tmp_path):
    from lele_tpu_torch.runtime.engine import CompiledModel

    _, cm, feeds = _small_sanm(dev)
    want = [o.clone() for o in cm(**feeds)]
    cm.save_aot(tmp_path / "sv")
    manifest = json.loads((tmp_path / "sv.xc" / "manifest.json").read_text())
    assert sorted(manifest["libraries"]) == ["dq_gemm", "sanm_dql"]
    assert manifest["device"].startswith("sm_")
    for m in (CompiledModel.from_aot(tmp_path / "sv", dict(cm.params)),
              cm.use_aot(tmp_path / "sv")):
        m.compile()
        K.reset_launch_counts()
        got = m(**feeds)
        torch.cuda.synchronize()
        assert m.stats["captured"]
        assert {k: v for k, v in K.launch_counts().items() if v} == {"dq_gemm": 1,
                                                                     "sanm_stack_dql": 1}
        assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
def test_precision_takes_tf32_in_the_walk_and_restores_the_flags(dev):
    from lele_tpu_torch.compiler import compile_model
    from lele_tpu_torch.onnx import builder as ob

    rng = np.random.default_rng(9)
    w = rng.standard_normal((1024, 1024)).astype(np.float32)
    data = ob.build_model_bytes(
        [ob.node("MatMul", ["x", "w"], ["y"])], inputs=[ob.value_info("x", 1, [512, 1024])],
        outputs=[ob.value_info("y", 1, [512, 1024])], initializers=[ob.tensor_from_array(w, "w")])
    x = torch.from_numpy(rng.standard_normal((512, 1024)).astype(np.float32)).to(dev)
    ref = (x.double() @ torch.from_numpy(w).to(dev).double())
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    errs = {}
    for prec in ("highest", "high", "default"):
        cm = compile_model(data, device=dev, precision=prec).compile()
        y = cm(x=x)[0]
        assert cm.stats["captured"]
        assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == flags
        errs[prec] = ((y.double() - ref).abs().max() / ref.abs().max()).item()
    assert errs["highest"] < 1e-5 < errs["high"] < 1e-2
    assert errs["default"] == errs["high"]  # no bf16 pass for f32 operands: TF32


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["pt2", "xc"])
def test_loaded_conv_program_keeps_its_precision_on_the_card(dev, tmp_path, route):
    """A conv graph compiled at "highest", exported and loaded, gives the
    tape's bits while torch's flags allow TF32 (cuDNN's default), because
    the call runs at the precision saved with the program; the same program
    run bare at those flags differs (cuDNN takes TF32)."""
    from lele_tpu_torch.compiler import compile_model
    from lele_tpu_torch.compiler.aot import export_model, load_exported
    from lele_tpu_torch.onnx import builder as ob
    from lele_tpu_torch.runtime.artifact import load_aot_bundle

    rng = np.random.default_rng(12)
    w = (rng.standard_normal((128, 64, 3, 3)) * 0.05).astype(np.float32)
    m = (rng.standard_normal((56, 64)) * 0.1).astype(np.float32)
    data = ob.build_model_bytes(
        [ob.node("Conv", ["x", "w"], ["c"], pads=[1, 1, 1, 1]),
         ob.node("MatMul", ["c", "m"], ["y"])],
        inputs=[ob.value_info("x", 1, [4, 64, 56, 56])],
        outputs=[ob.value_info("y", 1, [4, 128, 56, 64])],
        initializers=[ob.tensor_from_array(w, "w"), ob.tensor_from_array(m, "m")])
    x = torch.from_numpy(rng.standard_normal((4, 64, 56, 56)).astype(np.float32)).to(dev)
    cm = compile_model(data, device=dev, precision="highest")
    want = cm.replay(x=x)[0]
    if route == "pt2":
        call = load_exported(export_model(cm, tmp_path / "c"))
        run = lambda: call(cm.params, (), (x,))[0]  # noqa: E731
        program = call.program
    else:
        cm.save_aot(tmp_path / "c")
        fn, _ = load_aot_bundle(tmp_path / "c", params=False)
        run = lambda: fn(dict(cm.params), (), (x,))[0]  # noqa: E731
        program = fn.program
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        got = run()
        bare = program.module()(dict(sorted(cm.params.items())), (), (x,))[0]
        after = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    assert after == (True, True)
    assert torch.equal(got, want)
    assert not torch.equal(bare, want)


@pytest.mark.cuda
def test_native_bundle_on_the_card(dev, tmp_path):
    from lele_tpu_torch.models import (SenseVoiceConfig, SenseVoiceModel, cast_big_params,
                                       prepare_w8_params, stack_layer_params)
    from lele_tpu_torch.models.sensevoice import sensevoice_encode
    from lele_tpu_torch.runtime.artifact import (canonical, export_program, load_aot_bundle,
                                                 save_aot_bundle)

    cfg = SenseVoiceConfig(n_layers=2, d_model=256, n_heads=2, ffn_dim=512, vocab_size=300,
                           weight_int8=True)
    m = SenseVoiceModel(cfg, device=dev)
    m.init(3)
    m.params = stack_layer_params(prepare_w8_params(cast_big_params(m.params, torch.bfloat16)))
    pcm = (np.random.default_rng(3).standard_normal(32000) * 0.1).astype(np.float32)
    feats = m.fbank(pcm).contiguous()

    def enc(p, f):
        return sensevoice_encode(p, f[None], torch.ones((1, f.shape[0]), device=f.device), cfg)

    prog = export_program(enc, m.params, feats)
    with torch.inference_mode():
        ref = prog.module()(canonical(m.params), feats)
    save_aot_bundle(tmp_path / "nat", prog, m.params)
    fn, params = load_aot_bundle(tmp_path / "nat")
    K.reset_launch_counts()
    got = fn(params, feats)
    torch.cuda.synchronize()
    assert {k: v for k, v in K.launch_counts().items() if v} == {"sanm_stack_w8": 1,
                                                                 "w8_gemm": 1}
    assert torch.equal(got, ref) and torch.equal(ref, m.forward_fn()(m.params, pcm))


@pytest.mark.cuda
def test_native_decoder_on_the_card_machine(dev, tmp_path):
    from lele_tpu_torch.runtime.dataloader import decode_wav_files
    from lele_tpu_torch.utils.wav import encode_wav, read_wav

    rng = np.random.default_rng(11)
    paths = []
    for i in range(6):
        p = tmp_path / f"w{i}.wav"
        p.write_bytes(encode_wav((rng.standard_normal(8000 + 77 * i) * 0.2).astype(np.float32),
                                 16000))
        paths.append(p)
    for p, (x, sr) in zip(paths, decode_wav_files(paths)):
        y, ysr = read_wav(p, try_native=False)
        assert sr == ysr and np.array_equal(x, y)
