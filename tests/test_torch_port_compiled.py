"""The port's compiled-ONNX slice against the JAX package's, on the CPU.

Kernel 5 (`fused_dq_matmul`) and kernel 4 (`sanm_stack_dql`) take their
plain versions here; the JAX side runs its jnp references and its Pallas
kernels in interpret mode, and the compiled graph with LELE_SANM_FUSE=0 and
=interpret, as its own tests do.

A note on tolerances. In an int8 graph with ONNX DynamicQuantizeLinear every
linear quantizes its input against the input's global min/max. Two f32
implementations that differ in the last bit of one activation (another
summation order in a product, a mean or a softmax) put that activation on
neighbouring int8 codes whenever it lies within that bit of a rounding
boundary, and the next layers carry the step on. Where the two sides share
every operation's arithmetic the results are equal (the port's fused and
per-op paths, the exact int32 GEMMs). Where they do not (the port's torch
against XLA), a comparison either sees no flipped code and agrees to ~1e-6,
or sees one and then differs at the level of the graph's own quantization
noise. scripts/torch_port_dql_noise.py measures that level; each test below
states which case it is in.
"""

import tempfile
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lele_tpu.kernels.quant_matmul import _fused_dq_matmul_jnp, fused_dq_matmul_pallas
from lele_tpu.kernels.quant_matmul import dynamic_quantize_u8 as j_dynamic_quantize_u8
from lele_tpu.kernels.sanm_block import sanm_stack_dql_pallas
from lele_tpu_torch import kernels as K
from lele_tpu_torch.compiler import compile_model
from lele_tpu_torch.compiler.patterns import DEFAULT_PATTERNS
from lele_tpu_torch.models.checkpoints import SenseVoiceOnnx

FIXTURES = Path(__file__).resolve().parent.parent / "fixtures"
# tests/test_sanm_fuse.py:54-57, the JAX fused-vs-per-op gate
STACK_ATOL = 2e-3
# the fixture oracle's gate (tests/test_fixture_e2e.py:54-57) for MAE. Its
# argmax gate (> 0.97) sits inside the graph's quantization noise: the JAX
# package itself reads 0.9485-0.9897 against the oracle over inputs 1e-7
# apart (scripts/torch_port_dql_noise.py), so the port is held at 0.94
FIXTURE_MAE = 0.02
FIXTURE_AGREE = 0.94


def _t(a):
    return torch.from_numpy(np.array(a))


# -- kernel 5: fused_dq_matmul ----------------------------------------------


def _dq_inputs(m, k, n, seed, all_positive=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32) * 2.0
    if all_positive:
        x = np.abs(x)
    wq = rng.integers(-127, 128, (k, n)).astype(np.int8)
    colsum = wq.astype(np.int32).sum(axis=0, dtype=np.int32)
    return x, wq, colsum, np.float32(rng.uniform(1e-3, 5e-3))


@pytest.mark.parametrize("shape", [(1, 1), (37, 64), (64, 512), (5, 130)], ids=str)
@pytest.mark.parametrize("kind", ["mixed", "positive", "zeros"])
def test_dynamic_quantize_u8_matches_jax_exactly(shape, kind):
    rng = np.random.default_rng(3)
    x = rng.standard_normal(shape).astype(np.float32) * 3
    x = {"mixed": x, "positive": np.abs(x) + 0.5, "zeros": np.zeros(shape, np.float32)}[kind]
    got = K.dynamic_quantize_u8(_t(x))
    want = j_dynamic_quantize_u8(jnp.asarray(x))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("m,k,n", [(37, 64, 96), (5, 130, 33), (50, 128, 255), (96, 512, 64)])
@pytest.mark.parametrize("all_positive", [False, True], ids=["mixed", "positive"])
def test_fused_dq_matmul_plain_is_the_jnp_path_bit_for_bit(m, k, n, all_positive):
    """Division in the quantization, an exact int32 sum, one f32 epilogue:
    the same bits as `_fused_dq_matmul_jnp` (quant_matmul.py:129)."""
    x, wq, colsum, w_scale = _dq_inputs(m, k, n, m + k + n, all_positive)
    _, a_scale, a_zp = K.dynamic_quantize_u8(_t(x))
    got = K.fused_dq_matmul(_t(x), _t(wq), _t(colsum), a_scale, a_zp, float(w_scale))
    want = _fused_dq_matmul_jnp(jnp.asarray(x), jnp.asarray(wq), jnp.asarray(colsum),
                                jnp.asarray(a_scale.numpy()), jnp.asarray(a_zp.numpy()),
                                jnp.float32(w_scale))
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("m,k,n", [(37, 64, 96), (50, 128, 255)])
def test_fused_dq_matmul_plain_vs_pallas_within_one_code(m, k, n):
    """The Pallas kernel quantizes by x * (1/a_scale) (quant_matmul.py:174),
    the port by x / a_scale as ONNX specifies. The two land one code apart
    where x/a_scale sits at a rounding boundary, so the outputs may differ by
    exactly the weight rows of the moved codes, and by nothing else."""
    x, wq, colsum, w_scale = _dq_inputs(m, k, n, 7 * m)
    _, a_scale, a_zp = K.dynamic_quantize_u8(_t(x))
    s, zp = np.float32(a_scale.item()), np.float32(a_zp.item())
    got = K.fused_dq_matmul(_t(x), _t(wq), _t(colsum), a_scale, a_zp, float(w_scale)).numpy()
    want = np.asarray(fused_dq_matmul_pallas(
        jnp.asarray(x), jnp.asarray(wq), jnp.asarray(colsum), jnp.float32(s), jnp.float32(zp),
        jnp.float32(w_scale), interpret=True))
    q_div = np.clip(np.round(x / s) + zp, 0, 255)
    q_rec = np.clip(np.round(x * (np.float32(1) / s)) + zp, 0, 255)
    moved = q_rec - q_div
    assert np.abs(moved).max() <= 1
    # the moved codes' contribution, plus the f32 rounding of the two outputs
    bound = (np.abs(moved) @ np.abs(wq.astype(np.float64))) * float(s * w_scale)
    bound += 2 * np.finfo(np.float32).eps * np.abs(want)
    assert np.all(np.abs(got - want) <= bound)


# -- kernel 4: sanm_stack_dql -----------------------------------------------


def _stack_inputs(L, D, F, k, T, n_valid, seed):
    rng = np.random.default_rng(seed)
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


def _stack_pair(seed, T=100, n_valid=93, L=2, D=128, H=4, F=256, k=11, pad_left=5):
    x, bias, vmask, st = _stack_inputs(L, D, F, k, T, n_valid, seed)
    want = np.asarray(sanm_stack_dql_pallas(
        jnp.asarray(x), jnp.asarray(bias), jnp.asarray(vmask),
        {kk: ({a: jnp.asarray(b) for a, b in v.items()} if isinstance(v, dict)
              else jnp.asarray(v)) for kk, v in st.items()},
        H, k, pad_left, interpret=True))
    tst = {kk: ({a: _t(b) for a, b in v.items()} if isinstance(v, dict) else _t(v))
           for kk, v in st.items()}
    got = K.sanm_stack_dql(_t(x), _t(bias), _t(vmask), tst, H, k, pad_left).numpy()
    return got, want


@pytest.mark.parametrize("seed,T,n_valid", [(0, 100, 93), (1, 100, 93), (3, 100, 93),
                                            (6, 100, 93), (0, 45, 45)])
def test_sanm_stack_dql_plain_matches_pallas(seed, T, n_valid):
    """L=2, D=128, H=4, F=256, T not a multiple of 32 (the Pallas kernel pads
    to 32 and masks the pad out of every min/max; the port pads nothing).
    Over seeds 0-7 at T=100, the inputs of seeds 0-3 and 6 put no activation
    on the other side of a rounding boundary, and the two agree to ~1e-6;
    the cases here are those. Seeds 4, 5 and 7 move one code somewhere and
    the cascade reaches at most 0.5% of max|ref|
    (test_sanm_stack_dql_cascade_stays_at_the_quantization_step)."""
    got, want = _stack_pair(seed, T, n_valid)
    assert got.shape == want.shape == (T, 128)
    np.testing.assert_allclose(got, want, atol=STACK_ATOL, rtol=0)


def test_sanm_stack_dql_cascade_stays_at_the_quantization_step():
    """Seed 5 moves one activation code between the two sides: the cascade
    stays at the graph's quantization step (max|d| well under 1% of
    max|ref|), far below what a wrong mask, pad or scale gives."""
    got, want = _stack_pair(5)
    d = np.abs(got - want).max() / np.abs(want).max()
    assert 1e-4 < d < 1e-2


def test_sanm_stack_dql_plain_refuses_a_wrong_fsmn_width():
    x, bias, vmask, st = _stack_inputs(1, 64, 96, 11, 20, 20, 0)
    tst = {kk: ({a: _t(b) for a, b in v.items()} if isinstance(v, dict) else _t(v))
           for kk, v in st.items()}
    with pytest.raises(ValueError, match="fsmn"):
        K.sanm_stack_dql(_t(x), _t(bias), _t(vmask), tst, 2, 7, 3)


def _edge_pair(case, seed=0, T=45, n_valid=40, D=128, H=4, F=256, k=11):
    """One layer at a DQL or FSMN edge, through the JAX kernel (interpret)
    and the port's plain version."""
    x, bias, vmask, st = _stack_inputs(1, D, F, k, T, n_valid, seed)
    pad_left = {"pad_first": 0, "pad_last": k - 1}.get(case, (k - 1) // 2)
    if case == "zero_norm":  # LN1's output all zero: DQL's scale 0, the safe scale 1
        st["norm1"]["g"][:] = 0.0
        st["norm1"]["b"][:] = 0.0
    elif case == "const_x":  # every row constant: LN1 gives its bias alone
        x[:] = 0.75
    elif case == "zero_x":
        x[:] = 0.0
    want = np.asarray(sanm_stack_dql_pallas(
        jnp.asarray(x), jnp.asarray(bias), jnp.asarray(vmask),
        {kk: ({a: jnp.asarray(b) for a, b in v.items()} if isinstance(v, dict)
              else jnp.asarray(v)) for kk, v in st.items()},
        H, k, pad_left, interpret=True))
    tst = {kk: ({a: _t(b) for a, b in v.items()} if isinstance(v, dict) else _t(v))
           for kk, v in st.items()}
    got = K.sanm_stack_dql(_t(x), _t(bias), _t(vmask), tst, H, k, pad_left).numpy()
    return got, want


@pytest.mark.parametrize("case", ["zero_norm", "const_x", "zero_x", "pad_first", "pad_last"])
def test_sanm_stack_dql_plain_matches_pallas_at_edges(case):
    """The edges the one-launch kernel handles on its own: a linear whose
    input is all zero (scale 0), constant rows, and the FSMN's left pad at 0
    and k - 1 (its halo then all on one side)."""
    got, want = _edge_pair(case)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=STACK_ATOL, rtol=0)


def test_dql_kernel_entry_checks_the_range_first():
    """A head dim the kernel does not compile, or more FSMN taps than it
    stages, is refused before the device is looked at; the phase timer is
    the kernel's own and refuses a CPU tensor."""
    xs, bias, vmask, st = _stack_inputs(1, 96, 96, 11, 20, 20, 0)
    tst = {kk: ({a: _t(b) for a, b in v.items()} if isinstance(v, dict) else _t(v))
           for kk, v in st.items()}
    with pytest.raises(ValueError, match="outside the kernel"):
        K.sanm_block.sanm_stack_dql_kernel(_t(xs), _t(bias), _t(vmask), tst, 1, 11, 5,
                                           1e-5, 1e-5, None)
    xs, bias, vmask, st = _stack_inputs(1, 64, 96, 17, 20, 20, 0)
    tst = {kk: ({a: _t(b) for a, b in v.items()} if isinstance(v, dict) else _t(v))
           for kk, v in st.items()}
    with pytest.raises(ValueError, match="outside the kernel"):
        K.sanm_block.sanm_stack_dql_kernel(_t(xs), _t(bias), _t(vmask), tst, 2, 17, 8,
                                           1e-5, 1e-5, None)
    with pytest.raises(ValueError, match="timer"):
        K.sanm_block.dql_phase_us(_t(xs), _t(bias), _t(vmask), tst, 2, 17, 8)


def test_dql_kernel_entries_refuse_a_cpu_tensor():
    x, wq, colsum, w_scale = _dq_inputs(4, 32, 8, 0)
    _, s, zp = K.dynamic_quantize_u8(_t(x))
    with pytest.raises(ValueError, match="CUDA"):
        K.quant_matmul.fused_dq_matmul_kernel(_t(x), _t(wq), _t(colsum), s, zp, 0.01)
    xs, bias, vmask, st = _stack_inputs(1, 64, 96, 11, 20, 20, 0)
    with pytest.raises(ValueError, match="CUDA"):
        K.sanm_block.sanm_stack_dql_kernel(_t(xs), _t(bias), _t(vmask), st, 2, 11, 5,
                                           1e-5, 1e-5, None)


# -- the slice as a whole -----------------------------------------------------


def _fixture_inputs():
    feats = np.load(FIXTURES / "sensevoice_input.npy")
    t = feats.shape[1]
    t_pad = -(-t // 32) * 32
    padded = np.zeros((1, t_pad, 560), np.float32)
    padded[:, :t] = feats
    return dict(speech=padded, speech_lengths=np.asarray([t], np.int64),
                language=np.asarray([3], np.int32), textnorm=np.asarray([0], np.int32))


@pytest.fixture(scope="module")
def fixture_runs():
    """The fixture compiled by both packages, fused and per-op, on the same
    padded input → {(package, mode): (logits, pattern_hits)}."""
    from lele_tpu.compiler import compile_model as j_compile
    from lele_tpu.onnx.loader import OnnxModel as JOnnxModel

    kw = _fixture_inputs()
    shapes = {"speech": kw["speech"].shape}
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for mode in ("0", "interpret"):
            mp.setenv("LELE_SANM_FUSE", mode)
            cm = j_compile(JOnnxModel.load(FIXTURES / "sensevoice.onnx"), input_shapes=shapes)
            out["jax", mode] = (np.asarray(cm.run_np(**kw)[0]), dict(cm.stats["pattern_hits"]))
    for mode, patterns in (("per_op", []), ("fused", None)):
        cm = compile_model(FIXTURES / "sensevoice.onnx", input_shapes=shapes,
                           patterns=patterns, device="cpu")
        out["port", mode] = (cm.run_np(**kw)[0], dict(cm.stats["pattern_hits"]))
    return out


def test_fused_and_per_op_paths_are_bit_identical(fixture_runs):
    """The port's fused stack repeats the per-op emitters' arithmetic, so on
    one device the two paths give the same bits (JAX's own gate is atol
    2e-3 between its two paths)."""
    fused, per_op = fixture_runs["port", "fused"][0], fixture_runs["port", "per_op"][0]
    np.testing.assert_array_equal(fused, per_op)


def test_pattern_hits_match_jax(fixture_runs):
    assert fixture_runs["port", "fused"][1] == fixture_runs["jax", "interpret"][1]
    hits = fixture_runs["port", "fused"][1]
    assert hits["sanm_fused_layers"] == 4 and hits["sanm_stack_dataflow"] == 1
    # the per-op path with its DQL pattern on, as JAX's LELE_SANM_FUSE=0
    cm = compile_model(FIXTURES / "sensevoice.onnx", input_shapes={"speech": (1, 96, 560)},
                       patterns=[p for p in DEFAULT_PATTERNS
                                 if p.__name__ == "dql_matmul_dataflow"], device="cpu")
    assert cm.stats["pattern_hits"] == fixture_runs["jax", "0"][1]
    assert cm.stats["pattern_hits"]["dql_matmul_dataflow"] >= 1
    assert fixture_runs["port", "per_op"][1] == {}


@pytest.mark.parametrize("port_mode", ["fused", "per_op"])
@pytest.mark.parametrize("jax_mode", ["interpret", "0"])
def test_logits_match_jax_at_the_noise_level(fixture_runs, port_mode, jax_mode):
    """torch's f32 products and means differ from XLA's in the last bit, and
    on this input that moves codes in layer 0 (the first DQL sees one moved
    code of 12,800), so the four layers end at the quantization noise level
    (MAE ~0.015, a few frames' argmax) and not at atol 2e-3."""
    got, want = fixture_runs["port", port_mode][0], fixture_runs["jax", jax_mode][0]
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.abs(got - want).mean() <= FIXTURE_MAE * want.std()
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= FIXTURE_AGREE


@pytest.mark.parametrize("port_mode", ["fused", "per_op"])
def test_logits_against_the_fixture_oracle(fixture_runs, port_mode):
    want = np.load(FIXTURES / "sensevoice_logits.npy")
    got = fixture_runs["port", port_mode][0][:, : want.shape[1]]
    assert np.abs(got - want).mean() <= FIXTURE_MAE
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= FIXTURE_AGREE


def _speechlike(seconds, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 16000)) / 16000.0
    env = 10.0 ** (-2.0 * (0.5 + 0.5 * np.sin(2 * np.pi * 3.0 * t)))
    sig = np.sin(2 * np.pi * (150 + 1500 * t) * t) + 0.5 * rng.standard_normal(t.size)
    return (0.3 * env * sig).astype(np.float32)


def test_transcribe_ids_match_jax(monkeypatch):
    """SenseVoiceOnnx.transcribe (front-end, bucketing, the fused graph, the
    argmax) on synthetic waveforms: the same ids as the JAX package's."""
    from lele_tpu.models.checkpoints import SenseVoiceOnnx as JSenseVoiceOnnx

    monkeypatch.setenv("LELE_SANM_FUSE", "interpret")
    jsv = JSenseVoiceOnnx(FIXTURES / "sensevoice.onnx")
    sv = SenseVoiceOnnx((FIXTURES / "sensevoice.onnx").read_bytes(), device="cpu")
    for seconds, seed in ((1.3, 0), (2.5, 1), (3.7, 2)):
        pcm = _speechlike(seconds, seed)
        ids = sv.transcribe(pcm)
        assert ids and ids == jsv.transcribe(pcm)
    # 2.5 s and 3.7 s share one pcm bucket: one compiled trace for both
    assert sv.compile_count() == jsv.compile_count() == 2


def test_transcribe_agrees_with_unbucketed_logits():
    sv = SenseVoiceOnnx(FIXTURES / "sensevoice.onnx", device="cpu")
    pcm = _speechlike(1.3, 0)
    from lele_tpu_torch.models.sensevoice import _collapse_ids

    logits = sv.logits(pcm)[0, 4:]  # the graph's 4 prefix frames first
    assert sv.transcribe(pcm) == _collapse_ids(logits.argmax(-1).numpy())


def test_a_warm_request_matches_and_folds_nothing():
    """Trace once, replay after: compile walks the graph and runs the
    patterns once; a request replays the recorded steps only. Replaying at
    new inputs gives the bits a fresh compile at those inputs gives."""
    calls = {"n": 0}

    def counting(tracer, state, nodes, i, env, scope):
        calls["n"] += 1
        return None

    counting.__name__ = "counting"
    kw = _fixture_inputs()
    shapes = {"speech": kw["speech"].shape}
    cm = compile_model(FIXTURES / "sensevoice.onnx", input_shapes=shapes,
                       patterns=[counting, *DEFAULT_PATTERNS], device="cpu")
    walked = calls["n"]  # once per node the fused stack did not consume
    assert walked > 0
    rng = np.random.default_rng(4)
    kw2 = dict(kw, speech=(kw["speech"] * rng.uniform(0.5, 1.5)).astype(np.float32),
               speech_lengths=np.asarray([80], np.int64))
    out = [cm.run_np(**kw2)[0] for _ in range(2)]
    assert calls["n"] == walked
    fresh = compile_model(FIXTURES / "sensevoice.onnx", input_shapes=shapes,
                          device="cpu").run_np(**kw2)[0]
    np.testing.assert_array_equal(out[0], fresh)
    np.testing.assert_array_equal(out[1], fresh)
    with pytest.raises(ValueError, match="compiled for"):
        cm.run_np(**dict(kw, speech=np.zeros((1, 64, 560), np.float32)))


def test_compiled_int8_head_runs_through_dq_gemm():
    """With an int8 CTC head (the full-width layout), the head's DQL chain is
    the one the stack match leaves to dql_matmul_dataflow, whose fused
    epilogue launches `fused_dq_matmul` (its plain version here)."""
    from lele_tpu_torch.onnx.synth import build_sanm_int8_model

    graph = build_sanm_int8_model(L=2, d=128, h=4, ffn=256, vocab=300, int8_head=True)
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "sv.onnx"
        path.write_bytes(graph)
        kw = _fixture_inputs()
        kw["speech"] = kw["speech"][:, :60]
        kw["speech_lengths"] = np.asarray([55], np.int64)
        fused = compile_model(path, input_shapes={"speech": (1, 60, 560)}, device="cpu")
        per_op = compile_model(path, input_shapes={"speech": (1, 60, 560)}, patterns=[],
                               device="cpu")
    hits = fused.stats["pattern_hits"]
    assert hits["sanm_fused_layers"] == 2
    assert hits["dql_matmul_dataflow"] == 1 and hits["dql_fused_epilogue"] == 1
    got, want = fused.run_np(**kw)[0], per_op.run_np(**kw)[0]
    assert got.shape == (1, 64, 300)
    np.testing.assert_array_equal(got, want)


def test_repeated_mask_chains_are_recorded_once():
    """Each SAN-M layer of the export rebuilds the same attention bias and
    value mask from speech_lengths (Sub, Mul, three Unsqueeze). The trace
    keeps one copy of such a chain, as XLA's CSE does for the JAX package;
    the fixture has 4 layers, so 3 chains of 5 steps are reused."""
    for patterns in ([], None):
        cm = compile_model(FIXTURES / "sensevoice.onnx", input_shapes={"speech": (1, 96, 560)},
                           patterns=patterns, device="cpu")
        assert cm.stats["n_reused"] == 3 * 5
