"""The port's compiled-program half (runtime/graphs.py and what it needs),
held against the JAX package on the CPU, where nothing is captured and
every program runs its function eagerly:

(a) MatMulInteger with a static weight prepared once while tracing (the
    i8 shift and the column sums hoisted as params) gives the JAX emitter's
    int32 bit for bit, and its tape holds one step for the node;
(b) fbank_features and lfr_stack with n_valid a tensor (as a captured graph
    takes it) equal JAX's with an int n_valid, and the port's own int path,
    at several lengths of one bucket: exactly for the stacking, at the
    front-end's FEAT_ATOL (f32 FFT and mel sums in another order) for the
    features, and bit for bit between the port's two paths;
(c) SileroOnnx.speech_probs in block form equals JAX's whole-utterance scan
    at the whole-graph tolerance 1e-4 (tests/test_torch_port_silero_onnx.py)
    and the port's step-by-step host loop bit for bit, at 16 and 8 kHz, at
    1, BLOCK, BLOCK + 1 and 2 BLOCK - 1 chunks of a synthetic waveform;
(d) CompiledModel(donate=...) gives the outputs it gives without;
(e) a tape with a dynamic If reports that it cannot be captured, and the
    Silero (rate bound) and SenseVoice fixture tapes report that they can;
(f) `collector_paused`, which every capture runs inside, turns Python's
    cyclic collector off for its block and back to what it was after it,
    also when the block raises.
"""

import zlib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lele_tpu.compiler import compile_model as j_compile
from lele_tpu.features import FbankConfig as JFbankConfig
from lele_tpu.features import FbankFrontend as JFbankFrontend
from lele_tpu.features import fbank_features as jfbank_features
from lele_tpu.features import lfr_stack as jlfr_stack
from lele_tpu.models.checkpoints import SileroOnnx as JSileroOnnx
from lele_tpu.onnx import builder as jb
from lele_tpu_torch.compiler import compile_model
from lele_tpu_torch.features import FbankFrontend, fbank_features, lfr_stack
from lele_tpu_torch.models import SileroOnnx
from lele_tpu_torch.onnx import builder as ob
from lele_tpu_torch.ops import quant_ops
from lele_tpu_torch.runtime import graphs
from lele_tpu_torch.runtime.bucketing import pad_pcm

FIXTURES = Path(__file__).resolve().parent.parent / "fixtures"
SILERO = FIXTURES / "silero.onnx"
FEAT_ATOL = 1e-3  # tests/test_torch_port_features.py
GRAPH_TOL = 1e-4  # tests/test_torch_port_silero_onnx.py


# -- (a) MatMulInteger on a prepared static weight ------------------------------------


def _mmi_graph(builder, w, wz, m, k):
    """a [m, k] u8 with a dynamic zero point, times a static weight w with
    zero point wz (None: absent)."""
    ins = ["a", "w", "az"] + (["wz"] if wz is not None else [])
    inits = [builder.tensor_from_array(w, "w")]
    if wz is not None:
        inits.append(builder.tensor_from_array(wz, "wz"))
    return builder.build_model_bytes(
        [builder.node("MatMulInteger", ins, ["y"])],
        [builder.value_info("a", 2, [m, k]), builder.value_info("az", 2, [])],
        [builder.value_info("y", 6, [m, w.shape[1]])], inits)


WEIGHTS = {  # (weight dtype, zero point kind)
    "u8_col_zp": (np.uint8, "col"),
    "u8_scalar_zp": (np.uint8, "scalar"),
    "u8_no_zp": (np.uint8, None),
    "i8_col_zp": (np.int8, "col"),
}


@pytest.mark.parametrize("case", list(WEIGHTS))
def test_matmul_integer_prepared_weight_equals_jax(case):
    wdt, zkind = WEIGHTS[case]
    rng = np.random.default_rng(zlib.crc32(case.encode()))
    m, k, n = 9, 70, 13
    info = np.iinfo(wdt)
    w = rng.integers(info.min, info.max + 1, (k, n)).astype(wdt)
    wz = {None: None, "scalar": np.asarray(rng.integers(info.min, info.max + 1), wdt),
          "col": rng.integers(info.min, info.max + 1, (n,)).astype(wdt)}[zkind]
    data = _mmi_graph(ob, w, wz, m, k)
    assert data == _mmi_graph(jb, w, wz, m, k)
    cm = compile_model(data, device="cpu", strict=True)
    steps = cm._tape.steps
    # one step for the node, on the prepared weight: no shift of w and no
    # column sum is left to a replay
    assert [st.fn for st in steps] == [quant_ops.matmul_integer_prepared]
    assert sorted(name.rsplit("#", 1)[-1] for name in cm.params if "#" in name) == [
        "colsum", "i8", "zp_i8"]
    assert cm.params["w#i8"].dtype == torch.int8 and cm.params["w#colsum"].dtype == torch.int32
    jcm = j_compile(data)
    for seed in (1, 2):
        r = np.random.default_rng(seed)
        a = r.integers(0, 256, (m, k)).astype(np.uint8)
        az = np.asarray(r.integers(0, 256), np.uint8)
        got = cm.run_np(a=a, az=az)[0]
        want = np.asarray(jcm.run_np(a=a, az=az)[0])
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    # the float64 override, which keeps the per-call algebra, agrees too
    ref = compile_model(data, device="cpu", strict=True,
                        overrides={"MatMulInteger": quant_ops.matmul_integer_plain})
    np.testing.assert_array_equal(ref.run_np(a=a, az=az)[0], got)


# -- (b) n_valid as a tensor ------------------------------------------------------------


def _speechlike(n, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000.0
    env = 10.0 ** (-2.0 * (0.5 + 0.5 * np.sin(2 * np.pi * 3.0 * t)))
    sig = np.sin(2 * np.pi * (150 + 2000 * t) * t) + 0.5 * rng.standard_normal(n)
    return (0.3 * env * sig).astype(np.float32)


# three lengths that pad to one bucket (2 s: 32,000 samples)
BUCKET_LENGTHS = (17000, 25000, 31999)


def test_n_valid_lengths_share_one_bucket():
    assert len({len(pad_pcm(np.zeros(n, np.float32))[0]) for n in BUCKET_LENGTHS}) == 1


@pytest.mark.parametrize("n", BUCKET_LENGTHS)
def test_fbank_features_tensor_n_valid_equals_jax_and_int(n):
    padded, n_valid = pad_pcm(_speechlike(n, n))
    jf = JFbankFrontend(JFbankConfig())
    want_f, want_m = jfbank_features(jnp.asarray(padded), jf.config, jf.window, jf.mel_t,
                                     n_valid=n_valid)
    tf = FbankFrontend(device="cpu")
    got_f, got_m = fbank_features(padded, tf.config, tf.window, tf.mel_t,
                                  n_valid=torch.tensor([n_valid]))
    int_f, int_m = fbank_features(padded, tf.config, tf.window, tf.mel_t, n_valid=n_valid)
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), rtol=0, atol=FEAT_ATOL)
    assert torch.equal(got_f, int_f) and torch.equal(got_m, int_m)


@pytest.mark.parametrize("n_valid", [0, 1, 5, 30, 37])
def test_lfr_stack_tensor_n_valid_equals_jax_and_int(n_valid):
    x = np.random.default_rng(n_valid).standard_normal((37, 8)).astype(np.float32)
    want = np.asarray(jlfr_stack(jnp.asarray(x), 7, 6, n_valid=n_valid))
    got = lfr_stack(torch.from_numpy(x), 7, 6, n_valid=torch.tensor(n_valid))
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, lfr_stack(torch.from_numpy(x), 7, 6, n_valid=n_valid))


# -- (c) SileroOnnx in blocks ------------------------------------------------------------


def test_silero_blocks_cover_every_chunk_once():
    port = SileroOnnx(SILERO, device="cpu")
    B = port.BLOCK
    assert B & (B - 1) == 0
    for n in (1, B - 1, B, B + 1, 2 * B - 1, 312, 1875):
        sizes = port.blocks(n)
        assert sum(sizes) == n and all(s & (s - 1) == 0 and s <= B for s in sizes)
        assert len(sizes) <= n // B + B.bit_length()
    assert port.blocks(312) == [B] * (312 // B) + port.blocks(312 % B)


@pytest.fixture(scope="module")
def silero_pair():
    return SileroOnnx(SILERO, device="cpu"), JSileroOnnx(SILERO)


@pytest.mark.parametrize("sr", [16000, 8000])
@pytest.mark.parametrize("extra", [1 - SileroOnnx.BLOCK, 0, 1, SileroOnnx.BLOCK - 1],
                         ids=["one", "block", "block+1", "2block-1"])
def test_silero_onnx_block_form_equals_jax_scan_and_hostloop(silero_pair, sr, extra):
    port, jside = silero_pair
    n = port.BLOCK + extra
    pcm = _speechlike(n * port.chunk + 100, 40 + n)
    got = port.speech_probs(pcm, sr)
    assert got.shape == (n,) and got.dtype == np.float32
    want = np.asarray(jside.speech_probs(pcm, sr))
    np.testing.assert_allclose(got, want, rtol=GRAPH_TOL, atol=GRAPH_TOL * np.abs(want).max())
    np.testing.assert_array_equal(got, port.speech_probs_hostloop(pcm, sr))


# -- (d) donation ------------------------------------------------------------------------


def test_compiled_model_donation_keeps_the_outputs():
    rng = np.random.default_rng(7)
    cm = compile_model(str(SILERO), device="cpu", donate=["state"])
    plain = compile_model(str(SILERO), device="cpu")
    # the donated state's new value is the output of its shape and type
    assert cm.donated == {"state": 1} and plain.donated == {}
    state = np.zeros((2, 1, 128), np.float32)
    pstate = state
    for sr in (16000, 8000, 16000):
        x = (rng.standard_normal((1, 512)) * 3000).astype(np.float32)
        srv = np.asarray([sr], np.int64)
        prob, state = cm(x, state, srv)
        pprob, pstate = plain(x, pstate, srv)
        assert torch.equal(prob, pprob) and torch.equal(state, pstate)
    with pytest.raises(ValueError, match="not an input"):
        compile_model(str(SILERO), device="cpu", donate=["nope"])


# -- (e) which tapes can be captured ------------------------------------------------------


def test_tapes_report_whether_they_can_be_captured():
    dynamic = compile_model(str(SILERO), device="cpu")  # sr an input: a dynamic If
    assert dynamic.stats["capturable"] is False and dynamic._tape.capturable is False
    bound = SileroOnnx(SILERO, device="cpu").compiled(16000)  # the If resolved
    assert bound.stats["capturable"] is True
    sv = compile_model(str(FIXTURES / "sensevoice.onnx"), device="cpu",
                       input_shapes={"speech": (1, 32, 560)})
    assert sv.stats["capturable"] is True
    # nothing is captured on the CPU: every tape replays step by step
    for cm in (dynamic, bound, sv):
        assert cm.stats["captured"] is False


def test_programs_run_eagerly_on_the_cpu_and_trees_round_trip():
    tree = {"b": [torch.zeros(2), (torch.ones(3, dtype=torch.int32), 4)], "a": torch.ones(1)}
    leaves, spec = graphs.flatten(tree)
    assert [tuple(v.shape) if isinstance(v, torch.Tensor) else v for v in leaves] == [
        (1,), (2,), (3,), 4]
    back = graphs.unflatten(spec, leaves)
    assert back.keys() == tree.keys() and back["b"][1][1] == 4
    assert graphs.flatten(back)[1] == spec
    progs = graphs.Programs("cpu")
    out = progs.run("k", lambda: lambda x, s: (x * 2, s + 1), np.ones(3, np.float32),
                    torch.zeros(2), donate={1: 1})
    assert torch.equal(out[0], torch.full((3,), 2.0)) and torch.equal(out[1], torch.ones(2))
    assert len(progs) == 0  # the CPU captures nothing


@pytest.mark.parametrize("enabled", [True, False])
def test_collector_paused_holds_the_collector_off_and_restores_it(enabled):
    import gc

    was = gc.isenabled()
    (gc.enable if enabled else gc.disable)()
    try:
        with graphs.collector_paused():
            assert not gc.isenabled()
        assert gc.isenabled() is enabled
        with pytest.raises(ValueError), graphs.collector_paused():
            raise ValueError("inside")
        assert gc.isenabled() is enabled
    finally:
        (gc.enable if was else gc.disable)()
