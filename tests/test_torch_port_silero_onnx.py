"""The port's compiled Silero path against the JAX package's: the seven new
emitters (Equal, Log, Sigmoid, Gemm, ReduceMean, STFT, LSTM in all its
forms), the tracer's If (a static condition, and a dynamic one traced on
zeros), and SileroOnnx on fixtures/silero.onnx at both sample rates.

Each emitter runs the same node as the JAX emitter on the same numpy
inputs: the JAX side eagerly with jax.numpy on the CPU, the port with torch
on the CPU. Float results agree to 1e-5 of the reference's largest
magnitude (only summation orders and the FFT's implementation differ;
everything is f32), boolean results exactly. Whole graphs: the fixture
scales PCM by 32768 and takes a log of the power spectrum, so its
probabilities are held to 1e-4.
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lele_tpu.compiler import compile_model as j_compile
from lele_tpu.models.checkpoints import SileroOnnx as JSileroOnnx
from lele_tpu.onnx import builder as jb
from lele_tpu.onnx.loader import OnnxModel as JOnnxModel
from lele_tpu.ops.registry import lookup_op as j_lookup
from lele_tpu.ops.registry import make_ctx as j_make_ctx
from lele_tpu_torch.compiler import compile_model
from lele_tpu_torch.kernels import lstm_seq
from lele_tpu_torch.models import SileroOnnx
from lele_tpu_torch.onnx import OnnxModel
from lele_tpu_torch.onnx import builder as ob
from lele_tpu_torch.ops import make_ctx, nn_ops
from lele_tpu_torch.ops.registry import lookup_op

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_silero_onnx_e2e import build_silero_like_onnx  # noqa: E402

FIXTURE = Path(__file__).resolve().parent.parent / "fixtures" / "silero.onnx"
FLOAT_TOL = 1e-5
GRAPH_TOL = 1e-4
_RNG = np.random.default_rng(2027)


def _f32(*shape, scale=1.0):
    return (_RNG.standard_normal(shape) * scale).astype(np.float32)


def _assert_close(got, want, tol=FLOAT_TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if np.issubdtype(want.dtype, np.floating):
        assert got.dtype == want.dtype
        scale = float(np.abs(want).max()) if want.size else 0.0
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)
    else:
        np.testing.assert_array_equal(got, want)


# -- emitters -----------------------------------------------------------------


def _case(op, inputs, n_out=1, **attrs):
    return (op, inputs, n_out, attrs)


_win = np.hanning(64).astype(np.float32)
EMITTER_CASES = {
    "Equal": _case("Equal", [np.asarray([16000], np.int64), np.asarray([16000], np.int64)]),
    "Equal_false": _case("Equal", [np.asarray(8000, np.int64), np.asarray(16000, np.int64)]),
    "Equal_f32": _case("Equal", [np.float32([1, 2, 3]), np.float32([1, 0, 3])]),
    "Log": _case("Log", [np.abs(_f32(1, 65, 7)) + 1.0]),
    "Sigmoid": _case("Sigmoid", [_f32(1, 1, scale=3.0)]),
    "Sigmoid_wide": _case("Sigmoid", [_f32(4, 33, scale=8.0)]),
    "Gemm": _case("Gemm", [_f32(1, 16), _f32(16, 1), _f32(1)]),
    "Gemm_trans_alpha_beta": _case("Gemm", [_f32(8, 5), _f32(7, 8), _f32(5, 7)],
                                   transA=1, transB=1, alpha=0.5, beta=2.0),
    "ReduceMean": _case("ReduceMean", [_f32(1, 3, 16)], axes=[1], keepdims=0),
    "ReduceMean_keep": _case("ReduceMean", [_f32(2, 5, 6)], axes=[-1]),
    "ReduceMean_input_axes": _case("ReduceMean", [_f32(2, 5, 6), np.asarray([0, 2], np.int64)]),
    "STFT": _case("STFT", [_f32(1, 512, scale=0.3), np.asarray(128, np.int64),
                           np.hanning(256).astype(np.float32)], onesided=1),
    "STFT_3d_hop": _case("STFT", [_f32(2, 300, 1), np.asarray(32, np.int64), _win]),
    "STFT_frame_length": _case("STFT", [_f32(1, 200), np.asarray(50, np.int64), None,
                                        np.asarray(100, np.int64)]),
}


def _nodes(op, ins, n_out, attrs):
    """The node as both loaders parse it from the same bytes ("" for an
    absent optional input)."""
    outs = [f"o{k}" for k in range(n_out)]
    data = ob.build_model_bytes(
        [ob.node(op, ins, outs, **attrs)],
        inputs=[ob.value_info(n, 1, []) for n in ins if n],
        outputs=[ob.value_info(n, 1, []) for n in outs])
    assert data == jb.build_model_bytes(
        [jb.node(op, ins, outs, **attrs)],
        inputs=[jb.value_info(n, 1, []) for n in ins if n],
        outputs=[jb.value_info(n, 1, []) for n in outs])
    return OnnxModel.from_bytes(data).graph.node[0], JOnnxModel.from_bytes(data).graph.node[0]


def _run_both(op, inputs, n_out, attrs):
    """Run the port's and the JAX emitter on the same node: dynamic
    arguments as device values (torch / jax arrays), shape arguments and each
    emitter's static_args host-static, as each tracer hands them over."""
    node, jnode = _nodes(op, [f"i{k}" if v is not None else "" for k, v in enumerate(inputs)],
                         n_out, attrs)
    opdef, jopdef = lookup_op("", op), j_lookup("", op)
    t_in = [v if v is None or k in opdef.static_args else torch.from_numpy(np.array(v))
            for k, v in enumerate(inputs)]
    j_in = [v if v is None or k in jopdef.static_args else jnp.asarray(v)
            for k, v in enumerate(inputs)]
    got = opdef.fn(make_ctx(torch, node, 17), *t_in)
    want = jopdef.fn(j_make_ctx(jnp, jnode, 17), *j_in)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want) == n_out
    return got, want


@pytest.mark.parametrize("case", list(EMITTER_CASES))
def test_emitter_matches_jax(case):
    for g, w in zip(*_run_both(*EMITTER_CASES[case])):
        _assert_close(g, w)


def _lstm_case(S, B, I, H, D=1, bias=True, lens=None, init=False, peep=False, layout=0,
               **attrs):
    x = _f32(*((B, S, I) if layout else (S, B, I)))
    ins = [x, _f32(D, 4 * H, I, scale=0.3), _f32(D, 4 * H, H, scale=0.3),
           _f32(D, 8 * H, scale=0.1) if bias else None,
           None if lens is None else np.asarray(lens, np.int32)]
    if init or peep:
        st = (B, D, H) if layout else (D, B, H)
        ins += [_f32(*st), _f32(*st)]
    if peep:
        ins.append(_f32(D, 3 * H, scale=0.5))
    if D == 2:
        attrs["direction"] = "bidirectional"
    return _case("LSTM", ins, 3, hidden_size=H, layout=layout, **attrs)


LSTM_CASES = {  # tests/test_nn_ops.py:378-510 and tests/test_op_battery.py:125
    "forward": _lstm_case(6, 2, 4, 5),
    "reverse_initial_states": _lstm_case(4, 1, 3, 4, bias=False, lens=[4], init=True,
                                         direction="reverse"),
    "peepholes": _lstm_case(5, 2, 3, 4, lens=[5, 5], peep=True),
    "ragged": _lstm_case(6, 3, 4, 5, lens=[6, 3, 1]),
    "ragged_reverse": _lstm_case(5, 2, 3, 4, lens=[5, 2], direction="reverse"),
    "bidirectional": _lstm_case(5, 2, 3, 4, D=2),
    "layout_1_bidirectional_states": _lstm_case(5, 3, 4, 6, D=2, init=True, layout=1),
    "silero_fixture_width": _lstm_case(3, 1, 128, 128, init=True),
}


@pytest.mark.parametrize("case", list(LSTM_CASES))
def test_lstm_emitter_matches_jax(case):
    op, inputs, n_out, attrs = LSTM_CASES[case]
    got, want = _run_both(op, inputs, n_out, attrs)
    for g, w in zip(got, want):
        _assert_close(g, w)


@pytest.mark.parametrize("case", list(LSTM_CASES))
def test_lstm_compiled_matches_jax_and_hoists_prepared_weights(case):
    """Through the tracer: W, R and B are put in the kernel's order once, at
    trace time, and hoisted; the tape holds one step, the recurrence."""
    _, inputs, _, attrs = LSTM_CASES[case]
    names = ["x", "w", "r", "b", "sl", "h0", "c0", "p"][:len(inputs)]
    node_in = [n if v is not None else "" for n, v in zip(names, inputs)]
    inits = [jb.tensor_from_array(v, n) for n, v in zip(names[1:], inputs[1:]) if v is not None]
    data = jb.build_model_bytes(
        [jb.node("LSTM", node_in, ["y", "yh", "yc"], **attrs)],
        inputs=[jb.value_info("x", 1, list(inputs[0].shape))],
        outputs=[jb.value_info(n, 1, []) for n in ("y", "yh", "yc")],
        initializers=inits)
    cm = compile_model(data, device="cpu")
    routes = dict(nn_ops.RNN_ROUTES)
    got = cm.run_np(x=inputs[0])
    want = j_compile(JOnnxModel.from_bytes(data)).run_np(x=inputs[0])
    for g, w in zip(got, want):
        _assert_close(g, w)
    assert cm.stats["n_steps"] == 1
    assert {k.split("#")[1] for k in cm.params if "#" in k} == (
        {"lstm_wx", "lstm_rh", "lstm_bias"} if inputs[3] is not None else {"lstm_wx", "lstm_rh"})
    n_dir = 2 if attrs.get("direction") == "bidirectional" else 1
    kernel_route = inputs[4] is None or np.all(inputs[4] == inputs[0].shape[
        1 if attrs["layout"] else 0])
    kernel_route = kernel_route and len(inputs) < 8
    moved = {k: nn_ops.RNN_ROUTES[k] - routes[k] for k in routes}
    assert moved == ({"lstm_seq": n_dir, "gru_seq": 0, "loop": 0} if kernel_route
                     else {"lstm_seq": 0, "gru_seq": 0, "loop": n_dir})


@pytest.mark.parametrize("case", ["forward", "peepholes", "ragged_reverse", "bidirectional"])
def test_lstm_plain_override_equals_the_emitter(case):
    _, inputs, _, attrs = LSTM_CASES[case]
    names = ["x", "w", "r", "b", "sl", "h0", "c0", "p"][:len(inputs)]
    data = ob.build_model_bytes(
        [ob.node("LSTM", [n if v is not None else "" for n, v in zip(names, inputs)],
                 ["y", "yh", "yc"], **attrs)],
        inputs=[ob.value_info("x", 1, list(inputs[0].shape))],
        outputs=[ob.value_info(n, 1, []) for n in ("y", "yh", "yc")],
        initializers=[ob.tensor_from_array(v, n) for n, v in zip(names[1:], inputs[1:])
                      if v is not None])
    got = compile_model(data, device="cpu", overrides={"LSTM": nn_ops.lstm_plain})
    want = compile_model(data, device="cpu")
    for g, w in zip(got.run_np(x=inputs[0]), want.run_np(x=inputs[0])):
        np.testing.assert_array_equal(g, w)


# -- tracer: If ---------------------------------------------------------------


def _if_graph(sr_static=None, mismatched=False, nested=False):
    """x [2, 3] → If(sr == 16000) with two outputs: then (2·x, x itself),
    else (x + 1, relu(x)); then y + z - x. `nested` puts a second If on a
    graph input `flag` inside the then-branch, reading the outer x."""
    then_nodes = [ob.node("Mul", ["x", "two"], ["ty"]), ob.node("Identity", ["x"], ["tz"])]
    if nested:
        inner_t = ob.graph([ob.node("Mul", ["x", "x"], ["it"])], name="it",
                           outputs=[ob.value_info("it", 1, [2, 3])])
        inner_e = ob.graph([ob.node("Sub", ["x", "one"], ["ie"])], name="ie",
                           outputs=[ob.value_info("ie", 1, [2, 3])])
        then_nodes[1] = ob.node("If", ["flag"], ["tz"], then_branch=inner_t,
                                else_branch=inner_e)
    then_g = ob.graph(then_nodes, name="then",
                      outputs=[ob.value_info("ty", 1, [2, 3]), ob.value_info("tz", 1, [2, 3])])
    else_y = ob.node("ReduceSum", ["x", "ax"], ["ey"]) if mismatched else \
        ob.node("Add", ["x", "one"], ["ey"])
    else_g = ob.graph([else_y, ob.node("Relu", ["x"], ["ez"])], name="else",
                      outputs=[ob.value_info("ey", 1, [2, 3]), ob.value_info("ez", 1, [2, 3])])
    nodes = [ob.node("Equal", ["sr", "c16k"], ["is16k"]),
             ob.node("If", ["is16k"], ["y", "z"], then_branch=then_g, else_branch=else_g),
             ob.node("Add", ["y", "z"], ["s"]),
             ob.node("Sub", ["s", "x"], ["out"])]
    inits = {"c16k": np.asarray(16000, np.int64), "two": np.float32(2.0),
             "one": np.float32(1.0), "ax": np.asarray([1], np.int64)}
    inputs = [ob.value_info("x", 1, [2, 3])]
    if sr_static is None:
        inputs.append(ob.value_info("sr", 7, []))
    else:
        inits["sr"] = np.asarray(sr_static, np.int64)
    if nested:
        inputs.append(ob.value_info("flag", 9, []))
    return ob.build_model_bytes(
        nodes, inputs=inputs, outputs=[ob.value_info("out", 1, [2, 3])],
        initializers=[ob.tensor_from_array(v, k) for k, v in inits.items()])


def _if_want(x, sr, flag=None):
    y, z = (2 * x, x if flag is None else (x * x if flag else x - 1)) if sr == 16000 \
        else (x + 1, np.maximum(x, 0))
    return y + z - x


@pytest.mark.parametrize("sr", [16000, 8000])
def test_static_if_resolves_at_trace_time(sr):
    data = _if_graph(sr_static=sr)
    cm = compile_model(data, device="cpu")
    x = _f32(2, 3)
    got = cm.run_np(x=x)[0]
    np.testing.assert_allclose(got, _if_want(x, sr), rtol=1e-6)
    np.testing.assert_array_equal(got, j_compile(JOnnxModel.from_bytes(data)).run_np(x=x)[0])
    # only the taken branch is recorded: its two steps, then Add and Sub
    assert cm.stats["n_steps"] == 4
    assert cm.stats["n_folded"] == 1  # Equal on two constants


def test_dynamic_if_replays_the_branch_of_each_request():
    """The trace runs on zeros, so sr = 0 takes the else-branch while
    tracing; every replay must take the branch of its own sr."""
    data = _if_graph()
    cm = compile_model(data, device="cpu")
    jcm = j_compile(JOnnxModel.from_bytes(data))
    for sr in (16000, 8000, 16000, 0, 8000):
        x = _f32(2, 3)
        srv = np.asarray(sr, np.int64)
        got = cm.run_np(x=x, sr=srv)[0]
        np.testing.assert_allclose(got, _if_want(x, sr), rtol=1e-6)
        np.testing.assert_array_equal(got, jcm.run_np(x=x, sr=srv)[0])


def test_nested_dynamic_if_reads_outer_values():
    data = _if_graph(nested=True)
    cm = compile_model(data, device="cpu")
    jcm = j_compile(JOnnxModel.from_bytes(data))
    for sr, flag in ((16000, True), (16000, False), (8000, True), (8000, False)):
        x = _f32(2, 3)
        kw = dict(x=x, sr=np.asarray(sr, np.int64), flag=np.asarray(flag))
        got = cm.run_np(**kw)[0]
        np.testing.assert_allclose(got, _if_want(x, sr, flag), rtol=1e-6)
        np.testing.assert_array_equal(got, jcm.run_np(**kw)[0])


def test_dynamic_if_with_branches_of_two_shapes_raises():
    with pytest.raises(NotImplementedError, match="one shape"):
        compile_model(_if_graph(mismatched=True), device="cpu")


# -- the Silero-class graphs ----------------------------------------------------


def _all_ops(graph):
    ops = set()
    for n in graph.node:
        ops.add(n.op_type)
        for a in n.attribute:
            if a.name in ("then_branch", "else_branch"):
                ops |= _all_ops(a.g)
    return ops


def test_every_silero_graph_op_has_an_emitter():
    builder, _ = build_silero_like_onnx()
    ops = _all_ops(OnnxModel.load(FIXTURE).graph) | _all_ops(OnnxModel.from_bytes(builder).graph)
    assert "If" in ops and "LSTM" in ops and len(ops) == 20
    assert all(lookup_op("", o) is not None for o in ops - {"If"})


def test_builder_graph_streams_like_jax():
    """The graph of tests/test_silero_onnx_e2e.py: sr a dynamic input, both
    branches hand back the outer chunk itself; 4 streaming steps."""
    data, _ = build_silero_like_onnx()
    cm = compile_model(data, device="cpu")
    jcm = j_compile(JOnnxModel.from_bytes(data))
    rng = np.random.default_rng(9)
    state = jstate = np.zeros((2, 1, 16), np.float32)
    sr = np.asarray(16000, np.int64)
    for _ in range(4):
        chunk = (rng.standard_normal((1, 512)) * 0.3).astype(np.float32)
        prob, state = cm.run_np(chunk, state, sr)
        jprob, jstate = (np.asarray(v) for v in jcm.run_np(chunk, jstate, sr))
        _assert_close(prob, jprob, GRAPH_TOL)
        _assert_close(state, jstate, GRAPH_TOL)


def _pcm(seconds, seed):
    rng = np.random.default_rng(seed)
    n = int(seconds * 16000)
    t = np.arange(n) / 16000
    pcm = 0.2 * np.sin(2 * np.pi * 200 * t) * (t % 1.0 > 0.4) + 0.01 * rng.standard_normal(n)
    return pcm.astype(np.float32)


def test_fixture_with_a_dynamic_sr_matches_jax_at_both_rates():
    """One compiled model whose sr is a graph input: each request's rate
    takes its own front-end (the trap of tracing on zeros)."""
    cm = compile_model(FIXTURE, device="cpu")
    jcm = j_compile(str(FIXTURE))
    assert cm.input_order == ["input", "state", "sr"]
    rng = np.random.default_rng(4)
    state = jstate = np.zeros((2, 1, 128), np.float32)
    probs = {}
    for sr in (16000, 8000, 16000, 8000):
        x = (rng.standard_normal((1, 512)) * 3000).astype(np.float32)
        srv = np.asarray([sr], np.int64)
        prob, state = cm.run_np(x, state, srv)
        jprob, jstate = (np.asarray(v) for v in jcm.run_np(x, jstate, srv))
        _assert_close(prob, jprob, GRAPH_TOL)
        _assert_close(state, jstate, GRAPH_TOL)
        probs[sr] = cm.run_np(np.full((1, 512), 900.0, np.float32), np.zeros_like(state),
                              srv)[0]
    assert not np.array_equal(probs[16000], probs[8000])


@pytest.fixture(scope="module")
def fixture_probs():
    pcm = _pcm(3.0, 5)
    port, jax_side = SileroOnnx(FIXTURE, device="cpu"), JSileroOnnx(FIXTURE)
    return pcm, port, {sr: (port.speech_probs(pcm, sr), jax_side.speech_probs(pcm, sr))
                       for sr in (16000, 8000)}


@pytest.mark.parametrize("sr", [16000, 8000])
def test_silero_onnx_matches_jax(fixture_probs, sr):
    pcm, port, probs = fixture_probs
    got, want = probs[sr]
    assert got.shape == want.shape == (len(pcm) // 512,) and got.dtype == np.float32
    _assert_close(got, want, GRAPH_TOL)
    # the If took this rate's branch: the two front-ends give other numbers
    assert not np.allclose(probs[16000][0], probs[8000][0], atol=1e-6)
    # static sr: the If resolved while tracing, and no step reads back
    cm = port.compiled(sr)
    assert cm.input_order == ["input", "state"] and cm.stats["n_folded"] == 2
    assert cm.stats["n_steps"] == 22


@pytest.mark.parametrize("sr", [16000, 8000])
def test_silero_onnx_scan_matches_hostloop_and_segments_match_jax(fixture_probs, sr):
    pcm, port, probs = fixture_probs
    np.testing.assert_array_equal(port.speech_probs_hostloop(pcm, sr), probs[sr][0])
    np.testing.assert_array_equal(port.speech_probs(pcm, sr, max_chunks=7), probs[sr][0][:7])
    for thr in (0.3, float(np.median(probs[sr][1]))):
        assert port.segments(pcm, sr, threshold=thr) == \
            JSileroOnnx(FIXTURE).segments(pcm, sr, threshold=thr)


def test_silero_onnx_runs_the_sequence_once_a_chunk(fixture_probs, monkeypatch):
    pcm, port, probs = fixture_probs
    calls = []
    monkeypatch.setattr(nn_ops, "lstm_seq",
                        lambda *a: calls.append(tuple(a[0].shape)) or lstm_seq(*a))
    fresh = SileroOnnx(FIXTURE, device="cpu")
    np.testing.assert_array_equal(fresh.speech_probs(pcm[:8 * 512]), probs[16000][0][:8])
    # the trace's own walk, then one per chunk: [S = 3 frames, B = 1, 4H]
    assert calls == [(3, 1, 512)] * (1 + 8)
    plain = SileroOnnx(FIXTURE, device="cpu", overrides={"LSTM": nn_ops.lstm_plain})
    np.testing.assert_array_equal(plain.speech_probs(pcm, 8000), probs[8000][0])
    assert len(calls) == 9
