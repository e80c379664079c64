"""The port's control flow against the JAX package's: the tracer's Loop (its
three lowerings), Scan and SequenceMap, the sequence and optional ops, Neg
and LeakyRelu, and Silero's whole utterance as one Scan or Loop over
fixtures/silero.onnx's step.

Each case builds one graph and runs its bytes through JAX's compile_model
and the port's (device="cpu"): both agree with the JAX test's expected
values at its tolerance (tests/test_loop_op.py and test_sequence_map.py:
max|d| <= 1e-5 or rtol 1e-6) and with each other. The port's loop steps
replay a body walked once on device placeholders; `stats["capturable"]`
says whether a tape can go into one CUDA graph, and it must be False only
for the host-read while loop (and a dynamic If).
"""

import io
import sys
from contextlib import redirect_stderr
from pathlib import Path

import numpy as np
import pytest
import torch

from lele_tpu.compiler import compile_model as j_compile
from lele_tpu.onnx import builder as jb
from lele_tpu.onnx.loader import OnnxModel as JOnnxModel
from lele_tpu_torch.compiler import compile_model
from lele_tpu_torch.models import SileroOnnx
from lele_tpu_torch.ops import nn_ops

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tests"))
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402
from test_loop_op import _dyn_exit_scan_body, _loop_model  # noqa: E402

TOL = 1e-5  # tests/optest.py assert_close, the JAX loop tests' gate
FLOAT_TOL = 1e-5  # tests/test_torch_port_silero_onnx.py:41


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert (np.abs(got - want).max() if got.size else 0.0) <= tol


def _bytes(nodes, inputs, outputs, inits=None, opset=17):
    return jb.build_model_bytes(
        nodes, [jb.vi_from_array(k, v) if isinstance(v, np.ndarray) else v
                for k, v in inputs.items()],
        [jb.value_info(o, 1, []) for o in outputs],
        [jb.tensor_from_array(v, k) for k, v in (inits or {}).items()], opset=opset)


def _both(bs, *args, strict=True, **kwargs):
    """(port outputs, JAX outputs, the port's CompiledModel) on the same bytes."""
    with redirect_stderr(io.StringIO()):
        want = j_compile(JOnnxModel.from_bytes(bs), strict=strict).run_np(*args, **kwargs)
        cm = compile_model(bs, device="cpu", strict=strict)
    return cm.run_np(*args, **kwargs), want, cm


def _loop_bytes(**kw):
    nodes, gin, inits = _loop_model(**kw)
    return jb.build_model_bytes(nodes, gin, [jb.value_info("y", 1, [4])],
                                [jb.tensor_from_array(v, k) for k, v in inits.items()])


def _pure_for_body():
    return jb.graph(
        [jb.node("Add", ["v_in", "v_in"], ["v_out"]),
         jb.node("Identity", ["cond_in"], ["cond_out"]),
         jb.node("Identity", ["v_out"], ["scan0"])],
        name="body",
        inputs=[jb.value_info("iter", 7, []), jb.value_info("cond_in", 9, []),
                jb.value_info("v_in", 1, [3])],
        outputs=[jb.value_info("cond_out", 9, []), jb.value_info("v_out", 1, [3]),
                 jb.value_info("scan0", 1, [3])])


def _scan_body():
    return jb.graph(
        [jb.node("Add", ["acc_in", "x_t"], ["acc_out"]),
         jb.node("Mul", ["acc_out", "two"], ["y_t"])],
        name="body",
        inputs=[jb.value_info("acc_in", 1, [3]), jb.value_info("x_t", 1, [3])],
        outputs=[jb.value_info("acc_out", 1, [3]), jb.value_info("y_t", 1, [3])])


# -- Loop: counterparts of tests/test_loop_op.py -------------------------------------


def test_loop_static_trip_count():
    x = np.ones(4, np.float32)
    (y,), (jy,), cm = _both(_loop_bytes(m_value=3), x)
    _close(y, x * 8)
    _close(y, jy)


def test_loop_early_exit_condition():
    x = np.ones(4, np.float32) * 10  # sums 80, 160: exits after iteration 1
    (y,), (jy,), cm = _both(_loop_bytes(m_value=50, with_cond=True), x)
    _close(y, x * 4)
    _close(y, jy)
    assert cm.stats["capturable"] is False  # its condition is read on the host


def test_loop_int64max_sentinel_runs_as_while():
    x = np.ones(4, np.float32) * 10
    (y,), (jy,), cm = _both(_loop_bytes(m_value=2**63 - 1, with_cond=True), x)
    _close(y, x * 4)  # not x: the clamped sentinel lets the exit govern
    _close(y, jy)


def test_loop_scan_int64max_sentinel_falls_back():
    nodes = [jb.node("Loop", ["M", "", "v0"], ["v_fin", "ys"], body=_dyn_exit_scan_body())]
    bs = jb.build_model_bytes(
        nodes, [jb.value_info("v0", 1, [2])],
        [jb.value_info("v_fin", 1, [2]), jb.value_info("ys", 1, ["n", 2])],
        [jb.tensor_from_array(np.array(2**63 - 1, np.int64), "M"),
         jb.tensor_from_array(np.float32(100.0), "lim")])
    (v_fin, ys), (jv, jys), _ = _both(bs, np.ones(2, np.float32), strict=False)
    assert ys.shape[0] == 0 and jys.shape[0] == 0  # warned and empty, not a 2^63 scan


def test_loop_dynamic_trip_count():
    x = np.ones(4, np.float32)
    bs = _loop_bytes(m_value=1, dynamic_m=True)
    jcm = j_compile(JOnnxModel.from_bytes(bs))
    cm = compile_model(bs, device="cpu")
    for m, want in ((4, x * 16), (2, x * 4)):
        (y,) = cm.run_np(x, np.array(m, np.int64))
        _close(y, want)
        _close(y, jcm.run_np(x, np.array(m, np.int64))[0])
    assert cm.stats["capturable"] is False


def test_loop_scan_outputs_dynamic_exit_padded():
    nodes = [jb.node("Loop", ["M", "", "x"], ["y", "ys"], body=_dyn_exit_scan_body())]
    x = np.ones(2, np.float32)
    bs = _bytes(nodes, {"x": x}, ["y", "ys"],
                {"M": np.array(6, np.int64), "lim": np.float32(30.0)})
    (y, ys), (jy, jys), cm = _both(bs, x=x)
    _close(y, x * 16)
    assert ys.shape == (6, 2)
    _close(ys, np.stack([x * 2, x * 4, x * 8, x * 16, x * 0, x * 0]))
    _close(y, jy)
    _close(ys, jys)
    assert cm.stats["capturable"] is True  # the active flag stays on the device


def test_loop_scan_outputs_dynamic_initial_cond():
    nodes = [jb.node("Loop", ["M", "c0", "x"], ["y", "ys"], body=_dyn_exit_scan_body())]
    x = np.ones(2, np.float32)
    bs = _bytes(nodes, {"x": x, "c0": jb.value_info("c0", 9, [])}, ["y", "ys"],
                {"M": np.array(3, np.int64), "lim": np.float32(1e9)})
    jcm = j_compile(JOnnxModel.from_bytes(bs))
    cm = compile_model(bs, device="cpu")
    y, ys = cm.run_np(x, np.array(True))
    _close(y, x * 8)
    _close(ys, np.stack([x * 2, x * 4, x * 8]))
    for got, want in zip((y, ys), jcm.run_np(x, np.array(True))):
        _close(got, want)
    y, ys = cm.run_np(x, np.array(False))
    _close(y, x)  # never ran: the carried value stays the init
    _close(ys, np.zeros((3, 2), np.float32))
    for got, want in zip((y, ys), jcm.run_np(x, np.array(False))):
        _close(got, want)
    assert cm.stats["capturable"] is True


def test_loop_scan_outputs_statically_false_cond():
    nodes = [jb.node("Loop", ["M", "c0", "x"], ["y", "ys"], body=_dyn_exit_scan_body())]
    x = np.ones(2, np.float32) * 3
    bs = _bytes(nodes, {"x": x}, ["y", "ys"],
                {"M": np.array(5, np.int64), "c0": np.array(False), "lim": np.float32(100.0)})
    (y, ys), (jy, jys), _ = _both(bs, x=x)
    _close(y, x)
    assert ys.shape == (0, 2) and jys.shape == (0, 2)
    _close(y, jy)


def test_loop_scan_outputs_no_trip_bound_falls_back(capsys):
    nodes = [jb.node("Loop", ["", "c0", "x"], ["y", "ys"], body=_dyn_exit_scan_body())]
    x = np.ones(2, np.float32)
    bs = _bytes(nodes, {"x": x}, ["y", "ys"], {"c0": np.array(True), "lim": np.float32(100.0)})
    outs = compile_model(bs, device="cpu").run_np(x=x)
    assert outs[0].size == 0  # the fallback empties, with a warning
    assert "without a static trip-count bound" in capsys.readouterr().err
    with pytest.raises(NotImplementedError, match="static trip-count bound") as port_err:
        compile_model(bs, device="cpu", strict=True)
    with pytest.raises(NotImplementedError) as jax_err:
        j_compile(JOnnxModel.from_bytes(bs), strict=True)
    assert str(port_err.value) == str(jax_err.value)  # JAX's wording


def test_loop_scan_outputs_pure_for():
    nodes = [jb.node("Loop", ["M", "", "x"], ["y", "ys"], body=_pure_for_body())]
    x = np.ones(3, np.float32)
    bs = _bytes(nodes, {"x": x}, ["y", "ys"], {"M": np.array(4, np.int64)})
    (y, ys), (jy, jys), cm = _both(bs, x=x)
    _close(y, x * 16)
    _close(ys, np.stack([x * 2, x * 4, x * 8, x * 16]))
    _close(ys, jys)
    assert cm.stats["capturable"] is True


def test_loop_scan_outputs_constant_true_cond():
    body = jb.graph(
        [jb.node("Constant", [], ["cond_out"], value=np.array(True)),
         jb.node("Mul", ["v_in", "two"], ["v_out"]),
         jb.node("ReduceSum", ["v_in"], ["scan0"], keepdims=0)],
        name="body",
        inputs=[jb.value_info("iter", 7, []), jb.value_info("cond_in", 9, []),
                jb.value_info("v_in", 1, [2])],
        outputs=[jb.value_info("cond_out", 9, []), jb.value_info("v_out", 1, [2]),
                 jb.value_info("scan0", 1, [])])
    nodes = [jb.node("Loop", ["M", "", "x"], ["y", "sums"], body=body)]
    x = np.array([1.0, 2.0], np.float32)
    bs = _bytes(nodes, {"x": x}, ["y", "sums"],
                {"M": np.array(3, np.int64), "two": np.float32(2.0)})
    (y, sums), (jy, jsums), cm = _both(bs, x=x)
    _close(y, x * 8)
    _close(sums, [3.0, 6.0, 12.0])
    _close(sums, jsums)
    assert cm.stats["capturable"] is True


def test_scan_op_cumulative_state_and_outputs():
    nodes = [jb.node("Scan", ["acc0", "xs"], ["acc_final", "ys"], body=_scan_body(),
                     num_scan_inputs=1)]
    xs = np.arange(12, dtype=np.float32).reshape(4, 3)
    acc0 = np.zeros(3, np.float32)
    bs = _bytes(nodes, {"acc0": acc0, "xs": xs}, ["acc_final", "ys"],
                {"two": np.float32(2.0)})
    (acc, ys), (jacc, jys), cm = _both(bs, acc0=acc0, xs=xs)
    want = xs.cumsum(0)
    _close(acc, want[-1])
    _close(ys, want * 2)
    _close(ys, jys)
    assert cm.stats["capturable"] is True and cm.stats["n_steps"] == 1


def test_scan_op_reverse_direction_and_axes():
    body = jb.graph(
        [jb.node("Add", ["s_in", "x_t"], ["s_out"]), jb.node("Identity", ["s_out"], ["y_t"])],
        name="body",
        inputs=[jb.value_info("s_in", 1, [2]), jb.value_info("x_t", 1, [2])],
        outputs=[jb.value_info("s_out", 1, [2]), jb.value_info("y_t", 1, [2])])
    nodes = [jb.node("Scan", ["s0", "xs"], ["s_final", "ys"], body=body, num_scan_inputs=1,
                     scan_input_axes=[1], scan_input_directions=[1],
                     scan_output_axes=[1], scan_output_directions=[1])]
    xs = np.arange(10, dtype=np.float32).reshape(2, 5)
    s0 = np.zeros(2, np.float32)
    (s, ys), (js, jys), _ = _both(_bytes(nodes, {"s0": s0, "xs": xs}, ["s_final", "ys"]),
                                  s0=s0, xs=xs)
    states = xs[:, ::-1].cumsum(1)
    _close(s, states[:, -1])
    assert ys.shape == (2, 5)
    _close(ys, states[:, ::-1])
    _close(ys, jys)


# -- the port's own properties of loop steps ---------------------------------------------


def test_loop_counter_is_a_device_value_and_replays_upload_nothing(monkeypatch):
    """The body sees iteration i's counter, not iteration 0's folded in; a
    replay makes no tensor from host data (the counter is a view of a
    device arange made while tracing)."""
    body = jb.graph(
        [jb.node("Cast", ["iter"], ["i_f"], to=1),
         jb.node("Add", ["v_in", "i_f"], ["v_out"]),
         jb.node("Identity", ["cond_in"], ["cond_out"]),
         jb.node("Mul", ["i_f", "i_f"], ["sq"])],
        name="body",
        inputs=[jb.value_info("iter", 7, []), jb.value_info("cond_in", 9, []),
                jb.value_info("v_in", 1, [2])],
        outputs=[jb.value_info("cond_out", 9, []), jb.value_info("v_out", 1, [2]),
                 jb.value_info("sq", 1, [])])
    nodes = [jb.node("Loop", ["M", "", "x"], ["y", "sq_rows"], body=body)]
    x = np.zeros(2, np.float32)
    bs = _bytes(nodes, {"x": x}, ["y", "sq_rows"], {"M": np.array(5, np.int64)})
    (y, sq), (jy, jsq), cm = _both(bs, x=x)
    _close(y, np.full(2, 10.0))
    _close(sq, [0.0, 1.0, 4.0, 9.0, 16.0])
    _close(sq, jsq)
    inp = torch.from_numpy(x)

    def refuse(*a, **k):
        raise AssertionError("a replay made a tensor from host data")

    monkeypatch.setattr(torch, "tensor", refuse)
    monkeypatch.setattr(torch, "as_tensor", refuse)
    y2, sq2 = cm.replay(inp)
    assert torch.equal(sq2, torch.from_numpy(sq))


def test_while_loop_counter_does_not_scale_with_its_cap(monkeypatch):
    """A carried-only loop whose static M is a safety cap (10^9) and whose
    exit comes from its condition: the counter starts at one element and
    grows as the loop runs, never an arange of M."""
    sizes = []
    arange = torch.arange

    def spy(*a, **k):
        sizes.append(a[-1] if a and isinstance(a[-1], int) else 0)
        assert sizes[-1] <= 8, f"an arange of {sizes[-1]} elements"  # before allocating
        return arange(*a, **k)

    monkeypatch.setattr(torch, "arange", spy)
    x = np.ones(4, np.float32)  # doubled five times: the sum passes 100 at 128
    (y,), (jy,), cm = _both(_loop_bytes(m_value=10**9, with_cond=True), x)
    _close(y, x * 32)
    _close(y, jy)
    assert cm.stats["capturable"] is False and sizes


def test_dynamic_if_in_a_scan_body_is_not_capturable():
    """A body holding a host-read step makes the whole tape step by step."""
    then_g = jb.graph([jb.node("Add", ["x_t", "x_t"], ["tb"])], "then", [],
                      [jb.value_info("tb", 1, [2])])
    else_g = jb.graph([jb.node("Neg", ["x_t"], ["eb"])], "else", [],
                      [jb.value_info("eb", 1, [2])])
    body = jb.graph(
        [jb.node("ReduceSum", ["x_t"], ["s"], keepdims=0),
         jb.node("Less", ["s", "zero"], ["neg"]),
         jb.node("If", ["neg"], ["y_t"], then_branch=then_g, else_branch=else_g),
         jb.node("Add", ["s_in", "y_t"], ["s_out"])],
        name="body",
        inputs=[jb.value_info("s_in", 1, [2]), jb.value_info("x_t", 1, [2])],
        outputs=[jb.value_info("s_out", 1, [2]), jb.value_info("y_t", 1, [2])])
    nodes = [jb.node("Scan", ["s0", "xs"], ["s_final", "ys"], body=body, num_scan_inputs=1)]
    xs = np.array([[1, 2], [-3, -1], [0.5, -4]], np.float32)
    s0 = np.zeros(2, np.float32)
    bs = _bytes(nodes, {"s0": s0, "xs": xs}, ["s_final", "ys"], {"zero": np.float32(0.0)})
    (s, ys), (js, jys), cm = _both(bs, s0=s0, xs=xs)
    want = np.where(xs.sum(1, keepdims=True) < 0, 2 * xs, -xs)
    _close(ys, want)
    _close(ys, jys)
    _close(s, jys.sum(0))
    assert cm.stats["capturable"] is False


# -- SequenceMap: counterparts of tests/test_sequence_map.py ---------------------------


def test_sequence_map_scale_and_concat():
    body = jb.graph([jb.node("Mul", ["e", "e"], ["sq"])], "body",
                    [jb.value_info("e", 1, [2])], [jb.value_info("sq", 1, [2])])
    nodes = [jb.node("SplitToSequence", ["x"], ["seq"], axis=0, keepdims=0),
             jb.node("SequenceMap", ["seq"], ["mapped"], body=body),
             jb.node("ConcatFromSequence", ["mapped"], ["y"], axis=0, new_axis=1)]
    x = np.arange(6, dtype=np.float32).reshape(3, 2)
    (y,), (jy,), _ = _both(_bytes(nodes, {"x": x}, ["y"]), x=x)
    np.testing.assert_allclose(y, x * x, rtol=1e-6)
    np.testing.assert_allclose(y, jy, rtol=1e-6)


def test_sequence_map_extra_tensor_input():
    body = jb.graph(
        [jb.node("Add", ["e", "c"], ["a"]), jb.node("ReduceSum", ["e"], ["s"], keepdims=0)],
        "body", [jb.value_info("e", 1, [2]), jb.value_info("c", 1, [2])],
        [jb.value_info("a", 1, [2]), jb.value_info("s", 1, [])])
    nodes = [jb.node("SplitToSequence", ["x"], ["seq"], axis=0, keepdims=0),
             jb.node("SequenceMap", ["seq", "c"], ["added", "sums"], body=body),
             jb.node("ConcatFromSequence", ["added"], ["y"], axis=0, new_axis=1),
             jb.node("ConcatFromSequence", ["sums"], ["z"], axis=0, new_axis=1)]
    x = np.arange(8, dtype=np.float32).reshape(4, 2)
    c = np.array([10.0, 20.0], dtype=np.float32)
    (y, z), (jy, jz), _ = _both(_bytes(nodes, {"x": x, "c": c}, ["y", "z"]), x=x, c=c)
    np.testing.assert_allclose(y, x + c, rtol=1e-6)
    np.testing.assert_allclose(z, x.sum(1), rtol=1e-6)
    np.testing.assert_allclose(z, jz, rtol=1e-6)


def test_sequence_map_ragged_elements():
    body = jb.graph([jb.node("ReduceSum", ["e"], ["s"], keepdims=1)], "body",
                    [jb.value_info("e", 1, ["n"])], [jb.value_info("s", 1, [1])])
    nodes = [jb.node("SplitToSequence", ["x", "lens"], ["seq"], axis=0),
             jb.node("SequenceMap", ["seq"], ["sums"], body=body),
             jb.node("ConcatFromSequence", ["sums"], ["y"], axis=0)]
    x = np.arange(5, dtype=np.float32)
    bs = _bytes(nodes, {"x": x}, ["y"], {"lens": np.array([2, 3], dtype=np.int64)})
    (y,), (jy,), _ = _both(bs, x=x)
    np.testing.assert_allclose(y, [x[:2].sum(), x[2:].sum()], rtol=1e-6)
    np.testing.assert_allclose(y, jy, rtol=1e-6)


@pytest.mark.parametrize("seqs, match", [([], "at least one sequence"),
                                         ([2, 3], "disagree on length")])
def test_sequence_map_refusals_are_jax_s(seqs, match):
    """JAX's two ValueErrors: no sequence input, and sequences of two lengths."""
    body = jb.graph([jb.node("Identity", ["e"], ["o"])], "body",
                    [jb.value_info("e", 1, [1])], [jb.value_info("o", 1, [1])])
    x = np.arange(5, dtype=np.float32)
    nodes = [jb.node("SplitToSequence", ["x", f"l{i}"], [f"s{i}"], axis=0)
             for i in range(len(seqs))]
    ins = [f"s{i}" for i in range(len(seqs))] or ["x"]
    nodes += [jb.node("SequenceMap", ins, ["m"], body=body),
              jb.node("ConcatFromSequence", ["m"], ["y"], axis=0)]
    inits = {f"l{i}": np.array([6 - n] + [1] * (n - 1), np.int64)  # n parts of x
             for i, n in enumerate(seqs)}
    bs = _bytes(nodes, {"x": x}, ["y"], inits)
    with pytest.raises(ValueError, match=match):
        compile_model(bs, device="cpu", strict=True)
    with pytest.raises(ValueError, match=match):
        j_compile(JOnnxModel.from_bytes(bs), strict=True)


# -- sequence and optional values ----------------------------------------------------------


def test_sequence_ops_match_jax_and_record_no_step():
    """Split → Erase → Insert → At / Length → Concat: only the split and the
    two concats record device steps; the length folds to a static value."""
    nodes = [jb.node("SplitToSequence", ["x"], ["seq"], axis=1, keepdims=1),
             jb.node("SequenceErase", ["seq", "one"], ["e"]),
             jb.node("SequenceInsert", ["e", "y", "zero"], ["ins"]),
             jb.node("SequenceAt", ["ins", "minus1"], ["last"]),
             jb.node("SequenceLength", ["ins"], ["n"]),
             jb.node("ConcatFromSequence", ["ins"], ["cat"], axis=1),
             jb.node("ConcatFromSequence", ["ins"], ["stk"], axis=0, new_axis=1),
             jb.node("Add", ["last", "last"], ["last2"])]
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 4)).astype(np.float32)
    y = rng.standard_normal((3, 1)).astype(np.float32)
    inits = {"one": np.array(1, np.int64), "zero": np.array(0, np.int64),
             "minus1": np.array(-1, np.int64)}
    bs = _bytes(nodes, {"x": x, "y": y}, ["cat", "stk", "last2", "n"], inits)
    got, want, cm = _both(bs, x=x, y=y)
    parts = [y] + [x[:, j:j + 1] for j in (0, 2, 3)]
    _close(got[0], np.concatenate(parts, 1))
    _close(got[1], np.stack(parts, 0))
    _close(got[2], 2 * x[:, 3:4])
    assert int(got[3]) == 4
    for g, w in zip(got, want):
        _close(g, w)
    assert cm.stats["n_steps"] == 4  # split, two concats, the Add


def test_sequence_construct_empty_and_split_sizes():
    nodes = [jb.node("SequenceEmpty", [], ["e0"]),
             jb.node("SequenceInsert", ["e0", "a"], ["e1"]),
             jb.node("SequenceConstruct", ["b", "a"], ["pair"]),
             jb.node("SequenceInsert", ["e1", "b"], ["e2"]),
             jb.node("ConcatFromSequence", ["e2"], ["ab"], axis=0),
             jb.node("ConcatFromSequence", ["pair"], ["ba"], axis=0),
             jb.node("SplitToSequence", ["ab", "two"], ["chunks"], axis=0),
             jb.node("SequenceLength", ["chunks"], ["n_chunks"]),
             jb.node("SequenceAt", ["chunks", "last"], ["tail"])]
    a = np.arange(6, dtype=np.float32).reshape(3, 2)
    b = -np.arange(4, dtype=np.float32).reshape(2, 2)
    bs = _bytes(nodes, {"a": a, "b": b}, ["ab", "ba", "n_chunks", "tail"],
                {"two": np.array(2, np.int64), "last": np.array(-1, np.int64)})
    got, want, _ = _both(bs, a=a, b=b)
    _close(got[0], np.concatenate([a, b]))
    _close(got[1], np.concatenate([b, a]))
    assert int(got[2]) == 3 and got[3].shape == (1, 2)
    for g, w in zip(got, want):
        _close(g, w)


def test_cse_does_not_merge_different_sequences():
    """Two sequences of the same tensors in another order are different
    values: their concats are two steps; a repeat of one is reused."""
    nodes = [jb.node("SequenceConstruct", ["a", "b"], ["s1"]),
             jb.node("SequenceConstruct", ["b", "a"], ["s2"]),
             jb.node("SequenceConstruct", ["a", "b"], ["s3"]),
             jb.node("ConcatFromSequence", ["s1"], ["c1"], axis=0),
             jb.node("ConcatFromSequence", ["s2"], ["c2"], axis=0),
             jb.node("ConcatFromSequence", ["s3"], ["c3"], axis=0)]
    a = np.ones((1, 2), np.float32)
    b = np.full((1, 2), 2.0, np.float32)
    (c1, c2, c3), want, cm = _both(_bytes(nodes, {"a": a, "b": b}, ["c1", "c2", "c3"]),
                                   a=a, b=b)
    _close(c1, [[1, 1], [2, 2]])
    _close(c2, [[2, 2], [1, 1]])
    _close(c3, c1)
    for g, w in zip((c1, c2, c3), want):
        _close(g, w)
    assert cm.stats["n_reused"] == 1 and cm.stats["n_steps"] == 2


def test_optional_roundtrip_and_has_element():
    x = np.arange(4, dtype=np.float32)
    nodes = [jb.node("Optional", ["x"], ["opt"]),
             jb.node("OptionalGetElement", ["opt"], ["y"]),
             jb.node("OptionalHasElement", ["opt"], ["has"])]
    (y, has), (jy, jhas), _ = _both(_bytes(nodes, {"x": x}, ["y", "has"]), x=x)
    np.testing.assert_array_equal(y, x)
    assert bool(has) is True and bool(jhas) is True


def test_empty_optional_has_no_element():
    nodes = [jb.node("Optional", [], ["opt"]),
             jb.node("OptionalHasElement", ["opt"], ["has"])]
    x = np.zeros((1,), np.float32)
    (has,), (jhas,), _ = _both(_bytes(nodes, {"x": x}, ["has"]), x=x)
    assert bool(has) is False and bool(jhas) is False


def test_optional_in_dynamic_loop_raises_clearly():
    """The counterpart of tests/test_dynshape_fold_ops.py:173: an optional
    carried through a Loop body raises JAX's actionable error."""
    body = jb.graph(
        nodes=[jb.node("Identity", ["c_in"], ["c_out"]),
               jb.node("Optional", ["v_in"], ["v_opt"])],
        name="body",
        inputs=[jb.value_info("i", 7, []), jb.value_info("c_in", 9, []),
                jb.value_info("v_in", 1, [2])],
        outputs=[jb.value_info("c_out", 9, []), jb.value_info("v_opt", 1, [2])])
    nodes = [jb.node("Loop", ["m", "cond", "v0"], ["v_final"], body=body)]
    bs = _bytes(nodes, {"v0": np.ones(2, np.float32), "cond": np.array(True)}, ["v_final"],
                {"m": np.asarray(3, np.int64)})
    with pytest.raises(NotImplementedError, match="[Oo]ptional") as port_err:
        compile_model(bs, device="cpu", strict=True)
    with pytest.raises(Exception, match="[Oo]ptional") as jax_err:
        j_compile(JOnnxModel.from_bytes(bs), strict=True)
    assert str(port_err.value) == str(jax_err.value)


# -- Neg and LeakyRelu -----------------------------------------------------------------


@pytest.mark.parametrize("op, attrs", [("Neg", {}), ("LeakyRelu", {}),
                                       ("LeakyRelu", {"alpha": 0.25})],
                         ids=["Neg", "LeakyRelu", "LeakyRelu_alpha"])
@pytest.mark.parametrize("static", [False, True], ids=["device", "folded"])
def test_neg_and_leaky_relu_match_jax(op, attrs, static):
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((3, 17)) * 4).astype(np.float32)
    x[0, :3] = (0.0, -0.0, -1e-30)
    nodes = [jb.node(op, ["x"], ["y"], **attrs)]
    if static:  # the node folds (Neg) or runs once on constants (LeakyRelu)
        bs = _bytes(nodes + [jb.node("Add", ["y", "z"], ["out"])],
                    {"z": np.zeros(1, np.float32)}, ["out"], {"x": x})
        (y,), (jy,), _ = _both(bs, z=np.zeros(1, np.float32))
    else:
        (y,), (jy,), _ = _both(_bytes(nodes, {"x": x}, ["y"]), x=x)
    alpha = attrs.get("alpha", 0.01)
    want = -x if op == "Neg" else np.where(x >= 0, x, np.float32(alpha) * x)
    np.testing.assert_array_equal(y, want)
    np.testing.assert_array_equal(y, jy)


# -- Silero's whole utterance as one Scan or Loop -------------------------------------------


@pytest.fixture(scope="module")
def silero_pcm():
    return chip_smoke.vad_pcm(1.0, 16000, np.random.default_rng(7))


@pytest.mark.parametrize("sr", [16000, 8000])
@pytest.mark.parametrize("form", ["scan", "loop"])
def test_silero_utterance_graph_matches_jax_and_speech_probs(form, sr, silero_pcm):
    """The wrapper over fixtures/silero.onnx's step: JAX's compile of the
    same bytes within FLOAT_TOL, and the port's SileroOnnx.speech_probs (the
    same emitters on the same chunks) bit for bit; kernel 6's route once a
    chunk; one capturable tape."""
    sv = SileroOnnx(chip_smoke.SILERO_FIXTURE, device="cpu")
    ref = sv.speech_probs(silero_pcm, sr)
    chunks = sv._chunks(silero_pcm, None)[:, None, :]
    bs = chip_smoke.silero_utterance_model(form, len(chunks), sr)
    state = np.zeros((2, 1, 128), np.float32)
    cm = compile_model(bs, device="cpu")
    before = nn_ops.RNN_ROUTES["lstm_seq"]
    probs, st = cm.run_np(chunks=chunks, state=state)
    assert nn_ops.RNN_ROUTES["lstm_seq"] == before + len(chunks)
    assert cm.stats["capturable"] is True and cm.stats["n_steps"] <= 2
    np.testing.assert_array_equal(probs, ref)
    jprobs, jst = j_compile(JOnnxModel.from_bytes(bs)).run_np(chunks=chunks, state=state)
    for got, want in ((probs, jprobs), (st, jst)):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=FLOAT_TOL,
                                   atol=FLOAT_TOL * float(np.abs(want).max()))


def test_patterns_and_cse_run_inside_a_scan_body():
    """A Scan whose body is a dynamically quantized linear (quantize_dynamic's
    form) matches the DQL-GEMM pattern inside the body, once; CSE reuses a
    repeated node within the body; the result is the per-op trace's, and
    JAX's run of the body as a flat graph on each slice. JAX's CPU compile of
    the Scan itself fails in XLA's LLVM lowering (an i32 add of an i8
    operand), which the case records."""
    from lele_tpu_torch.onnx import schema
    from lele_tpu_torch.onnx.quantize import quantize_dynamic

    rng = np.random.default_rng(8)
    w = rng.standard_normal((16, 8)).astype(np.float32)
    lin = quantize_dynamic(jb.build_model_bytes(
        [jb.node("MatMul", ["x_t", "w"], ["y0"])], [jb.value_info("x_t", 1, [2, 16])],
        [jb.value_info("y0", 1, [2, 8])], [jb.tensor_from_array(w, "w")]))
    g = schema.decode_model(lin).raw()["graph"]
    body = jb.graph(
        list(g["node"]) + [jb.node("Relu", ["y0"], ["r1"]), jb.node("Relu", ["y0"], ["r2"]),
                           jb.node("Add", ["r1", "r2"], ["y_t"]),
                           jb.node("Identity", ["s_in"], ["s_out"])],
        "body", [jb.value_info("s_in", 1, [1]), jb.value_info("x_t", 1, [2, 16])],
        [jb.value_info("s_out", 1, [1]), jb.value_info("y_t", 1, [2, 8])], g["initializer"])
    nodes = [jb.node("Scan", ["s0", "xs"], ["s", "ys"], body=body, num_scan_inputs=1)]
    xs = rng.standard_normal((5, 2, 16)).astype(np.float32)
    s0 = np.zeros(1, np.float32)
    bs = _bytes(nodes, {"s0": s0, "xs": xs}, ["s", "ys"])
    cm = compile_model(bs, device="cpu", strict=True)
    ys = cm.run_np(s0=s0, xs=xs)[1]
    assert cm.stats["pattern_hits"] == {"dql_matmul_dataflow": 1, "dql_fused_epilogue": 1}
    assert cm.stats["n_reused"] == 1  # the second Relu
    per_op = compile_model(bs, device="cpu", patterns=[])
    assert per_op.stats["pattern_hits"] == {}
    ref = per_op.run_np(s0=s0, xs=xs)[1]
    np.testing.assert_allclose(ys, ref, rtol=1e-6, atol=1e-6 * np.abs(ref).max())
    flat = jb.build_model_bytes(
        list(g["node"]) + body["node"][-4:-1], [jb.value_info("x_t", 1, [2, 16])],
        [jb.value_info("y_t", 1, [2, 8])], g["initializer"])
    jflat = j_compile(JOnnxModel.from_bytes(flat), strict=True)
    _close(ys, np.stack([jflat.run_np(x_t=x)[0] for x in xs]))
    with pytest.raises(Exception, match="Invalid LLVM IR"), redirect_stderr(io.StringIO()):
        j_compile(JOnnxModel.from_bytes(bs), strict=True).run_np(s0=s0, xs=xs)
