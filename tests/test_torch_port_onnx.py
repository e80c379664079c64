"""The port's ONNX layer against the JAX package's: builder, loader and the
22 op emitters the SAN-M int8 graph uses.

The graph builder must give the same bytes for the same seed, the loader the same
nodes and the same initializers bit for bit. Each emitter runs the same node
as the JAX emitter on the same numpy inputs: the JAX side eagerly with
jax.numpy, the port with torch on the CPU. Float results agree to 1e-6 of
the reference's largest magnitude (only the summation order of a product or
a mean differs); integer, boolean and quantized results are equal.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lele_tpu.onnx import builder as jb
from lele_tpu.onnx.loader import OnnxModel as JOnnxModel
from lele_tpu.onnx.loader import tensor_to_array as j_tensor_to_array
from lele_tpu.onnx.synth import build_sanm_int8_model as j_build
from lele_tpu.ops.registry import lookup_op as j_lookup
from lele_tpu.ops.registry import make_ctx as j_make_ctx
from lele_tpu.ops.registry import parse_attr as j_parse_attr
from lele_tpu_torch.onnx import OnnxModel, tensor_to_array
from lele_tpu_torch.onnx import builder as ob
from lele_tpu_torch.onnx.synth import build_sanm_int8_model
from lele_tpu_torch.ops import make_ctx
from lele_tpu_torch.ops.registry import lookup_op, parse_attr

FIXTURES = Path(__file__).resolve().parent.parent / "fixtures"
FLOAT_TOL = 1e-6


@pytest.mark.parametrize("kw", [
    {},
    dict(L=1, d=64, h=2, ffn=96, vocab=40, seed=5),
    dict(L=2, d=128, h=4, ffn=256, vocab=300, int8_head=True, seed=11),
], ids=["fixture_layout", "tiny", "int8_head"])
def test_synth_bytes_match_jax(kw):
    assert build_sanm_int8_model(**kw) == j_build(**kw)


def test_synth_default_is_the_fixture():
    assert build_sanm_int8_model() == (FIXTURES / "sensevoice.onnx").read_bytes()


def _attrs(node, parse):
    return {a.name: parse(a) for a in node.attribute}


def test_loader_reads_the_fixture_like_jax():
    path = FIXTURES / "sensevoice.onnx"
    got, want = OnnxModel.load(path), JOnnxModel.load(path)
    assert got.opset == want.opset
    assert got.input_info() == want.input_info()
    assert got.input_names() == want.input_names()
    assert got.output_names() == want.output_names()
    gn, wn = list(got.graph.node), list(want.graph.node)
    assert len(gn) == len(wn) > 200
    for g, w in zip(gn, wn):
        assert (g.op_type, g.name, g.domain) == (w.op_type, w.name, w.domain)
        assert list(g.input) == list(w.input) and list(g.output) == list(w.output)
        ga, wa = _attrs(g, parse_attr), _attrs(w, j_parse_attr)
        assert ga.keys() == wa.keys()
        for k in ga:
            np.testing.assert_array_equal(np.asarray(ga[k]), np.asarray(wa[k]))
    gi, wi = list(got.graph.initializer), list(want.graph.initializer)
    assert [t.name for t in gi] == [t.name for t in wi]
    for g, w in zip(gi, wi):
        ga, wa = tensor_to_array(g), j_tensor_to_array(w)
        assert ga.dtype == wa.dtype and ga.shape == wa.shape
        assert ga.tobytes() == wa.tobytes()


def test_loader_from_bytes_equals_load():
    path = FIXTURES / "sensevoice.onnx"
    a, b = OnnxModel.load(path), OnnxModel.from_bytes(path.read_bytes())
    assert [n.op_type for n in a.graph.node] == [n.op_type for n in b.graph.node]
    for x, y in zip(a.graph.initializer, b.graph.initializer):
        assert tensor_to_array(x).tobytes() == tensor_to_array(y).tobytes()


@pytest.mark.parametrize("data", [b"", b"\x08", b"\xff\xff\xff\xff"], ids=["empty", "cut", "junk"])
def test_loader_refuses_what_jax_refuses(data):
    with pytest.raises(ValueError):
        JOnnxModel.from_bytes(data)
    with pytest.raises(ValueError):
        OnnxModel.from_bytes(data)


# -- emitters ---------------------------------------------------------------

_RNG = np.random.default_rng(2026)


def _f32(*shape, scale=1.0):
    return (_RNG.standard_normal(shape) * scale).astype(np.float32)


def _case(op, inputs, n_out=1, **attrs):
    return (op, inputs, n_out, attrs)


INT_MAX = np.iinfo(np.int64).max
_mask = np.zeros((1, 1, 1, 40), np.float32)
_mask[..., 33:] = -1e4
EMITTER_CASES = {
    "Gather": _case("Gather", [_f32(16, 560), np.asarray([3, -1], np.int32)]),
    "Gather_axis1": _case("Gather", [_f32(2, 7, 5), np.asarray([[4, 0]], np.int64)], axis=1),
    "Unsqueeze": _case("Unsqueeze", [_f32(1, 560), np.asarray([1], np.int64)]),
    "Concat": _case("Concat", [_f32(1, 1, 56), _f32(1, 2, 56), _f32(1, 9, 56)], axis=1),
    "Shape": _case("Shape", [_f32(1, 40, 64)]),
    "Slice": _case("Slice", [_f32(1, 2048, 16), np.asarray([0], np.int64),
                             np.asarray([40], np.int64), np.asarray([1], np.int64)]),
    "Slice_negative_step": _case("Slice", [
        _f32(1, 37, 8), np.asarray([-3], np.int64), np.asarray([-INT_MAX], np.int64),
        np.asarray([1], np.int64), np.asarray([-2], np.int64)]),
    "Squeeze": _case("Squeeze", [_f32(1, 5, 1), np.asarray([0, 2], np.int64)]),
    "Cast_bool_f32": _case("Cast", [_RNG.standard_normal(40) > 0], to=1),
    "Cast_f32_i32": _case("Cast", [_f32(40, scale=30.0)], to=6),
    "Split": _case("Split", [_f32(1, 40, 96)], n_out=3, axis=2, num_outputs=3),
    "Split_sizes": _case("Split", [_f32(1, 40, 96), np.asarray([32, 32, 32], np.int64)],
                         n_out=3, axis=2),
    "Reshape": _case("Reshape", [_f32(1, 40, 64), np.asarray([1, -1, 4, 16], np.int64)]),
    "Transpose": _case("Transpose", [_f32(1, 40, 4, 16)], perm=[0, 2, 3, 1]),
    "Add": _case("Add", [_f32(1, 40, 64), _f32(64)]),
    "Sub": _case("Sub", [np.float32(1.0), (_RNG.random((1, 40)) > 0.2).astype(np.float32)]),
    "Mul": _case("Mul", [_f32(1, 4, 40, 40), np.float32(0.25)]),
    "MatMul": _case("MatMul", [_f32(1, 4, 40, 16), _f32(1, 4, 16, 40)]),
    "MatMul_embed": _case("MatMul", [_f32(1, 40, 560), _f32(560, 64, scale=0.04)]),
    "Range": _case("Range", [np.asarray(0, np.int64), np.asarray(40, np.int64),
                             np.asarray(1, np.int64)]),
    "Less": _case("Less", [np.arange(40, dtype=np.int64), np.asarray([33], np.int64)]),
    "LayerNormalization": _case("LayerNormalization",
                                [_f32(1, 40, 64), _f32(64), _f32(64)], epsilon=1e-5),
    "Conv_fsmn": _case("Conv", [_f32(1, 64, 40), _f32(64, 1, 11, scale=0.3)],
                       group=64, pads=[5, 5]),
    "Softmax": _case("Softmax", [_f32(1, 4, 1, 40) * 3 + _mask], axis=-1),
    "Relu": _case("Relu", [_f32(1, 40, 96)]),
    "DynamicQuantizeLinear": _case("DynamicQuantizeLinear", [_f32(1, 40, 64)], n_out=3),
    "MatMulInteger": _case("MatMulInteger", [
        _RNG.integers(0, 256, (1, 40, 64)).astype(np.uint8),
        _RNG.integers(0, 256, (64, 96)).astype(np.uint8),
        np.uint8(131), np.uint8(128)]),
}


def _proto_node(op, n_in, n_out, attrs):
    """The node as both loaders parse it from the same bytes."""
    ins = [f"i{k}" for k in range(n_in)]
    outs = [f"o{k}" for k in range(n_out)]
    data = ob.build_model_bytes(
        [ob.node(op, ins, outs, **attrs)],
        inputs=[ob.value_info(n, 1, []) for n in ins],
        outputs=[ob.value_info(n, 1, []) for n in outs])
    assert data == jb.build_model_bytes(
        [jb.node(op, ins, outs, **attrs)],
        inputs=[jb.value_info(n, 1, []) for n in ins],
        outputs=[jb.value_info(n, 1, []) for n in outs])
    return OnnxModel.from_bytes(data).graph.node[0], JOnnxModel.from_bytes(data).graph.node[0]


def _as_tuple(v):
    return v if isinstance(v, tuple) else (v,)


@pytest.mark.parametrize("case", list(EMITTER_CASES))
def test_emitter_matches_jax(case):
    op, inputs, n_out, attrs = EMITTER_CASES[case]
    node, jnode = _proto_node(op, len(inputs), n_out, attrs)
    opdef, jopdef = lookup_op("", op), j_lookup("", op)
    # dynamic arguments are device values (torch / jax arrays); shape and
    # axes arguments stay host-static, as each tracer hands them over
    t_in = [v if k in opdef.static_args else torch.from_numpy(np.array(v))
            for k, v in enumerate(inputs)]
    j_in = [v if k in jopdef.static_args else jnp.asarray(v) for k, v in enumerate(inputs)]
    got = _as_tuple(opdef.fn(make_ctx(torch, node, 17), *t_in))
    want = _as_tuple(jopdef.fn(j_make_ctx(jnp, jnode, 17), *j_in))
    assert len(got) == len(want) == n_out
    for g, w in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w)
        assert g.shape == w.shape, (g.shape, w.shape)
        if np.issubdtype(w.dtype, np.floating):
            assert g.dtype == w.dtype
            scale = float(np.abs(w).max()) if w.size else 0.0
            np.testing.assert_allclose(g, w, rtol=FLOAT_TOL, atol=FLOAT_TOL * scale)
        else:
            # integer widths differ (JAX keeps i64 as i32); values must not
            assert g.dtype.kind == w.dtype.kind or {g.dtype.kind, w.dtype.kind} <= {"i", "u"}
            np.testing.assert_array_equal(g, w)


def test_every_sanm_graph_op_has_an_emitter():
    """The SAN-M int8 graph (with an int8 head) needs the 22 emitters and no
    other."""
    m = OnnxModel.from_bytes(build_sanm_int8_model(L=1, d=64, h=2, ffn=96, vocab=40,
                                                   int8_head=True))
    ops = {n.op_type for n in m.graph.node}
    assert len(ops) == 22 and all(lookup_op("", o) is not None for o in ops)
    assert ops == {c[0] for c in EMITTER_CASES.values()}


def test_unknown_op_warns_and_strict_mode_raises(capsys):
    from lele_tpu_torch.compiler import compile_model

    data = ob.build_model_bytes(
        [ob.node("Relu", ["x"], ["r"]), ob.node("NoSuchOp", ["r"], ["y"])],
        inputs=[ob.value_info("x", 1, [2, 3])], outputs=[ob.value_info("y", 1, [2, 3])])
    cm = compile_model(data, device="cpu")
    out = cm.run_np(x=np.ones((2, 3), np.float32))[0]
    assert out.size == 0 and "unsupported op NoSuchOp" in capsys.readouterr().err
    with pytest.raises(NotImplementedError, match="NoSuchOp"):
        compile_model(data, device="cpu", strict=True)
