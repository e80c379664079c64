"""The port's ONNX local functions and dynamic quantizer against the JAX
package's: onnx/functions.py `inline_functions`, onnx/quantize.py
`quantize_dynamic`, and the compile paths that inline before tracing
(compile_model, and the model wrappers' loader).

Counterparts, case for case, of tests/test_onnx_functions.py (a graph run
through both compilers, held to the JAX test's expected values at its
tolerance), tests/test_onnx_functions_torch.py (a torch export with
`export_modules_as_functions`), and tests/test_sanm_fuse_torch.py's three
tests on the port's quantizer. The quantizer's bytes equal JAX's for the same
input bytes, flat and function-packaged. The port's SAN-M kernel takes head
dims 32, 64 and 128, so its fusion cases run the JAX test's encoder at 2
heads of 32 (the JAX test's 4 heads of 16 take the per-op path here).
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
from lele_tpu.onnx import schema as jschema
from lele_tpu.onnx.functions import inline_functions as j_inline
from lele_tpu.onnx.loader import OnnxModel as JOnnxModel
from lele_tpu.onnx.quantize import quantize_dynamic as j_quantize
from lele_tpu_torch.compiler import compile_model
from lele_tpu_torch.onnx import OnnxModel, schema
from lele_tpu_torch.onnx import builder as ob
from lele_tpu_torch.onnx.functions import inline_functions, inline_model
from lele_tpu_torch.onnx.quantize import (
    quantize_dynamic,
    quantize_dynamic_file,
    quantize_weight_int8,
)

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tests"))
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402
import test_sanm_fuse_torch as jsanm  # noqa: E402
from test_onnx_functions_torch import Block, Net  # noqa: E402


def _both(m_dict, **inputs):
    """A model dict through JAX's compiler and the port's (device="cpu")."""
    bs = jb.serialize(m_dict)
    want = j_compile(JOnnxModel.from_bytes(bs)).run_np(**inputs)
    got = compile_model(bs, device="cpu").run_np(**inputs)
    return got, want


def _mk_model(nodes, inputs, outputs, functions, inits=()):
    return jb.model(jb.graph(nodes, "g", inputs, outputs, inits), functions=functions)


def _check(m, x, want, rtol=1e-6):
    got, jgot = _both(m, x=x)
    np.testing.assert_allclose(got[0], want, rtol=rtol)
    np.testing.assert_allclose(got[0], jgot[0], rtol=rtol)


# -- counterparts of tests/test_onnx_functions.py ----------------------------------------


def test_basic_call_and_repeat():
    sq = jb.function("Square", ["a"], ["b"],
                     [jb.node("Mul", ["a", "a"], ["tmp"]), jb.node("Identity", ["tmp"], ["b"])])
    m = _mk_model([jb.node("Square", ["x"], ["h"], domain="local"),
                   jb.node("Square", ["h"], ["y"], domain="local")],
                  [jb.value_info("x", 1, [3])], [jb.value_info("y", 1, [3])], [sq])
    x = np.array([1.0, 2.0, 3.0], dtype=np.float32)
    _check(m, x, x ** 4)


def test_nested_functions():
    inner = jb.function("Twice", ["a"], ["b"], [jb.node("Add", ["a", "a"], ["b"])])
    outer = jb.function("Quad", ["a"], ["b"],
                        [jb.node("Twice", ["a"], ["t"], domain="local"),
                         jb.node("Twice", ["t"], ["b"], domain="local")])
    m = _mk_model([jb.node("Quad", ["x"], ["y"], domain="local")],
                  [jb.value_info("x", 1, [2])], [jb.value_info("y", 1, [2])], [inner, outer])
    x = np.array([1.5, -2.0], dtype=np.float32)
    _check(m, x, 4 * x)


def test_ref_attr_forwarding_and_default():
    body = [jb.node("LeakyRelu", ["a"], ["b"])]
    body[0]["attribute"] = [jb.ref_attr("alpha", "slope", jschema.ATTR_FLOAT)]
    f = jb.function("MyLeaky", ["a"], ["b"], body, attributes=["slope"],
                    attribute_defaults={"slope": 0.5})
    m = _mk_model([jb.node("MyLeaky", ["x"], ["h"], domain="local", slope=0.25),
                   jb.node("MyLeaky", ["h"], ["y"], domain="local")],
                  [jb.value_info("x", 1, [4])], [jb.value_info("y", 1, [4])], [f])
    x = np.array([-4.0, -1.0, 0.0, 2.0], dtype=np.float32)
    h = np.where(x < 0, 0.25 * x, x)
    _check(m, x, np.where(h < 0, 0.5 * h, h))


def test_ref_attr_absent_uses_op_default():
    body = [jb.node("LeakyRelu", ["a"], ["b"])]
    body[0]["attribute"] = [jb.ref_attr("alpha", "slope", jschema.ATTR_FLOAT)]
    f = jb.function("MyLeaky", ["a"], ["b"], body, attributes=["slope"])
    m = _mk_model([jb.node("MyLeaky", ["x"], ["y"], domain="local")],
                  [jb.value_info("x", 1, [2])], [jb.value_info("y", 1, [2])], [f])
    x = np.array([-1.0, 1.0], dtype=np.float32)
    _check(m, x, np.where(x < 0, 0.01 * x, x), rtol=1e-5)


def test_call_inside_if_branch():
    dbl = jb.function("Dbl", ["a"], ["b"], [jb.node("Add", ["a", "a"], ["b"])])
    then_g = jb.graph([jb.node("Dbl", ["x"], ["tb"], domain="local")], "then", [],
                      [jb.value_info("tb", 1, [2])])
    else_g = jb.graph([jb.node("Neg", ["x"], ["eb"])], "else", [],
                      [jb.value_info("eb", 1, [2])])
    m = _mk_model([jb.node("If", ["cond"], ["y"], then_branch=then_g, else_branch=else_g)],
                  [jb.value_info("x", 1, [2])], [jb.value_info("y", 1, [2])], [dbl],
                  inits=[jb.tensor_from_array(np.array(True), "cond")])
    x = np.array([3.0, -1.0], dtype=np.float32)
    _check(m, x, 2 * x)


def test_subgraph_in_body_captures_local():
    then_g = jb.graph([jb.node("Identity", ["loc"], ["tb"])], "then", [],
                      [jb.value_info("tb", 1, [2])])
    else_g = jb.graph([jb.node("Neg", ["loc"], ["eb"])], "else", [],
                      [jb.value_info("eb", 1, [2])])
    body = [jb.node("Add", ["a", "a"], ["loc"]),
            jb.node("If", ["flag"], ["b"], then_branch=then_g, else_branch=else_g)]
    f = jb.function("CapIf", ["a", "flag"], ["b"], body)
    m = _mk_model([jb.node("CapIf", ["x", "t"], ["p"], domain="local"),
                   jb.node("CapIf", ["x", "f"], ["q"], domain="local"),
                   jb.node("Sub", ["p", "q"], ["y"])],
                  [jb.value_info("x", 1, [2])], [jb.value_info("y", 1, [2])], [f],
                  inits=[jb.tensor_from_array(np.array(True), "t"),
                         jb.tensor_from_array(np.array(False), "f")])
    x = np.array([1.0, 4.0], dtype=np.float32)
    _check(m, x, 4 * x)


def test_ref_attr_inside_body_subgraph():
    leaky = jb.node("LeakyRelu", ["a"], ["tb"])
    leaky["attribute"] = [jb.ref_attr("alpha", "slope", jschema.ATTR_FLOAT)]
    then_g = jb.graph([leaky], "then", [], [jb.value_info("tb", 1, [2])])
    else_g = jb.graph([jb.node("Neg", ["a"], ["eb"])], "else", [],
                      [jb.value_info("eb", 1, [2])])
    f = jb.function("DeepLeaky", ["a", "flag"], ["b"],
                    [jb.node("If", ["flag"], ["b"], then_branch=then_g, else_branch=else_g)],
                    attributes=["slope"])
    m = _mk_model([jb.node("DeepLeaky", ["x", "t"], ["y"], domain="local", slope=0.125)],
                  [jb.value_info("x", 1, [2])], [jb.value_info("y", 1, [2])], [f],
                  inits=[jb.tensor_from_array(np.array(True), "t")])
    x = np.array([-8.0, 2.0], dtype=np.float32)
    _check(m, x, np.where(x < 0, 0.125 * x, x))


def test_default_domain_function_does_not_shadow_builtin():
    evil = jb.function("Relu", ["a"], ["b"], [jb.node("Neg", ["a"], ["b"])], domain="")
    m = _mk_model([jb.node("Relu", ["x"], ["y"])], [jb.value_info("x", 1, [2])],
                  [jb.value_info("y", 1, [2])], [evil])
    x = np.array([-1.0, 2.0], dtype=np.float32)
    _check(m, x, np.maximum(x, 0.0))


def test_default_domain_function_without_kernel_inlines():
    f = jb.function("MyBlock", ["a"], ["b"], [jb.node("Add", ["a", "a"], ["b"])], domain="")
    m = _mk_model([jb.node("MyBlock", ["x"], ["y"])], [jb.value_info("x", 1, [2])],
                  [jb.value_info("y", 1, [2])], [f])
    x = np.array([1.0, -2.0], dtype=np.float32)
    _check(m, x, 2 * x)


def test_function_opset_mismatch_rejected():
    f = jb.function("Old", ["a"], ["b"], [jb.node("Add", ["a", "a"], ["b"])], opset=12)
    m = _mk_model([jb.node("Old", ["x"], ["y"], domain="local")],
                  [jb.value_info("x", 1, [2])], [jb.value_info("y", 1, [2])], [f])
    with pytest.raises(NotImplementedError, match="opset") as err:
        compile_model(jb.serialize(m), device="cpu")
    with pytest.raises(NotImplementedError) as jerr:
        j_compile(JOnnxModel.from_bytes(jb.serialize(m)))
    assert str(err.value) == str(jerr.value)


def test_recursive_function_rejected():
    f = jb.function("Loopy", ["a"], ["b"], [jb.node("Loopy", ["a"], ["b"], domain="local")])
    m = _mk_model([jb.node("Loopy", ["x"], ["y"], domain="local")],
                  [jb.value_info("x", 1, [2])], [jb.value_info("y", 1, [2])], [f])
    with pytest.raises(ValueError, match="recursive"):
        compile_model(jb.serialize(m), device="cpu")


def test_wire_roundtrip_preserves_functions():
    """The port's builder writes JAX's bytes, and its schema reads them back."""
    def build(b, s):
        f = b.function("Sq", ["a"], ["b"], [b.node("Mul", ["a", "a"], ["b"])],
                       attributes=["k"], attribute_defaults={"k": 2})
        return b.serialize(b.model(b.graph([b.node("Sq", ["x"], ["y"], domain="local")], "g",
                                           [b.value_info("x", 1, [2])],
                                           [b.value_info("y", 1, [2])]), functions=[f]))

    data = build(ob, schema)
    assert data == build(jb, jschema)
    fns = schema.decode_model(data).functions
    assert len(fns) == 1
    assert fns[0].name == "Sq" and fns[0].domain == "local"
    assert list(fns[0].input) == ["a"] and list(fns[0].output) == ["b"]
    assert [a.name for a in fns[0].attribute_proto] == ["k"]
    assert fns[0].node[0].op_type == "Mul"


# -- the port's own: inlining inside loop bodies, raw equality, front doors -----------------


def _fn_in_loop_and_scan_model():
    dbl = jb.function("Dbl", ["a"], ["b"], [jb.node("Add", ["a", "a"], ["b"])])
    loop_body = jb.graph(
        [jb.node("Dbl", ["v_in"], ["v_out"], domain="local"),
         jb.node("Identity", ["cond_in"], ["cond_out"])],
        "lbody", [jb.value_info("i", 7, []), jb.value_info("cond_in", 9, []),
                  jb.value_info("v_in", 1, [2])],
        [jb.value_info("cond_out", 9, []), jb.value_info("v_out", 1, [2])])
    scan_body = jb.graph(
        [jb.node("Dbl", ["x_t"], ["d"], domain="local"), jb.node("Add", ["s_in", "d"], ["s_out"])],
        "sbody", [jb.value_info("s_in", 1, [2]), jb.value_info("x_t", 1, [2])],
        [jb.value_info("s_out", 1, [2]), jb.value_info("d", 1, [2])])
    nodes = [jb.node("Loop", ["M", "", "x"], ["y"], body=loop_body),
             jb.node("Scan", ["x", "xs"], ["s", "ds"], body=scan_body, num_scan_inputs=1)]
    return _mk_model(nodes, [jb.value_info("x", 1, [2]), jb.value_info("xs", 1, [3, 2])],
                     [jb.value_info("y", 1, [2]), jb.value_info("s", 1, [2]),
                      jb.value_info("ds", 1, [3, 2])],
                     [dbl], inits=[jb.tensor_from_array(np.array(3, np.int64), "M")])


def test_calls_inside_loop_and_scan_bodies_inline():
    m = _fn_in_loop_and_scan_model()
    x = np.array([1.0, -2.0], np.float32)
    xs = np.arange(6, dtype=np.float32).reshape(3, 2)
    bs = jb.serialize(m)
    got = compile_model(bs, device="cpu").run_np(x=x, xs=xs)
    want = j_compile(JOnnxModel.from_bytes(bs)).run_np(x=x, xs=xs)
    np.testing.assert_allclose(got[0], 8 * x, rtol=1e-6)
    np.testing.assert_allclose(got[1], x + 2 * xs.sum(0), rtol=1e-6)
    np.testing.assert_allclose(got[2], 2 * xs, rtol=1e-6)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-6)


@pytest.mark.parametrize("case", ["nested", "loop_scan", "torch_export"])
def test_inline_functions_gives_jax_s_graph(case):
    """The inlined model dict, encoded, is JAX's byte for byte."""
    if case == "nested":
        inner = jb.function("Twice", ["a"], ["b"], [jb.node("Add", ["a", "a"], ["b"])])
        outer = jb.function("Quad", ["a"], ["b"], [jb.node("Twice", ["a"], ["t"], domain="local"),
                                                    jb.node("Twice", ["t"], ["b"], domain="local")])
        data = jb.serialize(_mk_model([jb.node("Quad", ["x"], ["y"], domain="local")],
                                      [jb.value_info("x", 1, [2])],
                                      [jb.value_info("y", 1, [2])], [inner, outer]))
    elif case == "loop_scan":
        data = jb.serialize(_fn_in_loop_and_scan_model())
    else:
        data = _net_export(functions=True)
    got = schema.encode_message(inline_functions(schema.decode_model(data).raw()), "ModelProto")
    want = jschema.encode_message(j_inline(jschema.decode_model(data).raw()), "ModelProto")
    assert got == want
    assert not schema.decode_model(got).functions


def test_model_wrappers_inline_before_tracing():
    """SileroOnnx takes a function-packaged model: the loader inlines (its
    step's If wrapped in a local function gives the fixture's bits)."""
    from lele_tpu_torch.models import SileroOnnx

    raw = schema.decode_model((ROOT / "fixtures" / "silero.onnx").read_bytes()).raw()
    g = raw["graph"]
    # the weights are the function's formals too: its body sees no graph names
    names = [vi["name"] for vi in g["input"]] + [t["name"] for t in g["initializer"]]
    outs = [vi["name"] for vi in g["output"]]
    f = ob.function("Step", names, outs, g["node"], domain="local")
    packed = dict(raw)
    packed["graph"] = dict(g, node=[ob.node("Step", names, outs, domain="local")])
    packed["functions"] = [f]
    packed["opset_import"] = list(raw["opset_import"]) + [{"domain": "local", "version": 1}]
    data = schema.encode_message(packed, "ModelProto")
    assert schema.decode_model(data).functions
    pcm = chip_smoke.vad_pcm(0.5, 16000, np.random.default_rng(3))
    got = SileroOnnx(data, device="cpu").speech_probs(pcm, 16000)
    want = SileroOnnx(chip_smoke.SILERO_FIXTURE, device="cpu").speech_probs(pcm, 16000)
    np.testing.assert_array_equal(got, want)
    assert inline_model(OnnxModel.from_bytes(data)).model.functions == []


# -- counterpart of tests/test_onnx_functions_torch.py ------------------------------------


def _net_export(functions: bool) -> bytes:
    from lele_tpu_torch.onnx.torch_shim import install

    install()
    torch.manual_seed(0)
    m = Net().eval()
    buf = io.BytesIO()
    kw = {"export_modules_as_functions": {Block}} if functions else {}
    with torch.no_grad():
        torch.onnx.export(m, (torch.randn(3, 16),), buf, opset_version=17, dynamo=False,
                          input_names=["x"], **kw)
    return buf.getvalue()


def test_torch_module_functions_compile():
    torch.manual_seed(0)
    m = Net().eval()
    x = torch.randn(3, 16)
    with torch.no_grad():
        want = m(x).numpy()
    data = _net_export(functions=True)
    dec = schema.decode_model(data)
    assert dec.functions and any(len(f.node) > 1 for f in dec.functions)
    calls = [n for n in dec.graph.node if (n.domain or "") not in ("", "ai.onnx", "ai.onnx.ml")]
    assert len(calls) >= 2
    got = compile_model(data, device="cpu").run_np(x=x.numpy())[0]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    jgot = j_compile(JOnnxModel.from_bytes(data)).run_np(x=x.numpy())[0]
    np.testing.assert_allclose(got, jgot, rtol=1e-4, atol=1e-5)


# -- quantize_dynamic ------------------------------------------------------------------------


def test_quantize_weight_int8_is_jax_s():
    from lele_tpu.onnx.quantize import quantize_weight_int8 as j_qw

    w = np.random.default_rng(4).standard_normal((37, 19)).astype(np.float32)
    for a in (w, np.zeros((3, 2), np.float32)):
        (q, s), (jq, js) = quantize_weight_int8(a), j_qw(a)
        assert s == js and q.dtype == np.int8
        np.testing.assert_array_equal(q, jq)


def _gemm_graph():
    """MatMul and Gemm(transB) sharing one weight, a Constant-node weight, a
    float product of two activations, and Conv (with bias) for op_types."""
    rng = np.random.default_rng(9)
    w = rng.standard_normal((8, 8)).astype(np.float32)
    cw = rng.standard_normal((4, 2, 3)).astype(np.float32)
    nodes = [jb.node("MatMul", ["x", "w"], ["a"]),
             jb.node("Gemm", ["x", "w", "b"], ["g"], transB=1),
             jb.node("Constant", [], ["wc"], value=rng.standard_normal((8, 8)).astype(np.float32)),
             jb.node("MatMul", ["a", "wc"], ["c"]),
             jb.node("MatMul", ["a", "g"], ["p"]),
             jb.node("Conv", ["img", "cw", "cb"], ["k"], pads=[1, 1])]
    inits = [jb.tensor_from_array(w, "w"), jb.tensor_from_array(np.ones(8, np.float32), "b"),
             jb.tensor_from_array(cw, "cw"), jb.tensor_from_array(np.ones(4, np.float32), "cb")]
    return jb.build_model_bytes(nodes, [jb.value_info("x", 1, [8, 8]),
                                        jb.value_info("img", 1, [1, 2, 5])],
                                [jb.value_info(o, 1, []) for o in ("c", "p", "g", "k")], inits)


@pytest.mark.parametrize("op_types", [("MatMul", "Gemm"), ("MatMul", "Gemm", "Conv")],
                         ids=["default", "conv"])
def test_quantize_dynamic_bytes_equal_jax_s(op_types, tmp_path):
    data = _gemm_graph()
    got = quantize_dynamic(data, op_types=op_types)
    assert got == j_quantize(data, op_types=op_types)
    ops = [n.op_type for n in schema.decode_model(got).graph.node]
    assert ops.count("DynamicQuantizeLinear") == (3 if "Conv" in op_types else 2)
    assert ("ConvInteger" in ops) == ("Conv" in op_types) and ops.count("MatMul") == 1
    src, dst = tmp_path / "f.onnx", tmp_path / "q.onnx"
    src.write_bytes(data)
    quantize_dynamic_file(str(src), str(dst))
    assert dst.read_bytes() == quantize_dynamic(data)


def test_quantize_dynamic_refuses_old_opsets_and_external_data():
    old = jb.build_model_bytes([jb.node("MatMul", ["x", "w"], ["y"])],
                               [jb.value_info("x", 1, [2, 2])], [jb.value_info("y", 1, [])],
                               [jb.tensor_from_array(np.eye(2, dtype=np.float32), "w")],
                               opset=10)
    with pytest.raises(ValueError, match="opset >= 11"):
        quantize_dynamic(old)
    ext = jb.build_model_bytes([jb.node("MatMul", ["x", "w"], ["y"])],
                               [jb.value_info("x", 1, [2, 2])], [jb.value_info("y", 1, [])],
                               [jb.tensor_external(np.eye(2, dtype=np.float32), "w", "w.bin", 0)])
    with pytest.raises(ValueError, match="external data"):
        quantize_dynamic(ext)


# -- counterparts of tests/test_sanm_fuse_torch.py on the port's quantizer --------------------


SANM_HEADS = 2  # head dim 32: one the port's SAN-M kernel compiles


def _sanm_export(seed, n_layers, functions, heads=SANM_HEADS, tail=6):
    layer, encoder = chip_smoke.sanm_modules(jsanm.T, jsanm.D, heads, jsanm.FFN, jsanm.K)
    torch.manual_seed(seed)
    m = encoder(n_layers).eval()
    x = torch.randn(1, jsanm.T, jsanm.D)
    attn_bias = torch.zeros(1, 1, 1, jsanm.T)
    vmask = torch.ones(1, 1, jsanm.T)
    if tail:
        attn_bias[..., jsanm.T - tail:] = -1e4  # the padded tail masked out
        vmask[..., jsanm.T - tail:] = 0.0
    data = chip_smoke.sanm_export(m, layer, (x, attn_bias, vmask), functions)
    with torch.no_grad():
        want = m(x, attn_bias, vmask).numpy()
    return data, (x.numpy(), attn_bias.numpy(), vmask.numpy()), want


def _run(data, args, patterns=None):
    cm = compile_model(data, device="cpu", patterns=patterns)
    return cm.run_np(*args)[0], cm.stats["pattern_hits"]


def _jax_per_op(data, args, monkeypatch):
    """JAX's compile_model of the same bytes on its per-op path (the JAX
    test's LELE_SANM_FUSE=0 run)."""
    monkeypatch.setenv("LELE_SANM_FUSE", "0")
    cm = j_compile(JOnnxModel.from_bytes(data))
    assert "sanm_fused_layers" not in cm.stats["pattern_hits"]
    return np.asarray(cm.run_np(*args)[0])


def test_sanm_copy_exports_the_jax_test_module():
    """chip_smoke's SAN-M layer (the card's full-width encoder) is the JAX
    test's module: the same seed gives the same export bytes."""
    torch.manual_seed(11)
    jm = jsanm.SanmEncoder().eval()
    layer, encoder = chip_smoke.sanm_modules(jsanm.T, jsanm.D, jsanm.H, jsanm.FFN, jsanm.K)
    torch.manual_seed(11)
    m = encoder(jsanm.L).eval()
    args = (torch.randn(1, jsanm.T, jsanm.D), torch.zeros(1, 1, 1, jsanm.T),
            torch.ones(1, 1, jsanm.T))
    assert (chip_smoke.sanm_export(m, layer, args, False)
            == chip_smoke.sanm_export(jm, jsanm.SanmLayer, args, False))


def test_torch_exported_encoder_fuses_with_parity(monkeypatch):
    """The port's per-op and fused runs of the quantized export, each held to
    JAX's per-op run of the same bytes at the JAX test's fused-vs-per-op
    gate."""
    data, args, want_float = _sanm_export(11, jsanm.L, functions=False)
    qdata = quantize_dynamic(data)
    assert qdata == j_quantize(data)
    per_op, hits0 = _run(qdata, args, patterns=[])
    assert "sanm_fused_layers" not in hits0
    fused, hits1 = _run(qdata, args)
    assert hits1.get("sanm_fused_layers", 0) == jsanm.L, hits1
    np.testing.assert_allclose(fused, per_op, atol=2e-3, rtol=0)
    jper_op = _jax_per_op(qdata, args, monkeypatch)
    np.testing.assert_allclose(per_op, jper_op, atol=2e-3, rtol=0)
    np.testing.assert_allclose(fused, jper_op, atol=2e-3, rtol=0)
    assert np.abs(per_op - want_float).mean() < 0.03


def test_torch_export_unquantized_bails_cleanly():
    """The float export (the JAX test's 4 heads) has no DQL chains: the
    matcher bails to the per-op path, which agrees with torch and JAX."""
    data, args, want = _sanm_export(12, 1, functions=False, heads=jsanm.H, tail=0)
    out, hits = _run(data, args)
    assert "sanm_fused_layers" not in hits
    np.testing.assert_allclose(out, want, atol=5e-4, rtol=1e-4)
    jout = j_compile(JOnnxModel.from_bytes(data)).run_np(*args)[0]
    np.testing.assert_allclose(out, jout, atol=5e-4, rtol=1e-4)


def test_function_packaged_export_fuses(monkeypatch):
    """Each layer a local function: quantize_dynamic inlines (the MatMuls sit
    in function bodies), its bytes are JAX's, both layers fuse, the port's
    runs agree with JAX's per-op run of the same bytes, and the output is bit
    for bit the flat export's quantized the same way, which JAX's per-op run
    of the flat bytes also agrees with."""
    data, args, want_float = _sanm_export(13, jsanm.L, functions=True, tail=0)
    assert schema.decode_model(data).functions, "export not function-packaged"
    qdata = quantize_dynamic(data)
    assert qdata == j_quantize(data)
    per_op, hits0 = _run(qdata, args, patterns=[])
    fused, hits1 = _run(qdata, args)
    assert hits1.get("sanm_fused_layers", 0) == jsanm.L, hits1
    np.testing.assert_allclose(fused, per_op, atol=2e-3, rtol=0)
    jper_op = _jax_per_op(qdata, args, monkeypatch)
    np.testing.assert_allclose(per_op, jper_op, atol=2e-3, rtol=0)
    np.testing.assert_allclose(fused, jper_op, atol=2e-3, rtol=0)
    assert np.abs(per_op - want_float).mean() < 0.03
    flat, _, _ = _sanm_export(13, jsanm.L, functions=False, tail=0)
    qflat = quantize_dynamic(flat)
    np.testing.assert_array_equal(fused, _run(qflat, args)[0])
    with redirect_stderr(io.StringIO()):
        jflat = j_quantize(flat)
    assert qflat == jflat
    np.testing.assert_allclose(fused, _jax_per_op(qflat, args, monkeypatch), atol=2e-3, rtol=0)
