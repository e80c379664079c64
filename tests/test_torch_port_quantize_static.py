"""The port's static int8 quantization against the JAX package on the CPU:
`onnx/quantize.py`'s calibrate_minmax / quantize_static, ConvInteger, the
int4 DequantizeLinear cases of test_int4_fp8.py, the dynamic quantizer's
Conv rewrite,
and chip_smoke phase 37's two int8 ResNet-50 forms at a small width.

JAX's own test files run with their compile and quantize calls swapped for
stand-ins that run both packages on the same bytes (`Both`,
`_dual_quantizers`): the port's outputs go back to the JAX test's
assertions, and are held to JAX's first. Tolerances, each with its reason:

- calibrated ranges: 1e-5 relative (each package's f32 convs sum in its own
  order; measured 2.5e-7 at the small ResNet);
- the QDQ graphs both quantizers write: the same nodes, names, attributes
  and initializer names, types and shapes; the int8 weights equal; scales
  within the ranges' 1e-5, zero points within one code;
- outputs of one compiled graph: `OUT_REL` (1e-5 of max(1, max|ref|)), the
  JAX op tests' tolerance; integer outputs equal;
- the QOperator ResNet: every u8 tensor and the logits equal (integer
  products are exact on both sides and the requantizations the same f32
  steps), probs within 1e-6 (the softmax's exp).
"""

import importlib
import io
import sys
import types
from contextlib import redirect_stderr
from pathlib import Path

import numpy as np
import pytest
import torch

from lele_tpu.compiler import compile_model as j_compile
from lele_tpu.onnx import builder as jb
from lele_tpu.onnx import quantize as jq
from lele_tpu.onnx.loader import OnnxModel as JOnnxModel
from lele_tpu_torch.compiler import compile_model
from lele_tpu_torch.onnx import quantize as pq
from lele_tpu_torch.onnx import schema
from lele_tpu_torch.onnx.loader import tensor_to_array
from lele_tpu_torch.ops import quant_ops

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tests"))
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

RANGE_REL = 1e-5
OUT_REL = 1e-5
SMALL = dict(width=8, blocks=(1, 1, 1, 1), classes=10, img=32)


def _jax_run(bs, inputs):
    with redirect_stderr(io.StringIO()):
        return j_compile(JOnnxModel.from_bytes(bs), strict=False).run_np(**inputs)


def _hold(got, want, rel=OUT_REL):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape, (g.shape, w.shape)
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w)
        elif w.size:
            d = np.abs(g.astype(np.float64) - w).max()
            assert d <= rel * max(1.0, float(np.abs(w).max())), d


class Both:
    """compile_model's stand-in for a JAX test: the model (bytes, a path,
    or the bytes `_BytesModel.from_bytes` passed through) compiles in both
    packages; run_np returns the port's outputs, held to JAX's first."""

    def __init__(self, src, *a, **kw):
        self.bytes = src if isinstance(src, bytes) else Path(src).read_bytes()
        self.port = compile_model(self.bytes, device="cpu")
        with redirect_stderr(io.StringIO()):
            self.jax = j_compile(JOnnxModel.from_bytes(self.bytes))
        self.stats = self.port.stats

    def run_np(self, *args, **kw):
        got = self.port.run_np(*args, **kw)
        with redirect_stderr(io.StringIO()):
            want = self.jax.run_np(*args, **kw)
        _hold(got, want)
        return got


_BytesModel = types.SimpleNamespace(from_bytes=lambda bs, *a, **k: bs)


def _ranges_close(got: dict, want: dict):
    assert list(got) == list(want)
    for k in want:
        for a, b in zip(got[k], want[k]):
            assert abs(a - b) <= RANGE_REL * max(abs(b), 1e-30), (k, got[k], want[k])


def _same_qdq_graph(port: bytes, jax: bytes):
    """Both quantizers' graphs: the same nodes (op, inputs, outputs,
    attributes) and initializers (name, type, shape); int8 weights equal,
    scales within RANGE_REL, zero points within one code."""
    p, j = schema.decode_model(port).raw()["graph"], schema.decode_model(jax).raw()["graph"]
    assert [(n["op_type"], n["input"], n["output"], n.get("attribute", []))
            for n in p["node"]] == [(n["op_type"], n["input"], n["output"],
                                     n.get("attribute", [])) for n in j["node"]]
    assert [vi["name"] for vi in p.get("output", [])] == [vi["name"] for vi in j.get("output", [])]
    assert [t["name"] for t in p["initializer"]] == [t["name"] for t in j["initializer"]]
    for tp, tj in zip(p["initializer"], j["initializer"]):
        a = tensor_to_array(schema.Proto(tp, "TensorProto"))
        b = tensor_to_array(schema.Proto(tj, "TensorProto"))
        assert a.dtype == b.dtype and a.shape == b.shape, tp["name"]
        if "_scale__qs" in tp["name"]:  # an activation's, from its range
            np.testing.assert_allclose(a, b, rtol=RANGE_REL, atol=0)
        elif "_zp__qs" in tp["name"]:
            assert np.abs(a.astype(np.int64) - b).max() <= 1, tp["name"]
        else:
            np.testing.assert_array_equal(a, b, err_msg=tp["name"])


def _dual_quantizers(monkeypatch, mod):
    """The JAX test module's calibrate_minmax and quantize_static run both
    packages (the port's on the CPU) and give the port's result, held to
    JAX's first; its compile_model is `Both`."""

    def calibrate(data, batches, base_dir=None):
        batches = list(batches)
        got = pq.calibrate_minmax(data, batches, base_dir=base_dir, device="cpu")
        with redirect_stderr(io.StringIO()):
            _ranges_close(got, jq.calibrate_minmax(data, batches, base_dir=base_dir))
        return got

    def quantize(data, batches, op_types=("Conv", "MatMul", "Gemm"), per_channel=False,
                 base_dir=None):
        batches = list(batches)
        try:
            with redirect_stderr(io.StringIO()):
                want = jq.quantize_static(data, batches, op_types, per_channel, base_dir)
        except ValueError as e:
            with pytest.raises(ValueError, match="opset"):
                pq.quantize_static(data, batches, op_types, per_channel, base_dir, "cpu")
            raise e
        got = pq.quantize_static(data, batches, op_types, per_channel, base_dir, "cpu")
        _same_qdq_graph(got, want)
        return got

    monkeypatch.setattr(mod, "calibrate_minmax", calibrate)
    monkeypatch.setattr(mod, "quantize_static", quantize)
    monkeypatch.setattr(mod, "compile_model", Both)


QS_TESTS = ("test_calibrate_minmax_merges_and_includes_zero",
            "test_static_quant_structure_and_accuracy", "test_static_quant_oracle_exactness",
            "test_per_channel_conv_weights", "test_old_opset_refused")


@pytest.mark.parametrize("name", QS_TESTS)
def test_jax_quantize_static_test_on_the_port(monkeypatch, tmp_path, name):
    """tests/test_quantize_static.py's five tests (torch exports through
    the shim), the port's calibrate_minmax, quantize_static and compiler in
    JAX's place, judged by the JAX test's own assertions."""
    mod = importlib.import_module("test_quantize_static")
    assert set(QS_TESTS) == {n for n in vars(mod) if n.startswith("test_")}
    _dual_quantizers(monkeypatch, mod)
    fn = getattr(mod, name)
    fn(tmp_path) if "tmp_path" in fn.__code__.co_varnames[:fn.__code__.co_argcount] else fn()


@pytest.mark.parametrize("name", ["test_int4_dequantize_linear_compiles",
                                  "test_int4_blockwise_dequantize",
                                  "test_blockwise_qdq_roundtrip"])
def test_jax_int4_dequantize_test_on_the_port(monkeypatch, name):
    """tests/test_int4_fp8.py's three DequantizeLinear cases (int4 weights,
    blocked scales and int4 zero points, the blocked Q → DQ round trip):
    the port's outputs judged by the JAX test and held to JAX's."""
    mod = importlib.import_module("test_int4_fp8")
    monkeypatch.setattr(mod, "compile_model", Both)
    monkeypatch.setattr(mod, "OnnxModel", _BytesModel)
    getattr(mod, name)()


def test_quantize_static_on_the_small_resnet():
    """The QDQ form of chip_smoke's ResNet-50 graph at a small width
    (per-channel weights, phase 37's settings): the port's quantizer writes
    JAX's graph, and both compilers give the same outputs on it."""
    m, _ = chip_smoke.resnet50_model(batch=2, **SMALL)
    rng = np.random.default_rng(1)
    batches = [{"data": rng.standard_normal((2, 3, 32, 32)).astype(np.float32)}
               for _ in range(2)]
    got = pq.quantize_static(m, batches, per_channel=True, device="cpu")
    with redirect_stderr(io.StringIO()):
        want = jq.quantize_static(m, batches, per_channel=True)
    _same_qdq_graph(got, want)
    ops = [n.op_type for n in schema.decode_model(got).graph.node]
    assert ops.count("Conv") == 17 and ops.count("Gemm") == 1
    assert ops.count("DequantizeLinear") == ops.count("QuantizeLinear") + 18 > 18
    x = np.random.default_rng(2).standard_normal((2, 3, 32, 32)).astype(np.float32)
    cm = compile_model(got, device="cpu", strict=True)
    assert cm.stats["n_folded"] >= 18  # every weight's DequantizeLinear
    _hold(cm.run_np(data=x), _jax_run(got, {"data": x}))
    _hold(compile_model(want, device="cpu", strict=True).run_np(data=x),
          _jax_run(want, {"data": x}))


def test_qoperator_resnet_small_width_matches_jax():
    """chip_smoke.resnet50_qoperator_model at a small width, its grids from
    the port's calibrate_minmax of the folded float graph (which computes
    resnet50_model's function), through both compilers: every u8 tensor and
    the logits equal, TopK and ArgMax equal; the integer products the
    port's kernel-11 route on the CPU (the plain product)."""
    fold = chip_smoke.resnet50_folded_model(batch=2, **SMALL)
    x = np.random.default_rng(2).standard_normal((2, 3, 32, 32)).astype(np.float32)
    ref = compile_model(chip_smoke.resnet50_model(batch=2, **SMALL)[0],
                        device="cpu").run_np(data=x)[0]
    assert np.abs(compile_model(fold, device="cpu").run_np(data=x)[0] - ref).max() \
        <= 1e-5 * np.abs(ref).max()
    rng = np.random.default_rng(1)
    batches = [{"data": rng.standard_normal((2, 3, 32, 32)).astype(np.float32)}
               for _ in range(2)]
    ranges = pq.calibrate_minmax(fold, batches, device="cpu")
    with redirect_stderr(io.StringIO()):
        _ranges_close(ranges, jq.calibrate_minmax(fold, batches))
    qb, info = chip_smoke.resnet50_qoperator_model(ranges, batch=2, **SMALL)
    qb = chip_smoke.with_outputs(qb, info["u8"], 2)  # every u8 tensor
    cm = compile_model(qb, device="cpu", strict=True)
    assert cm.stats["capturable"]
    got, want = cm.run_np(data=x), _jax_run(qb, {"data": x})
    assert info["int8_products"] == 18 and len(info["u8"]) == len(got) - 5
    _hold([got[0]] + got[3:], [want[0]] + want[3:], rel=0.0)  # logits, indices, u8
    _hold(got[1:3], want[1:3], rel=1e-6)  # probs and their top 5
    assert all(g.dtype == np.uint8 for g in got[5:])
    # the quantized network tracks the float one: the argmax of both images
    np.testing.assert_array_equal(got[4], ref.argmax(1))


def _conv_graph(x, w, xzp, wzp, op="ConvInteger", **attrs):
    inits = {"w": w}
    names = ["x", "w"]
    for k, v in (("xz", xzp), ("wz", wzp)):
        if v is not None:
            inits[k] = v
        names.append(k if v is not None else "")
    while names and not names[-1]:
        names.pop()
    return jb.build_model_bytes(
        [jb.node(op, names, ["y"], **attrs)], [jb.vi_from_array("x", x)],
        [jb.value_info("y", 6, [])], [jb.tensor_from_array(v, k) for k, v in inits.items()],
        opset=17)


CONV_CASES = {
    "1-D u8 x, i8 w, pads, stride": ((1, 3, 11), (4, 3, 3), np.uint8, np.int8,
                                     dict(pads=[1, 2], strides=[2])),
    "2-D u8 x, u8 w, per-channel zp, group 2": ((2, 4, 7, 6), (6, 2, 3, 3), np.uint8, np.uint8,
                                                dict(group=2, pads=[1, 1, 0, 2])),
    "2-D i8 x, i8 w, dilation, SAME_UPPER": ((1, 3, 9, 8), (5, 3, 3, 2), np.int8, np.int8,
                                            dict(dilations=[2, 1], strides=[1, 2],
                                                 auto_pad="SAME_UPPER")),
    "2-D i8 x, u8 w, SAME_LOWER, depthwise": ((1, 4, 6, 6), (4, 1, 3, 3), np.int8, np.uint8,
                                              dict(group=4, auto_pad="SAME_LOWER")),
    "3-D u8 x, i8 w, VALID, dilation": ((1, 2, 5, 6, 7), (3, 2, 2, 2, 3), np.uint8, np.int8,
                                        dict(dilations=[1, 2, 1], auto_pad="VALID")),
}


def _ints(rng, shape, dt):
    info = np.iinfo(dt)
    return rng.integers(info.min, info.max + 1, shape).astype(dt)


@pytest.mark.parametrize("name", sorted(CONV_CASES))
@pytest.mark.parametrize("zps", ["none", "scalar", "per-channel"])
def test_conv_integer_matches_jax(name, zps):
    """ConvInteger (1-3 spatial dims, groups, strides, dilations, auto_pad,
    u8/i8 mixes, no / scalar / per-output-channel weight zero points)
    through both compilers: the same int32 outputs. The port's CPU route is
    the plain float64 convolution; the im2col route a card takes (kernel
    11's product, here its plain version, on the weight's prepared group
    matrices) gives the same integers."""
    xs, ws, xdt, wdt, attrs = CONV_CASES[name]
    rng = np.random.default_rng(sum(map(ord, name + zps)))
    x, w = _ints(rng, xs, xdt), _ints(rng, ws, wdt)
    xzp = None if zps == "none" else _ints(rng, (), xdt)
    wzp = {"none": None, "scalar": _ints(rng, (), wdt),
           "per-channel": _ints(rng, (ws[0],), wdt)}[zps]
    bs = _conv_graph(x, w, xzp, wzp, **attrs)
    got = compile_model(bs, device="cpu", strict=True).run_np(x=x)
    want = _jax_run(bs, {"x": x})
    _hold(got, want)
    assert got[0].dtype == np.int32
    # the card's algebra on the CPU: im2col + the plain i8 product
    from lele_tpu_torch.ops.registry import make_ctx
    ctx = make_ctx(torch, schema.decode_model(bs).graph.node[0], 17)
    geo = quant_ops.conv_geometry(ctx, xs, ws)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    tz = [torch.from_numpy(np.asarray(v)) if v is not None else None for v in (xzp, wzp)]
    wmat, colsum, wzp_i = quant_ops.conv_weight_i8(tw, tz[1], geo[3])
    i8 = quant_ops.conv_integer_i8(tx, tz[0], wmat, colsum, wzp_i, tuple(ws[2:]), geo)
    np.testing.assert_array_equal(i8.numpy(), want[0])


def test_conv_integer_plain_override_and_qlinear_conv_requant():
    """The plain override compiles to the default route's integers; a
    QLinearConv with a per-channel w_scale and int32 bias requantizes to
    JAX's codes."""
    rng = np.random.default_rng(9)
    x, w = _ints(rng, (2, 3, 8, 8), np.uint8), _ints(rng, (5, 3, 3, 3), np.int8)
    bs = _conv_graph(x, w, np.uint8(121), np.int8(2), pads=[1, 1, 1, 1])
    a = compile_model(bs, device="cpu", strict=True).run_np(x=x)[0]
    b = compile_model(bs, device="cpu", strict=True, overrides={
        "ConvInteger": quant_ops.conv_integer_plain}).run_np(x=x)[0]
    np.testing.assert_array_equal(a, b)
    inits = {"xs": np.float32(0.02), "xz": np.uint8(121), "w": w,
             "ws": (rng.random(5) * 0.01 + 0.002).astype(np.float32),
             "wz": np.zeros(5, np.int8), "ys": np.float32(0.05), "yz": np.uint8(7),
             "b": rng.integers(-3000, 3000, 5).astype(np.int32)}
    qb = jb.build_model_bytes(
        [jb.node("QLinearConv", ["x", "xs", "xz", "w", "ws", "wz", "ys", "yz", "b"], ["y"],
                 pads=[1, 1, 1, 1], strides=[2, 2])],
        [jb.vi_from_array("x", x)], [jb.value_info("y", 2, [])],
        [jb.tensor_from_array(v, k) for k, v in inits.items()])
    _hold(compile_model(qb, device="cpu", strict=True).run_np(x=x), _jax_run(qb, {"x": x}))


def test_quantize_dynamic_conv_compiles_to_jax():
    """quantize_dynamic with "Conv" (ConvInteger nodes on DynamicQuantize-
    Linear codes, the small ResNet): the port writes JAX's bytes, and its
    compiler, which refused ConvInteger before, gives JAX's outputs."""
    m, _ = chip_smoke.resnet50_model(batch=2, **SMALL)
    ops = ("MatMul", "Gemm", "Conv")
    got = pq.quantize_dynamic(m, op_types=ops)
    assert got == jq.quantize_dynamic(m, op_types=ops)
    assert [n.op_type for n in schema.decode_model(got).graph.node].count("ConvInteger") == 17
    x = np.random.default_rng(3).standard_normal((2, 3, 32, 32)).astype(np.float32)
    _hold(compile_model(got, device="cpu", strict=True).run_np(data=x), _jax_run(got, {"data": x}))
