"""The port's loader and builder on external data, 4-bit, fp8 and string
tensors, against the JAX package's loader and builder: every case of JAX's
tests/test_external_data.py and tests/test_int4_fp8.py replayed.

- Side files: resolution against the model's directory, offsets in one
  shared file, Constant attributes through the tracer's `base_dir_scope`,
  `save_with_external_data` (JAX's model bytes and JAX's side file),
  `quantize_dynamic` writing a self-contained model (JAX's bytes), a side
  file rewritten in place, and each of JAX's rejections (same exception
  type, same message).
- 4-bit tensors: `tensor_int4`'s bytes, signed and unsigned, odd counts, a
  side file, a truncated payload. The graphs of JAX's DequantizeLinear cases
  give JAX's bytes and initializers; their compile waits for the port's
  QuantizeLinear / DequantizeLinear emitters (the ai.onnx quant set).
- fp8 (17-20): ml_dtypes' values where it is installed, and, as on the card
  machine (no ml_dtypes), the uint8 bits in `Fp8Bits`; either reaches the
  device as a torch float8 tensor and a Cast of it runs to JAX's output.
- STRING tensors: object arrays of str, JAX's bytes.
"""

import os

import numpy as np
import pytest
import torch

from lele_tpu.compiler import compile_model as jcompile
from lele_tpu.onnx import OnnxModel as JOnnxModel
from lele_tpu.onnx import builder as jb
from lele_tpu.onnx.loader import tensor_to_array as j_tensor_to_array
from lele_tpu.onnx.schema import Proto
from lele_tpu_torch.compiler import compile_model
from lele_tpu_torch.onnx import OnnxModel
from lele_tpu_torch.onnx import builder as ob
from lele_tpu_torch.onnx import loader
from lele_tpu_torch.onnx.loader import Fp8Bits, Int4Array, tensor_to_array

ml_dtypes = pytest.importorskip("ml_dtypes")


def _matmul_bytes(b, w_tensor, extra_inits=()):
    return b.build_model_bytes([b.node("MatMul", ["x", "w"], ["y"])],
                               inputs=[b.value_info("x", 1, [2, 3])],
                               outputs=[b.value_info("y", 1, [2, 4])],
                               initializers=[w_tensor, *extra_inits])


def _both_from_path(p, **inputs):
    want = jcompile(JOnnxModel.load(p)).run_np(**inputs)
    got = compile_model(str(p), device="cpu").run_np(**inputs)
    return [np.asarray(w) for w in want], got


# ------------------------------------------------------------- side files


def test_external_matmul_end_to_end(tmp_path):
    rng = np.random.default_rng(0)
    w = rng.standard_normal((3, 4)).astype(np.float32)
    x = rng.standard_normal((2, 3)).astype(np.float32)
    (tmp_path / "w.bin").write_bytes(w.tobytes())
    ext = _matmul_bytes(ob, ob.tensor_external(w, "w", "w.bin", 0))
    assert ext == _matmul_bytes(jb, jb.tensor_external(w, "w", "w.bin", 0))
    p = tmp_path / "m.onnx"
    p.write_bytes(ext)
    assert OnnxModel.load(p).base_dir == str(tmp_path)
    want, got = _both_from_path(p, x=x)
    inline = compile_model(_matmul_bytes(ob, ob.tensor_from_array(w, "w")),
                           device="cpu").run_np(x=x)
    np.testing.assert_array_equal(got[0], inline[0])
    np.testing.assert_array_equal(got[0], want[0])


def test_shared_side_file_offsets(tmp_path):
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    b = np.arange(100, 112, dtype=np.float32).reshape(3, 4)
    (tmp_path / "pack.data").write_bytes(a.tobytes() + b.tobytes())
    bs = _matmul_bytes(ob, ob.tensor_external(b, "b", "pack.data", a.nbytes),
                       [ob.tensor_external(a, "a", "pack.data", 0)])
    m = OnnxModel.from_bytes(bs, base_dir=tmp_path)
    jm = JOnnxModel.from_bytes(bs, base_dir=tmp_path)
    assert m.base_dir == jm.base_dir == str(tmp_path)
    for name, want in (("a", a), ("b", b)):
        np.testing.assert_array_equal(m.initializer_array(name), want)
        np.testing.assert_array_equal(m.initializer_array(name), jm.initializer_array(name))


@pytest.mark.parametrize("from_path", [True, False])
def test_constant_node_attribute_external(tmp_path, from_path):
    """A Constant whose value lives in a side file resolves through the
    tracer's base_dir scope: from the model's path, or the base_dir given to
    `from_bytes`."""
    c = np.full((2, 3), 2.5, dtype=np.float32)
    (tmp_path / "c.bin").write_bytes(c.tobytes())

    def graph(b):
        return b.build_model_bytes(
            [b.node("Constant", [], ["c"], value=b.tensor_external(c, "", "c.bin", 0)),
             b.node("Add", ["x", "c"], ["y"])],
            inputs=[b.value_info("x", 1, [2, 3])], outputs=[b.value_info("y", 1, [2, 3])])

    bs = graph(ob)
    assert bs == graph(jb)
    x = np.ones((2, 3), dtype=np.float32)
    p = tmp_path / "m.onnx"
    p.write_bytes(bs)
    model = str(p) if from_path else OnnxModel.from_bytes(bs, base_dir=tmp_path)
    got = compile_model(model, device="cpu").run_np(x=x)[0]
    want = jcompile(JOnnxModel.load(p)).run_np(x=x)[0]
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got, x + c)


def test_save_with_external_data_roundtrip(tmp_path):
    """Initializers above the threshold land in <model>.data (JAX's file,
    byte for byte), small ones stay inline, and the model runs from disk."""
    rng = np.random.default_rng(1)
    w = rng.standard_normal((3, 4)).astype(np.float32)  # 48 B > threshold
    bias = np.ones(2, np.float32)  # 8 B, stays inline

    def raw(b):
        return {"ir_version": 8,
                "graph": {"node": [b.node("MatMul", ["x", "w"], ["y"])], "name": "g",
                          "input": [b.value_info("x", 1, [2, 3])],
                          "output": [b.value_info("y", 1, [2, 4])],
                          "initializer": [b.tensor_from_array(w, "w"),
                                          b.tensor_from_array(bias, "bias")]},
                "opset_import": [{"domain": "", "version": 17}]}

    (tmp_path / "j").mkdir()
    ob.save_with_external_data(raw(ob), tmp_path / "m.onnx", size_threshold=16)
    jb.save_with_external_data(raw(jb), tmp_path / "j" / "m.onnx", size_threshold=16)
    for name in ("m.onnx", "m.onnx.data"):
        assert (tmp_path / name).read_bytes() == (tmp_path / "j" / name).read_bytes()
    m = OnnxModel.load(tmp_path / "m.onnx")
    assert int(m.initializers["w"].data_location) == 1
    assert int(m.initializers["bias"].data_location) != 1
    x = rng.standard_normal((2, 3)).astype(np.float32)
    want, got = _both_from_path(tmp_path / "m.onnx", x=x)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[0], x @ w, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("form", ["initializers", "constant_node"])
def test_quantizer_consolidates_external(tmp_path, form):
    """quantize_dynamic on a model whose weights are external writes a
    self-contained model, JAX's bytes, that runs from another directory."""
    from lele_tpu.onnx.quantize import quantize_dynamic as j_quantize
    from lele_tpu_torch.onnx.quantize import quantize_dynamic, quantize_dynamic_file

    rng = np.random.default_rng(2)
    w = rng.standard_normal((8, 8)).astype(np.float32)
    gamma = rng.standard_normal((8,)).astype(np.float32)  # stays float
    if form == "initializers":
        (tmp_path / "m.data").write_bytes(w.tobytes() + gamma.tobytes())
        inits = [jb.tensor_external(w, "w", "m.data", 0),
                 jb.tensor_external(gamma, "gamma", "m.data", w.nbytes)]
        pre = []
    else:
        (tmp_path / "c.data").write_bytes(gamma.tobytes())
        inits = [jb.tensor_from_array(w, "w")]
        pre = [jb.node("Constant", [], ["gamma"],
                       value=jb.tensor_external(gamma, "", "c.data", 0))]
    bs = jb.build_model_bytes(
        pre + [jb.node("MatMul", ["x", "w"], ["h"]), jb.node("Mul", ["h", "gamma"], ["y"])],
        inputs=[jb.value_info("x", 1, [2, 8])], outputs=[jb.value_info("y", 1, [2, 8])],
        initializers=inits)
    qdata = quantize_dynamic(bs, base_dir=tmp_path)
    assert qdata == j_quantize(bs, base_dir=tmp_path)
    src = tmp_path / "m.onnx"
    src.write_bytes(bs)
    other = tmp_path / "elsewhere"
    other.mkdir()
    quantize_dynamic_file(str(src), str(other / "m.int8.onnx"))
    assert (other / "m.int8.onnx").read_bytes() == qdata
    qm = OnnxModel.load(other / "m.int8.onnx")
    assert all(int(t.data_location) != 1 for t in qm.initializers.values())
    x = rng.standard_normal((2, 8)).astype(np.float32)
    want, got = _both_from_path(other / "m.int8.onnx", x=x)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6, atol=1e-6)
    assert np.abs(got[0] - (x @ w) * gamma).max() < 0.1  # the int8 grid's error


def test_side_file_rewrite_not_stale(tmp_path):
    w1 = np.full((2, 2), 1.0, np.float32)
    w2 = np.full((2, 2), 9.0, np.float32)
    side = tmp_path / "w.bin"
    side.write_bytes(w1.tobytes())
    t = Proto(ob.tensor_external(w1, "w", "w.bin", 0), "TensorProto")
    np.testing.assert_array_equal(tensor_to_array(t, tmp_path), w1)
    side.write_bytes(w2.tobytes())
    st = side.stat()
    os.utime(side, ns=(st.st_atime_ns, st.st_mtime_ns + 1))
    np.testing.assert_array_equal(tensor_to_array(t, tmp_path), w2)


def _ext_proto(arr, location, length=None):
    t = ob.tensor_external(arr, "t", location, 0)
    if length is not None:
        t["external_data"][2]["value"] = str(length)
    return Proto(t, "TensorProto")


REJECTIONS = [
    ("no_base_dir", ValueError, "no model directory", lambda d: (_ext_proto(
        np.ones((2, 2), np.float32), "w.bin"), None)),
    ("missing_file", FileNotFoundError, "not found", lambda d: (_ext_proto(
        np.ones((2, 2), np.float32), "nope.bin"), d)),
    ("absolute_path", ValueError, "escapes", lambda d: (_ext_proto(
        np.ones((2, 2), np.float32), "/etc/passwd"), d)),
    ("dotdot_path", ValueError, "escapes", lambda d: (_ext_proto(
        np.ones((2, 2), np.float32), "../w.bin"), d)),
    ("length_mismatch", ValueError, "length", lambda d: (_ext_proto(
        np.ones((2, 2), np.float32), "w.bin", length=8), d)),
    ("range_past_eof", ValueError, "exceeds", lambda d: (_ext_proto(
        np.ones((2, 2), np.float32), "short.bin"), d)),
    ("no_location", ValueError, "no `location`", lambda d: (Proto(
        {**ob.tensor_external(np.ones(2, np.float32), "t", "w.bin", 0),
         "external_data": [{"key": "offset", "value": "0"}]}, "TensorProto"), d)),
]


@pytest.mark.parametrize("name,exc,match,case", REJECTIONS, ids=[r[0] for r in REJECTIONS])
def test_rejections_are_jax_rejections(tmp_path, name, exc, match, case):
    (tmp_path / "w.bin").write_bytes(np.ones((2, 2), np.float32).tobytes())
    (tmp_path / "short.bin").write_bytes(np.ones((2, 2), np.float32).tobytes()[:-4])
    t, base = case(tmp_path)
    with pytest.raises(exc, match=match) as got:
        tensor_to_array(t, base)
    with pytest.raises(exc, match=match) as want:
        j_tensor_to_array(t, base)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------- 4-bit


@pytest.mark.parametrize("vals,signed", [
    (np.array([[-8, 7, 3], [-1, 0, 5], [2, -4, 6]]), True),  # odd count
    (np.array([0, 15, 7, 8, 1]), False),
    (np.arange(6) - 3, True),
    (np.array([[1, 2], [3, 4]]), False),
])
def test_int4_matches_jax(vals, signed):
    td = ob.tensor_int4(vals, "w", signed=signed)
    assert td == jb.tensor_int4(vals, "w", signed=signed)
    got = tensor_to_array(Proto(td, "TensorProto"))
    want = j_tensor_to_array(Proto(td, "TensorProto"))
    assert isinstance(got, Int4Array) and got.onnx_dtype == want.onnx_dtype
    assert got.dtype == want.dtype == (np.int8 if signed else np.uint8)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, vals)
    with pytest.raises(ValueError, match="outside"):
        ob.tensor_int4(np.array([16 if not signed else -9]), signed=signed)


def test_int4_external_side_file(tmp_path):
    vals = np.array([3, -2, 7, -8, 1, 0, 5])
    td = ob.tensor_int4(vals, "w")
    packed = td.pop("raw_data")
    (tmp_path / "w4.bin").write_bytes(packed)
    td["data_location"] = 1
    td["external_data"] = [{"key": "location", "value": "w4.bin"},
                           {"key": "offset", "value": "0"},
                           {"key": "length", "value": str(len(packed))}]
    got = tensor_to_array(Proto(td, "TensorProto"), tmp_path)
    np.testing.assert_array_equal(got, j_tensor_to_array(Proto(td, "TensorProto"), tmp_path))
    np.testing.assert_array_equal(got, vals)
    with loader.base_dir_scope(tmp_path):  # the tracer's fallback
        np.testing.assert_array_equal(tensor_to_array(Proto(td, "TensorProto")), vals)


def test_int4_truncated_raises():
    td = ob.tensor_int4(np.arange(6) - 3, "w")
    td["raw_data"] = td["raw_data"][:2]  # 6 elements need 3 bytes
    with pytest.raises(ValueError, match="raw_data"):
        tensor_to_array(Proto(td, "TensorProto"))


def _dql_int4(b, blocked: bool):
    rng = np.random.default_rng(1 if blocked else 0)
    if not blocked:
        wq = rng.integers(-8, 8, (4, 3))
        return b.build_model_bytes(
            [b.node("DequantizeLinear", ["wq", "sc"], ["w"]), b.node("MatMul", ["x", "w"], ["y"])],
            inputs=[b.value_info("x", 1, [2, 4])], outputs=[b.value_info("y", 1, [2, 3])],
            initializers=[b.tensor_int4(wq, "wq"),
                          b.tensor_from_array(np.float32(0.25).reshape(()), "sc")], opset=21)
    wq = rng.integers(-8, 8, (8, 3))
    scales = (rng.random((2, 3)) * 0.3 + 0.05).astype(np.float32)
    return b.build_model_bytes(
        [b.node("DequantizeLinear", ["wq", "sc", "zp"], ["w"], axis=0, block_size=4),
         b.node("MatMul", ["x", "w"], ["y"])],
        inputs=[b.value_info("x", 1, [2, 8])], outputs=[b.value_info("y", 1, [2, 3])],
        initializers=[b.tensor_int4(wq, "wq"), b.tensor_from_array(scales, "sc"),
                      b.tensor_int4(rng.integers(-4, 4, (2, 3)), "zp")], opset=21)


def _blockwise_qdq(b):
    sc = np.full((2, 4), 0.02, np.float32)
    return b.build_model_bytes(
        [b.node("QuantizeLinear", ["x", "sc", "zp"], ["q"], axis=0, block_size=4),
         b.node("DequantizeLinear", ["q", "sc", "zp"], ["y"], axis=0, block_size=4)],
        inputs=[b.value_info("x", 1, [8, 4])], outputs=[b.value_info("y", 1, [8, 4])],
        initializers=[b.tensor_from_array(sc, "sc"),
                      b.tensor_from_array(np.zeros((2, 4), np.int8), "zp")], opset=21)


@pytest.mark.parametrize("graph", [lambda b: _dql_int4(b, False), lambda b: _dql_int4(b, True),
                                   _blockwise_qdq],
                         ids=["int4_dequantize_linear", "int4_blockwise", "blockwise_qdq"])
def test_quantized_graphs_load_as_jax(graph):
    """JAX's DequantizeLinear graphs: the port's builder gives JAX's bytes
    and its loader JAX's initializers (int4 ones as Int4Array)."""
    bs = graph(ob)
    assert bs == graph(jb)
    m, jm = OnnxModel.from_bytes(bs), JOnnxModel.from_bytes(bs)
    assert list(m.initializers) == list(jm.initializers)
    for name in m.initializers:
        got, want = m.initializer_array(name), jm.initializer_array(name)
        assert got.dtype == want.dtype and type(got).__name__ == type(want).__name__
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------- fp8

FP8 = [(17, "float8_e4m3fn"), (18, "float8_e4m3fnuz"), (19, "float8_e5m2"),
       (20, "float8_e5m2fnuz")]


def _fp8_graph(dt, w8):
    td = {"name": "w", "dims": [4], "data_type": dt, "raw_data": w8.tobytes()}
    return td, ob.build_model_bytes(
        [ob.node("Cast", ["w"], ["wf"], to=1), ob.node("Add", ["x", "wf"], ["y"])],
        inputs=[ob.value_info("x", 1, [4])], outputs=[ob.value_info("y", 1, [4])],
        initializers=[td], opset=21)


@pytest.mark.parametrize("dt,name", FP8, ids=[f[1] for f in FP8])
def test_fp8_tensor_decodes_and_runs(dt, name):
    w8 = np.array([1.0, -2.0, 0.5, 4.0], dtype=getattr(ml_dtypes, name))
    td, bs = _fp8_graph(dt, w8)
    got = tensor_to_array(Proto(td, "TensorProto"))
    want = j_tensor_to_array(Proto(td, "TensorProto"))
    assert got.dtype == want.dtype == np.dtype(getattr(ml_dtypes, name))
    np.testing.assert_array_equal(got.astype(np.float32), want.astype(np.float32))
    t = loader.to_torch(got)
    assert t.dtype == loader.FP8_TORCH[dt] == getattr(torch, name)
    np.testing.assert_array_equal(t.float().numpy(), w8.astype(np.float32))
    x = np.ones(4, np.float32)
    out = compile_model(bs, device="cpu").run_np(x=x)[0]
    np.testing.assert_array_equal(out, np.asarray(jcompile(JOnnxModel.from_bytes(bs))
                                                  .run_np(x=x)[0]))


@pytest.mark.parametrize("dt,name", FP8, ids=[f[1] for f in FP8])
def test_fp8_without_ml_dtypes(monkeypatch, dt, name):
    """The card machine's route: no ml_dtypes, so the loader keeps the uint8
    bits (Fp8Bits); they reach torch as float8, and a Cast of them runs on
    the torch route to the same output."""
    w8 = np.array([1.0, -2.0, 0.5, 4.0], dtype=getattr(ml_dtypes, name))
    td, bs = _fp8_graph(dt, w8)
    for k, _ in FP8:
        monkeypatch.delitem(loader.DTYPE_MAP, k)
    got = tensor_to_array(Proto(td, "TensorProto"))
    assert isinstance(got, Fp8Bits) and got.dtype == np.uint8 and got.onnx_dtype == dt
    np.testing.assert_array_equal(got.view(np.uint8), w8.view(np.uint8))
    t = loader.to_torch(got)
    assert t.dtype == getattr(torch, name)
    np.testing.assert_array_equal(t.float().numpy(), w8.astype(np.float32))
    back = loader.from_torch(t)
    assert isinstance(back, Fp8Bits) and back.onnx_dtype == dt
    x = np.ones(4, np.float32)
    out = compile_model(bs, device="cpu").run_np(x=x)[0]
    np.testing.assert_array_equal(out, x + w8.astype(np.float32))


def test_fp8_external_side_file(tmp_path):
    w8 = np.array([0.25, -3.0, 1.5], dtype=ml_dtypes.float8_e5m2)
    (tmp_path / "f8.bin").write_bytes(w8.tobytes())
    td = {"name": "w", "dims": [3], "data_type": 19, "data_location": 1,
          "external_data": [{"key": "location", "value": "f8.bin"},
                            {"key": "length", "value": "3"}]}
    got = tensor_to_array(Proto(td, "TensorProto"), tmp_path)
    want = j_tensor_to_array(Proto(td, "TensorProto"), tmp_path)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got.astype(np.float32), want.astype(np.float32))


# --------------------------------------------------------------- strings


def test_string_tensors_match_jax():
    arr = np.array([["a", "bé"], ["", "long string"]], dtype=object)
    td = ob.tensor_from_array(arr, "s")
    assert td == jb.tensor_from_array(arr, "s")
    got = tensor_to_array(Proto(td, "TensorProto"))
    want = j_tensor_to_array(Proto(td, "TensorProto"))
    assert got.dtype == want.dtype == object and got.shape == want.shape == (2, 2)
    assert got.tolist() == want.tolist() == arr.tolist()
    scalar = tensor_to_array(Proto(ob.tensor_from_array(np.array("x"), "s"), "TensorProto"))
    assert scalar.shape == () and scalar.item() == "x"


@pytest.mark.parametrize("no_ml_dtypes", [False, True])
def test_fp8_initializer_is_a_float8_tensor_on_the_device(monkeypatch, no_ml_dtypes):
    """A static fp8 value the graph hands out is hoisted as a torch float8
    tensor (the CPU here; tests/test_torch_port_card.py holds the card)."""
    bits = np.array([0x38, 0xC0, 0x30, 0x48], np.uint8)  # e4m3fn 1, -2, 0.5, 4
    td = {"name": "w", "dims": [4], "data_type": 17, "raw_data": bits.tobytes()}
    bs = ob.build_model_bytes(
        [ob.node("Cast", ["w"], ["wf"], to=1), ob.node("Add", ["x", "wf"], ["y"]),
         ob.node("Identity", ["w"], ["w8"])],
        inputs=[ob.value_info("x", 1, [4])],
        outputs=[ob.value_info("y", 1, [4]), ob.value_info("w8", 17, [4])],
        initializers=[td], opset=21)
    if no_ml_dtypes:
        for k, _ in FP8:
            monkeypatch.delitem(loader.DTYPE_MAP, k)
    y, w8 = compile_model(bs, device="cpu", strict=True)(x=torch.ones(4))
    assert w8.dtype == torch.float8_e4m3fn
    assert torch.equal(w8.float(), torch.tensor([1.0, -2.0, 0.5, 4.0]))
    assert torch.equal(y, torch.tensor([2.0, -1.0, 1.5, 5.0]))
