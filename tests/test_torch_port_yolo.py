"""The port's compiled YOLO26 path against the JAX package's: the Conv
emitter over 1-3 spatial dims, the compiled graph's compute policy,
`YoloOnnx` on fixtures/yolo26.onnx in f32 and bf16, ImageDecoder and the
image helpers.

- Conv runs the same node as the JAX emitter on the same numpy inputs (the
  helpers of tests/test_torch_port_silero_onnx.py): floats to 1e-5 of the
  largest magnitude (f32 on both sides, only summation orders differ).
- `YoloOnnx` in f32 is held to the fixture's torch outputs at JAX's own gate
  (logits atol 2e-4, boxes 2e-3; tests/test_fixture_e2e.py:144-160) and to
  JAX's `YoloOnnx.forward` at 1e-6 of the largest magnitude (the CPU reads
  ~2e-7); `detect` gives JAX's anchors in JAX's order, scores to 1e-5.
- With `compute="bfloat16"` both sides round to bf16 after every conv, in
  their own summation orders, so a value may land one bf16 step (2^-8
  relative) away: held to the fixture at JAX's bf16 gate (logits atol 2e-3,
  boxes rtol 2e-2 / atol 5e-2, argmax agreement >= 0.99; :163-186) and to
  JAX's bf16 compile at the same gate; `detect` gives JAX's anchor set,
  each score within one bf16 step of the logit (5e-4: sigmoid' <= 1/4).
- The helpers bit for bit.
"""

import io
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from test_torch_port_silero_onnx import _assert_close, _run_both

from lele_tpu.compiler import compile_model as j_compile
from lele_tpu.models import compose_masks as j_compose_masks
from lele_tpu.models import decode_detections as j_decode
from lele_tpu.models.checkpoints import YoloOnnx as JYoloOnnx
from lele_tpu.onnx import builder as jb
from lele_tpu.onnx.loader import OnnxModel as JOnnxModel
from lele_tpu.utils import image as j_image
from lele_tpu_torch.compiler import compile_model
from lele_tpu_torch.models import YoloOnnx, compose_masks, decode_detections
from lele_tpu_torch.onnx import builder as ob
from lele_tpu_torch.utils import image

FIXTURES = Path(__file__).resolve().parent.parent / "fixtures"
F32_JAX_REL = 1e-6
DETECT_F32 = 1e-5
BF16_SCORE = 5e-4
_RNG = np.random.default_rng(2031)


def _f32(*shape, scale=1.0):
    return (_RNG.standard_normal(shape) * scale).astype(np.float32)


def _conv(x, w, b=None, **attrs):
    return ("Conv", [x, w] + ([b] if b is not None else []), 1, attrs)


# -- the Conv emitter ----------------------------------------------------------

CONV_CASES = {
    "2d_stride1": _conv(_f32(2, 4, 9, 11), _f32(6, 4, 3, 3), _f32(6), pads=[1, 1, 1, 1]),
    "2d_stride2": _conv(_f32(1, 3, 16, 16), _f32(8, 3, 3, 3), _f32(8), strides=[2, 2],
                        pads=[1, 1, 1, 1]),
    "2d_asym_pads": _conv(_f32(1, 3, 10, 7), _f32(5, 3, 3, 2), _f32(5), pads=[0, 2, 1, 0]),
    "2d_same_upper_odd": _conv(_f32(1, 4, 9, 7), _f32(4, 4, 3, 3), strides=[2, 2],
                               auto_pad="SAME_UPPER"),
    "2d_same_upper_even": _conv(_f32(1, 4, 10, 8), _f32(4, 4, 3, 3), _f32(4), strides=[2, 2],
                                auto_pad="SAME_UPPER"),
    "2d_same_lower_odd": _conv(_f32(1, 4, 9, 7), _f32(4, 4, 4, 3), strides=[2, 2],
                               auto_pad="SAME_LOWER"),
    "2d_same_lower_even": _conv(_f32(2, 4, 10, 8), _f32(4, 4, 3, 3), _f32(4), strides=[2, 2],
                                auto_pad="SAME_LOWER"),
    "2d_valid": _conv(_f32(1, 2, 8, 8), _f32(3, 2, 3, 3), auto_pad="VALID"),
    "2d_dilation2": _conv(_f32(1, 3, 12, 12), _f32(4, 3, 3, 3), _f32(4), dilations=[2, 2],
                          pads=[2, 2, 2, 2]),
    "2d_groups2": _conv(_f32(1, 6, 8, 8), _f32(4, 3, 3, 3), _f32(4), group=2,
                        pads=[1, 1, 1, 1]),
    "2d_depthwise": _conv(_f32(1, 8, 9, 9), _f32(8, 1, 3, 3), _f32(8), group=8, strides=[2, 2],
                          pads=[1, 1, 1, 1]),
    "2d_1x1_no_bias": _conv(_f32(1, 16, 5, 5), _f32(7, 16, 1, 1)),
    "3d": _conv(_f32(1, 2, 5, 6, 7), _f32(3, 2, 3, 3, 3), _f32(3), strides=[1, 2, 2],
                pads=[1, 0, 1, 1, 1, 0]),
    "1d": _conv(_f32(2, 4, 20), _f32(6, 2, 5), _f32(6), group=2, strides=[2],
                auto_pad="SAME_UPPER"),
}


@pytest.mark.parametrize("case", list(CONV_CASES))
def test_conv_emitter_matches_jax(case):
    (g,), (w,) = _run_both(*CONV_CASES[case])
    _assert_close(g, w)


def test_conv_emitter_refuses_rank_4():
    with pytest.raises(NotImplementedError):
        _run_both(*_conv(_f32(1, 1, 2, 2, 2, 2), _f32(1, 1, 1, 1, 1, 1)))


# -- the compute policy ----------------------------------------------------------

def _policy_graph() -> bytes:
    """x → Conv (a 432-element weight: a param; an 8-element bias: a
    literal in JAX) → Sigmoid → Mul by an f32 scalar constant."""
    def build(b):
        return b.build_model_bytes(
            [b.node("Conv", ["x", "w", "b"], ["c"], pads=[1, 1, 1, 1]),
             b.node("Sigmoid", ["c"], ["s"]),
             b.node("Constant", [], ["k"], value=np.asarray(640.0, np.float32)),
             b.node("Mul", ["s", "k"], ["y"])],
            [b.value_info("x", 1, [1, 6, 12, 12])], [b.value_info("y", 1, [])],
            [b.tensor_from_array(_f32(8, 6, 3, 3, scale=0.3), "w"),
             b.tensor_from_array(_f32(8), "b")])

    rng_state = _RNG.bit_generator.state
    data = build(ob)
    _RNG.bit_generator.state = rng_state
    assert data == build(jb)
    return data


def test_compute_policy_matches_jax():
    """compute="bfloat16": the large weight is stored bf16, the bias and the
    scalar keep f32, the input goes in as bf16, the f32 scalar promotes the
    bf16 sigmoid to f32 as jnp does, and the output leaves as f32."""
    data = _policy_graph()
    x = _f32(1, 6, 12, 12)
    cm = compile_model(data, device="cpu", compute="bfloat16")
    got = cm.run_np(x=x)[0]
    want = np.asarray(j_compile(JOnnxModel.from_bytes(data), compute="bfloat16",
                                precision="default").run_np(x=x)[0])
    assert got.dtype == want.dtype == np.float32
    assert sorted(str(t.dtype) for t in cm.params.values()) == [
        "torch.bfloat16", "torch.float32", "torch.float32"]
    # the sigmoid ran in bf16 and the product in f32: y / 640 is a bf16
    # value, y itself is not (a bf16 product would be)
    def bf16_exact(a):
        return torch.from_numpy(a).to(torch.bfloat16).float().numpy() == a

    assert bf16_exact(got / 640).all() and not bf16_exact(got).all()
    # XLA on the CPU folds some of its bf16 roundings away (a convert pair
    # f32 → bf16 → f32 is simplified), so a sigmoid may sit a bf16 step or two
    # from the port's (2^-8 at [0.5, 1); the CPU reads <= 3.2 at 640)
    np.testing.assert_allclose(got, want, rtol=0, atol=640 * 2.0 ** -7)


def test_compute_policy_rejects_unknown_dtype():
    with pytest.raises(ValueError):
        compile_model(_policy_graph(), device="cpu", compute="int8")


# -- YoloOnnx on the fixture -------------------------------------------------------

@pytest.fixture(scope="module")
def fixture_io():
    return (np.load(FIXTURES / "yolo26_input.npy"), np.load(FIXTURES / "yolo26_logits.npy"),
            np.load(FIXTURES / "yolo26_boxes.npy"))


@pytest.fixture(scope="module", params=[None, "bfloat16"], ids=["f32", "bf16"])
def yolo_pair(request, fixture_io):
    """(compute, the port's YoloOnnx, JAX's YoloOnnx, the port's outputs,
    JAX's outputs) on the fixture's input."""
    x = fixture_io[0]
    port = YoloOnnx(FIXTURES / "yolo26.onnx", img_size=x.shape[-1], compute=request.param,
                    device="cpu")
    jax_yo = JYoloOnnx(FIXTURES / "yolo26.onnx", img_size=x.shape[-1], compute=request.param)
    return (request.param, port, jax_yo, port.forward(x),
            [np.asarray(o, np.float32) for o in jax_yo.forward(x)])


def test_yolo_onnx_matches_fixture(yolo_pair, fixture_io):
    compute, _, _, (logits, boxes), _ = yolo_pair
    _, want_logits, want_boxes = fixture_io
    assert logits.dtype == boxes.dtype == np.float32
    assert logits.shape == want_logits.shape and boxes.shape == want_boxes.shape
    if compute is None:
        np.testing.assert_allclose(logits, want_logits, atol=2e-4)
        np.testing.assert_allclose(boxes, want_boxes, atol=2e-3)
    else:
        np.testing.assert_allclose(logits, want_logits, atol=2e-3)
        np.testing.assert_allclose(boxes, want_boxes, rtol=2e-2, atol=5e-2)
        assert (logits.argmax(-1) == want_logits.argmax(-1)).mean() >= 0.99


def test_yolo_onnx_matches_jax(yolo_pair):
    compute, _, _, got, want = yolo_pair
    for g, w in zip(got, want):
        if compute is None:
            np.testing.assert_allclose(g, w, rtol=0, atol=F32_JAX_REL * np.abs(w).max())
    if compute is not None:
        np.testing.assert_allclose(got[0], want[0], atol=2e-3)
        np.testing.assert_allclose(got[1], want[1], rtol=2e-2, atol=5e-2)
        assert (got[0].argmax(-1) == want[0].argmax(-1)).mean() >= 0.99


def test_yolo_onnx_detect_matches_jax(yolo_pair):
    compute, port, jax_yo, _, _ = yolo_pair
    img = (np.random.default_rng(0).random((480, 640, 3)) * 255).astype(np.uint8)
    x = port.prepare(img)
    assert x.dtype == torch.float32 and tuple(x.shape) == (1, 3, 640, 640)
    np.testing.assert_array_equal(
        x.numpy(), np.transpose(j_image.preprocess(img, 640), (0, 3, 1, 2)))
    got, want = port.detect(img, 0.0), jax_yo.detect(img, 0.0)
    assert len(got) == len(want) == 300
    if compute is None:
        assert [d["anchor"] for d in got] == [d["anchor"] for d in want]
        for g, w in zip(got, want):
            assert g["class_id"] == w["class_id"]
            assert abs(g["score"] - w["score"]) <= DETECT_F32
            np.testing.assert_allclose(g["xyxy"], w["xyxy"], atol=2e-3)
    else:
        by_anchor = {d["anchor"]: d for d in want}
        assert set(by_anchor) == {d["anchor"] for d in got}
        assert max(abs(d["score"] - by_anchor[d["anchor"]]["score"]) for d in got) <= BF16_SCORE


def test_yolo_onnx_decode_takes_one_output_form(yolo_pair):
    """A graph whose only output is [1, N, 4 + C] decodes as the two-output
    form does."""
    _, port, _, (logits, boxes), _ = yolo_pair
    one = np.concatenate([boxes, logits], axis=-1)
    assert port.decode([torch.from_numpy(one)], 0.3) == port.decode([logits, boxes], 0.3) \
        == decode_detections(logits, boxes, 0.3)


# -- helpers, bit for bit ----------------------------------------------------------


@pytest.mark.parametrize("shape", [(97, 203, 3), (480, 640, 3), (64, 64, 3), (7, 5, 3)])
@pytest.mark.parametrize("size", [32, 64, 128])
def test_image_helpers_match_jax(shape, size):
    img = _RNG.integers(0, 256, shape).astype(np.uint8)
    for name in ("nearest_resize", "preprocess", "preprocess_u8", "preprocess_chw"):
        got, want = getattr(image, name)(img, size), getattr(j_image, name)(img, size)
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("seed", [0, 1])
def test_decode_and_masks_match_jax(seed):
    rng = np.random.default_rng(seed)
    scores = rng.standard_normal((1, 40, 12)).astype(np.float32) * 3
    boxes = np.abs(rng.standard_normal((1, 40, 4)).astype(np.float32)) * 40 + 4
    coeffs = rng.standard_normal((1, 40, 8)).astype(np.float32)
    protos = rng.standard_normal((1, 16, 16, 8)).astype(np.float32)
    names = [f"c{i}" for i in range(12)]
    for th in (0.0, 0.5, 0.9):
        assert decode_detections(scores, boxes, th, names) == j_decode(scores, boxes, th, names)
    keep = [d["anchor"] for d in decode_detections(scores, boxes, 0.6)]
    for k in (keep, []):
        got = compose_masks(coeffs, protos, boxes, k, 128)
        want = j_compose_masks(coeffs, protos, boxes, k, 128)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def _encoded(fmt: str) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(_RNG.integers(0, 256, (21, 34, 3)).astype(np.uint8)).save(buf, fmt)
    return buf.getvalue()


@pytest.mark.parametrize("fmt", ["PNG", "JPEG"])
@pytest.mark.parametrize("pixel_format", ["RGB", "BGR", "Grayscale"])
def test_image_decoder_matches_jax(fmt, pixel_format):
    """Bytes folded at trace time decode on the host, as in JAX."""
    enc = np.frombuffer(_encoded(fmt), np.uint8).copy()

    def build(b):
        return b.build_model_bytes(
            [b.node("ImageDecoder", ["enc"], ["img"], pixel_format=pixel_format)],
            [], [b.value_info("img", 2, [])], [b.tensor_from_array(enc, "enc")], opset=20)

    data = build(ob)
    assert data == build(jb)
    (got,) = compile_model(data, device="cpu").run_np()
    (want,) = j_compile(JOnnxModel.from_bytes(data)).run_np()
    assert got.dtype == np.uint8 and got.shape[:2] == (21, 34)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_image_decoder_raises_on_a_traced_input():
    data = ob.build_model_bytes([ob.node("ImageDecoder", ["enc"], ["img"])],
                                [ob.value_info("enc", 2, [100])],
                                [ob.value_info("img", 2, [])], opset=20)
    with pytest.raises(NotImplementedError, match="decode in your input pipeline"):
        compile_model(data, device="cpu")
    with pytest.raises(NotImplementedError, match="decode in your input pipeline"):
        jax.block_until_ready(j_compile(JOnnxModel.from_bytes(data)).run_np(
            enc=np.zeros(100, np.uint8)))
