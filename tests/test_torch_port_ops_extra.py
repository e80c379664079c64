"""The long-tail ai.onnx set through the port (ROADMAP §1.1.3): the JAX
tests of tests/test_extra_ops.py, test_string_ops.py, test_deform_conv.py
and the AffineGrid cases of test_attention_ops.py replayed, each graph
through both packages' compile_model on the same bytes, the port's outputs
handed to the JAX test's own assertions and held to JAX's at the test's
tolerance (test_torch_port_ops_battery.py says how); and the slice's
full-width path at a small encoder: chip_smoke's front-end graph (SenseVoice's
log-mel in ONNX ops: DFT, HannWindow, MelWeightMatrix) at FbankConfig's
widths on 10 s of audio, behind a 2-layer, d-128 int8 SAN-M.

Kept from JAX and checked here: a STRING graph output is refused; a string
reaching a device value raises; GridSample's cubic mode raises; RoiAlign's
`sampling_ratio=0` is a fixed grid of 2 (ROADMAP §3 "Known"); Bernoulli and
Multinomial draw at trace time, the same numbers every call.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

from lele_tpu.compiler import compile_model as j_compile
from lele_tpu.onnx.loader import OnnxModel as JOnnxModel
from lele_tpu_torch.compiler import compile_model
from lele_tpu_torch.onnx import builder as ob

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tests"))
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402
from test_torch_port_ops_battery import cases, replay_case  # noqa: E402

AFFINE = [c for c in cases(["test_attention_ops"])
          if "affine" in c.values[1] or "spatial_transformer" in c.values[1]]


@pytest.mark.parametrize("mod_name,fn_name,kwargs", cases(
    ["test_extra_ops", "test_string_ops", "test_deform_conv"]) + AFFINE)
def test_replays_jax_op_test(monkeypatch, mod_name, fn_name, kwargs):
    replay_case(monkeypatch, mod_name, fn_name, kwargs)


def test_affine_cases_found():
    assert len(AFFINE) == 6


def _one(op_type, inputs, inits=None, names=None, n_out=1, opset=17, **attrs):
    outs = [f"y{i}" for i in range(n_out)]
    return ob.build_model_bytes(
        [ob.node(op_type, names or list(inputs) + list(inits or {}), outs, **attrs)],
        [ob.vi_from_array(k, v) for k, v in inputs.items()],
        [ob.value_info(o, 1, []) for o in outs],
        [ob.tensor_from_array(v, k) for k, v in (inits or {}).items()], opset=opset)


def _both(bs, inputs, **kw):
    got = compile_model(bs, device="cpu", strict=True, **kw).run_np(**inputs)
    want = j_compile(JOnnxModel.from_bytes(bs), strict=True).run_np(**inputs)
    return got, want


def test_dft_opset20_axis_input_and_length():
    """The opset-20 axis input (negative: from the full rank), dft_length
    padding, onesided and inverse on complex input, against JAX."""
    x = np.random.default_rng(0).standard_normal((2, 3, 10, 2)).astype(np.float32)
    for axis, attrs in ((-2, {}), (1, {"onesided": 0}), (-3, {"inverse": 1})):
        bs = _one("DFT", {"x": x}, {"n": np.asarray(16, np.int64),
                                   "a": np.asarray(axis, np.int64)}, opset=20, **attrs)
        (g,), (w,) = _both(bs, {"x": x})
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


def test_hardmax_opset11_flattens_and_ties_take_first():
    x = np.array([[[1.0, 3.0], [3.0, 0.0]], [[2.0, 2.0], [1.0, 2.0]]], np.float32)
    for opset in (11, 13):
        (g,), (w,) = _both(_one("Hardmax", {"x": x}, opset=opset, axis=1), {"x": x})
        np.testing.assert_array_equal(g, w)
    (g,), _ = _both(_one("Hardmax", {"x": x}, opset=11, axis=1), {"x": x})
    assert g.reshape(2, 4).sum(1).tolist() == [1, 1] and g[0, 0, 1] == 1  # first of the ties


def test_grid_sample_reflection_and_nearest_ties():
    """Reflection padding at both align_corners, and nearest mode on exact
    .5 coordinates (ties round up, as JAX's floor(v + 0.5))."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, 2, 4, 5)).astype(np.float32)
    grid = rng.uniform(-1.6, 1.6, (1, 3, 4, 2)).astype(np.float32)
    for align in (0, 1):
        bs = _one("GridSample", {"x": x, "g": grid}, padding_mode="reflection",
                  align_corners=align)
        (g,), (w,) = _both(bs, {"x": x, "g": grid})
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
    ties = np.stack(np.meshgrid(np.linspace(-1, 1, 9), np.linspace(-1, 1, 9)), -1)
    ties = ties[None].astype(np.float32)  # with align 1 and W 5: every other x is a .5
    for pad in ("zeros", "border"):
        bs = _one("GridSample", {"x": x, "g": ties}, mode="nearest", padding_mode=pad,
                  align_corners=1)
        (g,), (w,) = _both(bs, {"x": x, "g": ties})
        np.testing.assert_array_equal(g, w)


def test_grid_sample_cubic_refused():
    x = np.zeros((1, 1, 3, 3), np.float32)
    grid = np.zeros((1, 2, 2, 2), np.float32)
    with pytest.raises(NotImplementedError, match="cubic"):
        compile_model(_one("GridSample", {"x": x, "g": grid}, mode="cubic"), device="cpu")


def test_roi_align_sampling_ratio_zero_is_jax_fixed_grid():
    """ROADMAP §3 "Known": sampling_ratio 0 samples 2 x 2 a bin (JAX's
    static grid), not the spec's adaptive ceil(roi / bin) grid: equal to an
    explicit sampling_ratio=2, and to JAX, in both modes."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 3, 12, 12)).astype(np.float32)
    rois = np.array([[0.5, 1.0, 11.0, 9.5], [2.0, 2.0, 5.0, 8.0]], np.float32)
    bi = np.array([1, 0], np.int64)
    for mode in ("avg", "max"):
        outs = []
        for sr in (0, 2):
            bs = _one("RoiAlign", {"x": x, "r": rois, "b": bi}, output_height=3,
                      output_width=2, sampling_ratio=sr, mode=mode)
            (g,), (w,) = _both(bs, {"x": x, "r": rois, "b": bi})
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
            outs.append(g)
        np.testing.assert_array_equal(outs[0], outs[1])


def test_max_roi_pool_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 3, 10, 12)).astype(np.float32)
    rois = np.array([[0, 8.0, 8.0, 40.0, 30.0], [1, 0.0, 0.0, 8.0, 100.0],
                     [1, 72.0, 64.0, 72.0, 64.0]], np.float32)
    bs = _one("MaxRoiPool", {"x": x, "r": rois}, pooled_shape=[3, 4], spatial_scale=0.125)
    (g,), (w,) = _both(bs, {"x": x, "r": rois})
    np.testing.assert_array_equal(g, w)


def test_random_ops_draw_once_at_trace_time():
    """Bernoulli and Multinomial: the same numbers on every call (the
    uniforms are a constant of the trace), two nodes on the same input give
    different streams, the properties JAX's tests assert hold."""
    p = np.full((4, 64), 0.5, np.float32)
    nodes = [ob.node("Bernoulli", ["p"], ["a"]), ob.node("Bernoulli", ["p"], ["b"])]
    bs = ob.build_model_bytes(nodes, [ob.vi_from_array("p", p)],
                              [ob.value_info(o, 1, []) for o in "ab"])
    cm = compile_model(bs, device="cpu", strict=True)
    a1, b1 = cm.run_np(p=p)
    a2, _ = cm.run_np(p=p)
    np.testing.assert_array_equal(a1, a2)
    assert set(np.unique(a1)) <= {0.0, 1.0} and not np.array_equal(a1, b1)
    assert 0.35 < a1.mean() < 0.65
    logits = np.log(np.array([[0.2, 0.3, 0.5]] * 2, np.float32))
    cm = compile_model(_one("Multinomial", {"p": logits}, sample_size=4000), device="cpu")
    (y,) = cm.run_np(p=logits)
    assert y.shape == (2, 4000) and y.dtype == np.int32
    np.testing.assert_allclose(np.bincount(y[0], minlength=3) / 4000, [0.2, 0.3, 0.5],
                               atol=0.03)


def test_string_output_refused_and_string_on_device_raises():
    x = np.empty(2, dtype=object)
    x[:] = ["a", "b"]
    bs = ob.build_model_bytes([ob.node("StringConcat", ["x", "x"], ["y"])],
                              [ob.value_info("inp", 1, [1])], [ob.value_info("y", 8, [2])],
                              [ob.tensor_from_array(x, "x")])
    with pytest.raises(NotImplementedError, match="STRING tensor"):
        compile_model(bs, device="cpu")
    import torch

    from lele_tpu_torch.ops.registry import OPS, OpContext

    ctx = OpContext(xp=torch, attrs={"pattern": "a"}, opset=17)
    with pytest.raises(NotImplementedError, match="trace time"):
        OPS["RegexFullMatch"].fn(ctx, torch.zeros(2))


def test_tfidf_int_mode_on_the_tape_and_string_mode_folds():
    """The int mode is one recorded step whose pool and columns are
    constants of the trace (two calls, two inputs, JAX's counts); the
    string mode folds to a constant."""
    attrs = dict(min_gram_length=1, max_gram_length=3, max_skip_count=2,
                 ngram_counts=[0, 3, 7], ngram_indexes=list(range(6)),
                 pool_int64s=[2, 3, 5, 2, 3, 5, 9, 2, 3, 5], mode="TFIDF",
                 weights=[0.5, 1.0, 2.0, 4.0, 8.0, 3.0])
    x = np.array([[2, 3, 5, 9, 2, 3, 7, 5], [5, 9, 2, 5, 3, 5, 9, 2]], np.int64)
    bs = _one("TfIdfVectorizer", {"x": x}, **attrs)
    cm = compile_model(bs, device="cpu", strict=True)
    assert cm.stats["n_steps"] == 1
    for xi in (x, x[::-1].copy()):
        (g,) = cm.run_np(x=xi)
        (w,) = j_compile(JOnnxModel.from_bytes(bs), strict=True).run_np(x=xi)
        np.testing.assert_array_equal(g, w)


def test_front_end_graph_matches_jax():
    """Phase 39 (a)'s graph at FbankConfig's widths on 10 s of seeded audio,
    behind a 2-layer d-128 int8 SAN-M: the port's log-mel and logits against
    JAX's on the same bytes (LELE_SANM_FUSE=interpret: JAX's fused route),
    the same pattern hits on both sides (the front-end does not stop the
    SAN-M and DQL patterns). Gates: log-mel 1e-4 max|ref| (pocketfft and
    XLA's FFT sum in other orders; measured 4.7e-5); logits at int8 noise,
    MAE <= 0.02 std and argmax agreement >= 0.94 (measured 9e-6 and 1.0)."""
    import os

    bs = cs.frontend_model(160000, L=2, d=128, h=4, ffn=256, vocab=64)
    feeds = cs.frontend_feeds(cs.synth_speechlike(10.0, np.random.default_rng(0)))
    cm = compile_model(bs, device="cpu", strict=True)
    logits, logmel = cm.run_np(**feeds)
    old = os.environ.get("LELE_SANM_FUSE")
    os.environ["LELE_SANM_FUSE"] = "interpret"
    try:
        jm = j_compile(JOnnxModel.from_bytes(bs), strict=True)
        j_logits, j_logmel = jm.run_np(**feeds)
    finally:
        if old is None:
            os.environ.pop("LELE_SANM_FUSE")
        else:
            os.environ["LELE_SANM_FUSE"] = old
    assert logmel.shape == j_logmel.shape == (1, 998, 80)
    assert logits.shape == j_logits.shape == (1, 167 + 4, 64) and np.isfinite(logits).all()
    assert np.abs(logmel - j_logmel).max() <= 1e-4 * np.abs(j_logmel).max()
    assert np.abs(logits - j_logits).mean() <= 0.02 * j_logits.std()
    assert (logits.argmax(-1) == j_logits.argmax(-1)).mean() >= 0.94
    hits = cm.stats["pattern_hits"]
    assert hits == jm.stats["pattern_hits"]
    assert hits["sanm_fused_layers"] == 2 and hits["dql_matmul_dataflow"] == 1, hits
