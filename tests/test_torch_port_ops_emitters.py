"""The port's math, tensor, nn and activation emitters (ROADMAP §1.1.1)
against the JAX package's, one graph at a time.

Each case builds one graph and runs its bytes through JAX's compile_model
and the port's (device="cpu", strict): the port gives JAX's outputs at the
JAX op tests' tolerance (tests/optest.py assert_close, max|d| <= 1e-5)
unless the case says why another. Where the port goes past JAX (ONNX
attributes JAX ignores), the case holds it to a numpy oracle of the ONNX
spec instead and ROADMAP.md §3 "Known" lists the departure.
"""

import io
import sys
from contextlib import redirect_stderr
from pathlib import Path

import numpy as np
import pytest

from lele_tpu.compiler import compile_model as j_compile
from lele_tpu.onnx import builder as jb
from lele_tpu.onnx.loader import OnnxModel as JOnnxModel
from lele_tpu_torch.compiler import compile_model

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tests"))
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

TOL = 1e-5  # tests/optest.py assert_close


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    d = np.abs(got - want).max() if got.size else 0.0
    assert d <= tol or (np.isnan(d) and np.array_equal(np.isnan(got), np.isnan(want))
                        and np.abs(np.nan_to_num(got - want)).max() <= tol), d


def _bytes(nodes, inputs, outputs, inits=None, opset=17):
    return jb.build_model_bytes(
        nodes, [jb.vi_from_array(k, v) for k, v in inputs.items()],
        [jb.value_info(o, 1, []) for o in outputs],
        [jb.tensor_from_array(v, k) for k, v in (inits or {}).items()], opset=opset)


def _both(bs, inputs):
    """(port outputs, JAX outputs) of the same bytes on the same inputs."""
    with redirect_stderr(io.StringIO()):
        want = j_compile(JOnnxModel.from_bytes(bs), strict=True).run_np(**inputs)
    got = compile_model(bs, device="cpu", strict=True).run_np(**inputs)
    return got, want


def _op(op_type, inputs, n_out=1, inits=None, opset=17, names=None, **attrs):
    outs = [f"y{i}" for i in range(n_out)]
    node = jb.node(op_type, names or list(inputs) + list(inits or {}), outs, **attrs)
    return _both(_bytes([node], inputs, outs, inits, opset), inputs)


# -- integer Div and Mod on a dynamic divisor ---------------------------------


@pytest.mark.parametrize("dt", [np.int32, np.int64])
def test_int_div_truncates_like_jax(dt):
    """tests/test_kernel_accuracy.py:33-40 through both packages: the
    tracer's walk on zero placeholders divides by zero, which torch refuses
    on the CPU; the port must compile and give JAX's truncated quotients."""
    a = np.array([7, -7, 6, -6], dt)
    b = np.array([2, 2, -4, -4], dt)
    (got,), (want,) = _op("Div", {"a": a, "b": b})
    np.testing.assert_array_equal(got, [3, -3, -1, 1])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dt", [np.int32, np.int64, np.uint8])
def test_int_div_by_zero_gives_jax_values(dt):
    """A zero divisor gives JAX's CPU values: [7, -7, 0] / 0 -> [-2, -1, -1]
    (XLA's x / 0 = -1 through the floor-and-adjust of
    lele_tpu/ops/math_ops.py:45-55; all ones for an unsigned type), and the
    zeros do not disturb the other quotients."""
    a = np.array([7, 250, 0] if dt == np.uint8 else [7, -7, 0], dt)
    (q,), (jq,) = _op("Div", {"a": a, "b": np.zeros(3, dt)})
    np.testing.assert_array_equal(q, jq)
    if dt != np.uint8:
        np.testing.assert_array_equal(q, [-2, -1, -1])
        a2 = np.array([9, -9, 5, -5, 3], dt)
        b2 = np.array([2, 0, -2, 0, 3], dt)
        (g,), (w,) = _op("Div", {"a": a2, "b": b2})
        np.testing.assert_array_equal(g, w)


def test_int_mod_by_zero_gives_jax_values():
    """Mod and fmod by an integer zero give 0, as jnp.mod and jnp.fmod give
    it (they divide by one there); the other entries keep their sign rules."""
    for dt in (np.int32, np.int64, np.uint8):
        a = np.array([7, 250, 0] if dt == np.uint8 else [7, -7, 0], dt)
        for fmod in (0, 1):
            (m,), (jm,) = _op("Mod", {"a": a, "b": np.zeros(3, dt)}, fmod=fmod)
            np.testing.assert_array_equal(m, jm)
            np.testing.assert_array_equal(m, np.zeros(3))
    a = np.array([9, -9, 5, -5, 3, 0], np.int32)
    b = np.array([2, 0, -2, 3, -3, 0], np.int32)
    for fmod in (0, 1):
        (g,), (w,) = _op("Mod", {"a": a, "b": b}, fmod=fmod)
        np.testing.assert_array_equal(g, w)


# -- the registry -----------------------------------------------------------------


def test_registry_holds_every_set_one_emitter():
    """The port registers every one of JAX's 195 ai.onnx emitters and all 52
    of its com.microsoft ones, the search and packed sets too (LATER is
    empty); the search ops walk their subgraphs, as JAX's do; the Trilu
    alias resolves."""
    import lele_tpu.ops.registry as jreg
    import lele_tpu_torch.ops.registry as preg
    from test_torch_port_ops_battery import LATER

    assert set(jreg.OPS) - set(preg.OPS) == set() and LATER == frozenset()
    assert set(preg.CONTRIB_OPS) == set(jreg.CONTRIB_OPS) and len(preg.CONTRIB_OPS) == 52
    assert {k[1] for k, od in preg.CONTRIB_OPS.items() if od.subgraph} == {
        k[1] for k, od in jreg.CONTRIB_OPS.items() if od.subgraph} == {
        "BeamSearch", "GreedySearch", "Sampling", "WhisperBeamSearch"}
    assert len(preg.OPS) == 195 and set(preg.OPS) <= set(jreg.OPS)
    assert preg.CONTRIB_ALIASES == jreg.CONTRIB_ALIASES
    assert preg.lookup_op("com.microsoft", "Trilu") is preg.OPS["Trilu"]
    set_one = [n for n, od in jreg.OPS.items() if od.fn.__module__.rsplit(".", 1)[1] in (
        "math_ops", "tensor_ops", "nn_ops", "activation_ops")]
    assert len(set(set_one) - {"LSTM", "GRU", "RNN"}) > 87
    for name in set_one:  # JAX's fold and static-argument flags
        if name in ("Resize", "LSTM", "GRU", "RNN"):
            # the port reads Resize's roi (tf_crop_and_resize) at trace
            # time; the RNNs: slices 3 and 5
            continue
        j, p = jreg.OPS[name], preg.OPS[name]
        assert (j.foldable, tuple(j.static_args)) == (p.foldable, tuple(p.static_args)), name


def test_trilu_contrib_alias_matches_jax():
    x = np.random.default_rng(0).standard_normal((2, 4, 5)).astype(np.float32)
    node = jb.node("Trilu", ["x", "k"], ["y0"], domain="com.microsoft", upper=0)
    bs = jb.build_model_bytes([node], [jb.vi_from_array("x", x)], [jb.value_info("y0", 1, [])],
                              [jb.tensor_from_array(np.array(1, np.int64), "k")])
    (got,), (want,) = _both(bs, {"x": x})
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.tril(x, 1))


# -- chip_smoke phase 36's emitter graphs on the CPU ------------------------------

GRAPHS = {c["name"]: c for c in chip_smoke.emitter_graphs()}


def test_emitter_graphs_cover_the_set():
    """Phase 36's graphs name every emitter of ROADMAP §1.1.1 but
    NonMaxSuppression, which both packages refuse on every input, and
    ConvTranspose at 2-D and 3-D."""
    import lele_tpu.ops.registry as jreg

    set_one = {n for n, od in jreg.OPS.items() if od.fn.__module__.rsplit(".", 1)[1] in (
        "math_ops", "tensor_ops", "nn_ops", "activation_ops")}
    from lele_tpu_torch.ops import registry as preg

    new = set_one - {n for n in preg.OPS if n in _SLICE_BEFORE}
    ops = {node["op_type"] for c in GRAPHS.values() for node in c["nodes"]}
    assert len(new) == 87 and new - ops == {"NonMaxSuppression"}, sorted(new - ops)
    assert {"ConvTranspose 2-D", "ConvTranspose 3-D"} <= set(GRAPHS)


# the default-domain names of those four JAX modules the port had before this slice
_SLICE_BEFORE = frozenset(
    "Add Sub Mul Div Neg Less Equal Log Erf MatMul Gemm Range ReduceSum ReduceMean STFT "
    "Relu LeakyRelu Sigmoid Softmax Tanh Softplus Gelu Identity Transpose Reshape "
    "Unsqueeze Squeeze Concat Gather Shape Cast Slice Split Constant ConstantOfShape "
    "Expand Where Conv ConvTranspose LayerNormalization RMSNormalization LSTM GRU "
    "RNN".split())


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_emitter_graph_matches_jax(name):
    """Each of phase 36's graphs through both packages on the CPU: JAX's
    outputs at the graph's tolerance (max|d| <= tol·max(1, max|ref|)), or,
    where the port departs from JAX, the ONNX spec's: IsInf's detect_*
    attributes (JAX ignores them), Resize's cubic and crop forms (JAX
    refuses them), the Random ops' streams (threefry's bits are not held,
    only their shape and range)."""
    c = GRAPHS[name]
    bs = chip_smoke.emitter_graph_bytes(c)
    cm = compile_model(bs, device="cpu", strict=True)
    got = cm.run_np(**c["inputs"])
    assert cm.stats["capturable"]
    if name == "Resize cubic":
        want = _onnx_resize(c["inputs"]["x"], [1.75, 0.5], None, [2, 3], "half_pixel",
                            "cubic", a=-0.5, exclude=1)
        _close(got[0], want, c["tol"])
        return
    if name == "Resize tf_crop_and_resize":
        want = _onnx_resize(c["inputs"]["x"], None, [5, 11], [2, 3], "tf_crop_and_resize",
                            "linear", roi=list(c["inits"]["roi"]), extrap=-3.0)
        _close(got[0], want, c["tol"])
        return
    with redirect_stderr(io.StringIO()):
        want = j_compile(JOnnxModel.from_bytes(bs), strict=True).run_np(**c["inputs"])
    if name == "IsInf":  # detect_negative=0
        want = [np.isposinf(c["inputs"]["x"])]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        assert g.shape == w.shape
        if name.startswith("Random"):
            continue
        assert np.array_equal(np.isnan(g), np.isnan(w))
        fin = np.isfinite(w)
        assert np.array_equal(g[~fin & ~np.isnan(w)], w[~fin & ~np.isnan(w)])
        if fin.any():
            scale = max(1.0, float(np.abs(w[fin]).max()))
            assert np.abs(g[fin] - w[fin]).max() <= c["tol"] * scale, name


# -- attribute grids against JAX ----------------------------------------------------

RNG = np.random.default_rng(21)


@pytest.mark.parametrize("ct", ["half_pixel", "pytorch_half_pixel", "align_corners",
                                "asymmetric"])
@pytest.mark.parametrize("mode", ["nearest", "linear"])
def test_resize_modes_match_jax(mode, ct):
    """Every coordinate_transformation_mode JAX's Resize has, nearest (each
    nearest_mode) and linear, up and down, by scales and by sizes (a size
    of 1 takes pytorch_half_pixel's special case)."""
    x = RNG.standard_normal((1, 2, 5, 7)).astype(np.float32)
    roi = np.zeros(0, np.float32)
    nearest = (["round_prefer_floor", "round_prefer_ceil", "floor", "ceil"]
               if mode == "nearest" else ["round_prefer_floor"])
    for nm in nearest:
        for inits in ({"roi": roi, "s": np.array([1, 1, 1.6, 0.5], np.float32)},
                      {"roi": roi, "s": np.zeros(0, np.float32),
                       "z": np.array([1, 2, 1, 11], np.int64)}):
            (g,), (w,) = _op("Resize", {"x": x}, inits=inits, mode=mode,
                             coordinate_transformation_mode=ct, nearest_mode=nm)
            _close(g, w)


@pytest.mark.parametrize("mode", ["constant", "reflect", "edge", "wrap"])
def test_pad_modes_match_jax(mode):
    """Each mode with negative pads (crop first), pads past the extent and
    `axes` (opset 18); constant mode with its fill as an input, which JAX's
    emitter reads on the host (lele_tpu/ops/tensor_ops.py:307) and so
    refuses when it is hoisted: held to numpy (ROADMAP §3 "Known")."""
    x = RNG.standard_normal((3, 4, 5)).astype(np.float32)
    pads = np.array([1, -1, 3, 2, 0, 4], np.int64)
    want = np.pad(x[:, 1:], [(1, 2), (0, 0), (3, 4)], mode=mode)
    (g,), (w,) = _op("Pad", {"x": x}, inits={"p": pads}, mode=mode)
    _close(g, w)
    np.testing.assert_array_equal(g, want)
    if mode == "constant":  # the fill as an input: JAX's emitter cannot take it
        bs = _bytes([jb.node("Pad", ["x", "p", "v"], ["y0"])], {"x": x}, ["y0"],
                    {"p": pads, "v": np.float32(-2.5)})
        (g,) = compile_model(bs, device="cpu", strict=True).run_np(x=x)
        np.testing.assert_array_equal(
            g, np.pad(x[:, 1:], [(1, 2), (0, 0), (3, 4)], constant_values=-2.5))
    (g,), (w,) = _op("Pad", {"x": x}, inits={
        "p": np.array([2, 3], np.int64), "a": np.array([-1], np.int64)}, mode=mode,
        opset=18, names=["x", "p", "", "a"])
    _close(g, w)


@pytest.mark.parametrize("excl,rev", [(0, 0), (1, 0), (0, 1), (1, 1)])
def test_cumsum_forms_match_jax(excl, rev):
    x = RNG.standard_normal((3, 6)).astype(np.float32)
    for axis in (1, -2):
        (g,), (w,) = _op("CumSum", {"x": x}, inits={"a": np.array(axis, np.int64)},
                         exclusive=excl, reverse=rev)
        _close(g, w)
    xi = RNG.integers(-9, 9, (4,)).astype(np.int32)
    (g,), (w,) = _op("CumSum", {"x": xi}, inits={"a": np.array(0, np.int64)},
                     exclusive=excl, reverse=rev)
    assert g.dtype == np.int32
    np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("count_pad", [0, 1])
@pytest.mark.parametrize("ceil", [0, 1])
def test_pools_geometry_matches_jax(count_pad, ceil):
    """AveragePool and MaxPool at 1-3 spatial dims with asymmetric pads,
    strides, dilations and ceil_mode (a last window that starts in the pad)."""
    for shape, k, s, d, p in (((2, 3, 11), [3], [2], [2], [1, 2]),
                              ((1, 2, 7, 9), [3, 2], [2, 3], [1, 2], [1, 0, 2, 1]),
                              ((1, 2, 5, 6, 7), [2, 3, 2], [2, 2, 3], [1, 1, 1],
                               [0, 1, 1, 1, 0, 1])):
        x = RNG.standard_normal(shape).astype(np.float32)
        (g,), (w,) = _op("AveragePool", {"x": x}, kernel_shape=k, strides=s, pads=p,
                         ceil_mode=ceil, count_include_pad=count_pad, opset=19, dilations=d)
        _close(g, w)
        (g, gi), (w, wi) = _op("MaxPool", {"x": x}, n_out=2, kernel_shape=k, strides=s,
                               pads=p, ceil_mode=ceil, dilations=d)
        _close(g, w)
        np.testing.assert_array_equal(gi, wi)


def test_maxpool_storage_order_one_and_int_types():
    """storage_order 1 (the JAX package refuses it): the spatial axes of the
    flat index column-major, checked against the values they point at; and
    int8 and int32 inputs keep their values and type."""
    x = np.round(RNG.standard_normal((2, 3, 6, 5)) * 3).astype(np.float32)
    bs = _bytes([jb.node("MaxPool", ["x"], ["y0", "y1"], kernel_shape=[2, 3], strides=[2, 1],
                         storage_order=1)], {"x": x}, ["y0", "y1"])
    vals, idx = compile_model(bs, device="cpu", strict=True).run_np(x=x)
    h, w = idx % 30 % 6, idx % 30 // 6
    np.testing.assert_array_equal(x[idx // 90, idx // 30 % 3, h, w], vals)
    for dt in (np.int8, np.int32):
        xi = RNG.integers(-100, 100, (1, 2, 5, 5)).astype(dt)
        (g,), (w_,) = _op("MaxPool", {"x": xi}, kernel_shape=[2, 2], pads=[1, 1, 0, 0])
        assert g.dtype == dt
        np.testing.assert_array_equal(g, w_)


@pytest.mark.parametrize("red", ["none", "add", "mul"])
def test_scatter_reductions_and_duplicates_match_jax(red):
    """ScatterND and ScatterElements with duplicate indices (the last
    update wins without a reduction, JAX's CPU order) and JAX's reductions."""
    d = RNG.standard_normal((5, 4)).astype(np.float32)
    idx = np.array([[1], [3], [1], [-1], [3]], np.int64)
    u = RNG.standard_normal((5, 4)).astype(np.float32)
    (g,), (w,) = _op("ScatterND", {"d": d, "u": u}, inits={"i": idx}, names=["d", "i", "u"],
                     opset=16, reduction=red)
    _close(g, w)
    ie = np.array([[0, 3, 0, 0], [2, 2, -1, 1]], np.int64)
    ue = RNG.standard_normal((2, 4)).astype(np.float32)
    (g,), (w,) = _op("ScatterElements", {"d": d, "u": ue}, inits={"i": ie},
                     names=["d", "i", "u"], opset=16, axis=1, reduction=red)
    _close(g, w)


@pytest.mark.parametrize("red", ["max", "min"])
def test_scatter_max_min_follow_onnx(red):
    """max and min (opset 18): the port keeps the extreme of the data and
    every update at a position, as ONNX defines them (the JAX package's
    emitters write the updates as `none` would: ROADMAP §3 "Known")."""
    d = RNG.standard_normal((4, 3)).astype(np.float32)
    idx = np.array([[2], [0], [2]], np.int64)
    u = RNG.standard_normal((3, 3)).astype(np.float32)
    bs = _bytes([jb.node("ScatterND", ["d", "i", "u"], ["y0"], reduction=red)],
                {"d": d, "u": u}, ["y0"], {"i": idx}, opset=18)
    (g,) = compile_model(bs, device="cpu", strict=True).run_np(d=d, u=u)
    want = d.copy()
    f = np.maximum if red == "max" else np.minimum
    for j, row in enumerate(idx[:, 0]):
        want[row] = f(want[row], u[j])
    np.testing.assert_array_equal(g, want)


def test_topk_argmax_ties_match_jax():
    """Equal values: TopK takes the lower index first (lax.top_k), largest
    and smallest; ArgMax and ArgMin the first, or the last with
    select_last_index."""
    x = np.array([[1.0, 3.0, 3.0, 2.0, 3.0, 1.0], [0.0, 0.0, -1.0, -1.0, 5.0, 5.0]],
                 np.float32)
    for largest in (1, 0):
        (gv, gi), (wv, wi) = _op("TopK", {"x": x}, n_out=2,
                                 inits={"k": np.array([4], np.int64)}, largest=largest)
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gv, wv)
    for op_type in ("ArgMax", "ArgMin"):
        for last in (0, 1):
            for keep in (0, 1):
                (g,), (w,) = _op(op_type, {"x": x}, axis=-1, keepdims=keep,
                                 select_last_index=last)
                np.testing.assert_array_equal(g, w)


def test_isinf_detect_attributes_follow_onnx():
    """detect_positive / detect_negative (the JAX package ignores them and
    flags both infinities)."""
    x = np.array([np.inf, -np.inf, 1.0, np.nan], np.float32)
    for pos, neg, want in ((1, 1, [1, 1, 0, 0]), (1, 0, [1, 0, 0, 0]), (0, 1, [0, 1, 0, 0]),
                           (0, 0, [0, 0, 0, 0])):
        bs = _bytes([jb.node("IsInf", ["x"], ["y0"], detect_positive=pos,
                             detect_negative=neg)], {"x": x}, ["y0"])
        (g,) = compile_model(bs, device="cpu", strict=True).run_np(x=x)
        np.testing.assert_array_equal(g, np.array(want, bool))


def test_int_pow_negative_exponent_truncates():
    """An integer base under a negative exponent gives jnp.power's wrapped
    value, where torch refuses (3^-2 -> 3^62 mod 2^32); a non-negative
    exponent gives JAX's values too."""
    a = np.array([2, 3, -2, 1, -1, 4], np.int32)
    b = np.array([-1, -2, -1, -3, -3, 2], np.int32)
    (g,), (w,) = _op("Pow", {"a": a, "b": b})
    np.testing.assert_array_equal(g, w)
    assert g[1] == 703_701_817 and g[2] == 0 and g[4] == -1
    (g,), (w,) = _op("Pow", {"a": a, "b": np.abs(b)})
    np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("dt", [np.int8, np.int16, np.int32, np.uint8])
@pytest.mark.parametrize("exp_as", ["input", "initializer"])
def test_int_pow_wraps_like_jax(dt, exp_as):
    """Integer Pow over every exponent bit pattern jnp's binary
    exponentiation reads (its low 6 bits), negative exponents, 0^0, 0^64 and
    results that overflow the dtype, from a graph input and from an
    initializer."""
    rng = np.random.default_rng(7)
    lo = 0 if dt == np.uint8 else -6
    a = rng.integers(lo, 7, 64).astype(dt)
    b = (rng.integers(-70, 70, 64) if lo else rng.integers(0, 70, 64)).astype(dt)
    a[:3], b[:3] = 0, [0, 64, 3]
    if exp_as == "input":
        (g,), (w,) = _op("Pow", {"a": a, "b": b})
    else:
        (g,), (w,) = _op("Pow", {"a": a}, inits={"b": b})
    assert g.dtype == w.dtype == dt
    np.testing.assert_array_equal(g, w)


def test_random_ops_hold_jax_tests_properties():
    """The streams' properties (tests/test_op_battery2.py:149-185,
    test_tensor_ops.py:396-403): ranges and moments; the same seed the same
    numbers in two compiles; distinct nodes without a seed distinct streams,
    from the crc32 of their names; a seed of -x apart from x."""
    def run(nodes, x):
        bs = _bytes(nodes, {"x": x}, ["y0"])
        return compile_model(bs, device="cpu", strict=True).run_np(x=x)[0]

    x = np.zeros((128, 128), np.float32)
    n = run([jb.node("RandomNormalLike", ["x"], ["r"], mean=1.0, scale=2.0),
             jb.node("Add", ["r", "x"], ["y0"])], x)
    assert abs(n.mean() - 1.0) < 0.05 and abs(n.std() - 2.0) < 0.05
    u = run([jb.node("RandomUniformLike", ["x"], ["r"], low=2.0, high=5.0, seed=3.0),
             jb.node("Add", ["r", "x"], ["y0"])], x)
    assert 2.0 <= u.min() and u.max() < 5.0 and abs(u.mean() - 3.5) < 0.05
    u2 = run([jb.node("RandomUniformLike", ["x"], ["r"], low=2.0, high=5.0, seed=3.0),
              jb.node("Add", ["r", "x"], ["y0"])], x)
    np.testing.assert_array_equal(u, u2)
    neg = run([jb.node("RandomUniformLike", ["x"], ["r"], low=2.0, high=5.0, seed=-3.0),
               jb.node("Add", ["r", "x"], ["y0"])], x)
    assert not np.array_equal(u, neg)
    two = run([jb.node("RandomNormalLike", ["x"], ["a"], name="na"),
               jb.node("RandomNormalLike", ["x"], ["b"], name="nb"),
               jb.node("Sub", ["a", "b"], ["y0"])], x)
    assert two.std() > 1.0  # two independent streams, not one
    h = run([jb.node("RandomUniform", [], ["r"], shape=[128, 128], dtype=10),
             jb.node("Cast", ["r"], ["c"], to=1), jb.node("Add", ["c", "x"], ["y0"])], x)
    assert 0.0 <= h.min() and h.max() < 1.0


def test_data_dependent_ops_run_on_concrete_values_only():
    """NonZero, Unique and Compress's condition fold or gather on
    trace-time values; a runtime value raises JAX's refusal."""
    x = np.array([[1.0, 0.0, 2.0], [0.0, 3.0, 3.0]], np.float32)
    for op_type, n_out in (("NonZero", 1), ("Unique", 4)):
        bs = _bytes([jb.node(op_type, ["c"], [f"y{i}" for i in range(n_out)])], {},
                    [f"y{i}" for i in range(n_out)], {"c": x})
        got = compile_model(bs, device="cpu", strict=True).run_np()
        with redirect_stderr(io.StringIO()):
            want = j_compile(JOnnxModel.from_bytes(bs), strict=True).run_np()
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        bs = _bytes([jb.node(op_type, ["x"], [f"y{i}" for i in range(n_out)])], {"x": x},
                    [f"y{i}" for i in range(n_out)])
        with pytest.raises(NotImplementedError, match="data-dependent"):
            compile_model(bs, device="cpu", strict=True)


@pytest.mark.parametrize("given_as", ["input", "initializer"])
def test_nms_refused_on_every_input(given_as):
    """NonMaxSuppression raises JAX's refusal whether its boxes and scores
    are runtime inputs or constants, in both packages."""
    vals = {"b": np.zeros((1, 2, 4), np.float32), "s": np.zeros((1, 1, 2), np.float32)}
    inputs, inits = (vals, {}) if given_as == "input" else ({}, vals)
    bs = _bytes([jb.node("NonMaxSuppression", ["b", "s"], ["y0"])], inputs, ["y0"], inits)
    with pytest.raises(NotImplementedError, match="NMS-free"):
        compile_model(bs, device="cpu", strict=True)
    with pytest.raises(NotImplementedError, match="NMS-free"), redirect_stderr(io.StringIO()):
        j_compile(JOnnxModel.from_bytes(bs), strict=True)


def test_compress_index_is_a_constant_of_the_compiled_model():
    """Compress over runtime data gathers with an index vector that the
    compiled model holds among its params (its lifetime is the model's),
    and gives JAX's output."""
    x = RNG.standard_normal((2, 5, 3)).astype(np.float32)
    cond = np.array([True, False, True, True, False])
    bs = _bytes([jb.node("Compress", ["x", "c"], ["y0"], axis=1)], {"x": x}, ["y0"],
                {"c": cond})
    cm = compile_model(bs, device="cpu", strict=True)
    index = [v for k, v in cm.params.items() if k.endswith("/index")]
    assert len(index) == 1 and index[0].tolist() == [0, 2, 3]
    with redirect_stderr(io.StringIO()):
        want = j_compile(JOnnxModel.from_bytes(bs), strict=True).run_np(x=x)
    np.testing.assert_array_equal(cm.run_np(x=x)[0], want[0])


@pytest.mark.parametrize("rank", [1, 2, 3])
def test_conv_transpose_forms_match_jax(rank):
    """ConvTranspose at 1-3 spatial dims: groups, dilations, strides,
    output_padding, explicit and negative pads, output_shape with each
    auto_pad, SAME_* without pads, and a bias."""
    cin, cout_g, g = 4, 3, 2
    x = RNG.standard_normal((2, cin) + (5, 4, 3)[:rank]).astype(np.float32)
    w = (RNG.standard_normal((cin, cout_g) + (3, 2, 2)[:rank]) * 0.3).astype(np.float32)
    b = RNG.standard_normal(cout_g * g).astype(np.float32)
    forms = [dict(strides=[2, 1, 3][:rank], group=g, dilations=[1, 2, 1][:rank],
                  output_padding=[1, 0, 2][:rank], pads=([1, 0, 0][:rank] + [0, 1, -1][:rank])),
             dict(strides=[2] * rank, group=g, output_shape=[11, 8, 6][:rank]),
             dict(strides=[2] * rank, group=g, output_shape=[10, 9, 7][:rank],
                  auto_pad="SAME_UPPER"),
             dict(strides=[3] * rank, group=g, auto_pad="SAME_LOWER"),
             dict(group=g, auto_pad="VALID")]
    for attrs in forms:
        (gt,), (wt,) = _op("ConvTranspose", {"x": x}, inits={"w": w, "b": b}, **attrs)
        _close(gt, wt, tol=1e-4)  # tests/test_nn_ops.py's conv gate


# -- Resize past JAX: cubic, half_pixel_symmetric, tf_crop_and_resize, axes ---------


def _onnx_resize_1d(data, scale, out_n, ctm, mode, roi, extrap, a, exclude, nearest_mode):
    """One axis of ONNX's Resize, written from its reference implementation
    (onnx/reference/ops/op_resize.py): the source coordinate, then the
    nearest, the two linear or the four cubic neighbours of an edge-padded
    axis."""
    n = len(data)
    out = np.empty(out_n)
    for i in range(out_n):
        if ctm == "align_corners":
            xo = 0.0 if out_n == 1 else i * (n - 1) / (out_n - 1)
        elif ctm == "asymmetric":
            xo = i / scale
        elif ctm == "pytorch_half_pixel":
            xo = (i + 0.5) / scale - 0.5 if out_n > 1 else 0.0
        elif ctm == "half_pixel_symmetric":
            xo = n / 2 * (1 - out_n / (scale * n)) + (i + 0.5) / scale - 0.5
        elif ctm == "tf_crop_and_resize":
            xo = ((roi[1] - roi[0]) * (n - 1) / 2 if out_n == 1
                  else i * (roi[1] - roi[0]) * (n - 1) / (out_n - 1)) + roi[0] * (n - 1)
            if xo < 0 or xo > n - 1:
                out[i] = extrap
                continue
        else:
            xo = (i + 0.5) / scale - 0.5
        if mode == "nearest":
            r = {"round_prefer_floor": np.ceil(xo - 0.5), "round_prefer_ceil": np.floor(xo + 0.5),
                 "floor": np.floor(xo), "ceil": np.ceil(xo)}[nearest_mode]
            out[i] = data[int(min(max(r, 0), n - 1))]
            continue
        k = int(np.floor(xo))
        t = xo - k
        if mode == "linear":
            taps, w = [k, k + 1], np.array([1 - t, t])
        else:
            def cc(d):
                d = abs(d)
                if d <= 1:
                    return ((a + 2) * d - (a + 3)) * d * d + 1
                return ((a * d - 5 * a) * d + 8 * a) * d - 4 * a if d < 2 else 0.0
            taps = [k - 1, k, k + 1, k + 2]
            w = np.array([cc(t + 1), cc(t), cc(1 - t), cc(2 - t)])
            if exclude:
                w = np.where([0 <= j <= n - 1 for j in taps], w, 0.0)
                w = w / w.sum()
        out[i] = sum(wi * data[min(max(j, 0), n - 1)] for wi, j in zip(w, taps))
    return out


def _onnx_resize(x, scales, sizes, axes, ctm, mode, roi=None, extrap=0.0, a=-0.75,
                 exclude=0, nearest_mode="round_prefer_floor"):
    out = x.astype(np.float64)
    for i, ax in enumerate(axes):
        n = x.shape[ax]
        on = sizes[i] if sizes is not None else int(np.floor(n * scales[i]))
        sc = on / n if sizes is not None else float(scales[i])
        r = None if roi is None else (roi[i], roi[len(axes) + i])
        out = np.apply_along_axis(_onnx_resize_1d, ax, out, sc, on, ctm, mode, r, extrap, a,
                                  exclude, nearest_mode)
    return out


@pytest.mark.parametrize("ctm", ["half_pixel", "align_corners", "asymmetric",
                                 "half_pixel_symmetric", "pytorch_half_pixel"])
@pytest.mark.parametrize("exclude,a", [(0, -0.75), (1, -0.75), (0, -0.5), (1, -0.5)])
def test_resize_cubic_follows_onnx(ctm, exclude, a):
    """Cubic (the JAX package raises): its four taps, cubic_coeff_a,
    exclude_outside, up and down, against the ONNX reference's formulas."""
    x = RNG.standard_normal((1, 2, 6, 5)).astype(np.float32)
    sc = np.array([1, 1, 1.7, 0.6], np.float32)
    bs = _bytes([jb.node("Resize", ["x", "", "s"], ["y0"], mode="cubic",
                         coordinate_transformation_mode=ctm, cubic_coeff_a=a,
                         exclude_outside=exclude)], {"x": x}, ["y0"], {"s": sc}, opset=19)
    (g,) = compile_model(bs, device="cpu", strict=True).run_np(x=x)
    _close(g, _onnx_resize(x, sc[2:], None, [2, 3], ctm, "cubic", a=a, exclude=exclude), 1e-5)


@pytest.mark.parametrize("mode", ["nearest", "linear", "cubic"])
def test_resize_tf_crop_and_resize_follows_onnx(mode):
    """tf_crop_and_resize (the JAX package raises): a crop box partly off
    the image, filled with extrapolation_value there, by sizes, over `axes`
    (opset 18)."""
    x = RNG.standard_normal((1, 2, 7, 6)).astype(np.float32)
    roi = np.array([0.2, -0.1, 0.9, 1.3], np.float32)  # starts, ends of axes 2 and 3
    sizes = np.array([5, 9], np.int64)
    bs = _bytes([jb.node("Resize", ["x", "roi", "", "z"], ["y0"], mode=mode,
                         coordinate_transformation_mode="tf_crop_and_resize",
                         extrapolation_value=-7.0, axes=[2, 3])],
                {"x": x}, ["y0"], {"roi": roi, "z": sizes}, opset=18)
    (g,) = compile_model(bs, device="cpu", strict=True).run_np(x=x)
    want = _onnx_resize(x, None, list(sizes), [2, 3], "tf_crop_and_resize", mode,
                        roi=list(roi), extrap=-7.0)
    _close(g, want, 1e-5)
    assert (g == -7.0).any()


def test_resize_linear_and_nearest_follow_onnx_with_axes():
    """The modes JAX has, held to the ONNX reference's formulas too, with
    scales over a subset of the axes (opset 18's `axes`)."""
    x = RNG.standard_normal((2, 3, 5, 4)).astype(np.float32)
    for mode in ("nearest", "linear"):
        for ctm in ("half_pixel", "asymmetric", "align_corners", "half_pixel_symmetric"):
            bs = _bytes([jb.node("Resize", ["x", "", "s"], ["y0"], mode=mode,
                                 coordinate_transformation_mode=ctm, axes=[-1, 2])],
                        {"x": x}, ["y0"], {"s": np.array([2.5, 0.8], np.float32)}, opset=18)
            (g,) = compile_model(bs, device="cpu", strict=True).run_np(x=x)
            want = _onnx_resize(x, [2.5, 0.8], None, [3, 2], ctm, mode)
            _close(g, want, 1e-5)
