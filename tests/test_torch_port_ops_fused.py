"""The com.microsoft fused and diffusion sets through the port (ROADMAP
§1.1.4): the JAX tests of tests/test_diffusion_ops.py and
test_fused_contrib_tail.py replayed, each graph through both packages'
compile_model on the same bytes, the port's outputs handed to the JAX
test's own assertions and held to JAX's at the test's tolerance
(test_torch_port_ops_battery.py says how; the GatherBlockQuantized and
MatMulBnb4 cases replay here too, beside test_torch_port_genai.py's own);
chip_smoke phase 39 (b)'s Stable Diffusion 1.5 UNet block in ORT's fused
form at a small width (32 channels, 8 groups, 16 x 16); and phase 39 (c)'s
graphs, one an emitter of both sets, against JAX on the CPU.
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
from test_torch_port_ops_battery import RANDOM_OPS, cases, replay_case  # noqa: E402

TAIL = {c["name"]: c for c in cs.tail_emitter_graphs()}


@pytest.mark.parametrize("mod_name,fn_name,kwargs", cases(
    ["test_diffusion_ops", "test_fused_contrib_tail"]))
def test_replays_jax_op_test(monkeypatch, mod_name, fn_name, kwargs):
    rep = replay_case(monkeypatch, mod_name, fn_name, kwargs)
    assert not rep.deferred, rep.deferred


def _ms(op_type, inputs, inits=None, names=None, n_out=1, **attrs):
    outs = [f"y{i}" for i in range(n_out)]
    return ob.build_model_bytes(
        [ob.node(op_type, names or list(inputs) + list(inits or {}), outs,
                 domain="com.microsoft", **attrs)],
        [ob.vi_from_array(k, v) for k, v in inputs.items()],
        [ob.value_info(o, 1, []) for o in outs],
        [ob.tensor_from_array(v, k) for k, v in (inits or {}).items()])


def _both(bs, inputs):
    got = compile_model(bs, device="cpu", strict=True).run_np(**inputs)
    want = j_compile(JOnnxModel.from_bytes(bs), strict=True).run_np(**inputs)
    return got, want


def test_relative_position_bias_dynamic_table_on_the_tape():
    """A runtime bias table: the buckets are a constant of the trace and the
    lookup one recorded step, JAX's values."""
    table = np.random.default_rng(0).standard_normal((32, 4)).astype(np.float32)
    bs = _ms("RelativePositionBias", {"t": table},
             {"q": np.array([9], np.int64), "k": np.array([13], np.int64)},
             max_distance=16, is_bidirectional=1)
    cm = compile_model(bs, device="cpu", strict=True)
    assert cm.stats["n_steps"] == 1
    (g,) = cm.run_np(t=table)
    (w,) = j_compile(JOnnxModel.from_bytes(bs), strict=True).run_np(t=table)
    np.testing.assert_array_equal(g, w)


def test_nhwc_conv_asymmetric_pads_and_group_norm_nchw_swish():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 6, 8)).astype(np.float32)
    w = rng.standard_normal((4, 4, 3, 2)).astype(np.float32)
    bs = _ms("NhwcConv", {"x": x}, {"w": w}, kernel_shape=[3, 2], pads=[0, 1, 2, 0],
             strides=[2, 1], group=2)
    (g,), (j,) = _both(bs, {"x": x})
    np.testing.assert_allclose(g, j, rtol=1e-5, atol=1e-5)
    x = rng.standard_normal((2, 8, 5, 3)).astype(np.float32)
    gb = {"g": rng.standard_normal(8).astype(np.float32),
          "b": rng.standard_normal(8).astype(np.float32)}
    bs = _ms("GroupNorm", {"x": x}, gb, groups=4, channels_last=0, activation=1)
    (g,), (j,) = _both(bs, {"x": x})
    np.testing.assert_allclose(g, j, rtol=1e-5, atol=1e-5)


def test_sd_block_matches_jax():
    """Phase 39 (b)'s graph at 32 channels, 8 groups, 16 x 16, batch 2: the
    port against JAX on the same bytes, max|d| <= 1e-5 max|ref| (measured
    3.6e-7)."""
    bs, _ = cs.sd_block_model(channels=32, groups=8, side=16, batch=2)
    rng = np.random.default_rng(2)
    feeds = {"h": rng.standard_normal((2, 16, 16, 32)).astype(np.float32),
             "temb": rng.standard_normal((2, 32)).astype(np.float32)}
    (g,), (w,) = _both(bs, feeds)
    assert g.shape == (2, 16, 16, 32) and np.isfinite(g).all()
    assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max()


@pytest.mark.parametrize("name", list(TAIL))
def test_tail_emitter_graph_matches_jax(name):
    """chip_smoke's `tail_emitter_graphs()` on the CPU: each graph through
    both packages, the port within the graph's own card gate of JAX (a
    Random op's draws: the shapes and dtypes only); a string graph folds to
    a constant (no tape step)."""
    import io
    from contextlib import redirect_stderr

    c = TAIL[name]
    bs = cs.emitter_graph_bytes(c)
    cm = compile_model(bs, device="cpu", strict=True)
    got = cm.run_np(**c["inputs"])
    with redirect_stderr(io.StringIO()):
        want = j_compile(JOnnxModel.from_bytes(bs), strict=True).run_np(**c["inputs"])
    assert len(got) == len(want)
    random = any(n["op_type"] in RANDOM_OPS for n in c["nodes"])
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape
        if not random:
            gap = np.abs(g.astype(np.float64) - w.astype(np.float64)).max() if g.size else 0
            assert gap <= c["tol"] * max(1.0, float(np.abs(w).max()) if w.size else 1.0)
    assert (cm.stats["n_steps"] == 0) == bool(c.get("folds"))


def test_tail_graphs_cover_both_sets():
    """Every emitter of ROADMAP §1.1.3 and §1.1.4 has a graph (51 names)."""
    import lele_tpu_torch.ops.registry as preg

    names = {n["op_type"] for c in TAIL.values() for n in c["nodes"]}
    tail = {od.name for od in [*preg.OPS.values(), *preg.CONTRIB_OPS.values()]
            if od.fn.__module__.rsplit(".", 1)[1] in (
                "string_ops", "tfidf_ops", "deform_ops", "fused_ops", "diffusion_ops")
            or od.name == "AffineGrid"
            or (od.fn.__module__.endswith("extra_ops") and not od.host
                and od.name not in ("SplitToSequence", "ConcatFromSequence"))}
    assert len(tail) == 51 and tail <= names, sorted(tail - names)
