"""The port's MoE slice against the JAX package's, at a small size.

- The com.microsoft MoE and QMoE emitters (the port's `patterns=[]`) against
  JAX's emitters on the same ONNX bytes, on the cases of
  tests/test_moe_ops.py: the decode and prefill paths, fc3 gating,
  SparseMixer, normalised routing, bits 4 and 8, biases, the refusals, and
  tied logits, which must pick the experts `jax.lax.top_k` picks.
- The `qmoe_w4` pattern (kernel 7's expert-indexed entry; its plain version
  on the CPU) against JAX's: the f32 route against JAX's
  `LELE_QMOE_PALLAS=1 LELE_NBITS_F32=1`, and the default bf16 route against
  JAX's TPU routing (`_on_tpu` True, `w4_matmul_pallas` in interpret mode);
  equal pattern hits, and the same declines.

Inputs are made with numpy from a seed; the weights are initializers.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lele_tpu.kernels.quant_matmul as jqm
import lele_tpu.kernels.w4_matmul as jw4
from lele_tpu.compiler import compile_model as j_compile
from lele_tpu.compiler.patterns import _qmoe_group as j_qmoe_group
from lele_tpu.onnx import builder as jb
from lele_tpu.onnx.loader import OnnxModel as JOnnxModel
from lele_tpu.ops.moe_ops import route_topk as j_route_topk
from lele_tpu_torch.compiler import compile_model
from lele_tpu_torch.compiler import patterns as P
from lele_tpu_torch.kernels import w4_matmul as _w4  # noqa: F401
from lele_tpu_torch.ops import moe_ops

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_moe_ops import _case, np_moe, quantize_cols  # noqa: E402

W4 = sys.modules["lele_tpu_torch.kernels.w4_matmul"]
# the emitters: f32 on both sides, only summation orders differ
RTOL, ATOL = 1e-5, 1e-6
# the f32 route: the kernel's exact form against JAX's f32 jnp path
F32_RTOL, F32_ATOL = 1e-5, 1e-6
# the bf16 route against JAX's TPU routing where both take the group form:
# exact bf16 x int4 products in both, f32 sums in another order (measured
# 7.0e-8 of max|ref|; a flipped bf16 rounding of the fc1/fc3 activation
# before fc2 would move it to ~1e-3)
BF16_SAME_FORM_REL = 1e-5
# where the port takes the dequantised-tile form for a group below 8 and
# JAX's Pallas kernel the group form (the port's stated departure, see
# kernels/w4_matmul.py), the two differ by the bf16 rounding of q·s
# (measured 7.1e-3 and 5.2e-3 of max|ref|): the bf16 gate of
# tests/test_w4.py:73
BF16_TOL = 2e-2

NAMES = ["x", "logits", "w1", "s1", "b1", "w2", "s2", "b2", "w3", "s3", "b3"]


def _graph(op, x, logits, weights, **attrs):
    """One MoE/QMoE node: x and the logits as graph inputs, the expert stacks
    as initializers (`weights` maps the names of NAMES to arrays or None)."""
    names = ["x", "logits"] + [n if weights.get(n) is not None else "" for n in NAMES[2:]]
    if op == "MoE":
        names = ["x", "logits"] + [n if weights.get(n) is not None else ""
                                   for n in ("w1", "b1", "w2", "b2", "w3", "b3")]
    while names[-1] == "":
        names.pop()
    return jb.build_model_bytes(
        [jb.node(op, names, ["y"], domain="com.microsoft", **attrs)],
        inputs=[jb.vi_from_array("x", x), jb.vi_from_array("logits", logits)],
        outputs=[jb.value_info("y", 1, [])],
        initializers=[jb.tensor_from_array(v, n) for n, v in weights.items() if v is not None])


def _jax(bs, x, logits):
    cm = j_compile(JOnnxModel.from_bytes(bs), strict=True)
    return cm.run_np(x=x, logits=logits)[0], cm.stats.get("pattern_hits", {})


def _port(bs, x, logits, patterns=None):
    cm = compile_model(bs, strict=True, device="cpu", patterns=patterns)
    return cm.run_np(x=x, logits=logits)[0], cm.stats["pattern_hits"], cm


def _moe_weights(w1, b1, w2, b2, w3=None, b3=None):
    return {"w1": w1, "b1": b1, "w2": w2, "b2": b2, "w3": w3, "b3": b3}


MOE_CASES = {  # tests/test_moe_ops.py:118-166
    "topk_decode": (dict(seed=0, rows=2), dict(k=2, activation_type="relu")),
    "topk_prefill_3d_normalized": (dict(seed=1, rows=12, E=4),
                                   dict(k=2, activation_type="silu",
                                        normalize_routing_weights=1)),
    "gelu_prefill": (dict(seed=2, rows=16, E=8), dict(k=2, activation_type="gelu")),
    "fc3_gated_no_bias": (dict(seed=3, rows=2, bias=False, fc3=True),
                          dict(k=2, activation_type="silu", normalize_routing_weights=1)),
    "sparse_mixer": (dict(seed=4, rows=3, fc3=True),
                     dict(k=2, activation_type="silu", use_sparse_mixer=1)),
    "top1_identity": (dict(seed=5, rows=4), dict(k=1, activation_type="identity")),
}


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_emitter_matches_jax(case):
    kw, attrs = MOE_CASES[case]
    x, logits, w1, b1, w2, b2, w3, b3 = _case(**kw)
    if case == "topk_prefill_3d_normalized":
        x = x.reshape(3, 4, -1)
    bs = _graph("MoE", x, logits, _moe_weights(w1, b1, w2, b2, w3, b3), **attrs)
    want, _ = _jax(bs, x, logits)
    got, hits, _ = _port(bs, x, logits, patterns=[])
    assert not hits and got.shape == want.shape == x.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    oracle = np_moe(x, logits, w1, b1, w2, b2, w3, b3, k=attrs["k"],
                    act=attrs["activation_type"],
                    normalize=attrs.get("normalize_routing_weights", 0),
                    sparse_mixer=attrs.get("use_sparse_mixer", 0))
    np.testing.assert_allclose(got, oracle, rtol=1e-4, atol=1e-5)


def _q_weights(w1, b1, w2, b2, w3, b3, bits):
    out = {}
    for n, w, b in (("1", w1, b1), ("2", w2, b2), ("3", w3, b3)):
        if w is None:
            continue
        q, s, _ = quantize_cols(w, bits)
        out.update({f"w{n}": q, f"s{n}": s, f"b{n}": b})
    return out


QMOE_CASES = {  # tests/test_moe_ops.py:217-248
    "decode_bits4": (dict(seed=6, rows=2, inter=8), 4, dict(k=2, activation_type="relu")),
    "decode_bits8": (dict(seed=6, rows=2, inter=8), 8, dict(k=2, activation_type="relu")),
    "prefill_fc3_sparse_mixer": (dict(seed=7, rows=16, E=4, inter=8, fc3=True), 4,
                                 dict(k=2, activation_type="silu", use_sparse_mixer=1)),
    "prefill_bits8_gelu": (dict(seed=8, rows=8, E=4, inter=8), 8,
                           dict(k=2, activation_type="gelu")),
    "decode_fc3_normalized_no_bias": (dict(seed=9, rows=3, inter=8, bias=False, fc3=True), 4,
                                      dict(k=2, activation_type="silu",
                                           normalize_routing_weights=1)),
}


@pytest.mark.parametrize("case", list(QMOE_CASES))
def test_qmoe_emitter_matches_jax(case):
    kw, bits, attrs = QMOE_CASES[case]
    x, logits, *ws = _case(**kw)
    bs = _graph("QMoE", x, logits, _q_weights(*ws, bits), expert_weight_bits=bits, **attrs)
    want, _ = _jax(bs, x, logits)
    got, hits, _ = _port(bs, x, logits, patterns=[])
    assert not hits
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_moe_refusals_match_jax():
    x, logits, w1, b1, w2, b2, _, _ = _case(5, rows=2)
    for attrs, match in ((dict(k=2, activation_type="swiglu"), "activation_type"),
                         (dict(k=1, use_sparse_mixer=1), "k=2")):
        bs = _graph("MoE", x, logits, _moe_weights(w1, b1, w2, b2), **attrs)
        with pytest.raises(Exception, match=match):
            _jax(bs, x, logits)
        with pytest.raises(Exception, match=match):
            _port(bs, x, logits, patterns=[])
    q = _q_weights(w1, None, w2, None, None, None, 4)
    bs = _graph("QMoE", x, logits, q, k=2, expert_weight_bits=3)
    for run in (_jax, lambda *a: _port(*a, patterns=[])):
        with pytest.raises(Exception, match="expert_weight_bits"):
            run(bs, x, logits)


@pytest.mark.parametrize("sparse", [False, True])
def test_route_topk_breaks_ties_as_jax(sparse):
    """Tied logits: the stable descending sort picks the lower expert index,
    as jax.lax.top_k does; the SparseMixer's argmax takes the first maximum
    on both sides."""
    logits = np.zeros((4, 8), np.float32)
    logits[1, [2, 5, 6]] = 1.0
    logits[2] = np.repeat(np.float32([0.5, -1.0]), 4)
    logits[3, [7, 3]] = 2.0
    for normalize in (False, True):
        jw, je = j_route_topk(jnp.asarray(logits), 2, sparse, normalize)
        tw, te = moe_ops.route_topk(torch.from_numpy(logits), 2, sparse, normalize)
        np.testing.assert_array_equal(te.numpy(), np.asarray(je))
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=RTOL, atol=ATOL)
    assert te[0].tolist() == [0, 1] and te[3].tolist() == [3, 7]


def test_moe_with_tied_logits_matches_jax():
    x, _, w1, b1, w2, b2, _, _ = _case(12, rows=2)
    logits = np.zeros((2, 8), np.float32)
    bs = _graph("MoE", x, logits, _moe_weights(w1, b1, w2, b2), k=2, activation_type="relu")
    want, _ = _jax(bs, x, logits)
    got, _, _ = _port(bs, x, logits, patterns=[])
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


# -- the qmoe_w4 pattern -----------------------------------------------------------


def _pattern_case(seed=20, rows=2, E=8, hidden=8, inter=16, fc3=True, bias=False):
    """tests/test_moe_ops.py:254-297's case: hidden 8 and inter 16 give
    QMoE groups 4 (fc1, fc3) and 8 (fc2)."""
    x, logits, *ws = _case(seed, rows=rows, E=E, hidden=hidden, inter=inter, bias=bias,
                           fc3=fc3)
    attrs = dict(k=2, activation_type="silu", use_sparse_mixer=1, expert_weight_bits=4)
    return x, logits, _graph("QMoE", x, logits, _q_weights(*ws, 4), **attrs)


def test_qmoe_w4_f32_route_matches_jax(monkeypatch):
    x, logits, bs = _pattern_case()
    monkeypatch.setenv("LELE_QMOE_PALLAS", "1")
    monkeypatch.setenv("LELE_NBITS_F32", "1")
    want, jhits = _jax(bs, x, logits)
    got, hits, cm = _port(bs, x, logits, patterns=P.F32_NBITS_PATTERNS)
    assert hits == jhits and hits["qmoe_w4"] == 2, (hits, jhits)
    np.testing.assert_allclose(got, want, rtol=F32_RTOL, atol=F32_ATOL)
    assert cm.stats["n_steps"] == 1
    # the planes ride as int8 [E, K/2, N]; the scales as [E, K/g, N]
    planes = sorted(tuple(v.shape) for k, v in cm.params.items() if k.endswith("::qw4"))
    scales = sorted(tuple(v.shape) for k, v in cm.params.items() if k.endswith("::qw4s"))
    assert planes == [(8, 4, 16), (8, 4, 16), (8, 8, 8)]  # fc1, fc3: K = 8; fc2: K = 16
    assert scales == [(8, 2, 8), (8, 2, 16), (8, 2, 16)]  # groups 4 and 8
    assert all(v.dtype == torch.int8 for k, v in cm.params.items() if k.endswith("::qw4"))


@pytest.fixture
def jax_tpu_routing(monkeypatch):
    """JAX's TPU routing: the qmoe_w4 pattern forced on, `_on_tpu` True and
    its w4 kernel in interpret mode. Records the groups that reached it."""
    seen = []
    real = jw4.w4_matmul_pallas
    monkeypatch.setenv("LELE_QMOE_PALLAS", "1")
    monkeypatch.delenv("LELE_NBITS_F32", raising=False)
    monkeypatch.setattr(jqm, "_on_tpu", lambda: True)
    monkeypatch.setattr(jw4, "_on_tpu", lambda: True)
    monkeypatch.setattr(jw4, "w4_matmul_pallas", lambda *a, **k: (
        seen.append(k.get("group", a[3] if len(a) > 3 else None)),
        real(*a, **{**k, "interpret": True}))[1])
    return seen


def test_qmoe_w4_bf16_route_matches_jax_tpu_routing(jax_tpu_routing):
    """JAX's own sizes: group 4 for fc1/fc3 (below the card's k-step of 8:
    the port's dequantised-tile form against JAX's group form, at the bf16
    gate) and 8 for fc2 (the group form on both sides)."""
    x, logits, bs = _pattern_case()
    want, jhits = _jax(bs, x, logits)
    got, hits, _ = _port(bs, x, logits)
    assert hits == jhits and hits["qmoe_w4"] == 2
    assert set(jax_tpu_routing) == {4, 8}
    assert not W4.group_acc_form(8, 4) and W4.group_acc_form(16, 8)
    np.testing.assert_allclose(got, want, rtol=BF16_TOL, atol=BF16_TOL * 10)


def test_qmoe_w4_bf16_route_same_form_as_jax_tpu_routing(jax_tpu_routing):
    """hidden 32, inter 64: groups 16 and 32, the group form on both sides;
    only f32 summation orders differ."""
    x, logits, bs = _pattern_case(seed=21, rows=3, E=8, hidden=32, inter=64)
    want, jhits = _jax(bs, x, logits)
    got, hits, _ = _port(bs, x, logits)
    assert hits == jhits and set(jax_tpu_routing) == {16, 32}
    assert np.abs(got - want).max() <= BF16_SAME_FORM_REL * np.abs(want).max()


def test_qmoe_w4_declines_prefill_and_biases_as_jax(monkeypatch):
    monkeypatch.setenv("LELE_QMOE_PALLAS", "1")
    for kw in (dict(seed=21, rows=16, E=4), dict(seed=22, rows=2, bias=True)):
        x, logits, bs = _pattern_case(**kw)
        want, jhits = _jax(bs, x, logits)
        got, hits, _ = _port(bs, x, logits)
        assert not jhits.get("qmoe_w4") and not hits.get("qmoe_w4")
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_qmoe_w4_small_group_where_half_k_has_no_factor_of_16(jax_tpu_routing):
    """hidden 24: fc1's K/2 = 12 takes `_qmoe_group`'s group 4 on both
    sides, and kernel 7 takes it (no padding); inter 40: fc2's K/2 = 20,
    group 4 again."""
    assert P._qmoe_group(24) == j_qmoe_group(24) == 4
    assert P._qmoe_group(40) == j_qmoe_group(40) == 4
    assert W4.kernel_supports(24, 4) and W4.kernel_supports(40, 4)
    x, logits, bs = _pattern_case(seed=23, rows=2, hidden=24, inter=40)
    want, jhits = _jax(bs, x, logits)
    got, hits, cm = _port(bs, x, logits)
    assert hits == jhits and hits["qmoe_w4"] == 2
    assert set(jax_tpu_routing) == {4}
    scales = [tuple(v.shape) for k, v in cm.params.items() if k.endswith("::qw4s")]
    assert sorted(scales) == sorted([(8, 6, 40), (8, 10, 24), (8, 6, 40)])
    np.testing.assert_allclose(got, want, rtol=BF16_TOL, atol=BF16_TOL * 10)


def test_qmoe_w4_routes_through_the_indexed_entry(monkeypatch):
    """One call of kernel 7's wrapper per linear a request, all rows·k slots
    at once through the expert-indexed entry; no launch on the CPU."""
    seen = []
    real = W4.w4_matmul
    monkeypatch.setattr(W4, "w4_matmul", lambda *a: (seen.append((a[0].shape, a[4].tolist())),
                                                     real(*a))[1])
    x, logits, bs = _pattern_case(seed=24, rows=3)
    cm = compile_model(bs, strict=True, device="cpu")
    n_trace = len(seen)
    cm.run_np(x=x, logits=logits)
    assert n_trace == 3 and len(seen) == 6
    assert all(s[0] == (6, s[0][1]) for s in seen) and real.launches == 0
    weights, experts = moe_ops.route_topk(torch.from_numpy(logits), 2, True, False)
    assert seen[-1][1] == experts.reshape(-1).tolist()


def test_quant4_cols_and_moe_layer_graph_match_jax():
    """The port's copy of quant4_cols gives JAX's bytes; the MoE layer graph
    (router MatMul into QMoE) compiled by both, at a small width: the
    emitters agree at the emitter gate, and the port's default route takes
    qmoe_w4 on the decode path and declines prefill."""
    from lele_tpu.onnx.synth import quant4_cols as j_quant4_cols
    from lele_tpu_torch.onnx.synth import build_moe_layer_model, quant4_cols

    w = np.random.default_rng(0).standard_normal((3, 16, 10)).astype(np.float32)
    for a, b in zip(quant4_cols(w), j_quant4_cols(w)):
        np.testing.assert_array_equal(a, b)
    for rows, decode in ((1, True), (4, True), (16, False)):
        bs = build_moe_layer_model(rows, hidden=32, inter=48, experts=8, seed=rows)
        x = np.random.default_rng(rows).standard_normal((rows, 32)).astype(np.float32)
        want = j_compile(JOnnxModel.from_bytes(bs), strict=True).run_np(x=x)[0]
        per_op = compile_model(bs, strict=True, device="cpu", patterns=[])
        np.testing.assert_allclose(per_op.run_np(x=x)[0], want, rtol=RTOL, atol=ATOL)
        cm = compile_model(bs, strict=True, device="cpu")
        assert cm.stats["pattern_hits"].get("qmoe_w4", 0) == (2 if decode else 0)
        got = cm.run_np(x=x)[0]
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel <= 5e-3  # bf16 activations: the MatMulNBits gate
