"""The ORT-GenAI op family in the port against the JAX package, on the same
ONNX bytes and the same seeded numpy inputs.

- Every non-MatMulNBits case of JAX's tests/test_genai_ops.py,
  test_decoder_masked.py, test_sparse_attention.py, test_contrib_ops.py,
  test_fused_contrib_tail.py (GatherBlockQuantized, MatMulBnb4) and
  test_domain_dispatch.py, replayed through both packages' `compile_model`
  (the port on the CPU), with a few more: GroupQueryAttention at B = 2 with
  unequal lengths, a cache append that overruns the buffer (the clamp), a
  negative start, explicit position_ids, attention_bias, softcap alone;
  the contrib RotaryEmbedding's forms and refusals; SimplifiedLayerNorm over
  two trailing axes in both domains.
- Tolerances are JAX's (tests/test_genai_ops.py:134-136): rtol 1e-4 / atol
  1e-5 for outputs, 1e-5 / 1e-6 for the present caches.
- The registries: the port registers every emitter of JAX's
  ops/contrib_ops.py and ops/genai_ops.py, and the com.microsoft Gelu and
  Range aliases reach the default emitters with JAX's outputs.
- The GenAI decoder (onnx/synth.py): the port's builders give JAX's bytes
  for seed 0, and GENAI_CFG and GENAI_MOE_CFG prefill 4 tokens and decode 6
  greedily through both packages, loaded from a side file on both.
"""

import numpy as np
import pytest
import torch

from lele_tpu.compiler import compile_model as jcompile
from lele_tpu.onnx import OnnxModel as JOnnxModel
from lele_tpu.onnx import builder as job
from lele_tpu_torch.compiler import compile_model
from lele_tpu_torch.compiler.patterns import F32_NBITS_PATTERNS
from lele_tpu_torch.onnx import OnnxModel
from lele_tpu_torch.onnx import builder as ob

OUT_TOL = dict(rtol=1e-4, atol=1e-5)
CACHE_TOL = dict(rtol=1e-5, atol=1e-6)


def _bytes(builder, nodes, inputs, outputs, inits, opset):
    return builder.build_model_bytes(
        nodes,
        inputs=[builder.vi_from_array(k, v) for k, v in inputs.items()],
        outputs=[builder.value_info(o, 1, []) for o in outputs],
        initializers=[builder.tensor_from_array(v, k) for k, v in inits.items()],
        opset=opset)


def _op_graph(builder, op_type, inputs, inits, input_names, n_outputs, domain, attrs):
    names = input_names or list(inputs) + list(inits)
    outs = [f"out{i}" for i in range(n_outputs)]
    return [builder.node(op_type, names, outs, domain=domain, **attrs)], outs


def both(op_type, inputs, inits=None, input_names=None, n_outputs=1, opset=17,
         domain="com.microsoft", **attrs):
    """(JAX outputs, port outputs) of one node on the same bytes."""
    inits = inits or {}
    nodes, outs = _op_graph(ob, op_type, inputs, inits, input_names, n_outputs, domain, attrs)
    bs = _bytes(ob, nodes, inputs, outs, inits, opset)
    jnodes, _ = _op_graph(job, op_type, inputs, inits, input_names, n_outputs, domain, attrs)
    assert _bytes(job, jnodes, inputs, outs, inits, opset) == bs
    return _run_both(bs, inputs)


def _run_both(bs, inputs):
    want = jcompile(JOnnxModel.from_bytes(bs), strict=True).run_np(**inputs)
    got = compile_model(bs, strict=True, device="cpu").run_np(**inputs)
    return [np.asarray(w) for w in want], got


def _check(want, got, caches=()):
    assert len(want) == len(got)
    for i, (w, g) in enumerate(zip(want, got)):
        assert g.shape == w.shape and g.dtype == w.dtype, (i, g.shape, w.shape)
        np.testing.assert_allclose(g, w, **(CACHE_TOL if i in caches else OUT_TOL))


def both_raise(match, *args, **kwargs):
    with pytest.raises(Exception, match=match):
        both(*args, **kwargs)
    inits = kwargs.pop("inits", None) or {}
    op_type, inputs = args
    nodes, outs = _op_graph(ob, op_type, inputs, inits, kwargs.pop("input_names", None),
                            kwargs.pop("n_outputs", 1), kwargs.pop("domain", "com.microsoft"),
                            {k: v for k, v in kwargs.items() if k != "opset"})
    bs = _bytes(ob, nodes, inputs, outs, inits, kwargs.get("opset", 17))
    with pytest.raises(Exception, match=match):
        compile_model(bs, strict=True, device="cpu").run_np(**inputs)


def _f(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def make_caches(max_pos, half, seed=0):
    rng = np.random.default_rng(seed)
    ang = rng.uniform(-np.pi, np.pi, (max_pos, half))
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


# ------------------------------------------------------- GroupQueryAttention


def _gqa_case(seed, s, past_len, qh=4, kvh=2, head=8, L=16):
    rng = np.random.default_rng(seed)
    b = len(past_len)
    past_len = np.asarray(past_len, np.int64)
    f = {"q": _f(rng, b, s, qh * head), "k": _f(rng, b, s, kvh * head),
         "v": _f(rng, b, s, kvh * head), "pk": _f(rng, b, kvh, L, head),
         "pv": _f(rng, b, kvh, L, head),
         "slk": (past_len + s - 1).astype(np.int32),
         "tot": np.asarray([int(past_len.max() + s)], np.int32)}
    return f


GQA = [
    # JAX's test_gqa_decode_step: B = 2, unequal lengths
    ("decode_step", lambda: (_gqa_case(0, 1, [5, 3]), {}, None, dict(num_heads=4,
                                                                     kv_num_heads=2))),
    # test_gqa_chunked_prefill_continuation: S = 4 after unequal pasts, 6 over 2 heads
    ("chunked_prefill", lambda: (_gqa_case(1, 4, [6, 0, 2], qh=6, kvh=2, head=4, L=12), {},
                                 None, dict(num_heads=6, kv_num_heads=2))),
    # test_gqa_rotary_window_softcap_smooth
    ("rotary_window_softcap_smooth", lambda: (
        {**_gqa_case(2, 2, [7, 4]), **dict(zip(("cos", "sin"), make_caches(32, 4)))}, {},
        None, dict(num_heads=4, kv_num_heads=2, do_rotary=1, local_window_size=4,
                   softcap=30.0, smooth_softmax=1))),
    # test_gqa_rotary_interleaved_partial_dim: rotary dim 4 < head 8
    ("rotary_interleaved_partial", lambda: (
        {**_gqa_case(3, 3, [0, 5]), **dict(zip(("cos", "sin"), make_caches(32, 2, seed=9)))},
        {}, None, dict(num_heads=4, kv_num_heads=2, do_rotary=1, rotary_interleaved=1))),
    # past_len + S overruns L = 8 in row 0 (6 + 4): the append clamps to 4
    ("overrun_clamp", lambda: (_gqa_case(4, 4, [6, 2], L=8), {}, None,
                               dict(num_heads=4, kv_num_heads=2))),
    # seqlens_k below S - 1: a negative start, wrapped once (+ L) as JAX places it
    ("negative_start", lambda: (
        {**_gqa_case(5, 3, [0, 2]), "slk": np.asarray([0, 4], np.int32)}, {}, None,
        dict(num_heads=4, kv_num_heads=2))),
    # explicit position_ids ([B, S]) for the rotary, a scale and an additive bias
    ("position_ids_bias_scale", lambda: (
        {**_gqa_case(6, 2, [3, 9]), **dict(zip(("cos", "sin"), make_caches(32, 4, seed=3))),
         "pid": np.asarray([[3, 4], [9, 10]], np.int64),
         "ab": _f(np.random.default_rng(60), 2, 1, 2, 16)}, {},
        ["q", "k", "v", "pk", "pv", "slk", "tot", "cos", "sin", "pid", "ab"],
        dict(num_heads=4, kv_num_heads=2, do_rotary=1, scale=0.2))),
    # a [1] start position, softcap alone, equal heads
    ("start_position_softcap", lambda: (
        {**_gqa_case(7, 1, [4, 4], qh=2, kvh=2), **dict(zip(("cos", "sin"), make_caches(32, 4))),
         "pid": np.asarray([4], np.int64)}, {},
        ["q", "k", "v", "pk", "pv", "slk", "tot", "cos", "sin", "pid"],
        dict(num_heads=2, kv_num_heads=2, do_rotary=1, softcap=5.0))),
]


@pytest.mark.parametrize("name,case", GQA, ids=[c[0] for c in GQA])
def test_gqa_matches_jax(name, case):
    inputs, inits, names, attrs = case()
    want, got = both("GroupQueryAttention", inputs, inits, input_names=names, n_outputs=3,
                     **attrs)
    _check(want, got, caches=(1, 2))


def test_gqa_packed_qkv_prefill_no_past():
    rng = np.random.default_rng(4)
    b, s, qh, kvh, head = 2, 5, 4, 2, 8
    inputs = {"q": _f(rng, b, s, (qh + 2 * kvh) * head),
              "slk": np.full((b,), s - 1, np.int32), "tot": np.asarray([s], np.int32)}
    want, got = both("GroupQueryAttention", inputs,
                     input_names=["q", "", "", "", "", "slk", "tot"], num_heads=qh,
                     kv_num_heads=kvh)
    _check(want, got)


def test_gqa_refusals():
    f = _gqa_case(8, 1, [2])
    names = ["q", "k", "v", "pk", "pv", "slk", "tot", "", "", "", "", "hs"]
    both_raise("head_sink", "GroupQueryAttention", {**f, "hs": np.zeros(4, np.float32)},
               input_names=names, num_heads=4, kv_num_heads=2)
    both_raise("not divisible", "GroupQueryAttention", f, num_heads=5, kv_num_heads=2)


def test_cache_append_holds_per_row_offsets_on_device():
    """The append writes each row at its own offset without a host read, and
    places it as JAX's vmapped lax.dynamic_update_slice does: a negative
    offset wraps once, then clamps into [0, L - S]."""
    import jax.numpy as jnp

    from lele_tpu.ops.genai_ops import _cache_append as jax_append
    from lele_tpu_torch.ops.genai_ops import _cache_append

    past = np.zeros((5, 1, 6, 2), np.float32)
    new = np.ones((5, 1, 2, 2), np.float32)
    start = np.array([1, 5, -3, -9, 0])
    got = _cache_append(torch.from_numpy(past), torch.from_numpy(new), torch.from_numpy(start))
    rows = got[:, 0, :, 0]
    assert rows[1].tolist() == [0, 0, 0, 0, 1, 1]  # 5 clamped to L - S = 4
    assert rows[2].tolist() == [0, 0, 0, 1, 1, 0]  # -3 wrapped to 3
    assert rows[3].tolist() == [1, 1, 0, 0, 0, 0]  # -9 wrapped to -3, clamped to 0
    want = jax_append(jnp.asarray(past), jnp.asarray(new), jnp.asarray(start))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not past.any()  # the past buffer itself is not written


# ------------------------------------------------------- MultiHeadAttention


def test_mha_3d_bias_key_lengths():
    rng = np.random.default_rng(5)
    b, sq, skv, h, d = 2, 3, 6, 4, 8
    inputs = {"q": _f(rng, b, sq, h * d), "k": _f(rng, b, skv, h * d),
              "v": _f(rng, b, skv, h * d), "bias": _f(rng, 3 * h * d),
              "kpm": np.asarray([4, 6], np.int32)}
    _check(*both("MultiHeadAttention", inputs, num_heads=h))


def test_mha_packed_qkv():
    rng = np.random.default_rng(6)
    _check(*both("MultiHeadAttention", {"q": _f(rng, 2, 4, 3, 3, 8)}, num_heads=3))


def test_mha_packed_kv_and_cached_4d_kv():
    rng = np.random.default_rng(7)
    q, kv = _f(rng, 1, 2, 2 * 4), _f(rng, 1, 5, 2, 2, 4)
    _check(*both("MultiHeadAttention", {"q": q, "kv": kv}, num_heads=2))
    k4 = np.ascontiguousarray(kv[:, :, :, 0].transpose(0, 2, 1, 3))
    v4 = np.ascontiguousarray(kv[:, :, :, 1].transpose(0, 2, 1, 3))
    _check(*both("MultiHeadAttention", {"q": q, "k": k4, "v": v4}, num_heads=2))


def test_mha_past_kv_unidirectional():
    rng = np.random.default_rng(8)
    b, sq, p, h, d = 2, 3, 4, 2, 8
    inputs = {"q": _f(rng, b, sq, h * d), "k": _f(rng, b, sq, h * d),
              "v": _f(rng, b, sq, h * d), "pk": _f(rng, b, h, p, d), "pv": _f(rng, b, h, p, d)}
    want, got = both("MultiHeadAttention", inputs,
                     input_names=["q", "k", "v", "", "", "", "pk", "pv"], n_outputs=3,
                     num_heads=h, unidirectional=1)
    _check(want, got, caches=(1, 2))


def test_mha_padding_mask_bias_and_filter_value():
    """A [B, total_kv] padding mask adds mask_filter_value (ORT's rule), with
    an additive attention_bias."""
    rng = np.random.default_rng(9)
    b, sq, skv, h, d = 2, 2, 5, 2, 4
    mask = np.ones((b, skv), np.int32)
    mask[0, 3:] = 0
    inputs = {"q": _f(rng, b, sq, h * d), "k": _f(rng, b, skv, h * d),
              "v": _f(rng, b, skv, h * d), "kpm": mask, "ab": _f(rng, 1, h, sq, skv)}
    _check(*both("MultiHeadAttention", inputs, input_names=["q", "k", "v", "", "kpm", "ab"],
                 num_heads=h, mask_filter_value=-50.0))


# --------------------------------------------- contrib Attention (packed QKV)


def test_ms_attention_past_kv_present():
    rng = np.random.default_rng(9)
    b, s, p, h, d = 2, 2, 3, 2, 4
    inputs = {"x": _f(rng, b, s, h * d), "past": _f(rng, 2, b, h, p, d)}
    inits = {"w": _f(rng, h * d, 3 * h * d)}
    want, got = both("Attention", inputs, inits, input_names=["x", "w", "", "", "past"],
                     n_outputs=2, num_heads=h, unidirectional=1)
    _check(want, got)


def _ms_inputs(seed, B, S, D, zero_bias=False):
    rng = np.random.default_rng(seed)
    x = _f(rng, B, S, D)
    w = (rng.standard_normal((D, 3 * D)) / np.sqrt(D)).astype(np.float32)
    bias = np.zeros(3 * D, np.float32) if zero_bias else _f(rng, 3 * D)
    return x, w, bias


def test_ms_attention_lengths_mask_and_unidirectional():
    x, w, bias = _ms_inputs(6, 2, 5, 8)
    _check(*both("Attention", {"x": x, "mi": np.array([5, 3], np.int32)},
                 {"w": w, "bias": bias}, input_names=["x", "w", "bias", "mi"], num_heads=2))
    x, w, bias = _ms_inputs(7, 1, 6, 8, zero_bias=True)
    _check(*both("Attention", {"x": x}, {"w": w, "bias": bias},
                 input_names=["x", "w", "bias"], num_heads=2, unidirectional=1))


def test_ms_attention_padding_mask_and_bias():
    x, w, bias = _ms_inputs(10, 2, 4, 8)
    mask = np.array([[1, 1, 0, 0], [1, 1, 1, 1]], np.int32)
    ab = _f(np.random.default_rng(11), 1, 2, 4, 4)
    _check(*both("Attention", {"x": x, "mi": mask, "ab": ab}, {"w": w, "bias": bias},
                 input_names=["x", "w", "bias", "mi", "", "ab"], num_heads=2))


def test_ms_attention_refusals():
    rng = np.random.default_rng(8)
    x = _f(rng, 1, 4, 8)
    inits = {"w": np.eye(8, 24, dtype=np.float32), "past": np.zeros((2, 1, 2, 8, 4), np.float32),
             "psl": np.asarray([3], np.int32)}
    both_raise("share_buffer", "Attention", {"x": x}, inits=inits,
               input_names=["x", "w", "", "", "past", "", "psl"], num_heads=2,
               past_present_share_buffer=1)
    both_raise("qkv_hidden_sizes", "Attention", {"x": x}, inits={"w": inits["w"]},
               input_names=["x", "w"], num_heads=2, qkv_hidden_sizes=[8, 8, 4])


# ---------------------------------------------------------- DecoderMasked*

DB, DH, DD, DML = 2, 8, 16, 10


def test_dmsa_decode_step_and_mask_bias():
    rng = np.random.default_rng(0)
    x = _f(rng, DB, 1, DD)
    w = (rng.standard_normal((DD, 3 * DD)) / np.sqrt(DD)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(3 * DD)).astype(np.float32)
    past = _f(rng, 2, DB, 2, DML, DH)
    want, got = both("DecoderMaskedSelfAttention",
                     {"x": x, "past": past, "pseq": np.asarray([4], np.int32)},
                     {"w": w, "b": bias}, input_names=["x", "w", "b", "", "past", "", "pseq"],
                     n_outputs=2, num_heads=2, past_present_share_buffer=1)
    _check(want, got, caches=(1,))
    mask = np.ones((DB, DML), np.int32)
    mask[0, :2] = 0
    rel = _f(rng, 1, 2, 1, DML)
    _check(*both("DecoderMaskedSelfAttention",
                 {"x": x, "past": past, "mask": mask, "rel": rel,
                  "pseq": np.asarray([6], np.int32)}, {"w": w},
                 input_names=["x", "w", "", "mask", "past", "rel", "pseq"], num_heads=2,
                 past_present_share_buffer=1, mask_filter_value=-5000.0))


def test_dmmha_self_and_cross():
    rng = np.random.default_rng(2)
    q, k, v = _f(rng, DB, 1, DD), _f(rng, DB, 1, DD), _f(rng, DB, 1, DD)
    pk, pv = _f(rng, DB, 2, DML, DH), _f(rng, DB, 2, DML, DH)
    want, got = both("DecoderMaskedMultiHeadAttention",
                     {"q": q, "k": k, "v": v, "pk": pk, "pv": pv,
                      "pseq": np.asarray([3], np.int32)}, n_outputs=3,
                     input_names=["q", "k", "v", "", "", "pk", "pv", "pseq"], num_heads=2,
                     past_present_share_buffer=1)
    _check(want, got, caches=(1, 2))
    ck, cv = _f(rng, DB, 2, 5, DH), _f(rng, DB, 2, 5, DH)
    _check(*both("DecoderMaskedMultiHeadAttention", {"q": q, "ck": ck, "cv": cv},
                 input_names=["q", "ck", "cv"], num_heads=2))
    # a fused bias on 3D key and value
    _check(*both("DecoderMaskedMultiHeadAttention",
                 {"q": q, "k": k, "v": v, "pk": pk, "pv": pv,
                  "pseq": np.asarray([9], np.int32), "b": _f(rng, 3 * DD)},
                 input_names=["q", "k", "v", "", "", "pk", "pv", "pseq", "", "", "b"],
                 num_heads=2, past_present_share_buffer=1))


def test_dm_refusals():
    rng = np.random.default_rng(3)
    q = _f(rng, DB, 1, DD)
    pk = _f(rng, DB, 2, DML, DH)
    both_raise("cache_indirection", "DecoderMaskedMultiHeadAttention",
               {"q": q, "k": q, "v": q, "pk": pk, "pv": pk,
                "pseq": np.asarray([1], np.int32), "ci": np.zeros((DB, 2, DML), np.int32)},
               input_names=["q", "k", "v", "", "", "pk", "pv", "pseq", "", "ci"],
               num_heads=2, past_present_share_buffer=1)
    both_raise("share_buffer", "DecoderMaskedMultiHeadAttention",
               {"q": q, "k": q, "v": q, "pk": pk, "pv": pk, "pseq": np.asarray([1], np.int32)},
               input_names=["q", "k", "v", "", "", "pk", "pv", "pseq"], num_heads=2)
    both_raise("do_rotary", "DecoderMaskedMultiHeadAttention",
               {"q": q, "k": q, "v": q}, num_heads=2, do_rotary=1)


# --------------------------------------------------------- SparseAttention


def _dense_to_csr(dense):
    L, nb, _ = dense.shape
    rows = np.zeros((L, nb + 1), np.int32)
    cols_l = []
    for lay in range(L):
        cols = []
        for r in range(nb):
            cols.extend(np.nonzero(dense[lay, r])[0].tolist())
            rows[lay, r + 1] = len(cols)
        cols_l.append(cols)
    col_arr = np.full((L, max(len(c) for c in cols_l)), -1, np.int32)
    for lay, c in enumerate(cols_l):
        col_arr[lay, : len(c)] = c
    return rows, col_arr


def _layouts(num_layout, nb, seed=0, density=0.6):
    dense = np.random.default_rng(seed).uniform(size=(num_layout, nb, nb)) < density
    for lay in range(num_layout):
        np.fill_diagonal(dense[lay], True)
    return dense


def _sparse_case(seed, s, past_len, qh=4, kvh=2, head=8, L=16, block=4, num_layout=2,
                 diagonal=False):
    f = _gqa_case(seed, s, past_len, qh, kvh, head, L)
    f.pop("slk")
    dense = _layouts(num_layout, L // block, seed=seed + 100)
    if diagonal:  # only the diagonal blocks
        dense = np.zeros_like(dense[:1])
        idx = np.arange(dense.shape[1])
        dense[0, idx, idx] = True
    f["rows"], f["cols"] = _dense_to_csr(dense)
    f["ktl"] = (np.asarray(past_len) + s).astype(np.int32)
    return {k: f[k] for k in ("q", "k", "v", "pk", "pv", "rows", "cols", "tot", "ktl")}


SPARSE = [
    ("decode_step", lambda: (_sparse_case(0, 1, [5, 9]), None, dict(num_heads=4))),
    ("chunked_prefill_gqa_heads", lambda: (
        _sparse_case(1, 4, [6, 0, 2], qh=6, head=4, L=12, num_layout=3), None,
        dict(num_heads=6))),
    ("diagonal_only", lambda: (_sparse_case(2, 2, [6, 6], diagonal=True), None,
                               dict(num_heads=4))),
]


@pytest.mark.parametrize("name,case", SPARSE, ids=[c[0] for c in SPARSE])
def test_sparse_attention_matches_jax(name, case):
    inputs, names, attrs = case()
    want, got = both("SparseAttention", inputs, input_names=names, n_outputs=3,
                     kv_num_heads=2, sparse_block_size=4, **attrs)
    _check(want, got, caches=(1, 2))


def test_sparse_rotary_packed_qkv():
    rng = np.random.default_rng(3)
    b, s, qh, kvh, head, L = 2, 3, 4, 2, 8, 16
    past_len = np.asarray([5, 0])
    rows, cols = _dense_to_csr(_layouts(2, L // 4, seed=33))
    cos, sin = make_caches(32, 4)
    inputs = {"q": _f(rng, b, s, (qh + 2 * kvh) * head), "pk": _f(rng, b, kvh, L, head),
              "pv": _f(rng, b, kvh, L, head), "rows": rows, "cols": cols,
              "tot": np.asarray([8], np.int32), "ktl": (past_len + s).astype(np.int32),
              "cos": cos, "sin": sin}
    _check(*both("SparseAttention", inputs,
                 input_names=["q", "", "", "pk", "pv", "rows", "cols", "tot", "ktl", "cos",
                              "sin"],
                 num_heads=4, kv_num_heads=2, sparse_block_size=4, do_rotary=1))


def test_sparse_refusals():
    f = _sparse_case(4, 1, [5])
    both_raise("sparse_block_size", "SparseAttention", f, num_heads=4, kv_num_heads=2)
    both_raise("not divisible", "SparseAttention", f, num_heads=5, kv_num_heads=2,
               sparse_block_size=4)


# ---------------------------------------------------- the contrib norms


def test_simplified_layer_norm_both_domains_and_axes():
    rng = np.random.default_rng(2)
    x, w = _f(rng, 3, 7), _f(rng, 7)
    for domain in ("", "com.microsoft"):
        _check(*both("SimplifiedLayerNormalization", {"x": x, "w": w}, domain=domain,
                     epsilon=1e-5))
    # axis 1 of a 3-D input reduces over both trailing axes
    x3, w2 = _f(rng, 2, 3, 4), _f(rng, 3, 4)
    _check(*both("SimplifiedLayerNormalization", {"x": x3, "w": w2}, domain="",
                 axis=1, epsilon=1e-6))


def test_skip_layer_norms_with_their_outputs():
    rng = np.random.default_rng(3)
    x, skip = _f(rng, 2, 4, 8), _f(rng, 2, 4, 8)
    g, be, bias = _f(rng, 8), _f(rng, 8), _f(rng, 8)
    _check(*both("SkipLayerNormalization", {"x": x, "skip": skip, "g": g, "be": be,
                                            "bias": bias}, n_outputs=4, epsilon=1e-6))
    _check(*both("SkipSimplifiedLayerNormalization",
                 {"x": x, "skip": skip, "g": g, "bias": bias}, n_outputs=4, epsilon=1e-5))
    _check(*both("SkipSimplifiedLayerNormalization", {"x": x, "skip": skip, "g": g},
                 epsilon=1e-5))


# -------------------------------------------------- contrib RotaryEmbedding


def _rope_caches(max_pos, half):
    inv = 1.0 / (10000.0 ** (np.arange(half) / half))
    ang = np.arange(max_pos)[:, None] * inv[None, :]
    return {"cos": np.cos(ang).astype(np.float32), "sin": np.sin(ang).astype(np.float32)}


ROPE = [
    # test_contrib_rotary_embedding_input_order: 4-D input, [B, S] positions
    ("4d_position_ids", lambda rng: ({"x": _f(rng, 2, 3, 5, 8),
                                      "pos": rng.integers(0, 16, (2, 5)).astype(np.int64)},
                                     _rope_caches(16, 4), {})),
    # test_contrib_rotary_3d_inferred_heads_and_start_position: interleaved
    ("3d_inferred_heads_start", lambda rng: ({"x": _f(rng, 1, 4, 12),
                                              "pos": np.array([7], np.int64)},
                                             _rope_caches(32, 3), dict(interleaved=1))),
    ("3d_num_heads_partial_dim", lambda rng: ({"x": _f(rng, 2, 3, 16),
                                               "pos": np.array([2], np.int64)},
                                              _rope_caches(32, 4),
                                              dict(num_heads=2, rotary_embedding_dim=4))),
]


@pytest.mark.parametrize("name,case", ROPE, ids=[c[0] for c in ROPE])
def test_contrib_rotary_matches_jax(name, case):
    inputs, inits, attrs = case(np.random.default_rng(len(name)))
    _check(*both("RotaryEmbedding", inputs, inits, input_names=["x", "pos", "cos", "sin"],
                 **attrs))


def test_contrib_rotary_refusals():
    inputs = {"x": _f(np.random.default_rng(0), 1, 2, 8), "pos": np.array([0], np.int64)}
    kw = dict(inits=_rope_caches(8, 2), input_names=["x", "pos", "cos", "sin"])
    both_raise("scale", "RotaryEmbedding", inputs, scale=2.0, **kw)
    both_raise("is_packed_batching", "RotaryEmbedding", inputs, is_packed_batching=1, **kw)
    both_raise("num_heads is required", "RotaryEmbedding", inputs, rotary_embedding_dim=2,
               **kw)


# ----------------------------------------------------- the small contrib ops


def test_fused_matmul_quick_gelu_bias_gelu_fast_gelu():
    rng = np.random.default_rng(4)
    a, b = _f(rng, 5, 3), _f(rng, 7, 5)
    _check(*both("FusedMatMul", {"a": a, "b": b}, transA=1, transB=1, alpha=0.5))
    x, bias = _f(rng, 3, 8), _f(rng, 8)
    _check(*both("QuickGelu", {"x": x}))
    _check(*both("QuickGelu", {"x": x}, alpha=1.0))
    _check(*both("BiasGelu", {"x": x, "b": bias}))
    _check(*both("FastGelu", {"x": x, "b": bias}))
    _check(*both("FastGelu", {"x": x}))
    both_raise("transBatch", "FusedMatMul", {"a": a, "b": b}, transBatchA=1)


def test_embed_layer_norm():
    rng = np.random.default_rng(10)
    B, S, V, D, NS = 2, 5, 11, 8, 2
    inputs = {"ids": rng.integers(0, V, (B, S)).astype(np.int64),
              "seg": rng.integers(0, NS, (B, S)).astype(np.int64),
              "mask": np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1]], np.int32)}
    inits = {"we": _f(rng, V, D), "pe": _f(rng, S + 2, D), "se": _f(rng, NS, D),
             "g": _f(rng, D), "be": _f(rng, D)}
    want, got = both("EmbedLayerNormalization", inputs, inits,
                     input_names=["ids", "seg", "we", "pe", "se", "g", "be", "mask"],
                     n_outputs=3, epsilon=1e-12)
    _check(want, got)
    np.testing.assert_array_equal(got[1], [3, 5])


def test_ort_optimized_bert_block_composition():
    """JAX's EmbedLayerNormalization → Attention → SkipLayerNormalization →
    BiasGelu → SkipLayerNormalization block, as one graph."""
    rng = np.random.default_rng(11)
    B, S, V, D, H = 2, 4, 13, 8, 2

    def w(*s):
        return (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)

    inits = {"we": _f(rng, V, D) * 0.5, "pe": _f(rng, S, D) * 0.5,
             "g0": np.ones(D, np.float32), "b0": np.zeros(D, np.float32),
             "wqkv": w(D, 3 * D), "bqkv": _f(rng, 3 * D) * 0.1, "wo": w(D, D),
             "g1": _f(rng, D) * 0.1 + 1, "b1": _f(rng, D) * 0.1, "wup": w(D, 2 * D),
             "bup": _f(rng, 2 * D) * 0.1, "wdn": w(2 * D, D), "g2": _f(rng, D) * 0.1 + 1,
             "b2": _f(rng, D) * 0.1}

    def nodes(b):
        ms = dict(domain="com.microsoft")
        return [b.node("EmbedLayerNormalization", ["ids", "", "we", "pe", "", "g0", "b0"],
                       ["emb"], epsilon=1e-12, **ms),
                b.node("Attention", ["emb", "wqkv", "bqkv"], ["att"], num_heads=H, **ms),
                b.node("MatMul", ["att", "wo"], ["ao"]),
                b.node("SkipLayerNormalization", ["ao", "emb", "g1", "b1"], ["h1"],
                       epsilon=1e-12, **ms),
                b.node("MatMul", ["h1", "wup"], ["up"]),
                b.node("BiasGelu", ["up", "bup"], ["act"], **ms),
                b.node("MatMul", ["act", "wdn"], ["dn"]),
                b.node("SkipLayerNormalization", ["dn", "h1", "g2", "b2"], ["y"],
                       epsilon=1e-12, **ms)]

    inputs = {"ids": rng.integers(0, V, (B, S)).astype(np.int64)}
    bs = _bytes(ob, nodes(ob), inputs, ["y"], inits, 17)
    assert bs == _bytes(job, nodes(job), inputs, ["y"], inits, 17)
    _check(*_run_both(bs, inputs))


# ------------------------------------- the quantized gathers and products


def test_gather_block_quantized_forms():
    rng = np.random.default_rng(14)
    q = rng.integers(-8, 8, (7, 32)).astype(np.int8)
    scales = (rng.random((7, 2)) + 0.5).astype(np.float32)
    zp = rng.integers(-8, 8, (7, 2)).astype(np.int8)
    idx = np.array([[3, 0], [6, 2]], np.int64)
    kw = dict(gather_axis=0, quantize_axis=1, block_size=16)
    # int8 data, int8 zero points
    _check(*both("GatherBlockQuantized", {"idx": idx}, {"d": q, "s": scales, "z": zp},
                 input_names=["d", "idx", "s", "z"], **kw))
    # uint8 packed two a byte, default zero point
    qu = rng.integers(0, 16, (5, 32)).astype(np.uint8)
    packed = (qu[:, 0::2] | (qu[:, 1::2] << 4)).astype(np.uint8)
    _check(*both("GatherBlockQuantized", {"idx": np.array([4, 1, 1], np.int64)},
                 {"d": packed, "s": scales[:5]}, input_names=["d", "idx", "s"], **kw))
    # packed 4-bit zero points on the packed data
    zpk = rng.integers(0, 256, (5, 1)).astype(np.uint8)
    _check(*both("GatherBlockQuantized", {"idx": np.array([0, 3], np.int64)},
                 {"d": packed, "s": scales[:5], "z": zpk}, input_names=["d", "idx", "s", "z"],
                 **kw))
    # gather along axis 1 while axis 0 is quantized; ceil block count
    q2 = rng.integers(-8, 8, (20, 6)).astype(np.int8)
    sc2 = (rng.random((2, 6)) + 0.5).astype(np.float32)
    _check(*both("GatherBlockQuantized", {"idx": np.array([5, 0], np.int64)},
                 {"d": q2, "s": sc2}, input_names=["d", "idx", "s"], gather_axis=1,
                 quantize_axis=0, block_size=16))


@pytest.mark.parametrize("signed", [True, False])
def test_gather_block_quantized_int4_tensors(signed):
    """4-bit data and zero points as int4 / uint4 TensorProtos (the loader's
    Int4Array)."""
    rng = np.random.default_rng(15 + signed)
    lo, hi = (-8, 8) if signed else (0, 16)
    q = rng.integers(lo, hi, (6, 32))
    z = rng.integers(lo, hi, (6, 2))
    s = (rng.random((6, 2)) + 0.5).astype(np.float32)
    idx = np.array([5, 1, 2], np.int64)

    def graph(b):
        return b.build_model_bytes(
            [b.node("GatherBlockQuantized", ["d", "idx", "s", "z"], ["y"],
                    domain="com.microsoft", gather_axis=0, quantize_axis=1, block_size=16)],
            inputs=[b.vi_from_array("idx", idx)], outputs=[b.value_info("y", 1, [])],
            initializers=[b.tensor_int4(q, "d", signed=signed), b.tensor_from_array(s, "s"),
                          b.tensor_int4(z, "z", signed=signed)], opset=21)

    bs = graph(ob)
    assert bs == graph(job)
    want, got = _run_both(bs, {"idx": idx})
    _check(want, got)
    deq = (q - np.repeat(z, 16, 1)) * np.repeat(s, 16, 1)
    np.testing.assert_allclose(got[0], deq[idx], rtol=1e-6)


@pytest.mark.parametrize("quant_type", [0, 1])
def test_matmul_bnb4(quant_type):
    rng = np.random.default_rng(17)
    n, k, block = 6, 16, 32
    codes = rng.integers(0, 16, n * k).astype(np.uint8)
    absmax = (rng.random(-(-n * k // block)) + 0.5).astype(np.float32)
    packed = ((codes[0::2] << 4) | codes[1::2]).astype(np.uint8)
    _check(*both("MatMulBnb4", {"a": _f(rng, 3, k)}, {"b": packed, "m": absmax},
                 input_names=["a", "b", "m"], K=k, N=n, block_size=block,
                 quant_type=quant_type))


# ------------------------------------------------ dispatch and the registries


def test_port_registers_every_contrib_and_genai_emitter():
    import lele_tpu.ops  # noqa: F401  (registers JAX's emitters)
    import lele_tpu.ops.registry as jreg
    import lele_tpu_torch.ops  # noqa: F401
    import lele_tpu_torch.ops.registry as treg

    mods = ("lele_tpu.ops.contrib_ops", "lele_tpu.ops.genai_ops")
    jc = {k for k, v in jreg.CONTRIB_OPS.items() if v.fn.__module__ in mods}
    jd = {k for k, v in jreg.OPS.items() if v.fn.__module__ in mods}
    assert len(jc) == 18 and jd == {"SimplifiedLayerNormalization"}
    assert jc <= set(treg.CONTRIB_OPS) and jd <= set(treg.OPS)
    for key in jc:  # each in the port's module of the same name
        assert treg.CONTRIB_OPS[key].fn.__module__.replace("_torch", "") == \
            jreg.CONTRIB_OPS[key].fn.__module__, key
    # the aliases: every port row is JAX's, and its target is ported
    assert set(treg.CONTRIB_ALIASES.items()) <= set(jreg.CONTRIB_ALIASES.items())
    for key, target in treg.CONTRIB_ALIASES.items():
        assert treg.lookup_op(*key) is treg.OPS[target]
    missing = set(jreg.CONTRIB_ALIASES) - set(treg.CONTRIB_ALIASES)
    assert all(jreg.CONTRIB_ALIASES[k] not in treg.OPS for k in missing)


def test_lookup_op_contract():
    from lele_tpu_torch.ops.registry import CONTRIB_OPS, OPS, canon_domain, lookup_op

    assert canon_domain("ai.onnx") == "" and canon_domain(None) == ""
    assert lookup_op("ai.onnx", "MatMul") is OPS["MatMul"]
    ms_rot = lookup_op("com.microsoft", "RotaryEmbedding")
    assert ms_rot is CONTRIB_OPS[("com.microsoft", "RotaryEmbedding")]
    assert ms_rot is not OPS["RotaryEmbedding"]
    assert lookup_op("com.microsoft", "Attention") is not OPS["Attention"]
    assert lookup_op("", "SimplifiedLayerNormalization") is not None
    assert lookup_op("com.microsoft", "SimplifiedLayerNormalization") is not None
    assert lookup_op("", "GroupQueryAttention") is None
    assert lookup_op("com.microsoft", "Conv") is None
    assert lookup_op("ai.onnx.ml", "TreeEnsemble") is None


def test_declared_aliases_reach_default_emitters():
    """com.microsoft::Gelu and ::Range give JAX's outputs (the alias table)."""
    x = np.linspace(-2, 2, 12, dtype=np.float32).reshape(3, 4)
    _check(*both("Gelu", {"x": x}, opset=20))
    inits = {"a": np.asarray(1.0, np.float32), "l": np.asarray(4.0, np.float32),
             "d": np.asarray(0.5, np.float32)}
    want, got = both("Range", {}, inits, input_names=["a", "l", "d"])
    _check(want, got)
    np.testing.assert_array_equal(got[0], np.arange(1.0, 4.0, 0.5, dtype=np.float32))


def test_unknown_and_colliding_contrib_ops_refused():
    x = np.zeros((2, 3), np.float32)
    both_raise("com.microsoft::NotAnOp", "NotAnOp", {"x": x})
    # ai.onnx has Softmax; com.microsoft declares none: the refusal names the tables
    both_raise("CONTRIB_ALIASES|CONTRIB_OPS", "Softmax", {"x": x})


# ------------------------------------------------ the GenAI decoder, whole

PREFILL, STEPS = 4, 6


def _genai_cfgs():
    from lele_tpu_torch.onnx.synth import GENAI_CFG, GENAI_MOE_CFG

    return {"dense": GENAI_CFG, "moe": GENAI_MOE_CFG}


@pytest.mark.parametrize("form", ["dense", "moe"])
def test_genai_builders_give_jax_bytes(form):
    from lele_tpu.onnx import synth as jsynth
    from lele_tpu_torch.onnx import synth

    cfg = _genai_cfgs()[form]
    inits, deq = synth.genai_decoder_params(np.random.default_rng(0), cfg)
    jinits, jdeq = jsynth.genai_decoder_params(np.random.default_rng(0), cfg)
    assert list(inits) == list(jinits) and list(deq) == list(jdeq)
    for k in inits:
        assert inits[k].dtype == jinits[k].dtype and np.array_equal(inits[k], jinits[k]), k
    for s in (PREFILL, 1):
        assert synth.build_genai_decoder(inits, s, cfg) == jsynth.build_genai_decoder(
            jinits, s, cfg)
    np.testing.assert_array_equal(synth.quant4_ort(deq["emb"][:4, :16], 8)[0],
                                  jsynth.quant4_ort(deq["emb"][:4, :16], 8)[0])


def _save_genai(tmp_path, inits, s, cfg, name):
    from lele_tpu_torch.onnx import synth

    p = tmp_path / f"{name}.onnx"
    # a low threshold, so the small config's projections land in the side file
    ob.save_with_external_data(synth.build_genai_decoder(inits, s, cfg, raw=True), p,
                               size_threshold=64)
    return p


def _rollout(step_pre, step_dec, cfg, ids0, fed=None):
    """Prefill ids0, then STEPS greedy tokens: [(logits, caches)] a step.
    `fed`, a list, collects each step's feeds."""
    from lele_tpu_torch.onnx.synth import genai_feeds

    B, nl, kvh, L, hd = (cfg[k] for k in ("B", "nl", "kvh", "L", "hd"))
    pks = [np.zeros((B, kvh, L, hd), np.float32) for _ in range(nl)]
    pvs = [np.zeros((B, kvh, L, hd), np.float32) for _ in range(nl)]
    pos = np.broadcast_to(np.arange(PREFILL), (B, PREFILL)).astype(np.int64)
    feeds = genai_feeds(ids0, pos, 0, PREFILL, pks, pvs, cfg)
    trail, run = [], step_pre
    for step in range(STEPS + 1):
        if fed is not None:
            fed.append(feeds)
        outs = [np.asarray(o) for o in run(**feeds)]
        pks, pvs = outs[1::2], outs[2::2]
        trail.append(outs)
        tok = outs[0][:, -1].argmax(-1)[:, None].astype(np.int64)
        plen = PREFILL + step
        feeds = genai_feeds(tok, np.full((B, 1), plen, np.int64), plen, 1, pks, pvs, cfg)
        run = step_dec
    return trail


@pytest.mark.parametrize("form", ["dense", "moe"])
def test_genai_decoder_rollout_matches_jax(tmp_path, form):
    """Prefill 4 and 6 greedy steps through both packages, each compiled from
    the same model.onnx + model.onnx.data: the port's per-op route (JAX's
    CPU route), logits and every present cache at JAX's tolerances, tokens
    equal; the fused routes (MatMulNBits and QMoE on kernel 7's plain
    version) with their pattern hits, the f32 one at JAX's tolerances on
    each step's feeds."""
    from lele_tpu_torch.onnx import synth

    cfg = _genai_cfgs()[form]
    inits, _ = synth.genai_decoder_params(np.random.default_rng(0), cfg)
    pre, dec = (_save_genai(tmp_path, inits, s, cfg, f"s{s}") for s in (PREFILL, 1))
    m = OnnxModel.load(dec)
    ext = [n for n, t in m.initializers.items() if int(t.data_location) == 1]
    assert "emb" in ext and f"wq{cfg['nl'] - 1}_q" in ext
    ids0 = np.random.default_rng(1).integers(0, cfg["V"], (cfg["B"], PREFILL)).astype(np.int64)

    jax_trail = _rollout(jcompile(JOnnxModel.load(pre), strict=True).run_np,
                         jcompile(JOnnxModel.load(dec), strict=True).run_np, cfg, ids0)
    cms = [compile_model(str(p), strict=True, patterns=[], device="cpu") for p in (pre, dec)]
    fed = []
    trail = _rollout(cms[0].run_np, cms[1].run_np, cfg, ids0, fed)
    for want, got in zip(jax_trail, trail):
        _check(want, got, caches=tuple(range(1, len(got))))
        np.testing.assert_array_equal(got[0][:, -1].argmax(-1), want[0][:, -1].argmax(-1))

    # the default route: every MatMulNBits the kernel takes K a multiple of
    # 2·block (the small config's down projection, K = ffn 48 at block 16,
    # keeps the emitter, as in JAX), QMoE's decode step (rows·k <= experts)
    # on the indexed entry
    fused = [compile_model(str(p), strict=True, device="cpu") for p in (pre, dec)]
    down = cfg["ffn"] % (2 * cfg["blk"]) == 0
    n_nbits = cfg["nl"] * (4 if cfg.get("experts") else 6 + down) + 1
    for cm in fused:
        assert cm.stats["pattern_hits"]["matmul_nbits_w4"] == 2 * n_nbits
    if cfg.get("experts"):
        assert fused[1].stats["pattern_hits"]["qmoe_w4"] == 2 * cfg["nl"]
    # kernel 7's exact f32 form (F32_NBITS_PATTERNS) on each step's feeds:
    # the per-op route's logits and caches at JAX's tolerances; the bf16 form
    # finite, its shapes the per-op route's
    f32 = [compile_model(str(p), strict=True, device="cpu", patterns=F32_NBITS_PATTERNS)
           for p in (pre, dec)]
    for i, (want, feeds) in enumerate(zip(trail, fed)):
        _check(want, f32[min(i, 1)].run_np(**feeds), caches=tuple(range(1, len(want))))
        got = fused[min(i, 1)].run_np(**feeds)
        assert [g.shape for g in got] == [w.shape for w in want]
        assert all(np.isfinite(g).all() for g in got)


def test_genai_donation_pairs_each_cache_with_its_own_present():
    """donate= in graph order pairs pk_i with npk_i and pv_i with npv_i (the
    pairing takes the first free output of the input's shape and type)."""
    from lele_tpu_torch.onnx import synth

    cfg = _genai_cfgs()["dense"]
    inits, _ = synth.genai_decoder_params(np.random.default_rng(0), cfg)
    donate = [f"p{kv}{i}" for i in range(cfg["nl"]) for kv in "kv"]
    cm = compile_model(synth.build_genai_decoder(inits, 1, cfg), device="cpu", donate=donate)
    names = cm.output_names
    assert {k: names[j] for k, j in cm.donated.items()} == {n: "n" + n for n in donate}


def test_hoisted_weights_are_contiguous():
    """Every value the trace hoists to the device is C-ordered: kernel 7's
    repacked planes come from a transposed host array, and a transposed
    param would be copied again by the wrapper's `.contiguous()` at every
    call."""
    from lele_tpu_torch.onnx import synth

    cfg = _genai_cfgs()["dense"]
    inits, _ = synth.genai_decoder_params(np.random.default_rng(0), cfg)
    cm = compile_model(synth.build_genai_decoder(inits, 1, cfg), device="cpu")
    packed = [n for n in cm.params if n.endswith("::w4pk")]
    assert len(packed) == cm.stats["pattern_hits"]["matmul_nbits_w4"] // 2
    assert all(t.is_contiguous() for t in cm.params.values())
