"""The port's opset-23 attention-family emitters against the JAX package's.

Every case of tests/test_attention_ops.py (AffineGrid's apart: they replay
through tests/test_torch_port_ops_extra.py) is built once as ONNX bytes and
compiled by both packages; the two outputs are compared at that test's
tolerance (Attention rtol 2e-5, atol
2e-6; RotaryEmbedding 1e-5 / 1e-6; Swish 1e-6 / 1e-7; TensorScatter exact to
1e-6), and the error paths must raise on both sides. Added: the
softmax_precision attribute, every qk_matmul_output_mode tap, and the
RMSNormalization and Gelu (both forms) emitters the Phi-3 and GPT-2-style
step graphs use. These shapes are not flash-eligible, so both sides take the
einsum path; tests/test_torch_port_flash.py holds the flash route.
"""

import numpy as np
import pytest

from lele_tpu.compiler import compile_model as j_compile
from lele_tpu.onnx.loader import OnnxModel as JOnnxModel
from lele_tpu_torch.compiler import compile_model
from lele_tpu_torch.onnx import builder as ob
from lele_tpu_torch.ops import attention_ops

B, H, KVH, LQ, LK, D = 2, 4, 2, 5, 7, 8
ATT = dict(rtol=2e-5, atol=2e-6)


def _bytes(op_type, inputs, n_outputs=1, initializers=None, input_names=None, opset=17,
           **attrs):
    initializers = initializers or {}
    in_names = input_names or list(inputs) + list(initializers)
    out_names = [f"out{i}" for i in range(n_outputs)]
    return ob.build_model_bytes(
        [ob.node(op_type, in_names, out_names, **attrs)],
        inputs=[ob.value_info(k, ob.NP_TO_ONNX[np.asarray(v).dtype], list(np.shape(v)))
                for k, v in inputs.items()],
        outputs=[ob.value_info(o, 1, []) for o in out_names],
        initializers=[ob.tensor_from_array(v, k) for k, v in initializers.items()],
        opset=opset)


def _both(op_type, inputs, **kw):
    """(port outputs, JAX outputs) of one node on the same bytes and inputs."""
    bs = _bytes(op_type, inputs, **kw)
    got = compile_model(bs, device="cpu", strict=True).run_np(**inputs)
    want = j_compile(JOnnxModel.from_bytes(bs), strict=True).run_np(**inputs)
    assert len(got) == len(want)
    return got, want


def _close(got, want, **tol):
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, (g.shape, w.shape, g.dtype, w.dtype)
        np.testing.assert_allclose(g, w, **tol)


def _qkv(rng, h=H, kvh=H, lq=LQ, lk=LK, d=D):
    q = rng.standard_normal((B, h, lq, d)).astype(np.float32)
    k = rng.standard_normal((B, kvh, lk, d)).astype(np.float32)
    v = rng.standard_normal((B, kvh, lk, d)).astype(np.float32)
    return q, k, v


def _att(q, k, v, **kw):
    return _both("Attention", {"q": q, "k": k, "v": v}, **kw)


def test_attention_basic_4d():
    before = dict(attention_ops.ATTENTION_ROUTES)
    _close(*_att(*_qkv(np.random.default_rng(0))), **ATT)
    assert attention_ops.ATTENTION_ROUTES["einsum"] > before["einsum"]
    assert attention_ops.ATTENTION_ROUTES["flash_attn"] == before["flash_attn"]


def test_attention_causal():
    _close(*_att(*_qkv(np.random.default_rng(1)), is_causal=1), **ATT)


def test_attention_causal_lq_ne_lk():
    """Top-left alignment where Lq != Lk (the spec's torch sdpa rule)."""
    _close(*_att(*_qkv(np.random.default_rng(25), lq=7, lk=5), is_causal=1), **ATT)


@pytest.mark.parametrize("kind", ["float", "bool"])
def test_attention_masks(kind):
    rng = np.random.default_rng(2 if kind == "float" else 3)
    q, k, v = _qkv(rng)
    if kind == "float":
        mask = (rng.standard_normal((B, 1, LQ, LK)) * 2).astype(np.float32)
    else:
        mask = rng.random((B, 1, LQ, LK)) > 0.3
        mask[..., 0] = True  # keep every row attendable
    got, want = _both("Attention", {"q": q, "k": k, "v": v, "mask": mask},
                      input_names=["q", "k", "v", "mask"])
    _close(got, want, **ATT)


def test_attention_bool_mask_with_causal_and_a_fully_masked_row():
    rng = np.random.default_rng(26)
    q, k, v = _qkv(rng, lq=6, lk=6)
    mask = rng.random((B, 1, 6, 6)) > 0.3
    mask[0, 0, 2] = False  # finfo.min everywhere: the row's uniform average
    got, want = _both("Attention", {"q": q, "k": k, "v": v, "mask": mask},
                      input_names=["q", "k", "v", "mask"], is_causal=1)
    _close(got, want, **ATT)


def test_attention_gqa():
    _close(*_att(*_qkv(np.random.default_rng(4), kvh=KVH)), **ATT)


def test_attention_scale_attr():
    _close(*_att(*_qkv(np.random.default_rng(5)), scale=0.05), **ATT)


def test_attention_past_kv_and_present():
    rng = np.random.default_rng(6)
    q, k, v = _qkv(rng)
    pk = rng.standard_normal((B, H, 3, D)).astype(np.float32)
    pv = rng.standard_normal((B, H, 3, D)).astype(np.float32)
    got, want = _both("Attention", {"q": q, "k": k, "v": v, "pk": pk, "pv": pv},
                      input_names=["q", "k", "v", "", "pk", "pv"], n_outputs=3)
    _close(got, want, **ATT)
    np.testing.assert_array_equal(got[1], np.concatenate([pk, k], 2))


def test_attention_3d_form():
    rng = np.random.default_rng(7)
    q = rng.standard_normal((B, LQ, H * D)).astype(np.float32)
    k = rng.standard_normal((B, LK, KVH * D)).astype(np.float32)
    v = rng.standard_normal((B, LK, KVH * D)).astype(np.float32)
    _close(*_att(q, k, v, q_num_heads=H, kv_num_heads=KVH), **ATT)


def test_attention_softcap():
    _close(*_att(*_qkv(np.random.default_rng(8)), softcap=5.0), **ATT)


@pytest.mark.parametrize("mode", [0, 1, 2, 3])
def test_attention_qk_output_modes(mode):
    rng = np.random.default_rng(9)
    q, k, v = _qkv(rng)
    mask = (rng.standard_normal((B, 1, LQ, LK))).astype(np.float32)
    got, want = _both("Attention", {"q": q, "k": k, "v": v, "mask": mask},
                      input_names=["q", "k", "v", "mask"], n_outputs=4,
                      qk_matmul_output_mode=mode, softcap=3.0)
    _close(got, want, **ATT)


def test_attention_softmax_precision():
    rng = np.random.default_rng(27)
    q, k, v = (a.astype(np.float16) for a in _qkv(rng))
    got, want = _att(q, k, v, softmax_precision=1)  # f32 softmax of f16 scores
    _close(got, want, rtol=5e-3, atol=5e-3)


def test_attention_fp16_dtype_carried():
    """Half inputs: softmax runs in f32 internally, output returns f16."""
    rng = np.random.default_rng(21)
    q, k, v = (a.astype(np.float16) for a in _qkv(rng))
    got, want = _att(q, k, v)
    assert got[0].dtype == np.float16
    _close(got, want, rtol=5e-3, atol=5e-3)


def test_attention_error_paths():
    rng = np.random.default_rng(22)
    q, k, v = _qkv(rng)
    q3 = rng.standard_normal((B, LQ, H * D)).astype(np.float32)
    k3 = rng.standard_normal((B, LK, H * D)).astype(np.float32)
    kbad = rng.standard_normal((B, 3, LK, D)).astype(np.float32)
    for inputs, match in (({"q": q3, "k": k3, "v": k3}, "q_num_heads"),
                          ({"q": q, "k": kbad, "v": kbad}, "divisible")):
        bs = _bytes("Attention", inputs)
        with pytest.raises(Exception, match=match):
            compile_model(bs, device="cpu", strict=True)
        with pytest.raises(Exception, match=match):
            j_compile(JOnnxModel.from_bytes(bs), strict=True)


def test_rotary_requires_num_heads_for_3d():
    rng = np.random.default_rng(23)
    x = rng.standard_normal((B, LQ, H * D)).astype(np.float32)
    cos = rng.standard_normal((B, LQ, D // 2)).astype(np.float32)
    bs = _bytes("RotaryEmbedding", {"x": x, "cos": cos, "sin": cos})
    with pytest.raises(Exception, match="num_heads"):
        compile_model(bs, device="cpu", strict=True)
    with pytest.raises(Exception, match="num_heads"):
        j_compile(JOnnxModel.from_bytes(bs), strict=True)


def test_tensor_scatter_rejects_batch_axis():
    rng = np.random.default_rng(24)
    cache = rng.standard_normal((B, H, 8, D)).astype(np.float32)
    upd = rng.standard_normal((B, H, 2, D)).astype(np.float32)
    bs = _bytes("TensorScatter", {"c": cache, "u": upd}, axis=0)
    with pytest.raises(Exception, match="axis"):
        compile_model(bs, device="cpu", strict=True)
    with pytest.raises(Exception, match="axis"):
        j_compile(JOnnxModel.from_bytes(bs), strict=True)


@pytest.mark.parametrize("interleaved", [0, 1])
def test_rotary_with_position_ids(interleaved):
    rng = np.random.default_rng(10)
    x = rng.standard_normal((B, H, LQ, D)).astype(np.float32)
    maxp = 16
    inv = 1.0 / 10000 ** (np.arange(D // 2) / (D // 2))
    t = np.arange(maxp)[:, None] * inv[None, :]
    cos, sin = np.cos(t).astype(np.float32), np.sin(t).astype(np.float32)
    pos = rng.integers(0, maxp, (B, LQ)).astype(np.int64)
    got, want = _both("RotaryEmbedding", {"x": x, "pos": pos},
                      initializers={"cos": cos, "sin": sin},
                      input_names=["x", "cos", "sin", "pos"], interleaved=interleaved)
    _close(got, want, rtol=1e-5, atol=1e-6)


def test_rotary_partial_dim_3d():
    rng = np.random.default_rng(11)
    x = rng.standard_normal((B, LQ, H * D)).astype(np.float32)
    r = D // 2
    cos = rng.standard_normal((B, LQ, r // 2)).astype(np.float32)
    sin = rng.standard_normal((B, LQ, r // 2)).astype(np.float32)
    got, want = _both("RotaryEmbedding", {"x": x, "cos": cos, "sin": sin}, num_heads=H,
                      rotary_embedding_dim=r)
    _close(got, want, rtol=1e-5, atol=1e-6)


def test_swish():
    x = np.random.default_rng(12).standard_normal((4, 9)).astype(np.float32)
    _close(*_both("Swish", {"x": x}, alpha=0.7), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("mode,wi", [("linear", [2, 6]), ("circular", [2, 8]),
                                     ("linear", [9, -1])])
def test_tensor_scatter(mode, wi):
    """In-bounds linear writes, circular wrap (8+4 past 10), and linear
    starts out of range, which both sides wrap and clamp as dynamic_update_slice
    does."""
    rng = np.random.default_rng(13)
    cache = rng.standard_normal((B, H, 10, D)).astype(np.float32)
    upd = rng.standard_normal((B, H, 4, D)).astype(np.float32)
    wi = np.array(wi, dtype=np.int64)
    got, want = _both("TensorScatter", {"cache": cache, "upd": upd, "wi": wi}, mode=mode)
    _close(got, want, rtol=1e-6)


def test_tensor_scatter_other_axis_and_default_index():
    rng = np.random.default_rng(28)
    cache = rng.standard_normal((B, 6, H, D)).astype(np.float32)
    upd = rng.standard_normal((B, 2, H, D)).astype(np.float32)
    got, want = _both("TensorScatter", {"cache": cache, "upd": upd}, axis=1)
    _close(got, want, rtol=1e-6)


@pytest.mark.parametrize("axis", [-1, 1])
def test_rms_normalization(axis):
    rng = np.random.default_rng(29)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32) * 3
    g = (1 + 0.1 * rng.standard_normal(16 if axis == -1 else (5, 1))).astype(np.float32)
    got, want = _both("RMSNormalization", {"x": x}, initializers={"g": g}, opset=23,
                      axis=axis, epsilon=1e-5)
    _close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("approximate", ["none", "tanh"])
def test_gelu(approximate):
    x = np.random.default_rng(30).standard_normal((3, 40)).astype(np.float32) * 3
    got, want = _both("Gelu", {"x": x}, opset=20, approximate=approximate)
    _close(got, want, rtol=1e-6, atol=1e-6)
