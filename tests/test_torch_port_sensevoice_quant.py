"""The port's dynamic-int8 SenseVoice (`quantized=True`) and MoE FFN against
lele_tpu's, at small sizes.

Weights are made by the JAX package and carried over with
`from_numpy_tree`; the quantized forward carries JAX's prepared tree across,
so both sides multiply the same codes. PCM and features are made with numpy
from seeds. On the CPU the port's kernels 11 and 5 take their plain
versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lele_tpu.models import SenseVoiceConfig as JConfig
from lele_tpu.models import SenseVoiceModel as JModel
from lele_tpu.models.common import cast_big_params as jcast
from lele_tpu.models.sensevoice import moe_ffn as jmoe_ffn
from lele_tpu.models.sensevoice import prepare_quantized_params as jprepare
from lele_tpu.models.sensevoice import sensevoice_encode as jencode
from lele_tpu_torch.models import (
    SenseVoiceConfig,
    SenseVoiceModel,
    moe_ffn,
    prepare_quantized_params,
    sensevoice_encode,
    stack_layer_params,
)
from lele_tpu_torch.models import sensevoice as sv
from lele_tpu_torch.params import from_numpy_tree

QSMALL = dict(n_layers=2, d_model=256, n_heads=2, ffn_dim=384, vocab_size=64,
              quantized=True)
# the same features and the same codes: only f32 summation orders differ
# (the first run read 1.8e-6 with bf16 attention, 4.7e-7 in f32)
SAME_FEATS_REL = 1e-5
# from PCM: a last-bit difference of the front-end moves DQL codes, which
# the int8 layers carry (the first run read 1.1e-2, argmax agreement 1.0);
# JAX's own quantized tolerance (tests/test_models.py:58-71)
QUANT_REL = 0.05
ARGMAX_AGREE = 0.98
# f32 SenseVoice with MoE: only summation orders differ (read 5.0e-5, and
# 1.1e-7 for moe_ffn alone)
F32_REL = 1e-4


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


def _pcm(seconds, seed):
    return (np.random.default_rng(seed).standard_normal(int(seconds * 16000))
            * 0.1).astype(np.float32)


@pytest.fixture(scope="module")
def jax_quant():
    """The JAX model's f32 masters and its prepared quantized tree."""
    m = JModel(JConfig(**QSMALL))
    m.init(0)
    return m, _np_tree(m.params), _np_tree(jprepare(m.params))


@pytest.mark.parametrize("bf16", [False, True], ids=["f32_masters", "bf16_masters"])
def test_prepare_quantized_params_matches_jax(bf16):
    """At the main path's layer widths (d512, ffn 2048). JAX prepares under
    jit, where XLA may rewrite w / w_scale; the first run found every code
    equal (0 of 3,145,728 differ by one, both masters), so the gate is at
    most one code in 10^4 and never more than one step; each side's wscale
    and colsum agree with its own codes."""
    m = JModel(JConfig(n_layers=1, vocab_size=64, quantized=True))
    m.init(1)
    src = _np_tree(jcast(m.params, jnp.bfloat16) if bf16 else m.params)
    want = _np_tree(jprepare(src))
    got = prepare_quantized_params(from_numpy_tree(src), drop_fp=True)
    assert "wq" not in got["ctc"]  # the CTC head stays a float linear
    n = moved = 0
    for g, w in ((gl[k], wl[k]) for gl, wl in zip(got["layers"], want["layers"])
                 for k in ("qkv", "out", "ffn1", "ffn2")):
        assert "w" not in g and g["wq"].dtype == torch.int8 and g["wscale"].dim() == 0
        gq, wq = g["wq"].numpy().astype(np.int32), w["wq"].astype(np.int32)
        n, moved = n + gq.size, moved + int((gq != wq).sum())
        assert np.abs(gq - wq).max() <= 1
        np.testing.assert_allclose(g["wscale"].item(), float(w["wscale"]), rtol=1e-7)
        np.testing.assert_array_equal(g["wcolsum"].numpy(), gq.sum(0))
        np.testing.assert_array_equal(w["wcolsum"], wq.sum(0))
    assert n == 3_145_728 and moved <= n // 10_000, (moved, n)


@pytest.mark.parametrize("quant_pallas", [False, True], ids=["kernel11", "kernel5"])
@pytest.mark.parametrize("stacked", [False, True], ids=["per_layer", "stacked"])
def test_quantized_forward_matches_jax(jax_quant, quant_pallas, stacked):
    """Both routes, on JAX's prepared codes: the encoder on the same
    features, and the whole forward from PCM."""
    jm, _, prepared = jax_quant
    jcfg = JConfig(**QSMALL, quant_pallas=quant_pallas)
    cfg = SenseVoiceConfig(**QSMALL, quant_pallas=quant_pallas)
    tp = from_numpy_tree(prepared)
    if stacked:
        tp = stack_layer_params(tp)
    pcm = _pcm(1.9, 5)
    feats = np.array(jm.fbank(pcm))[None]
    mask = np.ones(feats.shape[:2], np.float32)
    want = np.asarray(jax.jit(lambda p, f, m: jencode(p, f, m, jcfg))(prepared, feats, mask))
    got = sensevoice_encode(tp, torch.from_numpy(feats), torch.from_numpy(mask), cfg).numpy()
    assert _rel(got, want) <= SAME_FEATS_REL, _rel(got, want)
    jm_q = JModel(jcfg, params=prepared, fbank=jm.fbank)
    want = np.asarray(jax.jit(jm_q.forward_fn())(prepared, pcm))
    got = SenseVoiceModel(cfg, device="cpu").forward_fn()(tp, pcm).numpy()
    assert got.shape == want.shape == (1, 4 + 32, 64)
    agree = (got.argmax(-1) == want.argmax(-1)).mean()
    assert _rel(got, want) <= QUANT_REL and agree >= ARGMAX_AGREE, (_rel(got, want), agree)


def test_kernel11_and_kernel5_routes_agree_exactly(jax_quant):
    """The same integer sums and the same f32 dequant on both routes."""
    _, _, prepared = jax_quant
    tp = stack_layer_params(from_numpy_tree(prepared))
    pcm = _pcm(1.3, 6)
    a = SenseVoiceModel(SenseVoiceConfig(**QSMALL), device="cpu").forward_fn()(tp, pcm)
    b = SenseVoiceModel(SenseVoiceConfig(**QSMALL, quant_pallas=True),
                        device="cpu").forward_fn()(tp, pcm)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("quant_pallas", [False, True], ids=["kernel11", "kernel5"])
def test_quantized_layers_route_every_linear_to_its_kernel(jax_quant, monkeypatch,
                                                           quant_pallas):
    """Four linears a layer go to kernel 11 (flattened [B·T, K] rows) or
    kernel 5, and no other kernel runs; the CTC head stays a plain linear."""
    _, _, prepared = jax_quant
    calls = {"i8": [], "dq": [], "other": 0}

    def spy(role, fn):
        def wrapped(x, *args):
            calls[role].append(tuple(x.shape))
            return fn(x, *args)
        return wrapped

    def other(*args):
        calls["other"] += 1
        raise AssertionError("a w8/w4/layer/stack kernel ran on a quantized model")

    kernels = {k: other for k in sv._KERNELS}
    kernels.update(i8=spy("i8", sv._KERNELS["i8"]), dq=spy("dq", sv._KERNELS["dq"]))
    monkeypatch.setattr(sv, "_KERNELS", kernels)
    tp = stack_layer_params(from_numpy_tree(prepared))
    model = SenseVoiceModel(SenseVoiceConfig(**QSMALL, quant_pallas=quant_pallas),
                            device="cpu")
    model.forward_fn()(tp, _pcm(1.3, 7))
    role = "dq" if quant_pallas else "i8"
    T = 4 + 22
    assert calls[role] == [(T, 256), (T, 256), (T, 256), (T, 384)] * 2
    assert not calls["dq" if role == "i8" else "i8"] and calls["other"] == 0


def test_inline_and_drop_fp_agree_with_prepared(jax_quant):
    """The inline weight quantizes per tensor each call: the prepared tree's
    codes, so the logits agree (JAX's gate, tests/test_models.py:375-390:
    atol 1e-4); drop_fp keeps a quarter of the layer-weight bytes and runs."""
    _, f32, _ = jax_quant
    cfg = SenseVoiceConfig(**QSMALL)
    model = SenseVoiceModel(cfg, device="cpu")
    params = from_numpy_tree(f32)
    pcm = _pcm(0.9, 8)
    inline = model.forward_fn()(params, pcm)
    full = prepare_quantized_params(params)
    slim = prepare_quantized_params(params, drop_fp=True)
    torch.testing.assert_close(model.forward_fn()(full, pcm), inline, rtol=0, atol=1e-4)
    torch.testing.assert_close(model.forward_fn()(slim, pcm), inline, rtol=0, atol=1e-4)

    def nbytes(tree):
        if isinstance(tree, dict):
            return sum(nbytes(v) for v in tree.values())
        if isinstance(tree, list):
            return sum(nbytes(v) for v in tree)
        return tree.numel() * tree.element_size()

    assert nbytes(slim) < 0.8 * nbytes(full)


def test_quantized_close_to_float():
    """JAX's tests/test_models.py:58-71 on the port: the int8 model within
    5% of the f32 one on the same weights."""
    base = dict(n_layers=2, d_model=32, ffn_dim=64, vocab_size=50, n_heads=2,
                dtype="float32")
    m = JModel(JConfig(**base))
    m.init(0)
    params = from_numpy_tree(_np_tree(m.params))
    pcm = _pcm(0.5, 9)
    lf = SenseVoiceModel(SenseVoiceConfig(**base), device="cpu").forward_fn()(params, pcm)
    lq = SenseVoiceModel(SenseVoiceConfig(**base, quantized=True),
                         device="cpu").forward_fn()(params, pcm)
    rel = ((lq - lf).abs().max() / lf.abs().max()).item()
    assert rel < 0.05, rel


MOE = dict(n_layers=2, d_model=64, n_heads=2, ffn_dim=96, vocab_size=40, n_experts=4,
           dtype="float32")


@pytest.fixture(scope="module")
def jax_moe():
    m = JModel(JConfig(**MOE))
    m.init(3)
    return m, _np_tree(m.params)


def test_init_gives_every_layer_an_moe_subtree():
    """As JAX's init loop does (models/sensevoice.py:100-107): each layer,
    router [D, E] without bias, w1 [E, D, F], w2 [E, F, D]."""
    gen = torch.Generator().manual_seed(0)
    p = sv.init_sensevoice(gen, SenseVoiceConfig(**MOE))
    for lp in p["layers"]:
        moe = lp["moe"]
        assert set(moe["router"]) == {"w"} and tuple(moe["router"]["w"].shape) == (64, 4)
        assert tuple(moe["w1"].shape) == (4, 64, 96) and tuple(moe["w2"].shape) == (4, 96, 64)


def test_moe_ffn_matches_jax(jax_moe):
    _, params = jax_moe
    x = np.random.default_rng(10).standard_normal((2, 9, 64)).astype(np.float32)
    want = np.asarray(jmoe_ffn(params["layers"][0]["moe"], jnp.asarray(x), JConfig(**MOE)))
    got = moe_ffn(from_numpy_tree(params["layers"][0]["moe"]), torch.from_numpy(x),
                  SenseVoiceConfig(**MOE)).numpy()
    assert _rel(got, want) <= 1e-5, _rel(got, want)


def test_moe_model_matches_jax(jax_moe):
    jm, params = jax_moe
    pcm = _pcm(1.6, 11)
    want = np.asarray(jax.jit(jm.forward_fn())(jm.params, pcm))
    got = SenseVoiceModel(SenseVoiceConfig(**MOE), device="cpu").forward_fn()(
        from_numpy_tree(params), pcm).numpy()
    assert _rel(got, want) <= F32_REL, _rel(got, want)
