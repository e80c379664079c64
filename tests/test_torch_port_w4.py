"""The port's SenseVoice w4a16 slice against lele_tpu's, at a small size.

Kernel 7 (w4a16 GEMM) and kernel 8 (the w4 SAN-M stack): their plain
versions against the Pallas kernels in interpret mode and against the JAX
package's jnp paths; then the whole model, under both of JAX's routings.
On the CPU JAX reaches its jnp paths (the per-layer scan with a dequantise-
then-dot GEMM); with `_on_tpu` patched to True and the Pallas kernels run
in interpret mode it takes its TPU routing (the stack kernel and the
group-accumulator GEMM), which computes the same forms as the port.
Weights are made and prepared by the JAX package and carried over through
lele_tpu_torch.params; inputs are made with numpy from a seed.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lele_tpu.kernels.quant_matmul as jqm
import lele_tpu.kernels.sanm_block as jsb
import lele_tpu.kernels.w4_matmul as jw4
from lele_tpu.models import SenseVoiceConfig as JConfig
from lele_tpu.models import SenseVoiceModel as JModel
from lele_tpu.models.common import cast_big_params as jcast
from lele_tpu.models.sensevoice import init_sensevoice as jinit
from lele_tpu.models.sensevoice import prepare_w4_params as jprepare
from lele_tpu.models.sensevoice import sanm_block as jsanm_block
from lele_tpu.models.sensevoice import sensevoice_encode as jencode
from lele_tpu.models.sensevoice import stack_layer_params as jstack
from lele_tpu.serving import SenseVoiceEngine as JEngine
from lele_tpu.serving import encode_wav
from lele_tpu_torch import kernels as K
from lele_tpu_torch.models import (
    SenseVoiceConfig,
    SenseVoiceModel,
    prepare_w4_params,
    sensevoice_encode,
)
from lele_tpu_torch.models import sensevoice as tsv
from lele_tpu_torch.params import from_numpy_tree
from lele_tpu_torch.serving import SenseVoiceEngine, decode_wav

W4 = importlib.import_module("lele_tpu_torch.kernels.w4_matmul")

SMALL = dict(n_layers=2, d_model=256, n_heads=2, ffn_dim=512, vocab_size=64,
             weight_int4=True)
# kernel 7's plain version vs the Pallas kernel: the same exact products, so
# only the f32 summation order differs (measured <= 3.1e-7 relative)
GEMM_REL = 1e-5
# vs JAX's CPU route `_w4_matmul_jnp` (tests/test_w4.py:73): f32 equal forms;
# for bf16 x the jnp route rounds q*s to bf16 first (measured <= 2.6e-3)
JNP_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# kernel 8's plain version vs the Pallas stack kernel: the same bf16
# roundings, f32 sums in another order
STACK_REL = 1e-3
# at the kernel's tiling edges, where three layers of head dim 32 or 64 carry
# a flipped bf16 rounding further (measured <= 1.7e-3): the layer bound of
# tests/test_pallas_parity.py::test_fused_sanm_layer_matches_block
LAYER_RTOL = 2e-2
# the logit gates of tests/test_torch_port_sensevoice.py (measured against
# JAX's CPU routing: <= 3.5e-3, agreement 1.0)
LOGIT_REL = 1e-2
ARGMAX_AGREE = 0.98
# against JAX's TPU routing the forms are equal and the logits differ by
# bf16 roundings that f32 summation order flips, amplified through the
# layers (measured <= 2.9e-3; per-layer f32 7e-7), agreement 1.0
TPU_ROUTE_REL = 5e-3
TPU_ROUTE_AGREE = 0.99


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _speechlike(seconds, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 16000)) / 16000.0
    env = 10.0 ** (-2.0 * (0.5 + 0.5 * np.sin(2 * np.pi * 3.0 * t)))
    sig = np.sin(2 * np.pi * (150 + 1500 * t) * t) + 0.5 * rng.standard_normal(t.size)
    return (0.3 * env * sig).astype(np.float32)


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def _agree(got, want):
    return _rel(got, want), float((got.argmax(-1) == want.argmax(-1)).mean())


@pytest.fixture
def jax_tpu_routing(monkeypatch):
    """JAX's TPU routing on the CPU: `_on_tpu` True, and the two Pallas
    kernels of this slice in interpret mode. Counts their calls (traces)."""
    calls = {"w4_matmul_pallas": 0, "sanm_stack_w4_pallas": 0}
    monkeypatch.setattr(jqm, "_on_tpu", lambda: True)
    monkeypatch.setattr(jw4, "_on_tpu", lambda: True)
    for mod, name in ((jw4, "w4_matmul_pallas"), (jsb, "sanm_stack_w4_pallas")):
        real = getattr(mod, name)

        def interp(*a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(*a, **{**k, "interpret": True})

        monkeypatch.setattr(mod, name, interp)
    return calls


# ---------------------------------------------------------------------------
# quantisation and kernel 7's plain version


@pytest.mark.parametrize("bf16", [False, True], ids=["f32_masters", "bf16_masters"])
def test_prepare_w4_params_matches_jax(bf16):
    """At the main path's layer widths (d512, ffn 2048) and CTC head: bit for
    bit against JAX's quantize_weight_int4 run eagerly (IEEE division, as
    the port). JAX's prepare_w4_params runs it under jit, where XLA rewrites
    amax / 7 (the scales move by an ulp) and codes on an exact .5 round to
    the neighbour: against it, at most one code apart, all equal for f32
    masters and 99.84% for bf16 masters (4,994 of 3,178,496 codes; bf16
    weights land on .5 often)."""
    m = JModel(JConfig(n_layers=1, vocab_size=64, weight_int4=True))
    m.init(1)
    src = jcast(m.params, jnp.bfloat16) if bf16 else m.params
    masters = _np_tree(src)
    jitted = _np_tree(jprepare(src))
    got = prepare_w4_params(from_numpy_tree(masters))
    triples = [(got["ctc"], jitted["ctc"], masters["ctc"])]
    triples += [(g[k], w[k], s[k]) for g, w, s in zip(got["layers"], jitted["layers"],
                                                     masters["layers"])
                for k in ("qkv", "out", "ffn1", "ffn2")]
    n = same = 0
    for g, w, master in triples:
        assert "w" not in g and g["wq4"].dtype == torch.int8
        eager_q, eager_s = jw4.quantize_weight_int4(master["w"], group=128)
        np.testing.assert_array_equal(g["wq4"].numpy(), np.asarray(eager_q))
        np.testing.assert_array_equal(g["ws4"].numpy(), np.asarray(eager_s))
        q_g = np.concatenate([t.numpy() for t in W4._unpack_nibbles(g["wq4"])])
        q_w = np.concatenate([np.asarray(t) for t in
                              jw4._unpack_nibbles(jnp.asarray(w["wq4"]))])
        assert np.abs(q_g - q_w).max() <= 1
        n, same = n + q_g.size, same + int((q_g == q_w).sum())
        np.testing.assert_allclose(g["ws4"].numpy(), w["ws4"], rtol=1e-6)
    assert same / n >= (0.998 if bf16 else 1.0), (n - same, n)


def test_unpack_and_dequantize_match_jax():
    rng = np.random.default_rng(0)
    packed = rng.integers(-128, 128, (64, 40)).astype(np.int8)
    scales = (rng.random((2, 40)) + 0.1).astype(np.float32)
    for a, b in zip(W4._unpack_nibbles(torch.from_numpy(packed)),
                    jw4._unpack_nibbles(jnp.asarray(packed))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(
        W4.dequantize_int4(torch.from_numpy(packed), torch.from_numpy(scales), 64).numpy(),
        np.asarray(jw4.dequantize_int4(jnp.asarray(packed), jnp.asarray(scales), 64)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n,g,tk,tn", [
    (8, 256, 128, 128, 128, 128),
    (3, 512, 200, 128, 128, 128),   # ragged M/N
    (16, 1024, 256, 128, 256, 256),
    # decode rows (kernel 7's decode form on a card): M = 1 and 2, odd N
    (1, 1024, 193, 128, 256, 128),
    (2, 1024, 193, 128, 256, 128),
    (1, 1792, 129, 128, 128, 128),
    (2, 1792, 129, 128, 128, 128),
])
def test_w4_matmul_plain_matches_pallas_and_jnp(dtype, m, k, n, g, tk, tn):
    """The shapes of tests/test_w4.py:60-64, and decode rows."""
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.standard_normal((m, k)), dtype)
    w = rng.standard_normal((k, n)).astype(np.float32) * 0.1
    packed, scales = jw4.quantize_weight_int4(w, group=g)
    want_pallas = np.asarray(jw4.w4_matmul_pallas(x, packed, scales, g, tn=tn, tk=tk,
                                                  interpret=True))
    want_jnp = np.asarray(jw4._w4_matmul_jnp(x, packed, scales, g))
    got = K.w4_matmul_plain(*from_numpy_tree([x, packed, scales]), g).numpy()
    assert got.shape == (m, n) and got.dtype == np.float32
    np.testing.assert_allclose(got, want_pallas, rtol=GEMM_REL,
                               atol=GEMM_REL * np.abs(want_pallas).max())
    tol = JNP_TOL[dtype]
    np.testing.assert_allclose(got, want_jnp, rtol=tol, atol=tol * 10)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_w4_matmul_plain_where_half_k_is_not_a_group_multiple(dtype):
    """K/2 = 192 with group 128 (tests/test_w4.py:77-88): no Pallas tile
    exists and JAX takes its jnp path; the port's kernel takes the shape in
    the dequantised-tile form (a group straddles the nibble planes), and so
    does its plain version: B is the dequantised weight rounded to x's type,
    and the product is exact up to the f32 summation order."""
    rng = np.random.default_rng(4)
    x = jnp.asarray(rng.standard_normal((4, 384)), dtype)
    w = rng.standard_normal((384, 64)).astype(np.float32)
    packed, scales = jw4.quantize_weight_int4(w, group=128)
    assert W4.kernel_supports(384, 128) and not W4.group_acc_form(384, 128)
    want = np.asarray(jw4.w4_matmul(x, packed, scales, group=128))
    got = K.w4_matmul(*from_numpy_tree([x, packed, scales]), 128).numpy()
    tol = JNP_TOL[dtype]
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * 10)
    b = jw4.dequantize_int4(packed, scales, 128).astype(x.dtype)
    exact = (np.asarray(x.astype(jnp.float32)).astype(np.float64)
             @ np.asarray(b.astype(jnp.float32)).astype(np.float64))
    np.testing.assert_allclose(got, exact, rtol=1e-4, atol=1e-4 * np.abs(exact).max())


def test_w4_quantize_refuses_what_jax_refuses():
    with pytest.raises(ValueError, match="divisible"):
        W4.quantize_weight_int4(torch.zeros((200, 8)), group=128)
    with pytest.raises(ValueError, match="divisible"):
        jw4.quantize_weight_int4(np.zeros((200, 8), np.float32), group=128)
    # the kernel takes every even K and every group up to 512 that divides K
    assert W4.kernel_supports(200, 8) and W4.kernel_supports(48, 16)
    assert not W4.kernel_supports(201, 3) and not W4.kernel_supports(200, 16)
    assert not W4.kernel_supports(2048, 1024)


# ---------------------------------------------------------------------------
# kernel 8's plain version


def _stack_params(ffn=512, key=4, n_layers=3, bf16=False, n_heads=2):
    cfg = JConfig(n_layers=n_layers, d_model=256, ffn_dim=ffn, vocab_size=32, n_heads=n_heads,
                  dtype="float32", weight_int4=True)
    params = jinit(jax.random.PRNGKey(key), cfg)
    if bf16:
        params = jcast(params, jnp.bfloat16)
    return cfg, jprepare(params)


# T = 19, head dim 128 (d256 over 2 heads), 3 layers; then the stack kernel's
# tiling edges: one row, a ragged 32-row tile, a key tile and one more row;
# head dims 32 and 64 (8 and 4 heads); 1 and 3 layers. The last T // 6 rows
# are masked.
STACK_CASES = [(19, 128, 3)] + [(t, hd, n) for t in (1, 19, 65) for hd in (32, 64)
                                for n in (1, 3)]
STACK_IDS = [f"T{t}-hd{hd}-L{n}" for t, hd, n in STACK_CASES]


@pytest.mark.parametrize("T,hd,n_layers", STACK_CASES, ids=STACK_IDS)
@pytest.mark.parametrize("bf16", [False, True], ids=["f32_params", "bf16_params"])
def test_sanm_stack_w4_plain_matches_pallas_and_jnp_layers(bf16, T, hd, n_layers):
    """tests/test_w4.py:137-172 (there T = 19 with 3 masked rows). Against
    the Pallas stack kernel (the same numerics) at STACK_REL in that
    configuration (head dim 128, 3 layers) and at LAYER_RTOL at the tiling
    edges, and against JAX's per-layer jnp block at that test's 3e-2 and
    correlation > 0.999."""
    cfg, params = _stack_params(bf16=bf16, n_layers=n_layers, n_heads=256 // hd)
    stacked = jstack(params)["layers_stacked"]
    rng = np.random.default_rng(7)
    x = rng.standard_normal((T, cfg.d_model)).astype(np.float32) * 0.3
    mask = np.ones((T,), np.float32)
    mask[T - T // 6:] = 0.0
    valid = int(mask.sum())
    want = np.asarray(jsb.sanm_stack_w4_pallas(jnp.asarray(x), jnp.asarray(mask), stacked,
                                               cfg.n_heads, cfg.fsmn_kernel, interpret=True))
    jnp_layers = jnp.asarray(x)[None]
    for lp in params["layers"]:
        jnp_layers = jsanm_block(lp, jnp_layers, jnp.asarray(mask)[None], cfg)
    jnp_layers = np.asarray(jnp_layers)[0]
    got = K.sanm_stack_w4_plain(torch.from_numpy(x), torch.from_numpy(mask),
                                from_numpy_tree(_np_tree(stacked)), cfg.n_heads,
                                cfg.fsmn_kernel).numpy()
    g, w = got[:valid], want[:valid]
    rel = STACK_REL if (T, hd, n_layers) == STACK_CASES[0] else LAYER_RTOL
    assert np.abs(g - w).max() <= rel * np.abs(w).max()
    w = jnp_layers[:valid]
    np.testing.assert_allclose(g, w, rtol=3e-2, atol=3e-2 * np.abs(w).max())
    assert np.corrcoef(g.reshape(-1), w.reshape(-1))[0, 1] > 0.999


def test_sanm_stack_w4_refuses_odd_groups_as_jax():
    """ffn 384 → K/group = 3 for ffn2: both stacks refuse (test_w4.py:175)."""
    cfg, params = _stack_params(ffn=384, key=0, n_layers=1)
    stacked = jstack(params)["layers_stacked"]
    with pytest.raises(ValueError, match="nibble-plane"):
        jsb.sanm_stack_w4_pallas(jnp.zeros((8, 256)), jnp.ones((8,)), stacked,
                                 cfg.n_heads, cfg.fsmn_kernel, interpret=True)
    with pytest.raises(ValueError, match="nibble-plane"):
        K.sanm_stack_w4(torch.zeros((8, 256)), torch.ones(8),
                        from_numpy_tree(_np_tree(stacked)), cfg.n_heads, cfg.fsmn_kernel)


# ---------------------------------------------------------------------------
# the model


@pytest.fixture(scope="module")
def jax_params():
    """The small model's f32 masters cast to bf16 and w4-prepared by JAX, as
    the main path prepares its weights."""
    m = JModel(JConfig(**SMALL))
    m.init(0)
    return m.fbank, jprepare(jcast(m.params, jnp.bfloat16))


def _models(jax_params, dtype: str, stacked: bool):
    fbank, params = jax_params
    cfg = dict(SMALL, dtype=dtype)
    params = jstack(params) if stacked else params
    jm = JModel(JConfig(**cfg), params=params, fbank=fbank)
    tm = SenseVoiceModel(SenseVoiceConfig(**cfg), device="cpu")
    tm.params = from_numpy_tree(_np_tree(params))
    return jm, tm


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("stacked", [True, False], ids=["stacked", "per_layer"])
def test_forward_fn_logits_match_jax_cpu_routing(jax_params, dtype, stacked):
    """JAX on the CPU takes its per-layer jnp path everywhere; the port's
    stacked params take kernel 8's plain version (bf16 weights and attention
    whatever the dtype), so the stacked f32 case differs by bf16 rounding."""
    jm, tm = _models(jax_params, dtype, stacked)
    pcm = _speechlike(1.7, seed=21)
    want = np.asarray(jax.jit(jm.forward_fn())(jm.params, pcm))
    got = tm.forward_fn()(tm.params, pcm).numpy()
    assert got.shape == want.shape == (1, 4 + 28, SMALL["vocab_size"])
    rel, agree = _agree(got, want)
    assert rel <= LOGIT_REL and agree >= ARGMAX_AGREE, (rel, agree)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("stacked", [True, False], ids=["stacked", "per_layer"])
def test_forward_fn_logits_match_jax_tpu_routing(jax_params, jax_tpu_routing, dtype,
                                                  stacked):
    """Under JAX's TPU routing both sides compute the same forms: the stack
    kernel for stacked params, the w4 GEMM for every other linear and the
    CTC head. Only f32 summation orders differ."""
    jm, tm = _models(jax_params, dtype, stacked)
    pcm = _speechlike(1.7, seed=21)
    want = np.asarray(jax.jit(jm.forward_fn())(jm.params, pcm))
    got = tm.forward_fn()(tm.params, pcm).numpy()
    assert jax_tpu_routing["sanm_stack_w4_pallas"] == (1 if stacked else 0)
    assert jax_tpu_routing["w4_matmul_pallas"] == (1 if stacked else 1 + 4 * SMALL["n_layers"])
    rel, agree = _agree(got, want)
    assert rel <= TPU_ROUTE_REL and agree >= TPU_ROUTE_AGREE, (rel, agree)


def test_odd_group_gate_takes_the_per_layer_path_on_both_sides(jax_tpu_routing,
                                                               monkeypatch):
    """ffn 384 (test_w4.py:196-220): neither side routes to the stack kernel.
    JAX traces its scan body once: qkv, out and ffn1 take its Pallas GEMM,
    ffn2 (K/2 = 192, no tile) its jnp path, then the CTC head; the port runs
    every linear through its w4 GEMM (the same f32 form). They agree."""
    cfg = dict(n_layers=2, d_model=256, n_heads=2, ffn_dim=384, vocab_size=32,
               dtype="float32", weight_int4=True)
    m = JModel(JConfig(**cfg))
    params = jstack(jprepare(m.init(0)))
    feats = np.random.default_rng(9).standard_normal((1, 12, 560)).astype(np.float32)
    mask = np.ones((1, 12), np.float32)
    want = np.asarray(jencode(params, jnp.asarray(feats), jnp.asarray(mask), JConfig(**cfg)))
    used = []
    monkeypatch.setitem(tsv._PLAIN, "stack4", lambda *a, **k: used.append(1))
    got = sensevoice_encode(from_numpy_tree(_np_tree(params)), torch.from_numpy(feats),
                            torch.from_numpy(mask), SenseVoiceConfig(**cfg)).numpy()
    assert jax_tpu_routing["sanm_stack_w4_pallas"] == 0 and not used
    assert jax_tpu_routing["w4_matmul_pallas"] == 3 + 1
    assert np.isfinite(got).all()
    rel, agree = _agree(got, want)
    assert rel <= TPU_ROUTE_REL and agree >= TPU_ROUTE_AGREE, (rel, agree)


def test_stacked_port_routes_to_kernel_8(jax_params, monkeypatch):
    """The port's gate sends stacked w4 params at batch 1 to the stack and
    the CTC head to the w4 GEMM; `plain=True` takes their plain versions."""
    _, tm = _models(jax_params, "bfloat16", True)
    seen = []
    for role in ("stack4", "w4"):
        real = tsv._PLAIN[role]
        monkeypatch.setitem(tsv._PLAIN, role,
                            lambda *a, _r=real, _n=role, **k: (seen.append(_n), _r(*a, **k))[1])
    pcm = _speechlike(0.7, seed=3)
    a = tm.forward_fn()(tm.params, pcm)
    assert seen == []  # the wrappers, which take their plain versions on the CPU
    b = tm.forward_fn(plain=True)(tm.params, pcm)
    assert seen == ["stack4", "w4"]
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_transcribe_ids_and_engine_match_jax(jax_params):
    jm, tm = _models(jax_params, "bfloat16", True)
    frames = same = 0
    for i, seconds in enumerate((0.8, 2.5, 4.2)):
        pcm = _speechlike(seconds, seed=30 + i)
        want_ids, want_valid = jm._bucketed_argmax(pcm)
        got_ids, got_valid = tm._bucketed_argmax(pcm)
        assert got_valid == want_valid and got_ids.dtype == np.int32
        frames += got_valid
        same += int((got_ids[:got_valid] == want_ids[:want_valid]).sum())
    assert same / frames >= ARGMAX_AGREE, same / frames
    wav = encode_wav(_speechlike(2.0, seed=40), 16000)
    got = SenseVoiceEngine(model=tm).recognize(wav)
    want = JEngine(model=jm).recognize(wav)
    assert got == tm.transcribe_ids(decode_wav(wav)[0])
    assert got == want, (got, want)
