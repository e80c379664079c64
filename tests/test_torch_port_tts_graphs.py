"""The port's TTS as one program a bucket, `runtime/compose.py` and
`SupertonicOnnx` as one composed program, held against the JAX package on
the CPU (where nothing is captured: each program's function runs eagerly,
as its graph replays on a card):

- `SupertonicTts.synthesize` on both of JAX's routes (`fused_duration` True:
  duration → mask → synth in one program with a bucket guess; False: the
  duration program, the host formula, the synth program), with the
  Supertonic 2 and 3 settings, against JAX's same route, at the sub-model
  gate of tests/test_torch_port_supertonic.py (1e-5 of the largest
  magnitude; JAX's noise through the `noise` seam);
- a bucket guess missed on purpose (a forced `_fpt_ema`) gives the hit's
  audio bit for bit, with one more dispatch;
- `synth_e2e_fn`'s in-program frame count t_real equals JAX's exactly, its
  durations and wave at the same gate;
- `compose_models`: the three cases of tests/test_compose.py against JAX's
  composed program, at its atol 1e-4;
- `SupertonicOnnx.synthesize_latent` (one composed program) against JAX's
  fused program at the existing SYNTH_ATOL (1e-3) and against the port's
  host loop at 1e-6.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lele_tpu.compiler import compile_model as j_compile
from lele_tpu.models import supertonic as jst
from lele_tpu.models.checkpoints import SupertonicOnnx as JSupertonicOnnx
from lele_tpu.onnx import OnnxModel as JOnnxModel
from lele_tpu.onnx import builder as jb
from lele_tpu.runtime.compose import compose_models as j_compose
from lele_tpu_torch.compiler import compile_model
from lele_tpu_torch.models import SupertonicOnnx
from lele_tpu_torch.models import supertonic as tst
from lele_tpu_torch.runtime import compose_models, graphs

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "fixtures"
EXAMPLES = REPO / "examples"
F32_RTOL = 1e-5  # tests/test_torch_port_supertonic.py
COMPOSE_ATOL = 1e-4  # tests/test_compose.py
SYNTH_ATOL = 1e-3  # tests/test_torch_port_supertonic_onnx.py
SMALL = dict(d_text=64, n_heads=2, n_text_layers=2, n_est_layers=2, ffn_mult=2,
             latent_buckets=(32, 64), token_buckets=(48, 96))
TEXTS = ("Capture once, replay after.", "The quick brown fox jumps over the lazy dog. "
         "It runs away!")
V3 = dict(apply_latent_denorm=False, speed=1.05)


def _close(got, want, rtol=F32_RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(np.abs(want).max(), 1e-30))


def _pair(seed=0, **kw):
    cfg = dict(SMALL, **kw)
    jm = jst.SupertonicTts(jst.SupertonicConfig(**cfg))
    jm.init(seed)
    tm = tst.SupertonicTts(tst.SupertonicConfig(**cfg), device="cpu",
                           params=tst.supertonic_params_from_jax(
                               jax.tree.map(np.asarray, jm.params), "cpu"))
    return jm, tm


@pytest.fixture(scope="module")
def models():
    return {"v2": _pair(4), "v3": _pair(4, **V3)}


def _style(seed=9, d=128):
    rng = np.random.default_rng(seed)
    return {"ttl": rng.standard_normal(d).astype(np.float32),
            "dp": rng.standard_normal(d).astype(np.float32)}


def _jax_noise(cfg, seed):
    return torch.from_numpy(np.asarray(jax.random.normal(
        jax.random.PRNGKey(seed), (1, cfg.latent_buckets[-1], cfg.d_latent), jnp.float32)))


@pytest.mark.parametrize("settings", ["v2", "v3"])
@pytest.mark.parametrize("fused_duration", [True, False], ids=["e2e", "two_dispatch"])
def test_synthesize_routes_equal_jax(models, settings, fused_duration):
    jm, tm = models[settings]
    style = _style()
    for seed, text in enumerate(TEXTS):
        want = np.asarray(jm.synthesize(text, style, seed=seed, fused_duration=fused_duration))
        n = tm.dispatches
        got = tm.synthesize(text, style, seed=seed, fused_duration=fused_duration,
                            noise=_jax_noise(tm.cfg, seed))
        assert tm.dispatches - n >= len(tst.prepare_chunks(text))
        _close(got, want)


@pytest.mark.parametrize("ema,text", [(0.01, TEXTS[1]), (1e3, "Hi.")],
                         ids=["guess_low", "guess_high"])
def test_missed_bucket_guess_gives_the_hit_audio(models, ema, text):
    jm, tm = models["v2"]
    style = _style(3)
    noise = _jax_noise(tm.cfg, 5)
    hit = tm.synthesize(text, style, seed=5, noise=noise)
    guess = tm._bucket(max(8, int(len(tm.indexer(text)) * ema)))
    assert guess != tm._bucket(len(hit) // tm.cfg.hop)  # the guess misses
    tm._fpt_ema = ema
    n = tm.dispatches
    missed = tm.synthesize(text, style, seed=5, noise=noise)
    assert tm.dispatches - n == 2  # the guess and the canonical bucket
    np.testing.assert_array_equal(missed, hit)
    jm._fpt_ema = ema
    _close(missed, np.asarray(jm.synthesize(text, style, seed=5)))


@pytest.mark.parametrize("t_latent,min_frames,text", [
    (32, 8, TEXTS[0]), (64, 8, TEXTS[1]), (64, 60, TEXTS[0]), (32, 8, TEXTS[1])],
    ids=["fits", "longer", "min_frames", "capped"])
def test_synth_e2e_t_real_equals_jax(models, t_latent, min_frames, text):
    jm, tm = models["v2"]
    style = _style(21)
    ids, mask = tm.pad_tokens(tm.indexer(tst.prepare_chunks(text)[0])[None])
    want_wave, want_t, want_dur = jax.jit(jm.synth_e2e_fn(t_latent, min_frames))(
        jm.params, ids, mask, style["ttl"], style["dp"], 2)
    noise = _jax_noise(tm.cfg, 2)[:, :t_latent]
    wave, t_real, dur = tm.synth_e2e_fn(t_latent, min_frames)(
        torch.from_numpy(ids.astype(np.int64)), torch.from_numpy(mask),
        torch.from_numpy(style["ttl"]), torch.from_numpy(style["dp"]), noise)
    assert int(t_real) == int(want_t) and t_real.dtype == torch.int32
    assert min_frames <= int(t_real) <= t_latent
    _close(dur, want_dur)
    _close(wave, want_wave)


def test_synth_program_equals_synth_core(models):
    """The two-dispatch route's program function and the eager synth core
    (its oracle) on the same inputs; the flow steps' times are the values
    the core uploaded a step before they became device constants."""
    _, tm = models["v2"]
    style = _style(2)
    ids, mask = tm.pad_tokens(tm.indexer(TEXTS[0])[None])
    ids, mask = torch.from_numpy(ids.astype(np.int64)), torch.from_numpy(mask)
    lm = torch.zeros((1, 32))
    lm[:, :20] = 1.0
    noise = tm.noise(7)
    wave, dur = tm.synth_fn(32)(ids, mask, torch.from_numpy(style["ttl"]),
                                torch.from_numpy(style["dp"]), lm, noise[:, :32])
    want = tm.synth_core(ids, mask, torch.from_numpy(style["ttl"])[None], lm, seed=7)
    assert torch.equal(wave, want) and dur.shape == ids.shape
    dt = 1.0 / tm.cfg.flow_steps
    assert torch.equal(tm._flow_times(), torch.stack(
        [torch.tensor(i, dtype=torch.float32) * dt for i in range(tm.cfg.flow_steps)]))


def test_uncaptured_route_equals_synthesize(models):
    _, tm = models["v3"]
    style = _style(6)
    for fused_duration in (True, False):
        a = tm.synthesize(TEXTS[1], style, seed=1, fused_duration=fused_duration)
        b = tm.synthesize_uncaptured(TEXTS[1], style, seed=1, fused_duration=fused_duration)
        np.testing.assert_array_equal(a, b)


# -- compose_models: tests/test_compose.py's three cases --------------------------------


def _linear_bytes(builder, w):
    d_in, d_out = w.shape
    return builder.build_model_bytes(
        [builder.node("MatMul", ["x", "w"], ["mm"]), builder.node("Tanh", ["mm"], ["y"])],
        inputs=[builder.value_info("x", 1, [2, d_in])],
        outputs=[builder.value_info("y", 1, [2, d_out])],
        initializers=[builder.tensor_from_array(w, "w")])


def _both(w):
    """The same linear+tanh graph compiled by both packages → (port, JAX)."""
    bs = _linear_bytes(jb, w)
    return compile_model(bs, device="cpu"), j_compile(JOnnxModel.from_bytes(bs))


def test_compose_two_model_chain():
    rng = np.random.default_rng(41)
    (enc, jenc), (dec, jdec) = (_both(rng.standard_normal(s).astype(np.float32))
                                for s in ((8, 16), (16, 4)))
    pipe = compose_models({"enc": enc, "dec": dec},
                          lambda call, x: call("dec", x=call("enc", x=x)[0])[0])
    jpipe = j_compose({"enc": jenc, "dec": jdec},
                      lambda call, x: call("dec", x=call("enc", x=x)[0])[0])
    x = rng.standard_normal((2, 8)).astype(np.float32)
    got = pipe(x)
    np.testing.assert_allclose(got.numpy(), np.asarray(jpipe(x)), atol=COMPOSE_ATOL)
    assert torch.equal(got, pipe.uncaptured(x))
    assert set(pipe.params_bundle) == {"enc", "dec"}
    assert pipe.params_bundle["enc"] is enc.params and len(pipe.programs) == 0


def test_compose_flow_matching_loop():
    """An iterated sub-model (the flow steps): a Python loop in the pipeline,
    against JAX's fori_loop."""
    rng = np.random.default_rng(42)
    est, jest = _both(rng.standard_normal((8, 8)).astype(np.float32))

    def pipeline(call, x0):
        x = x0
        for _ in range(5):
            x = x + 0.2 * call("est", x=x)[0]
        return x

    def jpipeline(call, x0):
        return jax.lax.fori_loop(0, 5, lambda i, x: x + 0.2 * call("est", x=x)[0], x0)

    x0 = rng.standard_normal((2, 8)).astype(np.float32)
    got = compose_models({"est": est}, pipeline)(x0)
    np.testing.assert_allclose(got.numpy(), np.asarray(j_compose({"est": jest}, jpipeline)(x0)),
                               atol=COMPOSE_ATOL)


def test_compose_missing_input_errors():
    enc, jenc = _both(np.ones((8, 16), np.float32))
    for compose, m in ((compose_models, enc), (j_compose, jenc)):
        pipe = compose({"enc": m}, lambda call, x: call("enc")[0])
        with pytest.raises(ValueError, match="missing inputs"):
            pipe(np.zeros((2, 8), np.float32))


def test_programs_repeat_carries_the_donated_state():
    """`repeat` n runs a program n times, each from the state the run before
    donated: on the CPU the function runs n times."""
    progs = graphs.Programs("cpu")
    out = progs.run("k", lambda: lambda s, x: (s * 2 + x, s.sum()), torch.ones(3),
                    torch.arange(3.0), donate={0: 0}, repeat=4)
    s = torch.ones(3)
    for _ in range(4):
        s, last = s * 2 + torch.arange(3.0), s.sum()
    assert torch.equal(out[0], s) and torch.equal(out[1], last)


# -- SupertonicOnnx as one composed program ---------------------------------------------


@pytest.fixture(scope="module")
def onnx_pair():
    return SupertonicOnnx(FIXTURES, device="cpu"), JSupertonicOnnx(FIXTURES)


@pytest.mark.parametrize("seed", [1, 2])
def test_supertonic_onnx_composed_equals_jax(onnx_pair, seed):
    port, jst_onnx = onnx_pair
    io = dict(np.load(FIXTURES / "supertonic_io.npz"))
    latent_len = io["xt"].shape[-1]  # the estimator graph's compiled length
    args = (io["ids"].astype(np.int64), io["style"], io["mask"])
    want_dur, want = jst_onnx.synthesize_latent(*args, latent_len=latent_len, seed=seed)
    dur, wave = port.synthesize_latent(*args, latent_len=latent_len, seed=seed)
    dur_h, wave_h = port.synthesize_latent_hostloop(*args, latent_len=latent_len, seed=seed)
    assert wave.shape == want.shape == (1, latent_len * 4) and np.isfinite(wave).all()
    np.testing.assert_allclose(wave, want, atol=SYNTH_ATOL)
    np.testing.assert_allclose(wave, wave_h, atol=1e-6)
    np.testing.assert_array_equal(dur, dur_h)
    np.testing.assert_allclose(dur, want_dur, atol=2e-4)
    fn = port.fused(latent_len)
    assert port.fused(latent_len) is fn and set(fn.params_bundle) == {"dp", "te", "ve", "voc"}
