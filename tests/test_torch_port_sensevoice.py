"""The port's SenseVoice w8a16 slice against lele_tpu's, at a small size.

Weights are made by the JAX package (torch cannot reproduce jax.random),
prepared there, and carried over through lele_tpu_torch.params; PCM is made
with numpy from a seed. The JAX model runs on the CPU (its jnp paths), the
port on the CPU takes its kernels' plain versions.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lele_tpu.models import SenseVoiceConfig as JConfig
from lele_tpu.models import SenseVoiceModel as JModel
from lele_tpu.models.common import cast_big_params as jcast
from lele_tpu.models.sensevoice import _collapse_ids as j_collapse_ids
from lele_tpu.models.sensevoice import prepare_w8_params as jprepare
from lele_tpu.models.sensevoice import stack_layer_params as jstack
from lele_tpu.runtime.bucketing import pad_pcm
from lele_tpu_torch.models import (
    SenseVoiceConfig,
    SenseVoiceModel,
    cast_big_params,
    greedy_ctc_decode,
    prepare_w8_params,
    stack_layer_params,
)
from lele_tpu_torch.models.sensevoice import _collapse_ids
from lele_tpu_torch.params import from_numpy_tree

REPO = Path(__file__).resolve().parent.parent
SMALL = dict(n_layers=2, d_model=256, n_heads=2, ffn_dim=384, vocab_size=64,
             weight_int8=True)
LOGIT_REL = 1e-2  # max|d| / max|ref| of the logits
ARGMAX_AGREE = 0.98  # share of frames whose argmax agrees


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _speechlike(seconds, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 16000)) / 16000.0
    env = 10.0 ** (-2.0 * (0.5 + 0.5 * np.sin(2 * np.pi * 3.0 * t)))
    sig = np.sin(2 * np.pi * (150 + 1500 * t) * t) + 0.5 * rng.standard_normal(t.size)
    return (0.3 * env * sig).astype(np.float32)


@pytest.fixture(scope="module")
def jax_model():
    """The JAX model with f32 masters, and its bf16 → w8 prepared params."""
    m = JModel(JConfig(**SMALL))
    m.init(0)
    f32 = m.params
    m.params = jprepare(jcast(f32, jnp.bfloat16))
    return m, f32


def _port(jm, stacked: bool):
    params = jstack(jm.params) if stacked else jm.params
    tm = SenseVoiceModel(SenseVoiceConfig(**SMALL), device="cpu")
    tm.params = from_numpy_tree(_np_tree(params))
    return tm, params


def _agree(got, want):
    rel = np.abs(got - want).max() / np.abs(want).max()
    agree = (got.argmax(-1) == want.argmax(-1)).mean()
    return rel, agree


@pytest.mark.parametrize("bf16", [False, True], ids=["f32_masters", "bf16_masters"])
def test_prepare_w8_params_matches_jax(bf16):
    """At the main path's layer widths (d512, ffn 2048). w/scale can land on
    an exact .5 (bf16 masters often hold w = amax/2), and XLA rewrites the
    quotient differently at some shapes, so a few entries may differ by 1."""
    m = JModel(JConfig(n_layers=1, vocab_size=64, weight_int8=True))
    m.init(1)
    src = jcast(m.params, jnp.bfloat16) if bf16 else m.params
    want = _np_tree(jprepare(src))
    got = prepare_w8_params(from_numpy_tree(_np_tree(src)))
    pairs = [(got["ctc"], want["ctc"])]
    pairs += [(g[k], w[k]) for g, w in zip(got["layers"], want["layers"])
              for k in ("qkv", "out", "ffn1", "ffn2")]
    for g, w in pairs:
        assert "w" not in g and g["wq8"].dtype == torch.int8
        gq = g["wq8"].numpy().astype(np.int32)
        wq = w["wq8"].astype(np.int32)
        assert (gq == wq).mean() >= 0.9999
        assert np.abs(gq - wq).max() <= 1
        np.testing.assert_allclose(g["ws8"].numpy(), w["ws8"], rtol=1e-6)


def test_bf16_carry_over_and_cast_are_bit_exact(jax_model):
    _, f32 = jax_model
    want = _np_tree(jcast(f32, jnp.bfloat16))
    carried = from_numpy_tree(want)
    cast = cast_big_params(from_numpy_tree(_np_tree(f32)), torch.bfloat16)
    for tree in (carried, cast):
        for name in ("prefix",):
            assert tree[name].dtype == torch.bfloat16
            np.testing.assert_array_equal(tree[name].view(torch.int16).numpy(),
                                          want[name].view(np.int16))
        for g, w in zip(tree["layers"], want["layers"]):
            for path in (("fsmn", "w"), ("qkv", "w"), ("ffn2", "w")):
                t, a = g[path[0]][path[1]], w[path[0]][path[1]]
                assert t.dtype == torch.bfloat16
                np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                              a.view(np.int16))
            assert g["norm1"]["g"].dtype == torch.float32  # rank 1 stays f32


@pytest.mark.parametrize("stacked", [True, False], ids=["stacked", "per_layer"])
def test_forward_fn_logits_match_jax(jax_model, stacked):
    jm, _ = jax_model
    tm, params = _port(jm, stacked)
    pcm = _speechlike(1.7, seed=21)
    want = np.asarray(jax.jit(jm.forward_fn())(params, pcm))
    got = tm.forward_fn()(tm.params, pcm).numpy()
    assert got.shape == want.shape == (1, 4 + 28, SMALL["vocab_size"])
    rel, agree = _agree(got, want)
    assert rel <= LOGIT_REL and agree >= ARGMAX_AGREE, (rel, agree)


def test_forward_bucketed_fn_matches_jax(jax_model):
    jm, _ = jax_model
    tm, params = _port(jm, True)
    padded, n_valid = pad_pcm(_speechlike(2.4, seed=22))
    want_l, want_m = jax.jit(jm.forward_bucketed_fn())(params, padded, n_valid)
    got_l, got_m = tm.forward_bucketed_fn()(tm.params, padded, n_valid)
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    assert 0 < got_m.sum() < got_m.numel()  # the bucket really pads
    rel, agree = _agree(got_l.numpy(), np.asarray(want_l))
    assert rel <= LOGIT_REL and agree >= ARGMAX_AGREE, (rel, agree)


def test_transcribe_ids_match_jax_bucketed_argmax(jax_model):
    jm, _ = jax_model
    jm8 = JModel(jm.cfg, params=jstack(jm.params), fbank=jm.fbank)
    tm, _ = _port(jm, True)
    frames = same = 0
    for i, seconds in enumerate((0.8, 2.5, 4.2)):
        pcm = _speechlike(seconds, seed=30 + i)
        want_ids, want_valid = jm8._bucketed_argmax(pcm)
        got_ids, got_valid = tm._bucketed_argmax(pcm)
        assert got_valid == want_valid and got_ids.dtype == np.int32
        frames += got_valid
        same += int((got_ids[:got_valid] == want_ids[:want_valid]).sum())
        ids = tm.transcribe_ids(pcm)
        assert ids == _collapse_ids(got_ids[:got_valid])
    assert same / frames >= ARGMAX_AGREE, same / frames


def test_collapse_ids_and_greedy_decode_match_jax():
    rng = np.random.default_rng(7)
    for n in (0, 1, 17, 200):
        ids = rng.integers(0, 4, n)
        assert _collapse_ids(ids) == j_collapse_ids(ids)
        assert _collapse_ids(ids, blank_id=2) == j_collapse_ids(ids, blank_id=2)
    logits = rng.standard_normal((30, 5)).astype(np.float32)
    assert greedy_ctc_decode(torch.from_numpy(logits)) == j_collapse_ids(logits.argmax(-1))


def test_audio_beyond_the_largest_bucket_routes_to_transcribe_long(monkeypatch):
    """JAX's tests/test_bucketing.py:45-59 on the port: 61 s goes to
    transcribe_long (three 30 s windows in one batch) and gives JAX's ids."""
    cfg = dict(n_layers=1, d_model=32, ffn_dim=64, vocab_size=40, n_heads=2, dtype="float32")
    jm = JModel(JConfig(**cfg))
    jm.init(0)
    tm = SenseVoiceModel(SenseVoiceConfig(**cfg), device="cpu")
    tm.params = from_numpy_tree(_np_tree(jm.params))
    pcm = (np.random.default_rng(61).standard_normal(61 * 16000) * 0.1).astype(np.float32)
    calls = []
    long_form = tm.transcribe_long
    monkeypatch.setattr(tm, "transcribe_long",
                        lambda p, b=0: calls.append(len(p)) or long_form(p, b))
    ids = tm.transcribe_ids(pcm)
    assert calls == [61 * 16000] and len(ids) > 0
    assert ids == jm.transcribe_ids(pcm)


def test_port_runs_without_jax():
    """The card machine has no JAX: the port must import and run without it,
    and without the JAX package. Every slice runs: the native engine, the
    compiled graph behind SenseVoiceOnnx, Silero VAD native and compiled
    at both sample rates, the w4a16 model, a MatMulNBits graph, a GRU graph,
    a QMoE decode layer, and Supertonic TTS through TtsEngine (on the fused
    estimator route) and SupertonicOnnx, and an opset-23 decoder step graph
    (a prefill on the flash route's plain version, two decode steps); and
    slice 8: a dynamic-int8 model on both routes, transcribe_batch,
    transcribe_long, recognize_batch with a tokenizer, beam decoding, a
    streaming step, and a MatMulInteger graph both ways; and slice 15:
    YoloOnnx on the fixture (bf16 compute) and a small seg model behind
    Yolo26Engine, with no PIL imported (the card machine has none); and
    slice 16: runtime/graphs.py's programs (run eagerly on the CPU) and
    SileroOnnx in blocks with its donated state; and slice 17: both TTS
    routes, SupertonicOnnx's composed program, compose_models, the onnx
    stand-in with torch.onnx.export, and a Seq2SeqGenerator on exported
    graphs (greedy, sampled, beam); and slice 18: Silero's utterance as one
    Scan and one Loop, a function-packaged export through quantize_dynamic
    onto the fused SAN-M stack, and the sequence ops; and slice 19: a small
    ORT-GenAI MoE decoder from a side file, prefilled and decoded with its
    caches donated; and slice 20: chip_smoke phase 36's ResNet-50 builder at
    a small width, and one emitter graph of each of the math, tensor, nn and
    activation sets (Mod, ScatterND, TopK, the Random ops; LogSoftmax;
    MaxPool, Resize, 3-D ConvTranspose); and slice 21: chip_smoke phase
    37's two int8 ResNet-50 forms at a small width, the QDQ graph from the
    port's quantize_static and the QOperator graph on calibrate_minmax's
    ranges; and slice 23: chip_smoke phase 39's front-end graph (DFT,
    HannWindow, MelWeightMatrix before a small int8 SAN-M) and SD block at
    small widths; and slice 22: a graph compiled through the CLI, its generated
    wrapper loaded and run, and one /recognize request to the tiny server;
    and slice 24: chip_smoke phase 40's int8 GPT-2 BeamSearch export at a
    small width, bound by bind_inputs, and its packed BERT stack; and slice
    25 (with optax and orbax blocked too): a remat train step, a checkpoint
    saved and restored, and the planner's H100 plans; and the multi-device
    layer, in a one-rank gloo group: a pipeline of one stage, a compiled
    graph over a one-rank mesh with param rules, and plan_serving_mesh's
    (None, None)."""
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['lele_tpu'] = None\n"
        "sys.modules['optax'] = None; sys.modules['orbax'] = None\n"
        "import numpy as np, torch\n"
        "from lele_tpu_torch.models.checkpoints import SenseVoiceOnnx\n"
        "from lele_tpu_torch.onnx.synth import build_sanm_int8_model\n"
        "sv = SenseVoiceOnnx(build_sanm_int8_model(L=2, d=64, h=2, ffn=96, vocab=40,\n"
        "                                          int8_head=True), device='cpu')\n"
        "pcm = np.random.default_rng(1).standard_normal(30000).astype(np.float32) * 0.1\n"
        "ids = sv.transcribe(pcm)\n"
        "assert all(0 <= i < 40 for i in ids)\n"
        "hits = sv._compiled(32).stats['pattern_hits']\n"
        "assert hits['sanm_fused_layers'] == 2 and hits['dql_matmul_dataflow'] == 1, hits\n"
        "from lele_tpu_torch.models import *\n"
        "from lele_tpu_torch.serving import SenseVoiceEngine\n"
        "cfg = SenseVoiceConfig(n_layers=2, d_model=64, n_heads=2, ffn_dim=96,\n"
        "                       vocab_size=40, weight_int8=True)\n"
        "m = SenseVoiceModel(cfg, device='cpu'); m.init(0)\n"
        "m.params = stack_layer_params(prepare_w8_params(\n"
        "    cast_big_params(m.params, torch.bfloat16)))\n"
        "pcm = np.random.default_rng(0).standard_normal(20000).astype(np.float32) * 0.1\n"
        "ids = SenseVoiceEngine(model=m).model.transcribe_ids(pcm)\n"
        "logits = m.forward_fn()(m.params, pcm)\n"
        "assert logits.shape == (1, 4 + 21, 40) and torch.isfinite(logits).all()\n"
        "assert all(0 <= i < 40 for i in ids)\n"
        "vad = SileroVad(device='cpu'); vad.init(0)\n"
        "pcm = np.random.default_rng(2).standard_normal(16000).astype(np.float32) * 0.1\n"
        "for sr in (16000, 8000):\n"
        "    p = vad.speech_probs(pcm, sr)\n"
        "    assert p.shape == (31,) and ((p >= 0) & (p <= 1)).all()\n"
        "    assert isinstance(vad.segments(pcm, sr=sr), list)\n"
        "    q = SileroOnnx('fixtures/silero.onnx', device='cpu').speech_probs(pcm, sr)\n"
        "    assert q.shape == (31,) and np.isfinite(q).all()\n"
        "cfg4 = SenseVoiceConfig(n_layers=2, d_model=256, n_heads=2, ffn_dim=512,\n"
        "                        vocab_size=40, weight_int4=True)\n"
        "m4 = SenseVoiceModel(cfg4, device='cpu'); m4.init(0)\n"
        "m4.params = stack_layer_params(prepare_w4_params(\n"
        "    cast_big_params(m4.params, torch.bfloat16)))\n"
        "ids = SenseVoiceEngine(model=m4).model.transcribe_ids(pcm[:20000])\n"
        "assert all(0 <= i < 40 for i in ids)\n"
        "from lele_tpu_torch.compiler import compile_model\n"
        "from lele_tpu_torch.onnx import builder as ob\n"
        "rng = np.random.default_rng(3)\n"
        "n = ob.node('MatMulNBits', ['a', 'b', 'sc'], ['y'], domain='com.microsoft',\n"
        "            K=256, N=48, bits=4, block_size=32)\n"
        "bs = ob.build_model_bytes([n], [ob.value_info('a', 1, [3, 256])],\n"
        "    [ob.value_info('y', 1, [3, 48])], [ob.tensor_from_array(\n"
        "    rng.integers(0, 256, (48, 8, 16), dtype=np.uint8), 'b'),\n"
        "    ob.tensor_from_array(rng.random((48, 8)).astype(np.float32), 'sc')])\n"
        "a = rng.standard_normal((3, 256)).astype(np.float32)\n"
        "cm = compile_model(bs, device='cpu', strict=True)\n"
        "assert cm.stats['pattern_hits']['matmul_nbits_w4'] == 2\n"
        "assert np.isfinite(cm.run_np(a=a)[0]).all()\n"
        "from lele_tpu_torch.ops import nn_ops\n"
        "n = ob.node('GRU', ['x', 'w', 'r', 'b'], ['y', 'yh'], hidden_size=8,\n"
        "            direction='bidirectional', linear_before_reset=1)\n"
        "bs = ob.build_model_bytes([n], [ob.value_info('x', 1, [5, 2, 4])],\n"
        "    [ob.value_info('y', 1, []), ob.value_info('yh', 1, [])], [\n"
        "    ob.tensor_from_array(rng.standard_normal((2, 24, 4)).astype(np.float32), 'w'),\n"
        "    ob.tensor_from_array(rng.standard_normal((2, 24, 8)).astype(np.float32), 'r'),\n"
        "    ob.tensor_from_array(rng.standard_normal((2, 48)).astype(np.float32), 'b')])\n"
        "cm = compile_model(bs, device='cpu', strict=True)\n"
        "before = nn_ops.RNN_ROUTES['gru_seq']\n"
        "y, yh = cm.run_np(x=rng.standard_normal((5, 2, 4)).astype(np.float32))\n"
        "assert y.shape == (5, 2, 2, 8) and np.isfinite(y).all()\n"
        "assert nn_ops.RNN_ROUTES['gru_seq'] == before + 2\n"
        "from lele_tpu_torch.onnx.synth import build_moe_layer_model\n"
        "cm = compile_model(build_moe_layer_model(2, hidden=32, inter=48), device='cpu',\n"
        "                   strict=True)\n"
        "assert cm.stats['pattern_hits']['qmoe_w4'] == 2\n"
        "y = cm.run_np(x=rng.standard_normal((2, 32)).astype(np.float32))[0]\n"
        "assert y.shape == (2, 32) and np.isfinite(y).all()\n"
        "from lele_tpu_torch.serving import TtsEngine\n"
        "from lele_tpu_torch.utils.wav import decode_wav_bytes\n"
        "tts = SupertonicTts(SupertonicConfig(d_text=64, n_heads=2, n_text_layers=1,\n"
        "    n_est_layers=1, latent_buckets=(32, 64), fused_estimator=True), device='cpu')\n"
        "tts.init(0)\n"
        "eng = TtsEngine(tts=tts)\n"
        "eng.load_style('examples/supertonic/voice_styles/F1.json')\n"
        "pcm, sr = decode_wav_bytes(eng.synthesize('Hello there.'))\n"
        "assert sr == 24000 and len(pcm) >= 8 * 256 and np.isfinite(pcm).all()\n"
        "io = np.load('fixtures/supertonic_io.npz')\n"
        "dur, wave = SupertonicOnnx('fixtures', device='cpu').synthesize_latent(\n"
        "    io['ids'], io['style'], io['mask'], latent_len=32, seed=1)\n"
        "assert wave.shape == (1, 128) and np.isfinite(wave).all()\n"
        "from lele_tpu_torch.onnx.synth import (attn23_decoder_params, attn23_step_feeds,\n"
        "                                       build_attn23_decoder)\n"
        "from lele_tpu_torch.ops import attention_ops\n"
        "cfg = dict(hidden=32, heads=2, kv_heads=2, head_dim=16, ffn=48, layers=1, vocab=50,\n"
        "           eps=1e-5, theta=1e4, max_pos=256, l_max=256, batch=1)\n"
        "bs = build_attn23_decoder(attn23_decoder_params(rng, cfg), 'S', cfg)\n"
        "steps = {s: compile_model(bs, dim_values={'S': s}, device='cpu', strict=True)\n"
        "         for s in (128, 1)}\n"
        "caches = {'ck0': np.zeros((1, 2, 256, 16), np.float32)}\n"
        "caches['cv0'] = caches['ck0']\n"
        "before = dict(attention_ops.ATTENTION_ROUTES)\n"
        "ids, start = rng.integers(0, 50, (1, 128)), 0\n"
        "for _ in range(3):\n"
        "    logits, caches['ck0'], caches['cv0'] = steps[ids.shape[1]].run_np(\n"
        "        **attn23_step_feeds(ids, start, 256), **caches)\n"
        "    assert np.isfinite(logits).all()\n"
        "    start, ids = start + ids.shape[1], logits[:, -1:].argmax(-1)\n"
        "routes = attention_ops.ATTENTION_ROUTES\n"
        "assert routes['flash_attn'] == before['flash_attn'] + 1, routes\n"
        "assert routes['einsum'] == before['einsum'] + 2, routes\n"
        "import dataclasses\n"
        "from lele_tpu_torch.serving import encode_wav\n"
        "from lele_tpu_torch.utils.tokenizer import CtcTokenizer, synthetic_vocab\n"
        "from lele_tpu_torch.utils.ctc_decode import ctc_beam_decode\n"
        "cfgq = SenseVoiceConfig(n_layers=2, d_model=64, n_heads=2, ffn_dim=96, vocab_size=40,\n"
        "                        quantized=True)\n"
        "mq = SenseVoiceModel(cfgq, device='cpu'); mq.init(0)\n"
        "mq.params = stack_layer_params(prepare_quantized_params(mq.params, drop_fp=True))\n"
        "pcm = np.random.default_rng(4).standard_normal(20000).astype(np.float32) * 0.1\n"
        "lq = mq.forward_fn()(mq.params, pcm)\n"
        "mq5 = SenseVoiceModel(dataclasses.replace(cfgq, quant_pallas=True), device='cpu')\n"
        "assert torch.equal(lq, mq5.forward_fn()(mq.params, pcm))\n"
        "assert all(0 <= i < 40 for i in ctc_beam_decode(lq[0].numpy(), 4))\n"
        "eng = SenseVoiceEngine(model=mq, tokenizer=CtcTokenizer(synthetic_vocab(40)))\n"
        "texts = eng.recognize_batch([encode_wav(pcm, 16000), encode_wav(pcm[:9000], 16000)])\n"
        "assert len(texts) == 2 and all(isinstance(t, str) for t in texts)\n"
        "ids_b = mq.transcribe_batch([pcm, pcm[:7000], pcm[:12000]])\n"
        "assert len(ids_b) == 3 and all(0 <= i < 40 for r in ids_b for i in r)\n"
        "ids_l = mq.transcribe_long(np.tile(pcm, 5), window_s=3.0, overlap_s=1.0)\n"
        "assert all(0 <= i < 40 for i in ids_l)\n"
        "st = StreamingSenseVoice(cfg=dataclasses.replace(cfgq, quantized=False),\n"
        "                         stream=StreamConfig(chunk_frames=8), device='cpu')\n"
        "st.params = SenseVoiceModel(st.cfg, device='cpu').init(0)\n"
        "ids_s, state = st.decode_step_fn()(st.params, torch.zeros((1, 8, 560)),\n"
        "    torch.ones((1, 8)), init_stream_state(st.cfg, st.stream, device='cpu'))\n"
        "assert ids_s.shape == (1, 8) and int(state['pos']) == 8\n"
        "from lele_tpu_torch.ops import quant_ops\n"
        "n = [ob.node('DynamicQuantizeLinear', ['x'], ['q', 's', 'z']),\n"
        "     ob.node('MatMulInteger', ['q', 'w', 'z'], ['y'])]\n"
        "bs = ob.build_model_bytes(n, [ob.value_info('x', 1, [3, 16])],\n"
        "    [ob.value_info('y', 6, [3, 5])], [ob.tensor_from_array(\n"
        "    rng.integers(0, 256, (16, 5), dtype=np.uint8), 'w')])\n"
        "x = rng.standard_normal((3, 16)).astype(np.float32)\n"
        "y = compile_model(bs, device='cpu', strict=True).run_np(x=x)[0]\n"
        "y0 = compile_model(bs, device='cpu', strict=True, overrides={\n"
        "    'MatMulInteger': quant_ops.matmul_integer_plain}).run_np(x=x)[0]\n"
        "assert y.dtype == np.int32 and np.array_equal(y, y0)\n"
        "from lele_tpu_torch.serving import Yolo26Engine\n"
        "yo = YoloOnnx('fixtures/yolo26.onnx', device='cpu', compute='bfloat16')\n"
        "logits, boxes = yo.forward(np.load('fixtures/yolo26_input.npy'))\n"
        "assert logits.shape == (1, 300, 16) and boxes.dtype == np.float32\n"
        "img = np.random.default_rng(5).integers(0, 256, (128, 160, 3), dtype=np.uint8)\n"
        "assert len(yo.detect(img, 0.0)) == 300\n"
        "ycfg = Yolo26Config(img_size=128, widths=(8, 16, 32, 64), segmentation=True)\n"
        "ym = Yolo26Model(ycfg, device='cpu'); ym.init(0)\n"
        "eng = Yolo26Engine(model=ym, conf_threshold=0.0)\n"
        "dets = eng.detect_batch([img, img[:100]])\n"
        "assert len(dets) == 2 and len(dets[0]) == 64\n"
        "s, b, c, p = ym.forward_fn()(ym.params, img[None, :128, :128])\n"
        "assert p.shape == (1, 16, 16, 32) and compose_masks(c.numpy(), p.numpy(),\n"
        "    b.numpy(), [0, 1], 128).shape == (2, 128, 128)\n"
        "from lele_tpu_torch.runtime import graphs\n"
        "progs = graphs.Programs('cpu')\n"
        "out = progs.run('k', lambda: lambda x, s: (x + s, s * 2), np.ones(3, np.float32),\n"
        "                torch.ones(3), donate={1: 1})\n"
        "assert torch.equal(out[0], torch.full((3,), 2.0)) and len(progs) == 0\n"
        "sv8 = SileroOnnx('fixtures/silero.onnx', device='cpu')\n"
        "q = sv8.speech_probs(pcm[:9 * 512], 16000)\n"
        "assert q.shape == (9,) and np.array_equal(q, sv8.speech_probs_hostloop(pcm[:9 * 512]))\n"
        "assert sv8.compiled(16000).donated == {'state': 1}\n"
        "n0 = tts.dispatches\n"
        "sty = load_voice_style('examples/supertonic/voice_styles/F1.json')\n"
        "w1 = tts.synthesize('Hello there.', sty)\n"
        "w2 = tts.synthesize('Hello there.', sty,\n"
        "                    fused_duration=False)\n"
        "assert np.array_equal(w1, w2) and tts.dispatches == n0 + 2\n"
        "from lele_tpu_torch.runtime import compose_models, StaticKVDecoder, Seq2SeqGenerator\n"
        "from lele_tpu_torch.onnx import torch_shim\n"
        "st5 = SupertonicOnnx('fixtures', device='cpu')\n"
        "d5, w5 = st5.synthesize_latent(io['ids'], io['style'], io['mask'], latent_len=32)\n"
        "assert np.abs(w5 - st5.synthesize_latent_hostloop(io['ids'], io['style'],\n"
        "    io['mask'], latent_len=32)[1]).max() <= 1e-6\n"
        "assert torch_shim.install() and sys.modules['onnx'].__version__.endswith('torch_shim')\n"
        "class Step(torch.nn.Module):\n"
        "    def __init__(self):\n"
        "        super().__init__(); self.emb = torch.nn.Embedding(13, 8)\n"
        "        self.pemb = torch.nn.Embedding(10, 8)\n"
        "        self.head = torch.nn.Linear(8, 13)\n"
        "    def forward(self, ids, pos, ck, cv, mask, xk, xv):\n"
        "        x = self.emb(ids) + self.pemb(pos)\n"
        "        a = torch.softmax(x @ ck[0, :, 0].transpose(-1, -2) + mask[:, 0, :, :-1], -1)\n"
        "        x = x + a @ cv[0, :, 0] + xk.mean() + xv.mean()\n"
        "        return self.head(x)[:, 0], x[None, :, None], x[None, :, None] * 2\n"
        "class Enc(torch.nn.Module):\n"
        "    def forward(self, src):\n"
        "        return src[None, None, None] * 1.0, src[None, None, None] * 2.0\n"
        "import io as bio\n"
        "def export(m, args):\n"
        "    f = bio.BytesIO()\n"
        "    torch.onnx.export(m.eval(), args, f, opset_version=17, dynamo=False)\n"
        "    return compile_model(f.getvalue(), device='cpu', strict=True)\n"
        "z = torch.zeros\n"
        "step = export(Step(), (z(1, 1, dtype=torch.long), z(1, 1, dtype=torch.long),\n"
        "    z(1, 1, 1, 9, 8), z(1, 1, 1, 9, 8), z(1, 1, 1, 10), z(1, 1, 1, 3, 8), z(1, 1, 1, 3, 8)))\n"
        "gen = Seq2SeqGenerator(export(Enc(), (z(3, 8),)), step, num_layers=1, num_heads=1,\n"
        "    head_dim=8, max_len=10, bos_id=1, eos_id=0)\n"
        "src = np.random.default_rng(6).standard_normal((3, 8)).astype(np.float32)\n"
        "assert gen.generate(src, max_steps=6) == gen.generate_hostloop(src, max_steps=6)\n"
        "ids_g, _ = gen.decoder.generate_fused([2, 3], 5, temperature=1.0, seed=4,\n"
        "                                      extras=gen.encode(src))\n"
        "assert ids_g == gen.decoder.generate_hostloop([2, 3], 5, rng=4, temperature=1.0,\n"
        "                                              extras=gen.encode(src))[0]\n"
        "assert len(gen.decoder.beam_search([2], 4, beam=1, eos_id=0,\n"
        "    extras=gen.encode(src))[0]) <= 4\n"
        "pipe = compose_models({'voc': st5.voc}, lambda call, x: call('voc', **{\n"
        "    st5.voc.input_order[0]: x})[0])\n"
        "assert pipe(io['xt']).shape == io['wave'].shape\n"
        "import chip_smoke\n"
        "from lele_tpu_torch.onnx.quantize import quantize_dynamic\n"
        "ch = sv8._chunks(pcm[:3 * 512], None)[:, None]\n"
        "for form in ('scan', 'loop'):\n"
        "    cm = compile_model(chip_smoke.silero_utterance_model(form, 3, 16000), device='cpu')\n"
        "    p3 = cm.run_np(chunks=ch, state=np.zeros((2, 1, 128), np.float32))[0]\n"
        "    assert np.array_equal(p3, sv8.speech_probs(pcm[:3 * 512])) and cm.stats['capturable']\n"
        "lay, enc = chip_smoke.sanm_modules(8, 64, 2, 32, 3)\n"
        "torch.manual_seed(0)\n"
        "sargs = (torch.randn(1, 8, 64), torch.zeros(1, 1, 1, 8), torch.ones(1, 1, 8))\n"
        "qm = quantize_dynamic(chip_smoke.sanm_export(enc(1).eval(), lay, sargs, True))\n"
        "cm = compile_model(qm, device='cpu')\n"
        "assert cm.stats['pattern_hits']['sanm_fused_layers'] == 1\n"
        "assert np.isfinite(cm.run_np(*[a.numpy() for a in sargs])[0]).all()\n"
        "n = [ob.node('SplitToSequence', ['x'], ['s'], axis=0, keepdims=0),\n"
        "     ob.node('SequenceErase', ['s'], ['e']),\n"
        "     ob.node('ConcatFromSequence', ['e'], ['y'], axis=0, new_axis=1)]\n"
        "bs = ob.build_model_bytes(n, [ob.value_info('x', 1, [3, 2])],\n"
        "                          [ob.value_info('y', 1, [2, 2])])\n"
        "xs = np.arange(6, dtype=np.float32).reshape(3, 2)\n"
        "assert np.array_equal(compile_model(bs, device='cpu').run_np(x=xs)[0], xs[:2])\n"
        "import tempfile, pathlib\n"
        "from lele_tpu_torch.onnx.synth import (GENAI_MOE_CFG, build_genai_decoder,\n"
        "    genai_decoder_params, genai_feeds)\n"
        "cfg = dict(GENAI_MOE_CFG, B=1)\n"
        "gi, _ = genai_decoder_params(np.random.default_rng(0), cfg)\n"
        "with tempfile.TemporaryDirectory() as d:\n"
        "    ps = [pathlib.Path(d) / f's{s}.onnx' for s in (3, 1)]\n"
        "    for p, s in zip(ps, (3, 1)):\n"
        "        ob.save_with_external_data(build_genai_decoder(gi, s, cfg, raw=True), p, 64)\n"
        "    gcm = [compile_model(str(p), device='cpu', strict=True, donate=['pk0', 'pv0'])\n"
        "           for p in ps]\n"
        "z = [np.zeros((1, 2, 16, 8), np.float32)] * 2\n"
        "f = genai_feeds(np.array([[1, 2, 3]]), np.arange(3)[None], 0, 3, z, z, cfg)\n"
        "for t in range(3):\n"
        "    o = gcm[min(t, 1)].run_np(**f)\n"
        "    tok = o[0][:, -1].argmax(-1)[:, None]\n"
        "    f = genai_feeds(tok, np.full((1, 1), 3 + t), 3 + t, 1, o[1::2], o[2::2], cfg)\n"
        "assert np.isfinite(o[0]).all() and gcm[1].stats['pattern_hits']['qmoe_w4'] == 4\n"
        "rb, _ = chip_smoke.resnet50_model(batch=1, width=8, blocks=(1, 1, 1, 1), classes=10,\n"
        "                                  img=32)\n"
        "xi = np.random.default_rng(7).standard_normal((1, 3, 32, 32)).astype(np.float32)\n"
        "lo, pr, t5, ti, am = compile_model(rb, device='cpu', strict=True).run_np(data=xi)\n"
        "assert np.isfinite(lo).all() and ti[0, 0] == am[0] == lo.argmax()\n"
        "for c in chip_smoke.emitter_graphs():\n"
        "    if c['name'] in ('Mod', 'LogSoftmax', 'ScatterND', 'ConvTranspose 3-D', 'TopK',\n"
        "                     'MaxPool', 'RandomNormal', 'Resize'):\n"
        "        cm = compile_model(chip_smoke.emitter_graph_bytes(c), device='cpu', strict=True)\n"
        "        assert all(np.isfinite(v.astype(np.float64)).all()\n"
        "                   for v in cm.run_np(**c['inputs'])) and cm.stats['capturable']\n"
        "from lele_tpu_torch.onnx.quantize import calibrate_minmax, quantize_static\n"
        "small = dict(batch=1, width=8, blocks=(1, 1, 1, 1), classes=10, img=32)\n"
        "bq = [{'data': np.random.default_rng(8).standard_normal((1, 3, 32, 32),\n"
        "                                                       dtype=np.float32)}]\n"
        "qd = quantize_static(rb, bq, per_channel=True, device='cpu')\n"
        "assert np.isfinite(compile_model(qd, device='cpu', strict=True).run_np(data=xi)[0]).all()\n"
        "rg = calibrate_minmax(chip_smoke.resnet50_folded_model(**small), bq, device='cpu')\n"
        "qo, qi = chip_smoke.resnet50_qoperator_model(rg, **small)\n"
        "lq = compile_model(qo, device='cpu', strict=True).run_np(data=xi)[0]\n"
        "assert np.isfinite(lq).all() and lq.shape == (1, 10) and qi['int8_products'] == 18\n"
        "import contextlib, importlib.util, json, pathlib, tempfile, threading, urllib.request\n"
        "from io import StringIO\n"
        "from lele_tpu_torch import server as srv\n"
        "from lele_tpu_torch.cli import main as cli_main\n"
        "wt = np.random.default_rng(9).standard_normal((8, 12)).astype(np.float32)\n"
        "with tempfile.TemporaryDirectory() as d:\n"
        "    d = pathlib.Path(d)\n"
        "    (d / 'toy.onnx').write_bytes(ob.build_model_bytes([ob.node('MatMul', ['x', 'w'],\n"
        "        ['y'])], [ob.value_info('x', 1, [2, 8])], [ob.value_info('y', 1, [2, 12])],\n"
        "        [ob.tensor_from_array(wt, 'w')]))\n"
        "    with contextlib.redirect_stdout(StringIO()):\n"
        "        assert cli_main([str(d / 'toy.onnx'), str(d / 'gen'), 'NoJaxToy', '--device',\n"
        "                         'cpu']) == 0\n"
        "    spec = importlib.util.spec_from_file_location('NoJaxToy', d / 'gen' / 'NoJaxToy.py')\n"
        "    wmod = importlib.util.module_from_spec(spec); spec.loader.exec_module(wmod)\n"
        "    xt = np.ones((2, 8), np.float32)\n"
        "    assert np.array_equal(wmod.NoJaxToy(device='cpu').forward(xt)[0],\n"
        "        compile_model(str(d / 'toy.onnx'), device='cpu').run_np(xt)[0])\n"
        "with contextlib.redirect_stdout(StringIO()):\n"
        "    httpd = srv.serve(port=0, tiny=True, device='cpu')\n"
        "threading.Thread(target=httpd.serve_forever, daemon=True).start()\n"
        "wv = encode_wav(pcm[:12000], 16000)\n"
        "with urllib.request.urlopen(urllib.request.Request(\n"
        "        f'http://127.0.0.1:{httpd.server_address[1]}/recognize', data=wv), timeout=120) as r:\n"
        "    assert json.loads(r.read()) == {'ids': srv._LAST_ENGINES['asr'].recognize(wv)}\n"
        "httpd.shutdown()\n"
        "fe = chip_smoke.frontend_model(16000, L=2, d=64, h=2, ffn=96, vocab=40)\n"
        "fcm = compile_model(fe, device='cpu', strict=True)\n"
        "fpcm = np.random.default_rng(5).standard_normal(16000).astype(np.float32) * 0.1\n"
        "flg, fmel = fcm.run_np(**chip_smoke.frontend_feeds(fpcm))\n"
        "assert flg.shape == (1, 17 + 4, 40) and fmel.shape == (1, 98, 80)\n"
        "assert np.isfinite(flg).all() and fcm.stats['pattern_hits']['sanm_fused_layers'] == 2\n"
        "sd, _ = chip_smoke.sd_block_model(channels=16, groups=4, side=8)\n"
        "sy = compile_model(sd, device='cpu', strict=True).run_np(\n"
        "    h=np.ones((2, 8, 8, 16), np.float32), temb=np.ones((2, 16), np.float32))[0]\n"
        "assert sy.shape == (2, 8, 8, 16) and np.isfinite(sy).all()\n"
        "from lele_tpu_torch.onnx import OnnxModel, bind_inputs\n"
        "g2 = dict(vocab=97, d=32, heads=2, layers=2, max_len=64, ffn=64)\n"
        "beam, _, _, binds = chip_smoke.gpt2_search_models(chip_smoke.gpt2_search_params(cfg=g2), g2)\n"
        "bcm = compile_model(bind_inputs(OnnxModel.from_bytes(beam), binds['beam']), device='cpu')\n"
        "bids, bmask = chip_smoke.search_prompts(97)\n"
        "bseq, bsc = bcm.run_np(input_ids=bids, attention_mask=bmask)\n"
        "assert bseq.shape == (2, 2, 48) and np.isfinite(bsc).all() and bcm.stats['capturable']\n"
        "assert bcm.stats['pattern_hits']['dql_matmul_dataflow'] == 14\n"
        "pk, _, pf = chip_smoke.packed_bert_models(2, 8, layers=1, d=16, heads=2, ffn=32)\n"
        "assert compile_model(pk, device='cpu', strict=True).run_np(**pf)[0].shape == (2, 8, 16)\n"
        "import tempfile\n"
        "from lele_tpu_torch.models.sensevoice import init_sensevoice\n"
        "from lele_tpu_torch.train import make_train_step\n"
        "from lele_tpu_torch.train.checkpoint import latest_step, restore_train_state, save_train_state\n"
        "tcfg = SenseVoiceConfig(n_layers=1, d_model=32, ffn_dim=64, vocab_size=32, n_heads=2,\n"
        "                        dtype='float32', remat=True)\n"
        "tp = init_sensevoice(torch.Generator().manual_seed(0), tcfg)\n"
        "ttx, tstep = make_train_step(tcfg, lr=1e-3)\n"
        "topt = ttx.init(tp)\n"
        "tb = {'feats': np.random.default_rng(6).standard_normal((2, 10, 560)).astype(np.float32),\n"
        "      'feat_mask': np.ones((2, 10), np.float32), 'labels': np.array([[1, 2, 3], [4, 5, 6]]),\n"
        "      'label_mask': np.ones((2, 3), np.float32)}\n"
        "tp, topt, tl = tstep(tp, topt, tb)\n"
        "assert torch.isfinite(tl) and int(topt['count']) == 1\n"
        "with tempfile.TemporaryDirectory() as td:\n"
        "    save_train_state(td, tp, topt, 1)\n"
        "    rp, ro, rs = restore_train_state(\n"
        "        td, init_sensevoice(torch.Generator().manual_seed(1), tcfg), ttx.init(tp))\n"
        "    assert rs == 1 == latest_step(td) and torch.equal(rp['ctc']['w'], tp['ctc']['w'])\n"
        "    assert torch.equal(ro['nu']['embed']['w'], topt['nu']['embed']['w'])\n"
        "from lele_tpu_torch.parallel.planner import H100, EncoderSpec, format_plans, plan_encoder\n"
        "assert 'dp' in format_plans(plan_encoder(EncoderSpec(batch=8, seq=96), 8, chip=H100))\n"
        "import lele_tpu_torch.parallel.spmd  # noqa: F401\n"
        "import lele_tpu_torch.parallel.lockstep  # noqa: F401\n"
        "from lele_tpu_torch.onnx import builder as mob\n"
        "from lele_tpu_torch.parallel import init_distributed, make_mesh, pipeline_apply\n"
        "from lele_tpu_torch.parallel import stack_stage_params\n"
        "from lele_tpu_torch.parallel.pipeline import pipe_mesh\n"
        "from lele_tpu_torch.server import plan_serving_mesh\n"
        "with tempfile.TemporaryDirectory() as td:\n"
        "    init_distributed(0, 1, f'file://{td}/rv', 'cpu')\n"
        "    assert plan_serving_mesh() == (None, None)\n"
        "    pw = stack_stage_params([{'w': torch.eye(4) * 2}])\n"
        "    py = pipeline_apply(lambda p, mb: mb @ p['w'], pw, torch.ones(4, 4), pipe_mesh(1), 2)\n"
        "    assert torch.equal(py, torch.full((4, 4), 2.0))\n"
        "    mw = np.arange(12, dtype=np.float32).reshape(3, 4)\n"
        "    mbs = mob.build_model_bytes([mob.node('MatMul', ['x', 'w'], ['y'])],\n"
        "        inputs=[mob.value_info('x', 1, [2, 3])], outputs=[mob.value_info('y', 1, [2, 4])],\n"
        "        initializers=[mob.tensor_from_array(mw, 'w')])\n"
        "    mcm = compile_model(mbs, mesh=make_mesh(1), param_rules=lambda n, s: (None, 'model'))\n"
        "    assert np.array_equal(mcm.run_np(np.ones((2, 3), np.float32))[0], np.ones((2, 3)) @ mw)\n"
        "    torch.distributed.destroy_process_group()\n"
        "assert not any(k.split('.')[0] in ('jax', 'lele_tpu', 'PIL', 'optax', 'orbax')\n"
        "               for k, v in sys.modules.items() if v is not None)\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
