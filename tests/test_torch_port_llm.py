"""Opset-23 decoder step graphs (Attention + RotaryEmbedding + TensorScatter
over a static KV cache), compiled by the port and by the JAX package from
the same bytes, rolled out greedily, logits compared at
tests/test_llm_decode_e2e.py's tolerance (rtol 1e-4, atol 1e-5).

(a) tests/test_llm_decode_e2e.py's own graph (`_params`/`_build_step`:
    LayerNorm, Gelu FFN, decode steps of one token): the 10-step rollout.
(b) `onnx.synth.build_attn23_decoder`, the Phi-3 layer (RMSNorm, SiLU-gated
    FFN) at d 64, 4 heads of 16, ffn 128, vocab 100, 2 layers, a 256-slot
    cache: a 128-token prefill, which takes the flash route (its plain
    version on the CPU; `ATTENTION_ROUTES` shows it, one node a layer), then
    4 decode steps on the einsum path, caches fed back on each side. Also
    with 2 kv heads (GQA through the flash route).
"""

import numpy as np
import pytest

import test_llm_decode_e2e as G
from lele_tpu.compiler import compile_model as j_compile
from lele_tpu.onnx.loader import OnnxModel as JOnnxModel
from lele_tpu_torch.compiler import compile_model
from lele_tpu_torch.onnx.synth import (
    attn23_decoder_params,
    attn23_step_feeds,
    build_attn23_decoder,
)
from lele_tpu_torch.ops import attention_ops

TOL = dict(rtol=1e-4, atol=1e-5)
SMALL = dict(hidden=64, heads=4, kv_heads=4, head_dim=16, ffn=128, layers=2, vocab=100,
             eps=1e-5, theta=10000.0, max_pos=256, l_max=256, batch=1)


def test_llm_decode_e2e_graph_rollout_matches_jax():
    bs, _ = G._build_step(G._params(np.random.default_rng(0)))
    cm = compile_model(bs, device="cpu", strict=True)
    jm = j_compile(JOnnxModel.from_bytes(bs), strict=True)
    B, H, S, HD, NL = G.B, G.H, G.S, G.HD, G.NL
    ids = np.array([3, 7], dtype=np.int64)
    caches = {f"c{kv}{i}": np.zeros((B, H, S, HD), np.float32) for i in range(NL)
              for kv in "kv"}
    jcaches = dict(caches)
    toks = []
    for step in range(G.STEPS):
        pos = np.full((B,), step, dtype=np.int64)
        mask = np.full((B, 1, 1, S), -1e9, np.float32)
        mask[..., : step + 1] = 0.0
        feeds = {"ids": ids, "pos1": pos, "pos2": pos[:, None], "mask": mask}
        outs = cm.run_np(**feeds, **caches)
        want = jm.run_np(**feeds, **jcaches)
        for g, w in zip(outs, want):
            np.testing.assert_allclose(g, w, **TOL)
        for i in range(NL):
            caches[f"ck{i}"], caches[f"cv{i}"] = outs[1 + 2 * i], outs[2 + 2 * i]
            jcaches[f"ck{i}"], jcaches[f"cv{i}"] = want[1 + 2 * i], want[2 + 2 * i]
        ids = outs[0].reshape(B, G.V).argmax(-1).astype(np.int64)
        np.testing.assert_array_equal(ids, want[0].reshape(B, G.V).argmax(-1))
        toks.append(ids)
    assert len({tuple(t) for t in toks}) > 1  # the rollout moves


@pytest.mark.parametrize("kv_heads", [4, 2])
def test_attn23_decoder_prefill_and_decode_match_jax(kv_heads):
    cfg = dict(SMALL, kv_heads=kv_heads)
    bs = build_attn23_decoder(attn23_decoder_params(np.random.default_rng(kv_heads), cfg), "S",
                              cfg)
    prefill, decode = (compile_model(bs, dim_values={"S": s}, device="cpu", strict=True)
                       for s in (128, 1))
    j_prefill, j_decode = (j_compile(JOnnxModel.from_bytes(bs), dim_values={"S": s}, strict=True)
                           for s in (128, 1))
    L = cfg["l_max"]
    caches = {f"c{kv}{i}": np.zeros((1, kv_heads, L, 16), np.float32)
              for i in range(cfg["layers"]) for kv in "kv"}
    jcaches = dict(caches)
    ids = np.random.default_rng(5).integers(0, cfg["vocab"], (1, 128))
    start = 0
    for step in range(5):
        feeds = attn23_step_feeds(ids, start, L)
        before = dict(attention_ops.ATTENTION_ROUTES)
        outs = (prefill if step == 0 else decode).run_np(**feeds, **caches)
        route = "flash_attn" if step == 0 else "einsum"
        assert attention_ops.ATTENTION_ROUTES[route] == before[route] + cfg["layers"]
        assert sum(attention_ops.ATTENTION_ROUTES.values()) == sum(before.values()) + 2
        want = (j_prefill if step == 0 else j_decode).run_np(**feeds, **jcaches)
        assert outs[0].shape == (1, ids.shape[1], cfg["vocab"])
        for g, w in zip(outs, want):
            np.testing.assert_allclose(g, w, **TOL)
        for i in range(cfg["layers"]):
            caches[f"ck{i}"], caches[f"cv{i}"] = outs[1 + 2 * i], outs[2 + 2 * i]
            jcaches[f"ck{i}"], jcaches[f"cv{i}"] = want[1 + 2 * i], want[2 + 2 * i]
        start += ids.shape[1]
        ids = outs[0][:, -1:].argmax(-1).astype(np.int64)
        np.testing.assert_array_equal(ids, want[0][:, -1:].argmax(-1))
    written = np.abs(caches["ck0"][0, 0]).sum(-1)
    assert (written[:start] > 0).all() and (written[start:] == 0).all()
