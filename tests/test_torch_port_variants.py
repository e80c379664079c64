"""The port's SAN-M matcher against the JAX package's on the 13 export
variants of tests/test_sanm_fuse_variants.py.

Each variant perturbs the synthetic SAN-M int8 graph (Identity or Cast glue,
a Div-form attention scale, Split sizes as an input, a biased FSMN conv, a
weight zero point other than 128, an intermediate exposed as a graph output,
an extra consumer, per-channel weight scales, layer dims that differ, a
MatMulInteger without zero points) and must fuse or bail in the port exactly
as it does in JAX: the same `pattern_hits`, fused and per-op. The port's
fused path is held against its own per-op path of the same graph at JAX's
gate (atol 2e-3). The variants are rebuilt here on the port's builder; both
packages compile the same bytes.
"""

import numpy as np
import pytest

from lele_tpu_torch.compiler import compile_model
from lele_tpu_torch.compiler.patterns import DEFAULT_PATTERNS
from lele_tpu_torch.onnx import builder as ob
from lele_tpu_torch.onnx.synth import build_sanm_int8_graph, serialize_sanm_graph

L, D, H, FFN, VOCAB = 2, 128, 4, 256, 64
T_IN = 60  # + 4 prefix frames = 64 rows


def _find(nodes, op_type, output):
    for i, n in enumerate(nodes):
        if n["op_type"] == op_type and output in n["output"]:
            return i
    raise AssertionError(f"{op_type} -> {output} not in graph")


def _rewire(nodes, old, new, start=0):
    for n in nodes[start:]:
        n["input"] = [new if x == old else x for x in n["input"]]


def _identity(nodes, inits, outs):
    for src in ("ln1_l0", "qkv_l0", "fr_l0"):
        i = _find(nodes, next(n["op_type"] for n in nodes if src in n["output"]), src)
        _rewire(nodes, src, f"{src}__id", start=i + 1)
        nodes.insert(i + 1, ob.node("Identity", [src], [f"{src}__id"]))
    return outs


def _noop_cast(nodes, inits, outs):
    i = _find(nodes, "LayerNormalization", "ln1_l0")
    _rewire(nodes, "ln1_l0", "ln1_l0__c", start=i + 1)
    nodes.insert(i + 1, ob.node("Cast", ["ln1_l0"], ["ln1_l0__c"], to=1))
    return outs


def _div_scale(nodes, inits, outs):
    inits["sqrt_hd"] = np.float32(np.sqrt(D // H))
    for li in range(L):
        i = _find(nodes, "Mul", f"sc1_l{li}")
        nodes[i] = ob.node("Div", [f"sc0_l{li}", "sqrt_hd"], [f"sc1_l{li}"])
    return outs


def _split_sizes(nodes, inits, outs):
    inits["qkv_sizes"] = np.asarray([D, D, D], np.int64)
    for li in range(L):
        i = _find(nodes, "Split", f"q_l{li}")
        nodes[i] = ob.node("Split", [f"qkv_l{li}", "qkv_sizes"],
                           [f"q_l{li}", f"k_l{li}", f"v_l{li}"], axis=2)
    return outs


def _biased_fsmn(nodes, inits, outs):
    inits["fsmn_bias"] = np.random.default_rng(3).standard_normal(D).astype(np.float32) * 0.1
    for li in range(L):
        i = _find(nodes, "Conv", f"fs0_l{li}")
        nodes[i]["input"] = list(nodes[i]["input"]) + ["fsmn_bias"]
    return outs


def _nonclean_zp(nodes, inits, outs):
    inits["wz_qkv0"] = np.uint8(131)
    return outs


def _intermediate_output(nodes, inits, outs):
    return list(outs) + [ob.value_info("x1_l0", 1, [1, "T4", D])]


def _extra_consumer(nodes, inits, outs):
    nodes.append(ob.node("ReduceSum", ["qkv_l0"], ["qkv_tap"], keepdims=0))
    return list(outs) + [ob.value_info("qkv_tap", 1, [])]


def _per_channel_scale(nodes, inits, outs):
    rng = np.random.default_rng(5)
    base = float(inits["ws_qkv0"])
    inits["ws_qkv0"] = (base * (1.0 + 0.3 * rng.standard_normal(3 * D).astype(np.float32))
                        ).astype(np.float32)
    return outs


def _inconsistent_dims(nodes, inits, outs):
    rng = np.random.default_rng(9)
    ffn2 = FFN + 128

    def q_u8(arr):
        s = float(np.abs(arr).max() / 127.0) or 1.0
        return np.clip(np.round(arr / s) + 128, 0, 255).astype(np.uint8), np.float32(s)

    w1 = rng.standard_normal((D, ffn2)).astype(np.float32) / np.sqrt(D)
    w2 = rng.standard_normal((ffn2, D)).astype(np.float32) / np.sqrt(ffn2)
    inits["w_ff11"], inits["ws_ff11"] = q_u8(w1)
    inits["b_ff11"] = np.zeros(ffn2, np.float32)
    inits["w_ff21"], inits["ws_ff21"] = q_u8(w2)
    return outs


def _missing_azp(nodes, inits, outs):
    i = _find(nodes, "MatMulInteger", "mm_qkv0")
    nodes[i]["input"] = nodes[i]["input"][:2]
    return outs


# variant → (perturbation, fused layers in JAX's test). "fuse_count" is the
# baseline graph read only for its count, as in the JAX file.
VARIANTS = {
    "baseline": (None, L),
    "identity_glue": (_identity, L),
    "noop_cast": (_noop_cast, L - 1),
    "div_attention_scale": (_div_scale, L),
    "opset13_split_sizes": (_split_sizes, L),
    "biased_fsmn_conv": (_biased_fsmn, 0),
    "nonclean_weight_zp": (_nonclean_zp, L - 1),
    "intermediate_graph_output": (_intermediate_output, L - 1),
    "extra_consumer": (_extra_consumer, L - 1),
    "per_channel_weight_scale": (_per_channel_scale, L),
    "inconsistent_layer_dims": (_inconsistent_dims, L),
    "missing_azp_wiring": (_missing_azp, L - 1),
    "fuse_count": (None, L),
}


def _variant_bytes(name):
    perturb = VARIANTS[name][0]
    nodes, inits, ins, outs = build_sanm_int8_graph(L=L, d=D, h=H, ffn=FFN, vocab=VOCAB)
    if perturb is not None:
        outs = perturb(nodes, inits, outs)
    return serialize_sanm_graph(nodes, inits, ins, outs), len(outs)


def _inputs():
    rng = np.random.default_rng(7)
    return dict(speech=rng.standard_normal((1, T_IN, 560)).astype(np.float32),
                speech_lengths=np.asarray([T_IN], np.int64),
                language=np.asarray([3], np.int32), textnorm=np.asarray([0], np.int32))


def _jax_hits(data, mode, monkeypatch):
    from lele_tpu.compiler import compile_model as j_compile
    from lele_tpu.onnx.loader import OnnxModel as JOnnxModel

    monkeypatch.setenv("LELE_SANM_FUSE", mode)
    cm = j_compile(JOnnxModel.from_bytes(data), input_shapes={"speech": (1, T_IN, 560)})
    cm.run_np(**_inputs())
    return dict(cm.stats["pattern_hits"])


@pytest.mark.parametrize("name", list(VARIANTS))
def test_variant_fuses_or_bails_as_in_jax(name, monkeypatch):
    data, n_outs = _variant_bytes(name)
    expect = VARIANTS[name][1]
    fused = compile_model(data, input_shapes={"speech": (1, T_IN, 560)}, device="cpu")
    hits = dict(fused.stats["pattern_hits"])
    assert hits.get("sanm_fused_layers", 0) == expect, hits
    assert hits == _jax_hits(data, "interpret", monkeypatch)
    if name == "fuse_count":
        return
    # without the stack pattern, as JAX's LELE_SANM_FUSE=0
    no_stack = compile_model(data, input_shapes={"speech": (1, T_IN, 560)}, device="cpu",
                             patterns=[p for p in DEFAULT_PATTERNS
                                       if p.__name__ != "sanm_stack_dataflow"])
    assert dict(no_stack.stats["pattern_hits"]) == _jax_hits(data, "0", monkeypatch)
    per_op = compile_model(data, input_shapes={"speech": (1, T_IN, 560)}, device="cpu",
                           patterns=[])
    got, want = fused.run_np(**_inputs()), per_op.run_np(**_inputs())
    assert len(got) == len(want) == n_outs
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.isfinite(g).all()
        np.testing.assert_allclose(g, w, atol=2e-3, rtol=0)
