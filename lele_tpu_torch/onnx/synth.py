"""Synthetic real-topology SAN-M int8 ONNX graphs (numpy only): the port's
copy of `build_sanm_int8_model` / `build_sanm_int8_graph` /
`serialize_sanm_graph` from lele_tpu/onnx/synth.py. The same seed gives the
same bytes as the JAX package's builder.

The graph has the FunASR int8 export layout: interleaved
DynamicQuantizeLinear → MatMulInteger → Cast/Mul/Add chains, the 4-input
signature (speech, speech_lengths, language, textnorm), FSMN depthwise convs,
prefix query frames and a dynamic-length position slice. At
`L=50, d=512, h=4, ffn=2048, vocab=25055, int8_head=True` it is the
SenseVoiceSmall-class flagship at full width, with random weights.

`build_moe_layer_model` makes the Phi-3.5-MoE-form MoE layer (router MatMul
into com.microsoft::QMoE, 4-bit experts packed by `quant4_cols`, a copy of
the JAX package's) at the widths of the repo's MoE decode row.

`build_attn23_decoder` makes an opset-23 decoder step graph of the layout
modern torch exports write (Attention + RotaryEmbedding + TensorScatter over
a static KV cache), with the Phi-3 layer (RMSNorm, SiLU-gated FFN, untied
head): tests/test_llm_decode_e2e.py's `_build_step` generalised to S tokens
a step. `PHI3_MINI` holds Phi-3-mini-4k-instruct's published widths.

The generative search exports (`build_gpt2_decoder_graph`,
`SEARCH_INPUT_ORDER`, `build_search_model`, `build_whisper_search_graphs`):
a GPT-2 step graph in onnxruntime convert_generation.py's contract, the
one-node BeamSearch / GreedySearch / Sampling / WhisperBeamSearch model
around a decoder (the search scalars as initializers, or as runtime inputs
to bind), and the Whisper/T5 two-graph form (encoder_decoder_init and a
decoder step positioned by past_sequence_length, with MultiHeadAttention or
`masked_ops=True`'s DecoderMaskedMultiHeadAttention): JAX's builders, the
same bytes.

The ORT-GenAI decoder form (`GENAI_CFG`, `GENAI_MOE_CFG`, `quant4_ort`,
`genai_decoder_params`, `build_genai_decoder`, `genai_feeds`): the op
vocabulary onnxruntime-genai's model builder writes into published int4
LLM exports (Phi-3, Llama, Qwen): MatMulNBits projections,
com.microsoft::RotaryEmbedding, GroupQueryAttention over static cache
buffers, SimplifiedLayerNormalization and SkipSimplifiedLayerNormalization,
a SwiGLU MLP or (Phi-3.5-MoE) a router MatMul into QMoE. The generator is
drawn in JAX's order, so a seed gives JAX's initializers and bytes.

`build_mha_encoder` is `dryrun_multichip`'s multi-head-attention encoder
(__graft_entry__._build_mha_encoder_bytes, the torch-export topology):
LayerNorm, a fused qkv MatMul, per-head attention, the out and FFN MatMuls;
its weights `wqkv_l*`, `wo_l*`, `w1_l*`, `w2_l*` are what the mesh legs'
Megatron rules split. Same generator order, same bytes.
"""

from __future__ import annotations

import numpy as np

from . import builder as ob


def build_sanm_int8_model(
    L: int = 4,
    d: int = 128,
    h: int = 4,
    ffn: int = 256,
    vocab: int = 512,
    din: int = 560,
    maxlen: int = 2048,
    fsmn_k: int = 11,
    seed: int = 2026,
    rng: np.random.Generator | None = None,
    int8_head: bool = False,
) -> bytes:
    """int8_head: emit the CTC projection as a DQL → MatMulInteger chain
    too, as real int8 exports do for the [d, vocab] head. Default False
    gives the bytes of fixtures/sensevoice.onnx's layout."""
    nodes, inits, inputs, outputs = build_sanm_int8_graph(
        L=L, d=d, h=h, ffn=ffn, vocab=vocab, din=din, maxlen=maxlen,
        fsmn_k=fsmn_k, seed=seed, rng=rng, int8_head=int8_head,
    )
    return serialize_sanm_graph(nodes, inits, inputs, outputs)


def serialize_sanm_graph(nodes, inits, inputs, outputs, opset: int = 17) -> bytes:
    return ob.build_model_bytes(
        nodes,
        inputs=inputs,
        outputs=outputs,
        initializers=[ob.tensor_from_array(v, k) for k, v in inits.items()],
        opset=opset,
        name="sensevoice_sanm_int8",
    )


def build_sanm_int8_graph(
    L: int = 4,
    d: int = 128,
    h: int = 4,
    ffn: int = 256,
    vocab: int = 512,
    din: int = 560,
    maxlen: int = 2048,
    fsmn_k: int = 11,
    seed: int = 2026,
    rng: np.random.Generator | None = None,
    int8_head: bool = False,
):
    """The graph before serialization — (nodes, inits, inputs, outputs) as
    plain builder dicts, for callers that perturb it before serializing
    (export variants the SAN-M matcher must fuse or bail on)."""
    rng = rng if rng is not None else np.random.default_rng(seed)

    def w(*shape, scale=None):
        s = scale if scale is not None else 1.0 / np.sqrt(shape[0])
        return (rng.standard_normal(shape) * s).astype(np.float32)

    def q_u8(arr):
        """Symmetric-ish u8 weight quantization with zp=128 (the clean i8
        case real exports use for most tensors)."""
        s = float(np.abs(arr).max() / 127.0) or 1.0
        q = np.clip(np.round(arr / s) + 128, 0, 255).astype(np.uint8)
        return q, np.float32(s)

    inits: dict[str, np.ndarray] = {}
    nodes: list[dict] = []

    def int8_chain(x_name, out_name, w_f32, bias, tag, interleave):
        """DQL → MatMulInteger → (interleaved) Mul(scale) / Cast → Mul →
        Add bias — the real export layout where chain nodes are separated
        by other computation."""
        wq, wsc = q_u8(w_f32)
        inits[f"w_{tag}"] = wq
        inits[f"wz_{tag}"] = np.uint8(128)
        inits[f"ws_{tag}"] = wsc
        inits[f"b_{tag}"] = bias
        chain = [
            ob.node("DynamicQuantizeLinear", [x_name],
                    [f"q_{tag}", f"as_{tag}", f"az_{tag}"]),
            ob.node("MatMulInteger",
                    [f"q_{tag}", f"w_{tag}", f"az_{tag}", f"wz_{tag}"],
                    [f"mm_{tag}"]),
            ob.node("Mul", [f"as_{tag}", f"ws_{tag}"], [f"cs_{tag}"]),
            ob.node("Cast", [f"mm_{tag}"], [f"mf_{tag}"], to=1),
            ob.node("Mul", [f"mf_{tag}", f"cs_{tag}"], [f"sc_{tag}"]),
            ob.node("Add", [f"sc_{tag}", f"b_{tag}"], [out_name]),
        ]
        merged = []
        ext = list(interleave)
        for c in chain:
            merged.append(c)
            if ext:
                merged.append(ext.pop(0))
        merged.extend(ext)
        nodes.extend(merged)

    inits.update({
        "lang_table": w(16, din, scale=0.05),
        "tn_table": w(4, din, scale=0.05),
        "event_emo": w(1, 2, din, scale=0.05),
        "embed_w": w(din, d),
        "embed_b": np.zeros(d, np.float32),
        "pos_table": w(1, maxlen, d, scale=0.02),
        "in_scale": np.float32(np.sqrt(d) / np.sqrt(din)),
        "after_g": np.ones(d, np.float32),
        "after_b": np.zeros(d, np.float32),
        "ctc_w": w(d, vocab),
        "ctc_b": np.zeros(vocab, np.float32),
        "c4": np.asarray([4], np.int64),
        "axes1": np.asarray([1], np.int64),
        "starts0": np.asarray([0], np.int64),
        "zero_i": np.asarray(0, np.int64),
        "inv_sqrt_hd": np.float32(1.0 / np.sqrt(d // h)),
        "neg1e4": np.float32(-1e4),
        "one_f": np.float32(1.0),
        "shape_heads": np.asarray([1, -1, h, d // h], np.int64),
        "shape_flat": np.asarray([1, -1, d], np.int64),
        "c4_end": np.asarray([2], np.int64),
        "one_i": np.asarray(1, np.int64),
    })
    nodes += [
        # prefix query frames from language/textnorm ids (real 4-input sig)
        ob.node("Gather", ["lang_table", "language"], ["lang_e"]),
        ob.node("Unsqueeze", ["lang_e", "axes1"], ["lang_e3"]),
        ob.node("Gather", ["tn_table", "textnorm"], ["tn_e"]),
        ob.node("Unsqueeze", ["tn_e", "axes1"], ["tn_e3"]),
        ob.node("Concat", ["lang_e3", "event_emo", "tn_e3"], ["prefix"],
                axis=1),
        ob.node("Concat", ["prefix", "speech"], ["x_in"], axis=1),
        ob.node("Mul", ["x_in", "in_scale"], ["x_s"]),
        ob.node("MatMul", ["x_s", "embed_w"], ["x_e0"]),
        ob.node("Add", ["x_e0", "embed_b"], ["x_e"]),
        # dynamic-length position slice: Shape→Slice→Slice chain (folds at
        # trace time — the static/dynamic split the tracer exists for)
        ob.node("Shape", ["x_e"], ["xshape"]),
        ob.node("Slice", ["xshape", "axes1", "c4_end", "starts0"], ["t4_v"]),
        ob.node("Slice", ["pos_table", "starts0", "t4_v", "axes1"], ["pos"]),
        ob.node("Add", ["x_e", "pos"], ["x_0"]),
        # valid-length mask from speech_lengths
        ob.node("Squeeze", ["t4_v"], ["t4_s"]),
        ob.node("Add", ["speech_lengths", "c4"], ["len4"]),
        ob.node("Range", ["zero_i", "t4_s", "one_i"], ["t_range"]),
        ob.node("Less", ["t_range", "len4"], ["mask_b"]),
        ob.node("Cast", ["mask_b"], ["mask_f"], to=1),
        ob.node("Unsqueeze", ["mask_f", "starts0"], ["mask2"]),   # [1,T4]
    ]

    x = "x_0"
    for li in range(L):
        t = f"l{li}"
        inits[f"g1_{t}"] = np.ones(d, np.float32)
        inits[f"bt1_{t}"] = np.zeros(d, np.float32)
        inits[f"g2_{t}"] = np.ones(d, np.float32)
        inits[f"bt2_{t}"] = np.zeros(d, np.float32)
        inits[f"fsmn_w_{t}"] = w(d, 1, fsmn_k, scale=1.0 / np.sqrt(fsmn_k))
        nodes.append(ob.node("LayerNormalization",
                             [x, f"g1_{t}", f"bt1_{t}"], [f"ln1_{t}"]))
        # qkv int8 chain, interleaved with the mask-prep nodes of this block
        side = [
            ob.node("Sub", ["one_f", "mask2"], [f"imask_{t}"]),
            ob.node("Mul", [f"imask_{t}", "neg1e4"], [f"mbias0_{t}"]),
            ob.node("Unsqueeze", [f"mbias0_{t}", "axes1"], [f"mbias1_{t}"]),
            ob.node("Unsqueeze", [f"mbias1_{t}", "axes1"], [f"mbias_{t}"]),
        ]
        int8_chain(f"ln1_{t}", f"qkv_{t}",
                   w(d, 3 * d), np.zeros(3 * d, np.float32), f"qkv{li}",
                   side)
        nodes += [
            ob.node("Split", [f"qkv_{t}"], [f"q_{t}", f"k_{t}", f"v_{t}"],
                    axis=2, num_outputs=3),
            ob.node("Reshape", [f"q_{t}", "shape_heads"], [f"qr_{t}"]),
            ob.node("Transpose", [f"qr_{t}"], [f"qh_{t}"], perm=[0, 2, 1, 3]),
            ob.node("Reshape", [f"k_{t}", "shape_heads"], [f"kr_{t}"]),
            ob.node("Transpose", [f"kr_{t}"], [f"kh_{t}"], perm=[0, 2, 3, 1]),
            ob.node("Reshape", [f"v_{t}", "shape_heads"], [f"vr_{t}"]),
            ob.node("Transpose", [f"vr_{t}"], [f"vh_{t}"], perm=[0, 2, 1, 3]),
            ob.node("MatMul", [f"qh_{t}", f"kh_{t}"], [f"sc0_{t}"]),
            ob.node("Mul", [f"sc0_{t}", "inv_sqrt_hd"], [f"sc1_{t}"]),
            ob.node("Add", [f"sc1_{t}", f"mbias_{t}"], [f"sc2_{t}"]),
            ob.node("Softmax", [f"sc2_{t}"], [f"at_{t}"], axis=-1),
            ob.node("MatMul", [f"at_{t}", f"vh_{t}"], [f"cx0_{t}"]),
            ob.node("Transpose", [f"cx0_{t}"], [f"cx1_{t}"], perm=[0, 2, 1, 3]),
            ob.node("Reshape", [f"cx1_{t}", "shape_flat"], [f"cx_{t}"]),
            # FSMN memory conv on masked values
            ob.node("Unsqueeze", ["mask2", "axes1"], [f"mv0_{t}"]),  # [1,1,T4]
            ob.node("Transpose", [f"v_{t}"], [f"vt_{t}"], perm=[0, 2, 1]),
            ob.node("Mul", [f"vt_{t}", f"mv0_{t}"], [f"vm_{t}"]),
            ob.node("Conv", [f"vm_{t}", f"fsmn_w_{t}"], [f"fs0_{t}"],
                    group=d, pads=[(fsmn_k - 1) // 2, fsmn_k // 2]),
            ob.node("Transpose", [f"fs0_{t}"], [f"fs_{t}"], perm=[0, 2, 1]),
            ob.node("Add", [f"cx_{t}", f"fs_{t}"], [f"ao_{t}"]),
        ]
        int8_chain(f"ao_{t}", f"att_{t}",
                   w(d, d), np.zeros(d, np.float32), f"out{li}", [])
        nodes.append(ob.node("Add", [x, f"att_{t}"], [f"x1_{t}"]))
        nodes.append(ob.node("LayerNormalization",
                             [f"x1_{t}", f"g2_{t}", f"bt2_{t}"], [f"ln2_{t}"]))
        int8_chain(f"ln2_{t}", f"ff1_{t}",
                   w(d, ffn), np.zeros(ffn, np.float32), f"ff1{li}", [])
        nodes.append(ob.node("Relu", [f"ff1_{t}"], [f"fr_{t}"]))
        int8_chain(f"fr_{t}", f"ff2_{t}",
                   w(ffn, d), np.zeros(d, np.float32), f"ff2{li}", [])
        nodes.append(ob.node("Add", [f"x1_{t}", f"ff2_{t}"], [f"x2_{t}"]))
        x = f"x2_{t}"

    nodes.append(
        ob.node("LayerNormalization", [x, "after_g", "after_b"], ["xf"]))
    if int8_head:
        ctc_w = inits.pop("ctc_w")
        ctc_b = inits.pop("ctc_b")
        int8_chain("xf", "logits", ctc_w, ctc_b, "ctc", [])
    else:
        nodes += [
            ob.node("MatMul", ["xf", "ctc_w"], ["lg0"]),
            ob.node("Add", ["lg0", "ctc_b"], ["logits"]),
        ]
    inputs = [
        ob.value_info("speech", 1, [1, "T", din]),
        ob.value_info("speech_lengths", 7, [1]),
        ob.value_info("language", 6, [1]),
        ob.value_info("textnorm", 6, [1]),
    ]
    outputs = [ob.value_info("logits", 1, [1, "T4", vocab])]
    return nodes, inits, inputs, outputs


# -- the Phi-3.5-MoE-form MoE layer (router MatMul + com.microsoft::QMoE) ------

# the MoE layer of the repo's own Phi-3.5-MoE-form decode row (bench.py:391-440:
# hidden qh·hd = 16·64, inter 1792, 8 experts, SparseMixer top-2, silu-gated
# fc1/fc3, 4-bit experts); the published Phi-3.5-MoE's experts are 4096 × 6400
MOE_DECODE = dict(hidden=1024, inter=1792, experts=8)


def quant4_cols(w: np.ndarray):
    """Float [E, in, out] → (packed u8 [E, in, out/2] low-nibble-first,
    scales [E, out], dequantised twin): the QMoE expert-weight storage,
    symmetric per output column with zero point 8 (a copy of
    lele_tpu/onnx/synth.py:quant4_cols)."""
    zp, qmax = 8, 7
    sc = (np.abs(w).max(axis=1) / qmax + 1e-8).astype(np.float32)
    q = np.clip(np.round(w / sc[:, None, :]) + zp, 0, 15).astype(np.uint8)
    deq = ((q.astype(np.float32) - zp) * sc[:, None, :]).astype(np.float32)
    packed = (q[..., 0::2] | (q[..., 1::2] << 4)).astype(np.uint8)
    return packed, sc, deq


def build_moe_layer_model(rows: int, hidden: int = 1024, inter: int = 1792,
                          experts: int = 8, seed: int = 0) -> bytes:
    """ONNX bytes of one Phi-3.5-MoE-form MoE layer: x [rows, hidden] → router
    MatMul [hidden → experts] → com.microsoft::QMoE (k = 2, SparseMixer, silu,
    fc3 gate, 4-bit experts, no biases) → y [rows, hidden]. Random weights
    from `seed`, drawn as lele_tpu/onnx/synth.py:genai_decoder_params draws
    the MoE layer's."""
    rng = np.random.default_rng(seed)
    E = experts
    inits = [ob.tensor_from_array(
        (rng.standard_normal((hidden, E)) / np.sqrt(hidden)).astype(np.float32), "router")]
    for nm, shp in (("fc1", (E, hidden, inter)), ("fc2", (E, inter, hidden)),
                    ("fc3", (E, hidden, inter))):
        w = (rng.standard_normal(shp) / np.sqrt(shp[1])).astype(np.float32)
        packed, sc, _ = quant4_cols(w)
        inits += [ob.tensor_from_array(packed, f"{nm}_q"), ob.tensor_from_array(sc, f"{nm}_s")]
    nodes = [ob.node("MatMul", ["x", "router"], ["logits"]),
             ob.node("QMoE", ["x", "logits", "fc1_q", "fc1_s", "", "fc2_q", "fc2_s", "",
                              "fc3_q", "fc3_s"], ["y"], domain="com.microsoft", k=2,
                     activation_type="silu", use_sparse_mixer=1, expert_weight_bits=4)]
    return ob.build_model_bytes(nodes, inputs=[ob.value_info("x", 1, [rows, hidden])],
                                outputs=[ob.value_info("y", 1, [rows, hidden])],
                                initializers=inits)


# -- the ORT-GenAI decoder form ------------------------------------------------

GENAI_CFG = dict(B=2, V=48, qh=4, kvh=2, hd=8, nl=2, L=16, ffn=48, blk=16, eps=1e-5)

# Phi-3.5-MoE form: the MLP is a router MatMul + com.microsoft::QMoE with
# SparseMixer top-2 routing and 4-bit experts (fc1/fc3 gate pair + fc2)
GENAI_MOE_CFG = dict(GENAI_CFG, experts=4, ffn=16)


def quant4_ort(w: np.ndarray, blk: int):
    """Float [N, K] → (packed u8 [N, kb, blk/2], scales [N, kb], dequantised
    twin [N, K]) in ORT's MatMulNBits layout (default zero point 8)."""
    n, k = w.shape
    kb = k // blk
    wg = w.reshape(n, kb, blk)
    sc = (np.abs(wg).max(-1) / 7.0 + 1e-8).astype(np.float32)
    q = np.clip(np.round(wg / sc[:, :, None]) + 8, 0, 15).astype(np.uint8)
    wdq = ((q.astype(np.float32) - 8.0) * sc[:, :, None]).reshape(n, k)
    packed = (q[..., 0::2] | (q[..., 1::2] << 4)).astype(np.uint8)
    return packed, sc, wdq


def genai_decoder_params(rng, cfg=None):
    """The quantized graph's initializers and the dequantised float twins an
    independent oracle reads (the same numbers on both sides)."""
    c = dict(GENAI_CFG, **(cfg or {}))
    V, qh, kvh, hd, nl, L, ffn, blk = (c["V"], c["qh"], c["kvh"], c["hd"], c["nl"], c["L"],
                                       c["ffn"], c["blk"])
    D, KVD = qh * hd, kvh * hd
    inits, deq = {}, {}

    def linear(name, n, k):
        w = (rng.standard_normal((n, k)) / np.sqrt(k)).astype(np.float32)
        packed, sc, wdq = quant4_ort(w, blk)
        inits[f"{name}_q"] = packed
        inits[f"{name}_s"] = sc
        deq[name] = wdq  # [N, K]; the layer computes x @ wdq.T

    inits["emb"] = (rng.standard_normal((V, D)) * 0.5).astype(np.float32)
    deq["emb"] = inits["emb"]
    for i in range(nl):
        linear(f"wq{i}", D, D)
        linear(f"wk{i}", KVD, D)
        linear(f"wv{i}", KVD, D)
        linear(f"wo{i}", D, D)
        linear(f"wg{i}", ffn, D)
        linear(f"wu{i}", ffn, D)
        linear(f"wd{i}", D, ffn)
        for g in (f"g_attn{i}", f"g_mlp{i}"):
            inits[g] = (rng.standard_normal(D) * 0.1 + 1).astype(np.float32)
            deq[g] = inits[g]
    inits["g_final"] = (rng.standard_normal(D) * 0.1 + 1).astype(np.float32)
    deq["g_final"] = inits["g_final"]
    if c.get("experts"):
        E, ffn = c["experts"], c["ffn"]
        for i in range(nl):
            for nm in (f"wg{i}", f"wu{i}", f"wd{i}"):
                inits.pop(f"{nm}_q", None)
                inits.pop(f"{nm}_s", None)
                deq.pop(nm, None)
            inits[f"router{i}"] = (rng.standard_normal((D, E)) / np.sqrt(D)).astype(np.float32)
            deq[f"router{i}"] = inits[f"router{i}"]
            for nm, shp in ((f"fc1_{i}", (E, D, ffn)), (f"fc2_{i}", (E, ffn, D)),
                            (f"fc3_{i}", (E, D, ffn))):
                w = (rng.standard_normal(shp) / np.sqrt(shp[1])).astype(np.float32)
                packed, sc, wdq = quant4_cols(w)
                inits[f"{nm}_q"] = packed
                inits[f"{nm}_s"] = sc
                deq[nm] = wdq  # [E, in, out]
    linear("head", V, D)
    inv = 1.0 / 10000 ** (np.arange(hd // 2) / (hd // 2))
    t = np.arange(L)[:, None] * inv[None, :]
    inits["cos"] = np.cos(t).astype(np.float32)
    inits["sin"] = np.sin(t).astype(np.float32)
    deq["cos"], deq["sin"] = inits["cos"], inits["sin"]
    return inits, deq


def build_genai_decoder(inits, s: int, cfg=None, raw: bool = False):
    """The GenAI step graph over `s` tokens (a prefill or a decode step; one
    program a shape). inputs: ids [B, s] i64, pos [B, s] i64, slk [B] i32
    (total length − 1 a row), tot [1] i32, then pk{i}, pv{i} [B, kvh, L, hd]
    f32 a layer; outputs: logits, then npk{i}, npv{i} a layer (the updated
    buffers). raw=True returns the ModelProto dict (for
    `builder.save_with_external_data`) instead of its bytes."""
    c = dict(GENAI_CFG, **(cfg or {}))
    B, V, qh, kvh, hd, nl, L, ffn, blk, eps = (
        c["B"], c["V"], c["qh"], c["kvh"], c["hd"], c["nl"], c["L"], c["ffn"], c["blk"],
        c["eps"])
    D, KVD = qh * hd, kvh * hd
    nodes = []

    def n(*a, **kw):
        nodes.append(ob.node(*a, **kw))

    def mmnb(x, w, out, n_, k_):
        n("MatMulNBits", [x, f"{w}_q", f"{w}_s"], [out], domain="com.microsoft", K=k_, N=n_,
          bits=4, block_size=blk)

    n("Gather", ["emb", "ids"], ["x0"])  # [B,S,D]
    outs = ["logits"]
    res, cur = None, "x0"
    for i in range(nl):
        if res is None:
            n("SimplifiedLayerNormalization", [cur, f"g_attn{i}"], [f"h{i}"], epsilon=eps,
              domain="com.microsoft")
            res = cur
        else:
            n("SkipSimplifiedLayerNormalization", [cur, res, f"g_attn{i}"],
              [f"h{i}", f"m{i}", f"iv{i}", f"sum_in{i}"], epsilon=eps,
              domain="com.microsoft")
            res = f"sum_in{i}"
        mmnb(f"h{i}", f"wq{i}", f"q{i}", D, D)
        mmnb(f"h{i}", f"wk{i}", f"k{i}", KVD, D)
        mmnb(f"h{i}", f"wv{i}", f"v{i}", KVD, D)
        n("RotaryEmbedding", [f"q{i}", "pos", "cos", "sin"], [f"qr{i}"],
          domain="com.microsoft", num_heads=qh)
        n("RotaryEmbedding", [f"k{i}", "pos", "cos", "sin"], [f"kr{i}"],
          domain="com.microsoft", num_heads=kvh)
        n("GroupQueryAttention",
          [f"qr{i}", f"kr{i}", f"v{i}", f"pk{i}", f"pv{i}", "slk", "tot"],
          [f"att{i}", f"npk{i}", f"npv{i}"], domain="com.microsoft", num_heads=qh,
          kv_num_heads=kvh)
        mmnb(f"att{i}", f"wo{i}", f"ao{i}", D, D)
        n("SkipSimplifiedLayerNormalization", [f"ao{i}", res, f"g_mlp{i}"],
          [f"hm{i}", f"mm_{i}", f"ivm{i}", f"sum_attn{i}"], epsilon=eps,
          domain="com.microsoft")
        res = f"sum_attn{i}"
        if c.get("experts"):
            # Phi-3.5-MoE MLP: router logits → QMoE (SparseMixer top-2,
            # silu-gated fc1/fc3 pair, 4-bit experts)
            n("MatMul", [f"hm{i}", f"router{i}"], [f"rl{i}"])
            n("QMoE",
              [f"hm{i}", f"rl{i}", f"fc1_{i}_q", f"fc1_{i}_s", "", f"fc2_{i}_q", f"fc2_{i}_s",
               "", f"fc3_{i}_q", f"fc3_{i}_s"],
              [f"dn{i}"], domain="com.microsoft", k=2, activation_type="silu",
              use_sparse_mixer=1, expert_weight_bits=4)
        else:
            mmnb(f"hm{i}", f"wg{i}", f"gate{i}", ffn, D)
            mmnb(f"hm{i}", f"wu{i}", f"up{i}", ffn, D)
            n("Sigmoid", [f"gate{i}"], [f"sig{i}"])
            n("Mul", [f"gate{i}", f"sig{i}"], [f"silu{i}"])
            n("Mul", [f"silu{i}", f"up{i}"], [f"ff{i}"])
            mmnb(f"ff{i}", f"wd{i}", f"dn{i}", D, ffn)
        cur = f"dn{i}"
        outs += [f"npk{i}", f"npv{i}"]
    n("SkipSimplifiedLayerNormalization", [cur, res, "g_final"], ["hfin", "mf", "ivf", "sumf"],
      epsilon=eps, domain="com.microsoft")
    mmnb("hfin", "head", "logits", V, D)

    inputs = [ob.value_info("ids", 7, [B, s]), ob.value_info("pos", 7, [B, s]),
              ob.value_info("slk", 6, [B]), ob.value_info("tot", 6, [1])]
    for i in range(nl):
        inputs += [ob.value_info(f"pk{i}", 1, [B, kvh, L, hd]),
                   ob.value_info(f"pv{i}", 1, [B, kvh, L, hd])]
    m = ob.model(ob.graph(nodes, "genai_decoder", inputs,
                          [ob.value_info(o, 1, []) for o in outs],
                          [ob.tensor_from_array(v, k) for k, v in inits.items()]), opset=17)
    return m if raw else ob.serialize(m)


def genai_feeds(ids, pos, past_len, s, pks, pvs, cfg=None):
    """The input dict of one step at a uniform past length `past_len`."""
    c = dict(GENAI_CFG, **(cfg or {}))
    b = c["B"]
    f = {"ids": ids, "pos": pos, "slk": np.full((b,), past_len + s - 1, np.int32),
         "tot": np.asarray([past_len + s], np.int32)}
    for i in range(c["nl"]):
        f[f"pk{i}"], f[f"pv{i}"] = pks[i], pvs[i]
    return f


# microsoft/Phi-3-mini-4k-instruct's published config.json: hidden 3,072, 32
# heads and 32 kv heads of 96, SiLU-gated FFN 8,192, 32 layers, vocab 32,064
# (untied head), RMSNorm eps 1e-5, RoPE theta 10,000 over the full head
# (rotate-half), 4,096 positions; l_max is the static cache's slots
PHI3_MINI = dict(hidden=3072, heads=32, kv_heads=32, head_dim=96, ffn=8192, layers=32,
                 vocab=32064, eps=1e-5, theta=10000.0, max_pos=4096, l_max=4096, batch=1)


def attn23_decoder_params(rng: np.random.Generator, cfg: dict) -> dict[str, np.ndarray]:
    """Random f32 weights of `build_attn23_decoder` from a numpy generator:
    matrices N(0, 1/fan_in), norm gains 1 + N(0, 0.1^2), embeddings N(0, 1),
    and the RoPE cos/sin tables [max_pos, head_dim/2]."""
    D, F, V = cfg["hidden"], cfg["ffn"], cfg["vocab"]
    hd = cfg["head_dim"]
    qd, kvd = cfg["heads"] * hd, cfg["kv_heads"] * hd

    def mat(n_in, n_out):
        w = rng.standard_normal((n_in, n_out), dtype=np.float32)
        w *= np.float32(1.0 / np.sqrt(n_in))
        return w

    def gain():
        return (1.0 + 0.1 * rng.standard_normal(D)).astype(np.float32)

    p = {"emb": rng.standard_normal((V, D), dtype=np.float32)}
    for i in range(cfg["layers"]):
        p[f"g1_{i}"] = gain()
        p[f"wq{i}"], p[f"wk{i}"], p[f"wv{i}"] = mat(D, qd), mat(D, kvd), mat(D, kvd)
        p[f"wo{i}"] = mat(qd, D)
        p[f"g2_{i}"] = gain()
        p[f"wg{i}"], p[f"wu{i}"], p[f"wd{i}"] = mat(D, F), mat(D, F), mat(F, D)
    p["gf"] = gain()
    p["head"] = mat(D, V)
    inv = 1.0 / cfg["theta"] ** (np.arange(hd // 2) / (hd // 2))
    t = np.arange(cfg["max_pos"])[:, None] * inv[None, :]
    p["cos"], p["sin"] = np.cos(t).astype(np.float32), np.sin(t).astype(np.float32)
    return p


def build_attn23_decoder(params: dict[str, np.ndarray], s: int | str, cfg: dict) -> bytes:
    """ONNX bytes (opset 23) of a decoder step over S = `s` tokens (an int, or
    a dim name to pin at compile time) and a static KV cache of l_max slots:

    inputs  ids [B, S] i64, position_ids [B, S] i64, write_idx [B] i64,
            mask [B, 1, S, l_max] f32 (0 where a key slot may be read, -1e9
            elsewhere; `attn23_step_feeds`), ck{i}, cv{i} [B, kv_heads,
            l_max, head_dim] f32 for each layer i
    outputs logits [B, S, vocab], then nk{i}, nv{i}: each layer's new cache

    x = Gather(emb, ids); each layer: h = RMSNorm(x, g1); q, k, v = h·Wq,
    h·Wk, h·Wv to [B, heads, S, hd]; RotaryEmbedding of q and k at
    position_ids; TensorScatter of k and v into the caches at write_idx
    (linear, axis -2); Attention(q, nk, nv, mask); x += att·Wo; h2 =
    RMSNorm(x, g2); x += (Sigmoid(h2·Wg)·(h2·Wg)·(h2·Wu))·Wd. Then
    logits = RMSNorm(x, gf)·W_head. Phi-3's fused qkv_proj and
    gate_up_proj are separate MatMuls here: the same function."""
    B, L, hd = cfg["batch"], cfg["l_max"], cfg["head_dim"]
    H, KVH, eps = cfg["heads"], cfg["kv_heads"], float(cfg["eps"])
    nodes = []
    inits = [ob.tensor_from_array(v, k) for k, v in params.items()]
    inits += [ob.tensor_from_array(np.array([0, 0, n, hd], np.int64), f"shp_{n}")
              for n in sorted({H, KVH})]
    inits.append(ob.tensor_from_array(np.array([0, 0, H * hd], np.int64), "shp_merge"))

    def n(*a, **kw):
        nodes.append(ob.node(*a, **kw))

    n("Gather", ["emb", "ids"], ["x"])
    cur, outs = "x", ["logits"]
    for i in range(cfg["layers"]):
        n("RMSNormalization", [cur, f"g1_{i}"], [f"h{i}"], epsilon=eps, axis=-1)
        for t_, nh in (("q", H), ("k", KVH), ("v", KVH)):
            n("MatMul", [f"h{i}", f"w{t_}{i}"], [f"{t_}f{i}"])
            n("Reshape", [f"{t_}f{i}", f"shp_{nh}"], [f"{t_}r{i}"])
            n("Transpose", [f"{t_}r{i}"], [f"{t_}4_{i}"], perm=[0, 2, 1, 3])
        n("RotaryEmbedding", [f"q4_{i}", "cos", "sin", "position_ids"], [f"qr{i}"])
        n("RotaryEmbedding", [f"k4_{i}", "cos", "sin", "position_ids"], [f"kr{i}"])
        n("TensorScatter", [f"ck{i}", f"kr{i}", "write_idx"], [f"nk{i}"], axis=-2,
          mode="linear")
        n("TensorScatter", [f"cv{i}", f"v4_{i}", "write_idx"], [f"nv{i}"], axis=-2,
          mode="linear")
        n("Attention", [f"qr{i}", f"nk{i}", f"nv{i}", "mask"], [f"att{i}"])
        n("Transpose", [f"att{i}"], [f"attT{i}"], perm=[0, 2, 1, 3])
        n("Reshape", [f"attT{i}", "shp_merge"], [f"attF{i}"])
        n("MatMul", [f"attF{i}", f"wo{i}"], [f"ao{i}"])
        n("Add", [cur, f"ao{i}"], [f"r1_{i}"])
        n("RMSNormalization", [f"r1_{i}", f"g2_{i}"], [f"hf{i}"], epsilon=eps, axis=-1)
        n("MatMul", [f"hf{i}", f"wg{i}"], [f"gt{i}"])
        n("Sigmoid", [f"gt{i}"], [f"sg{i}"])
        n("Mul", [f"sg{i}", f"gt{i}"], [f"act{i}"])
        n("MatMul", [f"hf{i}", f"wu{i}"], [f"up{i}"])
        n("Mul", [f"act{i}", f"up{i}"], [f"gu{i}"])
        n("MatMul", [f"gu{i}", f"wd{i}"], [f"dn{i}"])
        n("Add", [f"r1_{i}", f"dn{i}"], [f"r2_{i}"])
        cur = f"r2_{i}"
        outs += [f"nk{i}", f"nv{i}"]
    n("RMSNormalization", [cur, "gf"], ["hfin"], epsilon=eps, axis=-1)
    n("MatMul", ["hfin", "head"], ["logits"])

    inputs = [ob.value_info("ids", 7, [B, s]), ob.value_info("position_ids", 7, [B, s]),
              ob.value_info("write_idx", 7, [B]), ob.value_info("mask", 1, [B, 1, s, L])]
    for i in range(cfg["layers"]):
        inputs += [ob.value_info(f"ck{i}", 1, [B, KVH, L, hd]),
                   ob.value_info(f"cv{i}", 1, [B, KVH, L, hd])]
    return ob.build_model_bytes(nodes, inputs=inputs,
                                outputs=[ob.value_info(o, 1, []) for o in outs],
                                initializers=inits, opset=23, name="attn23_decoder")


def attn23_step_feeds(ids: np.ndarray, start: int, l_max: int) -> dict[str, np.ndarray]:
    """The non-cache inputs of one step over ids [B, S] written from cache
    slot `start`: positions start .. start+S-1, and the float mask that lets
    each query read the key slots up to its own position (0; -1e9 past it),
    as examples/llm_decode.py builds it."""
    b, s = ids.shape
    pos = np.arange(start, start + s, dtype=np.int64)
    mask = np.where(np.arange(l_max)[None, :] <= pos[:, None], 0.0, -1e9).astype(np.float32)
    return {"ids": ids.astype(np.int64), "position_ids": np.tile(pos, (b, 1)),
            "write_idx": np.full((b,), start, np.int64),
            "mask": np.broadcast_to(mask, (b, 1, s, l_max)).copy()}

# -- the generative search exports (com.microsoft BeamSearch, GreedySearch,
# Sampling, WhisperBeamSearch: ops/search_ops.py). The GPT decoder follows
# onnxruntime convert_generation.py's contract: inputs (input_ids,
# position_ids, attention_mask, past_0..), outputs (logits, present_0..),
# attention as com.microsoft::Attention with the stacked [2,B,H,P,dh] past
# and a [B,total] binary mask_index. JAX's builders, node for node.


def build_gpt2_decoder_graph(params, n_layer: int, n_head: int,
                             eps: float = 1e-5, name: str = "decoder"):
    """GraphProto dict of a GPT-2 LM step from a params dict (numpy):
    wte [V,D], wpe [P,D], lm_w [D,V]; per layer i: ln1_g{i}/ln1_b{i},
    attn_w{i} [D,3D], attn_b{i}, proj_w{i} [D,D], proj_b{i}, ln2_*,
    fc_w{i} [D,4D], fc_b{i}, fcp_w{i} [4D,D], fcp_b{i}; lnf_g/lnf_b.
    The HF Conv1D [in,out] layout is exactly contrib Attention's weight
    layout and MatMul's right-operand layout — no transposes needed."""
    nodes = []

    def n(*a, **kw):
        nodes.append(ob.node(*a, **kw))

    n("Gather", ["wte", "input_ids"], ["te"])
    n("Gather", ["wpe", "position_ids"], ["pe"])
    n("Add", ["te", "pe"], ["x0"])
    cur = "x0"
    outs = ["logits"]
    for i in range(n_layer):
        n("LayerNormalization", [cur, f"ln1_g{i}", f"ln1_b{i}"], [f"h{i}"],
          epsilon=eps)
        n("Attention", [f"h{i}", f"attn_w{i}", f"attn_b{i}",
                        "attention_mask", f"past_{i}"],
          [f"a{i}", f"present_{i}"], domain="com.microsoft",
          num_heads=n_head, unidirectional=1)
        n("MatMul", [f"a{i}", f"proj_w{i}"], [f"ap{i}"])
        n("Add", [f"ap{i}", f"proj_b{i}"], [f"ab{i}"])
        n("Add", [f"ab{i}", cur], [f"x1_{i}"])
        n("LayerNormalization", [f"x1_{i}", f"ln2_g{i}", f"ln2_b{i}"],
          [f"h2_{i}"], epsilon=eps)
        n("MatMul", [f"h2_{i}", f"fc_w{i}"], [f"fc{i}"])
        n("FastGelu", [f"fc{i}", f"fc_b{i}"], [f"gelu{i}"],
          domain="com.microsoft")
        n("MatMul", [f"gelu{i}", f"fcp_w{i}"], [f"fcp{i}"])
        n("Add", [f"fcp{i}", f"fcp_b{i}"], [f"fcpb{i}"])
        n("Add", [f"fcpb{i}", f"x1_{i}"], [f"x2_{i}"])
        cur = f"x2_{i}"
        outs.append(f"present_{i}")
    n("LayerNormalization", [cur, "lnf_g", "lnf_b"], ["hf"], epsilon=eps)
    n("MatMul", ["hf", "lm_w"], ["logits"])

    d = params["wte"].shape[1]
    dh = d // n_head
    inputs = [
        ob.value_info("input_ids", 6, ["b", "s"]),
        ob.value_info("position_ids", 6, ["b", "s"]),
        ob.value_info("attention_mask", 6, ["b", "total"]),
    ]
    for i in range(n_layer):
        inputs.append(
            ob.value_info(f"past_{i}", 1, [2, "b", n_head, "p", dh])
        )
    return ob.graph(
        nodes, name, inputs,
        [ob.value_info(o, 1, []) for o in outs],
        [ob.tensor_from_array(np.asarray(v, np.float32), k)
         for k, v in params.items()],
    )


# canonical ORT input orders for the three search ops
SEARCH_INPUT_ORDER = {
    "BeamSearch": [
        "input_ids", "max_length", "min_length", "num_beams",
        "num_return_sequences", "length_penalty", "repetition_penalty",
        "vocab_mask", "prefix_vocab_mask", "attention_mask",
        "decoder_input_ids", "logits_processor",
    ],
    "GreedySearch": [
        "input_ids", "max_length", "min_length", "repetition_penalty",
        "vocab_mask", "prefix_vocab_mask", "attention_mask",
    ],
    "Sampling": [
        "input_ids", "max_length", "min_length", "repetition_penalty",
        "vocab_mask", "prefix_vocab_mask", "attention_mask",
        "presence_mask", "seed",
    ],
}
SEARCH_INPUT_ORDER["WhisperBeamSearch"] = (
    SEARCH_INPUT_ORDER["BeamSearch"]
    + ["cross_qk_layer_head", "extra_decoding_ids", "temperature"]
)


def build_search_model(kind: str, decoder_graph, input_shape,
                       search_inits: dict, attrs: dict,
                       n_outputs: int = 1, input_dtype: int = 6,
                       mask_shape=None, runtime_scalars=()) -> bytes:
    """A top-level one-node search model: dynamic inputs input_ids (i32
    tokens for GPT/T5, float features for Whisper — input_dtype) and (when
    search_inits marks 'attention_mask' with None) a mask input; every
    scalar search parameter rides as an initializer (trace-time static, as
    shape-determining values must be), or, named in `runtime_scalars`, as a
    runtime input in the published form (onnx/loader.bind_inputs binds it).
    Extra subgraphs (encoder=...) ride in `attrs`."""
    order = SEARCH_INPUT_ORDER[kind]
    names = []
    for nm in order:
        if nm == "input_ids" or (
            nm == "attention_mask" and search_inits.get(nm) is None
            and nm in search_inits
        ):
            names.append(nm)
        elif nm in search_inits and search_inits[nm] is not None:
            names.append(nm)
        else:
            names.append("")
    while names and not names[-1]:
        names.pop()
    out_names = ["sequences", "sequences_scores", "scores"][:n_outputs]
    node = ob.node(kind, names, out_names, domain="com.microsoft",
                   decoder=decoder_graph, **attrs)
    inputs = [ob.value_info("input_ids", input_dtype, list(input_shape))]
    if "attention_mask" in search_inits and \
            search_inits["attention_mask"] is None:
        inputs.append(ob.value_info(
            "attention_mask", 6, list(mask_shape or input_shape)))
    inits = [
        ob.tensor_from_array(np.asarray(v), k)
        for k, v in search_inits.items()
        if v is not None and k != "input_ids" and k not in runtime_scalars
    ]
    for k in runtime_scalars:
        # the published export form: search scalars as RUNTIME inputs
        # (bind_inputs converts them to constants before compile)
        v = np.asarray(search_inits[k])
        dt = 6 if v.dtype.kind in "iu" else 1
        inputs.append(ob.value_info(k, dt, list(v.shape)))
    out_vis = [ob.value_info("sequences", 6, [])]
    if n_outputs > 1:
        out_vis.append(ob.value_info("sequences_scores", 1, []))
    if n_outputs > 2:
        out_vis.append(ob.value_info("scores", 1, []))
    return ob.serialize(ob.model(ob.graph(
        [node], f"{kind.lower()}_model", inputs, out_vis, inits,
    ), opset=17))


def build_whisper_search_graphs(p, n_layer: int, n_head: int, s0: int,
                                eps: float = 1e-5,
                                masked_ops: bool = False):
    """(encoder_decoder_init, decoder-step) GraphProto dicts in the ORT
    Whisper/T5 two-graph BeamSearch form: the init graph runs the encoder
    AND the first decoder pass on decoder_input_ids, emitting logits +
    present_*_self + present_*_cross; the step graph consumes
    past_sequence_length (ORT's DecoderMasked static-buffer contract — the
    position source that does NOT read buffer capacity via Shape) plus the
    name-paired past tensors. Params (numpy): We [F,D], be; emb [V,D],
    emb_T [D,V], pos [P,D]; per layer i: ln{1,2,3}_{g,b}{i}, s{q,k,v,o}_w/b
    (self), c{q,k,v,o}_w/b (cross, k bias-less like Whisper), f1_w/b,
    f2_w/b; lnf_{g,b}. Pre-LN blocks, FastGelu MLP, tied lm head."""
    d = p["emb"].shape[1]
    dh = d // n_head
    shp = np.asarray([0, 0, n_head, dh], np.int64)

    def blocks(n, x, tag, self_kv, cross_kv, causal):
        """Shared decoder stack; self_kv/cross_kv map layer→(k,v) input
        names (None → compute in-graph / no past)."""
        for i in range(n_layer):
            n("LayerNormalization", [x, f"ln1_g{i}", f"ln1_b{i}"],
              [f"{tag}h{i}"], epsilon=eps)
            for w in ("q", "k", "v"):
                n("MatMul", [f"{tag}h{i}", f"s{w}_w{i}"], [f"{tag}s{w}m{i}"])
                n("Add", [f"{tag}s{w}m{i}", f"s{w}_b{i}"], [f"{tag}s{w}{i}"])
            past = self_kv(i)
            if past and masked_ops:
                # the ORT GPU generative-export form: explicit
                # DecoderMaskedMultiHeadAttention over the share buffer,
                # positioned by the past_sequence_length input — no
                # injected mask needed
                n("DecoderMaskedMultiHeadAttention",
                  [f"{tag}sq{i}", f"{tag}sk{i}", f"{tag}sv{i}", "", "",
                   past[0], past[1], "past_sequence_length"],
                  [f"{tag}sa{i}", f"present_key_self_{i}",
                   f"present_value_self_{i}"],
                  domain="com.microsoft", num_heads=n_head,
                  past_present_share_buffer=1)
            else:
                ins = [f"{tag}sq{i}", f"{tag}sk{i}", f"{tag}sv{i}",
                       "", "", ""]
                if past:
                    ins += list(past)
                n("MultiHeadAttention", ins,
                  [f"{tag}sa{i}", f"present_key_self_{i}",
                   f"present_value_self_{i}"],
                  domain="com.microsoft", num_heads=n_head,
                  unidirectional=1 if causal else 0)
            n("MatMul", [f"{tag}sa{i}", f"so_w{i}"], [f"{tag}som{i}"])
            n("Add", [f"{tag}som{i}", f"so_b{i}"], [f"{tag}so{i}"])
            n("Add", [x, f"{tag}so{i}"], [f"{tag}x1_{i}"])
            n("LayerNormalization", [f"{tag}x1_{i}", f"ln2_g{i}",
                                     f"ln2_b{i}"], [f"{tag}h2_{i}"],
              epsilon=eps)
            n("MatMul", [f"{tag}h2_{i}", f"cq_w{i}"], [f"{tag}cqm{i}"])
            n("Add", [f"{tag}cqm{i}", f"cq_b{i}"], [f"{tag}cq{i}"])
            ck, cv = cross_kv(i)
            n("MultiHeadAttention", [f"{tag}cq{i}", ck, cv],
              [f"{tag}ca{i}"], domain="com.microsoft", num_heads=n_head)
            n("MatMul", [f"{tag}ca{i}", f"co_w{i}"], [f"{tag}com{i}"])
            n("Add", [f"{tag}com{i}", f"co_b{i}"], [f"{tag}co{i}"])
            n("Add", [f"{tag}x1_{i}", f"{tag}co{i}"], [f"{tag}x2_{i}"])
            n("LayerNormalization", [f"{tag}x2_{i}", f"ln3_g{i}",
                                     f"ln3_b{i}"], [f"{tag}h3_{i}"],
              epsilon=eps)
            n("MatMul", [f"{tag}h3_{i}", f"f1_w{i}"], [f"{tag}f1_{i}"])
            n("FastGelu", [f"{tag}f1_{i}", f"f1_b{i}"], [f"{tag}g{i}"],
              domain="com.microsoft")
            n("MatMul", [f"{tag}g{i}", f"f2_w{i}"], [f"{tag}f2m{i}"])
            n("Add", [f"{tag}f2m{i}", f"f2_b{i}"], [f"{tag}f2b{i}"])
            n("Add", [f"{tag}x2_{i}", f"{tag}f2b{i}"], [f"{tag}x3_{i}"])
            x = f"{tag}x3_{i}"
        n("LayerNormalization", [x, "lnf_g", "lnf_b"], [f"{tag}hf"],
          epsilon=eps)
        n("MatMul", [f"{tag}hf", "emb_T"], ["logits"])

    inits = [ob.tensor_from_array(np.asarray(v, np.float32), k)
             for k, v in p.items()]
    inits.append(ob.tensor_from_array(shp, "shp"))
    inits_enc = inits + [
        ob.tensor_from_array(p["pos"][:s0].astype(np.float32), "pos0")
    ]

    # ---------- encoder_decoder_init
    nodes = []

    def n(*a, **kw):
        nodes.append(ob.node(*a, **kw))

    n("Transpose", ["input_features"], ["ft"], perm=[0, 2, 1])
    n("MatMul", ["ft", "We"], ["em"])
    n("Add", ["em", "be"], ["ea"])
    n("Tanh", ["ea"], ["encoder_hidden_states"])
    for i in range(n_layer):
        for w, bias in (("k", False), ("v", True)):
            src = "encoder_hidden_states"
            n("MatMul", [src, f"c{w}_w{i}"], [f"x{w}m{i}"])
            if bias:
                n("Add", [f"x{w}m{i}", f"c{w}_b{i}"], [f"x{w}a{i}"])
            flat = f"x{w}a{i}" if bias else f"x{w}m{i}"
            n("Reshape", [flat, "shp"], [f"x{w}r{i}"])
            n("Transpose", [f"x{w}r{i}"], [f"present_{'key' if w == 'k' else 'value'}_cross_{i}"],
              perm=[0, 2, 1, 3])
    n("Gather", ["emb", "decoder_input_ids"], ["de"])
    n("Add", ["de", "pos0"], ["dx"])
    blocks(n, "dx", "d",
           self_kv=lambda i: None,
           cross_kv=lambda i: (f"present_key_cross_{i}",
                               f"present_value_cross_{i}"),
           causal=True)
    outs = ["logits", "encoder_hidden_states"]
    for i in range(n_layer):
        outs += [f"present_key_self_{i}", f"present_value_self_{i}"]
    for i in range(n_layer):
        outs += [f"present_key_cross_{i}", f"present_value_cross_{i}"]
    enc_graph = ob.graph(
        nodes, "encoder_decoder_init",
        [ob.value_info("input_features", 1, ["b", "F", "T"]),
         ob.value_info("decoder_input_ids", 6, ["b", s0])],
        [ob.value_info(o, 1, []) for o in outs],
        inits_enc,
    )

    # ---------- decoder step
    nodes = []
    n("Gather", ["emb", "input_ids"], ["de"])
    n("Gather", ["pos", "past_sequence_length"], ["pe"])
    n("Add", ["de", "pe"], ["dx"])
    blocks(n, "dx", "d",
           self_kv=lambda i: (f"past_key_self_{i}", f"past_value_self_{i}"),
           cross_kv=lambda i: (f"past_key_cross_{i}",
                               f"past_value_cross_{i}"),
           causal=False)
    outs = ["logits"]
    for i in range(n_layer):
        outs += [f"present_key_self_{i}", f"present_value_self_{i}"]
    dec_inputs = [
        ob.value_info("input_ids", 6, ["b", 1]),
        ob.value_info("past_sequence_length", 6, [1]),
    ]
    for i in range(n_layer):
        dec_inputs += [
            ob.value_info(f"past_key_self_{i}", 1, ["b", n_head, "p", dh]),
            ob.value_info(f"past_value_self_{i}", 1, ["b", n_head, "p", dh]),
            ob.value_info(f"past_key_cross_{i}", 1, ["b", n_head, "T", dh]),
            ob.value_info(f"past_value_cross_{i}", 1,
                          ["b", n_head, "T", dh]),
        ]
    dec_graph = ob.graph(
        nodes, "decoder_step", dec_inputs,
        [ob.value_info(o, 1, []) for o in outs],
        inits,
    )
    return enc_graph, dec_graph


def build_mha_encoder(rng, D: int, H: int, F: int, L: int) -> bytes:
    """The L-layer MHA encoder graph, input x [B, T, D] (dims "B", "T")."""
    hd = D // H
    inits = {
        "shape_heads": np.asarray([0, -1, H, hd], np.int64),
        "shape_flat": np.asarray([0, -1, D], np.int64),
        "inv_sqrt_hd": np.float32(1.0 / np.sqrt(hd)),
    }
    nodes = []
    x = "x"
    for li in range(L):
        t = f"l{li}"
        inits[f"wqkv_{t}"] = (rng.standard_normal((D, 3 * D)) / np.sqrt(D)).astype(np.float32)
        inits[f"wo_{t}"] = (rng.standard_normal((D, D)) / np.sqrt(D)).astype(np.float32)
        inits[f"w1_{t}"] = (rng.standard_normal((D, F)) / np.sqrt(D)).astype(np.float32)
        inits[f"w2_{t}"] = (rng.standard_normal((F, D)) / np.sqrt(F)).astype(np.float32)
        inits[f"g_{t}"] = np.ones(D, np.float32)
        inits[f"b_{t}"] = np.zeros(D, np.float32)
        nodes += [
            ob.node("LayerNormalization", [x, f"g_{t}", f"b_{t}"], [f"ln_{t}"]),
            ob.node("MatMul", [f"ln_{t}", f"wqkv_{t}"], [f"qkv_{t}"]),
            ob.node("Split", [f"qkv_{t}"], [f"q_{t}", f"k_{t}", f"v_{t}"],
                    axis=2, num_outputs=3),
            ob.node("Reshape", [f"q_{t}", "shape_heads"], [f"qr_{t}"]),
            ob.node("Transpose", [f"qr_{t}"], [f"qh_{t}"], perm=[0, 2, 1, 3]),
            ob.node("Reshape", [f"k_{t}", "shape_heads"], [f"kr_{t}"]),
            ob.node("Transpose", [f"kr_{t}"], [f"kh_{t}"], perm=[0, 2, 3, 1]),
            ob.node("Reshape", [f"v_{t}", "shape_heads"], [f"vr_{t}"]),
            ob.node("Transpose", [f"vr_{t}"], [f"vh_{t}"], perm=[0, 2, 1, 3]),
            ob.node("MatMul", [f"qh_{t}", f"kh_{t}"], [f"sc_{t}"]),
            ob.node("Mul", [f"sc_{t}", "inv_sqrt_hd"], [f"scs_{t}"]),
            ob.node("Softmax", [f"scs_{t}"], [f"at_{t}"], axis=-1),
            ob.node("MatMul", [f"at_{t}", f"vh_{t}"], [f"cx_{t}"]),
            ob.node("Transpose", [f"cx_{t}"], [f"cxt_{t}"], perm=[0, 2, 1, 3]),
            ob.node("Reshape", [f"cxt_{t}", "shape_flat"], [f"cxf_{t}"]),
            ob.node("MatMul", [f"cxf_{t}", f"wo_{t}"], [f"ao_{t}"]),
            ob.node("Add", [x, f"ao_{t}"], [f"x1_{t}"]),
            ob.node("MatMul", [f"x1_{t}", f"w1_{t}"], [f"f1_{t}"]),
            ob.node("Relu", [f"f1_{t}"], [f"fr_{t}"]),
            ob.node("MatMul", [f"fr_{t}", f"w2_{t}"], [f"f2_{t}"]),
            ob.node("Add", [f"x1_{t}", f"f2_{t}"], [f"x2_{t}"]),
        ]
        x = f"x2_{t}"
    return ob.build_model_bytes(
        nodes,
        inputs=[ob.value_info("x", 1, ["B", "T", D])],
        outputs=[ob.value_info(x, 1, ["B", "T", D])],
        initializers=[ob.tensor_from_array(v, k) for k, v in inits.items()],
        name="mha_encoder",
    )
