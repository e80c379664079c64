"""The com.microsoft search ops through the port (ROADMAP §1.1.5):
BeamSearch, GreedySearch, Sampling, WhisperBeamSearch and NGramRepeatBlock,
with `onnx.loader.bind_inputs` and the search builders of `onnx/synth.py`.

Every test of tests/test_search_ops.py, and test_decoder_masked.py's
`test_masked_ops_beam_search_e2e`, runs with the port in JAX's place: the
module's compile_model, OnnxModel, bind_inputs and synth builders are the
port's (on the CPU), so the JAX tests' own oracles judge it: HF `generate`
for greedy, the independent ORT-scorer oracle `ref_beam` for beam, the
Whisper-form oracle, HF's NoRepeatNGramLogitsProcessor. NGramRepeatBlock's
graph goes through test_torch_port_ops_battery's replay and is held to JAX's
outputs as well.

Beside them, the port against JAX on the same bytes, at the JAX tests'
tolerances (sequences equal, sequences_scores within 2e-3, per-step scores
within 2e-4): a beam graph with every processor; the Whisper beam graph in
both of `build_whisper_search_graphs`' forms; an int8 `quantize_dynamic`
GPT-2 decoder under BeamSearch at 2 layers and d 64, whose pattern hits must
be JAX's; the stable tie rule; one copy of the decoder's params a search
node; and `Tape.capturable` on every search tape. Sampling's draws are the port's own (ROADMAP §3 "Known"): held to the
properties JAX's tests assert (seeded, varying with either seed, top-p 1e-4
is greedy).
"""

import inspect
import io
import sys
from contextlib import redirect_stderr
from pathlib import Path

import numpy as np
import pytest

from lele_tpu.compiler import compile_model as j_compile
from lele_tpu.onnx.loader import OnnxModel as JOnnxModel
from lele_tpu_torch.compiler import compile_model
from lele_tpu_torch.onnx import builder as ob
from lele_tpu_torch.onnx import loader as pl
from lele_tpu_torch.onnx import quantize as pq
from lele_tpu_torch.onnx import schema
from lele_tpu_torch.onnx import synth as ps

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tests"))
sys.path.insert(0, str(ROOT))
import test_search_ops as tso  # noqa: E402
from test_search_ops import gpt2, whisper_params  # noqa: E402,F401  (fixtures)
from test_torch_port_ops_battery import replay_case  # noqa: E402

SCORE_TOL = 2e-3  # test_search_ops: sequences_scores against ref_beam
STEP_TOL = 2e-4  # test_search_ops: the first step's scores

REPLAYED = sorted(n for n, f in vars(tso).items()
                  if n.startswith("test_") and inspect.isfunction(f)
                  and n != "test_ngram_repeat_block_standalone_op")


@pytest.fixture
def port_in_place(monkeypatch):
    """The JAX search tests' compile_model, OnnxModel, bind_inputs and synth
    builders swapped for the port's (on the CPU)."""
    import lele_tpu.compiler as jc
    import lele_tpu.onnx as jo
    import lele_tpu.onnx.synth as js

    def port_compile(model, *a, strict=False, **kw):
        return compile_model(model, strict=strict, device="cpu")

    for mod in (tso, jc):
        monkeypatch.setattr(mod, "compile_model", port_compile)
    for mod in (tso, jo):
        monkeypatch.setattr(mod, "OnnxModel", pl.OnnxModel)
    monkeypatch.setattr(jo, "bind_inputs", pl.bind_inputs)
    for name in ("build_gpt2_decoder_graph", "build_search_model",
                 "build_whisper_search_graphs"):
        for mod in (tso, js):
            monkeypatch.setattr(mod, name, getattr(ps, name), raising=False)


@pytest.mark.parametrize("name", REPLAYED)
def test_jax_search_test_on_the_port(port_in_place, request, name):
    fn = getattr(tso, name)
    fn(**{arg: request.getfixturevalue(arg) for arg in inspect.signature(fn).parameters})


def test_every_search_test_replays():
    assert len(REPLAYED) == 17


def test_ngram_repeat_block_on_the_port(monkeypatch):
    replay_case(monkeypatch, "test_search_ops", "test_ngram_repeat_block_standalone_op", {})


def test_masked_ops_beam_search_e2e_on_the_port(port_in_place):
    import test_decoder_masked

    test_decoder_masked.test_masked_ops_beam_search_e2e()


# -- the port against JAX ---------------------------------------------------------


def _both(bs: bytes, feeds: dict, **kw):
    cm = compile_model(bs, device="cpu", strict=True, **kw)
    got = cm.run_np(**feeds)
    with redirect_stderr(io.StringIO()):
        jm = j_compile(JOnnxModel.from_bytes(bs), strict=True)
        want = jm.run_np(**feeds)
    return cm, jm, got, want


def _hold_beam(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    assert np.abs(got[1] - want[1]).max() <= SCORE_TOL
    if len(got) > 2:
        assert got[2].shape == want[2].shape
        assert np.array_equal(got[2] <= tso.NEG / 2, want[2] <= tso.NEG / 2)
        live = want[2] > tso.NEG / 2
        assert np.abs(got[2][live] - want[2][live]).max() <= STEP_TOL


def _beam_bytes(params, ids_shape, search, n_outputs=2, kind="BeamSearch", **attrs):
    dec = ps.build_gpt2_decoder_graph(params, tso.NL, tso.NH)
    return ps.build_search_model(kind, dec, ids_shape, search, tso.base_attrs(**attrs),
                                 n_outputs)


def test_beam_with_every_processor_matches_jax(gpt2):
    rng = np.random.default_rng(40)
    B, S, ML, nb = 2, 6, 17, 3
    ids = rng.integers(0, tso.V - 2, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    ids[1, :2], mask[1, :2] = tso.PAD, 0
    vm = np.ones((tso.V,), np.int32)
    vm[[3, 11, 17]] = 0
    pm = np.ones((B, tso.V), np.int32)
    pm[0, ::2] = 0
    search = {
        "max_length": np.asarray([ML], np.int32), "min_length": np.asarray([9], np.int32),
        "num_beams": np.asarray([nb], np.int32),
        "num_return_sequences": np.asarray([2], np.int32),
        "length_penalty": np.asarray([1.4], np.float32),
        "repetition_penalty": np.asarray([1.25], np.float32),
        "vocab_mask": vm, "prefix_vocab_mask": pm, "attention_mask": None,
    }
    bs = _beam_bytes(tso.gpt2_params(tso.eos_boosted(gpt2)), ids.shape, search, 3,
                     no_repeat_ngram_size=2)
    cm, jm, got, want = _both(bs, {"input_ids": ids, "attention_mask": mask})
    _hold_beam(got, want)
    assert got[2].shape == (ML - S, B, nb, tso.V)
    assert cm.stats["capturable"]


@pytest.mark.parametrize("masked", [False, True])
def test_whisper_beam_matches_jax_in_both_forms(whisper_params, masked):
    rng = np.random.default_rng(41)
    feats = rng.standard_normal((2, tso.WF, tso.WT)).astype(np.float32)
    start = np.tile(np.asarray([[52, 7]], np.int32), (2, 1))
    enc_g, dec_g = ps.build_whisper_search_graphs(whisper_params, tso.WL, tso.WH, 2,
                                                  masked_ops=masked)
    search = {"max_length": np.asarray([12], np.int32),
              "num_beams": np.asarray([3], np.int32),
              "num_return_sequences": np.asarray([2], np.int32),
              "length_penalty": np.asarray([1.3], np.float32),
              "repetition_penalty": np.asarray([1.2], np.float32),
              "decoder_input_ids": start}
    bs = ps.build_search_model(
        "WhisperBeamSearch" if masked else "BeamSearch", dec_g, feats.shape, search,
        dict(eos_token_id=50, pad_token_id=tso.WPAD, model_type=2,
             decoder_start_token_id=52, encoder=enc_g, no_repeat_ngram_size=3),
        n_outputs=2, input_dtype=1)
    cm, jm, got, want = _both(bs, {"input_ids": feats})
    _hold_beam(got, want)
    assert cm.stats["capturable"]


def gpt2_small_params(rng, V, D, n_layer, n_pos=64) -> dict:
    """Random GPT-2-form params (numpy f32) for build_gpt2_decoder_graph."""
    p = {"wte": 0.5 * rng.standard_normal((V, D)), "wpe": 0.2 * rng.standard_normal((n_pos, D)),
         "lnf_g": 1 + 0.1 * rng.standard_normal(D), "lnf_b": 0.1 * rng.standard_normal(D)}
    for i in range(n_layer):
        for k, shape in (("attn_w", (D, 3 * D)), ("proj_w", (D, D)), ("fc_w", (D, 4 * D)),
                         ("fcp_w", (4 * D, D))):
            p[f"{k}{i}"] = rng.standard_normal(shape) / np.sqrt(shape[0])
            p[f"{k[:-2]}_b{i}"] = 0.1 * rng.standard_normal(shape[1])
        for k in ("ln1", "ln2"):
            p[f"{k}_g{i}"] = 1 + 0.1 * rng.standard_normal(D)
            p[f"{k}_b{i}"] = 0.1 * rng.standard_normal(D)
    p["lm_w"] = np.ascontiguousarray(p["wte"].T)
    return {k: np.asarray(v, np.float32) for k, v in p.items()}


def int8_decoder(params, n_layer, n_head) -> dict:
    """The GPT-2 decoder through quantize_dynamic (ORT's int8 conversion:
    MatMul and Gemm only, so the contrib Attention's QKV weight stays f32)."""
    dec = ps.build_gpt2_decoder_graph(params, n_layer, n_head)
    q = pq.quantize_dynamic(ob.serialize(ob.model(dec, opset=17)))
    return schema.decode_model(q).raw()["graph"]


def test_int8_gpt2_beam_search_matches_jax():
    rng = np.random.default_rng(3)
    V, D, L, H = 101, 64, 2, 4
    params = gpt2_small_params(rng, V, D, L)
    B, S, ML = 2, 6, 20
    ids = rng.integers(0, V - 2, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.int32)
    ids[1, :2], mask[1, :2] = V - 1, 0
    search = {"max_length": np.asarray([ML], np.int32), "num_beams": np.asarray([3], np.int32),
              "num_return_sequences": np.asarray([2], np.int32), "attention_mask": None,
              "repetition_penalty": np.asarray([1.1], np.float32)}
    bs = ps.build_search_model("BeamSearch", int8_decoder(params, L, H), ids.shape, search,
                               dict(eos_token_id=V - 2, pad_token_id=V - 1, model_type=0,
                                    no_repeat_ngram_size=3), 2)
    cm, jm, got, want = _both(bs, {"input_ids": ids, "attention_mask": mask})
    hits = cm.stats["pattern_hits"]
    # 3 linears a layer and the head, in the prefill walk and the step walk
    assert hits == jm.stats["pattern_hits"] == {"dql_matmul_dataflow": 2 * (3 * L + 1),
                                                "dql_fused_epilogue": 2 * (3 * L + 1)}
    _hold_beam(got, want)
    assert cm.stats["capturable"]


def test_top_k_takes_the_lower_index_on_ties():
    """`_top_k` is `lax.top_k`: values and indices equal on tie-heavy rows."""
    import jax
    import torch

    from lele_tpu_torch.ops.search_ops import _top_k

    rng = np.random.default_rng(5)
    x = rng.choice(np.asarray([-1e30, -3.0, -1.0, 0.5], np.float32), size=(6, 97))
    for k in (1, 4, 9, 40):
        v, i = _top_k(torch.from_numpy(x), k)
        jv, ji = jax.lax.top_k(x, k)
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))


def test_beam_ties_take_the_lower_index_as_in_jax(gpt2):
    """A prefix mask that bans every token of batch row 1's first step: all
    its candidates tie at NEG from then on, so which of them run, and in
    which order the running beams are returned, is the tie rule's alone.
    Lower index first (lax.top_k's rule) gives beam j the tokens 0, ..., 0,
    j; the port's outputs must be JAX's."""
    rng = np.random.default_rng(42)
    B, S, ML, nb = 2, 4, 10, 3
    ids = rng.integers(0, tso.V - 2, (B, S)).astype(np.int32)
    pm = np.ones((B, tso.V), np.int32)
    pm[1] = 0
    search = {"max_length": np.asarray([ML], np.int32), "num_beams": np.asarray([nb], np.int32),
              "num_return_sequences": np.asarray([nb], np.int32), "prefix_vocab_mask": pm}
    bs = _beam_bytes(tso.gpt2_params(gpt2), ids.shape, search, 3)
    _, _, got, want = _both(bs, {"input_ids": ids})
    _hold_beam(got, want)
    tail = np.zeros((nb, ML - S), np.int32)
    tail[:, -1] = np.arange(nb)
    np.testing.assert_array_equal(got[0][1, :, S:], tail)
    assert (got[0][0, :, S:] > nb).any()  # row 0 searched as usual


def test_search_node_hoists_its_decoder_params_once(gpt2):
    """One copy of the decoder's params for the prefill and step walks, and
    a step sub-tape that reads no value of the prefill walk."""
    from lele_tpu_torch.compiler.tracer import _SearchStep

    params = tso.gpt2_params(gpt2)
    dec_bytes = sum(np.asarray(v, np.float32).nbytes for v in params.values())
    ids = np.zeros((2, 4), np.int32)
    for kind, search in (("GreedySearch", {"max_length": np.asarray([9], np.int32)}),
                         ("BeamSearch", {"max_length": np.asarray([9], np.int32),
                                         "num_beams": np.asarray([2], np.int32),
                                         "num_return_sequences": np.asarray([1], np.int32)})):
        cm = compile_model(_beam_bytes(params, ids.shape, search, 1, kind), device="cpu",
                           strict=True)
        assert dec_bytes <= cm.stats["param_bytes"] < dec_bytes + 4096, (
            kind, cm.stats["param_bytes"], dec_bytes)
        (step,) = [st.fn for st in cm._tape.steps if isinstance(st.fn, _SearchStep)]
        assert step.body.captured == [] and step.body.steps
    rng = np.random.default_rng(0)
    p8 = gpt2_small_params(rng, 101, 64, 2)
    bs = ps.build_search_model("BeamSearch", int8_decoder(p8, 2, 4), (2, 4),
                               {"max_length": np.asarray([9], np.int32),
                                "num_beams": np.asarray([2], np.int32),
                                "num_return_sequences": np.asarray([1], np.int32)},
                               dict(eos_token_id=99, pad_token_id=100, model_type=0), 1)
    cm = compile_model(bs, device="cpu", strict=True)
    # the int8 weights once each (with their col-sums), the f32 rest once
    q_bytes = sum(v.nbytes // 4 + 4 * v.shape[1] if k.startswith(("proj_w", "fc_w", "fcp_w",
                                                                   "lm_w")) else v.nbytes
                  for k, v in p8.items())
    assert q_bytes <= cm.stats["param_bytes"] < q_bytes + 4096, (cm.stats["param_bytes"], q_bytes)


def test_every_search_tape_is_capturable(gpt2, whisper_params):
    params = tso.gpt2_params(gpt2)
    ids = np.zeros((2, 4), np.int32)
    ml = {"max_length": np.asarray([9], np.int32)}
    beam = dict(ml, num_beams=np.asarray([2], np.int32),
                num_return_sequences=np.asarray([1], np.int32))
    graphs = [_beam_bytes(params, ids.shape, ml, 1, "GreedySearch"),
              _beam_bytes(params, ids.shape, ml, 1, "Sampling", top_p=0.9, seed=3),
              _beam_bytes(params, ids.shape, beam, 2)]
    feats = (1, tso.WF, tso.WT)
    for masked in (False, True):
        enc_g, dec_g = ps.build_whisper_search_graphs(whisper_params, tso.WL, tso.WH, 1,
                                                      masked_ops=masked)
        graphs.append(ps.build_search_model(
            "BeamSearch", dec_g, feats, beam,
            dict(eos_token_id=50, pad_token_id=tso.WPAD, model_type=2,
                 decoder_start_token_id=52, encoder=enc_g), 2, input_dtype=1))
    for bs in graphs:
        cm = compile_model(bs, device="cpu", strict=True)
        assert cm.stats["capturable"] and not cm.stats["captured"]


def test_sampling_seed_input_and_attribute(gpt2):
    """The seed input, a runtime value, reseeds every call without a new
    trace; the attribute seed is part of the stream too; top-p 1e-4 with a
    seed input is still greedy."""
    params = tso.gpt2_params(gpt2)
    rng = np.random.default_rng(43)
    ids = rng.integers(0, tso.V - 2, (2, 4)).astype(np.int32)
    search = {"max_length": np.asarray([14], np.int32), "seed": np.asarray([0], np.int32)}

    def model(**attrs):
        dec = ps.build_gpt2_decoder_graph(params, tso.NL, tso.NH)
        bs = ps.build_search_model("Sampling", dec, ids.shape, search, tso.base_attrs(**attrs),
                                   runtime_scalars=("seed",))
        return compile_model(bs, device="cpu", strict=True)

    cm = model(temperature=1.5, seed=1)
    run = lambda m, s: m.run_np(input_ids=ids, seed=np.asarray([s], np.int32))[0]  # noqa: E731
    a, b, a2 = run(cm, 7), run(cm, 8), run(cm, 7)
    np.testing.assert_array_equal(a, a2)
    assert (a != b).any()
    assert (run(model(temperature=1.5, seed=2), 7) != a).any()
    greedy = compile_model(_beam_bytes(params, ids.shape, {"max_length": search["max_length"]},
                                       1, "GreedySearch"), device="cpu").run_np(input_ids=ids)[0]
    np.testing.assert_array_equal(run(model(top_p=1e-4, seed=1), 9), greedy)


def test_port_refuses_what_jax_refuses(gpt2):
    params = tso.gpt2_params(gpt2)
    ids = np.zeros((1, 4), np.int32)
    ml = {"max_length": np.asarray([8], np.int32)}
    with pytest.raises(NotImplementedError, match="filtered_logits"):
        compile_model(_beam_bytes(params, ids.shape, ml, 2, "Sampling"), device="cpu")
    with pytest.raises(NotImplementedError, match="custom"):
        compile_model(_beam_bytes(params, ids.shape, ml, 1, "Sampling", custom=1), device="cpu")
    beam = dict(ml, num_beams=np.asarray([2], np.int32),
                num_return_sequences=np.asarray([1], np.int32))
    with pytest.raises(NotImplementedError, match="logits_processor"):
        compile_model(_beam_bytes(params, ids.shape, dict(
            beam, logits_processor=np.asarray([1], np.int32)), 1), device="cpu")
    with pytest.raises(ValueError, match="num_return_sequences"):
        compile_model(_beam_bytes(params, ids.shape, dict(
            beam, num_return_sequences=np.asarray([3], np.int32)), 1), device="cpu")


@pytest.mark.parametrize("what,value", [
    ("cross_qk_layer_head", np.zeros((1, 2), np.int32)),
    ("extra_decoding_ids", np.zeros((1, 1), np.int32)),
    ("temperature", np.asarray([0.7], np.float32))])
def test_whisper_beam_refusals(whisper_params, what, value):
    enc_g, dec_g = ps.build_whisper_search_graphs(whisper_params, tso.WL, tso.WH, 1)
    search = {"max_length": np.asarray([8], np.int32), "num_beams": np.asarray([2], np.int32),
              "num_return_sequences": np.asarray([1], np.int32), what: value}
    bs = ps.build_search_model("WhisperBeamSearch", dec_g, (1, tso.WF, tso.WT), search,
                               dict(eos_token_id=50, pad_token_id=tso.WPAD, model_type=2,
                                    decoder_start_token_id=52, encoder=enc_g),
                               input_dtype=1)
    with pytest.raises(NotImplementedError, match=what.split("_")[0]):
        compile_model(bs, device="cpu", strict=True)


def test_builders_give_jax_bytes(gpt2, whisper_params):
    """The search builders, node for node: the same bytes as JAX's."""
    import lele_tpu.onnx.synth as js

    params = tso.gpt2_params(gpt2)
    search = {"max_length": np.asarray([9], np.int32), "num_beams": np.asarray([2], np.int32),
              "num_return_sequences": np.asarray([1], np.int32), "attention_mask": None}
    for mod in (ps, js):
        assert mod.SEARCH_INPUT_ORDER == js.SEARCH_INPUT_ORDER
    got = ps.build_search_model("BeamSearch", ps.build_gpt2_decoder_graph(params, 2, 2),
                                (2, 4), search, tso.base_attrs(), 2,
                                runtime_scalars=("max_length", "num_beams"))
    want = js.build_search_model("BeamSearch", js.build_gpt2_decoder_graph(params, 2, 2),
                                 (2, 4), search, tso.base_attrs(), 2,
                                 runtime_scalars=("max_length", "num_beams"))
    assert got == want
    for masked in (False, True):
        a = ps.build_whisper_search_graphs(whisper_params, tso.WL, tso.WH, 2, masked_ops=masked)
        b = js.build_whisper_search_graphs(whisper_params, tso.WL, tso.WH, 2, masked_ops=masked)
        for ga, gb in zip(a, b):
            assert ob.serialize(ob.model(ga)) == ob.serialize(ob.model(gb))


def test_bind_inputs_shares_storage_and_refuses_unknown_names(gpt2):
    params = tso.gpt2_params(gpt2)
    search = {"max_length": np.asarray([9], np.int32), "num_beams": np.asarray([2], np.int32),
              "num_return_sequences": np.asarray([1], np.int32)}
    bs = ps.build_search_model("BeamSearch", ps.build_gpt2_decoder_graph(params, 2, 2), (2, 4),
                               search, tso.base_attrs(), 1,
                               runtime_scalars=tuple(search))
    m = pl.OnnxModel.from_bytes(bs)
    bound = pl.bind_inputs(m, search)
    assert bound.input_names() == ["input_ids"] and m.input_names()[0] == "input_ids"
    assert len(m.input_names()) == 4
    node = bound.graph.node[0]
    assert node.raw() is m.graph.node[0].raw()  # the decoder's tensors are not copied
    with pytest.raises(ValueError, match="not graph inputs"):
        pl.bind_inputs(m, {"nope": np.zeros(1)})
