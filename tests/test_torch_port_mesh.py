"""Compiled graphs, serving and the daemon over a mesh in the port
(`compile_model(mesh=, batch_axis=, seq_axis=, param_rules=)`,
parallel/placement.py, `SenseVoiceModel.mesh`, `Yolo26Engine.mesh`,
`server --mesh auto`) against the JAX package's.

JAX runs these on conftest's 8 virtual CPU devices; the port runs them as 8
gloo processes, spawned once for every leg (tests/torch_port_legs.mesh_legs).
Replayed: tests/test_sharding.py's data-parallel compiled model (the local
shard (1, 16)) and tensor-parallel param rules (w1's local shard (16, 128));
dryrun_multichip's compiled-ONNX leg (the MHA encoder over data 2 x seq 2 x
model 2 with Megatron rules, and Attention-23 under dp), serving leg,
GenAI int4 leg (data 4 x model 2 over MatMulNBits' `_q` / `_s`), search leg
(BeamSearch under data 8) and MoE leg (data 4 x expert parallel 2 over
QMoE's stacks), each at the dryrun's own tolerance against JAX's outputs on
the same bytes and inputs; tests/test_serving_multidevice.py's three cases
and tests/test_server_mesh.py's five, with HTTP on rank 0 and the other
ranks in `serve_worker`. Each request's output is bit-equal coalesced and
alone, as in JAX.

The GenAI and MoE legs are held to JAX on kernel 7's exact f32 route
(`F32_NBITS_PATTERNS`, the port's route that carries JAX's CPU numerics);
the default bf16 route is held to its own mesh-free compile.
"""

import numpy as np
import pytest

from lele_tpu.compiler import compile_model as jcompile
from lele_tpu.onnx import OnnxModel as JOnnxModel
from lele_tpu.parallel import (EncoderSpec, plan_encoder, recommend_plan,
                               recommend_serving_plan)
from lele_tpu_torch.onnx import builder as ob

import chip_smoke as cs
import torch_port_legs as legs


def _jax(bs, dims=None, **feeds):
    cm = jcompile(JOnnxModel.from_bytes(bs), dim_values=dims)
    return [np.asarray(o) for o in cm.run_np(**feeds)]


def _dp_payload():
    rng = np.random.default_rng(1)
    w = rng.standard_normal((16, 300)).astype(np.float32)
    bs = ob.build_model_bytes(
        [ob.node("MatMul", ["x", "w"], ["mm"]), ob.node("Relu", ["mm"], ["y"])],
        inputs=[ob.value_info("x", 1, [8, 16])], outputs=[ob.value_info("y", 1, [8, 300])],
        initializers=[ob.tensor_from_array(w, "w")])
    return {"model": bs, "x": rng.standard_normal((8, 16)).astype(np.float32), "w": w}


def _tp_payload():
    rng = np.random.default_rng(2)
    w1 = rng.standard_normal((16, 512)).astype(np.float32)
    w2 = rng.standard_normal((512, 8)).astype(np.float32)
    bs = ob.build_model_bytes(
        [ob.node("MatMul", ["x", "w1"], ["h"]), ob.node("Relu", ["h"], ["hr"]),
         ob.node("MatMul", ["hr", "w2"], ["y"])],
        inputs=[ob.value_info("x", 1, [4, 16])], outputs=[ob.value_info("y", 1, [4, 8])],
        initializers=[ob.tensor_from_array(w1, "w1"), ob.tensor_from_array(w2, "w2")])
    x = rng.standard_normal((4, 16)).astype(np.float32)
    return {"model": bs, "x": x, "ref": np.maximum(x @ w1, 0) @ w2}


def _onnx_payload():
    """_dryrun_compiled_onnx's draws on a data 2 x seq 2 x model 2 mesh."""
    bs, x, attn, qkv = cs.dryrun_onnx(2, 16)
    return {"model": bs, "x": x, "attn": attn, "qkv": qkv}


def _serving_payload(seed: int, n_req: int):
    bs, reqs = cs.dryrun_serving(seed, n_req)
    return {"model": bs, "reqs": reqs, "B": 8, "T": 12, "D": 32, "L": 2, "F": 64}


def _genai_payload(S: int = 1, moe: bool = False):
    """_dryrun_genai's draws (or _dryrun_moe's) at B = 8."""
    bs, feeds = cs.dryrun_genai(8, S, moe)
    return {"model": bs, "feeds": feeds}


def _gemm_payload():
    rng = np.random.default_rng(5)
    b1 = rng.standard_normal((24, 16)).astype(np.float32)  # transB: [N, K]
    c1 = rng.standard_normal(24).astype(np.float32)
    b2 = rng.standard_normal((24, 8)).astype(np.float32)
    c2 = rng.standard_normal(8).astype(np.float32)
    bs = ob.build_model_bytes(
        [ob.node("Gemm", ["x", "b1", "c1"], ["h"], transB=1, alpha=0.5),
         ob.node("Relu", ["h"], ["hr"]), ob.node("Gemm", ["hr", "b2", "c2"], ["y"], beta=2.0)],
        inputs=[ob.value_info("x", 1, [4, 16])], outputs=[ob.value_info("y", 1, [4, 8])],
        initializers=[ob.tensor_from_array(v, k)
                      for k, v in {"b1": b1, "c1": c1, "b2": b2, "c2": c2}.items()])
    x = rng.standard_normal((4, 16)).astype(np.float32)
    ref = np.maximum(0.5 * (x @ b1.T) + c1, 0) @ b2 + 2.0 * c2
    return {"model": bs, "x": x, "ref": ref}


def _rows_payload():
    """Graphs whose outputs do not carry the rows at batch_axis (refused
    over "data"), and a fixed-size table input beside a dynamic batch."""
    def moved(x_dims, y_dims, nodes):
        return ob.build_model_bytes(nodes, inputs=[ob.value_info("x", 1, x_dims)],
                                    outputs=[ob.value_info("y", 1, y_dims)])

    seq_first = [ob.node("Transpose", ["x"], ["y"], perm=[1, 0, 2])]
    refused = {
        # [T, B, D] out of [B, T, D]: 4 frames where a rank holds 1 row
        "seq_first": (moved(["B", "T", 3], ["T", "B", 3], seq_first), {"B": 8, "T": 4},
                      {"model": 1}),
        # the same with T equal to a rank's 2 rows: told by the declared dims
        "seq_first_declared": (moved(["B", "T", 3], ["T", "B", 3], seq_first),
                               {"B": 4, "T": 2}, {"model": 4}),
        # a mean over the batch
        "batch_mean": (moved(["B", "T", 3], ["T", 3],
                             [ob.node("ReduceMean", ["x"], ["y"], axes=[0], keepdims=0)]),
                       {"B": 8, "T": 4}, {"model": 1}),
    }
    rng = np.random.default_rng(9)
    table = rng.standard_normal((8, 4)).astype(np.float32)
    ids = rng.integers(0, 8, (8, 2)).astype(np.int64)
    lookup = ob.build_model_bytes(
        [ob.node("Gather", ["table", "ids"], ["y"], axis=0)],
        inputs=[ob.value_info("ids", 7, ["B", 2]), ob.value_info("table", 1, [8, 4])],
        outputs=[ob.value_info("y", 1, ["B", 2, 4])])
    return {"refused": refused, "table": {"model": lookup, "ids": ids, "table": table}}


def _search_payload():
    """_dryrun_search's GPT-2-form BeamSearch model at B = 8."""
    bs, ids = cs.dryrun_search(8)
    return {"model": bs, "ids": ids}


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    """The legs' inputs, JAX's outputs on them, and every rank's results."""
    payload = {"dp": _dp_payload(), "tp": _tp_payload(), "onnx": _onnx_payload(),
               "serving": _serving_payload(11, 5), "batcher": _serving_payload(0, 6),
               "genai": _genai_payload(), "search": _search_payload(),
               "moe": _genai_payload(4, moe=True), "gemm": _gemm_payload(),
               "moe_decode": _genai_payload(1, moe=True), "rows": _rows_payload()}
    ranks = legs.run_ranks(legs.mesh_legs, 8, tmp_path_factory.mktemp("mesh"), payload)
    o = payload["onnx"]
    jax_out = {
        "mha": _jax(o["model"], {"B": 2, "T": 16}, x=o["x"])[0],
        "attn23": _jax(o["attn"], **o["qkv"])[0],
        "genai": _jax(payload["genai"]["model"], **payload["genai"]["feeds"]),
        "moe": _jax(payload["moe"]["model"], **payload["moe"]["feeds"]),
        "moe_decode": _jax(payload["moe_decode"]["model"], **payload["moe_decode"]["feeds"]),
        "search": _jax(payload["search"]["model"], input_ids=payload["search"]["ids"]),
    }
    for name in ("serving", "batcher"):
        s = payload[name]
        x = np.zeros((s["B"], s["T"], s["D"]), np.float32)
        x[:len(s["reqs"])] = s["reqs"]
        jax_out[name] = _jax(s["model"], {"B": s["B"], "T": s["T"]}, x=x)[0]
    return payload, ranks, jax_out


def test_data_parallel_compiled_model(mesh_run):
    """test_sharding.py:113: data 8, one row a rank ((1, 16)), every rank
    the whole [8, 300] output within 1e-4."""
    payload, ranks, _ = mesh_run
    dp = payload["dp"]
    for r in ranks:
        np.testing.assert_allclose(r["dp"]["y"], np.maximum(dp["x"] @ dp["w"], 0), atol=1e-4)
        assert r["dp"]["shard"] == (1, 16)
        assert r["dp"]["captured"] is False  # the CPU captures nothing


def test_onnx_model_tensor_parallel_param_rules(mesh_run):
    """test_sharding.py:286: data 2 x model 4, w1 column parallel (its
    local shard (16, 128)), w2 row parallel, within 1e-3."""
    payload, ranks, _ = mesh_run
    for r in ranks:
        assert r["tp"]["w1"] == (16, 128) and r["tp"]["w2"] == (128, 8)
        np.testing.assert_allclose(r["tp"]["y"], payload["tp"]["ref"], atol=1e-3)


def test_dryrun_compiled_onnx_leg(mesh_run):
    """_dryrun_compiled_onnx: the MHA encoder over data 2 x seq 2 x model 2
    (x's shard (1, 8, 32); wqkv's columns and wo's rows halved) against
    JAX at the leg's 1e-4 and the port's mesh-free compile; Attention-23
    under dp at 1e-5."""
    _, ranks, jax_out = mesh_run
    for r in ranks:
        m = r["mha"]
        assert m["shard"] == (1, 8, 32) and m["wqkv"] == (32, 48) and m["wo"] == (16, 32)
        np.testing.assert_allclose(m["y"], jax_out["mha"], atol=1e-4)
        np.testing.assert_allclose(m["y"], m["one"], atol=1e-4)
        a = r["attn23"]
        assert a["shard"] == (1, 2, 16, 8)
        np.testing.assert_allclose(a["y"], jax_out["attn23"], atol=1e-5)
        np.testing.assert_allclose(a["y"], a["one"], atol=1e-5)


@pytest.mark.parametrize("name", ["serving", "batcher"])
def test_serving_over_planned_dp_bit_equal(mesh_run, name):
    """_dryrun_serving (5 requests) and test_serving_multidevice.py's
    test_batcher_over_planned_dp_engine_bit_equal (6): the planner's dp 8
    plan, a MicroBatcher on rank 0 whose batches every rank runs (one row a
    rank); each request's output BIT-equal coalesced and alone in a batch
    of 8, and within 1e-5 of JAX's unsharded program."""
    payload, ranks, jax_out = mesh_run
    s = payload[name]
    got = ranks[0][name]
    assert all(r[name]["plan"] == (8, 1, 1) and r[name]["shard"] == (1, 12, 32) for r in ranks)
    assert sum(got["batch_sizes"]) == len(s["reqs"])
    for i in range(len(s["reqs"])):
        np.testing.assert_array_equal(got["results"][i], got["alone"][i], err_msg=f"request {i}")
        np.testing.assert_allclose(got["results"][i], jax_out[name][i], atol=1e-5, rtol=1e-5)


def test_dryrun_genai_leg(mesh_run):
    """_dryrun_genai: the int4 decode step over data 4 x model 2 with `_q`
    / `_s` column parallel (kernel 7 on a rank's 16 of wq's 32 columns):
    the f32 route against JAX at the leg's 1e-4 (logits) and 1e-5 (the
    caches), both routes against their mesh-free compiles."""
    _, ranks, jax_out = mesh_run
    for r in ranks:
        g = r["genai"]
        assert g["wq_q"] == (16, 16) and g["f32_hits"] > 0 and g["bf16_hits"] > 0
        np.testing.assert_allclose(g["f32"][0], jax_out["genai"][0], atol=1e-4)
        np.testing.assert_allclose(g["f32"][1], jax_out["genai"][1], atol=1e-5)
        for route in ("f32", "bf16"):
            for a, b in zip(g[route], g[route + "_one"]):
                np.testing.assert_allclose(a, b, atol=1e-4)


def test_dryrun_search_leg(mesh_run):
    """_dryrun_search: BeamSearch under data 8 (one prompt a rank):
    sequences equal to JAX's and the mesh-free compile's, scores within
    1e-5."""
    _, ranks, jax_out = mesh_run
    for r in ranks:
        s = r["search"]
        assert s["shard"] == (1, 4)
        np.testing.assert_array_equal(s["got"][0], jax_out["search"][0])
        np.testing.assert_array_equal(s["got"][0], s["one"][0])
        np.testing.assert_allclose(s["got"][1], jax_out["search"][1], atol=1e-5)


def test_dryrun_moe_leg(mesh_run):
    """_dryrun_moe: the QMoE decoder's prefill over data 4 x expert parallel
    2 (a rank holds 2 of the 4 experts of each stack, the combine
    all-reduced) against JAX at the leg's 1e-4."""
    _, ranks, jax_out = mesh_run
    for r in ranks:
        m = r["moe"]
        assert m["fc1"][0] == 2
        np.testing.assert_allclose(m["got"][0], jax_out["moe"][0], atol=1e-4)
        np.testing.assert_allclose(m["got"][0], m["one"][0], atol=1e-4)


def test_moe_decode_step_expert_parallel(mesh_run):
    """The MoE decoder's decode step over data 4 x expert parallel 2: 2 rows
    x top-2 a rank on the gathered-expert path, slots of the other rank's
    experts weighing nothing (kernel 7's indexed route is left to the
    unsharded stacks), against JAX at 1e-4."""
    _, ranks, jax_out = mesh_run
    for r in ranks:
        assert r["moe_decode"]["hits"] == 0
        for a, b in zip(r["moe_decode"]["got"], jax_out["moe_decode"]):
            np.testing.assert_allclose(a, b, atol=1e-4)


def test_gemm_column_and_row_parallel(mesh_run):
    """Gemm over data 2 x model 4: transB's split rows are op(B)'s columns
    (column parallel, alpha 0.5), a plain B's split rows its K (row
    parallel, beta 2 x C added after the sum), within 1e-4."""
    payload, ranks, _ = mesh_run
    for r in ranks:
        assert r["gemm"]["b1"] == (6, 16) and r["gemm"]["b2"] == (6, 8)
        np.testing.assert_allclose(r["gemm"]["y"], payload["gemm"]["ref"], atol=1e-4)


@pytest.mark.parametrize("case", ["seq_first", "seq_first_declared", "batch_mean"])
def test_outputs_off_the_rows_refused_over_data(mesh_run, case):
    """Each rank runs its own rows, so an output that does not carry them at
    batch_axis (seq-first, a mean over the batch) is refused with
    ValueError when the program is built, on every rank, rather than
    gathered into a wrong result."""
    for r in mesh_run[1]:
        msg = r["rows"]["refused"][case]
        assert msg is not None and "'y'" in msg and "batch_axis" in msg, msg


def test_fixed_table_input_stays_whole(mesh_run):
    """A fixed-size [8, 4] table beside ids of a dynamic batch 8 over data
    8: the ids split one row a rank, the table stays whole (its dim 0 is not
    the batch), every rank the lookup of every row."""
    payload, ranks, _ = mesh_run
    tb = payload["rows"]["table"]
    for r in ranks:
        t = r["rows"]["table"]
        assert t["ids"] == (1, 2) and t["table"] == (8, 4)
        np.testing.assert_array_equal(t["y"], tb["table"][tb["ids"]])


def test_planner_ranks_and_recommends():
    """test_serving_multidevice.py's first case (the port's planner is
    numpy; held to JAX's picks)."""
    from lele_tpu_torch.parallel import planner

    spec = planner.EncoderSpec(batch=8, seq=96)
    plans = planner.plan_encoder(spec, 8)
    assert plans and plans == sorted(plans, key=lambda p: p.step_s)
    assert all(p.chips == 8 for p in plans)
    best = planner.recommend_plan(spec, 8)
    assert best.fits_hbm and not best.notes
    srv = planner.recommend_serving_plan(spec, 8)
    assert (srv.dp, srv.tp, srv.sp) == (8, 1, 1)
    jspec = EncoderSpec(batch=8, seq=96)
    assert [(p.dp, p.tp, p.sp) for p in plans] == [(p.dp, p.tp, p.sp)
                                                   for p in plan_encoder(jspec, 8)]
    j = recommend_plan(jspec, 8)
    assert (best.dp, best.tp, best.sp) == (j.dp, j.tp, j.sp)
    js = recommend_serving_plan(jspec, 8)
    assert (srv.dp, srv.tp, srv.sp) == (js.dp, js.tp, js.sp)


def test_plan_mesh_shapes_match_plan(mesh_run):
    """test_serving_multidevice.py's second case, on the group: the serving
    plan's mesh is data 8, batch_axis 0, and a plan with sp > 1 carries
    seq_axis 1."""
    _, ranks, _ = mesh_run
    for r in ranks:
        p = r["plan_mesh"]
        assert p["sizes"] == {"data": 8, "seq": 1, "model": 1} and p["plan"] == (8, 1, 1)
        assert p["batch_axis"] == 0 and p["same"] and p["seq_axis"] == 1


def test_daemon_healthz_reports_planned_layout(mesh_run):
    _, ranks, _ = mesh_run
    d = ranks[0]["daemon"]
    assert d["healthz"] == {"ok": True, "mesh": "dp8xsp1xtp1"}
    # every worker ran the daemon's batches, and left its loop at shutdown
    assert all(r["daemon"]["batches"] > 0 for r in ranks[1:])
    assert len({r["daemon"]["batches"] for r in ranks[1:]}) == 1


def test_daemon_engines_really_shard_over_data(mesh_run):
    d = mesh_run[1][0]["daemon"]
    assert d["mesh_sizes"] == {"data": 8, "seq": 1, "model": 1}
    # a batch of 8 one row a rank; one of 3 (not divisible) whole on each
    assert d["dp_put"][0] == (1, 4) and d["dp_put"][1] == (3, 4)
    assert all(p.startswith("Replicate") for p in d["dp_put"][2])


def test_daemon_asr_bit_equal_per_request(mesh_run):
    """Each request's ids equal coalesced and alone in a batch of 8 (the
    same program a rank), and a mesh-free model on the same params gives
    the coalesced ids."""
    d = mesh_run[1][0]["daemon"]
    assert d["asr_mesh"]
    for i, ids in d["alone"].items():
        assert ids == d["coal"][i], f"request {i} batch-dependent"
    assert d["single"] == d["coal"]


def test_daemon_http_recognize_batch_rides_the_mesh(mesh_run):
    d = mesh_run[1][0]["daemon"]
    status, body = d["recognize_batch"]
    assert status == 200
    assert len(body["results"]) == 8 and all(isinstance(r, list) for r in body["results"])


def test_daemon_http_detect_through_mesh(mesh_run):
    d = mesh_run[1][0]["daemon"]
    has_mesh, n, alone, coalesced, lists = d["det"]
    assert has_mesh and n == 8 and lists
    assert alone == coalesced


def test_plan_serving_mesh_at_one_rank():
    """One rank (no process group) gives no mesh, as JAX on one device;
    /healthz then reports none."""
    from lele_tpu_torch.server import mesh_tag, plan_serving_mesh

    assert plan_serving_mesh() == (None, None)
    assert mesh_tag(None) is None
