"""The port's sharded legs, run as gloo processes: one process a device,
where the JAX package's tests use 8 virtual CPU devices (conftest.py).

`run_ranks(fn, world, folder, *args)` spawns `world` processes that meet
through a file store under `folder`, runs fn(rank, *args) in each with one
thread, and returns the ranks' results in rank order; a rank that raises or
hangs past the timeout fails the call. This module imports no JAX: the
spawned processes import it.
"""

from __future__ import annotations

import queue
import traceback
from pathlib import Path


LEG_TIMEOUT = 240.0  # seconds for one spawn, its start-up included


def _entry(fn, rank: int, world: int, init: str, args, q) -> None:
    import torch
    import torch.distributed as dist

    from lele_tpu_torch.parallel.mesh import init_distributed

    torch.set_num_threads(1)
    try:
        init_distributed(rank, world, init, device="cpu")
        q.put((rank, True, fn(rank, *args)))
    except BaseException:  # reported to the parent, which fails the test
        q.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, world: int, folder, *args, timeout: float = LEG_TIMEOUT) -> list:
    import multiprocessing as mp
    import time

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    init = f"file://{Path(folder).resolve() / 'rendezvous'}"
    procs = [ctx.Process(target=_entry, args=(fn, r, world, init, args, q), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    results: dict = {}
    errors = []
    deadline = time.monotonic() + timeout
    try:
        while len(results) + len(errors) < world:
            try:
                rank, ok, out = q.get(timeout=max(deadline - time.monotonic(), 0.1))
            except queue.Empty:
                raise TimeoutError(f"{world - len(results) - len(errors)} rank(s) gave no "
                                   f"result in {timeout:.0f} s") from None
            if ok:
                results[rank] = out
            else:
                errors.append(f"rank {rank}:\n{out}")
                break  # the others may wait on it in a collective
    finally:
        for p in procs:
            p.join(timeout=5.0 if not errors else 0.1)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=5.0)
    if errors:
        raise RuntimeError("\n".join(errors))
    return [results[r] for r in range(world)]


# --- the legs (tests/test_sharding.py's cases and dryrun_multichip's) ---

def _cfg(**kw):
    from lele_tpu_torch.models import SenseVoiceConfig

    return SenseVoiceConfig(**kw)


def _full_tree(tree) -> dict:
    """{path: numpy} of a DTensor tree, every leaf whole (all ranks call)."""
    from lele_tpu_torch.parallel.sharding import _tree_paths

    return {p: t.full_tensor().numpy() for p, t in _tree_paths(tree)}


def _local_shapes(tree) -> dict:
    from lele_tpu_torch.parallel.sharding import _tree_paths

    return {p: tuple(t.to_local().shape) for p, t in _tree_paths(tree)}


def _whole_grads(params, grads) -> dict:
    """{path: numpy} of this rank's gradient shards made whole by each
    leaf's placements (all ranks call)."""
    from torch.distributed.tensor import DTensor

    from lele_tpu_torch.parallel.sharding import _tree_paths

    return {p: DTensor.from_local(g, t.device_mesh, t.placements).full_tensor().numpy()
            for (p, t), g in zip(_tree_paths(params), grads)}


def _sharded_step(params_np, batch_np, cfg, mesh, lr):
    """shard_params → tx.init → shard_batch → the gradients of the placed
    params, then one step, as the JAX test."""
    from lele_tpu_torch.parallel import shard_params
    from lele_tpu_torch.train import make_train_step, shard_batch
    from lele_tpu_torch.train.trainer import value_and_grad

    sp = shard_params(params_np, mesh)
    tx, step = make_train_step(cfg, lr=lr)
    opt = tx.init(sp)
    batch = shard_batch(batch_np, mesh)
    grad_loss, grads = value_and_grad(sp, batch, cfg)
    grads = _whole_grads(sp, grads)
    sp2, opt2, loss = step(sp, opt, batch)
    assert sp2 is sp and opt2 is opt and float(grad_loss) == float(loss)
    return sp, opt, batch, float(loss), grads


def all_legs(rank: int, payload: dict) -> dict:
    """Every leg on one group of 8 ranks; each builds its own mesh."""
    import torch

    from lele_tpu_torch.parallel import make_mesh
    from lele_tpu_torch.parallel.mesh import axis_sizes
    from lele_tpu_torch.parallel.spmd import sharded_encode

    out: dict = {}
    # test_make_mesh_factoring
    out["mesh8"] = axis_sizes(make_mesh(8))
    out["mesh8_model2"] = axis_sizes(make_mesh(8, model=2))
    out["mesh8_seq2"] = axis_sizes(make_mesh(8, seq=2, model=2))
    try:
        make_mesh(8, data=3, model=2)
        out["bad_mesh"] = "no error"
    except AssertionError:
        out["bad_mesh"] = "AssertionError"

    small = payload["small"]
    mesh = make_mesh(8, model=2)
    # test_sharded_train_step_runs_and_matches_single_device (dp x tp)
    sp, opt, batch, loss, grads = _sharded_step(small["params"], small["batch_dp"],
                                                _cfg(**small["cfg"]), mesh, 1e-3)
    out["dp_tp"] = {"loss": loss, "params": _full_tree(sp), "grads": grads,
                    "local": _local_shapes(sp),
                    "mu_local": _local_shapes(opt["mu"]),
                    "feats_local": tuple(batch["feats"].to_local().shape)}
    # test_shard_params_places_on_mesh: before any step
    from lele_tpu_torch.parallel import shard_params

    placed = shard_params(small["params"], mesh)
    out["placed"] = {"qkv": tuple(placed["layers"][0]["qkv"]["w"].to_local().shape),
                     "norm1": tuple(placed["layers"][0]["norm1"]["g"].to_local().shape),
                     "layers_is_list": isinstance(placed["layers"], list)}
    # dp_put's leniency, batch_sharding and replicate
    import numpy as np

    from lele_tpu_torch.parallel import batch_sharding, replicate
    from lele_tpu_torch.parallel.sharding import dp_put

    a, b = dp_put(mesh, [np.ones((4, 3), np.float32), np.ones((3, 2), np.float32)])
    out["dp_put"] = (tuple(a.to_local().shape), tuple(b.to_local().shape))
    out["placements"] = (repr(batch_sharding(mesh)), repr(replicate(mesh)))

    # test_moe_expert_parallel_train_step (ep over "model")
    moe = payload["moe"]
    sp, _, _, loss, grads = _sharded_step(moe["params"], moe["batch"], _cfg(**moe["cfg"]), mesh,
                                          1e-3)
    out["moe"] = {"loss": loss, "w1_local": tuple(sp["layers"][0]["moe"]["w1"].to_local().shape),
                  "params": _full_tree(sp), "grads": grads}

    # test_3d_mesh_with_sequence_parallelism (dp x sp x tp)
    mesh3 = make_mesh(8, seq=2, model=2)
    sp, _, batch, loss, grads = _sharded_step(small["params"], small["batch_sp"],
                                              _cfg(**small["cfg"]), mesh3, 1e-3)
    out["dp_sp_tp"] = {"loss": loss, "feats_local": tuple(batch["feats"].to_local().shape),
                       "params": _full_tree(sp), "grads": grads}

    # dryrun_multichip's first leg: 2 x 2 x 2, 4 experts, its lr (1e-4), with
    # and without remat
    dry = payload["dryrun"]
    for remat in (False, True):
        sp, _, batch, loss, grads = _sharded_step(dry["params"], dry["batch"],
                                                  _cfg(**dry["cfg"], remat=remat), mesh3, 1e-4)
        out[f"dryrun_remat{int(remat)}"] = {"loss": loss, "params": _full_tree(sp),
                                           "grads": grads, "local": _local_shapes(sp)}

    # test_tensor_parallel_inference_matches_single_device (model = 4)
    tp = payload["tp"]
    mesh4 = make_mesh(8, model=4)
    sp = shard_params(tp["params"], mesh4)
    with torch.no_grad():
        logits = sharded_encode(sp, torch.from_numpy(tp["feats"]), torch.from_numpy(tp["mask"]),
                                _cfg(**tp["cfg"]))
    out["tp4"] = {"logits": logits.numpy(), "qkv_local": tuple(sp["layers"][0]["qkv"]["w"]
                                                             .to_local().shape)}
    if rank:  # the whole params only from rank 0 (every rank's whole gradients)
        out = {k: {kk: vv for kk, vv in v.items() if kk != "params"}
               if isinstance(v, dict) else v for k, v in out.items()}
    return out


def planner_mesh(rank: int, dp: int, sp: int, tp: int, batch: int, seq: int, d: int,
                 ffn: int) -> dict:
    """tests/test_planner.py's last case on processes: the plan's mesh
    (plan_mesh and make_mesh) shards a matmul: x over ("data", "seq"), w
    over "model", each rank's product of its shards a DTensor whose whole
    is the product."""
    import torch
    from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

    from lele_tpu_torch.parallel import make_mesh
    from lele_tpu_torch.parallel.mesh import axis_sizes
    from lele_tpu_torch.parallel.planner import EncoderSpec, plan_encoder, plan_mesh

    best = plan_encoder(EncoderSpec(batch=batch, seq=seq), 8)[0]
    mesh, kwargs = plan_mesh(best)
    mesh2 = make_mesh(8, data=dp, seq=sp, model=tp)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((batch, seq, d), generator=gen)
    w = torch.randn((d, ffn), generator=gen)
    xs = distribute_tensor(x, mesh2, [Shard(0), Shard(1), Replicate()], src_data_rank=None)
    ws = distribute_tensor(w, mesh2, [Replicate(), Replicate(), Shard(1)], src_data_rank=None)
    y = DTensor.from_local(xs.to_local() @ ws.to_local(), mesh2, [Shard(0), Shard(1), Shard(2)])
    err = float((y.full_tensor() - x @ w).abs().max())
    return {"plan": (best.dp, best.sp, best.tp), "mesh": axis_sizes(mesh),
            "mesh2": axis_sizes(mesh2), "kwargs": sorted(kwargs), "y": tuple(y.shape),
            "y_local": tuple(y.to_local().shape), "err": err}


# --- the pipeline legs (tests/test_sharding.py:326, :358; dryrun's pp leg) ---

def pipeline_legs(rank: int, payload: dict) -> dict:
    """Every pipeline leg on one group of 4 ranks; each builds its own
    "pipe" mesh (the first S ranks, as JAX's `Mesh(devices[:S], ("pipe",))`)."""
    import torch

    from lele_tpu_torch.models.sensevoice import sanm_block
    from lele_tpu_torch.params import from_numpy_tree
    from lele_tpu_torch.parallel import pipeline_apply, stack_stage_params
    from lele_tpu_torch.parallel.pipeline import pipe_mesh

    out: dict = {}
    # :326: S 4, M 4, tanh stages
    seq = payload["seq"]
    per_stage = [{k: torch.from_numpy(v) for k, v in p.items()} for p in seq["stages"]]
    mesh4 = pipe_mesh(4)
    stacked = stack_stage_params(per_stage)
    out["seq"] = pipeline_apply(lambda p, mb: torch.tanh(mb @ p["w"] + p["b"]), stacked,
                                torch.from_numpy(seq["x"]), mesh4, n_microbatch=4).numpy()
    out["stacked_shape"] = tuple(stacked["w"].shape)

    # :358: S 2 over ranks 0-1, M 1, and the ragged batch
    one = payload["one"]
    mesh2 = pipe_mesh(2)
    if rank < 2:
        stacked2 = stack_stage_params([{"w": torch.from_numpy(w)} for w in one["stages"]])
        x = torch.from_numpy(one["x"])
        out["one"] = pipeline_apply(lambda p, mb: mb @ p["w"], stacked2, x, mesh2,
                                    n_microbatch=1).numpy()
        try:
            pipeline_apply(lambda p, mb: mb @ p["w"], stacked2, x, mesh2, n_microbatch=2)
            out["ragged"] = "no error"
        except ValueError as e:
            out["ragged"] = f"ValueError: {e}"

    # dryrun_multichip's pp leg: 4 SAN-M blocks at d 32 as the stages
    pp = payload["pp"]
    cfg = _cfg(**pp["cfg"])
    stages = from_numpy_tree(pp["layers"])
    mask = torch.ones((1, pp["x"].shape[1]))

    def stage_fn(p, mb):
        return sanm_block(p, mb, mask.expand(mb.shape[0], -1), cfg)

    with torch.no_grad():
        out["pp"] = pipeline_apply(stage_fn, stack_stage_params(stages),
                                   torch.from_numpy(pp["x"]), mesh4, n_microbatch=4).numpy()
    return out


# --- compiled graphs over a mesh, serving and the daemon (8 ranks) ---

def _compile(bs, **kw):
    from lele_tpu_torch.compiler import compile_model

    return compile_model(bs, device=None if "mesh" in kw else "cpu", **kw)


def _driven(fn, run_on_all, engine: str = "run"):
    """On rank 0: run `fn(drive)` where `drive(*arrays)` announces the
    arrays to the other ranks and runs `run_on_all` on them (the SPMD
    call); the other ranks follow until rank 0 stops. Rank 0's result."""
    import torch.distributed as dist

    from lele_tpu_torch.parallel import lockstep

    if dist.get_rank() != 0:
        lockstep.follow({engine: run_on_all})
        return None
    lockstep.drive()
    try:
        def drive(*arrays):
            lockstep.announce(engine, arrays)
            return run_on_all(*arrays)
        return fn(drive)
    finally:
        lockstep.stop()


def _serving_leg(rank: int, leg: dict) -> dict | None:
    """_dryrun_serving / test_batcher_over_planned_dp_engine_bit_equal: the
    planner's serving plan → plan_mesh → compile_model(**kw) → a
    MicroBatcher on rank 0 whose batches every rank runs; each request's
    output coalesced and alone in a batch of B."""
    import threading

    import numpy as np

    from lele_tpu_torch.parallel.planner import EncoderSpec, plan_mesh, recommend_serving_plan
    from lele_tpu_torch.runtime.batcher import MicroBatcher

    B, T, D = leg["B"], leg["T"], leg["D"]
    spec = EncoderSpec(n_layers=leg["L"], d_model=D, ffn=leg["F"], vocab=D, seq=T, batch=B,
                       weight_bytes=4)
    plan = recommend_serving_plan(spec, 8, quantized=False)
    mesh, kw = plan_mesh(plan)
    cm = _compile(leg["model"], dim_values={"B": B, "T": T}, **kw)
    shard = tuple(cm._prep("x", np.zeros((B, T, D), np.float32)).shape)

    def session(drive):
        def process(items):
            x = np.zeros((B, T, D), np.float32)
            for i, it in enumerate(items):
                x[i] = it
            (y,) = drive(x)
            return [y[i] for i in range(len(items))]

        mb = MicroBatcher(process, max_batch=B, window_ms=50.0)
        results: list = [None] * len(leg["reqs"])
        ts = [threading.Thread(target=lambda i=i: results.__setitem__(
            i, mb.submit(leg["reqs"][i]))) for i in range(len(leg["reqs"]))]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        mb.close()
        alone = []
        for r in leg["reqs"]:
            x = np.zeros((B, T, D), np.float32)
            x[0] = r
            alone.append(drive(x)[0][0])
        return {"results": results, "alone": alone, "batch_sizes": list(mb.batch_sizes)}

    out = _driven(session, lambda x: cm.run_np(x))
    return {"plan": (plan.dp, plan.tp, plan.sp), "shard": shard,
            **({} if out is None else out)}


def _daemon_leg(rank: int) -> dict:
    """tests/test_server_mesh.py's five cases on the port's daemon over the
    8 ranks: rank 0 serves HTTP and drives, the others run serve_worker."""
    import base64
    import json
    import threading
    import urllib.request

    import numpy as np
    import torch.distributed as dist

    from lele_tpu_torch.server import build_engines, serve, serve_worker
    from lele_tpu_torch.serving import encode_wav

    engines = build_engines(tiny=True, device="cpu", mesh="auto")
    if dist.get_rank() != 0:
        return {"batches": serve_worker(engines)}
    httpd = serve(port=0, engines=engines)
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    out: dict = {}
    try:
        with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
            out["healthz"] = json.loads(r.read())
        # the engines really shard over "data" (dp_put on the daemon's mesh)
        from lele_tpu_torch.parallel.sharding import dp_put

        mesh = engines["mesh"]
        (x,) = dp_put(mesh, (np.zeros((8, 4), np.float32),))
        (y,) = dp_put(mesh, (np.zeros((3, 4), np.float32),))
        out["dp_put"] = (tuple(x.to_local().shape), tuple(y.to_local().shape),
                         [repr(p) for p in y.placements])
        out["mesh_sizes"] = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
        # ASR: coalesced against alone in a batch of 8, and a mesh-free model
        from lele_tpu_torch.models import SenseVoiceModel

        model = engines["asr"].model
        rng = np.random.default_rng(0)
        pcms = [rng.standard_normal(4000).astype(np.float32) * 0.1 for _ in range(8)]
        out["coal"] = model.transcribe_batch(pcms)
        silence = np.zeros(4000, np.float32)
        out["alone"] = {i: model.transcribe_batch([pcms[i]] + [silence] * 7)[0]
                        for i in (0, 3, 7)}
        single = SenseVoiceModel(cfg=model.cfg, params=model.params, fbank=model.fbank,
                                 device="cpu")
        out["single"] = single.transcribe_batch(pcms)
        out["asr_mesh"] = model.mesh is not None
        # /recognize_batch through HTTP
        wavs = [encode_wav((np.sin(np.arange(8000) / f) * 0.2).astype(np.float32), 16000)
                for f in (5.0, 7.0, 9.0, 11.0, 13.0, 15.0, 17.0, 19.0)]
        body = json.dumps([base64.b64encode(w).decode() for w in wavs]).encode()
        req = urllib.request.Request(url + "/recognize_batch", data=body)
        with urllib.request.urlopen(req, timeout=120) as r:
            out["recognize_batch"] = (r.status, json.loads(r.read()))
        # detection: 8 images, and image 2 alone in a full batch
        det = engines["det"]
        rng = np.random.default_rng(1)
        imgs = [rng.integers(0, 255, (96, 96, 3)).astype(np.uint8) for _ in range(8)]
        outs = det.detect_batch(imgs)
        alone = det.detect_batch([imgs[2]] + [np.zeros_like(imgs[2])] * 7)
        out["det"] = (det.mesh is not None, len(outs), json.dumps(alone[0]),
                      json.dumps(outs[2]), all(isinstance(o, list) for o in outs))
    finally:
        httpd.shutdown()
        httpd.server_close()
        for k in ("asr_batcher", "det_batcher"):
            engines[k].close()
    return out


def mesh_legs(rank: int, payload: dict) -> dict:
    """Every compiled-graph, serving and daemon leg on one group of 8 ranks;
    the rules are chip_smoke's copies of dryrun_multichip's."""
    import torch

    import chip_smoke as cs

    from lele_tpu_torch.parallel import make_mesh

    out: dict = {}
    # test_data_parallel_compiled_model: data 8, a [8, 16] input
    dp = payload["dp"]
    cm = _compile(dp["model"], mesh=make_mesh(8, data=8, model=1), batch_axis=0)
    out["dp"] = {"y": cm.run_np(dp["x"])[0],
                 "shard": tuple(cm._prep("x", dp["x"]).shape),
                 "captured": cm.stats["captured"]}

    # test_onnx_model_tensor_parallel_param_rules: data 2 x model 4
    tp = payload["tp"]
    cm = _compile(tp["model"], mesh=make_mesh(8, data=2, model=4), batch_axis=0,
                  param_rules=lambda n, s: {"w1": (None, "model"), "w2": ("model", None)}.get(n))
    out["tp"] = {"y": cm.run_np(tp["x"])[0], "w1": tuple(cm.params["w1"].shape),
                 "w2": tuple(cm.params["w2"].shape)}

    # _dryrun_compiled_onnx: the MHA encoder over data 2 x seq 2 x model 2
    # with the Megatron rules, then Attention-23 under dp
    oc = payload["onnx"]
    mesh3 = make_mesh(8, seq=2, model=2)
    B, T = oc["x"].shape[:2]
    cm = _compile(oc["model"], dim_values={"B": B, "T": T}, mesh=mesh3, batch_axis=0,
                  seq_axis=1, param_rules=cs.mha_rules)
    one = _compile(oc["model"], dim_values={"B": B, "T": T})
    out["mha"] = {"y": cm.run_np(oc["x"])[0], "one": one.run_np(oc["x"])[0],
                  "shard": tuple(cm._prep("x", oc["x"]).shape),
                  "wqkv": tuple(cm.params["wqkv_l0"].shape),
                  "wo": tuple(cm.params["wo_l0"].shape)}
    a_cm = _compile(oc["attn"], mesh=mesh3, batch_axis=0)
    out["attn23"] = {"y": a_cm.run_np(**oc["qkv"])[0],
                     "one": _compile(oc["attn"]).run_np(**oc["qkv"])[0],
                     "shard": tuple(a_cm._prep("q", oc["qkv"]["q"]).shape)}

    # _dryrun_serving (rng 11, 5 requests) and
    # test_batcher_over_planned_dp_engine_bit_equal (rng 0, 6 requests)
    for name in ("serving", "batcher"):
        out[name] = _serving_leg(rank, payload[name])

    # _dryrun_genai: data 4 x model 2, `_q` / `_s` column parallel; the
    # f32 route (kernel 7's exact w4a32 form) and the default bf16 one
    from lele_tpu_torch.compiler.patterns import F32_NBITS_PATTERNS

    g = payload["genai"]
    mesh42 = make_mesh(8, model=2)
    res = {}
    for route, pats in (("f32", F32_NBITS_PATTERNS), ("bf16", None)):
        cm = _compile(g["model"], mesh=mesh42, batch_axis=0, param_rules=cs.nbits_rules,
                      patterns=pats)
        res[route] = cm.run_np(**g["feeds"])
        res[route + "_one"] = _compile(g["model"], patterns=pats).run_np(**g["feeds"])
        res[route + "_hits"] = cm.stats["pattern_hits"].get("matmul_nbits_w4", 0)
    res["wq_q"] = tuple(cm.params["wq0_q::w4pk"].shape)
    out["genai"] = res

    # _dryrun_search: BeamSearch under pure dp (data 8)
    s = payload["search"]
    cm = _compile(s["model"], mesh=make_mesh(8, model=1), batch_axis=0)
    out["search"] = {"got": cm.run_np(input_ids=s["ids"]),
                     "one": _compile(s["model"]).run_np(input_ids=s["ids"]),
                     "shard": tuple(cm._prep("input_ids", s["ids"]).shape)}

    # _dryrun_moe: data 4 x expert parallel 2 over the QMoE stacks
    m = payload["moe"]
    cm = _compile(m["model"], mesh=mesh42, batch_axis=0, param_rules=cs.expert_rules,
                  patterns=F32_NBITS_PATTERNS)
    out["moe"] = {"got": cm.run_np(**m["feeds"]),
                  "one": _compile(m["model"], patterns=F32_NBITS_PATTERNS).run_np(**m["feeds"]),
                  "fc1": tuple(cm.params["fc1_0_q"].shape)}

    # Gemm with B split: transB's rows are op(B)'s columns (column
    # parallel), a plain B's rows its K (row parallel, C after the sum)
    gm = payload["gemm"]
    cm = _compile(gm["model"], mesh=make_mesh(8, data=2, model=4), batch_axis=0,
                  param_rules=lambda n, s: ("model", None) if n in ("b1", "b2") else None)
    out["gemm"] = {"y": cm.run_np(gm["x"])[0], "b1": tuple(cm.params["b1"].shape),
                   "b2": tuple(cm.params["b2"].shape)}

    # the MoE decoder's decode step (rows·k <= experts: the gathered-expert
    # path) over data 4 x expert parallel 2
    m = payload["moe_decode"]
    cm = _compile(m["model"], mesh=mesh42, batch_axis=0, param_rules=cs.expert_rules,
                  patterns=F32_NBITS_PATTERNS)
    out["moe_decode"] = {"got": cm.run_np(**m["feeds"]),
                         "hits": cm.stats["pattern_hits"].get("qmoe_w4", 0)}

    # outputs off the rows refused over "data"; a fixed-size table whole
    rows = payload["rows"]
    out["rows"] = {"refused": {}}
    for case, (bs, dims, shape) in rows["refused"].items():
        try:
            _compile(bs, dim_values=dims, mesh=make_mesh(8, **shape), batch_axis=0)
            out["rows"]["refused"][case] = None
        except ValueError as e:
            out["rows"]["refused"][case] = str(e)
    tb = rows["table"]
    cm = _compile(tb["model"], dim_values={"B": 8}, mesh=make_mesh(8, model=1), batch_axis=0)
    out["rows"]["table"] = {"y": cm.run_np(ids=tb["ids"], table=tb["table"])[0],
                            "ids": tuple(cm._prep("ids", tb["ids"]).shape),
                            "table": tuple(cm._prep("table", tb["table"]).shape)}

    # tests/test_serving_multidevice.py's planner cases on the group
    from lele_tpu_torch.parallel.mesh import axis_sizes
    from lele_tpu_torch.parallel.planner import (EncoderSpec, plan_encoder, plan_mesh,
                                                 recommend_serving_plan)

    spec = EncoderSpec(batch=8, seq=96)
    srv = recommend_serving_plan(spec, 8)
    mesh, kw = plan_mesh(srv)
    tp_plan = next(p for p in plan_encoder(spec, 8) if p.sp > 1)
    _, kw2 = plan_mesh(tp_plan)
    out["plan_mesh"] = {"sizes": axis_sizes(mesh), "plan": (srv.dp, srv.sp, srv.tp),
                        "batch_axis": kw["batch_axis"], "same": kw["mesh"] is mesh,
                        "seq_axis": kw2.get("seq_axis")}

    # the daemon over the 8 ranks
    out["daemon"] = _daemon_leg(rank)
    torch.distributed.barrier()
    return out
