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
