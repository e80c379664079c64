"""GPipe-style pipeline parallelism over a "pipe" mesh axis (counterpart of
lele_tpu/parallel/pipeline.py).

Layers are partitioned into S contiguous stages, one rank each, and
microbatches stream through with one ring send/recv a tick. The schedule
is JAX's, statement for statement: S + M - 1 ticks for M microbatches,
bubble fraction (S-1)/(S+M-1).

- Stage params are stacked on a leading axis (`stack_stage_params`); each
  rank of the "pipe" axis keeps only its own stage's slice `[rank]`, as
  JAX's `P(axis)` placement gives each device its stage: a rank holds only
  its stage's weights.
- Every rank sees the whole microbatch queue. Stage 0 takes microbatch t
  while t < M; each tick's result is zeroed outside 0 <= t - sid < M, and
  stage S-1 banks its result in slot t - sid. The hop is one
  `batch_isend_irecv` a tick, (i, (i+1) % S) over the pipe group, JAX's
  `ppermute`; at the end an `all_reduce` over the group plays JAX's
  `psum`, so every rank returns the whole [batch, ...] output.
- Stages must be shape-preserving ([mb, ...] in == out), as in JAX.

An axis of size 1 issues no collective: one rank runs every tick itself.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..params import tree_map


def pipeline_apply(stage_fn, stage_params, x: torch.Tensor, mesh, n_microbatch: int,
                   axis: str = "pipe") -> torch.Tensor:
    """Run `x` through S pipelined stages.

    stage_fn:      (params_slice, mb) -> mb, the per-stage computation,
                   applied by every rank to its own stage's params.
    stage_params:  a tree whose leaves are stacked [S, ...] per-stage params
                   (`stack_stage_params`); each rank keeps its slice [rank].
    x:             [batch, ...] input, whole on every rank; batch must
                   divide by n_microbatch.
    mesh:          a DeviceMesh with the axis `axis` (size S).
    n_microbatch:  M; latency is (S + M - 1) stage-ticks.

    Returns the [batch, ...] output (stage S-1's results), whole on every
    rank. A batch that does not divide by M raises ValueError before any
    collective runs."""
    batch = x.shape[0]
    if batch % n_microbatch:
        raise ValueError(f"batch {batch} not divisible by M={n_microbatch}")
    S = mesh.size(mesh.mesh_dim_names.index(axis))
    M = n_microbatch
    mb = batch // M
    xs = x.reshape((M, mb) + tuple(x.shape[1:]))
    group = mesh.get_group(axis) if S > 1 else None
    sid = mesh.get_local_rank(axis) if S > 1 else 0
    p_local = tree_map(lambda a: a[sid], stage_params)  # this rank's stage only
    if S > 1:
        nxt = dist.get_global_rank(group, (sid + 1) % S)
        prv = dist.get_global_rank(group, (sid - 1) % S)

    zero = torch.zeros_like(xs[0])
    out = torch.zeros_like(xs)
    cur = zero
    for t in range(S + M - 1):
        # stage 0 ingests microbatch t (while t < M); the others use what
        # the previous stage sent last tick
        if sid == 0:
            cur = xs[t] if t < M else zero
        res = stage_fn(p_local, cur)
        # my microbatch this tick; valid while 0 <= t - sid < M
        mine = t - sid
        valid = 0 <= mine < M
        if not valid:
            res = zero
        # the last stage banks its finished microbatch
        if valid and sid == S - 1:
            out[mine] = res
        # hop to the next stage for the next tick
        if S == 1:
            cur = res
        else:
            recv = torch.empty_like(res)
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, res.contiguous(), nxt, group),
                dist.P2POp(dist.irecv, recv, prv, group)])
            for r in reqs:
                r.wait()
            cur = recv
    # only stage S-1's bank holds results; the sum hands them to every rank
    # (the other stages add zeros)
    if S > 1:
        dist.all_reduce(out, group=group)
    return out.reshape((batch,) + tuple(x.shape[1:]))


def stack_stage_params(per_stage: list):
    """[p_0, ..., p_{S-1}] trees (same structure) → one tree with leaves
    stacked on a new leading stage axis, ready for `pipeline_apply`."""
    first = per_stage[0]
    if isinstance(first, dict):
        return {k: stack_stage_params([p[k] for p in per_stage]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(stack_stage_params([p[i] for p in per_stage])
                           for i in range(len(first)))
    return torch.stack(list(per_stage))


def pipe_mesh(n_stages: int):
    """A 1-D DeviceMesh ("pipe",) over the default group's first n_stages
    ranks: JAX's `Mesh(devices[:S], ("pipe",))`, on the device type the
    group's backend serves. Every rank of the group calls it."""
    from torch.distributed.device_mesh import DeviceMesh

    devices = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(devices, torch.arange(n_stages), mesh_dim_names=("pipe",))
