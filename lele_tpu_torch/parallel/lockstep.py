"""Rank 0 drives, the other ranks follow: how the port serves over a mesh of
processes.

JAX's daemon is one process over many devices: a coalesced batch is one
global array and one program. The port's mesh is one process a rank, so
rank 0 (the HTTP server and its batchers) tells the other ranks each
batch before it runs its share:

- `announce(engine, arrays)` on the driving rank sends a small header
  (the engine's name and each array's shape and type) and then the arrays
  themselves, over the default group. It is a no-op on a rank that does not
  drive (a one-process daemon, a one-rank mesh, a test calling a model
  alone), so a mesh path calls it unconditionally.
- `follow(handlers)` is a worker's loop: a header, the arrays, then
  `handlers[engine](*arrays)` (the same SPMD program rank 0 runs on its
  share), until a "stop" header.
- `stop()` on the driving rank ends the workers' loops.

Every rank then runs its rows and the results are gathered (the mesh
paths of models/sensevoice.py and serving.py), so rank 0 ends with the
whole batch. Rank 0 announces while it holds `runtime.graphs.CARD_LOCK`,
so every rank sees the batches in one order, and it announces only after
the request's inputs are built: a request rank 0 refuses never sends a
header, and no worker is left inside a collective. A worker whose handler
raises ends its loop with the error; rank 0's next collective then fails
the call (nothing carries on alone).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

STOP = "stop"
_DRIVING = {"on": False}


def drive() -> None:
    """Make this process the one that announces batches to its default
    group's workers (rank 0 of a daemon over several ranks)."""
    _DRIVING["on"] = dist.is_initialized() and dist.get_world_size() > 1


def driving() -> bool:
    return _DRIVING["on"]


def _device() -> torch.device:
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def announce(engine: str, arrays=()) -> None:
    """On the driving rank: the header and the arrays to every worker."""
    if not driving():
        return
    arrays = [np.ascontiguousarray(a) for a in arrays]
    dist.broadcast_object_list([(engine, [(a.shape, a.dtype.str) for a in arrays])], src=0)
    for a in arrays:
        dist.broadcast(torch.from_numpy(a).to(_device()), src=0)


def stop() -> None:
    """On the driving rank: end the workers' loops (then it drives no more)."""
    if driving():
        announce(STOP)
        _DRIVING["on"] = False


def follow(handlers: dict) -> int:
    """A worker's loop: run each announced batch's handler on the received
    arrays until "stop". Returns the number of batches run."""
    n = 0
    while True:
        box = [None]
        dist.broadcast_object_list(box, src=0)
        engine, metas = box[0]
        if engine == STOP:
            return n
        arrays = []
        for shape, dt in metas:
            t = torch.empty(shape, dtype=torch.from_numpy(np.zeros(0, dt)).dtype,
                            device=_device())
            dist.broadcast(t, src=0)
            arrays.append(t.cpu().numpy())
        handlers[engine](*arrays)
        n += 1
