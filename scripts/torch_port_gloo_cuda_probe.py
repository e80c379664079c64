"""Whether a gloo process group takes CUDA tensors for the collectives the
port's mesh paths use: two ranks sharing one card (NCCL refuses two ranks on
one device), each collective on CUDA tensors, its answer checked.

    python3 scripts/torch_port_gloo_cuda_probe.py

Each collective runs in a fresh pair of processes, since gloo may abort the
process on a CUDA tensor. Prints one JSON line: {collective: "ok", the
error, or how the ranks ended}, the torch and CUDA versions and the card's
name. Exits 0 whatever the answers (it is a probe).
"""

from __future__ import annotations

import json
import multiprocessing as mp
import sys
import tempfile
from pathlib import Path


def _collective(name: str, rank: int, dev):
    """Run one collective on CUDA tensors; True where its answer is right."""
    import torch
    import torch.distributed as dist

    if name == "all_reduce":
        t = torch.full((4,), float(rank + 1), device=dev)
        dist.all_reduce(t)
        return bool((t == 3).all())
    if name == "all_gather_into_tensor":
        t = torch.full((2,), float(rank), device=dev)
        o = torch.empty(4, device=dev)
        dist.all_gather_into_tensor(o, t)
        return o.tolist() == [0, 0, 1, 1]
    if name == "batch_isend_irecv":
        t = torch.full((3,), float(rank), device=dev)
        r = torch.empty(3, device=dev)
        for w in dist.batch_isend_irecv([dist.P2POp(dist.isend, t, 1 - rank),
                                         dist.P2POp(dist.irecv, r, 1 - rank)]):
            w.wait()
        return bool((r == 1 - rank).all())
    t = torch.full((2,), float(rank + 5), device=dev)  # broadcast
    dist.broadcast(t, src=0)
    return bool((t == 5).all())


def _rank(rank: int, init: str, name: str, q) -> None:
    import torch
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=2)
    try:
        q.put((rank, "ok" if _collective(name, rank, torch.device("cuda", 0))
               else "wrong answer"))
    except Exception as e:  # the probe's answer
        q.put((rank, f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"))
    dist.destroy_process_group()


COLLECTIVES = ("all_reduce", "all_gather_into_tensor", "batch_isend_irecv", "broadcast")


def _probe(name: str) -> str:
    """One collective in a fresh pair of processes (gloo may abort the
    process on a CUDA tensor): its answer, or how the processes ended."""
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    with tempfile.TemporaryDirectory() as d:
        init = f"file://{Path(d) / 'rendezvous'}"
        procs = [ctx.Process(target=_rank, args=(r, init, name, q)) for r in range(2)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=30)
        answers = {}
        while not q.empty():
            r, a = q.get()
            answers[r] = a
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    if len(answers) == 2 and len(set(answers.values())) == 1:
        return answers[0]
    return (f"answers {answers}, exit codes {[p.exitcode for p in procs]} "
            "(a rank aborted: gloo raised in C++)")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    res = {name: _probe(name) for name in COLLECTIVES}
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "card": torch.cuda.get_device_name(0), "gloo_on_cuda_tensors": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
