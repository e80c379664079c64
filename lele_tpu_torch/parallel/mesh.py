"""Device mesh construction (counterpart of lele_tpu/parallel/mesh.py).

Default topology: 2-D ("data", "model"): data parallelism over the first
axis, tensor parallelism over the second. A 3-D ("data", "seq", "model")
mesh adds sequence parallelism. Axis sizes auto-factor from the device
count, by the JAX package's rule (`mesh_shape`); callers can pin sizes.

Torch on the CPU has one device, so a mesh is over processes: one rank a
device, gloo for CPU tensors and NCCL on cards. The caller starts the
processes and the default process group (`init_distributed` gives it its
backend from the device); `make_mesh` then builds a DeviceMesh over the
group's ranks with the JAX package's axis names.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

AXES = ("data", "model")
AXES3 = ("data", "seq", "model")


def mesh_axes() -> tuple[str, str]:
    return AXES


def mesh_shape(n: int, data: int | None = None, model: int | None = None,
               seq: int | None = None) -> dict[str, int]:
    """{axis: size} for n devices, as the JAX package factors them; a
    factoring that does not multiply to n raises AssertionError, as there."""
    if seq is not None:
        rest = n // seq
        if data is None and model is None:
            model = 2 if rest % 2 == 0 else 1
            data = rest // model
        elif data is None:
            data = rest // model
        elif model is None:
            model = rest // data
        if data * seq * model != n:
            raise AssertionError(f"mesh {data}x{seq}x{model} != {n}")
        return {"data": data, "seq": seq, "model": model}
    if data is None and model is None:
        # favor model-parallel up to 4, rest data-parallel
        model = 1
        for cand in (4, 2):
            if n % cand == 0:
                model = cand
                break
        data = n // model
    elif data is None:
        data = n // model
    elif model is None:
        model = n // data
    if data * model != n:
        raise AssertionError(f"mesh {data}x{model} != {n} devices")
    return {"data": data, "model": model}


def init_distributed(rank: int, world_size: int, init_method: str,
                     device: str = "cuda") -> None:
    """The default process group for one rank: NCCL for "cuda" (card
    `rank % device_count`), gloo for "cpu". `init_method` is the
    rendezvous (`tcp://localhost:<port>` or `file://<path>`)."""
    if device == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            init_method=init_method, rank=rank, world_size=world_size)


def make_mesh(n_devices: int | None = None, data: int | None = None,
              model: int | None = None, seq: int | None = None,
              devices: str | None = None) -> DeviceMesh:
    """A DeviceMesh over the default group's ranks, shaped by `mesh_shape`,
    with the axis names ("data", "model") or ("data", "seq", "model").
    `devices` is the device type ("cuda" or "cpu"; by default the one the
    group's backend serves). Every rank calls it; n_devices must be the
    group's size."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs the default process group "
                           "(parallel.mesh.init_distributed)")
    world = dist.get_world_size()
    n = n_devices or world
    if n != world:
        raise ValueError(f"a mesh of {n} devices over a group of {world} ranks")
    if devices is None:
        devices = "cuda" if dist.get_backend() == "nccl" else "cpu"
    shape = mesh_shape(n, data=data, model=model, seq=seq)
    ranks = torch.arange(n).reshape(*shape.values())
    return DeviceMesh(devices, ranks, mesh_dim_names=tuple(shape))


def axis_sizes(mesh: DeviceMesh) -> dict[str, int]:
    """{axis: size}: the JAX Mesh's `.shape`."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank's tensors live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)
