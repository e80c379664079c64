"""Sharding rules: param path → spec (counterpart of
lele_tpu/parallel/sharding.py).

Megatron-style tensor parallelism for the transformer blocks: column-parallel
first matmul (qkv / ffn1 sharded on the output feature axis), row-parallel
second matmul (out / ffn2 sharded on the input feature axis), so each block
needs one all-reduce; experts shard over "model". A spec is the JAX
PartitionSpec as a tuple, one axis name or None a dimension (() is
replicated). Placed leaves are DTensors over the mesh: each rank holds only
its shard. GSPMD inserts the collectives for the JAX package; the port
writes them out in `parallel/spmd.py`.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from ..params import array_to_tensor
from .mesh import axis_sizes, mesh_device

Spec = tuple


def to_placements(mesh: DeviceMesh, spec: Spec) -> list:
    """A spec → one DTensor placement a mesh axis (Shard(i) where tensor
    dimension i names the axis, else Replicate)."""
    out = []
    for name in mesh.mesh_dim_names:
        dims = [i for i, a in enumerate(spec)
                if a == name or (isinstance(a, tuple) and name in a)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


def replicate(mesh: DeviceMesh) -> list:
    return to_placements(mesh, ())


def batch_sharding(mesh: DeviceMesh, rank: int = 3) -> list:
    return to_placements(mesh, ("data", *([None] * (rank - 1))))


def sensevoice_param_rules(path: str) -> Spec:
    """Spec for a SenseVoice param, keyed by its tree path string.

    qkv/ffn1 → column-parallel (shard last dim on "model");
    out/ffn2 → row-parallel (shard first dim);
    biases of row-parallel layers + norms + small tensors → replicated.
    """
    if path.endswith("qkv/w") or path.endswith("ffn1/w"):
        return (None, "model")
    if path.endswith("qkv/b") or path.endswith("ffn1/b"):
        return ("model",)
    if path.endswith("out/w") or path.endswith("ffn2/w"):
        return ("model", None)
    if path.endswith("ctc/w"):
        return (None, "model")
    if path.endswith("ctc/b"):
        return ("model",)
    if path.endswith("fsmn/w"):
        return (None, "model")
    if "/moe/w1" in path or "/moe/w2" in path:
        return ("model", None, None)  # expert parallelism
    return ()


def _tree_paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _tree_paths(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _tree_paths(v, f"{prefix}{i}/")
    else:
        yield prefix.rstrip("/"), tree


def placed_spec(spec: Spec, shape: tuple, sizes: dict[str, int]) -> Spec:
    """The spec a leaf of `shape` is placed with: `spec` where every named
    axis divides its dimension, else () (replicated)."""
    for i, axis in enumerate(spec):
        if axis is None:
            continue
        size = sizes[axis] if isinstance(axis, str) else \
            int(np.prod([sizes[a] for a in axis]))
        if i >= len(shape) or shape[i] % size:
            return ()  # not evenly partitionable → replicate
    return spec


def shard_params(params, mesh: DeviceMesh, rules=sensevoice_param_rules):
    """Place a param tree on the mesh per the rules: every rank passes the
    whole tree and keeps its own shard of each leaf (a DTensor).

    A rule only applies when every named axis DIVIDES the corresponding
    dimension — otherwise that leaf replicates. The flagship's CTC head is
    the canonical case: vocab 25055 has no power-of-two factor, so on
    model=2/4/8 meshes it stays replicated and the matmul still runs with
    sharded activations."""
    sizes = axis_sizes(mesh)
    dev = mesh_device(mesh)

    def place(path, leaf):
        t = (leaf if isinstance(leaf, torch.Tensor) else array_to_tensor(leaf)).to(dev)
        spec = placed_spec(rules(path), tuple(t.shape), sizes)
        return distribute_tensor(t, mesh, to_placements(mesh, spec), src_data_rank=None)

    return _unflatten({p: place(p, l) for p, l in _tree_paths(params)})


def _unflatten(flat: dict):
    root: dict = {}
    for path, leaf in flat.items():
        parts = path.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return _listify(root)


def _listify(node):
    if isinstance(node, dict):
        keys = list(node.keys())
        if keys and all(k.isdigit() for k in keys):
            return [_listify(node[str(i)]) for i in range(len(keys))]
        return {k: _listify(v) for k, v in node.items()}
    return node


def param_spec_tree(params, rules=sensevoice_param_rules):
    """Tree of specs matching the params structure."""
    flat = dict(_tree_paths(params))
    placed = {p: rules(p) for p in flat}
    return _unflatten(placed)


def dp_put(mesh: DeviceMesh, arrays, axis: int = 0):
    """Place live batch inputs with the batch dim sharded over "data" (the
    serving dp layout). An array whose batch dim does not divide the axis
    replicates instead — same leniency rule as shard_params, so
    partially-filled power-of-two batches still run."""
    dp = axis_sizes(mesh).get("data", 1)
    dev = mesh_device(mesh)
    out = []
    for a in arrays:
        t = (a if isinstance(a, torch.Tensor) else array_to_tensor(a)).to(dev)
        spec = [None] * t.ndim
        if t.ndim > axis and dp > 1 and t.shape[axis] % dp == 0:
            spec[axis] = "data"
        out.append(distribute_tensor(t, mesh, to_placements(mesh, tuple(spec)),
                                     src_data_rank=None))
    return tuple(out)
