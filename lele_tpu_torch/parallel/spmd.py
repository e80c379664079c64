"""The sharded CTC step's layout and collectives: what GSPMD inserts for
the JAX package's sharded step (train/trainer.py there jits one program
over NamedSharding'd params and batch).

The model's forward (`models.sensevoice.sensevoice_encode`, `sanm_block`,
`moe_ffn`) and the loss (`train.ctc_loss_fn`) take a `Layout` and call the
collectives here. Under `LOCAL` (every axis of size 1, nothing split) each
collective is the identity, so the one-process step and the sharded step
run one forward, op for op.

Each rank holds its shards (DTensors from `shard_params` and
`shard_batch`) and runs the model on them:

- "data": the batch rows are split; the loss's denominator is the global
  label count (an all-reduce), and every gradient is summed over "data".
- "model" (Megatron): activations between blocks are whole on every model
  rank. A column-parallel product runs on the rank's columns; where the
  whole output is needed it is all-gathered (`gather`). A row-parallel
  product runs on the rank's rows and its partial sums are all-reduced
  (`all_sum`). Where a rank's own columns start from a whole activation,
  the backward sums the activation's gradient over the ranks (`sum_grad`).
  The fused qkv is sharded as one [D, 3D] axis, so its columns do not line
  up with heads: the rank gathers qkv and takes the heads that hold its
  channels of out/w's rows and fsmn/w (its attention outputs only those
  channels), with a reduce-scatter in backward. The experts split over
  "model": a rank runs its experts and the one-hot combine is all-reduced.
- "seq": the frames are split (feats and feat_mask, T/seq a rank; seq rank
  0 also holds the 4 prefix frames). Per-frame work stays local; attention
  gathers every key and value (reduce-scattered in backward), and the FSMN
  conv reads its (k-1)/2 frames of halo from the gathered values. The CTC
  loss has no sharded form: the logits are gathered over "seq" and every
  seq rank computes the same loss, each keeping its own frames' gradient.

A leaf `shard_params` left replicated (an axis that does not divide it:
the flagship's vocab of 25,055) runs whole on every rank. Params of a
replicated leaf get the same gradient on every model rank; every gradient
is summed over "data" and, where the frames are split, over "seq".
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch
import torch.distributed as dist
from torch.distributed.tensor import Shard

from ..params import tree_leaves, tree_map
from .mesh import axis_sizes


@dataclass(frozen=True)
class Axis:
    """This rank on one mesh axis; `group` is None for an axis of size 1."""

    group: object = None
    size: int = 1
    rank: int = 0


def mesh_axis(mesh, name: str) -> Axis:
    size = axis_sizes(mesh).get(name, 1)
    if size == 1:
        return Axis()
    return Axis(mesh.get_group(name), size, mesh.get_local_rank(name))


@dataclass(frozen=True)
class Layout:
    """This rank's axes and the paths of the leaves split over "model"."""

    data: Axis = Axis()
    seq: Axis = Axis()  # size 1 unless the batch's frames are split
    model: Axis = Axis()
    split: frozenset = field(default_factory=frozenset)

    def at(self, prefix: str) -> Layout:
        """The layout of the subtree under `prefix` ("layers/3/")."""
        if not self.split:
            return self
        return Layout(self.data, self.seq, self.model,
                      frozenset(p[len(prefix):] for p in self.split if p.startswith(prefix)))

    def splits(self, path: str) -> bool:
        return path in self.split

    def frames(self, t_all: int, n_prefix: int) -> list[int]:
        """The frames each seq rank holds of `t_all` (rank 0 also the
        `n_prefix` prefix frames)."""
        t = (t_all - n_prefix) // self.seq.size
        return [t + (n_prefix if r == 0 else 0) for r in range(self.seq.size)]


LOCAL = Layout()


class _SumGrad(torch.autograd.Function):
    """Identity forward; backward sums the gradient over the axis."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _Sum(torch.autograd.Function):
    """All-reduce (sum) forward; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def _all_gather(x: torch.Tensor, ax: Axis, sizes: list, dim: int) -> torch.Tensor:
    """Parts of `sizes` along `dim`, in rank order, padded to the largest
    for the collective."""
    c = max(sizes)
    xm = x.movedim(dim, 0)
    if xm.shape[0] < c:
        xm = torch.cat([xm, xm.new_zeros((c - xm.shape[0],) + xm.shape[1:])])
    out = xm.new_empty((ax.size * c,) + xm.shape[1:])
    dist.all_gather_into_tensor(out, xm.contiguous(), group=ax.group)
    return torch.cat([out[i * c:i * c + n] for i, n in enumerate(sizes)]).movedim(0, dim)


def _reduce_scatter(g: torch.Tensor, ax: Axis, sizes: list, dim: int) -> torch.Tensor:
    """Sum over the axis of the whole `g`, then this rank's part."""
    c = max(sizes)
    gm = g.movedim(dim, 0)
    parts, off = [], 0
    for n in sizes:
        part = gm[off:off + n]
        off += n
        if n < c:
            part = torch.cat([part, part.new_zeros((c - n,) + part.shape[1:])])
        parts.append(part)
    out = gm.new_empty((c,) + gm.shape[1:])
    dist.reduce_scatter_tensor(out, torch.cat(parts).contiguous(), group=ax.group)
    return out[:sizes[ax.rank]].movedim(0, dim)


class _Gather(torch.autograd.Function):
    """All-gather along `dim`. Backward: with `reduce`, reduce-scatter (each
    rank's downstream used another part of the whole); else this rank's
    slice (the downstream is the same on every rank)."""

    @staticmethod
    def forward(ctx, x, ax, sizes, dim, reduce):
        ctx.args = (ax, sizes, dim, reduce)
        return _all_gather(x, ax, sizes, dim)

    @staticmethod
    def backward(ctx, g):
        ax, sizes, dim, reduce = ctx.args
        if reduce:
            return _reduce_scatter(g, ax, sizes, dim), None, None, None, None
        off = sum(sizes[:ax.rank])
        return g.narrow(dim, off, sizes[ax.rank]).contiguous(), None, None, None, None


def sum_grad(x, ax: Axis):
    """x; its gradient summed over the axis."""
    return x if ax.group is None else _SumGrad.apply(x, ax.group)


def all_sum(x, ax: Axis):
    """x summed over the axis; its gradient as it is."""
    return x if ax.group is None else _Sum.apply(x, ax.group)


def gather(x, ax: Axis, dim: int, reduce: bool, sizes: list | None = None):
    """The ranks' parts of x (of `sizes`, else all as this one's) joined
    along `dim`; see `_Gather` for `reduce`."""
    if ax.group is None:
        return x
    return _Gather.apply(x, ax, sizes or [x.shape[dim]] * ax.size, dim, reduce)


def reduce_(t: torch.Tensor, *axes: Axis) -> torch.Tensor:
    """t summed in place over each axis (no autograd)."""
    for ax in axes:
        if ax.group is not None:
            dist.all_reduce(t, group=ax.group)
    return t


def col_linear(lin, p, split: bool, x, ax: Axis):
    """A column-parallel linear whose whole output every rank needs."""
    if not split:
        return lin(p, x)
    return gather(lin(p, sum_grad(x, ax)), ax, dim=-1, reduce=False)


def row_linear(lin, p, x, ax: Axis):
    """A row-parallel linear on this rank's input channels: partial sums
    all-reduced, then the (replicated) bias."""
    return all_sum(lin({"w": p["w"]}, x), ax) + p["b"]


def local_shard(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's shard on this rank (its storage, for in-place updates);
    a plain tensor as it is."""
    with torch.no_grad():
        return t.to_local() if hasattr(t, "to_local") else t


def _model_split(t, mesh) -> bool:
    i = mesh.mesh_dim_names.index("model") if "model" in mesh.mesh_dim_names else None
    return i is not None and isinstance(t.placements[i], Shard)


def layout_of(params, feats) -> Layout:
    """This rank's Layout for DTensor params; the frames count as split
    where `feats` is a DTensor split over "seq"."""
    from .sharding import _tree_paths

    mesh = tree_leaves(params)[0].device_mesh
    split_frames = hasattr(feats, "placements") and any(
        isinstance(pl, Shard) and pl.dim == 1 for pl in feats.placements)
    return Layout(data=mesh_axis(mesh, "data"),
                  seq=mesh_axis(mesh, "seq") if split_frames else Axis(),
                  model=mesh_axis(mesh, "model"),
                  split=frozenset(path for path, t in _tree_paths(params)
                                  if _model_split(t, mesh)))


def sharded_encode(params, feats, mask, cfg) -> torch.Tensor:
    """`models.sensevoice.sensevoice_encode` on DTensor params (tensor-
    parallel inference): logits [B, 4 + T, vocab] of this rank's batch rows
    (every row where feats is a plain tensor), whole on every rank."""
    from ..models.sensevoice import sensevoice_encode

    lay = layout_of(params, feats)
    p = tree_map(lambda t: t.to_local(), params)
    feats, mask = local_shard(feats), local_shard(mask)
    logits = sensevoice_encode(p, feats, mask.float(), cfg, lay=lay)
    sizes = lay.frames(feats.shape[1] * lay.seq.size + cfg.n_prefix, cfg.n_prefix)
    return gather(logits, lay.seq, dim=1, reduce=False, sizes=sizes)
