"""Compiled graphs over a mesh: JAX's `CompiledModel(mesh, batch_axis,
seq_axis, param_rules)` placement (lele_tpu/runtime/engine.py:75-120) and
the collectives GSPMD inserts for it, written out where the tracer meets a
sharded value.

Every rank passes the whole host input and gets the whole output (SPMD, as
JAX's global arrays read):

- **Inputs.** An input shards over "data" along `batch_axis` (0 by default)
  where that dim is the graph's batch dim and divides the axis, and over
  "seq" along `seq_axis` where `seq_axis != batch_axis` and the dim divides
  the axis; every other input is replicated. `shard` gives this rank's part
  (JAX's `_prep`). The trace runs on this rank's rows: a seq-sharded input
  is gathered over "seq" at the program's entry, so the graph sees every
  frame of its rows.
- **Outputs.** An output that depends on a data-sharded input is gathered
  over "data" along `batch_axis`; the others are the same on every rank.
- **Params.** A param is replicated unless `param_rules(name, shape)` (the
  initializer's name and ONNX shape) gives a spec whose every named axis
  divides its dimension; the rank then holds its shard (under the same
  name in `CompiledModel.params`). The consumers that take a shard:
  MatMul / Gemm with the weight split on its output columns (column
  parallel: the rank's columns, then the last dim gathered) or on its K
  rows (row parallel: the rank's slice of the input's last dim, then an
  all-reduce); MatMulNBits with its `_q` / `_s` split on N (the rank's
  columns on kernel 7 or the emitter, then gathered); QMoE with its expert
  stacks split on the expert axis (the rank's experts, the combine's
  partial sums all-reduced). Any other consumer gathers the param whole at
  its point of use.

In JAX a placement only decides where data lives. Here each rank traces
and runs its own rows, so a data split is right only where the graph's
rows are independent and every output that depends on them carries them
at `batch_axis`. The batch dim is the first input's dim at `batch_axis`
(in the graph's input order); another input carries it where it declares
the same dim_param there, or, where either of the two declares none (or
both a fixed size), where its size is the same. So a fixed-size table
beside a dynamic batch stays whole. `outputs` checks each output that
depends on the rows when the program is built and raises ValueError where
it does not hold this rank's rows at `batch_axis` (a seq-first output, a
reduction over the batch, the batch's dim_param declared at another dim)
rather than gather a wrong result.

An axis of size 1 issues no collective. A recorded collective is capturable
in a CUDA graph over NCCL; over gloo it is not, so such a tape takes
step-by-step replay (`Tape.capturable`).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from .mesh import axis_sizes
from .spmd import Axis, _all_gather, mesh_axis


def _is_static(v) -> bool:
    return v is None or isinstance(v, (np.ndarray, np.generic))


class Collective:
    """A recorded collective step over one mesh axis: `gather` joins the
    ranks' parts along `dim` in rank order, `sum` all-reduces."""

    def __init__(self, kind: str, ax: Axis, dim: int = -1):
        self.kind, self.ax, self.dim = kind, ax, dim
        self.capturable = ax.group is None or dist.get_backend(ax.group) == "nccl"
        self.__qualname__ = f"Collective.{kind}"

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.ax.group is None:
            return x
        if self.kind == "sum":
            y = x.contiguous().clone()
            dist.all_reduce(y, group=self.ax.group)
            return y
        dim = self.dim % x.ndim
        return _all_gather(x, self.ax, [x.shape[dim]] * self.ax.size, dim)


def collect(state, kind: str, ax: Axis, t, dim: int = -1):
    """Record a collective on the trace's tape (none for an axis of size 1)."""
    return t if ax.group is None else state.run(Collective(kind, ax, dim), t)


def _narrow(x: torch.Tensor, dim: int, start: int, length: int) -> torch.Tensor:
    return x.narrow(dim, start, length)


def _add_scaled(y: torch.Tensor, c: torch.Tensor, beta: float) -> torch.Tensor:
    return y + (c if beta == 1.0 else beta * c)


def _dim_at(dims, rank: int, ax: int):
    """A declared dim at `ax` (a dim_param name or a fixed size), where the
    declaration has the value's rank; None where it declares nothing."""
    if not dims or len(dims) != rank:
        return None
    d = dims[ax]
    return d if isinstance(d, str) else (int(d) if int(d) > 0 else None)


def _spec(rule_out) -> tuple:
    """A rule's answer (None, a tuple, a list) as a tuple spec."""
    return () if rule_out is None else tuple(rule_out)


class Placement:
    """One mesh's placement of a compiled graph (module docstring)."""

    def __init__(self, mesh, model, input_specs: dict, batch_axis: int | None = None,
                 seq_axis: int | None = None, param_rules=None):
        self.mesh = mesh
        self.sizes = axis_sizes(mesh)
        self.axes = {n: mesh_axis(mesh, n) for n in mesh.mesh_dim_names}
        self.batch_axis = 0 if batch_axis is None else batch_axis
        self.seq_axis = seq_axis
        self.param_rules = param_rules
        # the graph's declared dims (`model`, an OnnxModel): which inputs
        # carry the batch, and what each output declares
        self.declared = {n: d for n, _, d in model.input_info()}
        self.out_dims = model.output_dims()
        ax = self.batch_axis
        first = next((n for n, s in input_specs.items() if len(s[0]) > ax), None)
        self.batch = None if first is None else input_specs[first][0][ax]
        self.batch_sym = None if first is None else _dim_at(self.declared.get(first),
                                                            len(input_specs[first][0]), ax)
        self.inputs = {n: self._input_spec(n, tuple(s[0])) for n, s in input_specs.items()}
        self.gathered: dict[str, Any] = {}  # param name → its whole value on the tape

    # -- inputs and outputs --------------------------------------------------

    def _carries_batch(self, name: str, shape: tuple) -> bool:
        """Whether an input's dim at `batch_axis` is the graph's batch dim
        (module docstring)."""
        d = _dim_at(self.declared.get(name), len(shape), self.batch_axis)
        b = self.batch_sym
        if isinstance(b, str) and isinstance(d, str):
            return d == b
        if isinstance(b, str) and d is not None or isinstance(d, str) and b is not None:
            return False  # one a dim_param, the other a fixed size
        return shape[self.batch_axis] == self.batch

    def _input_spec(self, name: str, shape: tuple) -> tuple:
        parts: list = [None] * len(shape)
        ax = self.batch_axis
        if ("data" in self.sizes and len(shape) > ax and self._carries_batch(name, shape)
                and shape[ax] % self.sizes["data"] == 0):
            parts[ax] = "data"
        s = self.seq_axis
        if (s is not None and "seq" in self.sizes and len(shape) > s and s != ax
                and shape[s] % self.sizes["seq"] == 0):
            parts[s] = "seq"
        return tuple(parts)

    def trace_shape(self, name: str, shape: tuple) -> tuple:
        """The shape the graph is traced at: this rank's rows, every frame."""
        spec = self.inputs[name]
        return tuple(d // self.sizes["data"] if a == "data" else d
                     for d, a in zip(shape, spec))

    def shard(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's part of a whole input (JAX's `_prep` shard)."""
        return self.local(t, self.inputs[name])

    def enter(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """A rank's shard → the trace's input: gathered over "seq"."""
        spec = self.inputs[name]
        if "seq" in spec:
            t = Collective("gather", self.axes["seq"], spec.index("seq"))(t)
        return t

    def outputs(self, tape, input_order: list, output_names: list) -> list[bool]:
        """For each output of a rank's finished tape, whether `leave`
        gathers it over "data" (it depends on a data-sharded input). Raises
        ValueError where such an output does not hold this rank's rows at
        `batch_axis` (module docstring)."""
        data = {k for n, k in zip(input_order, tape.inputs) if "data" in self.inputs[n]}
        from_data = depends_on(tape, data)
        dp = self.sizes.get("data", 1)
        if dp == 1 or not any(from_data):
            return from_data
        ax, rows = self.batch_axis, self.batch // dp
        for name, (shape, _), d in zip(output_names, tape.out_meta, from_data):
            if not d:
                continue
            why = None
            if shape is None or len(shape) <= ax:
                why = f"its traced shape {shape} has no dim {ax}"
            elif shape[ax] != rows:
                why = (f"its traced shape {shape} holds {shape[ax]} at dim {ax}, not this "
                       f"rank's {rows} rows")
            else:
                dims = self.out_dims.get(name)
                if (isinstance(self.batch_sym, str) and dims is not None
                        and len(dims) == len(shape)):
                    if isinstance(dims[ax], str) and dims[ax] != self.batch_sym:
                        why = (f"it declares {dims[ax]!r} at dim {ax}, not the batch "
                               f"{self.batch_sym!r}")
                    elif any(d_ == self.batch_sym for i, d_ in enumerate(dims) if i != ax):
                        why = f"it declares the batch {self.batch_sym!r} at another dim ({dims})"
            if why:
                raise ValueError(
                    f"output {name!r} depends on the inputs split over 'data' (batch_axis "
                    f"{ax}, data {dp}) but {why}: each rank computes its own rows, so over "
                    f"'data' every such output must carry the batch at batch_axis with rows "
                    f"computed independently. Compile without a 'data' axis, or with the "
                    f"batch_axis the outputs carry.")
        return from_data

    def leave(self, t, from_data: bool):
        """A trace output → the whole output: gathered over "data" where it
        depends on a data-sharded input."""
        if from_data and isinstance(t, torch.Tensor):
            return Collective("gather", self.axes["data"], self.batch_axis)(t)
        return t

    @property
    def capturable(self) -> bool:
        """Whether the entry and exit gathers can be captured (NCCL)."""
        return all(ax.group is None or dist.get_backend(ax.group) == "nccl"
                   for ax in self.axes.values())

    # -- params ----------------------------------------------------------------

    def param_spec(self, name: str, value) -> tuple:
        """The rule's spec for a static value where it divides the shape,
        else () (replicated), as at lele_tpu/runtime/engine.py:108-120."""
        if self.param_rules is None or not _is_static(value) or value is None:
            return ()
        shape = np.shape(value)
        spec = _spec(self.param_rules(name, shape))
        if not any(a is not None for a in spec) or len(spec) > len(shape):
            return ()
        for i, a in enumerate(spec):
            if a is not None and shape[i] % self._size(a):
                return ()
        return spec

    def _size(self, a) -> int:
        n = 1
        for name in (a if isinstance(a, tuple) else (a,)):
            n *= self.sizes[name]
        return n

    def _index(self, a) -> int:
        """This rank's part along a dim split over `a` (axes in mesh order)."""
        names = a if isinstance(a, tuple) else (a,)
        idx = 0
        for n in names:
            idx = idx * self.sizes[n] + self.axes[n].rank
        return idx

    def local(self, v, spec: tuple):
        """This rank's shard of a whole value (numpy or torch)."""
        for i, a in enumerate(spec):
            parts = 1 if a is None else self._size(a)
            if parts == 1:
                continue
            n = v.shape[i] // parts
            v = v.narrow(i, self._index(a) * n, n) if isinstance(v, torch.Tensor) else \
                v[(slice(None),) * i + (slice(self._index(a) * n, (self._index(a) + 1) * n),)]
        return np.ascontiguousarray(v) if isinstance(v, np.ndarray) else v.contiguous()

    def hoist(self, state, name: str, v):
        """A static input of a dynamic node on the device: whole where the
        rules leave it replicated; else this rank's shard, gathered whole on
        the tape at its first use (once a param)."""
        spec = self.param_spec(name, v)
        if not spec:
            return state.to_device(name, v)
        if name not in self.gathered:
            t = state.to_device(name, self.local(np.asarray(v), spec))
            for i, a in enumerate(spec):
                if a is None:
                    continue
                # the inner axis first: its ranks hold adjacent parts
                for n in reversed(a if isinstance(a, tuple) else (a,)):
                    t = collect(state, "gather", self.axes[n], t, i)
            self.gathered[name] = t
        return self.gathered[name]

    def axis_of(self, a) -> Axis | None:
        """The Axis of a single-axis spec entry (None for a compound one)."""
        return self.axes[a] if isinstance(a, str) else None

    # -- consumers that take a shard ------------------------------------------

    def emit(self, tracer, state, node, label: str, ins: list, scope: str, emitter,
             static_pos: set):
        """Run a dynamic node one of whose static inputs the rules shard, on
        the shard; NotImplemented where this consumer gathers the whole
        param instead (the tracer's hoisting does)."""
        names = [scope + n if n else "" for n in node.input]
        specs = {i: s for i, v in enumerate(ins)
                 if v is not None and _is_static(v) and i not in static_pos
                 for s in [self.param_spec(names[i], v)] if s}
        if not specs:
            return NotImplemented
        handler = _HANDLERS.get(label)
        if handler is None:
            return NotImplemented
        from ..ops import make_ctx

        ctx = make_ctx(torch, node, tracer.opset, tracer, scope=scope)
        return handler(self, state, ctx, emitter, ins, names, specs)

    def nbits_cut(self, names: list, ins: list, N: int):
        """MatMulNBits on this rank's N columns, for kernel 7's pattern and
        the emitter alike: (axis, columns, inputs) with `_q` (input 1), the
        scales, zero points and bias cut to the rank's columns, each in its
        own layout, where the rules split `_q` on N and every other split
        input the same way; None where nothing of the node is split; False
        where the split is of another form or a plane is not static."""
        specs = {i: self.param_spec(names[i], ins[i]) for i in (1, 2, 3, 5)
                 if i < len(ins) and names[i] and ins[i] is not None and _is_static(ins[i])}
        specs = {i: s for i, s in specs.items() if s}
        if not specs:
            return None
        a = specs.get(1, (None,))[0]
        if (1 not in specs or not isinstance(a, str) or any(x is not None for x in specs[1][1:])
                or any(s[0] != a or any(x is not None for x in s[1:]) for s in specs.values())
                or any(i < len(ins) and ins[i] is not None and not _is_static(ins[i])
                       for i in (1, 2, 3, 5))):
            return False
        n_loc = N // self.sizes[a]
        n0 = self.axes[a].rank * n_loc
        out = list(ins)
        for i in (1, 2, 3, 5):
            if i < len(out) and out[i] is not None:
                v = np.asarray(out[i])
                rows = v.reshape(N, -1)[n0:n0 + n_loc]  # scales and zero points may come flat
                out[i] = np.ascontiguousarray(rows.reshape((n_loc,) + v.shape[1:])
                                              if v.shape[0] == N else rows.reshape(-1))
        return self.axes[a], n_loc, out


def _matmul(pl, state, ctx, emitter, ins, names, specs):
    """MatMul with a static 2-D weight split on one dim (module docstring)."""
    if set(specs) != {1} or _is_static(ins[0]) or np.ndim(ins[1]) != 2:
        return NotImplemented
    return _split_product(pl, state, lambda a, w: state.run(emitter, ctx, a, w), ins[0],
                          ins[1], names[1], specs[1], n_dim=1, a_dim=-1)


def _gemm(pl, state, ctx, emitter, ins, names, specs):
    """Gemm with a static B split on one dim: op(B)'s N is column parallel,
    its K row parallel; C is added after the collective."""
    if set(specs) != {1} or _is_static(ins[0]) or np.ndim(ins[1]) != 2:
        return NotImplemented
    trans_a, trans_b = ctx.attr("transA", 0), ctx.attr("transB", 0)
    ctx2 = dataclasses.replace(ctx, attrs={**ctx.attrs, "beta": 0.0})
    y = _split_product(pl, state, lambda a, w: state.run(emitter, ctx2, a, w, None), ins[0],
                       ins[1], names[1], specs[1], n_dim=0 if trans_b else 1,
                       a_dim=0 if trans_a else -1)
    if y is NotImplemented:
        return y
    c, beta = (ins[2] if len(ins) > 2 else None), float(ctx.attr("beta", 1.0))
    if c is None or beta == 0.0:
        return y
    if _is_static(c):
        c = pl.hoist(state, names[2], c)
    return state.run(_add_scaled, y, c, beta)


def _split_product(pl, state, product, a, w, name: str, spec: tuple, n_dim: int, a_dim: int):
    """product(a, w) with w split on its output dim `n_dim` (the rank's
    columns, gathered along the last dim) or its K dim (a's `a_dim` sliced,
    the partial products all-reduced)."""
    dims = [i for i, x in enumerate(spec) if x is not None]
    ax = pl.axis_of(spec[dims[0]]) if len(dims) == 1 else None
    if ax is None:
        return NotImplemented
    w_loc = state.to_device(name, pl.local(np.asarray(w), spec))
    if dims[0] == n_dim:
        return collect(state, "gather", ax, product(a, w_loc))
    k = w_loc.shape[dims[0]]
    if ax.group is not None:
        a = state.run(_narrow, a, a_dim % a.ndim, ax.rank * k, k)
    return collect(state, "sum", ax, product(a, w_loc))


def _matmul_nbits(pl, state, ctx, emitter, ins, names, specs):
    """MatMulNBits off kernel 7's route (bits 8, g_idx, other blocks) on the
    rank's N columns: the emitter with N set to them, then gathered."""
    cut = pl.nbits_cut(names, ins, int(ctx.attr("N")))
    if not cut or _is_static(ins[0]) or (len(ins) > 4 and ins[4] is not None):
        return NotImplemented
    ax, n_loc, args = cut
    args = args + [None] * (6 - len(args))
    for i in (1, 2, 3, 5):
        if args[i] is not None:
            args[i] = state.to_device(names[i], args[i])
    ctx2 = dataclasses.replace(ctx, attrs={**ctx.attrs, "N": n_loc})
    return collect(state, "gather", ax, state.run(emitter, ctx2, *args))


def _qmoe(pl, state, ctx, emitter, ins, names, specs):
    """QMoE with its expert stacks split on the expert axis: the rank's
    experts (ops/moe_ops.py on the local stacks, the routing over every
    expert), the combine's partial sums all-reduced."""
    from ..ops.moe_ops import qmoe_local

    stack_ins = [i for i in range(2, 11) if i < len(ins) and ins[i] is not None]
    a = specs[min(specs)][0] if specs else None
    if (_is_static(ins[0]) or not isinstance(a, str) or set(specs) != set(stack_ins)
            or any(s[0] != a or any(x is not None for x in s[1:]) for s in specs.values())):
        return NotImplemented
    ax = pl.axes[a]
    n_experts = np.shape(ins[2])[0]
    e_loc = n_experts // pl.sizes[a]
    args = list(ins) + [None] * (11 - len(ins))
    for i in stack_ins:
        args[i] = state.to_device(names[i], pl.local(np.asarray(ins[i]), specs[i]))
    y = state.run(qmoe_local, ctx, *args, e0=ax.rank * e_loc, n_experts=n_experts)
    return collect(state, "sum", ax, y)


_HANDLERS = {"MatMul": _matmul, "Gemm": _gemm, "com.microsoft::MatMulNBits": _matmul_nbits,
             "com.microsoft::QMoE": _qmoe}


def depends_on(tape, input_slots: set) -> list[bool]:
    """For each output of a finished tape, whether it depends on one of the
    given input slots (data flow through the recorded steps)."""
    from ..compiler.tracer import _slots

    marked = set(input_slots)
    for st in tape.steps:
        if _slots((st.args, st.kwargs), set()) & marked:
            marked |= _slots(st.outs, set())
    return [bool(_slots(o, set()) & marked) for o in tape.outputs]
