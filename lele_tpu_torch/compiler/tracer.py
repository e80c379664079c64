"""ONNX → torch tracer (counterpart of lele_tpu/compiler/tracer.py): walk a
GraphProto once, record the device work, replay it per request.

- **Constant folding** falls out of the walk: every value is either
  *static* (a numpy array, evaluated on the host in full 64-bit precision)
  or *dynamic* (a tensor on the model's device). A node whose inputs are all
  static evaluates at once with numpy, so shape-carrying chains
  (Shape → Slice → Concat → Reshape) are Python ints before the device sees
  them.
- **Param hoisting**: a static value that feeds a dynamic op goes to the
  device once, by name, into `TraceState.params`, after folding: weight-only
  computation (transposes, casts, zero-point pre-packs) runs once.
- **Trace once, replay after.** JAX walks the graph under `jit` and runs the
  compiled program after. The port walks the graph once in `build`, at the
  input spec, on placeholder inputs (zeros) on the device, running every
  dynamic step as it goes and recording it on a `Tape`: the emitters'
  steps, and the patterns' fused launches with their weights stacked on
  the device. `Tape.replay` runs only the recorded steps, so a warm request
  matches no pattern and folds nothing. Steps whose outputs reach no graph
  output are dropped, and each intermediate is freed after its last use.
- **Common subexpressions**: a dynamic node that repeats an earlier one (the
  same op and attributes on the same values) reuses its result instead of
  recording a second step, as XLA's CSE does for the JAX package. Exports
  repeat such chains per layer (the SAN-M graph rebuilds its attention mask
  in each of its layers).
- Dispatch precedence: pattern → override → builtin → fallback (a warning
  and an empty value; strict mode raises). An emitter marked `records`
  (LSTM) records its own steps, so it can prepare static weights once.
- **If**: a static condition picks its branch while tracing, as JAX does.
  A dynamic one is traced on the placeholder zeros, which would take one
  branch for every request; so both branches are walked, each onto a
  sub-tape of its own, and one step holds both and replays the branch that
  the request's condition selects. Reading the condition costs one
  device → host read a replay, so such a tape cannot be captured in a CUDA
  graph (`Tape.capturable`): `CompiledModel` replays it step by step on a
  card. Both branches must give outputs of the same shapes, since later
  shape arithmetic folds on one of them.
- **Scan and Loop**: the body is walked once, onto a sub-tape, on device
  placeholders for its inputs (the state, the slice, the iteration counter),
  so no iteration's values fold into the others. One step holds the
  sub-tape and replays it once an iteration. Scan, a Loop whose body is a
  pure for-loop over a static trip count M, and a Loop with scan outputs,
  a static M and a data-dependent exit (JAX's padded design: an `active`
  flag on the device freezes the carries and writes zero rows up to M) read
  nothing from the host, so they stay capturable; the counter is a device
  `arange(M)` made once while tracing, indexed a replay. A carried-only
  Loop with a dynamic condition or M (M = INT64_MAX, the exporters' "no
  bound", clamped as JAX clamps it) reads its condition on the host each
  iteration, as a dynamic If does: such a tape is not capturable. It is not
  run while tracing (on placeholder inputs its exit may never come); its
  inits, whose shapes its carries keep, stand in for the walk. Scan outputs
  with no static bound give a warning and empty outputs (strict mode
  raises), as in JAX.
- **Search ops** (BeamSearch, GreedySearch, Sampling: `OpDef.subgraph`,
  ops/search_ops.py) get the tracer, the walk state and the scope, are
  never folded or merged by CSE, and walk their decoder graphs themselves:
  the prefill inline on the tape, the step once onto a sub-tape
  (`walk_body`, from an empty CSE table) replayed by one `_SearchStep` a
  generated token, all on the device, so it stays capturable. An override
  marked `records` records its own steps, as a recording emitter does.
- **SequenceMap** unrolls its body once per element of its sequences
  (trace-time lists, `ops/extra_ops.TensorSeq`, whose elements may differ in
  shape), as JAX does. Sequences and optionals are host-level values: the
  ops that only restructure them record no step.

- **A compute dtype** (`build(..., compute=torch.bfloat16)`, JAX's
  `compute="bfloat16"`): the walk runs on f32 inputs cast to it, and every
  hoisted f32 value of at least `PARAM_THRESHOLD` elements (the JAX tracer's
  bar for a runtime param; a smaller one stays a literal there) is stored in
  it. Smaller constants keep f32, so an f32 scalar promotes the value it
  meets, as under jnp (the binary emitters promote as jnp does).

"""

from __future__ import annotations

import functools
import sys
from collections import ChainMap
from dataclasses import dataclass, field
from typing import Any, Callable, Sequence

import numpy as np
import torch

from ..onnx.loader import (Fp8Bits, OnnxModel, base_dir_scope, from_torch, tensor_to_array,
                           to_torch)
from ..onnx.schema import Proto
from ..ops import make_ctx
from ..ops.extra_ops import OptionalVal, TensorSeq
from ..ops.registry import canon_domain, lookup_op, parse_attr
from ..ops.tensor_ops import torch_dtype

# the largest trip count a Loop takes (JAX clamps M to int32; INT64_MAX is
# the exporters' "no bound")
_NO_BOUND = 2**31 - 1
# the JAX tracer's size bar for hoisting a static value to a runtime param;
# under a compute dtype only such params are stored in it
PARAM_THRESHOLD = 256


def _is_static(v) -> bool:
    return v is None or isinstance(v, (np.ndarray, np.generic))


def _reject_optionals(where: str, values) -> None:
    """Optionals are trace-time wrappers (ops/extra_ops.OptionalVal); they
    cannot flow through a dynamic branch or a loop's carries. Raise the
    JAX tracer's actionable error."""
    if any(isinstance(v, OptionalVal) for v in values):
        raise NotImplementedError(
            f"{where} carry an ONNX optional: optional values must be "
            "resolved statically (OptionalHasElement folds at trace time); "
            "dynamic branches/loops cannot carry optionals. Hint: hoist the "
            "Optional construction out of the subgraph or make its "
            "condition static.")


def _hashable(v):
    """A value's identity for the CSE key: a device tensor by object (the
    trace keeps every one alive), a host value by content, a sequence by its
    elements and its kind. Raises TypeError for what has no such identity (a
    subgraph attribute, an optional)."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, TensorSeq):
        return ("seq",) + tuple(_hashable(x) for x in v)
    if isinstance(v, torch.Tensor):
        return ("tensor", id(v))
    if isinstance(v, (np.ndarray, np.generic)):
        a = np.asarray(v)
        return ("array", a.dtype.str, a.shape, a.tobytes())
    if isinstance(v, (list, tuple)):
        return tuple(_hashable(x) for x in v)
    raise TypeError(f"no CSE identity for {type(v).__name__}")


def _to_numpy(out):
    if isinstance(out, tuple):
        return tuple(_to_numpy(v) for v in out)
    if isinstance(out, TensorSeq):
        return TensorSeq(_to_numpy(v) for v in out)
    if isinstance(out, torch.Tensor):
        return from_torch(out)
    return np.asarray(out)


@dataclass(frozen=True)
class _Slot:
    """A dynamic value's place in the replay's value table."""

    k: int


@dataclass
class _Step:
    fn: Callable
    args: tuple
    kwargs: dict
    outs: Any  # the output's structure, tensors replaced by _Slot
    free: tuple = ()  # slots whose last use is this step


def _map(tree, leaf):
    if isinstance(tree, tuple):
        return tuple(_map(v, leaf) for v in tree)
    if isinstance(tree, list):  # a TensorSeq stays one
        return type(tree)(_map(v, leaf) for v in tree)
    if isinstance(tree, dict):
        return {k: _map(v, leaf) for k, v in tree.items()}
    return leaf(tree)


def _slots(tree, acc: set) -> set:
    _map(tree, lambda v: acc.add(v.k) if isinstance(v, _Slot) else None)
    return acc


class Tape:
    """The dynamic steps of one graph walk, replayed on new inputs.

    During the walk `run(fn, *args)` calls fn at once and records it with
    each tensor argument named by its slot. A tensor argument must be a
    recorded value (an input or a step's output) or a constant of the trace
    (`const`): any other tensor was computed outside the tape, which replay
    could not repeat, so it raises.

    A sub-tape (an If branch) has a parent: a value of the parent (or of its
    parents) that the branch reads becomes one of the sub-tape's inputs,
    and `captured` lists those values in input order. Constants are shared
    by all the tapes of a trace."""

    def __init__(self, parent: "Tape | None" = None):
        self.steps: list[_Step] = []
        self.values: list[torch.Tensor] = []  # slot → the walk's value
        self.inputs: list[int] = []
        self._slot: dict[int, int] = {}  # id(tensor) → slot
        self._const: set[int] = parent._const if parent is not None else set()
        self.parent = parent
        self.captured: list[torch.Tensor] = []
        self.outputs: list = []
        self.out_meta: list = []
        self.n_slots = 0

    def const(self, t: torch.Tensor) -> torch.Tensor:
        self._const.add(id(t))
        return t

    def _new_slot(self, t: torch.Tensor) -> _Slot:
        k = len(self.values)
        self.values.append(t)  # keeps t alive, so its id stays unique
        self._slot[id(t)] = k
        return _Slot(k)

    def _ref(self, v):
        if not isinstance(v, torch.Tensor):
            return v
        k = self._slot.get(id(v))
        if k is not None:
            return _Slot(k)
        if id(v) in self._const:
            return v
        if self.parent is not None:
            self.parent._ref(v)  # raises unless an outer value
            self.captured.append(v)
            return _Slot(self.input(v))
        raise RuntimeError("a device value reached a traced step without "
                           "being recorded: compute it through Tape.run")

    def input(self, t: torch.Tensor) -> int:
        k = self._new_slot(t).k
        self.inputs.append(k)
        return k

    def run(self, fn: Callable, *args, **kwargs):
        rargs, rkwargs = _map(args, self._ref), _map(kwargs, self._ref)
        out = fn(*args, **kwargs)
        return self._record(fn, rargs, rkwargs, out)

    def record(self, fn: Callable, args: tuple, out):
        """Record fn(*args) as a step whose trace-time result is `out`,
        without calling it."""
        return self._record(fn, _map(args, self._ref), {}, out)

    def _record(self, fn, rargs, rkwargs, out):
        outs = _map(out, lambda v: self._new_slot(v)
                    if isinstance(v, torch.Tensor) else v)
        if _slots(outs, set()):
            self.steps.append(_Step(fn, rargs, rkwargs, outs))
        return out

    def finish(self, outputs: list) -> None:
        """Fix the graph outputs, drop the steps no output needs, mark where
        each slot is last read, and let go of the walk's values."""
        self.outputs = [_map(o, self._ref) for o in outputs]
        # each output's (shape, dtype) at the walk, for donation's matching
        self.out_meta = [(tuple(o.shape), o.dtype) if isinstance(o, torch.Tensor)
                         else (None, None) for o in outputs]
        live = _slots(self.outputs, set())
        kept = []
        for st in reversed(self.steps):
            if _slots(st.outs, set()) & live:
                kept.append(st)
                live |= _slots((st.args, st.kwargs), set())
        kept.reverse()
        keep_to_end = _slots(self.outputs, set())
        seen: set[int] = set()
        for st in reversed(kept):
            used = _slots((st.args, st.kwargs), set()) - seen - keep_to_end
            st.free = tuple(sorted(used))
            seen |= used
        self.steps = kept
        self.n_slots = len(self.values)
        self.values = []
        self._slot = {}

    def replay(self, inputs: Sequence[torch.Tensor]) -> list:
        vals: list = [None] * self.n_slots
        for k, t in zip(self.inputs, inputs):
            vals[k] = t

        def get(v):
            return vals[v.k] if isinstance(v, _Slot) else v

        for i, st in enumerate(self.steps):
            try:
                out = st.fn(*_map(st.args, get), **_map(st.kwargs, get))
            except Exception as e:
                if not getattr(e, "_lele_step", False):
                    e._lele_step = True
                    e.add_note(f"  in tape step {i} of {len(self.steps)}: {_step_name(st)}")
                raise
            _bind(st.outs, out, vals)
            for k in st.free:
                vals[k] = None
        return [_map(o, get) for o in self.outputs]

    @property
    def capturable(self) -> bool:
        """Whether a replay can be captured in a CUDA graph: no step reads
        the host. Such steps are a dynamic If's (`_IfStep`), which reads its
        condition on every replay, and a while loop's (`_WhileStep`), which
        reads it every iteration; a loop or scan step is capturable where
        its body is; a collective over a mesh axis (parallel/placement.py)
        is capturable over NCCL, not over gloo."""
        return all(getattr(st.fn, "capturable", True) for st in self.steps)


def _step_name(st: _Step) -> str:
    """A recorded step by its function's name, and its node where an
    emitter recorded it (a pattern's launch has no node)."""
    fn = st.fn
    while isinstance(fn, functools.partial):
        fn = fn.func
    if isinstance(fn, _SubgraphStep):
        return fn.label
    name = getattr(fn, "__qualname__", type(fn).__name__)
    node = getattr(st.args[0], "node", None) if st.args else None
    if node is not None:
        name += f" (node {node.op_type} {node.name!r})"
    return name


class _SubgraphStep:
    """A recorded step that replays sub-tapes (If branches, a loop body)."""

    label = "subgraph"
    capturable = False


class _IfStep(_SubgraphStep):
    """The recorded step of an If with a dynamic condition: both branches'
    sub-tapes; a replay reads the condition (one device → host read) and
    replays the branch it selects on that branch's captured values."""

    label = "If (a dynamic condition)"

    def __init__(self, then_tape: Tape, else_tape: Tape):
        self.then_tape, self.else_tape = then_tape, else_tape

    def __call__(self, cond: torch.Tensor, then_in: list, else_in: list):
        if bool(cond.reshape(-1)[0].item()):
            return tuple(self.then_tape.replay(then_in))
        return tuple(self.else_tape.replay(else_in))


def _fresh(vals) -> tuple:
    """New tensor objects for a step's outputs: a body may hand back one of
    its inputs or an outer value itself, which the tape must not re-slot."""
    return tuple(v.view_as(v) for v in vals)


def _stacked(rows: list, meta, device) -> torch.Tensor:
    """One scan output: its rows stacked on a new leading axis, or [0, ...]
    of the body output's traced shape where the loop ran no iteration."""
    if rows:
        return torch.stack(rows)
    shape, dtype = meta
    return torch.empty((0,) + tuple(shape), dtype=dtype, device=device)


class _ScanStep(_SubgraphStep):
    """The recorded step of an ONNX Scan: the body's sub-tape replayed once a
    slice (inputs: the states, the slices, the captured outer values; outputs:
    the new states, then the scan rows), with JAX's axes and directions."""

    label = "Scan"

    def __init__(self, body: Tape, n_state: int, in_axes, in_dirs, out_axes, out_dirs,
                 device: torch.device):
        self.body, self.n_state, self.device = body, n_state, device
        self.in_axes, self.in_dirs = in_axes, in_dirs
        self.out_axes, self.out_dirs = out_axes, out_dirs

    @property
    def capturable(self) -> bool:
        return self.body.capturable

    def __call__(self, states: list, xs: list, captured: list):
        xs = [_scan_axis(x, self.in_axes, self.in_dirs, i, to_front=True)
              for i, x in enumerate(xs)]
        n_out = len(self.body.out_meta) - self.n_state
        rows: list[list] = [[] for _ in range(n_out)]
        for t in range(xs[0].shape[0] if xs else 0):
            outs = self.body.replay([*states, *(x[t] for x in xs), *captured])
            states = outs[:self.n_state]
            for acc, y in zip(rows, outs[self.n_state:]):
                acc.append(y)
        ys = [_scan_axis(_stacked(r, self.body.out_meta[self.n_state + j], self.device),
                         self.out_axes, self.out_dirs, j, to_front=False)
              for j, r in enumerate(rows)]
        return _fresh([*states, *ys])


def _scan_axis(x, axes, dirs, i: int, to_front: bool):
    """Scan input i moved to the front and flipped for a reverse direction,
    or scan output i flipped back and moved to its axis."""
    ax = int(axes[i]) if i < len(axes) else 0
    rev = i < len(dirs) and bool(dirs[i])
    if to_front:
        x = torch.movedim(x, ax, 0)
        return x.flip(0) if rev else x
    if rev:
        x = x.flip(0)
    return torch.movedim(x, 0, ax)


class _LoopStep(_SubgraphStep):
    """The recorded step of an ONNX Loop over a static trip count M: the
    body's sub-tape (inputs: the iteration counter, the condition, the
    carries, the captured outer values; outputs: the condition, the new
    carries, the scan rows) replayed M times. The counter is `iters[i]`, a
    view of a device arange made once while tracing. `padded` is JAX's
    design for a data-dependent exit: an `active` flag on the device, the
    carries frozen and zero rows written once the body's condition is
    false, all without a host read."""

    def __init__(self, body: Tape, n_carried: int, padded: bool):
        self.body, self.n_carried, self.padded = body, n_carried, padded
        self.label = "Loop (padded to its bound)" if padded else "Loop (a for-loop)"

    @property
    def capturable(self) -> bool:
        return self.body.capturable

    def __call__(self, iters: torch.Tensor, true: torch.Tensor, vs: list, captured: list,
                 active: torch.Tensor | None = None):
        nc = self.n_carried
        if active is not None:
            active = active.reshape(()).bool()
        rows: list[list] = [[] for _ in range(len(self.body.out_meta) - 1 - nc)]
        for i in range(iters.shape[0]):
            outs = self.body.replay([iters[i], true, *vs, *captured])
            new_vs, scans = outs[1:1 + nc], outs[1 + nc:]
            if self.padded:
                new_vs = [torch.where(active, nv.to(v.dtype), v) for nv, v in zip(new_vs, vs)]
                scans = [torch.where(active, y, torch.zeros_like(y)) for y in scans]
                active = torch.logical_and(active, outs[0].reshape(()).bool())
            vs = new_vs
            for acc, y in zip(rows, scans):
                acc.append(y)
        ys = [_stacked(r, self.body.out_meta[1 + nc + j], iters.device)
              for j, r in enumerate(rows)]
        return _fresh([*vs, *ys])


class _WhileStep(_SubgraphStep):
    """The recorded step of a carried-only Loop with a dynamic condition or
    trip count (JAX's `lax.while_loop`): each iteration reads the body's
    condition on the host, so a tape holding it is not capturable. M (an int,
    or a device scalar read once a replay) is clamped to int32 as JAX
    clamps it. The counter is a view of a device arange, regrown (on the
    device) when a loop outruns it."""

    label = "Loop (a while loop: its condition read on the host)"

    def __init__(self, body: Tape, n_carried: int, iters: torch.Tensor):
        self.body, self.n_carried, self.iters = body, n_carried, iters

    def __call__(self, m, cond, true: torch.Tensor, vs: list, captured: list):
        if isinstance(m, torch.Tensor):
            m = int(m.reshape(-1)[0].item())
        m = min(m, _NO_BOUND)
        go = cond if isinstance(cond, bool) else bool(cond.reshape(-1)[0].item())
        i = 0
        while i < m and go:
            if i == self.iters.shape[0]:
                self.iters = torch.arange(2 * i, dtype=self.iters.dtype,
                                          device=self.iters.device)
            outs = self.body.replay([self.iters[i], true, *vs, *captured])
            go = bool(outs[0].reshape(-1)[0].item())
            vs = outs[1:1 + self.n_carried]
            i += 1
        return _fresh(vs)


class _SearchStep(_SubgraphStep):
    """The recorded step of a generative search node (ops/search_ops.py): the
    decoder's step sub-tape, walked once on device placeholders at the static
    buffer shapes (`GraphTracer.walk_body`), and the search loop, which
    replays it once a generated token (`loop(step, args)`, plain torch: the
    logits processors, the beam bookkeeping, the KV buffers' writes and
    reorders, a finished row frozen by `where`). The loop reads nothing on
    the host, so the step is capturable where its sub-tape is. It is not
    run while tracing (ops/search_ops._record)."""

    def __init__(self, body: Tape, loop: Callable, label: str):
        self.body, self.loop, self.label = body, loop, label

    @property
    def capturable(self) -> bool:
        return self.body.capturable

    def __call__(self, args: dict, captured: list):
        return self.loop(lambda feeds: self.body.replay([*feeds, *captured]), args)


def _bind(spec, out, vals: list) -> None:
    if isinstance(spec, _Slot):
        vals[spec.k] = out
    elif isinstance(spec, (tuple, list)):
        for s, o in zip(spec, out):
            _bind(s, o, vals)
    elif isinstance(spec, dict):
        for key, s in spec.items():
            _bind(s, out[key], vals)


@dataclass
class TraceState:
    device: torch.device
    strict: bool = False
    tape: Tape = field(default_factory=Tape)
    params: dict[str, torch.Tensor] = field(default_factory=dict)
    warned: set = field(default_factory=set)
    n_nodes: int = 0
    n_folded: int = 0
    # per-pattern fusion hit counts (observable via CompiledModel.stats)
    pattern_hits: dict[str, int] = field(default_factory=dict)
    # output names of the graph being walked (patterns must not consume
    # nodes whose outputs the graph exports)
    graph_outputs: frozenset = frozenset()
    # dynamic steps by what they compute (common-subexpression reuse)
    cse: dict = field(default_factory=dict)
    n_reused: int = 0
    compute: torch.dtype | None = None  # see the module docstring
    # a mesh's placement (parallel/placement.py): rule-sharded params and
    # the collectives at their consumers; None for one device
    placement: Any = None

    def hoist(self, name: str, v) -> torch.Tensor:
        """A static input of a dynamic node on the device: `to_device`, or
        under a placement this rank's shard of a rule-sharded param,
        gathered whole on the tape."""
        if self.placement is None:
            return self.to_device(name, v)
        return self.placement.hoist(self, name, v)

    def to_device(self, name: str, v) -> torch.Tensor:
        """A static value on the device, once per name (param hoisting)."""
        t = self.params.get(name)
        if t is None:
            t = to_torch(v).to(self.device)  # a copy: torch takes no read-only view
            if (self.compute is not None and t.dtype == torch.float32
                    and t.numel() >= PARAM_THRESHOLD):
                t = t.to(self.compute)
            self.params[name] = self.tape.const(t)
        return t

    def run(self, fn: Callable, *args, **kwargs):
        """Run and record one dynamic step (see Tape.run)."""
        return self.tape.run(fn, *args, **kwargs)


class GraphTracer:
    def __init__(
        self,
        model: OnnxModel,
        overrides: dict[str, Callable] | None = None,
        patterns: Sequence | None = None,
        strict: bool = False,
    ):
        self.model = model
        self.opset = model.opset
        self.overrides = overrides or {}
        from .patterns import DEFAULT_PATTERNS

        self.patterns = list(patterns) if patterns is not None else list(
            DEFAULT_PATTERNS)
        self.strict = strict

    # -- node execution ------------------------------------------------------

    def _emit(self, state: TraceState, node: Proto, env, scope: str, tag: str = ""):
        op_type = node.op_type
        dom = canon_domain(node.domain)
        if not dom:  # control flow belongs to the default operator set
            special = {"If": self._emit_if, "Loop": self._emit_loop,
                       "Scan": self._emit_scan,
                       "SequenceMap": self._emit_sequence_map}.get(op_type)
            if special is not None:
                return special(state, node, env, scope, tag)
        ins = [env[n] if n else None for n in node.input]
        label = f"{dom}::{op_type}" if dom else op_type
        emitter = self.overrides.get(label)
        opdef = lookup_op(dom, op_type)
        if emitter is None and opdef is not None:
            emitter = opdef.fn
        if emitter is None:
            if self.strict:
                hint = ""
                if dom and lookup_op("", op_type) is not None:
                    hint = (f" (a default-domain ai.onnx emitter named {op_type!r} exists "
                            "but the contrib schema differs: add a CONTRIB_OPS entry or a "
                            "CONTRIB_ALIASES row if the schemas coincide)")
                elif dom:
                    hint = (" (custom-domain op with no matching model-local function: "
                            "functions are inlined before tracing)")
                raise NotImplementedError(f"unsupported op {label} ({node.name}){hint}")
            if label not in state.warned:
                state.warned.add(label)
                print(f"Warning: unsupported op {label}; emitting empty tensor",
                      file=sys.stderr)
            outs = tuple(np.zeros((0,), np.float32) for _ in node.output)
            return outs if len(node.output) > 1 else outs[0]

        all_static = all(_is_static(v) for v in ins)
        subgraph = opdef is not None and opdef.subgraph
        if subgraph:
            # a search op walks its attribute graphs itself: never folded
            all_static = False
        # numpy cannot compute on fp8 bits (no ml_dtypes): such a node takes
        # the torch route on the host
        foldable = (opdef.foldable if opdef is not None else False) and not any(
            isinstance(v, Fp8Bits) for v in ins)
        state.n_nodes += 1
        if all_static and (foldable or ins):
            state.n_folded += 1
        overridden = label in self.overrides
        if opdef is not None and opdef.host and not overridden:
            # sequences and optionals: trace-time structure, no device step
            return emitter(make_ctx(torch, node, self.opset, self), *ins)
        if all_static and foldable:
            return _to_numpy(emitter(make_ctx(np, node, self.opset, self), *ins))
        if all_static and ins:
            # a non-foldable op on constants: evaluate it once with torch on
            # the host, and carry the result as a static value; its shape
            # arguments stay host values, as on the dynamic path
            static_pos = set(opdef.static_args) if opdef is not None else set()
            cpu_ins = [v if v is None or i in static_pos else to_torch(v)
                       for i, v in enumerate(ins)]
            return _to_numpy(emitter(make_ctx(torch, node, self.opset, self),
                                     *cpu_ins))
        # dynamic: static inputs go to the device (hoisted by name), except
        # shape-position arguments, which stay host-static for the emitter.
        # A recording emitter's static arguments are weights it prepares
        # itself; an override of it records as one step, so they are
        # hoisted for it (a host value in a step would be an upload a call)
        static_pos = (set(opdef.static_args)
                      if opdef is not None and not (opdef.records and overridden) else set())
        if state.placement is not None:  # a consumer of a rule-sharded param
            out = state.placement.emit(self, state, node, label, ins, scope, emitter,
                                       static_pos)
            if out is not NotImplemented:
                return out
        dyn_ins = []
        for i, v in enumerate(ins):
            if isinstance(v, TensorSeq):  # a sequence's static elements too
                v = TensorSeq(state.to_device(f"{scope}{node.input[i]}[{j}]", e)
                              if _is_static(e) and e is not None else e
                              for j, e in enumerate(v))
            if v is None or not _is_static(v) or i in static_pos:
                dyn_ins.append(v)
            else:
                dyn_ins.append(state.hoist(scope + node.input[i], v))
        # an override marked `records` records its own steps, as a recording
        # emitter does (the search ops' injected self-attention masks)
        records = ((opdef is not None and (opdef.records or subgraph) and not overridden)
                   or (overridden and getattr(emitter, "records", False)))
        ctx = make_ctx(torch, node, self.opset, self, state=state if records else None,
                       scope=scope)
        key = None
        if not overridden and not opdef.draws and not subgraph:  # builtins are pure
            try:
                key = (label, self.opset, len(node.output), _hashable(dyn_ins),
                       tuple(sorted((k, _hashable(v)) for k, v in ctx.attrs.items())))
            except TypeError:
                key = None
        if key is not None and key in state.cse:
            state.n_reused += 1
            return state.cse[key]
        out = emitter(ctx, *dyn_ins) if records else state.run(emitter, ctx, *dyn_ins)
        if key is not None:
            state.cse[key] = out
        return out

    def _emit_if(self, state: TraceState, node: Proto, env, scope: str, tag: str):
        cond = env[node.input[0]]
        attrs = {a.name: a for a in node.attribute}
        branches = {"then": attrs["then_branch"].g, "else": attrs["else_branch"].g}
        n_out = len(node.output)
        if_scope = scope + (node.name or f"If_{tag}")
        if _is_static(cond):  # resolved while tracing (Silero's sr checks)
            branch = branches["then" if bool(np.asarray(cond).reshape(-1)[0]) else "else"]
            sub = self._walk_graph(state, branch, ChainMap({}, env), if_scope + "/")
            return tuple(sub) if n_out > 1 else sub[0]

        tapes, outs = {}, {}
        parent, parent_cse = state.tape, state.cse
        for btag, g in branches.items():
            tape = Tape(parent)
            state.tape, state.cse = tape, dict(parent_cse)  # no reuse across branches
            try:
                sub = self._walk_graph(state, g, ChainMap({}, env), f"{if_scope}/{btag}/")
                sub = [state.to_device(f"{if_scope}/{btag}/out{j}", o) if _is_static(o) else o
                       for j, o in enumerate(sub)]
                tape.finish(sub)
            finally:
                state.tape, state.cse = parent, parent_cse
            tapes[btag], outs[btag] = tape, sub
        for a, b in zip(outs["then"], outs["else"]):
            if a.shape != b.shape or a.dtype != b.dtype:
                raise NotImplementedError(
                    f"If ({node.name}): its branches give {tuple(a.shape)} {a.dtype} and "
                    f"{tuple(b.shape)} {b.dtype}; a dynamic condition needs outputs of one "
                    "shape and type")
        taken = outs["then" if bool(cond.reshape(-1)[0].item()) else "else"]
        # new tensor objects: a branch may hand back an outer value itself
        out = tuple(t.view_as(t) for t in taken)
        parent.record(_IfStep(tapes["then"], tapes["else"]),
                      (cond, list(tapes["then"].captured), list(tapes["else"].captured)),
                      out)
        return out if n_out > 1 else out[0]

    def _emit_sequence_map(self, state: TraceState, node: Proto, env, scope: str, tag: str):
        """ONNX SequenceMap: the body once per sequence element, unrolled
        (JAX's form: the op maps over ragged sequences, which cannot be
        stacked). A sequence input gives each walk its element, any other
        input is passed whole."""
        body = next(a for a in node.attribute if a.name == "body").g
        ins = [env[n] for n in node.input if n]
        seq_lens = {len(v) for v in ins if isinstance(v, TensorSeq)}
        if not seq_lens:
            raise ValueError("SequenceMap requires at least one sequence input")
        if len(seq_lens) > 1:
            raise ValueError(f"SequenceMap sequence inputs disagree on length: "
                             f"{sorted(seq_lens)}")
        n_out = len(node.output)
        accs = [TensorSeq() for _ in range(n_out)]
        map_scope = scope + (node.name or f"SeqMap_{tag}")
        for i in range(seq_lens.pop()):
            benv = ChainMap({}, env)
            for vi, val in zip(body.input, ins):
                benv[vi.name] = val[i] if isinstance(val, TensorSeq) else val
            sub = self._walk_graph(state, body, benv, f"{map_scope}/{i}/")
            if len(sub) != n_out:
                raise ValueError(f"SequenceMap body yields {len(sub)} outputs, node "
                                 f"declares {n_out}")
            for acc, o in zip(accs, sub):
                acc.append(o)
        return tuple(accs) if n_out > 1 else accs[0]

    def walk_body(self, state: TraceState, body: Proto, env, scope: str, inputs,
                   where: str, cse: dict | None = None) -> tuple[Tape, list]:
        """Walk a loop body or a search step graph once onto a sub-tape.
        `inputs` are (body input name, value) pairs: each device tensor is a
        placeholder and becomes one of the sub-tape's inputs, in order (the
        outer values the body reads follow them, `Tape.captured`); a host
        value folds. CSE starts from the outer walk's table, or from `cse`
        (a search step passes {} so that it reads nothing of the prefill
        walk but the params), and is not shared back."""
        parent, parent_cse = state.tape, state.cse
        tape = Tape(parent)
        benv = ChainMap({}, env)
        for name, v in inputs:
            if isinstance(v, torch.Tensor):
                tape.input(v)
            benv[name] = v
        state.tape, state.cse = tape, dict(parent_cse) if cse is None else cse
        try:
            outs = self._walk_graph(state, body, benv, scope)
            _reject_optionals(where, outs)
            outs = [state.to_device(f"{scope}out{j}", o) if _is_static(o) else o
                    for j, o in enumerate(outs)]
            tape.finish(outs)
        finally:
            state.tape, state.cse = parent, parent_cse
        return tape, outs

    def _dev(self, state: TraceState, scope: str, name: str, v) -> torch.Tensor:
        return state.to_device(scope + name, v) if _is_static(v) else v

    def _emit_scan(self, state: TraceState, node: Proto, env, scope: str, tag: str):
        """ONNX Scan (state variables, scan inputs and outputs with their axes
        and directions): the body walked once on device placeholders (the
        initial states and the first slices, copied), then one `_ScanStep`
        that replays it a slice; its trace-time result is that replay on the
        outer walk's values."""
        attrs = {a.name: a for a in node.attribute}
        body = attrs["body"].g
        get = lambda k, d: parse_attr(attrs[k]) if k in attrs else d  # noqa: E731
        m = int(get("num_scan_inputs", 1))
        n_state = len(node.input) - m
        n_scan_out = len(node.output) - n_state
        axes = (get("scan_input_axes", [0] * m), get("scan_input_directions", [0] * m),
                get("scan_output_axes", [0] * n_scan_out),
                get("scan_output_directions", [0] * n_scan_out))
        states0 = [self._dev(state, scope, n, env[n]) for n in node.input[:n_state]]
        xs = [self._dev(state, scope, n, env[n]) for n in node.input[n_state:]]
        firsts = []
        for i, x in enumerate(xs):
            x = _scan_axis(x, axes[0], axes[1], i, to_front=True)
            firsts.append(x[0].clone() if x.shape[0] else x.new_zeros(x.shape[1:]))
        body_tape, _ = self.walk_body(
            state, body, env, scope + (node.name or f"Scan_{tag}") + "/",
            zip([vi.name for vi in body.input], [t.clone() for t in states0] + firsts),
            "Scan body outputs")
        step = _ScanStep(body_tape, n_state, *axes, device=state.device)
        outs = state.run(step, states0, xs, list(body_tape.captured))
        return outs if len(outs) > 1 else outs[0]

    @staticmethod
    def _body_is_pure_for(body: Proto) -> bool:
        """True when cond_out is Constant(true) or Identity of cond_in (a
        short chain): the loop can never exit early (JAX's test)."""
        cond_out_name = body.output[0].name
        cond_in_name = body.input[1].name if len(body.input) > 1 else ""
        name = cond_out_name
        for _ in range(4):
            if name == cond_in_name:
                return True
            producer = next((n for n in body.node if name in n.output), None)
            if producer is None:
                return False
            if producer.op_type == "Identity":
                name = producer.input[0]
                continue
            if producer.op_type == "Constant":
                for a in producer.attribute:
                    if a.name.startswith("value"):
                        return bool(np.asarray(parse_attr(a)).reshape(-1)[0])
            return False
        return False

    def _emit_loop(self, state: TraceState, node: Proto, env, scope: str, tag: str):
        """ONNX Loop, JAX's three lowerings (module docstring): a for-loop or
        the padded design over a static trip count M (`_LoopStep`,
        capturable), a host-read while loop for carried-only loops with a
        dynamic condition or M (`_WhileStep`), and scan outputs with no
        static bound: a warning and empty outputs, or a raise in strict
        mode."""
        body = next(a for a in node.attribute if a.name == "body").g
        n_carried = len(node.input) - 2
        n_scan = len(node.output) - n_carried
        m_in = env[node.input[0]] if node.input[0] else None
        cond_in = env[node.input[1]] if len(node.input) > 1 and node.input[1] else None
        v_init = [env[n] for n in node.input[2:]]
        _reject_optionals("Loop carried inputs", v_init)
        M = int(np.asarray(m_in)) if m_in is not None and _is_static(m_in) else None
        cond0 = (True if cond_in is None else
                 bool(np.asarray(cond_in).reshape(-1)[0]) if _is_static(cond_in) else None)
        if M is not None and M >= _NO_BOUND:
            M = None  # INT64_MAX: the exporters' while-loop, no static bound
        if cond0 is False:
            M = 0  # statically never runs: the inits, and [0, ...] scan outputs
        pure_for = cond0 is not None and (M == 0 or self._body_is_pure_for(body))
        if n_scan > 0 and M is None:
            if self.strict:
                raise NotImplementedError(
                    "Loop scan-outputs need a static trip-count bound M "
                    "(dynamic exits are fine: outputs are zero-padded to M)")
            if "Loop-scan" not in state.warned:
                state.warned.add("Loop-scan")
                print("Warning: Loop scan outputs without a static trip-count "
                      "bound unsupported; emitting empty", file=sys.stderr)
            outs = tuple(np.zeros((0,), np.float32) for _ in node.output)
            return outs if len(node.output) > 1 else outs[0]

        loop_scope = scope + (node.name or f"Loop_{tag}") + "/"
        dev = state.device
        vs0 = [self._dev(state, scope, n, v) for n, v in zip(node.input[2:], v_init)]
        true = state.tape.const(torch.ones((), dtype=torch.bool, device=dev))
        stepped = M is not None and (pure_for or n_scan > 0)
        # the counter: one device arange for the whole loop, made here (a
        # while loop's starts at one and grows as the loop runs)
        iters = state.tape.const(torch.arange(M if stepped else 1, dtype=torch.int64,
                                              device=dev))
        i0 = iters[0].clone() if len(iters) else iters.new_zeros(())
        body_tape, _ = self.walk_body(
            state, body, env, loop_scope,
            zip([vi.name for vi in body.input], [i0, true.clone()] + [v.clone() for v in vs0]),
            "Loop body outputs")
        captured = list(body_tape.captured)
        if stepped:
            if pure_for:
                step = _LoopStep(body_tape, n_carried, padded=False)
                outs = state.run(step, iters, true, vs0, captured)
            else:
                active = true if cond0 else self._dev(state, scope, node.input[1], cond_in)
                step = _LoopStep(body_tape, n_carried, padded=True)
                outs = state.run(step, iters, true, vs0, captured, active)
        else:
            m = M if M is not None else (
                min(int(np.asarray(m_in)), _NO_BOUND) if m_in is not None and _is_static(m_in)
                else m_in if m_in is not None else _NO_BOUND)
            # not run while tracing: on the placeholder inputs its exit may
            # never come, and its carries keep their shapes, so the inits
            # stand in for the walk's later shape arithmetic
            cond = cond0 if cond0 is not None else cond_in
            outs = tuple(v.clone() for v in vs0)
            state.tape.record(_WhileStep(body_tape, n_carried, iters),
                              (m, cond, true, vs0, captured), outs)
        return outs if len(outs) > 1 else outs[0]

    # -- graph walk ----------------------------------------------------------

    def _walk_graph(self, state: TraceState, graph: Proto, env, scope: str):
        for t in graph.initializer:
            env[t.name] = tensor_to_array(t, self.model.base_dir)
        nodes = list(graph.node)
        prev_outputs = state.graph_outputs
        state.graph_outputs = frozenset(vi.name for vi in graph.output)
        try:
            return self._walk_nodes(state, nodes, env, scope, graph)
        finally:
            state.graph_outputs = prev_outputs

    def _walk_nodes(self, state: TraceState, nodes, env, scope: str, graph):
        i = 0
        skipped: set[int] = set()  # nodes consumed by dataflow patterns
        while i < len(nodes):
            if i in skipped:
                i += 1
                continue
            consumed = 0
            for pattern in self.patterns:
                res = pattern(self, state, nodes, i, env, scope)
                if res is not None:
                    consumed, results = res
                    for out_name, val in results.items():
                        env[out_name] = val
                    name = getattr(pattern, "__name__", "pattern")
                    state.pattern_hits[name] = state.pattern_hits.get(name, 0) + 1
                    break
            if consumed:
                if isinstance(consumed, int):
                    i += consumed
                else:  # absolute indices, possibly non-contiguous
                    skipped.update(consumed)
                    skipped.add(i)
                continue
            node = nodes[i]
            try:
                out = self._emit(state, node, env, scope, tag=str(i))
            except Exception as e:
                # attach graph context once (innermost node wins)
                if not getattr(e, "_lele_node", None):
                    e._lele_node = True
                    e.add_note(
                        f"  while compiling node #{i} {node.op_type!r} "
                        f"(name={node.name!r}, inputs={list(node.input)}, "
                        f"outputs={list(node.output)})")
                raise
            outs = out if isinstance(out, tuple) else (out,)
            for name, val in zip(node.output, outs):
                if name:
                    env[name] = val
            i += 1
        return [env[vi.name] for vi in graph.output]

    # -- public API ----------------------------------------------------------

    def build(self, input_specs: dict[str, tuple[tuple, np.dtype]],
              device: torch.device | str,
              constants: dict[str, np.ndarray] | None = None,
              compute: torch.dtype | None = None, placement=None) -> TraceState:
        """Walk the graph once at the given static input signature on
        `device` and return the trace: its tape (inputs in
        `model.input_names()` order, outputs in graph order), its device
        params and its stats. Graph inputs named in `constants` are bound to
        those host values: they fold like initializers and are not inputs
        of the tape. `compute` is the module docstring's compute dtype: the
        tape then takes f32 inputs in that type. `placement`
        (parallel/placement.py) traces a mesh's rank: the inputs at this
        rank's rows, rule-sharded params as this rank's shards."""
        graph = self.model.graph
        constants = constants or {}
        in_names = [n for n in self.model.input_names() if n not in constants]
        for n in in_names:
            if n not in input_specs:
                raise ValueError(f"missing input spec for {n!r}")
        state = TraceState(device=torch.device(device), strict=self.strict, compute=compute,
                           placement=placement)
        env: dict[str, Any] = {"": None}
        env.update((n, np.asarray(v)) for n, v in constants.items())
        with torch.inference_mode():
            for n in in_names:
                shape, dt = input_specs[n]
                if placement is not None:
                    shape = placement.trace_shape(n, tuple(shape))
                tdt = torch_dtype(dt)
                if compute is not None and tdt == torch.float32:
                    tdt = compute
                env[n] = torch.zeros(tuple(shape), dtype=tdt, device=state.device)
                state.tape.input(env[n])
            # the model's directory resolves Constant attributes' side files
            with base_dir_scope(self.model.base_dir):
                outs = self._walk_graph(state, graph, env, "")
            if any(_is_static(o) and o is not None and np.asarray(o).dtype == object
                   for o in outs):
                raise NotImplementedError(
                    "a STRING tensor is a graph output: strings have no device "
                    "representation. Consume them inside the graph (RegexFullMatch, "
                    "StringSplit lengths, TfIdfVectorizer) so outputs are numeric.")
            state.tape.finish([
                state.to_device(f"::out{j}", o) if _is_static(o) else o
                for j, o in enumerate(outs)])
        self.stats = {
            "n_nodes": state.n_nodes,
            "n_folded": state.n_folded,
            "n_params": len(state.params),
            "param_bytes": int(sum(t.numel() * t.element_size()
                                   for t in state.params.values())),
            "pattern_hits": dict(state.pattern_hits),
            "n_steps": len(state.tape.steps),
            "n_reused": state.n_reused,
        }
        return state
