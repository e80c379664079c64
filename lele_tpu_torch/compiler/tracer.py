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

- **A compute dtype** (`build(..., compute=torch.bfloat16)`, JAX's
  `compute="bfloat16"`): the walk runs on f32 inputs cast to it, and every
  hoisted f32 value of at least `PARAM_THRESHOLD` elements (the JAX tracer's
  bar for a runtime param; a smaller one stays a literal there) is stored in
  it. Smaller constants keep f32, so an f32 scalar promotes the value it
  meets, as under jnp (the binary emitters promote as jnp does).

Loop, Scan and SequenceMap raise NotImplementedError: no graph the port runs
has one yet.
"""

from __future__ import annotations

import functools
import sys
from collections import ChainMap
from dataclasses import dataclass, field
from typing import Any, Callable, Sequence

import numpy as np
import torch

from ..onnx.loader import OnnxModel, tensor_to_array
from ..onnx.schema import Proto
from ..ops import make_ctx
from ..ops.registry import canon_domain, lookup_op
from ..ops.tensor_ops import torch_dtype

_SUBGRAPH_OPS = ("Loop", "Scan", "SequenceMap")
# the JAX tracer's size bar for hoisting a static value to a runtime param;
# under a compute dtype only such params are stored in it
PARAM_THRESHOLD = 256


def _is_static(v) -> bool:
    return v is None or isinstance(v, (np.ndarray, np.generic))


def _hashable(v):
    """A value's identity for the CSE key: a device tensor by object (the
    trace keeps every one alive), a host value by content. Raises TypeError
    for what has no such identity (a subgraph attribute)."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
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
    if isinstance(out, torch.Tensor):
        return out.numpy()
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
    if isinstance(tree, list):
        return [_map(v, leaf) for v in tree]
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
        the host. The only such step is a dynamic If's (`_IfStep`), which
        reads its condition on every replay."""
        return not any(isinstance(st.fn, _IfStep) for st in self.steps)


def _step_name(st: _Step) -> str:
    """A recorded step by its function's name, and its node where an
    emitter recorded it (a pattern's launch has no node)."""
    fn = st.fn
    while isinstance(fn, functools.partial):
        fn = fn.func
    if isinstance(fn, _IfStep):
        return "If (a dynamic condition)"
    name = getattr(fn, "__qualname__", type(fn).__name__)
    node = getattr(st.args[0], "node", None) if st.args else None
    if node is not None:
        name += f" (node {node.op_type} {node.name!r})"
    return name


class _IfStep:
    """The recorded step of an If with a dynamic condition: both branches'
    sub-tapes; a replay reads the condition (one device → host read) and
    replays the branch it selects on that branch's captured values."""

    def __init__(self, then_tape: Tape, else_tape: Tape):
        self.then_tape, self.else_tape = then_tape, else_tape

    def __call__(self, cond: torch.Tensor, then_in: list, else_in: list):
        if bool(cond.reshape(-1)[0].item()):
            return tuple(self.then_tape.replay(then_in))
        return tuple(self.else_tape.replay(else_in))


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

    def to_device(self, name: str, v) -> torch.Tensor:
        """A static value on the device, once per name (param hoisting)."""
        t = self.params.get(name)
        if t is None:
            a = np.array(v)  # a writable copy: torch takes no read-only view
            t = torch.from_numpy(a).to(self.device) if a.dtype.name != "bfloat16" \
                else torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(self.device)
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
        if not dom and op_type == "If":
            return self._emit_if(state, node, env, scope, tag)
        if not dom and op_type in _SUBGRAPH_OPS:
            raise NotImplementedError(
                f"{op_type} ({node.name}): subgraph ops are not ported to the "
                "torch tracer yet")
        ins = [env[n] if n else None for n in node.input]
        label = f"{dom}::{op_type}" if dom else op_type
        emitter = self.overrides.get(label)
        opdef = lookup_op(dom, op_type)
        if emitter is None and opdef is not None:
            emitter = opdef.fn
        if emitter is None:
            if self.strict:
                raise NotImplementedError(f"unsupported op {label} ({node.name})")
            if label not in state.warned:
                state.warned.add(label)
                print(f"Warning: unsupported op {label}; emitting empty tensor",
                      file=sys.stderr)
            outs = tuple(np.zeros((0,), np.float32) for _ in node.output)
            return outs if len(node.output) > 1 else outs[0]

        all_static = all(_is_static(v) for v in ins)
        foldable = opdef.foldable if opdef is not None else False
        state.n_nodes += 1
        if all_static and (foldable or ins):
            state.n_folded += 1
        if all_static and foldable:
            return _to_numpy(emitter(make_ctx(np, node, self.opset, self), *ins))
        if all_static and ins:
            # a non-foldable op on constants: evaluate it once with torch on
            # the host, and carry the result as a static value
            cpu_ins = [None if v is None else torch.from_numpy(np.array(v))
                       for v in ins]
            return _to_numpy(emitter(make_ctx(torch, node, self.opset, self),
                                     *cpu_ins))
        # dynamic: static inputs go to the device (hoisted by name), except
        # shape-position arguments, which stay host-static for the emitter.
        # A recording emitter's static arguments are weights it prepares
        # itself; an override of it records as one step, so they are
        # hoisted for it (a host value in a step would be an upload a call)
        overridden = label in self.overrides
        static_pos = (set(opdef.static_args)
                      if opdef is not None and not (opdef.records and overridden) else set())
        dyn_ins = []
        for i, v in enumerate(ins):
            if v is None or not _is_static(v) or i in static_pos:
                dyn_ins.append(v)
            else:
                dyn_ins.append(state.to_device(scope + node.input[i], v))
        records = opdef is not None and opdef.records and not overridden
        ctx = make_ctx(torch, node, self.opset, self, state=state if records else None,
                       scope=scope)
        key = None
        if label not in self.overrides:  # builtin emitters are pure
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

    # -- graph walk ----------------------------------------------------------

    def _walk_graph(self, state: TraceState, graph: Proto, env, scope: str):
        for t in graph.initializer:
            env[t.name] = tensor_to_array(t)
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
              compute: torch.dtype | None = None) -> TraceState:
        """Walk the graph once at the given static input signature on
        `device` and return the trace: its tape (inputs in
        `model.input_names()` order, outputs in graph order), its device
        params and its stats. Graph inputs named in `constants` are bound to
        those host values: they fold like initializers and are not inputs
        of the tape. `compute` is the module docstring's compute dtype: the
        tape then takes f32 inputs in that type."""
        graph = self.model.graph
        constants = constants or {}
        in_names = [n for n in self.model.input_names() if n not in constants]
        for n in in_names:
            if n not in input_specs:
                raise ValueError(f"missing input spec for {n!r}")
        state = TraceState(device=torch.device(device), strict=self.strict, compute=compute)
        env: dict[str, Any] = {"": None}
        env.update((n, np.asarray(v)) for n, v in constants.items())
        with torch.inference_mode():
            for n in in_names:
                shape, dt = input_specs[n]
                tdt = torch_dtype(dt)
                if compute is not None and tdt == torch.float32:
                    tdt = compute
                env[n] = torch.zeros(tuple(shape), dtype=tdt, device=state.device)
                state.tape.input(env[n])
            outs = self._walk_graph(state, graph, env, "")
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
