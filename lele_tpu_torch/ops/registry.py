"""Op registry + emitter context (counterpart of lele_tpu/ops/registry.py).

An emitter runs one ONNX node. It is written once against ``ctx.xp``:
numpy when the tracer folds a node whose inputs are all static, torch when
the node is dynamic (its inputs are tensors on the model's device). Emitters
branch on ``ctx.is_fold`` only where the two libraries' names differ.

Dispatch precedence is the JAX package's: pattern rewrite → user override
→ builtin emitter → fallback (warning + zeros, or a raise in strict mode).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np

from ..onnx import schema, tensor_to_array
from ..onnx.schema import Proto

OPS: dict[str, "OpDef"] = {}  # default-domain (ai.onnx) emitters, by op_type

# non-default-domain emitters, keyed (domain, op_type): a contrib node only
# ever reaches its own domain's entry or a declared alias, never a
# same-named ai.onnx emitter with another schema
CONTRIB_OPS: dict[tuple[str, str], "OpDef"] = {}

# (domain, op_type) → the default-domain op_type whose schema coincides
# (inputs, attributes, semantics): curated, not inferred, as JAX's table
CONTRIB_ALIASES: dict[tuple[str, str], str] = {
    ("com.microsoft", "Gelu"): "Gelu",
    ("com.microsoft", "Trilu"): "Trilu",
    ("com.microsoft", "Range"): "Range",
}

_DEFAULT_DOMAINS = ("", "ai.onnx")


def canon_domain(domain: str | None) -> str:
    """'' and 'ai.onnx' both name the default operator set."""
    return "" if (domain or "") in _DEFAULT_DOMAINS else domain


@dataclass
class OpDef:
    name: str
    fn: Callable
    foldable: bool  # safe to evaluate with numpy at trace time
    # input positions that must stay host-static (shape/axes arguments); the
    # tracer never converts these to device values
    static_args: tuple = ()
    # the emitter records its own device steps through ctx.state, so it can
    # prepare static weights once at trace time (LSTM); the tracer does not
    # record it as one step
    records: bool = False
    # the emitter only restructures trace-time values (sequences, optionals:
    # ops/extra_ops.py) or makes a trace-time constant (the Random ops): the
    # tracer calls it once on its inputs as they are and records no step
    host: bool = False
    # the emitter draws from the node's own stream (Bernoulli, Multinomial):
    # two such nodes on the same inputs differ, so CSE never merges them
    draws: bool = False
    # the emitter walks its attribute graphs itself (BeamSearch, GreedySearch,
    # Sampling: ops/search_ops.py): it gets ctx.tracer, ctx.state and
    # ctx.scope, records its own steps, and is never folded or merged by CSE
    subgraph: bool = False


def op(name: str, foldable: bool = True, static_args: tuple = (), records: bool = False,
       domain: str = "", host: bool = False, draws: bool = False, subgraph: bool = False):
    d = canon_domain(domain)

    def deco(fn):
        od = OpDef(name, fn, foldable, static_args, records, host, draws, subgraph)
        if d:
            CONTRIB_OPS[(d, name)] = od
        else:
            OPS[name] = od
        return fn

    return deco


def lookup_op(domain: str | None, op_type: str) -> "OpDef | None":
    """The emitter of (domain, op_type): default-domain nodes hit OPS,
    contrib nodes their (domain, op_type) entry or a declared alias
    (`CONTRIB_ALIASES`), never a bare-name fallback."""
    d = canon_domain(domain)
    if not d:
        return OPS.get(op_type)
    od = CONTRIB_OPS.get((d, op_type))
    if od is not None:
        return od
    alias = CONTRIB_ALIASES.get((d, op_type))
    return OPS.get(alias) if alias is not None else None


def parse_attr(a: Proto) -> Any:
    t = a.type
    if t == schema.ATTR_INT:
        return int(a.i)
    if t == schema.ATTR_FLOAT:
        return float(a.f)
    if t == schema.ATTR_STRING:
        s = a.s
        if isinstance(s, memoryview):  # wire's >256B zero-copy fast path
            s = bytes(s)
        return s.decode() if isinstance(s, bytes) else s
    if t == schema.ATTR_INTS:
        return [int(v) for v in a.ints]
    if t == schema.ATTR_FLOATS:
        return [float(v) for v in a.floats]
    if t == schema.ATTR_TENSOR:
        return tensor_to_array(a.t)
    if t == schema.ATTR_GRAPH:
        return a.g
    if t == schema.ATTR_STRINGS:
        return [
            v.decode() if isinstance(v, (bytes, memoryview)) else v for v in a.strings
        ]
    if t == schema.ATTR_TENSORS:
        return [tensor_to_array(v) for v in a.tensors]
    if t == schema.ATTR_GRAPHS:
        return list(a.graphs)
    # untyped attribute (some exporters omit type): best effort
    if a.has("i"):
        return int(a.i)
    if a.has("f"):
        return float(a.f)
    if a.has("ints"):
        return [int(v) for v in a.ints]
    return None


@dataclass
class OpContext:
    """Per-node emitter context.

    xp      numpy (folding) or torch (a dynamic node)
    attrs   parsed node attributes
    opset   model's ai.onnx opset version (semantics switch per opset)
    node    the NodeProto wrapper
    tracer  the GraphTracer
    state   the TraceState, for an emitter that records its own steps
            (`records=True`, `subgraph=True`); None otherwise
    scope   the subgraph scope of the node's value names
    """

    xp: Any
    attrs: dict[str, Any]
    opset: int
    node: Proto | None = None
    tracer: Any = None
    state: Any = None
    scope: str = ""

    @property
    def is_fold(self) -> bool:
        return self.xp is np

    def attr(self, name: str, default: Any = None) -> Any:
        return self.attrs.get(name, default)

    def attr_ints(self, name: str, default=None) -> list[int] | None:
        v = self.attrs.get(name)
        if v is None:
            return default
        return [int(x) for x in v] if isinstance(v, (list, tuple)) else [int(v)]


def make_ctx(xp, node: Proto, opset: int, tracer=None, state=None,
             scope: str = "") -> OpContext:
    attrs = {a.name: parse_attr(a) for a in node.attribute}
    return OpContext(xp=xp, attrs=attrs, opset=opset, node=node, tracer=tracer,
                     state=state, scope=scope)


def host_const(ctx: OpContext, tag: str, arr: np.ndarray):
    """A host-built array for a recording emitter's step: a constant of the
    trace on the device (hoisted once, owned by the compiled model, so a
    call uploads nothing), or a host tensor where the node runs on
    constants (`ctx.state` is None)."""
    import torch

    if ctx.state is None:
        return torch.from_numpy(np.ascontiguousarray(arr))
    return ctx.state.to_device(f"{ctx.scope}{ctx.node.output[0]}/{tag}", arr)


def run_step(ctx: OpContext, fn: Callable, *args):
    """fn(*args) as a recording emitter's one step (at once on constants)."""
    return fn(*args) if ctx.state is None else ctx.state.run(fn, *args)


def static_ints(v, what: str = "value") -> list[int]:
    """Require a trace-time static integer vector (shapes, axes, ...)."""
    if v is None:
        raise ValueError(f"{what}: missing")
    if not isinstance(v, (np.ndarray, np.generic, int, list, tuple)):
        raise ValueError(f"{what} must be trace-time static, got a device value "
                         "(a runtime graph input); constant folding should "
                         "have resolved it")
    arr = np.asarray(v)
    if arr.dtype == object or not np.issubdtype(arr.dtype, np.number):
        raise ValueError(f"{what}: not numeric")
    return [int(x) for x in np.atleast_1d(arr)]
