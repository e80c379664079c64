"""AOT export: a compiled model's program as a `torch.export` program
(counterpart of lele_tpu/compiler/aot.py, which writes StableHLO).

`lower(cm)` exports the model's walk (`CompiledModel._walk`, the tape the
trace recorded) non-strict at the compiled input specs. The params are
lifted to inputs, so the program carries no weights: they travel in the
weights blob, as in the JAX package. Each hand-written kernel is one node
of its registered op (`lele_tpu_torch::<name>`, kernels/_library.py), so
the program launches the same kernels as the tape, and a capture of it
records them.

The program's signature is JAX's: `(params, donated, rest)`, with params a
dict by name in sorted order and donated and rest the inputs in graph order
(donated ones first). A tape that reads the host (a dynamic If, a while
loop: `Tape.capturable` is False) cannot be exported, nor can a program
compiled over a mesh: both raise ValueError, naming what stands in the way.

`export_model(cm, path)` writes the program to `<path>.pt2`
(`torch.export.save`); `load_exported(path)` → `call(params, donated,
rest)`, in a process that has imported the kernels (their ops are
registered then).

A program does not hold its precision: its products and convolutions read
torch's TF32 flags when they run, not when they were traced. So the
precision the model ran at (`program_precision`) is saved beside the
program (the `.pt2`'s extra file `precision`, the `.xc` manifest's key),
and every call of a loaded program runs inside `config.precision_scope` of
it, whatever the caller's flags are.
"""

from __future__ import annotations

from pathlib import Path

import torch

from ..config import config, precision_scope
from ..kernels import OP_STEMS
from ..kernels._library import NAMESPACE
from .tracer import first_uncapturable, substituted_constants


class _Walk(torch.nn.Module):
    """The model's walk as a module of (params, donated, rest)."""

    def __init__(self, cm, donated: list[str], rest: list[str]):
        super().__init__()
        self.cm, self.donated, self.rest = cm, donated, rest

    def forward(self, params: dict, donated: tuple, rest: tuple):
        cm = self.cm
        by = dict(zip(self.donated, donated)) | dict(zip(self.rest, rest))
        with substituted_constants({id(cm.params[k]): v for k, v in params.items()}):
            return cm._walk([by[n] for n in cm.input_order])


def signature(cm) -> tuple[list[str], list[str]]:
    """(donated input names, the other input names), each in graph order."""
    donated = [n for n in cm.input_order if n in cm.donated]
    return donated, [n for n in cm.input_order if n not in cm.donated]


def sorted_params(params: dict) -> dict:
    return {k: params[k] for k in sorted(params)}


def lower(cm) -> torch.export.ExportedProgram:
    """`cm`'s program, exported at its compiled input specs on its device."""
    if cm.placement is not None:
        raise ValueError("a program compiled over a mesh cannot be exported: each rank's "
                         "walk holds its shards and the collectives between them")
    program = getattr(cm._tape, "program", None)
    if program is not None:  # a model already running a loaded program
        return program
    blocker = first_uncapturable(cm._tape)
    if blocker is not None:
        raise ValueError(f"this model's tape reads the host, so it cannot be exported: "
                         f"{blocker}")
    donated, rest = signature(cm)

    def zeros(n):
        return torch.zeros(tuple(cm.input_specs[n][0]), dtype=cm._dtypes[n], device=cm.device)

    params = sorted_params(cm.params)
    with torch.no_grad():
        ep = torch.export.export(_Walk(cm, donated, rest),
                                 (params, tuple(zeros(n) for n in donated),
                                  tuple(zeros(n) for n in rest)), strict=False)
    ids = {id(t): k for k, t in cm.params.items()}
    leaked = sorted(ids[id(t)] for t in ep.constants.values() if id(t) in ids)
    if leaked:
        raise ValueError(f"params reached the program as constants, not inputs: {leaked[:8]}")
    return ep


def program_ops(ep: torch.export.ExportedProgram) -> list[str]:
    """The registered kernel ops the program calls, by name, sorted."""
    ops = set()
    for node in ep.graph.nodes:
        if node.op == "call_function":
            name = getattr(node.target, "name", lambda: "")()
            ns, _, op = name.partition("::")
            if ns == NAMESPACE:
                ops.add(op.split(".")[0])
    return sorted(ops)


def program_stems(ep: torch.export.ExportedProgram) -> list[str]:
    """The kernel sources (kernels/_build.py stems) the program launches."""
    return sorted({OP_STEMS[op] for op in program_ops(ep)})


def program_device(ep: torch.export.ExportedProgram) -> torch.device:
    """The device of the program's inputs: a card where any input lies on
    one (a lifted constant, such as a host scalar, does not count)."""
    from torch.export.graph_signature import InputKind

    user = {s.arg.name for s in ep.graph_signature.input_specs
            if s.kind == InputKind.USER_INPUT}
    devices = [n.meta["val"].device for n in ep.graph.nodes
               if n.op == "placeholder" and n.name in user
               and isinstance(n.meta.get("val"), torch.Tensor)]
    return next((d for d in devices if d.type == "cuda"), torch.device("cpu"))


PRECISION = "precision"  # the .pt2's extra file that holds the program's precision


def pt2_path(path: str | Path) -> Path:
    p = Path(path)
    return p if p.suffix == ".pt2" else p.with_name(p.name + ".pt2")


def program_precision(cm) -> str:
    """The precision `cm`'s walks run at now: its pinned one, else the
    process's (`config.matmul_precision`)."""
    return cm.precision or config.matmul_precision


def export_model(cm, path: str | Path) -> Path:
    """Write `cm`'s program, and the precision it runs at, to <path>.pt2;
    → the file's path."""
    out = pt2_path(path)
    torch.export.save(lower(cm), str(out), extra_files={PRECISION: program_precision(cm)})
    return out


def program_call(ep: torch.export.ExportedProgram, precision: str | None):
    """→ call(params, donated, rest) → list of outputs, over `ep`'s module,
    run at `precision` (None: `config.matmul_precision` at each call); host
    arrays go to the program's device."""
    mod = ep.module()
    device = program_device(ep)

    def on(v):
        return v if isinstance(v, torch.Tensor) else torch.as_tensor(v, device=device)

    def call(params: dict, donated=(), rest=()):
        with precision_scope(precision):
            return list(mod(sorted_params(params), tuple(on(v) for v in donated),
                            tuple(on(v) for v in rest)))

    call.program = ep
    call.precision = precision
    return call


def load_exported(path: str | Path):
    """→ callable(params_dict, donated_tuple, rest_tuple) → list of outputs,
    at the precision saved with the program."""
    extra = {PRECISION: ""}
    ep = torch.export.load(str(pt2_path(path)), extra_files=extra)
    return program_call(ep, extra[PRECISION] or None)
