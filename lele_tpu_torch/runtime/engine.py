"""CompiledModel: the runtime wrapper around one traced graph (counterpart of
lele_tpu/runtime/engine.py).

It holds the trace `GraphTracer.build` recorded: the device-resident params
(uploaded once) and the tape of dynamic steps. The JAX package jits the
whole walk into one program (with `donate_argnums` for streaming state) and
can `lower()` and `compile()` it ahead of a call; here the tape is captured
in one CUDA graph (runtime/graphs.py):

- `__call__` on a card replays the captured graph: the inputs are copied
  into its static buffers, the graph runs once, fresh outputs come back.
  The capture happens at the first call, or ahead of it with `compile()`.
- `donate=[names]`: each donated input's new value (the first output of
  its shape and dtype, as XLA aliases a donated buffer) is written back
  into its static buffer inside the graph; the call returns a copy that
  the caller owns, and that copy passed back unchanged into the next call
  is not copied in again (runtime/graphs.py).
- A tape that reads the host (an If with a dynamic condition,
  `Tape.capturable`) is routed by its structure to step-by-step replay;
  `stats["captured"]` says which route it took (False on the CPU, where
  nothing is captured).
- `replay()` is the step-by-step path: the oracle of the captured one.

A trace built over a mesh (JAX's `mesh`, `batch_axis`, `seq_axis` and
`param_rules`, lele_tpu/runtime/engine.py:27-30, 68-120) is one rank's
program: `_prep(name, x)` gives this rank's shard of an input (JAX's
`addressable_shards`), the params hold this rank's shards of the
rule-sharded ones, and a call is SPMD: every rank passes the whole host
input, runs its shard (seq-sharded inputs gathered over "seq" at the
entry) and gets back the whole output, gathered over "data" where it
depends on a data-sharded input (parallel/placement.py). An axis of size 1
issues no collective, so a one-rank mesh captures one CUDA graph as
without a mesh; a collective over gloo cannot be captured, so a tape that
holds one takes step-by-step replay.

A trace built with a compute dtype (JAX's `compute="bfloat16"`,
lele_tpu/runtime/engine.py:48-57, 95-105) stores its large f32 params in
that type; a call casts f32 inputs to it and returns outputs of that type
as f32, so the API stays f32 at the boundary.

`precision` (JAX's `compile_model(precision=)`) pins the precision of the
model's plain f32 products: every walk (the capture, an uncaptured replay,
an export) runs inside `config.precision_scope(precision)`, which sets
torch's TF32 flags and restores them after; None takes
`config.matmul_precision` at the walk.

AOT (JAX's `lower`, `save_aot`, `use_aot`, lele_tpu/runtime/engine.py:
182-229): `lower()` exports the walk as a `torch.export` program with the
params as inputs (compiler/aot.py); `save_aot(prefix)` writes it as the
`<prefix>.xc/` bundle with its kernel libraries and the model's signature
(runtime/artifact.py); `use_aot(prefix)` checks the bundle against this
process and model, hands its libraries to the build, and swaps the tape for
the loaded program (`ProgramTape`), which `compile()` then captures as
before; `CompiledModel.from_aot(prefix, params)` builds the model from the
bundle alone, without the graph or a trace.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

from ..config import check_precision, precision_scope
from ..ops.tensor_ops import torch_dtype
from .graphs import Program


class ProgramTape:
    """A loaded exported program in the place of a trace's tape: `replay`
    runs it on the model's current params (a host-free program, so it is
    capturable)."""

    capturable = True

    def __init__(self, cm: "CompiledModel", program, out_meta: list):
        from ..compiler.aot import program_call, signature

        self.program = program
        self.out_meta = out_meta
        self._call = program_call(program, cm.precision)
        self._cm = cm
        self._donated, self._rest = signature(cm)

    def replay(self, inputs) -> list:
        by = dict(zip(self._cm.input_order, inputs))
        return self._call(self._cm.params, [by[n] for n in self._donated],
                          [by[n] for n in self._rest])


class CompiledModel:
    def __init__(self, trace, input_specs: dict[str, tuple[tuple, Any]],
                 input_order: Sequence[str], output_names: Sequence[str],
                 stats: dict | None = None, donate: Sequence[str] = (),
                 precision: str | None = None):
        check_precision(precision)
        self.precision = precision
        self.device = trace.device
        self.placement = trace.placement
        self.mesh = None if trace.placement is None else trace.placement.mesh
        self.params: dict[str, torch.Tensor] = trace.params
        self.input_specs = input_specs
        self.input_order = list(input_order)
        self.output_names = list(output_names)
        self.stats = dict(stats or {})
        self._tape = trace.tape
        self.compute = trace.compute
        self._dtypes = {n: torch_dtype(input_specs[n][1]) for n in self.input_order}
        if self.compute is not None:
            self._dtypes = {n: self.compute if d == torch.float32 else d
                            for n, d in self._dtypes.items()}
        self.donated = self._match_donated(donate)
        if self.placement is not None:
            self._from_data = self.placement.outputs(self._tape, self.input_order,
                                                     self.output_names)
        self.stats["capturable"] = self._captures_structure()
        self.stats["captured"] = False
        self._program: Program | None = None

    def _match_donated(self, donate: Sequence[str]) -> dict[str, int]:
        """Each donated input → the index of its new value: the first output
        not yet taken whose shape and dtype are the input's."""
        out_meta = []
        for shape, dt in self._tape.out_meta:
            if self.compute is not None and dt == self.compute:
                dt = torch.float32
            out_meta.append((shape, dt))
        taken: dict[str, int] = {}
        for name in donate:
            if name not in self.input_order:
                raise ValueError(f"donate: {name!r} is not an input of the model "
                                 f"({self.input_order})")
            want = (tuple(self.input_specs[name][0]), self._dtypes[name])
            j = next((j for j, m in enumerate(out_meta)
                      if m == want and j not in taken.values()), None)
            if j is None:
                raise ValueError(f"donate: no output of {name!r}'s shape and type {want}")
            taken[name] = j
        return taken

    def _walk(self, inputs: Sequence[torch.Tensor]) -> list:
        """The tape on device inputs in input order (JAX `_walk_fn`): what a
        capture records, and what an outer program calls inside its own.
        Over a mesh the inputs are this rank's shards and the outputs whole."""
        pl = self.placement
        if pl is not None:
            inputs = [pl.enter(n, t) for n, t in zip(self.input_order, inputs)]
        with precision_scope(self.precision):
            outs = self._tape.replay(inputs)
        if pl is not None:
            outs = [pl.leave(o, d) for o, d in zip(outs, self._from_data)]
        if self.compute is not None:
            outs = [o.float() if isinstance(o, torch.Tensor) and o.dtype == self.compute
                    else o for o in outs]
        return outs

    def _prep(self, name: str, v) -> torch.Tensor:
        """An input on the device in its type, checked against the compiled
        shape; over a mesh, this rank's shard of it."""
        t = self._whole(name, v)
        return t if self.placement is None else self.placement.shard(name, t)

    def _whole(self, name: str, v) -> torch.Tensor:
        if isinstance(v, torch.Tensor):
            t = v.to(device=self.device, dtype=self._dtypes[name])
        else:
            t = torch.from_numpy(np.array(v, dtype=np.dtype(self.input_specs[name][1])))
            t = t.to(device=self.device, dtype=self._dtypes[name])
        shape = tuple(self.input_specs[name][0])
        if tuple(t.shape) != shape:
            raise ValueError(f"input {name!r} has shape {tuple(t.shape)}; this "
                             f"model was compiled for {shape}")
        return t

    def _ordered(self, args, kwargs) -> list:
        if args:
            kwargs.update(dict(zip(self.input_order, args)))
        missing = [n for n in self.input_order if n not in kwargs]
        if missing:
            raise TypeError(f"missing model inputs {missing}; expected "
                            f"{self.input_order} (got {sorted(kwargs)})")
        return [kwargs[n] for n in self.input_order]

    def replay(self, *args, **kwargs) -> list[torch.Tensor]:
        """The tape replayed step by step: the uncaptured oracle of `__call__`."""
        vals = self._ordered(args, kwargs)
        inputs = [self._prep(n, v) for n, v in zip(self.input_order, vals)]
        with torch.inference_mode():
            return self._walk(inputs)

    def _captures_structure(self) -> bool:
        return self._tape.capturable and (self.placement is None
                                          or self.placement.capturable)

    def _captures(self) -> bool:
        return self.device.type == "cuda" and self._captures_structure()

    def compile(self) -> "CompiledModel":
        """Capture the program ahead of the first call (JAX's `compile()`),
        on zero inputs; a no-op where nothing is captured."""
        if self._captures() and self._program is None:
            self(*(torch.zeros(tuple(self.input_specs[n][0]), dtype=self._dtypes[n],
                               device=self.device) for n in self.input_order))
        return self

    def _local_shape(self, name: str) -> tuple:
        shape = tuple(self.input_specs[name][0])
        if self.placement is None:
            return shape
        return tuple(self.placement.shard(name, torch.empty(shape, device="meta")).shape)

    def __call__(self, *args, **kwargs) -> list[torch.Tensor]:
        if not self._captures() or torch.cuda.is_current_stream_capturing():
            # step by step, or into a capture already running (an outer one
            # records the steps)
            return self.replay(*args, **kwargs)
        vals = self._ordered(args, kwargs)
        if self.placement is not None:  # this rank's shards
            vals = [self._prep(n, v) for n, v in zip(self.input_order, vals)]
        vals = [v if isinstance(v, (torch.Tensor, np.ndarray))
                else np.array(v, dtype=np.dtype(self.input_specs[n][1]))
                for n, v in zip(self.input_order, vals)]
        if self._program is None:
            examples = [torch.zeros(self._local_shape(n), dtype=self._dtypes[n])
                        for n in self.input_order]
            index = {n: i for i, n in enumerate(self.input_order)}
            self._program = Program(
                lambda *xs: tuple(self._walk(xs)), examples, self.device,
                donate={index[n]: j for n, j in self.donated.items()},
                pool=torch.cuda.graph_pool_handle(), name="CompiledModel")
        outs = list(self._program(*vals))
        self.stats["captured"] = self._program.graph is not None
        return outs

    def run_np(self, *args, **kwargs) -> list[np.ndarray]:
        return [o.cpu().numpy() for o in self(*args, **kwargs)]

    # -- AOT -------------------------------------------------------------------

    def lower(self):
        """This model's program as a `torch.export.ExportedProgram` of
        (params, donated, rest) (compiler/aot.py); ValueError for a tape
        that reads the host or a program over a mesh."""
        from ..compiler.aot import lower

        return lower(self)

    def aot_signature(self) -> dict:
        """What a bundle records of this model, to rebuild and to check it."""
        return {
            "input_order": self.input_order,
            "input_specs": {n: [list(self.input_specs[n][0]),
                                np.dtype(self.input_specs[n][1]).name]
                            for n in self.input_order},
            "output_names": self.output_names,
            "donate": list(self.donated),
            "compute": None if self.compute is None else str(self.compute)[6:],
            "precision": self.precision,
            "params": sorted(self.params),
            "out_meta": [[None if s is None else list(s), None if d is None else str(d)[6:]]
                         for s, d in self._tape.out_meta],
        }

    def save_aot(self, path_prefix) -> None:
        """Write <prefix>.xc/: the program, its kernel libraries and a
        manifest pinned to this torch, CUDA and card (runtime/artifact.py).
        The weights travel in the blob the CLI writes."""
        from .artifact import save_aot_bundle

        from ..compiler.aot import program_precision

        save_aot_bundle(path_prefix, self.lower(), extra={"model": self.aot_signature()},
                        precision=program_precision(self))

    def use_aot(self, path_prefix) -> "CompiledModel":
        """Run the bundle's program in place of the traced tape: raises
        (artifact.AotMismatch) where it was made for another torch, CUDA,
        card, kernel source or model signature."""
        from .artifact import AotMismatch, load_aot_program

        program, manifest = load_aot_program(path_prefix)
        mine = self.aot_signature()
        theirs = manifest.get("model", {})
        wrong = [k for k in mine if k != "out_meta" and theirs.get(k) != mine[k]]
        if wrong:
            raise AotMismatch(f"{path_prefix}: the bundle's model differs in {wrong}")
        self._tape = ProgramTape(self, program, self._tape.out_meta)
        self._program = None
        self.stats["aot"] = True
        return self

    @classmethod
    def from_aot(cls, path_prefix, params: dict[str, torch.Tensor],
                 manifest: dict | None = None) -> "CompiledModel":
        """The model of a bundle, from its program and signature alone (no
        graph, no trace), on `params` (by name, on the bundle's device);
        raises artifact.AotMismatch as `use_aot` does, ValueError where the
        params' names differ from the program's. `manifest`: the bundle's,
        already checked (artifact.check_aot_bundle)."""
        from types import SimpleNamespace

        from ..compiler.aot import program_device
        from .artifact import load_aot_program

        program, manifest = load_aot_program(path_prefix, manifest)
        m = manifest["model"]
        if sorted(params) != m["params"]:
            raise ValueError(f"{path_prefix}: params {sorted(params)[:8]}... are not the "
                             f"program's {m['params'][:8]}...")
        out_meta = [(None if s is None else tuple(s), None if d is None else getattr(torch, d))
                    for s, d in m["out_meta"]]
        device = program_device(program)
        trace = SimpleNamespace(device=device, placement=None, params=params,
                                tape=SimpleNamespace(out_meta=out_meta, capturable=True),
                                compute=None if m["compute"] is None
                                else getattr(torch, m["compute"]))
        specs = {n: (tuple(shape), np.dtype(dt)) for n, (shape, dt) in m["input_specs"].items()}
        cm = cls(trace, specs, m["input_order"], m["output_names"],
                 stats={"aot": True, "n_params": len(params)}, donate=m["donate"],
                 precision=m["precision"] or manifest.get("precision"))
        cm._tape = ProgramTape(cm, program, out_meta)
        return cm
