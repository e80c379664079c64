"""Compiler front door: ONNX model → CompiledModel (counterpart of
lele_tpu/compiler/__init__.py).

`compile_model(model, input_shapes=..., patterns=None, device=None)` loads
(a path, bytes or an `OnnxModel`), inlines its local functions
(onnx/functions.py), pins the input signature, and traces the graph once on
the device (compiler/tracer.py). `patterns=None` takes the
default patterns (the fused SAN-M stack and the fused DQL GEMM);
`patterns=[]` gives the per-op path. `device` defaults to the card and
raises where there is none. `compute="bfloat16"` is the JAX package's
compute policy: large f32 params stored in bf16, f32 inputs cast to it, bf16
outputs returned as f32 (compiler/tracer.py). `donate=[input names]` is
JAX's donation (runtime/engine.py): on a card the model's captured CUDA
graph writes each such input's new value back into its static buffer.
`precision` ("default", "high" or "highest"; None takes
`config.matmul_precision` at each walk) pins the precision of the model's
plain f32 products and convs (config.py, runtime/engine.py); `strict=None`
takes `config.strict`. The compiled model exports (`cm.lower()`,
compiler/aot.py) and saves its AOT bundle (`cm.save_aot`). The JAX
package's image-stem option (a TPU lane layout) has no counterpart here.

`mesh` (a DeviceMesh over the default group's ranks, `parallel.make_mesh` or
`parallel.plan_mesh`) with `batch_axis`, `seq_axis` and `param_rules` is
JAX's placement (lele_tpu/compiler/__init__.py:239-242): every rank calls
`compile_model` and traces its own program, over its rows and its shards
of the rule-sharded params, with the collectives written out at their
consumers (parallel/placement.py). The device is then the mesh's: a CUDA
mesh's products run on the rank's card. Over a "data" axis each rank runs
its own rows, so a graph whose outputs do not carry its rows at
`batch_axis` is refused with ValueError.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Callable, Sequence

import numpy as np
import torch

from .. import default_device
from ..config import check_precision, config
from ..onnx.functions import inline_model
from ..onnx.loader import DTYPE_MAP, OnnxModel
from ..runtime.engine import CompiledModel
from .tracer import GraphTracer


class Compiler:
    def __init__(self):
        self._overrides: dict[str, Callable] = {}
        self._patterns: list | None = None
        self._strict: bool | None = None

    def with_override(self, op_type: str, fn: Callable) -> "Compiler":
        self._overrides[op_type] = fn
        return self

    def with_pattern(self, fn: Callable) -> "Compiler":
        """Prepend a pattern to the default list."""
        from .patterns import DEFAULT_PATTERNS

        if self._patterns is None:
            self._patterns = list(DEFAULT_PATTERNS)
        self._patterns.insert(0, fn)
        return self

    def with_patterns(self, patterns: Sequence) -> "Compiler":
        """Replace the pattern list ([] gives the per-op path)."""
        self._patterns = list(patterns)
        return self

    def with_strict(self, strict: bool | None = True) -> "Compiler":
        self._strict = strict
        return self

    def compile(self, model: OnnxModel | str | Path | bytes,
                input_shapes: dict[str, Sequence[int]] | None = None,
                dim_values: dict[str, int] | None = None,
                device: torch.device | str | None = None,
                compute: str | None = None, donate: Sequence[str] = (), mesh=None,
                batch_axis: int | None = None, seq_axis: int | None = None,
                param_rules=None, precision: str | None = None) -> CompiledModel:
        if compute not in (None, "bfloat16"):
            raise ValueError(f"compute={compute!r}: expected None or 'bfloat16'")
        check_precision(precision)
        if isinstance(model, (bytes, bytearray, memoryview)):
            model = OnnxModel.from_bytes(bytes(model))
        elif not isinstance(model, OnnxModel):
            model = OnnxModel.load(model)
        model = inline_model(model)  # local functions, flattened before tracing
        specs = resolve_input_specs(model, input_shapes, dim_values)
        placement = None
        if mesh is not None:
            from ..parallel.mesh import mesh_device
            from ..parallel.placement import Placement

            on = mesh_device(mesh)
            if device is not None and torch.device(device).type != on.type:
                raise ValueError(f"device={device!r} on a mesh of {mesh.device_type} ranks")
            device = on
            placement = Placement(mesh, model, specs, batch_axis, seq_axis, param_rules)
        device = torch.device(device) if device is not None else default_device()
        strict = config.strict if self._strict is None else self._strict
        tracer = GraphTracer(model, overrides=self._overrides,
                             patterns=self._patterns, strict=strict)
        trace = tracer.build(specs, device, compute=torch.bfloat16 if compute else None,
                             placement=placement)
        return CompiledModel(trace, specs, input_order=model.input_names(),
                             output_names=model.output_names(), stats=tracer.stats,
                             donate=donate, precision=precision)


def resolve_input_specs(
    model: OnnxModel,
    input_shapes: dict[str, Sequence[int]] | None = None,
    dim_values: dict[str, int] | None = None,
) -> dict[str, tuple[tuple, Any]]:
    """Static input signature from graph metadata + user overrides. Dynamic
    dims (dim_param or 0/-1) must be pinned via input_shapes (per input) or
    dim_values (per named dim)."""
    input_shapes = input_shapes or {}
    dim_values = dim_values or {}
    specs: dict[str, tuple[tuple, Any]] = {}
    for name, onnx_dt, dims in model.input_info():
        np_dt = DTYPE_MAP.get(onnx_dt, np.dtype(np.float32))
        if name in input_shapes:
            shape = tuple(int(d) for d in input_shapes[name])
        else:
            shape = []
            for d in dims:
                if isinstance(d, str):
                    if d not in dim_values:
                        raise ValueError(
                            f"input {name!r} has dynamic dim {d!r}; pass "
                            f"input_shapes={{{name!r}: (...)}} or "
                            f"dim_values={{{d!r}: N}}")
                    shape.append(int(dim_values[d]))
                elif d <= 0:
                    raise ValueError(f"input {name!r} has unknown dim; pass input_shapes")
                else:
                    shape.append(int(d))
            shape = tuple(shape)
        specs[name] = (shape, np_dt)
    return specs


def compile_model(
    model: OnnxModel | str | Path | bytes,
    input_shapes: dict[str, Sequence[int]] | None = None,
    dim_values: dict[str, int] | None = None,
    overrides: dict[str, Callable] | None = None,
    strict: bool | None = None,
    patterns: Sequence | None = None,
    device: torch.device | str | None = None,
    compute: str | None = None,
    donate: Sequence[str] = (),
    mesh=None,
    batch_axis: int | None = None,
    seq_axis: int | None = None,
    param_rules=None,
    precision: str | None = None,
) -> CompiledModel:
    c = Compiler()
    for k, v in (overrides or {}).items():
        c.with_override(k, v)
    if patterns is not None:
        c.with_patterns(patterns)
    return c.with_strict(strict).compile(model, input_shapes, dim_values, device, compute,
                                         donate, mesh, batch_axis, seq_axis, param_rules,
                                         precision)
