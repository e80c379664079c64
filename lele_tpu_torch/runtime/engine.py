"""CompiledModel: the runtime wrapper around one traced graph (counterpart of
lele_tpu/runtime/engine.py).

It holds the trace `GraphTracer.build` recorded: the device-resident params
(uploaded once) and the tape of dynamic steps. A call converts the inputs
to the spec's dtypes on the model's device, replays the tape, and returns
the graph outputs as device tensors.

A trace built with a compute dtype (JAX's `compute="bfloat16"`,
lele_tpu/runtime/engine.py:48-57, 95-105) stores its large f32 params in
that type; a call casts f32 inputs to it and returns outputs of that type
as f32, so the API stays f32 at the boundary.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

from ..ops.tensor_ops import torch_dtype


class CompiledModel:
    def __init__(self, trace, input_specs: dict[str, tuple[tuple, Any]],
                 input_order: Sequence[str], output_names: Sequence[str],
                 stats: dict | None = None):
        self.device = trace.device
        self.params: dict[str, torch.Tensor] = trace.params
        self.input_specs = input_specs
        self.input_order = list(input_order)
        self.output_names = list(output_names)
        self.stats = stats or {}
        self._tape = trace.tape
        self.compute = trace.compute
        self._dtypes = {n: torch_dtype(input_specs[n][1]) for n in self.input_order}
        if self.compute is not None:
            self._dtypes = {n: self.compute if d == torch.float32 else d
                            for n, d in self._dtypes.items()}

    def _prep(self, name: str, v) -> torch.Tensor:
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

    def __call__(self, *args, **kwargs) -> list[torch.Tensor]:
        if args:
            kwargs.update(dict(zip(self.input_order, args)))
        missing = [n for n in self.input_order if n not in kwargs]
        if missing:
            raise TypeError(f"missing model inputs {missing}; expected "
                            f"{self.input_order} (got {sorted(kwargs)})")
        inputs = [self._prep(n, kwargs[n]) for n in self.input_order]
        with torch.inference_mode():
            outs = self._tape.replay(inputs)
        if self.compute is not None:
            outs = [o.float() if isinstance(o, torch.Tensor) and o.dtype == self.compute
                    else o for o in outs]
        return outs

    def run_np(self, *args, **kwargs) -> list[np.ndarray]:
        return [o.cpu().numpy() for o in self(*args, **kwargs)]
