"""Several compiled ONNX models composed into one captured program
(counterpart of lele_tpu/runtime/compose.py).

A multi-model pipeline (Supertonic's four graphs and its flow loop) chained
from Python pays a dispatch, and on a card a graph replay, for every
sub-model call. Here the sub-models' tape walks (`CompiledModel._walk`) run
inside one pipeline function, which is captured as one CUDA graph for each
input signature (runtime/graphs.py): the intermediate tensors never leave
the card, and a Python loop over sub-model calls (the flow steps) is
unrolled into the graph, as JAX's jit inlines it.

Usage:
    pipe = compose_models(
        {"enc": cm_enc, "dec": cm_dec},
        lambda call, x: call("dec", h=call("enc", x=x)[0])[0],
    )
    out = pipe(x)                       # one graph replay
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .engine import CompiledModel
from .graphs import Programs, flatten, unflatten


def compose_models(models: dict[str, CompiledModel], pipeline: Callable):
    """pipeline(call, *args, **kwargs) → a tree of tensors; `call(name,
    **inputs)` runs sub-model `name` on its inputs and returns its output
    list. Returns fn(*args, **kwargs): the pipeline as one program for each
    signature (the inputs' shapes and dtypes), all in one memory pool. On
    the CPU the pipeline is called directly. `fn.params_bundle` holds each
    sub-model's params; `fn.uncaptured` calls the pipeline directly on the
    card (the captured program's oracle); `fn.programs` is the pool."""
    params_bundle = {name: cm.params for name, cm in models.items()}
    device = next(iter(models.values())).device
    programs = Programs(device)

    def call(name: str, **inputs):
        cm = models[name]
        missing = [n for n in cm.input_order if n not in inputs]
        if missing:
            raise ValueError(f"sub-model {name!r} missing inputs {missing}")
        return cm._walk([_cast(cm, n, inputs[n]) for n in cm.input_order])

    def on_device(tree):
        leaves, spec = flatten(tree)
        return unflatten(spec, [_to_device(v, device) for v in leaves])

    def run(args, kwargs):
        return pipeline(call, *args, **kwargs)

    def fn(*args, **kwargs):
        args, kwargs = on_device(args), on_device(kwargs)
        _, key = flatten((args, kwargs))
        return programs.run(key, lambda: run, args, kwargs, params=params_bundle)

    def uncaptured(*args, **kwargs):
        with torch.inference_mode():
            return run(on_device(args), on_device(kwargs))

    fn.params_bundle = params_bundle
    fn.uncaptured = uncaptured
    fn.programs = programs
    return fn


def _to_device(v, device: torch.device):
    """A leaf of the pipeline's inputs as a tensor on the models' device."""
    if isinstance(v, torch.Tensor):
        return v.to(device)
    return torch.as_tensor(np.asarray(v), device=device)


def _cast(cm: CompiledModel, name: str, v: torch.Tensor) -> torch.Tensor:
    """An input of sub-model `cm` in its compiled dtype (`CompiledModel._prep`
    without the host copy: inside a program the value is on the card)."""
    t = v.to(dtype=cm._dtypes[name])
    shape = tuple(cm.input_specs[name][0])
    if tuple(t.shape) != shape:
        raise ValueError(f"input {name!r} has shape {tuple(t.shape)}; this model was "
                         f"compiled for {shape}")
    return t
