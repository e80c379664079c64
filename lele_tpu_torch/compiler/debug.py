"""Per-node profiling and debugging (the port's copy of
lele_tpu/compiler/debug.py): the graph run eagerly, one node at a time, on
the port's tracer, with each node's time, output shapes and a non-finite
flag — a dev tool for finding the node that makes NaNs or dominates a
graph, not for production timing (use torch.profiler on a compiled model,
utils/timing.profile_trace, for that).

On a card each node is timed by CUDA events after a synchronize; on the CPU
by the host clock. `device` defaults to the card and raises where there is
none.
"""

from __future__ import annotations

import time
from collections import defaultdict

import numpy as np
import torch

from .. import default_device
from ..onnx.loader import OnnxModel, base_dir_scope, tensor_to_array, to_torch
from .tracer import GraphTracer, TraceState, _to_numpy


def _start(model: OnnxModel, inputs: dict, device, patterns=None):
    device = torch.device(device) if device is not None else default_device()
    tracer = GraphTracer(model, patterns=patterns)
    state = TraceState(device=device)
    env: dict = {"": None}
    for n, v in inputs.items():
        env[n] = to_torch(np.asarray(v)).to(device)
        state.tape.input(env[n])
    return tracer, state, env


def _timed_emit(tracer, state, node, env, i: int):
    """One emit of node i → (outputs, ms). The reuse table is cleared first,
    so a repeat run of a node computes again instead of returning the last
    run's outputs."""
    state.cse.clear()
    on_card = state.device.type == "cuda"
    if on_card:
        torch.cuda.synchronize(state.device)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
    else:
        t0 = time.perf_counter()
    out = tracer._emit(state, node, env, "", tag=str(i))
    if on_card:
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)
    return out, (time.perf_counter() - t0) * 1000


def profile_nodes(model: OnnxModel, inputs: dict[str, np.ndarray], warmup: bool = True,
                  device: torch.device | str | None = None) -> list[dict]:
    """Run the graph eagerly, one node at a time (each twice with `warmup`,
    the second timed). Returns [{index, op_type, name, ms, out_shapes,
    nonfinite}] per node."""
    tracer, state, env = _start(model, inputs, device)
    graph = model.graph
    for t in graph.initializer:
        env[t.name] = tensor_to_array(t, model.base_dir)
    records = []
    with torch.inference_mode(), base_dir_scope(model.base_dir):
        for i, node in enumerate(graph.node):
            for _ in range(2 if warmup else 1):
                out, ms = _timed_emit(tracer, state, node, env, i)
            outs = out if isinstance(out, tuple) else (out,)
            nonfinite = False
            shapes = []
            for o in outs:
                if o is None:
                    continue
                shapes.append(tuple(np.shape(o)))
                if isinstance(o, torch.Tensor):
                    if o.numel() and o.is_floating_point():
                        nonfinite = nonfinite or not bool(torch.isfinite(o).all())
                else:
                    arr = np.asarray(o)
                    if arr.size and np.issubdtype(arr.dtype, np.floating):
                        nonfinite = nonfinite or not np.isfinite(arr).all()
            for name, val in zip(node.output, outs):
                if name:
                    env[name] = val
            records.append({"index": i, "op_type": node.op_type, "name": node.name,
                            "ms": ms, "out_shapes": shapes, "nonfinite": nonfinite})
    return records


def reference_eval(model: OnnxModel, inputs: dict[str, np.ndarray],
                   device: torch.device | str | None = None) -> dict[str, np.ndarray]:
    """Eager node-by-node evaluation → {output_name: np.ndarray}: no
    patterns and no capture, each node through its op emitter, so a
    compiled model (tracer + patterns + CUDA graph) can be held against a
    path that shares only the per-op semantics."""
    tracer, state, env = _start(model, inputs, device, patterns=[])
    graph = model.graph
    with torch.inference_mode(), base_dir_scope(model.base_dir):
        outs = tracer._walk_graph(state, graph, env, "")
    return {vi.name: _to_numpy(o) for vi, o in zip(graph.output, outs)}


def print_breakdown(records: list[dict], top: int = 15) -> None:
    """Aggregate per op class and print."""
    by_op = defaultdict(lambda: [0.0, 0])
    for r in records:
        by_op[r["op_type"]][0] += r["ms"]
        by_op[r["op_type"]][1] += 1
    total = sum(v[0] for v in by_op.values())
    print(f"{'op':24s} {'count':>5s} {'total ms':>9s} {'%':>6s}")
    for op, (ms, cnt) in sorted(by_op.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"{op:24s} {cnt:5d} {ms:9.3f} {100 * ms / total if total else 0:6.1f}")
    for r in records:
        if r["nonfinite"]:
            print(f"NONFINITE output at node #{r['index']} {r['op_type']} {r['name']!r}")
