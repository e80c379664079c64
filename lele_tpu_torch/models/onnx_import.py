"""Import ONNX checkpoint weights into native model param trees (the port's
copy of lele_tpu/models/onnx_import.py): run a real checkpoint either by
compiling its ONNX graph (compiler.compile_model) or by mapping its
initializers onto the native architecture (models/).

The tree comes back with numpy leaves, as in the JAX package;
`params.from_numpy_tree(tree, device)` puts it on a device.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from ..onnx.loader import OnnxModel, tensor_to_array


def import_weights(
    model: OnnxModel,
    mapping: dict[str, str | tuple[str, Callable[[np.ndarray], np.ndarray]]],
    strict: bool = True,
) -> dict:
    """mapping: param path ("layers/0/qkv/w") → ONNX initializer name (or a
    Constant node's output), or (name, transform) where transform adapts the
    layout (ONNX linears are usually [out, in], the native ones [in, out]).

    Returns a nested param tree (lists for numeric path segments)."""
    flat: dict[str, np.ndarray] = {}
    missing = []
    for path, spec in mapping.items():
        name, transform = spec if isinstance(spec, tuple) else (spec, None)
        arr = model.initializer_array(name)
        if arr is None:
            t = model.find_constant_node_tensor(name)
            if t is not None:
                arr = tensor_to_array(t, model.base_dir)
        if arr is None:
            missing.append((path, name))
            continue
        if transform is not None:
            arr = transform(arr)
        flat[path] = np.ascontiguousarray(arr)
    if missing and strict:
        raise KeyError(f"initializers not found: {missing}")
    return _unflatten(flat)


def transpose2d(arr: np.ndarray) -> np.ndarray:
    """The common [out,in] → [in,out] linear-weight adapter."""
    return arr.T


def _unflatten(flat: dict):
    """{"a/0/w": leaf} → {"a": [{"w": leaf}]} (the JAX package's
    parallel/sharding.py `_unflatten`)."""
    root: dict = {}
    for path, leaf in flat.items():
        parts = path.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return _listify(root)


def _listify(node):
    if isinstance(node, dict):
        keys = list(node.keys())
        if keys and all(k.isdigit() for k in keys):
            return [_listify(node[str(i)]) for i in range(len(keys))]
        return {k: _listify(v) for k, v in node.items()}
    return node
