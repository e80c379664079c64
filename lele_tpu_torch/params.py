"""Weight carry-over between the JAX package and the port.

Torch cannot reproduce a `jax.random` initialisation, so the parity tests
build weights with `lele_tpu`, take them to numpy, and convert them here.
A param pytree is nested dicts and lists whose leaves are arrays; stacked
trees carry a leading layer axis on every leaf, per-layer trees a list
under ``"layers"``. Both convert the same way.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def array_to_tensor(a, device: torch.device | str = "cpu") -> torch.Tensor:
    """One numpy (or numpy-convertible) array → tensor on `device`, bit for bit.

    `np.asarray` of a JAX bf16 array has the ml_dtypes bfloat16 dtype, which
    `torch.from_numpy` rejects: it travels as its uint16 bit pattern and is
    viewed back as torch.bfloat16. int8 and int32 leaves keep their type."""
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device)


def tree_map(fn, tree):
    """Apply `fn` to every leaf of a dict/list pytree."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def from_numpy_tree(tree: Any, device: torch.device | str = "cpu") -> Any:
    """JAX param pytree with numpy (or JAX) leaves → the same tree of tensors."""
    return tree_map(lambda a: array_to_tensor(a, device), tree)
