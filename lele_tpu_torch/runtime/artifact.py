"""Prepared-parameter artifacts: a param tree ⇄ flat blob + manifest (the
port's copy of lele_tpu/runtime/artifact.py:30-140, in the same files).

Run the prepare passes (quantize, stack, pack) once, save the final tree
with `save_pytree`, and a fresh process maps the blob, rebuilds the tree
and moves it to the card in ONE host-to-device copy (`load_pytree`), the
counterpart of JAX's single `device_put`.

The blob is compiler/weights.py's format; the tree is nested dicts and
lists (tuples) of tensors or arrays. Leaf names are `f"{i:04d}:" + path`
with i the leaf's place in `jax.tree_util`'s flatten order, which sorts
dict keys and skips None, so a tree the JAX package saved loads here under
the same names, and the reverse. A `<prefix>.tree.json` holds each leaf's
key path to rebuild the tree.
"""

from __future__ import annotations

import json
from pathlib import Path

import torch

from .. import default_device
from ..compiler.weights import bin_path, entry_tensors, load_weights, read_manifest, save_weights

_TREE_SUFFIX = ".tree.json"


def _leaves(tree, keys: list):
    """(key path, leaf) in jax.tree_util's flatten order."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], keys + [["d", k]])
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, keys + [["l", i]])
    else:
        yield keys, tree


def _flatten_with_names(tree) -> list[tuple[str, object, list]]:
    """→ [(name, leaf, keys)]; the index prefix keeps names unique even if
    two key paths join to the same string (a dict key containing "/")."""
    return [(f"{i:04d}:" + ("/".join(str(k[1]) for k in keys) or "_root"), leaf, keys)
            for i, (keys, leaf) in enumerate(_leaves(tree, []))]


def save_pytree(path_prefix: str | Path, tree) -> None:
    """Writes <prefix>.bin + <prefix>.json + <prefix>.tree.json."""
    named = _flatten_with_names(tree)
    save_weights(path_prefix, {name: leaf for name, leaf, _ in named})
    Path(str(path_prefix) + _TREE_SUFFIX).write_text(json.dumps(
        {"leaves": [{"name": name, "keys": keys} for name, _, keys in named]}))


def _insert(root, keys, value):
    node = root
    for i, (kind, key) in enumerate(keys):
        last = i == len(keys) - 1
        if kind == "l":
            while len(node) <= key:
                node.append(None)
        if last:
            node[key] = value
        else:
            empty = [] if keys[i + 1][0] == "l" else {}
            if kind == "d":
                node = node.setdefault(key, empty)
            else:
                if node[key] is None:
                    node[key] = empty
                node = node[key]
    return root


def load_pytree(path_prefix: str | Path, device: torch.device | str | None = None):
    """Rebuild the saved tree on `device` (the card by default; "cpu" gives
    zero-copy views of the mapped blob). On a card the whole blob goes over
    in one host-to-device copy and each tensor is a view cut from it; a leaf
    the blob deduplicated, or dequantized, is a tensor of its own, so an
    in-place write to one leaf changes no other."""
    device = torch.device(device) if device is not None else default_device()
    if device.type == "cpu":
        flat = load_weights(path_prefix)
    else:
        manifest = read_manifest(path_prefix)
        path = bin_path(path_prefix)
        blob = torch.from_file(str(path), size=path.stat().st_size,
                               dtype=torch.uint8).to(device)
        flat = entry_tensors(blob, manifest)
    leaves = json.loads(Path(str(path_prefix) + _TREE_SUFFIX).read_text())["leaves"]
    if len(leaves) == 1 and leaves[0]["keys"] == []:
        return flat[leaves[0]["name"]]
    tree = [] if leaves and leaves[0]["keys"][0][0] == "l" else {}
    for e in leaves:
        _insert(tree, e["keys"], flat[e["name"]])
    return tree
