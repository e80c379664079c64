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

The AOT bundle (the counterpart of lele_tpu/runtime/artifact.py:124-295):
`save_aot_bundle(prefix, program, params)` writes `<prefix>.xc/`, a
deployment artifact pinned to the versions and the device that made it:

- `program.pt2`, a `torch.export` program (`export_program(fn, params,
  *args)` exports a function of (params, *args) with the params as inputs;
  `CompiledModel.lower` a compiled model's);
- the kernel libraries the program launches (`lib<stem>-<hash>.so` for
  `sm_90a`), copied from the build directory;
- `manifest.json`: the torch version, the CUDA version, the device
  (`device_kind`: "cpu" or the card's compute capability), each library's
  file name (which carries its source's hash), the precision the program
  runs at (a program does not hold it: its products read torch's TF32
  flags when they run) and what the caller adds;

and, with params, the params tree as `save_pytree` writes it.
`load_aot_bundle(prefix, params=True)` checks the manifest against this
process and checkout (`AotMismatch` on any difference), hands the libraries
to kernels/_build.py so that nothing is built, and loads the program on
this thread while the params come over to the card on a worker thread
(JAX's :261-295). → (callable(params, *args), params or None); each
call runs inside `config.precision_scope` of the manifest's precision.
"""

from __future__ import annotations

import json
import shutil
import threading
import time
from pathlib import Path

import torch

from .. import default_device
from ..compiler.weights import bin_path, entry_tensors, load_weights, read_manifest, save_weights
from ..config import check_precision, current_precision, precision_scope

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


def load_flat(path_prefix: str | Path, device: torch.device | str | None = None
              ) -> dict[str, torch.Tensor]:
    """A weights blob (compiler/weights.py) as {name: tensor} on `device`
    (the card by default): on a card in one host-to-device copy of the
    whole blob, each tensor a view cut from it (a deduplicated or
    dequantized entry a tensor of its own); on the CPU zero-copy views of
    the mapped blob."""
    device = torch.device(device) if device is not None else default_device()
    if device.type == "cpu":
        return load_weights(path_prefix)
    manifest = read_manifest(path_prefix)
    path = bin_path(path_prefix)
    blob = torch.from_file(str(path), size=path.stat().st_size, dtype=torch.uint8).to(device)
    return entry_tensors(blob, manifest)


def load_pytree(path_prefix: str | Path, device: torch.device | str | None = None):
    """Rebuild the saved tree on `device` (the card by default; "cpu" gives
    zero-copy views of the mapped blob). On a card the whole blob goes over
    in one host-to-device copy and each tensor is a view cut from it; a leaf
    the blob deduplicated, or dequantized, is a tensor of its own, so an
    in-place write to one leaf changes no other."""
    flat = load_flat(path_prefix, device)
    leaves = json.loads(Path(str(path_prefix) + _TREE_SUFFIX).read_text())["leaves"]
    if len(leaves) == 1 and leaves[0]["keys"] == []:
        return flat[leaves[0]["name"]]
    tree = [] if leaves and leaves[0]["keys"][0][0] == "l" else {}
    for e in leaves:
        _insert(tree, e["keys"], flat[e["name"]])
    return tree


# --- AOT bundle -------------------------------------------------------------

_XC_SUFFIX = ".xc"
PROGRAM = "program.pt2"
MANIFEST = "manifest.json"


class AotMismatch(ValueError):
    """The bundle was made for other versions, another device or other
    kernel sources than this process and checkout have."""


def xc_dir(path_prefix: str | Path) -> Path:
    return Path(str(path_prefix) + _XC_SUFFIX)


def canonical(tree):
    """The tree as `load_pytree` rebuilds it: dict keys in sorted order,
    tuples as lists (the exported program's input spec is this form)."""
    if isinstance(tree, dict):
        return {k: canonical(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [canonical(v) for v in tree]
    return tree


class _Fn(torch.nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, params, *args):
        return self.fn(params, *args)


def export_program(fn, params, *args) -> torch.export.ExportedProgram:
    """fn(params, *args) exported non-strict, the params (in `canonical`
    form) lifted to inputs: the program carries no weights."""
    with torch.no_grad():
        return torch.export.export(_Fn(fn), (canonical(params), *args), strict=False)


def device_kind(device: torch.device | str) -> str:
    """"cpu", or a card's compute capability ("sm_90")."""
    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    major, minor = torch.cuda.get_device_capability(device)
    return f"sm_{major}{minor}"


def save_aot_bundle(path_prefix: str | Path, program: torch.export.ExportedProgram,
                    params=None, extra: dict | None = None,
                    precision: str | None = None) -> Path:
    """Write <prefix>.xc/ (the program, its kernel libraries, the manifest
    with `extra` merged in) and, with params, the params tree. `precision`:
    what the program runs at, None for the one in force now
    (`config.current_precision`, where the program was exported). → the
    bundle's directory."""
    from ..compiler.aot import program_device, program_stems
    from ..kernels import _build

    out = xc_dir(path_prefix)
    out.mkdir(parents=True, exist_ok=True)
    torch.export.save(program, str(out / PROGRAM))
    device = program_device(program)
    libs = {}
    if device.type == "cuda":  # a CPU program runs the plain versions
        for stem in program_stems(program):
            src = _build.library_path(stem)
            if not src.exists():
                _build.build([stem])
            shutil.copyfile(src, out / src.name)
            libs[stem] = src.name
    precision = precision or current_precision()
    check_precision(precision)
    manifest = {"torch": torch.__version__, "cuda": torch.version.cuda,
                "device": device_kind(device), "libraries": libs, "precision": precision,
                **(extra or {})}
    (out / MANIFEST).write_text(json.dumps(manifest, indent=1))
    if params is not None:
        save_pytree(path_prefix, params)
    return out


def check_aot_bundle(path_prefix: str | Path) -> dict:
    """The bundle's manifest, checked against this process and checkout:
    raises AotMismatch where the torch or CUDA version, the device kind or
    a kernel source differs."""
    from ..kernels import _build

    out = xc_dir(path_prefix)
    try:
        manifest = json.loads((out / MANIFEST).read_text())
    except FileNotFoundError as e:
        raise AotMismatch(f"{out}: no AOT bundle ({e})") from None
    have = {"torch": torch.__version__, "cuda": torch.version.cuda}
    kind = manifest.get("device")
    if kind == "cpu":
        have["device"] = "cpu"
    elif torch.cuda.is_available():
        have["device"] = device_kind(torch.device("cuda", torch.cuda.current_device()))
    else:
        have["device"] = "no CUDA card"
    wrong = [f"{k}: bundle {manifest.get(k)!r}, here {v!r}" for k, v in have.items()
             if manifest.get(k) != v]
    wrong += [f"{stem}: bundle {name}, this checkout {_build.lib_name(stem)}"
              for stem, name in manifest.get("libraries", {}).items()
              if name != _build.lib_name(stem)]
    if wrong:
        raise AotMismatch(f"{out} was made elsewhere: " + "; ".join(wrong))
    return manifest


def load_aot_program(path_prefix: str | Path, manifest: dict | None = None
                     ) -> tuple[torch.export.ExportedProgram, dict]:
    """Check the bundle (unless given its checked manifest), hand its
    libraries to kernels/_build.py, and load its program: → (program,
    manifest)."""
    from ..kernels import _build

    manifest = manifest or check_aot_bundle(path_prefix)
    out = xc_dir(path_prefix)
    _build.provide({stem: out / name for stem, name in manifest["libraries"].items()})
    return torch.export.load(str(out / PROGRAM)), manifest


def load_aot_bundle(path_prefix: str | Path, params: bool = True):
    """→ (callable(params, *args), params tree or None). The params load on
    a worker thread, in one copy to the bundle's device, while the program
    loads here; `callable.load_s` holds the host seconds until each half
    was ready."""
    manifest = check_aot_bundle(path_prefix)
    device = "cpu" if manifest["device"] == "cpu" else torch.device(
        "cuda", torch.cuda.current_device())
    box: dict = {}
    t = None
    t0 = time.perf_counter()
    if params:
        def _params():
            try:
                box["p"] = load_pytree(path_prefix, device=device)
                if torch.device(device).type == "cuda":
                    torch.cuda.synchronize(device)
                box["params_s"] = time.perf_counter() - t0
            except BaseException as e:  # re-raised on the caller's thread
                box["err"] = e

        t = threading.Thread(target=_params, name="aot-params")
        t.start()
    try:
        program, _ = load_aot_program(path_prefix, manifest)
        mod = program.module()
        program_s = time.perf_counter() - t0
    finally:
        if t is not None:
            t.join()
    if "err" in box:
        raise box["err"]

    precision = manifest.get("precision")

    def call(p, *args):
        with precision_scope(precision):
            return mod(canonical(p), *args)

    call.program = program
    call.precision = precision
    # host seconds from the call's start until each half was ready
    call.load_s = {"program": program_s, "params": box.get("params_s"),
                   "total": time.perf_counter() - t0}
    return call, box.get("p")
