"""Training checkpoint and resume (counterpart of lele_tpu/train/checkpoint.py).

JAX writes orbax `step_{n}` directories; the port keeps the layout and
`latest_step`'s rule in its own format: `step_{n}/state` is
runtime/artifact.save_pytree's blob of {"params", "opt_state"} (the AdamW
moments and count, bit for bit), and `step_{n}/step.json` the step. It
does not read orbax's files. A tree of DTensors saves and restores each
rank's own shards: give each rank its own path.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any

import torch

from ..parallel.spmd import local_shard
from ..params import tree_map
from ..runtime.artifact import load_pytree, save_pytree


def _pairs(saved, like, where: str = ""):
    """(saved leaf, like leaf) pairs, matched by key path."""
    if isinstance(like, dict):
        if not isinstance(saved, dict) or set(saved) != set(like):
            raise ValueError(f"{where or 'the root'}: the saved keys differ from the target's")
        for k in like:
            yield from _pairs(saved[k], like[k], f"{where}/{k}")
    elif isinstance(like, (list, tuple)):
        if not isinstance(saved, (list, tuple)) or len(saved) != len(like):
            raise ValueError(f"{where}: the saved list differs from the target's")
        for i, (s, t) in enumerate(zip(saved, like)):
            yield from _pairs(s, t, f"{where}/{i}")
    else:
        yield where, saved, like


def save_train_state(path: str | Path, params: Any, opt_state: Any, step: int) -> None:
    d = Path(path).resolve() / f"step_{step}"
    d.mkdir(parents=True, exist_ok=True)
    with torch.no_grad():
        tree = tree_map(local_shard, {"params": params, "opt_state": opt_state})
    save_pytree(d / "state", tree)
    (d / "step.json").write_text(json.dumps({"step": int(step)}))


def latest_step(path: str | Path) -> int | None:
    path = Path(path)
    steps = [
        int(p.name.split("_", 1)[1])
        for p in path.glob("step_*")
        if p.name.split("_", 1)[1].isdigit()
    ]
    return max(steps) if steps else None


def restore_train_state(path: str | Path, params_like: Any, opt_state_like: Any,
                        step: int | None = None):
    """Restore (params, opt_state, step) into `*_like` (e.g. freshly
    initialized state), whose leaves give the structure, shapes, types and
    device; each like leaf is overwritten in place and the like trees are
    returned. A leaf that differs in shape or type raises."""
    path = Path(path).resolve()
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {path}")
    d = path / f"step_{step}"
    like = {"params": params_like, "opt_state": opt_state_like}
    saved = load_pytree(d / "state", device="cpu")
    with torch.no_grad():
        for where, src, dst in _pairs(saved, like):
            dst = local_shard(dst)
            if src.shape != dst.shape or src.dtype != dst.dtype:
                raise ValueError(f"{d}{where}: a saved {tuple(src.shape)} {src.dtype} leaf "
                                 f"restores into {tuple(dst.shape)} {dst.dtype}")
            dst.copy_(src)
    saved_step = json.loads((d / "step.json").read_text())["step"]
    return params_like, opt_state_like, int(saved_step)
