"""The persistent build cache (counterpart of lele_tpu/runtime/cache.py).

The JAX package persists XLA executables so that a model's second cold
start skips compilation. The port's compiled state is the kernel libraries
(kernels/_build.py): `enable_cache(path=None)` points their build
directory at `path`, or at `$LELE_CACHE_DIR`, or at the default
`lele_tpu_torch/_build/`, creates it and returns it. A read-only install
points it at a writable directory; the generated wrapper (cli.py) calls it,
as the JAX package's does.
"""

from __future__ import annotations

import os
from pathlib import Path


def enable_cache(path: str | Path | None = None) -> str:
    from ..kernels import _build

    cache_dir = Path(path or os.environ.get("LELE_CACHE_DIR") or _build.DEFAULT_BUILD_DIR)
    cache_dir.mkdir(parents=True, exist_ok=True)
    _build.BUILD_DIR = cache_dir
    return str(cache_dir)
