"""Process-wide configuration of the port (counterpart of lele_tpu/config.py).

The fields that have a meaning here:

- `matmul_precision`: the precision of the plain f32 products and convs
  ("highest", "high" or "default"), for every program that pins none
  (`compile_model(precision=)` pins one program's). On a card: "highest"
  is IEEE f32 (TF32 off in cuBLAS and cuDNN), "high" is TF32 in both, and
  "default", a single bf16 pass on the TPU, is TF32 too, because torch's
  CUDA backend has no bf16 pass for f32 operands (`PRECISION_FLAGS`). The
  hand-written kernels keep their own numerics, and the CPU stays f32 at
  every setting, as XLA:CPU does.
- `strict`: unknown ops raise instead of warning, where `compile_model`
  is given `strict=None`.
- `rng_seed`: the root of every Random op's stream
  (ops/tensor_ops.rng_key).

The JAX package's `index_dtype` and `float64_as` have no counterpart: the
port keeps int64 index outputs and float64 where ONNX gives them. Nor have
its `use_pallas_rnn` (False would send a card's LSTM and GRU directions
around kernels 6 and 9 to plain PyTorch) and `compute_dtype` (which it
defines and never reads).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch

PRECISIONS = ("default", "high", "highest")
# each precision's (cuBLAS TF32, cuDNN TF32) on a card
PRECISION_FLAGS = {"highest": (False, False), "high": (True, True),
                   "default": (True, True)}


@dataclass
class Config:
    matmul_precision: str = "highest"
    strict: bool = False
    rng_seed: int = 0


config = Config()

# the precisions pinned by the programs running now, innermost last
_pinned: list[str] = []


def current_precision() -> str:
    """The precision in force: the innermost running program's, else
    `config.matmul_precision`."""
    return _pinned[-1] if _pinned else config.matmul_precision


def cudnn_tf32() -> bool:
    """Whether a conv may take cuDNN's TF32 now (the emitters' and the
    models' `cudnn.flags` read it)."""
    return PRECISION_FLAGS[current_precision()][1]


def check_precision(precision: str | None) -> None:
    if precision is not None and precision not in PRECISIONS:
        raise ValueError(f"precision={precision!r}: expected one of {PRECISIONS}")


@contextlib.contextmanager
def precision_scope(precision: str | None = None):
    """Run a program at `precision` (None: `config.matmul_precision`): set
    torch's cuBLAS and cuDNN TF32 flags to its `PRECISION_FLAGS`, and
    restore them after, as the JAX package's walk restores its config.
    The flags are process-wide, so the scope holds runtime.graphs.CARD_LOCK
    (re-entrant) from the set to the restore: a walk on another thread
    waits, and never runs at this one's flags nor restores them out of
    order."""
    from .runtime.graphs import CARD_LOCK

    p = precision or config.matmul_precision
    check_precision(p)
    matmul, cudnn = PRECISION_FLAGS[p]
    with CARD_LOCK:
        old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn
        _pinned.append(p)
        try:
            yield p
        finally:
            _pinned.pop()
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
