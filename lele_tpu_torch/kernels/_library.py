"""Each kernel wrapper as a registered `torch.library` op,
`lele_tpu_torch::<name>` (the names of `KERNEL_WRAPPERS`).

An op has three implementations: the CPU one is the kernel's plain
version, the CUDA one is the launch, and the fake one gives the output's
shape, dtype and strides without computing it (what `torch.export` and
`torch.compile` trace with). So a CUDA tensor reaches only the launch, by
the dispatcher's choice, and a traced program (`compiler/aot.py`) holds the
op as one node. Everything the launch does with real memory (`data_ptr`,
the 16-byte-row copies, the launch counts) stays inside the CUDA
implementation, where a fake tensor never reaches. No launch writes into a
tensor it was given, so no schema marks an argument as mutated.

The ops are defined and implemented through one `torch.library.Library`
fragment (`define` and `impl` per dispatch key, `register_fake`): a call
goes from the dispatcher straight to the implementation, without
`custom_op`'s Python layers, which cost about twice the host time a call
(scripts/torch_port_dispatch_probe.py). Ops are registered once, when
their kernel module is imported; nothing is built then.
"""

from __future__ import annotations

from typing import Callable

import torch

NAMESPACE = "lele_tpu_torch"
_LIB = torch.library.Library(NAMESPACE, "FRAGMENT")
_OPS: set[str] = set()


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def _own(outs, args):
    """Outputs of a plain version that share memory with an input (an empty
    stack returns x itself) are copied: an op's outputs never alias its
    inputs."""
    ins = set()
    for a in args:
        for t in (a if isinstance(a, (list, tuple)) else (a,)):
            if isinstance(t, torch.Tensor) and t.numel():
                ins.add(_storage(t))

    def fresh(t):
        return t.clone() if t.numel() and _storage(t) in ins else t

    if isinstance(outs, tuple):
        return tuple(fresh(t) for t in outs)
    return fresh(outs)


def register(name: str, schema: str, plain: Callable, launch: Callable, fake: Callable):
    """Define `lele_tpu_torch::<name>` with `schema`: `plain` for CPU
    tensors, `launch` for CUDA tensors, `fake` for fake and meta tensors.
    Returns the op's default overload, which the public wrapper calls."""
    if name not in _OPS:
        def cpu(*args):
            return _own(plain(*args), args)

        _LIB.define(name + schema)
        _LIB.impl(name, cpu, "CPU")
        _LIB.impl(name, launch, "CUDA")
        torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=_LIB)
        _OPS.add(name)
    return getattr(getattr(torch.ops, NAMESPACE), name).default
