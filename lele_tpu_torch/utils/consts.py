"""Device constants made once a process (positions, windows, index tables).

A function that caches such a tensor makes it inside `real_tensors()`:
while torch.export traces (compiler/aot.py, runtime/artifact.py) every
tensor made is a fake one, and a fake tensor kept in a cache would reach
every later call. Made real, the cached tensor is what a traced program
lifts as a constant and what every eager call and capture reads.
"""

from __future__ import annotations


def real_tensors():
    """A context in which tensors are real even inside a fake-tensor trace."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily

    return unset_fake_temporarily()
