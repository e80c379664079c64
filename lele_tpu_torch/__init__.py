"""lele_tpu_torch — the PyTorch/CUDA port of lele_tpu for one NVIDIA H100.

`lele_tpu` (JAX on a TPU) stays the reference; this package mirrors its
module layout and names, so each module here has a counterpart there:

- ``lele_tpu_torch.params``    JAX param pytree (numpy leaves) → torch tensors
- ``lele_tpu_torch.features``  audio front-end: framing, fbank, LFR, CMVN
- ``lele_tpu_torch.models``    SenseVoice w8a16 (the main path)
- ``lele_tpu_torch.kernels``   hand-written Hopper kernels (CUDA C++ under
                               ``csrc/``), each beside its plain PyTorch version
- ``lele_tpu_torch.serving``   ``SenseVoiceEngine``

A kernel wrapper takes its plain version only for a tensor that lies on the
CPU; for a CUDA tensor it launches the kernel or raises. Nothing here imports
jax.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def default_device() -> torch.device:
    """The first CUDA card when there is one, else the CPU."""
    return torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
