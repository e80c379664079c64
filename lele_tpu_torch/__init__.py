"""lele_tpu_torch — the PyTorch/CUDA port of lele_tpu for one NVIDIA H100.

`lele_tpu` (JAX on a TPU) stays the reference; this package mirrors its
module layout and names, so each module here has a counterpart there:

- ``lele_tpu_torch.params``    JAX param pytree (numpy leaves) → torch tensors
- ``lele_tpu_torch.features``  audio front-end: framing, fbank, LFR, CMVN
- ``lele_tpu_torch.models``    SenseVoice w8a16/w4a16, Silero VAD,
                               Supertonic TTS and YOLO26 detect/segment, and
                               ``SenseVoiceOnnx`` / ``SileroOnnx`` /
                               ``SupertonicOnnx`` / ``YoloOnnx`` over
                               compiled ONNX graphs (``models.checkpoints``)
- ``lele_tpu_torch.onnx``      wire codec, loader, graph builder, SAN-M synth
- ``lele_tpu_torch.ops``       ONNX op emitters (numpy when folding, torch
                               on the device)
- ``lele_tpu_torch.compiler``  ``compile_model``: trace once, replay after
- ``lele_tpu_torch.runtime``   ``CompiledModel``, length bucketing
- ``lele_tpu_torch.kernels``   hand-written Hopper kernels (CUDA C++ under
                               ``csrc/``), each beside its plain PyTorch version
- ``lele_tpu_torch.serving``   ``SenseVoiceEngine``, ``Yolo26Engine``,
                               ``TtsEngine``
- ``lele_tpu_torch.utils``     CTC decoding, tokenizer, WAV IO, image
                               preprocessing

A kernel wrapper takes its plain version only for a tensor that lies on the
CPU; for a CUDA tensor it launches the kernel or raises. Entry points run on
the card; the CPU is taken only when the caller passes ``device="cpu"``.
Nothing here imports jax or the JAX package.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def default_device() -> torch.device:
    """The first CUDA card; raises where there is none (a caller that wants
    the CPU passes device="cpu" to the entry point)."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card found: the port runs on the card; pass "
                           "device='cpu' to run its plain versions on the CPU")
    return torch.device("cuda", 0)
