"""Supertonic flow-estimator blocks: counterpart of lele_tpu/kernels/est_block.py.

`estimator_blocks` replaces `estimator_blocks_pallas`
(lele_tpu/kernels/est_block.py:121, kernel 10): the vector estimator's 2L
attention blocks at batch 1, alternating self-attention over the latent
rows and cross-attention to the text memory (normalised with the block's
own norm1 weights), each followed by a tanh-GELU FFN, with bf16 products
and f32 sums, LN, softmax and GELU. The kernel is csrc/est_block.cu: one C
entry runs every block as a fixed sequence of launches on the current
stream, in place on one [T, D] f32 buffer (design and bounds in its source
note). Its range is `kernel_takes`.

`estimator_blocks_plain` is the same function in plain PyTorch, in the TPU
kernel's order of operations (`_kernel`, est_block.py:44-108): bf16-rounded
operands, f32 products and sums, the softmax of f32 scores normalised before
its probabilities are rounded to bf16. The wrapper takes it only for a CPU
tensor; for a CUDA tensor it launches the kernel or raises.
`estimator_blocks.launches` counts launches (one a call, whatever the
number of blocks; the C entry makes 8 kernel launches a self block and 9 a
cross block). The wrapper reads only shapes, dtypes and addresses, and
binds the C entry at its first call, so inside a captured program (the TTS
synth, one graph a bucket) the warm-up binds it and the capture records
the launches.

`stack_est_blocks` stacks the blocks' weights once, in the order self0,
cross0, self1, ... (`_stack_est_blocks`, est_block.py:111), with the
linear weights as bf16: JAX casts them on every call, to the same values.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build

_STEM = "est_block"
_fn = None
_LINEARS = ("q", "kv", "out", "ffn1", "ffn2")


def kernel_takes(T: int, Tk: int, D: int, n_heads: int, F: int) -> bool:
    """The kernel's stated range: head dim D / n_heads in {32, 64, 128}, D
    and F multiples of 64, any T >= 1 and Tk >= 1 (keys stream through
    shared memory in tiles). It covers examples/supertonic/tts.json and
    `SupertonicConfig()` (D 256, 4 heads, F 1,024) at every latent bucket
    (T <= 1,024) and token bucket (Tk <= 320)."""
    if n_heads < 1 or D % n_heads:
        return False
    return (D // n_heads in (32, 64, 128) and D % 64 == 0 and F > 0 and F % 64 == 0
            and T >= 1 and Tk >= 1)


def stack_est_blocks(blocks) -> dict:
    """[{"self": blk, "cross": blk}, ...] (models/supertonic `_init_attn_block`
    layout) → one tree of the same keys with a leading [2L] axis, blocks in
    the order self0, cross0, self1, ...; linear weights bf16 and contiguous,
    norms and biases f32."""
    flat = [b[kind] for b in blocks for kind in ("self", "cross")]
    out = {}
    for name in flat[0]:
        out[name] = {}
        for leaf in flat[0][name]:
            t = torch.stack([blk[name][leaf] for blk in flat])
            wide = name in _LINEARS and leaf == "w"
            out[name][leaf] = (t.to(torch.bfloat16) if wide else t.float()).contiguous()
    return out


def _ln(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor, eps: float = 1e-12):
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * g + b


def _bf(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _dot(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return _bf(a) @ _bf(w)


def estimator_blocks_plain(x: torch.Tensor, text_emb: torch.Tensor, latent_mask: torch.Tensor,
                           text_mask: torch.Tensor, stacked, n_heads: int) -> torch.Tensor:
    """x [T, D], text_emb [Tk, D], latent_mask [T], text_mask [Tk] (1 =
    valid), `stacked` from `stack_est_blocks` → f32 [T, D]. Needs
    allow_tf32 off on a card (PyTorch's default)."""
    x = x.float()
    text = text_emb.float()
    T, D = x.shape
    hd = D // n_heads
    inv = 1.0 / np.sqrt(hd)
    negs = ((latent_mask.float() - 1.0) * 1e9, (text_mask.float() - 1.0) * 1e9)
    for i in range(stacked["q"]["w"].shape[0]):
        p = {name: {leaf: v[i] for leaf, v in sub.items()} for name, sub in stacked.items()}
        g1, b1 = p["norm1"]["g"], p["norm1"]["b"]
        h = _ln(x, g1, b1)
        q = _dot(h, p["q"]["w"]) + p["q"]["b"]
        src = h if i % 2 == 0 else _ln(text, g1, b1)
        kvp = _dot(src, p["kv"]["w"]) + p["kv"]["b"]
        k, v = kvp[:, :D], kvp[:, D:]
        Tk = k.shape[0]
        qh = _bf(q).reshape(T, n_heads, hd).transpose(0, 1)
        kh = _bf(k).reshape(Tk, n_heads, hd).transpose(0, 1)
        vh = _bf(v).reshape(Tk, n_heads, hd).transpose(0, 1)
        s = (qh @ kh.transpose(-1, -2)) * inv + negs[i % 2]
        s = s - s.amax(dim=-1, keepdim=True)
        e = torch.exp(s)
        att = e / e.sum(dim=-1, keepdim=True)
        ctx = (_bf(att) @ vh).transpose(0, 1).reshape(T, D)
        x1 = x + (_dot(ctx, p["out"]["w"]) + p["out"]["b"])
        f1 = _dot(_ln(x1, p["norm2"]["g"], p["norm2"]["b"]), p["ffn1"]["w"]) + p["ffn1"]["b"]
        f1 = 0.5 * f1 * (1.0 + torch.tanh(0.7978845608028654 * (f1 + 0.044715 * f1 * f1 * f1)))
        x = x1 + (_dot(f1, p["ffn2"]["w"]) + p["ffn2"]["b"])
    return x


def _check(x, text_emb, latent_mask, text_mask, stacked):
    if x.dim() != 2 or text_emb.dim() != 2 or text_emb.shape[1] != x.shape[1]:
        raise ValueError(f"estimator_blocks: x must be [T, D] and text_emb [Tk, D], got "
                         f"{tuple(x.shape)} and {tuple(text_emb.shape)}")
    T, D = x.shape
    if latent_mask.numel() != T or text_mask.numel() != text_emb.shape[0]:
        raise ValueError(f"estimator_blocks: masks {tuple(latent_mask.shape)}, "
                         f"{tuple(text_mask.shape)} for T = {T}, Tk = {text_emb.shape[0]}")
    n = stacked["q"]["w"].shape[0]
    if n % 2 or tuple(stacked["q"]["w"].shape[1:]) != (D, D):
        raise ValueError(f"estimator_blocks: stacked q weights {tuple(stacked['q']['w'].shape)}"
                         f" for D = {D} (an even number of blocks, self then cross)")
    for t in (text_emb, latent_mask, text_mask, stacked["q"]["w"]):
        if t.device != x.device:
            raise ValueError("estimator_blocks: tensors on different devices")


def _f32_operand(t: torch.Tensor) -> torch.Tensor:
    """t as contiguous f32 on a 16-byte boundary (the kernel's vector loads)."""
    t = t.float().contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def estimator_blocks_kernel(x: torch.Tensor, text_emb: torch.Tensor, latent_mask: torch.Tensor,
                            text_mask: torch.Tensor, stacked, n_heads: int) -> torch.Tensor:
    """Launch csrc/est_block.cu on x's card and stream."""
    global _fn
    _check(x, text_emb, latent_mask, text_mask, stacked)
    T, D = x.shape
    Tk = text_emb.shape[0]
    n = stacked["q"]["w"].shape[0]
    F = stacked["ffn1"]["w"].shape[-1]
    if not kernel_takes(T, Tk, D, n_heads, F):
        raise ValueError(f"estimator_blocks_kernel: T={T}, Tk={Tk}, D={D}, heads={n_heads}, "
                         f"F={F} is outside the kernel's range (head dim 32/64/128, D and F "
                         "multiples of 64)")
    if not x.is_cuda:
        raise ValueError(f"estimator_blocks_kernel: x lies on {x.device}, not on a CUDA card")
    if _fn is None:
        P, I = _build.P, _build.I
        _fn = _build.bind(_STEM, "estimator_blocks", [P, P, P, P, I, I, I, I, I, I]
                          + [P] * 14 + [P] * 6 + [P])
    weights = []
    for name, leaf in (("norm1", "g"), ("norm1", "b"), ("q", "w"), ("q", "b"), ("kv", "w"),
                       ("kv", "b"), ("out", "w"), ("out", "b"), ("norm2", "g"),
                       ("norm2", "b"), ("ffn1", "w"), ("ffn1", "b"), ("ffn2", "w"),
                       ("ffn2", "b")):
        t = stacked[name][leaf]
        want = torch.bfloat16 if name in _LINEARS and leaf == "w" else torch.float32
        if t.dtype != want or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"estimator_blocks_kernel: stacked {name}.{leaf} must be "
                             f"contiguous {want} (build it with stack_est_blocks)")
        weights.append(t)
    out = x.float().contiguous().clone()
    text, lm, tm = (_f32_operand(t) for t in (text_emb, latent_mask, text_mask))
    dev = x.device

    def scratch(rows, cols):
        return torch.empty((rows, cols), dtype=torch.float32, device=dev)

    bufs = (scratch(T, D), scratch(Tk, D), scratch(T, D), scratch(max(T, Tk), 2 * D),
            scratch(T, D), scratch(T, F))
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = _fn(out.data_ptr(), text.data_ptr(), lm.data_ptr(), tm.data_ptr(), T, Tk, D,
               n_heads, F, n, *(t.data_ptr() for t in weights), *(b.data_ptr() for b in bufs),
               stream)
    _build.check(_STEM, "estimator_blocks", code)
    estimator_blocks.launches += 1
    return out


def estimator_blocks(x: torch.Tensor, text_emb: torch.Tensor, latent_mask: torch.Tensor,
                     text_mask: torch.Tensor, stacked, n_heads: int) -> torch.Tensor:
    """x f32 [T, D] (after the in/style/time/position projections), text_emb
    [Tk, D], latent_mask [T], text_mask [Tk], `stacked` from
    `stack_est_blocks` → f32 [T, D] after all 2L blocks."""
    if x.device.type == "cpu":
        _check(x, text_emb, latent_mask, text_mask, stacked)
        return estimator_blocks_plain(x, text_emb, latent_mask, text_mask, stacked, n_heads)
    return estimator_blocks_kernel(x, text_emb, latent_mask, text_mask, stacked, n_heads)


estimator_blocks.launches = 0
