"""Flash attention: counterpart of the TPU flash-attention route of
lele_tpu/ops/attention_ops.py (`_flash_attention_maybe`, line 34).

The JAX package routes an eligible ONNX Attention node to the library Pallas
TPU flash-attention kernel. `flash_attention` is the port's kernel with the
same contract, csrc/flash_attn.cu (design and bound in its source note):

- q [B, H, Lq, D], k and v [B, KVH, Lk, D], computed in f32, the result cast
  back to q's dtype; GQA (H a multiple of KVH) reads kv head h // (H / KVH)
  itself, with no repeated copy of k and v;
- an optional mask broadcastable to [B, H, Lq, Lk], added after scaling; a
  bool mask becomes 0 / -1e9 on this route (JAX's, attention_ops.py:83-86),
  not the einsum path's finfo.min. The TPU route pre-divides the mask by the
  scale only because the library kernel adds its bias before scaling; the
  function adds it after, and so does this kernel;
- causal only where Lq == Lk, top-left, combined with a mask where both are
  given.

`kernel_takes` is JAX's gate without its TPU test. `flash_attention_plain`
is the same function in plain f32 PyTorch: the oracle on the card (with
allow_tf32 off, PyTorch's default) and what the wrapper runs for a CPU
tensor. For a CUDA tensor the wrapper launches the kernel or raises;
`flash_attention.launches` counts launches, and after a launch
`flash_attention.last_visits` holds the key tiles each (batch row, head, q
tile) visited. `skippable_tiles` is the kernel's test for key tiles whose
every term is exactly 0, in plain float64 PyTorch: the tests and
chip_smoke.py's bound use it; the kernel computes its own.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build, _library

_STEM = "flash_attn"
BOOL_MASK_VALUE = -1e9  # a False entry of a bool mask on this route
TILE = 64  # the kernel's q and key tiles
_fn = None
_work_fn = None


def kernel_takes(q_shape, k_shape, *, is_causal: bool, has_mask: bool, scale: float,
                 softcap: float = 0.0, n_out: int = 1, mode: int = 0) -> bool:
    """JAX's flash gate (attention_ops.py:52-93) without the TPU test: no
    softcap, no qk tap (n_out < 4, mode 0), Lq and Lk multiples of 128,
    D % 8 == 0 and D >= 16, causal only where Lq == Lk, and a mask only with
    a non-zero scale. q_shape [B, H, Lq, D] and k_shape [B, H|KVH, Lk, D]."""
    if softcap or n_out >= 4 or mode:
        return False
    lq, d = int(q_shape[2]), int(q_shape[3])
    lk = int(k_shape[2])
    if lq % 128 or lk % 128 or d % 8 or d < 16:
        return False
    if is_causal and lq != lk:
        return False
    return not (has_mask and not scale)


def mask_bias(mask, shape) -> torch.Tensor | None:
    """The f32 additive bias of a bool or float mask, broadcast (stride 0)
    to shape [B, H, Lq, Lk]."""
    if mask is None:
        return None
    if mask.dtype == torch.bool:
        bias = torch.zeros(mask.shape, dtype=torch.float32, device=mask.device)
        bias.masked_fill_(~mask, BOOL_MASK_VALUE)
    else:
        bias = mask.float()
    return bias.reshape((1,) * (4 - bias.dim()) + tuple(bias.shape)).broadcast_to(shape)


def _check(q, k, v, mask, is_causal):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"flash_attention: q, k, v must be [B, H, L, D], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, H, Lq, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D or H % k.shape[1]:
        raise ValueError(f"flash_attention: k {tuple(k.shape)}, v {tuple(v.shape)} "
                         f"for q {tuple(q.shape)}")
    if is_causal and Lq != k.shape[2]:
        raise ValueError(f"flash_attention: causal needs Lq == Lk, got {Lq}, {k.shape[2]}")
    for t in (k, v) + (() if mask is None else (mask,)):
        if t.device != q.device:
            raise ValueError("flash_attention: tensors on different devices")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mask: torch.Tensor | None = None, is_causal: bool = False,
                          scale: float | None = None) -> torch.Tensor:
    """softmax(q k^T * scale + bias [+ causal]) v in f32, cast to q's dtype.
    Needs allow_tf32 off on a card (PyTorch's default)."""
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    scale = 1.0 / math.sqrt(D) if scale is None else float(scale)
    rep = H // k.shape[1]
    kf, vf = k.float(), v.float()
    if rep > 1:
        kf, vf = kf.repeat_interleave(rep, 1), vf.repeat_interleave(rep, 1)
    s = torch.matmul(q.float(), kf.transpose(-1, -2)) * scale
    bias = mask_bias(mask, (B, H, Lq, Lk))
    if bias is not None:
        s = s + bias
    if is_causal:
        keep = torch.ones((Lq, Lk), dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    return torch.matmul(torch.softmax(s, dim=-1), vf).to(q.dtype)


def _mask_heads(bias: torch.Tensor) -> torch.Tensor:
    """The bias without its broadcast batch and head axes (kept as size 1)."""
    for axis in (0, 1):
        if bias.stride(axis) == 0:
            bias = bias.narrow(axis, 0, 1)
    return bias


def skippable_tiles(q: torch.Tensor, k: torch.Tensor, mask: torch.Tensor | None,
                    is_causal: bool = False, scale: float | None = None,
                    tile: int = TILE) -> torch.Tensor:
    """[B, H, Lq / tile, Lk / tile] bool: the key tiles (of `tile` keys)
    whose every term exp(s - row max) is exactly 0 in f32 for every query
    row of the q tile, by csrc/flash_attn.cu's test, in float64: with rowmin
    the least over the q tile's rows of the row's largest bias (over the
    keys causal leaves), tmax the tile's largest bias, and S2 = |scale|
    max|q| (max|k| over the key tile + max|k| over the kv head),
        tmax + S2 + 105 + 1e-6 (|tmax| + |rowmin| + S2) < rowmin.
    Causal marks no tile past the diagonal (the kernel never visits them).
    `tile` = 1 gives the test of each (query, key) pair."""
    B, H, Lq, D = q.shape
    KVH, Lk = k.shape[1], k.shape[2]
    nq, nk = Lq // tile, Lk // tile
    if mask is None:
        return torch.zeros((B, H, nq, nk), dtype=torch.bool, device=q.device)
    scale = 1.0 / math.sqrt(D) if scale is None else float(scale)
    bias = _mask_heads(mask_bias(mask, (B, H, Lq, Lk))).double()
    allowed = bias
    if is_causal:
        keep = torch.ones((Lq, Lk), dtype=torch.bool, device=q.device).tril()
        allowed = bias.masked_fill(~keep, float("-inf"))
    rowmin = allowed.amax(-1).reshape(*bias.shape[:2], nq, tile).amin(-1)
    tmax = bias.reshape(*bias.shape[:2], nq, tile, nk, tile).amax((3, 5))
    qn = q.double().norm(dim=-1).reshape(B, H, nq, tile).amax(-1)
    kn = k.double().norm(dim=-1)
    k_all = kn.amax(-1, keepdim=True).repeat_interleave(H // KVH, 1)
    kn = kn.reshape(B, KVH, nk, tile).amax(-1).repeat_interleave(H // KVH, 1)
    s2 = 1.001 * abs(scale) * qn[..., :, None] * (kn + k_all)[..., None, :]
    tm = tmax.clamp(min=-1e30)
    lhs = tm + s2 + 105.0 + 1e-6 * (tm.abs() + rowmin.abs()[..., None] + s2)
    dead = lhs < rowmin[..., None]
    if is_causal:
        dead &= torch.ones((nq, nk), dtype=torch.bool, device=q.device).tril()
    return dead


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           mask: torch.Tensor | None = None, is_causal: bool = False,
                           scale: float | None = None) -> torch.Tensor:
    """Launch csrc/flash_attn.cu on q's card and stream."""
    global _fn
    if not q.is_cuda:
        raise ValueError(f"flash_attention_kernel: q lies on {q.device}, not on a CUDA card")
    _check(q, k, v, mask, is_causal)
    B, H, Lq, D = q.shape
    KVH, Lk = k.shape[1], k.shape[2]
    if Lq % 64 or Lk % 64 or D % 8:
        raise ValueError(f"flash_attention_kernel: Lq {Lq}, Lk {Lk}, D {D} is outside the "
                         "kernel's range (Lq, Lk multiples of 64, D % 8 == 0)")
    scale = 1.0 / math.sqrt(D) if scale is None else float(scale)
    global _work_fn
    if _fn is None:
        P, I, F, LL = _build.P, _build.I, _build.F, ctypes.c_longlong
        _fn = _build.bind(_STEM, "flash_attn",
                          [P, P, P, P, LL, LL, LL, LL, P, I, I, I, I, I, I, F, I, P, P])
        _work_fn = getattr(_build.library(_STEM), "flash_attn_work_bytes")
        _work_fn.argtypes = [I, I, I, I, I, I, I, I, LL, LL]
        _work_fn.restype = LL

    def operand(t):
        t = t.float().contiguous()
        return t if t.data_ptr() % 16 == 0 else t.clone()

    qf, kf, vf = operand(q), operand(k), operand(v)
    bias = mask_bias(mask, (B, H, Lq, Lk))
    strides, bias_ptr = (0, 0, 0, 0), None
    if bias is not None:
        strides, bias_ptr = bias.stride(), bias.data_ptr()
    causal = int(bool(is_causal))
    n_work = _work_fn(B, H, KVH, Lq, Lk, D, causal, int(bias is not None), strides[0],
                      strides[1])
    work = torch.empty((n_work // 4,), dtype=torch.int32, device=q.device)
    out = torch.empty((B, H, Lq, D), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = _fn(qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), bias_ptr, *strides, out.data_ptr(),
               B, H, KVH, Lq, Lk, D, scale, causal, work.data_ptr(), stream)
    _build.check(_STEM, "flash_attn", code)
    flash_attention.launches += 1
    flash_attention.last_visits = work[:B * H * (Lq // TILE)].view(B, H, Lq // TILE)
    return out.to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: torch.Tensor | None = None, is_causal: bool = False,
                    scale: float | None = None) -> torch.Tensor:
    """q [B, H, Lq, D], k and v [B, KVH, Lk, D], an optional bool or float
    mask broadcastable to [B, H, Lq, Lk] → [B, H, Lq, D] in q's dtype. Calls
    the registered op `lele_tpu_torch::flash_attn` (kernels/_library.py)."""
    return _OP(q, k, v, mask, bool(is_causal), None if scale is None else float(scale))


def _plain(q, k, v, mask, is_causal, scale):
    _check(q, k, v, mask, is_causal)
    return flash_attention_plain(q, k, v, mask, is_causal, scale)


_OP = _library.register(
    "flash_attn", "(Tensor q, Tensor k, Tensor v, Tensor? mask, bool is_causal, float? scale) "
    "-> Tensor", _plain, flash_attention_kernel, lambda q, *_: torch.empty_like(
        q, memory_format=torch.contiguous_format))
flash_attention.launches = 0
flash_attention.last_visits = None
