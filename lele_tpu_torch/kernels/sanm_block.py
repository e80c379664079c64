"""SAN-M encoder layer, w8a16: counterpart of lele_tpu/kernels/sanm_block.py.

Replaces two TPU kernels:

- `sanm_layer_w8` ← `sanm_layer_w8_pallas` (lele_tpu/kernels/sanm_block.py:110):
  one layer, LN1 → w8 qkv → FSMN over V·mask + per-head attention → w8 out
  + residual → LN2 → w8 FFN (ReLU) + residual.
- `sanm_stack_w8` ← `sanm_stack_w8_pallas` (lele_tpu/kernels/sanm_block.py:229):
  all L layers at batch 1.

The kernel is csrc/sanm_layer.cu: one C entry runs a layer as seven
launches on the current stream (design and what bounds it on the H100 are
in that file). The stack loops over the layers in Python on per-layer
pointers into the stacked [L, ...] weights (no copies), with the activation
in one preallocated [T, D] f32 buffer that every layer updates in place.
The TPU kernel's weight prefetch across layers is not ported yet.

The plain versions follow the JAX jnp block (models/sensevoice.py:321-397)
with the kernel's numerics: bf16-rounded operands, f32 sums, masked keys
replaced by -1e9, the FSMN written as shifted adds (no cuDNN conv, so no
TF32 on a card). A wrapper takes its plain version only for a CPU tensor;
for a CUDA tensor it launches the kernel or raises. `sanm_layer_w8.launches`
counts layer launches (a stack of L layers adds L), `sanm_stack_w8.launches`
counts stack calls.
"""

from __future__ import annotations

import math

import torch

from ..params import tree_map
from . import _build
from .quant_matmul import w8_matmul_plain

_STEM = "sanm_layer"
_HEAD_DIMS = (32, 64, 128)  # compiled in csrc/sanm_layer.cu
_FSMN_KMAX = 16  # csrc/sanm_layer.cu FSMN_KMAX
_fn = None

# the kernel's per-layer operands, in the C entry's order
_LEAVES = (
    ("norm1", "g"), ("norm1", "b"),
    ("qkv", "wq8"), ("qkv", "ws8"), ("qkv", "b"),
    ("fsmn", "w"),
    ("out", "wq8"), ("out", "ws8"), ("out", "b"),
    ("norm2", "g"), ("norm2", "b"),
    ("ffn1", "wq8"), ("ffn1", "ws8"), ("ffn1", "b"),
    ("ffn2", "wq8"), ("ffn2", "ws8"), ("ffn2", "b"),
)


def fused_layer_available(cfg, params_layer) -> bool:
    """The layer kernel covers w8-prepared linears, no MoE, head dims 32, 64
    and 128 (the TPU's "multiple of 128 lanes" rule does not apply), and an
    FSMN of at most 16 taps."""
    return (
        "wq8" in params_layer.get("qkv", {})
        and "moe" not in params_layer
        and cfg.d_model % cfg.n_heads == 0
        and cfg.d_model // cfg.n_heads in _HEAD_DIMS
        and cfg.fsmn_kernel <= _FSMN_KMAX
    )


def layer_view(stacked, i: int):
    """Layer i of a stacked [L, ...] param tree, as views."""
    return tree_map(lambda a: a[i], stacked)


# ---------------------------------------------------------------------------
# plain versions


def _ln(x, p, eps: float = 1e-12):
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * p["g"] + p["b"]


def _bf(x):
    return x.to(torch.bfloat16).float()


def _w8_lin(p, x):
    y = w8_matmul_plain(x.to(torch.bfloat16), p["wq8"], p["ws8"])
    if "b" in p:
        y = y + p["b"]
    return y


def fsmn_conv(vm: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise centred k-tap conv over time as k shifted multiply-adds.
    vm [..., T, D] f32, w [k, D] → [..., T, D]."""
    k = w.shape[0]
    T = vm.shape[-2]
    pad = (k - 1) // 2
    vp = torch.nn.functional.pad(vm, (0, 0, pad, k - 1 - pad))
    w = w.float()
    out = torch.zeros_like(vm)
    for kk in range(k):
        out = out + vp[..., kk:kk + T, :] * w[kk]
    return out


def sanm_layer_w8_plain(x: torch.Tensor, mask: torch.Tensor, lp, n_heads: int,
                        fsmn_k: int) -> torch.Tensor:
    """x f32 [T, D], mask f32 [T] (1 = valid), w8 layer params → f32 [T, D]."""
    T, D = x.shape
    if lp["fsmn"]["w"].shape[0] != fsmn_k:
        raise ValueError("sanm_layer_w8: fsmn weight does not have fsmn_k taps")
    hd = D // n_heads
    x = x.float()
    m = mask.float()
    h = _ln(x, lp["norm1"])
    q, k, v = _w8_lin(lp["qkv"], h).split(D, dim=-1)
    fsmn = fsmn_conv(v * m[:, None], lp["fsmn"]["w"])
    qh = _bf(q).reshape(T, n_heads, hd).transpose(0, 1)  # [H, T, hd]
    kh = _bf(k).reshape(T, n_heads, hd).transpose(0, 1)
    vh = _bf(v).reshape(T, n_heads, hd).transpose(0, 1)
    scores = (qh @ kh.transpose(-1, -2)) / math.sqrt(hd)
    scores = torch.where(m > 0, scores, torch.full_like(scores, -1e9))  # over keys
    attn = torch.softmax(scores, dim=-1)
    ctx = (_bf(attn) @ vh).transpose(0, 1).reshape(T, D)
    x1 = x + _w8_lin(lp["out"], ctx + fsmn)
    h2 = _ln(x1, lp["norm2"])
    return x1 + _w8_lin(lp["ffn2"], torch.relu(_w8_lin(lp["ffn1"], h2)))


def sanm_stack_w8_plain(x: torch.Tensor, mask: torch.Tensor, stacked, n_heads: int,
                        fsmn_k: int) -> torch.Tensor:
    """All L layers of a stacked tree, one plain layer after another."""
    for i in range(stacked["qkv"]["wq8"].shape[0]):
        x = sanm_layer_w8_plain(x, mask, layer_view(stacked, i), n_heads, fsmn_k)
    return x


# ---------------------------------------------------------------------------
# kernel launches


def _layer_fn():
    global _fn
    if _fn is None:
        P, I = _build.P, _build.I
        _fn = _build.bind(_STEM, "sanm_layer_w8",
                          [P, P, I, I, I, I, I] + [P] * 5 + [P, I] + [P] * 11
                          + [P] * 5)
    return _fn


def _operands(lp, device, lead: tuple[int, ...], D: int, fsmn_k: int):
    """The layer's tensors in the C entry's order (None for a missing bias),
    checked for device, dtype, contiguity and shape."""
    ts = []
    for group, name in _LEAVES:
        t = lp[group].get(name)
        if t is None:
            if name != "b" or group.startswith("norm"):
                raise KeyError(f"sanm_layer_w8: missing {group}.{name}")
            ts.append(None)
            continue
        if t.device != device or not t.is_contiguous():
            raise ValueError(f"sanm_layer_w8: {group}.{name} must be contiguous on {device}")
        want = (torch.int8,) if name == "wq8" else (
            (torch.bfloat16, torch.float32) if group == "fsmn" else (torch.float32,))
        if t.dtype not in want:
            raise TypeError(f"sanm_layer_w8: {group}.{name} is {t.dtype}, wants {want}")
        if tuple(t.shape[:len(lead)]) != lead:
            raise ValueError(f"sanm_layer_w8: {group}.{name} lacks the leading {lead}")
        ts.append(t)
    F = lp["ffn1"]["wq8"].shape[-1]
    shapes = (
        (D,), (D,), (D, 3 * D), (3 * D,), (3 * D,), (fsmn_k, D),
        (D, D), (D,), (D,), (D,), (D,),
        (D, F), (F,), (F,), (F, D), (D,), (D,),
    )
    for idx, shape in enumerate(shapes):
        if ts[idx] is not None and tuple(ts[idx].shape[len(lead):]) != shape:
            raise ValueError(f"sanm_layer_w8: {_LEAVES[idx]} has shape "
                             f"{tuple(ts[idx].shape)}, wants {lead + shape}")
    return ts, F


def _launch_layers(x, mask, lp, n_heads: int, fsmn_k: int, n_layers: int | None):
    """Run the layer kernel in place on x [T, D] f32 (a fresh buffer the
    caller owns), once, or over the n_layers of a stacked tree."""
    if not x.is_cuda:
        raise ValueError(f"sanm_layer_w8: x lies on {x.device}, not on a CUDA card")
    T, D = x.shape
    if D % n_heads or D // n_heads not in _HEAD_DIMS or not 1 <= fsmn_k <= _FSMN_KMAX:
        raise ValueError(f"sanm_layer_w8: head dim {D}/{n_heads} or {fsmn_k} FSMN "
                         "taps unsupported")
    mask = mask.to(device=x.device, dtype=torch.float32).contiguous()
    if mask.shape != (T,):
        raise ValueError("sanm_layer_w8: mask must be [T]")
    lead = () if n_layers is None else (n_layers,)
    ts, F = _operands(lp, x.device, lead, D, fsmn_k)
    fn = _layer_fn()
    scratch = [torch.empty((T, n), dtype=torch.float32, device=x.device)
               for n in (D, 3 * D, D, F)]  # h, qkv, ctx, f1
    bases = [None if t is None else t.data_ptr() for t in ts]
    strides = [0 if (t is None or not lead) else t.stride(0) * t.element_size()
               for t in ts]
    fsmn_bf16 = int(ts[5].dtype == torch.bfloat16)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    for i in range(n_layers or 1):
        p = [None if b is None else b + i * s for b, s in zip(bases, strides)]
        code = fn(x.data_ptr(), mask.data_ptr(), T, D, n_heads, F, fsmn_k,
                  *p[0:5], p[5], fsmn_bf16, *p[6:17],
                  *(s.data_ptr() for s in scratch), stream)
        _build.check(_STEM, "sanm_layer_w8", code)
        sanm_layer_w8.launches += 1
    return x


def sanm_layer_w8(x: torch.Tensor, mask: torch.Tensor, lp, n_heads: int,
                  fsmn_k: int) -> torch.Tensor:
    """One SAN-M layer. x f32 [T, D]; mask f32 [T]; lp: layer params with
    w8-prepared linears (wq8/ws8/b), norms and fsmn. Returns f32 [T, D]."""
    if x.device.type == "cpu":
        return sanm_layer_w8_plain(x, mask, lp, n_heads, fsmn_k)
    y = x.to(torch.float32).contiguous().clone()
    return _launch_layers(y, mask, lp, n_heads, fsmn_k, None)


def sanm_stack_w8(x: torch.Tensor, mask: torch.Tensor, stacked, n_heads: int,
                  fsmn_k: int) -> torch.Tensor:
    """The L-layer stack at batch 1. stacked: stack_layer_params' tree (a
    leading L axis on every leaf, w8-prepared linears). Returns f32 [T, D]."""
    if x.device.type == "cpu":
        return sanm_stack_w8_plain(x, mask, stacked, n_heads, fsmn_k)
    # one [T, D] f32 activation buffer, updated in place by every layer
    y = x.to(torch.float32).contiguous().clone()
    L = stacked["qkv"]["wq8"].shape[0]
    _launch_layers(y, mask, stacked, n_heads, fsmn_k, L)
    sanm_stack_w8.launches += 1
    return y


sanm_layer_w8.launches = 0
sanm_stack_w8.launches = 0
