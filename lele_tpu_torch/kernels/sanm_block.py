"""SAN-M encoder layers: counterpart of lele_tpu/kernels/sanm_block.py.

Replaces four TPU kernels. w8a16 (int8 weights, f32/bf16 activations):

- `sanm_layer_w8` ← `sanm_layer_w8_pallas` (lele_tpu/kernels/sanm_block.py:110):
  one layer, LN1 → w8 qkv → FSMN over V·mask + per-head attention → w8 out
  + residual → LN2 → w8 FFN (ReLU) + residual. The kernel is
  csrc/sanm_layer.cu: one C entry runs the layer as seven launches on the
  current stream. It serves params that are not stacked.
- `sanm_stack_w8` ← `sanm_stack_w8_pallas` (lele_tpu/kernels/sanm_block.py:229):
  all L layers at batch 1.

w4a16 (groupwise int4 weights, lele_tpu/kernels/w4_matmul.py's block
packing):

- `sanm_stack_w4` ← `sanm_stack_w4_pallas` (lele_tpu/kernels/sanm_block.py:621):
  all L layers at batch 1, each linear dequantised as `_w4dot` does:
  bf16(q·s), bf16 products, f32 sums. The TPU's `hd % 128` rule is dropped,
  as for w8.

Both stacks are one cooperative launch of csrc/sanm_stack.cu (design and
what bounds it on the H100 are in that file): the layer loop runs on the
card, seven grid-wide phases a layer, on the stacked [L, ...] weights (base
pointers and per-layer strides, no copies) and one [T, D] f32 activation
buffer that every layer updates in place.

The plain versions follow the JAX jnp block (models/sensevoice.py:321-397)
with the kernel's numerics: bf16-rounded operands, f32 sums, masked keys
replaced by -1e9, the FSMN written as shifted adds (no cuDNN conv, so no
TF32 on a card).

Exact ONNX DynamicQuantizeLinear semantics (the compiled-ONNX path):

- `sanm_stack_dql` ← `sanm_stack_dql_pallas`
  (lele_tpu/kernels/sanm_block.py:434): L layers whose four linears are
  DQL → MatMulInteger → dequant, with f32 attention under the graph's
  additive key bias, and the FSMN over values times the graph's value mask
  with the graph's left pad. The kernel is csrc/sanm_dql.cu (design and
  bounds there): one cooperative launch for all L layers, eleven grid-wide
  phases a layer; `dql_phase_us` times them with the kernel's own timer.
  It pads no rows, so every min/max covers exactly the T
  rows of the graph; the bucket's padded frames are real rows of the graph
  and enter them. The plain version follows `_stack_kernel_dql` with the
  same arithmetic: division in quantization, exact int32 sums (as float64
  products), f32 attention. It is written op for op as the per-op trace of
  the same graph computes the layer (the ONNX emitters' LayerNormalization,
  Softmax and Conv), so on one device the fused and per-op paths give the
  same bits: DQL's global min/max makes a deep int8 graph amplify any
  difference in the last bit (see PERF.md), and the two paths are the
  oracle for each other.

A wrapper takes its plain version only for a CPU tensor; for a CUDA tensor
it launches the kernel or raises (each wrapper calls its registered op,
kernels/_library.py). `sanm_layer_w8.launches` counts single
layers; `sanm_stack_w8.launches`, `sanm_stack_w4.launches` and
`sanm_stack_dql.launches` count stack calls (one launch each).
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..config import cudnn_tf32
from ..params import tree_map
from . import _build, _library
from .quant_matmul import dql_quantize, dql_scale_zp, w8_matmul_plain
from .w4_matmul import _unpack_nibbles

_STEM = "sanm_layer"
_STACK_STEM = "sanm_stack"
_HEAD_DIMS = (32, 64, 128)  # compiled in csrc/sanm_layer.cu and csrc/sanm_stack.cu
_FSMN_KMAX = 16  # their FSMN_KMAX

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


def layer_kernel_takes(cfg) -> bool:
    """Whether the layer kernel compiles the config's head dim (32, 64 or
    128: the TPU's "multiple of 128 lanes" rule does not apply) and FSMN (at
    most 16 taps)."""
    return (cfg.d_model % cfg.n_heads == 0
            and cfg.d_model // cfg.n_heads in _HEAD_DIMS
            and cfg.fsmn_kernel <= _FSMN_KMAX)


def fused_layer_available(cfg, params_layer) -> bool:
    """The w8 layer kernel covers w8-prepared linears and no MoE, at the
    widths `layer_kernel_takes`."""
    return ("wq8" in params_layer.get("qkv", {}) and "moe" not in params_layer
            and layer_kernel_takes(cfg))


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


def _w4_lin(p, x, group: int):
    """`_w4dot`: x rounded to bf16; each plane's weight dequantised as
    bf16(q·s in f32); bf16 products, f32 sums (low plane, then high); + b."""
    half = x.shape[-1] // 2
    lo, hi = _unpack_nibbles(p["wq4"])
    s = p["ws4"].float().repeat_interleave(group, dim=0)
    xb = _bf(x)
    y = xb[:, :half] @ _bf(lo.float() * s[:half])
    y = y + xb[:, half:] @ _bf(hi.float() * s[half:])
    if "b" in p:
        y = y + p["b"]
    return y


def _layer_plain(x, mask, lp, n_heads: int, fsmn_k: int, lin, name: str):
    """One layer, any weight format: `lin(p, x)` is its linear."""
    T, D = x.shape
    if lp["fsmn"]["w"].shape[0] != fsmn_k:
        raise ValueError(f"{name}: fsmn weight does not have fsmn_k taps")
    hd = D // n_heads
    x = x.float()
    m = mask.float()
    h = _ln(x, lp["norm1"])
    q, k, v = lin(lp["qkv"], h).split(D, dim=-1)
    fsmn = fsmn_conv(v * m[:, None], lp["fsmn"]["w"])
    qh = _bf(q).reshape(T, n_heads, hd).transpose(0, 1)  # [H, T, hd]
    kh = _bf(k).reshape(T, n_heads, hd).transpose(0, 1)
    vh = _bf(v).reshape(T, n_heads, hd).transpose(0, 1)
    scores = (qh @ kh.transpose(-1, -2)) / math.sqrt(hd)
    scores = torch.where(m > 0, scores, torch.full_like(scores, -1e9))  # over keys
    attn = torch.softmax(scores, dim=-1)
    ctx = (_bf(attn) @ vh).transpose(0, 1).reshape(T, D)
    x1 = x + lin(lp["out"], ctx + fsmn)
    h2 = _ln(x1, lp["norm2"])
    return x1 + lin(lp["ffn2"], torch.relu(lin(lp["ffn1"], h2)))


def sanm_layer_w8_plain(x: torch.Tensor, mask: torch.Tensor, lp, n_heads: int,
                        fsmn_k: int) -> torch.Tensor:
    """x f32 [T, D], mask f32 [T] (1 = valid), w8 layer params → f32 [T, D]."""
    return _layer_plain(x, mask, lp, n_heads, fsmn_k, _w8_lin, "sanm_layer_w8")


def sanm_stack_w8_plain(x: torch.Tensor, mask: torch.Tensor, stacked, n_heads: int,
                        fsmn_k: int) -> torch.Tensor:
    """All L layers of a stacked tree, one plain layer after another."""
    for i in range(stacked["qkv"]["wq8"].shape[0]):
        x = sanm_layer_w8_plain(x, mask, layer_view(stacked, i), n_heads, fsmn_k)
    return x


# ---------------------------------------------------------------------------
# kernel launches


# the two weight formats: (packed weight key, scale key)
_FORMATS = {"w8": ("wq8", "ws8"), "w4": ("wq4", "ws4")}
_layer_fn = None
_stack_fns: dict[str, object] = {}
_work_fn = None


def _operands(lp, device, lead: tuple[int, ...], D: int, fsmn_k: int, fmt: str, group: int,
              name: str):
    """The layer's (or stack's) tensors in the C entry's order (None for a
    missing bias), checked for device, dtype, contiguity and shape."""
    wkey, skey = _FORMATS[fmt]
    leaves = [(g, {"wq8": wkey, "ws8": skey}.get(n, n)) for g, n in _LEAVES]
    ts = []
    for group_, leaf in leaves:
        t = lp[group_].get(leaf)
        if t is None:
            if leaf != "b" or group_.startswith("norm"):
                raise KeyError(f"{name}: missing {group_}.{leaf}")
            ts.append(None)
            continue
        if t.device != device or not t.is_contiguous():
            raise ValueError(f"{name}: {group_}.{leaf} must be contiguous on {device}")
        want = (torch.int8,) if leaf == wkey else (
            (torch.bfloat16, torch.float32) if group_ == "fsmn" else (torch.float32,))
        if t.dtype not in want:
            raise TypeError(f"{name}: {group_}.{leaf} is {t.dtype}, wants {want}")
        if tuple(t.shape[:len(lead)]) != lead:
            raise ValueError(f"{name}: {group_}.{leaf} lacks the leading {lead}")
        ts.append(t)
    F = lp["ffn1"][wkey].shape[-1]
    if fmt == "w8":
        def lin(k_, n_):  # weight, scale
            return (k_, n_), (n_,)
    else:
        def lin(k_, n_):
            return (k_ // 2, n_), (k_ // group, n_)
    shapes = (
        (D,), (D,), *lin(D, 3 * D), (3 * D,), (fsmn_k, D),
        *lin(D, D), (D,), (D,), (D,),
        *lin(D, F), (F,), *lin(F, D), (D,),
    )
    for idx, shape in enumerate(shapes):
        if ts[idx] is not None and tuple(ts[idx].shape[len(lead):]) != shape:
            raise ValueError(f"{name}: {leaves[idx]} has shape "
                             f"{tuple(ts[idx].shape)}, wants {lead + shape}")
    return ts, F


def layer_pointers(tree, device, D: int, fsmn_k: int, fmt: str, group: int, name: str,
                   stacked: bool):
    """The C entries' per-layer operands of a layer tree: (L, the tensors as
    `_operands` checks them, F, each leaf's device pointer or None, its byte
    stride from one layer to the next). A stacked tree (a leading L axis on
    every leaf) gives layer i's leaf at pointer + i·stride; a per-layer tree
    is L = 1 with every stride 0."""
    L = tree["qkv"][_FORMATS[fmt][0]].shape[0] if stacked else 1
    ts, F = _operands(tree, device, (L,) if stacked else (), D, fsmn_k, fmt, group, name)
    ptrs = [None if t is None else t.data_ptr() for t in ts]
    strides = [0 if t is None or not stacked else t.stride(0) * t.element_size() for t in ts]
    return L, ts, F, ptrs, strides


def _stack_w4_shape(K: int, group: int) -> bool:
    """The shapes kernel 8's GEMMs take: K/2 and the group multiples of 16."""
    return K % 32 == 0 and group >= 16 and group % 16 == 0


def _checked(x, mask, n_heads: int, fsmn_k: int, name: str):
    """x's shape and the mask as contiguous f32 [T] on x's card."""
    if not x.is_cuda:
        raise ValueError(f"{name}: x lies on {x.device}, not on a CUDA card")
    T, D = x.shape
    if D % n_heads or D // n_heads not in _HEAD_DIMS or not 1 <= fsmn_k <= _FSMN_KMAX:
        raise ValueError(f"{name}: head dim {D}/{n_heads} or {fsmn_k} FSMN "
                         "taps unsupported")
    mask = mask.to(device=x.device, dtype=torch.float32).contiguous()
    if mask.shape != (T,):
        raise ValueError(f"{name}: mask must be [T]")
    return T, D, mask


def _launch_layer(x, mask, lp, n_heads: int, fsmn_k: int):
    """Run csrc/sanm_layer.cu's seven launches in place on x [T, D] f32 (a
    fresh buffer the caller owns)."""
    global _layer_fn
    name = "sanm_layer_w8"
    T, D, mask = _checked(x, mask, n_heads, fsmn_k, name)
    _, ts, F, p, _ = layer_pointers(lp, x.device, D, fsmn_k, "w8", 0, name, stacked=False)
    if _layer_fn is None:
        P, I = _build.P, _build.I
        _layer_fn = _build.bind(_STEM, name, [P, P] + [I] * 5 + [P] * 5 + [P, I] + [P] * 11
                                + [P] * 5)
    scratch = [torch.empty((T, n), dtype=torch.float32, device=x.device)
               for n in (D, 3 * D, D, F)]  # h, qkv, ctx, f1
    code = _layer_fn(x.data_ptr(), mask.data_ptr(), T, D, n_heads, F, fsmn_k,
                     *p[0:5], p[5], int(ts[5].dtype == torch.bfloat16), *p[6:17],
                     *(s.data_ptr() for s in scratch),
                     torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(_STEM, name, code)
    sanm_layer_w8.launches += 1
    return x


def _launch_stack(x, mask, stacked, n_heads: int, fsmn_k: int, fmt: str, group: int = 0,
                  trace: torch.Tensor | None = None):
    """Run all L layers of a stacked tree in place on x [T, D] f32 (a fresh
    buffer the caller owns) as one launch of csrc/sanm_stack.cu; `trace`
    (int64 [5 L + 1] on the card) gets the kernel's phase timestamps."""
    global _work_fn
    name = f"sanm_stack_{fmt}"
    T, D, mask = _checked(x, mask, n_heads, fsmn_k, name)
    L, ts, F, ptrs, strides = layer_pointers(stacked, x.device, D, fsmn_k, fmt, group, name,
                                             stacked=True)
    if fmt == "w4" and not (_stack_w4_shape(D, group) and _stack_w4_shape(F, group)):
        raise ValueError(f"{name}: D={D}, F={F}, group={group}: the kernel needs K/2 "
                         "and the group to be multiples of 16")
    fn = _stack_fns.get(fmt)
    if fn is None:
        P, I = _build.P, _build.I
        ints = [I] * (6 if fmt == "w8" else 7)  # T, D, H, F, k, (group,) L
        fn = _stack_fns[fmt] = _build.bind(_STACK_STEM, name,
                                           [P, P, *ints, P, P, I, P, P, P])
    if _work_fn is None:
        _work_fn = _build.library(_STACK_STEM).sanm_stack_work_bytes
        _work_fn.argtypes = [_build.I] * 3
        _work_fn.restype = ctypes.c_longlong
    work = torch.empty((_work_fn(T, D, F),), dtype=torch.uint8, device=x.device)
    leaves = (ctypes.c_void_p * len(ts))(*ptrs)
    strides = (ctypes.c_longlong * len(ts))(*strides)
    ints = (T, D, n_heads, F, fsmn_k) + ((group,) if fmt == "w4" else ()) + (L,)
    code = fn(x.data_ptr(), mask.data_ptr(), *ints, leaves, strides,
              int(ts[5].dtype == torch.bfloat16), work.data_ptr(),
              None if trace is None else trace.data_ptr(),
              torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(_STACK_STEM, name, code)
    return x


STACK_PHASES = ("LN1", "qkv", "attention+FSMN", "out", "LN2", "ffn1", "ffn2")


def stack_phase_us(x: torch.Tensor, mask: torch.Tensor, stacked, n_heads: int, fsmn_k: int,
                   fmt: str = "w8", group: int = 128) -> torch.Tensor:
    """One launch of the stack kernel on a CUDA x with its timer trace on:
    f64 [L, 7] microseconds of each layer's phases (STACK_PHASES), each up to
    the end of the grid barrier after it. `stack_phase_us.raw` keeps the
    stamps (ns), then those inside layer 1's phases (csrc/sanm_stack.cu
    `stamp`). A measurement: it counts no launch (`_build.phase_us`)."""
    L = stacked["qkv"][_FORMATS[fmt][0]].shape[0]
    y = x.to(torch.float32).contiguous().clone()
    ph, stack_phase_us.raw = _build.phase_us(
        "stack_phase_us", x, L, STACK_PHASES,
        lambda trace: _launch_stack(y, mask, stacked, n_heads, fsmn_k, fmt,
                                    group if fmt == "w4" else 0, trace))
    return ph


# the registered ops (kernels/_library.py) take a layer tree as the list of
# its `_LEAVES` (None for a missing bias), in the C entry's order


def _flat(tree, fmt: str) -> list:
    names = {"wq8": _FORMATS[fmt][0], "ws8": _FORMATS[fmt][1]}
    return [tree.get(g, {}).get(names.get(n, n)) for g, n in _LEAVES]


def _tree(leaves, fmt: str) -> dict:
    names = {"wq8": _FORMATS[fmt][0], "ws8": _FORMATS[fmt][1]}
    tree: dict = {}
    for (g, n), t in zip(_LEAVES, leaves):
        sub = tree.setdefault(g, {})
        if t is not None:
            sub[names.get(n, n)] = t
    return tree


def _like_x(x, *_):
    return x.new_empty(x.shape, dtype=torch.float32)


def sanm_layer_w8(x: torch.Tensor, mask: torch.Tensor, lp, n_heads: int,
                  fsmn_k: int) -> torch.Tensor:
    """One SAN-M layer. x f32 [T, D]; mask f32 [T]; lp: layer params with
    w8-prepared linears (wq8/ws8/b), norms and fsmn. Returns f32 [T, D]."""
    return _LAYER_OP(x, mask, _flat(lp, "w8"), n_heads, fsmn_k)


def _layer_launch(x, mask, leaves, n_heads: int, fsmn_k: int):
    y = x.to(torch.float32).contiguous().clone()
    return _launch_layer(y, mask, _tree(leaves, "w8"), n_heads, fsmn_k)


_LAYER_OP = _library.register(
    "sanm_layer_w8", "(Tensor x, Tensor mask, Tensor?[] leaves, int n_heads, int fsmn_k) "
    "-> Tensor", lambda x, mask, leaves, h, k: sanm_layer_w8_plain(
        x, mask, _tree(leaves, "w8"), h, k), _layer_launch, _like_x)


def sanm_stack_w8(x: torch.Tensor, mask: torch.Tensor, stacked, n_heads: int,
                  fsmn_k: int) -> torch.Tensor:
    """The L-layer stack at batch 1. stacked: stack_layer_params' tree (a
    leading L axis on every leaf, w8-prepared linears). Returns f32 [T, D]."""
    return _STACK_W8_OP(x, mask, _flat(stacked, "w8"), n_heads, fsmn_k)


def _stack_w8_launch(x, mask, leaves, n_heads: int, fsmn_k: int):
    # one [T, D] f32 activation buffer, updated in place by every layer
    y = x.to(torch.float32).contiguous().clone()
    _launch_stack(y, mask, _tree(leaves, "w8"), n_heads, fsmn_k, "w8")
    sanm_stack_w8.launches += 1
    return y


_STACK_W8_OP = _library.register(
    "sanm_stack_w8", "(Tensor x, Tensor mask, Tensor?[] leaves, int n_heads, int fsmn_k) "
    "-> Tensor", lambda x, mask, leaves, h, k: sanm_stack_w8_plain(
        x, mask, _tree(leaves, "w8"), h, k), _stack_w8_launch, _like_x)
sanm_layer_w8.launches = 0
sanm_stack_w8.launches = 0


# ---------------------------------------------------------------------------
# w4a16 stack (kernel 8: csrc/sanm_stack.cu, sanm_stack_w4)


def _w4_groups(stacked, D: int, group: int):
    """Check the stacked w4 linears' scale groups: K/group rows of scales,
    an even count (a group must not straddle the nibble-plane boundary, as
    the JAX kernel requires)."""
    F = stacked["ffn1"]["wq4"].shape[-1]
    for name, k_ in (("qkv", D), ("out", D), ("ffn1", D), ("ffn2", F)):
        n_g = stacked[name]["ws4"].shape[1]
        if n_g * group != k_:
            raise ValueError(f"sanm_stack_w4: {name} has {n_g} scale groups for K={k_}, "
                             f"group={group}")
        if n_g % 2:
            raise ValueError(f"sanm_stack_w4: {name}: K/group={n_g} must be even (groups "
                             "must not straddle the nibble-plane boundary)")


def sanm_stack_w4_plain(x: torch.Tensor, mask: torch.Tensor, stacked, n_heads: int,
                        fsmn_k: int, group: int = 128) -> torch.Tensor:
    """All L layers of a stacked w4 tree, one plain layer after another, with
    `_w4dot`'s numerics (lele_tpu/kernels/sanm_block.py:522)."""
    _w4_groups(stacked, x.shape[1], group)

    def lin(p, v):
        return _w4_lin(p, v, group)

    for i in range(stacked["qkv"]["wq4"].shape[0]):
        x = _layer_plain(x, mask, layer_view(stacked, i), n_heads, fsmn_k, lin,
                         "sanm_stack_w4")
    return x


def sanm_stack_w4(x: torch.Tensor, mask: torch.Tensor, stacked, n_heads: int,
                  fsmn_k: int, group: int = 128) -> torch.Tensor:
    """The L-layer w4a16 stack at batch 1 (`sanm_stack_w4_pallas`). stacked:
    stack_layer_params over prepare_w4_params (wq4 int8 [L, K/2, N], ws4 f32
    [L, K/group, N]). x f32 [T, D], mask f32 [T] → f32 [T, D]. Each linear
    dequantises as bf16(q·s), bf16 products, f32 sums; LN eps 1e-12; bf16
    attention with an f32 softmax, masked keys at (m − 1)·1e9; the FSMN over
    V·mask as shifted adds."""
    return _STACK_W4_OP(x, mask, _flat(stacked, "w4"), n_heads, fsmn_k, group)


def _stack_w4_launch(x, mask, leaves, n_heads: int, fsmn_k: int, group: int):
    stacked = _tree(leaves, "w4")
    _w4_groups(stacked, x.shape[1], group)
    # one [T, D] f32 activation buffer, updated in place by every layer
    y = x.to(torch.float32).contiguous().clone()
    _launch_stack(y, mask, stacked, n_heads, fsmn_k, "w4", group)
    sanm_stack_w4.launches += 1
    return y


_STACK_W4_OP = _library.register(
    "sanm_stack_w4", "(Tensor x, Tensor mask, Tensor?[] leaves, int n_heads, int fsmn_k, "
    "int group) -> Tensor", lambda x, mask, leaves, h, k, g: sanm_stack_w4_plain(
        x, mask, _tree(leaves, "w4"), h, k, g), _stack_w4_launch, _like_x)
sanm_stack_w4.launches = 0


# ---------------------------------------------------------------------------
# exact-DQL stack (kernel: csrc/sanm_dql.cu)

_DQL_STEM = "sanm_dql"
DQL_HEAD_DIMS = (32, 64, 128)  # compiled in csrc/sanm_dql.cu
DQL_T_MAX = 2048  # the compiler's routing range (the kernel streams its keys: any T)
_dql_fn = None
_dql_work_fn = None

# a stacked linear's operands, in the C entry's order
_DQL_LIN = ("wq", "colsum", "ws", "b")


def sanm_stack_dql_supported(D: int, n_heads: int | None, T: int) -> bool:
    """Whether the kernel takes these widths: a head dim it compiles and at
    most DQL_T_MAX rows (with n_heads None: whether any head split could)."""
    if not 1 <= T <= DQL_T_MAX:
        return False
    if n_heads is None:
        return any(D % hd == 0 for hd in DQL_HEAD_DIMS)
    return D % n_heads == 0 and D // n_heads in DQL_HEAD_DIMS


def _dql_linear_plain(x, p, i: int):
    """Layer i of a stacked DQL linear: exact DQL → int8 dot → dequant + bias
    (the Pallas `_dql_dot` on unpadded rows)."""
    scale, zp = dql_scale_zp(x)
    ai = dql_quantize(x, scale, zp).to(torch.float64) - 128.0
    acc = ai @ p["wq"][i].to(torch.float64)
    acc = acc - (zp.to(torch.float64) - 128.0) * p["colsum"][i].to(torch.float64)
    return acc.to(torch.float32) * (scale * p["ws"][i]) + p["b"][i]


def _ln_eps(x, g, b, eps: float):
    """ONNX LayerNormalization over the last axis, as its emitter computes it."""
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    return (x - mu) * (1.0 / torch.sqrt(var + eps)) * g + b


def _fsmn_dql_plain(vm: torch.Tensor, w: torch.Tensor, pad_left: int) -> torch.Tensor:
    """The graph's depthwise FSMN conv over vm [T, D] with taps w [k, D] and
    pad_left zero rows before (k - 1 - pad_left after), as the Conv emitter
    computes it (cuDNN's TF32 off)."""
    k, D = w.shape
    xt = torch.nn.functional.pad(vm.t()[None], (pad_left, k - 1 - pad_left))
    with torch.backends.cudnn.flags(enabled=torch.backends.cudnn.enabled,
                                    allow_tf32=cudnn_tf32()):
        out = torch.nn.functional.conv1d(xt, w.t().reshape(D, 1, k), groups=D)
    return out[0].t()


def sanm_stack_dql_plain(x: torch.Tensor, attn_bias: torch.Tensor, vmask: torch.Tensor,
                         stacked, n_heads: int, fsmn_k: int, pad_left: int,
                         eps1: float = 1e-5, eps2: float = 1e-5,
                         att_scale: float | None = None) -> torch.Tensor:
    """The stack one layer after another, in plain PyTorch (arguments as
    `sanm_stack_dql`)."""
    T, D = x.shape
    L = stacked["qkv"]["wq"].shape[0]
    hd = D // n_heads
    if stacked["fsmn"].shape[1] != fsmn_k:
        raise ValueError("sanm_stack_dql: fsmn weight does not have fsmn_k taps")
    if att_scale is None:
        att_scale = 1.0 / math.sqrt(hd)
    x = x.to(torch.float32)
    for i in range(L):
        h = _ln_eps(x, stacked["norm1"]["g"][i], stacked["norm1"]["b"][i], eps1)
        q, k, v = _dql_linear_plain(h, stacked["qkv"], i).split(D, dim=-1)
        fsmn = _fsmn_dql_plain(v * vmask[i].reshape(T, 1), stacked["fsmn"][i],
                               pad_left)
        qh = q.reshape(1, T, n_heads, hd).permute(0, 2, 1, 3)  # [1, H, T, hd]
        kh = k.reshape(1, T, n_heads, hd).permute(0, 2, 3, 1)  # [1, H, hd, T]
        vh = v.reshape(1, T, n_heads, hd).permute(0, 2, 1, 3)
        sc = torch.matmul(qh, kh) * att_scale + attn_bias[i].reshape(1, 1, 1, T)
        att = torch.softmax(sc, dim=-1)
        ctx = torch.matmul(att, vh).permute(0, 2, 1, 3).reshape(T, D)
        x1 = x + _dql_linear_plain(ctx + fsmn, stacked["out"], i)
        h2 = _ln_eps(x1, stacked["norm2"]["g"][i], stacked["norm2"]["b"][i], eps2)
        f1 = torch.relu(_dql_linear_plain(h2, stacked["ffn1"], i))
        x = x1 + _dql_linear_plain(f1, stacked["ffn2"], i)
    return x


def _dql_operands(stacked, device, L: int, D: int, F: int, fsmn_k: int):
    """The stack's tensors in the C entry's order, checked for device,
    dtype, contiguity and shape."""
    want = []
    for key, k_, n_ in (("qkv", D, 3 * D), ("out", D, D), ("ffn1", D, F),
                        ("ffn2", F, D)):
        for name, dt, shape in (("wq", torch.int8, (L, k_, n_)),
                                ("colsum", torch.int32, (L, 1, n_)),
                                ("ws", torch.float32, (L, 1, n_)),
                                ("b", torch.float32, (L, 1, n_))):
            want.append((f"{key}.{name}", stacked[key][name], dt, shape))
    for key in ("norm1", "norm2"):
        for name in ("g", "b"):
            want.append((f"{key}.{name}", stacked[key][name], torch.float32, (L, 1, D)))
    want.append(("fsmn", stacked["fsmn"], torch.float32, (L, fsmn_k, D)))
    out = {}
    for label, t, dt, shape in want:
        if t.device != device or not t.is_contiguous():
            raise ValueError(f"sanm_stack_dql: {label} must be contiguous on {device}")
        if t.dtype != dt:
            raise TypeError(f"sanm_stack_dql: {label} is {t.dtype}, wants {dt}")
        if tuple(t.shape) != shape:
            raise ValueError(f"sanm_stack_dql: {label} has shape {tuple(t.shape)}, "
                             f"wants {shape}")
        out[label] = t
    return out


def _dql_check(x, attn_bias, vmask, stacked, fsmn_k: int, pad_left: int):
    """The operands both versions take: (checked stack tensors, bias and
    value mask as contiguous f32 [L, T] on x's device)."""
    T, D = x.shape
    L = stacked["qkv"]["wq"].shape[0]
    F = stacked["ffn1"]["wq"].shape[-1]
    if not 0 <= pad_left < fsmn_k:
        raise ValueError(f"sanm_stack_dql: pad_left {pad_left} for {fsmn_k} taps")
    ops = _dql_operands(stacked, x.device, L, D, F, fsmn_k)
    bias = attn_bias.to(device=x.device, dtype=torch.float32).contiguous()
    vm = vmask.to(device=x.device, dtype=torch.float32).contiguous()
    if bias.shape != (L, T) or vm.shape != (L, T):
        raise ValueError("sanm_stack_dql: attn_bias and vmask must be [L, T]")
    return ops, bias, vm


def sanm_stack_dql_kernel(x, attn_bias, vmask, stacked, n_heads: int, fsmn_k: int,
                          pad_left: int, eps1: float, eps2: float,
                          att_scale: float | None, trace: torch.Tensor | None = None):
    """Launch csrc/sanm_dql.cu on x's card and stream: one cooperative launch
    for all L layers; returns a fresh f32 [T, D] that every layer updated in
    place. `trace` (int64 [11 L + 1 + 11 * 16] on the card) gets the kernel's
    phase timestamps."""
    global _dql_fn, _dql_work_fn
    T, D = x.shape
    if not sanm_stack_dql_supported(D, n_heads, T) or fsmn_k > _FSMN_KMAX:
        raise ValueError(f"sanm_stack_dql: D={D}, {n_heads} heads, T={T}, {fsmn_k} FSMN taps "
                         f"are outside the kernel (head dims {DQL_HEAD_DIMS}, T <= "
                         f"{DQL_T_MAX}, at most {_FSMN_KMAX} taps)")
    if not x.is_cuda:
        raise ValueError(f"sanm_stack_dql: x lies on {x.device}, not on a CUDA card")
    ops, bias, vm = _dql_check(x, attn_bias, vmask, stacked, fsmn_k, pad_left)
    L, F = bias.shape[0], ops["ffn1.wq"].shape[-1]
    if att_scale is None:
        att_scale = 1.0 / math.sqrt(D // n_heads)
    if _dql_fn is None:
        P, I, Fl = _build.P, _build.I, _build.F
        _dql_fn = _build.bind(_DQL_STEM, "sanm_stack_dql",
                              [P, I, I, I, I, I, I, I, Fl, Fl, Fl, P, P]
                              + [P] * 16 + [P] * 4 + [P] + [P, P, P])
        _dql_work_fn = _build.library(_DQL_STEM).sanm_dql_work_bytes
        _dql_work_fn.argtypes = [_build.I] * 5
        _dql_work_fn.restype = ctypes.c_longlong
    y = x.to(torch.float32).contiguous().clone()
    work = torch.empty((_dql_work_fn(T, D, n_heads, F, L),), dtype=torch.uint8,
                       device=x.device)
    lin = [ops[f"{key}.{name}"].data_ptr() for key in ("qkv", "out", "ffn1", "ffn2")
           for name in _DQL_LIN]
    norms = [ops[f"{key}.{name}"].data_ptr() for key in ("norm1", "norm2")
             for name in ("g", "b")]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = _dql_fn(y.data_ptr(), T, D, n_heads, F, L, fsmn_k, pad_left,
                   float(eps1), float(eps2), float(att_scale),
                   bias.data_ptr(), vm.data_ptr(), *lin, *norms,
                   ops["fsmn"].data_ptr(), work.data_ptr(),
                   None if trace is None else trace.data_ptr(), stream)
    _build.check(_DQL_STEM, "sanm_stack_dql", code)
    return y


DQL_PHASES = ("LN1", "quantize h", "qkv", "attention+FSMN", "quantize a", "out", "LN2",
              "quantize h", "ffn1", "quantize f", "ffn2")


def dql_phase_us(x: torch.Tensor, attn_bias: torch.Tensor, vmask: torch.Tensor, stacked,
                 n_heads: int, fsmn_k: int, pad_left: int, eps1: float = 1e-5,
                 eps2: float = 1e-5, att_scale: float | None = None) -> torch.Tensor:
    """One launch of kernel 4 on a CUDA x with its timer trace on: f64 [L, 11]
    microseconds of each layer's phases (DQL_PHASES), each up to the end of
    the grid barrier after it; `dql_phase_us.raw` keeps the stamps (ns), then
    those inside layer 1's phases (csrc/sanm_dql.cu `stamp`). A measurement:
    it counts no launch, and it refuses a CPU tensor (`_build.phase_us`)."""
    ph, dql_phase_us.raw = _build.phase_us(
        "dql_phase_us", x, stacked["qkv"]["wq"].shape[0], DQL_PHASES,
        lambda trace: sanm_stack_dql_kernel(x, attn_bias, vmask, stacked, n_heads, fsmn_k,
                                            pad_left, eps1, eps2, att_scale, trace))
    return ph


def sanm_stack_dql(x: torch.Tensor, attn_bias: torch.Tensor, vmask: torch.Tensor,
                   stacked, n_heads: int, fsmn_k: int, pad_left: int,
                   eps1: float = 1e-5, eps2: float = 1e-5,
                   att_scale: float | None = None) -> torch.Tensor:
    """L SAN-M layers with exact compiled-int8 (DQL/a8w8) semantics.

    x f32 [T, D]; attn_bias f32 [L, T] (added over the key axis); vmask f32
    [L, T] (multiplies values ahead of the FSMN); stacked: per linear
    {"wq" i8 [L, K, N], "colsum" i32 [L, 1, N], "ws" f32 [L, 1, N], "b" f32
    [L, 1, N]} under qkv/out/ffn1/ffn2, norm1/norm2 {"g", "b"} f32 [L, 1, D],
    fsmn f32 [L, k, D]. Returns f32 [T, D]. Both versions take the same
    operands, checked alike."""
    leaves = [stacked[k][n] for k in _DQL_GROUPS for n in _DQL_LIN]
    leaves += [stacked[k][n] for k in ("norm1", "norm2") for n in ("g", "b")]
    return _DQL_OP(x, attn_bias, vmask, leaves + [stacked["fsmn"]], n_heads, fsmn_k,
                   pad_left, float(eps1), float(eps2),
                   None if att_scale is None else float(att_scale))


_DQL_GROUPS = ("qkv", "out", "ffn1", "ffn2")


def _dql_tree(leaves) -> dict:
    it = iter(leaves)
    tree = {k: {n: next(it) for n in _DQL_LIN} for k in _DQL_GROUPS}
    tree.update({k: {n: next(it) for n in ("g", "b")} for k in ("norm1", "norm2")})
    tree["fsmn"] = next(it)
    return tree


def _dql_plain(x, attn_bias, vmask, leaves, n_heads, fsmn_k, pad_left, eps1, eps2,
               att_scale):
    stacked = _dql_tree(leaves)
    _dql_check(x, attn_bias, vmask, stacked, fsmn_k, pad_left)
    return sanm_stack_dql_plain(x, attn_bias, vmask, stacked, n_heads, fsmn_k, pad_left,
                                eps1, eps2, att_scale)


def _dql_launch(x, attn_bias, vmask, leaves, n_heads, fsmn_k, pad_left, eps1, eps2,
                att_scale):
    y = sanm_stack_dql_kernel(x, attn_bias, vmask, _dql_tree(leaves), n_heads, fsmn_k,
                              pad_left, eps1, eps2, att_scale)
    sanm_stack_dql.launches += 1
    return y


_DQL_OP = _library.register(
    "sanm_stack_dql", "(Tensor x, Tensor attn_bias, Tensor vmask, Tensor[] leaves, "
    "int n_heads, int fsmn_k, int pad_left, float eps1, float eps2, float? att_scale) "
    "-> Tensor", _dql_plain, _dql_launch, _like_x)
sanm_stack_dql.launches = 0
