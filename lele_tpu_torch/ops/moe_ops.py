"""com.microsoft Mixture-of-Experts ops, MoE and QMoE (counterpart of
lele_tpu/ops/moe_ops.py).

The published MoE ONNX releases (Phi-3.5-MoE-instruct-onnx, Mixtral GenAI
builds) carry their expert MLPs as single fused nodes: ``MoE`` (float
experts) and ``QMoE`` (4- or 8-bit experts with per-column scales). Two
lowerings, chosen by the row count, as JAX's:

- the decode path (rows·k ≤ experts): gather the k selected experts of each
  row and run one batched product per linear; for QMoE the gather takes the
  packed bytes and scales, and only the gathered experts are dequantised;
- the prefill path: a loop over the experts, each over all rows,
  accumulated under its routing weight.

Routing follows ORT: `router_probs` holds the logits; softmax → top-k
(optionally renormalised over the k), or, with `use_sparse_mixer=1`, the
SparseMixer-v2 rule of Phi-3.5-MoE (top-1 over a relative-margin-masked
softmax, then the runner-up with the winner at −inf; margin 2·0.01). The top
k come from a stable descending sort, so ties go to the lower expert index as
`jax.lax.top_k` sends them. These products lie outside any Pallas kernel in
JAX, so they are plain PyTorch here (f32, no TF32); the `qmoe_w4` pattern
(compiler/patterns.py) sends QMoE's decode path through kernel 7.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .registry import OpContext, op

_SPARSE_MIXER_EPS = 0.01  # fixed in ORT's kernel and HF PhiMoE inference


def _softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    x = x.to(torch.promote_types(x.dtype, torch.float32))
    m = x.max(dim=dim, keepdim=True).values
    e = torch.exp(x - m)
    return e / e.sum(dim=dim, keepdim=True)


def _sparse_mixer_round(logits: torch.Tensor, masked: torch.Tensor):
    """One SparseMixer selection round over `masked` (logits with the experts
    already selected at −inf): the argmax (the first maximum, as
    `jnp.argmax`), and its weight in a softmax over the entries whose
    relative margin to the max is within 2·eps; all in f32."""
    thr = masked.max(dim=-1, keepdim=True).values
    ind = torch.argmax(masked, dim=-1)
    factor = torch.maximum(logits.abs(), thr)
    drop = (thr - masked) / factor > 2 * _SPARSE_MIXER_EPS
    gates = _softmax(torch.where(drop, torch.full_like(masked, float("-inf")), masked))
    w = torch.gather(gates, -1, ind[:, None])[:, 0]
    return w, ind.to(torch.int32)


def route_topk(logits: torch.Tensor, k: int, use_sparse_mixer: bool = False,
               normalize: bool = False):
    """The MoE routing rule over [rows, E] logits → (weights [rows, k] f32,
    experts [rows, k] int32). Shared by the emitters and the qmoe_w4
    pattern."""
    n_experts = logits.shape[-1]
    if use_sparse_mixer:
        if k != 2:
            raise NotImplementedError(
                f"MoE: use_sparse_mixer requires k=2 (got k={k}); the SparseMixer rule "
                "is defined for top-2 routing")
        lg = logits.to(torch.promote_types(logits.dtype, torch.float32))
        w1, e1 = _sparse_mixer_round(lg, lg)
        hit = torch.arange(n_experts, device=lg.device)[None, :] == e1[:, None]
        w2, e2 = _sparse_mixer_round(lg, torch.where(hit, torch.full_like(lg, float("-inf")),
                                                     lg))
        return torch.stack([w1, w2], dim=-1), torch.stack([e1, e2], dim=-1)
    probs = _softmax(logits)
    w, e = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, e = w[..., :k], e[..., :k]
    if normalize:
        w = w / w.sum(dim=-1, keepdim=True)
    return w, e.to(torch.int32)


def _route(ctx: OpContext, logits: torch.Tensor):
    return route_topk(logits, int(ctx.attr("k", 1)),
                      bool(int(ctx.attr("use_sparse_mixer", 0))),
                      bool(int(ctx.attr("normalize_routing_weights", 0))))


def apply_activation(act: str, h: torch.Tensor) -> torch.Tensor:
    if act == "relu":
        return torch.clamp_min(h, 0)
    if act == "gelu":
        return F.gelu(h)  # exact (erf), as jax.nn.gelu(approximate=False)
    if act == "silu":
        return F.silu(h)
    if act == "identity":
        return h
    raise NotImplementedError(
        f"MoE: activation_type={act!r} is not supported (relu/gelu/silu/identity; gated "
        "exports carry the gate as fc3_experts_weights)")


def _activation(ctx: OpContext, h: torch.Tensor) -> torch.Tensor:
    return apply_activation(ctx.attr("activation_type", "relu"), h)


def _mm(x: torch.Tensor, w: torch.Tensor, per_row: bool) -> torch.Tensor:
    """x [rows, in] against w [rows, in, out] (each row its own gathered
    expert) or [in, out], in f32 (JAX's f32-accumulating einsum)."""
    x, w = x.float(), w.float()
    return torch.bmm(x[:, None, :], w)[:, 0] if per_row else x @ w


def _ffn(ctx, x, w1, b1, w2, b2, w3, b3, per_row: bool):
    """One expert-FFN application (JAX's `_ffn`)."""
    h = _mm(x, w1, per_row)
    if b1 is not None:
        h = h + b1
    h = _activation(ctx, h)
    if w3 is not None:
        g = _mm(x, w3, per_row)
        if b3 is not None:
            g = g + b3
        h = h * g
    y = _mm(h.to(x.dtype), w2, per_row)
    if b2 is not None:
        y = y + b2
    return y


def _moe_core(ctx, x, logits, experts_w, dequant):
    """Shared MoE body. experts_w = (w1, b1, w2, b2, w3, b3) with the weight
    stacks in storage form; `dequant(stack, which)` maps a (gathered) stack
    to float [..., in, out]."""
    orig_shape = x.shape
    hidden = orig_shape[-1]
    x2 = x.reshape(-1, hidden)
    rows = x2.shape[0]
    w1s, b1, w2s, b2, w3s, b3 = experts_w
    n_experts = w1s.shape[0]
    weights, experts = _route(ctx, logits.reshape(rows, n_experts))
    k = weights.shape[-1]
    if rows * k <= n_experts:
        # decode path: gather the selected experts' weights per (row, slot)
        flat = experts.reshape(-1).long()
        xk = torch.repeat_interleave(x2, k, dim=0)

        def take(t):
            return None if t is None else t[flat]

        w3 = None if w3s is None else dequant(take(w3s), 2)
        y = _ffn(ctx, xk, dequant(take(w1s), 0), take(b1), dequant(take(w2s), 1), take(b2),
                 w3, take(b3), per_row=True)
        y = y.reshape(rows, k, hidden) * weights[..., None].to(y.dtype)
        out = y.sum(dim=1)
    else:
        # prefill path: a loop over the experts, masked accumulation
        out = torch.zeros((rows, hidden), dtype=torch.float32, device=x.device)
        for e in range(n_experts):
            y = _ffn(ctx, x2, dequant(w1s[e], 0), None if b1 is None else b1[e],
                     dequant(w2s[e], 1), None if b2 is None else b2[e],
                     None if w3s is None else dequant(w3s[e], 2),
                     None if b3 is None else b3[e], per_row=False)
            gate = torch.where(experts == e, weights, torch.zeros_like(weights)).sum(dim=-1)
            out = out + y * gate[:, None].to(y.dtype)
    return out.to(x.dtype).reshape(orig_shape)


@op("MoE", foldable=False, domain="com.microsoft")
def moe(ctx: OpContext, x, router_probs, fc1_w, fc1_b=None, fc2_w=None, fc2_b=None,
        fc3_w=None, fc3_b=None):
    """com.microsoft::MoE: float mixture-of-experts MLP. x [rows, hidden] or
    [B, S, hidden]; router_probs [rows, E] (logits); fc1 [E, hidden, inter]
    (+ bias [E, inter]); fc2 [E, inter, hidden]; optional fc3 [E, hidden,
    inter], the gate multiplied into the activated fc1 output."""
    if fc2_w is None:
        raise ValueError("MoE requires fc2_experts_weights")
    return _moe_core(ctx, x, router_probs, (fc1_w, fc1_b, fc2_w, fc2_b, fc3_w, fc3_b),
                     lambda w, which: w)


@op("QMoE", foldable=False, domain="com.microsoft")
def qmoe(ctx: OpContext, x, router_probs, fc1_w, fc1_scales, fc1_b=None, fc2_w=None,
         fc2_scales=None, fc2_b=None, fc3_w=None, fc3_scales=None, fc3_b=None):
    """com.microsoft::QMoE: MoE with 4- or 8-bit symmetric experts (the
    Phi-3.5-MoE-instruct ONNX release's node). Stacks are u8:
    `expert_weight_bits=8` one value a byte, zero point 128; `=4` two values
    a byte along the output axis, low nibble first, zero point 8. Scales are
    per expert and output column ([E, out]). On the decode path only the
    selected experts' bytes are dequantised."""
    if fc2_w is None or fc2_scales is None:
        raise ValueError("QMoE requires fc2_experts_weights and fc2_scales")
    if fc3_w is not None and fc3_scales is None:
        raise ValueError("QMoE: fc3_experts_weights requires fc3_scales")
    bits = int(ctx.attr("expert_weight_bits", 4))
    if bits not in (4, 8):
        raise NotImplementedError(f"QMoE: expert_weight_bits={bits} (must be 4 or 8)")
    return _qmoe_core(ctx, x, router_probs, bits, 1 << (bits - 1),
                      (fc1_w, fc1_scales, fc1_b), (fc2_w, fc2_scales, fc2_b),
                      None if fc3_w is None else (fc3_w, fc3_scales, fc3_b))


def qmoe_local(ctx: OpContext, x, router_probs, fc1_w, fc1_scales, fc1_b=None, fc2_w=None,
               fc2_scales=None, fc2_b=None, fc3_w=None, fc3_scales=None, fc3_b=None, *,
               e0: int, n_experts: int):
    """QMoE on a rank's experts e0 .. e0 + E_local - 1 of n_experts (the
    stacks given are that share): its part of the combine, which the ranks'
    all-reduce sums (parallel/placement.py)."""
    bits = int(ctx.attr("expert_weight_bits", 4))
    return _qmoe_core(ctx, x, router_probs, bits, 1 << (bits - 1),
                      (fc1_w, fc1_scales, fc1_b), (fc2_w, fc2_scales, fc2_b),
                      None if fc3_w is None else (fc3_w, fc3_scales, fc3_b), e0, n_experts)


def _q_mm(x, wq, s, bits: int, zp: int, per_row: bool):
    """The quantised product, dequantising only the stack it is given. 4-bit:
    output columns 2j come from the low-nibble plane and 2j + 1 from the high
    one, so each plane is one product and the small outputs interleave."""
    def col(sl):  # scale columns broadcast over the input axis
        return s[..., sl].unsqueeze(-2).float()

    if bits == 8:
        return _mm(x, (wq.float() - zp) * col(slice(None)), per_row)
    lo = ((wq & 0xF).float() - zp) * col(slice(0, None, 2))
    hi = ((wq >> 4).float() - zp) * col(slice(1, None, 2))
    h_lo, h_hi = _mm(x, lo, per_row), _mm(x, hi, per_row)
    return torch.stack([h_lo, h_hi], dim=-1).reshape(*h_lo.shape[:-1], h_lo.shape[-1] * 2)


def _q_ffn(ctx, x, fc1, fc2, fc3, bits: int, zp: int, per_row: bool):
    """The QMoE expert FFN over packed stacks fcN = (bytes, scales, bias),
    already gathered or sliced."""
    h = _q_mm(x, fc1[0], fc1[1], bits, zp, per_row)
    if fc1[2] is not None:
        h = h + fc1[2]
    h = _activation(ctx, h)
    if fc3 is not None:
        g = _q_mm(x, fc3[0], fc3[1], bits, zp, per_row)
        if fc3[2] is not None:
            g = g + fc3[2]
        h = h * g
    y = _q_mm(h.to(x.dtype), fc2[0], fc2[1], bits, zp, per_row)
    if fc2[2] is not None:
        y = y + fc2[2]
    return y


def _qmoe_core(ctx, x, logits, bits: int, zp: int, fc1, fc2, fc3, e0: int = 0,
               n_experts: int | None = None):
    """The QMoE body. With `e0` / `n_experts` the stacks hold experts e0 ..
    e0 + E_local - 1 of n_experts (a rank's share, parallel/placement.py):
    the routing is over every expert and the output is this share's part of
    the combine (the other experts' slots add nothing)."""
    orig_shape = x.shape
    hidden = orig_shape[-1]
    x2 = x.reshape(-1, hidden)
    rows = x2.shape[0]
    e_local = fc1[0].shape[0]
    n_experts = n_experts or e_local
    weights, experts = _route(ctx, logits.reshape(rows, n_experts))
    k = weights.shape[-1]
    if rows * k <= n_experts:
        flat = experts.reshape(-1).long()
        if e_local != n_experts:  # slots of other ranks' experts weigh nothing
            mine = (flat >= e0) & (flat < e0 + e_local)
            flat = torch.where(mine, flat - e0, torch.zeros_like(flat))
            weights = weights * mine.reshape(weights.shape).to(weights.dtype)

        def pick(fc):
            w, s, b = fc
            return w[flat], s[flat], None if b is None else b[flat]

        xk = torch.repeat_interleave(x2, k, dim=0)
        y = _q_ffn(ctx, xk, pick(fc1), pick(fc2), None if fc3 is None else pick(fc3), bits,
                   zp, per_row=True)
        y = y.reshape(rows, k, hidden) * weights[..., None].to(y.dtype)
        out = y.sum(dim=1)
    else:
        def sl(fc, e):
            w, s, b = fc
            return w[e], s[e], None if b is None else b[e]

        out = torch.zeros((rows, hidden), dtype=torch.float32, device=x.device)
        for e in range(e_local):
            y = _q_ffn(ctx, x2, sl(fc1, e), sl(fc2, e), None if fc3 is None else sl(fc3, e),
                       bits, zp, per_row=False)
            gate = torch.where(experts == e0 + e, weights, torch.zeros_like(weights)).sum(dim=-1)
            out = out + y * gate[:, None].to(y.dtype)
    return out.to(x.dtype).reshape(orig_shape)
