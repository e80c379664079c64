"""SenseVoice-style ASR encoder: f32/bf16, w8a16, w4a16, dynamic int8 and
MoE (counterpart of lele_tpu/models/sensevoice.py).

560-dim LFR fbank features → 4 prefix query frames → embed linear +
sinusoidal positions → N SAN-M blocks (self-attention + FSMN memory conv)
→ after_norm → CTC vocab head → greedy CTC decode.

On a CUDA tensor at batch 1 the routing is the JAX package's TPU routing
(models/sensevoice.py:328-345, 425-476). With w8-prepared params, stacked
layers go through the `sanm_stack_w8` kernel, per-layer params through
`sanm_layer_w8`, and the CTC head through the `w8_matmul` kernel. With
w4-prepared params (`weight_int4`), stacked layers go through the
`sanm_stack_w4` kernel where every linear's K/128 is even, other layers
take every linear through the `w4_matmul` kernel, and so does the CTC head.
The TPU's `hd % 128` condition is dropped: the layer kernel compiles head
dims 32, 64 and 128. On the CPU the same wrappers take their plain
versions. `plain=True` runs every kernel's plain version on any device: it
is the oracle the kernels are held against on the card, never the main
path.

Dynamic int8 (`quantized`, JAX's reference-parity mode): each layer linear
quantizes its whole activation tensor with ONNX DynamicQuantizeLinear and
runs the i8 product on kernel 11 (`int8_matmul`), or the whole linear on
kernel 5 (`fused_dq_matmul`) with `quant_pallas`; quantized layers never
take the layer or stack kernels, and the CTC head stays a plain linear.
`n_experts` gives every layer a top-1 MoE FFN (plain PyTorch, as JAX has no
kernel there). At batch > 1 (`transcribe_batch`, `transcribe_long`) the w8
and w4 models run per layer with kernels 2 and 7 at M = B·T rows: the layer
and stack kernels are batch-1 only, as the TPU's are.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.utils.checkpoint

from .. import default_device
from ..features import FbankConfig, FbankFrontend, fbank_features, fbank_features_batch
from ..kernels import (
    fused_dq_matmul,
    fused_dq_matmul_plain,
    fused_layer_available,
    int8_matmul,
    int8_matmul_plain,
    sanm_layer_w8,
    sanm_layer_w8_plain,
    sanm_stack_w4,
    sanm_stack_w4_plain,
    sanm_stack_w8,
    sanm_stack_w8_plain,
    w4_matmul,
    w4_matmul_plain,
    w8_matmul,
    w8_matmul_plain,
)
from ..kernels.quant_matmul import (
    dql_quantize,
    dql_scale_zp,
    align_rows,
    quantize_weight_int8,
)
from ..kernels.sanm_block import fsmn_conv, layer_kernel_takes, layer_view
from ..kernels.w4_matmul import quantize_weight_int4
from ..parallel.spmd import LOCAL, Axis, Layout, all_sum, col_linear, gather, row_linear, sum_grad
from ..runtime.bucketing import max_bucket_samples, pad_batch_pow2, pad_pcm
from ..runtime.graphs import Programs
from .common import (
    Params,
    init_layer_norm,
    init_linear,
    layer_norm,
    linear,
    positions_on,
    round_to,
)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclass
class SenseVoiceConfig:
    input_dim: int = 560  # 80 mel × LFR m=7
    d_model: int = 512
    n_heads: int = 4
    ffn_dim: int = 2048
    n_layers: int = 50
    fsmn_kernel: int = 11
    vocab_size: int = 25055
    n_prefix: int = 4  # language / event / emotion / textnorm query frames
    dropout: float = 0.0  # inference
    dtype: str = "bfloat16"
    quantized: bool = False  # dynamic-int8 linears (kernel 11)
    quant_pallas: bool = False  # quantized linears on kernel 5 instead
    weight_int4: bool = False  # w4a16: groupwise int4 weights (group 128)
    weight_int8: bool = False  # w8a16: int8 weights, per-output-channel scales
    fused_block: bool = True  # batch 1 + weight_int8/int4: the layer/stack kernels
    remat: bool = False  # recompute each block's activations in backward (training)
    n_experts: int = 0  # > 0: a top-1 mixture-of-experts FFN in every layer

    @property
    def compute_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]


def init_sensevoice(gen: torch.Generator, cfg: SenseVoiceConfig) -> Params:
    """Random f32 params on `gen`'s device, shapes and scales as the JAX init
    (with `n_experts`, every layer gets a `moe` subtree, as JAX's loop does)."""
    dev = gen.device
    p: Params = {
        "embed": init_linear(gen, cfg.input_dim, cfg.d_model),
        "prefix": torch.randn((cfg.n_prefix, cfg.input_dim), generator=gen,
                              device=dev) * 0.02,
        "after_norm": init_layer_norm(gen, cfg.d_model),
        "ctc": init_linear(gen, cfg.d_model, cfg.vocab_size),
        "layers": [],
    }
    d = cfg.d_model
    for _ in range(cfg.n_layers):
        p["layers"].append({
            "norm1": init_layer_norm(gen, d),
            "qkv": init_linear(gen, d, 3 * d),
            "fsmn": {"w": torch.randn((cfg.fsmn_kernel, d), generator=gen, device=dev)
                     * (1.0 / np.sqrt(cfg.fsmn_kernel))},
            "out": init_linear(gen, d, d),
            "norm2": init_layer_norm(gen, d),
            "ffn1": init_linear(gen, d, cfg.ffn_dim),
            "ffn2": init_linear(gen, cfg.ffn_dim, d),
        })
        if cfg.n_experts > 0:
            E, f = cfg.n_experts, cfg.ffn_dim
            p["layers"][-1]["moe"] = {
                "router": init_linear(gen, d, E, bias=False),
                "w1": torch.randn((E, d, f), generator=gen, device=dev) * (1.0 / np.sqrt(d)),
                "w2": torch.randn((E, f, d), generator=gen, device=dev) * (1.0 / np.sqrt(f)),
            }
    return p


def moe_ffn(p: Params, x: torch.Tensor, cfg: SenseVoiceConfig,
            ax: Axis = LOCAL.model) -> torch.Tensor:
    """Top-1 routed mixture-of-experts FFN, dense dispatch: every expert
    computes, a one-hot contraction selects, and the output is gated by the
    chosen expert's probability (JAX `moe_ffn`). With the experts split
    over `ax` (parallel/spmd.py) the rank runs its own, the router whole,
    and the one-hot combine is summed over the axis."""
    probs = torch.softmax(linear(p["router"], x).float(), dim=-1)  # [B, T, E]
    # one-hot by comparison: torch.nn.functional.one_hot may check its input
    # on the host, which a CUDA graph capture refuses
    experts = torch.arange(cfg.n_experts, device=x.device)
    onehot = (probs.argmax(dim=-1)[..., None] == experts).to(x.dtype)
    gate = (probs * onehot).sum(dim=-1, keepdim=True)
    e = p["w1"].shape[0]
    e0 = ax.rank * e
    h = torch.relu(torch.einsum("btd,edf->btef", sum_grad(x, ax).float(), p["w1"].float()))
    y = torch.einsum("btef,efd->bted", h, p["w2"].float())
    y = torch.einsum("bted,bte->btd", y, onehot[..., e0:e0 + e].to(y.dtype))
    return all_sum(y, ax) * gate.to(y.dtype)


_W8_LINEAR_KEYS = ("qkv", "out", "ffn1", "ffn2", "ctc")


def _prepare(params: Params, prep) -> Params:
    """`prep` applied to every big linear (layer linears and CTC head)."""
    def walk(tree):
        if isinstance(tree, dict):
            return {k: (prep(v) if k in _W8_LINEAR_KEYS and isinstance(v, dict)
                        and "w" in v else walk(v))
                    for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v) for v in tree]
        return tree

    return walk(params)


def prepare_w8_params(params: Params, drop_fp: bool = True) -> Params:
    """Per-output-channel symmetric int8 quantisation of every big linear
    (layer linears and CTC head) into "wq8"/"ws8"; with drop_fp the float
    weight is removed. The CTC head's weight (25,055 columns: rows not a
    multiple of 16 bytes) is kept as a [K, N] view of zero-padded rows,
    which kernel 2 loads by TMA as it lies; the layer weights stay
    contiguous, as the layer and stack kernels read them."""
    def prep(p):
        wq, scale = quantize_weight_int8(p["w"], axis=0)
        out = dict(p)
        out["wq8"] = wq
        out["ws8"] = scale
        if drop_fp:
            del out["w"]
        return out

    out = _prepare(params, prep)
    if "wq8" in out.get("ctc", {}):
        out["ctc"]["wq8"] = align_rows(out["ctc"]["wq8"])
    return out


def prepare_w4_params(params: Params, drop_fp: bool = True, group: int = 128) -> Params:
    """Groupwise symmetric int4 quantisation of every big linear into
    "wq4" (packed int8 [K/2, N]) and "ws4" (f32 [K/group, N]); with drop_fp
    the float weight is removed."""
    def prep(p):
        wq, scale = quantize_weight_int4(p["w"], group=group)
        out = dict(p)
        out["wq4"] = wq
        out["ws4"] = scale
        if drop_fp:
            del out["w"]
        return out

    return _prepare(params, prep)


_QUANT_LINEAR_KEYS = ("qkv", "out", "ffn1", "ffn2")  # the CTC head stays f32


def _quantize_per_tensor(w: torch.Tensor):
    """Symmetric per-tensor int8: (wq int8, w_scale 0-d, colsum int32 [N]),
    in the weight's own type as JAX's (a bf16 master gives a bf16 scale).
    The scale is a device divisor: on a card torch divides by a host scalar
    as a multiplication by its reciprocal."""
    absmax = w.abs().max()
    w_scale = absmax / torch.full_like(absmax, 127.0)
    wq = torch.clamp(torch.round(w / w_scale), -127, 127).to(torch.int8)
    return wq, w_scale, wq.to(torch.int32).sum(dim=0, dtype=torch.int32)


def prepare_quantized_params(params: Params, drop_fp: bool = False) -> Params:
    """Per-tensor symmetric int8 of every layer linear, once: "wq" int8,
    "wscale" (a 0-d device tensor) and "wcolsum" int32 [N] for the
    zero-point correction; with drop_fp the float weight is removed."""
    def walk(tree):
        if isinstance(tree, dict):
            out = {}
            for k, v in tree.items():
                if k in _QUANT_LINEAR_KEYS and isinstance(v, dict) and "w" in v:
                    v = dict(v)
                    v["wq"], v["wscale"], v["wcolsum"] = _quantize_per_tensor(v["w"])
                    if drop_fp:
                        del v["w"]
                    out[k] = v
                else:
                    out[k] = walk(v)
            return out
        if isinstance(tree, list):
            return [walk(v) for v in tree]
        return tree

    return walk(params)


def stack_layer_params(params: Params) -> Params:
    """[{layer}, ...] → one tree with a leading layer axis on every leaf
    ("layers_stacked"). Run once at load time: it copies every weight."""
    def stack(*xs):
        if isinstance(xs[0], dict):
            return {k: stack(*(x[k] for x in xs)) for k in xs[0]}
        return torch.stack(xs)

    out = {k: v for k, v in params.items() if k != "layers"}
    out["layers_stacked"] = stack(*params["layers"])
    return out


_KERNELS = {"w8": w8_matmul, "layer": sanm_layer_w8, "stack": sanm_stack_w8,
            "w4": w4_matmul, "stack4": sanm_stack_w4, "i8": int8_matmul,
            "dq": fused_dq_matmul}
_PLAIN = {"w8": w8_matmul_plain, "layer": sanm_layer_w8_plain, "stack": sanm_stack_w8_plain,
          "w4": w4_matmul_plain, "stack4": sanm_stack_w4_plain, "i8": int8_matmul_plain,
          "dq": fused_dq_matmul_plain}


def _ops(plain: bool) -> dict:
    """The kernel wrappers, or their plain versions, by role."""
    return _PLAIN if plain else _KERNELS


def _w8_linear(p: Params, x: torch.Tensor, dtype: torch.dtype, w8=w8_matmul):
    lead = x.shape[:-1]
    y = w8(x.reshape(-1, x.shape[-1]).to(dtype), p["wq8"], p["ws8"])
    y = y.reshape(*lead, p["wq8"].shape[-1])
    if "b" in p:
        y = y + p["b"]
    return y


def _w4_linear(p: Params, x: torch.Tensor, dtype: torch.dtype, group: int = 128,
               w4=w4_matmul):
    """Weight-only groupwise int4 linear (w4a16) through `w4`."""
    lead = x.shape[:-1]
    y = w4(x.reshape(-1, x.shape[-1]).to(dtype), p["wq4"], p["ws4"], group)
    y = y.reshape(*lead, p["wq4"].shape[-1])
    if "b" in p:
        y = y + p["b"]
    return y


def _quant_linear(p: Params, x: torch.Tensor, ops: dict, fused: bool = False):
    """Dynamic-int8 linear (JAX `_quant_linear`): x's whole tensor quantized
    by ONNX DynamicQuantizeLinear (one scale and zero point over every row,
    the padding and the batch's other rows included, as in JAX), the prepared
    weight ("wq", "wscale", "wcolsum"; else the f32 weight quantized per
    tensor here, each call). The i8 product runs on kernel 11 over the
    flattened rows; the zero-point correction and the dequant follow in
    JAX's order. `fused` runs the whole linear on kernel 5 instead."""
    if "wq" in p:
        wi, w_scale, colsum = p["wq"], p["wscale"], p["wcolsum"]
    else:
        wi, w_scale, colsum = _quantize_per_tensor(p["w"])
    xf = x.float()
    lead, K, N = x.shape[:-1], x.shape[-1], wi.shape[-1]
    a_scale, a_zp = dql_scale_zp(xf)
    if fused:
        y = ops["dq"](xf.reshape(-1, K), wi, colsum, a_scale, a_zp, w_scale.float())
    else:
        ai = (dql_quantize(xf, a_scale, a_zp) - 128.0).to(torch.int8)
        c = ops["i8"](ai.reshape(-1, K), wi)
        c = c - (a_zp - 128.0).to(torch.int32) * colsum.reshape(1, -1)
        y = c.float() * (a_scale * w_scale)
    y = y.reshape(*lead, N)
    if "b" in p:
        y = y + p["b"]
    return y


def _w4_stack_gate(cfg: SenseVoiceConfig, stacked: Params, B: int) -> bool:
    """The JAX package's gate for the w4 stack (models/sensevoice.py:442-450):
    batch 1, w4-prepared linears, no MoE, and every linear's K/128 even (a
    scale group must not straddle the nibble planes); the layer kernel's
    head dims stand in for the TPU's hd % 128."""
    return (cfg.weight_int4 and cfg.fused_block and B == 1
            and "wq4" in stacked.get("qkv", {}) and "moe" not in stacked
            and layer_kernel_takes(cfg)
            and (cfg.d_model // 128) % 2 == 0
            and cfg.ffn_dim % 128 == 0
            and (cfg.ffn_dim // 128) % 2 == 0)


def _fsmn_frames(vm: torch.Tensor, w: torch.Tensor, off: int, t: int) -> torch.Tensor:
    """`fsmn_conv` at frames [off, off + t) of the whole masked values `vm`:
    the conv on that window with its (k-1)/2 frames of halo each side."""
    if off == 0 and t == vm.shape[1]:
        return fsmn_conv(vm, w)
    k = w.shape[0]
    pad = (k - 1) // 2
    win = torch.nn.functional.pad(vm, (0, 0, pad, k - 1 - pad))[:, off:off + t + k - 1]
    return fsmn_conv(win, w)[:, pad:pad + t]


def sanm_block(p: Params, x: torch.Tensor, mask: torch.Tensor, cfg: SenseVoiceConfig,
               plain: bool = False, lay: Layout = LOCAL) -> torch.Tensor:
    """SAN-M: multi-head self-attention + FSMN memory conv on values.

    x: [B, T, D]; mask: [B, T] (1 = valid). Pre-norm residual wiring.
    Under a sharded `lay` (the unquantized model, parallel/spmd.py) x holds
    this rank's frames, mask every frame's, and p this rank's shards of the
    layer; under LOCAL every collective is the identity."""
    dt = cfg.compute_dtype
    B, T, D = x.shape
    ops = _ops(plain)
    if cfg.weight_int8 and cfg.fused_block and B == 1 and fused_layer_available(cfg, p):
        y = ops["layer"](x[0].float(), mask[0].float(), p, cfg.n_heads, cfg.fsmn_kernel)
        return y[None].to(x.dtype)
    if cfg.quantized:
        def lin(pp, v):
            return _quant_linear(pp, v, ops, fused=cfg.quant_pallas)
    elif cfg.weight_int4:
        def lin(pp, v):
            return (_w4_linear(pp, v, dt, w4=ops["w4"]) if "wq4" in pp
                    else linear(pp, v, dtype=dt))
    elif cfg.weight_int8:
        def lin(pp, v):
            return _w8_linear(pp, v, dt, ops["w8"]) if "wq8" in pp else linear(pp, v, dtype=dt)
    else:
        def lin(pp, v):
            return linear(pp, v, dtype=dt)
    H = cfg.n_heads
    hd = D // H
    m, s = lay.model, lay.seq
    sizes = lay.frames(mask.shape[1], cfg.n_prefix)

    h = layer_norm(p["norm1"], x)
    if lay.splits("out/w"):  # D divides "model": qkv, out and fsmn all split
        c0 = m.rank * (D // m.size)
        c1 = c0 + D // m.size
        qkv = gather(lin(p["qkv"], sum_grad(h, m)), m, dim=-1, reduce=True)
    else:
        c0, c1 = 0, D
        qkv = col_linear(lin, p["qkv"], lay.splits("qkv/w"), h, m)
    h0, h1 = c0 // hd, -(-c1 // hd)  # the heads that hold channels [c0, c1)
    q, k, v = (a[..., h0 * hd:h1 * hd] for a in qkv.float().split(D, dim=-1))
    k, v = (gather(a, s, dim=1, reduce=True, sizes=sizes) for a in (k, v))
    fsmn = _fsmn_frames(v[..., c0 - h0 * hd:c1 - h0 * hd] * mask[..., None], p["fsmn"]["w"],
                        sum(sizes[:s.rank]), T)
    nh = h1 - h0

    def heads(a):  # [B, T, nh·hd] → [B, nh, T, hd]
        return round_to(a, dt).reshape(B, a.shape[1], nh, hd).transpose(1, 2)

    scores = (heads(q) @ heads(k).transpose(-1, -2)) / math.sqrt(hd)
    scores = torch.where(mask[:, None, None, :] > 0, scores,
                         torch.full_like(scores, -1e9))
    attn = torch.softmax(scores, dim=-1)
    ctx = (round_to(attn, dt) @ heads(v)).transpose(1, 2).reshape(B, T, nh * hd)
    a = ctx[..., c0 - h0 * hd:c1 - h0 * hd] + fsmn
    if lay.splits("out/w"):
        x = x + row_linear(lin, p["out"], a, m).to(x.dtype)
    else:
        x = x + lin(p["out"], a).to(x.dtype)

    h2 = layer_norm(p["norm2"], x)
    if cfg.n_experts > 0 and "moe" in p:
        ff = moe_ffn(p["moe"], h2, cfg, m if lay.splits("moe/w1") else LOCAL.model)
    elif lay.splits("ffn1/w"):
        ff = row_linear(lin, p["ffn2"], torch.relu(lin(p["ffn1"], sum_grad(h2, m))), m)
    else:
        ff = lin(p["ffn2"], torch.relu(lin(p["ffn1"], h2)))
    return x + ff.to(x.dtype)


def _block(lp: Params, x: torch.Tensor, mask: torch.Tensor, cfg: SenseVoiceConfig,
           plain: bool, lay: Layout) -> torch.Tensor:
    """sanm_block; under cfg.remat (where a gradient is recorded) its
    activations recomputed in backward, as JAX's jax.checkpoint of each
    block (lele_tpu/models/sensevoice.py:416-421)."""
    if cfg.remat and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(sanm_block, lp, x, mask, cfg, plain, lay,
                                                 use_reentrant=False)
    return sanm_block(lp, x, mask, cfg, plain, lay)


def sensevoice_encode(p: Params, feats: torch.Tensor, mask: torch.Tensor,
                      cfg: SenseVoiceConfig, plain: bool = False,
                      lay: Layout = LOCAL) -> torch.Tensor:
    """feats: [B, T, 560]; mask: [B, T] → logits f32 [B, T+4, vocab].

    Under a sharded `lay` (the unquantized model, parallel/spmd.py): this
    rank's rows, frames and shards → the logits of its frames (seq rank 0's
    begin with the prefix), whole over "model"."""
    if lay is not LOCAL and (cfg.quantized or cfg.weight_int8 or cfg.weight_int4):
        raise ValueError("the sharded forward runs the unquantized model")
    B, T, _ = feats.shape
    ops = _ops(plain)
    s = lay.seq
    x = feats.float()
    if cfg.n_prefix > 0 and s.rank == 0:
        prefix = p["prefix"][: cfg.n_prefix].float().expand(B, cfg.n_prefix, cfg.input_dim)
        x = torch.cat([prefix, x], dim=1)
        mask = torch.cat([torch.ones((B, cfg.n_prefix), dtype=mask.dtype,
                                     device=mask.device), mask], dim=1)
    sizes = lay.frames(T * s.size + cfg.n_prefix, cfg.n_prefix)
    off = sum(sizes[:s.rank])
    mask = gather(mask, s, dim=1, reduce=False, sizes=sizes)  # every frame's
    Tt = mask.shape[1]
    x = x * (cfg.d_model**0.5) / (cfg.input_dim**0.5)
    x = linear(p["embed"], x, dtype=cfg.compute_dtype).float()
    x = x + positions_on(Tt, cfg.d_model, x.device)[off:off + x.shape[1]]
    if "layers_stacked" in p:
        stacked = p["layers_stacked"]
        if (cfg.weight_int8 and cfg.fused_block and B == 1
                and fused_layer_available(cfg, stacked)):
            x = ops["stack"](x[0], mask[0].float(), stacked, cfg.n_heads,
                             cfg.fsmn_kernel)[None]
        elif _w4_stack_gate(cfg, stacked, B):
            x = ops["stack4"](x[0], mask[0].float(), stacked, cfg.n_heads,
                              cfg.fsmn_kernel)[None]
        else:
            for i in range(stacked["norm1"]["g"].shape[0]):
                x = _block(layer_view(stacked, i), x, mask, cfg, plain, lay)
    else:
        for i, lp in enumerate(p["layers"]):
            x = _block(lp, x, mask, cfg, plain, lay.at(f"layers/{i}/"))
    x = layer_norm(p["after_norm"], x)
    if cfg.weight_int4 and "wq4" in p["ctc"]:
        logits = _w4_linear(p["ctc"], x, cfg.compute_dtype, w4=ops["w4"])
    elif cfg.weight_int8 and "wq8" in p["ctc"]:
        logits = _w8_linear(p["ctc"], x, cfg.compute_dtype, ops["w8"])
    else:
        logits = col_linear(lambda pp, v: linear(pp, v, dtype=cfg.compute_dtype), p["ctc"],
                            lay.splits("ctc/w"), x, lay.model)
    return logits.float()


@dataclass
class SenseVoiceModel:
    """Front-end + encoder on one device; `forward_fn()(params, pcm)` runs
    waveform → logits with no host round trip. `device` defaults to
    `default_device()`, which raises where there is no CUDA card: the CPU
    is taken only when the caller passes device="cpu".

    `transcribe_ids`, `transcribe_batch` and `transcribe_long` run one
    program a bucket (JAX's `_fn_cache` of jitted functions): the front-end,
    the encoder and the per-frame argmax, keyed by the batch and the padded
    length, with the valid lengths a device input, so one program serves
    every length of a bucket. On a card each is one CUDA graph, captured at
    its first use (runtime/graphs.py); on the CPU it runs eagerly. The
    `forward_*_fn()` functions are the uncaptured oracles."""

    cfg: SenseVoiceConfig = field(default_factory=SenseVoiceConfig)
    params: Params | None = None
    fbank: FbankFrontend | None = None
    device: torch.device | str | None = None
    programs: Programs | None = field(default=None, init=False, repr=False)

    def __post_init__(self):
        self.device = torch.device(self.device) if self.device is not None else default_device()
        if self.fbank is None:
            self.fbank = FbankFrontend(FbankConfig(), self.device)
        if self.programs is None:
            self.programs = Programs(self.device)

    def init(self, seed: int = 0) -> Params:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        self.params = init_sensevoice(gen, self.cfg)
        return self.params

    def features(self, pcm):
        return self.fbank(pcm)

    def forward_fn(self, plain: bool = False):
        """(params, pcm [n]) → logits [1, T+4, vocab]."""
        cfg, fbank = self.cfg, self.fbank

        @torch.inference_mode()
        def fn(params, pcm):
            feats = fbank(pcm)[None]
            mask = torch.ones(feats.shape[:2], dtype=torch.float32, device=feats.device)
            return sensevoice_encode(params, feats, mask, cfg, plain=plain)

        return fn

    def forward_bucketed_fn(self, plain: bool = False):
        """(params, pcm_padded, n_valid) → (logits, frame_mask): masked CMVN
        and attention, so the bucket's padding never reaches the valid frames."""
        cfg, fb = self.cfg, self.fbank

        @torch.inference_mode()
        def fn(params, pcm, n_valid):
            feats, fmask = fbank_features(pcm, fb.config, fb.window, fb.mel_t,
                                          n_valid=n_valid)
            logits = sensevoice_encode(params, feats[None], fmask[None], cfg, plain=plain)
            return logits, fmask

        return fn

    def forward_batch_fn(self, plain: bool = False):
        """(params, pcm [B, n] padded, n_valid [B]) → (logits [B, T+4, vocab],
        frame masks [B, T]): the batched front-end, then one encode of the
        whole batch (JAX `_batched_ids`' traced body, before its argmax)."""
        cfg, fb = self.cfg, self.fbank

        @torch.inference_mode()
        def fn(params, pcm_b, n_valid_b):
            feats, masks = fbank_features_batch(pcm_b, fb.config, fb.window, fb.mel_t,
                                                n_valid_b)
            return sensevoice_encode(params, feats, masks, cfg, plain=plain), masks

        return fn

    def transcribe_long(self, pcm: np.ndarray, blank_id: int = 0, window_s: float = 30.0,
                        overlap_s: float = 2.0, sr: int = 16000) -> list[int]:
        """Long-form audio: overlapping windows decoded as one batch; each
        window drops its margin frames (half the overlap) before its own CTC
        collapse, so a token repeated across a seam is kept twice, as in JAX.
        Audio of at most one window goes to `transcribe_ids`."""
        win = int(window_s * sr)
        if len(pcm) <= win:
            return self.transcribe_ids(pcm, blank_id)
        c = self.fbank.config
        margin_frames = int(overlap_s * sr / 2 / c.hop_len / c.lfr_n)
        pieces, starts = self.long_windows(pcm, window_s, overlap_s, sr)
        ids: list[int] = []
        for (frame_ids, valid), s0 in zip(self._batched_window_ids(pieces, win), starts):
            lo = margin_frames if s0 > 0 else 0
            hi = valid - (margin_frames if s0 + win < len(pcm) else 0)
            ids.extend(_collapse_ids(frame_ids[lo:hi], blank_id))
        return ids

    def long_windows(self, pcm: np.ndarray, window_s: float = 30.0, overlap_s: float = 2.0,
                     sr: int = 16000):
        """The windows of `transcribe_long`: (pieces, start samples), a hop of
        window − overlap, up to a last piece of at least one frame."""
        win = int(window_s * sr)
        hop = win - int(overlap_s * sr)
        pieces, starts = [], []
        start = 0
        while start < len(pcm):
            piece = pcm[start:start + win]
            if len(piece) < self.fbank.config.frame_len:
                break
            pieces.append(np.asarray(piece, np.float32))
            starts.append(start)
            start += hop
        return pieces, starts

    def _ids_fn(self):
        """The body of the bucketed and batched programs: (pcm [B, n] padded,
        n_valid [B] int64) → (per-frame ids [B, T] int32, frame masks [B,
        T]), the argmax on the device (JAX `_batched_ids`' traced body)."""
        params, cfg, fb = self.params, self.cfg, self.fbank

        def fn(pcm_b, n_valid_b):
            feats, masks = fbank_features_batch(pcm_b, fb.config, fb.window, fb.mel_t,
                                                n_valid_b)
            logits = sensevoice_encode(params, feats, masks, cfg)
            return logits[:, cfg.n_prefix:].argmax(dim=-1).to(torch.int32), masks

        return fn

    def _run_ids(self, batch: np.ndarray, lens) -> tuple[torch.Tensor, torch.Tensor]:
        """`_ids_fn` through the program of (B, n)."""
        if self.params is None:
            self.init()
        return self.programs.run(("ids",) + batch.shape, self._ids_fn, batch,
                                 np.asarray(lens, np.int64).reshape(-1), params=self.params)

    def _batched_ids(self, batch: np.ndarray, lens: np.ndarray):
        """[B, n] padded PCM + [B] valid lengths → (per-frame ids [B, T] int32,
        masks [B, T]), numpy; the argmax runs on the device, so only the ids
        and masks come back."""
        ids, masks = self._run_ids(batch, lens)
        return ids.cpu().numpy(), masks.cpu().numpy()

    def _batched_window_ids(self, pieces, win: int):
        """Windows zero-padded to `win` samples, one batch (no batch bucket,
        as in JAX) → [(frame ids, valid frames)] per window."""
        ids, masks = self._batched_ids(*pad_rows(pieces, win))
        return [(ids[i], int(masks[i].sum())) for i in range(len(pieces))]

    def transcribe_ids(self, pcm: np.ndarray, blank_id: int = 0) -> list[int]:
        """Bucketed waveform → token ids; the per-frame argmax runs on the
        device, so only [T] int32 comes back. Audio longer than the largest
        bucket goes to `transcribe_long`."""
        if len(pcm) > max_bucket_samples():
            return self.transcribe_long(pcm, blank_id)
        frame_ids, valid = self._bucketed_argmax(pcm)
        return _collapse_ids(frame_ids[:valid], blank_id)

    def _bucketed_argmax(self, pcm: np.ndarray):
        """The bucket's program at B = 1 (JAX `_bucketed_argmax`) → (per-frame
        ids [T], valid frames)."""
        padded, true_len = pad_pcm(np.asarray(pcm, np.float32))
        ids, fmask = self._run_ids(padded[None], [true_len])
        return ids[0].cpu().numpy(), int(fmask.sum().item())

    def batch_inputs(self, pcms: list[np.ndarray]):
        """Utterances (each within the largest bucket) → (pcm [B', n], n_valid
        [B']): zero-padded to the bucket of the longest, B' = pad_batch_pow2(B);
        the padding rows have n_valid = 0 and decode to nothing."""
        bucket = len(pad_pcm(np.zeros(max(len(p) for p in pcms), np.float32))[0])
        empty = [np.zeros(0, np.float32)] * (pad_batch_pow2(len(pcms)) - len(pcms))
        return pad_rows(list(pcms) + empty, bucket)

    def transcribe_batch(self, pcms: list[np.ndarray], blank_id: int = 0) -> list[list[int]]:
        """Utterances padded to one shared bucket and run as one batch. If
        any is longer than the largest bucket, each goes to
        `transcribe_long` on its own, as in JAX."""
        if not pcms:
            return []
        if max(len(p) for p in pcms) > max_bucket_samples():
            return [self.transcribe_long(p, blank_id) for p in pcms]
        ids_b, masks = self._batched_ids(*self.batch_inputs(pcms))
        return [_collapse_ids(ids_b[i, :int(masks[i].sum())], blank_id)
                for i in range(len(pcms))]


def pad_rows(pcms, n: int):
    """PCM pieces zero-padded to n samples → (pcm [B, n], n_valid [B])."""
    batch = np.zeros((len(pcms), n), np.float32)
    lens = np.zeros((len(pcms),), np.int32)
    for i, p in enumerate(pcms):
        batch[i, :len(p)] = p
        lens[i] = len(p)
    return batch, lens


def _collapse_ids(frame_ids, blank_id: int = 0) -> list[int]:
    """CTC collapse: drop repeats, then blanks."""
    out = []
    prev = -1
    for t in np.asarray(frame_ids).reshape(-1):
        t = int(t)
        if t != prev and t != blank_id:
            out.append(t)
        prev = t
    return out


def greedy_ctc_decode(logits, blank_id: int = 0) -> list[int]:
    """Greedy CTC: argmax per frame, collapse repeats, drop blanks."""
    if isinstance(logits, torch.Tensor):
        logits = logits.detach().cpu().numpy()
    return _collapse_ids(np.asarray(logits).argmax(-1), blank_id)
