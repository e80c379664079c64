"""Supertonic-style TTS, text → acoustic latent → waveform (counterpart of
lele_tpu/models/supertonic.py).

Four sub-models chained: DurationPredictor, TextEncoder, VectorEstimator
(flow matching, 5 Euler steps) and Vocoder (256x upsampling to 24 kHz),
behind the UnicodeProcessor text pipeline, per-voice style vectors from
JSON, noisy-latent sampling and the latent mask + normalizer-scale denorm.
Supertonic 3 is the same pipeline without the mask/denorm block, at speed
1.05.

The text pipeline is a pure-Python copy of the JAX module's: its output is
the same string and the same ids. Params are nested dicts of tensors in the
JAX package's layouts (linear [in, out], conv [C_out, C_in, k], transposed
conv [k, C_in, C_out]); `init` draws the same shapes and distributions from
a `torch.Generator`, and `supertonic_params_from_jax` carries JAX weights
across. The estimator also holds its blocks stacked and cast to bf16 once
(`"blocks_stacked"`, kernels/est_block.stack_est_blocks): with
`cfg.fused_estimator` at batch 1 the 2L attention blocks of each flow step
are one call of kernel 10 (`estimator_blocks`), and on the CPU its plain
version. The JAX package's lane-packed vocoder (models/packed1d.py) is a
TPU layout: the port runs the plain conv path and owes only its output.

`synthesize` runs one program a chunk (JAX's `synth_fn` / `synth_e2e_fn`,
one jitted program a latent bucket): on a card each is captured once a
(kind, token bucket, latent bucket) and replayed after (runtime/graphs.py);
on the CPU its function runs eagerly. Its default route
(`fused_duration=True`) computes the durations, the frame count and the
latent mask inside the synth program at a guessed bucket and takes the
result from the bucket the durations map to, re-dispatching once where
the guess missed, as JAX does; `fused_duration=False` runs the duration
program, JAX's host formula and the synth program. Both give JAX's audio
for its two routes. `synthesize_uncaptured` runs the same functions
eagerly: the captured route's oracle.

The noise is drawn outside any program, from a `torch.Generator` seeded
from `seed`, at the largest latent bucket; a program takes its prefix as
an input, so a seed gives the same audio whatever the bucket. `jax.random`
bits cannot be drawn in torch, so `synthesize` and the synth core also take
the noise as a tensor (`noise=`): a seam the parity tests use to pass JAX's
noise. The flow steps' times are device constants made once.
"""

from __future__ import annotations

import json
import re
import unicodedata
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from .. import default_device
from ..kernels.est_block import estimator_blocks, stack_est_blocks
from ..params import from_numpy_tree
from ..runtime.graphs import Programs
from .common import (
    Params,
    conv1d,
    conv_transpose1d,
    init_conv1d,
    init_layer_norm,
    init_linear,
    layer_norm,
    linear,
    positions_on,
    round_to,
)

# ---------------------------------------------------------------------------
# Config (tts.json schema: nested {ae:{...}, ttl:{...}} or flat layouts)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


@dataclass
class SupertonicConfig:
    vocab_size: int = 512
    d_text: int = 256
    d_latent: int = 64
    d_style: int = 128
    n_text_layers: int = 4
    n_est_layers: int = 4
    n_heads: int = 4
    ffn_mult: int = 4
    flow_steps: int = 5
    frames_per_second: float = 93.75  # 24000 / 256
    sample_rate: int = 24000
    hop: int = 256  # vocoder upsampling factor
    normalizer_scale: float = 1.0
    speed: float = 1.0
    latent_buckets: tuple = (64, 128, 256, 512, 1024)
    token_buckets: tuple = (48, 96, 160, 256, 320)
    est_frames_per_token: float = 8.0  # the cold prior of the fused-duration
    #   route's bucket guess (`SupertonicTts._fpt_ema` takes over)
    apply_latent_denorm: bool = True  # Supertonic 2; v3 skips it
    fused_estimator: bool = False  # the 2L estimator blocks on kernel 10
    dtype: str = "float32"  # product dtype of the unfused attention blocks

    @classmethod
    def from_json(cls, path: str | Path) -> "SupertonicConfig":
        raw = json.loads(Path(path).read_text())
        flat: dict = {}
        for section in ("ae", "ttl", "dp"):
            if isinstance(raw.get(section), dict):
                flat.update(raw[section])
        flat.update({k: v for k, v in raw.items() if not isinstance(v, dict)})
        known = set(cls.__dataclass_fields__)
        return cls(**{k: v for k, v in flat.items() if k in known})

    @property
    def compute_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]


# ---------------------------------------------------------------------------
# Text pipeline (UnicodeProcessor analog)

#: Languages the published Supertonic checkpoints accept.
AVAILABLE_LANGS = ("en", "ko", "es", "pt", "fr", "zh")


def is_valid_lang(lang: str) -> bool:
    return lang in AVAILABLE_LANGS


# Emoji block ranges, exactly the reference's class.
_EMOJI_RE = re.compile(
    "["
    "\U0001F600-\U0001F64F"  # emoticons
    "\U0001F300-\U0001F5FF"  # symbols & pictographs
    "\U0001F680-\U0001F6FF"  # transport & map
    "\U0001F700-\U0001F77F"  # alchemical
    "\U0001F780-\U0001F7FF"  # geometric shapes ext
    "\U0001F800-\U0001F8FF"  # supplemental arrows-C
    "\U0001F900-\U0001F9FF"  # supplemental symbols
    "\U0001FA00-\U0001FA6F"  # chess symbols
    "\U0001FA70-\U0001FAFF"  # symbols ext-A
    "☀-⛿"          # misc symbols
    "✀-➿"          # dingbats
    "\U0001F1E6-\U0001F1FF"  # regional indicators
    "]+"
)

# Character replacements, applied IN ORDER, each a global replace; order and
# completeness decide the token ids on the real unicode_indexer.json.
_REPLACEMENTS = (
    ("–", "-"),   # – en dash
    ("‑", "-"),   # ‑ non-breaking hyphen
    ("—", "-"),   # — em dash
    ("_", " "),
    ("“", '"'),   # " left curly
    ("”", '"'),   # " right curly
    ("‘", "'"),   # ' left curly
    ("’", "'"),   # ' right curly
    ("´", "'"),   # ´ acute (unreachable post-NFKD; kept for parity)
    ("`", "'"),
    ("[", " "),
    ("]", " "),
    ("|", " "),
    ("/", " "),
    ("#", " "),
    ("→", " "),   # →
    ("←", " "),   # ←
)

# Symbols deleted outright.
_SPECIAL_STRIP = ("♥", "☆", "♡", "©", "\\")  # ♥ ☆ ♡ © \

_WS_RE = re.compile(r"\s+")

# Wide terminal-punctuation class: ASCII sentence punctuation, quotes,
# closing brackets, and CJK terminators/quote-closers.
_ENDS_WITH_PUNCT = re.compile(
    "[.!?;:,'\"“”‘’)\\]}"
    "…。」』】〉》›»]$"
)


def normalize_text(text: str, lang: str = "en") -> str:
    """NFKD → emoji-range removal → ordered replacement table → special-symbol
    strip → whitespace collapse + trim → wide terminal-punctuation check →
    lang validation → ``<lang>…</lang>`` wrap; the JAX package's string,
    byte for byte."""
    s = unicodedata.normalize("NFKD", text)
    s = _EMOJI_RE.sub("", s)
    for src, dst in _REPLACEMENTS:
        s = s.replace(src, dst)
    for sym in _SPECIAL_STRIP:
        s = s.replace(sym, "")
    # lone surrogates cannot round-trip UTF-8
    s = "".join(ch for ch in s if not 0xD800 <= ord(ch) <= 0xDFFF)
    s = _WS_RE.sub(" ", s).strip()
    if s and not _ENDS_WITH_PUNCT.search(s):
        s += "."
    if not is_valid_lang(lang):
        raise ValueError(
            f"Invalid language: {lang}. Available: {list(AVAILABLE_LANGS)}"
        )
    return f"<{lang}>{s}</{lang}>"


def prepare_chunks(text: str, lang: str = "en", max_len: int = 300) -> list[str]:
    """normalize → chunk → wrap EACH chunk in <lang> tags."""
    s = normalize_text(text, lang)
    s = re.sub(rf"^<{re.escape(lang)}>|</{re.escape(lang)}>$", "", s)
    return [f"<{lang}>{c}</{lang}>" for c in chunk_text(s, max_len)]


def chunk_text(text: str, max_len: int = 300) -> list[str]:
    """Sentence-boundary chunking at ~max_len chars: every character is
    synthesized (the reference truncates over-long paragraphs)."""
    if len(text) <= max_len:
        return [text]
    chunks, cur = [], ""
    for part in text.replace("!", ".").replace("?", ".").split("."):
        part = part.strip()
        if not part:
            continue
        if len(cur) + len(part) + 1 > max_len and cur:
            chunks.append(cur)
            cur = part + "."
        else:
            cur += part + "."
    if cur:
        chunks.append(cur)
    return chunks


class UnicodeIndexer:
    """Codepoint → id tokenizer (unicode_indexer.json analog). Unknown
    codepoints hash into the reserved tail of the vocab. Ids are int64 (for
    torch indexing), with JAX's values."""

    def __init__(self, mapping: dict[str, int] | None = None, vocab_size: int = 512):
        self.vocab_size = vocab_size
        if mapping is None:
            printable = [chr(c) for c in range(32, 127)]
            mapping = {ch: i + 2 for i, ch in enumerate(printable)}
        self.mapping = mapping

    @classmethod
    def from_json(cls, path: str | Path, vocab_size: int = 512) -> "UnicodeIndexer":
        return cls(json.loads(Path(path).read_text()), vocab_size)

    def __call__(self, text: str) -> np.ndarray:
        ids = [
            self.mapping.get(ch, 2 + (ord(ch) % (self.vocab_size - 2)))
            for ch in text
        ]
        return np.asarray(ids, np.int64)


def load_voice_style(path: str | Path) -> dict[str, np.ndarray]:
    """voice_styles/*.json: {"ttl": [...], "dp": [...]} vectors."""
    raw = json.loads(Path(path).read_text())
    return {k: np.asarray(v, np.float32).reshape(-1) for k, v in raw.items()}


# ---------------------------------------------------------------------------
# Sub-models


def _init_attn_block(gen: torch.Generator, d: int, ffn: int) -> Params:
    return {
        "norm1": init_layer_norm(gen, d),
        "q": init_linear(gen, d, d),
        "kv": init_linear(gen, d, 2 * d),
        "out": init_linear(gen, d, d),
        "norm2": init_layer_norm(gen, d),
        "ffn1": init_linear(gen, d, ffn),
        "ffn2": init_linear(gen, ffn, d),
    }


def _attn_block(p: Params, x: torch.Tensor, mask: torch.Tensor, n_heads: int,
                kv: torch.Tensor | None = None, kv_mask: torch.Tensor | None = None,
                dtype: torch.dtype | None = None) -> torch.Tensor:
    """Self-attention (kv=None) or cross-attention block; the kv source of a
    cross block is the text memory under the block's own norm1. Products
    take operands rounded to `dtype` and sum in f32; norms, softmax and the
    tanh-form GELU run in f32."""
    B, T, D = x.shape
    h = layer_norm(p["norm1"], x)
    q = linear(p["q"], h, dtype=dtype)
    if kv is None:
        kvp = linear(p["kv"], h, dtype=dtype)
        att_mask = mask
    else:
        kvp = linear(p["kv"], layer_norm(p["norm1"], kv), dtype=dtype)
        att_mask = kv_mask
    k, v = kvp.split(D, dim=-1)
    hd = D // n_heads
    Tk = k.shape[1]

    def heads(a, t):  # [B, t, D] → [B, H, t, hd]
        return round_to(a, dtype).reshape(B, t, n_heads, hd).transpose(1, 2)

    s = heads(q, T) @ heads(k, Tk).transpose(-1, -2)
    s = s / np.sqrt(hd)
    s = torch.where(att_mask[:, None, None, :] > 0, s, torch.full_like(s, -1e9))
    a = torch.softmax(s, dim=-1)
    ctx = (round_to(a, dtype) @ heads(v, Tk)).transpose(1, 2).reshape(B, T, D)
    x = x + linear(p["out"], ctx, dtype=dtype)
    h2 = layer_norm(p["norm2"], x)
    f = F.gelu(linear(p["ffn1"], h2, dtype=dtype), approximate="tanh")
    return x + linear(p["ffn2"], f, dtype=dtype)


def init_text_encoder(gen: torch.Generator, cfg: SupertonicConfig) -> Params:
    d = cfg.d_text
    return {
        "embed": torch.randn((cfg.vocab_size, d), generator=gen, device=gen.device) * 0.02,
        "style_proj": init_linear(gen, cfg.d_style, d),
        "blocks": [_init_attn_block(gen, d, d * cfg.ffn_mult)
                   for _ in range(cfg.n_text_layers)],
        "norm": init_layer_norm(gen, d),
    }


def text_encoder_forward(p: Params, ids: torch.Tensor, style: torch.Tensor,
                         mask: torch.Tensor, cfg: SupertonicConfig) -> torch.Tensor:
    """ids [B, n], style [B, d_style], mask [B, n] → text memory [B, n, d_text]."""
    x = p["embed"][ids] + linear(p["style_proj"], style)[:, None, :]
    x = x + positions_on(ids.shape[1], cfg.d_text, x.device)
    for b in p["blocks"]:
        x = _attn_block(b, x, mask, cfg.n_heads, dtype=cfg.compute_dtype)
    return layer_norm(p["norm"], x)


def init_duration_predictor(gen: torch.Generator, cfg: SupertonicConfig) -> Params:
    d = cfg.d_text
    return {
        "embed": torch.randn((cfg.vocab_size, d), generator=gen, device=gen.device) * 0.02,
        "style_proj": init_linear(gen, cfg.d_style, d),
        "conv1": init_conv1d(gen, d, d, 3),
        "conv2": init_conv1d(gen, d, d, 3),
        "norm": init_layer_norm(gen, d),
        "out": init_linear(gen, d, 1),
    }


def duration_predictor_forward(p: Params, ids: torch.Tensor, style: torch.Tensor,
                               mask: torch.Tensor, cfg: SupertonicConfig) -> torch.Tensor:
    """→ per-token durations in frames [B, n] (softplus, masked). Inputs and
    every conv output are re-masked, so a sequence padded to a token bucket
    computes what the unpadded one would."""
    m = mask[..., None]
    x = (p["embed"][ids] + linear(p["style_proj"], style)[:, None, :]) * m
    x = torch.relu(conv1d(p["conv1"], x)) * m
    x = torch.relu(conv1d(p["conv2"], x)) * m
    x = layer_norm(p["norm"], x)
    return F.softplus(linear(p["out"], x))[..., 0] * mask


def init_vector_estimator(gen: torch.Generator, cfg: SupertonicConfig) -> Params:
    d = cfg.d_text
    p = {
        "in_proj": init_linear(gen, cfg.d_latent, d),
        "style_proj": init_linear(gen, cfg.d_style, d),
        "t_proj": init_linear(gen, d, d),
        "blocks": [{"self": _init_attn_block(gen, d, d * cfg.ffn_mult),
                    "cross": _init_attn_block(gen, d, d * cfg.ffn_mult)}
                   for _ in range(cfg.n_est_layers)],
        "out": init_linear(gen, d, cfg.d_latent),
    }
    p["blocks_stacked"] = stack_est_blocks(p["blocks"])
    return p


def vector_estimator_forward(p: Params, xt: torch.Tensor, text_emb: torch.Tensor,
                             style: torch.Tensor, latent_mask: torch.Tensor,
                             text_mask: torch.Tensor, t_step: torch.Tensor,
                             cfg: SupertonicConfig) -> torch.Tensor:
    """Velocity field v(x_t, t): [B, T_latent, d_latent]. `t_step` is an f32
    scalar tensor. With `cfg.fused_estimator` at batch 1 the 2L blocks are
    one `estimator_blocks` call (kernel 10 on a card)."""
    B, T, _ = xt.shape
    d = cfg.d_text
    half = d // 2
    # timestep embedding (sinusoidal over a scalar t in [0, 1]), in f32
    i = torch.arange(half, dtype=torch.float32, device=xt.device)
    freqs = torch.exp(i * float(-np.log(10000.0)) / half)
    ang = t_step * 1000.0 * freqs
    temb = torch.cat([torch.sin(ang), torch.cos(ang)])[None]
    x = linear(p["in_proj"], xt)
    x = x + linear(p["style_proj"], style)[:, None, :]
    x = x + linear(p["t_proj"], temb)[:, None, :]
    x = x + positions_on(T, d, x.device)
    if cfg.fused_estimator and B == 1:
        y = estimator_blocks(x[0], text_emb[0], latent_mask[0], text_mask[0],
                             p["blocks_stacked"], cfg.n_heads)
        return linear(p["out"], y[None]) * latent_mask[..., None]
    dt = cfg.compute_dtype
    for b in p["blocks"]:
        x = _attn_block(b["self"], x, latent_mask, cfg.n_heads, dtype=dt)
        x = _attn_block(b["cross"], x, latent_mask, cfg.n_heads, kv=text_emb,
                        kv_mask=text_mask, dtype=dt)
    return linear(p["out"], x) * latent_mask[..., None]


def init_vocoder(gen: torch.Generator, cfg: SupertonicConfig) -> Params:
    # 256x upsampling: 4 x ConvTranspose(x4), latent rate → 24 kHz
    chans = [cfg.d_latent, 128, 64, 32, 16]
    p: Params = {"ups": [], "pre": init_conv1d(gen, cfg.d_latent, chans[0], 7)}
    for i in range(4):
        scale = 1.0 / np.sqrt(chans[i] * 8)
        w = torch.rand((8, chans[i], chans[i + 1]), generator=gen, device=gen.device)
        p["ups"].append({
            "w": w * (2 * scale) - scale,
            "b": torch.zeros((chans[i + 1],), dtype=torch.float32, device=gen.device),
            "res": init_conv1d(gen, chans[i + 1], chans[i + 1], 7),
        })
    p["out"] = init_conv1d(gen, chans[-1], 1, 7)
    return p


def vocoder_forward(p: Params, latent: torch.Tensor, cfg: SupertonicConfig) -> torch.Tensor:
    """latent [B, T, d_latent] → waveform [B, T·hop]: each transposed conv is
    SAME-padded x4, so the hop holds exactly. The plain conv path: the JAX
    package's lane-packed form computes the same output."""
    x = F.leaky_relu(conv1d(p["pre"], latent), 0.1)
    for up in p["ups"]:
        x = F.leaky_relu(conv_transpose1d(x, up["w"], 4) + up["b"], 0.1)
        x = x + torch.tanh(conv1d(up["res"], x))
    return torch.tanh(conv1d(p["out"], x))[..., 0]


def supertonic_params_from_jax(tree: Params, device: torch.device | str) -> Params:
    """JAX `SupertonicTts.init()` params (numpy or JAX leaves) → the port's
    tree on `device`: the same layouts, without the vocoder's TPU-only
    "packed" subtree, with the estimator blocks also stacked for kernel 10."""
    tree = dict(tree)
    tree["vocoder"] = {k: v for k, v in tree["vocoder"].items() if k != "packed"}
    p = from_numpy_tree(tree, device)
    p["estimator"]["blocks_stacked"] = stack_est_blocks(p["estimator"]["blocks"])
    return p


# ---------------------------------------------------------------------------
# Full pipeline


def sample_noisy_latent(gen: torch.Generator, shape: tuple, latent_mask: torch.Tensor,
                        max_t: int | None = None) -> torch.Tensor:
    """Standard-normal latent [B, T, D] times the mask. With `max_t` it is
    drawn at [B, max_t, D] and prefix-sliced, so a seed gives the same
    latent whatever the bucket."""
    B, T, D = shape
    n = max_t if max_t is not None and max_t >= T else T
    z = torch.randn((B, n, D), generator=gen, device=gen.device)[:, :T]
    return z * latent_mask[..., None]


def _call(key, make, *args, params=None):
    """A program's function called directly: the uncaptured route."""
    return make()(*args)


@dataclass
class SupertonicTts:
    """Text + voice style → waveform on one device. `device` defaults to
    `default_device()`, which raises where there is no CUDA card: the CPU is
    taken only when the caller passes device="cpu".

    `programs` holds the captured programs, one a (kind, token bucket,
    latent bucket); `_fpt_ema` is the fused-duration route's observed frames
    a token; `dispatches` counts the synth programs run (a missed bucket
    guess costs one more)."""

    cfg: SupertonicConfig = field(default_factory=SupertonicConfig)
    params: Params | None = None
    indexer: UnicodeIndexer | None = None
    device: torch.device | str | None = None
    _fpt_ema: float | None = None
    programs: Programs = field(init=False, repr=False)
    dispatches: int = field(init=False, default=0)

    def __post_init__(self):
        self.device = torch.device(self.device) if self.device is not None else default_device()
        if self.indexer is None:
            self.indexer = UnicodeIndexer(vocab_size=self.cfg.vocab_size)
        self.programs = Programs(self.device)
        self._times = None

    def init(self, seed: int = 0) -> Params:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        self.params = {
            "duration": init_duration_predictor(gen, self.cfg),
            "text": init_text_encoder(gen, self.cfg),
            "estimator": init_vector_estimator(gen, self.cfg),
            "vocoder": init_vocoder(gen, self.cfg),
        }
        return self.params

    def _tensor(self, a, dtype=torch.float32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    def _flow_times(self) -> torch.Tensor:
        """The flow steps' times i·dt, f32 on the device, made once (outside
        any capture): a program reads them and uploads nothing."""
        if self._times is None:
            dt = 1.0 / self.cfg.flow_steps
            self._times = torch.arange(self.cfg.flow_steps, dtype=torch.float32) * dt
            self._times = self._times.to(self.device)
        return self._times

    def noise(self, seed: int) -> torch.Tensor:
        """The seed's standard-normal latent [1, latent_buckets[-1], d_latent]
        from `torch.Generator(device).manual_seed(seed)`: a program takes its
        prefix, so a seed gives the same latent whatever the bucket."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        return torch.randn((1, self.cfg.latent_buckets[-1], self.cfg.d_latent), generator=gen,
                           device=self.device)

    def _flow(self, params: Params, ids, text_mask, style_ttl, latent_mask, noise):
        """Text encoder, the flow loop and the vocoder: style_ttl [B, d_style],
        noise [B, >= T, d_latent] → waveform [B, T·hop]."""
        cfg = self.cfg
        text_emb = text_encoder_forward(params["text"], ids, style_ttl, text_mask, cfg)
        T = latent_mask.shape[1]
        xt = noise[:, :T] * latent_mask[..., None]
        dt = 1.0 / cfg.flow_steps
        times = self._flow_times()
        for i in range(cfg.flow_steps):
            v = vector_estimator_forward(params["estimator"], xt, text_emb, style_ttl,
                                         latent_mask, text_mask, times[i], cfg)
            xt = xt + dt * v
        if cfg.apply_latent_denorm:
            xt = xt * latent_mask[..., None] / cfg.normalizer_scale
        return vocoder_forward(params["vocoder"], xt, cfg)

    @torch.inference_mode()
    def synth_core(self, ids: torch.Tensor, text_mask: torch.Tensor, style_ttl: torch.Tensor,
                   latent_mask: torch.Tensor, seed: int = 0,
                   noise: torch.Tensor | None = None) -> torch.Tensor:
        """ids [B, n], text_mask [B, n], style_ttl [B, d_style], latent_mask
        [B, T] → waveform [B, T·hop]: text encoder, the flow loop and the
        vocoder, run eagerly (the synth program's oracle). `noise` [B, >= T,
        d_latent] replaces the generator's draw."""
        B, T = latent_mask.shape
        if noise is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
            noise = sample_noisy_latent(gen, (B, T, self.cfg.d_latent), latent_mask,
                                        max_t=self.cfg.latent_buckets[-1])
        return self._flow(self.params, ids, text_mask, style_ttl, latent_mask,
                          noise.to(self.device, torch.float32))

    def _durations(self, params: Params, ids, text_mask, style_dp):
        return duration_predictor_forward(params["duration"], ids, style_dp[None], text_mask,
                                          self.cfg)

    def duration_fn(self):
        """(ids [1, n], text_mask [1, n], style_dp [d_style]) → durations [1, n]."""
        params = self.params
        return lambda ids, text_mask, style_dp: self._durations(params, ids, text_mask, style_dp)

    def synth_fn(self, t_latent: int):
        """One program a latent bucket (JAX `synth_fn`): (ids [1, n], text_mask
        [1, n], style_ttl [d_style], style_dp [d_style], latent_mask [1,
        t_latent], noise [1, t_latent, d_latent]) → (wave [1, t_latent·hop],
        durations [1, n]). The params are the program's own and the noise an
        input (JAX takes params and a seed)."""
        params = self.params
        self._flow_times()

        def fn(ids, text_mask, style_ttl, style_dp, latent_mask, noise):
            durations = self._durations(params, ids, text_mask, style_dp)
            wave = self._flow(params, ids, text_mask, style_ttl[None], latent_mask, noise)
            return wave, durations

        return fn

    def synth_e2e_fn(self, t_latent: int, min_frames: int = 8):
        """Duration → latent mask → synth as one program (JAX
        `synth_e2e_fn`): (ids, text_mask, style_ttl, style_dp, noise) → (wave
        [1, t_latent·hop], t_real, durations). The frame count t_real =
        min(t_latent, max(min_frames, floor(Σdur / speed))) and the latent
        mask are computed on the device; the caller trims the wave to
        t_real·hop."""
        params, cfg = self.params, self.cfg
        self._flow_times()

        def fn(ids, text_mask, style_ttl, style_dp, noise):
            durations = self._durations(params, ids, text_mask, style_dp)
            t_real = torch.floor(durations.sum() / cfg.speed).to(torch.int32)
            t_real = t_real.clamp(min=min_frames).clamp(max=t_latent)
            frames = torch.arange(t_latent, device=ids.device)[None, :]
            latent_mask = (frames < t_real).to(torch.float32)
            wave = self._flow(params, ids, text_mask, style_ttl[None], latent_mask, noise)
            return wave, t_real, durations

        return fn

    def _bucket(self, t: int) -> int:
        for b in self.cfg.latent_buckets:
            if t <= b:
                return b
        return self.cfg.latent_buckets[-1]

    def pad_tokens(self, ids: np.ndarray):
        """ids [1, n] → (padded ids [1, bucket], text_mask [1, bucket]):
        zero-padded to the token bucket, under which the duration and text
        models are mask-exact."""
        n = ids.shape[1]
        b = n
        for tb in self.cfg.token_buckets:
            if n <= tb:
                b = tb
                break
        else:
            b = max(n, self.cfg.token_buckets[-1])
        padded = np.zeros((1, b), ids.dtype)
        padded[:, :n] = ids
        mask = np.zeros((1, b), np.float32)
        mask[:, :n] = 1.0
        return padded, mask

    def _t_true(self, durations: np.ndarray, min_frames: int) -> int:
        """JAX's host frame count of a chunk's durations [1, n] (f32)."""
        return max(min_frames, int(durations.sum() / self.cfg.speed))

    @torch.inference_mode()
    def synthesize(self, text: str, style: dict[str, np.ndarray], lang: str = "en",
                   seed: int = 0, min_frames: int = 8, fused_duration: bool = True,
                   noise: torch.Tensor | None = None) -> np.ndarray:
        """normalize → chunk → per chunk one synth program → f32 waveform in
        [-1, 1] (JAX `synthesize`).

        fused_duration=True (the default): the duration → mask → synth
        program (`synth_e2e_fn`) at a bucket guessed from the token count
        (`_fpt_ema`, cold prior `cfg.est_frames_per_token`); the result is
        taken from the canonical bucket, the one the chunk's own durations
        map to (JAX's host formula max(min_frames, floor(Σdur / speed))), so
        a missed guess costs one more dispatch and never other audio. False:
        the duration program, that formula on the host, then the synth
        program (`synth_fn`) at its bucket. Both give JAX's two routes'
        audio. Each chunk waits for the device once: its durations and
        frame count come back in one copy, then the trimmed wave.
        `noise` [1, latent_buckets[-1], d_latent] replaces the seed's draw."""
        return self._synthesize(text, style, lang, seed, min_frames, fused_duration, noise,
                                self.programs.run)

    @torch.inference_mode()
    def synthesize_uncaptured(self, text: str, style: dict[str, np.ndarray], lang: str = "en",
                              seed: int = 0, min_frames: int = 8, fused_duration: bool = True,
                              noise: torch.Tensor | None = None) -> np.ndarray:
        """`synthesize` with each program's function run eagerly: the
        uncaptured oracle of the captured route."""
        return self._synthesize(text, style, lang, seed, min_frames, fused_duration, noise,
                                _call)

    def _synthesize(self, text, style, lang, seed, min_frames, fused_duration, noise, run):
        cfg = self.cfg
        style_ttl, style_dp = self._tensor(style["ttl"]), self._tensor(style["dp"])
        noise = self.noise(seed) if noise is None else noise.to(self.device, torch.float32)
        waves = []
        for chunk in prepare_chunks(text, lang):
            n_real = len(self.indexer(chunk))
            ids_np, mask_np = self.pad_tokens(self.indexer(chunk)[None])
            tb = ids_np.shape[1]
            ids, text_mask = self._tensor(ids_np, torch.int64), self._tensor(mask_np)
            if fused_duration:
                fpt = self._fpt_ema or cfg.est_frames_per_token
                t_buck = self._bucket(max(min_frames, int(n_real * fpt / cfg.speed)))
                for _attempt in range(2):
                    wave, t_dev, dur = run(
                        ("synth_e2e", tb, t_buck, min_frames),
                        lambda t=t_buck: self.synth_e2e_fn(t, min_frames),
                        ids, text_mask, style_ttl, style_dp, noise[:, :t_buck],
                        params=self.params)
                    self.dispatches += 1
                    meta = torch.cat([t_dev.reshape(1).to(torch.float32),
                                      dur.reshape(-1)]).cpu().numpy()
                    t_real, durations = int(meta[0]), meta[1:].reshape(1, -1)
                    t_true = self._t_true(durations, min_frames)
                    ratio = t_true * cfg.speed / max(1, n_real)
                    self._fpt_ema = (ratio if self._fpt_ema is None
                                     else 0.7 * self._fpt_ema + 0.3 * ratio)
                    canonical = self._bucket(t_true)
                    if t_buck == canonical:
                        break
                    t_buck = canonical  # the guess missed: one re-dispatch
                waves.append(wave[0, : t_real * cfg.hop].cpu().numpy())
                continue
            dur = run(("dur", tb, 0), self.duration_fn, ids, text_mask, style_dp,
                      params=self.params)
            t_real = self._t_true(dur.cpu().numpy(), min_frames)
            t_buck = self._bucket(t_real)
            t_real = min(t_real, t_buck)
            latent_mask = np.zeros((1, t_buck), np.float32)
            latent_mask[:, :t_real] = 1.0
            wave, _ = run(("synth", tb, t_buck), lambda t=t_buck: self.synth_fn(t),
                          ids, text_mask, style_ttl, style_dp, self._tensor(latent_mask),
                          noise[:, :t_buck], params=self.params)
            self.dispatches += 1
            waves.append(wave[0, : t_real * cfg.hop].cpu().numpy())
        return np.clip(np.concatenate(waves), -1.0, 1.0)
