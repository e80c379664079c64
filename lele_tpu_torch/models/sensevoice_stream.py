"""Streaming SenseVoice: chunked encoding with per-layer context caches
(counterpart of lele_tpu/models/sensevoice_stream.py).

Audio arrives in fixed chunks of LFR frames; each SAN-M layer attends over
[left-context cache ‖ current chunk], and the FSMN convolution carries its
own (kernel − 1)-frame tail. Within a chunk this is full attention
restricted to the visible context window: a latency mode, not bit-parity
with offline decoding. As in JAX, the step runs the f32 `linear` (no
kernel) on the model's f32 weights, and prefix query frames are omitted.

State is a dict of per-layer caches plus the running position, all on the
device. As JAX jits its step with the state donated, `step_fn` and
`decode_step_fn` return programs: on a card each is one CUDA graph a chunk
shape, captured at its first use (runtime/graphs.py), with the state
donated (written back into the program's state buffers inside the graph;
the step returns a copy the caller owns, so sessions may interleave
through one program); on the CPU they run eagerly and return new
tensors. `stream_step` is the uncaptured
function. No step waits on the host.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import default_device
from ..features import FbankConfig, FbankFrontend
from ..runtime.graphs import Programs
from .common import Params, layer_norm, linear
from .sensevoice import SenseVoiceConfig


@dataclass
class StreamConfig:
    chunk_frames: int = 16  # LFR frames per chunk (~0.96 s)
    context_frames: int = 32  # left-context frames cached per layer


def init_stream_state(cfg: SenseVoiceConfig, s: StreamConfig, batch: int = 1,
                      device: torch.device | str | None = None):
    """Per-layer caches: attention context [B, L, D], its validity [B, L],
    the FSMN tail [B, k−1, D]; plus the absolute frame position (int32). On
    `device`, by default `default_device()`."""
    device = device if device is not None else default_device()

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    layers = [{"ctx": zeros(batch, s.context_frames, cfg.d_model),
               "ctx_mask": zeros(batch, s.context_frames),
               "fsmn_tail": zeros(batch, cfg.fsmn_kernel - 1, cfg.d_model)}
              for _ in range(cfg.n_layers)]
    return {"layers": layers, "pos": torch.zeros((), dtype=torch.int32, device=device)}


def _stream_block(p: Params, x: torch.Tensor, cache: dict, mask: torch.Tensor,
                  cfg: SenseVoiceConfig):
    """One SAN-M layer over [ctx ‖ chunk] → (y, new cache). The cache holds
    this layer's INPUT activations of earlier chunks (offline attention
    attends over the layer's inputs), re-projected each chunk."""
    B, T, D = x.shape
    H = cfg.n_heads
    hd = D // H
    L = cache["ctx"].shape[1]
    x_in = x

    h = layer_norm(p["norm1"], x)
    q, k_cur, v_cur = linear(p["qkv"], h).float().split(D, dim=-1)
    hc = layer_norm(p["norm1"], cache["ctx"])
    _, k_ctx, v_ctx = linear(p["qkv"], hc).float().split(D, dim=-1)
    k = torch.cat([k_ctx, k_cur], dim=1)
    v = torch.cat([v_ctx, v_cur], dim=1)
    kv_mask = torch.cat([cache["ctx_mask"], mask], dim=1)

    # FSMN on values with the carried tail (causal: only the tail pads left)
    vm = v_cur * mask[..., None]
    v_ext = torch.cat([cache["fsmn_tail"], vm], dim=1)
    fw = p["fsmn"]["w"].float()
    fsmn = torch.zeros_like(vm)
    for kk in range(fw.shape[0]):
        fsmn = fsmn + v_ext[:, kk:kk + T, :] * fw[kk]

    qh = q.reshape(B, T, H, hd).transpose(1, 2)
    kh = k.reshape(B, L + T, H, hd).transpose(1, 2)
    vh = v.reshape(B, L + T, H, hd).transpose(1, 2)
    scores = (qh @ kh.transpose(-1, -2)) / math.sqrt(hd)
    scores = torch.where(kv_mask[:, None, None, :] > 0, scores,
                         torch.full_like(scores, -1e9))
    ctx_out = (torch.softmax(scores, dim=-1) @ vh).transpose(1, 2).reshape(B, T, D)
    x = x + linear(p["out"], ctx_out + fsmn)

    h2 = layer_norm(p["norm2"], x)
    x = x + linear(p["ffn2"], torch.relu(linear(p["ffn1"], h2)))

    # roll the caches: the last L INPUT activations of [old ctx ‖ x_in]
    full = torch.cat([cache["ctx"], x_in], dim=1)
    full_mask = torch.cat([cache["ctx_mask"], mask], dim=1)
    tail = v_ext[:, -(cfg.fsmn_kernel - 1):] if cfg.fsmn_kernel > 1 else cache["fsmn_tail"]
    return x, {"ctx": full[:, -L:], "ctx_mask": full_mask[:, -L:], "fsmn_tail": tail}


def stream_step(params: Params, feats: torch.Tensor, mask: torch.Tensor, state: dict,
                cfg: SenseVoiceConfig):
    """feats [B, chunk, 560], mask [B, chunk] → (logits [B, chunk, vocab],
    new state)."""
    B, T, _ = feats.shape
    x = feats.float() * (cfg.d_model**0.5) / (cfg.input_dim**0.5)
    x = linear(params["embed"], x).float()
    pos = state["pos"]
    # absolute positions continue across chunks, computed here from the
    # running position (FunASR's are 1-based): a fixed table sliced at the
    # position would clamp past its last row and repeat positions after
    # ~8k frames of stream
    p = (pos + 1 + torch.arange(T, device=x.device)).float()[:, None]
    div = torch.exp(torch.arange(0, cfg.d_model, 2, dtype=torch.float32, device=x.device)
                    * -(np.log(10000.0) / cfg.d_model))
    pe = torch.zeros((T, cfg.d_model), dtype=torch.float32, device=x.device)
    pe[:, 0::2] = torch.sin(p * div)
    pe[:, 1::2] = torch.cos(p * div)
    x = x + pe
    new_layers = []
    for lp, cache in zip(params["layers"], state["layers"]):
        x, nc = _stream_block(lp, x, cache, mask, cfg)
        new_layers.append(nc)
    x = layer_norm(params["after_norm"], x)
    logits = linear(params["ctc"], x).float()
    n_valid = mask[0].sum().to(torch.int32)
    return logits, {"layers": new_layers, "pos": pos + n_valid}


@dataclass
class StreamingSenseVoice:
    """Chunked streaming over a SenseVoice model's f32 weights (unstacked
    "layers"). `device` defaults to `default_device()`, which raises where
    there is no CUDA card: the CPU is taken only when the caller passes
    device="cpu"."""

    cfg: SenseVoiceConfig
    stream: StreamConfig = field(default_factory=StreamConfig)
    params: Params | None = None
    fbank: FbankFrontend | None = None
    device: torch.device | str | None = None
    programs: Programs | None = field(default=None, init=False, repr=False)

    def __post_init__(self):
        self.device = torch.device(self.device) if self.device is not None else default_device()
        if self.fbank is None:
            self.fbank = FbankFrontend(FbankConfig(), self.device)
        self.programs = Programs(self.device)

    def _step(self, kind: str, params, feats, mask, state):
        cfg = self.cfg

        def make():
            def step(f, m, s):
                logits, new_state = stream_step(params, f, m, s, cfg)
                if kind == "decode":
                    return logits.argmax(dim=-1).to(torch.int32), new_state
                return logits, new_state

            return step

        return self.programs.run((kind, tuple(feats.shape)), make, feats, mask, state,
                                 params=params, donate={2: 1})

    def step_fn(self):
        """(params, feats, mask, state) → (logits, new state), the state
        donated."""
        return lambda params, feats, mask, state: self._step("step", params, feats, mask,
                                                             state)

    def decode_step_fn(self):
        """Like `step_fn`, but returns the per-frame argmax ids (int32 [B,
        chunk], computed on the device) in place of the logits."""
        return lambda params, feats, mask, state: self._step("decode", params, feats, mask,
                                                             state)

    def transcribe_stream(self, pcm: np.ndarray, blank_id: int = 0) -> list[int]:
        """Feed the audio's features chunk by chunk → the greedy ids, collapsed
        across chunk boundaries."""
        feats = self.fbank(np.asarray(pcm, np.float32))
        C = self.stream.chunk_frames
        state = init_stream_state(self.cfg, self.stream, device=self.device)
        step = self.decode_step_fn()
        ids: list[int] = []
        prev_last = -1
        for start in range(0, feats.shape[0], C):
            chunk = feats[start:start + C]
            valid = chunk.shape[0]
            mask = torch.zeros((1, C), dtype=torch.float32, device=feats.device)
            mask[0, :valid] = 1.0
            if valid < C:
                chunk = torch.cat([chunk, chunk.new_zeros((C - valid, chunk.shape[1]))])
            ids_dev, state = step(self.params, chunk[None], mask, state)
            for t in ids_dev[0, :valid].cpu().numpy():
                t = int(t)
                if t != prev_last and t != blank_id:
                    ids.append(t)
                prev_last = t
        return ids
