"""Compiled ONNX checkpoints with a model family's pipeline around them
(counterpart of lele_tpu/models/checkpoints.py): SenseVoice, Silero VAD,
YOLO-class detectors and Supertonic TTS.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from .. import default_device
from ..runtime.compose import compose_models
from ..features import FbankConfig, FbankFrontend, fbank_features
from .sensevoice import _collapse_ids
from .silero import VadSegmentConfig, collect_segments


def _load(model):
    """The model's `OnnxModel` (a path or bytes), local functions inlined."""
    from ..onnx.functions import inline_model
    from ..onnx.loader import OnnxModel

    if isinstance(model, (bytes, bytearray, memoryview)):
        return inline_model(OnnxModel.from_bytes(bytes(model)))
    return inline_model(OnnxModel.load(str(model)))


class SenseVoiceOnnx:
    """WAV → CTC ids through a compiled SenseVoice-class encoder graph.

    Takes the ONNX file's path or its bytes. Handles the FunASR 4-input
    signature (speech, speech_lengths, language, textnorm) and speech-only
    exports. PCM pads to length buckets and frames to multiples of
    FRAME_BUCKET, so the number of compiled traces stays bounded: one per
    bucket, each compiled at first use (`compile_count`). `device` defaults
    to `default_device()`, which raises where there is no CUDA card;
    `patterns` goes to `compile_model` ([] gives the per-op path)."""

    FRAME_BUCKET = 32

    def __init__(self, model: str | Path | bytes, language: int = 3, textnorm: int = 0,
                 device: torch.device | str | None = None, patterns=None):
        self.model = _load(model)
        self.device = torch.device(device) if device is not None else default_device()
        self.in_names = self.model.input_names()
        self.language = language
        self.textnorm = textnorm
        self.patterns = patterns
        self._cms: dict[int, object] = {}
        self._buckets: dict[int, int] = {}  # pcm bucket → t_pad
        self.frontend = FbankFrontend(FbankConfig(), self.device)

    def _compiled(self, t_pad: int):
        if t_pad not in self._cms:
            from ..compiler import compile_model

            self._cms[t_pad] = compile_model(
                self.model, input_shapes={"speech": (1, t_pad, 560)},
                patterns=self.patterns, device=self.device)
        return self._cms[t_pad]

    def _inputs(self, padded: torch.Tensor, valid: int) -> dict:
        kwargs = {"speech": padded}
        if "speech_lengths" in self.in_names:
            kwargs["speech_lengths"] = np.asarray([valid], np.int64)
        if "language" in self.in_names:
            kwargs["language"] = np.asarray([self.language], np.int32)
        if "textnorm" in self.in_names:
            kwargs["textnorm"] = np.asarray([self.textnorm], np.int32)
        return {k: v for k, v in kwargs.items() if k in self.in_names}

    def _pad_frames(self, feats: torch.Tensor, t_pad: int) -> torch.Tensor:
        padded = torch.zeros((1, t_pad, feats.shape[-1]), dtype=torch.float32,
                             device=self.device)
        padded[0, : feats.shape[0]] = feats
        return padded

    @torch.inference_mode()
    def logits(self, pcm: np.ndarray) -> torch.Tensor:
        """Unbucketed waveform → logits [1, n_prefix + T, vocab] on the device."""
        feats = self.frontend(np.asarray(pcm, np.float32))
        t = feats.shape[0]
        t_pad = -(-t // self.FRAME_BUCKET) * self.FRAME_BUCKET
        cm = self._compiled(t_pad)
        logits = cm(**self._inputs(self._pad_frames(feats, t_pad), t))[0]
        n_prefix = logits.shape[1] - t_pad
        return logits[:, : n_prefix + t]

    def _pcm_bucket(self, n_pcm: int) -> int:
        """Smallest pcm-length bucket covering n_pcm: steps of FRAME_BUCKET
        LFR frames of audio, so the fbank's shape and the encoder's frame
        padding are shared by every input in the bucket."""
        c = self.frontend.config
        step = self.FRAME_BUCKET * c.lfr_n * c.hop_len
        return max(-(-n_pcm // step) * step, step)

    def _true_frames(self, n_pcm: int) -> int:
        """LFR frames the unpadded waveform produces (the front-end's formula)."""
        c = self.frontend.config
        t_raw = max(c.num_frames(n_pcm), 0)
        return -(-t_raw // c.lfr_n) if c.apply_lfr else t_raw

    @torch.inference_mode()
    def transcribe(self, pcm: np.ndarray, blank_id: int = 0,
                   n_prefix: int | None = None) -> list[int]:
        """Waveform → CTC ids. The fbank (mask-aware CMVN over the valid
        samples only), the frame padding, the compiled graph and the
        per-frame argmax run on the device; only [T] int32 ids come back."""
        pcm = np.asarray(pcm, np.float32)
        n_bucket = self._pcm_bucket(len(pcm))
        padded_pcm = np.zeros(n_bucket, np.float32)
        padded_pcm[: len(pcm)] = pcm
        fb = self.frontend
        feats, _ = fbank_features(padded_pcm, fb.config, fb.window, fb.mel_t,
                                  n_valid=len(pcm))
        t_pad = self._buckets.setdefault(
            n_bucket, -(-feats.shape[0] // self.FRAME_BUCKET) * self.FRAME_BUCKET)
        t = self._true_frames(len(pcm))
        cm = self._compiled(t_pad)
        logits = cm(**self._inputs(self._pad_frames(feats, t_pad), t))[0]
        if n_prefix is None:
            n_prefix = logits.shape[1] - t_pad
        ids = logits[0, n_prefix : n_prefix + t].argmax(dim=-1).to(torch.int32)
        return _collapse_ids(ids.cpu().numpy(), blank_id)

    def compile_count(self) -> int:
        """Distinct compiled traces so far (one per bucket)."""
        return len(self._cms)


class SileroOnnx:
    """Streaming VAD over a compiled Silero-class graph: inputs (PCM chunk
    [1, chunk] scaled by `scale`, the packed recurrent state [2, 1, H], the
    sample rate), outputs (probability, new state), the graph choosing its
    front-end with an If on the sample rate.

    Takes the ONNX file's path or its bytes. One trace per sample rate, with
    the rate bound as a constant so the If resolves while tracing (the JAX
    package's static-sr route), compiled with the state donated (JAX
    `donate=["state"]`). `speech_probs` is the counterpart of JAX's
    whole-utterance `lax.scan`: the chunk step several times over in one
    program on a slab of chunks, the state carried on the device from
    block to block and nothing read back until the last block. Blocks hold
    `BLOCK` chunks; the rest of an utterance runs as blocks of the powers
    of two below it (one program each, at most log2(BLOCK) more), so no
    padded chunk runs and kernel 6 launches exactly once a chunk. On a card
    each block size is one CUDA graph, captured at its first use
    (runtime/graphs.py); `BLOCK` was chosen on an H100 (PERF.md §6).
    `device` defaults to `default_device()`, which raises where there is no
    CUDA card; `overrides` goes to the tracer (`{"LSTM":
    ops.nn_ops.lstm_plain}` compiles the plain oracle)."""

    BLOCK = 8

    def __init__(self, model: str | Path | bytes, chunk: int = 512, scale: float = 32768.0,
                 device: torch.device | str | None = None, overrides=None):
        from ..runtime.graphs import Programs

        self.model = _load(model)
        self.device = torch.device(device) if device is not None else default_device()
        self.in_names = self.model.input_names()
        self.chunk = chunk
        self.scale = scale
        self.overrides = overrides
        self._cms: dict[int, object] = {}
        self.programs = Programs(self.device)

    def compiled(self, sr: int):
        """The CompiledModel of (chunk, state) for sample rate `sr`, with the
        state donated, traced at first use."""
        if sr not in self._cms:
            from ..compiler import resolve_input_specs
            from ..compiler.tracer import GraphTracer
            from ..runtime.engine import CompiledModel

            x_name, state_name, sr_name = self.in_names
            specs = resolve_input_specs(self.model, {x_name: (1, self.chunk)})
            shape, dt = specs.pop(sr_name)
            tracer = GraphTracer(self.model, overrides=self.overrides)
            trace = tracer.build(specs, self.device,
                                 constants={sr_name: np.full(shape, sr, dtype=dt)})
            self._cms[sr] = CompiledModel(trace, specs, self.in_names[:2],
                                          self.model.output_names(), tracer.stats,
                                          donate=[state_name])
        return self._cms[sr]

    def _chunks(self, pcm: np.ndarray, max_chunks: int | None) -> np.ndarray:
        n = len(pcm) // self.chunk
        if max_chunks is not None:
            n = min(n, max_chunks)
        return (np.asarray(pcm)[: n * self.chunk].reshape(n, self.chunk)
                * self.scale).astype(np.float32)

    def _state0(self, cm) -> torch.Tensor:
        return torch.zeros(cm.input_specs[self.in_names[1]][0], dtype=torch.float32,
                           device=self.device)

    def blocks(self, n: int) -> list[int]:
        """n chunks as block sizes: BLOCK, ..., then the powers of two of the
        rest, largest first."""
        sizes = [self.BLOCK] * (n // self.BLOCK)
        rest = n % self.BLOCK
        while rest:
            b = 1 << (rest.bit_length() - 1)
            sizes.append(b)
            rest -= b
        return sizes

    def _block_fn(self, sr: int, n: int):
        """(chunks [n, chunk], state) → (probs [n], state after the block):
        the compiled step n times over, the state carried (JAX's scan body)."""
        cm = self.compiled(sr)

        def fn(x, state):
            probs = []
            for i in range(n):
                prob, state = cm._walk([x[i:i + 1], state])[:2]
                probs.append(prob.reshape(()))
            return torch.stack(probs), state

        return fn

    @torch.inference_mode()
    def speech_probs(self, pcm: np.ndarray, sr: int = 16000,
                     max_chunks: int | None = None) -> np.ndarray:
        """Per-chunk speech probabilities over a whole waveform: the chunks go
        up in one copy, each block is one program call (one graph replay on
        a card) with the state donated from block to block, and all N
        probabilities come back in one read."""
        chunks = self._chunks(pcm, max_chunks)
        if len(chunks) == 0:
            return np.zeros(0, np.float32)
        state = self._state0(self.compiled(sr))
        x = torch.from_numpy(chunks).to(self.device)
        probs, start = [], 0
        for n in self.blocks(len(chunks)):
            p, state = self.programs.run(("block", sr, n), lambda: self._block_fn(sr, n),
                                         x[start:start + n], state, donate={1: 1})
            probs.append(p)
            start += n
        return torch.cat(probs).cpu().numpy()

    def speech_probs_hostloop(self, pcm: np.ndarray, sr: int = 16000,
                              max_chunks: int | None = None) -> np.ndarray:
        """Per-chunk host streaming loop (state through numpy), each chunk one
        step-by-step replay of the tape (`CompiledModel.replay`): the
        uncaptured oracle of `speech_probs`, and the shape real streaming
        input arrives in."""
        chunks = self._chunks(pcm, max_chunks)
        cm = self.compiled(sr)
        state = self._state0(cm).cpu().numpy()
        probs = np.zeros(len(chunks), np.float32)
        for i, x in enumerate(chunks):
            out = [o.cpu().numpy() for o in cm.replay(x[None], state)]
            probs[i] = float(np.asarray(out[0]).reshape(-1)[0])
            state = out[1]
        return probs

    def segments(self, pcm: np.ndarray, sr: int = 16000, threshold: float = 0.3):
        probs = self.speech_probs(pcm, sr)
        return collect_segments(probs, VadSegmentConfig(threshold=threshold, sample_rate=sr,
                                                        chunk=self.chunk))


class YoloOnnx:
    """A compiled YOLO-class detector: image → NMS-free decode; the graph gives
    logits and boxes as two outputs or one [1, N, 4+C].

    Takes the ONNX file's path or its bytes, compiled for one [1, 3, img_size,
    img_size] input. `compute="bfloat16"` runs it under the JAX package's
    compute policy (bf16 weights and activations; f32 at the API); None
    keeps f32, with cuDNN's TF32 off; as in the JAX package, the bf16 route
    also pins precision "default" (config.py). `device` defaults to
    `default_device()`, which raises where there is no CUDA card. JAX's
    image-stem rewrite (`pack_image_stem`, the TPU's space-to-depth lanes)
    has no counterpart: the port owes its outputs only."""

    def __init__(self, path: str | Path | bytes, img_size: int = 640,
                 compute: str | None = None, device: torch.device | str | None = None):
        from ..compiler import compile_model

        model = _load(path)
        self.device = torch.device(device) if device is not None else default_device()
        name = model.input_names()[0]
        # one input shape: on a card its graph is captured here, ahead of the
        # first image (`CompiledModel.compile`)
        self.cm = compile_model(model, input_shapes={name: (1, 3, img_size, img_size)},
                                compute=compute, device=self.device,
                                precision="default" if compute else None).compile()
        self.img_size = img_size

    def forward(self, x_chw: np.ndarray) -> list[np.ndarray]:
        """[1, 3, H, W] f32 → the graph's outputs, numpy, f32."""
        return self.cm.run_np(np.asarray(x_chw, np.float32))

    def prepare(self, image: np.ndarray) -> torch.Tensor:
        """u8 HWC image → nearest resize, /255 in f32, NCHW, uploaded once; the
        tensor can go to `forward_device` again and again (JAX's slow path and
        its packed fast path give these bits)."""
        from ..utils.image import preprocess

        x = np.ascontiguousarray(np.transpose(preprocess(image, self.img_size), (0, 3, 1, 2)))
        return torch.from_numpy(x).to(self.device)

    def forward_device(self, x: torch.Tensor) -> list[torch.Tensor]:
        """The compiled graph on an input already on the device."""
        return self.cm(x)

    def detect(self, image: np.ndarray, threshold: float = 0.25) -> list[dict]:
        return self.decode(self.forward_device(self.prepare(image)), threshold)

    def decode(self, outs, threshold: float = 0.25) -> list[dict]:
        from .yolo26 import decode_detections

        outs = [o.cpu().numpy() if isinstance(o, torch.Tensor) else np.asarray(o)
                for o in outs]
        if len(outs) >= 2 and outs[1].ndim == 3 and outs[1].shape[-1] == 4:
            logits, boxes = outs[0], outs[1]
        else:  # one [1, N, 4 + C]
            boxes, logits = outs[0][..., :4], outs[0][..., 4:]
        return decode_detections(logits, boxes, threshold)


class SupertonicOnnx:
    """The four Supertonic sub-models, each a compiled ONNX graph, with the
    5-step flow-matching loop.

    `model_dir` holds the four files under the repo's fixture names or the
    names the published exports ship under. Each graph compiles at its own
    input shapes. `synthesize_latent` composes the four into one program a
    latent length (runtime/compose.py; JAX's `_fused_fn`); the host-chained
    `synthesize_latent_hostloop` is its oracle. `device` defaults to
    `default_device()`, which raises where there is no CUDA card. The noise
    is numpy's `default_rng(seed).standard_normal`, as in the JAX package,
    so a seed gives the same bits on both sides."""

    _NAMES = {
        "dp": ("supertonic_dp.onnx", "duration_predictor.onnx"),
        "te": ("supertonic_te.onnx", "text_encoder.onnx"),
        "ve": ("supertonic_ve.onnx", "vector_estimator.onnx"),
        "voc": ("supertonic_voc.onnx", "vocoder.onnx"),
    }

    def __init__(self, model_dir: str | Path, steps: int = 5,
                 device: torch.device | str | None = None):
        from ..compiler import compile_model

        d = Path(model_dir)
        self.device = torch.device(device) if device is not None else default_device()

        def find(key):
            for name in self._NAMES[key]:
                if (d / name).exists():
                    return str(d / name)
            raise FileNotFoundError(f"none of {self._NAMES[key]} in {d}")

        self.dp, self.te, self.ve, self.voc = (
            compile_model(find(k), device=self.device) for k in ("dp", "te", "ve", "voc"))
        self.steps = steps
        self._fused_cache: dict = {}

    def _noise(self, channels: int, latent_len: int, seed: int) -> np.ndarray:
        rng = np.random.default_rng(seed)
        return rng.standard_normal((1, channels, latent_len)).astype(np.float32)

    @staticmethod
    def _upsample_index(tn: int, latent_len: int) -> np.ndarray:
        """Nearest upsampling of the text memory's last axis to latent_len."""
        return np.minimum(np.arange(latent_len) * tn // latent_len, tn - 1)

    def _emb_shape(self) -> tuple:
        """The text encoder's output shape [1, channels, Tn], from its trace."""
        return tuple(self.te._tape.out_meta[0][0])

    def fused(self, latent_len: int):
        """The four models and the flow loop as one composed program (JAX
        `_fused_fn`): (ids, style, mask, noise [1, channels, latent_len]) →
        (durations, wave). The upsampling index and the flow steps' times
        are device constants made here, with the program."""
        fn = self._fused_cache.get(latent_len)
        if fn is not None:
            return fn
        dp, te, ve, voc, steps = self.dp, self.te, self.ve, self.voc, self.steps
        idx = torch.from_numpy(self._upsample_index(self._emb_shape()[-1], latent_len))
        idx = idx.to(self.device)
        t_steps = (torch.arange(steps, dtype=torch.float32) / steps).to(self.device)

        def pipeline(call, ids, style, mask, noise):
            (dur,) = call("dp", **dict(zip(dp.input_order, (ids, style, mask))))
            (emb,) = call("te", **dict(zip(te.input_order, (ids, style, mask))))
            emb_l = emb.float().index_select(emb.dim() - 1, idx)
            xt = noise
            for s in range(steps):
                (v,) = call("ve", **dict(zip(ve.input_order,
                                             (xt, emb_l, style, t_steps[s:s + 1]))))
                xt = xt + v.float() / steps
            (wave,) = call("voc", **{voc.input_order[0]: xt})
            return dur, wave

        fn = self._fused_cache[latent_len] = compose_models(
            {"dp": dp, "te": te, "ve": ve, "voc": voc}, pipeline)
        return fn

    @torch.inference_mode()
    def synthesize_latent(self, ids, style, mask, latent_len: int, seed: int = 0):
        """ids [1, Tn]; style [1, S]; mask [1, Tn] → (durations, wave), numpy:
        one composed program (`fused`), the noise uploaded into its static
        buffer, the two results read back once."""
        noise = self._noise(self._emb_shape()[1], latent_len, seed)
        dur, wave = self.fused(latent_len)(np.asarray(ids), np.asarray(style, np.float32),
                                           np.asarray(mask, np.float32), noise)
        return dur.cpu().numpy(), wave.cpu().numpy()

    def synthesize_latent_hostloop(self, ids, style, mask, latent_len: int, seed: int = 0):
        """The host-chained oracle: four separate runs and a host copy of the
        latent every flow step."""
        (dur,) = self.dp.run_np(ids, style, mask)
        (emb,) = self.te.run_np(ids, style, mask)
        emb = np.asarray(emb, np.float32)
        emb_l = emb[..., self._upsample_index(emb.shape[-1], latent_len)]
        xt = self._noise(emb.shape[1], latent_len, seed)
        for s in range(self.steps):
            t_step = np.asarray([s / self.steps], np.float32)
            (v,) = self.ve.run_np(xt, emb_l, style, t_step)
            xt = xt + np.asarray(v, np.float32) / self.steps
        (wave,) = self.voc.run_np(xt)
        return np.asarray(dur), np.asarray(wave)
