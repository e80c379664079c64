#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (lele_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

1. builds every kernel under lele_tpu_torch/csrc/ with nvcc;
2. prints the card's name and power limit;
3. holds each kernel against its plain PyTorch version on the card, at the
   main paths' shapes and in their working types: the w8a16 GEMM and layer;
   the w8a16 stack (kernel 1, csrc/sanm_stack.cu: one cooperative launch for
   all 50 layers) at T = 21, 87 (76 valid), 171, 196 and 1,004 and at head
   dims 32 and 64, each repeat call bit-identical and a CUDA-graph replay
   bit-identical to the eager call; the dynamic-quantized int8 GEMM (its strip form, and its tile
   form at [512 -> 512], bit for bit at the compiled head's T = 36, 100,
   196 and the quant_pallas linears at T = 21, 171); the exact-DQL SAN-M
   stack (kernel 4, csrc/sanm_dql.cu: one cooperative launch for all 50
   layers), layer by layer on the plain version's own activations, and
   whole, at head dims 32, 64 and 128, each repeat call and CUDA-graph
   replay bit-identical, one call one kernel node when captured in a CUDA
   graph;
4. drives the native main path at full width: SenseVoice w8a16 (50 layers,
   d512, vocab 25,055, random weights from a seed) behind SenseVoiceEngine,
   answering three WAV requests (1.0 s, 4.3 s, 10 s), and checks from the
   launch counts that every kernel ran (the stack once a request); one 10 s
   request on the same weights as per-layer params (kernel 3, 50 launches);
   then holds the 10 s logits of the kernel path against the plain path;
5. times each kernel, its plain version, its bound on the card and, where one
   PyTorch call computes the same product, that call, with CUDA events
   (median of warm runs), kernel 5 and torch._int_mm also by device time
   (torch.profiler, and a CUDA graph of 20 calls) at T = 36, 100, 196; the
   w8 stack at T = 21, 87, 171, 196 and 1,004 by events, the profiler and a
   CUDA graph, with its per-phase split; and the native 10 s forward by
   events and in a CUDA graph;
6. drives the compiled main path at full width: the SenseVoiceSmall-layout
   int8 ONNX graph (50 layers, d512, 4 heads, ffn 2048, vocab 25,055, int8
   CTC head, random weights from a seed) behind SenseVoiceOnnx, answering
   three requests (1.0 s, 4.3 s, 10 s) on the fused kernels, with launch
   counts and pattern hits checked; holds its 10 s logits against the per-op
   path compiled from the same bytes; times compile, request and RTF on both;
   traces three compiled 10 s forwards with torch.profiler and prints the
   device's busy share and time by kernel;
7. holds kernel 6 (the LSTM recurrence) against its plain version at the
   Silero shapes: the native offline scan (S = 312, 1,875 and 18,750
   chunks, B = 1, H = 128), the fixture's graph (S = 3 and 2, B = 1 and 2),
   a ragged one; a repeat call and a CUDA-graph replay the same bits, one
   call one kernel node;
8. drives Silero VAD native at full width (d_hidden 128, convs
   128/64/64/128, random weights from a seed): `SileroVad.speech_probs`
   and `segments` on 1, 10 and 60 s of audio at 16 kHz and 10 s at 8 kHz,
   one `lstm_seq` launch per request, kernel path against the plain path;
9. drives `SileroOnnx` on fixtures/silero.onnx at 16 and 8 kHz on 10 s:
   one `lstm_seq` launch per chunk, the If on each rate's front-end, held
   against the same graph compiled with `overrides={"LSTM": lstm_plain}`;
10. times kernel 6, its plain version, its bound, cuDNN's LSTM (events; and
   at S = 3, 312, 1,875, 18,750 in a CUDA graph), the streaming step and the
   RTFs of both Silero paths, and profiles one compiled 10 s request
   (kernel 6's share of its device time);
11. holds kernel 7 (the w4a16 GEMM) against its plain version at the
   GEMM shapes, T = 171 and 87, bf16 and f32, and at MatMulNBits groups 32
   and 128, and its decode form at M = 1 to 8 (up to 4 rows in f32, 8 in
   bf16's group form; the tile form beside it above) with a repeat call
   bit-identical; kernel 8 (the w4 SAN-M stack) layer 0 and
   whole (50 layers) at T = 171 and at T = 87 with 76 valid rows, and as
   kernel 1 in phase 3 (the same T, head dims, repeat and graph bits);
12. drives SenseVoice w4a16 at full width (`SenseVoiceConfig(weight_int4=
   True)`, random weights from a seed) behind SenseVoiceEngine, answering
   the three WAV requests: kernel 8 and kernel 7 (the CTC head) once a
   request and no w8 kernel; holds the 10 s logits against the plain path;
13. compiles a MatMulNBits graph at the main path's linear widths (512 →
   1536, 512 → 2048 → 512, 512 → 25,055; blocks 32 and 128, packed zero
   points and bias; 196 rows) with the default patterns and with
   `patterns=[]`: pattern hits, one kernel 7 launch a node, fused vs per-op;
14. times kernels 7 and 8, their plain versions, bounds and kernel 7's
   library call (the CTC head also by device time), kernel 8 at phase 5's T
   by events, the profiler and a CUDA graph with its per-phase split, the
   two compiled MatMulNBits paths, and the w4 and w8 10 s forwards in one
   call, by events and in a CUDA graph;
15. holds kernel 9 (the GRU recurrence) against its plain version, both
   linear_before_reset forms, in its register form at H = 128 (S = 1,875
   and 18,750, B = 1; B = 4) and at H = 1, 33, 64, 100 (B = 2), and in its
   general form at H = 256; kernel 6's general form at
   H = 256 and 1,024; kernel 7 at groups 8 and 24, at K = 1,040 (the
   dequantised-tile form) and through its expert-indexed entry, and its
   decode form there and at Phi-3.5-MoE's widths (a cluster splitting K),
   each repeat call bit-identical;
16. compiles an ONNX GRU graph (input 128, H 128, bidirectional, 1,875
   steps; both forms) with the default emitters and with the gru_plain
   override: one gru_seq launch a direction a request, the routes, the two
   paths against each other; a ragged B = 4 request on the loop; an LSTM
   graph at H = 256, S = 1,023 on kernel 6's general form;
17. compiles the Phi-3.5-MoE-form MoE layer (router MatMul into QMoE,
   hidden 1024, inter 1792, 8 experts, top-2 SparseMixer, 4-bit experts) at
   1, 4 and 16 rows with the default patterns, the f32 variants and
   `patterns=[]`: pattern hits, three kernel 7 launches a decode request,
   none at prefill, each route against the per-op path;
18. times kernel 9 against its plain version, cuDNN's GRU and its bound;
   kernels 6 and 9 at H = 256; kernel 7 at the decode shapes (the MoE
   layer's and the published Phi-3.5-MoE expert widths) against
   torch.matmul, by events and by device time with a warm and a cold L2;
   the QMoE node and the GRU graph per request, both ways;
19. holds kernel 10 (the flow estimator's 8 attention blocks) against its
   plain version at examples/supertonic/tts.json's widths (D 256, 4 heads,
   F 1,024) at (T, Tk) = (1,024, 320), (512, 160) and a ragged (37, 19),
   with masked tails, each repeat call and CUDA-graph replay bit-identical;
20. drives Supertonic TTS at full width (tts.json with the fused
   estimator, random weights from a seed) behind TtsEngine, with the
   Supertonic 2 and 3 settings and voices, on three texts, each chunk one
   captured duration → mask → synth program (a bucket guess, one
   re-dispatch where it misses): kernel 10 five times a program run and no
   other kernel; each WAV against the unfused f32 route;
21. times kernel 10, its plain version, its bound and a composite of bf16
   library calls, by events, the profiler and a CUDA graph; the synth core
   (eager) at 512 and 1,024 latent frames, fused and unfused, with RTF,
   and profiles both at 1,024; TtsEngine per request, captured and
   uncaptured; registers the synth programs at 512 and 1,024 frames and
   TtsEngine for phase 32;
22. drives SupertonicOnnx on the four fixture graphs: each against
   supertonic_io.npz, `synthesize_latent` (the four graphs and the flow
   loop composed into one captured program, runtime/compose.py) against
   the host loop, no kernel; registers it for phase 32;
23. holds kernel 12 (flash attention, csrc/flash_attn.cu) against its
   plain version and an f64 oracle at the TPU script's shape (B 2, H 8,
   L 2,048, D 128, causal), its masked shape (a float mask x 2), the Phi-3
   prefill (B 1, H 32, Lq 1,920, Lk 4,096, D 96, its real mask), GQA 32/8,
   bool masks with a fully masked row, D 16, 256 and 264, a chunked prefill
   (512 tokens from slot 512), a float mask with -inf entries and a bool
   mask whose fully masked row shares its q tile with dead key tiles; at
   each, the key tiles the kernel skipped must be exactly those the plain
   skip test marks; times kernel, plain and F.scaled_dot_product_attention
   at the first and third, by events and in a CUDA graph, with the bound on
   the live pairs;
24. drives the opset-23 LLM slice at Phi-3-mini-4k-instruct's published
   widths (hidden 3,072, 32 heads of 96, FFN 8,192, vocab 32,064; 2 of 32
   layers, random weights from a seed, a 4,096-slot static KV cache): one
   graph (onnx/synth.build_attn23_decoder) compiled for S = 512, 1,024,
   1,920 and 1; three requests (prompts of 512, 1,024, 1,920 tokens, 16
   greedy steps each): kernel 12 twice a prefill and never in a decode
   step; every logit row against the same requests on a compile with the
   plain Attention (teacher forced); prefill and decode times, a profile of
   the 1,920-token prefill;
25. holds kernel 11 (the exact int8 GEMM, csrc/int8_gemm.cu) against its
   plain version, int32 equal, operands with -128, at a layer's four linears
   at M = 21, 171, 684 (a batch of 4) and 196 (the per-op graph), that
   graph's int8 head, M = 1, JAX's ragged (50, 70, 30) and (37, 70, 30),
   1,024^3 and 2,048^3; one call one kernel node, a graph replay the same
   bits; times kernel, plain, bound and torch._int_mm (N padded to 8) at
   the 10 s request's linears, the head and the squares;
26. drives SenseVoice dynamic int8 at full width (`SenseVoiceConfig(
   quantized=True)`, prepared with drop_fp and stacked, random weights from
   a seed) behind SenseVoiceEngine with a CtcTokenizer over a synthetic
   25,055-token vocabulary: three WAV requests answered as text, kernel 11
   200 times a request and no other kernel; the 10 s logits against the
   plain path; then `quant_pallas=True`: kernel 5 200 times a request, its
   logits against the kernel 11 route; times both routes (events, host
   clock, RTF) and profiles one forward;
27. on phase 4's w8a16 model: `recognize_batch` of three WAVs (B = 3
   padded to 4, the 10 s bucket; kernel 2 201 times, no layer or stack
   kernel), the batch logits against its plain path; a 75 s request through
   `recognize` (`transcribe_long`: 3 windows in one batch) against its plain
   path; a quantized batch of 4 (kernel 11 at M = 684); times and RTFs;
28. MoE (`SenseVoiceConfig(weight_int8=True, n_experts=8)`, unstacked; every
   layer carries the MoE FFN, as JAX's init gives it): one 10 s request,
   kernel 2 for qkv and out; the kernel path against the plain path at f32
   activations (bf16's gap printed beside the plain path's own at a 1e-7
   input step: top-1 routing flips on near ties);
29. `StreamingSenseVoice.transcribe_stream` at full width (f32 masters) on
   the 10 s request: 11 chunks of 16 frames, ids in the vocabulary, no
   kernel; host time per chunk;
30. the per-op compile of phase 6's int8 export (`patterns=[]`) with the
   default MatMulInteger emitter (kernel 11, once a node) and with the f64
   override: identical 10 s logits; both times;
31. YOLO26 detect and segment at full width, no kernel of its own (cuDNN
   convs): `YoloOnnx` on fixtures/yolo26.onnx (640 x 640) in f32 and with
   compute="bfloat16", each against the fixture's torch outputs at JAX's
   gates, `detect` on a u8 image; the native `Yolo26Config()` (640, widths
   32-256, 80 classes, 300 queries) detect and seg, bf16 and f32, behind
   `Yolo26Engine` (`detect`, and a `detect_batch` of 5 padded to 8): each
   request's head maps against the port's CPU run of the same params and
   input, its selected cells against the CPU's wherever the order is
   decided, its detections against the decode of those maps; times of the
   compiled and native forwards (events, CUDA graph), beside the same
   network as plain bf16 F.conv2d calls, `detect` by host clock, and a
   profiled request;
32. holds every captured path against its uncaptured oracle at full width.
   Since the runtime captures one CUDA graph a bucket (runtime/graphs.py),
   phases 4-31 already drive the captured paths; each phase registers its
   path (CAPTURED): the native bucketed programs (w8a16, w4a16, dynamic int8
   on kernel 11 and on kernel 5, MoE), the batch of 3 and the 75 s
   long-form, SileroVad's scan and streaming step, the streaming ASR decode
   step, and the CompiledModel graphs (the compiled SenseVoice, SileroOnnx in
   blocks, MatMulNBits, GRU, QMoE decode, the per-op int8 graph, the
   opset-23 prefill and decode step, YoloOnnx), and the native YOLO26
   behind Yolo26Engine, the TTS synth programs at 512 and 1,024 frames
   and TtsEngine (kernel 10 five times a program: its 68 kernel nodes a
   call are counted by name), SupertonicOnnx's composed program, and phase
   33's GPT-2 greedy decode and Whisper-width seq2seq against their host
   loops. For each: the same bits, or the path's card gate
   where cuBLAS or cuDNN may take another algorithm under capture; the
   uncaptured path's launch counts; a second call on other inputs that
   leaves the first call's outputs as they were; one program for both
   inputs of a bucket; both paths' times by host clock and events with the
   device's busy share (medians of 5 and 10 calls, or one call each for a
   side slower than SLOW_CALL_MS a call); the memory reserved after the captures; then 32b,
   SileroOnnx's block size (1, 8, 32, 128 and 312 chunks a graph);
33. (run before 32, which holds its paths) generative decode through the
   port's runtime/decode.py and runtime/seq2seq.py on step graphs exported
   by torch.onnx.export through the port's onnx/torch_shim.py: GPT-2 small
   (12 layers, d 768, 12 heads, vocab 50,257, 1,024 positions; random
   weights from a seed) greedy, sampled and beam 4, and Whisper-tiny's
   decoder widths (4 layers, d 384, 6 heads, vocab 51,865) over a 1,500-
   frame encoder graph through Seq2SeqGenerator: each fused program (one
   step program a (B, P), replayed a token) against its host loop, ids
   equal, ms a token both ways;
34. the tracer's Scan and Loop and ONNX local functions at full width:
   Silero's 10 s utterance (312 chunks) at 16 and 8 kHz as one ONNX Scan and
   one Loop over fixtures/silero.onnx's step, each one captured CUDA graph a
   call with kernel 6 launched once a chunk (its graph's kernel nodes read
   back), bit-equal to `SileroOnnx.speech_probs` and within VAD_PROB_TOL of
   the lstm_plain compile, with both paths' times; a CF_SANM_LAYERS-layer
   SAN-M encoder at SenseVoice's widths (D 512, 4 heads, FFN 2,048, FSMN k 11, T 196,
   random weights from a seed) exported here by torch.onnx.export through
   the port's onnx stand-in with each layer a local function, quantized by
   the port's `quantize_dynamic`, compiled: every layer fused, kernel 4 once a
   call in a captured graph, the bits of the same model exported flat and
   quantized the same way, the per-op trace within LOGIT_NOISE_MAE; the
   export's, quantizer's and program's times;
35. the ORT-GenAI int4 decoder form (onnx/synth.py `build_genai_decoder`:
   com.microsoft SimplifiedLayerNormalization, SkipSimplifiedLayerNormalization,
   RotaryEmbedding, GroupQueryAttention and MatMulNBits; QMoE in the MoE
   form) at Phi-3-mini's width (GENAI_DENSE_LAYERS of 32 layers) and
   Phi-3.5-MoE's attention and expert widths (GENAI_MOE_LAYERS of 32 layers),
   random weights drawn on the card from a seed, written as model.onnx +
   model.onnx.data by save_with_external_data and compiled from the path, the
   caches donated: a 128-token prefill and GENAI_STEPS greedy steps through
   captured graphs, every MatMulNBits on kernel 7 (its
   launches a step counted), each step's logits against the graph on kernel
   7's plain version, the captured donated bits against the uncaptured
   replay, prefill and decode times, kernel 7's device time a step against
   its bound, the busy share;
36. the ONNX op layer's math, tensor, nn and activation emitters (no kernel
   of the port's own: cuDNN's convs and the emitters): a ResNet-50 graph in
   the ONNX Model Zoo's resnet50-v1-7 layout (53 convs, 25.6 M parameters,
   random weights from a seed; `resnet50_model`) compiled and run at N = 1
   and 8, captured: the captured call the bits of `replay()`, the logits
   within RESNET_F32_REL (1e-5 max|ref|) of the port's CPU run of the same
   bytes, TopK and ArgMax indices equal where the CPU's margins decide them,
   the bf16 compute policy at N = 8 within RESNET_BF16_REL; times by events
   and host clock, captured and step by step, the busy share of a profiled
   call and an op breakdown; then one small graph for each of the 87
   emitters, ConvTranspose at 2-D and 3-D and Resize's cubic and crop forms
   (`emitter_graphs`), each captured, against the CPU, with the graphs that
   do not capture named; the GatherND, ScatterND and Compress graphs
   replayed again after all the others, bit for bit, and NonMaxSuppression
   refused as the JAX package refuses it;
37. static int8 quantization in ORT's two formats on the same ResNet-50
   network at full width: the QDQ graph from the port's quantize_static
   (per-channel weights, calibrated on the card) and the QOperator graph
   (`resnet50_qoperator_model`: BN folded, QLinearConv, QLinearAdd,
   QLinearGlobalAveragePool, QGemm, its grids from calibrate_minmax of the
   folded float graph), each compiled and run at N = 1 and 8, captured: the
   captured call the bits of `replay()`, every u8 tensor against the port's
   CPU run of the same bytes (flipped codes counted; QOP_GATE_CODES,
   QDQ_GATE_STEPS), TopK and ArgMax where the gate decides them, kernel 11
   launched once an integer product (54 a forward) and held to its plain
   version at each conv shape class, times captured and step by step with
   kernel 11's share and the int8 bound; then one graph for each of the 17
   quant emitters (`quant_emitter_graphs`), captured, against the CPU;
38. the entry points at full width: the port's server (ThreadingHTTPServer
   on 127.0.0.1:0) over build_engines()'s full-width JAX defaults and over
   the main path's engines (w8a16 SenseVoice, the fused Supertonic of
   tts.json, YOLO26): /healthz, the demo page, /recognize of 1.0, 4.3 and
   10 s, a burst of 8 concurrent /recognize requests through the
   MicroBatcher (each answer recognize_batch's for the batch it joined, a
   flush of more than one), /recognize_batch, /detect of a JPEG,
   /synthesize, each answer the engine's direct call and its launches the
   direct call's (kernels 1 and 2 once a lone w8a16 request, kernel 10 on
   /synthesize); then every route at once (`mixed_traffic`), each answer
   the direct call's; /recognize latency p50 / p90 / max at 1, 4 and 8
   clients by host clock over ENTRY_REQUESTS requests each, with the batch
   sizes; `python -m lele_tpu_torch.cli` on phase 6's
   int8 graph in a subprocess and its generated wrapper in a fresh one
   (kernels 4 and 5 once a call, the bits of compile_model in this
   process); --quantize-weights within QW_GATE of f64 on its blob's
   weights and more than QW_FLOOR off the f32 weights' output,
   --quantize-dynamic the bits of quantize_dynamic + compile_model, and
   build_model from a local model.toml (a real wrapper);
39. the rest of the op layer: SenseVoice's log-mel front-end in ONNX ops
   (DFT, HannWindow, MelWeightMatrix) before the full-width int8 encoder at
   4.3 and 10 s (kernels 4 and 5 once a call), an SD 1.5 UNet block in
   ORT's fused form at published widths, and one graph for each new
   emitter, each captured and against the CPU;
40. the com.microsoft search and packed sets at full width (`search_phase`):
   an int8 GPT-2 small BeamSearch export bound by bind_inputs (kernel 5 in
   every decoder walk of one captured program; kernels 5 and 11 against
   their plain versions at its shapes), the f32 decoder under the same
   BeamSearch and under GreedySearch, WhisperBeamSearch at Whisper-tiny
   widths and a packed BERT-base stack, each captured against its replay
   and the CPU;
41. training (`train_phase`): the CTC train step against the CPU at
   dryrun_multichip's config; at the flagship's widths (50 layers, d 512,
   bf16 compute) the loss over 10 steps, the step's time, peak memory with
   remat and without, and its share of the bf16 bound; a checkpoint
   restored on the card giving the next step's bits; the sharded step on
   NCCL over a 1 x 1 x 1 mesh;
42. the multi-device layer (`mesh_phase`) in an NCCL group of one rank: the
   50 w8 layers as a one-stage GPipe pipeline (kernel 1 a row, the bits of
   one launch a row), the Phi-3-mini-width int4 step compiled over a mesh
   with `_q`/`_s` rules (kernel 7, the mesh-free compile's bits), the
   daemon's full-width engines over a mesh (8 concurrent /recognize and a
   /detect, each request's ids alone and mesh-free), dryrun_multichip's six
   remaining legs, and two gloo ranks sharing the card for the tp legs;
43. the JAX package's last modules (`aot_phase`): phase 6's graph through
   `python -m lele_tpu_torch.cli --aot --xc`, its four cold starts in fresh
   processes (traced warm, the .pt2 program, the .xc bundle with an empty
   build cache and nothing built, traced with nvcc), each the compiled
   model's bits and kernels 4 and 5 once a call; the native w8a16 encoder
   through save_aot_bundle / load_aot_bundle (kernels 1 and 2, the bits);
   ResNet-50 and the SD block at each --precision; opcheck of the 12
   registered ops on the card and the dispatcher's host cost; the native
   WAV decoder against the Python parser;
44. prints one JSON line of kernels (rows 4 and 6 count phase 34's launches
   too, row 7 phase 35's, row 11 phase 37's, rows 1, 2, 4, 5 and 10 phase
   38's, rows 4 and 5 phase 39's, row 5 phase 40's, rows 1, 2 and 7 phase
   42's, rows 1, 2, 4 and 5 phase 43's), the card, and last {"ok": true,
   "device": ...}.

Each phase's seconds follow its output ("[phase 7: 12.3 s]"). Exits
non-zero, and prints no result, when there is no CUDA card or any check
fails. Imports no jax and nothing of the JAX package.
"""

from __future__ import annotations

import io
import json
import math
import os
import statistics
import subprocess
from itertools import cycle
import sys
import time
import wave
from pathlib import Path

SEED = 0
GRAPH_SEED = 2026
SR = 16000
REQUEST_SECONDS = (1.0, 4.3, 10.0)
T_MAIN = 171  # 10 s: 998 fbank frames → 167 LFR frames + 4 prefix frames
T_RAGGED = 87  # 4.3 s padded to the 5 s bucket: 83 LFR + 4, of which 76 valid
VALID_RAGGED = 76
# the compiled graph's rows: SenseVoiceOnnx pads PCM to steps of 32 LFR
# frames of audio; 10 s → 192 frames + 4 prefix, 171 valid; 4.3 s → 96 + 4
T_DQL = 196
VALID_DQL = 171
T_DQL_RAGGED = 100
VALID_DQL_RAGGED = 76
GEMM_SHAPES = ((512, 1536), (512, 512), (512, 2048), (2048, 512), (512, 25055))
# kernel 2's rows: the B = 1 10 s request, 4.3 s, the batch of 4 in the 10 s
# bucket, the 75 s long-form request's three 30 s windows, and a ragged count
W8_ROWS = (T_MAIN, T_RAGGED, 4 * T_MAIN, 1512, 513)
# (M, K, N) kernel 2 runs on its paths: the CTC head of a B = 1, a batch and
# a long-form request, the batch and long-form layer linears, MoE's qkv and
# out at 10 s
W8_TIMED = ((T_MAIN, *GEMM_SHAPES[-1]), (4 * T_MAIN, *GEMM_SHAPES[-1]), (1512, *GEMM_SHAPES[-1]),
            *((m, k, n) for m in (4 * T_MAIN, 1512) for k, n in GEMM_SHAPES[:-1]),
            (T_MAIN, *GEMM_SHAPES[0]), (T_MAIN, *GEMM_SHAPES[1]))
# kernel 5's strip form (the tile form at [512 -> 512]): the compiled head at
# the buckets' rows (1 s, 4.3 s, 10 s) and the quant_pallas route's four
# linears at 1 s and 10 s
DQ_STRIP_SHAPES = (*((t, *GEMM_SHAPES[-1]) for t in (36, T_DQL_RAGGED, T_DQL)),
                   *((t, k, n) for t in (21, 171) for k, n in GEMM_SHAPES[:-1]))
TIMED_RUNS = 20
# the stacks (kernels 1 and 8) at the main path's rows: 1 s, 4.3 s in the 5 s
# bucket (76 valid), 10 s, the compiled path's 10 s bucket, and the 60 s
# bucket (5,998 fbank frames → 1,000 LFR frames + 4 prefix)
STACK_T = ((21, 21), (T_RAGGED, VALID_RAGGED), (T_MAIN, T_MAIN), (T_DQL, T_DQL), (1004, 1004))
# NVIDIA's data sheet, H100 SXM, dense: HBM 3.35 TB/s; bf16 989 TFLOP/s,
# int8 1,979 TOP/s, f32 outside the tensor cores 67 TFLOP/s, TF32 495 TFLOP/s
PEAK_BYTES = 3.35e12
L2_BYTES = 50e6  # the H100's L2
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12, "tf32": 495e12}
# kernel 4 whole against its plain version: one moved int8 code in an early
# layer carries through the 50 DQL layers at the graph's quantization noise
# (a 1e-7 relative perturbation of the input moves the plain stack by
# mean|d| 0.021 std, max 0.023 max|ref|: scripts/torch_port_dql_noise.py)
STACK_NOISE_MEAN = 0.05
STACK_NOISE_MAX = 0.1
# one layer of kernel 4 on the plain version's own input: a moved DQL code
# shifts mean|d| by ~1e-5 std (plain vs plain at a 1e-7 input step read
# 6e-8 to 1.3e-5 std over 28 small layers on an H100), while a key part of
# the attention left out of its merge read 1.3e-2
LAYER_NOISE_MEAN = 1e-3
# the compiled 10 s logits, fused vs per-op, at the same noise (the probe
# reads MAE 0.025 std and argmax agreement 0.94-0.96 for a 1e-7 input step)
LOGIT_NOISE_MAE = 0.05
LOGIT_NOISE_AGREE = 0.90
# kernel 6 vs its plain version: both f32 FMA; the recurrence is contractive,
# so the summation-order difference stays at a few f32 ulps of the states
# (the first call read max|d| <= 3e-7 up to S = 18,750)
LSTM_TOL = 1e-5
# Silero probabilities, kernel path vs plain path (the same states, through
# the head's sigmoid)
VAD_PROB_TOL = 1e-5
VAD_SECONDS = (1.0, 10.0, 60.0)
VAD_LONG_SECONDS = 600.0
VAD_SR = 16000
SILERO_FIXTURE = Path(__file__).resolve().parent / "fixtures" / "silero.onnx"
# kernel 7 vs its plain version: exact products on both sides, so only the
# f32 summation order differs. The first call read <= 1.9e-7 max|ref| in bf16
# and <= 1.3e-6 in f32, so the bf16 gate was tightened from 1e-4 to 1e-5
W4_TOL = {"bfloat16": 1e-5, "float32": 1e-5}
NBITS_ROWS = 196
# MatMulNBits, fused (bf16 activations) vs per-op (f32): the gate of
# tests/test_matmul_nbits_fusion.py:161-165
NBITS_RELNORM = 5e-3
# kernel 9 vs its plain version: both f32 FMA, as kernel 6 (LSTM_TOL)
GRU_TOL = LSTM_TOL
# (S, B, H): the GRU graph's width at 60 s and 600 s, a batch of 4, the
# cluster form at H 256, and the register form at H 1, 33, 64 and 100
GRU_SHAPES = ((1875, 1, 128), (18750, 1, 128), (1875, 4, 128), (1023, 1, 256),
              *((1875, 2, h) for h in (1, 33, 64, 100)))
# the QMoE layer, f32 route (kernel 7's exact form) vs per-op: f32 products
# on both sides, only summation orders differ. The first call read 1.1e-6,
# so the gate was tightened from 1e-5 to 5e-6 (the bf16 route read 3.0e-3
# against JAX's 5e-3, NBITS_RELNORM, which stays)
QMOE_F32_REL = 5e-6
MOE_ROWS = (1, 4, 16)  # rows·k <= 8 experts: decode at 1 and 4; prefill at 16
PHI_MOE = (4096, 6400)  # Phi-3.5-MoE's published expert widths (hidden, inter)
EXAMPLES = Path(__file__).resolve().parent / "examples"
FIXTURES = Path(__file__).resolve().parent / "fixtures"
# kernel 10 vs its plain version: the same bf16-rounded operands and f32
# sums in another order, so an activation may round to the neighbouring
# bf16 value and carry it through the later blocks: one bf16 step (2^-8) of
# the largest magnitude, the bound tests/test_torch_port_est_block.py holds
# the plain version to against the TPU kernel
EST_TOL = 2.0 ** -8
# (T, Tk, valid T, valid Tk): the largest latent and token buckets, the
# bucket the timings also use at 5 s, and a ragged shape with masked tails
EST_SHAPES = ((1024, 320, 1024, 320), (512, 160, 480, 150), (37, 19, 32, 16))
# fused (bf16 products) vs unfused (f32) TTS waveforms: test_est_block.py's
# correlation gate, and max|d| <= 1e-2 max|ref| (the first call read
# <= 1.7e-3 over six requests)
TTS_CORR = 0.999
TTS_REL = 1e-2
TTS_TEXTS = (
    "Hello, this is the port's speech synthesizer.",
    "The quick brown fox jumps over the lazy dog, and then it runs away quickly!",
    "Speech synthesis turns written text into sound. " * 4
    + "Long passages are cut at sentence boundaries, so that every character is "
      "spoken. " * 2,
)
SYNTH_FRAMES = ((512, 160), (1024, 320))  # latent frames, tokens: 5.5 s and 10.9 s
# kernel 12 against an f64 oracle and its plain version: the gates of
# scripts/flash_attention_tpu.py:114-115, 159-160 (rel-max-err <= 2e-2, and
# within 3 x max(the plain path's, 1e-6)), and vs plain max|d| <= 1e-5
# max|ref|: both f32, only the summation order over <= 4,096 keys differs
FLASH_REL = 1e-5
# (B, H, KVH, Lq, Lk, D, causal, mask): the TPU script's shape
# (scripts/flash_attention_tpu.py:125), its masked shape (float mask x 2,
# :72-115), the Phi-3-mini prefill of 1,920 tokens over the 4,096-slot cache
# with its real mask, GQA at Phi-3's 32 heads over 8, a bool mask with a fully
# masked row, D = 16, 256, 264 (264: the FFMA form); a chunked prefill (512
# tokens from slot 512, the graph's own mask), a float mask with -inf entries
# (whole dead key tiles and scattered ones), and a bool mask whose fully
# masked row shares its q tile with dead key tiles
FLASH_SHAPES = ((2, 8, 8, 2048, 2048, 128, True, None),
                (1, 4, 4, 256, 256, 128, False, "float"),
                (1, 32, 32, 1920, 4096, 96, False, "prefill"),
                (1, 32, 8, 512, 1024, 96, False, "bool"),
                (2, 4, 2, 256, 256, 16, True, "bool"),
                (1, 4, 4, 128, 256, 256, False, "bool"),
                (1, 2, 2, 256, 256, 264, True, "float"),
                (1, 32, 32, 512, 4096, 96, False, "chunked"),
                (1, 4, 2, 256, 512, 64, False, "float_inf"),
                (1, 8, 8, 256, 512, 128, False, "bool_dead"))
FLASH_TIMED = ((2, 8, 2048, 128), (1, 32, 1920, 96))  # (B, H, Lq, D) of the timed shapes
# the slice's model: Phi-3-mini-4k-instruct at its published widths, 2 of 32
# layers (the f32 graph must stay below protobuf's 2 GiB); prompts of 512,
# 1,024 and 1,920 tokens, each followed by 16 greedy steps
LLM_LAYERS = 2
LLM_PROMPTS = (512, 1024, 1920)
LLM_DECODE = 16
# every logit row, kernel 12 route vs the plain-Attention compile (teacher
# forced): both f32, only the attention's summation order differs, carried
# through 2 layers and the head; JAX holds its rollout to rtol 1e-4
# (tests/test_llm_decode_e2e.py:174)
LLM_REL = 1e-4

# YOLO26 (phase 31): the fixture's gates are JAX's own
# (tests/test_fixture_e2e.py:144-186): f32 logits atol 2e-4, boxes 2e-3;
# bf16 compute logits atol 2e-3, boxes rtol 2e-2 / atol 5e-2, argmax >= 0.99
YOLO_F32_GATE = (2e-4, 2e-3)
YOLO_BF16_GATE = (2e-3, 2e-2, 5e-2, 0.99)
# the native head maps on the card against the port's CPU run of the same
# params and input, relative to max|ref|: f32 sums in another order (f32
# convs, TF32 off); bf16 rounds every conv's operands, so a summation-order
# difference may move an activation to the neighbouring bf16 step (2^-8
# relative) and carry it through the 11 convs after it
YOLO_MAP_REL = {"float32": 1e-5, "bfloat16": 1e-2}
YOLO_BATCH = 5  # detect_batch of 5 images, padded to 8

# phase 36: the ResNet-50 graph (resnet50_model) and the emitter graphs
RESNET_SEED = SEED + 36
RESNET_BLOCKS = (3, 4, 6, 3)
# ResNet-50 logits, card against the port's CPU run of the same bytes, both
# f32 (TF32 off): only the summation order of cuDNN's convs differs from the
# CPU's, over 53 convs with sums of up to 4,608 products (3 x 3 x 512). The
# gate began at 1e-4 max|ref|; the first card calls read 2.6e-7 (N = 1) and
# 3.8e-7 (N = 8), so it was tightened to YOLO's 1e-5 (YOLO_MAP_REL), 26x
# above the reading
RESNET_F32_REL = 1e-5
# bf16 compute (YOLO's policy, phase 31) against the CPU's f32 logits: bf16
# rounds every conv's operands (2^-8 relative) through 53 convs; YOLO's
# 1e-2 max|ref| (the first calls read 6.5e-3 at N = 8)
RESNET_BF16_REL = 1e-2

# phase 37: ResNet-50 in ORT's two static int8 formats (resnet50_model's
# network, QDQ from quantize_static and QOperator from
# resnet50_qoperator_model), calibrated on QUANT_CALIB batches of 8 images
# drawn from QUANT_SEED, and one graph for each of the 17 quant emitters
QUANT_SEED = SEED + 37
QUANT_CALIB = 2
# the QDQ logits, card against the CPU, in steps of their own output grid
# (the Gemm's output is fake-quantized): an f32 rounding difference at a
# half-step of any of the 19 fake-quantized activations flips a code, which
# the later convs carry on; the gate starts at 2 steps of max|ref|
QDQ_GATE_STEPS = 2
# the QOperator graph's u8 tensors, card against the CPU: integer products
# are exact on both and the requantizations the same f32 steps, so bits are
# expected; QLinearGlobalAveragePool's mean sums in another order on the
# card, so one code is allowed there and after it, and the logits one
# QGemm input step
QOP_GATE_CODES = 1

# the device's own time a call (us) of a kernel's row and of its library
# call, where a phase measured it: {name: {"device_us": torch.profiler's or
# None, "graph_us": in a CUDA graph, "library_device_us", "library_graph_us"}}
DEVICE_US: dict[str, dict[str, float | None]] = {}

# phase 32: the captured paths, each against its uncaptured oracle. label →
# {"after": i → the captured path's outputs on inputs i (0 or 1), "before":
# i → the uncaptured path's, "rel": None where the two must give the same
# bits (our kernels, elementwise work, and library calls that take the same
# algorithm under capture), else the path's card gate, max|d| <=
# rel·max|ref| (cuBLAS and cuDNN may pick another algorithm under capture),
# "programs": the `Programs` that must not grow on the second call (one
# program serves every length of a bucket), or None}; the phases that build
# each path register it
CAPTURED: dict[str, dict] = {}
# SileroOnnx's BLOCK, the chunks a captured graph, measured at 10 s (312
# chunks; 312 is the whole request in one graph)
SILERO_BLOCKS = (1, 8, 32, 128, 312)


class Checks:
    def __init__(self):
        self.failures: list[str] = []

    def require(self, ok: bool, what: str) -> bool:
        print(f"  [{'ok' if ok else 'FAIL'}] {what}")
        if not ok:
            self.failures.append(what)
        return ok


def card_identity() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def banner(title: str | None) -> None:
    """Print a phase's title ("== 7. ..."), after the seconds the phase
    before it took; None closes the last phase."""
    now = time.perf_counter()
    if _PHASE["name"] is not None:
        print(f"  [{_PHASE['name']}: {now - _PHASE['t0']:.1f} s]")
    if title is not None:
        _PHASE["name"] = "phase " + title[3:].split(".")[0]
        _PHASE["t0"] = now
        print(title)


# the phase whose title `banner` printed last, and when
_PHASE: dict = {"name": None, "t0": 0.0}


def wav_bytes(pcm, sr: int = SR) -> bytes:
    import numpy as np

    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes((np.clip(pcm, -1, 1) * 32767).astype("<i2").tobytes())
    return buf.getvalue()


def synth_speechlike(seconds: float, rng):
    """Tones with a slow amplitude envelope plus noise, in [-1, 1]."""
    import numpy as np

    t = np.arange(int(seconds * SR)) / SR
    f0 = rng.uniform(120, 300)
    env = 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(2, 5) * t)
    sig = sum(np.sin(2 * np.pi * f0 * k * t) / k for k in (1, 2, 3))
    return (0.2 * env * sig + 0.01 * rng.standard_normal(t.size)).astype(np.float32)


def time_ms(fn, runs: int = TIMED_RUNS, warm: int = 3) -> float:
    """Median of `runs` CUDA-event timings of fn(), after `warm` runs."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_ms(fn, runs: int = 5) -> float:
    """Median host-clock time of fn() (which ends in a device sync), warm."""
    fn()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def bound(n_bytes: float, ops: dict[str, float]) -> tuple[float, str]:
    """The least time (ms) the card could take: the larger of the bytes over
    the memory rate and the operations over the peak rate of their type."""
    t_bytes = n_bytes / PEAK_BYTES
    t_ops = sum(n / PEAK_OPS[kind] for kind, n in ops.items())
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def compare(got, ref):
    """(max|d|, max|ref|, mean|d| / std(ref))."""
    d = (got - ref).abs()
    return d.max().item(), ref.abs().max().item(), (d.mean() / ref.std()).item()


def random_dql_stack(L, D, F, k, dev, gen):
    """Stacked exact-DQL layer operands at full width, from a generator."""
    import torch

    st = {}
    for key, k_, n_ in (("qkv", D, 3 * D), ("out", D, D), ("ffn1", D, F), ("ffn2", F, D)):
        wq = torch.randint(-127, 128, (L, k_, n_), generator=gen, device=dev,
                           dtype=torch.int8)
        st[key] = {"wq": wq, "colsum": wq.to(torch.int32).sum(1, keepdim=True, dtype=torch.int32),
                   "ws": torch.full((L, 1, n_), 1.0 / (127 * k_ ** 0.5), device=dev),
                   "b": 0.02 * torch.randn((L, 1, n_), generator=gen, device=dev)}
    for key in ("norm1", "norm2"):
        st[key] = {"g": 1 + 0.1 * torch.randn((L, 1, D), generator=gen, device=dev),
                   "b": 0.1 * torch.randn((L, 1, D), generator=gen, device=dev)}
    st["fsmn"] = torch.randn((L, k, D), generator=gen, device=dev) / k ** 0.5
    return st


def dql_masks(L, T, n_valid, dev):
    """The graph's [L, T] attention key bias (-1e4 past the valid rows) and
    FSMN value mask."""
    import torch

    bias = torch.zeros((L, T), device=dev)
    bias[:, n_valid:] = -1e4
    vmask = torch.zeros((L, T), device=dev)
    vmask[:, :n_valid] = 1.0
    return bias, vmask


def layer_slice(stacked, i):
    return {k: ({kk: vv[i:i + 1] for kk, vv in v.items()} if isinstance(v, dict)
                else v[i:i + 1]) for k, v in stacked.items()}


def stack_tree(flag: str, dev, n_layers: int = 50, d_model: int = 512, n_heads: int = 4,
               ffn: int = 2048, seed: int = SEED, fsmn_dtype=None):
    """A stacked SenseVoice layer tree (flag "weight_int8" or "weight_int4",
    bf16 masters prepared as the main path prepares them) with random
    weights from a seed, its norms and biases moved away from 1 and 0;
    fsmn_dtype recasts the FSMN taps (bf16 by default)."""
    import torch

    from lele_tpu_torch.models import (
        SenseVoiceConfig,
        SenseVoiceModel,
        cast_big_params,
        prepare_w4_params,
        prepare_w8_params,
        stack_layer_params,
    )

    cfg = SenseVoiceConfig(n_layers=n_layers, d_model=d_model, n_heads=n_heads,
                           ffn_dim=ffn, vocab_size=64, **{flag: True})
    m = SenseVoiceModel(cfg, device=dev)
    m.init(seed)
    prep = prepare_w8_params if flag == "weight_int8" else prepare_w4_params
    st = stack_layer_params(prep(cast_big_params(m.params, torch.bfloat16)))["layers_stacked"]
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    for sub in st.values():
        for leaf, v in sub.items():
            if leaf in ("g", "b"):
                v.add_(0.1 * torch.randn(v.shape, generator=gen, device=dev))
    if fsmn_dtype is not None:
        st["fsmn"]["w"] = st["fsmn"]["w"].to(fsmn_dtype).contiguous()
    return st


def stack_check(fn, plain, x, mask, valid, stacked, H, FK) -> dict:
    """A stack kernel against its plain version on the valid rows, at the
    layer gate (rtol 2e-2, atol 2e-2 max|ref|), and a repeat call's bits."""
    import torch

    got = fn(x, mask, stacked, H, FK)
    again = fn(x, mask, stacked, H, FK)
    ref = plain(x, mask, stacked, H, FK)
    torch.cuda.synchronize()
    g, r = got[:valid], ref[:valid]
    d = (g - r).abs().max().item()
    scale = r.abs().max().item()
    ok = bool(torch.isfinite(g).all()) and torch.allclose(g, r, rtol=2e-2, atol=2e-2 * scale)
    return {"ok": ok, "d": d, "scale": scale, "same": torch.equal(got, again)}


def stack_checks(checks, err, name: str, flag: str, stacked, dev, gen, H, FK) -> None:
    """A stack kernel (`name`: sanm_stack_w8 or sanm_stack_w4) against its
    plain version at the layer gate on the valid rows, with a repeat call's
    bits: on the full-width tree at STACK_T, and at d256 with head dims 32
    and 64 (2 layers, f32 FSMN taps) at T = 65 with 60 valid; a CUDA-graph
    replay's bits against the eager call, and one call's profiler trace (one
    stack kernel, no other kernel of the port), at T = 171."""
    import torch

    from lele_tpu_torch import kernels as K

    fn, plain = K.KERNEL_WRAPPERS[name], getattr(K, f"{name}_plain")
    D = stacked["norm1"]["g"].shape[-1]
    cases = [(T, v, stacked, H, D, "") for T, v in STACK_T]
    for hd in (32, 64):
        small = stack_tree(flag, dev, n_layers=2, d_model=256, n_heads=256 // hd, ffn=512,
                           seed=hd, fsmn_dtype=torch.float32)
        cases.append((65, 60, small, 256 // hd, 256, f" d256 head dim {hd}, 2 layers,"))
    for T, n_valid, tree, heads, width, label in cases:
        x = torch.randn((T, width), generator=gen, device=dev) * 0.5
        mask = torch.zeros((T,), device=dev)
        mask[:n_valid] = 1.0
        res = stack_check(fn, plain, x, mask, n_valid, tree, heads, FK)
        err[name] = max(err[name], res["d"])
        checks.require(res["ok"] and res["same"],
                       f"{name}{label} T={T} valid={n_valid}: max|d| {res['d']:.3e}, rtol "
                       f"2e-2, atol 2e-2 * {res['scale']:.3e}; a repeat call the same bits "
                       f"{res['same']}")
    x = torch.randn((T_MAIN, D), generator=gen, device=dev) * 0.5
    mask = torch.ones((T_MAIN,), device=dev)
    checks.require(graph_same_bits(lambda: fn(x, mask, stacked, H, FK)),
                   f"{name} T={T_MAIN}: a CUDA-graph replay gives the eager call's bits")
    one_launch_check(checks, f"{name} T={T_MAIN}", lambda: fn(x, mask, stacked, H, FK),
                     "sanm_stack_kernel")


# CUgraphNodeType (cuda.h)
GRAPH_NODE_TYPES = {0: "KERNEL", 1: "MEMCPY", 2: "MEMSET", 3: "HOST", 4: "GRAPH", 5: "EMPTY",
                    6: "WAIT_EVENT", 7: "EVENT_RECORD", 10: "MEM_ALLOC", 11: "MEM_FREE"}


def graph_nodes(fn) -> list[tuple[str, str]]:
    """One call of fn captured in a CUDA graph: each node's type (KERNEL,
    MEMCPY, MEMSET, ...) and, for a kernel, its function's name, read from
    the captured graph through the driver (cuGraphGetNodes,
    cuGraphNodeGetType, cuGraphKernelNodeGetParams, cuFuncGetName). Every
    launch the call makes is a node, whatever a profiler would record."""
    import torch

    from lele_tpu_torch.runtime.graphs import collector_paused

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with collector_paused(), torch.cuda.graph(graph):
        fn()
    torch.cuda.synchronize()
    out = read_graph_nodes(graph)
    graph.reset()
    return out


def read_graph_nodes(graph) -> list[tuple[str, str]]:
    """A captured CUDA graph's nodes as `graph_nodes` gives them; the graph
    was made with keep_graph=True."""
    import ctypes

    cu = ctypes.CDLL("libcuda.so.1")
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(handle, None, ctypes.byref(n)):
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if n.value and cu.cuGraphGetNodes(handle, nodes, ctypes.byref(n)):
        raise RuntimeError("cuGraphGetNodes failed")
    out = []
    for node in nodes[:n.value]:
        kind, name = ctypes.c_int(-1), ""
        cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind))
        if kind.value == 0:
            # CUDA_KERNEL_NODE_PARAMS_v2: the CUfunction at byte 0, the CUkernel
            # (where the runtime loaded the kernel as one) at byte 56
            params = (ctypes.c_char * 256)()
            cname = ctypes.c_char_p()
            if cu.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node), params) == 0:
                func = ctypes.c_void_p.from_buffer(params, 0)
                kern = ctypes.c_void_p.from_buffer(params, 56)
                if func.value and cu.cuFuncGetName(ctypes.byref(cname), func) == 0:
                    name = cname.value.decode()
                elif kern.value and cu.cuKernelGetName(ctypes.byref(cname), kern) == 0:
                    name = cname.value.decode()
        out.append((GRAPH_NODE_TYPES.get(kind.value, f"type {kind.value}"), name))
    return out


def one_launch_check(checks, label: str, fn, kernel: str) -> None:
    """One call is one launch of `kernel` and no other kernel: the call
    captured in a CUDA graph holds one kernel node, and it is `kernel`
    (copies and memsets beside it are not launches). A graph that cannot be
    read fails the check."""
    try:
        nodes = graph_nodes(fn)
    except (RuntimeError, OSError, TypeError, AttributeError) as e:
        checks.require(False, f"{label}, one call captured in a CUDA graph: not read ({e})")
        return
    kinds = [k for k, _ in nodes]
    kernels = [name for k, name in nodes if k == "KERNEL"]
    ok = len(kernels) == 1 and kernel in kernels[0]
    checks.require(ok, f"{label}, one call captured in a CUDA graph: nodes "
                       f"{ {k: kinds.count(k) for k in sorted(set(kinds))} }, kernels "
                       f"{[k[:60] for k in kernels]}; one, and it is {kernel}")


def stack_times(name: str, stacked, dev, gen, H, FK, card) -> None:
    """A stack kernel at STACK_T by CUDA events, the profiler and a CUDA
    graph, with its per-phase split (the kernel's own timer) at T = 171 and
    1,004; DEVICE_US gets the T = 171 times."""
    import torch

    from lele_tpu_torch import kernels as K
    from lele_tpu_torch.kernels import sanm_block

    fn = K.KERNEL_WRAPPERS[name]
    fmt = name[-2:]
    D = stacked["norm1"]["g"].shape[-1]
    for T, n_valid in STACK_T:
        x = torch.randn((T, D), generator=gen, device=dev) * 0.5
        mask = torch.zeros((T,), device=dev)
        mask[:n_valid] = 1.0
        call = lambda: fn(x, mask, stacked, H, FK)  # noqa: E731
        ev = time_ms(call)
        d_k = device_us(call, n=5 if T > 500 else 20)
        g_k = graph_us(call, n=5 if T > 500 else 20, reps=5 if T > 500 else 10)
        d_k = None if d_k is None else sum(d_k.values())
        print(f"  {name} T={T} valid={n_valid}: events {ev:.4f} ms; device {fmt_us(d_k)} by "
              f"the profiler, {g_k:.2f} us in a CUDA graph  ({card})")
        if T == T_MAIN:
            DEVICE_US[name] = {"device_us": d_k, "graph_us": g_k}
        if T in (T_MAIN, 1004):
            ph = sanm_block.stack_phase_us(x, mask, stacked, H, FK, fmt)
            mean = ", ".join(f"{n} {v:.2f}" for n, v in zip(sanm_block.STACK_PHASES,
                                                            ph.mean(0).tolist()))
            print(f"    phases a layer (us, mean of {ph.shape[0]}): {mean}; timer span "
                  f"{ph.sum().item():.1f} us  ({card})")


def graph_same_bits(fn) -> bool:
    """fn() replayed from a CUDA graph gives the bits of an eager call."""
    import torch

    from lele_tpu_torch.runtime.graphs import collector_paused

    eager = fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with collector_paused(), torch.cuda.graph(graph):
        out = fn()
    graph.replay()
    torch.cuda.synchronize()
    return torch.equal(out, eager)


def lstm_bound(S: int, B: int, H: int) -> tuple[float, str]:
    """Kernel 6: xproj, Wh, h0 and c0 read once, hs, h_S and c_S written once;
    2·S·B·H·4H f32 operations of h @ Wh (the gates' few per unit left out)."""
    n_bytes = 4 * (S * B * 4 * H + H * 4 * H + 2 * B * H + S * B * H + 2 * B * H)
    return bound(n_bytes, {"f32": 2 * S * B * H * 4 * H})


def lstm_inputs(S, B, H, dev, gen):
    import torch

    x = torch.randn((S, B, 4 * H), generator=gen, device=dev)
    wh = (torch.rand((H, 4 * H), generator=gen, device=dev) * 2 - 1) / H ** 0.5
    h0 = torch.randn((B, H), generator=gen, device=dev) * 0.5
    return x, wh, h0, torch.randn((B, H), generator=gen, device=dev) * 0.5


def vad_pcm(seconds: float, sr: int, rng):
    """Speech-like tone bursts, 0.6 s on and 0.4 s off, plus noise."""
    import numpy as np

    t = np.arange(int(seconds * sr)) / sr
    on = (t % 1.0) < 0.6
    tone = sum(np.sin(2 * np.pi * rng.uniform(120, 300) * k * t) / k for k in (1, 2, 3))
    return (0.3 * on * tone + 0.01 * rng.standard_normal(t.size)).astype(np.float32)


def silero_phases(checks, dev, gen, card, err, ms, plain_ms, library_ms, bounds) -> dict:
    """Phases 7-10: kernel 6, SileroVad and SileroOnnx. Returns the launch
    counts of the two Silero main paths."""
    import numpy as np
    import torch

    from lele_tpu_torch import kernels as K
    from lele_tpu_torch.models import SileroConfig, SileroOnnx, SileroVad, VadSegmentConfig
    from lele_tpu_torch.models.silero import silero_scan, silero_step, zero_state
    from lele_tpu_torch.ops import nn_ops

    banner("== 7. kernel 6 (lstm_seq) vs plain on the card")
    for S, B, H in ((1875, 1, 128), (18750, 1, 128), (312, 1, 128), (3, 1, 128), (2, 1, 128),
                    (3, 2, 128), (37, 3, 48)):
        args = lstm_inputs(S, B, H, dev, gen)
        got, again, ref = K.lstm_seq(*args), K.lstm_seq(*args), K.lstm_seq_plain(*args)
        torch.cuda.synchronize()
        d = max((g - r).abs().max().item() for g, r in zip(got, ref))
        err["lstm_seq"] = max(err["lstm_seq"], d)
        checks.require(all(bool(torch.isfinite(g).all()) for g in got) and d <= LSTM_TOL,
                       f"lstm_seq S={S} B={B} H={H}: max|d| of hs, h_S, c_S {d:.3e} "
                       f"<= {LSTM_TOL:g}")
        if S <= 1875:
            def call(args=args):
                return torch.cat([t.reshape(-1) for t in K.lstm_seq(*args)])

            checks.require(all(torch.equal(g, a) for g, a in zip(got, again))
                           and graph_same_bits(call),
                           f"lstm_seq S={S} B={B} H={H}: a repeat call and a CUDA-graph "
                           f"replay give the same bits")
    args = lstm_inputs(312, 1, 128, dev, gen)
    one_launch_check(checks, "lstm_seq S=312 B=1 H=128", lambda: K.lstm_seq(*args),
                     "lstm_seq_reg")

    banner("== 8. main path: SileroVad at full width")
    rng = np.random.default_rng(SEED + 3)
    vad = SileroVad(SileroConfig(), device=dev)
    vad.init(SEED)
    requests = [(vad_pcm(s, VAD_SR, rng), VAD_SR) for s in VAD_SECONDS]
    requests.append((vad_pcm(10.0, 8000, rng), 8000))
    K.reset_launch_counts()
    probs = [vad.speech_probs(pcm, sr) for pcm, sr in requests]
    torch.cuda.synchronize()
    vad_launches = K.launch_counts()
    print(f"  launch counts over {len(requests)} requests: {vad_launches}")
    checks.require(vad_launches["lstm_seq"] == len(requests),
                   "lstm_seq once per offline request")
    worst = 0.0
    for (pcm, sr), p in zip(requests, probs):
        n = len(pcm) // 512
        ref = vad.speech_probs(pcm, sr, plain=True)
        d = float(np.abs(p - ref).max())
        worst = max(worst, d)
        checks.require(p.shape == (n,) and bool(np.isfinite(p).all())
                       and bool(((p >= 0) & (p <= 1)).all()),
                       f"{len(pcm) / sr:.0f} s at {sr} Hz: {n} probabilities in [0, 1]")
    checks.require(worst <= VAD_PROB_TOL,
                   f"SileroVad probabilities, kernel vs plain: max|d| {worst:.3e} "
                   f"<= {VAD_PROB_TOL:g}")
    seg_cfg = VadSegmentConfig(threshold=float(np.median(probs[2])),
                               neg_threshold=float(np.median(probs[2])) - 1e-4,
                               min_speech_ms=64.0, min_silence_ms=64.0)
    segs = vad.segments(requests[2][0], seg_cfg)
    checks.require(isinstance(segs, list) and all(0 <= a < b for a, b in segs),
                   f"60 s segments at the median threshold: {len(segs)} ordered segments")
    vad_chunks = [torch.from_numpy(vad.frame_chunks(requests[k][0])).to(dev) for k in (1, 2)]
    register("SileroVad offline scan, 10 s and 60 s (kernel 6)",
             lambda i: vad.scan_fn(VAD_SR)(vad.params, vad_chunks[i]),
             lambda i: silero_scan(vad.params, vad_chunks[i], vad.cfg, VAD_SR))
    step_chunks = [c[:1].clone() for c in vad_chunks]

    register("SileroVad streaming step, state donated (no kernel)",
             lambda i: vad.step_fn(VAD_SR)(vad.params, step_chunks[i],
                                           zero_state(vad.cfg, device=dev)),
             lambda i: silero_step(vad.params, step_chunks[i], zero_state(vad.cfg, device=dev),
                                   vad.cfg, VAD_SR))
    sessions = [[c[t:t + 1] for t in range(4)] for c in vad_chunks]
    register("SileroVad streaming step, two sessions interleaved through one program",
             lambda i: interleaved(lambda c, s: vad.step_fn(VAD_SR)(vad.params, c, s),
                                   sessions, [zero_state(vad.cfg, device=dev)] * 2, i),
             lambda i: interleaved(lambda c, s: silero_step(vad.params, c, s, vad.cfg, VAD_SR),
                                   sessions, [zero_state(vad.cfg, device=dev)] * 2, i))

    banner("== 9. compiled main path: SileroOnnx on fixtures/silero.onnx")
    sv = SileroOnnx(SILERO_FIXTURE, device=dev)
    sv_plain = SileroOnnx(SILERO_FIXTURE, device=dev, overrides={"LSTM": nn_ops.lstm_plain})
    pcm10 = vad_pcm(10.0, VAD_SR, rng)
    n10 = len(pcm10) // 512
    t0 = time.perf_counter()
    for rate in (16000, 8000):  # one trace per rate, before the counted run
        sv.compiled(rate)
    print(f"  two traces in {time.perf_counter() - t0:.2f} s: "
          + ", ".join(f"{r} Hz {sv.compiled(r).stats['n_steps']} steps" for r in (16000, 8000)))
    routes = dict(nn_ops.RNN_ROUTES)
    K.reset_launch_counts()
    onnx_probs = {rate: sv.speech_probs(pcm10, rate) for rate in (16000, 8000)}
    torch.cuda.synchronize()
    onnx_launches = K.launch_counts()
    print(f"  launch counts over 2 requests of {n10} chunks: {onnx_launches}")
    checks.require(onnx_launches["lstm_seq"] == 2 * n10, "lstm_seq once per chunk at both rates")
    checks.require(nn_ops.RNN_ROUTES["loop"] == routes["loop"], "no LSTM took the masked loop")
    for rate in (16000, 8000):
        p = onnx_probs[rate]
        ref = sv_plain.speech_probs(pcm10, rate)
        d = float(np.abs(p - ref).max())
        err["lstm_seq"] = max(err["lstm_seq"], d)
        checks.require(p.shape == (n10,) and bool(np.isfinite(p).all()) and d <= VAD_PROB_TOL,
                       f"SileroOnnx {rate} Hz: {n10} probabilities, vs the lstm_plain "
                       f"override max|d| {d:.3e} <= {VAD_PROB_TOL:g}")
    onnx_pcms = [pcm10, vad_pcm(10.0, VAD_SR, np.random.default_rng(SEED + 9))]
    register(f"SileroOnnx 10 s at 16 kHz (kernel 6 once a chunk, blocks of {sv.BLOCK})",
             lambda i: sv.speech_probs(onnx_pcms[i], 16000),
             lambda i: silero_onnx_stepwise(sv, onnx_pcms[i], 16000))
    gap = float(np.abs(onnx_probs[16000] - onnx_probs[8000]).max())
    checks.require(gap > 1e-4, f"the If took each rate's front-end: the rates' probabilities "
                               f"differ by up to {gap:.3e}")

    banner(f"== 10. Silero timings (CUDA events, median of warm runs; {card})")
    for S in (1875, 18750):
        args = lstm_inputs(S, 1, 128, dev, gen)
        a = time_ms(lambda: K.lstm_seq(*args), runs=10)
        # the plain version's host loop takes ~3 s at S = 18,750: timed once there,
        # as phases 15 and 18 time the plain GRU
        if S > 2000:
            plain_out, b = once_ms(lambda: K.lstm_seq_plain(*args))
        else:
            b = time_ms(lambda: K.lstm_seq_plain(*args), runs=3, warm=1)
            plain_out = K.lstm_seq_plain(*args)
        lstm = cudnn_lstm(args[1], dev)
        hc = (args[2][None], args[3][None])
        with torch.no_grad(), torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            y, _ = lstm(args[0], hc)
            ref = plain_out[0]
            lib_d = (y - ref).abs().max().item()
            c = time_ms(lambda: lstm(args[0], hc), runs=10)
        b_ms, b_by = lstm_bound(S, 1, 128)
        print(f"  lstm_seq S={S} B=1 H=128: kernel {a:.4f} ms ({a * 1e3 / S:.4f} us a step), "
              f"plain {b:.3f} ms, cuDNN nn.LSTM on xproj with W_ih = I {c:.4f} ms "
              f"(+ one [S,512]x[512,512] input product; max|d| vs plain {lib_d:.2e}); "
              f"bound {b_ms * 1e3:.3f} us by {b_by}, kernel at {100 * b_ms / a:.4f}% of it  "
              f"({card})")
        ms["lstm_seq"], plain_ms["lstm_seq"], library_ms["lstm_seq"] = a, b, c
        bounds["lstm_seq"] = (b_ms, b_by)
    # in a CUDA graph: the device's time with the gaps between calls
    lstm_graph = {}
    for S in (3, 312, 1875, 18750):
        args = lstm_inputs(S, 1, 128, dev, gen)
        lstm = cudnn_lstm(args[1], dev)
        hc = (args[2][None], args[3][None])
        n, reps = (2, 3) if S > 2000 else (20, 10)
        g_k = graph_us(lambda: K.lstm_seq(*args), n=n, reps=reps)
        with torch.no_grad(), torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            g_l = graph_us(lambda: lstm(args[0], hc), n=n, reps=reps)
        lstm_graph[S] = (g_k, g_l)
        print(f"  lstm_seq S={S} B=1 H=128 in a CUDA graph: kernel {g_k:.2f} us "
              f"({g_k / S:.4f} us a step), cuDNN nn.LSTM {g_l:.2f} us  ({card})")
    DEVICE_US["lstm_seq"] = {"graph_us": lstm_graph[18750][0],
                             "library_graph_us": lstm_graph[18750][1],
                             "graph_us_by_steps": {S: v[0] for S, v in lstm_graph.items()}}

    step = vad.step_fn()
    chunk = torch.from_numpy(vad.frame_chunks(requests[0][0])[:1]).to(dev)
    state = torch.zeros((2, 1, 128), device=dev)
    step_ms = time_ms(lambda: step(vad.params, chunk, state))
    print(f"  SileroVad streaming step, one 32 ms chunk: {step_ms:.4f} ms  ({card})")
    for s in (60.0, VAD_LONG_SECONDS):
        pcm = vad_pcm(s, VAD_SR, rng)
        t = host_ms(lambda: vad.speech_probs(pcm), runs=3)
        print(f"  SileroVad.speech_probs {s:.0f} s: {t:.3f} ms, RTF {t / (s * 1e3):.3e} "
              f"(host clock, readback included)  ({card})")
    for rate in (16000, 8000):
        t = host_ms(lambda: sv.speech_probs(pcm10, rate), runs=3)
        print(f"  SileroOnnx.speech_probs 10 s at {rate} Hz: {t:.3f} ms, RTF {t / 1e4:.3e}, "
              f"{t * 1e3 / n10:.1f} us a chunk  ({card})")

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sv.speech_probs(pcm10, 16000)
        span_us = (time.perf_counter() - t0) * 1e6
    rows = device_rows(prof)
    dev_us = sum(us for us, _ in rows.values())
    kernels = sum(c for k, (_, c) in rows.items() if not k.startswith(("Memcpy", "Memset")))
    print(f"  profile, SileroOnnx 10 s at 16 kHz: {kernels} device launches "
          f"({kernels / n10:.1f} a chunk), device {dev_us:.1f} us over {span_us:.1f} us, "
          f"busy share {dev_us / span_us:.3f}  ({card})")
    for k, (us, c) in sorted(rows.items(), key=lambda r: -r[1][0])[:6]:
        print(f"    {us:10.1f} us  x{c:<6d} {k[:90]}")
    lstm_us = sum(us for k, (us, _) in rows.items() if "lstm_seq" in k)
    print(f"  of which lstm_seq {lstm_us:.1f} us ({lstm_us / n10:.2f} us a chunk)  ({card})")
    return {"native": vad_launches, "compiled": onnx_launches}


def w4_decode_check(checks, err, x, packed, scales, group, idx, what) -> None:
    """Kernel 7 at few rows or through its expert-indexed entry (the decode
    form, csrc/w4_gemv.cuh: M <= 8 in the group form, M <= 4 in the
    others; the tile form above): within W4_TOL of the plain
    version, and the same bits on a repeat call (a fixed reduction order)."""
    import torch

    from lele_tpu_torch import kernels as K

    got = K.w4_matmul(x, packed, scales, group, idx)
    again = K.w4_matmul(x, packed, scales, group, idx)
    ref = K.w4_matmul_plain(x, packed, scales, group, idx)
    torch.cuda.synchronize()
    d, scale, _ = compare(got, ref)
    tol = W4_TOL[str(x.dtype)[6:]]
    err["w4_gemm"] = max(err["w4_gemm"], d)
    checks.require(got.shape == ref.shape and d <= tol * scale and torch.equal(got, again),
                   f"w4_gemm {what} {str(x.dtype)[6:]}: max|d| {d:.3e} <= {tol:g} * "
                   f"{scale:.3e}, a repeat call bit-identical")


def w4_phases(checks, dev, gen, card, err, ms, plain_ms, library_ms, bounds, w8_fwd,
              w8_params) -> dict:
    """Phases 11-14: kernels 7 and 8, SenseVoice w4a16 behind the engine, a
    MatMulNBits graph, and their timings. Returns the launch counts of the
    w4 main path."""
    import importlib

    import numpy as np
    import torch

    from lele_tpu_torch import kernels as K
    from lele_tpu_torch.compiler import compile_model
    from lele_tpu_torch.models import (
        SenseVoiceConfig,
        SenseVoiceModel,
        cast_big_params,
        prepare_w4_params,
        stack_layer_params,
    )
    from lele_tpu_torch.onnx import builder as ob
    from lele_tpu_torch.runtime.bucketing import pad_pcm
    from lele_tpu_torch.serving import SenseVoiceEngine

    W4 = importlib.import_module("lele_tpu_torch.kernels.w4_matmul")

    def gemm_check(T, k_, n_, packed, scales, group, what):
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn((T, k_), generator=gen, device=dev).to(dtype)
            got = K.w4_matmul(x, packed, scales, group)
            ref = K.w4_matmul_plain(x, packed, scales, group)
            torch.cuda.synchronize()
            d, scale, _ = compare(got, ref)
            tol = W4_TOL[str(dtype)[6:]]
            err["w4_gemm"] = max(err["w4_gemm"], d)
            checks.require(got.shape == ref.shape and d <= tol * scale,
                           f"w4_gemm [{T},{k_}]x[{k_},{n_}] g{group} {str(dtype)[6:]}{what}: "
                           f"max|d| {d:.3e} <= {tol:g} * {scale:.3e}")

    banner("== 11. kernels 7 (w4_gemm) and 8 (sanm_stack_w4) vs plain on the card")
    for T in (T_MAIN, T_RAGGED):
        for (k_, n_) in GEMM_SHAPES:
            w = torch.randn((k_, n_), generator=gen, device=dev) / k_ ** 0.5
            packed, scales = W4.quantize_weight_int4(w, 128)
            gemm_check(T, k_, n_, packed, scales, 128, "")
    for group in (32, 128):  # MatMulNBits' recentred planes: the full [-8, 7]
        packed = torch.randint(-128, 128, (256, 1536), generator=gen, device=dev,
                               dtype=torch.int8)
        scales = torch.rand((512 // group, 1536), generator=gen, device=dev) * 0.01 + 1e-3
        gemm_check(NBITS_ROWS, 512, 1536, packed, scales, group, ", recentred int4")
    # the decode form at M = 1, 2, 4 (both forms), 5 and 8 (the group form;
    # f32 on the tile form), and M = 9 on the tile form beside it: the CTC
    # head's odd N and the [2048 -> 512] linear
    for M in (1, 2, 4, 5, 8, 9):
        for (k_, n_) in (GEMM_SHAPES[-1], GEMM_SHAPES[3]):
            w = torch.randn((k_, n_), generator=gen, device=dev) / k_ ** 0.5
            packed, scales = W4.quantize_weight_int4(w, 128)
            for dtype in (torch.bfloat16, torch.float32):
                x = torch.randn((M, k_), generator=gen, device=dev).to(dtype)
                w4_decode_check(checks, err, x, packed, scales, 128, None,
                                f"[{M},{k_}]x[{k_},{n_}] g128")

    cfg = SenseVoiceConfig(weight_int4=True)
    model = SenseVoiceModel(cfg, device=dev)
    model.init(SEED)
    model.params = stack_layer_params(
        prepare_w4_params(cast_big_params(model.params, torch.bfloat16)))
    stacked = model.params["layers_stacked"]
    L, D, H, FK = cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.fsmn_kernel
    stack_bytes = sum(t.numel() * t.element_size() for t in (
        v for grp in stacked.values() for v in grp.values()))
    print(f"  model: {L} layers, d{D}, vocab {cfg.vocab_size}, {stack_bytes / 1e6:.1f} MB of "
          f"w4 layer operands resident")
    for tree, label in ((layer_slice(stacked, 0), "layer 0"), (stacked, f"{L} layers")):
        for T, n_valid in ((T_MAIN, T_MAIN), (T_RAGGED, VALID_RAGGED)):
            x = torch.randn((T, D), generator=gen, device=dev) * 0.5
            mask = torch.zeros((T,), device=dev)
            mask[:n_valid] = 1.0
            got = K.sanm_stack_w4(x, mask, tree, H, FK)[:n_valid]
            ref = K.sanm_stack_w4_plain(x, mask, tree, H, FK)[:n_valid]
            torch.cuda.synchronize()
            d, scale, _ = compare(got, ref)
            err["sanm_stack_w4"] = max(err["sanm_stack_w4"], d)
            checks.require(bool(torch.isfinite(got).all()) and torch.allclose(
                got, ref, rtol=2e-2, atol=2e-2 * scale),
                f"sanm_stack_w4 {label} T={T} valid={n_valid}: max|d| {d:.3e}, rtol 2e-2, "
                f"atol 2e-2 * {scale:.3e}")
    stack_checks(checks, err, "sanm_stack_w4", "weight_int4", stacked, dev, gen, H, FK)

    banner("== 12. main path: SenseVoiceEngine.recognize on the w4a16 model at full width")
    rng = np.random.default_rng(SEED + 4)
    engine = SenseVoiceEngine(model=model)
    requests = [wav_bytes(synth_speechlike(s, rng)) for s in REQUEST_SECONDS]
    K.reset_launch_counts()
    answers = [engine.recognize(r) for r in requests]
    torch.cuda.synchronize()
    launches = K.launch_counts()
    n_req = len(requests)
    for s, ids in zip(REQUEST_SECONDS, answers):
        checks.require(all(0 <= i < cfg.vocab_size for i in ids),
                       f"w4 request {s} s: {len(ids)} tokens, ids in [0, vocab)")
    print(f"  launch counts over {n_req} requests: {launches}")
    checks.require(launches["sanm_stack_w4"] == n_req, "sanm_stack_w4 once per request")
    checks.require(launches["w4_gemm"] == n_req, "w4_gemm (CTC head) once per request")
    checks.require(all(launches[k] == 0 for k in ("w8_gemm", "sanm_layer_w8", "sanm_stack_w8",
                                                  "dq_gemm", "sanm_stack_dql")),
                   "no w8 or int8 kernel on the w4 path")
    register_ids("SenseVoice w4a16 bucketed B = 1 (kernels 8, 7), 10 s and 8.5 s of one bucket",
                 model, [(p[None], [n]) for p, n in (
                     pad_pcm(synth_speechlike(s, np.random.default_rng(SEED + 41)))
                     for s in (10.0, 8.5))])
    pcm10 = synth_speechlike(10.0, np.random.default_rng(SEED + 1))
    fwd, fwd_plain = model.forward_fn(), model.forward_fn(plain=True)
    got, ref = fwd(model.params, pcm10), fwd_plain(model.params, pcm10)
    torch.cuda.synchronize()
    rel = ((got - ref).abs().max() / ref.abs().max()).item()
    agree = (got.argmax(-1) == ref.argmax(-1)).float().mean().item()
    checks.require(tuple(got.shape) == (1, T_MAIN, cfg.vocab_size)
                   and bool(torch.isfinite(got).all()),
                   f"w4 10 s logits {tuple(got.shape)} finite")
    checks.require(rel <= 5e-2, f"w4 10 s logits kernel vs plain: max|d|/max|ref| {rel:.3e} "
                                f"<= 5e-2")
    checks.require(agree >= 0.98, f"w4 10 s frame-argmax agreement {agree:.4f} >= 0.98")

    banner("== 13. compiled MatMulNBits graph at the main path's linear widths")
    grng = np.random.default_rng(GRAPH_SEED + 1)
    inits, nodes = [], []
    # (input, output, K, N, block, packed zero points and bias)
    spec = (("a", "y1", 512, 1536, 32, False), ("a", "h", 512, 2048, 128, False),
            ("h", "y3", 2048, 512, 128, False), ("a", "y4", 512, 25055, 128, True))
    for j, (src, dst, k_, n_, blk, zp_bias) in enumerate(spec):
        kb = k_ // blk
        ins = [src, f"b{j}", f"s{j}"]
        inits += [ob.tensor_from_array(grng.integers(0, 256, (n_, kb, blk // 2),
                                                     dtype=np.uint8), f"b{j}"),
                  ob.tensor_from_array((grng.random((n_, kb)) * 0.4 / k_ ** 0.5 + 1e-3)
                                       .astype(np.float32), f"s{j}")]
        if zp_bias:
            ins += [f"z{j}", "", f"c{j}"]
            inits += [ob.tensor_from_array(grng.integers(0, 256, (n_, (kb + 1) // 2),
                                                         dtype=np.uint8), f"z{j}"),
                      ob.tensor_from_array(grng.standard_normal(n_).astype(np.float32) * 0.1,
                                           f"c{j}")]
        nodes.append(ob.node("MatMulNBits", ins, [dst], domain="com.microsoft", K=k_, N=n_,
                             bits=4, block_size=blk))
    graph = ob.build_model_bytes(
        nodes, inputs=[ob.value_info("a", 1, [NBITS_ROWS, 512])],
        outputs=[ob.value_info(n, 1, [NBITS_ROWS, w]) for n, w in
                 (("y1", 1536), ("y3", 512), ("y4", 25055))], initializers=inits)
    t0 = time.perf_counter()
    cm = compile_model(graph, device=dev, strict=True)
    cm_ref = compile_model(graph, device=dev, strict=True, patterns=[])
    print(f"  graph: {len(graph) / 1e6:.1f} MB of ONNX bytes, {len(nodes)} MatMulNBits, "
          f"both paths compiled in {time.perf_counter() - t0:.2f} s")
    a = torch.from_numpy(grng.standard_normal((NBITS_ROWS, 512)).astype(np.float32)).to(dev)
    register_cm(f"MatMulNBits graph, {NBITS_ROWS} rows (kernel 7 once a node)", cm,
                [{"a": a}, {"a": torch.randn(a.shape, generator=gen, device=dev)}])
    hits = cm.stats["pattern_hits"]
    checks.require(hits.get("matmul_nbits_w4") == 2 * len(nodes) and not
                   cm_ref.stats["pattern_hits"],
                   f"pattern hits {hits}: two a node (the pattern and the tracer's walk "
                   f"each count it, as the JAX package does); none on the per-op path")
    K.reset_launch_counts()
    outs = cm(a=a)
    torch.cuda.synchronize()
    nb_launches = K.launch_counts()
    refs = cm_ref(a=a)
    torch.cuda.synchronize()
    checks.require(nb_launches["w4_gemm"] == len(nodes)
                   and sum(nb_launches.values()) == len(nodes),
                   f"w4_gemm once a node a request: {nb_launches}")
    for name, o, r in zip(("y1", "y3", "y4"), outs, refs):
        rn = ((o - r).norm() / r.norm()).item()
        checks.require(bool(torch.isfinite(o).all()) and rn <= NBITS_RELNORM,
                       f"MatMulNBits {name} {tuple(o.shape)}, fused vs per-op: relative "
                       f"Frobenius {rn:.3e} <= {NBITS_RELNORM:g}")

    banner(f"== 14. w4 timings (CUDA events, median of {TIMED_RUNS}; {card})")
    k_, n_ = GEMM_SHAPES[-1]
    x = torch.randn((T_MAIN, k_), generator=gen, device=dev).to(torch.bfloat16)
    w = torch.randn((k_, n_), generator=gen, device=dev) / k_ ** 0.5
    packed, scales = W4.quantize_weight_int4(w, 128)
    ms["w4_gemm"] = time_ms(lambda: K.w4_matmul(x, packed, scales, 128))
    plain_ms["w4_gemm"] = time_ms(lambda: K.w4_matmul_plain(x, packed, scales, 128))
    # the CTC head's one library call: bf16 x by the weight dequantised to bf16
    w_bf16 = W4.dequantize_int4(packed, scales, 128).to(torch.bfloat16)
    library_ms["w4_gemm"] = time_ms(lambda: torch.matmul(x, w_bf16))
    bounds["w4_gemm"] = bound(T_MAIN * k_ * 2 + packed.numel() + scales.numel() * 4
                              + T_MAIN * n_ * 4, {"bf16": 2 * T_MAIN * k_ * n_})
    print(f"  w4_gemm [{T_MAIN},{k_}]x[{k_},{n_}] g128 bf16: kernel {ms['w4_gemm']:.4f} ms, "
          f"plain {plain_ms['w4_gemm']:.4f} ms, torch.matmul bf16 x bf16 dequantised weight "
          f"{library_ms['w4_gemm']:.4f} ms  ({card})")
    d_k, g_k = device_times(lambda: K.w4_matmul(x, packed, scales, 128))
    d_l, g_l = device_times(lambda: torch.matmul(x, w_bf16))
    DEVICE_US["w4_gemm"] = {"device_us": d_k, "graph_us": g_k, "library_device_us": d_l,
                            "library_graph_us": g_l}
    print(f"  w4_gemm [{T_MAIN},{k_}]x[{k_},{n_}] (tile form), device time a call: kernel "
          f"{fmt_us(d_k)} by the profiler, {g_k:.2f} us in a CUDA graph; torch.matmul "
          f"{fmt_us(d_l)}, {g_l:.2f} us  ({card})")
    x = torch.randn((T_MAIN, D), generator=gen, device=dev) * 0.5
    mask = torch.ones((T_MAIN,), device=dev)
    ms["sanm_stack_w4"] = time_ms(lambda: K.sanm_stack_w4(x, mask, stacked, H, FK))
    plain_ms["sanm_stack_w4"] = time_ms(lambda: K.sanm_stack_w4_plain(x, mask, stacked, H, FK),
                                        runs=5)
    library_ms["sanm_stack_w4"] = None
    F = cfg.ffn_dim
    bounds["sanm_stack_w4"] = bound(stack_bytes + 2 * T_MAIN * D * 4, {
        "bf16": L * (2 * T_MAIN * D * (4 * D + 2 * F) + 4 * T_MAIN * T_MAIN * D)})
    print(f"  sanm_stack_w4 T={T_MAIN}, {L} layers: kernel {ms['sanm_stack_w4']:.4f} ms, "
          f"plain {plain_ms['sanm_stack_w4']:.4f} ms  ({card})")
    stack_times("sanm_stack_w4", stacked, dev, gen, H, FK, card)
    for name in ("w4_gemm", "sanm_stack_w4"):
        b_ms, by = bounds[name]
        print(f"  bound {name}: {b_ms * 1e3:.2f} us by {by}; kernel at "
              f"{100 * b_ms / ms[name]:.2f}% of it  ({card})")
    fused_ms = time_ms(lambda: cm(a=a))
    per_op_ms = time_ms(lambda: cm_ref(a=a), runs=5)
    print(f"  MatMulNBits graph, {NBITS_ROWS} rows: fused {fused_ms:.4f} ms, per-op "
          f"{per_op_ms:.4f} ms  ({card})")
    w8_ms = time_ms(lambda: w8_fwd(w8_params, pcm10))
    w4_ms = time_ms(lambda: fwd(model.params, pcm10))
    w4p_ms = time_ms(lambda: fwd_plain(model.params, pcm10), runs=5)
    pcm10_dev = torch.from_numpy(pcm10).to(dev)
    w8_g = graph_us(lambda: w8_fwd(w8_params, pcm10_dev))
    w4_g = graph_us(lambda: fwd(model.params, pcm10_dev))
    print(f"  forward_fn 10 s: w4a16 kernel path {w4_ms:.4f} ms (RTF {w4_ms / 1e4:.3e}), "
          f"{w4_g:.2f} us in a CUDA graph; w4a16 plain path {w4p_ms:.4f} ms; w8a16 kernel "
          f"path {w8_ms:.4f} ms (RTF {w8_ms / 1e4:.3e}), {w8_g:.2f} us in a CUDA graph  "
          f"({card})")
    return launches


def gru_bound(S: int, B: int, H: int, lbr: bool) -> tuple[float, str]:
    """Kernel 9: xproj, Rh, rb and h0 read once, hs and h_S written once;
    2·S·B·H·3H f32 operations of h @ Rh (2·S·B·H·4H without
    linear_before_reset: the second product on r * h), the gates left out."""
    n_bytes = 4 * (S * B * 3 * H + H * 3 * H + 3 * H + B * H + S * B * H + B * H)
    return bound(n_bytes, {"f32": 2 * S * B * H * (3 if lbr else 4) * H})


def gru_inputs(S, B, H, dev, gen):
    import torch

    x = torch.randn((S, B, 3 * H), generator=gen, device=dev)
    rh = (torch.rand((H, 3 * H), generator=gen, device=dev) * 2 - 1) / H ** 0.5
    rb = torch.randn((3 * H,), generator=gen, device=dev) * 0.1
    return x, rh, rb, torch.randn((B, H), generator=gen, device=dev) * 0.5


def once_ms(fn):
    """(fn(), its time in ms by CUDA events): for a plain version too slow to
    run more than once."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def cudnn_gru(rh, rb, dev):
    """torch.nn.GRU (cuDNN, linear_before_reset) computing kernel 9's
    recurrence on xproj: gates z, r, h become PyTorch's r, z, n, W_ih the
    permutation that takes xproj's columns in that order, b_ih zero."""
    import torch

    H = rh.shape[0]
    perm = torch.cat([torch.arange(H, 2 * H), torch.arange(0, H), torch.arange(2 * H, 3 * H)])
    gru = torch.nn.GRU(3 * H, H).to(dev)
    with torch.no_grad():
        gru.weight_ih_l0.copy_(torch.eye(3 * H, device=dev)[perm])
        gru.weight_hh_l0.copy_(rh.t()[perm.to(dev)])
        gru.bias_ih_l0.zero_()
        gru.bias_hh_l0.copy_(rb[perm.to(dev)])
    return gru


def cudnn_lstm(wh, dev):
    """torch.nn.LSTM (cuDNN) computing kernel 6's recurrence on xproj (gate
    order i, f, g, o, PyTorch's own) with W_ih = I."""
    import torch

    H = wh.shape[0]
    lstm = torch.nn.LSTM(4 * H, H).to(dev)
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(torch.eye(4 * H, device=dev))
        lstm.weight_hh_l0.copy_(wh.t())
        lstm.bias_ih_l0.zero_()
        lstm.bias_hh_l0.zero_()
    return lstm


def rnn_graph(op: str, S: int, B: int, I: int, H: int, grng, lens=None, **attrs) -> bytes:
    """An ONNX GRU or LSTM node with random weights and bias (both
    directions if attrs say so): x [S, B, I] → y, y_h."""
    import numpy as np

    from lele_tpu_torch.onnx import builder as ob

    ng = 3 if op == "GRU" else 4
    D = 2 if attrs.get("direction") == "bidirectional" else 1
    inits = {"w": (grng.standard_normal((D, ng * H, I)) / I ** 0.5).astype(np.float32),
             "r": (grng.standard_normal((D, ng * H, H)) / H ** 0.5).astype(np.float32),
             "b": (grng.standard_normal((D, 2 * ng * H)) * 0.1).astype(np.float32)}
    names = ["x", "w", "r", "b"]
    if lens is not None:
        inits["sl"] = np.asarray(lens, np.int32)
        names.append("sl")
    outs = ["y", "yh"] + (["yc"] if op == "LSTM" else [])
    return ob.build_model_bytes(
        [ob.node(op, names, outs, hidden_size=H, **attrs)],
        inputs=[ob.value_info("x", 1, [S, B, I])],
        outputs=[ob.value_info(n, 1, []) for n in outs],
        initializers=[ob.tensor_from_array(v, n) for n, v in inits.items()])


def slice5_phases(checks, dev, gen, card, err, ms, plain_ms, library_ms, bounds) -> dict:
    """Phases 15-18: kernel 9 and the new forms of kernels 6 and 7, a GRU
    graph, an LSTM graph at H = 256, the QMoE decode layer, and their
    timings. Returns the launch counts of the GRU and QMoE main paths."""
    import importlib

    import numpy as np
    import torch

    from lele_tpu_torch import kernels as K
    from lele_tpu_torch.compiler import compile_model
    from lele_tpu_torch.compiler.patterns import F32_NBITS_PATTERNS, _qmoe_group
    from lele_tpu_torch.onnx.synth import MOE_DECODE, build_moe_layer_model
    from lele_tpu_torch.ops import nn_ops

    W4 = importlib.import_module("lele_tpu_torch.kernels.w4_matmul")

    banner("== 15. kernel 9 (gru_seq) vs plain; kernels 6 and 7 in their new forms")
    plain_18750 = None
    for S, B, H in GRU_SHAPES:
        for lbr in (True, False):
            if S > 2000 and not lbr:
                continue  # the plain version runs once at S = 18,750 (seconds)
            args = gru_inputs(S, B, H, dev, gen)
            got = K.gru_seq(*args, lbr)
            ref, t = once_ms(lambda: K.gru_seq_plain(*args, lbr))
            if S > 2000:
                plain_18750 = t
            torch.cuda.synchronize()
            d = max((g - r).abs().max().item() for g, r in zip(got, ref))
            err["gru_seq"] = max(err["gru_seq"], d)
            checks.require(all(bool(torch.isfinite(g).all()) for g in got) and d <= GRU_TOL,
                           f"gru_seq S={S} B={B} H={H} linear_before_reset={int(lbr)}: max|d| "
                           f"of hs, h_S {d:.3e} <= {GRU_TOL:g}")
    for S, B, H in ((1023, 1, 256), (255, 1, 1024), (37, 3, 200)):
        args = lstm_inputs(S, B, H, dev, gen)
        got, ref = K.lstm_seq(*args), K.lstm_seq_plain(*args)
        torch.cuda.synchronize()
        d = max((g - r).abs().max().item() for g, r in zip(got, ref))
        err["lstm_seq"] = max(err["lstm_seq"], d)
        checks.require(all(bool(torch.isfinite(g).all()) for g in got) and d <= LSTM_TOL,
                       f"lstm_seq general form S={S} B={B} H={H}: max|d| of hs, h_S, c_S "
                       f"{d:.3e} <= {LSTM_TOL:g}")

    def w4_check(x, packed, scales, group, idx, what):
        got = K.w4_matmul(x, packed, scales, group, idx)
        ref = K.w4_matmul_plain(x, packed, scales, group, idx)
        torch.cuda.synchronize()
        d, scale, _ = compare(got, ref)
        tol = W4_TOL[str(x.dtype)[6:]]
        err["w4_gemm"] = max(err["w4_gemm"], d)
        checks.require(got.shape == ref.shape and d <= tol * scale,
                       f"w4_gemm {what} {str(x.dtype)[6:]}: max|d| {d:.3e} <= {tol:g} * "
                       f"{scale:.3e}")

    for k_, group in ((512, 8), (768, 24), (1040, 8)):
        packed = torch.randint(-128, 128, (k_ // 2, 1536), generator=gen, device=dev,
                               dtype=torch.int8)
        scales = torch.rand((k_ // group, 1536), generator=gen, device=dev) * 0.01 + 1e-3
        form = "group-accumulator" if W4.group_acc_form(k_, group) else "dequantised-tile"
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn((NBITS_ROWS, k_), generator=gen, device=dev).to(dtype)
            w4_check(x, packed, scales, group, None,
                     f"[{NBITS_ROWS},{k_}]x[{k_},{1536}] g{group} ({form} form)")
    E, hidden, inter = MOE_DECODE["experts"], MOE_DECODE["hidden"], MOE_DECODE["inter"]
    for R in (2, 8):
        for k_, n_ in ((hidden, inter), (inter, hidden)):
            group = _qmoe_group(k_)
            packed = torch.randint(-128, 128, (E, k_ // 2, n_), generator=gen, device=dev,
                                   dtype=torch.int8)
            scales = torch.rand((E, k_ // group, n_), generator=gen, device=dev) * 0.01 + 1e-3
            idx = torch.randint(0, E, (R,), generator=gen, device=dev, dtype=torch.int32)
            for dtype in (torch.bfloat16, torch.float32):
                x = torch.randn((R, k_), generator=gen, device=dev).to(dtype)
                w4_check(x, packed, scales, group, idx,
                         f"expert-indexed R={R} [{k_},{n_}] x {E} stacks g{group}")
                w4_decode_check(checks, err, x, packed, scales, group, idx,
                                f"decode form, expert-indexed R={R} [{k_},{n_}] x {E} "
                                f"stacks g{group}")
    # the decode form at M = 1 and 3 in the k-step-8 group form (groups 8,
    # 24) and the dequantised-tile form (K = 1,040), and at Phi-3.5-MoE's
    # expert widths, where a thread-block cluster splits K
    for M in (1, 3):
        for k_, group in ((512, 8), (768, 24), (1040, 8)):
            packed = torch.randint(-128, 128, (k_ // 2, 1536), generator=gen, device=dev,
                                   dtype=torch.int8)
            scales = torch.rand((k_ // group, 1536), generator=gen, device=dev) * 0.01 + 1e-3
            form = "group-accumulator" if W4.group_acc_form(k_, group) else "dequantised-tile"
            for dtype in (torch.bfloat16, torch.float32):
                x = torch.randn((M, k_), generator=gen, device=dev).to(dtype)
                w4_decode_check(checks, err, x, packed, scales, group, None,
                                f"decode form [{M},{k_}]x[{k_},1536] g{group} ({form})")
    for k_, n_ in (PHI_MOE, PHI_MOE[::-1]):
        w = torch.randn((k_, n_), generator=gen, device=dev) / k_ ** 0.5
        packed, scales = W4.quantize_weight_int4(w, 128)
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn((1, k_), generator=gen, device=dev).to(dtype)
            w4_decode_check(checks, err, x, packed, scales, 128, None,
                            f"decode form [1,{k_}]x[{k_},{n_}] g128 (cluster split of K)")

    banner("== 16. compiled GRU graph (input 128, H 128, bidirectional, 1,875 steps)")
    grng = np.random.default_rng(GRAPH_SEED + 5)
    S, H = 1875, 128
    graphs = {lbr: rnn_graph("GRU", S, 1, 128, H, grng, direction="bidirectional",
                             linear_before_reset=lbr) for lbr in (1, 0)}
    ragged = rnn_graph("GRU", S, 4, 128, H, grng, lens=[S, 1200, 600, 1],
                       direction="bidirectional", linear_before_reset=1)
    t0 = time.perf_counter()
    cms = {k: compile_model(g, device=dev, strict=True)
           for k, g in [*graphs.items(), ("ragged", ragged)]}
    plain = {k: compile_model(g, device=dev, strict=True, overrides={"GRU": nn_ops.gru_plain})
             for k, g in [*graphs.items(), ("ragged", ragged)]}
    print(f"  six compiles in {time.perf_counter() - t0:.2f} s")
    xs = {k: torch.from_numpy(grng.standard_normal((S, 4 if k == "ragged" else 1, 128))
                              .astype(np.float32)).to(dev) for k in cms}
    register_cm(f"ONNX GRU graph, bidirectional, {S} steps (kernel 9 a direction)", cms[1],
                [{"x": xs[1]}, {"x": torch.randn(xs[1].shape, generator=gen, device=dev)}],
                rel=1e-5)
    routes = dict(nn_ops.RNN_ROUTES)
    K.reset_launch_counts()
    outs = {k: cms[k](x=xs[k]) for k in (1, 0)}
    torch.cuda.synchronize()
    gru_launches = K.launch_counts()
    moved = {k: nn_ops.RNN_ROUTES[k] - routes[k] for k in routes}
    print(f"  launch counts over 2 requests: {gru_launches}; routes moved {moved}")
    checks.require(gru_launches["gru_seq"] == 4 and sum(gru_launches.values()) == 4,
                   "gru_seq once a direction a request, no other kernel")
    checks.require(moved == {"lstm_seq": 0, "gru_seq": 4, "loop": 0},
                   "RNN_ROUTES: 4 directions on gru_seq, none on the loop")
    for k in (1, 0):
        ref = plain[k](x=xs[k])
        d = max((o - r).abs().max().item() for o, r in zip(outs[k], ref))
        err["gru_seq"] = max(err["gru_seq"], d)
        checks.require(tuple(outs[k][0].shape) == (S, 2, 1, H) and d <= GRU_TOL
                       and all(bool(torch.isfinite(o).all()) for o in outs[k]),
                       f"GRU graph linear_before_reset={k}: y {tuple(outs[k][0].shape)}, vs "
                       f"the gru_plain override max|d| {d:.3e} <= {GRU_TOL:g}")
    routes = dict(nn_ops.RNN_ROUTES)
    n0 = K.launch_counts()["gru_seq"]
    got = cms["ragged"](x=xs["ragged"])
    torch.cuda.synchronize()
    on_loop = nn_ops.RNN_ROUTES["loop"] - routes["loop"]
    ref = plain["ragged"](x=xs["ragged"])
    d = max((o - r).abs().max().item() for o, r in zip(got, ref))
    checks.require(on_loop == 2 and K.launch_counts()["gru_seq"] == n0 and d <= GRU_TOL,
                   f"ragged B=4 GRU request: both directions on the loop, no gru_seq launch, "
                   f"vs plain max|d| {d:.3e}")
    lstm_g = rnn_graph("LSTM", 1023, 1, 256, 256, grng)
    cm_l = compile_model(lstm_g, device=dev, strict=True)
    cm_lp = compile_model(lstm_g, device=dev, strict=True, overrides={"LSTM": nn_ops.lstm_plain})
    x_l = torch.from_numpy(grng.standard_normal((1023, 1, 256)).astype(np.float32)).to(dev)
    routes = dict(nn_ops.RNN_ROUTES)
    K.reset_launch_counts()
    got = cm_l(x=x_l)
    torch.cuda.synchronize()
    l_launches = K.launch_counts()
    ref = cm_lp(x=x_l)
    d = max((o - r).abs().max().item() for o, r in zip(got, ref))
    err["lstm_seq"] = max(err["lstm_seq"], d)
    checks.require(l_launches["lstm_seq"] == 1 and nn_ops.RNN_ROUTES["loop"] == routes["loop"]
                   and d <= LSTM_TOL,
                   f"LSTM graph H=256 S=1023: {l_launches['lstm_seq']} lstm_seq launch, loop "
                   f"unchanged, vs lstm_plain max|d| {d:.3e} <= {LSTM_TOL:g}")

    banner(f"== 17. compiled QMoE layer (hidden {hidden}, inter {inter}, {E} experts, top-2)")
    qmoe = {}
    for rows in MOE_ROWS:
        bs = build_moe_layer_model(rows, seed=GRAPH_SEED + rows, **MOE_DECODE)
        qmoe[rows] = (compile_model(bs, device=dev, strict=True),
                      compile_model(bs, device=dev, strict=True, patterns=F32_NBITS_PATTERNS),
                      compile_model(bs, device=dev, strict=True, patterns=[]),
                      torch.from_numpy(grng.standard_normal((rows, hidden))
                                       .astype(np.float32)).to(dev))
    print(f"  graph: {len(bs) / 1e6:.1f} MB of ONNX bytes (packed experts)")
    x1 = qmoe[MOE_ROWS[0]][3]
    register_cm(f"QMoE decode layer, {MOE_ROWS[0]} row (kernel 7 three times)",
                qmoe[MOE_ROWS[0]][0], [{"x": x1}, {"x": torch.randn(x1.shape, generator=gen,
                                                                     device=dev)}], rel=1e-5)
    K.reset_launch_counts()
    fused = {rows: qmoe[rows][0](x=qmoe[rows][3])[0] for rows in MOE_ROWS[:2]}
    torch.cuda.synchronize()
    moe_launches = K.launch_counts()
    print(f"  launch counts over 2 decode requests: {moe_launches}")
    checks.require(moe_launches["w4_gemm"] == 6 and sum(moe_launches.values()) == 6,
                   "w4_gemm 3 times a decode request (fc1, fc3, fc2, expert-indexed)")
    for rows in MOE_ROWS:
        cm, cm32, cm_ref, x = qmoe[rows]
        decode = rows * 2 <= E
        hits = cm.stats["pattern_hits"]
        checks.require(hits.get("qmoe_w4", 0) == (2 if decode else 0)
                       and cm32.stats["pattern_hits"].get("qmoe_w4", 0) == (2 if decode else 0)
                       and not cm_ref.stats["pattern_hits"],
                       f"rows={rows}: pattern hits {hits} ({'decode' if decode else 'prefill'})")
        n0 = K.launch_counts()["w4_gemm"]
        y = fused[rows] if decode else cm(x=x)[0]
        y32 = cm32(x=x)[0]
        ref = cm_ref(x=x)[0]
        torch.cuda.synchronize()
        if not decode:
            checks.require(K.launch_counts()["w4_gemm"] == n0,
                           "prefill: the pattern declines, no w4_gemm launch from the default "
                           "route")
        rn = ((y - ref).norm() / ref.norm()).item()
        rn32 = ((y32 - ref).norm() / ref.norm()).item()
        checks.require(tuple(y.shape) == (rows, hidden) and bool(torch.isfinite(y).all())
                       and rn <= NBITS_RELNORM,
                       f"QMoE rows={rows} bf16 route vs per-op: relative Frobenius {rn:.3e} "
                       f"<= {NBITS_RELNORM:g}")
        checks.require(rn32 <= QMOE_F32_REL,
                       f"QMoE rows={rows} f32 route vs per-op: relative Frobenius {rn32:.3e} "
                       f"<= {QMOE_F32_REL:g}")

    banner(f"== 18. slice 5 timings (CUDA events, median of warm runs; {card})")
    for S in (1875, 18750):
        args = gru_inputs(S, 1, 128, dev, gen)
        a = time_ms(lambda: K.gru_seq(*args, True), runs=10)
        a0 = time_ms(lambda: K.gru_seq(*args, False), runs=10)
        b = plain_18750 if S > 2000 else time_ms(lambda: K.gru_seq_plain(*args, True), runs=3,
                                                  warm=1)
        gru = cudnn_gru(args[1], args[2], dev)
        reps = 4 if S < 2000 else 2  # calls in a CUDA graph: these take milliseconds
        g_k = graph_us(lambda: K.gru_seq(*args, True), n=reps, reps=3)
        g_k0 = graph_us(lambda: K.gru_seq(*args, False), n=reps, reps=3)
        with torch.no_grad(), torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            y, _ = gru(args[0], args[3][None])
            lib_d = (y - K.gru_seq(*args, True)[0]).abs().max().item()
            c = time_ms(lambda: gru(args[0], args[3][None]), runs=10)
            g_l = graph_us(lambda: gru(args[0], args[3][None]), n=reps, reps=3)
        b_ms, b_by = gru_bound(S, 1, 128, True)
        b0_ms, _ = gru_bound(S, 1, 128, False)
        print(f"  gru_seq S={S} B=1 H=128: linear_before_reset kernel {a:.4f} ms "
              f"({a * 1e3 / S:.4f} us a step; {g_k:.2f} us in a CUDA graph), without "
              f"{a0:.4f} ms ({g_k0:.2f} us); plain {b:.3f} ms; cuDNN nn.GRU on xproj with "
              f"W_ih a permutation {c:.4f} ms ({g_l:.2f} us in a CUDA graph; + one "
              f"[S,384]x[384,384] input product; max|d| vs kernel {lib_d:.2e}); bound "
              f"{b_ms * 1e3:.3f} us (without: {b0_ms * 1e3:.3f} us) by {b_by}, kernel at "
              f"{100 * b_ms / a:.4f}% of it  ({card})")
        ms["gru_seq"], plain_ms["gru_seq"], library_ms["gru_seq"] = a, b, c
        bounds["gru_seq"] = (b_ms, b_by)
        DEVICE_US["gru_seq"] = {"graph_us": g_k, "library_graph_us": g_l}
    S, H = 1023, 256
    largs = lstm_inputs(S, 1, H, dev, gen)
    gargs = gru_inputs(S, 1, H, dev, gen)
    lstm, gru = cudnn_lstm(largs[1], dev), cudnn_gru(gargs[1], gargs[2], dev)
    with torch.no_grad(), torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        lib_l = time_ms(lambda: lstm(largs[0], (largs[2][None], largs[3][None])), runs=10)
        lib_g = time_ms(lambda: gru(gargs[0], gargs[3][None]), runs=10)
    for name, kern, plain_fn, args, lib, bnd in (
            ("lstm_seq", K.lstm_seq, K.lstm_seq_plain, largs, lib_l, lstm_bound(S, 1, H)),
            ("gru_seq", K.gru_seq, K.gru_seq_plain, gargs, lib_g, gru_bound(S, 1, H, True))):
        a = time_ms(lambda: kern(*args), runs=10)
        b = time_ms(lambda: plain_fn(*args), runs=3, warm=1)
        print(f"  {name} general form S={S} B=1 H={H}: kernel {a:.4f} ms ({a * 1e3 / S:.3f} us "
              f"a step), plain {b:.3f} ms, cuDNN {lib:.4f} ms; bound {bnd[0] * 1e3:.3f} us by "
              f"{bnd[1]}, kernel at {100 * bnd[0] / a:.4f}% of it  ({card})")
    args = lstm_inputs(255, 1, 1024, dev, gen)
    a = time_ms(lambda: K.lstm_seq(*args), runs=5)
    bnd = lstm_bound(255, 1, 1024)
    print(f"  lstm_seq general form S=255 B=1 H=1024: kernel {a:.4f} ms ({a * 1e3 / 255:.3f} us "
          f"a step; Wh 16 MiB from L2 each step); bound {bnd[0] * 1e3:.3f} us by {bnd[1]}  "
          f"({card})")
    for k_, n_ in ((hidden, inter), (inter, hidden), PHI_MOE, PHI_MOE[::-1]):
        x = torch.randn((1, k_), generator=gen, device=dev).to(torch.bfloat16)
        w = torch.randn((k_, n_), generator=gen, device=dev) / k_ ** 0.5
        packed, scales = W4.quantize_weight_int4(w, 128)
        a = time_ms(lambda: K.w4_matmul(x, packed, scales, 128))
        b = time_ms(lambda: K.w4_matmul_plain(x, packed, scales, 128))
        w_bf16 = W4.dequantize_int4(packed, scales, 128).to(torch.bfloat16)
        c = time_ms(lambda: torch.matmul(x, w_bf16))
        b_ms, b_by = bound(2 * k_ + packed.numel() + 4 * scales.numel() + 4 * n_,
                           {"bf16": 2 * k_ * n_})
        # the device's own time a call, warm (one weight, resident in the L2)
        # and cold (calls rotate over copies whose set exceeds the 50 MB L2,
        # as a decode step meets each expert's weight once a token)
        wk = cycle([(packed.clone(), scales.clone()) for _ in
                    range(int(L2_BYTES // (packed.numel() + 4 * scales.numel())) + 2)])
        wl = cycle([w_bf16.clone() for _ in range(int(L2_BYTES // (2 * w_bf16.numel())) + 2)])
        d_kw, g_kw = device_times(lambda: K.w4_matmul(x, packed, scales, 128))
        d_kc, g_kc = device_times(lambda: K.w4_matmul(x, *next(wk), 128))
        d_lw, g_lw = device_times(lambda: torch.matmul(x, w_bf16))
        d_lc, g_lc = device_times(lambda: torch.matmul(x, next(wl)))
        print(f"  w4_gemm decode [1,{k_}]x[{k_},{n_}] g128 bf16: kernel {a:.4f} ms, plain "
              f"{b:.4f} ms, torch.matmul bf16 x bf16 dequantised weight {c:.4f} ms (events); "
              f"device a call by the profiler (in a CUDA graph): kernel warm {fmt_us(d_kw)} "
              f"({g_kw:.2f} us), cold {fmt_us(d_kc)} ({g_kc:.2f} us); torch.matmul warm "
              f"{fmt_us(d_lw)} ({g_lw:.2f} us), cold {fmt_us(d_lc)} ({g_lc:.2f} us); bound "
              f"{b_ms * 1e3:.2f} us by {b_by} ({(packed.numel() + 4 * scales.numel()) / 1e6:.2f}"
              f" MB of weight and scales), kernel's cold graph time at "
              f"{100e3 * b_ms / g_kc:.2f}% of it  ({card})")
    for k_, group in ((512, 8), (768, 24), (1040, 8)):
        x = torch.randn((NBITS_ROWS, k_), generator=gen, device=dev).to(torch.bfloat16)
        packed = torch.randint(-128, 128, (k_ // 2, 1536), generator=gen, device=dev,
                               dtype=torch.int8)
        scales = torch.rand((k_ // group, 1536), generator=gen, device=dev) * 0.01 + 1e-3
        a = time_ms(lambda: K.w4_matmul(x, packed, scales, group))
        b = time_ms(lambda: K.w4_matmul_plain(x, packed, scales, group))
        w_bf16 = W4.dequantize_int4(packed, scales, group).to(torch.bfloat16)
        c = time_ms(lambda: torch.matmul(x, w_bf16))
        b_ms, b_by = bound(2 * NBITS_ROWS * k_ + packed.numel() + 4 * scales.numel()
                           + 4 * NBITS_ROWS * 1536, {"bf16": 2 * NBITS_ROWS * k_ * 1536})
        form = "group-accumulator" if W4.group_acc_form(k_, group) else "dequantised-tile"
        print(f"  w4_gemm [{NBITS_ROWS},{k_}]x[{k_},1536] g{group} bf16 ({form} form): kernel "
              f"{a:.4f} ms, plain {b:.4f} ms, torch.matmul bf16 x bf16 dequantised weight "
              f"{c:.4f} ms; bound {b_ms * 1e3:.2f} us by {b_by}  ({card})")
    x = torch.randn((2, hidden), generator=gen, device=dev).to(torch.bfloat16)
    packed = torch.randint(-128, 128, (E, hidden // 2, inter), generator=gen, device=dev,
                           dtype=torch.int8)
    scales = torch.rand((E, hidden // 128, inter), generator=gen, device=dev) * 0.01 + 1e-3
    idx = torch.tensor([3, 6], dtype=torch.int32, device=dev)
    a = time_ms(lambda: K.w4_matmul(x, packed, scales, 128, idx))
    b = time_ms(lambda: K.w4_matmul_plain(x, packed, scales, 128, idx))
    d_k, g_k = device_times(lambda: K.w4_matmul(x, packed, scales, 128, idx))
    b_ms, b_by = bound(2 * 2 * hidden + 2 * (packed[0].numel() + 4 * scales[0].numel())
                       + 4 * 2 * inter + 8, {"bf16": 2 * 2 * hidden * inter})
    print(f"  w4_gemm expert-indexed, 1 row x top-2 [2,{hidden}] x stacks [{E},{hidden // 2},"
          f"{inter}] g128 bf16 (fc1 of a decode step): kernel {a:.4f} ms, plain {b:.4f} ms "
          f"(gathers the two stacks); device a call (warm) {fmt_us(d_k)} by the profiler, "
          f"{g_k:.2f} us in a CUDA graph; bound "
          f"{b_ms * 1e3:.2f} us by {b_by}  ({card})")
    for rows in MOE_ROWS[:2]:
        cm, cm32, cm_ref, x = qmoe[rows]
        t_f = host_ms(lambda: (cm(x=x), torch.cuda.synchronize()), runs=20)
        t_32 = host_ms(lambda: (cm32(x=x), torch.cuda.synchronize()), runs=20)
        t_r = host_ms(lambda: (cm_ref(x=x), torch.cuda.synchronize()), runs=10)
        d_f = time_ms(lambda: cm(x=x))
        print(f"  QMoE layer rows={rows} request (host clock, median): fused bf16 {t_f:.4f} ms "
              f"(CUDA events {d_f:.4f} ms), fused f32 {t_32:.4f} ms, per-op {t_r:.4f} ms  "
              f"({card})")
    for k in (1, 0):
        t_k = host_ms(lambda: (cms[k](x=xs[k]), torch.cuda.synchronize()), runs=5)
        t_p = host_ms(lambda: (plain[k](x=xs[k]), torch.cuda.synchronize()), runs=1)
        print(f"  GRU graph linear_before_reset={k} request (host clock, median): kernel route "
              f"{t_k:.3f} ms, gru_plain override {t_p:.3f} ms  ({card})")
    return {"gru": gru_launches, "qmoe": moe_launches}


def dev_time(e):  # the attribute's name moved between torch versions
    v = getattr(e, "self_device_time_total", None)
    return v if v is not None else e.self_cuda_time_total


def device_rows(prof) -> dict[str, list]:
    """{name: [device us, records]} of a finished trace's device-side
    records (kernels, copies, sets), summed from the raw trace: the sums of
    key_averages()'s device rows, without the Python event it first builds
    for each record (on the CPU 3.07 s against 0.09 for 30,000 records;
    scripts/torch_port_profiler_probe.py holds the two to the same rows on
    the card)."""
    from torch.autograd import DeviceType

    rows: dict[str, list] = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CPU:
            row = rows.setdefault(e.name(), [0.0, 0])
            row[0] += e.duration_ns() / 1e3
            row[1] += 1
    return {k: v for k, v in rows.items() if v[0] > 0}


def profile_top(fn, label: str, card: str, n: int = 3, top: int = 12,
                warm: bool = True) -> list:
    """Trace n calls of fn() with torch.profiler (after one untraced call,
    unless the caller ran fn already: warm=False): the device's busy share
    of the host span and the device time by kernel. Only device-side rows
    are summed: a CPU op's row (aten::mm) carries the device time of the
    kernels it launched, which have rows of their own. Returns (kernel
    name, device us a call, launches a call), the longest first."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if warm:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        span_us = (time.perf_counter() - t0) * 1e6
    rows = device_rows(prof)
    dev_us = sum(us for us, _ in rows.values())
    launches = sum(c for _, c in rows.values()) // n
    print(f"  profile, {n} x {label}: device {dev_us / n:.1f} us a call in {launches} "
          f"launches over {span_us / n:.1f} us, busy share {dev_us / span_us:.3f}  ({card})")
    rows = [(k, us / n, c // n) for k, (us, c) in sorted(rows.items(), key=lambda r: -r[1][0])]
    for name, us, count in rows[:top]:
        print(f"    {us:10.1f} us  x{count:<5d} {name[:90]}")
    return rows


def interleaved(step, chunks, states, i: int) -> list:
    """Streams 0 and 1 through step(chunk, state) → (out, state), their
    calls alternating (on input i = 1 stream 1 goes first), each carrying
    its own state: the outputs in call order, then each stream's last
    state. Through one captured program, a stream must not see the
    other's state."""
    states, outs = list(states), []
    for t in range(len(chunks[0])):
        for k in ((0, 1) if i == 0 else (1, 0)):
            out, states[k] = step(chunks[k][t], states[k])
            outs.append(out)
    return outs + states


def register(label: str, after, before, rel: float | None = None, programs=None) -> None:
    CAPTURED[label] = {"after": after, "before": before, "rel": rel, "programs": programs}


def register_ids(label: str, model, inputs, rel: float | None = None) -> None:
    """A SenseVoiceModel's bucketed or batched program (`_run_ids`) on two
    (pcm [B, n], n_valid [B]) inputs of one bucket, against its body
    (`_ids_fn()`) run eagerly on the same inputs."""
    import numpy as np
    import torch

    def before(i):
        batch, lens = inputs[i]
        return model._ids_fn()(torch.from_numpy(batch).to(model.device),
                               torch.from_numpy(np.asarray(lens, np.int64)).to(model.device))

    register(label, lambda i: model._run_ids(*inputs[i]), before, rel, model.programs)


def register_cm(label: str, cm, inputs, rel: float | None = None) -> None:
    """A CompiledModel's captured call against `replay()` (step by step)."""
    def after(i):
        out = cm(**inputs[i])
        if not cm.stats["captured"]:
            raise RuntimeError(f"{label}: the model was not captured ({cm.stats})")
        return out

    register(label, after, lambda i: cm.replay(**inputs[i]), rel)


def _card_tensors(out) -> list:
    """A path's outputs (tensors, numpy arrays, trees of them) as one list of
    tensors on the card."""
    import numpy as np
    import torch

    from lele_tpu_torch.runtime.graphs import flatten

    leaves, _ = flatten(out)
    return [(torch.from_numpy(v) if isinstance(v, np.ndarray) else v).cuda()
            for v in leaves if isinstance(v, (np.ndarray, torch.Tensor))]


def busy(fn, warm: bool = True) -> tuple[float, float]:
    """(device us, host span us) of one fn() (ending in a sync) under
    torch.profiler, after one warm call unless `warm` is False; the device
    time only from device-side rows. Like every profile here that reads
    device rows only, it traces CUDA activity alone: tracing each launch on
    the CPU side too cost 17.6 s against 5.0 for 20,000 launches, with the
    same device rows, and widened the span (scripts/torch_port_profiler_probe.py,
    NVIDIA H100 80GB HBM3, 700.00 W)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if warm:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        span_us = (time.perf_counter() - t0) * 1e6
    return sum(us for us, _ in device_rows(prof).values()), span_us


# each wrapper's kernels (csrc `__global__` names), exactly one of which runs
# a launch (the helpers beside them, such as kernel 5's quantize pass or
# kernel 12's statistics, are not listed), except where LAUNCH_NODES says
# how many kernel nodes one launch is; wrappers that share a kernel are
# counted together (`launch_groups`)
LAUNCH_KERNELS = {
    "est_block": ("ln_rows", "gemm_bf16", "attention"),
    "w8_gemm": ("w8_wgmma", "w8_gemm_f32"),
    "sanm_layer_w8": ("attn_fsmn",),
    "sanm_stack_w8": ("sanm_stack_kernel",),
    "sanm_stack_w4": ("sanm_stack_kernel",),
    "dq_gemm": ("dq_gemm_mma", "dq_gemm_strip"),
    "int8_gemm": ("dq_gemm_strip",),
    "sanm_stack_dql": ("sanm_dql_kernel",),
    "lstm_seq": ("lstm_seq_reg", "rnn_seq_cluster"),
    "gru_seq": ("gru_seq_reg", "rnn_seq_cluster"),
    "w4_gemm": ("w4_gemm_mma", "w4_gemm_f32", "w4_gemv_mma", "w4_gemv"),
    "flash_attn": ("flash_attn_tf32", "flash_attn_ffma"),
}


# kernel 10 is a fixed sequence of launches a call (csrc/est_block.cu): 8 a
# self block and 9 a cross block, 68 for the TTS estimator's 8 blocks
LAUNCH_NODES = {"est_block": 8 * 8 + 8 // 2}


def launch_groups() -> list[tuple[set, set]]:
    """(wrappers, kernel names) of LAUNCH_KERNELS, merged where wrappers
    share a kernel."""
    groups: list[tuple[set, set]] = []
    for w, names in LAUNCH_KERNELS.items():
        ws, ns = {w}, set(names)
        for g in [g for g in groups if g[1] & ns]:
            groups.remove(g)
            ws, ns = ws | g[0], ns | g[1]
        groups.append((ws, ns))
    return groups


def is_kernel(node_name: str, name: str) -> bool:
    """A kernel node's (mangled) function name is csrc kernel `name`."""
    return node_name == name or f"{len(name)}{name}" in node_name


def program_launch_check(checks, label: str, calls: list) -> None:
    """The programs one captured call went through: each one's graph holds,
    group by group, as many kernel nodes of our kernels as the launches it
    recorded at capture (its `_delta`), which each replay adds to
    `launch_counts()`."""
    import torch

    for prog in {id(p): p for p in calls}.values():
        try:
            nodes = [n for k, n in read_graph_nodes(prog.graph) if k == "KERNEL"]
        except (RuntimeError, OSError, TypeError, AttributeError) as e:
            checks.require(False, f"{label}: {prog.name}'s graph not read ({e})")
            continue
        delta = {k: v for k, v in prog._delta[0].items() if v}
        unmapped = sorted(set(delta) - set(LAUNCH_KERNELS))
        per = []
        for ws, ns in launch_groups():
            got = sum(any(is_kernel(n, k) for k in ns) for n in nodes)
            want = sum(delta.get(w, 0) * LAUNCH_NODES.get(w, 1) for w in ws)
            if got or want:
                per.append(("+".join(sorted(ws)), got, want))
        checks.require(not unmapped and all(g == w for _, g, w in per),
                       f"{label}: {prog.name}'s graph, {len(nodes)} kernel nodes: "
                       + (", ".join(f"{w} {g} nodes for {n} nodes of its counted launches"
                                    for w, g, n in per) or "none of ours, no launch counted")
                       + (f"; no kernel names for {unmapped}" if unmapped else ""))


# phase 32 times a side (captured or uncaptured) of a path whose one warm
# call takes longer than this once by host clock and once by events, and
# profiles it without a warm-up call (the checks before have warmed it):
# the slow sides are host-paced, and twenty calls of them were most of the
# phase's time
SLOW_CALL_MS = 40.0


def side_times(fn) -> tuple[float, float, float, float]:
    """(host ms, events ms, device us, profiled span us) of fn(), a path's
    side already warm: medians of 5 and 10 calls, or one call each where
    one takes longer than SLOW_CALL_MS."""
    import torch

    def synced():
        fn()
        torch.cuda.synchronize()

    t0 = time.perf_counter()
    synced()
    one = (time.perf_counter() - t0) * 1e3
    if one > SLOW_CALL_MS:
        return (one, time_ms(fn, runs=1, warm=0), *busy(synced, warm=False))
    return (host_ms(synced), time_ms(fn, runs=10), *busy(synced))


def capture_phase(checks, card) -> None:
    """Phase 32: every registered path, captured against uncaptured: the
    gate, the launch counts, a second call on other inputs, the program
    count, and both paths' times.

    A replay runs no wrapper, so the captured path's launch counts are the
    ones its programs recorded at capture: the kernel nodes of each program
    the captured call went through are held against them, and the counts
    the call added against the sum of those programs' records."""
    import torch

    from lele_tpu_torch import kernels as K
    from lele_tpu_torch.runtime.graphs import Program

    banner(f"== 32. one CUDA graph a bucket: each captured path against its uncaptured "
          f"oracle ({card})")
    for label, e in CAPTURED.items():
        t_label = time.perf_counter()
        after, before, rel, progs = e["after"], e["before"], e["rel"], e["programs"]
        with torch.inference_mode():
            K.reset_launch_counts()
            calls, call = [], Program.__call__
            Program.__call__ = lambda prog, *a, **k: (
                calls.extend([prog] * k.get("repeat", 1)), call(prog, *a, **k))[1]
            try:
                a0 = _card_tensors(after(0))
            finally:
                Program.__call__ = call
            torch.cuda.synchronize()
            ca = K.launch_counts()
            n_prog = len(progs) if progs is not None else None
            K.reset_launch_counts()
            b0 = _card_tensors(before(0))
            torch.cuda.synchronize()
            cb = K.launch_counts()
            keep = [t.clone() for t in a0]
            a1, b1 = _card_tensors(after(1)), _card_tensors(before(1))
            torch.cuda.synchronize()
        pairs = list(zip(a0, b0)) + list(zip(a1, b1))
        shapes = (len(a0) == len(b0) and len(a1) == len(b1)
                  and all(a.shape == b.shape and a.dtype == b.dtype for a, b in pairs))
        same = shapes and all(torch.equal(a, b) for a, b in pairs)
        worst = max(((a.double() - b.double()).abs().max().item()
                     / max(b.double().abs().max().item(), 1e-30))
                    for a, b in pairs if a.numel()) if shapes else float("inf")
        gate = "the same bits" if rel is None else f"max|d|/max|ref| <= {rel:g}"
        checks.require(same if rel is None else (shapes and worst <= rel),
                       f"{label}: captured vs uncaptured on two inputs: "
                       f"{'the same bits' if same else f'max|d|/max|ref| {worst:.3e}'} "
                       f"(gate: {gate})")
        moved = {k: v for k, v in ca.items() if v}
        checks.require(ca == cb, f"{label}: launch counts of one call, captured {moved} = "
                                 f"uncaptured {dict((k, v) for k, v in cb.items() if v)}")
        checks.require(all(torch.equal(k, a) for k, a in zip(keep, a0)),
                       f"{label}: a second call on other inputs left the first call's "
                       "outputs as they were")
        if progs is not None:
            checks.require(len(progs) == n_prog,
                           f"{label}: one program served both inputs ({n_prog} programs)")
        hb, eb, db, sb = side_times(lambda: before(0))
        ha, ea, da, sa = side_times(lambda: after(0))
        recorded = {k: sum(p._delta[0][k] for p in calls) for k in ca}
        checks.require(bool(calls) and recorded == ca,
                       f"{label}: the captured call went through {len(calls)} program calls, "
                       f"whose recorded launches {dict((k, v) for k, v in recorded.items() if v)}"
                       f" are its counts")
        program_launch_check(checks, label, calls)
        print(f"  {label}: uncaptured {hb:.3f} ms by host clock, {eb:.3f} ms by events, "
              f"device {db:.1f} us, busy {db / sb:.3f}; captured {ha:.3f} ms, {ea:.3f} ms, "
              f"device {da:.1f} us, busy {da / sa:.3f}; {time.perf_counter() - t_label:.1f} s "
              f"of this phase  ({card})")
    print(f"  torch.cuda.max_memory_reserved() after the captures: "
          f"{torch.cuda.max_memory_reserved() / 2**30:.2f} GiB (reserved now "
          f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB)  ({card})")


def silero_blocks(checks, dev, card) -> None:
    """Phase 32b: SileroOnnx's BLOCK (chunks a captured graph) at 10 s and 16
    kHz: each size's first request (its graphs captured), its times and its
    probabilities against the uncaptured path's bits."""
    import numpy as np

    from lele_tpu_torch.models import SileroOnnx

    banner(f"== 32b. SileroOnnx blocks of {', '.join(map(str, SILERO_BLOCKS))} chunks a graph, "
          f"10 s at 16 kHz ({card})")
    pcm = vad_pcm(10.0, VAD_SR, np.random.default_rng(SEED + 33))
    ref = None
    for b in SILERO_BLOCKS:
        sv = SileroOnnx(SILERO_FIXTURE, device=dev)
        sv.BLOCK = b
        sv.compiled(VAD_SR)  # the trace, outside the first request's time
        t0 = time.perf_counter()
        probs = sv.speech_probs(pcm, VAD_SR)
        first = time.perf_counter() - t0
        if ref is None:
            ref = silero_onnx_stepwise(sv, pcm, VAD_SR)
        sizes = sv.blocks(len(ref))
        checks.require(np.array_equal(probs, ref),
                       f"SileroOnnx BLOCK {b}: {len(ref)} probabilities, the uncaptured "
                       f"path's bits")
        host = host_ms(lambda: sv.speech_probs(pcm, VAD_SR))
        ev = time_ms(lambda: sv.speech_probs(pcm, VAD_SR), runs=10)
        d_us, span = busy(lambda: sv.speech_probs(pcm, VAD_SR))
        print(f"  BLOCK {b}: {len(sizes)} replays a request ({len(set(sizes))} graphs); first "
              f"request {first:.3f} s (warm-up and capture); {host:.3f} ms by host clock, "
              f"{ev:.3f} ms by events, device {d_us:.1f} us, busy {d_us / span:.3f}  ({card})")


def silero_onnx_stepwise(sv, pcm, sr: int):
    """SileroOnnx's speech_probs before capture: one step-by-step replay of
    the tape a chunk, the state carried on the card, one read at the end."""
    import torch

    cm = sv.compiled(sr)
    x = torch.from_numpy(sv._chunks(pcm, None)).to(sv.device)
    state, probs = sv._state0(cm), []
    for i in range(x.shape[0]):
        prob, state = cm.replay(x[i:i + 1], state)[:2]
        probs.append(prob.reshape(()))
    return torch.stack(probs).cpu().numpy()


def silero_utterance_model(form: str, n_chunks: int, sr: int, fixture=SILERO_FIXTURE) -> bytes:
    """Silero's whole utterance as one ONNX graph around the fixture's step:
    inputs chunks [N, 1, 512] (PCM scaled as SileroOnnx scales it) and state
    [2, 1, 128]; outputs probs [N] and the final state. `sr` is an outer
    constant, so the step's If resolves while tracing. form "scan": a Scan
    whose state variable is the state, whose scan input is the chunks and
    whose scan output is the probability; "loop": a pure for-loop of M = N
    whose body takes its chunk as Gather(chunks, iter). Test data for the
    tracer's Scan and Loop, not a model the package ships."""
    import numpy as np

    from lele_tpu_torch.onnx import builder as ob
    from lele_tpu_torch.onnx import schema

    g = schema.decode_model(Path(fixture).read_bytes()).raw()["graph"]
    x_in, st_in = (vi for vi in g["input"] if vi["name"] != "sr")
    prob, st_out = g["output"]
    chunk_shape = [d["dim_value"] for d in x_in["type"]["tensor_type"]["shape"]["dim"]]
    st_shape = [d["dim_value"] for d in st_in["type"]["tensor_type"]["shape"]["dim"]]
    nodes, inputs = list(g["node"]), [st_in, x_in]
    outputs = [st_out, prob]
    inits = [ob.tensor_from_array(np.full((1,), sr, np.int64), "sr")]
    if form == "loop":
        nodes = [ob.node("Gather", ["chunks", "iter"], [x_in["name"]], axis=0),
                 ob.node("Identity", ["cond_in"], ["cond_out"])] + nodes
        inputs = [ob.value_info("iter", 7, []), ob.value_info("cond_in", 9, []), st_in]
        outputs = [ob.value_info("cond_out", 9, []), st_out, prob]
        inits.append(ob.tensor_from_array(np.array(n_chunks, np.int64), "M"))
    body = ob.graph(nodes, "step", inputs, outputs, g["initializer"])
    if form == "scan":
        loop = ob.node("Scan", ["state", "chunks"], ["state_final", "prob_rows"],
                       num_scan_inputs=1, body=body)
    elif form == "loop":
        loop = ob.node("Loop", ["M", "", "state"], ["state_final", "prob_rows"], body=body)
    else:
        raise ValueError(f"form {form!r}: expected 'scan' or 'loop'")
    return ob.build_model_bytes(
        [loop, ob.node("Reshape", ["prob_rows", "flat"], ["probs"])],
        [ob.value_info("chunks", 1, [n_chunks] + chunk_shape), ob.value_info("state", 1, st_shape)],
        [ob.value_info("probs", 1, [n_chunks]), ob.value_info("state_final", 1, st_shape)],
        inits + [ob.tensor_from_array(np.array([-1], np.int64), "flat")])


def sanm_modules(T: int, D: int, H: int, FFN: int, K: int):
    """(SanmLayer, SanmEncoder): the SAN-M layer in its torch export form
    (fused-qkv attention with Div scaling and an additive bias, the
    depthwise FSMN conv on v, post-LN residual blocks), a copy of the JAX
    package's test module (tests/test_sanm_fuse_torch.py) with its widths as
    arguments. `SanmEncoder(L)` stacks L layers."""
    import math

    import torch
    import torch.nn as nn

    class SanmLayer(nn.Module):
        def __init__(self):
            super().__init__()
            self.ln1 = nn.LayerNorm(D)
            self.qkv = nn.Linear(D, 3 * D)
            self.fsmn = nn.Conv1d(D, D, K, groups=D, bias=False, padding=(K - 1) // 2)
            self.out = nn.Linear(D, D)
            self.ln2 = nn.LayerNorm(D)
            self.ff1 = nn.Linear(D, FFN)
            self.ff2 = nn.Linear(FFN, D)

        def forward(self, x, attn_bias, vmask):
            hd = D // H
            y = self.ln1(x)
            q, k, v = self.qkv(y).chunk(3, dim=-1)
            qh = q.reshape(1, T, H, hd).permute(0, 2, 1, 3)
            kh = k.reshape(1, T, H, hd).permute(0, 2, 3, 1)
            vh = v.reshape(1, T, H, hd).permute(0, 2, 1, 3)
            att = torch.matmul(qh, kh) / math.sqrt(hd)
            att = torch.softmax(att + attn_bias, dim=-1)
            ctx = torch.matmul(att, vh).permute(0, 2, 1, 3).reshape(1, T, D)
            fs = self.fsmn(v.transpose(1, 2) * vmask).transpose(1, 2)
            h1 = x + self.out(ctx + fs)
            return h1 + self.ff2(torch.relu(self.ff1(self.ln2(h1))))

    class SanmEncoder(nn.Module):
        def __init__(self, n_layers: int):
            super().__init__()
            self.layers = nn.ModuleList(SanmLayer() for _ in range(n_layers))

        def forward(self, x, attn_bias, vmask):
            for layer in self.layers:
                x = layer(x, attn_bias, vmask)
            return x

    return SanmLayer, SanmEncoder


def sanm_export(encoder, layer_cls, args, functions: bool) -> bytes:
    """The encoder exported by torch.onnx.export (TorchScript, opset 17)
    through the port's onnx stand-in; `functions` packages each layer as a
    local function (`export_modules_as_functions`: torch's function
    extraction asserts on a second such export of the same instance, so
    export each module once)."""
    import torch

    from lele_tpu_torch.onnx.torch_shim import install

    install()
    buf = io.BytesIO()
    kw = {"export_modules_as_functions": {layer_cls}} if functions else {}
    with torch.no_grad():
        torch.onnx.export(encoder, args, buf, opset_version=17, dynamo=False,
                          input_names=["x", "attn_bias", "vmask"], **kw)
    return buf.getvalue()


# phase 34's SAN-M export: depth cut from 50 to keep the whole script in its
# time once phase 38 was added (the widths stay SenseVoice's)
CF_SANM_LAYERS = 12


def control_flow_phase(checks, dev, card) -> dict:
    """Phase 34: the tracer's Scan and Loop and ONNX local functions at full
    width. Silero's 10 s utterance (312 chunks, 16 and 8 kHz) as one Scan and
    one Loop over fixtures/silero.onnx's step (kernel 6 once a chunk, one
    captured graph a call), against SileroOnnx.speech_probs' bits and the
    plain-LSTM compile; a function-packaged int8 SAN-M encoder (CF_SANM_LAYERS
    layers) at SenseVoice's
    widths (exported here through the port's onnx stand-in, quantized by the
    port's quantize_dynamic): every layer fused, one kernel-4 launch a call in
    a captured graph, the flat export's bits, the per-op trace's noise gate.
    Returns each kernel's launches in one call of each path:
    {kernel: {path: count}}."""
    import numpy as np
    import torch

    from lele_tpu_torch import kernels as K
    from lele_tpu_torch.compiler import compile_model
    from lele_tpu_torch.models import SileroOnnx
    from lele_tpu_torch.onnx import schema
    from lele_tpu_torch.onnx.quantize import quantize_dynamic
    from lele_tpu_torch.ops import nn_ops

    banner(f"== 34. Silero's utterance as one Scan / Loop, and a function-packaged int8 "
          f"SAN-M export ({card})")
    launches: dict[str, dict[str, int]] = {}

    def counted(cm, inputs, path):
        with torch.inference_mode():
            K.reset_launch_counts()
            out = cm(**inputs)
            torch.cuda.synchronize()
        moved = {k: v for k, v in K.launch_counts().items() if v}
        for k, v in moved.items():
            launches.setdefault(k, {})[path] = v
        return out, moved

    pcm = vad_pcm(10.0, VAD_SR, np.random.default_rng(SEED + 34))
    for rate in (16000, 8000):
        sv = SileroOnnx(SILERO_FIXTURE, device=dev)
        ref = sv.speech_probs(pcm, rate)
        chunks = torch.from_numpy(sv._chunks(pcm, None)[:, None]).to(dev)
        n = chunks.shape[0]
        inputs = {"chunks": chunks, "state": torch.zeros((2, 1, 128), device=dev)}
        for form in ("scan", "loop"):
            label = f"Silero 10 s at {rate} Hz as one {form.capitalize()}"
            bs = silero_utterance_model(form, n, rate)
            t0 = time.perf_counter()
            cm = compile_model(bs, device=dev)
            t_trace = time.perf_counter() - t0
            plain = compile_model(bs, device=dev, overrides={"LSTM": nn_ops.lstm_plain})
            cm.compile()  # the warm-up and the capture, before the counted call
            (probs, _), moved = counted(cm, inputs, f"{form} {rate} Hz")
            checks.require(cm.stats["capturable"] and cm.stats["captured"],
                           f"{label}: one captured CUDA graph a call ({cm.stats['n_steps']} "
                           f"tape steps, traced in {t_trace:.2f} s)")
            checks.require(moved == {"lstm_seq": n},
                           f"{label}: launches of one call {moved}: kernel 6 once a chunk "
                           f"({n}), nothing else")
            program_launch_check(checks, label, [cm._program])
            got = probs.cpu().numpy()
            with torch.inference_mode():
                p_plain = plain(**inputs)[0].cpu().numpy()
            d_ref = float(np.abs(got - ref).max()) if got.shape == ref.shape else float("inf")
            checks.require(got.shape == (n,) and np.array_equal(got, ref),
                           f"{label}: {n} probabilities, SileroOnnx.speech_probs' bits "
                           f"(max|d| {d_ref:.3e})")
            d = float(np.abs(got - p_plain).max())
            checks.require(bool(np.isfinite(got).all()) and d <= VAD_PROB_TOL,
                           f"{label}: vs the lstm_plain override max|d| {d:.3e} "
                           f"<= {VAD_PROB_TOL:g}")
            call = lambda: cm(**inputs)[0].cpu()  # noqa: E731
            ref_call = lambda: sv.speech_probs(pcm, rate)  # noqa: E731
            h, h_ref = host_ms(call, runs=10), host_ms(ref_call, runs=10)
            (du, span), (du_ref, span_ref) = busy(call), busy(ref_call)
            print(f"  {label}: {h:.3f} ms by host clock, device {du / 1e3:.3f} ms, busy "
                  f"{du / span:.3f}; SileroOnnx.speech_probs (blocks of {sv.BLOCK}) "
                  f"{h_ref:.3f} ms, device {du_ref / 1e3:.3f} ms, busy {du_ref / span_ref:.3f}"
                  f"  ({card})")

    L, T, D, H, FFN, KK = CF_SANM_LAYERS, T_DQL, 512, 4, 2048, 11
    label = f"function-packaged int8 SAN-M, {L} layers, D {D}, T {T}"
    layer, encoder = sanm_modules(T, D, H, FFN, KK)
    torch.manual_seed(SEED)
    enc = encoder(L).eval()
    x = torch.randn(1, T, D)
    bias, vmask = torch.zeros(1, 1, 1, T), torch.ones(1, 1, T)
    bias[..., VALID_DQL:] = -1e4  # the bucket's padded tail masked, as the export's
    vmask[..., VALID_DQL:] = 0.0
    t0 = time.perf_counter()
    fn_bytes = sanm_export(enc, layer, (x, bias, vmask), functions=True)
    t_fn = time.perf_counter() - t0
    flat_bytes = sanm_export(enc, layer, (x, bias, vmask), functions=False)
    t_flat = time.perf_counter() - t0 - t_fn
    t0 = time.perf_counter()
    q_fn = quantize_dynamic(fn_bytes)
    t_q = time.perf_counter() - t0
    q_flat = quantize_dynamic(flat_bytes)
    dec = schema.decode_model(fn_bytes)
    calls = sum(n.domain not in ("", "ai.onnx") for n in dec.graph.node)
    checks.require(len(dec.functions) >= 1 and calls == L,
                   f"{label}: the export holds {len(dec.functions)} local function(s), "
                   f"called {calls} times")
    print(f"  {label}: export {len(fn_bytes) / 1e6:.1f} MB in {t_fn:.2f} s (flat "
          f"{t_flat:.2f} s); quantize_dynamic {t_q:.2f} s -> {len(q_fn) / 1e6:.1f} MB "
          f"(host clock)")
    del fn_bytes, flat_bytes, dec
    t0 = time.perf_counter()
    cm = compile_model(q_fn, device=dev)
    t_trace = time.perf_counter() - t0
    cm_flat = compile_model(q_flat, device=dev)
    cm_op = compile_model(q_fn, device=dev, patterns=[])
    hits = cm.stats["pattern_hits"]
    checks.require(hits.get("sanm_fused_layers") == L,
                   f"{label}: pattern hits {hits} (traced in {t_trace:.2f} s)")
    inputs = {"x": x.to(dev), "attn_bias": bias.to(dev), "vmask": vmask.to(dev)}
    cm.compile()
    (out,), moved = counted(cm, inputs, "function-packaged SAN-M")
    checks.require(cm.stats["captured"] and moved == {"sanm_stack_dql": 1},
                   f"{label}: one captured graph a call, launches {moved}: kernel 4 once")
    program_launch_check(checks, label, [cm._program])
    with torch.inference_mode():
        flat = cm_flat(**inputs)[0]
        per_op = cm_op(**inputs)[0]
        noisy = cm_op(**dict(inputs, x=inputs["x"] * (1 + 1e-7 * torch.randn(
            inputs["x"].shape, generator=torch.Generator().manual_seed(SEED + 7)).to(dev))))[0]
    checks.require(torch.equal(out, flat),
                   f"{label}: the flat export's bits (max|d| "
                   f"{(out - flat).abs().max().item():.3e})")
    v = slice(0, VALID_DQL)
    _, _, mae = compare(out[:, v], per_op[:, v])
    _, _, n_mae = compare(noisy[:, v], per_op[:, v])
    agree = (out[:, v].argmax(-1) == per_op[:, v].argmax(-1)).float().mean().item()
    # the compiled-SenseVoice gate's MAE half: its argmax half reads logits'
    # classes, which an encoder's hidden state has none of (printed only)
    checks.require(bool(torch.isfinite(out).all()) and mae <= LOGIT_NOISE_MAE,
                   f"{label}: fused vs per-op on the {VALID_DQL} valid rows: MAE {mae:.3e} "
                   f"std (per-op vs per-op at a 1e-7 input step {n_mae:.3e}); gate "
                   f"{LOGIT_NOISE_MAE} std; argmax over D agrees on {agree:.4f}")
    g_us = graph_us(lambda: cm(**inputs))
    ev = time_ms(lambda: cm(**inputs))
    print(f"  {label}: the captured program {g_us:.1f} us in a CUDA graph of 20 calls, "
          f"{ev:.3f} ms by events (kernel 4 alone, PERF.md row 4: 4,259 us)  ({card})")
    print(f"  launches {launches}")
    return launches


def est_bound(T: int, Tk: int, D: int, F: int, n_blocks: int) -> tuple[float, str]:
    """Kernel 10: x, text and the masks read once, the bf16 weights and f32
    norms and biases of every block read once, y written once; the bf16
    products of the function (only each block's own attention branch, every
    key, as the function has no data-dependent work)."""
    n_bytes = 4 * (2 * T * D + Tk * D + T + Tk) + n_blocks * (
        2 * (4 * D * D + 2 * D * F) + 4 * (8 * D + F))
    ops = 0
    for i in range(n_blocks):
        tk = T if i % 2 == 0 else Tk
        ops += 2 * T * D * D * 2 + 2 * tk * D * 2 * D + 4 * T * tk * D + 4 * T * D * F
    return bound(n_bytes, {"bf16": ops})


def est_library_blocks(stacked):
    """Per-block views of `stacked` with every leaf cast to bf16: the operands
    of `est_blocks_library`."""
    import torch

    n = stacked["q"]["w"].shape[0]
    return [{k: {leaf: v[i].to(torch.bfloat16) for leaf, v in sub.items()}
             for k, sub in stacked.items()} for i in range(n)]


def est_blocks_library(x, text, lm, tm, blocks, H):
    """Kernel 10's function composed of library calls in bf16 (torch.addmm,
    F.layer_norm, F.scaled_dot_product_attention with the additive mask,
    F.gelu tanh): the yardstick a later kernel must beat. The port never
    calls it."""
    import torch
    import torch.nn.functional as F

    T, D = x.shape
    hd = D // H
    x, text = x.to(torch.bfloat16), text.to(torch.bfloat16)
    masks = [((m - 1) * 1e9).to(torch.bfloat16).view(1, 1, 1, -1) for m in (lm, tm)]

    def heads(a):
        return a.view(-1, H, hd).transpose(0, 1)[None]

    for i, p in enumerate(blocks):
        h = F.layer_norm(x, (D,), p["norm1"]["g"], p["norm1"]["b"], 1e-12)
        src = h if i % 2 == 0 else F.layer_norm(text, (D,), p["norm1"]["g"], p["norm1"]["b"],
                                                1e-12)
        q = torch.addmm(p["q"]["b"], h, p["q"]["w"])
        k, v = torch.addmm(p["kv"]["b"], src, p["kv"]["w"]).split(D, dim=-1)
        ctx = F.scaled_dot_product_attention(heads(q), heads(k), heads(v),
                                             attn_mask=masks[i % 2])
        x = x + torch.addmm(p["out"]["b"], ctx[0].transpose(0, 1).reshape(T, D), p["out"]["w"])
        h2 = F.layer_norm(x, (D,), p["norm2"]["g"], p["norm2"]["b"], 1e-12)
        f = F.gelu(torch.addmm(p["ffn1"]["b"], h2, p["ffn1"]["w"]), approximate="tanh")
        x = x + torch.addmm(p["ffn2"]["b"], f, p["ffn2"]["w"])
    return x


def supertonic_phases(checks, dev, gen, card, err, ms, plain_ms, library_ms, bounds) -> dict:
    """Phases 19-22: kernel 10 against its plain version at full width,
    Supertonic TTS behind TtsEngine (the 2 and 3 settings) fused and unfused,
    the timings, and SupertonicOnnx on the fixtures. Returns the launch
    counts of the TTS main path."""
    import dataclasses

    import numpy as np
    import torch

    from lele_tpu_torch import kernels as K
    from lele_tpu_torch.models import SupertonicConfig, SupertonicOnnx, SupertonicTts
    from lele_tpu_torch.models.supertonic import init_vector_estimator
    from lele_tpu_torch.params import tree_map
    from lele_tpu_torch.serving import TtsEngine, encode_wav
    from lele_tpu_torch.utils.wav import decode_wav_bytes

    cfg = dataclasses.replace(SupertonicConfig.from_json(EXAMPLES / "supertonic" / "tts.json"),
                              fused_estimator=True)
    D, H, F = cfg.d_text, cfg.n_heads, cfg.d_text * cfg.ffn_mult
    n_blocks = 2 * cfg.n_est_layers

    banner(f"== 19. kernel 10 (est_block) vs plain: D {D}, {H} heads, F {F}, {n_blocks} blocks")
    stacked = init_vector_estimator(gen, cfg)["blocks_stacked"]
    for name, sub in stacked.items():  # norms and biases away from 1 and 0
        for leaf, v in sub.items():
            if v.dtype == torch.float32:
                v.add_(0.1 * torch.randn(v.shape, generator=gen, device=dev))
    est_in = {}
    for T, Tk, tv, tkv in EST_SHAPES:
        x = torch.randn((T, D), generator=gen, device=dev)
        text = torch.randn((Tk, D), generator=gen, device=dev)
        lm, tm = torch.zeros((T,), device=dev), torch.zeros((Tk,), device=dev)
        lm[:tv], tm[:tkv] = 1.0, 1.0
        est_in[T] = (x, text, lm, tm)
        got = K.estimator_blocks(x, text, lm, tm, stacked, H)
        ref = K.estimator_blocks_plain(x, text, lm, tm, stacked, H)
        torch.cuda.synchronize()
        d, scale, mean = compare(got, ref)
        err["est_block"] = max(err["est_block"], d)
        corr = torch.corrcoef(torch.stack([got.ravel(), ref.ravel()]))[0, 1].item()
        checks.require(bool(torch.isfinite(got).all()) and d <= EST_TOL * scale,
                       f"est_block T={T} Tk={Tk} (valid {tv}, {tkv}): max|d| {d:.3e} <= "
                       f"2^-8 * {scale:.3e}; mean|d| {mean:.2e} std, corr {corr:.7f}")
        call = lambda a=(x, text, lm, tm): K.estimator_blocks(*a, stacked, H)  # noqa: E731
        checks.require(torch.equal(got, call()) and graph_same_bits(call),
                       f"est_block T={T} Tk={Tk}: a repeat call and a CUDA-graph replay give "
                       "the eager call's bits")

    banner("== 20. main path: TtsEngine.synthesize (Supertonic 2 and 3 settings), fused")
    tts2 = SupertonicTts(cfg, device=dev)
    tts2.init(SEED)
    sizes = []
    tree_map(lambda t: sizes.append(t.numel()),
             {k: {kk: vv for kk, vv in sub.items() if kk != "blocks_stacked"}
              for k, sub in tts2.params.items()})
    n_params = sum(sizes)
    print(f"  model: {n_params / 1e6:.2f} M f32 parameters, {cfg.n_text_layers} text layers, "
          f"{cfg.n_est_layers} estimator layers, {cfg.flow_steps} flow steps")
    cfg3 = dataclasses.replace(cfg, apply_latent_denorm=False, speed=1.05)
    tts3 = SupertonicTts(cfg3, params=tts2.params, device=dev)
    engines = {"v2": TtsEngine(tts=tts2), "v3": TtsEngine(tts=tts3)}
    engines["v2"].load_style(str(EXAMPLES / "supertonic" / "voice_styles" / "F1.json"), "F1")
    engines["v3"].load_style(str(EXAMPLES / "supertonic3" / "voice_styles" / "M2.json"), "M2")
    from lele_tpu_torch.models import prepare_chunks

    n_chunks = len(engines) * sum(len(prepare_chunks(t)) for t in TTS_TEXTS)
    K.reset_launch_counts()
    before = sum(eng.tts.dispatches for eng in engines.values())
    wavs = {(v, i): eng.synthesize(t, seed=i)
            for v, eng in engines.items() for i, t in enumerate(TTS_TEXTS)}
    torch.cuda.synchronize()
    tts_launches = K.launch_counts()
    dispatches = sum(eng.tts.dispatches for eng in engines.values()) - before
    progs = [p for eng in engines.values() for p in eng.tts.programs._progs.values()]
    print(f"  launch counts over {len(wavs)} requests ({n_chunks} chunks, {dispatches} synth "
          f"programs run, {len(progs)} programs captured): {tts_launches}")
    checks.require(tts_launches["est_block"] == cfg.flow_steps * dispatches
                   and n_chunks <= dispatches <= 2 * n_chunks
                   and sum(tts_launches.values()) == tts_launches["est_block"],
                   f"est_block {cfg.flow_steps} times a synth program, no other kernel")
    checks.require(bool(progs) and all(p.graph is not None for p in progs),
                   f"TtsEngine.synthesize ran through {len(progs)} captured programs "
                   "(one a (kind, token bucket, latent bucket))")
    for (v, i), data in wavs.items():
        eng = engines[v]
        pcm, sr = decode_wav_bytes(data)
        un = dataclasses.replace(eng.tts, cfg=dataclasses.replace(eng.tts.cfg,
                                                                  fused_estimator=False))
        fused = eng.tts.synthesize(TTS_TEXTS[i], next(iter(eng.styles.values())), seed=i)
        ref = un.synthesize(TTS_TEXTS[i], next(iter(eng.styles.values())), seed=i)
        corr = float(np.corrcoef(fused, ref)[0, 1]) if len(ref) == len(fused) else 0.0
        rel = float(np.abs(fused - ref).max() / np.abs(ref).max()) if corr else float("inf")
        same = len(pcm) == len(fused) and np.abs(pcm - fused).max() <= 1.0 / 32767 + 1e-6
        checks.require(sr == cfg.sample_rate and same and len(pcm) % cfg.hop == 0
                       and np.isfinite(pcm).all() and corr > TTS_CORR and rel <= TTS_REL,
                       f"{v} request {i}: {len(pcm)} samples at {sr} Hz "
                       f"({len(pcm) / sr:.2f} s); fused vs unfused corr {corr:.6f} > "
                       f"{TTS_CORR}, max|d|/max|ref| {rel:.3e} <= {TTS_REL:g}")

    banner(f"== 21. TTS timings (CUDA events and host clock, median of warm runs; {card})")
    lib_blocks = est_library_blocks(stacked)
    for T, Tk, _, _ in EST_SHAPES[:2]:
        args = est_in[T]
        a = time_ms(lambda: K.estimator_blocks(*args, stacked, H))
        b = time_ms(lambda: K.estimator_blocks_plain(*args, stacked, H), runs=5)
        c = time_ms(lambda: est_blocks_library(*args, lib_blocks, H))
        lib_d = (est_blocks_library(*args, lib_blocks, H).float()
                 - K.estimator_blocks(*args, stacked, H)).abs().max().item()
        b_ms, b_by = est_bound(T, Tk, D, F, n_blocks)
        print(f"  est_block T={T} Tk={Tk}: kernel {a:.4f} ms, plain {b:.4f} ms, library "
              f"composite (bf16 addmm/layer_norm/SDPA/gelu) {c:.4f} ms (max|d| vs kernel "
              f"{lib_d:.2e}); bound {b_ms * 1e3:.2f} us by {b_by}, kernel at "
              f"{100 * b_ms / a:.2f}% of it  ({card})")
        d_k, g_k = device_times(lambda: K.estimator_blocks(*args, stacked, H))
        print(f"    device {fmt_us(d_k)} by the profiler, {g_k:.2f} us in a CUDA graph  "
              f"({card})")
        if T == SYNTH_FRAMES[-1][0]:
            ms["est_block"], plain_ms["est_block"], library_ms["est_block"] = a, b, c
            bounds["est_block"] = (b_ms, b_by)
            DEVICE_US["est_block"] = {"device_us": d_k, "graph_us": g_k}
    un2 = dataclasses.replace(tts2, cfg=dataclasses.replace(cfg, fused_estimator=False))
    style = engines["v2"].styles["F1"]
    st_ttl = torch.as_tensor(style["ttl"], device=dev)[None]
    for T, Tk in SYNTH_FRAMES:
        ids = torch.randint(0, cfg.vocab_size, (1, Tk), generator=gen, device=dev)
        tmask = torch.ones((1, Tk), device=dev)
        lmask = torch.ones((1, T), device=dev)
        audio_ms = T * cfg.hop / cfg.sample_rate * 1e3
        for name, m in (("fused", tts2), ("unfused", un2)):
            t_h = host_ms(lambda: (m.synth_core(ids, tmask, st_ttl, lmask),
                                   torch.cuda.synchronize()))
            t_d = time_ms(lambda: m.synth_core(ids, tmask, st_ttl, lmask), runs=5)
            print(f"  synth core {name} T={T} ({audio_ms / 1e3:.2f} s of audio) Tk={Tk}: "
                  f"{t_h:.3f} ms host clock (RTF {t_h / audio_ms:.2e}), {t_d:.3f} ms CUDA "
                  f"events  ({card})")
        if T == SYNTH_FRAMES[-1][0]:
            profile_top(lambda: tts2.synth_core(ids, tmask, st_ttl, lmask),
                        f"fused synth core T={T}", card, n=2, top=15)
            profile_top(lambda: un2.synth_core(ids, tmask, st_ttl, lmask),
                        f"unfused synth core T={T}", card, n=2, top=8)
        register_synth(f"Supertonic synth program T={T} Tk={Tk} (kernel 10 five times)", tts2,
                       T, Tk, gen)
    for i, text in enumerate(TTS_TEXTS):
        n = len(decode_wav_bytes(wavs[("v2", i)])[0])
        t_h = host_ms(lambda: engines["v2"].synthesize(text, seed=i))
        t_u = host_ms(lambda: (tts2.synthesize_uncaptured(text, style, seed=i),
                               torch.cuda.synchronize()))
        print(f"  TtsEngine.synthesize request {i} ({len(text)} chars, {n / cfg.sample_rate:.2f} "
              f"s of audio): {t_h:.3f} ms host clock (RTF "
              f"{t_h / (n / cfg.sample_rate * 1e3):.2e}); uncaptured {t_u:.3f} ms  ({card})")

    ema = tts2._fpt_ema  # the rate the requests above taught the bucket guess

    def engine_wave(i):
        tts2._fpt_ema = ema  # the same bucket guesses on both paths
        return decode_wav_bytes(engines["v2"].synthesize(TTS_TEXTS[i], seed=i))[0]

    def uncaptured_wave(i):
        tts2._fpt_ema = ema
        wave = tts2.synthesize_uncaptured(TTS_TEXTS[i], style, seed=i)
        return decode_wav_bytes(encode_wav(wave, cfg.sample_rate))[0]

    register("TtsEngine.synthesize, Supertonic 2 settings (a synth program a chunk, kernel 10 "
             "five times a program)", engine_wave, uncaptured_wave)

    banner("== 22. SupertonicOnnx on fixtures/supertonic_{dp,te,ve,voc}.onnx")
    fio = dict(np.load(FIXTURES / "supertonic_io.npz"))
    t0 = time.perf_counter()
    st = SupertonicOnnx(FIXTURES, device=dev)
    print(f"  four compiles in {time.perf_counter() - t0:.2f} s")
    K.reset_launch_counts()
    outs = {"durations": st.dp.run_np(fio["ids"], fio["style"], fio["mask"])[0],
            "te_out": st.te.run_np(fio["ids"], fio["style"], fio["mask"])[0],
            "v": st.ve.run_np(fio["xt"], fio["text_emb"], fio["style"], fio["t_step"])[0],
            "wave": st.voc.run_np(fio["xt"])[0]}
    n = fio["xt"].shape[-1]
    args = (fio["ids"], fio["style"], fio["mask"])
    dur, wave_d = st.synthesize_latent(*args, latent_len=n, seed=1)
    dur_h, wave_h = st.synthesize_latent_hostloop(*args, latent_len=n, seed=1)
    checks.require(sum(K.launch_counts().values()) == 0, "SupertonicOnnx launches no kernel")
    for key, got in outs.items():
        d = float(np.abs(got - fio[key]).max())
        checks.require(got.shape == fio[key].shape and d <= 2e-4,
                       f"compiled {key} {got.shape} vs supertonic_io.npz: max|d| {d:.2e} <= 2e-4")
    d = float(np.abs(wave_d - wave_h).max())
    checks.require(wave_d.shape == fio["wave"].shape and np.isfinite(wave_d).all() and d <= 1e-5
                   and np.abs(dur - dur_h).max() <= 1e-6,
                   f"synthesize_latent {wave_d.shape} vs the host loop: max|d| {d:.2e} <= 1e-5")
    t_d = host_ms(lambda: st.synthesize_latent(*args, latent_len=n, seed=1))
    t_hl = host_ms(lambda: st.synthesize_latent_hostloop(*args, latent_len=n, seed=1))
    fused = st.fused(n)
    emb = st._emb_shape()
    noises = [torch.from_numpy(st._noise(emb[1], n, seed)).to(dev) for seed in (1, 2)]
    t_u = host_ms(lambda: (fused.uncaptured(*args, noises[0]), torch.cuda.synchronize()))
    checks.require(len(fused.programs) == 1,
                   "SupertonicOnnx.synthesize_latent is one captured program (dp, te, five "
                   "estimator walks and the vocoder)")
    print(f"  synthesize_latent (fixture size, {n} latent frames): {t_d:.3f} ms host clock; "
          f"uncaptured composed pipeline {t_u:.3f} ms; host loop {t_hl:.3f} ms  ({card})")
    register("SupertonicOnnx.synthesize_latent, the four graphs composed into one program "
             "(no kernel)", lambda i: st.synthesize_latent(*args, latent_len=n, seed=i + 1),
             lambda i: fused.uncaptured(*args, noises[i]), programs=fused.programs)
    return tts_launches


def register_synth(label: str, tts, T: int, Tk: int, gen) -> None:
    """The two-dispatch route's synth program at latent bucket T and token
    bucket Tk (`synth_fn`, as `synthesize` runs it) on two inputs of the
    bucket (the second with a shorter latent mask), against its function
    run eagerly."""
    import torch

    cfg, dev = tts.cfg, tts.device
    inputs = []
    for i in range(2):
        ids = torch.randint(0, cfg.vocab_size, (1, Tk), generator=gen, device=dev)
        lmask = torch.zeros((1, T), device=dev)
        lmask[:, :T - 37 * i] = 1.0
        style = torch.randn((2, cfg.d_style), generator=gen, device=dev)
        inputs.append((ids, torch.ones((1, Tk), device=dev), style[0], style[1], lmask,
                       tts.noise(i)[:, :T]))
    register(label, lambda i: tts.programs.run(("synth", Tk, T), lambda: tts.synth_fn(T),
                                               *inputs[i], params=tts.params),
             lambda i: tts.synth_fn(T)(*inputs[i]), programs=tts.programs)


def flash_oracle(q, k, v, bias, causal, scale):
    """f64 attention computed a (batch, head) block at a time on the card."""
    import torch

    B, H, Lq, D = q.shape
    rep = H // k.shape[1]
    out = torch.empty(q.shape, dtype=torch.float64, device=q.device)
    keep = torch.ones((Lq, k.shape[2]), dtype=torch.bool, device=q.device).tril()
    for b in range(B):
        for h in range(H):
            s = (q[b, h].double() @ k[b, h // rep].double().T) * scale
            if bias is not None:
                s = s + bias[b, h].double()
            if causal:
                s = s.masked_fill(~keep, float("-inf"))
            out[b, h] = torch.softmax(s, dim=-1) @ v[b, h // rep].double()
    return out


def flash_inputs(shape, dev, gen):
    """(q, k, v, mask, scale) of one FLASH_SHAPES case, from gen on dev."""
    import numpy as np
    import torch

    from lele_tpu_torch.onnx.synth import attn23_step_feeds

    B, H, KVH, Lq, Lk, D, causal, kind = shape
    q = torch.randn((B, H, Lq, D), generator=gen, device=dev)
    k = torch.randn((B, KVH, Lk, D), generator=gen, device=dev)
    v = torch.randn((B, KVH, Lk, D), generator=gen, device=dev)
    mask = None
    if kind in ("float", "float_inf"):
        mask = 2 * torch.randn((B, 1, Lq, Lk), generator=gen, device=dev)
        if kind == "float_inf":  # dead key tiles 4-7 past q tile 0, and a sprinkle
            mask[:, :, 64:, 256:] = float("-inf")
            mask[torch.rand(mask.shape, generator=gen, device=dev) < 0.05] = float("-inf")
            mask[..., 0] = 0.0  # no row is all -inf
    elif kind in ("bool", "bool_dead"):
        mask = torch.rand((B, 1, Lq, Lk), generator=gen, device=dev) > 0.3
        if kind == "bool_dead":
            mask[..., Lk // 2:] = False  # dead key tiles for every q tile ...
        mask[0, 0, 3] = False  # ... and a fully masked row: the uniform average of v
    elif kind in ("prefill", "chunked"):
        start = 0 if kind == "prefill" else Lq
        mask = torch.from_numpy(attn23_step_feeds(np.zeros((B, Lq), np.int64), start,
                                                  Lk)["mask"]).to(dev)
    return q, k, v, mask, 1.0 / D ** 0.5


def flash_oracle_bias(mask, shape):
    """The f64 oracle's bias: a float mask as it is; a bool mask's False
    entries weigh nothing, and a row with no True entry among the keys
    causal leaves averages them uniformly, as -1e9 does in f32."""
    import torch

    from lele_tpu_torch.kernels.flash_attention import mask_bias

    B, H, KVH, Lq, Lk, D, causal, kind = shape
    if mask is None or mask.dtype != torch.bool:
        return mask_bias(mask, (B, H, Lq, Lk))
    seen = mask & torch.ones((Lq, Lk), dtype=torch.bool, device=mask.device).tril() \
        if causal else mask
    bias = torch.where(mask, 0.0, float("-inf"))
    bias = torch.where(~seen.any(-1, keepdim=True), -1e300, bias.double())
    return bias.expand(B, H, Lq, Lk)


def flash_check(shape, dev, gen) -> dict:
    """Kernel 12 against its plain version and the f64 oracle at one
    FLASH_SHAPES case, with the key tiles it visited against those the plain
    skip test leaves: {"ok", "what", "max_abs", "inputs", "visited", ...}."""
    import torch

    from lele_tpu_torch import kernels as K
    from lele_tpu_torch.kernels.flash_attention import skippable_tiles

    B, H, KVH, Lq, Lk, D, causal, kind = shape
    q, k, v, mask, scale = flash_inputs(shape, dev, gen)
    got = K.flash_attention(q, k, v, mask, causal, scale)
    visits = K.flash_attention.last_visits.clone()
    ref = K.flash_attention_plain(q, k, v, mask, causal, scale)
    torch.cuda.synchronize()
    exact = flash_oracle(q, k, v, flash_oracle_bias(mask, shape), causal, scale)
    mag = exact.abs().max().item()
    e_k = (got.double() - exact).abs().max().item() / mag
    e_p = (ref.double() - exact).abs().max().item() / mag
    d, rmax, _ = compare(got, ref)
    nq, nk = Lq // 64, Lk // 64
    reach = torch.ones((nq, nk), dtype=torch.bool, device=dev)
    if causal:
        reach = reach.tril()
    total = B * H * int(reach.sum())
    dead = int(skippable_tiles(q, k, mask, causal, scale).sum())
    visited = int(visits.sum())
    ok = (bool(torch.isfinite(got).all()) and e_k <= 2e-2 and e_k <= 3 * max(e_p, 1e-6)
          and d <= FLASH_REL * rmax and visited == total - dead)
    what = (f"flash_attn B={B} H={H}/{KVH} Lq={Lq} Lk={Lk} D={D} causal={causal} "
            f"mask={kind}: vs f64 {e_k:.2e} (plain {e_p:.2e}; <= 2e-2 and "
            f"<= 3 x max(plain, 1e-6)); vs plain max|d| {d:.2e} <= {FLASH_REL:g} * "
            f"{rmax:.3e}; key tiles visited {visited} of {total} ({total - visited} "
            f"skipped; the plain skip test marks {dead})")
    return {"ok": ok, "what": what, "max_abs": d, "inputs": (q, k, v, mask, scale),
            "got": got}


def flash_bound(q, k, mask, causal, scale) -> tuple[float, str, float, int]:
    """Kernel 12: q, k, v and the mask read once, out written once; 3 TF32
    products (3xTF32) of 4·D operations for each (query, key) pair whose
    term can be non-zero: the kernel's exact test at the pair's granularity
    (skippable_tiles, tile=1: at Phi-3's prefill the mask's 0 entries),
    under causal's triangle. Returns (ms, what bounds it, the all-pairs
    figure: every pair in f32 on the CUDA cores, in ms, live pairs)."""
    import torch

    from lele_tpu_torch.kernels.flash_attention import skippable_tiles

    B, H, Lq, D = q.shape
    KVH, Lk = k.shape[1], k.shape[2]
    rep = H // KVH
    live = 0
    for h in range(H):  # a head at a time: the pair test holds Lq x Lk float64s
        m = mask
        if m is not None and m.dim() == 4 and m.shape[1] > 1:
            m = m[:, h:h + 1]
        dead = skippable_tiles(q[:, h:h + 1], k[:, h // rep:h // rep + 1], m, causal, scale,
                               tile=1)
        if causal:
            dead |= ~torch.ones((Lq, Lk), dtype=torch.bool, device=q.device).tril()
        live += int((~dead).sum())
    mask_bytes = 0 if mask is None else mask.numel() * mask.element_size()
    n_bytes = 4 * (2 * B * H * Lq * D + 2 * B * KVH * Lk * D) + mask_bytes
    b_ms, b_by = bound(n_bytes, {"tf32": 3 * 4 * D * live})
    pairs = B * H * (Lq * (Lq + 1) // 2 if causal else Lq * Lk)
    old_ms, _ = bound(n_bytes, {"f32": 4 * D * pairs})
    return b_ms, b_by, old_ms, live


def llm_phases(checks, dev, gen, card, err, ms, plain_ms, library_ms, bounds) -> dict:
    """Phases 23-24: kernel 12 against its plain version and an f64 oracle,
    then the opset-23 LLM slice end to end at Phi-3-mini width: prefill on
    kernel 12, greedy decode through the static cache, against the same
    requests on a plain-Attention compile. Returns the launch counts of the
    slice's main path."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from lele_tpu_torch import kernels as K
    from lele_tpu_torch.compiler import compile_model
    from lele_tpu_torch.onnx.loader import OnnxModel
    from lele_tpu_torch.onnx.synth import (
        PHI3_MINI,
        attn23_decoder_params,
        attn23_step_feeds,
        build_attn23_decoder,
    )
    from lele_tpu_torch.ops import attention_ops

    cfg = dict(PHI3_MINI, layers=LLM_LAYERS)
    L = cfg["l_max"]
    banner("== 23. kernel 12 (flash_attn) vs plain and an f64 oracle")
    for shape in FLASH_SHAPES:
        B, H, KVH, Lq, Lk, D, causal, kind = shape
        res = flash_check(shape, dev, gen)
        err["flash_attn"] = max(err["flash_attn"], res["max_abs"])
        checks.require(res["ok"], res["what"])
        if (B, H, Lq, D) in FLASH_TIMED:
            q, k, v, mask, scale = res["inputs"]
            fn = lambda: K.flash_attention(q, k, v, mask, causal, scale)  # noqa: E731
            a = time_ms(fn)
            g_k = graph_us(fn)
            b = time_ms(lambda: K.flash_attention_plain(q, k, v, mask, causal, scale), runs=5)
            sdpa_mask = None if mask is None else mask.expand(B, H, Lq, Lk)
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q, k, v, attn_mask=sdpa_mask, is_causal=causal, scale=scale)
            c = time_ms(lib)
            g_l = graph_us(lib)
            lib_d = (lib() - res["got"]).abs().max().item()
            b_ms, b_by, old_ms, live = flash_bound(q, k, mask, causal, scale)
            pairs = B * H * (Lq * (Lq + 1) // 2 if causal else Lq * Lk)
            print(f"  flash_attn B={B} H={H} Lq={Lq} Lk={Lk} D={D} causal={causal}: kernel "
                  f"{a:.4f} ms ({g_k:.2f} us in a CUDA graph), plain {b:.4f} ms, "
                  f"F.scaled_dot_product_attention (f32, TF32 off) {c:.4f} ms ({g_l:.2f} us "
                  f"in a CUDA graph; max|d| vs kernel {lib_d:.2e}); bound {b_ms * 1e3:.2f} us "
                  f"by {b_by} ({live} live pairs of {pairs}, 3xTF32 at 495 TFLOP/s), kernel "
                  f"at {100 * b_ms / a:.2f}% of it; the all-pairs bound (every pair, f32 "
                  f"CUDA cores) {old_ms * 1e3:.2f} us  ({card})")
            if Lq == 1920:
                ms["flash_attn"], plain_ms["flash_attn"], library_ms["flash_attn"] = a, b, c
                bounds["flash_attn"] = (b_ms, b_by)
                DEVICE_US["flash_attn"] = {"graph_us": g_k, "library_graph_us": g_l}
            del q, k, v, mask
        del res

    banner(f"== 24. main path: the opset-23 decoder at Phi-3-mini width ({LLM_LAYERS} of "
          f"{PHI3_MINI['layers']} layers), prefill on kernel 12, greedy decode")
    t0 = time.perf_counter()
    params = attn23_decoder_params(np.random.default_rng(SEED), cfg)
    n_params = sum(a.size for a in params.values())
    graph = build_attn23_decoder(params, "S", cfg)
    del params
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    model = OnnxModel.from_bytes(graph)
    t_load = time.perf_counter() - t0
    t0 = time.perf_counter()
    steps = {s: compile_model(model, dim_values={"S": s}, device=dev, strict=True)
             for s in (*LLM_PROMPTS, 1)}
    t_trace = time.perf_counter() - t0
    refs = {s: compile_model(model, dim_values={"S": s}, device=dev, strict=True,
                             overrides={"Attention": attention_ops.attention_plain})
            for s in (*LLM_PROMPTS, 1)}
    print(f"  graph: {n_params / 1e6:.1f} M f32 parameters, {len(graph) / 1e6:.1f} MB; "
          f"weights and bytes built in {t_build:.2f} s, loaded in {t_load:.2f} s, traced "
          f"for S = {(*LLM_PROMPTS, 1)} in {t_trace:.2f} s (and again with the plain "
          f"Attention)")
    del graph
    cache_shape = (cfg["batch"], cfg["kv_heads"], L, cfg["head_dim"])
    prompts = {n: np.random.default_rng(SEED + n).integers(0, cfg["vocab"], (1, n))
               for n in LLM_PROMPTS}

    def step(cm, ids, start, caches):
        feeds = {key: torch.from_numpy(a).to(dev)
                 for key, a in attn23_step_feeds(ids, start, L).items()}
        outs = cm(**feeds, **caches)
        return outs[0], {f"c{kv}{i}": outs[1 + 2 * i + (kv == "v")]
                         for i in range(cfg["layers"]) for kv in "kv"}

    def request(n, models, forced=None):
        """One prompt of n tokens and LLM_DECODE greedy steps (or the tokens
        `forced`): (logits of each step, tokens, launches a step)."""
        caches = {f"c{kv}{i}": torch.zeros(cache_shape, device=dev)
                  for i in range(cfg["layers"]) for kv in "kv"}
        ids, start, logits, toks, launches = prompts[n], 0, [], [], []
        for j in range(LLM_DECODE + 1):
            before = K.flash_attention.launches
            out, caches = step(models[ids.shape[1]], ids, start, caches)
            launches.append(K.flash_attention.launches - before)
            logits.append(out[0])
            start += ids.shape[1]
            tok = int(out[0, -1].argmax()) if forced is None else forced[j]
            toks.append(tok)
            ids = np.array([[tok]], np.int64)
        return logits, toks, launches

    K.reset_launch_counts()
    routes0 = dict(attention_ops.ATTENTION_ROUTES)
    runs = {n: request(n, steps) for n in LLM_PROMPTS}
    torch.cuda.synchronize()
    llm_launches = K.launch_counts()
    routes = {r: attention_ops.ATTENTION_ROUTES[r] - routes0[r] for r in routes0}
    print(f"  launch counts over {len(LLM_PROMPTS)} requests: {llm_launches}; Attention "
          f"routes {routes}")
    per_step = {n: r[2] for n, r in runs.items()}
    checks.require(llm_launches["flash_attn"] == LLM_LAYERS * len(LLM_PROMPTS)
                   and sum(llm_launches.values()) == llm_launches["flash_attn"]
                   and all(p[0] == LLM_LAYERS and not any(p[1:]) for p in per_step.values())
                   and routes["einsum"] == LLM_LAYERS * LLM_DECODE * len(LLM_PROMPTS),
                   f"kernel 12 {LLM_LAYERS} times a prefill, 0 a decode step (einsum route), "
                   f"no other kernel: per step {per_step}")
    for n, (logits, toks, _) in runs.items():
        ref_logits, _, _ = request(n, refs, forced=toks)
        worst, rows = 0.0, 0
        ok = True
        for got, ref in zip(logits, ref_logits):
            d = (got - ref).abs().max().item()
            rel = d / ref.abs().max().item()
            worst = max(worst, rel)
            rows += got.shape[0]
            ok = ok and bool(torch.isfinite(got).all()) and rel <= LLM_REL
        checks.require(ok and logits[0].shape == (n, cfg["vocab"]),
                       f"request {n} tokens + {LLM_DECODE} steps ({rows} logit rows of "
                       f"{cfg['vocab']}): kernel route vs plain-Attention compile, worst "
                       f"max|d|/max|ref| {worst:.2e} <= {LLM_REL:g}; tokens {toks[:6]}...")

    def llm_inputs(n, start, seed):
        zeros = {f"c{kv}{i}": torch.zeros(cache_shape, device=dev)
                 for i in range(cfg["layers"]) for kv in "kv"}
        ids = np.random.default_rng(seed).integers(0, cfg["vocab"], (1, n))
        return {**{key: torch.from_numpy(a).to(dev)
                   for key, a in attn23_step_feeds(ids, start, L).items()}, **zeros}

    register_cm(f"opset-23 prefill of {LLM_PROMPTS[0]} tokens (kernel 12 once a layer)",
                steps[LLM_PROMPTS[0]], [llm_inputs(LLM_PROMPTS[0], 0, s) for s in (1, 2)],
                rel=LLM_REL)
    register_cm("opset-23 decode step (the einsum path, no kernel)", steps[1],
                [llm_inputs(1, start, s) for start, s in ((7, 3), (900, 4))], rel=LLM_REL)
    banner(f"== 24b. LLM timings (CUDA events and host clock, median of warm runs; {card})")
    for n in LLM_PROMPTS:
        ids = prompts[n]
        caches = {f"c{kv}{i}": torch.zeros(cache_shape, device=dev)
                  for i in range(cfg["layers"]) for kv in "kv"}
        feeds = {key: torch.from_numpy(a).to(dev)
                 for key, a in attn23_step_feeds(ids, 0, L).items()}
        t_d = time_ms(lambda: steps[n](**feeds, **caches), runs=5)
        t_h = host_ms(lambda: (step(steps[n], ids, 0, caches), torch.cuda.synchronize()))
        t_r = time_ms(lambda: refs[n](**feeds, **caches), runs=5)
        _, caches = step(steps[n], ids, 0, caches)
        tok = np.array([[int(runs[n][1][0])]], np.int64)

        def decode_all():
            c, start = caches, n
            for _ in range(LLM_DECODE):
                _, c = step(steps[1], tok, start, c)
                start += 1
            torch.cuda.synchronize()

        t_dec = host_ms(decode_all, runs=3) / LLM_DECODE
        print(f"  prompt {n} tokens: prefill {t_d:.3f} ms CUDA events, {t_h:.3f} ms host clock "
              f"(plain-Attention compile {t_r:.3f} ms); decode {t_dec:.3f} ms a token (host "
              f"clock, {LLM_DECODE} steps at positions {n}-{n + LLM_DECODE - 1})  ({card})")
        if n == LLM_PROMPTS[-1]:
            profile_top(lambda: steps[n](**feeds, **caches), f"prefill of {n} tokens", card,
                        n=2, top=12)
    return llm_launches


I8_PAIRS = ((512, 1536), (512, 512), (512, 2048), (2048, 512))  # a layer's four linears
# (M, K, N): the path's pairs at 1 s (M = 21), 10 s (171), a batch of 4 in
# the 10 s bucket (684) and the per-op graph's 10 s bucket (196), that
# graph's int8 head, decode rows, JAX's ragged shapes, the TPU scripts' squares
I8_SHAPES = (*((m, k, n) for m in (21, T_MAIN, 4 * T_MAIN, T_DQL) for k, n in I8_PAIRS),
             (T_DQL, 512, 25055), (1, 512, 2048), (1, 2048, 512), (50, 70, 30), (37, 70, 30),
             (1024, 1024, 1024), (2048, 2048, 2048))
# timed: the dynamic-int8 request's four linears at 10 s, the per-op
# graph's int8 head, the TPU scripts' squares
I8_TIMED = (*((T_MAIN, k, n) for k, n in I8_PAIRS), (T_DQL, 512, 25055), (1024, 1024, 1024),
            (2048, 2048, 2048))
LONG_SECONDS = 75.0
STREAM_CHUNK = 16
# kernel 11 route vs its plain version, and kernel 5 route vs kernel 11: the
# same integer sums and the same f32 dequant, so 0 is expected
QUANT_REL = 1e-6
# MoE at f32 activations, kernel 2's f32 form vs plain: only f32 summation
# orders differ (phase 3 holds kernel 2 to 1e-5 a call), over 50 layers
MOE_F32_REL = 1e-3


def device_us(fn, n: int = 20, tries: int = 4) -> dict[str, float] | None:
    """Device time (us) a call of fn() by kernel name, from torch.profiler
    over n warm calls: the kernels' own time, where CUDA events around a
    short launch also count the host's time to issue it. The trace now and
    then loses records of short back-to-back kernels; a trace in which a
    kernel's launches are not a whole multiple of n is taken again, and
    after `tries` such traces the time is None (not measured)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        rows = device_rows(prof)
        if rows and all(c % n == 0 for _, c in rows.values()):
            return {k: us / n for k, (us, _) in rows.items()}
    return None


def graph_us(fn, n: int = 20, reps: int = 10) -> float:
    """Time a call (us) as n calls captured in one CUDA graph, replayed
    `reps` times between two CUDA events: the device's time with the gaps
    between launches, without the host's issue or a profiler attached."""
    import torch

    from lele_tpu_torch.runtime.graphs import collector_paused

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with collector_paused(), torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e3 / (n * reps)


def device_times(fn) -> tuple[float | None, float]:
    """(the profiler's device time a call, or None where no whole trace came
    back; the time a call in a CUDA graph), in us."""
    rows = device_us(fn)
    return (None if rows is None else sum(rows.values())), graph_us(fn)


def fmt_us(t: float | None) -> str:
    return "not measured" if t is None else f"{t:.2f} us"


def w8_bound(M: int, K: int, N: int) -> tuple[float, str]:
    """Kernel 2: bf16 x, the int8 weight and the f32 scales read once, the
    f32 output written once; 2·M·N·K bf16 operations."""
    return bound(M * K * 2 + K * N + N * 4 + M * N * 4, {"bf16": 2 * M * N * K})


def i8_bound(M: int, K: int, N: int) -> tuple[float, str]:
    """Kernel 11: a and b read once, the int32 output written once; 2·M·N·K
    int8 operations."""
    return bound(M * K + K * N + 4 * M * N, {"int8": 2 * M * N * K})


def slice8_phases(checks, dev, gen, card, err, ms, plain_ms, library_ms, bounds, w8_model,
                  sv_ref, inputs10, inputs10b) -> dict:
    """Phases 25-30: kernel 11 against its plain version; SenseVoice dynamic
    int8 at full width behind SenseVoiceEngine with a tokenizer, both
    routes; batch and long-form on phase 4's w8 model; MoE; streaming; the
    per-op int8 export with MatMulInteger on kernel 11. Returns the launch
    counts of the quantized main path (phase 26)."""
    import dataclasses

    import numpy as np
    import torch

    from lele_tpu_torch import kernels as K
    from lele_tpu_torch.compiler import compile_model
    from lele_tpu_torch.models import (
        SenseVoiceConfig,
        SenseVoiceModel,
        StreamConfig,
        StreamingSenseVoice,
        cast_big_params,
        prepare_quantized_params,
        prepare_w8_params,
        stack_layer_params,
    )
    from lele_tpu_torch.models.sensevoice import pad_rows
    from lele_tpu_torch.models.sensevoice_stream import init_stream_state, stream_step
    from lele_tpu_torch.ops.quant_ops import matmul_integer_plain
    from lele_tpu_torch.runtime.bucketing import pad_pcm
    from lele_tpu_torch.runtime.graphs import flatten
    from lele_tpu_torch.serving import SenseVoiceEngine, decode_wav
    from lele_tpu_torch.utils.tokenizer import CtcTokenizer, synthetic_vocab

    srng = np.random.default_rng(SEED + 8)
    banner("== 25. kernel 11 (int8_gemm) vs plain")
    a = torch.randint(-128, 128, (T_MAIN, 2048), generator=gen, device=dev, dtype=torch.int8)
    b = torch.randint(-128, 128, (2048, 512), generator=gen, device=dev, dtype=torch.int8)
    one_launch_check(checks, f"int8_gemm [{T_MAIN},2048]x[2048,512]",
                     lambda: K.int8_matmul(a, b), "dq_gemm_strip")
    checks.require(graph_same_bits(lambda: K.int8_matmul(a, b)),
                   "int8_gemm: a CUDA-graph replay gives the eager call's bits")
    for M, K_, N in I8_SHAPES:
        a = torch.randint(-128, 128, (M, K_), generator=gen, device=dev, dtype=torch.int8)
        b = torch.randint(-128, 128, (K_, N), generator=gen, device=dev, dtype=torch.int8)
        a[0, 0] = b[0, 0] = -128
        got, ref = K.int8_matmul(a, b), K.int8_matmul_plain(a, b)
        torch.cuda.synchronize()
        d = (got - ref).abs().max().item()
        err["int8_gemm"] = max(err["int8_gemm"], float(d))
        checks.require(got.dtype == torch.int32 and torch.equal(got, ref),
                       f"int8_gemm [{M},{K_}]x[{K_},{N}]: int32 equal to plain (max|d| {d})")
    layer_us = 0.0
    for M, K_, N in I8_TIMED:
        a = torch.randint(-128, 128, (M, K_), generator=gen, device=dev, dtype=torch.int8)
        b = torch.randint(-128, 128, (K_, N), generator=gen, device=dev, dtype=torch.int8)
        b8 = torch.nn.functional.pad(b, (0, -N % 8))  # _int_mm takes N % 8 == 0 only
        t_k = time_ms(lambda: K.int8_matmul(a, b))
        t_p = time_ms(lambda: K.int8_matmul_plain(a, b), runs=5)
        try:  # a yardstick only: the port never calls it
            t_l = time_ms(lambda: torch._int_mm(a, b8))
        except RuntimeError as e:
            print(f"  torch._int_mm refused [{M},{K_}]x[{K_},{N}]: {e}")
            t_l = None
        b_ms, by = i8_bound(M, K_, N)
        d_k, g_k = device_times(lambda: K.int8_matmul(a, b))
        d_l, g_l = (device_times(lambda: torch._int_mm(a, b8)) if t_l is not None
                    else (None, None))
        print(f"  int8_gemm [{M},{K_}]x[{K_},{N}]: kernel {t_k:.4f} ms, plain (f64) {t_p:.4f} "
              f"ms, torch._int_mm {t_l} ms (CUDA events around the call); device time a call "
              f"by the profiler (in a CUDA graph): kernel {fmt_us(d_k)} ({g_k:.2f} us), "
              f"torch._int_mm {fmt_us(d_l)} ({fmt_us(g_l)}); bound {b_ms * 1e3:.2f} us by "
              f"{by}, kernel's graph time at {100e3 * b_ms / g_k:.2f}% of it  ({card})")
        if M == T_MAIN:
            layer_us += g_k
        if (M, K_, N) == (T_MAIN, 512, 2048):  # ffn1 at the 10 s request: the row's numbers
            ms["int8_gemm"], plain_ms["int8_gemm"], library_ms["int8_gemm"] = t_k, t_p, t_l
            bounds["int8_gemm"] = (b_ms, by)
            DEVICE_US["int8_gemm"] = {"device_us": d_k, "graph_us": g_k,
                                      "library_device_us": d_l, "library_graph_us": g_l}
    print(f"  int8_gemm: a layer's four linears at M = {T_MAIN} {layer_us:.2f} us in CUDA graphs, "
          f"x 50 layers = {layer_us * 50 / 1e3:.3f} ms a dynamic-int8 10 s request  ({card})")

    banner("== 26. SenseVoice dynamic int8 at full width: SenseVoiceEngine with a tokenizer")
    t0 = time.perf_counter()
    qcfg = SenseVoiceConfig(quantized=True)
    qmodel = SenseVoiceModel(qcfg, device=dev)
    f32 = qmodel.init(SEED)
    qmodel.params = stack_layer_params(prepare_quantized_params(f32, drop_fp=True))
    L = qcfg.n_layers
    tok = CtcTokenizer(synthetic_vocab(qcfg.vocab_size, seed=SEED))
    print(f"  model: {L} layers, d{qcfg.d_model}, vocab {qcfg.vocab_size}, per-tensor int8 "
          f"layer weights; prepared in {time.perf_counter() - t0:.2f} s")
    pcms = [synth_speechlike(s, srng) for s in REQUEST_SECONDS]
    wavs = [wav_bytes(p) for p in pcms]
    pcms = [decode_wav(w)[0] for w in wavs]  # what the engine decodes
    engine = SenseVoiceEngine(model=qmodel, tokenizer=tok)
    K.reset_launch_counts()
    texts = [engine.recognize(w) for w in wavs]
    torch.cuda.synchronize()
    q_launches = K.launch_counts()
    n_req = len(wavs)
    for s, text in zip(REQUEST_SECONDS, texts):
        print(f"  request {s} s: {len(text)} characters: {text[:60]!r}")
        checks.require(isinstance(text, str), f"quantized request {s} s answered as text")
    print(f"  launch counts over {n_req} requests: {q_launches}")
    checks.require(q_launches["int8_gemm"] == 4 * L * n_req,
                   f"int8_gemm launched {4 * L} times a request")
    checks.require(all(v == 0 for k, v in q_launches.items() if k != "int8_gemm"),
                   "no w8, w4, dq_gemm or other kernel on the quantized path")
    pcm10 = pcms[-1]
    q_inputs = [(p[None], [n]) for p, n in (
        pad_pcm(synth_speechlike(s, np.random.default_rng(SEED + 42))) for s in (10.0, 8.5))]
    register_ids("SenseVoice dynamic int8 bucketed B = 1 (kernel 11, 200 a call), 10 s and "
                 "8.5 s", qmodel, q_inputs)
    fwd_q, fwd_qp = qmodel.forward_fn(), qmodel.forward_fn(plain=True)
    got, ref = fwd_q(qmodel.params, pcm10), fwd_qp(qmodel.params, pcm10)
    d, scale, _ = compare(got, ref)
    checks.require(tuple(got.shape) == (1, T_MAIN, qcfg.vocab_size)
                   and bool(torch.isfinite(got).all()) and d <= QUANT_REL * scale,
                   f"quantized 10 s logits kernel 11 vs plain: max|d| {d:.3e} <= "
                   f"{QUANT_REL:g} * {scale:.3e}")
    q5 = SenseVoiceModel(dataclasses.replace(qcfg, quant_pallas=True), device=dev)
    q5.params = qmodel.params
    register_ids("SenseVoice dynamic int8, quant_pallas, bucketed B = 1 (kernel 5, 200 a call)",
                 q5, q_inputs)
    engine5 = SenseVoiceEngine(model=q5, tokenizer=tok)
    K.reset_launch_counts()
    texts5 = [engine5.recognize(w) for w in wavs]
    torch.cuda.synchronize()
    q5_launches = K.launch_counts()
    print(f"  quant_pallas=True: launch counts over {n_req} requests: {q5_launches}")
    checks.require(q5_launches["dq_gemm"] == 4 * L * n_req
                   and all(v == 0 for k, v in q5_launches.items() if k != "dq_gemm"),
                   f"quant_pallas: dq_gemm {4 * L} times a request, no int8_gemm")
    fwd_5 = q5.forward_fn()
    got5 = fwd_5(q5.params, pcm10)
    d, scale, _ = compare(got5, got)
    checks.require(d <= QUANT_REL * scale and texts5 == texts,
                   f"quantized 10 s logits kernel 5 vs kernel 11 route: max|d| {d:.3e} <= "
                   f"{QUANT_REL:g} * {scale:.3e}; the same texts")
    for name, fn in (("kernel 11", fwd_q), ("kernel 5", fwd_5), ("plain", fwd_qp)):
        t_ev = time_ms(lambda: fn(qmodel.params, pcm10), runs=10)
        t_host = host_ms(lambda: (fn(qmodel.params, pcm10), torch.cuda.synchronize()), runs=3)
        print(f"  quantized forward_fn 10 s, {name} route: {t_ev:.3f} ms CUDA events (RTF "
              f"{t_ev / 1e4:.3e}), {t_host:.3f} ms host clock (RTF {t_host / 1e4:.3e})  ({card})")
    profile_top(lambda: fwd_q(qmodel.params, pcm10), "quantized 10 s forward (kernel 11)", card)

    banner("== 27. batch and long-form on the w8a16 model")
    eng8 = SenseVoiceEngine(model=w8_model)
    K.reset_launch_counts()
    ids_b = eng8.recognize_batch(wavs)
    torch.cuda.synchronize()
    b_launches = K.launch_counts()
    print(f"  recognize_batch of {n_req} (padded to 4, the 10 s bucket): {b_launches}")
    checks.require(b_launches["w8_gemm"] == 4 * L + 1 and b_launches["sanm_layer_w8"] == 0
                   and b_launches["sanm_stack_w8"] == 0,
                   f"batch: w8_gemm {4 * L + 1} times (M = {4 * T_MAIN}), no layer or stack "
                   f"kernel")
    batch, lens = w8_model.batch_inputs(pcms)

    def batch_check(label, model, batch, lens, rel_gate, agree_gate):
        got, masks = model.forward_batch_fn()(model.params, batch, lens)
        ref, _ = model.forward_batch_fn(plain=True)(model.params, batch, lens)
        d, scale, _ = compare(got, ref)
        valid = torch.cat([torch.ones_like(masks[:, :4]), masks], dim=1) > 0
        agree = (got.argmax(-1) == ref.argmax(-1))[valid].float().mean().item()
        checks.require(bool(torch.isfinite(got).all()) and d <= rel_gate * scale
                       and agree >= agree_gate,
                       f"{label} {tuple(got.shape)}: kernel vs plain max|d|/max|ref| "
                       f"{d / scale:.3e} <= {rel_gate:g}, argmax agreement {agree:.4f} >= "
                       f"{agree_gate}")

    batch_check("batch logits", w8_model, batch, lens, 5e-2, 0.98)
    register_ids("SenseVoice w8a16 batch of 3 padded to 4, 10 s bucket (kernel 2, 201 a call)",
                 w8_model, [(batch, lens), w8_model.batch_inputs(
                     [synth_speechlike(s, np.random.default_rng(SEED + 43))
                      for s in (2.0, 6.0, 9.0)])])
    for i, (p, row) in enumerate(zip(pcms, ids_b)):
        single = w8_model.transcribe_ids(p)
        same = sum(a == b for a, b in zip(row, single))
        print(f"  row {i} ({REQUEST_SECONDS[i]} s): batch {len(row)} ids, transcribe_ids "
              f"{len(single)} ids, {same} equal in place")
    long_pcm = synth_speechlike(LONG_SECONDS, srng)
    long_wav = wav_bytes(long_pcm)
    long_pcm = decode_wav(long_wav)[0]
    pieces, _ = w8_model.long_windows(long_pcm)
    K.reset_launch_counts()
    ids_long = eng8.recognize(long_wav)
    torch.cuda.synchronize()
    l_launches = K.launch_counts()
    print(f"  {LONG_SECONDS} s request: {len(pieces)} windows, {len(ids_long)} ids; "
          f"{l_launches}")
    checks.require(len(pieces) == 3 and l_launches["w8_gemm"] == 4 * L + 1
                   and l_launches["sanm_stack_w8"] == 0 and l_launches["sanm_layer_w8"] == 0,
                   f"long-form: 3 windows in one batched program (w8_gemm {4 * L + 1} times)")
    batch_check("long-form windows' logits", w8_model,
                *pad_rows(pieces, 30 * SR), 5e-2, 0.98)
    register_ids(f"SenseVoice w8a16 {LONG_SECONDS} s long-form, 3 windows of 30 s (kernel 2, "
                 f"201 a call)", w8_model, [pad_rows(pieces, 30 * SR), pad_rows(
                     w8_model.long_windows(synth_speechlike(
                         LONG_SECONDS, np.random.default_rng(SEED + 44)))[0], 30 * SR)])
    pcms4 = pcms + [decode_wav(wav_bytes(synth_speechlike(7.0, srng)))[0]]
    K.reset_launch_counts()
    qmodel.transcribe_batch(pcms4)
    torch.cuda.synchronize()
    qb = K.launch_counts()
    checks.require(qb["int8_gemm"] == 4 * L and qb["dq_gemm"] == 0,
                   f"quantized batch of 4: int8_gemm {4 * L} times at M = {4 * T_MAIN}")
    batch_check("quantized batch logits", qmodel, *qmodel.batch_inputs(pcms4), QUANT_REL, 1.0)
    # where the batch and long-form requests' device time goes (kernel 2's
    # 201 launches a request among it), beside their host time below
    profile_top(lambda: (eng8.recognize_batch(wavs), torch.cuda.synchronize()),
                f"recognize_batch of {n_req}", card, n=2, top=6)
    profile_top(lambda: (eng8.recognize(long_wav), torch.cuda.synchronize()),
                f"{LONG_SECONDS} s request", card, n=2, top=6)
    t_b = host_ms(lambda: eng8.recognize_batch(wavs), runs=3)
    t_l = host_ms(lambda: eng8.recognize(long_wav), runs=3)
    t_q = host_ms(lambda: qmodel.transcribe_batch(pcms4), runs=3)
    audio_s = sum(REQUEST_SECONDS)
    print(f"  recognize_batch of {n_req} ({audio_s:.1f} s of audio): {t_b:.3f} ms host clock "
          f"(RTF {t_b / (audio_s * 1e3):.3e}); {LONG_SECONDS} s request {t_l:.3f} ms (RTF "
          f"{t_l / (LONG_SECONDS * 1e3):.3e}); quantized batch of 4 {t_q:.3f} ms  ({card})")

    banner("== 28. MoE: SenseVoiceConfig(weight_int8=True, n_experts=8), unstacked")
    mcfg = SenseVoiceConfig(weight_int8=True, n_experts=8)
    mm = SenseVoiceModel(mcfg, device=dev)
    mm.init(SEED + 28)
    mm.params = prepare_w8_params(cast_big_params(mm.params, torch.bfloat16))
    n_moe = sum("moe" in lp for lp in mm.params["layers"])
    K.reset_launch_counts()
    ids_m = mm.transcribe_ids(pcm10)
    torch.cuda.synchronize()
    m_launches = K.launch_counts()
    print(f"  {n_moe} of {L} layers carry an MoE FFN (JAX's init gives every layer one); "
          f"10 s request: {len(ids_m)} ids; {m_launches}")
    checks.require(n_moe == L and m_launches["w8_gemm"] == 2 * L + 1
                   and m_launches["sanm_layer_w8"] == 0 and m_launches["sanm_stack_w8"] == 0,
                   f"MoE: qkv and out on w8_gemm ({2 * L} + the head), the FFN plain")
    register_ids("SenseVoice w8a16 MoE bucketed B = 1 (kernel 2, 101 a call)", mm, q_inputs)
    # top-1 routing is discontinuous: at bf16 activations a last-bit
    # difference upstream (kernel 2's summation order, then a bf16 rounding
    # in the attention) moves a near-tie token to another expert, and 50
    # MoE layers carry it. So the kernel path is held against the plain
    # path at f32 activations (the same weights; kernel 2's f32 form), where
    # both sides route alike; at bf16 the gap is printed beside the plain
    # path's own move under a 1e-7 relative step of the input
    fwd_m, fwd_mp = mm.forward_fn(), mm.forward_fn(plain=True)
    got, ref = fwd_m(mm.params, pcm10), fwd_mp(mm.params, pcm10)
    step = (pcm10 * (1 + 1e-7 * srng.standard_normal(pcm10.size))).astype(np.float32)
    noise = fwd_mp(mm.params, step)
    checks.require(bool(torch.isfinite(got).all()), "MoE 10 s logits finite")
    for label, g in (("kernel vs plain", got), ("plain at a 1e-7 input step vs plain", noise)):
        d, scale, mae = compare(g, ref)
        agree = (g.argmax(-1) == ref.argmax(-1)).float().mean().item()
        print(f"  MoE bf16 10 s logits, {label}: max|d|/max|ref| {d / scale:.3e}, mean|d| "
              f"{mae:.3e} std, argmax agreement {agree:.4f}")
    m32 = SenseVoiceModel(dataclasses.replace(mcfg, dtype="float32"), device=dev)
    got, ref = m32.forward_fn()(mm.params, pcm10), m32.forward_fn(plain=True)(mm.params, pcm10)
    d, scale, _ = compare(got, ref)
    agree = (got.argmax(-1) == ref.argmax(-1)).float().mean().item()
    checks.require(bool(torch.isfinite(got).all()) and d <= MOE_F32_REL * scale
                   and agree >= 0.99,
                   f"MoE f32 activations 10 s logits kernel vs plain: max|d|/max|ref| "
                   f"{d / scale:.3e} <= {MOE_F32_REL:g}, argmax agreement {agree:.4f} >= 0.99")
    t_m = time_ms(lambda: fwd_m(mm.params, pcm10), runs=5)
    print(f"  MoE forward_fn 10 s: {t_m:.3f} ms CUDA events (RTF {t_m / 1e4:.3e})  ({card})")
    del mm, got, ref

    banner("== 29. streaming: StreamingSenseVoice.transcribe_stream at full width (f32)")
    st = StreamingSenseVoice(cfg=SenseVoiceConfig(),
                             stream=StreamConfig(chunk_frames=STREAM_CHUNK), device=dev)
    st.params = f32
    K.reset_launch_counts()
    ids_s = st.transcribe_stream(pcm10)
    torch.cuda.synchronize()
    n_frames = st.fbank(pcm10).shape[0]
    n_chunks = -(-n_frames // STREAM_CHUNK)
    checks.require(all(0 <= i < qcfg.vocab_size for i in ids_s)
                   and all(v == 0 for v in K.launch_counts().values()),
                   f"stream: {n_chunks} chunks of {STREAM_CHUNK} frames, {len(ids_s)} ids in "
                   f"[0, vocab), no kernel")
    t_s = host_ms(lambda: st.transcribe_stream(pcm10), runs=3)
    sfeats = [st.fbank(p)[None, :STREAM_CHUNK].contiguous() for p in (pcm10, pcms[1])]
    smask = torch.ones((1, STREAM_CHUNK), device=dev)

    def stream_after(i):
        ids, state = st.decode_step_fn()(st.params, sfeats[i], smask,
                                         init_stream_state(st.cfg, st.stream, device=dev))
        return ids, flatten(state)[0]

    def stream_before(i):
        with torch.inference_mode():
            logits, state = stream_step(st.params, sfeats[i], smask,
                                        init_stream_state(st.cfg, st.stream, device=dev), st.cfg)
        return logits.argmax(-1).to(torch.int32), flatten(state)[0]

    register("StreamingSenseVoice decode step, state donated (no kernel)", stream_after,
             stream_before)
    ssess = [[st.fbank(p)[None, t * STREAM_CHUNK:(t + 1) * STREAM_CHUNK].contiguous()
              for t in range(2)] for p in (pcm10, pcms[1])]

    def stream_ref(f, state):
        with torch.inference_mode():
            logits, state = stream_step(st.params, f, smask, state, st.cfg)
        return logits.argmax(-1).to(torch.int32), state

    register("StreamingSenseVoice decode step, two sessions interleaved through one program",
             lambda i: interleaved(lambda f, s: st.decode_step_fn()(st.params, f, smask, s),
                                   ssess, [init_stream_state(st.cfg, st.stream, device=dev)
                                           for _ in range(2)], i),
             lambda i: interleaved(stream_ref, ssess,
                                   [init_stream_state(st.cfg, st.stream, device=dev)
                                    for _ in range(2)], i))
    print(f"  transcribe_stream 10 s: {t_s:.3f} ms host clock, {t_s / n_chunks:.3f} ms a chunk "
          f"of {STREAM_CHUNK * 60} ms of audio  ({card})")

    banner("== 30. MatMulInteger on kernel 11: the per-op int8 export, default vs f64 override")
    n_mmi = sum(n.op_type == "MatMulInteger" for n in sv_ref.model.graph.node)
    t_pad = max(sv_ref._cms)
    cm_ops = sv_ref._cms[t_pad]
    cm_f64 = compile_model(sv_ref.model, input_shapes={"speech": (1, t_pad, 560)}, patterns=[],
                           overrides={"MatMulInteger": matmul_integer_plain}, device=dev)
    K.reset_launch_counts()
    a = cm_ops(**inputs10)[0]
    torch.cuda.synchronize()
    o_launches = K.launch_counts()
    b = cm_f64(**inputs10)[0]
    torch.cuda.synchronize()
    checks.require(o_launches["int8_gemm"] == n_mmi
                   and all(v == 0 for k, v in o_launches.items() if k != "int8_gemm"),
                   f"per-op graph: int8_gemm once per MatMulInteger node ({n_mmi})")
    checks.require(torch.equal(a, b), f"per-op 10 s logits {tuple(a.shape)}: kernel 11 and the "
                                      f"f64 override identical")
    register_cm(f"per-op int8 SenseVoice graph 10 s (kernel 11 at its {n_mmi} MatMulInteger "
                f"nodes)", cm_ops, [inputs10, inputs10b])
    t_ops = host_ms(lambda: (cm_ops(**inputs10), torch.cuda.synchronize()), runs=3)
    t_f64 = host_ms(lambda: (cm_f64(**inputs10), torch.cuda.synchronize()), runs=3)
    print(f"  per-op 10 s forward (host clock): kernel 11 {t_ops:.3f} ms, f64 override "
          f"{t_f64:.3f} ms  ({card})")
    return q_launches


def yolo_library_maps(params, x, cfg):
    """The native network as plain bf16 F.conv2d calls, bf16 outputs,
    channels_last (XLA's SAME pads by F.pad where they are asymmetric): the
    library figure beside the port's f32-accumulating convs. x: [B, H, W, 3]
    f32 → the class and box maps, bf16 NCHW."""
    import torch
    import torch.nn.functional as F

    from lele_tpu_torch.models.common import same_pads

    def conv(p, x, stride=1):
        (hl, hh), (wl, wh) = (same_pads(x.shape[2 + i], p["w"].shape[2 + i], stride)
                              for i in range(2))
        if (hl, wl) == (hh, wh):
            return F.conv2d(x, p["w"], p["b"], stride=stride, padding=(hl, wl))
        return F.conv2d(F.pad(x, (wl, wh, hl, hh)), p["w"], p["b"], stride=stride)

    x = x.permute(0, 3, 1, 2).to(torch.bfloat16)
    x = F.silu(conv(params["stem"], x, 2))
    for st in params["stages"]:
        x = F.silu(conv(st["down"], x, 2))
        x = x + conv(st["csp"]["c2"], F.silu(conv(st["csp"]["c1"], x)))
    return conv(params["head_cls"], x), conv(params["head_box"], x)


def library_params(params):
    """bf16 channels_last weights and bf16 biases for `yolo_library_maps`."""
    import torch

    from lele_tpu_torch.params import tree_map

    def cast(t):
        t = t.to(torch.bfloat16)
        return t.contiguous(memory_format=torch.channels_last) if t.dim() == 4 else t

    return tree_map(cast, params)


def decided_ranks(conf_ref, gap: float, n_q: int) -> list[int]:
    """The ranks < n_q of the reference's descending confidences whose value
    lies more than 2·gap from both neighbours': their cell is the same
    whatever order values within `gap` of the reference's take."""
    import torch

    c = torch.sort(conf_ref, descending=True).values
    d = c[:-1] - c[1:]
    inf = torch.full((1,), float("inf"))
    ok = (torch.cat([inf, d]) > 2 * gap) & (torch.cat([d, inf]) > 2 * gap)
    return [k for k in ok.nonzero().flatten().tolist() if k < n_q]


def yolo_phases(checks, dev, card) -> None:
    """Phase 31: YOLO26 detect and segment at full width, the compiled
    fixture graph in f32 and bf16 and the native detector behind
    Yolo26Engine, each held to its reference; times. No kernel of the
    port's own runs on this path (its convs are cuDNN's)."""
    import dataclasses

    import numpy as np
    import torch

    from lele_tpu_torch.models import Yolo26Config, Yolo26Model, YoloOnnx, decode_detections
    from lele_tpu_torch.models.yolo26 import (query_indices, yolo26_forward, yolo26_head_maps,
                                              yolo26_select)
    from lele_tpu_torch.params import tree_map
    from lele_tpu_torch.serving import Yolo26Engine

    yrng = np.random.default_rng(SEED + 31)
    banner("== 31. YOLO26 detect and segment")
    print("  (a) compiled: fixtures/yolo26.onnx at 640 x 640")
    x = np.load(FIXTURES / "yolo26_input.npy")
    want_l = np.load(FIXTURES / "yolo26_logits.npy")
    want_b = np.load(FIXTURES / "yolo26_boxes.npy")
    img = yrng.integers(0, 256, (480, 640, 3), dtype=np.uint8)
    for compute in (None, "bfloat16"):
        name = compute or "float32"
        t0 = time.perf_counter()
        yo = YoloOnnx(FIXTURES / "yolo26.onnx", img_size=640, compute=compute, device=dev)
        torch.cuda.synchronize()
        compile_s = time.perf_counter() - t0
        checks.require(yo.cm._program is not None and yo.cm._program.graph is not None,
                       f"YoloOnnx {name}: the graph captured ahead of the first image "
                       f"(CompiledModel.compile)")
        logits, boxes = yo.forward(x)
        dl, db = np.abs(logits - want_l).max(), np.abs(boxes - want_b).max()
        agree = float((logits.argmax(-1) == want_l.argmax(-1)).mean())
        shapes = (logits.shape == want_l.shape and boxes.shape == want_b.shape
                  and logits.dtype == boxes.dtype == np.float32
                  and np.isfinite(logits).all() and np.isfinite(boxes).all())
        if compute is None:
            ok = shapes and dl <= YOLO_F32_GATE[0] and db <= YOLO_F32_GATE[1]
            gate = f"logits atol {YOLO_F32_GATE[0]:g}, boxes atol {YOLO_F32_GATE[1]:g}"
        else:
            la, br, ba, ag = YOLO_BF16_GATE
            ok = (shapes and dl <= la and agree >= ag
                  and np.all(np.abs(boxes - want_b) <= ba + br * np.abs(want_b)))
            gate = f"logits atol {la:g}, boxes rtol {br:g} atol {ba:g}, argmax >= {ag}"
        checks.require(ok, f"YoloOnnx {name} vs the fixture's torch outputs: logits max|d| "
                           f"{dl:.3e}, boxes {db:.3e}, argmax agreement {agree:.4f} ({gate})")
        dets = yo.detect(img, 0.0)
        checks.require(len(dets) == 300 and all(np.isfinite(d["xyxy"]).all() for d in dets),
                       f"YoloOnnx {name} detect on a u8 480x640 image: {len(dets)} queries, "
                       f"{len(yo.detect(img))} at 0.25")
        xd = torch.from_numpy(x).to(dev)
        x2 = torch.rand(xd.shape, generator=torch.Generator(device=dev).manual_seed(SEED),
                        device=dev)
        register_cm(f"YoloOnnx fixture {name} (cuDNN convs, no kernel)", yo.cm,
                    [{yo.cm.input_order[0]: v} for v in (xd, x2)], rel=YOLO_MAP_REL[name])
        ev, gr = time_ms(lambda: yo.forward_device(xd)), graph_us(lambda: yo.forward_device(xd))
        det = host_ms(lambda: yo.detect(img))
        print(f"  YoloOnnx {name}: compile and capture {compile_s:.3f} s; forward {ev:.4f} ms by events, "
              f"{gr:.2f} us in a CUDA graph; detect with preprocessing {det:.3f} ms by host "
              f"clock  ({card})")

    print("  (b) native detector and seg head, Yolo26Config() (640, widths 32-256, 80 "
          "classes, 300 queries)")
    imgs = [yrng.integers(0, 256, (480 + 16 * i, 640, 3), dtype=np.uint8)
            for i in range(1 + YOLO_BATCH)]
    for seg in (False, True):
        base = Yolo26Model(Yolo26Config(segmentation=seg), device=dev)
        base.init(SEED)
        cpu_params = tree_map(lambda t: t.cpu(), base.params)
        for dtype in ("bfloat16", "float32"):
            cfg = dataclasses.replace(base.cfg, dtype=dtype)
            label = f"{'seg' if seg else 'detect'} {dtype}"
            model = Yolo26Model(cfg, params=base.params, device=dev)
            eng = Yolo26Engine(model=model, conf_threshold=0.25)
            if not (seg and dtype == "float32"):
                xs = [eng.batch([im]) for im in imgs[:2]]  # what detect() sends
                register(f"Yolo26Engine native {label} B = 1 (cuDNN convs, no kernel)",
                         lambda i, eng=eng, xs=xs: eng.forward(xs[i]),
                         lambda i, model=model, xs=xs: model.forward_fn()(
                             model.params, torch.from_numpy(xs[i]).to(dev)),
                         rel=YOLO_MAP_REL[dtype])
            for req, batch in (("detect", imgs[:1]), (f"detect_batch of {YOLO_BATCH}", imgs[1:])):
                outs = eng.detect_batch(batch) if len(batch) > 1 else [eng.detect(batch[0])]
                n, size = len(batch), cfg.img_size
                xin = np.zeros((8 if n > 1 else 1, size, size, 3), np.float32)
                xin[:n] = [eng._to_input(im) for im in batch]
                with torch.inference_mode():
                    xd = torch.from_numpy(xin).to(dev)
                    maps = yolo26_head_maps(model.params, xd, cfg)
                    sel = yolo26_select(maps, cfg)
                    ref = yolo26_head_maps(cpu_params, torch.from_numpy(xin[:n]), cfg)
                torch.cuda.synchronize()
                rel = YOLO_MAP_REL[dtype]
                gaps, d_cls = {}, 0.0
                for k, r in ref.items():
                    d, m, _ = compare(maps[k][:n].cpu(), r)
                    gaps[k] = d / m
                    d_cls = d if k == "cls" else d_cls
                checks.require(max(gaps.values()) <= rel and all(
                    bool(torch.isfinite(v).all()) for v in maps.values()),
                    f"{label} {req}: head maps vs the CPU, max|d|/max|ref| " + ", ".join(
                        f"{k} {g:.2e}" for k, g in gaps.items()) + f" (gate {rel:g})")
                n_q = min(cfg.n_queries, (size // 2 ** len(cfg.widths)) ** 2)
                want = [(n, n_q, cfg.n_classes), (n, n_q, 4)]
                if seg:
                    want += [(n, n_q, cfg.n_mask_coeffs), (n, size // 8, size // 8, cfg.n_protos)]
                checks.require([tuple(o[:n].shape) for o in sel] == want,
                               f"{label} {req}: outputs {[tuple(o[:n].shape) for o in sel]}")
                # (c) selection: the CPU's cells wherever the order is decided.
                # A confidence (the max of a cell's class logits) moves by at
                # most the class map's max|d|, so a rank more than twice that
                # from both neighbours holds the same cell on both sides
                idx = query_indices(maps["cls"], cfg.n_queries)[:n].cpu()
                idx_ref = query_indices(ref["cls"], cfg.n_queries)
                n_dec = n_bad = 0
                for i in range(n):
                    ranks = decided_ranks(ref["cls"][i].flatten(0, 1).amax(-1), d_cls,
                                          cfg.n_queries)
                    n_dec += len(ranks)
                    n_bad += int((idx[i, ranks] != idx_ref[i, ranks]).sum())
                checks.require(n_bad == 0 and (n_dec > 0 or dtype == "bfloat16"),
                               f"{label} {req}: selection, {n_dec} of {n * cfg.n_queries} "
                               f"ranks decided (> 2 x {d_cls:.2e} from both neighbours), "
                               f"{n_bad} of them on another cell than the CPU's")
                scores, boxes = (o[:n].cpu().numpy() for o in sel[:2])
                same = all(o == decode_detections(scores[i:i + 1], boxes[i:i + 1], 0.25)
                           for i, o in enumerate(outs))
                checks.require(same, f"{label} {req}: the engine's detections are the "
                                     f"decode of these maps ({sum(map(len, outs))} kept)")
            # (d) times
            for b in (1, 8):
                xd = torch.from_numpy(np.stack([eng._to_input(im) for im in
                                                (imgs * 2)[:b]])).to(dev)

                def fwd():
                    with torch.inference_mode():
                        return yolo26_forward(model.params, xd, cfg)

                print(f"  native {label} B={b}: forward {time_ms(fwd):.4f} ms by events, "
                      f"{graph_us(fwd):.2f} us in a CUDA graph  ({card})")
                if dtype == "bfloat16" and not seg:
                    lp = library_params(model.params)
                    xl = xd.contiguous()

                    def lib():
                        with torch.inference_mode():
                            return yolo_library_maps(lp, xl, cfg)

                    with torch.inference_mode():
                        lc = lib()[0].permute(0, 2, 3, 1).float()
                        pc = yolo26_head_maps(model.params, xd, cfg)["cls"]
                    d, m, _ = compare(lc, pc)
                    print(f"  library bf16 F.conv2d network B={b}: {time_ms(lib):.4f} ms by "
                          f"events, {graph_us(lib):.2f} us in a CUDA graph; its class map vs "
                          f"the port's max|d|/max|ref| {d / m:.2e}  ({card})")
            det = host_ms(lambda: eng.detect(imgs[0]))
            bat = host_ms(lambda: eng.detect_batch(imgs[1:]), runs=3)
            print(f"  {label}: detect {det:.3f} ms, detect_batch of {YOLO_BATCH} {bat:.3f} ms "
                  f"by host clock, with preprocessing  ({card})")
            if dtype == "bfloat16":
                profile_top(lambda: eng.detect(imgs[0]), f"{label} detect request", card)


# phase 33's models, at their published widths with random weights from a
# seed: GPT-2 small (the HF `gpt2` config: 12 layers, d 768, 12 heads of 64,
# MLP 3,072, vocab 50,257, 1,024 positions) as a decoder step, and
# Whisper-tiny's decoder (HF `openai/whisper-tiny`: 4 layers, d 384, 6 heads
# of 64, MLP 1,536, vocab 51,865, 448 positions) over 1,500 encoder frames
# of 80 mel bins. Neither reaches a kernel of the port: a step is
# single-token MatMuls and Softmax
GPT2 = dict(vocab=50257, d=768, heads=12, layers=12, max_len=1024, ffn=3072)
WHISPER_TINY = dict(vocab=51865, d=384, heads=6, layers=4, max_len=448, ffn=1536,
                    frames=1500, mels=80)
DECODE_PROMPTS = (16, 9)  # phase 32's two inputs: one program for both lengths
# decode depths kept short: the whole script stays within its half-limit aim
DECODE_STEPS = 24
DECODE_TEMPERATURE = 0.8
BEAM = 4
BEAM_STEPS = 12
S2S_STEPS = 24


def step_modules():
    """(DecoderStep, S2SEncoder, S2SDecoderStep): copies of
    tests/test_torch_onnx.py's TinyDecoderStep, TinyS2SEncoder and
    TinyS2SDecoderStep (the JAX package's step-graph contract,
    lele_tpu_torch/runtime/decode.py), with the MLP width a parameter."""
    import torch
    import torch.nn as nn

    class DecoderStep(nn.Module):
        def __init__(self, vocab, d, heads, layers, max_len, ffn):
            super().__init__()
            self.d, self.H, self.L, self.hd = d, heads, layers, d // heads
            self.tok = nn.Embedding(vocab, d)
            self.posemb = nn.Embedding(max_len, d)
            self.ln1 = nn.ModuleList([nn.LayerNorm(d) for _ in range(layers)])
            self.ln2 = nn.ModuleList([nn.LayerNorm(d) for _ in range(layers)])
            self.qkv = nn.ModuleList([nn.Linear(d, 3 * d) for _ in range(layers)])
            self.proj = nn.ModuleList([nn.Linear(d, d) for _ in range(layers)])
            self.up = nn.ModuleList([nn.Linear(d, ffn) for _ in range(layers)])
            self.down = nn.ModuleList([nn.Linear(ffn, d) for _ in range(layers)])
            self.lnf = nn.LayerNorm(d)
            self.head = nn.Linear(d, vocab, bias=False)

        def forward(self, ids, pos, cache_k, cache_v, mask):
            B = ids.shape[0]
            x = self.tok(ids) + self.posemb(pos)
            nks, nvs = [], []
            for i in range(self.L):
                q, k, v = self.qkv[i](self.ln1[i](x)).split(self.d, dim=-1)
                q, k, v = (t.view(B, 1, self.H, self.hd).transpose(1, 2) for t in (q, k, v))
                nks.append(k)
                nvs.append(v)
                K = torch.cat([cache_k[i], k], dim=2)
                V = torch.cat([cache_v[i], v], dim=2)
                att = torch.softmax((q @ K.transpose(-1, -2)) / (self.hd ** 0.5) + mask, dim=-1)
                x = x + self.proj[i]((att @ V).transpose(1, 2).reshape(B, 1, self.d))
                x = x + self.down[i](torch.nn.functional.gelu(self.up[i](self.ln2[i](x))))
            return self.head(self.lnf(x))[:, 0], torch.stack(nks), torch.stack(nvs)

    class S2SEncoder(nn.Module):
        def __init__(self, feat, d, heads, dec_layers):
            super().__init__()
            self.d, self.H, self.Ld, self.hd = d, heads, dec_layers, d // heads
            self.inp = nn.Linear(feat, d)
            self.ln = nn.LayerNorm(d)
            self.ff = nn.Linear(d, d)
            self.k_proj = nn.ModuleList([nn.Linear(d, d) for _ in range(dec_layers)])
            self.v_proj = nn.ModuleList([nn.Linear(d, d) for _ in range(dec_layers)])

        def forward(self, x):
            B, Te, _ = x.shape
            h = torch.tanh(self.inp(x))
            h = h + self.ff(self.ln(h))
            ks = [p(h).view(B, Te, self.H, self.hd).transpose(1, 2) for p in self.k_proj]
            vs = [p(h).view(B, Te, self.H, self.hd).transpose(1, 2) for p in self.v_proj]
            return torch.stack(ks), torch.stack(vs)

    class S2SDecoderStep(DecoderStep):
        def __init__(self, vocab, d, heads, layers, max_len, ffn):
            super().__init__(vocab, d, heads, layers, max_len, ffn)
            self.lnx = nn.ModuleList([nn.LayerNorm(d) for _ in range(layers)])
            self.q_x = nn.ModuleList([nn.Linear(d, d) for _ in range(layers)])
            self.proj_x = nn.ModuleList([nn.Linear(d, d) for _ in range(layers)])

        def forward(self, ids, pos, cache_k, cache_v, mask, cross_k, cross_v):
            B = ids.shape[0]
            x = self.tok(ids) + self.posemb(pos)
            nks, nvs = [], []
            for i in range(self.L):
                q, k, v = self.qkv[i](self.ln1[i](x)).split(self.d, dim=-1)
                q, k, v = (t.view(B, 1, self.H, self.hd).transpose(1, 2) for t in (q, k, v))
                nks.append(k)
                nvs.append(v)
                K = torch.cat([cache_k[i], k], dim=2)
                V = torch.cat([cache_v[i], v], dim=2)
                att = torch.softmax((q @ K.transpose(-1, -2)) / (self.hd ** 0.5) + mask, dim=-1)
                x = x + self.proj[i]((att @ V).transpose(1, 2).reshape(B, 1, self.d))
                qx = self.q_x[i](self.lnx[i](x)).view(B, 1, self.H, self.hd).transpose(1, 2)
                attx = torch.softmax((qx @ cross_k[i].transpose(-1, -2)) / (self.hd ** 0.5),
                                     dim=-1)
                x = x + self.proj_x[i]((attx @ cross_v[i]).transpose(1, 2).reshape(B, 1, self.d))
                x = x + self.down[i](torch.nn.functional.gelu(self.up[i](self.ln2[i](x))))
            return self.head(self.lnf(x))[:, 0], torch.stack(nks), torch.stack(nvs)

    return DecoderStep, S2SEncoder, S2SDecoderStep


STEP_INPUTS = ["ids", "pos", "ck", "cv", "mask"]
STEP_OUTPUTS = ["logits", "nk", "nv"]


def export_onnx(m, args, inputs, outputs, batch_axes=None) -> bytes:
    """m's graph by torch.onnx.export (TorchScript, opset 17) through the
    port's `onnx` stand-in (onnx/torch_shim.py), on the CPU. `batch_axes`
    names each input's and output's batch axis, left symbolic as "B"."""
    import torch

    from lele_tpu_torch.onnx import torch_shim

    torch_shim.install()
    f = io.BytesIO()
    dyn = None if batch_axes is None else {n: {a: "B"} for n, a in batch_axes.items()}
    with torch.no_grad():
        torch.onnx.export(m.eval(), args, f, opset_version=17, dynamo=False,
                          input_names=inputs, output_names=outputs, dynamic_axes=dyn)
    return f.getvalue()


def step_zeros(B, L, H, P, hd, Te=None) -> tuple:
    """Zero inputs of the step contract at batch B (and cross K/V of Te frames)."""
    import torch

    args = [torch.zeros(B, 1, dtype=torch.long), torch.zeros(B, 1, dtype=torch.long),
            torch.zeros(L, B, H, P, hd), torch.zeros(L, B, H, P, hd),
            torch.zeros(B, 1, 1, P + 1)]
    if Te is not None:
        args += [torch.zeros(L, B, H, Te, hd), torch.zeros(L, B, H, Te, hd)]
    return tuple(args)


def gpt2_decoders(dev, cfg=GPT2, seed=SEED, beam=BEAM):
    """The GPT-2-width step exported once with a symbolic batch, compiled for
    B = 1 and B = beam → ({1: decoder, beam: decoder}, ONNX bytes)."""
    import torch

    from lele_tpu_torch.compiler import compile_model
    from lele_tpu_torch.runtime import StaticKVDecoder

    DecoderStep, _, _ = step_modules()
    torch.manual_seed(seed)
    L, H, hd, P = cfg["layers"], cfg["heads"], cfg["d"] // cfg["heads"], cfg["max_len"] - 1
    m = DecoderStep(cfg["vocab"], cfg["d"], H, L, cfg["max_len"], cfg["ffn"])
    axes = {"ids": 0, "pos": 0, "ck": 1, "cv": 1, "mask": 0, "logits": 0, "nk": 1, "nv": 1}
    bs = export_onnx(m, step_zeros(1, L, H, P, hd), STEP_INPUTS, STEP_OUTPUTS, axes)
    decs = {b: StaticKVDecoder(compile_model(bs, dim_values={"B": b}, device=dev), L, H, hd,
                               cfg["max_len"], batch=b) for b in (1, beam)}
    return decs, bs


def whisper_generator(dev, cfg=WHISPER_TINY, seed=SEED + 1):
    """Whisper-tiny's decoder widths as a Seq2SeqGenerator over an encoder
    graph of cfg["frames"] frames → (generator, source features [1, frames,
    mels])."""
    import numpy as np
    import torch

    from lele_tpu_torch.compiler import compile_model
    from lele_tpu_torch.runtime import Seq2SeqGenerator

    _, S2SEncoder, S2SDecoderStep = step_modules()
    torch.manual_seed(seed)
    L, H, hd, P = cfg["layers"], cfg["heads"], cfg["d"] // cfg["heads"], cfg["max_len"] - 1
    enc = S2SEncoder(cfg["mels"], cfg["d"], H, L)
    dec = S2SDecoderStep(cfg["vocab"], cfg["d"], H, L, cfg["max_len"], cfg["ffn"])
    src = np.random.default_rng(seed).standard_normal((1, cfg["frames"], cfg["mels"]))
    src = src.astype(np.float32)
    enc_b = export_onnx(enc, (torch.from_numpy(src),), ["src"], ["cross_k", "cross_v"])
    dec_b = export_onnx(dec, step_zeros(1, L, H, P, hd, Te=cfg["frames"]),
                        STEP_INPUTS + ["cross_k", "cross_v"], STEP_OUTPUTS)
    gen = Seq2SeqGenerator(compile_model(enc_b, device=dev), compile_model(dec_b, device=dev),
                           num_layers=L, num_heads=H, head_dim=hd, max_len=cfg["max_len"],
                           bos_id=1, eos_id=0)
    return gen, src


def beam_hostloop(dec, prompt, steps: int, eos_id: int | None = None):
    """`beam_search`'s host-loop oracle: the step graph called once a token
    (its CompiledModel), the K·V continuations scored and ranked on the card
    as the fused program does, the parents and tokens read back every step,
    the caches reordered and written by the host's loop → (ids cut at EOS,
    score). No length penalty."""
    import numpy as np
    import torch

    K, P, neg = dec.B, dec.P, float(dec.neg)
    dev = dec.cm.device
    ck, cv = dec._caches()
    scores = torch.full((K,), neg, device=dev)
    scores[0] = 0.0
    seqs = np.zeros((K, steps), np.int64)
    finished = torch.zeros((K,), dtype=torch.bool, device=dev)
    logits, pos = None, 0

    def step(toks):
        nonlocal logits, pos
        outs = dec.cm(np.asarray(toks, np.int64).reshape(K, 1), np.full((K, 1), pos, np.int64),
                      ck, cv, dec._mask(pos))
        logits = outs[0].reshape(K, -1)
        if pos < P:
            ck[:, :, :, pos] = outs[1][:, :, :, 0]
            cv[:, :, :, pos] = outs[2][:, :, :, 0]
        pos += 1

    with torch.inference_mode():
        for t in prompt:
            step([int(t)] * K)
        V = logits.shape[-1]
        for i in range(steps):
            logp = torch.log_softmax(logits.float(), dim=-1)
            if eos_id is not None:
                frozen = torch.where(torch.arange(V, device=dev) == eos_id, 0.0, neg)
                logp = torch.where(finished[:, None], frozen, logp)
            top_v, top_i = torch.topk((scores[:, None] + logp).reshape(-1), K)
            parent, tok = (top_i // V), (top_i % V)
            p_host, t_host = parent.cpu().numpy(), tok.cpu().numpy()
            ck.copy_(ck.index_select(1, parent))
            cv.copy_(cv.index_select(1, parent))
            seqs = seqs[p_host]
            seqs[:, i] = t_host
            finished = finished.index_select(0, parent)
            if eos_id is not None:
                finished = finished | (tok == eos_id)
            scores = top_v
            step(t_host)
    best = int(torch.argmax(scores))
    ids = [int(t) for t in seqs[best]]
    if eos_id is not None and eos_id in ids:
        ids = ids[: ids.index(eos_id)]
    return ids, float(scores[best])


def ids_and(ids, *rest) -> tuple:
    """A decode's ids as an int64 array, beside what else it returned: what
    phase 32 compares."""
    import numpy as np

    return (np.asarray(ids, np.int64), *rest)


def decode_prompts(vocab: int, seed: int = SEED) -> list:
    import numpy as np

    rng = np.random.default_rng(seed + 33)
    return [[int(t) for t in rng.integers(2, vocab, n)] for n in DECODE_PROMPTS]


def decode_phase(checks, dev, card) -> None:
    """Phase 33: GPT-2-small decode (greedy, sampled, beam 4) and
    Whisper-tiny-width seq2seq through the port's generative runtime, each
    fused program against its host loop, with ms a token both ways; the
    paths are registered for phase 32."""
    import numpy as np
    import torch

    banner(f"== 33. generative decode: GPT-2 small and Whisper-tiny widths ({card})")
    t0 = time.perf_counter()
    decs, bs = gpt2_decoders(dev)
    dec, beam = decs[1], decs[BEAM]
    print(f"  GPT-2 small step graph: {len(bs) / 1e6:.1f} MB of ONNX through the port's "
          f"torch_shim, exported and compiled at B = 1 and {BEAM} in "
          f"{time.perf_counter() - t0:.1f} s")
    prompts = decode_prompts(GPT2["vocab"])
    n_tok = DECODE_PROMPTS[0] + DECODE_STEPS
    for label, kw, hkw in (("greedy", {}, {}),
                           (f"sampled, temperature {DECODE_TEMPERATURE}",
                            dict(temperature=DECODE_TEMPERATURE, seed=5),
                            dict(temperature=DECODE_TEMPERATURE, rng=5))):
        t1 = time.perf_counter()
        ids, logits = dec.generate(prompts[0], DECODE_STEPS, **kw)
        first = time.perf_counter() - t1
        ids_h, logits_h = dec.generate_hostloop(prompts[0], DECODE_STEPS, **hkw)
        same = ids == ids_h and np.array_equal(logits, logits_h)
        checks.require(same and len(ids) == DECODE_STEPS and all(0 <= t < GPT2["vocab"]
                                                                for t in ids),
                       f"GPT-2 small {label}: {DECODE_STEPS} ids after a {DECODE_PROMPTS[0]}-"
                       f"token prompt, fused = host loop (ids and last logits, the same bits)")
        fused = host_ms(lambda: dec.generate(prompts[0], DECODE_STEPS, **kw), runs=3)
        hostl = host_ms(lambda: dec.generate_hostloop(prompts[0], DECODE_STEPS, **hkw), runs=3)
        print(f"  GPT-2 small {label}: fused {fused / n_tok:.3f} ms a token ({fused:.2f} ms for "
              f"{n_tok} tokens; first call with its capture {first:.2f} s), host loop "
              f"{hostl / n_tok:.3f} ms a token  ({card})")
    profile_top(lambda: dec.generate(prompts[0], DECODE_STEPS),
                f"GPT-2 small greedy generation ({n_tok} steps)", card, n=1, top=12)
    t1 = time.perf_counter()
    ids_b, score = beam.beam_search(prompts[1][:4], BEAM_STEPS, beam=BEAM, eos_id=0)
    first = time.perf_counter() - t1
    ids_bh, score_h = beam_hostloop(beam, prompts[1][:4], BEAM_STEPS, eos_id=0)
    checks.require(ids_b == ids_bh and abs(score - score_h) <= 1e-5 * max(abs(score_h), 1.0)
                   and np.isfinite(score),
                   f"GPT-2 small beam {BEAM}: {len(ids_b)} ids, score {score:.6f}; the host "
                   f"loop's ids and score {score_h:.6f}")
    n_b = 4 + BEAM_STEPS
    fused = host_ms(lambda: beam.beam_search(prompts[1][:4], BEAM_STEPS, beam=BEAM, eos_id=0),
                    runs=3)
    hostl = host_ms(lambda: beam_hostloop(beam, prompts[1][:4], BEAM_STEPS, eos_id=0), runs=3)
    print(f"  GPT-2 small beam {BEAM}: fused {fused / n_b:.3f} ms a step ({n_b} steps; first "
          f"call {first:.2f} s), host loop {hostl / n_b:.3f} ms a step  ({card})")
    register(f"GPT-2 small beam {BEAM}, one step program replayed a step (no kernel)",
             lambda i: ids_and(*beam.beam_search(prompts[i][:4], BEAM_STEPS, beam=BEAM,
                                                 eos_id=0)),
             lambda i: ids_and(*beam_hostloop(beam, prompts[i][:4], BEAM_STEPS, eos_id=0)),
             programs=beam.programs)
    register("GPT-2 small greedy decode, one step program replayed a token (no kernel)",
             lambda i: ids_and(*dec.generate(prompts[i], DECODE_STEPS)),
             lambda i: ids_and(*dec.generate_hostloop(prompts[i], DECODE_STEPS)),
             programs=dec.programs)

    t0 = time.perf_counter()
    gen, src = whisper_generator(dev)
    print(f"  Whisper-tiny widths: encoder over {WHISPER_TINY['frames']} frames and decoder "
          f"step exported and compiled in {time.perf_counter() - t0:.1f} s")
    ids = gen.generate(src, max_steps=S2S_STEPS)
    ids_h = gen.generate_hostloop(src, max_steps=S2S_STEPS)
    checks.require(ids == ids_h and all(0 <= t < WHISPER_TINY["vocab"] for t in ids),
                   f"Whisper-tiny seq2seq: {len(ids)} ids (cut at EOS) of {S2S_STEPS} steps, "
                   "fused = host loop")
    fused = host_ms(lambda: gen.generate(src, max_steps=S2S_STEPS), runs=3)
    hostl = host_ms(lambda: gen.generate_hostloop(src, max_steps=S2S_STEPS), runs=3)
    n_s = 1 + S2S_STEPS
    print(f"  Whisper-tiny seq2seq: fused {fused / n_s:.3f} ms a token ({fused:.2f} ms for the "
          f"encoder and {n_s} steps), host loop {hostl / n_s:.3f} ms a token  ({card})")
    src2 = src[:, ::-1].copy()
    register("Whisper-tiny-width seq2seq, encoder program + one step program (no kernel)",
             lambda i: ids_and(gen.generate((src, src2)[i], max_steps=S2S_STEPS)),
             lambda i: ids_and(gen.generate_hostloop((src, src2)[i], max_steps=S2S_STEPS)),
             programs=gen.decoder.programs)
    torch.cuda.synchronize()


# phase 35: the ORT-GenAI int4 decoder form (onnx/synth.py build_genai_decoder)
# at published widths with random weights drawn on the card from a seed:
# Phi-3-mini's (microsoft/Phi-3-mini-4k-instruct config.json, the port's
# PHI3_MINI) at 4 of its 32 layers, bench_genai_decode's depth, and
# Phi-3.5-MoE's attention and expert widths (32 heads over 8 kv heads of 128,
# 16 experts of 4,096 x 6,400, top-2) at 2 of its 32 layers
GENAI_PROMPT = 128
# depth cut to keep the whole script in its time: 32 steps, 4 and 2 layers
# before phase 38 was added
GENAI_STEPS = 16
GENAI_DENSE_LAYERS = 2
GENAI_MOE_LAYERS = 1


def genai_forms() -> dict:
    from lele_tpu_torch.onnx.synth import GENAI_CFG, GENAI_MOE_CFG, PHI3_MINI

    p = PHI3_MINI
    dense = dict(GENAI_CFG, B=1, V=p["vocab"], qh=p["heads"], kvh=p["kv_heads"],
                 hd=p["head_dim"], ffn=p["ffn"], blk=32, L=p["l_max"], eps=p["eps"],
                 nl=GENAI_DENSE_LAYERS)
    moe = dict(GENAI_MOE_CFG, B=1, V=32064, qh=32, kvh=8, hd=128, experts=16, ffn=6400,
               blk=32, L=4096, nl=GENAI_MOE_LAYERS)
    return {f"dense, Phi-3-mini width, {GENAI_DENSE_LAYERS} of 32 layers": dense,
            f"MoE, Phi-3.5-MoE widths, {GENAI_MOE_LAYERS} of 32 layers": moe}


def genai_params_on_card(cfg: dict, seed: int, dev) -> dict:
    """build_genai_decoder's initializers at cfg's widths, drawn on the card
    from `seed` with genai_decoder_params' distributions and quantised by its
    rules (quant4_ort for MatMulNBits, quant4_cols for the experts) on the
    card, as host arrays; no dequantised twins (at the MoE widths they would
    be ~10 GB of host memory)."""
    import numpy as np
    import torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    V, qh, kvh, hd, nl, L, ffn, blk = (cfg[k] for k in
                                       ("V", "qh", "kvh", "hd", "nl", "L", "ffn", "blk"))
    D, KVD, E = qh * hd, kvh * hd, cfg.get("experts")
    inits: dict = {}

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def pack(q):  # low nibble first along the last axis
        return (q[..., 0::2] | (q[..., 1::2] << 4)).cpu().numpy()

    def linear(name, n, k):
        wg = (normal(n, k) / k ** 0.5).reshape(n, k // blk, blk)
        sc = wg.abs().amax(-1) / 7.0 + 1e-8
        inits[f"{name}_q"] = pack((torch.round(wg / sc[..., None]) + 8).clamp(0, 15)
                                  .to(torch.uint8))
        inits[f"{name}_s"] = sc.cpu().numpy()

    def experts(name, k, n):
        w = normal(E, k, n) / k ** 0.5
        sc = w.abs().amax(1) / 7.0 + 1e-8
        inits[f"{name}_q"] = pack((torch.round(w / sc[:, None]) + 8).clamp(0, 15)
                                  .to(torch.uint8))
        inits[f"{name}_s"] = sc.cpu().numpy()
        del w

    inits["emb"] = (normal(V, D) * 0.5).cpu().numpy()
    for i in range(nl):
        for name, n in (("wq", D), ("wk", KVD), ("wv", KVD), ("wo", D)):
            linear(f"{name}{i}", n, D)
        if not E:
            linear(f"wg{i}", ffn, D)
            linear(f"wu{i}", ffn, D)
            linear(f"wd{i}", D, ffn)
        for g in (f"g_attn{i}", f"g_mlp{i}"):
            inits[g] = (normal(D) * 0.1 + 1).cpu().numpy()
    inits["g_final"] = (normal(D) * 0.1 + 1).cpu().numpy()
    for i in range(nl if E else 0):
        inits[f"router{i}"] = (normal(D, E) / D ** 0.5).cpu().numpy()
        experts(f"fc1_{i}", D, ffn)
        experts(f"fc2_{i}", ffn, D)
        experts(f"fc3_{i}", D, ffn)
    linear("head", V, D)
    inv = 1.0 / 10000 ** (np.arange(hd // 2) / (hd // 2))
    t = np.arange(L)[:, None] * inv[None, :]
    inits["cos"], inits["sin"] = np.cos(t).astype(np.float32), np.sin(t).astype(np.float32)
    return inits


def genai_save(inits: dict, cfg: dict, folder) -> tuple:
    """The prefill graph (S = GENAI_PROMPT) and the decode graph (S = 1)
    written as a published export is: model.onnx beside model.onnx.data, by
    the port's save_with_external_data; the decode graph's initializers
    refer to the prefill graph's side file (one copy of the weights on
    disk). Returns the two paths and the side file's size in bytes."""
    from lele_tpu_torch.onnx import builder as ob
    from lele_tpu_torch.onnx import schema
    from lele_tpu_torch.onnx.synth import build_genai_decoder

    pre, dec = Path(folder) / "genai.onnx", Path(folder) / "genai_decode.onnx"
    ob.save_with_external_data(build_genai_decoder(inits, GENAI_PROMPT, cfg, raw=True), pre)
    spilled = schema.decode_model(pre.read_bytes()).raw()["graph"]["initializer"]
    raw = build_genai_decoder({}, 1, cfg, raw=True)
    raw["graph"]["initializer"] = spilled
    dec.write_bytes(ob.serialize(raw))
    return pre, dec, (Path(folder) / "genai.onnx.data").stat().st_size


def genai_w4_bound(cfg: dict, M: int) -> tuple[float, str]:
    """Kernel 7's least time for one step of M rows: every MatMulNBits
    weight's int4 bytes and f32 scales, bf16 activations in, f32 out; the
    MoE decode step's three indexed launches read the k = 2 experts a row
    chose (rows·k slots; scales [K/g, N] an expert)."""
    qh, kvh, hd, nl, ffn, V, blk = (cfg[k] for k in ("qh", "kvh", "hd", "nl", "ffn", "V", "blk"))
    D, KVD, E = qh * hd, kvh * hd, cfg.get("experts")
    shapes = [(D, D), (D, KVD), (D, KVD), (D, D)] * nl + [(D, V)]  # (K, N)
    if not E:
        shapes += [(D, ffn), (D, ffn), (ffn, D)] * nl
    n_bytes = sum(K * N / 2 + K / blk * N * 4 + M * K * 2 + M * N * 4 for K, N in shapes)
    flops = sum(2 * M * K * N for K, N in shapes)
    if E and M * 2 <= E:
        slots = 2 * M
        for K, N in ((D, ffn), (D, ffn), (ffn, D)):
            g = next(g for g in (128, 64, 32, 16, 8, 4, 2, 1) if (K // 2) % g == 0)
            n_bytes += nl * slots * (K * N / 2 + K / g * N * 4 + K * 2 + N * 4)
            flops += nl * slots * 2 * K * N
    return bound(n_bytes, {"bf16": flops})


def op_breakdown(fn, label: str, card: str, top: int = 12) -> None:
    """One uncaptured call of fn() under torch.profiler: the device time by
    the aten op that launched it (its CPU row's self device time), for where
    a graph's time goes, which a captured replay cannot attribute."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CPU and dev_time(e) > 0]
    total = sum(dev_time(e) for e in rows)
    print(f"  {label}: device {total:.1f} us by the aten op that launched it  ({card})")
    for e in sorted(rows, key=lambda e: -dev_time(e))[:top]:
        print(f"    {dev_time(e):10.1f} us  x{e.count:<5d} {e.key[:80]}")


def genai_phase(checks, dev, card) -> dict:
    """Phase 35: the ORT-GenAI int4 decoder family (com.microsoft
    SimplifiedLayerNormalization / SkipSimplifiedLayerNormalization,
    RotaryEmbedding, GroupQueryAttention, MatMulNBits; QMoE in the MoE form)
    at Phi-3-mini's width (GENAI_DENSE_LAYERS of 32 layers) and Phi-3.5-MoE's
    attention and expert widths (GENAI_MOE_LAYERS of 32), random weights drawn
    on the card from a
    seed, written with save_with_external_data and compiled from the path
    (S = 128 and S = 1), with the caches donated in graph order. A 128-token
    prefill and GENAI_STEPS greedy steps through captured graphs: every MatMulNBits on
    kernel 7 (2 pattern hits a node), kernel 7's launches a step, each step's
    logits within NBITS_RELNORM of the same graph on kernel 7's plain version
    (PLAIN_NBITS_PATTERNS, the same bf16 activations) on the same feeds,
    tokens equal where the plain logits' top-2 gap decides, the captured
    donated call the bits of the uncaptured undonated `replay()`, each
    present cache on its own past; prefill and decode times by CUDA events,
    kernel 7's device sum a decode step against its bound, the busy share.
    Returns kernel 7's launches a call by path."""
    import tempfile

    import numpy as np
    import torch

    from lele_tpu_torch import kernels as K
    from lele_tpu_torch.compiler import compile_model
    from lele_tpu_torch.compiler.patterns import PLAIN_NBITS_PATTERNS

    banner(f"== 35. the ORT-GenAI int4 decoder form: dense Phi-3-mini width and MoE "
          f"Phi-3.5-MoE widths, a {GENAI_PROMPT}-token prefill and {GENAI_STEPS} greedy "
          f"steps ({card})")
    launches: dict[str, int] = {}
    w4_names = LAUNCH_KERNELS["w4_gemm"]
    for fi, (label, cfg) in enumerate(genai_forms().items()):
        nl, E, B, V = cfg["nl"], cfg.get("experts"), cfg["B"], cfg["V"]
        n_nodes = (4 if E else 7) * nl + 1
        t0 = time.perf_counter()
        inits = genai_params_on_card(cfg, SEED + 35 + fi, dev)
        t_draw = time.perf_counter() - t0
        with tempfile.TemporaryDirectory() as folder:
            t0 = time.perf_counter()
            pre_path, dec_path, side = genai_save(inits, cfg, folder)
            t_save = time.perf_counter() - t0
            del inits
            donate = [f"p{kv}{i}" for i in range(nl) for kv in "kv"]
            t0 = time.perf_counter()
            pre = compile_model(str(pre_path), device=dev, strict=True, donate=donate)
            dec = compile_model(str(dec_path), device=dev, strict=True, donate=donate)
            t_compile = time.perf_counter() - t0
            plain = [compile_model(str(p), device=dev, strict=True,
                                   patterns=PLAIN_NBITS_PATTERNS) for p in (pre_path, dec_path)]
        print(f"  {label}: weights drawn on the card in {t_draw:.1f} s; model.onnx + a "
              f"{side / 1e9:.2f} GB side file written in {t_save:.1f} s; both graphs compiled "
              f"from their paths in {t_compile:.1f} s (host clock)")
        for name, cm in (("prefill", pre), ("decode", dec)):
            hits = cm.stats["pattern_hits"]
            want_moe = 2 * nl if (E and name == "decode") else 0
            checks.require(hits.get("matmul_nbits_w4") == 2 * n_nodes
                           and hits.get("qmoe_w4", 0) == want_moe,
                           f"{label}, {name}: pattern hits {hits}: every one of the "
                           f"{n_nodes} MatMulNBits on kernel 7 (two hits a node)"
                           + (", QMoE's decode on its indexed entry" if want_moe else ""))
            paired = {k: cm.output_names[j] for k, j in cm.donated.items()}
            checks.require(paired == {k: "n" + k for k in donate},
                           f"{label}, {name}: each donated cache gets its own present "
                           f"({len(paired)} pairs, pk_i -> npk_i, pv_i -> npv_i)")

        rng = np.random.default_rng(SEED + 350 + fi)
        ids0 = torch.from_numpy(rng.integers(0, V, (B, GENAI_PROMPT))).to(dev)
        shape = (B, cfg["kvh"], cfg["L"], cfg["hd"])
        zeros = [torch.zeros(shape, device=dev) for _ in range(2 * nl)]

        def feeds(ids, start, caches):
            s = ids.shape[1]
            f = {"ids": ids,
                 "pos": (start + torch.arange(s, device=dev))[None].expand(B, s).contiguous(),
                 "slk": torch.full((B,), start + s - 1, dtype=torch.int32, device=dev),
                 "tot": torch.full((1,), start + s, dtype=torch.int32, device=dev)}
            f.update(zip(donate, caches))
            return f

        f = feeds(ids0, 0, zeros)
        worst, bits, decided, agree = 0.0, True, 0, 0
        per_path: dict[str, dict] = {}
        with torch.inference_mode():
            for t in range(GENAI_STEPS + 1):
                cm, ref_cm, path = (pre, plain[0], "prefill") if t == 0 else \
                    (dec, plain[1], "decode step")
                K.reset_launch_counts()
                out = cm(**f)
                torch.cuda.synchronize()
                moved = {k: v for k, v in K.launch_counts().items() if v}
                per_path.setdefault(path, moved)
                eager = cm.replay(**f)
                ref = ref_cm(**f)
                bits &= all(torch.equal(a, b) for a, b in zip(out, eager))
                lg, rl = out[0][:, -1].float(), ref[0][:, -1].float()
                rn = ((out[0] - ref[0]).norm() / ref[0].norm()).item()
                worst = max(worst, rn) if np.isfinite(rn) else float("inf")
                top2 = rl.topk(2, dim=-1).values
                gap_ok = (top2[:, 0] - top2[:, 1]) > NBITS_RELNORM * rl.abs().amax(-1)
                same = lg.argmax(-1) == rl.argmax(-1)
                decided += int(gap_ok.sum())
                agree += int((same | ~gap_ok).sum())
                tok = lg.argmax(-1)[:, None]
                f = feeds(tok, GENAI_PROMPT + t if t else GENAI_PROMPT, list(out[1:]))
        n_rows = B * (GENAI_STEPS + 1)
        checks.require(bool(torch.isfinite(out[0]).all()) and worst <= NBITS_RELNORM,
                       f"{label}: {GENAI_STEPS + 1} steps' logits vs kernel 7's plain version "
                       f"on the same feeds: worst relative Frobenius {worst:.3e} <= "
                       f"{NBITS_RELNORM:g} (phase 13's fused MatMulNBits gate)")
        checks.require(agree == n_rows,
                       f"{label}: greedy tokens equal the plain route's wherever its top-2 gap "
                       f"exceeds {NBITS_RELNORM:g} x max|logit| ({decided} of {n_rows} "
                       f"decided, {agree - (n_rows - decided)} equal)")
        checks.require(bits and pre.stats["captured"] and dec.stats["captured"],
                       f"{label}: every step captured with donated caches gives the bits of "
                       f"the uncaptured, undonated replay() (logits and {2 * nl} caches)")
        want = {"prefill": n_nodes, "decode step": (4 * nl + 3 * nl + 1) if E else n_nodes}
        for path, moved in per_path.items():
            launches[f"{'MoE' if E else 'dense'} {path}"] = moved.get("w4_gemm", 0)
            checks.require(moved == {"w4_gemm": want[path]},
                           f"{label}, {path}: launches of one call {moved}: kernel 7 "
                           f"{want[path]} times, nothing else")
        program_launch_check(checks, f"{label}, prefill", [pre._program])
        program_launch_check(checks, f"{label}, decode step", [dec._program])

        # times: the prefill call, and decode steps fed back on the card
        f0 = feeds(ids0, 0, zeros)
        pre_ms = time_ms(lambda: pre(**f0), runs=10)
        with torch.inference_mode():
            o = pre(**f0)
            tok = o[0][:, -1].argmax(-1)[:, None]
            fd = feeds(tok, GENAI_PROMPT, list(o[1:]))

        def decode_run(n, fd=fd):
            out, f = None, fd
            for t in range(n):
                out = dec(**f)
                f = feeds(out[0][:, -1].argmax(-1)[:, None], GENAI_PROMPT + 1 + t,
                          list(out[1:]))
            return out

        with torch.inference_mode():
            decode_run(2)
            torch.cuda.synchronize()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            t0 = time.perf_counter()
            start.record()
            decode_run(GENAI_STEPS)
            end.record()
            end.synchronize()
            host = (time.perf_counter() - t0) * 1e3 / GENAI_STEPS
            ev = start.elapsed_time(end) / GENAI_STEPS
            rows = device_us(lambda: dec(**fd), n=10)
            du, span = busy(lambda: (dec(**fd), torch.cuda.synchronize()))
        # the profiler names a kernel by its demangled signature
        w4_us = None if rows is None else sum(
            v for k, v in rows.items()
            if any(is_kernel(k, n) or f"::{n}<" in k or f"::{n}(" in k for n in w4_names))
        b_ms, b_by = genai_w4_bound(cfg, B)
        print(f"  {label}: prefill of {GENAI_PROMPT} tokens {pre_ms:.3f} ms by CUDA events (one "
              f"captured graph a call); decode {ev:.3f} ms a token by events over "
              f"{GENAI_STEPS} steps fed back on the card ({host:.3f} ms by host clock); "
              f"kernel 7 a decode step {fmt_us(w4_us)} of device time against its bound "
              f"{b_ms * 1e3:.2f} us ({b_by}); one decode call: device "
              f"{du / 1e3:.3f} ms over {span / 1e3:.3f} ms, busy share {du / span:.3f}  "
              f"({card})")
        profile_top(lambda: dec(**fd), f"{label} decode step", card, n=3, top=12)
        op_breakdown(lambda: dec.replay(**fd), f"{label}, one uncaptured decode step", card)
        del pre, dec, plain, out, eager, ref, o, zeros, f, f0, fd
        torch.cuda.empty_cache()
    print(f"  kernel 7 launches a call {launches}")
    return {"w4_gemm": launches}


def resnet50_model(batch="N", seed: int = RESNET_SEED, width: int = 64,
                   blocks=RESNET_BLOCKS, classes: int = 1000,
                   img: int = 224) -> tuple[bytes, int]:
    """An ONNX graph in the layout of the ONNX Model Zoo's resnet50-v1-7:
    input `data` [batch, 3, img, img]; a 7 x 7 / 2 stem conv (no bias),
    BatchNormalization, Relu, MaxPool 3 x 3 / 2 pad 1; four bottleneck
    stages of `blocks` blocks (output widths 4, 8, 16, 32 x `width`), the
    stride on the first 1 x 1 conv of a downsampling block and a 1 x 1
    projection on each stage's first block; GlobalAveragePool, Flatten,
    Gemm to `classes`; then Softmax, TopK k = 5 and ArgMax. Outputs:
    logits, probs, top5 values and indices, argmax. The defaults are the
    published widths: 53 convs, 25.6 M parameters. Returns the bytes and
    the multiply-adds of one image.

    Random weights from `seed`, drawn to keep the activations O(1)
    through every conv: each conv He-normal (std sqrt(2 / fan_in)), which
    keeps a ReLU stack's second moment; BN statistics near identity (mean
    N(0, 0.1^2), var U(0.8, 1.2), beta N(0, 0.1^2)), gamma 1, except the
    last BN of each residual branch, whose gamma 0.25 adds 1/16 of the
    branch's variance to the shortcut a block; the Gemm N(0, 1 / 2048)."""
    import numpy as np

    from lele_tpu_torch.onnx import builder as ob

    rng = np.random.default_rng(seed)
    nodes, inits = [], []
    hw, macs = [img], [0]  # the spatial size a conv sees; multiply-adds so far

    def param(name, arr, dtype=np.float32):
        inits.append(ob.tensor_from_array(np.asarray(arr, dtype), name))
        return name

    def conv_bn(x, name, cin, cout, k, stride=1, gamma=1.0, relu=True):
        w = rng.standard_normal((cout, cin, k, k), dtype=np.float32) * np.sqrt(2.0 / (cin * k * k))
        out_hw = (hw[0] + 2 * (k // 2) - k) // stride + 1
        macs[0] += cout * cin * k * k * out_hw * out_hw
        nodes.append(ob.node("Conv", [x, param(f"{name}_w", w)], [f"{name}_c"],
                             kernel_shape=[k, k], strides=[stride, stride],
                             pads=[k // 2] * 4))
        bn = [param(f"{name}_{p}", v) for p, v in (
            ("gamma", np.full(cout, gamma)), ("beta", 0.1 * rng.standard_normal(cout)),
            ("mean", 0.1 * rng.standard_normal(cout)), ("var", rng.uniform(0.8, 1.2, cout)))]
        nodes.append(ob.node("BatchNormalization", [f"{name}_c"] + bn, [f"{name}_bn"],
                             epsilon=1e-5))
        if not relu:
            return f"{name}_bn"
        nodes.append(ob.node("Relu", [f"{name}_bn"], [f"{name}_r"]))
        return f"{name}_r"

    x = conv_bn("data", "stem", 3, width, 7, stride=2)
    nodes.append(ob.node("MaxPool", [x], ["pool"], kernel_shape=[3, 3], strides=[2, 2],
                         pads=[1, 1, 1, 1]))
    hw[0] = ((hw[0] - 1) // 2 + 1 - 1) // 2 + 1
    x, cin = "pool", width
    for si, n_blocks in enumerate(blocks):
        mid, cout = width * 2 ** si, 4 * width * 2 ** si
        for bi in range(n_blocks):
            stride = 2 if bi == 0 and si > 0 else 1
            name = f"s{si}b{bi}"
            short = conv_bn(x, f"{name}_p", cin, cout, 1, stride, relu=False) if bi == 0 else x
            h = conv_bn(x, f"{name}_1", cin, mid, 1, stride)
            hw[0] = (hw[0] - 1) // stride + 1
            h = conv_bn(h, f"{name}_2", mid, mid, 3)
            h = conv_bn(h, f"{name}_3", mid, cout, 1, gamma=0.25, relu=False)
            nodes.append(ob.node("Add", [h, short], [f"{name}_sum"]))
            nodes.append(ob.node("Relu", [f"{name}_sum"], [f"{name}_out"]))
            x, cin = f"{name}_out", cout
    nodes += [
        ob.node("GlobalAveragePool", [x], ["gap"]),
        ob.node("Flatten", ["gap"], ["flat"], axis=1),
        ob.node("Gemm", ["flat", param("fc_w", rng.standard_normal(
            (classes, cin), dtype=np.float32) / np.sqrt(cin)),
            param("fc_b", 0.01 * rng.standard_normal(classes))], ["logits"], transB=1),
        ob.node("Softmax", ["logits"], ["probs"], axis=1),
        ob.node("TopK", ["probs", param("k5", [5], np.int64)], ["top5", "top5_idx"],
                axis=-1),
        ob.node("ArgMax", ["logits"], ["argmax"], axis=1, keepdims=0),
    ]
    macs[0] += classes * cin
    return ob.build_model_bytes(
        nodes, [ob.value_info("data", 1, [batch, 3, img, img])],
        [ob.value_info("logits", 1, [batch, classes]), ob.value_info("probs", 1, [batch, classes]),
         ob.value_info("top5", 1, [batch, 5]), ob.value_info("top5_idx", 7, [batch, 5]),
         ob.value_info("argmax", 7, [batch])], inits, opset=17), macs[0]


def emitter_graphs(seed: int = RESNET_SEED) -> list[dict]:
    """One small graph for each of ROADMAP §1.1.1's 87 emitters but NMS, for
    ConvTranspose at 2-D and 3-D and for Resize's cubic and crop forms:
    {"name", "nodes", "inputs" (dynamic graph
    inputs), "inits", "outputs", "opset", "tol" (max|d| <= tol·max(1,
    max|ref|) against the CPU), "concrete" (the op runs on trace-time values
    only: NonZero, Unique, Compress's condition)}. NonMaxSuppression has no
    graph: the port refuses it on every input, as the JAX package does. Ties
    are built in where the order matters: TopK and ArgMax/ArgMin equal
    values, ScatterND and ScatterElements duplicate indices, MaxPool equal
    window entries. Integer Div and Mod meet a zero divisor."""
    import numpy as np

    from lele_tpu_torch.onnx import builder as ob

    rng = np.random.default_rng(seed)

    def f32(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    x4, x3, x2 = f32(2, 3, 8, 8), f32(2, 4, 6), f32(4, 6)
    unit = rng.uniform(-0.9, 0.9, (4, 6)).astype(np.float32)
    pos = (np.abs(x2) + 0.1).astype(np.float32)
    ties = np.repeat(np.round(f32(4, 3), 1), 3, axis=1)[:, rng.permutation(9)]
    cases = []

    def case(name, op_type, inputs, inits=None, n_out=1, opset=17, tol=1e-5,
             concrete=False, names=None, **attrs):
        outs = [f"y{i}" for i in range(n_out)]
        names = names or list(inputs) + list(inits or {})
        cases.append({"name": name, "nodes": [ob.node(op_type, names, outs, **attrs)],
                      "inputs": inputs, "inits": inits or {}, "outputs": outs,
                      "opset": opset, "tol": tol, "concrete": concrete})

    for op_type in ("Abs", "Atan", "Ceil", "Cos", "Cosh", "Exp", "Floor", "Round", "Sign",
                    "Sin", "Sinh", "Tan", "Softsign", "HardSwish", "Mish"):
        case(op_type, op_type, {"x": x2})
    for op_type in ("Acos", "Asin"):
        case(op_type, op_type, {"x": unit})
    for op_type in ("Sqrt", "Reciprocal"):
        case(op_type, op_type, {"x": pos})
    case("Celu", "Celu", {"x": x2}, alpha=0.7)
    case("Elu", "Elu", {"x": x2}, alpha=0.5)
    case("Selu", "Selu", {"x": x2})
    case("HardSigmoid", "HardSigmoid", {"x": x2}, alpha=0.3, beta=0.4)
    case("ThresholdedRelu", "ThresholdedRelu", {"x": x2}, alpha=0.5)
    case("LogSoftmax", "LogSoftmax", {"x": x3}, axis=1)
    special = np.array([[1.0, np.inf, -np.inf, np.nan, 0.0, -2.0]], np.float32)
    case("IsInf", "IsInf", {"x": special}, detect_negative=0)
    case("IsNaN", "IsNaN", {"x": special})
    for op_type in ("Greater", "GreaterOrEqual", "LessOrEqual"):
        case(op_type, op_type, {"a": x2, "b": np.where(rng.random((4, 6)) < 0.3, x2, f32(4, 6))})
    bools = rng.random((2, 4, 6)) < 0.5
    case("Not", "Not", {"a": bools[0]})
    for op_type in ("And", "Or", "Xor"):
        case(op_type, op_type, {"a": bools[0], "b": bools[1]})
    for op_type in ("Max", "Min", "Sum", "Mean"):
        case(op_type, op_type, {"a": x2, "b": f32(4, 6), "c": f32(1, 6)})
    ints = rng.integers(-20, 20, (4, 6)).astype(np.int32)
    divisor = rng.integers(-4, 5, (4, 6)).astype(np.int32)  # zeros among them
    case("Mod", "Mod", {"a": ints, "b": divisor})
    case("Mod fmod", "Mod", {"a": x2, "b": pos}, fmod=1)
    case("Div int by zero", "Div", {"a": ints, "b": divisor})
    case("Pow", "Pow", {"a": pos, "b": f32(4, 6)})
    case("PRelu", "PRelu", {"x": x4}, {"slope": f32(3, 1, 1, scale=0.2)})
    case("Clip", "Clip", {"x": x2}, {"lo": np.float32(-0.5), "hi": np.float32(0.7)})
    for op_type in ("ReduceMax", "ReduceMin", "ReduceProd", "ReduceL1", "ReduceL2",
                    "ReduceLogSumExp", "ReduceSumSquare"):
        case(op_type, op_type, {"x": x3}, {"axes": np.array([0, 2], np.int64)}, opset=18,
             keepdims=1)
    case("CumSum", "CumSum", {"x": x3}, {"axis": np.array(2, np.int64)}, exclusive=1,
         reverse=1)
    case("Einsum", "Einsum", {"a": x3, "b": f32(2, 6, 5)}, equation="bij,bjk->bik")
    case("Trilu", "Trilu", {"x": x3}, {"k": np.array(-1, np.int64)}, upper=0)
    # tensor
    case("Flatten", "Flatten", {"x": x4}, axis=2)
    case("Size", "Size", {"x": x4})
    case("CastLike", "CastLike", {"x": x2 * 4, "like": ints[:1]})
    case("Tile", "Tile", {"x": x3}, {"r": np.array([1, 2, 3], np.int64)})
    case("Pad", "Pad", {"x": x4}, {"p": np.array([0, 0, 2, -1, 0, 0, 1, 3], np.int64)},
         mode="reflect")
    case("GatherElements", "GatherElements", {"x": x3},
         {"i": rng.integers(-6, 6, (2, 4, 3)).astype(np.int64)}, axis=2)
    case("GatherND", "GatherND", {"x": x3},
         {"i": np.stack([rng.integers(0, 4, (2, 5)), rng.integers(-6, 6, (2, 5))], -1)},
         batch_dims=1)
    case("OneHot", "OneHot", {"i": rng.integers(-5, 5, (3, 4)).astype(np.int64)},
         {"d": np.array(5, np.int64), "v": np.array([-1.0, 2.0], np.float32)}, axis=1)
    case("DepthToSpace", "DepthToSpace", {"x": f32(2, 8, 3, 4)}, blocksize=2, mode="CRD")
    case("SpaceToDepth", "SpaceToDepth", {"x": x4}, blocksize=2)
    case("TopK", "TopK", {"x": ties}, {"k": np.array([4], np.int64)}, n_out=2, axis=1)
    case("ArgMax", "ArgMax", {"x": ties}, axis=1, keepdims=0, select_last_index=1)
    case("ArgMin", "ArgMin", {"x": ties}, axis=1)
    dup = np.array([[1], [3], [1], [0], [3]], np.int64)
    case("ScatterND", "ScatterND", {"d": x2, "u": f32(5, 6)}, {"i": dup},
         names=["d", "i", "u"])
    case("ScatterElements", "ScatterElements", {"d": x2, "u": f32(4, 3)},
         {"i": np.array([[0, 2, 0], [5, 5, 1], [3, 3, 3], [-1, 0, -1]], np.int64)},
         names=["d", "i", "u"], axis=1)
    case("Dropout", "Dropout", {"x": x2}, n_out=2)
    for op_type, attrs in (("RandomNormal", {"shape": [4, 6], "mean": 0.5, "scale": 2.0}),
                           ("RandomUniform", {"shape": [4, 6], "low": -1.0, "high": 3.0,
                                              "seed": 5.0})):
        cases.append({"name": op_type, "nodes": [
            ob.node(op_type, [], ["r"], **attrs), ob.node("Add", ["r", "x"], ["y0"])],
            "inputs": {"x": x2}, "inits": {}, "outputs": ["y0"], "opset": 17, "tol": 1e-5,
            "concrete": False})
    case("RandomNormalLike", "RandomNormalLike", {"x": x2}, seed=2.0)
    case("RandomUniformLike", "RandomUniformLike", {"x": x2})
    case("Compress", "Compress", {"x": x3}, {"c": np.array([True, False, True, True])},
         axis=1, concrete=True)
    case("NonZero", "NonZero", {}, {"x": (ints > 5).astype(np.float32)}, concrete=True)
    case("Unique", "Unique", {}, {"x": np.round(x2, 0)}, n_out=4, sorted=0, concrete=True)
    # nn
    pool_x = np.round(x4, 1)  # equal entries within windows
    case("MaxPool", "MaxPool", {"x": pool_x}, n_out=2, kernel_shape=[3, 3], strides=[2, 2],
         pads=[1, 0, 1, 1], ceil_mode=1)
    case("AveragePool", "AveragePool", {"x": x4}, kernel_shape=[3, 2], strides=[2, 1],
         pads=[1, 1, 0, 0], ceil_mode=1)
    case("GlobalAveragePool", "GlobalAveragePool", {"x": x4})
    case("GlobalMaxPool", "GlobalMaxPool", {"x": x4})
    case("Resize", "Resize", {"x": x4},
         {"roi": np.zeros(0, np.float32), "s": np.array([1, 1, 1.5, 0.75], np.float32)},
         mode="linear", coordinate_transformation_mode="half_pixel")
    case("Resize cubic", "Resize", {"x": x4},
         {"roi": np.zeros(0, np.float32), "s": np.array([1, 1, 1.75, 0.5], np.float32)},
         mode="cubic", exclude_outside=1, cubic_coeff_a=-0.5)
    case("Resize tf_crop_and_resize", "Resize", {"x": x4},
         {"roi": np.array([0.1, -0.2, 0.8, 1.1], np.float32), "s": np.zeros(0, np.float32),
          "z": np.array([5, 11], np.int64)}, opset=18, mode="linear", axes=[2, 3],
         coordinate_transformation_mode="tf_crop_and_resize", extrapolation_value=-3.0)
    case("Upsample", "Upsample", {"x": x4}, {"s": np.array([1, 1, 2, 3], np.float32)},
         opset=9, mode="nearest")
    chan = {k: f32(3) for k in ("g", "b", "m")}
    case("BatchNormalization", "BatchNormalization", {"x": x4},
         {**chan, "v": rng.uniform(0.5, 1.5, 3).astype(np.float32)}, epsilon=1e-3)
    case("InstanceNormalization", "InstanceNormalization", {"x": x4},
         {"g": chan["g"], "b": chan["b"]})
    case("GroupNormalization", "GroupNormalization", {"x": f32(2, 6, 5)},
         {"g": f32(6), "b": f32(6)}, opset=21, num_groups=3)
    case("MeanVarianceNormalization", "MeanVarianceNormalization", {"x": x4})
    case("LpNormalization", "LpNormalization", {"x": x2}, axis=0, p=1)
    case("ConvTranspose 2-D", "ConvTranspose", {"x": f32(1, 4, 5, 6)},
         {"w": f32(4, 3, 3, 2, scale=0.3), "b": f32(6)}, strides=[2, 3], group=2,
         dilations=[2, 1], output_padding=[1, 0], pads=[1, 0, 0, 1])
    case("ConvTranspose 3-D", "ConvTranspose", {"x": f32(1, 3, 3, 4, 5)},
         {"w": f32(3, 2, 2, 3, 3, scale=0.3)}, strides=[2, 1, 2], output_shape=[6, 6, 9],
         auto_pad="SAME_UPPER")
    return cases


def emitter_graph_bytes(c: dict) -> bytes:
    from lele_tpu_torch.onnx import builder as ob

    return ob.build_model_bytes(
        c["nodes"], [ob.vi_from_array(k, v) for k, v in c["inputs"].items()],
        [ob.value_info(o, 1, []) for o in c["outputs"]],
        [v if isinstance(v, dict) else ob.tensor_from_array(v, k)
         for k, v in c["inits"].items()], opset=c["opset"])


def quant_emitter_graphs(seed: int = QUANT_SEED) -> list[dict]:
    """One small graph for each of the 17 emitters of ROADMAP §1.1.2 and
    the qlinear part of §1.1.4, in `emitter_graphs`' form plus "codes": the
    largest difference of an integer output's codes allowed between the card
    and the CPU (0, or 1 where the float core is a transcendental or a
    reduction whose f32 order or division differs between the devices:
    sigmoid, softmax, the global mean, the window mean over 9), "tol" the
    float outputs' relative gate.
    Every integer product (ConvInteger, QLinearConv, QLinearMatMul, QGemm,
    MatMulIntegerToFloat, DynamicQuantizeMatMul, QAttention) runs on kernel
    11 on the card; the ConvInteger and QLinearConv graphs are grouped and
    padded with a nonzero input zero point, and their K (3·3·3 = 27) and
    output widths are not multiples of 16 (kernel 11's cp.async form)."""
    import numpy as np

    from lele_tpu_torch.onnx import builder as ob

    rng = np.random.default_rng(seed)

    def u8(*shape):
        return rng.integers(0, 256, shape).astype(np.uint8)

    def i8(*shape, lo=-127, hi=128):
        return rng.integers(lo, hi, shape).astype(np.int8)

    f32 = np.float32
    cases = []

    def case(name, op_type, inputs, inits, names, codes=0, tol=1e-6, opset=17, n_out=1,
             domain="", **attrs):
        outs = [f"y{i}" for i in range(n_out)]
        cases.append({"name": name, "nodes": [ob.node(op_type, names, outs, domain=domain,
                                                       **attrs)],
                      "inputs": inputs, "inits": inits, "outputs": outs, "opset": opset,
                      "codes": codes, "tol": tol, "concrete": False})

    ms = "com.microsoft"
    x4 = u8(2, 6, 9, 9)
    case("QuantizeLinear, per axis, int4 zero point", "QuantizeLinear",
         {"x": rng.standard_normal((4, 6, 5)).astype(f32) * 20},
         {"s": (rng.random(6) + 0.5).astype(f32),
          "z": ob.tensor_int4(rng.integers(-3, 4, 6), "z")}, ["x", "s", "z"], opset=21)
    case("DequantizeLinear, blocked", "DequantizeLinear", {"q": i8(4, 10)},
         {"s": (rng.random((4, 3)) * 0.1).astype(f32), "z": i8(4, 3, lo=-5, hi=5)},
         ["q", "s", "z"], opset=21, axis=1, block_size=4)
    case("ConvInteger, grouped, padded", "ConvInteger", {"x": x4},
         {"w": i8(10, 3, 3, 3), "xz": np.uint8(121), "wz": i8(10, lo=-3, hi=3)},
         ["x", "w", "xz", "wz"], group=2, pads=[1, 0, 2, 1], strides=[2, 1])
    case("QLinearConv, per channel, bias", "QLinearConv", {"x": x4},
         {"xs": f32(0.03), "xz": np.uint8(121), "w": i8(10, 3, 3, 3),
          "ws": (rng.random(10) * 0.01 + 0.002).astype(f32), "wz": np.zeros(10, np.int8),
          "ys": f32(0.4), "yz": np.uint8(60), "b": rng.integers(-4000, 4000, 10).astype(
              np.int32)}, ["x", "xs", "xz", "w", "ws", "wz", "ys", "yz", "b"], group=2,
         pads=[1, 1, 1, 1])
    case("QLinearMatMul", "QLinearMatMul", {"a": u8(3, 7, 40)},
         {"as": f32(0.02), "az": np.uint8(120), "b": i8(40, 24), "bs": f32(0.05),
          "bz": np.int8(0), "ys": f32(0.9), "yz": np.uint8(128)},
         ["a", "as", "az", "b", "bs", "bz", "ys", "yz"])
    a2, b2 = u8(2, 3, 5), u8(3, 5)
    q = {"sa": f32(0.03), "za": np.uint8(100), "sb": f32(0.05), "zb": np.uint8(30),
         "sc": f32(0.07), "zc": np.uint8(90)}
    for op_type in ("QLinearAdd", "QLinearMul"):
        case(op_type, op_type, {"a": a2, "b": b2}, q,
             ["a", "sa", "za", "b", "sb", "zb", "sc", "zc"], domain=ms)
    one = {"sx": f32(0.05), "zx": np.uint8(128), "sy": f32(1 / 256), "zy": np.uint8(0)}
    case("QLinearSigmoid", "QLinearSigmoid", {"x": u8(4, 33)}, one,
         ["x", "sx", "zx", "sy", "zy"], codes=1, domain=ms)
    case("QLinearLeakyRelu", "QLinearLeakyRelu", {"x": i8(4, 33)},
         {"sx": f32(0.04), "zx": np.int8(3), "sy": f32(0.03), "zy": np.int8(-2)},
         ["x", "sx", "zx", "sy", "zy"], domain=ms, alpha=0.1)
    case("QLinearSoftmax", "QLinearSoftmax", {"x": u8(3, 4, 50)}, one,
         ["x", "sx", "zx", "sy", "zy"], codes=1, domain=ms, axis=-1, opset=13)
    pool = {"sx": f32(0.1), "zx": np.uint8(128), "sy": f32(0.1), "zy": np.uint8(128)}
    case("QLinearAveragePool, padded", "QLinearAveragePool", {"x": u8(2, 5, 9, 9)},
         pool, ["x", "sx", "zx", "sy", "zy"], codes=1, domain=ms, kernel_shape=[3, 3],
         strides=[2, 2], pads=[1, 1, 1, 1])
    case("QLinearGlobalAveragePool", "QLinearGlobalAveragePool", {"x": u8(2, 16, 7, 7)},
         {"sx": f32(0.07), "zx": np.uint8(0), "sy": f32(0.03), "zy": np.uint8(0)},
         ["x", "sx", "zx", "sy", "zy"], codes=1, domain=ms)
    case("QLinearConcat", "QLinearConcat", {"x0": u8(2, 3), "x1": u8(2, 5)},
         {"ys": f32(0.04), "yz": np.uint8(64), "s0": f32(0.02), "z0": np.uint8(10),
          "s1": f32(0.05), "z1": np.uint8(200)}, ["ys", "yz", "x0", "s0", "z0", "x1", "s1",
                                                  "z1"], domain=ms, axis=1)
    gemm = {"sa": f32(0.02), "za": np.uint8(120), "b": i8(24, 40),
            "sb": (rng.random(24) * 0.05 + 0.01).astype(f32), "zb": np.zeros(24, np.int8),
            "c": rng.integers(-500, 500, 24).astype(np.int32)}
    case("QGemm, float output", "QGemm", {"a": u8(5, 40)}, gemm,
         ["a", "sa", "za", "b", "sb", "zb", "c"], domain=ms, alpha=0.5, transB=1)
    case("QGemm, requantized", "QGemm", {"a": u8(5, 40)},
         {**gemm, "sy": f32(0.8), "zy": np.uint8(30)},
         ["a", "sa", "za", "b", "sb", "zb", "c", "sy", "zy"], domain=ms, transB=1)
    case("MatMulIntegerToFloat", "MatMulIntegerToFloat", {"a": u8(2, 6, 40)},
         {"b": i8(40, 24), "sa": f32(0.03), "sb": (rng.random(24) * 0.1).astype(f32),
          "za": np.uint8(131), "zb": i8(24, lo=-5, hi=5),
          "bias": rng.standard_normal(24).astype(f32)},
         ["a", "b", "sa", "sb", "za", "zb", "bias"], domain=ms)
    case("DynamicQuantizeMatMul", "DynamicQuantizeMatMul",
         {"a": rng.standard_normal((6, 40)).astype(f32) * 2},
         {"b": i8(40, 24), "sb": f32(0.02), "zb": np.int8(3),
          "bias": rng.standard_normal(24).astype(f32)}, ["a", "b", "sb", "zb", "bias"],
         domain=ms)
    case("QAttention", "QAttention", {"x": u8(2, 7, 32)},
         {"w": i8(32, 96), "bias": (rng.standard_normal(96) * 0.1).astype(f32),
          "xs": f32(0.02), "ws": (rng.random(96) * 0.01 + 0.001).astype(f32),
          "m": np.array([7, 4], np.int32), "xz": np.uint8(128), "wz": np.zeros(96, np.int8)},
         ["x", "w", "bias", "xs", "ws", "m", "xz", "wz"], tol=1e-5, domain=ms, num_heads=4)
    return cases


def _resnet50_graph(model: bytes) -> tuple[dict, list, dict]:
    """(the decoded ModelProto as dicts, its nodes, {initializer: array}) of
    a `resnet50_model` graph."""
    from lele_tpu_torch.onnx import schema
    from lele_tpu_torch.onnx.loader import tensor_to_array

    raw = schema.decode_model(model).raw()
    arrays = {t["name"]: tensor_to_array(schema.Proto(t, "TensorProto"))
              for t in raw["graph"]["initializer"]}
    return raw, list(raw["graph"]["node"]), arrays


def _attr(node: dict, name: str, default=None):
    for a in node.get("attribute", []):
        if a["name"] == name:
            return a.get("f", a.get("i", a.get("ints", default)))
    return default


def _folded_convs(nodes: list, arrays: dict) -> dict:
    """Every Conv → BatchNormalization pair of a `resnet50_model` graph as
    one conv: {BN output name: (conv node, W', b')}, W' = W·γ/√(var + ε)
    and b' = β − mean·γ/√(var + ε) per output channel (in float64, stored
    f32): what ORT's quantizers fold before quantizing."""
    import numpy as np

    convs = {n["output"][0]: n for n in nodes if n["op_type"] == "Conv"}
    out = {}
    for n in nodes:
        if n["op_type"] != "BatchNormalization":
            continue
        conv = convs[n["input"][0]]
        g, b, m, v = (arrays[k].astype(np.float64) for k in n["input"][1:])
        s = g / np.sqrt(v + float(_attr(n, "epsilon", 1e-5)))
        w = arrays[conv["input"][1]].astype(np.float64) * s.reshape(-1, 1, 1, 1)
        out[n["output"][0]] = (conv, w.astype(np.float32), (b - m * s).astype(np.float32))
    return out


def resnet50_folded_model(batch="N", **kw) -> bytes:
    """`resnet50_model(batch, **kw)`'s network with each BatchNormalization
    folded into its conv (`_folded_convs`): the same function in float, the
    graph `resnet50_qoperator_model`'s activation ranges are calibrated on
    (`calibrate_minmax` records each conv's input and output, the Gemm's
    input and output)."""
    from lele_tpu_torch.onnx import builder as ob
    from lele_tpu_torch.onnx import schema

    raw, nodes, arrays = _resnet50_graph(resnet50_model(batch, **kw)[0])
    folded = _folded_convs(nodes, arrays)
    keep, inits = [], []
    for n in nodes:
        if n["op_type"] == "Conv":
            continue
        if n["op_type"] == "BatchNormalization":
            conv, w, b = folded[n["output"][0]]
            name = conv["input"][1]
            inits += [ob.tensor_from_array(w, name), ob.tensor_from_array(b, name + "_b")]
            n = {**conv, "input": [conv["input"][0], name, name + "_b"],
                 "output": n["output"]}
        keep.append(n)
    used = {i for n in keep for i in n["input"]}
    raw["graph"]["node"] = keep
    raw["graph"]["initializer"] = inits + [
        t for t in raw["graph"]["initializer"]
        if t["name"] in used and t["name"] not in {i["name"] for i in inits}]
    return schema.encode_message(raw, "ModelProto")


def resnet50_qoperator_model(ranges: dict, batch="N", **kw) -> tuple[bytes, dict]:
    """`resnet50_model(batch, **kw)`'s network in the form ORT's QOperator
    quantizer writes for a ResNet: BatchNormalization folded into the conv
    weights (`_folded_convs`); QuantizeLinear on `data`; QLinearConv with
    per-channel symmetric int8 weights (scale max|W'[c]| / 127, zero point
    0: no weight code saturates), u8 activations and an int32 bias
    (round(b' / (x_scale·w_scale[c]))); a Relu folded into its conv's output
    grid (zero point 0 on [0, max]); MaxPool on u8 (the stem's grid);
    QLinearAdd on each residual, its Relu folded likewise;
    QLinearGlobalAveragePool, Flatten, and QGemm 2048 → 1000 with per-column
    int8 weights, an int32 bias and float output; then Softmax, TopK k = 5
    and ArgMax, as in `resnet50_model`.

    `ranges` are the activations' [min, max] from `calibrate_minmax` of
    `resnet50_folded_model` (same batch and kw): each u8 tensor's grid is
    ORT's asymmetric one (`_u8_qparams`) of its range, [0, max] after a
    folded Relu. The last block's output, which no conv reads, is not
    calibrated: it takes the sum of its two inputs' grid maxima, an upper
    bound. Returns the bytes and {"grids": {u8 tensor: (scale, zp)}, "u8":
    their names in graph order, "int8_products": the graph's integer
    products}."""
    import numpy as np

    from lele_tpu_torch.onnx import builder as ob
    from lele_tpu_torch.onnx import schema
    from lele_tpu_torch.onnx.quantize import _u8_qparams

    raw, nodes, arrays = _resnet50_graph(resnet50_model(batch, **kw)[0])
    folded = _folded_convs(nodes, arrays)
    relu_of = {n["input"][0]: n["output"][0] for n in nodes if n["op_type"] == "Relu"}
    out_nodes, inits, grids, u8 = [], [], {}, []

    def const(name, arr):
        inits.append(ob.tensor_from_array(np.asarray(arr), name))
        return name

    def grid(t, scale, zp):
        grids[t] = (float(np.float32(scale)), int(zp))
        u8.append(t)
        const(f"{t}_scale", np.float32(scale))
        const(f"{t}_zp", np.uint8(zp))
        return [t, f"{t}_scale", f"{t}_zp"]

    def top(t):  # the largest value a grid represents
        scale, zp = grids[t]
        return scale * (255 - zp)

    out_nodes.append(ob.node("QuantizeLinear", ["data", *grid("data_q", *_u8_qparams(
        *ranges["data"]))[1:]], ["data_q"]))
    name_q = {"data": "data_q"}
    for n in nodes:
        op = n["op_type"]
        if op == "BatchNormalization":
            conv, w, b = folded[n["output"][0]]
            x = name_q[conv["input"][0]]
            lo, hi = ranges[n["output"][0]]
            t = relu_of.get(n["output"][0], n["output"][0])
            y = grid(t, *_u8_qparams(0.0 if t != n["output"][0] else lo, hi))
            ws = np.where(np.abs(w).reshape(len(w), -1).max(1) > 0,
                          np.abs(w).reshape(len(w), -1).max(1) / 127.0, 1.0).astype(np.float32)
            wq = np.clip(np.round(w / ws.reshape(-1, 1, 1, 1)), -127, 127).astype(np.int8)
            wname = conv["input"][1]
            bq = np.round(b.astype(np.float64) / (np.float64(grids[x][0]) * ws)).astype(np.int32)
            out_nodes.append({**conv, "input": [
                x, f"{x}_scale", f"{x}_zp", const(f"{wname}_q", wq), const(f"{wname}_s", ws),
                const(f"{wname}_z", np.zeros(len(ws), np.int8)), *y[1:],
                const(f"{wname}_bq", bq)], "output": [t], "op_type": "QLinearConv"})
            name_q[t] = t
        elif op == "MaxPool":
            grid(n["output"][0], *grids[name_q[n["input"][0]]])  # the max of codes
            out_nodes.append(n)
            name_q[n["output"][0]] = n["output"][0]
        elif op == "Add":
            a, c = (name_q[i] for i in n["input"])
            t = relu_of[n["output"][0]]
            hi = ranges[t][1] if t in ranges else top(a) + top(c)
            y = grid(t, *_u8_qparams(0.0, hi))
            out_nodes.append(ob.node("QLinearAdd", [a, f"{a}_scale", f"{a}_zp", c, f"{c}_scale",
                                                    f"{c}_zp", *y[1:]], [t],
                                     domain="com.microsoft"))
            name_q[t] = t
        elif op == "GlobalAveragePool":
            x = name_q[n["input"][0]]
            y = grid("gap", *_u8_qparams(*ranges["flat"]))
            out_nodes.append(ob.node("QLinearGlobalAveragePool", [
                x, f"{x}_scale", f"{x}_zp", *y[1:]], ["gap"], domain="com.microsoft"))
            name_q["gap"] = "gap"
        elif op == "Flatten":
            grid("flat", *grids["gap"])
            out_nodes.append(n)
            name_q["flat"] = "flat"
        elif op == "Gemm":
            wf = arrays[n["input"][1]]  # [classes, 2048], transB = 1
            ws = (np.abs(wf).max(1) / 127.0).astype(np.float32)
            wq = np.clip(np.round(wf / ws[:, None]), -127, 127).astype(np.int8)
            bq = np.round(arrays[n["input"][2]].astype(np.float64)
                          / (np.float64(grids["flat"][0]) * ws)).astype(np.int32)
            out_nodes.append(ob.node("QGemm", [
                "flat", "flat_scale", "flat_zp", const("fc_wq", wq), const("fc_ws", ws),
                const("fc_wz", np.zeros(len(ws), np.int8)), const("fc_bq", bq)],
                n["output"], domain="com.microsoft", transB=1))
        elif op in ("Softmax", "TopK", "ArgMax"):
            out_nodes.append(n)
    k5 = next(t for t in raw["graph"]["initializer"] if t["name"] == "k5")
    raw["graph"]["node"] = out_nodes
    raw["graph"]["initializer"] = inits + [k5]
    raw["opset_import"] = list(raw["opset_import"]) + [
        {"domain": "com.microsoft", "version": 1}]
    n_products = sum(n["op_type"] in ("QLinearConv", "QGemm") for n in out_nodes)
    return schema.encode_message(raw, "ModelProto"), {"grids": grids, "u8": u8,
                                                       "int8_products": n_products}


def ops_phase(checks, dev, card) -> None:
    """Phase 36: the ONNX op layer's math, tensor, nn and activation sets
    (ROADMAP §1.1.1), with a ResNet-50 graph at full width as the slice's
    path. No kernel of the port's own runs here: the convs are cuDNN's, the
    rest the port's emitters.

    (a) `resnet50_model()` (the Model Zoo's resnet50-v1-7 layout, 25.6 M
    parameters, random weights from a seed) compiled by compile_model on the
    card and run at N = 1 and 8, captured (one CUDA graph a bucket): the
    captured call the bits of `replay()`; the logits within RESNET_F32_REL
    of the port's CPU run of the same bytes (f32, TF32 off); TopK and ArgMax
    indices equal at each rank whose margins to both neighbours exceed the
    gate; the bf16
    compute policy at N = 8 within RESNET_BF16_REL; times by CUDA events and
    host clock, captured and step by step, and the busy share of one
    profiled call. (b) `emitter_graphs()`: each on the card, captured where
    its tape allows, against the CPU run of the same bytes; the index graphs
    replayed once more at the end; NonMaxSuppression refused."""
    import numpy as np
    import torch

    from lele_tpu_torch.compiler import compile_model
    from lele_tpu_torch.onnx import builder as ob

    banner("== 36. the ONNX op layer: ResNet-50 at full width, and one graph an emitter")
    t0 = time.perf_counter()
    model, macs = resnet50_model()
    print(f"  resnet50_model(): {len(model) / 1e6:.1f} MB of ONNX, {macs / 1e9:.3f} G "
          f"multiply-adds an image, built in {time.perf_counter() - t0:.2f} s")
    xrng = np.random.default_rng(RESNET_SEED + 1)
    inputs = {n: xrng.standard_normal((n, 3, 224, 224)).astype(np.float32) for n in (1, 8)}
    ref = {}
    for n in (1, 8):
        cpu = compile_model(model, dim_values={"N": n}, device="cpu", strict=True)
        ref[n] = cpu.run_np(data=inputs[n])
        del cpu
    print(f"  CPU reference runs (f32, N = 1 and 8) done at {time.perf_counter() - t0:.1f} s")
    names = ("logits", "probs", "top5", "top5_idx", "argmax")
    for n in (1, 8):
        t1 = time.perf_counter()
        cm = compile_model(model, dim_values={"N": n}, device=dev, strict=True).compile()
        torch.cuda.synchronize()
        compile_s = time.perf_counter() - t1
        x = torch.from_numpy(inputs[n]).to(dev)
        got = [o.clone() for o in cm(data=x)]
        again = cm.replay(data=x)
        torch.cuda.synchronize()
        bits = all(torch.equal(a, b) for a, b in zip(got, again))
        checks.require(cm.stats["captured"] and bits,
                       f"ResNet-50 N = {n}: captured {cm.stats['captured']}, the captured "
                       f"call the bits of replay(): {bits} ({cm.stats['n_steps']} tape steps)")
        out = {k: v.cpu().numpy() for k, v in zip(names, got)}
        want = dict(zip(names, ref[n]))
        d = float(np.abs(out["logits"] - want["logits"]).max())
        scale = float(np.abs(want["logits"]).max())
        checks.require(out["logits"].shape == (n, 1000) and np.isfinite(out["logits"]).all()
                       and d <= RESNET_F32_REL * scale,
                       f"ResNet-50 N = {n} f32 logits vs the CPU: max|d| {d:.3e}, max|ref| "
                       f"{scale:.3f} (gate {RESNET_F32_REL:g} max|ref|)")
        # a rank's index where the CPU's logits set it apart from both of its
        # neighbours by more than the gate
        gate = 2 * RESNET_F32_REL * scale
        srt = np.sort(want["logits"], axis=1)[:, ::-1]
        gaps = srt[:, :5] - srt[:, 1:6]  # rank j to rank j + 1
        decided = gaps > gate
        decided[:, 1:] &= gaps[:, :-1] > gate
        top_ok = bool((out["top5_idx"] == want["top5_idx"])[decided].all())
        arg_ok = bool((out["argmax"].reshape(n) == want["argmax"].reshape(n))[decided[:, 0]].all())
        checks.require(top_ok and arg_ok,
                       f"ResNet-50 N = {n}: TopK and ArgMax indices equal the CPU's at the "
                       f"{int(decided.sum())} of {5 * n} ranks whose margins to both "
                       f"neighbours exceed {gate:.2e}")
        ev = time_ms(lambda: cm(data=x))
        ev_replay = time_ms(lambda: cm.replay(data=x))
        hc = host_ms(lambda: (cm(data=x), torch.cuda.synchronize()))
        hc_replay = host_ms(lambda: (cm.replay(data=x), torch.cuda.synchronize()))
        dev_us, span_us = busy(lambda: (cm(data=x), torch.cuda.synchronize()))
        # the weights and the image read once, the logits written once; two
        # operations a multiply-add
        b_ms, b_by = bound(4 * (sum(p.numel() for p in cm.params.values()) + x.numel()
                                + 1000 * n), {"f32": 2 * macs * n})
        print(f"  ResNet-50 f32 N = {n}: compile and capture {compile_s:.2f} s; captured "
              f"{ev:.4f} ms by events, {hc:.4f} ms by host clock; step by step "
              f"{ev_replay:.4f} / {hc_replay:.4f} ms; busy {dev_us / 1e3:.4f} ms of a "
              f"{span_us / 1e3:.4f} ms profiled call ({dev_us / span_us:.1%}); bound "
              f"{b_ms:.4f} ms by {b_by} ({2 * macs * n / 1e9:.2f} GFLOP f32)  ({card})")
        op_breakdown(lambda: (cm.replay(data=x), torch.cuda.synchronize()),
                     f"ResNet-50 f32 N = {n}, one step-by-step call", card, top=8)
        del cm
    cm16 = compile_model(model, dim_values={"N": 8}, device=dev, strict=True,
                         compute="bfloat16").compile()
    x = torch.from_numpy(inputs[8]).to(dev)
    got = cm16(data=x)[0].cpu().numpy()
    want = ref[8][0]
    d, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    agree = float((got.argmax(1) == want.argmax(1)).mean())
    checks.require(cm16.stats["captured"] and d <= RESNET_BF16_REL * scale,
                   f"ResNet-50 N = 8 bf16 compute vs the CPU's f32 logits: max|d| {d:.3e}, "
                   f"max|ref| {scale:.3f} (gate {RESNET_BF16_REL:g} max|ref|), argmax "
                   f"agreement {agree:.3f}")
    ev16 = time_ms(lambda: cm16(data=x))
    print(f"  ResNet-50 bf16 N = 8: captured {ev16:.4f} ms by events  ({card})")
    del cm16

    print("  (b) one graph an emitter, card against the CPU")
    t1 = time.perf_counter()
    graphs = emitter_graphs()
    worst, uncaptured, held = emitter_runs(checks, dev, graphs,
                                           hold=("GatherND", "ScatterND", "Compress"))
    concrete = [c["name"] for c in graphs if c["concrete"]]
    checks.require(set(uncaptured) <= set(concrete),
                   f"uncapturable graphs: {uncaptured or 'none'}; on concrete values only: "
                   f"{concrete}")
    # the index graphs' device constants belong to their compiled models:
    # after every other graph, and memory freed and refilled with -1, a
    # captured replay still gives its first call's bits
    torch.cuda.empty_cache()
    junk = [torch.full((int(n),), -1, dtype=torch.int64, device=dev)
            for n in np.random.default_rng(RESNET_SEED).integers(1, 4096, 512)]
    del junk
    for name, (cm, feeds, first) in held.items():
        again = [o.cpu().numpy() for o in cm(**feeds)]
        checks.require(cm.stats["captured"] and all(np.array_equal(a, b)
                                                    for a, b in zip(first, again)),
                       f"{name}: a captured replay after {len(worst)} other graphs and "
                       f"refilled memory gives its first call's bits")
    # NonMaxSuppression: refused on every input, as the JAX package refuses it
    nms = emitter_graph_bytes({
        "nodes": [ob.node("NonMaxSuppression", ["b", "s"], ["y0"])], "outputs": ["y0"],
        "inputs": {"b": np.zeros((1, 2, 4), np.float32), "s": np.zeros((1, 1, 2), np.float32)},
        "inits": {}, "opset": 17})
    for where in ("cpu", dev):
        try:
            compile_model(nms, device=where, strict=True)
            refused = False
        except NotImplementedError as e:
            refused = "NMS-free" in str(e)
        checks.require(refused, f"NonMaxSuppression refused on {where} with JAX's hint")
    print(f"  {len(worst)} emitter graphs in {time.perf_counter() - t1:.1f} s; the largest "
          f"gap {max(worst.values()):.2e} ({max(worst, key=worst.get)})")


def with_outputs(model: bytes, names, onnx_dtype: int) -> bytes:
    """The graph with `names` added to its outputs (of one ONNX type)."""
    from lele_tpu_torch.onnx import builder as ob
    from lele_tpu_torch.onnx import schema

    raw = schema.decode_model(model).raw()
    raw["graph"]["output"] = list(raw["graph"]["output"]) + [
        ob.value_info(t, onnx_dtype, []) for t in names]
    return schema.encode_message(raw, "ModelProto")


def kernel_share(fn, kernel: str) -> tuple[float, float]:
    """(the device time of `kernel`'s launches, all device time) in us of
    one call of fn() (ending in a sync) under torch.profiler, after a warm
    call: the share of a path's device time that one kernel takes."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
    rows = device_rows(prof)
    return (sum(us for k, (us, _) in rows.items() if kernel in k),
            sum(us for us, _ in rows.values()))


def quant_phase(checks, dev, card) -> dict:
    """Phase 37: static int8 quantization in ORT's two formats (ROADMAP
    §1.1.2 and the qlinear part of §1.1.4), on `resnet50_model()`'s network
    at full width (53 convs, 25.6 M parameters, 3.858 G multiply-adds an
    image): (a) QDQ, the port's quantize_static on the card with per-channel
    weights, calibrated on QUANT_CALIB batches of 8 images from QUANT_SEED
    (float convs between Q/DQ pairs); (b) QOperator, resnet50_qoperator_model
    on calibrate_minmax's ranges of the BN-folded float graph (QLinearConv,
    QLinearAdd, QLinearGlobalAveragePool, QGemm: every integer product on
    kernel 11, 54 a forward). Each compiled by compile_model on the card and
    run at N = 1 and 8, captured: the captured call equals `replay()` bit
    for bit; against the port's CPU run of the same bytes, QOperator's every
    u8 tensor within QOP_GATE_CODES (bits expected; flipped codes counted)
    and its logits within one QGemm input step, QDQ's logits within
    QDQ_GATE_STEPS of their output grid (the share of flipped codes of every
    QuantizeLinear printed); TopK and ArgMax equal at the ranks the gate
    decides; kernel 11 launched 54 times by a QOperator forward (counts set
    to 0 just before, read just after) and held to int8_matmul_plain at each
    conv shape class; the 17 emitter graphs (`quant_emitter_graphs`)
    captured on the card against the CPU; times by events and host clock,
    captured and step by step, kernel 11's share of a profiled call, the
    int8 bound. Returns kernel 11's launches of one QOperator forward."""
    import gc

    import numpy as np
    import torch

    from lele_tpu_torch import kernels as K
    from lele_tpu_torch.compiler import compile_model
    from lele_tpu_torch.kernels.quant_matmul import int8_matmul, int8_matmul_plain
    from lele_tpu_torch.onnx import schema
    from lele_tpu_torch.onnx.loader import tensor_to_array
    from lele_tpu_torch.onnx.quantize import calibrate_minmax, quantize_static

    banner("== 37. static int8 ResNet-50 in ORT's two formats, QDQ and QOperator (kernel 11), "
           "and one graph a quant emitter")
    t0 = time.perf_counter()
    model, macs = resnet50_model()
    crng = np.random.default_rng(QUANT_SEED)
    batches = [{"data": crng.standard_normal((8, 3, 224, 224)).astype(np.float32)}
               for _ in range(QUANT_CALIB)]
    xrng = np.random.default_rng(QUANT_SEED + 1)
    inputs = {n: xrng.standard_normal((n, 3, 224, 224)).astype(np.float32) for n in (1, 8)}
    qdq = quantize_static(model, batches, per_channel=True, device=dev)
    t_qdq = time.perf_counter() - t0
    ranges = calibrate_minmax(resnet50_folded_model(), batches, device=dev)
    gc.collect()
    torch.cuda.empty_cache()
    qop, info = resnet50_qoperator_model(ranges)
    qop_x = with_outputs(qop, info["u8"], 2)
    qdq_nodes = schema.decode_model(qdq).raw()["graph"]["node"]
    q_outs = [n["output"][0] for n in qdq_nodes if n["op_type"] == "QuantizeLinear"]
    qdq_x = with_outputs(qdq, q_outs, 2)
    inits = {t["name"]: t for t in schema.decode_model(qdq).raw()["graph"]["initializer"]}
    step = float(tensor_to_array(schema.Proto(next(
        t for k, t in inits.items() if k.startswith("logits_scale__qs")), "TensorProto")))
    qraw = schema.decode_model(qop).raw()["graph"]["initializer"]
    qarr = {t["name"]: tensor_to_array(schema.Proto(t, "TensorProto")) for t in qraw
            if t["name"] in ("fc_wq", "fc_ws", "flat_scale")}
    # the logits' change when every QGemm input moves one code
    gemm_step = float(qarr["flat_scale"]) * float(
        (qarr["fc_ws"] * np.abs(qarr["fc_wq"].astype(np.float64)).sum(1)).max())
    print(f"  quantize_static (QDQ, per channel) on the card in {t_qdq:.1f} s: "
          f"{len(q_outs)} QuantizeLinear, "
          f"{sum(n['op_type'] == 'DequantizeLinear' for n in qdq_nodes)} DequantizeLinear; "
          f"QOperator from calibrate_minmax's {len(ranges)} ranges: {info['int8_products']} "
          f"integer products, {len(info['u8'])} u8 tensors; logits step {step:.4e} (QDQ), "
          f"one QGemm input step {gemm_step:.4e} (QOperator); "
          f"{time.perf_counter() - t0:.1f} s")

    names = ("logits", "probs", "top5", "top5_idx", "argmax")
    launches = None
    for form, plain_bytes, checked in (("QOperator", qop, qop_x), ("QDQ", qdq, qdq_x)):
        for n in (1, 8):
            t1 = time.perf_counter()
            cpu = compile_model(checked, dim_values={"N": n}, device="cpu", strict=True)
            ref = cpu.run_np(data=inputs[n])
            del cpu
            t_cpu = time.perf_counter() - t1
            cmx = compile_model(checked, dim_values={"N": n}, device=dev, strict=True).compile()
            x = torch.from_numpy(inputs[n]).to(dev)
            got = [o.clone() for o in cmx(data=x)]
            again = cmx.replay(data=x)
            torch.cuda.synchronize()
            bits = all(torch.equal(a, b) for a, b in zip(got, again))
            checks.require(cmx.stats["captured"] and bits,
                           f"{form} N = {n}: captured {cmx.stats['captured']}, the captured "
                           f"call the bits of replay(): {bits} ({cmx.stats['n_steps']} tape "
                           f"steps)")
            out = [o.cpu().numpy() for o in got]
            del cmx, got, again
            codes = [(a.astype(np.int64), b.astype(np.int64)) for a, b in zip(out[5:], ref[5:])]
            flipped = sum(int((a != b).sum()) for a, b in codes)
            total = sum(a.size for a, _ in codes)
            worst = max(int(np.abs(a - b).max()) for a, b in codes)
            d = float(np.abs(out[0] - ref[0]).max())
            scale = float(np.abs(ref[0]).max())
            if form == "QOperator":
                sat = sum(int(((b == 255) | ((b == 0) & (info["grids"][t][1] > 0))).sum())
                          for (_, b), t in zip(codes, info["u8"]))
                gate = 0.0 if flipped == 0 else gemm_step
                checks.require(worst <= QOP_GATE_CODES and d <= gate
                               and np.isfinite(out[0]).all() and out[0].shape == (n, 1000),
                               f"QOperator N = {n} vs the CPU: {flipped} of {total} u8 codes "
                               f"flipped (largest {worst}, gate {QOP_GATE_CODES}); logits max|d| "
                               f"{d:.3e} at max|ref| {scale:.3f} (gate {gate:.3e}: bits where "
                               f"no code flipped, else one QGemm input step); saturated codes "
                               f"{sat} of {total} ({sat / total:.2e})")
            else:
                gate = QDQ_GATE_STEPS * step
                steps = np.abs(np.round(out[0] / step) - np.round(ref[0] / step))
                checks.require(d <= gate and np.isfinite(out[0]).all()
                               and out[0].shape == (n, 1000),
                               f"QDQ N = {n} vs the CPU: logits max|d| {d:.3e} at max|ref| "
                               f"{scale:.3f} (gate {QDQ_GATE_STEPS} steps of the logits' grid, "
                               f"{gate:.3e}); {flipped} of {total} QuantizeLinear codes flipped "
                               f"({flipped / total:.2e}), logits codes moved {int(steps.sum())} "
                               f"(largest {int(steps.max())} steps)")
            gap = 2 * gate
            srt = np.sort(ref[0], axis=1)[:, ::-1]
            gaps = srt[:, :5] - srt[:, 1:6]
            decided = gaps > gap
            decided[:, 1:] &= gaps[:, :-1] > gap
            top_ok = bool((out[3] == ref[3])[decided].all())
            arg_ok = bool((out[4].reshape(n) == ref[4].reshape(n))[decided[:, 0]].all())
            checks.require(top_ok and arg_ok,
                           f"{form} N = {n}: TopK and ArgMax equal the CPU's at the "
                           f"{int(decided.sum())} of {5 * n} ranks whose margins to both "
                           f"neighbours exceed {gap:.2e}")
            # the timed model: the graph's own outputs
            t1 = time.perf_counter()
            cm = compile_model(plain_bytes, dim_values={"N": n}, device=dev,
                               strict=True).compile()
            torch.cuda.synchronize()
            t_compile = time.perf_counter() - t1
            if form == "QOperator":
                K.reset_launch_counts()
                cm(data=x)
                torch.cuda.synchronize()
                counts = K.launch_counts()
                moved = {k: v for k, v in counts.items() if v}
                checks.require(moved == {"int8_gemm": info["int8_products"]},
                               f"QOperator N = {n}: launches of one captured forward {moved}: "
                               f"kernel 11 once an integer product "
                               f"({info['int8_products']}), nothing else")
                launches = (launches or 0) + counts["int8_gemm"]
            ev = time_ms(lambda: cm(data=x), runs=10)
            ev_r = time_ms(lambda: cm.replay(data=x), runs=10)
            hc = host_ms(lambda: (cm(data=x), torch.cuda.synchronize()))
            hc_r = host_ms(lambda: (cm.replay(data=x), torch.cuda.synchronize()))
            share = ""
            if form == "QOperator":  # the QDQ graph has no integer product
                k11_us, dev_us = kernel_share(
                    lambda: (cm.replay(data=x), torch.cuda.synchronize()), "dq_gemm_strip")
                share = (f"; one step-by-step call's device time {dev_us / 1e3:.4f} ms, "
                         f"kernel 11 {k11_us / 1e3:.4f} ms ({k11_us / max(dev_us, 1e-9):.1%})")
            n_w = sum(p.numel() * p.element_size() for p in cm.params.values())
            b_ms, b_by = bound(n_w + x.numel() * 4 + 4 * 1000 * n, {"int8": 2 * macs * n})
            print(f"  {form} N = {n}: CPU reference {t_cpu:.1f} s; compile and capture "
                  f"{t_compile:.2f} s; captured {ev:.4f} ms by events, {hc:.4f} ms by host "
                  f"clock; step by step {ev_r:.4f} / {hc_r:.4f} ms{share}; int8 bound "
                  f"{b_ms:.4f} ms by {b_by} ({2 * macs * n / 1e9:.2f} G int8 operations, "
                  f"{n_w / 1e6:.1f} MB of params at {PEAK_OPS['int8'] / 1e12:.0f} TOP/s)  "
                  f"({card})")
            if n == 8:
                op_breakdown(lambda: (cm.replay(data=x), torch.cuda.synchronize()),
                             f"{form} N = 8, one step-by-step call", card, top=8)
            del cm
            gc.collect()
            torch.cuda.empty_cache()

    print("  kernel 11 at each conv shape class of the N = 8 forward, against "
          "int8_matmul_plain on the card")
    gen = torch.Generator(device=dev)
    gen.manual_seed(QUANT_SEED)
    for label, (M, Kd, N) in (("stem 7 x 7 / 2, K = 147", (8 * 112 * 112, 147, 64)),
                              ("1 x 1, stage 0", (8 * 56 * 56, 64, 64)),
                              ("3 x 3, stage 1", (8 * 28 * 28, 1152, 128)),
                              ("projection 1 x 1 / 2, stage 1", (8 * 28 * 28, 256, 512)),
                              ("3 x 3, stage 3", (8 * 7 * 7, 4608, 512)),
                              ("QGemm 2048 -> 1000", (8, 2048, 1000))):
        a = torch.randint(-128, 128, (M, Kd), generator=gen, device=dev, dtype=torch.int8)
        b = torch.randint(-127, 128, (Kd, N), generator=gen, device=dev, dtype=torch.int8)
        same = torch.equal(int8_matmul(a, b), int8_matmul_plain(a, b))
        checks.require(same, f"kernel 11 at {label} [{M},{Kd}]x[{Kd},{N}]: "
                             f"int8_matmul_plain's int32 (exact)")
        t_k, t_p = time_ms(lambda: int8_matmul(a, b)), time_ms(lambda: int8_matmul_plain(a, b),
                                                                runs=3, warm=1)
        b_ms, b_by = i8_bound(M, Kd, N)
        print(f"    {label}: kernel 11 {t_k:.4f} ms by events, {graph_us(lambda: int8_matmul(a, b)):.2f}"
              f" us in a CUDA graph, plain {t_p:.4f} ms, bound {b_ms * 1e3:.2f} us by "
              f"{b_by}  ({card})")
        del a, b

    print("  (c) one graph a quant emitter, card against the CPU")
    t1 = time.perf_counter()
    for c in quant_emitter_graphs():
        bs = emitter_graph_bytes(c)
        cpu = compile_model(bs, device="cpu", strict=True).run_np(**c["inputs"])
        K.reset_launch_counts()
        cm = compile_model(bs, device=dev, strict=True)
        got = [o.cpu().numpy() for o in cm(**c["inputs"])]
        k11 = K.launch_counts()["int8_gemm"]
        ok, err = len(got) == len(cpu), 0.0
        for g, w in zip(got, cpu):
            ok = ok and g.shape == w.shape and g.dtype == w.dtype
            if ok and np.issubdtype(w.dtype, np.integer):
                ok = int(np.abs(g.astype(np.int64) - w).max()) <= c["codes"]
                err = max(err, float(np.abs(g.astype(np.int64) - w).max()))
            elif ok:
                e = float(np.abs(g.astype(np.float64) - w).max())
                err = max(err, e / max(1.0, float(np.abs(w).max())))
                ok = ok and err <= c["tol"]
        products = c["nodes"][0]["op_type"] in (
            "ConvInteger", "QLinearConv", "QLinearMatMul", "QGemm", "MatMulIntegerToFloat",
            "DynamicQuantizeMatMul", "QAttention")
        checks.require(ok and cm.stats["captured"] and (k11 > 0) == products,
                       f"{c['name']}: card vs CPU largest difference {err:.3g} (gate "
                       f"{c['codes']} codes, {c['tol']:g} relative); captured "
                       f"{cm.stats['captured']}; kernel 11 launches {k11}")
        del cm
    print(f"  {len(quant_emitter_graphs())} quant emitter graphs in "
          f"{time.perf_counter() - t1:.1f} s")
    return {"int8_gemm": launches}


ENTRY_BURST = 8  # concurrent /recognize requests of one burst (the batchers' max_batch)
ENTRY_CLIENTS = (1, 4, 8)  # concurrent clients of the latency runs
# timed /recognize requests at each client count, split among the clients (kept
# short: the whole script stays within its half-limit aim)
ENTRY_REQUESTS = 150
QW_GATE = 1e-5  # --quantize-weights: max|d| / max|ref| against f64 on the blob's weights
QW_FLOOR = 1e-3  # ... and at least this far off the f32 weights' output (int8 took)
ENTRY_FFN = (196, 512, 2048)  # the CLI's float graph: rows, SenseVoice's d and ffn


def http(url: str, body: bytes | None = None, timeout: float = 300.0):
    """(status, body, content type) of a GET (no body) or a POST."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(urllib.request.Request(url, data=body),
                                    timeout=timeout) as r:
            return r.status, r.read(), r.headers.get("Content-Type", "")
    except urllib.error.HTTPError as e:  # a 4xx/5xx carries the handler's error
        return e.code, e.read(), e.headers.get("Content-Type", "")


def moved(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def record_batches(batcher) -> list:
    """Wrap `batcher.process_batch` to append each batch's requests to the
    list returned."""
    batches, inner = [], batcher.process_batch

    def recorded(items):
        batches.append(list(items))
        return inner(items)

    batcher.process_batch = recorded
    return batches


class Served:
    """The port's server on 127.0.0.1:0, serving on a thread, its ASR and
    detection batchers' `process_batch` wrapped to record each batch's
    requests (`batches`, `det_batches`)."""

    def __init__(self, engines: dict):
        import threading

        from lele_tpu_torch.server import serve

        self.engines = engines
        self.batches = record_batches(engines["asr_batcher"])
        self.det_batches = (record_batches(engines["det_batcher"]) if "det_batcher" in engines
                            else [])
        self.httpd = serve(port=0, engines=engines)
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self.thread.start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(60)
        for k in ("asr_batcher", "det_batcher"):
            if k in self.engines:
                self.engines[k].close()


def mixed_traffic(url: str, engines: dict, asr_batches: list, det_batches: list, seed: int,
                  voice=None) -> tuple[list[str], list[int], list[int]]:
    """Every route at once: ENTRY_BURST /recognize of 1-10 s (through the
    ASR batcher), two /recognize_batch of 3 (padded to 4, as a batcher's
    batch of 4 is), two /detect and four /synthesize (two texts and the
    same texts reversed), all in flight together in a seeded order. Each
    answer must be 200 and equal to the engine called directly afterwards:
    a /recognize what `recognize_batch` gives the batch it joined, a
    /detect what `detect_batch` gives its batch (`asr_batches` and
    `det_batches` record them: `record_batches`). → (what disagreed, the
    ASR batches' sizes, the detection batches')."""
    import base64
    import concurrent.futures

    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    burst = [wav_bytes(synth_speechlike(s, rng)) for s in np.linspace(1.0, 10.0, ENTRY_BURST)]
    lists = [[wav_bytes(synth_speechlike(s, rng)) for s in ss]
             for ss in ((1.0, 2.0, 4.3), (0.5, 3.0, 9.0))]
    images = []
    for _ in range(2):
        buf = io.BytesIO()
        Image.fromarray(rng.integers(0, 256, (240, 320, 3), dtype=np.uint8)).save(buf, "JPEG")
        images.append(buf.getvalue())
    texts = list(TTS_TEXTS[:2]) + [t[::-1] for t in TTS_TEXTS[:2]]
    jobs = ([("/recognize", w) for w in burst]
            + [("/recognize_batch", json.dumps([base64.b64encode(w).decode() for w in ws])
                .encode()) for ws in lists]
            + [("/detect", im) for im in images]
            + [("/synthesize", json.dumps({"text": t, "voice": voice}).encode()) for t in texts])
    seen = len(asr_batches), len(det_batches)
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as ex:
        futures = {int(i): ex.submit(http, url + jobs[i][0], jobs[i][1])
                   for i in rng.permutation(len(jobs))}
        got = {i: f.result() for i, f in futures.items()}
    bad = [f"{jobs[i][0]} #{i} answered {st}: {body[:200]!r}"
           for i, (st, body, _) in sorted(got.items()) if st != 200]
    asr_formed, det_formed = asr_batches[seen[0]:], det_batches[seen[1]:]
    if bad:
        return bad, [len(b) for b in asr_formed], [len(b) for b in det_formed]
    answers = {jobs[i][1]: json.loads(body) if jobs[i][0] != "/synthesize" else body
               for i, (_, body, _) in got.items()}
    asr, det, tts = engines["asr"], engines["det"], engines["tts"]
    for b in asr_formed:
        if [answers[w]["ids"] for w in b] != asr.recognize_batch(b):
            bad.append(f"/recognize: a batch of {len(b)} answered other than recognize_batch")
    for ws in lists:
        body = json.dumps([base64.b64encode(w).decode() for w in ws]).encode()
        if answers[body] != {"results": asr.recognize_batch(ws)}:
            bad.append(f"/recognize_batch of {len(ws)} answered other than recognize_batch")
    for b in det_formed:
        if ([answers[im]["detections"] for im in b]
                != json.loads(json.dumps(det.detect_batch(b)))):
            bad.append(f"/detect: a batch of {len(b)} answered other than detect_batch")
    for t in texts:
        if answers[json.dumps({"text": t, "voice": voice}).encode()] != tts.synthesize(
                t, voice=voice):
            bad.append(f"/synthesize of {t[:20]!r}...: other WAV bytes than synthesize's")
    if sum(map(len, asr_formed)) != ENTRY_BURST:
        bad.append(f"the ASR batcher ran {sum(map(len, asr_formed))} of {ENTRY_BURST} requests")
    return bad, [len(b) for b in asr_formed], [len(b) for b in det_formed]


def served_requests(checks, label: str, srv: Served, jpeg: bytes, voice) -> dict:
    """Every route of the server at `srv` once, each answer 200 and held to
    the engine called directly on the same input (bits: ids, detections and
    WAV bytes equal), the launches of a request to those of the direct call:
    /healthz, the demo page, /recognize on REQUEST_SECONDS, a burst of
    ENTRY_BURST concurrent /recognize requests (each answer what
    recognize_batch gives the batch it joined; a flush of more than one),
    /recognize_batch, /detect and /synthesize; then every route at once
    (`mixed_traffic`), which the engines' `CARD_LOCK` keeps apart.
    → {path: launches}."""
    import base64
    import concurrent.futures

    import numpy as np
    import torch

    from lele_tpu_torch import kernels as K
    from lele_tpu_torch.server import DEMO_PAGE

    engines, url, asr = srv.engines, srv.url, srv.engines["asr"]
    out: dict[str, dict] = {}

    def counted(fn):
        K.reset_launch_counts()
        r = fn()
        torch.cuda.synchronize()
        return r, K.launch_counts()

    st, body, _ = http(url + "/healthz")
    checks.require(st == 200 and json.loads(body) == {"ok": True, "mesh": None},
                   f"{label}: /healthz {st} {body!r}")
    st, body, ctype = http(url + "/")
    checks.require(st == 200 and ctype.startswith("text/html") and body == DEMO_PAGE.read_bytes(),
                   f"{label}: / {st} {ctype}, {len(body)} bytes, lele_tpu_torch/web/index.html's")
    rng = np.random.default_rng(SEED + 38)
    singles = [wav_bytes(synth_speechlike(s, rng)) for s in REQUEST_SECONDS]
    for s, w in zip(REQUEST_SECONDS, singles):
        asr.recognize(w)  # the bucket's program captured before the counted calls
        (st, body, _), served = counted(lambda w=w: http(url + "/recognize", w))
        direct, own = counted(lambda w=w: asr.recognize(w))
        got = json.loads(body) if st == 200 else body
        checks.require(st == 200 and got == {"ids": direct} and served == own,
                       f"{label}: /recognize {s} s: {st}, {len(direct)} ids, "
                       f"SenseVoiceEngine.recognize's; launches {moved(served)} = the "
                       f"engine's own {moved(own)}")
        out[f"/recognize {s} s"] = moved(served)

    burst = [wav_bytes(synth_speechlike(s, rng)) for s in np.linspace(1.0, 10.0, ENTRY_BURST)]
    seen, flushes = len(srv.batches), len(engines["asr_batcher"].batch_sizes)
    with concurrent.futures.ThreadPoolExecutor(ENTRY_BURST) as ex:
        rs, served = counted(lambda: list(ex.map(lambda w: http(url + "/recognize", w), burst)))
    formed, sizes = srv.batches[seen:], engines["asr_batcher"].batch_sizes[flushes:]
    answers = {w: json.loads(b)["ids"] for w, (st, b, _) in zip(burst, rs) if st == 200}
    direct, own = counted(lambda: [asr.recognize_batch(b) for b in formed])
    checks.require(len(answers) == ENTRY_BURST and sorted(map(len, formed)) == sorted(sizes)
                   and all([answers[w] for w in b] == d for b, d in zip(formed, direct)),
                   f"{label}: a burst of {ENTRY_BURST} concurrent /recognize requests (1-10 s) "
                   f"answered {[st for st, _, _ in rs]}, in batches of {sizes}: each answer "
                   f"is what recognize_batch gives its batch")
    checks.require(max(sizes) > 1, f"{label}: the ASR batcher flushed a batch of {max(sizes)}")
    checks.require(served == own, f"{label}: the burst's launches {moved(served)} = "
                                  f"recognize_batch's on the same batches {moved(own)}")
    out[f"/recognize burst of {ENTRY_BURST} ({len(sizes)} batches)"] = moved(served)

    body = json.dumps([base64.b64encode(w).decode() for w in singles]).encode()
    (st, resp, _), served = counted(lambda: http(url + "/recognize_batch", body))
    direct, own = counted(lambda: asr.recognize_batch(singles))
    checks.require(st == 200 and json.loads(resp) == {"results": direct} and served == own,
                   f"{label}: /recognize_batch of {len(singles)}: {st}, recognize_batch's "
                   f"answers; launches {moved(served)} = {moved(own)}")
    out["/recognize_batch of 3"] = moved(served)

    det = engines["det"]
    det.detect(jpeg)
    (st, resp, _), served = counted(lambda: http(url + "/detect", jpeg))
    direct, own = counted(lambda: json.loads(json.dumps(det.detect(jpeg))))
    checks.require(st == 200 and json.loads(resp) == {"detections": direct} and served == own,
                   f"{label}: /detect of a {len(jpeg)}-byte JPEG: {st}, {len(direct)} detections, "
                   "Yolo26Engine.detect's")

    tts, text = engines["tts"], TTS_TEXTS[0]
    req = json.dumps({"text": text, "voice": voice}).encode()
    tts.synthesize(text, voice=voice)
    (st, wav, ctype), served = counted(lambda: http(url + "/synthesize", req))
    direct, own = counted(lambda: tts.synthesize(text, voice=voice))
    checks.require(st == 200 and ctype == "audio/wav" and wav == direct and served == own,
                   f"{label}: /synthesize of {len(text)} characters: {st} {ctype}, "
                   f"{len(wav)} bytes, TtsEngine.synthesize's; launches {moved(served)} = "
                   f"{moved(own)}")
    out["/synthesize"] = moved(served)

    t0 = time.perf_counter()
    bad, asr_sizes, det_sizes = mixed_traffic(url, engines, srv.batches, srv.det_batches,
                                              SEED + 384, voice)
    checks.require(not bad, f"{label}: every route at once ({ENTRY_BURST} /recognize, 2 "
                            f"/recognize_batch, 2 /detect, 4 /synthesize in flight together): "
                            f"each answer the engine's direct call; ASR batches {asr_sizes}, "
                            f"detection {det_sizes}; {time.perf_counter() - t0:.2f} s"
                            + "".join(f"; {b}" for b in bad[:4]))
    return out


def latency_runs(srv: Served, card: str) -> dict:
    """p50 and p90 by host clock of /recognize (REQUEST_SECONDS in turn) for
    each of ENTRY_CLIENTS concurrent clients, ENTRY_REQUESTS requests at each
    count, split evenly among the clients, each client sending its share back
    to back after one untimed round, every batch program captured before;
    percentiles over all the requests, the rate over the whole window; the
    batch sizes."""
    import collections
    import concurrent.futures

    import numpy as np

    rng = np.random.default_rng(SEED + 380)
    wavs = [wav_bytes(synth_speechlike(s, rng)) for s in REQUEST_SECONDS]
    batcher, stats, asr = srv.engines["asr_batcher"], {}, srv.engines["asr"]
    # every program a timed batch can take (a batch of b runs at the padded
    # B = 1, 2, 4 or 8 and its longest request's bucket) captured first
    for b in (1, 2, 4, 8):
        for w in wavs:
            asr.recognize_batch([w] * b)
    progs = len(asr.model.programs)
    for c in ENTRY_CLIENTS:
        def client(i, rounds):
            times = []
            for r in range(rounds):
                t0 = time.perf_counter()
                st, _, _ = http(srv.url + "/recognize", wavs[(i + r) % len(wavs)])
                times.append(((time.perf_counter() - t0) * 1e3, st))
            return times

        with concurrent.futures.ThreadPoolExecutor(c) as ex:
            list(ex.map(lambda i: client(i, 1), range(c)))
            before = len(batcher.batch_sizes)
            t0 = time.perf_counter()
            runs = [t for ts in ex.map(lambda i: client(i, ENTRY_REQUESTS // c), range(c))
                    for t in ts]
            wall = time.perf_counter() - t0
        ms = np.array([t for t, _ in runs])
        sizes = collections.Counter(batcher.batch_sizes[before:])
        stats[c] = {"p50": float(np.percentile(ms, 50)), "p90": float(np.percentile(ms, 90)),
                    "max": float(ms.max()), "rps": len(runs) / wall,
                    "ok": all(st == 200 for _, st in runs), "n": len(runs)}
        print(f"  {c} client(s) x {ENTRY_REQUESTS // c} /recognize (1.0 / 4.3 / 10 s in turn): p50 "
              f"{stats[c]['p50']:.2f} ms, p90 {stats[c]['p90']:.2f} ms, max {ms.max():.2f} ms "
              f"by host clock over {len(runs)} requests; {len(runs) / wall:.1f} requests/s over "
              f"the {wall:.3f} s window; batch sizes {dict(sorted(sizes.items()))}; "
              f"programs captured before {progs}, after {len(asr.model.programs)}  ({card})")
    return stats


def ffn_graph(seed: int) -> bytes:
    """A float FFN at SenseVoice's widths (x [196, 512] → MatMul 512 → 2048,
    Add, Relu → MatMul 2048 → 512), weights from a seed: the CLI's
    quantize forms' input."""
    import numpy as np

    from lele_tpu_torch.onnx import builder as ob

    M, D, F = ENTRY_FFN
    rng = np.random.default_rng(seed)
    w1 = (rng.standard_normal((D, F)) / D ** 0.5).astype(np.float32)
    w2 = (rng.standard_normal((F, D)) / F ** 0.5).astype(np.float32)
    b1 = (rng.standard_normal(F) * 0.1).astype(np.float32)
    return ob.build_model_bytes(
        [ob.node("MatMul", ["x", "w1"], ["h"]), ob.node("Add", ["h", "b1"], ["hb"]),
         ob.node("Relu", ["hb"], ["r"]), ob.node("MatMul", ["r", "w2"], ["y"])],
        [ob.value_info("x", 1, [M, D])], [ob.value_info("y", 1, [M, D])],
        [ob.tensor_from_array(w1, "w1"), ob.tensor_from_array(b1, "b1"),
         ob.tensor_from_array(w2, "w2")])


def load_wrapper(path: Path):
    """A generated wrapper's class, loaded by file spec."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"chip_smoke_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return getattr(mod, path.stem)


def traced_copy(gen: Path, dest: Path) -> Path:
    """The CLI's output in `gen` without its AOT bundle: the wrapper copied
    (it reads its files beside itself) and the blob and graph linked, so the
    wrapper traces the graph. → dest."""
    dest.mkdir()
    (dest / "PhaseSanm.py").write_bytes((gen / "PhaseSanm.py").read_bytes())
    for f in gen.iterdir():
        if f.suffix in (".bin", ".json", ".onnx"):
            (dest / f.name).symlink_to(f)
    return dest


WRAPPER_RUN = """
import json, sys, time
import numpy as np
t0 = time.perf_counter()
sys.path.insert(0, sys.argv[1])
from PhaseSanm import PhaseSanm
from lele_tpu_torch import kernels as K
feeds = dict(np.load(sys.argv[2]))
m = PhaseSanm()
t_load = time.perf_counter() - t0
counts = []
for _ in range(2):
    K.reset_launch_counts()
    outs = m.forward(**feeds)
    counts.append({k: v for k, v in K.launch_counts().items() if v})
np.savez(sys.argv[3], *outs)
print(json.dumps({"counts": counts, "captured": m._cm.stats["captured"],
                  "device": str(m._cm.device), "load_s": t_load}))
"""


def entry_points_phase(checks, dev, card, graph: bytes, cm, feeds: dict, gen: Path) -> dict:
    """Phase 38: the port's entry points at full width. The server twice
    (ThreadingHTTPServer on 127.0.0.1:0): build_engines()'s full-width JAX
    defaults, and engines on the main path (w8a16 SenseVoice, the fused
    Supertonic of tts.json, the default YOLO26); every route held to the
    engines' direct calls (`served_requests`), /recognize latencies at 1, 4
    and 8 clients on the main path (`latency_runs`). The CLI: phase 6's
    int8 SAN-M graph through `python -m lele_tpu_torch.cli ... --aot --xc`
    in a subprocess, writing to `gen` (phase 43 starts its AOT forms from
    there), its wrapper traced in a second fresh one from a copy without
    the bundle (`traced_copy`; kernels 4 and 5 once a call, the outputs
    `cm`'s bits on `feeds`); --quantize-weights against
    f64 on its blob's dequantized weights, off the f32 output (the int8
    took), --quantize-dynamic the bits of
    quantize_dynamic + compile_model, build_model from a local model.toml.
    → {kernel: {path: launches}}."""
    import dataclasses
    import tempfile

    import numpy as np
    import torch

    from lele_tpu_torch import kernels as K
    from lele_tpu_torch.build_tool import build_model
    from lele_tpu_torch.cli import main as cli_main
    from lele_tpu_torch.compiler import compile_model
    from lele_tpu_torch.compiler.weights import load_weights
    from lele_tpu_torch.models import (SenseVoiceConfig, SenseVoiceModel, SupertonicConfig,
                                       SupertonicTts, cast_big_params, prepare_w8_params,
                                       stack_layer_params)
    from lele_tpu_torch.onnx.quantize import quantize_dynamic
    from lele_tpu_torch.runtime.batcher import MicroBatcher
    from lele_tpu_torch.server import build_engines
    from lele_tpu_torch.serving import SenseVoiceEngine, TtsEngine

    banner(f"== 38. the entry points: lele_tpu_torch.server at full width, the CLI and its "
          f"wrapper, build_model ({card})")
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.random.default_rng(SEED + 381).integers(0, 256, (480, 640, 3),
                                                               dtype=np.uint8)).save(buf, "JPEG")
    jpeg = buf.getvalue()
    launches: dict[str, dict[str, int]] = {}

    def record(path, counts):
        for k, v in counts.items():
            launches.setdefault(k, {})[path] = v

    tmp = tempfile.TemporaryDirectory()
    folder = Path(tmp.name)
    procs = []
    try:
        onnx_path = folder / "sensevoice_int8.onnx"
        onnx_path.write_bytes(graph)
        t_pad = feeds["speech"].shape[1]
        np.savez(folder / "feeds.npz", **{k: (v.cpu().numpy() if torch.is_tensor(v) else v)
                                          for k, v in feeds.items()})
        t_cli = time.perf_counter()
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "lele_tpu_torch.cli", str(onnx_path), str(gen),
             "PhaseSanm", "--dim", f"T={t_pad}", "--aot", "--xc"],
            cwd=Path(__file__).resolve().parent,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))

        t0 = time.perf_counter()
        engines = build_engines(device=dev)
        t_build = time.perf_counter() - t0
        srv = Served(engines)
        try:
            served_requests(checks, "build_engines() (JAX's full-width defaults)", srv, jpeg,
                            None)
        finally:
            srv.close()
        print(f"  build_engines() in {t_build:.2f} s, its routes in "
              f"{time.perf_counter() - t0 - t_build:.2f} s (host clock)")

        cli_out, _ = procs[0].communicate(timeout=300)
        t_cli = time.perf_counter() - t_cli
        checks.require(procs[0].returncode == 0 and (gen / "PhaseSanm.py").exists(),
                       f"python -m lele_tpu_torch.cli on the {len(graph) / 1e6:.1f} MB int8 "
                       f"SAN-M graph (--dim T={t_pad}): exit {procs[0].returncode} in "
                       f"{t_cli:.1f} s: {cli_out.strip().splitlines()[-2:]}")
        t_wrap = time.perf_counter()
        procs.append(subprocess.Popen(
            [sys.executable, "-c", WRAPPER_RUN, str(traced_copy(gen, folder / "traced")),
             str(folder / "feeds.npz"),
             str(folder / "outs.npz")], cwd=Path(__file__).resolve().parent,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))

        # the other CLI forms, in this process, on a float FFN at SenseVoice's widths
        ffn_path = folder / "ffn.onnx"
        ffn_path.write_bytes(ffn_graph(SEED + 382))
        M, D, F = ENTRY_FFN
        x = np.random.default_rng(SEED + 383).standard_normal((M, D)).astype(np.float32)
        t0 = time.perf_counter()
        rc = cli_main([str(ffn_path), str(folder / "qw"), "PhaseQw", "--quantize-weights"])
        qw = load_wrapper(folder / "qw" / "PhaseQw.py")().forward(x)[0]
        ref_cm = compile_model(str(ffn_path), device=dev)
        y_float = ref_cm.run_np(x)[0]
        # the reference is the FFN in f64 on the blob's own weights (int8 x
        # scale, dequantized by load_weights), so the gate is the f32
        # products' rounding alone; the int8 weights must have taken: the
        # output moves off the f32 weights' by more than QW_FLOOR
        manifest = json.loads((folder / "qw" / "PhaseQw_weights.json").read_text())["tensors"]
        blob = load_weights(folder / "qw" / "PhaseQw_weights")
        w1, b1, w2 = (blob[n].double().numpy() for n in ("w1", "b1", "w2"))
        ref = np.maximum(x.astype(np.float64) @ w1 + b1, 0) @ w2
        top = float(np.abs(ref).max())
        err, moved_by = float(np.abs(qw - ref).max()), float(np.abs(qw - y_float).max())
        quantized = sorted(n for n, e in manifest.items() if "dequant_scale" in e)
        checks.require(rc == 0 and quantized == ["w1", "w2"] and err <= QW_GATE * top
                       and moved_by > QW_FLOOR * top,
                       f"CLI --quantize-weights (float FFN {M}x{D}->{F}->{D}): int8 in the blob "
                       f"{quantized}; the wrapper against the FFN in f64 on the blob's "
                       f"dequantized weights: max|d| {err:.3e} = {err / top:.2e} of max|ref| "
                       f"{top:.3f} (gate {QW_GATE:g}); off the f32 weights' output by "
                       f"{moved_by / top:.2e} of it (floor {QW_FLOOR:g})")
        rc = cli_main([str(ffn_path), str(folder / "qd"), "PhaseQd", "--quantize-dynamic"])
        qd_wrapper = load_wrapper(folder / "qd" / "PhaseQd.py")()
        K.reset_launch_counts()
        qd = qd_wrapper.forward(x)
        torch.cuda.synchronize()
        qd_counts = moved(K.launch_counts())
        qbytes = quantize_dynamic(ffn_path.read_bytes())
        q_ref = compile_model(qbytes, device=dev).run_np(x)
        checks.require(rc == 0 and (folder / "qd" / "ffn.int8.onnx").read_bytes() == qbytes
                       and all(np.array_equal(a, b) for a, b in zip(qd, q_ref)),
                       f"CLI --quantize-dynamic: ffn.int8.onnx is quantize_dynamic's bytes, the "
                       f"wrapper the bits of its compile_model; launches a call {qd_counts}")
        record("--quantize-dynamic wrapper, a call", qd_counts)
        (folder / "model.toml").write_text(
            '[model]\nsource = "local"\npath = "ffn.onnx"\n[codegen]\nclass_name = "PhaseBuilt"\n')
        built = build_model(folder / "model.toml", folder / "built")
        y_built = (load_wrapper(built)().forward(x)[0] if "STUB" not in built.read_text()
                   else None)
        checks.require(y_built is not None and np.array_equal(y_built, ref_cm.run_np(x)[0]),
                       f"build_model of a local model.toml: {built.name}, a real wrapper "
                       f"(not a stub) giving compile_model's bits")
        print(f"  CLI quantize forms and build_model in {time.perf_counter() - t0:.2f} s "
              f"(host clock)")

        wrap_out, wrap_err = procs[1].communicate(timeout=300)
        t_wrap = time.perf_counter() - t_wrap
        res = json.loads(wrap_out.strip().splitlines()[-1]) if procs[1].returncode == 0 else {}
        got = list(np.load(folder / "outs.npz").values()) if res else []
        want = cm.run_np(**feeds)
        counts = res.get("counts", [{}])
        checks.require(bool(res) and res["device"].startswith("cuda") and res["captured"]
                       and all(c == {"sanm_stack_dql": 1, "dq_gemm": 1} for c in counts),
                       f"the generated wrapper in a fresh process on {res.get('device')}: "
                       f"captured {res.get('captured')}, launches of its two calls {counts} "
                       f"(kernels 4 and 5 once each a call); {wrap_err.strip()[-300:]}")
        checks.require(len(got) == len(want) and all(np.array_equal(a, b)
                                                     for a, b in zip(got, want)),
                       f"the wrapper's logits {[a.shape for a in got]}: the bits of "
                       f"compile_model of the same graph in this process")
        record("CLI wrapper, a call", counts[-1])
        print(f"  the CLI subprocess {t_cli:.1f} s (trace, blob, wrapper); the wrapper's "
              f"subprocess {t_wrap:.1f} s, of which start-up to a captured model "
              f"{res.get('load_s', float('nan')):.1f} s (host clock)  ({card})")

        # the main path's server: w8a16 ASR, the fused TTS of tts.json
        model = SenseVoiceModel(SenseVoiceConfig(weight_int8=True), device=dev)
        model.init(SEED)
        model.params = stack_layer_params(prepare_w8_params(cast_big_params(model.params,
                                                                            torch.bfloat16)))
        asr = SenseVoiceEngine(model=model)
        tts_cfg = dataclasses.replace(
            SupertonicConfig.from_json(EXAMPLES / "supertonic" / "tts.json"),
            fused_estimator=True)
        tts_m = SupertonicTts(tts_cfg, device=dev)
        tts_m.init(SEED)
        tts = TtsEngine(tts=tts_m)
        tts.load_style(str(EXAMPLES / "supertonic" / "voice_styles" / "F1.json"), "F1")
        det = engines["det"]
        main_engines = {"asr": asr, "asr_batcher": MicroBatcher(asr.recognize_batch, 8, 5.0),
                        "det": det, "det_batcher": MicroBatcher(det.detect_batch, 8, 5.0),
                        "tts": tts}
        srv = Served(main_engines)
        try:
            paths = served_requests(checks, "the main path's engines (w8a16 ASR, fused TTS)",
                                    srv, jpeg, "F1")
            lone = paths[f"/recognize {REQUEST_SECONDS[-1]} s"]
            checks.require(lone == {"sanm_stack_w8": 1, "w8_gemm": 1},
                           f"a lone /recognize on w8a16: kernel 1 and kernel 2 once ({lone})")
            checks.require(set(paths["/synthesize"]) == {"est_block"},
                           f"/synthesize on the fused TTS: kernel 10 only "
                           f"({paths['/synthesize']})")
            for path, counts in paths.items():
                record(path, counts)
            stats = latency_runs(srv, card)
            checks.require(all(s["ok"] for s in stats.values()),
                           f"every timed /recognize answered 200 ({sum(s['n'] for s in stats.values())}"
                           " requests)")
        finally:
            srv.close()
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        tmp.cleanup()
    print(f"  launches {launches}")
    return launches


FRONTEND_SECONDS = (4.3, 10.0)  # phase 39 (a): the lengths of phase 38's WAVs
FRONTEND_SEED = GRAPH_SEED + 39
SD_BLOCK = dict(channels=320, groups=32, side=64, batch=2)  # SD 1.5's UNet, first block
SD_SEED = SEED + 39
CLIP_MLP = (154, 768, 3072)  # CLIP ViT-L/14's text MLP: 2 x 77 tokens, d 768, 4 d


def frontend_model(n_samples: int, L: int = 50, d: int = 512, h: int = 4, ffn: int = 2048,
                   vocab: int = 25055, seed: int = FRONTEND_SEED, sanm=None,
                   encoder: bool = True) -> bytes:
    """Phase 39 (a)'s graph: SenseVoice's log-mel front-end written in ONNX
    ops at FbankConfig's widths, feeding `build_sanm_int8_graph`'s int8
    encoder and CTC head (opset 20). pcm [1, n_samples] f32 → pre-emphasis
    (y[0] kept) and the x32768 scale; frames as a Gather of a host-built
    index [F, 400]; the symmetric HannWindow(400); Pad to 512 and DFT
    (opset 20's axis input -2, onesided) → [1, F, 257, 2]; ReduceSumSquare;
    MatMul by MelWeightMatrix(80, 512, 16000, 20, 8000); Max with 1e-5, Log
    (the second output, `logmel`); LFR as a Gather of lfr_stack's index
    (m 7, n 6: three copies of the first frame in front) and a Reshape to
    [1, T, 560]; CMVN as Add and Mul with initializers from the seed; the
    encoder's `speech`. The other inputs stay the encoder's (speech_lengths,
    language, textnorm). The mel bank is the ONNX op's integer-bin one, not
    the native front-end's, so the two log-mels are not compared. `sanm`
    is a `build_sanm_int8_graph` result to reuse (the same seed's encoder for
    every length); `encoder=False` gives the front-end alone, its outputs
    `speech` and `logmel`."""
    import numpy as np

    from lele_tpu_torch.features.fbank import FbankConfig
    from lele_tpu_torch.onnx import builder as ob
    from lele_tpu_torch.onnx.synth import build_sanm_int8_graph, serialize_sanm_graph

    c = FbankConfig()
    n_frames = c.num_frames(n_samples)
    t_lfr = -(-n_frames // c.lfr_n)
    din = c.n_mels * c.lfr_m
    if not encoder:
        nodes, inits, inputs = [], {}, []
        outputs = [ob.value_info("speech", 1, [1, t_lfr, din])]
    else:
        nodes, inits, inputs, outputs = sanm or build_sanm_int8_graph(
            L=L, d=d, h=h, ffn=ffn, vocab=vocab, din=din, seed=seed, int8_head=True)
    rng = np.random.default_rng(seed + 1)
    i64 = lambda *v: np.asarray(v, np.int64)  # noqa: E731
    pad = (c.lfr_m - 1) // 2
    fe = {
        "fe_ax1": i64(1), "fe_s0": i64(0), "fe_s1": i64(1), "fe_end": i64(n_samples),
        "fe_end1": i64(n_samples - 1), "fe_pre": np.float32(c.preemphasis),
        "fe_scale": np.float32(c.scale),
        "fe_frames": (np.arange(n_frames)[:, None] * c.hop_len
                      + np.arange(c.frame_len)[None, :]).astype(np.int64),
        "fe_win_n": np.asarray(c.frame_len, np.int64),
        "fe_pads": i64(0, 0, 0, 0, 0, c.n_fft - c.frame_len),
        "fe_ax3": i64(3), "fe_axis": np.asarray(-2, np.int64),
        "fe_last": i64(-1),
        "fe_nm": np.asarray(c.n_mels, np.int64), "fe_nfft": np.asarray(c.n_fft, np.int64),
        "fe_sr": np.asarray(c.sample_rate, np.int64), "fe_flo": np.float32(c.f_min),
        "fe_fhi": np.float32(c.sample_rate / 2), "fe_floor": np.float32(c.log_floor),
        "fe_lfr": np.clip(np.arange(t_lfr)[:, None] * c.lfr_n + np.arange(c.lfr_m)[None, :]
                          - pad, 0, n_frames - 1).astype(np.int64),
        "fe_lfr_shape": i64(1, t_lfr, din),
        "fe_neg_mean": (-rng.normal(9.0, 2.0, din)).astype(np.float32),
        "fe_inv_std": (1.0 / rng.uniform(2.0, 5.0, din)).astype(np.float32),
    }
    front = [
        ob.node("Slice", ["pcm", "fe_s1", "fe_end", "fe_ax1"], ["fe_tail"]),
        ob.node("Slice", ["pcm", "fe_s0", "fe_end1", "fe_ax1"], ["fe_head"]),
        ob.node("Mul", ["fe_head", "fe_pre"], ["fe_head_p"]),
        ob.node("Sub", ["fe_tail", "fe_head_p"], ["fe_diff"]),
        ob.node("Slice", ["pcm", "fe_s0", "fe_s1", "fe_ax1"], ["fe_first"]),
        ob.node("Concat", ["fe_first", "fe_diff"], ["fe_emph"], axis=1),
        ob.node("Mul", ["fe_emph", "fe_scale"], ["fe_x"]),
        ob.node("Gather", ["fe_x", "fe_frames"], ["fe_fr"], axis=1),  # [1, F, 400]
        ob.node("HannWindow", ["fe_win_n"], ["fe_win"], periodic=0),
        ob.node("Mul", ["fe_fr", "fe_win"], ["fe_wfr"]),
        ob.node("Pad", ["fe_wfr", "fe_pads"], ["fe_padded"]),  # [1, F, 512]
        ob.node("Unsqueeze", ["fe_padded", "fe_ax3"], ["fe_sig"]),  # [1, F, 512, 1]
        ob.node("DFT", ["fe_sig", "", "fe_axis"], ["fe_spec"], onesided=1),  # [1, F, 257, 2]
        ob.node("ReduceSumSquare", ["fe_spec", "fe_last"], ["fe_power"], keepdims=0),
        ob.node("MelWeightMatrix", ["fe_nm", "fe_nfft", "fe_sr", "fe_flo", "fe_fhi"],
                ["fe_melw"]),
        ob.node("MatMul", ["fe_power", "fe_melw"], ["fe_mel"]),
        ob.node("Max", ["fe_mel", "fe_floor"], ["fe_melc"]),
        ob.node("Log", ["fe_melc"], ["logmel"]),
        ob.node("Gather", ["logmel", "fe_lfr"], ["fe_stk"], axis=1),  # [1, T, 7, 80]
        ob.node("Reshape", ["fe_stk", "fe_lfr_shape"], ["fe_lfr_out"]),
        ob.node("Add", ["fe_lfr_out", "fe_neg_mean"], ["fe_centred"]),
        ob.node("Mul", ["fe_centred", "fe_inv_std"], ["speech"]),
    ]
    inputs = [ob.value_info("pcm", 1, [1, n_samples])] + [
        vi for vi in inputs if vi["name"] != "speech"]
    outputs = outputs + [ob.value_info("logmel", 1, [1, n_frames, c.n_mels])]
    return serialize_sanm_graph(front + nodes, {**fe, **inits}, inputs, outputs, opset=20)


def frontend_feeds(pcm) -> dict:
    """The front-end graph's inputs for one waveform (T valid frames, the
    auto language and textnorm ids)."""
    import numpy as np

    from lele_tpu_torch.features.fbank import FbankConfig

    c = FbankConfig()
    t_lfr = -(-c.num_frames(pcm.size) // c.lfr_n)
    return {"pcm": pcm.reshape(1, -1).astype(np.float32),
            "speech_lengths": np.asarray([t_lfr], np.int64),
            "language": np.asarray([0], np.int32), "textnorm": np.asarray([0], np.int32)}


def sd_block_model(channels: int = 320, groups: int = 32, side: int = 64, batch: int = 2,
                   seed: int = SD_SEED) -> tuple[bytes, int]:
    """Phase 39 (b)'s graph: the first block of a Stable Diffusion 1.5 UNet in
    ORT's `--model_type unet` form, f32, random weights from the seed. h NHWC
    [batch, side, side, C] and temb [batch, C] → a resnet block (GroupNorm
    with swish, NhwcConv 3x3, SkipGroupNorm with temb as its [N, C] skip and
    swish, NhwcConv 3x3, BiasAdd with h as the skip), then the transformer's
    GEGLU feed-forward on the batch x side^2 tokens (LayerNormalization,
    MatMul C → 8 C, BiasSplitGelu, MatMul 4 C → C, BiasAdd with the
    residual). Returns the bytes and the multiply-adds of one call."""
    import numpy as np

    from lele_tpu_torch.onnx import builder as ob

    rng = np.random.default_rng(seed)
    C, n_tok = channels, side * side

    def w(*shape, fan_in):
        return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)

    def vec(n, mean=0.0, scale=0.1):
        return (mean + scale * rng.standard_normal(n)).astype(np.float32)

    inits = {
        "gn1_g": vec(C, 1.0), "gn1_b": vec(C), "conv1_w": w(C, C, 3, 3, fan_in=9 * C),
        "conv1_b": vec(C), "gn2_g": vec(C, 1.0), "gn2_b": vec(C),
        "conv2_w": w(C, C, 3, 3, fan_in=9 * C), "conv2_b": vec(C),
        "tok_shape": np.asarray([batch, n_tok, C], np.int64),
        "ln_g": vec(C, 1.0), "ln_b": vec(C), "ff1_w": w(C, 8 * C, fan_in=C),
        "ff1_b": vec(8 * C), "ff2_w": w(4 * C, C, fan_in=4 * C), "ff2_b": vec(C),
        "out_shape": np.asarray([batch, side, side, C], np.int64),
    }
    conv = dict(kernel_shape=[3, 3], pads=[1, 1, 1, 1], domain="com.microsoft")
    ms = dict(domain="com.microsoft")
    nodes = [
        ob.node("GroupNorm", ["h", "gn1_g", "gn1_b"], ["gn1"], groups=groups,
                epsilon=1e-5, channels_last=1, activation=1, **ms),
        ob.node("NhwcConv", ["gn1", "conv1_w", "conv1_b"], ["c1"], **conv),
        ob.node("SkipGroupNorm", ["c1", "gn2_g", "gn2_b", "temb"], ["gn2"], groups=groups,
                epsilon=1e-5, activation=1, **ms),
        ob.node("NhwcConv", ["gn2", "conv2_w"], ["c2"], **conv),
        ob.node("BiasAdd", ["c2", "conv2_b", "h"], ["res"], **ms),
        ob.node("Reshape", ["res", "tok_shape"], ["tok"]),
        ob.node("LayerNormalization", ["tok", "ln_g", "ln_b"], ["ln"], axis=-1, epsilon=1e-5),
        ob.node("MatMul", ["ln", "ff1_w"], ["ff1"]),
        ob.node("BiasSplitGelu", ["ff1", "ff1_b"], ["geglu"], **ms),
        ob.node("MatMul", ["geglu", "ff2_w"], ["ff2"]),
        ob.node("BiasAdd", ["ff2", "ff2_b", "tok"], ["tok_out"], **ms),
        ob.node("Reshape", ["tok_out", "out_shape"], ["y"]),
    ]
    bs = ob.build_model_bytes(
        nodes, [ob.value_info("h", 1, [batch, side, side, C]),
                ob.value_info("temb", 1, [batch, C])],
        [ob.value_info("y", 1, [batch, side, side, C])],
        [ob.tensor_from_array(v, k) for k, v in inits.items()])
    macs = batch * n_tok * (2 * 9 * C * C + 8 * C * C + 4 * C * C)
    return bs, macs


def tail_emitter_graphs(seed: int = SD_SEED) -> list[dict]:
    """One small graph for each of the 51 emitters of ROADMAP §1.1.3 and
    §1.1.4 (more for DFT's, Hardmax's and GridSample's forms), and
    GemmFastGelu at CLIP ViT-L/14's text MLP widths, in `emitter_graphs`'
    form plus "folds": a string graph, which folds away on the host (no
    step on the card; its outputs are numeric, as a string graph output is
    refused). Det goes last: its card form is cuSOLVER's LU, the one
    emitter here whose capture is not known beforehand."""
    import numpy as np

    from lele_tpu_torch.onnx import builder as ob

    rng = np.random.default_rng(seed)

    def f32(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    def i64(*v):
        return np.asarray(v, np.int64)

    def strings(*v):
        a = np.empty(len(v), dtype=object)
        a[:] = v
        return a

    x4, x3, x2 = f32(2, 3, 8, 8), f32(2, 4, 6), f32(4, 6)
    unit = rng.uniform(-0.9, 0.9, (4, 6)).astype(np.float32)
    ints = rng.integers(0, 64, (4, 6)).astype(np.int32)
    cases = []

    def graph(name, nodes, inputs, inits=None, outputs=("y0",), opset=17, tol=1e-5,
              folds=False):
        cases.append({"name": name, "nodes": nodes, "inputs": inputs, "inits": inits or {},
                      "outputs": list(outputs), "opset": opset, "tol": tol,
                      "concrete": False, "folds": folds})

    def case(name, op_type, inputs, inits=None, n_out=1, opset=17, tol=1e-5, names=None,
             domain="", **attrs):
        outs = [f"y{i}" for i in range(n_out)]
        node = ob.node(op_type, names or list(inputs) + list(inits or {}), outs,
                       domain=domain, **attrs)
        graph(name, [node], inputs, inits, outs, opset, tol)

    ms = "com.microsoft"
    # -- extra_ops
    case("Acosh", "Acosh", {"x": (np.abs(x2) + 1.1).astype(np.float32)})
    case("Asinh", "Asinh", {"x": x2})
    case("Atanh", "Atanh", {"x": unit})
    case("BitShift LEFT", "BitShift", {"x": ints, "y": (ints % 4).astype(np.int32)},
         direction="LEFT")
    case("BitShift RIGHT", "BitShift", {"x": ints, "y": (ints % 3).astype(np.int32)},
         direction="RIGHT")
    for op_type in ("BitwiseAnd", "BitwiseOr", "BitwiseXor"):
        case(op_type, op_type, {"a": ints, "b": ints[::-1].copy()})
    case("BitwiseNot", "BitwiseNot", {"a": ints})
    case("Shrink", "Shrink", {"x": x2}, lambd=0.4, bias=0.1)
    ties = np.round(x3, 0)
    case("Hardmax", "Hardmax", {"x": ties}, opset=13, axis=1)
    case("Hardmax opset 11", "Hardmax", {"x": ties}, opset=11, axis=1)
    case("EyeLike", "EyeLike", {"x": x2}, k=1, dtype=1)
    case("ReduceLogSum", "ReduceLogSum", {"x": np.abs(x3) + 0.1}, {"a": i64(0, 2)},
         opset=18)
    case("LRN", "LRN", {"x": x4}, size=3, alpha=2e-4, beta=0.7, bias=1.5)
    case("GlobalLpPool", "GlobalLpPool", {"x": x4}, p=3)
    case("LpPool", "LpPool", {"x": x4}, kernel_shape=[3, 2], strides=[2, 2],
         pads=[1, 0, 1, 1], p=2)
    case("ReverseSequence", "ReverseSequence", {"x": f32(5, 3, 2)}, {"l": i64(5, 3, 1)},
         batch_axis=1, time_axis=0)
    for op_type in ("HannWindow", "HammingWindow", "BlackmanWindow"):
        graph(op_type, [ob.node(op_type, ["n"], ["w"], periodic=0),
                        ob.node("Mul", ["x", "w"], ["y0"])],
              {"x": f32(3, 16)}, {"n": np.asarray(16, np.int64)})
    graph("MelWeightMatrix", [
        ob.node("MelWeightMatrix", ["nm", "nf", "sr", "lo", "hi"], ["m"]),
        ob.node("MatMul", ["x", "m"], ["y0"])], {"x": f32(4, 33)},
        {"nm": np.asarray(8, np.int64), "nf": np.asarray(64, np.int64),
         "sr": np.asarray(8000, np.int64), "lo": np.float32(20.0), "hi": np.float32(3800.0)})
    case("DFT onesided", "DFT", {"x": f32(2, 16, 1)}, onesided=1)
    case("DFT inverse", "DFT", {"x": f32(2, 16, 2)}, inverse=1)
    case("DFT opset 20 axis input", "DFT", {"x": f32(2, 3, 10, 2)},
         {"n": np.asarray(16, np.int64), "a": np.asarray(-3, np.int64)}, opset=20)
    case("Bernoulli", "Bernoulli", {"p": rng.uniform(0, 1, (4, 32)).astype(np.float32)})
    case("Multinomial", "Multinomial", {"p": f32(3, 5)}, sample_size=7)
    logp = np.log(rng.dirichlet(np.ones(5), 6)).astype(np.float32)
    tgt = i64(0, 4, -1, 2, 3, -1)
    case("NegativeLogLikelihoodLoss", "NegativeLogLikelihoodLoss", {"x": logp, "t": tgt},
         {"w": rng.uniform(0.5, 1.5, 5).astype(np.float32)}, reduction="mean",
         ignore_index=-1)
    case("SoftmaxCrossEntropyLoss", "SoftmaxCrossEntropyLoss",
         {"x": f32(3, 5, 4), "t": rng.integers(0, 5, (3, 4)).astype(np.int64)}, n_out=2,
         reduction="none")
    case("CenterCropPad", "CenterCropPad", {"x": x3}, {"s": i64(7, 3)}, axes=[1, 2])
    case("Col2Im", "Col2Im", {"c": f32(2, 3 * 4, 9)}, {"im": i64(5, 6), "bl": i64(2, 2)},
         strides=[2, 2], dilations=[1, 2], pads=[1, 0, 0, 1])
    pooled = f32(2, 3, 3, 3)
    plane = np.arange(36).reshape(6, 6)[::2, ::2].reshape(1, 1, 3, 3)
    idx = (plane + (np.arange(6).reshape(2, 3, 1, 1)) * 36).astype(np.int64)
    case("MaxUnpool", "MaxUnpool", {"x": pooled}, {"i": idx}, kernel_shape=[2, 2],
         strides=[2, 2])
    case("Scatter", "Scatter", {"d": x2, "u": f32(4, 2)},
         {"i": np.asarray([[0, 5], [1, 2], [3, 3], [4, 0]], np.int64)},
         names=["d", "i", "u"], opset=10, axis=1)
    grid = rng.uniform(-1.3, 1.3, (2, 4, 5, 2)).astype(np.float32)
    case("GridSample bilinear zeros", "GridSample", {"x": x4, "g": grid})
    case("GridSample nearest border", "GridSample", {"x": x4, "g": grid}, mode="nearest",
         padding_mode="border", align_corners=1)
    case("GridSample reflection", "GridSample", {"x": x4, "g": grid},
         padding_mode="reflection")
    rois = np.asarray([[0.5, 1.0, 7.0, 6.5], [2.0, 2.0, 5.0, 7.5]], np.float32)
    case("RoiAlign", "RoiAlign", {"x": x4, "r": rois}, {"b": i64(1, 0)},
         output_height=3, output_width=2, sampling_ratio=0, mode="avg")
    case("MaxRoiPool", "MaxRoiPool", {"x": x4, "r": np.asarray(
        [[0, 8.0, 8.0, 40.0, 30.0], [1, 0.0, 0.0, 16.0, 60.0]], np.float32)},
        pooled_shape=[2, 3], spatial_scale=0.125)
    case("AffineGrid", "AffineGrid", {"t": f32(2, 2, 3)}, {"s": i64(2, 3, 5, 7)}, opset=20)
    # -- deform_ops, string_ops, tfidf_ops
    case("DeformConv", "DeformConv", {"x": f32(1, 4, 7, 7), "o": f32(1, 2 * 2 * 9, 5, 5),
                                      "m": rng.uniform(0, 1, (1, 2 * 9, 5, 5))
                                      .astype(np.float32)},
         {"w": f32(6, 2, 3, 3, scale=0.3), "b": f32(6)}, names=["x", "w", "o", "b", "m"],
         group=2, offset_group=2)
    graph("StringConcat + RegexFullMatch", [
        ob.node("StringConcat", ["s", "t"], ["st"]),
        ob.node("RegexFullMatch", ["st"], ["y0"], pattern=r"ba._\d")],
        {}, {"s": strings("foo", "bar", "baz"), "t": strings("_1", "_2", "_x")},
        folds=True)
    graph("StringSplit", [ob.node("StringSplit", ["s"], ["tok", "y0"], delimiter=",")],
          {}, {"s": strings("a,b,c", "x", "", "p,q")}, folds=True)
    graph("StringNormalizer", [
        ob.node("StringNormalizer", ["s"], ["n"], case_change_action="LOWER",
                stopwords=["the", "and"]),
        ob.node("RegexFullMatch", ["n"], ["y0"], pattern="cat|dog")],
        {}, {"s": strings("The", "cat", "AND", "the", "Dog")}, folds=True)
    graph("TfIdfVectorizer strings", [ob.node(
        "TfIdfVectorizer", ["s"], ["y0"], mode="TF", min_gram_length=1, max_gram_length=2,
        ngram_counts=[0, 2], ngram_indexes=[0, 1, 2],
        pool_strings=["cat", "sat", "the", "cat"])],
        {}, {"s": strings("the", "cat", "sat", "the", "cat")}, folds=True)
    case("TfIdfVectorizer int64", "TfIdfVectorizer",
         {"x": rng.integers(0, 8, (3, 12)).astype(np.int64)}, mode="TFIDF",
         min_gram_length=1, max_gram_length=3, max_skip_count=1, ngram_counts=[0, 3, 7],
         ngram_indexes=list(range(6)), pool_int64s=[2, 3, 5, 2, 3, 5, 1, 2, 3, 5],
         weights=[0.5, 1.0, 2.0, 4.0, 8.0, 3.0])
    # -- fused_ops (com.microsoft)
    case("FusedConv", "FusedConv", {"x": x4, "z": f32(2, 4, 8, 8)},
         {"w": f32(4, 3, 3, 3, scale=0.3), "b": f32(4)}, names=["x", "w", "b", "z"],
         domain=ms, pads=[1, 1, 1, 1], activation="Relu")
    case("FusedGemm", "FusedGemm", {"a": x2}, {"b": f32(5, 6), "c": f32(5)}, domain=ms,
         transB=1, activation="LeakyRelu", activation_alpha=0.2)
    case("ConvTransposeWithDynamicPads", "ConvTransposeWithDynamicPads",
         {"x": f32(1, 4, 5, 6)}, {"w": f32(4, 3, 3, 3, scale=0.3), "p": i64(1, 0, 0, 1)},
         domain=ms, strides=[2, 2])
    case("BiasSoftmax", "BiasSoftmax", {"x": f32(2, 4, 5, 6), "b": f32(2, 1, 5, 6)},
         domain=ms, axis=2, is_inner_broadcast=1)
    case("RelativePositionBias", "RelativePositionBias", {"t": f32(32, 4)},
         {"q": i64(9), "k": i64(13)}, domain=ms, max_distance=16, is_bidirectional=1)
    # -- diffusion_ops (com.microsoft)
    nhwc = f32(2, 6, 6, 8)
    gb = {"g": f32(8, scale=0.5) + 1, "b": f32(8)}
    case("GroupNorm", "GroupNorm", {"x": nhwc}, gb, domain=ms, groups=4, activation=1)
    case("SkipGroupNorm", "SkipGroupNorm", {"x": nhwc, "s": f32(2, 8)},
         {**gb, "bias": f32(8)}, n_out=2, names=["x", "g", "b", "s", "bias"], domain=ms,
         groups=2)
    case("NhwcConv", "NhwcConv", {"x": nhwc}, {"w": f32(4, 4, 3, 3, scale=0.3),
                                              "b": f32(4)}, domain=ms, group=2,
         pads=[1, 1, 1, 1])
    case("BiasSplitGelu", "BiasSplitGelu", {"x": f32(2, 5, 12)}, {"b": f32(12)}, domain=ms)
    case("BiasAdd", "BiasAdd", {"x": f32(2, 5, 8), "s": f32(2, 5, 8)}, {"b": f32(8)},
         names=["x", "b", "s"], domain=ms)
    case("GemmFastGelu", "GemmFastGelu", {"x": f32(5, 8)}, {"w": f32(8, 12), "b": f32(12)},
         domain=ms)
    m, k, n = CLIP_MLP
    case("GemmFastGelu CLIP ViT-L/14 text MLP", "GemmFastGelu", {"x": f32(m, k)},
         {"w": f32(k, n, scale=k ** -0.5), "b": f32(n)}, domain=ms)
    case("Det", "Det", {"x": f32(3, 4, 4)})
    return cases


def emitter_runs(checks, dev, graphs: list[dict], hold=()) -> tuple[dict, dict, dict]:
    """Each graph compiled on the card and run (captured where its tape
    allows) against the CPU run of the same bytes, max|d| within its "tol"
    of max(1, max|ref|), NaN and infinite positions equal. A graph whose
    capture fails runs step by step and is reported, with the reason; a
    "folds" graph must hold no step (nothing runs on the card). Returns
    ({name: gap}, {name: why a graph was not captured}, {name: (cm, feeds,
    first outputs)} of the names in `hold`)."""
    import numpy as np

    from lele_tpu_torch.compiler import compile_model
    from lele_tpu_torch.runtime.graphs import CaptureError

    worst, uncaptured, held = {}, {}, {}
    for c in graphs:
        bs = emitter_graph_bytes(c)
        cpu = compile_model(bs, device="cpu", strict=True).run_np(**c["inputs"])
        cm = compile_model(bs, device=dev, strict=True)
        try:
            got = [o.cpu().numpy() for o in cm(**c["inputs"])]
        except CaptureError as e:
            uncaptured[c["name"]] = str(e).splitlines()[0][:160]
            got = [o.cpu().numpy() for o in cm.replay(**c["inputs"])]
        if c["name"] in hold:
            held[c["name"]] = cm, c["inputs"], got
        if not cm.stats["capturable"]:
            uncaptured.setdefault(c["name"], "a step reads the host (not capturable)")
        ok = len(got) == len(cpu)
        err = 0.0
        for g, w in zip(got, cpu):
            ok = ok and g.shape == w.shape and np.array_equal(np.isnan(g), np.isnan(w))
            if ok and g.size:
                g, w = g.astype(np.float64), w.astype(np.float64)
                fin = np.isfinite(w)
                ok = ok and np.array_equal(g[~fin & ~np.isnan(w)], w[~fin & ~np.isnan(w)])
                e = float(np.abs(g[fin] - w[fin]).max()) if fin.any() else 0.0
                err = max(err, e / max(1.0, float(np.abs(w[fin]).max()) if fin.any() else 1.0))
        worst[c["name"]] = err
        if c.get("folds"):
            ok = ok and cm.stats["n_steps"] == 0
        checks.require(ok and err <= c["tol"] and (cm.stats["captured"] or c["concrete"]
                                                   or c["name"] in uncaptured),
                       f"{c['name']}: card vs CPU max|d| {err:.2e} of max(1, max|ref|) (gate "
                       f"{c['tol']:g}); captured {cm.stats['captured']}, "
                       f"{cm.stats['n_steps']} tape steps")
    return worst, uncaptured, held


# cuFFT and pocketfft sum in other orders: 1e-4 at first, tightened to twice
# the largest reading (2.5e-5 max|ref| at 10 s, 7.0e-6 at 4.3 s; NVIDIA H100
# 80GB HBM3, 700.00 W)
FRONTEND_LOGMEL_REL = 5e-5
# the front-end graph's logits: phase 6's MAE gate; its argmax gate sits
# inside this graph's own noise (the card against itself at a 1e-7 PCM step
# agreed on 0.877 of the frames at 10 s, the CPU against itself 0.877; same
# card), so the agreement is held within this much of that noise's
FRONTEND_AGREE_SLACK = 0.05
# f32, TF32 off, cuDNN's and the CPU's convs summing in other orders: 1e-4
# at first, tightened from the first reading (1.3e-6 max|ref|, same card)
SD_REL = 1e-5


def op_tail_phase(checks, dev, card, phase6_hits: dict) -> dict:
    """Phase 39: the rest of the ONNX op layer (ROADMAP §1.1.3 and §1.1.4).

    (a) `frontend_model`: SenseVoice's log-mel front-end in ONNX ops (DFT,
    HannWindow, MelWeightMatrix) feeding the full-width int8 encoder and CTC
    head, compiled at 4.3 s and 10 s and captured: kernel 4 once and kernel
    5 once a call, phase 6's pattern hits, log-mel and logits against the
    port's CPU run of the same bytes (log-mel within FRONTEND_LOGMEL_REL
    max|ref|, logits within phase 6's MAE gate and an argmax agreement held
    to the graph's own noise at a 1e-7 PCM step); times captured and
    step by step by events and host clock, the busy share, the front-end
    alone against kernels 4 and 5. (b) `sd_block_model`: SD 1.5's first
    UNet block in ORT's fused form at published widths, f32, within SD_REL
    max|ref| of the CPU; times, busy share and bound. (c)
    `tail_emitter_graphs`: one graph an emitter against the CPU. Returns the
    launches of kernels 4 and 5 over (a)'s calls."""
    import numpy as np
    import torch

    from lele_tpu_torch import kernels as K
    from lele_tpu_torch.compiler import compile_model
    from lele_tpu_torch.onnx.synth import build_sanm_int8_graph

    banner("== 39. the rest of the op layer: an ONNX log-mel front-end before SenseVoice's "
           "int8 encoder, an SD 1.5 UNet block, one graph an emitter")
    t_phase = time.perf_counter()
    sanm = build_sanm_int8_graph(L=50, d=512, h=4, ffn=2048, vocab=25055, din=560,
                                 seed=FRONTEND_SEED, int8_head=True)
    rng = np.random.default_rng(FRONTEND_SEED)
    totals = {"sanm_stack_dql": 0, "dq_gemm": 0}
    for secs in FRONTEND_SECONDS:
        pcm = synth_speechlike(secs, rng)
        t0 = time.perf_counter()
        bs = frontend_model(pcm.size, sanm=sanm)
        feeds = frontend_feeds(pcm)
        cpu = compile_model(bs, device="cpu", strict=True)
        ref_logits, ref_mel = cpu.run_np(**feeds)
        del cpu
        t1 = time.perf_counter()
        cm = compile_model(bs, device=dev, strict=True).compile()
        tfeeds = {k: torch.from_numpy(v).to(dev) for k, v in feeds.items()}
        K.reset_launch_counts()
        logits, logmel = (o.clone() for o in cm(**tfeeds))
        torch.cuda.synchronize()
        launches = K.launch_counts()
        compile_s = time.perf_counter() - t1
        for k in totals:
            totals[k] += launches[k]
        hits = cm.stats["pattern_hits"]
        checks.require(launches["sanm_stack_dql"] == 1 and launches["dq_gemm"] == 1,
                       f"front-end graph {secs} s: kernel 4 {launches['sanm_stack_dql']}, "
                       f"kernel 5 {launches['dq_gemm']} launches in one call (1 each)")
        checks.require(hits == phase6_hits, f"front-end graph {secs} s: pattern hits {hits} "
                                            f"(phase 6's graph: {phase6_hits})")
        checks.require(cm.stats["captured"],
                       f"front-end graph {secs} s captured: {cm.stats['captured']} (the DFT "
                       f"node inside the CUDA graph), {cm.stats['n_steps']} tape steps")
        d_mel = float(np.abs(logmel.cpu().numpy() - ref_mel).max())
        s_mel = float(np.abs(ref_mel).max())
        checks.require(tuple(logmel.shape) == ref_mel.shape and d_mel <= FRONTEND_LOGMEL_REL
                       * s_mel, f"front-end graph {secs} s log-mel {tuple(logmel.shape)} vs "
                       f"the CPU: max|d| {d_mel:.3e}, max|ref| {s_mel:.3f} (gate "
                       f"{FRONTEND_LOGMEL_REL:g} max|ref|)")
        ref = torch.from_numpy(ref_logits).to(dev)
        dmax, rmax, mae = compare(logits, ref)
        agree = (logits.argmax(-1) == ref.argmax(-1)).float().mean().item()
        # the graph's own quantization noise: the card against itself, and
        # the CPU against itself, at a 1e-7 PCM step (phase 6's probe)
        step = frontend_feeds((pcm * (1 + 1e-7 * np.random.default_rng(FRONTEND_SEED + 2)
                                      .standard_normal(pcm.size))).astype(np.float32))
        noise = cm(pcm=torch.from_numpy(step["pcm"]).to(dev),
                   **{k: v for k, v in tfeeds.items() if k != "pcm"})[0]
        _, _, n_mae = compare(noise, logits)
        n_agree = (noise.argmax(-1) == logits.argmax(-1)).float().mean().item()
        cpu_noise = torch.from_numpy(compile_model(bs, device="cpu", strict=True)
                                     .run_np(**step)[0])
        _, _, c_mae = compare(cpu_noise, torch.from_numpy(ref_logits))
        c_agree = (cpu_noise.argmax(-1) == torch.from_numpy(ref_logits).argmax(-1)) \
            .float().mean().item()
        agree_gate = min(LOGIT_NOISE_AGREE, n_agree, c_agree) - FRONTEND_AGREE_SLACK
        checks.require(tuple(logits.shape) == ref_logits.shape
                       and bool(torch.isfinite(logits).all())
                       and mae <= LOGIT_NOISE_MAE and agree >= agree_gate,
                       f"front-end graph {secs} s logits {tuple(logits.shape)} vs the CPU: "
                       f"max|d| {dmax:.3e} of {rmax:.3f}, MAE {mae:.3e} std, argmax "
                       f"agreement {agree:.4f} (gate {LOGIT_NOISE_MAE} std, {agree_gate:.4f}); "
                       f"noise at a 1e-7 PCM step: card {n_mae:.3e} std, {n_agree:.4f}; CPU "
                       f"{c_mae:.3e} std, {c_agree:.4f}")
        ev = time_ms(lambda: cm(**tfeeds))
        ev_step = time_ms(lambda: cm.replay(**tfeeds))
        hc = host_ms(lambda: (cm(**tfeeds), torch.cuda.synchronize()))
        hc_step = host_ms(lambda: (cm.replay(**tfeeds), torch.cuda.synchronize()))
        dev_us, span_us = busy(lambda: (cm(**tfeeds), torch.cuda.synchronize()))
        front = compile_model(frontend_model(pcm.size, encoder=False), device=dev,
                              strict=True).compile()
        fe_ms = time_ms(lambda: front(pcm=tfeeds["pcm"]))
        k4, total = kernel_share(lambda: (cm.replay(**tfeeds), torch.cuda.synchronize()),
                                 "sanm_dql_kernel")
        k5, _ = kernel_share(lambda: (cm.replay(**tfeeds), torch.cuda.synchronize()),
                             "dq_gemm")
        _, fe_dev = kernel_share(lambda: (front.replay(pcm=tfeeds["pcm"]),
                                          torch.cuda.synchronize()), "")
        print(f"  front-end graph {secs} s ({pcm.size} samples, {logmel.shape[1]} frames, "
              f"T {logits.shape[1] - 4}): built and CPU-run in {t1 - t0:.1f} s, compiled and "
              f"captured in {compile_s:.2f} s; captured {ev:.4f} ms by events, {hc:.4f} ms by "
              f"host clock; step by step {ev_step:.4f} / {hc_step:.4f} ms; busy "
              f"{dev_us / 1e3:.4f} ms of a {span_us / 1e3:.4f} ms profiled call "
              f"({dev_us / span_us:.1%}); the DFT node captured: {cm.stats['captured']}  "
              f"({card})")
        print(f"    the front-end alone (every node before the encoder): captured "
              f"{fe_ms:.4f} ms by events, device {fe_dev:.1f} us step by step; in one "
              f"step-by-step call of the whole graph ({total:.1f} us of device time) kernel "
              f"4 {k4:.1f} us, kernel 5 {k5:.1f} us, by the profiler  ({card})")
        del cm, front
    print(f"  (a) done in {time.perf_counter() - t_phase:.1f} s")

    t1 = time.perf_counter()
    bs, macs = sd_block_model()
    b, side, C = SD_BLOCK["batch"], SD_BLOCK["side"], SD_BLOCK["channels"]
    srng = np.random.default_rng(SD_SEED + 1)
    feeds = {"h": srng.standard_normal((b, side, side, C)).astype(np.float32),
             "temb": srng.standard_normal((b, C)).astype(np.float32)}
    (ref,) = compile_model(bs, device="cpu", strict=True).run_np(**feeds)
    cm = compile_model(bs, device=dev, strict=True).compile()
    tfeeds = {k: torch.from_numpy(v).to(dev) for k, v in feeds.items()}
    got = cm(**tfeeds)[0].cpu().numpy()
    d, scale = float(np.abs(got - ref).max()), float(np.abs(ref).max())
    checks.require(cm.stats["captured"] and got.shape == ref.shape and np.isfinite(got).all()
                   and d <= SD_REL * scale,
                   f"SD 1.5 UNet block [{b}, {side}, {side}, {C}] vs the CPU: max|d| {d:.3e}, "
                   f"max|ref| {scale:.3f} (gate {SD_REL:g} max|ref|); captured "
                   f"{cm.stats['captured']}, {cm.stats['n_steps']} tape steps")
    ev = time_ms(lambda: cm(**tfeeds))
    ev_step = time_ms(lambda: cm.replay(**tfeeds))
    hc = host_ms(lambda: (cm(**tfeeds), torch.cuda.synchronize()))
    dev_us, span_us = busy(lambda: (cm(**tfeeds), torch.cuda.synchronize()))
    n_params = sum(p.numel() for p in cm.params.values())
    b_ms, b_by = bound(4 * (n_params + 2 * feeds["h"].size + feeds["temb"].size),
                       {"f32": 2 * macs})
    print(f"  SD 1.5 UNet block f32 (batch {b}, {side} x {side} x {C}, {2 * macs / 1e9:.2f} "
          f"GFLOP): captured {ev:.4f} ms by events, {hc:.4f} ms by host clock; step by step "
          f"{ev_step:.4f} ms; busy {dev_us / 1e3:.4f} ms of a {span_us / 1e3:.4f} ms profiled "
          f"call ({dev_us / span_us:.1%}); bound {b_ms:.4f} ms by {b_by}  ({card})")
    op_breakdown(lambda: (cm.replay(**tfeeds), torch.cuda.synchronize()),
                 "SD block, one step-by-step call", card, top=8)
    del cm
    print(f"  (b) done in {time.perf_counter() - t1:.1f} s")

    t1 = time.perf_counter()
    worst, uncaptured, _ = emitter_runs(checks, dev, tail_emitter_graphs())
    print(f"  (c) {len(worst)} emitter graphs in {time.perf_counter() - t1:.1f} s; the largest "
          f"gap {max(worst.values()):.2e} ({max(worst, key=worst.get)}); not captured: "
          + ("; ".join(f"{k}: {v}" for k, v in uncaptured.items()) or "none"))
    print(f"  phase 39 in {time.perf_counter() - t_phase:.1f} s")
    return totals


# phase 40: the com.microsoft search and packed sets at full width (ROADMAP
# §1.1.5). GPT-2 small's published widths (GPT2) and Whisper-tiny's decoder
# widths (WHISPER_TINY, as phase 33 uses them), BERT-base's for the packed
# stack; random weights from a seed at GPT-2's and BERT's init scale (0.02)
SEARCH_SEED = SEED + 40
SEARCH_PROMPTS = (16, 9)  # two prompts, the shorter left-padded to 16
SEARCH_MAX_LENGTH = 48
SEARCH_PER_OP_LENGTH = 24  # (a)'s per-op check: 8 generated tokens
SEARCH_BEAMS = 4
SEARCH_RETURN = 2
SEARCH_NGRAM = 3
SEARCH_REPETITION = 1.1
WHISPER_SEARCH_MAX_LENGTH = 32
# <|startoftranscript|> <|en|> <|transcribe|> <|notimestamps|>
WHISPER_PREFIX = (50258, 50259, 50359, 50363)
WHISPER_EOT = 50257
WHISPER_BATCH = 2
PACKED_BERT = dict(layers=12, d=768, heads=12, ffn=3072, batch=8, seq=128)
SEARCH_SCORE_REL = 1e-4  # sequences_scores, card against the CPU
# (a) is int8: each linear quantizes its activation on the activation's global
# range, so a last-bit difference between the card's f32 and the CPU's moves
# a code now and then, and twelve layers and the beam search carry it on.
# At GPT-2 small's widths the card against itself with the embedding 1e-7
# (relative) away moves the scores by up to 6.3e-3 and parts the ids; wider
# weights or heavy-tailed embedding norms do no better
# (scripts/torch_port_search_int8_noise.py, PERF.md). So (a) is held to the
# CPU at this int8 level, to the CPU's ids where the CPU's own top-2 margin
# exceeds it, bit for bit to its per-op compile on the card (kernel 11's
# exact sums), and kernels 5 and 11 bit for bit to their plain versions at
# its shapes; (a') runs the same search over the f32 decoder at the f32 gate
SEARCH_INT8_REL = 2e-2
PACKED_REL = 1e-5  # the packed stack: card against the CPU, and against the padded stack


def gpt2_search_params(seed: int = SEARCH_SEED, cfg=GPT2) -> dict:
    """GPT-2 small's decoder params for onnx/synth.build_gpt2_decoder_graph
    at the published widths, numpy f32 from a seed (std 0.02, GPT-2's
    initializer_range; the head tied to the embedding, as GPT-2's is)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    d, f = cfg["d"], cfg["ffn"]

    def w(*shape, std=0.02):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(std)

    p = {"wte": w(cfg["vocab"], d), "wpe": w(cfg["max_len"], d, std=0.01),
         "lnf_g": 1 + w(d), "lnf_b": w(d)}
    for i in range(cfg["layers"]):
        p.update({f"ln1_g{i}": 1 + w(d), f"ln1_b{i}": w(d), f"attn_w{i}": w(d, 3 * d),
                  f"attn_b{i}": w(3 * d), f"proj_w{i}": w(d, d), f"proj_b{i}": w(d),
                  f"ln2_g{i}": 1 + w(d), f"ln2_b{i}": w(d), f"fc_w{i}": w(d, f),
                  f"fc_b{i}": w(f), f"fcp_w{i}": w(f, d), f"fcp_b{i}": w(d)})
    p["lm_w"] = np.ascontiguousarray(p["wte"].T)
    return p


def gpt2_search_models(params: dict, cfg=GPT2) -> tuple[bytes, bytes, bytes, dict]:
    """(a) the int8 BeamSearch export, (a') the same search over the f32
    decoder and (b) the f32 GreedySearch export of GPT-2 small, in the
    published form: the search scalars as runtime inputs, to be bound
    (onnx/loader.bind_inputs). The int8 decoder is the f32 one through the
    port's quantize_dynamic (ORT's int8 conversion: MatMul and Gemm only, so
    the contrib Attention's QKV weight stays f32). Returns (int8 beam bytes,
    f32 beam bytes, greedy bytes, the values to bind in each)."""
    import numpy as np

    from lele_tpu_torch.onnx import builder as ob
    from lele_tpu_torch.onnx import quantize, schema
    from lele_tpu_torch.onnx.synth import build_gpt2_decoder_graph, build_search_model

    dec = build_gpt2_decoder_graph(params, cfg["layers"], cfg["heads"])
    qdec = schema.decode_model(quantize.quantize_dynamic(ob.serialize(ob.model(dec, opset=17)))
                               ).raw()["graph"]
    shape = (len(SEARCH_PROMPTS), max(SEARCH_PROMPTS))
    beam_bind = {"max_length": np.asarray([SEARCH_MAX_LENGTH], np.int32),
                 "num_beams": np.asarray([SEARCH_BEAMS], np.int32),
                 "num_return_sequences": np.asarray([SEARCH_RETURN], np.int32)}
    eos = cfg["vocab"] - 1  # GPT-2's <|endoftext|> is its last id, and its pad
    attrs = dict(eos_token_id=eos, pad_token_id=eos, model_type=0)
    beam, f32_beam = (build_search_model(
        "BeamSearch", g, shape,
        dict(beam_bind, attention_mask=None,
             repetition_penalty=np.asarray([SEARCH_REPETITION], np.float32)),
        dict(attrs, no_repeat_ngram_size=SEARCH_NGRAM), n_outputs=2,
        runtime_scalars=tuple(beam_bind)) for g in (qdec, dec))
    greedy_bind = {"max_length": beam_bind["max_length"]}
    greedy = build_search_model("GreedySearch", dec, shape,
                                dict(greedy_bind, attention_mask=None), attrs,
                                runtime_scalars=tuple(greedy_bind))
    return beam, f32_beam, greedy, {"beam": beam_bind, "greedy": greedy_bind}


def gpt2_search_bytes_a_step(cfg=GPT2) -> tuple[int, int]:
    """(weights, KV cache) bytes one decode step of (a) must read: the int8
    linears (proj, fc, fcp a layer), the int8 head and the f32 QKV weights,
    and the K/V buffers of every layer at batch x beams rows."""
    d, f, L = cfg["d"], cfg["ffn"], cfg["layers"]
    weights = L * (d * d + d * f + f * d) + d * cfg["vocab"] + L * 4 * d * 3 * d
    kv = L * 2 * len(SEARCH_PROMPTS) * SEARCH_BEAMS * (SEARCH_MAX_LENGTH + 1) * d * 4
    return weights, kv


def search_prompts(vocab: int, seed: int = SEARCH_SEED):
    """[2, 16] int32 ids and their mask: SEARCH_PROMPTS' lengths, the shorter
    left-padded with the pad id (GPT-2's <|endoftext|>, the last id)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    s = max(SEARCH_PROMPTS)
    ids = np.full((len(SEARCH_PROMPTS), s), vocab - 1, np.int32)
    mask = np.zeros((len(SEARCH_PROMPTS), s), np.int32)
    for r, n in enumerate(SEARCH_PROMPTS):
        ids[r, s - n:] = rng.integers(0, vocab - 1, n)
        mask[r, s - n:] = 1
    return ids, mask


def whisper_search_params(seed: int = SEARCH_SEED + 1, cfg=WHISPER_TINY) -> dict:
    """onnx/synth.build_whisper_search_graphs' params at Whisper-tiny's
    decoder widths, numpy f32 from a seed (std 0.02, tied head)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    d, f = cfg["d"], 2 * cfg["d"]

    def w(*shape, std=0.02):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(std)

    p = {"We": w(cfg["mels"], d, std=0.1), "be": w(d), "emb": w(cfg["vocab"], d),
         "pos": w(cfg["max_len"], d, std=0.01), "lnf_g": 1 + w(d), "lnf_b": w(d)}
    for i in range(cfg["layers"]):
        for nm in ("ln1", "ln2", "ln3"):
            p[f"{nm}_g{i}"], p[f"{nm}_b{i}"] = 1 + w(d), w(d)
        for nm in ("sq", "sk", "sv", "so", "cq", "cv", "co"):
            p[f"{nm}_w{i}"], p[f"{nm}_b{i}"] = w(d, d), w(d)
        p[f"ck_w{i}"] = w(d, d)  # Whisper's cross K has no bias
        p[f"f1_w{i}"], p[f"f1_b{i}"] = w(d, f), w(f)
        p[f"f2_w{i}"], p[f"f2_b{i}"] = w(f, d), w(d)
    p["emb_T"] = np.ascontiguousarray(p["emb"].T)
    return p


def whisper_search_model(params: dict, cfg=WHISPER_TINY) -> tuple[bytes, dict]:
    """(c) a WhisperBeamSearch export over the DecoderMasked step graph
    (`masked_ops=True`, ORT's GPU generative-export form), with its feeds."""
    import numpy as np

    from lele_tpu_torch.onnx.synth import build_search_model, build_whisper_search_graphs

    prefix = np.tile(np.asarray([WHISPER_PREFIX], np.int32), (WHISPER_BATCH, 1))
    enc_g, dec_g = build_whisper_search_graphs(params, cfg["layers"], cfg["heads"],
                                               prefix.shape[1], masked_ops=True)
    shape = (WHISPER_BATCH, cfg["mels"], cfg["frames"])
    bs = build_search_model(
        "WhisperBeamSearch", dec_g, shape,
        {"max_length": np.asarray([WHISPER_SEARCH_MAX_LENGTH], np.int32),
         "num_beams": np.asarray([SEARCH_BEAMS], np.int32),
         "num_return_sequences": np.asarray([1], np.int32), "decoder_input_ids": prefix},
        dict(eos_token_id=WHISPER_EOT, pad_token_id=WHISPER_EOT, model_type=2,
             decoder_start_token_id=WHISPER_PREFIX[0], encoder=enc_g),
        n_outputs=2, input_dtype=1)
    feats = np.random.default_rng(SEARCH_SEED + 2).standard_normal(shape).astype(np.float32)
    return bs, {"input_ids": feats}


def packed_bert_models(b: int, s: int, layers: int = 12, d: int = 768, heads: int = 12,
                       ffn: int = 3072, seed: int = SEARCH_SEED + 3) -> tuple[bytes, bytes, dict]:
    """(d) a post-LN BERT stack in ORT's packed form (RemovePadding, a
    PackedAttention and the MLP a layer, RestorePadding) and the same
    stack without packing (com.microsoft Attention over the padded batch,
    keys masked by length: test_packed_pipeline_graph's padded oracle), on
    the same weights; feeds x [b, s, d] (padding rows zero) and lens [b]
    drawn from the seed in [s/8, s], a row before the last padded."""
    import numpy as np

    from lele_tpu_torch.onnx import builder as ob

    rng = np.random.default_rng(seed)

    def w(*shape):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(0.02)

    inits = {}
    for i in range(layers):
        inits.update({f"wqkv{i}": w(d, 3 * d), f"bqkv{i}": w(3 * d), f"wo{i}": w(d, d),
                      f"bo{i}": w(d), f"g1_{i}": 1 + w(d), f"e1_{i}": w(d),
                      f"w1_{i}": w(d, ffn), f"c1_{i}": w(ffn), f"w2_{i}": w(ffn, d),
                      f"c2_{i}": w(d), f"g2_{i}": 1 + w(d), f"e2_{i}": w(d)})
    lens = rng.integers(max(1, s // 8), s + 1, b).astype(np.int32)
    if (lens[:-1] == s).all():
        lens[0] = max(1, s // 8)
    x = rng.standard_normal((b, s, d), dtype=np.float32)
    x[np.arange(s)[None, :] >= lens[:, None]] = 0.0

    def stack(packed: bool) -> bytes:
        nodes = []

        def n(*a, **kw):
            nodes.append(ob.node(*a, **kw))

        cur = "x"
        if packed:
            n("RemovePadding", ["x", "lens"], ["p0", "off", "cum", "mx"],
              domain="com.microsoft")
            cur = "p0"
        for i in range(layers):
            if packed:
                n("PackedAttention", [cur, f"wqkv{i}", f"bqkv{i}", "off", "cum"], [f"a{i}"],
                  domain="com.microsoft", num_heads=heads)
            else:
                n("Attention", [cur, f"wqkv{i}", f"bqkv{i}", "lens"], [f"a{i}"],
                  domain="com.microsoft", num_heads=heads)
            n("MatMul", [f"a{i}", f"wo{i}"], [f"ao{i}"])
            n("Add", [f"ao{i}", f"bo{i}"], [f"ab{i}"])
            n("Add", [f"ab{i}", cur], [f"r1_{i}"])
            n("LayerNormalization", [f"r1_{i}", f"g1_{i}", f"e1_{i}"], [f"h{i}"],
              epsilon=1e-12)
            n("MatMul", [f"h{i}", f"w1_{i}"], [f"f1_{i}"])
            n("Add", [f"f1_{i}", f"c1_{i}"], [f"fb{i}"])
            n("Gelu", [f"fb{i}"], [f"g{i}"], domain="com.microsoft")
            n("MatMul", [f"g{i}", f"w2_{i}"], [f"f2_{i}"])
            n("Add", [f"f2_{i}", f"c2_{i}"], [f"fc{i}"])
            n("Add", [f"fc{i}", f"h{i}"], [f"r2_{i}"])
            n("LayerNormalization", [f"r2_{i}", f"g2_{i}", f"e2_{i}"], [f"y{i}"],
              epsilon=1e-12)
            cur = f"y{i}"
        if packed:
            n("RestorePadding", [cur, "off"], ["y"], domain="com.microsoft")
        else:
            n("Identity", [cur], ["y"])
        return ob.build_model_bytes(
            nodes, [ob.vi_from_array("x", x), ob.vi_from_array("lens", lens)],
            [ob.value_info("y", 1, [])],
            [ob.tensor_from_array(v, k) for k, v in inits.items()], opset=17)

    return stack(True), stack(False), {"x": x, "lens": lens}


def gpt2_kernel_checks(checks, dev, cfg=GPT2) -> None:
    """Kernels 5 and 11 at (a)'s shapes, each bit for bit against its plain
    version on the same card tensors: B x beams rows at a decode step and
    B x beams x S at the prefill, by the four linears of a GPT-2 layer and
    its head ([d, d], [d, ffn], [ffn, d], [d, vocab]); kernel 5 with the
    weight scale as a host float and as a device tensor."""
    import torch

    from lele_tpu_torch import kernels as K

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEARCH_SEED + 5)
    d, f, v = cfg["d"], cfg["ffn"], cfg["vocab"]
    rows = len(SEARCH_PROMPTS) * SEARCH_BEAMS
    for m in (rows, rows * max(SEARCH_PROMPTS)):
        for k, n in ((d, d), (d, f), (f, d), (d, v)):
            wq = torch.randint(-127, 128, (k, n), generator=gen, device=dev, dtype=torch.int8)
            colsum = wq.to(torch.int32).sum(0, dtype=torch.int32)
            x = torch.randn((m, k), generator=gen, device=dev) * 2.0
            q, a_scale, a_zp = K.dynamic_quantize_u8(x)
            same = []
            for w_scale in (2.5e-3, torch.tensor([2.5e-3], device=dev)):
                same.append(torch.equal(K.fused_dq_matmul(x, wq, colsum, a_scale, a_zp, w_scale),
                                        K.fused_dq_matmul_plain(x, wq, colsum, a_scale, a_zp,
                                                                w_scale)))
            a = (q - 128).to(torch.int8)
            same.append(torch.equal(K.int8_matmul(a, wq), K.int8_matmul_plain(a, wq)))
            checks.require(all(same),
                           f"(a)'s shape [{m},{k}]x[{k},{n}]: dq_gemm (host, device w_scale) "
                           f"and int8_gemm equal to plain: {same}")


def ngram_clean(seq, start: int, n: int, eos: int) -> bool:
    """True when no n-gram ending at a generated position (from `start` up
    to the sequence's first EOS) repeats one that ends before it: the
    no-repeat n-gram ban, read off a search's returned ids."""
    for row in seq.reshape(-1, seq.shape[-1]).tolist():
        seen = set()
        for t in range(n - 1, len(row)):
            gram = tuple(row[t - n + 1:t + 1])
            if t >= start:
                if gram in seen:
                    return False
                if row[t] == eos:
                    break
            seen.add(gram)
    return True


def hold_beam_to_cpu(checks, label: str, seq, sc, ref_seq, ref_sc, ids, gate: float) -> float:
    """A GPT-2 BeamSearch's card outputs against the CPU's: the returned
    shape and id range, the prompts kept, the no-repeat n-gram ban kept,
    scores within `gate` (relative), and the CPU's ids for every prompt
    whose two returned scores (on the CPU) lie more than `gate` apart: a
    closer pair may swap or part. Prints a prompt whose ids part, with that
    margin. Returns the largest relative score difference."""
    import numpy as np

    b, s = ids.shape
    rel = np.abs(sc - ref_sc) / np.maximum(np.abs(ref_sc), 1e-30)
    margin = np.abs(ref_sc[:, 0] - ref_sc[:, 1]) / np.maximum(np.abs(ref_sc[:, 0]), 1e-30)
    parted = [r for r in range(b) if not np.array_equal(seq[r], ref_seq[r])]
    for r in parted:
        print(f"    {label} prompt {r}: the card's ids part from the CPU's; the CPU's top-2 "
              f"margin {margin[r]:.3e} (relative), scores {sc[r]} against {ref_sc[r]}")
    checks.require(seq.shape == (b, SEARCH_RETURN, SEARCH_MAX_LENGTH)
                   and ((seq >= 0) & (seq < GPT2["vocab"])).all()
                   and (seq[:, :, :s] == ids[:, None, :]).all()
                   and ngram_clean(seq, s, SEARCH_NGRAM, GPT2["vocab"] - 1)
                   and float(rel.max()) <= gate
                   and not any(margin[r] > gate for r in parted),
                   f"{label}: sequences {seq.shape}, the prompts kept, no repeated "
                   f"{SEARCH_NGRAM}-gram; against the CPU: {b - len(parted)} of {b} prompts the "
                   f"same ids (the CPU's top-2 margins {margin.tolist()}, ids held where above "
                   f"the gate), scores max rel|d| {rel.max():.3e}, gate {gate:g}")
    return float(rel.max())


def capture_checks(checks, label: str, cm, feeds: dict):
    """A compiled model's captured call against its uncaptured replay: the
    tape capturable, the call captured, the same bits and launch counts;
    then one captured call under torch.cuda.set_sync_debug_mode("error"),
    so that a host read inside the program fails the phase. Returns the
    captured call's outputs (device tensors the caller owns) and launches."""
    import torch

    from lele_tpu_torch import kernels as K

    K.reset_launch_counts()
    got = [o.clone() for o in cm(**feeds)]
    torch.cuda.synchronize()
    launches = K.launch_counts()
    K.reset_launch_counts()
    ref = cm.replay(**feeds)
    torch.cuda.synchronize()
    ref_launches = K.launch_counts()
    same = all(torch.equal(a, b) for a, b in zip(got, ref))
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = cm(**feeds)
        torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    same = same and all(torch.equal(a, b) for a, b in zip(got, again))
    moved = {k: v for k, v in launches.items() if v}
    checks.require(cm.stats["capturable"] and cm.stats["captured"] and same
                   and launches == ref_launches,
                   f"{label}: capturable {cm.stats['capturable']}, captured "
                   f"{cm.stats['captured']}; the captured call the replay's bits ({same}, and "
                   f"again under sync debug mode 'error') and launches ({moved} against "
                   f"{ {k: v for k, v in ref_launches.items() if v} })")
    return got, launches


def search_phase(checks, dev, card) -> dict:
    """Phase 40: the com.microsoft search and packed sets (ROADMAP §1.1.5)
    at full width, each graph built here by the port's onnx/synth.py,
    onnx/builder.py and onnx/quantize.py from numpy weights made from a
    seed, compiled and captured as one CUDA graph, and held against the
    port's CPU run of the same bytes:

    (a) GPT-2 small (12 layers, d 768, 12 heads, vocab 50,257) through
    quantize_dynamic under BeamSearch (4 beams, 2 returned, max_length 48,
    no_repeat_ngram_size 3, repetition_penalty 1.1) on 2 prompts of 16 and
    9 tokens (left-padded, with attention_mask), the search scalars bound
    by bind_inputs: kernel 5 37 times a decoder walk; kernels 5 and 11 bit
    for bit to their plain versions at its shapes (`gpt2_kernel_checks`);
    against the CPU at the int8 level (`hold_beam_to_cpu`, SEARCH_INT8_REL);
    at a shorter generation (SEARCH_PER_OP_LENGTH), the per-op compile's
    bits on the card (kernel 11) against kernel 5's; (a') the same
    search over the f32 decoder, against the CPU at SEARCH_SCORE_REL;
    (b) the same decoder in f32 under GreedySearch, ids equal, its time a
    token beside phase 33's step program; (c) WhisperBeamSearch over the
    DecoderMasked step graph at Whisper-tiny's widths (1,500 frames of 80
    features, 4 beams, max_length 32), ids equal; (d) a packed BERT-base
    stack (B 8, S 128), within PACKED_REL of the CPU and of the padded
    stack on the valid rows, padding rows zero. Each captured call must give
    the uncaptured replay's bits and launch counts, also under sync debug
    mode "error". Returns kernel 5's launches over (a)'s calls."""
    import numpy as np
    import torch

    from lele_tpu_torch import kernels as K
    from lele_tpu_torch.compiler import compile_model
    from lele_tpu_torch.onnx import OnnxModel, bind_inputs

    banner(f"== 40. the com.microsoft search and packed sets: int8 GPT-2 small under "
           f"BeamSearch, GreedySearch, WhisperBeamSearch, a packed BERT-base stack ({card})")
    t_phase = time.perf_counter()
    totals = {"dq_gemm": 0}

    t0 = time.perf_counter()
    params = gpt2_search_params()
    beam_bs, f32_beam_bs, greedy_bs, binds = gpt2_search_models(params)
    del params
    ids, mask = search_prompts(GPT2["vocab"])
    feeds = {"input_ids": ids, "attention_mask": mask}
    tfeeds = {k: torch.from_numpy(v).to(dev) for k, v in feeds.items()}
    s, ml = ids.shape[1], SEARCH_MAX_LENGTH
    n_steps = ml - s  # tokens a sequence gains: one from the prefill, the rest a step each
    print(f"  GPT-2 small exports: int8 BeamSearch {len(beam_bs) / 1e6:.1f} MB, f32 "
          f"BeamSearch {len(f32_beam_bs) / 1e6:.1f} MB, f32 GreedySearch "
          f"{len(greedy_bs) / 1e6:.1f} MB of ONNX, built in {time.perf_counter() - t0:.1f} s")
    gpt2_kernel_checks(checks, dev)

    # (a) the int8 beam search
    t0 = time.perf_counter()
    model = bind_inputs(OnnxModel.from_bytes(beam_bs), binds["beam"])
    short = bind_inputs(OnnxModel.from_bytes(beam_bs),
                        dict(binds["beam"], max_length=np.asarray([SEARCH_PER_OP_LENGTH],
                                                                  np.int32)))
    del beam_bs
    cpu = compile_model(model, device="cpu", strict=True)
    ref_seq, ref_sc = cpu.run_np(**feeds)
    cpu_hits = cpu.stats["pattern_hits"]
    del cpu
    t1 = time.perf_counter()
    cm = compile_model(model, device=dev, strict=True).compile()
    compile_s = time.perf_counter() - t1
    (seq, sc), launches = capture_checks(checks, "(a) int8 BeamSearch", cm, tfeeds)
    seq, sc = seq.cpu().numpy(), sc.cpu().numpy()
    totals["dq_gemm"] += launches["dq_gemm"]
    walk = 3 * GPT2["layers"] + 1
    hits = cm.stats["pattern_hits"]
    checks.require(hits == cpu_hits and hits.get("dql_matmul_dataflow") == 2 * walk,
                   f"(a) pattern hits {hits} (the CPU's {cpu_hits}; {walk} a decoder walk, the "
                   f"prefill's and the step's)")
    checks.require(launches["dq_gemm"] == walk * n_steps,
                   f"(a) kernel 5 {launches['dq_gemm']} launches a call ({walk} a decoder walk "
                   f"x (1 prefill + {n_steps - 1} steps)); kernel 11 {launches['int8_gemm']}; "
                   f"all: { {k: v for k, v in launches.items() if v} }")
    hold_beam_to_cpu(checks, "(a) int8", seq, sc, ref_seq, ref_sc, ids, SEARCH_INT8_REL)
    print(f"  (a) CPU run {t1 - t0:.1f} s, card compile and capture {compile_s:.1f} s")
    # the per-op compile (kernel 11) against kernel 5's bits, at a shorter
    # generation: both compiled from the same bytes bound to SEARCH_PER_OP_LENGTH
    t1 = time.perf_counter()
    n_short = SEARCH_PER_OP_LENGTH - s
    fused = compile_model(short, device=dev, strict=True)
    K.reset_launch_counts()
    seq_f, sc_f = (o.cpu().numpy() for o in fused.replay(**tfeeds))
    torch.cuda.synchronize()
    f_launches = K.launch_counts()
    del fused
    per_op = compile_model(short, device=dev, strict=True, patterns=[])
    K.reset_launch_counts()
    seq_p, sc_p = (o.cpu().numpy() for o in per_op.replay(**tfeeds))
    torch.cuda.synchronize()
    op_launches = K.launch_counts()
    same = np.array_equal(seq_p, seq_f) and np.array_equal(sc_p, sc_f)
    checks.require(same and seq_p.shape[-1] == SEARCH_PER_OP_LENGTH
                   and f_launches["dq_gemm"] == walk * n_short
                   and op_launches["int8_gemm"] == walk * n_short
                   and op_launches["dq_gemm"] == 0,
                   f"(a) max_length {SEARCH_PER_OP_LENGTH}: the per-op compile on the card "
                   f"(patterns=[]: DynamicQuantizeLinear, MatMulInteger on kernel 11 "
                   f"{op_launches['int8_gemm']} times, Cast, Mul) gives kernel 5's ids and "
                   f"scores ({f_launches['dq_gemm']} launches) bit for bit ({same}), in "
                   f"{time.perf_counter() - t1:.1f} s")
    del per_op, short
    t_a = time.perf_counter() - t0
    ev = time_ms(lambda: cm(**tfeeds), runs=5, warm=1)
    hc = host_ms(lambda: (cm(**tfeeds), torch.cuda.synchronize()), runs=3)
    rows = profile_top(lambda: (cm.replay(**tfeeds), torch.cuda.synchronize()),
                       "(a), step by step", card, n=1, top=8, warm=False)
    total = sum(us for _, us, _ in rows)
    k5 = sum(us for name, us, _ in rows if "dq_gemm" in name)
    w_bytes, kv_bytes = gpt2_search_bytes_a_step()
    held = sum(t.numel() * t.element_size() for name, t in cm.params.items()
               if name.endswith("::i8") or "/attn_w" in name)
    checks.require(held == w_bytes,
                   f"(a) a decode step's weights: {w_bytes / 1e6:.1f} MB by the widths, "
                   f"{held / 1e6:.1f} MB of the compiled model's int8 and QKV params")
    b_ms, _ = bound(w_bytes, {})
    bkv_ms, _ = bound(w_bytes + kv_bytes, {})
    print(f"  (a) int8 GPT-2 small BeamSearch, B {ids.shape[0]} x {SEARCH_BEAMS} beams, "
          f"{n_steps} tokens a sequence: captured {ev:.3f} ms a call by events ({hc:.3f} by "
          f"host clock), {ev / n_steps:.4f} ms a token; kernel 5 {k5:.1f} us of "
          f"{total:.1f} us device time in a step-by-step call ({k5 / total:.1%}); a decode "
          f"step must read {w_bytes / 1e6:.1f} MB of weights ({b_ms * 1e3:.1f} us at "
          f"{PEAK_BYTES / 1e12:.2f} TB/s; {bkv_ms * 1e3:.1f} us with the "
          f"{kv_bytes / 1e6:.1f} MB KV cache); checked in {t_a:.1f} s, timed in "
          f"{time.perf_counter() - t0 - t_a:.1f} s  ({card})")
    a_ms = ev
    del cm, model

    # (a') the same search over the f32 decoder
    t0 = time.perf_counter()
    model = bind_inputs(OnnxModel.from_bytes(f32_beam_bs), binds["beam"])
    del f32_beam_bs
    ref_seq, ref_sc = compile_model(model, device="cpu", strict=True).run_np(**feeds)
    cm = compile_model(model, device=dev, strict=True).compile()
    (seq, sc), _ = capture_checks(checks, "(a') f32 BeamSearch", cm, tfeeds)
    hold_beam_to_cpu(checks, "(a') f32", seq.cpu().numpy(), sc.cpu().numpy(), ref_seq, ref_sc,
                     ids, SEARCH_SCORE_REL)
    print(f"  (a') f32 GPT-2 small BeamSearch: built, CPU-run and compiled in "
          f"{time.perf_counter() - t0:.1f} s")
    del cm, model

    # (b) the f32 greedy search
    t0 = time.perf_counter()
    model = bind_inputs(OnnxModel.from_bytes(greedy_bs), binds["greedy"])
    del greedy_bs
    (ref_seq,) = compile_model(model, device="cpu", strict=True).run_np(**feeds)
    cm = compile_model(model, device=dev, strict=True).compile()
    (seq,), _ = capture_checks(checks, "(b) f32 GreedySearch", cm, tfeeds)
    seq = seq.cpu().numpy()
    checks.require(np.array_equal(seq, ref_seq),
                   f"(b) sequences {seq.shape} the CPU's ids; built, CPU-run and compiled in "
                   f"{time.perf_counter() - t0:.1f} s")
    ev = time_ms(lambda: cm(**tfeeds), runs=5, warm=1)
    print(f"  (b) f32 GPT-2 small GreedySearch, B {ids.shape[0]}, {n_steps} tokens: captured "
          f"{ev:.3f} ms a call, {ev / n_steps:.4f} ms a token in one program for the whole "
          f"generation (phase 33: one step program a token); (a)'s int8 beam "
          f"{a_ms / n_steps:.4f} ms a token  ({card})")
    profile_top(lambda: (cm.replay(**tfeeds), torch.cuda.synchronize()), "(b), step by step",
                card, n=1, top=8, warm=False)
    del cm, model

    # (c) Whisper-tiny widths under WhisperBeamSearch
    t0 = time.perf_counter()
    bs, wfeeds = whisper_search_model(whisper_search_params())
    (ref_seq, ref_sc) = compile_model(bs, device="cpu", strict=True).run_np(**wfeeds)
    cm = compile_model(bs, device=dev, strict=True).compile()
    twfeeds = {k: torch.from_numpy(v).to(dev) for k, v in wfeeds.items()}
    (seq, sc), _ = capture_checks(checks, "(c) WhisperBeamSearch", cm, twfeeds)
    seq, sc = seq.cpu().numpy(), sc.cpu().numpy()
    rel = float((np.abs(sc - ref_sc) / np.maximum(np.abs(ref_sc), 1e-30)).max())
    checks.require(np.array_equal(seq, ref_seq) and rel <= SEARCH_SCORE_REL,
                   f"(c) sequences {seq.shape} the CPU's ids, scores max rel|d| {rel:.3e} (gate "
                   f"{SEARCH_SCORE_REL:g}); {len(bs) / 1e6:.1f} MB of ONNX built, CPU-run and "
                   f"compiled in {time.perf_counter() - t0:.1f} s")
    n_w = WHISPER_SEARCH_MAX_LENGTH - len(WHISPER_PREFIX)
    ev = time_ms(lambda: cm(**twfeeds), runs=5, warm=1)
    print(f"  (c) WhisperBeamSearch at Whisper-tiny widths, B {WHISPER_BATCH} x {SEARCH_BEAMS} "
          f"beams, the encoder over {WHISPER_TINY['frames']} frames and {n_w} tokens: captured "
          f"{ev:.3f} ms a call, {ev / n_w:.4f} ms a token  ({card})")
    profile_top(lambda: (cm.replay(**twfeeds), torch.cuda.synchronize()),
                "(c), step by step", card, n=1, top=8, warm=False)
    del cm

    # (d) the packed BERT-base stack
    t0 = time.perf_counter()
    pb = PACKED_BERT
    packed, padded, pfeeds = packed_bert_models(pb["batch"], pb["seq"], pb["layers"], pb["d"],
                                                pb["heads"], pb["ffn"])
    (ref,) = compile_model(packed, device="cpu", strict=True).run_np(**pfeeds)
    tpfeeds = {k: torch.from_numpy(v).to(dev) for k, v in pfeeds.items()}
    cm = compile_model(packed, device=dev, strict=True).compile()
    pad_cm = compile_model(padded, device=dev, strict=True).compile()
    (got,), _ = capture_checks(checks, "(d) packed BERT-base", cm, tpfeeds)
    (pad_out,) = pad_cm(**tpfeeds)
    got, pad_out = got.cpu().numpy(), pad_out.cpu().numpy()
    valid = np.arange(pb["seq"])[None, :] < pfeeds["lens"][:, None]
    scale = float(np.abs(ref).max())
    d_cpu = float(np.abs(got - ref).max())
    d_pad = float(np.abs(got[valid] - pad_out[valid]).max())
    checks.require(got.shape == ref.shape and d_cpu <= PACKED_REL * scale
                   and d_pad <= PACKED_REL * scale and (got[~valid] == 0).all(),
                   f"(d) packed BERT-base [{pb['batch']}, {pb['seq']}, {pb['d']}], lengths "
                   f"{pfeeds['lens'].tolist()}: max|d| {d_cpu:.3e} against the CPU, {d_pad:.3e} "
                   f"against the padded stack on the valid rows (max|ref| {scale:.3f}, gate "
                   f"{PACKED_REL:g} max|ref|), padding rows zero; built and compiled in "
                   f"{time.perf_counter() - t0:.1f} s")
    ev = time_ms(lambda: cm(**tpfeeds), runs=10)
    ev_pad = time_ms(lambda: pad_cm(**tpfeeds), runs=10)
    print(f"  (d) packed BERT-base ({int(valid.sum())} real tokens of {valid.size}): captured "
          f"{ev:.3f} ms a call, the padded stack {ev_pad:.3f} ms (both compute over B x S rows, "
          f"as the JAX package's static form does)  ({card})")
    del cm, pad_cm
    torch.cuda.synchronize()
    print(f"  phase 40 in {time.perf_counter() - t_phase:.1f} s")
    return totals


# phase 41: training at the flagship widths (ROADMAP §1.1): the CTC train
# step of lele_tpu_torch/train on the unquantized model, which calls no kernel
# of the port (no JAX kernel has a backward); a 10 s request's 171 frames
TRAIN_SEED = SEED + 41
TRAIN_SMALL = dict(n_layers=2, d_model=64, ffn_dim=128, vocab_size=64, n_heads=2,
                   dtype="float32", n_experts=4)  # dryrun_multichip's config
TRAIN_BATCH = (8, 171, 48)  # B, T, labels
TRAIN_STEPS = 10
TRAIN_LR = 1e-4  # make_train_step's default, as JAX's
# (a) the card's step against the CPU's: the loss relative, each gradient
# leaf's max|d| over its max|grad| (f32, TF32 off: only the order of sums
# differs)
TRAIN_LOSS_REL = 1e-5
TRAIN_GRAD_REL = 1e-4
# (a) then the AdamW update at lr 1e-3: an element whose reference gradient
# is rounding noise (below TRAIN_NOISE_REL of its leaf's max |grad|; the key
# third of qkv/b: 0 in exact arithmetic) moves by lr either way, as Adam
# divides each gradient by its own size; every other element within
# TRAIN_STEP_ATOL
TRAIN_NOISE_REL = 1e-6
TRAIN_STEP_ATOL = 1e-5


def train_batch(B: int, T: int, L: int, vocab: int, seed: int) -> dict:
    """A training batch from a seed: features, full masks, labels 1..vocab-1."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return {"feats": rng.standard_normal((B, T, 560)).astype(np.float32),
            "feat_mask": np.ones((B, T), np.float32),
            "labels": rng.integers(1, vocab, (B, L)).astype(np.int32),
            "label_mask": np.ones((B, L), np.float32)}


def train_bound_ms(cfg, B: int, T: int) -> tuple[float, float]:
    """(the least time of a train step at the bf16 peak in ms, its
    operations): 6 x the matmul params x the tokens (2 forward, 4 backward)
    plus the attention products (QK^T and AV, 4·T²·D a sequence and layer
    forward, x 3 with the backward)."""
    D, F, L = cfg.d_model, cfg.ffn_dim, cfg.n_layers
    Tt = T + cfg.n_prefix
    params = cfg.input_dim * D + L * (3 * D * D + D * D + 2 * D * F) + D * cfg.vocab_size
    ops = 6 * params * B * Tt + 3 * L * 4 * B * Tt * Tt * D
    return ops / PEAK_OPS["bf16"] * 1e3, ops


def train_phase(checks, dev, card) -> None:
    """Phase 41: the CTC train step (lele_tpu_torch/train) on the card.

    (a) dryrun_multichip's config (2 layers, d 64, 4 experts, f32; B 2, T 24,
    L 6), TF32 off: one step's loss and every gradient leaf against the
    port's CPU run of the same step; (b) the flagship's widths
    (SenseVoiceConfig(weight_int8=False): 50 layers, d 512, bf16 compute,
    f32 params and moments), B 8 x T 171 x 48 labels from a seed: the loss
    over 10 steps on one batch must fall; the step's median time over warm
    steps, its peak memory, with remat and without, and its share of the
    bf16 bound; (c) a checkpoint saved after those steps and restored into
    fresh state gives the next step the same bits as continuing; (d) the
    sharded step (shard_params, shard_batch, the Layout of parallel/spmd.py)
    in an NCCL process group at world size 1: on a 1 x 1 x 1 mesh every
    axis has size 1, so no collective runs; its loss and updated params the
    bits of (b)'s first step. Collectives across ranks are checked on the
    CPU only (tests/test_torch_port_parallel.py): the machine has one card."""
    import tempfile

    import torch
    import torch.distributed as dist

    from lele_tpu_torch.models import SenseVoiceConfig
    from lele_tpu_torch.models.sensevoice import init_sensevoice
    from lele_tpu_torch.parallel import make_mesh, shard_params
    from lele_tpu_torch.parallel.mesh import init_distributed
    from lele_tpu_torch.params import tree_leaves, tree_map
    from lele_tpu_torch.train import make_train_step, shard_batch
    from lele_tpu_torch.train.checkpoint import restore_train_state, save_train_state
    from lele_tpu_torch.train.trainer import value_and_grad

    banner(f"== 41. training: the CTC train step, AdamW, remat and checkpoints at full "
           f"width; the sharded step in an NCCL group of one ({card})")
    t_phase = time.perf_counter()

    # (a) the card against the CPU at dryrun_multichip's config
    cfg = SenseVoiceConfig(**TRAIN_SMALL)
    params = init_sensevoice(torch.Generator().manual_seed(TRAIN_SEED), cfg)
    batch = train_batch(2, 24, 6, cfg.vocab_size, TRAIN_SEED)
    card_params = tree_map(lambda t: t.to(dev), params)
    ref_loss, ref_grads = value_and_grad(params, batch, cfg)
    loss, grads = value_and_grad(card_params, batch, cfg)
    d_loss = abs(float(loss) - float(ref_loss)) / abs(float(ref_loss))
    d_grad = max(float((g.cpu() - r).abs().max() / r.abs().max().clamp(min=1e-30))
                 for g, r in zip(grads, ref_grads))
    checks.require(d_loss <= TRAIN_LOSS_REL and d_grad <= TRAIN_GRAD_REL,
                   f"(a) one step at the dryrun config (2 layers, d 64, 4 experts, f32, TF32 "
                   f"off): loss {float(loss):.6f} against the CPU's {float(ref_loss):.6f} "
                   f"(rel {d_loss:.2e}, gate {TRAIN_LOSS_REL:g}); {len(grads)} gradient "
                   f"leaves, the worst max|d|/max|grad| {d_grad:.2e} (gate {TRAIN_GRAD_REL:g})")
    tx, step = make_train_step(cfg, lr=1e-3)
    step(params, tx.init(params), batch)
    step(card_params, tx.init(card_params), batch)
    d_step = d_noise = 0.0
    for a, b, r in zip(tree_leaves(card_params), tree_leaves(params), ref_grads):
        d = (a.cpu() - b).abs()
        noise = r.abs() < TRAIN_NOISE_REL * r.abs().max()
        d_step = max(d_step, float(d[~noise].max()))
        d_noise = max(d_noise, float(d[noise].max()) if noise.any() else 0.0)
    checks.require(d_step <= TRAIN_STEP_ATOL and d_noise <= 2e-3,
                   f"(a) the AdamW update at lr 0.001: params max|d| {d_step:.2e} (gate "
                   f"{TRAIN_STEP_ATOL:g}) where the CPU's gradient is above rounding level, "
                   f"{d_noise:.2e} (gate 2·lr) where it is below {TRAIN_NOISE_REL:g} of its "
                   f"leaf's max")

    # (b) the flagship's widths
    B, T, L = TRAIN_BATCH
    cfg = SenseVoiceConfig(weight_int8=False)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()  # the earlier phases' tensors still alive
    gen = torch.Generator(device=dev)
    gen.manual_seed(TRAIN_SEED)
    params = init_sensevoice(gen, cfg)
    n_params = sum(t.numel() for t in tree_leaves(params))
    batch = train_batch(B, T, L, cfg.vocab_size, TRAIN_SEED)
    tb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    tx, step = make_train_step(cfg, lr=TRAIN_LR)
    opt = tx.init(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for i in range(TRAIN_STEPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        _, _, loss = step(params, opt, tb)
        end.record()
        end.synchronize()
        losses.append(float(loss))
        times.append(start.elapsed_time(end))
        if i == 0:  # for (d), off the card: not in the peak memory
            first = [t.cpu() for t in tree_leaves(params)]
    peak = torch.cuda.max_memory_allocated() - base
    step_ms = statistics.median(times[2:])
    bound_ms, ops = train_bound_ms(cfg, B, T)
    checks.require(all(math.isfinite(v) for v in losses) and losses[-1] < losses[0],
                   f"(b) {cfg.n_layers} layers, d {cfg.d_model}, vocab {cfg.vocab_size}, bf16 "
                   f"compute, {n_params / 1e6:.1f} M f32 params; B {B} x T {T} x {L} labels, "
                   f"lr {TRAIN_LR:g}: the loss over {TRAIN_STEPS} steps on one batch "
                   f"{[round(v, 4) for v in losses]} falls")
    print(f"  (b) a step: {step_ms:.2f} ms (median of steps 3-{TRAIN_STEPS} by CUDA events; "
          f"the first {times[0]:.1f} ms), peak memory {peak / 2**30:.2f} GiB without remat "
          f"(above the {base / 2**30:.2f} GiB the earlier phases hold: params, moments, "
          f"gradients and activations); "
          f"bound {bound_ms:.3f} ms ({ops / 1e12:.3f} T operations at "
          f"{PEAK_OPS['bf16'] / 1e12:.0f} T/s bf16), {bound_ms / step_ms:.1%} of it  ({card})")

    # (c) a checkpoint on the card: restore, then the next step's bits
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as folder:
        save_train_state(folder, params, opt, TRAIN_STEPS)
        t_save = time.perf_counter() - t0
        fresh = init_sensevoice(gen, cfg)
        rp, ro, rstep = restore_train_state(folder, fresh, tx.init(fresh))
    t_io = time.perf_counter() - t0
    _, _, loss_c = step(params, opt, tb)
    _, _, loss_r = step(rp, ro, tb)
    same = all(torch.equal(a, b) for a, b in zip(tree_leaves({"p": params, "o": opt}),
                                                 tree_leaves({"p": rp, "o": ro})))
    checks.require(rstep == TRAIN_STEPS and same and float(loss_c) == float(loss_r),
                   f"(c) saved after step {TRAIN_STEPS} ({t_save:.1f} s) and restored into "
                   f"fresh state ({t_io - t_save:.1f} s): the next step's loss "
                   f"{float(loss_r):.6f} and every param and moment the same bits as "
                   f"continuing ({same})")
    del rp, ro, fresh

    profile_top(lambda: step(params, opt, tb), "(b) train step", card, n=1, top=10, warm=False)
    _, remat_step = make_train_step(SenseVoiceConfig(weight_int8=False, remat=True),
                                    lr=TRAIN_LR)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    remat_ms = time_ms(lambda: remat_step(params, opt, tb), runs=1, warm=1)
    remat_peak = torch.cuda.max_memory_allocated() - base
    print(f"  (b) with remat: {remat_ms:.2f} ms a step (one warm step), peak memory "
          f"{remat_peak / 2**30:.2f} GiB (without: {step_ms:.2f} ms, {peak / 2**30:.2f} GiB)  "
          f"({card})")

    # (d) the sharded step in an NCCL process group, world size 1
    with tempfile.TemporaryDirectory() as folder:
        init_distributed(0, 1, f"file://{Path(folder) / 'rendezvous'}", device="cuda")
        try:
            mesh = make_mesh(1, seq=1)
            gen.manual_seed(TRAIN_SEED)
            sp = shard_params(init_sensevoice(gen, cfg), mesh)
            stx, sstep = make_train_step(cfg, lr=TRAIN_LR)
            _, _, loss_d = sstep(sp, stx.init(sp), shard_batch(batch, mesh))
            torch.cuda.synchronize()
        finally:
            dist.destroy_process_group()
    local = [t.to_local().cpu() for t in tree_leaves(sp)]
    same = all(torch.equal(a, b) for a, b in zip(local, first))
    d = max(float((a - b).abs().max()) for a, b in zip(local, first))
    checks.require(float(loss_d) == losses[0] and same,
                   f"(d) the sharded step (shard_params, shard_batch, the spmd Layout) in an "
                   f"NCCL group over a 1 x 1 x 1 mesh (every axis of size 1: no collective "
                   f"runs): loss {float(loss_d):.6f} against (b)'s first step {losses[0]:.6f}, "
                   f"the updated params the same bits ({same}, max|d| {d:.2e})")
    del sp, first, local
    print(f"  phase 41 in {time.perf_counter() - t_phase:.1f} s")


MESH_SEED = SEED + 42
PIPE_BATCH = 8  # (a): 8 requests of T_MAIN frames in PIPE_MICRO microbatches
PIPE_MICRO = 4
MESH_BURST = 8  # (c): concurrent /recognize requests of MESH_SECONDS each
MESH_SECONDS = 10.0


def dryrun_onnx(B: int, T: int):
    """_dryrun_compiled_onnx's draws (rng 7): the MHA encoder's bytes, its
    input [B, T, 32], the Attention-23 graph and its q, k, v [B, 2, 16, 8]."""
    import numpy as np

    from lele_tpu_torch.onnx import builder as ob
    from lele_tpu_torch.onnx.synth import build_mha_encoder

    rng = np.random.default_rng(7)
    bs = build_mha_encoder(rng, 32, 2, 64, 2)
    x = rng.standard_normal((B, T, 32)).astype(np.float32)
    qkv = {n: rng.standard_normal((B, 2, 16, 8)).astype(np.float32) for n in "qkv"}
    attn = ob.build_model_bytes([ob.node("Attention", ["q", "k", "v"], ["y"], is_causal=1)],
                                inputs=[ob.vi_from_array(n, a) for n, a in qkv.items()],
                                outputs=[ob.value_info("y", 1, [])], opset=23)
    return bs, x, attn, qkv


def dryrun_serving(seed: int, n_req: int):
    """_dryrun_serving's (rng 11, 5 requests) or
    test_serving_multidevice's (rng 0, 6) MHA encoder (d 32, 2 heads, ffn
    64, 2 layers) and its [12, 32] requests."""
    import numpy as np

    from lele_tpu_torch.onnx.synth import build_mha_encoder

    rng = np.random.default_rng(seed)
    bs = build_mha_encoder(rng, 32, 2, 64, 2)
    return bs, [rng.standard_normal((12, 32)).astype(np.float32) for _ in range(n_req)]


def dryrun_genai(B: int, S: int = 1, moe: bool = False):
    """_dryrun_genai's int4 decode step (rng 11; past 3, random caches) or,
    with `moe`, _dryrun_moe's QMoE decoder (rng 17; past 0, zero caches) at
    batch B and S new tokens: (bytes, feeds)."""
    import numpy as np

    from lele_tpu_torch.onnx import synth

    rng = np.random.default_rng(17 if moe else 11)
    cfg = dict(synth.GENAI_MOE_CFG if moe else synth.GENAI_CFG, B=B)
    inits, _ = synth.genai_decoder_params(rng, cfg)
    bs = synth.build_genai_decoder(inits, S, cfg)
    kvh, L, hd, nl, V = (cfg[k] for k in ("kvh", "L", "hd", "nl", "V"))
    ids = rng.integers(0, V, (B, S)).astype(np.int64)
    if moe:
        pos = np.broadcast_to(np.arange(S), (B, S)).astype(np.int64)
        pks = pvs = [np.zeros((B, kvh, L, hd), np.float32) for _ in range(nl)]
        return bs, synth.genai_feeds(ids, pos, 0, S, pks, pvs, cfg)
    pks = [rng.standard_normal((B, kvh, L, hd)).astype(np.float32) for _ in range(nl)]
    pvs = [rng.standard_normal((B, kvh, L, hd)).astype(np.float32) for _ in range(nl)]
    return bs, synth.genai_feeds(ids, np.full((B, 1), 3, np.int64), 3, 1, pks, pvs, cfg)


def dryrun_search(B: int):
    """_dryrun_search's GPT-2-form BeamSearch model (rng 13: V 37, d 16, 2
    heads, 2 layers, max_length 9, 3 beams, 2 returned) and its [B, 4]
    prompts."""
    import numpy as np

    from lele_tpu_torch.onnx import synth

    rng = np.random.default_rng(13)
    V, D, NH, NL, ML, S, nb = 37, 16, 2, 2, 9, 4, 3

    def w(*sh):
        return (rng.standard_normal(sh) / np.sqrt(sh[0])).astype(np.float32)

    p = {"wte": w(V, D) * 3, "wpe": w(ML, D), "lnf_g": w(D) * 0.1 + 1, "lnf_b": w(D) * 0.1}
    for i in range(NL):
        for nm in ("ln1", "ln2"):
            p[f"{nm}_g{i}"] = w(D) * 0.1 + 1
            p[f"{nm}_b{i}"] = w(D) * 0.1
        p[f"attn_w{i}"], p[f"attn_b{i}"] = w(D, 3 * D), w(3 * D) * 0.1
        p[f"proj_w{i}"], p[f"proj_b{i}"] = w(D, D), w(D) * 0.1
        p[f"fc_w{i}"], p[f"fc_b{i}"] = w(D, 4 * D), w(4 * D) * 0.1
        p[f"fcp_w{i}"], p[f"fcp_b{i}"] = w(4 * D, D), w(D) * 0.1
    p["lm_w"] = np.ascontiguousarray(p["wte"].T)
    bs = synth.build_search_model(
        "BeamSearch", synth.build_gpt2_decoder_graph(p, NL, NH), (B, S),
        {"max_length": np.asarray([ML], np.int32), "num_beams": np.asarray([nb], np.int32),
         "num_return_sequences": np.asarray([2], np.int32)},
        dict(eos_token_id=V - 1, pad_token_id=V - 2, model_type=0), 2)
    return bs, rng.integers(0, V - 2, (B, S)).astype(np.int32)


def mha_rules(name, shape):
    """_dryrun_compiled_onnx's Megatron placement of the MHA encoder."""
    if "wqkv" in name or "w1_" in name:
        return (None, "model")
    return ("model", None) if "wo_" in name or "w2_" in name else None


def nbits_rules(name, shape):
    """_dryrun_genai's: MatMulNBits' `_q` / `_s` column parallel."""
    return ("model",) if name.endswith(("_q", "_s")) else None


def expert_rules(name, shape):
    """_dryrun_moe's: QMoE's expert stacks over "model"."""
    return ("model",) if name.startswith(("fc1_", "fc2_", "fc3_")) else None


def dryrun_mesh_legs(checks, dev, mesh) -> None:
    """dryrun_multichip's six remaining legs at their own sizes for one
    device (B = 2), each compiled over the one-rank `mesh` (every axis of
    size 1: no collective) and held to the mesh-free compile on the card at
    the leg's tolerance: the MHA encoder with Megatron rules and
    Attention-23; the pp leg's 4 SAN-M blocks (d 32) as one stage; the
    serving leg's MicroBatcher (each request bit-equal coalesced and
    alone); the int4 GenAI step with `_q` / `_s` rules; BeamSearch; the
    QMoE prefill with expert rules."""
    import threading

    import numpy as np
    import torch

    from lele_tpu_torch.compiler import compile_model
    from lele_tpu_torch.compiler.patterns import F32_NBITS_PATTERNS
    from lele_tpu_torch.models import SenseVoiceConfig
    from lele_tpu_torch.models.sensevoice import init_sensevoice, sanm_block
    from lele_tpu_torch.parallel import pipeline_apply, stack_stage_params
    from lele_tpu_torch.parallel.pipeline import pipe_mesh
    from lele_tpu_torch.parallel.planner import EncoderSpec, plan_mesh, recommend_serving_plan
    from lele_tpu_torch.runtime.batcher import MicroBatcher

    def both(bs, feeds, dims=None, **kw):
        a = compile_model(bs, dim_values=dims, device=dev, mesh=mesh, batch_axis=0, **kw)
        b = compile_model(bs, dim_values=dims, device=dev, patterns=kw.get("patterns"))
        return a.run_np(**feeds), b.run_np(**feeds)

    def close(got, want, atol):
        return max(float(np.abs(g.astype(np.float64) - w).max()) for g, w in zip(got, want)) \
            if all(np.allclose(g, w, atol=atol) for g, w in zip(got, want)) else float("inf")

    # compiled ONNX: the MHA encoder (rules), then Attention-23 under dp
    bs, x, attn, qkv = dryrun_onnx(2, 8)
    got, want = both(bs, {"x": x}, {"B": 2, "T": 8}, seq_axis=1, param_rules=mha_rules)
    a_got, a_want = both(attn, qkv)
    checks.require(close(got, want, 1e-4) < 1e-4 and close(a_got, a_want, 1e-5) < 1e-5,
                   f"(d) compiled ONNX leg: the MHA encoder [2, 8, 32] with Megatron rules "
                   f"within 1e-4 of the mesh-free compile ({close(got, want, 1e-4):.2e}), "
                   f"Attention-23 within 1e-5 ({close(a_got, a_want, 1e-5):.2e})")

    # pp: the 4 SAN-M blocks as the one stage of a one-rank "pipe" mesh
    pcfg = SenseVoiceConfig(n_layers=4, d_model=32, ffn_dim=64, vocab_size=16, n_heads=2,
                            dtype="float32")
    layers = init_sensevoice(torch.Generator(device=dev).manual_seed(1), pcfg)["layers"]
    xp = torch.from_numpy(np.random.default_rng(0).standard_normal((8, 12, 32))
                          .astype(np.float32)).to(dev)
    m12 = torch.ones((8, 12), device=dev)

    def blocks(p, mb):
        for lp in p:
            mb = sanm_block(lp, mb, m12[:mb.shape[0]], pcfg)
        return mb

    with torch.inference_mode():
        got = pipeline_apply(blocks, stack_stage_params([layers]), xp, pipe_mesh(1),
                             n_microbatch=4)
        want = blocks(layers, xp)
    checks.require(torch.allclose(got, want, atol=1e-4),
                   f"(d) pp leg: 4 SAN-M blocks (d 32) in 4 microbatches through a one-stage "
                   f"pipeline, max|d| {float((got - want).abs().max()):.2e} (gate 1e-4)")

    # serving: the planner's plan for one device, a MicroBatcher, bit-equality
    B, T, D = 2, 12, 32
    plan = recommend_serving_plan(EncoderSpec(n_layers=2, d_model=D, ffn=64, vocab=D, seq=T,
                                              batch=B, weight_bytes=4), 1, quantized=False)
    _, kw = plan_mesh(plan)
    sbs, reqs = dryrun_serving(11, 5)
    cm = compile_model(sbs, dim_values={"B": B, "T": T}, device=dev, **kw)
    ref = compile_model(sbs, dim_values={"B": B, "T": T}, device=dev)

    def process(items):
        xb = np.zeros((B, T, D), np.float32)
        xb[:len(items)] = items
        (y,) = cm.run_np(xb)
        return [y[i] for i in range(len(items))]

    mb = MicroBatcher(process, max_batch=B, window_ms=50.0)
    results: list = [None] * len(reqs)
    ts = [threading.Thread(target=lambda i=i: results.__setitem__(i, mb.submit(reqs[i])))
          for i in range(len(reqs))]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    mb.close()
    alone_ok = free_ok = True
    for i, r in enumerate(reqs):
        xb = np.zeros((B, T, D), np.float32)
        xb[0] = r
        alone_ok &= np.array_equal(results[i], cm.run_np(xb)[0][0])
        free_ok &= np.allclose(results[i], ref.run_np(xb)[0][0], atol=1e-5)
    checks.require(alone_ok and free_ok and sum(mb.batch_sizes) == len(reqs),
                   f"(d) serving leg: plan dp{plan.dp}xtp{plan.tp}xsp{plan.sp}, "
                   f"{len(reqs)} requests in batches {mb.batch_sizes}: each bit-equal "
                   f"coalesced and alone ({alone_ok}), within 1e-5 of the mesh-free "
                   f"program ({free_ok})")

    # genai: the int4 step with `_q` / `_s` column rules (f32 route and bf16)
    gbs, feeds = dryrun_genai(2)
    g32, w32 = both(gbs, feeds, patterns=F32_NBITS_PATTERNS, param_rules=nbits_rules)
    g16, w16 = both(gbs, feeds, param_rules=nbits_rules)
    checks.require(close(g32[:1], w32[:1], 1e-4) < 1e-4 and close(g32[1:], w32[1:], 1e-5) < 1e-5
                   and all(np.array_equal(a, b) for a, b in zip(g16, w16)),
                   f"(d) genai leg: the int4 decode step with `_q`/`_s` rules: the f32 route's "
                   f"logits within 1e-4 and caches within 1e-5 of the mesh-free compile; the "
                   f"bf16 route its bits")

    # search: BeamSearch under dp
    sm, ids = dryrun_search(2)
    sg, sw = both(sm, {"input_ids": ids})
    checks.require(np.array_equal(sg[0], sw[0]) and np.allclose(sg[1], sw[1], atol=1e-5),
                   f"(d) search leg: BeamSearch sequences {sg[0].shape} equal to the mesh-free "
                   f"compile's, scores within 1e-5")

    # moe: the QMoE decoder's 4-token prefill with expert rules
    mbs, feeds = dryrun_genai(2, S=4, moe=True)
    mg, mw = both(mbs, feeds, patterns=F32_NBITS_PATTERNS, param_rules=expert_rules)
    checks.require(close(mg[:1], mw[:1], 1e-4) < 1e-4,
                   f"(d) moe leg: the QMoE prefill with expert rules within 1e-4 of the "
                   f"mesh-free compile ({close(mg[:1], mw[:1], 1e-4):.2e})")


def _gloo_card_rank(rank: int, init: str, q) -> None:
    """One of two gloo ranks sharing the card (phase 42 (e)): the MHA encoder
    over model 2 (column and row parallel: all_gather and all_reduce on CUDA
    tensors), then (b)'s Phi-3-mini-width int4 step over model 2 with the
    `_q` / `_s` column rules (kernel 7 on the rank's half of each
    MatMulNBits' columns); rank 0 also runs both mesh-free."""
    import traceback

    import numpy as np
    import torch
    import torch.distributed as dist

    from lele_tpu_torch import kernels as K
    from lele_tpu_torch.compiler import compile_model
    from lele_tpu_torch.onnx.synth import build_genai_decoder
    from lele_tpu_torch.parallel import make_mesh

    try:
        torch.cuda.set_device(0)
        dev = torch.device("cuda", 0)
        dist.init_process_group("gloo", init_method=init, rank=rank, world_size=2)
        mesh = make_mesh(2, data=1, model=2, devices="cuda")
        out: dict = {}
        bs, x, _, _ = dryrun_onnx(2, 8)
        cm = compile_model(bs, dim_values={"B": 2, "T": 8}, mesh=mesh, param_rules=mha_rules)
        y = cm.run_np(x)[0]
        out["mha_wqkv"] = tuple(cm.params["wqkv_l0"].shape)
        if rank == 0:
            ref = compile_model(bs, dim_values={"B": 2, "T": 8}, device=dev).run_np(x)[0]
            out["mha_err"] = float(np.abs(y - ref).max())
        gcfg = genai_forms()[next(iter(genai_forms()))]
        g = build_genai_decoder(genai_params_on_card(gcfg, MESH_SEED, dev), 1, gcfg)
        gm = compile_model(g, device=dev, strict=True, mesh=mesh, param_rules=nbits_rules)
        gen = torch.Generator(device=dev).manual_seed(MESH_SEED)
        shape = (1, gcfg["kvh"], gcfg["L"], gcfg["hd"])
        feeds = {"ids": torch.tensor([[7]], device=dev),
                 "pos": torch.tensor([[GENAI_PROMPT]], device=dev),
                 "slk": torch.tensor([GENAI_PROMPT], dtype=torch.int32, device=dev),
                 "tot": torch.tensor([GENAI_PROMPT + 1], dtype=torch.int32, device=dev)}
        for i in range(gcfg["nl"]):
            for kv in "kv":
                feeds[f"p{kv}{i}"] = torch.randn(shape, generator=gen, device=dev)
        with torch.inference_mode():
            gm(**feeds)
            K.reset_launch_counts()
            got = gm(**feeds)
            torch.cuda.synchronize()
            out["launches"] = moved(K.launch_counts())
            out["wq_local"] = tuple(gm.params["wq0_q::w4pk"].shape)
            out["captured"] = gm.stats["captured"]
            dist.barrier()
            t0 = time.perf_counter()
            for _ in range(10):
                gm(**feeds)
            torch.cuda.synchronize()
            out["step_ms"] = (time.perf_counter() - t0) * 100
            if rank == 0:
                gf = compile_model(g, device=dev, strict=True)
                want = gf(**feeds)
                lg, rl = got[0].float(), want[0].float()
                out["logit_relnorm"] = float((lg - rl).norm() / rl.norm())
                out["logit_max_d"] = float((lg - rl).abs().max())
                out["same_bits"] = all(torch.equal(a, b) for a, b in zip(got, want))
                out["caches_equal"] = all(torch.equal(a, b) for a, b in zip(got[1:], want[1:]))
        dist.barrier()
        q.put((rank, True, out))
    except BaseException:
        q.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def two_rank_phase(checks, card) -> None:
    """Phase 42 (e): two gloo ranks sharing the card, where NCCL refuses two
    ranks on one device. The card machine's gloo takes CUDA tensors for
    all_reduce, all_gather_into_tensor and broadcast but not for send/recv
    (`scripts/torch_port_gloo_cuda_probe.py`), so the pipeline's hop is
    held to JAX on the CPU only; the compiled paths' collectives run here
    (`_gloo_card_rank`). Gloo's collectives are not captured: these tapes
    replay step by step."""
    import multiprocessing as mp
    import queue
    import tempfile

    t0 = time.perf_counter()
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    results: dict = {}
    with tempfile.TemporaryDirectory() as folder:
        init = f"file://{Path(folder) / 'rendezvous'}"
        procs = [ctx.Process(target=_gloo_card_rank, args=(r, init, q)) for r in range(2)]
        for p in procs:
            p.start()
        try:
            while len(results) < 2:
                rank, ok, out = q.get(timeout=240)
                results[rank] = (ok, out)
                if not ok:
                    break
        except queue.Empty:
            pass
        finally:
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join()
    ok = len(results) == 2 and all(r[0] for r in results.values())
    if not ok:
        checks.require(False, f"(e) two gloo ranks on the card: {results}")
        return
    r0, r1 = results[0][1], results[1][1]
    n_nodes = 7 * GENAI_DENSE_LAYERS + 1
    checks.require(r0["mha_err"] <= 1e-4 and r0["mha_wqkv"] == r1["mha_wqkv"] == (32, 48),
                   f"(e) two gloo ranks sharing the card, model 2: the MHA encoder (column "
                   f"and row parallel, all_gather and all_reduce on CUDA tensors) within "
                   f"1e-4 of the mesh-free compile (max|d| {r0['mha_err']:.2e})")
    checks.require(r0["logit_relnorm"] <= NBITS_RELNORM and r0["caches_equal"]
                   and r0["launches"] == r1["launches"] == {"w4_gemm": n_nodes}
                   and r0["wq_local"] == (3072 // 2, 3072 // 2),
                   f"(e) the Phi-3-mini-width int4 step over model 2 (kernel 7 on a rank's "
                   f"{r0['wq_local']} half of wq, {r0['launches']} a rank): logits against "
                   f"the mesh-free compile relative Frobenius {r0['logit_relnorm']:.2e}, "
                   f"max|d| {r0['logit_max_d']:.2e} (gate {NBITS_RELNORM:g}), the same bits "
                   f"{r0['same_bits']}, the caches' bits {r0['caches_equal']}; captured "
                   f"{r0['captured']} (gloo: step by step)")
    print(f"  (e) a step over the two ranks {r0['step_ms']:.2f} / {r1['step_ms']:.2f} ms "
          f"(host clock, mean of 10, both ranks on one card); the two ranks' run "
          f"{time.perf_counter() - t0:.1f} s  ({card})")


def mesh_phase(checks, dev, card) -> dict:
    """Phase 42: the multi-device layer's last pieces on the card, in an NCCL
    process group of one rank (the machine has one card; every axis has
    size 1, so no collective runs; the collectives across ranks are held to
    JAX on the CPU, tests/test_torch_port_{pipeline,mesh}.py).

    (a) The flagship's 50 w8 layers (SenseVoiceConfig(weight_int8=True)) as
    a GPipe pipeline (parallel/pipeline.py) of one stage: B 8 x T 171 in 4
    microbatches, each row of a microbatch one kernel-1 launch over the
    stage's layers; the bits of one kernel-1 launch a row over all 50.
    (b) Phase 35's Phi-3-mini-width int4 decode step (2 of 32 layers)
    through compile_model(mesh=..., param_rules=...) with _dryrun_genai's
    `_q` / `_s` rules: kernel 7 on the rank's shard (here every column),
    the bits of the mesh-free compile. (c) The daemon's engines at full
    width (the w8a16 ASR of the main path, the default YOLO26) over an
    explicit one-rank mesh (`--mesh auto` gives none on one card, as JAX
    on one device): a burst of 8 concurrent /recognize and a /detect; each
    request's ids those of the same engine with the request alone in a
    batch of its size and of the mesh-free engine. (d) dryrun_multichip's
    six remaining legs at their own sizes (`dryrun_mesh_legs`). (e) Two
    gloo ranks sharing the card (`two_rank_phase`).
    → {kernel: {path: launches}}."""
    import concurrent.futures
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from lele_tpu_torch import kernels as K
    from lele_tpu_torch.compiler import compile_model
    from lele_tpu_torch.models import (SenseVoiceConfig, SenseVoiceModel, Yolo26Config,
                                       Yolo26Model, cast_big_params, prepare_w8_params,
                                       stack_layer_params)
    from lele_tpu_torch.onnx.synth import build_genai_decoder
    from lele_tpu_torch.parallel import make_mesh, pipeline_apply, stack_stage_params
    from lele_tpu_torch.parallel.mesh import init_distributed
    from lele_tpu_torch.parallel.pipeline import pipe_mesh
    from lele_tpu_torch.runtime.batcher import MicroBatcher
    from lele_tpu_torch.server import mesh_tag, plan_serving_mesh, serve
    from lele_tpu_torch.serving import SenseVoiceEngine, Yolo26Engine

    banner(f"== 42. the multi-device layer over an NCCL group of one: a 50-layer w8 "
           f"pipeline, the int4 step over a mesh, the daemon's engines over a mesh, the "
           f"dryrun legs ({card})")
    t_phase = time.perf_counter()
    launches: dict[str, dict[str, int]] = {}
    tmp = tempfile.TemporaryDirectory()
    init_distributed(0, 1, f"file://{Path(tmp.name) / 'rendezvous'}", device="cuda")
    try:
        checks.require(plan_serving_mesh() == (None, None),
                       "plan_serving_mesh() on one rank: (None, None), as JAX's on one device")
        mesh = make_mesh(1, seq=1)

        # (a) the 50 w8 layers as a one-stage pipeline, 4 microbatches
        model = SenseVoiceModel(SenseVoiceConfig(weight_int8=True), device=dev)
        model.init(MESH_SEED)
        model.params = stack_layer_params(prepare_w8_params(cast_big_params(model.params,
                                                                            torch.bfloat16)))
        cfg = model.cfg
        layers = model.params["layers_stacked"]
        gen = torch.Generator(device=dev).manual_seed(MESH_SEED)
        x = torch.randn((PIPE_BATCH, T_MAIN, cfg.d_model), generator=gen, device=dev)
        mask = torch.ones(T_MAIN, device=dev)

        def stage(p, mb):
            return torch.stack([K.sanm_stack_w8(row, mask, p, cfg.n_heads, cfg.fsmn_kernel)
                                for row in mb])

        stages = stack_stage_params([layers])
        pmesh = pipe_mesh(1)

        def piped():
            return pipeline_apply(stage, stages, x, pmesh, n_microbatch=PIPE_MICRO)

        def single():
            return stage(layers, x)

        with torch.inference_mode():
            K.reset_launch_counts()
            got = piped()
            torch.cuda.synchronize()
            counted = moved(K.launch_counts())
            want = single()
            pipe_ms = time_ms(piped, runs=5, warm=1)
            one_ms = time_ms(single, runs=5, warm=1)
        launches.setdefault("sanm_stack_w8", {})["(a) the pipeline, a batch"] = \
            counted.get("sanm_stack_w8", 0)
        checks.require(torch.equal(got, want) and counted == {"sanm_stack_w8": PIPE_BATCH},
                       f"(a) {cfg.n_layers} w8 layers, B {PIPE_BATCH} x T {T_MAIN} in "
                       f"{PIPE_MICRO} microbatches through pipeline_apply (one stage): the bits "
                       f"of kernel 1 once a row over all {cfg.n_layers} layers; launches "
                       f"{counted}")
        print(f"  (a) the pipeline {pipe_ms:.3f} ms a batch of {PIPE_BATCH} against "
              f"{one_ms:.3f} ms for the {PIPE_BATCH} single launches (CUDA events, median "
              f"of 5)  ({card})")
        del stages, got, want

        # (b) phase 35's Phi-3-mini-width decode step over the mesh
        gcfg = genai_forms()[next(iter(genai_forms()))]
        inits = genai_params_on_card(gcfg, MESH_SEED, dev)
        gbytes = build_genai_decoder(inits, 1, gcfg)
        del inits
        t0 = time.perf_counter()
        gm = compile_model(gbytes, device=dev, strict=True, mesh=mesh, batch_axis=0,
                           param_rules=nbits_rules)
        gf = compile_model(gbytes, device=dev, strict=True)
        t_compile = time.perf_counter() - t0
        del gbytes
        rng = np.random.default_rng(MESH_SEED)
        shape = (1, gcfg["kvh"], gcfg["L"], gcfg["hd"])
        feeds = {"ids": torch.tensor([[int(rng.integers(0, gcfg["V"]))]], device=dev),
                 "pos": torch.tensor([[GENAI_PROMPT]], device=dev),
                 "slk": torch.tensor([GENAI_PROMPT], dtype=torch.int32, device=dev),
                 "tot": torch.tensor([GENAI_PROMPT + 1], dtype=torch.int32, device=dev)}
        for i in range(gcfg["nl"]):
            for kv in "kv":
                feeds[f"p{kv}{i}"] = torch.randn(shape, generator=gen, device=dev)
        with torch.inference_mode():
            gm(**feeds)
            K.reset_launch_counts()
            out_m = gm(**feeds)
            torch.cuda.synchronize()
            counted = moved(K.launch_counts())
            out_f = gf(**feeds)
            turns: dict = {"mesh": [], "free": []}
            for which in ("free", "mesh", "mesh", "free"):  # in turns, one card
                cm_ = gm if which == "mesh" else gf
                turns[which].append(time_ms(lambda: cm_(**feeds), runs=20) * 1e3)
            m_us, f_us = (statistics.median(turns[k]) for k in ("mesh", "free"))
            m_dev, f_dev = graph_us(lambda: gm(**feeds)), graph_us(lambda: gf(**feeds))
            prep_us = {}  # the host's input preparation of a call (`_prep` of every feed)
            for which, cm_ in (("mesh", gm), ("free", gf)):
                t0 = time.perf_counter()
                for _ in range(100):
                    for n in cm_.input_order:
                        cm_._prep(n, feeds[n])
                torch.cuda.synchronize()
                prep_us[which] = (time.perf_counter() - t0) * 1e4
        n_nodes = 7 * gcfg["nl"] + 1
        launches.setdefault("w4_gemm", {})["(b) the decode step over the mesh"] = \
            counted.get("w4_gemm", 0)
        checks.require(all(torch.equal(a, b) for a, b in zip(out_m, out_f))
                       and counted == {"w4_gemm": n_nodes} and gm.stats["captured"],
                       f"(b) the Phi-3-mini-width int4 decode step ({gcfg['nl']} layers) "
                       f"compiled over the mesh with `_q`/`_s` column rules (compiled in "
                       f"{t_compile:.1f} s with the mesh-free one): the mesh-free compile's "
                       f"bits on {len(out_m)} outputs, kernel 7 {counted.get('w4_gemm', 0)} "
                       f"times a step ({n_nodes} MatMulNBits), captured "
                       f"{gm.stats['captured']}")
        print(f"  (b) a decode step {m_us:.1f} us over the mesh against {f_us:.1f} us "
              f"mesh-free (CUDA events, medians of 20 in turns: mesh {turns['mesh']}, "
              f"mesh-free {turns['free']}; the caches not donated, as phase 35 times its "
              f"step fed back with them donated); device {m_dev:.1f} / {f_dev:.1f} us (20 "
              f"calls in one CUDA graph); the inputs' preparation {prep_us['mesh']:.1f} / "
              f"{prep_us['free']:.1f} us a call (host clock, 100 calls)  ({card})")
        del gm, gf, out_m, out_f, feeds
        torch.cuda.empty_cache()

        # (c) the daemon's engines at full width over the explicit mesh
        model.mesh = mesh
        free_model = SenseVoiceModel(cfg, params=model.params, fbank=model.fbank, device=dev)
        det_m = Yolo26Model(Yolo26Config(), device=dev)
        det_m.init(MESH_SEED)
        asr, det = SenseVoiceEngine(model=model), Yolo26Engine(model=det_m, mesh=mesh)
        free, free_det = SenseVoiceEngine(model=free_model), Yolo26Engine(model=det_m)
        engines = {"asr": asr, "asr_batcher": MicroBatcher(asr.recognize_batch, 8, 5.0),
                   "det": det, "det_batcher": MicroBatcher(det.detect_batch, 8, 5.0),
                   "mesh": mesh, "mesh_tag": mesh_tag(mesh)}
        batches = record_batches(engines["asr_batcher"])
        httpd = serve(port=0, engines=engines)
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        import threading

        th = threading.Thread(target=httpd.serve_forever, daemon=True)
        th.start()
        try:
            st, body, _ = http(url + "/healthz")
            checks.require(st == 200 and json.loads(body) == {"ok": True, "mesh": "dp1xsp1xtp1"},
                           f"(c) /healthz over the explicit mesh: {st} {body!r}")
            rng = np.random.default_rng(MESH_SEED)
            burst = [wav_bytes(synth_speechlike(MESH_SECONDS, rng)) for _ in range(MESH_BURST)]

            def timed(w):
                t0 = time.perf_counter()
                r = http(url + "/recognize", w)
                return r, (time.perf_counter() - t0) * 1e3

            for n in (1, 2, 4, 8):  # every batch bucket's program captured first
                asr.recognize_batch(burst[:n])
            with concurrent.futures.ThreadPoolExecutor(MESH_BURST) as ex:
                list(ex.map(timed, burst))
                seen = len(batches)
                K.reset_launch_counts()
                rs = list(ex.map(timed, burst))
                torch.cuda.synchronize()
                served = moved(K.launch_counts())
            formed = batches[seen:]
            answers = {w: json.loads(b)["ids"] for w, ((st, b, _), _) in zip(burst, rs)
                       if st == 200}
            silence = wav_bytes(np.zeros(int(MESH_SECONDS * SR), np.float32))
            alone_ok = free_ok = True
            for b in formed:
                for w in b:
                    alone = [w] + [silence] * (len(b) - 1)
                    alone_ok &= asr.recognize_batch(alone)[0] == answers.get(w)
                    free_ok &= free.recognize_batch(alone)[0] == answers.get(w)
            p50 = statistics.median(t for _, t in rs)
            for k in ("sanm_stack_w8", "w8_gemm"):
                launches.setdefault(k, {})["(c) a burst of 8 /recognize over the mesh"] = \
                    served.get(k, 0)
            checks.require(len(answers) == MESH_BURST and alone_ok and free_ok
                           and served.get("w8_gemm", 0) > 0,
                           f"(c) {MESH_BURST} concurrent {MESH_SECONDS:.0f} s /recognize on the "
                           f"w8a16 engine over the mesh, in batches {[len(b) for b in formed]}: "
                           f"each request's ids those of the same engine with it alone in a "
                           f"batch of its size ({alone_ok}) and of the mesh-free engine "
                           f"({free_ok}); launches {served}")
            buf = io.BytesIO()
            from PIL import Image

            Image.fromarray(np.random.default_rng(MESH_SEED).integers(
                0, 256, (480, 640, 3), dtype=np.uint8)).save(buf, "JPEG")
            st, body, _ = http(url + "/detect", buf.getvalue())
            checks.require(st == 200 and json.loads(body)["detections"]
                           == json.loads(json.dumps(free_det.detect(buf.getvalue()))),
                           f"(c) /detect over the mesh: {st}, the mesh-free engine's "
                           f"detections")
            print(f"  (c) a {MESH_SECONDS:.0f} s /recognize in a burst of {MESH_BURST}: "
                  f"p50 {p50:.2f} ms (host clock, the batches {[len(b) for b in formed]})  "
                  f"({card})")
        finally:
            httpd.shutdown()
            httpd.server_close()
            for k in ("asr_batcher", "det_batcher"):
                engines[k].close()
        del model, free_model, asr, free, det, free_det, det_m, engines
        torch.cuda.empty_cache()

        # (d) the six dryrun legs at their own sizes
        dryrun_mesh_legs(checks, dev, mesh)
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
        tmp.cleanup()
    two_rank_phase(checks, card)
    print(f"  phase 42 in {time.perf_counter() - t_phase:.1f} s; launches {launches}")
    return launches


# phase 43: the last modules of the JAX package (ROADMAP §1.4): the AOT
# forms of phase 6's compiled graph, the native model's AOT bundle, the
# precisions, the registered ops and the native decoder
AOT_RUN = """
import json, sys, time
t0 = time.perf_counter()
mode, gen, feeds_path, out_path = sys.argv[1:5]
sys.path.insert(0, gen)
import numpy as np, torch
from lele_tpu_torch import kernels as K
from lele_tpu_torch.kernels import _build
feeds = dict(np.load(feeds_path))
torch.cuda.init()
# torch's flags at TF32: each form must run at the precision it was built at
torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
t_import = time.perf_counter() - t0
aot = None
if mode == "pt2":
    from lele_tpu_torch.compiler.aot import load_exported
    from lele_tpu_torch.runtime.artifact import load_flat
    dev = torch.device("cuda", 0)
    call = load_exported(gen + "/PhaseSanm.pt2")
    params = load_flat(gen + "/PhaseSanm_weights", dev)
    rest = [torch.as_tensor(feeds[n]).to(device=dev, dtype=getattr(torch, dt))
            for n, dt in json.loads(sys.argv[5])]
    run = lambda: call(params, (), rest)
else:
    from PhaseSanm import PhaseSanm
    m = PhaseSanm()
    aot = m.aot_loaded
    run = lambda: m._cm(**feeds)
torch.cuda.synchronize()
t_model = time.perf_counter() - t0
counts = []
for i in range(3):
    K.reset_launch_counts()
    outs = run()
    torch.cuda.synchronize()
    if i == 0:
        t_first = time.perf_counter() - t0
    counts.append({k: v for k, v in K.launch_counts().items() if v})
np.savez(out_path, *[o.cpu().numpy() for o in outs])
print(json.dumps({"import_s": t_import, "model_s": t_model, "first_s": t_first,
                  "aot_loaded": aot,
                  "built": _build.BUILT, "counts": counts,
                  "build_dir": str(_build.BUILD_DIR)}))
"""

NATIVE_AOT_RUN = """
import json, sys, time
t0 = time.perf_counter()
prefix, feats_path, out_path = sys.argv[1:4]
import numpy as np, torch
from lele_tpu_torch import kernels as K
from lele_tpu_torch.kernels import _build
from lele_tpu_torch.runtime.artifact import load_aot_bundle
# torch's flags at TF32: the call must run at the precision saved with it
torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
fn, params = load_aot_bundle(prefix)
feats = torch.from_numpy(np.load(feats_path)).cuda()
K.reset_launch_counts()
logits = fn(params, feats)
torch.cuda.synchronize()
t_first = time.perf_counter() - t0
np.save(out_path, logits.cpu().numpy())
print(json.dumps({"load_s": fn.load_s, "first_s": t_first, "built": _build.BUILT,
                  "counts": {k: v for k, v in K.launch_counts().items() if v}}))
"""

MATMUL_PROBE = """
import json, torch
g = torch.Generator(device="cuda").manual_seed(0)
a = torch.randn(4096, 4096, device="cuda", generator=g)
b = torch.randn(4096, 4096, device="cuda", generator=g)
ref = (a.double() @ b.double())
out = {}
def err(label):
    torch.cuda.synchronize()
    y = a @ b
    out[label] = float((y.double() - ref).abs().max() / ref.abs().max())
torch.backends.cuda.matmul.allow_tf32 = False
err("allow_tf32 False (ieee)")
torch.backends.cuda.matmul.allow_tf32 = True
err("allow_tf32 True (tf32)")
torch.backends.cuda.matmul.allow_tf32 = False
torch.set_float32_matmul_precision("medium")
err("set_float32_matmul_precision medium")
torch.set_float32_matmul_precision("highest")
try:
    torch.backends.cuda.matmul.fp32_precision = "bf16"
    err("fp32_precision bf16")
except Exception as e:
    out["fp32_precision bf16"] = f"refused: {e}"
out["bf16 operands"] = float(((a.bfloat16() @ b.bfloat16()).double() - ref).abs().max()
                             / ref.abs().max())
print(json.dumps(out))
"""


def aot_phase(checks, dev, card, gen: Path, cm, feeds: dict, model) -> dict:
    """Phase 43: the slice's paths at full width.

    (a) phase 6's 50-layer int8 SAN-M graph as phase 38's `python -m
    lele_tpu_torch.cli ... --aot --xc` subprocess wrote it to `gen`, then
    four fresh processes: the wrapper traced from the graph with the warm build
    directory; `load_exported(<Class>.pt2)` on the blob's params; the
    wrapper with `<Class>.xc/` and `LELE_CACHE_DIR` an empty directory
    (aot_loaded, no kernel built); the wrapper traced with an empty build
    directory (nvcc runs). Each gives `cm`'s bits on `feeds`, kernels 4 and
    5 once a call, and its seconds from start to a model and to the first
    result. (b) the native w8a16 model's encoder (kernels 1 and 2) through
    `save_aot_bundle` and `load_aot_bundle` in a fresh process: the
    in-process program's and forward_fn's bits, the load seconds split.
    The fresh processes set torch's flags to TF32, so each form must run at
    the precision it was built at. (c) ResNet-50 f32 at N = 8 and the SD 1.5
    block at each precision: time in a CUDA graph and max|d|/max|ref|
    against "highest", and the "highest" model's `.pt2` run while torch's
    flags allow TF32 gives its bits; a [4096, 4096]^2 product against f64
    under each of torch's switches. (d) `torch.library.opcheck` on the
    12 ops with CUDA tensors, and each op's host cost over its launch alone.
    (e) 64 synthetic WAVs decoded by the native decoder and the Python
    parser. → {kernel: {path: launches}}."""
    import tempfile

    import numpy as np
    import torch

    from lele_tpu_torch import kernels as K
    from lele_tpu_torch.compiler import compile_model
    from lele_tpu_torch.compiler.aot import export_model, load_exported
    from lele_tpu_torch.config import precision_scope
    from lele_tpu_torch.models.sensevoice import sensevoice_encode
    from lele_tpu_torch.runtime.artifact import canonical, export_program, save_aot_bundle
    from lele_tpu_torch.runtime.dataloader import decode_wav_files
    from lele_tpu_torch.utils.wav import encode_wav, read_wav

    banner(f"== 43. AOT (--aot, --xc, load_aot_bundle), precisions, registered ops, the "
           f"native decoder ({card})")
    launches: dict[str, dict[str, int]] = {}
    here = Path(__file__).resolve().parent
    tmp = tempfile.TemporaryDirectory()
    folder = Path(tmp.name)
    try:
        # (a) the compiled graph's four cold starts
        t_ph = time.perf_counter()
        np.savez(folder / "feeds.npz", **{k: (v.cpu().numpy() if torch.is_tensor(v) else v)
                                          for k, v in feeds.items()})
        want = [o.cpu().numpy() for o in cm(**feeds)]
        mpath = gen / "PhaseSanm.xc" / "manifest.json"
        manifest = json.loads(mpath.read_text()) if mpath.exists() else {}
        checks.require((gen / "PhaseSanm.pt2").exists()
                       and sorted(manifest.get("libraries", {})) == ["dq_gemm", "sanm_dql"]
                       and manifest.get("device", "").startswith("sm_"),
                       f"phase 38's cli --aot --xc wrote PhaseSanm.pt2 and PhaseSanm.xc/: "
                       f"libraries {sorted(manifest.get('libraries', {}))}, device "
                       f"{manifest.get('device')}, torch {manifest.get('torch')}, CUDA "
                       f"{manifest.get('cuda')}")
        traced = traced_copy(gen, folder / "gen_traced")
        order = json.dumps([[n, str(cm._dtypes[n])[6:]] for n in cm.input_order])
        runs = (("traced, warm build directory", "wrapper", traced, None),
                ("load_exported(PhaseSanm.pt2), warm build directory", "pt2", gen, None),
                ("PhaseSanm.xc/, empty LELE_CACHE_DIR", "wrapper", gen, folder / "cache_xc"),
                ("traced, empty build directory (nvcc)", "wrapper", traced,
                 folder / "cache_cold"))
        rows = []
        for i, (label, mode, where, cache) in enumerate(runs):
            if cache is not None:
                cache.mkdir()
            env = {k: v for k, v in os.environ.items() if k != "LELE_CACHE_DIR"}
            if cache is not None:
                env["LELE_CACHE_DIR"] = str(cache)
            out = folder / f"outs{i}.npz"
            t0 = time.perf_counter()
            p = subprocess.run([sys.executable, "-c", AOT_RUN, mode, str(where),
                                str(folder / "feeds.npz"), str(out), order], cwd=here,
                               capture_output=True, text=True, timeout=600, env=env)
            wall = time.perf_counter() - t0
            if p.returncode != 0:
                checks.require(False, f"AOT run {label}: exit {p.returncode}: "
                                      f"{p.stderr[-2000:]}")
                continue
            res = json.loads(p.stdout.strip().splitlines()[-1])
            with np.load(out) as z:
                got = [z[f"arr_{j}"] for j in range(len(z.files))]
            bits = len(got) == len(want) and all(np.array_equal(g, w)
                                                   for g, w in zip(got, want))
            once = all(c.get("sanm_stack_dql") == 1 and c.get("dq_gemm") == 1
                       for c in res["counts"])
            ok = bits and once
            if "xc" in label:
                ok = ok and res["aot_loaded"] is True and res["built"] == []
            if "nvcc" in label:
                ok = ok and "sanm_dql" in res["built"]
            checks.require(ok, f"AOT run {label}: the compiled model's bits {bits}; launches "
                               f"a call {res['counts']}; aot_loaded {res['aot_loaded']}, "
                               f"built {res['built']}")
            rows.append((label, res, wall))
            for k, v in res["counts"][0].items():
                launches.setdefault(k, {})[f"43a {label}"] = v
        for label, res, wall in rows:
            print(f"  cold start, {label}: imports and the card {res['import_s']:.2f} s, "
                  f"model {res['model_s']:.2f} s, first result "
                  f"{res['first_s']:.2f} s from the script's start, process wall {wall:.2f} s"
                  f"; built {res['built'] or 'nothing'}  ({card})")
        print(f"  (a) done in {time.perf_counter() - t_ph:.1f} s")

        # (b) the native model's encoder as a bundle
        t_ph = time.perf_counter()
        cfg = model.cfg
        pcm = synth_speechlike(10.0, np.random.default_rng(SEED + 431))
        feats = model.fbank(pcm).contiguous()

        def encode(params, f):
            mask = torch.ones((1, f.shape[0]), dtype=torch.float32, device=f.device)
            return sensevoice_encode(params, f[None], mask, cfg)

        t0 = time.perf_counter()
        prog = export_program(encode, model.params, feats)
        export_s = time.perf_counter() - t0
        ops = sorted({n.target.name().split("::")[1].split(".")[0] for n in prog.graph.nodes
                      if n.op == "call_function" and hasattr(n.target, "name")
                      and n.target.name().startswith("lele_tpu_torch::")})
        K.reset_launch_counts()
        with torch.inference_mode(), precision_scope():  # what the bundle records
            ref = prog.module()(canonical(model.params), feats)
        torch.cuda.synchronize()
        inproc = K.launch_counts()
        eager = model.forward_fn()(model.params, pcm)
        prefix = folder / "native" / "sv_w8"
        prefix.parent.mkdir()
        t0 = time.perf_counter()
        save_aot_bundle(prefix, prog, model.params)
        save_s = time.perf_counter() - t0
        np.save(folder / "feats.npy", feats.cpu().numpy())
        p = subprocess.run([sys.executable, "-c", NATIVE_AOT_RUN, str(prefix),
                            str(folder / "feats.npy"), str(folder / "native_out.npy")],
                           cwd=here, capture_output=True, text=True, timeout=600)
        if p.returncode != 0:
            checks.require(False, f"load_aot_bundle in a fresh process: {p.stderr[-2000:]}")
        else:
            res = json.loads(p.stdout.strip().splitlines()[-1])
            got = np.load(folder / "native_out.npy")
            bits = np.array_equal(got, ref.cpu().numpy())
            eager_bits = torch.equal(ref, eager)
            ok = (bits and eager_bits and ops == ["sanm_stack_w8", "w8_gemm"]
                  and res["built"] == []
                  and res["counts"] == {"w8_gemm": 1, "sanm_stack_w8": 1}
                  and inproc["sanm_stack_w8"] == 1 and inproc["w8_gemm"] == 1)
            checks.require(ok, f"native w8a16 encoder ({cfg.n_layers} layers, d{cfg.d_model}) "
                               f"through save_aot_bundle / load_aot_bundle: the in-process "
                               f"program's bits {bits} (and forward_fn's {eager_bits}); ops "
                               f"{ops}; fresh process launches {res['counts']}, built "
                               f"{res['built']}")
            for k, v in res["counts"].items():
                launches.setdefault(k, {})["43b load_aot_bundle"] = v
            ls = res["load_s"]
            print(f"  native bundle: export {export_s:.2f} s, save {save_s:.2f} s; fresh "
                  f"process: program {ls['program']:.3f} s and params {ls['params']:.3f} s "
                  f"(concurrent; {ls['total']:.3f} s both), first logits "
                  f"{res['first_s']:.2f} s from the script's start  ({card})")
        print(f"  (b) done in {time.perf_counter() - t_ph:.1f} s")

        # (c) the precisions
        t_ph = time.perf_counter()
        p = subprocess.run([sys.executable, "-c", MATMUL_PROBE], cwd=here,
                           capture_output=True, text=True, timeout=300)
        probe = json.loads(p.stdout.strip().splitlines()[-1]) if p.returncode == 0 else {}
        checks.require(p.returncode == 0, f"the [4096, 4096]^2 precision probe: "
                                          f"{p.stderr[-1000:]}")
        for k, v in probe.items():
            print(f"  [4096, 4096]^2 f32 product vs f64, {k}: "
                  f"{v if isinstance(v, str) else f'max|d|/max|ref| {v:.3e}'}  ({card})")
        resnet, _ = resnet50_model()
        xr = torch.from_numpy(np.random.default_rng(RESNET_SEED + 1).standard_normal(
            (8, 3, 224, 224)).astype(np.float32)).to(dev)
        sd, _ = sd_block_model()
        b, side, C = SD_BLOCK["batch"], SD_BLOCK["side"], SD_BLOCK["channels"]
        srng = np.random.default_rng(SD_SEED + 1)
        sfeeds = {"h": torch.from_numpy(srng.standard_normal((b, side, side, C)).astype(
            np.float32)).to(dev), "temb": torch.from_numpy(srng.standard_normal(
                (b, C)).astype(np.float32)).to(dev)}
        flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        exported: list[str] = []
        for label, bs, kw, fd in (("ResNet-50 f32, N = 8", resnet, {"dim_values": {"N": 8}},
                                   {"data": xr}),
                                  ("SD 1.5 UNet block f32", sd, {}, sfeeds)):
            outs, times = {}, {}
            for prec in ("highest", "high", "default"):
                m = compile_model(bs, device=dev, strict=True, precision=prec, **kw).compile()
                outs[prec] = m(**fd)[0].clone()
                times[prec] = time_ms(lambda: m(**fd))
                if prec == "highest":  # its export, run while torch's flags allow TF32
                    call = load_exported(export_model(m, folder / f"prec{len(exported)}"))
                    rest = [m._prep(n, fd[n]) for n in m.input_order]
                    try:
                        torch.backends.cuda.matmul.allow_tf32 = True
                        torch.backends.cudnn.allow_tf32 = True
                        got = call(m.params, (), rest)[0]
                    finally:
                        (torch.backends.cuda.matmul.allow_tf32,
                         torch.backends.cudnn.allow_tf32) = flags
                    exported.append(label)
                    checks.require(call.precision == "highest" and torch.equal(got, outs[prec]),
                                   f"{label}: its .pt2 at highest, loaded and run while torch's "
                                   f"flags allow TF32, gives the tape's bits "
                                   f"(saved precision {call.precision!r})")
                same = (torch.backends.cuda.matmul.allow_tf32,
                        torch.backends.cudnn.allow_tf32) == flags
                checks.require(m.stats["captured"] and same,
                               f"{label} at {prec}: captured {m.stats['captured']}, torch's "
                               f"TF32 flags restored after the capture and replay {same}")
                del m
            top = outs["highest"].abs().max().item()
            parts = []
            for prec in ("highest", "high", "default"):
                rel = (outs[prec] - outs["highest"]).abs().max().item() / top
                parts.append(f"{prec} {times[prec]:.4f} ms, max|d|/max|ref| {rel:.3e}")
                checks.require(bool(torch.isfinite(outs[prec]).all()) and rel <= 1e-2,
                               f"{label} at {prec}: finite, {rel:.3e} <= 1e-2 of highest's")
            print(f"  {label}, in a CUDA graph: " + "; ".join(parts) + f"  ({card})")
        print(f"  (c) done in {time.perf_counter() - t_ph:.1f} s")

        # (d) the registered ops on the card
        t_ph = time.perf_counter()
        samples = K.op_samples(dev)
        for name in sorted(K.KERNEL_WRAPPERS):
            op = getattr(torch.ops.lele_tpu_torch, name).default
            try:
                res = torch.library.opcheck(op, samples[name])
                ok = set(res.values()) == {"SUCCESS"}
            except Exception as e:  # noqa: BLE001 - the check reports it
                res, ok = f"{type(e).__name__}: {str(e)[:400]}", False
            checks.require(ok, f"opcheck lele_tpu_torch::{name} on the card: {res}")
        x1 = torch.randn((1, 512), device=dev).to(torch.bfloat16)
        wq = torch.randint(-127, 128, (512, 2048), device=dev, dtype=torch.int8)
        ws = torch.rand((2048,), device=dev) * 1e-3
        xd = torch.randn((1, 512), device=dev)
        colsum = wq.to(torch.int32).sum(0, dtype=torch.int32)
        a_scale, a_zp = K.quant_matmul.dql_scale_zp(xd)
        pairs = (("w8_matmul, x [1, 512] bf16 @ [512, 2048]",
                  lambda: K.w8_matmul(x1, wq, ws),
                  lambda: K.quant_matmul.w8_matmul_kernel(x1, wq, ws)),
                 ("fused_dq_matmul, x [1, 512] @ [512, 2048]",
                  lambda: K.fused_dq_matmul(xd, wq, colsum, a_scale, a_zp, 2.5e-3),
                  lambda: K.quant_matmul.fused_dq_matmul_kernel(xd, wq, colsum, a_scale,
                                                               a_zp, 2.5e-3)))
        for label, via_op, direct in pairs:
            t_op, t_direct = host_us(via_op), host_us(direct)
            print(f"  {label}: {t_op:.2f} us of host time a call through the registered op, "
                  f"{t_direct:.2f} us calling the launch directly: the dispatcher adds "
                  f"{t_op - t_direct:.2f} us  ({card})")
        print(f"  (d) done in {time.perf_counter() - t_ph:.1f} s")

        # (e) the native decoder
        t_ph = time.perf_counter()
        wrng = np.random.default_rng(SEED + 435)
        paths = []
        for i in range(64):
            p_ = folder / "wav" / f"w{i:02d}.wav"
            p_.parent.mkdir(exist_ok=True)
            p_.write_bytes(encode_wav(synth_speechlike(10.0, wrng), SR))
            paths.append(p_)
        n_bytes = sum(p_.stat().st_size for p_ in paths)
        nat = decode_wav_files(paths)
        py = [read_wav(p_, try_native=False) for p_ in paths]
        same = all(s1 == s2 and np.array_equal(a1, a2) for (a1, s1), (a2, s2) in zip(nat, py))
        t_nat = host_ms(lambda: decode_wav_files(paths), runs=5)
        t_py = host_ms(lambda: [read_wav(p_, try_native=False) for p_ in paths], runs=5)
        checks.require(same, "the native decoder gives the Python parser's samples on 64 WAVs")
        print(f"  64 WAVs of 10 s (PCM16 mono, {n_bytes / 1e6:.1f} MB): native decode_wav_files "
              f"{t_nat:.2f} ms ({n_bytes / t_nat / 1e3:.0f} MB/s, {640 / t_nat * 1e3:.0f} s of "
              f"audio a second), the Python parser {t_py:.2f} ms ({n_bytes / t_py / 1e3:.0f} "
              f"MB/s), {os.cpu_count()} host cores (host clock)  ({card})")
        print(f"  (e) done in {time.perf_counter() - t_ph:.1f} s")
    finally:
        tmp.cleanup()
    return launches


def host_us(fn, calls: int = 2000) -> float:
    """Median host microseconds of one fn() call (an asynchronous launch),
    over `calls` calls in blocks of 100 with a device sync between blocks."""
    import torch

    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(calls // 100):
        t0 = time.perf_counter()
        for _ in range(100):
            fn()
        per.append((time.perf_counter() - t0) * 1e4)
        torch.cuda.synchronize()
    return statistics.median(per)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card; the port's kernels run only on one",
              file=sys.stderr)
        return 1

    import numpy as np

    from lele_tpu_torch import kernels as K
    from lele_tpu_torch.kernels import _build
    from lele_tpu_torch.kernels.quant_matmul import align_rows
    from lele_tpu_torch.kernels.sanm_block import layer_view
    from lele_tpu_torch.models import (
        SenseVoiceConfig,
        SenseVoiceModel,
        cast_big_params,
        prepare_w8_params,
        stack_layer_params,
    )
    from lele_tpu_torch.models.checkpoints import SenseVoiceOnnx
    from lele_tpu_torch.onnx.synth import build_sanm_int8_model
    from lele_tpu_torch.runtime.bucketing import pad_pcm
    from lele_tpu_torch.serving import SenseVoiceEngine

    t_start = time.perf_counter()
    # the plain versions are the oracle: full f32 products, no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    checks = Checks()
    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)

    banner("== 1. build")
    t0 = time.perf_counter()
    _build.build()
    print(f"  built {_build.sources()} in {time.perf_counter() - t0:.2f} s")

    banner("== 2. card")
    card = card_identity()
    print(card)
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    print(f"  torch.backends.cuda.matmul.allow_tf32 = {torch.backends.cuda.matmul.allow_tf32}, "
          f"torch.backends.cudnn.allow_tf32 = {torch.backends.cudnn.allow_tf32}")

    # the full-width model: its layers also give phase 3 its real shapes
    cfg = SenseVoiceConfig(weight_int8=True)
    model = SenseVoiceModel(cfg, device=dev)
    model.init(SEED)
    model.params = stack_layer_params(
        prepare_w8_params(cast_big_params(model.params, torch.bfloat16)))
    stacked = model.params["layers_stacked"]
    wbytes = sum(t.numel() for t in (
        *(stacked[k]["wq8"] for k in ("qkv", "out", "ffn1", "ffn2")),
        model.params["ctc"]["wq8"]))
    print(f"  model: {cfg.n_layers} layers, d{cfg.d_model}, vocab {cfg.vocab_size}, "
          f"{wbytes / 1e6:.1f} MB of int8 weights resident")
    L, D, F, H, FK = cfg.n_layers, cfg.d_model, cfg.ffn_dim, cfg.n_heads, cfg.fsmn_kernel

    err = {name: 0.0 for name in K.KERNEL_WRAPPERS}
    banner("== 3. kernels vs plain on the card")
    for T in W8_ROWS:
        for (k_, n_) in GEMM_SHAPES:
            wq = torch.randint(-127, 128, (k_, n_), generator=gen, device=dev,
                               dtype=torch.int8)
            ws = torch.rand((n_,), generator=gen, device=dev) * 2e-3 + 1e-4
            for dtype, tol in ((torch.bfloat16, 1e-3), (torch.float32, 1e-5)):
                x = torch.randn((T, k_), generator=gen, device=dev).to(dtype)
                got = K.w8_matmul(x, wq, ws)
                ref = K.w8_matmul_plain(x, wq, ws)
                torch.cuda.synchronize()
                d = (got - ref).abs().max().item()
                scale = ref.abs().max().item()
                err["w8_gemm"] = max(err["w8_gemm"], d)
                checks.require(
                    got.shape == ref.shape and d <= tol * scale,
                    f"w8_gemm [{T},{k_}]x[{k_},{n_}] {str(dtype)[6:]}: "
                    f"max|d| {d:.3e} <= {tol:g} * {scale:.3e}")
    for T, k_, n_ in ((T_MAIN, *GEMM_SHAPES[-1]), (4 * T_MAIN, 2048, 512)):
        x = torch.randn((T, k_), generator=gen, device=dev).to(torch.bfloat16)
        wq = torch.randint(-127, 128, (k_, n_), generator=gen, device=dev, dtype=torch.int8)
        ws = torch.rand((n_,), generator=gen, device=dev) * 2e-3 + 1e-4
        # the head's weight as prepare_w8_params keeps it: rows padded to a
        # multiple of 16 bytes, which the wrapper passes as they lie (in the
        # loop above it copied the contiguous, unaligned rows into such)
        wq = align_rows(wq)
        ref = K.w8_matmul_plain(x, wq, ws)
        d = (K.w8_matmul(x, wq, ws) - ref).abs().max().item()
        err["w8_gemm"] = max(err["w8_gemm"], d)
        checks.require(d <= 1e-3 * ref.abs().max().item(),
                       f"w8_gemm [{T},{k_}]x[{k_},{n_}] bf16, rows {wq.stride(0)} bytes apart: "
                       f"max|d| {d:.3e} <= 1e-3 * {ref.abs().max().item():.3e}")
        checks.require(torch.equal(K.w8_matmul(x, wq, ws), K.w8_matmul(x, wq, ws))
                       and graph_same_bits(lambda: K.w8_matmul(x, wq, ws)),
                       f"w8_gemm [{T},{k_}]x[{k_},{n_}]: a repeat call and a CUDA-graph replay "
                       f"give the eager call's bits")
        one_launch_check(checks, f"w8_gemm [{T},{k_}]x[{k_},{n_}]",
                         lambda: K.w8_matmul(x, wq, ws), "w8_wgmma")

    def layer_check(T, n_valid, lp, name, fn, plain):
        x = torch.randn((T, D), generator=gen, device=dev) * 0.5
        mask = torch.zeros((T,), device=dev)
        mask[:n_valid] = 1.0
        got = fn(x, mask, lp, H, FK)
        ref = plain(x, mask, lp, H, FK)
        torch.cuda.synchronize()
        g, r = got[:n_valid], ref[:n_valid]
        d = (g - r).abs().max().item()
        scale = r.abs().max().item()
        ok = bool(torch.isfinite(g).all()) and torch.allclose(
            g, r, rtol=2e-2, atol=2e-2 * scale)
        err[name] = max(err[name], d)
        checks.require(ok, f"{name} T={T} valid={n_valid}: max|d| {d:.3e}, "
                           f"rtol 2e-2, atol 2e-2 * {scale:.3e}")

    lp0 = layer_view(stacked, 0)
    layer_check(T_MAIN, T_MAIN, lp0, "sanm_layer_w8", K.sanm_layer_w8,
                K.sanm_layer_w8_plain)
    layer_check(T_RAGGED, VALID_RAGGED, lp0, "sanm_layer_w8", K.sanm_layer_w8,
                K.sanm_layer_w8_plain)
    # kernel 3 stays seven launches a layer (the stack kernel at L = 1 lost at
    # T = 21 and head dims 32 and 64: PERF.md §6)
    x = torch.randn((T_MAIN, D), generator=gen, device=dev) * 0.5
    mask = torch.ones((T_MAIN,), device=dev)
    nodes = graph_nodes(lambda: K.sanm_layer_w8(x, mask, lp0, H, FK))
    n_kernels = sum(kind == "KERNEL" for kind, _ in nodes)
    checks.require(n_kernels == 7, f"sanm_layer_w8 T={T_MAIN}, one call captured in a CUDA "
                                   f"graph: {n_kernels} kernel nodes, seven")
    stack_checks(checks, err, "sanm_stack_w8", "weight_int8", stacked, dev, gen, H, FK)

    # kernel 5: the same device scale and zero point on both sides, an exact
    # int32 sum and one f32 epilogue, so the two should agree bit for bit
    for T in (T_DQL, T_RAGGED):
        for (k_, n_) in GEMM_SHAPES:
            wq = torch.randint(-127, 128, (k_, n_), generator=gen, device=dev,
                               dtype=torch.int8)
            colsum = wq.to(torch.int32).sum(0, dtype=torch.int32)
            x = torch.randn((T, k_), generator=gen, device=dev) * 2.0
            _, a_scale, a_zp = K.dynamic_quantize_u8(x)
            w_scale = 2.5e-3
            got = K.fused_dq_matmul(x, wq, colsum, a_scale, a_zp, w_scale)
            ref = K.fused_dq_matmul_plain(x, wq, colsum, a_scale, a_zp, w_scale)
            torch.cuda.synchronize()
            d = (got - ref).abs().max().item()
            scale = ref.abs().max().item()
            err["dq_gemm"] = max(err["dq_gemm"], d)
            checks.require(got.shape == ref.shape and d <= 1e-6 * scale,
                           f"dq_gemm [{T},{k_}]x[{k_},{n_}]: max|d| {d:.3e} "
                           f"<= 1e-6 * {scale:.3e}")

    # kernel 5's strip form at the main path's rows: the compiled head at
    # the three buckets (T = 36, 100, 196) and the quant_pallas route's four
    # linears at 1 s and 10 s (T = 21, 171), through both C entries (a host
    # w_scale and a device one): the same bits as the plain version
    for T, k_, n_ in DQ_STRIP_SHAPES:
        wq = torch.randint(-127, 128, (k_, n_), generator=gen, device=dev, dtype=torch.int8)
        colsum = wq.to(torch.int32).sum(0, dtype=torch.int32)
        x = torch.randn((T, k_), generator=gen, device=dev) * 2.0
        _, a_scale, a_zp = K.dynamic_quantize_u8(x)
        for w_scale in (2.5e-3, torch.tensor([2.5e-3], device=dev)):
            got = K.fused_dq_matmul(x, wq, colsum, a_scale, a_zp, w_scale)
            ref = K.fused_dq_matmul_plain(x, wq, colsum, a_scale, a_zp, w_scale)
            torch.cuda.synchronize()
            d = (got - ref).abs().max().item()
            err["dq_gemm"] = max(err["dq_gemm"], d)
            checks.require(torch.equal(got, ref),
                           f"dq_gemm {'tile' if max(k_, n_) <= 512 else 'strip'} form "
                           f"[{T},{k_}]x[{k_},{n_}] "
                           f"{'device' if isinstance(w_scale, torch.Tensor) else 'host'} "
                           f"w_scale: equal to plain (max|d| {d:.3e})")

    # the ragged edges: K not a multiple of 16 and an odd N (kernel 5); the
    # other head dims kernel 4 compiles (32, 64, 128) on two small layers
    x = torch.randn((5, 130), generator=gen, device=dev)
    wq = torch.randint(-127, 128, (130, 33), generator=gen, device=dev, dtype=torch.int8)
    colsum = wq.to(torch.int32).sum(0, dtype=torch.int32)
    _, a_scale, a_zp = K.dynamic_quantize_u8(x)
    got = K.fused_dq_matmul(x, wq, colsum, a_scale, a_zp, 1e-2)
    ref = K.fused_dq_matmul_plain(x, wq, colsum, a_scale, a_zp, 1e-2)
    d, scale, _ = compare(got, ref)
    checks.require(d <= 1e-6 * scale, f"dq_gemm [5,130]x[130,33]: max|d| {d:.3e} "
                                      f"<= 1e-6 * {scale:.3e}")
    for heads in (4, 2, 1):
        small = random_dql_stack(2, 128, 256, FK, dev, gen)
        bias, vmask = dql_masks(2, 45, 40, dev)
        x = torch.randn((45, 128), generator=gen, device=dev)
        call = lambda: K.sanm_stack_dql(x, bias, vmask, small, heads, FK, (FK - 1) // 2)  # noqa: E731
        got, again = call(), call()
        ref = K.sanm_stack_dql_plain(x, bias, vmask, small, heads, FK, (FK - 1) // 2)
        d, scale, mean = compare(got, ref)
        same, graph_same = torch.equal(got, again), graph_same_bits(call)
        checks.require(torch.allclose(got, ref, rtol=2e-2, atol=2e-2 * scale) and same
                       and graph_same and mean <= STACK_NOISE_MEAN,
                       f"sanm_stack_dql head dim {128 // heads}, 2 layers, T=45: "
                       f"max|d|/max|ref| {d / scale:.3e}, rtol 2e-2, atol 2e-2*max|ref|, "
                       f"mean|d| {mean:.3e} std; a repeat call the same bits {same}, a "
                       f"CUDA-graph replay {graph_same}")

    # kernel 4 at full width: each of the 50 layers on the plain version's
    # own activation (the layer tolerance), then the whole stack
    dql = random_dql_stack(L, D, F, FK, dev, gen)
    pad_left = (FK - 1) // 2
    for T, n_valid in ((T_DQL, VALID_DQL), (T_DQL_RAGGED, VALID_DQL_RAGGED)):
        bias, vmask = dql_masks(L, T, n_valid, dev)
        x = torch.randn((T, D), generator=gen, device=dev)
        worst, worst_mean, ok = 0.0, 0.0, True
        for i in range(L):
            li = layer_slice(dql, i)
            got = K.sanm_stack_dql(x, bias[i:i + 1], vmask[i:i + 1], li, H, FK, pad_left)
            ref = K.sanm_stack_dql_plain(x, bias[i:i + 1], vmask[i:i + 1], li, H, FK,
                                         pad_left)
            d, scale, mean = compare(got, ref)
            err["sanm_stack_dql"] = max(err["sanm_stack_dql"], d)
            worst, worst_mean = max(worst, d / scale), max(worst_mean, mean)
            ok = ok and bool(torch.isfinite(got).all()) and torch.allclose(
                got, ref, rtol=2e-2, atol=2e-2 * scale) and mean <= LAYER_NOISE_MEAN
            x = ref
        checks.require(ok, f"sanm_stack_dql T={T} valid={n_valid}, each of {L} layers: "
                           f"max|d|/max|ref| {worst:.3e}, rtol 2e-2, atol 2e-2*max|ref|; "
                           f"mean|d| {worst_mean:.3e} std <= {LAYER_NOISE_MEAN:g}")
        x = torch.randn((T, D), generator=gen, device=dev)
        call = lambda: K.sanm_stack_dql(x, bias, vmask, dql, H, FK, pad_left)  # noqa: E731
        got, again = call(), call()
        ref = K.sanm_stack_dql_plain(x, bias, vmask, dql, H, FK, pad_left)
        noise = K.sanm_stack_dql_plain(x * (1 + 1e-7 * torch.randn(
            x.shape, generator=gen, device=dev)), bias, vmask, dql, H, FK, pad_left)
        d, scale, mean = compare(got, ref)
        nd, _, nmean = compare(noise, ref)
        checks.require(
            bool(torch.isfinite(got).all()) and mean <= STACK_NOISE_MEAN
            and d <= STACK_NOISE_MAX * scale,
            f"sanm_stack_dql T={T}, {L} layers whole: mean|d| {mean:.3e} std, "
            f"max|d|/max|ref| {d / scale:.3e} (plain vs plain at a 1e-7 input step: "
            f"{nmean:.3e} std, {nd / scale:.3e}); gate {STACK_NOISE_MEAN} std, "
            f"{STACK_NOISE_MAX}")
        checks.require(torch.equal(got, again) and graph_same_bits(call),
                       f"sanm_stack_dql T={T}, {L} layers: a repeat call and a CUDA-graph "
                       "replay give the eager call's bits")
        if T == T_DQL:
            one_launch_check(checks, f"sanm_stack_dql T={T}, {L} layers", call,
                             "sanm_dql_kernel")

    banner("== 4. main path: SenseVoiceEngine.recognize at full width")
    engine = SenseVoiceEngine(model=model)
    requests = [wav_bytes(synth_speechlike(s, rng)) for s in REQUEST_SECONDS]
    K.reset_launch_counts()
    answers = [engine.recognize(r) for r in requests]
    torch.cuda.synchronize()
    launches = K.launch_counts()
    for s, ids in zip(REQUEST_SECONDS, answers):
        checks.require(all(0 <= i < cfg.vocab_size for i in ids),
                       f"request {s} s: {len(ids)} tokens, ids in [0, vocab)")
    n_req = len(requests)
    print(f"  launch counts over {n_req} requests: {launches}")
    checks.require(launches["sanm_layer_w8"] == 0, "sanm_layer_w8 never (the stack is one "
                                                   "launch of sanm_stack_w8)")
    checks.require(launches["sanm_stack_w8"] == n_req, "sanm_stack_w8 once per request")
    checks.require(launches["w8_gemm"] == n_req, "w8_gemm (CTC head) once per request")
    # the same weights as per-layer params (not stacked): each layer on kernel 3
    per_layer = {k: v for k, v in model.params.items() if k != "layers_stacked"}
    per_layer["layers"] = [layer_view(stacked, i) for i in range(L)]
    layer_engine = SenseVoiceEngine(model=SenseVoiceModel(cfg, params=per_layer,
                                                          fbank=model.fbank, device=dev))
    K.reset_launch_counts()
    ids_layers = layer_engine.recognize(requests[-1])
    torch.cuda.synchronize()
    layer_launches = K.launch_counts()
    print(f"  launch counts of one 10 s request on per-layer params: {layer_launches}")
    checks.require(layer_launches["sanm_layer_w8"] == L and layer_launches["sanm_stack_w8"] == 0
                   and layer_launches["w8_gemm"] == 1,
                   f"per-layer params: sanm_layer_w8 {L} times, no stack, the CTC head once")
    checks.require(all(0 <= i < cfg.vocab_size for i in ids_layers),
                   f"per-layer request: {len(ids_layers)} tokens, ids in [0, vocab)")
    register_ids("SenseVoice w8a16 bucketed B = 1 (kernels 1, 2), 10 s and 8.5 s of one bucket",
                 model, [(p[None], [n]) for p, n in (
                     pad_pcm(synth_speechlike(s, np.random.default_rng(SEED + 40)))
                     for s in (10.0, 8.5))])

    pcm10 = synth_speechlike(10.0, np.random.default_rng(SEED + 1))
    fwd, fwd_plain = model.forward_fn(), model.forward_fn(plain=True)
    got = fwd(model.params, pcm10)
    ref = fwd_plain(model.params, pcm10)
    torch.cuda.synchronize()
    rel = ((got - ref).abs().max() / ref.abs().max()).item()
    agree = (got.argmax(-1) == ref.argmax(-1)).float().mean().item()
    checks.require(tuple(got.shape) == (1, T_MAIN, cfg.vocab_size)
                   and bool(torch.isfinite(got).all()),
                   f"10 s logits {tuple(got.shape)} finite")
    checks.require(rel <= 5e-2, f"10 s logits kernel vs plain: max|d|/max|ref| {rel:.3e} <= 5e-2")
    checks.require(agree >= 0.98, f"10 s frame-argmax agreement {agree:.4f} >= 0.98")

    banner(f"== 5. timings (CUDA events, median of {TIMED_RUNS}; {card})")
    ms, plain_ms, library_ms, bounds = {}, {}, {}, {}
    for (k_, n_) in GEMM_SHAPES:
        x = torch.randn((T_MAIN, k_), generator=gen, device=dev).to(torch.bfloat16)
        wq = torch.randint(-127, 128, (k_, n_), generator=gen, device=dev,
                           dtype=torch.int8)
        ws = torch.rand((n_,), generator=gen, device=dev) * 2e-3
        wq = align_rows(wq)  # as prepare_w8_params keeps it
        a = time_ms(lambda: K.w8_matmul(x, wq, ws))
        b = time_ms(lambda: K.w8_matmul_plain(x, wq, ws))
        print(f"  w8_gemm [{T_MAIN},{k_}]x[{k_},{n_}] bf16: kernel {a:.4f} ms, "
              f"plain {b:.4f} ms  ({card})")
        ms["w8_gemm"], plain_ms["w8_gemm"] = a, b  # the last is the CTC head
    # the CTC head's one library call: bf16 x by a weight dequantized to bf16
    w_bf16 = (wq.float() * ws).to(torch.bfloat16)
    library_ms["w8_gemm"] = time_ms(lambda: torch.matmul(x, w_bf16))
    bounds["w8_gemm"] = w8_bound(T_MAIN, k_, n_)
    # kernel 2 at every shape its paths run, 20 calls in a CUDA graph, beside
    # the library call and the bound
    for m, k_, n_ in W8_TIMED:
        x = torch.randn((m, k_), generator=gen, device=dev).to(torch.bfloat16)
        wq = torch.randint(-127, 128, (k_, n_), generator=gen, device=dev, dtype=torch.int8)
        ws = torch.rand((n_,), generator=gen, device=dev) * 2e-3 + 1e-4
        wq = align_rows(wq)  # as prepare_w8_params keeps it (the heads' rows padded)
        w_bf16 = (wq.float() * ws).to(torch.bfloat16)
        g_k = graph_us(lambda: K.w8_matmul(x, wq, ws))
        g_l = graph_us(lambda: torch.matmul(x, w_bf16))
        b_ms, by = w8_bound(m, k_, n_)
        print(f"  w8_gemm [{m},{k_}]x[{k_},{n_}] bf16: {g_k:.2f} us in a CUDA graph; torch.matmul "
              f"{g_l:.2f} us; bound {b_ms * 1e3:.2f} us ({by})  ({card})")
        if m == T_MAIN and n_ == GEMM_SHAPES[-1][1]:
            DEVICE_US["w8_gemm"] = {"graph_us": g_k, "library_graph_us": g_l}
    x = torch.randn((T_MAIN, D), generator=gen, device=dev) * 0.5
    mask = torch.ones((T_MAIN,), device=dev)
    w8_layer_bytes = D * 3 * D + D * D + D * F + F * D + 4 * (3 * D + D + F + D) * 2 \
        + 4 * (4 * D + FK * D)
    w8_layer_ops = 2 * T_MAIN * D * (4 * D + 2 * F) + 4 * T_MAIN * T_MAIN * D
    for name, tree, n_layers in (("sanm_layer_w8", lp0, 1), ("sanm_stack_w8", stacked, L)):
        fn, plain = K.KERNEL_WRAPPERS[name], getattr(K, f"{name}_plain")
        ms[name] = time_ms(lambda: fn(x, mask, tree, H, FK))
        plain_ms[name] = time_ms(lambda: plain(x, mask, tree, H, FK))
        library_ms[name] = None
        bounds[name] = bound(n_layers * w8_layer_bytes + 2 * T_MAIN * D * 4,
                             {"bf16": n_layers * w8_layer_ops})
        print(f"  {name} T={T_MAIN}: kernel {ms[name]:.4f} ms, "
              f"plain {plain_ms[name]:.4f} ms  ({card})")
    d_k, g_k = device_times(lambda: K.sanm_layer_w8(x, mask, lp0, H, FK))
    DEVICE_US["sanm_layer_w8"] = {"device_us": d_k, "graph_us": g_k}
    print(f"  sanm_layer_w8 T={T_MAIN}: device {fmt_us(d_k)} by the profiler, {g_k:.2f} us in "
          f"a CUDA graph  ({card})")
    stack_times("sanm_stack_w8", stacked, dev, gen, H, FK, card)
    pcm10_dev = torch.from_numpy(pcm10).to(dev)
    f_ms = time_ms(lambda: fwd(model.params, pcm10))
    fp_ms = time_ms(lambda: fwd_plain(model.params, pcm10))
    f_g = graph_us(lambda: fwd(model.params, pcm10_dev))
    print(f"  forward_fn 10 s: kernel path {f_ms:.4f} ms (RTF {f_ms / 1e4:.3e}), {f_g:.2f} us "
          f"in a CUDA graph (the PCM on the card); plain path {fp_ms:.4f} ms (RTF "
          f"{fp_ms / 1e4:.3e})  ({card})")

    # kernel 5 at the CTC head of the compiled graph, and its library yardstick
    k_, n_ = GEMM_SHAPES[-1]
    wq = torch.randint(-127, 128, (k_, n_), generator=gen, device=dev, dtype=torch.int8)
    colsum = wq.to(torch.int32).sum(0, dtype=torch.int32)
    x = torch.randn((T_DQL, k_), generator=gen, device=dev)
    _, a_scale, a_zp = K.dynamic_quantize_u8(x)
    ms["dq_gemm"] = time_ms(lambda: K.fused_dq_matmul(x, wq, colsum, a_scale, a_zp, 2.5e-3))
    plain_ms["dq_gemm"] = time_ms(
        lambda: K.fused_dq_matmul_plain(x, wq, colsum, a_scale, a_zp, 2.5e-3))
    # torch._int_mm takes i8 operands with N a multiple of 8: the head's
    # 25,055 columns padded to 25,056; it forms the int32 product only
    a_i8 = (K.quant_matmul.dql_quantize(x, a_scale, a_zp) - 128).to(torch.int8)
    w_pad = torch.zeros((k_, -(-n_ // 8) * 8), dtype=torch.int8, device=dev)
    w_pad[:, :n_] = wq
    try:  # a yardstick only: the port never calls it
        library_ms["dq_gemm"] = time_ms(lambda: torch._int_mm(a_i8, w_pad))
    except RuntimeError as e:
        print(f"  torch._int_mm refused the operands: {e}")
        library_ms["dq_gemm"] = None
    bounds["dq_gemm"] = bound(T_DQL * k_ * 4 + k_ * n_ + n_ * 4 + T_DQL * n_ * 4,
                              {"int8": 2 * T_DQL * k_ * n_})
    print(f"  dq_gemm [{T_DQL},{k_}]x[{k_},{n_}]: kernel {ms['dq_gemm']:.4f} ms, "
          f"plain {plain_ms['dq_gemm']:.4f} ms, torch._int_mm (N padded to "
          f"{w_pad.shape[1]}) {library_ms['dq_gemm']} ms  ({card})")
    # the device's own time a call (torch.profiler) beside the events, at the
    # three buckets' rows: kernel 5 (its quantize pass and GEMM) and
    # torch._int_mm on the same codes
    for T in (36, T_DQL_RAGGED, T_DQL):
        xt = torch.randn((T, k_), generator=gen, device=dev)
        _, s_t, z_t = K.dynamic_quantize_u8(xt)
        a_t = (K.quant_matmul.dql_quantize(xt, s_t, z_t) - 128).to(torch.int8)
        kern = lambda: K.fused_dq_matmul(xt, wq, colsum, s_t, z_t, 2.5e-3)  # noqa: E731
        ev = time_ms(kern)
        d_k, g_k = device_times(kern)
        d_l, g_l, ev_l = None, None, None
        if library_ms["dq_gemm"] is not None:
            ev_l = time_ms(lambda: torch._int_mm(a_t, w_pad))
            d_l, g_l = device_times(lambda: torch._int_mm(a_t, w_pad))
        b_ms, by = bound(T * k_ * 4 + k_ * n_ + n_ * 4 + T * n_ * 4, {"int8": 2 * T * k_ * n_})
        print(f"  dq_gemm [{T},{k_}]x[{k_},{n_}]: device a call {fmt_us(d_k)} by the profiler, "
              f"{g_k:.2f} us in a CUDA graph (events {ev:.4f} ms); torch._int_mm "
              f"{fmt_us(d_l)}, {fmt_us(g_l)} (events {ev_l} ms); bound {b_ms * 1e3:.2f} us by "
              f"{by}, kernel's graph time at {100e3 * b_ms / g_k:.2f}% of it  ({card})")
        if T == T_DQL:
            DEVICE_US["dq_gemm"] = {"device_us": d_k, "graph_us": g_k, "library_device_us": d_l,
                                    "library_graph_us": g_l}
    bias, vmask = dql_masks(L, T_DQL, VALID_DQL, dev)
    x = torch.randn((T_DQL, D), generator=gen, device=dev)
    ms["sanm_stack_dql"] = time_ms(
        lambda: K.sanm_stack_dql(x, bias, vmask, dql, H, FK, pad_left))
    plain_ms["sanm_stack_dql"] = time_ms(
        lambda: K.sanm_stack_dql_plain(x, bias, vmask, dql, H, FK, pad_left), runs=5)
    library_ms["sanm_stack_dql"] = None
    # per layer: int8 weights; colsum, ws and b (4 bytes each per output);
    # norms and FSMN taps; the [T] key bias and value mask. Then x in, y out.
    # The attention runs as 3 TF32 products a multiply-add on the tensor
    # cores; the f32 CUDA-core bound of the same work is printed beside it
    dql_bytes = L * (D * 3 * D + D * D + D * F + F * D + 12 * (5 * D + F)
                     + 4 * (4 * D + FK * D) + 8 * T_DQL) + 2 * T_DQL * D * 4
    dql_int8 = L * 2 * T_DQL * D * (4 * D + 2 * F)
    dql_attn = L * 4 * T_DQL * T_DQL * D
    bounds["sanm_stack_dql"] = bound(dql_bytes, {"int8": dql_int8, "tf32": 3 * dql_attn})
    f32_ms, _ = bound(dql_bytes, {"int8": dql_int8, "f32": dql_attn})
    dql_call = lambda: K.sanm_stack_dql(x, bias, vmask, dql, H, FK, pad_left)  # noqa: E731
    d_k, g_k = device_times(dql_call)
    DEVICE_US["sanm_stack_dql"] = {"device_us": d_k, "graph_us": g_k}
    print(f"  sanm_stack_dql T={T_DQL}, {L} layers: kernel {ms['sanm_stack_dql']:.4f} ms, "
          f"plain {plain_ms['sanm_stack_dql']:.4f} ms; device {fmt_us(d_k)} by the profiler, "
          f"{g_k:.2f} us in a CUDA graph; bound {bounds['sanm_stack_dql'][0] * 1e3:.2f} us "
          f"with 3xTF32 attention ({f32_ms * 1e3:.2f} us with f32 CUDA-core attention)  "
          f"({card})")
    ph = K.sanm_block.dql_phase_us(x, bias, vmask, dql, H, FK, pad_left)
    print(f"    phases a layer (us, mean of {ph.shape[0]}): "
          + ", ".join(f"{n} {v:.2f}" for n, v in zip(K.sanm_block.DQL_PHASES,
                                                      ph.mean(0).tolist()))
          + f"; timer span {ph.sum().item():.1f} us  ({card})")
    for name, (b_ms, by) in bounds.items():
        print(f"  bound {name}: {b_ms * 1e3:.2f} us by {by}; kernel at "
              f"{100 * b_ms / ms[name]:.2f}% of it  ({card})")

    banner("== 6. compiled main path: SenseVoiceOnnx.transcribe at full width")
    t0 = time.perf_counter()
    graph = build_sanm_int8_model(L=50, d=512, h=4, ffn=2048, vocab=25055,
                                  int8_head=True, seed=GRAPH_SEED)
    print(f"  graph: {len(graph) / 1e6:.1f} MB of ONNX bytes, built in "
          f"{time.perf_counter() - t0:.2f} s")
    sv = SenseVoiceOnnx(graph, device=dev)
    sv_ref = SenseVoiceOnnx(graph, device=dev, patterns=[])
    requests = [synth_speechlike(s, rng) for s in REQUEST_SECONDS]
    compile_s = {}
    for s, pcm in zip(REQUEST_SECONDS, requests):  # one trace per bucket
        t0 = time.perf_counter()
        sv.transcribe(pcm)
        compile_s[s] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sv_ref.transcribe(requests[-1])
    compile_ref_s = time.perf_counter() - t0
    print(f"  first request per bucket (trace + run): "
          f"{', '.join(f'{s} s: {v:.2f} s' for s, v in compile_s.items())}; "
          f"per-op 10 s: {compile_ref_s:.2f} s  ({card})")
    K.reset_launch_counts()
    answers = [sv.transcribe(pcm) for pcm in requests]
    torch.cuda.synchronize()
    dql_launches = K.launch_counts()
    vocab = 25055
    for s, ids in zip(REQUEST_SECONDS, answers):
        checks.require(len(ids) > 0 and all(0 <= i < vocab for i in ids),
                       f"compiled request {s} s: {len(ids)} tokens, ids in [0, vocab)")
    print(f"  launch counts over {n_req} requests: {dql_launches}")
    checks.require(dql_launches["sanm_stack_dql"] == n_req, "sanm_stack_dql once per request")
    checks.require(dql_launches["dq_gemm"] == n_req, "dq_gemm (CTC head) once per request")
    checks.require(all(dql_launches[k] == 0 for k in ("w8_gemm", "sanm_layer_w8",
                                                      "sanm_stack_w8")),
                   "no w8a16 kernel on the compiled path")
    for t_pad, cm in sorted(sv._cms.items()):
        hits = cm.stats["pattern_hits"]
        checks.require(hits.get("sanm_fused_layers") == 50
                       and hits.get("dql_matmul_dataflow", 0) >= 1,
                       f"pattern hits at {t_pad} frames: {hits}")
    checks.require(sv_ref._cms and all(not cm.stats["pattern_hits"]
                                       for cm in sv_ref._cms.values()),
                   "the per-op path matches no pattern")

    pcm10 = requests[-1]
    got, ref = sv.logits(pcm10), sv_ref.logits(pcm10)
    noise = sv_ref.logits(pcm10 * (1 + 1e-7 * np.random.default_rng(SEED + 2)
                                   .standard_normal(pcm10.size)).astype(np.float32))
    torch.cuda.synchronize()
    _, _, mae = compare(got, ref)
    _, _, n_mae = compare(noise, ref)
    agree = (got.argmax(-1) == ref.argmax(-1)).float().mean().item()
    n_agree = (noise.argmax(-1) == ref.argmax(-1)).float().mean().item()
    checks.require(tuple(got.shape) == (1, VALID_DQL, vocab)
                   and bool(torch.isfinite(got).all()),
                   f"compiled 10 s logits {tuple(got.shape)} finite")
    checks.require(mae <= LOGIT_NOISE_MAE and agree >= LOGIT_NOISE_AGREE,
                   f"compiled 10 s logits fused vs per-op: MAE {mae:.3e} std, argmax "
                   f"agreement {agree:.4f} (per-op vs per-op at a 1e-7 PCM step: "
                   f"{n_mae:.3e} std, {n_agree:.4f}); gate {LOGIT_NOISE_MAE} std, "
                   f"{LOGIT_NOISE_AGREE}")
    req_ms = host_ms(lambda: sv.transcribe(pcm10))
    req_ref_ms = host_ms(lambda: sv_ref.transcribe(pcm10), runs=3)
    cm10 = sv._cms[max(sv._cms)]
    inputs10 = sv._inputs(sv._pad_frames(sv.frontend(pcm10), max(sv._cms)), VALID_DQL - 4)
    graph_ms = time_ms(lambda: cm10(**inputs10))
    pcm10b = synth_speechlike(9.5, np.random.default_rng(SEED + 6))
    inputs10b = sv._inputs(sv._pad_frames(sv.frontend(pcm10b), max(sv._cms)),
                           sv._true_frames(len(pcm10b)))
    register_cm("compiled SenseVoice 10 s bucket (kernels 4, 5)", cm10, [inputs10, inputs10b])
    print(f"  10 s request (host clock, median): fused {req_ms:.3f} ms (RTF "
          f"{req_ms / 1e4:.3e}), per-op {req_ref_ms:.3f} ms (RTF {req_ref_ms / 1e4:.3e}); "
          f"the fused graph alone {graph_ms:.3f} ms by CUDA events  ({card})")

    profile_top(lambda: cm10(**inputs10), "compiled 10 s forward", card)

    vad_launches = silero_phases(checks, dev, gen, card, err, ms, plain_ms, library_ms,
                                 bounds)
    w4_launches = w4_phases(checks, dev, gen, card, err, ms, plain_ms, library_ms, bounds,
                            fwd, model.params)
    s5_launches = slice5_phases(checks, dev, gen, card, err, ms, plain_ms, library_ms, bounds)
    tts_launches = supertonic_phases(checks, dev, gen, card, err, ms, plain_ms, library_ms,
                                     bounds)
    llm_launches = llm_phases(checks, dev, gen, card, err, ms, plain_ms, library_ms, bounds)
    s8_launches = slice8_phases(checks, dev, gen, card, err, ms, plain_ms, library_ms, bounds,
                                model, sv_ref, inputs10, inputs10b)
    yolo_phases(checks, dev, card)
    decode_phase(checks, dev, card)
    capture_phase(checks, card)
    silero_blocks(checks, dev, card)
    cf_launches = control_flow_phase(checks, dev, card)
    genai_launches = genai_phase(checks, dev, card)
    ops_phase(checks, dev, card)
    quant_launches = quant_phase(checks, dev, card)
    import tempfile

    shared = tempfile.TemporaryDirectory()  # phase 38's CLI output, phase 43's input
    entry_launches = entry_points_phase(checks, dev, card, graph, cm10, inputs10,
                                        Path(shared.name) / "gen")
    tail_launches = op_tail_phase(checks, dev, card, cm10.stats["pattern_hits"])
    search_launches = search_phase(checks, dev, card)
    train_phase(checks, dev, card)
    mesh_launches = mesh_phase(checks, dev, card)
    aot_launches = aot_phase(checks, dev, card, Path(shared.name) / "gen", cm10, inputs10,
                             model)
    shared.cleanup()

    banner(None)
    if checks.failures:
        print(f"chip_smoke: {len(checks.failures)} check(s) failed:", file=sys.stderr)
        for f in checks.failures:
            print(f"  {f}", file=sys.stderr)
        return 1

    replaces = {
        "w8_gemm": ("lele_tpu_torch/csrc/w8_gemm.cu",
                    "lele_tpu/kernels/quant_matmul.py:267",
                    "bf16 max|d| <= 1e-3*max|ref|, f32 <= 1e-5*max|ref|", launches),
        "sanm_layer_w8": ("lele_tpu_torch/csrc/sanm_layer.cu",
                          "lele_tpu/kernels/sanm_block.py:110",
                          "rtol 2e-2, atol 2e-2*max|ref| on valid rows", layer_launches),
        "sanm_stack_w8": ("lele_tpu_torch/csrc/sanm_stack.cu",
                          "lele_tpu/kernels/sanm_block.py:229",
                          "rtol 2e-2, atol 2e-2*max|ref| on valid rows", launches),
        "dq_gemm": ("lele_tpu_torch/csrc/dq_gemm.cu",
                    "lele_tpu/kernels/quant_matmul.py:142",
                    "max|d| <= 1e-6*max|ref|", dql_launches),
        "sanm_stack_dql": ("lele_tpu_torch/csrc/sanm_dql.cu",
                           "lele_tpu/kernels/sanm_block.py:434",
                           "each layer rtol 2e-2, atol 2e-2*max|ref|; whole stack "
                           f"mean|d| <= {STACK_NOISE_MEAN} std; phase 34 the flat export's "
                           f"bits and MAE <= {LOGIT_NOISE_MAE} std of per-op",
                           dql_launches),
        "lstm_seq": ("lele_tpu_torch/csrc/lstm_seq.cu", "lele_tpu/kernels/lstm.py:21",
                     f"hs, h_S, c_S max|d| <= {LSTM_TOL:g}; probabilities vs plain "
                     f"<= {VAD_PROB_TOL:g}; phase 34 SileroOnnx.speech_probs' bits",
                     vad_launches["native"]),
        "w4_gemm": ("lele_tpu_torch/csrc/w4_gemm.cu",
                    "lele_tpu/kernels/w4_matmul.py:144",
                    "bf16 and f32 max|d| <= 1e-5*max|ref|", w4_launches),
        "sanm_stack_w4": ("lele_tpu_torch/csrc/sanm_stack.cu",
                          "lele_tpu/kernels/sanm_block.py:621",
                          "rtol 2e-2, atol 2e-2*max|ref| on valid rows", w4_launches),
        "gru_seq": ("lele_tpu_torch/csrc/gru_seq.cu", "lele_tpu/kernels/gru.py:18",
                    f"hs, h_S max|d| <= {GRU_TOL:g}", s5_launches["gru"]),
        "est_block": ("lele_tpu_torch/csrc/est_block.cu", "lele_tpu/kernels/est_block.py:121",
                      f"max|d| <= 2^-8*max|ref|; TTS waveforms fused vs unfused corr > "
                      f"{TTS_CORR}, max|d| <= {TTS_REL:g}*max|ref|", tts_launches),
        "flash_attn": ("lele_tpu_torch/csrc/flash_attn.cu", "lele_tpu/ops/attention_ops.py:34",
                       f"vs f64 rel-max-err <= 2e-2 and <= 3 x max(plain's, 1e-6); vs plain "
                       f"max|d| <= {FLASH_REL:g}*max|ref|; Phi-3 logits vs plain-Attention "
                       f"<= {LLM_REL:g}*max|ref|", llm_launches),
        "int8_gemm": ("lele_tpu_torch/csrc/int8_gemm.cu", "lele_tpu/kernels/quant_matmul.py:355",
                      f"exact (int32); quantized logits vs plain <= {QUANT_REL:g}*max|ref|",
                      s8_launches),
    }
    stack_form = ("one cooperative launch for all L layers, seven phases a layer between "
                  "grid barriers (LN1, qkv, attention + FSMN, out + residual, LN2, ffn1, ffn2 "
                  "+ residual); tolerance also: a repeat call and a CUDA-graph replay the same "
                  "bits (times: T=171, 50 layers; T=21, 87, 196, 1,004 in phases 5 and 14)")
    forms = {  # kernels with more than one form: which the numbers are of
        "w8_gemm": "bf16 x on wgmma (csrc/w8_wgmma.cuh): y^T = W^T x^T, the int8 tile widened "
                   "in registers into the A operand from an ldmatrix.trans, x's TMA tile the "
                   "B operand, a producer warp's TMA ring on mbarriers (operands in 16-byte rows, "
                   "others copied so by the wrapper), 128 channels by 64-256 rows a block and K "
                   "split by a cluster from the shape, programmatic dependent launch; f32 x as "
                   "f32 FMA (times: the CTC head [171,512]x[512,25055] with "
                   "its rows padded as prepare_w8_params keeps them; every path shape in a "
                   "CUDA graph in phase 5)",
        "sanm_stack_w8": stack_form,
        "sanm_stack_w4": stack_form,
        "sanm_layer_w8": "seven launches (times: T=171; launches: a request on per-layer "
                         "params, phase 4)",
        "lstm_seq": "register form for H <= 128 (one block of 256 threads a batch row, two "
                    "units' four gate columns a thread over a quarter of the rows, 24 of its 32 "
                    "rows of Wh in registers and 8 in shared memory, one barrier a step, Wh "
                    "staged by bulk copies; times: S=18,750 H=128, and S=3, 312, 1,875 in a "
                    "CUDA graph); cluster of 8 for 128 < H <= 1024 (phases 15-18)",
        "w4_gemm": "tile form (mma.sync; group-accumulator in k-steps of 16 or 8, "
                   "dequantised-tile, exact f32) above the decode form's rows; decode form "
                   "(csrc/w4_gemv.cuh: split-K GEMV, the group form on mma.sync through a "
                   "cp.async ring a warp for M <= 8, the others on the CUDA cores for M <= 4, "
                   "a cluster splitting K where strips are few) and every expert-indexed "
                   "launch; any even K and group "
                   "<= 512 (times: the CTC head, tile form; decode shapes warm and cold, by "
                   "device time, in phase 18)",
        "dq_gemm": "quantize pass + strip form (the tile form, dq_gemm_mma, where N and K "
                   "are both <= 512): every row up to 256 in one row of blocks, "
                   "64-column weight strips streamed once by a 4-stage cp.async ring, "
                   "byte-transposed B fragments of mma.sync m16n8k32, a cluster splitting K "
                   "where strips are few, the output staged for coalesced stores (times: "
                   "the CTC head [196,512]x[512,25055]; T = 36, 100 by device time in "
                   "phase 5)",
        "gru_seq": "register form for H <= 128 (one block a batch row, all of Rh in "
                   "registers, 2 units a thread; times: S=18,750 H=128, "
                   "linear_before_reset); cluster of 8 for 128 < H <= 1024",
        "est_block": "a fixed sequence of launches a call (8 or 9 a block: LN, q and kv "
                     "GEMMs, attention, out, LN, ffn1, ffn2; times at T=1,024 Tk=320, 8 "
                     "blocks)",
        "sanm_stack_dql": "one cooperative launch for all L layers, eleven phases a layer "
                          "between grid barriers (LN1, quantize, qkv, f32 attention on 3xTF32 "
                          "mma.sync with the keys split across CTAs + FSMN, quantize, out + "
                          "residual, LN2, quantize, ffn1, quantize, ffn2 + residual, split K); "
                          "int8 mma.sync m16n8k32 on DQL codes quantized once a linear by the "
                          "grid (times: T=196, 50 layers)",
        "flash_attn": "3xTF32 on mma.sync m16n8k8 for D <= 256 (f32 FFMA above), 64-row q "
                      "tiles on chip, 64-key tiles through a cp.async ring, exact skipping "
                      "of dead key tiles from a prepass of the mask, online softmax in "
                      "registers (times: the Phi-3 prefill, B=1 H=32 Lq=1,920 Lk=4,096 D=96 "
                      "with its float mask)",
        "int8_gemm": "kernel 5's strip core (csrc/dq_gemm.cuh) with the raw int32 store: "
                     "64 MI rows by a 64-column strip a block, K tiles by TMA (64-byte swizzle) "
                     "through an mbarrier ring with a block's K in flight, the weight tile "
                     "transposed once and ldmatrix fragments of mma.sync m16n8k32 s8 at MI <= 2, "
                     "a cluster splitting K where blocks are few, programmatic dependent launch; "
                     "cp.async where rows are not 16-byte aligned (times: ffn1 of the 10 s "
                     "request, [171,512]x[512,2048]; every linear in phase 25)",
    }
    library = {  # where no single PyTorch call computes the kernel's function
        "est_block": "composite: the 8 blocks as bf16 library calls (addmm, layer_norm, "
                     "scaled_dot_product_attention, gelu)",
        "flash_attn": "F.scaled_dot_product_attention, f32 inputs, TF32 off",
        "int8_gemm": "torch._int_mm (i8 x i8 -> i32)",
    }
    print(f"chip_smoke: every check passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": counts[name], "max_abs_err": err[name], "tolerance": tol,
         "ms": ms[name], "plain_ms": plain_ms[name], "bound_ms": bounds[name][0],
         "bound_by": bounds[name][1], "library_ms": library_ms[name],
         **DEVICE_US.get(name, {}),
         **({"phase34_launches": cf_launches[name]} if name in cf_launches else {}),
         **({"phase35_launches": genai_launches[name]} if name in genai_launches else {}),
         **({"phase37_launches": quant_launches[name]} if name in quant_launches else {}),
         **({"phase38_launches": entry_launches[name]} if name in entry_launches else {}),
         **({"phase39_launches": tail_launches[name]} if name in tail_launches else {}),
         **({"phase40_launches": search_launches[name]} if name in search_launches else {}),
         **({"phase42_launches": mesh_launches[name]} if name in mesh_launches else {}),
         **({"phase43_launches": aot_launches[name]} if name in aot_launches else {}),
         **({"forms": forms[name]} if name in forms else {}),
         **({"library": library[name]} if name in library else {})}
        for name, (src, rep, tol, counts) in replaces.items()
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
