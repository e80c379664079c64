"""Multi-node pattern rewrites (counterpart of lele_tpu/compiler/patterns.py).

- ``sanm_stack_dataflow`` (compiler/sanm_fuse.py): whole runs of SAN-M
  layers → the `sanm_stack_dql` kernel. It runs first, so it can claim
  entire layers.
- ``dql_matmul_dataflow``: DynamicQuantizeLinear → MatMulInteger (+ the
  Cast/Mul dequant epilogue), regrouped by consumer-graph search rather than
  node adjacency (real int8 exports interleave chain nodes). Weights shift to
  i8 with zero-point column sums once, at trace time, and the dot runs in
  the `fused_dq_matmul` kernel.
- ``matmul_nbits_w4``: com.microsoft::MatMulNBits at bits=4 → the `w4_matmul`
  kernel, its ORT blob repacked once at trace time into the kernel's
  low/high K-plane layout.
- ``qmoe_w4``: com.microsoft::QMoE's decode path at bits=4 → the `w4_matmul`
  kernel's expert-indexed entry, the expert stacks repacked once at trace
  time.
- ``matmul_nbits_w4_f32`` and ``qmoe_w4_f32``: the same routes with f32
  activations (the kernel's exact w4a32 form), JAX's `LELE_NBITS_F32=1`;
  selected with ``patterns=[...]``.

A pattern is ``fn(tracer, state, nodes, i, env, scope) -> None | (consumed,
{output_name: value})``. None means "no match"; the tracer then falls
through to override/builtin dispatch. ``consumed`` is an int (advance that
many nodes) or a collection of absolute node indices to skip. Every bound
value equals what the per-op trace would produce: patterns are
optimizations, never semantic changes. A pattern runs its device work
through ``state.run`` so that the trace records it. ``Compiler.with_pattern``
prepends user patterns; ``patterns=[]`` gives the per-op path.
"""

from __future__ import annotations

import numpy as np
import torch


def _node_attr(node, name, default=None):
    from ..ops.registry import parse_attr

    for a in node.attribute:
        if a.name == name:
            return parse_attr(a)
    return default


def _is_static(v) -> bool:
    return v is None or isinstance(v, (np.ndarray, np.generic))


def _dataflow_index(tracer, nodes):
    """(consumers, producers, captured) for a node list: name → consumer
    indices / producing index, and the names subgraph bodies read. Built once
    per node list and cached on the tracer (keyed by the list's identity)."""
    cache = getattr(tracer, "_dataflow_index_cache", None)
    if cache is None:
        cache = tracer._dataflow_index_cache = []
    for entry in cache:
        if entry[0] is nodes:
            return entry[1], entry[2], entry[3]
    cons: dict[str, list[int]] = {}
    prod: dict[str, int] = {}
    captured: set[str] = set()
    for j, n in enumerate(nodes):
        for name in n.input:
            if name:
                lst = cons.setdefault(name, [])
                if not lst or lst[-1] != j:  # one entry per node
                    lst.append(j)
        for name in n.output:
            if name:
                prod[name] = j
        # If/Loop/Scan bodies read outer values without listing them as
        # inputs: anything a body reads escapes, so no pattern claims it
        for a in n.attribute:
            if a.type == 5:  # a GraphProto attribute
                _collect_subgraph_refs(a.g, captured)
            elif a.type == 10:  # repeated GraphProto
                for g in a.graphs:
                    _collect_subgraph_refs(g, captured)
    cache.insert(0, (nodes, cons, prod, captured))
    del cache[4:]
    return cons, prod, captured


def _collect_subgraph_refs(g, out: set) -> None:
    """Names a subgraph reads that it does not itself produce (recursive)."""
    local = {vi.name for vi in g.input} | {t.name for t in g.initializer}
    for n in g.node:
        for name in n.input:
            if name and name not in local:
                out.add(name)
        for name in n.output:
            if name:
                local.add(name)
        for a in n.attribute:
            if a.type == 5:
                _collect_subgraph_refs(a.g, out)
            elif a.type == 10:
                for gg in a.graphs:
                    _collect_subgraph_refs(gg, out)


# -- the recorded device steps of dql_matmul_dataflow -------------------------


def _fused_linear(a, w, colsum, a_scale, a_zp, w_scale: float):
    from ..kernels.quant_matmul import fused_dq_matmul

    out = fused_dq_matmul(a.reshape(-1, a.shape[-1]).to(torch.float32), w, colsum,
                          a_scale, a_zp, w_scale)
    return out.reshape(*a.shape[:-1], w.shape[-1])


def _combined_scale(a_scale, w_scale: float):
    return a_scale * w_scale  # an f32 product: torch casts the scalar to f32


def _int32_dot(q_f, w, colsum, a_zp_f, azp_present: bool, bzp_i):
    """Exact MatMulInteger of the quantized activation with prepared weights
    (col-sums from trace time), as an exact float64 product (see
    ops/quant_ops.py). An omitted azp is ONNX's default 0 in the u8 domain,
    -128 in the shifted i8 domain, not the DQL zero point."""
    ai = q_f.to(torch.float64) - 128.0
    azp_i = (a_zp_f.to(torch.float64) - 128.0) if azp_present else -128.0
    c = torch.matmul(ai, w.to(torch.float64)) - azp_i * colsum.to(torch.float64)
    if bzp_i is not None:
        k = q_f.shape[-1]
        rowsum = ai.sum(dim=-1, keepdim=True)
        bzp_t = bzp_i.to(torch.float64)
        bzp_t = bzp_t.reshape(1, -1) if bzp_t.dim() else bzp_t
        c = c - bzp_t * rowsum + k * azp_i * bzp_t
    return c.to(torch.int32)


def _to_u8(v):
    return v.to(torch.uint8)


def dql_matmul_dataflow(tracer, state, nodes, i, env, scope):
    """Fuse DynamicQuantizeLinear-rooted int8 matmul chains via dataflow.

    At a DQL node, every MatMulInteger consuming its quantized output —
    anywhere later, interleaved or not — is fused: the activation's scale
    and zero point are computed once, weights and zero points pre-pack at
    trace time, and where the standard Cast → Mul(scale) dequant epilogue is
    found it folds into the fused f32 GEMM (`fused_dq_matmul`). Consumers
    the epilogue search cannot claim get the exact int32 product with
    hoisted col-sums. The DQL outputs (q/scale/zp) are always bound, so
    other consumers keep exact ONNX semantics; the trace drops the ones
    nothing reads."""
    node = nodes[i]
    if node.op_type != "DynamicQuantizeLinear":
        return None
    a = env[node.input[0]]
    if _is_static(a):
        return None  # fully static: normal folding handles it
    q_name, scale_name, zp_name = (list(node.output) + ["", ""])[:3]

    cons_map, prod_map, captured = _dataflow_index(tracer, nodes)
    escapes = state.graph_outputs | captured

    # every MatMulInteger fed by our quantized activation, with static
    # weight/zero-points and our zp (or ONNX's default 0) as the activation
    # zero point
    matches = []
    for j in cons_map.get(q_name, []):
        if j <= i:
            continue
        mmi = nodes[j]
        if mmi.op_type != "MatMulInteger" or mmi.input[0] != q_name:
            continue
        b = env.get(mmi.input[1])
        azp_n = mmi.input[2] if len(mmi.input) > 2 else ""
        bzp_n = mmi.input[3] if len(mmi.input) > 3 else ""
        bzp = env.get(bzp_n) if bzp_n else None
        if b is None or not _is_static(b) or np.ndim(b) != 2:
            continue
        if azp_n and azp_n != zp_name:
            continue
        if bzp_n and not _is_static(bzp):
            continue
        matches.append((j, mmi, b, bzp, bool(azp_n)))
    if not matches:
        return None

    from ..kernels.quant_matmul import dql_quantize, dql_scale_zp

    a_scale, a_zp_f = state.run(dql_scale_zp, a)
    q_f = state.run(dql_quantize, a, a_scale, a_zp_f)
    results = {q_name: state.run(_to_u8, q_f)}
    if scale_name:
        results[scale_name] = a_scale
    if zp_name:
        results[zp_name] = state.run(_to_u8, a_zp_f)
    consumed = {i}

    for j, mmi, b, bzp, azp_present in matches:
        mm_out = mmi.output[0]
        # prepared weights at trace time: i8 shift + zero-point col-sums
        b_np = np.asarray(b)
        if b_np.dtype == np.uint8:
            bi_np = (b_np.astype(np.int32) - 128).astype(np.int8)
            bzp_i = (np.asarray(bzp).astype(np.int32) - 128) if bzp is not None \
                else np.int32(-128)
        else:
            bi_np = b_np.astype(np.int8)
            bzp_i = np.asarray(bzp).astype(np.int32) if bzp is not None \
                else np.int32(0)
        colsum_np = bi_np.astype(np.int32).sum(axis=-2, dtype=np.int32)
        bi_dev = state.to_device(scope + mmi.input[1] + "::i8", bi_np)
        colsum_dev = state.to_device(scope + mmi.input[1] + "::colsum", colsum_np)
        clean_bzp = bool(np.all(bzp_i == 0))

        # the fused-dequant epilogue assumes the zero-point-CORRECTED dot; an
        # MMI with azp omitted computes the uncorrected q·w (ONNX default
        # azp=0), so it takes the int32 path below instead
        epi = _match_dequant_epilogue(
            nodes, j, mm_out, env, scale_name, escapes, cons_map, prod_map,
        ) if (clean_bzp and azp_present) else None

        if epi is not None:
            jc, jm, jp, mul_out, combined_out, b_scale = epi
            results[mul_out] = state.run(_fused_linear, a, bi_dev, colsum_dev,
                                         a_scale, a_zp_f, b_scale)
            consumed.update({j, jc, jm})
            if jp is not None:
                # the scalar a_scale × b_scale node: bound (others may read it)
                results[combined_out] = state.run(_combined_scale, a_scale, b_scale)
                consumed.add(jp)
            state.pattern_hits["dql_fused_epilogue"] = (
                state.pattern_hits.get("dql_fused_epilogue", 0) + 1)
        else:
            bzp_dev = None if clean_bzp else state.to_device(
                scope + mmi.input[1] + "::bzp", np.asarray(bzp_i, np.int32))
            results[mm_out] = state.run(_int32_dot, q_f, bi_dev, colsum_dev,
                                        a_zp_f, azp_present, bzp_dev)
            consumed.add(j)
            state.pattern_hits["dql_fused_int32"] = (
                state.pattern_hits.get("dql_fused_int32", 0) + 1)

    return consumed, results


def _match_dequant_epilogue(nodes, j, mm_out, env, scale_name, graph_outputs,
                            cons_map, prod_map):
    """Find the standard dequant epilogue of a MatMulInteger by dataflow:
    Cast(int32→f32) → Mul(·, Mul(a_scale, b_scale)). Returns (cast_idx,
    mul_idx, combined_idx, mul_out, combined_out, b_scale) or None. Claims
    only nodes whose intermediates have no consumers outside the chain and
    are not graph outputs."""
    if mm_out in graph_outputs:
        return None
    cons = [x for x in cons_map.get(mm_out, []) if x > j]
    if len(cons) != 1 or nodes[cons[0]].op_type != "Cast":
        return None
    jc = cons[0]
    cast = nodes[jc]
    if cast.input[0] != mm_out or _node_attr(cast, "to", 1) != 1:
        return None
    cast_out = cast.output[0]
    if cast_out in graph_outputs:
        return None
    cons = [x for x in cons_map.get(cast_out, []) if x > j]
    if len(cons) != 1 or nodes[cons[0]].op_type != "Mul":
        return None
    jm = cons[0]
    mul = nodes[jm]
    other = mul.input[1] if mul.input[0] == cast_out else mul.input[0]

    # the scale operand must be Mul(a_scale, static b_scale): a static
    # scalar alone cannot be the complete dequant scale (the DQL scale is
    # dynamic), so such graphs take the int32 path
    jp = prod_map.get(other)
    if jp is None or nodes[jp].op_type != "Mul":
        return None
    smul = nodes[jp]
    if scale_name not in smul.input:
        return None
    const_n = smul.input[1] if smul.input[0] == scale_name else smul.input[0]
    cv = env.get(const_n)
    if cv is None or not _is_static(cv) or np.asarray(cv).size != 1:
        return None
    return jc, jm, jp, mul.output[0], smul.output[0], float(np.asarray(cv))


def _w4_product(plain: bool):
    from ..kernels.w4_matmul import w4_matmul, w4_matmul_plain

    return w4_matmul_plain if plain else w4_matmul


def _nbits_w4_linear(a, packed, scales, zc, bias, K: int, N: int, block: int,
                     f32: bool = False, plain: bool = False):
    """The recorded step of matmul_nbits_w4: bf16 (or, for the f32 route,
    f32) activations through the w4 GEMM on the recentred planes, plus the
    zero-point residual Σ_g blocksum_g(a)·(8 − zp)·s as an f32 [M, K/block]
    × [K/block, N] product (zc None where every zero point is 8). plain:
    the GEMM's plain version on any device (`PLAIN_NBITS_PATTERNS`)."""
    x2 = a.reshape(-1, K)
    out = _w4_product(plain)(x2.to(torch.float32 if f32 else torch.bfloat16), packed, scales,
                             block)
    if zc is not None:
        xs = x2.to(torch.float32).reshape(x2.shape[0], K // block, block).sum(-1)
        out = out + xs @ zc
    out = out.reshape(*a.shape[:-1], N).to(a.dtype)
    if bias is not None:
        out = out + bias
    return out


def matmul_nbits_w4(tracer, state, nodes, i, env, scope, f32: bool = False,
                    plain: bool = False):
    """Route com.microsoft::MatMulNBits (bits=4, no g_idx) through the w4a16
    GEMM kernel (kernels/w4_matmul.py), as lele_tpu/compiler/patterns.py:277
    routes it through `w4_matmul_pallas`.

    ORT's blob [N, k_blocks, block/2] (K-adjacent nibble pairs, q in
    [0, 15]) is repacked on the host, once, into the kernel's [K/2, N]
    low/high K-plane layout, recentred to q − 8 so it fits the signed int4
    planes: (q − zp)·s = (q − 8)·s + (8 − zp)·s, and the second term is the
    zero-point residual, an [M, K/block] × [K/block, N] product over block
    sums of the activation (none for the default zp = 8). Activations go to
    the kernel as bf16, JAX's default route; `matmul_nbits_w4_f32` (in
    `patterns=[...]`) is JAX's `LELE_NBITS_F32=1` route, f32 activations in
    the kernel's exact form. Counted under "matmul_nbits_w4" either way.

    Eligibility is JAX's: bits 4, no g_idx, static weights, scales and zero
    points, a float activation, an even block of at most 512, K a multiple
    of 2·block; anything else keeps the emitter (ops/contrib_ops.py). Under
    a mesh whose rules split `_q` / `_s` on N, the kernel runs on the rank's
    columns and the output is gathered (parallel/placement.py). The
    kernel takes every such block in the form JAX's routing would (see
    kernels/w4_matmul.py). Each hit is counted twice in `pattern_hits`, by
    the pattern and by the tracer's walk, as the JAX package counts it."""
    node = nodes[i]
    if node.op_type != "MatMulNBits":
        return None
    from ..ops.registry import canon_domain

    if canon_domain(node.domain) != "com.microsoft":
        return None
    if int(_node_attr(node, "bits", 4)) != 4:
        return None
    K = int(_node_attr(node, "K"))
    N = int(_node_attr(node, "N"))
    block = int(_node_attr(node, "block_size"))
    if block < 2 or block % 2 or block > 512 or K % (2 * block):
        return None
    ins = list(node.input) + [""] * (6 - len(node.input))
    a = env.get(ins[0])
    b = env.get(ins[1])
    sc = env.get(ins[2])
    zp = env.get(ins[3]) if ins[3] else None
    gidx = env.get(ins[4]) if ins[4] else None
    bias = env.get(ins[5]) if ins[5] else None
    if gidx is not None:
        return None
    if a is None or _is_static(a) or not a.is_floating_point():
        return None
    if not (_is_static(b) and _is_static(sc)):
        return None
    if zp is not None and not _is_static(zp):
        return None
    KB = K // block
    b_np = np.asarray(b)
    if b_np.size != N * K // 2 or b_np.dtype != np.uint8:
        return None
    # under a mesh whose rules split the node's `_q` on N: the rank's
    # columns (parallel/placement.py), gathered after the product
    cut = None
    if state.placement is not None:
        cut = state.placement.nbits_cut([scope + n if n else "" for n in ins],
                                        [a, b, sc, zp, gidx, bias], N)
        if cut is False:
            return None
    if cut:
        ax, N, (_, b_np, sc, zp, _, bias) = cut
    # host repack: ORT's K-adjacent nibble pairs → the kernel's K/2 planes
    bq = b_np.reshape(N, KB, block // 2)
    q = np.stack([bq & 0x0F, bq >> 4], axis=-1).reshape(N, K)
    q = (q.astype(np.int8) - 8).T  # recentred signed int4, [K, N]
    half = K // 2
    packed = ((q[:half] & 0x0F) | (q[half:] << 4)).astype(np.int8)
    sc_np = np.asarray(sc).astype(np.float32).reshape(N, KB)

    from ..ops.contrib_ops import _nbits_zp

    c_np = (np.float32(8.0) - _nbits_zp(zp, 4, N, KB)) * sc_np
    packed_dev = state.to_device(scope + ins[1] + "::w4pk", packed)
    s_dev = state.to_device(scope + ins[1] + "::w4s", np.ascontiguousarray(sc_np.T))
    zc_dev = None
    if np.ndim(c_np) and np.any(c_np):
        zc_dev = state.to_device(scope + ins[1] + "::w4zc",
                                 np.ascontiguousarray(c_np.T.astype(np.float32)))
    if bias is not None and _is_static(bias):
        bias = state.to_device(scope + ins[5] + "::w4b", np.asarray(bias))
    out = state.run(_nbits_w4_linear, a, packed_dev, s_dev, zc_dev, bias, K, N, block, f32,
                    plain)
    if cut:
        from ..parallel.placement import collect

        out = collect(state, "gather", ax, out)
    state.pattern_hits["matmul_nbits_w4"] = state.pattern_hits.get("matmul_nbits_w4", 0) + 1
    return 1, {node.output[0]: out}


def matmul_nbits_w4_f32(tracer, state, nodes, i, env, scope):
    """`matmul_nbits_w4` with f32 activations: the kernel's exact w4a32 form
    (JAX's `LELE_NBITS_F32=1`), for graphs that carry f32 semantics."""
    return matmul_nbits_w4(tracer, state, nodes, i, env, scope, f32=True)


def _qmoe_repack(wq: np.ndarray) -> np.ndarray:
    """A QMoE expert stack [E, K, N/2] u8 (nibbles adjacent along the output
    axis, low first, zero point 8) → the w4 kernel's [E, K/2, N] int8
    low/high K-plane layout, recentred to signed int4
    (lele_tpu/compiler/patterns.py:412-424)."""
    E, K, half_n = wq.shape
    q = np.empty((E, K, 2 * half_n), np.int8)
    q[..., 0::2] = (wq & 0x0F).astype(np.int8) - 8
    q[..., 1::2] = (wq >> 4).astype(np.int8) - 8
    half = K // 2
    return ((q[:, :half] & 0x0F) | (q[:, half:].astype(np.uint8) << 4)).astype(np.int8)


def _qmoe_group(K: int) -> int:
    """The largest of 128, 64, ..., 1 that divides K/2 (JAX's choice,
    lele_tpu/compiler/patterns.py:427-434). QMoE scales are per output
    column, constant along K, so any group gives the same sums; kernel 7
    takes each in the form JAX's routing would."""
    half = K // 2
    for g in (128, 64, 32, 16, 8, 4, 2, 1):
        if half % g == 0:
            return g
    return 1


def _qmoe_w4_step(x, logits, fc1, fc2, fc3, k: int, sparse: bool, normalize: bool, act: str,
                  f32: bool, plain: bool = False):
    """The recorded step of qmoe_w4: route on the device, then one launch of
    the w4 GEMM's expert-indexed entry per linear for all rows·k slots (the
    expert indices never leave the card); fcN = (packed [E, K/2, N], scales
    [E, K/g, N], g). The activation and the fc3 product in f32, cast to the
    activation type before fc2; the routing weights sum in f32, slot by
    slot, as lele_tpu/compiler/patterns.py:551-563."""
    from ..ops.moe_ops import apply_activation, route_topk

    w4_matmul = _w4_product(plain)

    hidden = x.shape[-1]
    rows = x.numel() // hidden
    weights, experts = route_topk(logits.reshape(rows, -1).float(), k, sparse, normalize)
    x2 = x.reshape(rows, hidden)
    xk = x2.float() if f32 else x2.to(torch.bfloat16)
    xr = torch.repeat_interleave(xk, k, dim=0)  # [rows·k, hidden], slot-major per row
    idx = experts.reshape(-1).to(torch.int32)

    def mm(h, fc):
        return w4_matmul(h, fc[0], fc[1], fc[2], idx)

    h = apply_activation(act, mm(xr, fc1))
    if fc3 is not None:
        h = h * mm(xr, fc3)
    y = mm(h.to(xk.dtype), fc2).reshape(rows, k, hidden)
    acc = torch.zeros((rows, hidden), dtype=torch.float32, device=x.device)
    for s_ in range(k):
        acc = acc + weights[:, s_:s_ + 1].float() * y[:, s_]
    return acc.reshape(x.shape).to(x.dtype)


def qmoe_w4(tracer, state, nodes, i, env, scope, f32: bool = False, plain: bool = False):
    """Route com.microsoft::QMoE's decode path (rows·k ≤ experts) through the
    w4a16 GEMM kernel, as lele_tpu/compiler/patterns.py:437-566 routes it
    through `w4_matmul_pallas`.

    The expert stacks are repacked once, on the host, at trace time, into
    the kernel's plane layout ([E, K/2, N] int8, 0.5 byte a weight on the
    card) with the per-column scales broadcast to [E, K/g, N],
    g = `_qmoe_group(K)`. At run time the routing runs on the card and each
    linear (fc1, fc3, fc2) is one launch of the kernel's expert-indexed
    entry over all rows·k slots: no host sync, no expert copied. QMoE is
    symmetric (zero point 8), so the recentring leaves no residual.
    Activations go in as bf16; `qmoe_w4_f32` (in `patterns=[...]`) keeps
    them f32, JAX's `LELE_NBITS_F32=1`.

    Eligibility is JAX's: bits 4, no expert biases, static weight and scale
    stacks, a dynamic float input, rows·k ≤ E (prefill keeps the emitter's
    expert loop). Each hit counts twice in `pattern_hits`, by the pattern
    and by the tracer's walk, as the JAX package counts it."""
    node = nodes[i]
    if node.op_type != "QMoE":
        return None
    from ..ops.registry import canon_domain

    if canon_domain(node.domain) != "com.microsoft":
        return None
    if int(_node_attr(node, "expert_weight_bits", 4)) != 4:
        return None
    k = int(_node_attr(node, "k", 1))
    ins = list(node.input) + [""] * (11 - len(node.input))
    x = env.get(ins[0])
    logits = env.get(ins[1])
    if x is None or logits is None or _is_static(x):
        return None
    if ins[4] or ins[7] or ins[10]:
        return None  # expert biases: the emitter
    stacks = []
    for wi, si in ((2, 3), (5, 6), (8, 9)):
        if not ins[wi]:
            stacks.append(None)
            continue
        w = env.get(ins[wi])
        sc = env.get(ins[si]) if ins[si] else None
        if w is None or sc is None or not (_is_static(w) and _is_static(sc)):
            return None
        stacks.append((np.asarray(w), np.asarray(sc)))
    if stacks[0] is None or stacks[1] is None or not x.is_floating_point():
        return None
    if state.placement is not None and any(
            state.placement.param_spec(scope + n, env.get(n)) for n in ins[2:] if n):
        return None  # expert-sharded stacks: the emitter on the rank's experts
    E = stacks[0][0].shape[0]
    rows = x.numel() // x.shape[-1]
    if rows * k > E or any(st is not None and (st[0].dtype != np.uint8 or st[0].ndim != 3)
                           for st in stacks):
        return None

    devs = []
    for (wi, st) in zip((2, 5, 8), stacks):
        if st is None:
            devs.append(None)
            continue
        w, sc = st
        K = w.shape[1]
        g = _qmoe_group(K)
        sc_full = np.broadcast_to(sc.astype(np.float32)[:, None, :], (E, K // g, sc.shape[-1]))
        devs.append((state.to_device(scope + ins[wi] + "::qw4", _qmoe_repack(w)),
                     state.to_device(scope + ins[wi] + "::qw4s", sc_full), g))
    out = state.run(_qmoe_w4_step, x, logits, devs[0], devs[1], devs[2], k,
                    bool(int(_node_attr(node, "use_sparse_mixer", 0))),
                    bool(int(_node_attr(node, "normalize_routing_weights", 0))),
                    _node_attr(node, "activation_type", "relu"), f32, plain)
    state.pattern_hits["qmoe_w4"] = state.pattern_hits.get("qmoe_w4", 0) + 1
    return 1, {node.output[0]: out}


def qmoe_w4_f32(tracer, state, nodes, i, env, scope):
    """`qmoe_w4` with f32 activations: the kernel's exact w4a32 form (JAX's
    `LELE_NBITS_F32=1`). Counted under "qmoe_w4"."""
    return qmoe_w4(tracer, state, nodes, i, env, scope, f32=True)


def matmul_nbits_w4_plain(tracer, state, nodes, i, env, scope):
    """`matmul_nbits_w4` with the GEMM's plain version in place of kernel 7,
    the same bf16 activations: the card's oracle of the fused route."""
    return matmul_nbits_w4(tracer, state, nodes, i, env, scope, plain=True)


def qmoe_w4_plain(tracer, state, nodes, i, env, scope):
    """`qmoe_w4` with the GEMM's plain version (see matmul_nbits_w4_plain)."""
    return qmoe_w4(tracer, state, nodes, i, env, scope, plain=True)


# the tracer's walk counts a hit under the pattern's __name__: the f32 and
# plain variants count under their base pattern's name, as JAX counts its
# LELE_NBITS_F32 route, so `pattern_hits` agree
matmul_nbits_w4_f32.__name__ = matmul_nbits_w4_plain.__name__ = "matmul_nbits_w4"
qmoe_w4_f32.__name__ = qmoe_w4_plain.__name__ = "qmoe_w4"

from .sanm_fuse import sanm_stack_dataflow  # noqa: E402  (uses the helpers above)

DEFAULT_PATTERNS: list = [sanm_stack_dataflow, dql_matmul_dataflow, matmul_nbits_w4, qmoe_w4]
# JAX's `LELE_NBITS_F32=1`: patterns=F32_NBITS_PATTERNS
F32_NBITS_PATTERNS: list = [sanm_stack_dataflow, dql_matmul_dataflow, matmul_nbits_w4_f32,
                            qmoe_w4_f32]
# the default route with kernel 7's calls on its plain version (a card's oracle)
PLAIN_NBITS_PATTERNS: list = [sanm_stack_dataflow, dql_matmul_dataflow, matmul_nbits_w4_plain,
                              qmoe_w4_plain]
