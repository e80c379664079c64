"""Multi-node pattern rewrites (counterpart of lele_tpu/compiler/patterns.py).

- ``sanm_stack_dataflow`` (compiler/sanm_fuse.py): whole runs of SAN-M
  layers → the `sanm_stack_dql` kernel. It runs first, so it can claim
  entire layers.
- ``dql_matmul_dataflow``: DynamicQuantizeLinear → MatMulInteger (+ the
  Cast/Mul dequant epilogue), regrouped by consumer-graph search rather than
  node adjacency (real int8 exports interleave chain nodes). Weights shift to
  i8 with zero-point column sums once, at trace time, and the dot runs in
  the `fused_dq_matmul` kernel.

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


from .sanm_fuse import sanm_stack_dataflow  # noqa: E402  (uses the helpers above)

DEFAULT_PATTERNS: list = [sanm_stack_dataflow, dql_matmul_dataflow]
