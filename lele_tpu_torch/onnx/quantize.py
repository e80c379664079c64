"""Dynamic and static quantization of a float ONNX graph (the port's copy
of lele_tpu/onnx/quantize.py: `quantize_dynamic`, an `onnxruntime.
quantization.quantize_dynamic` analog over MatMul and Gemm with static
weights, Conv on request; and `quantize_static`, below).

It rewrites, at the ModelProto level:

    MatMul(x, W_init)            Gemm(x, W_init, C, transB=…)
        |                            |
        v                            v
    DynamicQuantizeLinear(x) -> (x_q u8, x_scale, x_zp)
    MatMulInteger(x_q, W_q i8, x_zp, w_zp=0) -> i32
    Cast(float) ; Mul(x_scale * w_scale) ; [Add C for Gemm]

with ORT's symmetric int8 weight grid (scale = max|W| / 127, zero point 0,
np.clip(np.round(W / scale), -127, 127)): the form the SAN-M and DQL-GEMM
patterns (compiler/sanm_fuse.py, compiler/patterns.py) fuse. The same input
bytes give the same output bytes as the JAX package's transform.

Only MatMul and Gemm whose weight is a 2-D float32 initializer or Constant
node are rewritten (activation × activation products stay float), with one
DynamicQuantizeLinear per distinct activation. Local functions are inlined
first: their MatMuls live in the function bodies. External-data tensors
(initializers and Constant nodes) are read against `base_dir` and written
inline, so the quantized model stands alone wherever it is saved.

Static quantization (`quantize_static`, ORT's QDQ format): `calibrate_minmax`
runs the float model through the port's compiler over calibration batches
(on the card unless `device` says otherwise) and records each activation's
range; then QuantizeLinear/DequantizeLinear pairs go around every target
op's activations (u8 asymmetric) and weights (symmetric int8 initializers,
per output channel on request, behind a DequantizeLinear). The ops stay
float. The graph is the JAX package's, node for node and name for name, for
the same ranges.
"""

from __future__ import annotations

import numpy as np

from . import builder as ob
from . import schema
from .loader import tensor_to_array


def _inline_tensor(t: dict, base_dir) -> dict:
    if int(t.get("data_location", 0) or 0) != 1:
        return t
    arr = tensor_to_array(schema.Proto(t, "TensorProto"), base_dir)
    t = dict(t)
    t.pop("data_location", None)
    t.pop("external_data", None)
    t["raw_data"] = np.ascontiguousarray(arr).tobytes()
    return t


def _consolidate_external(inits: list[dict], base_dir) -> list[dict]:
    """Initializers with any external data inlined: the quantized model is
    written where the caller wants, so a side-file reference relative to
    the source's directory would dangle. Quantized weights are inline
    already; this catches the untouched rest (embeddings, norms, biases)."""
    return [_inline_tensor(t, base_dir) for t in inits]


def _consolidate_external_nodes(nodes: list[dict], base_dir) -> list[dict]:
    """Constant nodes whose value tensor is external, with it inlined: the
    quantized model is written where the caller wants, away from the
    source's side file, so no reference to it may survive."""
    out = []
    for n in nodes:
        if n.get("op_type") == "Constant" and any(
                int(a.get("t", {}).get("data_location", 0) or 0) == 1
                for a in n.get("attribute", [])):
            n = dict(n)
            n["attribute"] = [{**a, "t": _inline_tensor(a["t"], base_dir)} if "t" in a else a
                              for a in n["attribute"]]
        out.append(n)
    return out


def _weight_array(name: str, inits: dict, const_nodes: dict, base_dir=None):
    """`name` as a static tensor: an initializer or a Constant node's value."""
    t = inits.get(name)
    if t is not None:
        return tensor_to_array(schema.Proto(t, "TensorProto"), base_dir)
    n = const_nodes.get(name)
    if n is not None:
        for a in n.get("attribute", []):
            if a.get("name") == "value" and "t" in a:
                return tensor_to_array(schema.Proto(a["t"], "TensorProto"), base_dir)
    return None


def quantize_weight_int8(w: np.ndarray) -> tuple[np.ndarray, float]:
    """ORT's symmetric int8 grid: scale = max|W| / 127, zero point 0."""
    amax = float(np.max(np.abs(w))) if w.size else 0.0
    scale = amax / 127.0 if amax > 0 else 1.0
    wq = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    return wq, scale


def quantize_dynamic(data: bytes, op_types=("MatMul", "Gemm"), base_dir=None) -> bytes:
    """Float MatMul/Gemm (static weights) → the dynamic-u8 × static-i8 DQL
    form; returns new ModelProto bytes. `op_types` may add "Conv" (→
    ConvInteger, opt-in as in ORT). External-data tensors resolve against
    `base_dir` (the source model's directory) and come out inline."""
    raw = schema.decode_model(data).raw()
    if raw.get("functions"):
        from .functions import inline_functions

        raw = inline_functions(raw)
    # DynamicQuantizeLinear needs opset 11; raising the declared opset would
    # change older attribute-form ops elsewhere in the graph
    for op_imp in raw.get("opset_import", []):
        if not op_imp.get("domain") and int(op_imp.get("version", 0)) < 11:
            raise ValueError(
                "quantize_dynamic needs opset >= 11 (DynamicQuantizeLinear); "
                f"model declares opset {op_imp.get('version')} — re-export "
                "with a newer opset_version")
    g = raw["graph"]
    nodes: list[dict] = list(g.get("node", []))
    inits = {t.get("name", ""): t for t in g.get("initializer", [])}
    const_nodes = {n["output"][0]: n for n in nodes
                   if n.get("op_type") == "Constant" and n.get("output")}

    out_nodes: list[dict] = []
    new_inits: list[dict] = []
    dql_cache: dict[str, tuple[str, str, str]] = {}
    wq_cache: dict[str, tuple[str, str, str]] = {}  # weight → (q, scale, zp)
    consumed_weights: dict[str, int] = {}
    uid = [0]

    def fresh(base: str) -> str:
        uid[0] += 1
        return f"{base}__dq{uid[0]}"

    def dql(src: str) -> tuple[str, str, str]:
        if src not in dql_cache:
            q, s, z = fresh(f"{src}_q"), fresh(f"{src}_scale"), fresh(f"{src}_zp")
            out_nodes.append(ob.node("DynamicQuantizeLinear", [src], [q, s, z]))
            dql_cache[src] = (q, s, z)
        return dql_cache[src]

    def quant_weight(wname: str, w: np.ndarray, transposed: bool) -> tuple[str, str, str]:
        # a weight shared by MatMul and Gemm(transB=1) needs two int8 copies
        key = f"{wname}|T" if transposed else wname
        if key not in wq_cache:
            wq, ws = quantize_weight_int8(w)
            qn, sn, zn = (fresh(f"{wname}_quant"), fresh(f"{wname}_wscale"),
                          fresh(f"{wname}_wzp"))
            new_inits.append(ob.tensor_from_array(wq, qn))
            new_inits.append(ob.tensor_from_array(np.float32(ws).reshape(()), sn))
            new_inits.append(ob.tensor_from_array(np.zeros((), np.int8), zn))
            wq_cache[key] = (qn, sn, zn)
        return wq_cache[key]

    def emit_quant_linear(src: str, wname: str, w: np.ndarray, out: str, bias: str | None,
                          transposed: bool = False) -> None:
        xq, xs, xz = dql(src)
        wqn, wsn, wzn = quant_weight(wname, w, transposed)
        mm = fresh(f"{out}_i32")
        out_nodes.append(ob.node("MatMulInteger", [xq, wqn, xz, wzn], [mm]))
        cf = fresh(f"{out}_f32")
        out_nodes.append(ob.node("Cast", [mm], [cf], to=1))
        sc = fresh(f"{out}_scales")
        out_nodes.append(ob.node("Mul", [xs, wsn], [sc]))
        if bias is None:
            out_nodes.append(ob.node("Mul", [cf, sc], [out]))
        else:
            dq = fresh(f"{out}_dq")
            out_nodes.append(ob.node("Mul", [cf, sc], [dq]))
            out_nodes.append(ob.node("Add", [dq, bias], [out]))

    def attr_i(n: dict, name: str, default: int) -> int:
        for a in n.get("attribute", []):
            if a.get("name") == name:
                return int(a.get("i", default))
        return default

    def attr_f(n: dict, name: str, default: float) -> float:
        for a in n.get("attribute", []):
            if a.get("name") == name:
                return float(a.get("f", default))
        return default

    def emit_quant_conv(n: dict, w: np.ndarray) -> None:
        """Conv(x, W[, B]) → DQL + ConvInteger (attributes kept) + Cast +
        Mul(combined scale) + Add(B as [1, M, 1, ...])."""
        xq, xs, xz = dql(n["input"][0])
        wqn, wsn, wzn = quant_weight(n["input"][1], w, transposed=False)
        out = n["output"][0]
        ci = fresh(f"{out}_i32")
        out_nodes.append({
            "op_type": "ConvInteger",
            "input": [xq, wqn, xz, wzn],
            "output": [ci],
            "name": f"ConvInteger_{ci}",
            "attribute": list(n.get("attribute", [])),
        })
        cf = fresh(f"{out}_f32")
        out_nodes.append(ob.node("Cast", [ci], [cf], to=1))
        sc = fresh(f"{out}_scales")
        out_nodes.append(ob.node("Mul", [xs, wsn], [sc]))
        bias_name = n["input"][2] if len(n["input"]) > 2 and n["input"][2] else None
        if bias_name is None:
            out_nodes.append(ob.node("Mul", [cf, sc], [out]))
            return
        b = _weight_array(bias_name, inits, const_nodes, base_dir)
        if b is None:
            raise ValueError(f"Conv bias {bias_name!r} must be a static tensor")
        brs = fresh(f"{bias_name}_nchw")
        new_inits.append(ob.tensor_from_array(b.reshape((1, -1) + (1,) * (w.ndim - 2)), brs))
        dq = fresh(f"{out}_dq")
        out_nodes.append(ob.node("Mul", [cf, sc], [dq]))
        out_nodes.append(ob.node("Add", [dq, brs], [out]))

    def consume(name: str) -> None:
        consumed_weights[name] = consumed_weights.get(name, 0) + 1

    for n in nodes:
        op = n.get("op_type")
        if op == "Conv" and "Conv" in op_types and len(n["input"]) >= 2:
            w = _weight_array(n["input"][1], inits, const_nodes, base_dir)
            if w is not None and w.ndim >= 3 and w.dtype == np.float32:
                emit_quant_conv(n, w)
                consume(n["input"][1])
                if len(n["input"]) > 2 and n["input"][2]:
                    consume(n["input"][2])
                continue
        if op == "MatMul" and "MatMul" in op_types and len(n["input"]) == 2:
            w = _weight_array(n["input"][1], inits, const_nodes, base_dir)
            if w is not None and w.ndim == 2 and w.dtype == np.float32:
                emit_quant_linear(n["input"][0], n["input"][1], w, n["output"][0], bias=None)
                consume(n["input"][1])
                continue
        if op == "Gemm" and "Gemm" in op_types and len(n["input"]) >= 2:
            w = _weight_array(n["input"][1], inits, const_nodes, base_dir)
            ok = (w is not None and w.ndim == 2 and w.dtype == np.float32
                  and attr_i(n, "transA", 0) == 0 and attr_f(n, "alpha", 1.0) == 1.0
                  and attr_f(n, "beta", 1.0) == 1.0)
            if ok:
                transposed = bool(attr_i(n, "transB", 0))
                if transposed:
                    w = np.ascontiguousarray(w.T)
                bias = n["input"][2] if len(n["input"]) > 2 and n["input"][2] else None
                emit_quant_linear(n["input"][0], n["input"][1], w, n["output"][0],
                                  bias=bias, transposed=transposed)
                consume(n["input"][1])
                continue
        out_nodes.append(n)

    # drop float weights (and their Constant nodes) no surviving node reads:
    # a quantized model carries one copy
    still_used: set[str] = set()
    for n in out_nodes:
        still_used.update(n.get("input", []))

    def gone(name: str) -> bool:
        return name in consumed_weights and name not in still_used

    g["node"] = _consolidate_external_nodes(
        [n for n in out_nodes
         if not (n.get("op_type") == "Constant" and n.get("output") and gone(n["output"][0]))],
        base_dir)
    g["initializer"] = _consolidate_external(
        [t for t in g.get("initializer", []) if not gone(t.get("name", ""))], base_dir) + new_inits
    # exports with keep_initializers_as_inputs also list weights as inputs:
    # a dropped weight must leave that list too
    if g.get("input"):
        g["input"] = [vi for vi in g["input"] if not gone(vi.get("name", ""))]
    return schema.encode_message(raw, "ModelProto")


def quantize_dynamic_file(src_path: str, dst_path: str) -> None:
    import os

    with open(src_path, "rb") as f:
        data = f.read()
    with open(dst_path, "wb") as f:
        f.write(quantize_dynamic(data, base_dir=os.path.dirname(os.path.abspath(src_path))))


# ---------------------------------------------------------------------------
# Static quantization (QDQ format), the onnxruntime `quantize_static`
# analog: the ops stay float; QuantizeLinear/DequantizeLinear pairs
# fake-quant the activations at calibrated ranges and the weights at the
# symmetric int8 grid. The compiler folds the weight-side pairs while
# tracing.


def calibrate_minmax(data: bytes, batches, base_dir=None,
                     device=None) -> dict[str, tuple[float, float]]:
    """Run the float model over calibration batches ({input: array}) and
    record each activation a static quantizer fake-quants (the inputs and
    outputs of Conv, MatMul and Gemm nodes) as [min, max], widened to take
    0 (ORT's MinMax calibrator: zero must be exact in asymmetric u8). The
    model is compiled by the port on `device` (the card unless it says
    otherwise), once for each input-shape signature of the batches, and
    freed before returning."""
    from ..compiler import compile_model
    from .loader import OnnxModel

    raw = schema.decode_model(data).raw()
    if raw.get("functions"):
        from .functions import inline_functions

        raw = inline_functions(raw)
    g = raw["graph"]
    inits = {t.get("name", "") for t in g.get("initializer", [])}
    # Constant-node outputs take the weight path in quantize_static
    static_out = inits | {n["output"][0] for n in g.get("node", [])
                          if n.get("op_type") == "Constant" and n.get("output")}
    names: list[str] = []
    for n in g.get("node", []):
        if n.get("op_type") not in ("Conv", "MatMul", "Gemm"):
            continue
        # every dynamic input is a calibrated edge (ORT's MinMax calibrator
        # records all of a target's inputs): an activation × activation
        # MatMul gets both
        for t in list(n.get("input", [])) + [n["output"][0]]:
            if t and t not in static_out and t not in names:
                names.append(t)
    if not names:
        return {}
    # expose the calibration tensors as extra graph outputs
    existing = [vi.get("name", "") for vi in g.get("output", [])]
    extra = [t for t in names if t not in existing]
    g["output"] = list(g.get("output", [])) + [{"name": t} for t in extra]
    model = OnnxModel.from_bytes(schema.encode_message(raw, "ModelProto"), base_dir=base_dir)
    compiled = {}
    ranges = {t: (0.0, 0.0) for t in names}
    order = existing + extra
    for batch in batches:
        sig = tuple(sorted((k, np.shape(v)) for k, v in batch.items()))
        if sig not in compiled:
            compiled[sig] = compile_model(model, input_shapes=dict(sig), device=device)
        vals = dict(zip(order, compiled[sig].run_np(**batch)))
        for t in names:
            v = np.asarray(vals[t], np.float32)
            lo, hi = ranges[t]
            ranges[t] = (min(lo, float(v.min(initial=0.0))), max(hi, float(v.max(initial=0.0))))
    compiled.clear()
    return ranges


def _u8_qparams(rmin: float, rmax: float) -> tuple[float, int]:
    scale = (rmax - rmin) / 255.0
    if scale <= 0:
        return 1.0, 0
    zp = int(np.clip(round(-rmin / scale), 0, 255))
    return float(scale), zp


def quantize_weight_int8_per_channel(w: np.ndarray, axis: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Per-channel symmetric int8 grid along `axis` (ORT's per_channel=True):
    scale[c] = max|W[c]| / 127, zero point 0."""
    mv = np.moveaxis(w, axis, 0)
    amax = np.abs(mv.reshape(mv.shape[0], -1)).max(axis=1)
    scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    wq = np.clip(np.round(mv / scale.reshape((-1,) + (1,) * (w.ndim - 1))),
                 -127, 127).astype(np.int8)
    return np.moveaxis(wq, 0, axis), scale


def quantize_static(data: bytes, calibration_batches, op_types=("Conv", "MatMul", "Gemm"),
                    per_channel: bool = False, base_dir=None, device=None) -> bytes:
    """QDQ-format static quantization: calibrate the activations' ranges on
    the float model (`calibrate_minmax` on `device`, the card by default),
    then put QuantizeLinear/DequantizeLinear pairs around every target op's
    activations (u8 asymmetric) and weights (symmetric int8 initializers +
    DequantizeLinear). The ops stay float.

    calibration_batches: an iterable of {input_name: np.ndarray} fed to the
    float model. per_channel=True gives Conv weights one scale per output
    channel (DequantizeLinear axis=0, ORT's per_channel); 2-D MatMul/Gemm
    weights stay per tensor either way."""
    for op_imp in schema.decode_model(data).raw().get("opset_import", []):
        if not op_imp.get("domain") and int(op_imp.get("version", 0)) < 10:
            raise ValueError("quantize_static needs opset >= 10 (QuantizeLinear); "
                             f"model declares opset {op_imp.get('version')}")
    batches = list(calibration_batches)
    raw0 = schema.decode_model(data).raw()
    if raw0.get("functions"):
        # the Conv/MatMul nodes live inside the function bodies otherwise
        from .functions import inline_functions

        data = schema.encode_message(inline_functions(raw0), "ModelProto")
    ranges = calibrate_minmax(data, batches, base_dir=base_dir, device=device)
    raw = schema.decode_model(data).raw()
    g = raw["graph"]
    nodes: list[dict] = list(g.get("node", []))
    inits = {t.get("name", ""): t for t in g.get("initializer", [])}
    const_nodes = {n["output"][0]: n for n in nodes
                   if n.get("op_type") == "Constant" and n.get("output")}
    targets = [n for n in nodes if n.get("op_type") in op_types and len(n.get("input", [])) >= 2]
    target_ids = {id(n) for n in targets}

    new_inits: list[dict] = []
    uid = [0]

    def fresh(base):
        uid[0] += 1
        return f"{base}__qs{uid[0]}"

    graph_outputs = {vi.get("name", "") for vi in g.get("output", [])}

    # activation fake-quant: tensor name → its dequantized alias. A tensor
    # that is a graph output has its producer renamed t__pre and the DQ
    # takes the public name (the output signature must not change)
    dq_alias: dict[str, str] = {}
    pre_rename: dict[str, str] = {}
    qdq_nodes: dict[str, list[dict]] = {}  # producer tensor → its Q/DQ pair
    for t, (rmin, rmax) in ranges.items():
        scale, zp = _u8_qparams(rmin, rmax)
        sn, zn = fresh(f"{t}_scale"), fresh(f"{t}_zp")
        new_inits.append(ob.tensor_from_array(np.float32(scale).reshape(()), sn))
        new_inits.append(ob.tensor_from_array(np.asarray(zp, np.uint8).reshape(()), zn))
        qn = fresh(f"{t}_q")
        if t in graph_outputs:
            src = fresh(f"{t}_pre")
            pre_rename[t] = src
            dqn = t
        else:
            src, dqn = t, fresh(f"{t}_dq")
        qdq_nodes[t] = [ob.node("QuantizeLinear", [src, sn, zn], [qn]),
                        ob.node("DequantizeLinear", [qn, sn, zn], [dqn])]
        dq_alias[t] = dqn

    wq_cache: dict[str, str] = {}

    def weight_dq(wname: str, w: np.ndarray) -> str:
        if wname not in wq_cache:
            qn = fresh(f"{wname}_quant")
            sn, zn = fresh(f"{wname}_wscale"), fresh(f"{wname}_wzp")
            dqn = fresh(f"{wname}_dq")
            if per_channel and w.ndim >= 3:  # Conv OIHW: a scale an output channel
                wq, ws = quantize_weight_int8_per_channel(w, axis=0)
                new_inits.append(ob.tensor_from_array(wq, qn))
                new_inits.append(ob.tensor_from_array(ws, sn))
                new_inits.append(ob.tensor_from_array(np.zeros(ws.shape, np.int8), zn))
                dq = ob.node("DequantizeLinear", [qn, sn, zn], [dqn], axis=0)
            else:
                wq, ws = quantize_weight_int8(w)
                new_inits.append(ob.tensor_from_array(wq, qn))
                new_inits.append(ob.tensor_from_array(np.float32(ws).reshape(()), sn))
                new_inits.append(ob.tensor_from_array(np.zeros((), np.int8), zn))
                dq = ob.node("DequantizeLinear", [qn, sn, zn], [dqn])
            qdq_nodes[f"__w_{wname}"] = [dq]
            wq_cache[wname] = dqn
        return wq_cache[wname]

    consumed_weights: dict[str, int] = {}
    out_nodes: list[dict] = []
    # graph-input activations have no producer node: their pairs come first
    graph_inputs = {vi.get("name", "") for vi in g.get("input", [])}
    emitted: set[str] = set()
    for t in ranges:
        if t in graph_inputs:
            out_nodes.extend(qdq_nodes[t])
            emitted.add(t)

    for n in nodes:
        outs_orig = list(n.get("output", []))
        if id(n) in target_ids:
            w = _weight_array(n["input"][1], inits, const_nodes, base_dir)
            # every calibrated edge reads the fake-quant view, a target
            # whose second input is an activation too; a static
            # weight replaces ins[1] below
            ins = [dq_alias.get(x, x) for x in n["input"]]
            if w is not None and w.ndim >= 2 and w.dtype == np.float32:
                ins[1] = weight_dq(n["input"][1], w)
                pair = qdq_nodes.get(f"__w_{n['input'][1]}")
                if pair:
                    out_nodes.extend(pair)
                    qdq_nodes[f"__w_{n['input'][1]}"] = []
                consumed_weights[n["input"][1]] = 1
            n = dict(n)
            n["input"] = ins
        elif any(x in dq_alias for x in n.get("input", [])):
            # other consumers read the fake-quant value too (ORT rewires the
            # whole edge: one numeric view)
            n = dict(n)
            n["input"] = [dq_alias.get(x, x) for x in n["input"]]
        if any(t in pre_rename for t in outs_orig):
            n = dict(n)
            n["output"] = [pre_rename.get(t, t) for t in outs_orig]
        out_nodes.append(n)
        for t in outs_orig:
            if t in qdq_nodes and t not in emitted:
                out_nodes.extend(qdq_nodes[t])
                emitted.add(t)

    still_used: set[str] = set()
    for n in out_nodes:
        still_used.update(n.get("input", []))

    def gone(name: str) -> bool:
        return name in consumed_weights and name not in still_used

    g["node"] = _consolidate_external_nodes(
        [n for n in out_nodes
         if not (n.get("op_type") == "Constant" and n.get("output") and gone(n["output"][0]))],
        base_dir)
    g["initializer"] = _consolidate_external(
        [t for t in g.get("initializer", []) if not gone(t.get("name", ""))], base_dir) + new_inits
    if g.get("input"):
        g["input"] = [vi for vi in g["input"] if not gone(vi.get("name", ""))]
    return schema.encode_message(raw, "ModelProto")
