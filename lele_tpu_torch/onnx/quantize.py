"""Dynamic quantization of a float ONNX graph (the port's copy of
`quantize_dynamic` in lele_tpu/onnx/quantize.py: an `onnxruntime.
quantization.quantize_dynamic` analog over MatMul and Gemm with static
weights, Conv on request).

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
inline, so the quantized model stands alone wherever it is saved. The
static (QDQ) quantizer and its calibration are not ported yet.
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
    g["initializer"] = [_inline_tensor(t, base_dir) for t in g.get("initializer", [])
                        if not gone(t.get("name", ""))] + new_inits
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
