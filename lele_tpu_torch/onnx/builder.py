"""Construct ONNX models programmatically (an `onnx.helper` analog): the
port's copy of the parts of lele_tpu/onnx/builder.py that `synth`,
`quantize` and the tests use (local functions included). Model bytes come out of the port's own wire codec, and the same
graph gives the same bytes as the JAX package's builder.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np

from . import schema
from .loader import NP_TO_ONNX

# the producer name both builders write, so that their bytes agree
PRODUCER = "lele_tpu.builder"


def attribute(name: str, value: Any) -> dict:
    a: dict[str, Any] = {"name": name}
    if isinstance(value, bool):
        a["i"], a["type"] = int(value), schema.ATTR_INT
    elif isinstance(value, int):
        a["i"], a["type"] = value, schema.ATTR_INT
    elif isinstance(value, float):
        a["f"], a["type"] = value, schema.ATTR_FLOAT
    elif isinstance(value, str):
        a["s"], a["type"] = value.encode(), schema.ATTR_STRING
    elif isinstance(value, bytes):
        a["s"], a["type"] = value, schema.ATTR_STRING
    elif isinstance(value, np.ndarray):
        a["t"], a["type"] = tensor_from_array(value, name), schema.ATTR_TENSOR
    elif isinstance(value, dict) and "data_type" in value:  # a TensorProto dict
        a["t"], a["type"] = value, schema.ATTR_TENSOR
    elif isinstance(value, dict):  # a graph dict built by graph() (If branches)
        a["g"], a["type"] = value, schema.ATTR_GRAPH
    elif isinstance(value, (list, tuple)):
        if len(value) and isinstance(value[0], float):
            a["floats"], a["type"] = list(value), schema.ATTR_FLOATS
        elif len(value) and isinstance(value[0], (str, bytes)):
            a["strings"] = [v.encode() if isinstance(v, str) else v for v in value]
            a["type"] = schema.ATTR_STRINGS
        else:
            a["ints"], a["type"] = [int(v) for v in value], schema.ATTR_INTS
    else:
        raise TypeError(f"unsupported attribute value for {name!r}: {type(value)}")
    return a


def node(op_type: str, inputs: Sequence[str], outputs: Sequence[str],
         name: str = "", domain: str = "", **attrs: Any) -> dict:
    n = {
        "op_type": op_type,
        "input": list(inputs),
        "output": list(outputs),
        "name": name or f"{op_type}_{outputs[0] if outputs else ''}",
        "attribute": [attribute(k, v) for k, v in attrs.items()],
    }
    if domain:
        n["domain"] = domain
    return n


def tensor_from_array(arr: np.ndarray, name: str = "") -> dict:
    arr = np.asarray(arr)
    if arr.dtype not in NP_TO_ONNX:
        raise TypeError(f"no ONNX dtype for numpy {arr.dtype}")
    return {
        "name": name,
        "dims": list(arr.shape),
        "data_type": NP_TO_ONNX[arr.dtype],
        "raw_data": np.ascontiguousarray(arr).tobytes(),
    }


def value_info(name: str, onnx_dtype: int, shape: Sequence[int | str]) -> dict:
    dims = []
    for d in shape:
        dims.append({"dim_param": d} if isinstance(d, str) else {"dim_value": int(d)})
    return {
        "name": name,
        "type": {"tensor_type": {"elem_type": onnx_dtype, "shape": {"dim": dims}}},
    }


def graph(nodes: Sequence[dict], name: str = "g", inputs: Sequence[dict] = (),
          outputs: Sequence[dict] = (), initializers: Sequence[dict] = ()) -> dict:
    return {
        "node": list(nodes),
        "name": name,
        "input": list(inputs),
        "output": list(outputs),
        "initializer": list(initializers),
    }


def model(g: dict, opset: int = 17, ir_version: int = 8,
          functions: Sequence[dict] = ()) -> dict:
    m = {
        "ir_version": ir_version,
        "producer_name": PRODUCER,
        "graph": g,
        "opset_import": [{"domain": "", "version": opset}],
    }
    if functions:
        m["functions"] = list(functions)
        extra = {f.get("domain", "") for f in functions} - {""}
        m["opset_import"] += [{"domain": d, "version": 1} for d in sorted(extra)]
    return m


def function(name: str, inputs: Sequence[str], outputs: Sequence[str],
             nodes: Sequence[dict], domain: str = "local", attributes: Sequence[str] = (),
             attribute_defaults: dict | None = None, opset: int = 17) -> dict:
    """A FunctionProto dict (a model-local function, ONNX IR >= 8)."""
    f = {
        "name": name,
        "domain": domain,
        "input": list(inputs),
        "output": list(outputs),
        "node": list(nodes),
        "opset_import": [{"domain": "", "version": opset}],
    }
    if attributes:
        f["attribute"] = list(attributes)
    if attribute_defaults:
        f["attribute_proto"] = [attribute(k, v) for k, v in attribute_defaults.items()]
    return f


def ref_attr(name: str, ref: str, attr_type: int) -> dict:
    """An attribute that forwards the caller's attribute `ref` (on a node
    inside a function body)."""
    return {"name": name, "ref_attr_name": ref, "type": attr_type}


def serialize(m: dict) -> bytes:
    return schema.encode_message(m, "ModelProto")


def build_model_bytes(nodes: Sequence[dict], inputs: Sequence[dict],
                      outputs: Sequence[dict], initializers: Sequence[dict] = (),
                      opset: int = 17, name: str = "g") -> bytes:
    return serialize(model(graph(nodes, name, inputs, outputs, initializers), opset))
