"""Construct ONNX models programmatically (an `onnx.helper` analog): the
port's copy of the parts of lele_tpu/onnx/builder.py that `synth`,
`quantize` and the tests use (local functions, 4-bit and string tensors,
external data and `save_with_external_data` included). Model bytes come
out of the port's own wire codec, and the same graph gives the same bytes
(and the same side file) as the JAX package's builder.
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
    if arr.dtype.kind in ("U", "S", "O"):  # STRING tensor (data_type 8)
        vals = [v.encode("utf-8") if isinstance(v, str) else bytes(v)
                for v in arr.reshape(-1)]
        return {"name": name, "dims": list(arr.shape), "data_type": 8,
                "string_data": vals}
    if arr.dtype not in NP_TO_ONNX:
        raise TypeError(f"no ONNX dtype for numpy {arr.dtype}")
    return {
        "name": name,
        "dims": list(arr.shape),
        "data_type": NP_TO_ONNX[arr.dtype],
        "raw_data": np.ascontiguousarray(arr).tobytes(),
    }


def tensor_int4(values, name: str = "", signed: bool = True) -> dict:
    """A 4-bit TensorProto (data_type 22 int4 / 21 uint4): two elements a
    byte, low nibble first, zero-padded to a whole byte."""
    v = np.asarray(values).reshape(-1)
    lo, hi = (-8, 7) if signed else (0, 15)
    if v.size and (v.min() < lo or v.max() > hi):
        raise ValueError(f"values outside {'int4' if signed else 'uint4'}")
    u = (v.astype(np.int64) & 0x0F).astype(np.uint8)
    if u.size % 2:
        u = np.concatenate([u, np.zeros(1, np.uint8)])
    packed = (u[0::2] | (u[1::2] << 4)).astype(np.uint8)
    return {"name": name, "dims": list(np.asarray(values).shape),
            "data_type": 22 if signed else 21, "raw_data": packed.tobytes()}


def tensor_external(arr: np.ndarray, name: str, location: str, offset: int) -> dict:
    """A TensorProto referencing `arr`'s bytes at `offset` in side file
    `location` (data_location EXTERNAL); the caller writes the bytes there."""
    arr = np.asarray(arr)
    if arr.dtype not in NP_TO_ONNX:
        raise TypeError(f"no ONNX dtype for numpy {arr.dtype}")
    return {
        "name": name,
        "dims": list(arr.shape),
        "data_type": NP_TO_ONNX[arr.dtype],
        "data_location": 1,
        "external_data": [
            {"key": "location", "value": location},
            {"key": "offset", "value": str(int(offset))},
            {"key": "length", "value": str(arr.nbytes)},
        ],
    }


def save_with_external_data(model_raw: dict, path, size_threshold: int = 1024) -> None:
    """Write `model_raw` (a ModelProto dict) to `path`, with every initializer
    whose raw_data is larger than `size_threshold` bytes moved into one
    `<model>.data` side file, in graph order: the layout of
    `onnx.save(..., save_as_external_data=True)`, which published exports
    larger than 2 GB take."""
    from pathlib import Path

    path = Path(path)
    side_name = path.name + ".data"
    chunks: list = []
    off = 0
    g = model_raw["graph"]
    new_inits = []
    for t in g.get("initializer", []):
        raw = t.get("raw_data", b"")
        if len(raw) <= size_threshold:
            new_inits.append(t)
            continue
        t = dict(t)
        t.pop("raw_data", None)
        t["data_location"] = 1
        t["external_data"] = [
            {"key": "location", "value": side_name},
            {"key": "offset", "value": str(off)},
            {"key": "length", "value": str(len(raw))},
        ]
        chunks.append(raw)
        off += len(raw)
        new_inits.append(t)
    g = dict(g)
    g["initializer"] = new_inits
    model_raw = dict(model_raw)
    model_raw["graph"] = g
    if chunks:
        with open(path.parent / side_name, "wb") as f:
            for c in chunks:  # one chunk at a time: no second copy of the weights
                f.write(c)
    path.write_bytes(serialize(model_raw))


def value_info(name: str, onnx_dtype: int, shape: Sequence[int | str]) -> dict:
    dims = []
    for d in shape:
        dims.append({"dim_param": d} if isinstance(d, str) else {"dim_value": int(d)})
    return {
        "name": name,
        "type": {"tensor_type": {"elem_type": onnx_dtype, "shape": {"dim": dims}}},
    }


def vi_from_array(name: str, arr: np.ndarray) -> dict:
    arr = np.asarray(arr)
    return value_info(name, NP_TO_ONNX[arr.dtype], arr.shape)


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
