"""ONNX message descriptors over the generic wire codec (the port's copy of
lele_tpu/onnx/schema.py).

Field numbers and enum values follow the public ONNX IR spec. Only the
messages an inference compiler needs are declared; unknown fields on the wire
are skipped by `wire.decode`.
"""

from __future__ import annotations

from typing import Any

from .wire import Field, decode, encode

F = Field

REGISTRY: dict[str, tuple[Field, ...]] = {
    "ModelProto": (
        F(1, "ir_version", "int64"),
        F(2, "producer_name", "string"),
        F(3, "producer_version", "string"),
        F(4, "domain", "string"),
        F(5, "model_version", "int64"),
        F(6, "doc_string", "string"),
        F(7, "graph", "message", msg="GraphProto"),
        F(8, "opset_import", "message", repeated=True, msg="OperatorSetIdProto"),
        F(25, "functions", "message", repeated=True, msg="FunctionProto"),
    ),
    "FunctionProto": (
        F(1, "name", "string"),
        F(4, "input", "string", repeated=True),
        F(5, "output", "string", repeated=True),
        F(6, "attribute", "string", repeated=True),
        F(11, "attribute_proto", "message", repeated=True, msg="AttributeProto"),
        F(7, "node", "message", repeated=True, msg="NodeProto"),
        F(8, "doc_string", "string"),
        F(9, "opset_import", "message", repeated=True, msg="OperatorSetIdProto"),
        F(10, "domain", "string"),
        F(13, "overload", "string"),
    ),
    "OperatorSetIdProto": (
        F(1, "domain", "string"),
        F(2, "version", "int64"),
    ),
    "GraphProto": (
        F(1, "node", "message", repeated=True, msg="NodeProto"),
        F(2, "name", "string"),
        F(5, "initializer", "message", repeated=True, msg="TensorProto"),
        F(10, "doc_string", "string"),
        F(11, "input", "message", repeated=True, msg="ValueInfoProto"),
        F(12, "output", "message", repeated=True, msg="ValueInfoProto"),
        F(13, "value_info", "message", repeated=True, msg="ValueInfoProto"),
    ),
    "NodeProto": (
        F(1, "input", "string", repeated=True),
        F(2, "output", "string", repeated=True),
        F(3, "name", "string"),
        F(4, "op_type", "string"),
        F(5, "attribute", "message", repeated=True, msg="AttributeProto"),
        F(6, "doc_string", "string"),
        F(7, "domain", "string"),
        F(8, "overload", "string"),
    ),
    "AttributeProto": (
        F(1, "name", "string"),
        F(2, "f", "float"),
        F(3, "i", "int64"),
        F(4, "s", "bytes"),
        F(5, "t", "message", msg="TensorProto"),
        F(6, "g", "message", msg="GraphProto"),
        F(7, "floats", "float", repeated=True),
        F(8, "ints", "int64", repeated=True),
        F(9, "strings", "bytes", repeated=True),
        F(10, "tensors", "message", repeated=True, msg="TensorProto"),
        F(11, "graphs", "message", repeated=True, msg="GraphProto"),
        F(20, "type", "enum"),
        F(21, "ref_attr_name", "string"),
    ),
    "TensorProto": (
        F(1, "dims", "int64", repeated=True),
        F(2, "data_type", "enum"),
        F(4, "float_data", "float", repeated=True),
        F(5, "int32_data", "int32", repeated=True),
        F(6, "string_data", "bytes", repeated=True),
        F(7, "int64_data", "int64", repeated=True),
        F(8, "name", "string"),
        F(9, "raw_data", "bytes"),
        F(10, "double_data", "double", repeated=True),
        F(11, "uint64_data", "uint64", repeated=True),
        F(13, "external_data", "message", repeated=True, msg="StringStringEntryProto"),
        F(14, "data_location", "enum"),
    ),
    "StringStringEntryProto": (
        F(1, "key", "string"),
        F(2, "value", "string"),
    ),
    "ValueInfoProto": (
        F(1, "name", "string"),
        F(2, "type", "message", msg="TypeProto"),
    ),
    "TypeProto": (
        F(1, "tensor_type", "message", msg="TypeProto.Tensor"),
    ),
    "TypeProto.Tensor": (
        F(1, "elem_type", "enum"),
        F(2, "shape", "message", msg="TensorShapeProto"),
    ),
    "TensorShapeProto": (
        F(1, "dim", "message", repeated=True, msg="TensorShapeProto.Dimension"),
    ),
    "TensorShapeProto.Dimension": (
        F(1, "dim_value", "int64"),
        F(2, "dim_param", "string"),
    ),
}

# AttributeProto.AttributeType enum values (public ONNX spec)
ATTR_FLOAT = 1
ATTR_INT = 2
ATTR_STRING = 3
ATTR_TENSOR = 4
ATTR_GRAPH = 5
ATTR_FLOATS = 6
ATTR_INTS = 7
ATTR_STRINGS = 8
ATTR_TENSORS = 9
ATTR_GRAPHS = 10


class Proto:
    """Attribute-access wrapper over a decoded message dict.

    Missing singular fields return sensible zero values; missing repeated
    fields return []. Nested messages are wrapped lazily.
    """

    __slots__ = ("_d", "_fields")

    def __init__(self, d: dict, type_name: str | None = None):
        self._d = d
        tn = type_name or d.get("__type__")
        self._fields = {f.name: f for f in REGISTRY[tn]} if tn else {}

    def __getattr__(self, name: str) -> Any:
        if name.startswith("_"):
            raise AttributeError(name)
        f = self._fields.get(name)
        v = self._d.get(name)
        if v is None:
            if f is None:
                raise AttributeError(name)
            if f.repeated:
                return []
            if f.kind == "message":
                return None
            return {"string": "", "bytes": b""}.get(f.kind, 0)
        if f is not None and f.kind == "message":
            if f.repeated:
                return [Proto(item, f.msg) for item in v]
            return Proto(v, f.msg)
        return v

    def raw(self) -> dict:
        return self._d

    def has(self, name: str) -> bool:
        return name in self._d

    def __repr__(self) -> str:
        tn = self._d.get("__type__", "Proto")
        keys = [k for k in self._d if k != "__type__"]
        return f"<{tn} {keys}>"


def decode_model(buf: bytes | memoryview) -> Proto:
    d = decode(buf, REGISTRY["ModelProto"], REGISTRY)
    d["__type__"] = "ModelProto"
    return Proto(d)


def encode_message(d: dict, type_name: str) -> bytes:
    return encode(d, REGISTRY[type_name], REGISTRY)
