"""Minimal protobuf wire-format codec (no deps): the port's copy of
lele_tpu/onnx/wire.py.

No `onnx` package and no generated code: ONNX's wire layout is stable public
knowledge, and the subset of messages an inference compiler needs is small.
This module implements a generic, descriptor-driven protobuf reader/writer;
`schema.py` declares the ONNX message descriptors on top of it.

Wire types: 0=varint, 1=fixed64, 2=length-delimited, 5=fixed32.
Scalar repeated fields accept both packed and unpacked encodings (required
for real-world ONNX files).
"""

from __future__ import annotations

import struct
from typing import Any, Iterator, NamedTuple

_VARINT = 0
_FIXED64 = 1
_LEN = 2
_FIXED32 = 5

_WIRE_TYPE = {
    "int32": _VARINT,
    "int64": _VARINT,
    "uint64": _VARINT,
    "bool": _VARINT,
    "enum": _VARINT,
    "float": _FIXED32,
    "double": _FIXED64,
    "bytes": _LEN,
    "string": _LEN,
    "message": _LEN,
}

_PACKABLE = {"int32", "int64", "uint64", "bool", "enum", "float", "double"}


class Field(NamedTuple):
    num: int
    name: str
    kind: str  # one of _WIRE_TYPE keys
    repeated: bool = False
    msg: str | None = None  # message type name for kind == "message"


# ---------------------------------------------------------------------------
# Decoding


def read_varint(buf: memoryview, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    n = len(buf)
    while True:
        if pos >= n:
            raise ValueError("truncated varint")
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("varint too long")


def _zigzag_signed(v: int) -> int:
    # protobuf int32/int64 use two's-complement varints (not zigzag); a
    # negative value arrives as a 10-byte varint.
    if v >= 1 << 63:
        v -= 1 << 64
    return v


def iter_fields(buf: memoryview) -> Iterator[tuple[int, int, Any, int]]:
    """Yield (field_number, wire_type, raw_value, end_pos) over a buffer."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = read_varint(buf, pos)
        fnum, wt = tag >> 3, tag & 7
        if wt == _VARINT:
            val, pos = read_varint(buf, pos)
        elif wt == _FIXED64:
            val = buf[pos : pos + 8]
            pos += 8
        elif wt == _LEN:
            ln, pos = read_varint(buf, pos)
            if pos + ln > n:
                raise ValueError(
                    f"truncated message: field {fnum} claims {ln} bytes, "
                    f"{n - pos} remain"
                )
            val = buf[pos : pos + ln]
            pos += ln
        elif wt == _FIXED32:
            val = buf[pos : pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wt} (field {fnum})")
        yield fnum, wt, val, pos


def _convert_scalar(kind: str, wt: int, raw: Any) -> Any:
    if kind in ("int32", "int64"):
        return _zigzag_signed(raw)
    if kind in ("uint64", "enum"):
        return raw
    if kind == "bool":
        return bool(raw)
    if kind == "float":
        return struct.unpack("<f", raw)[0]
    if kind == "double":
        return struct.unpack("<d", raw)[0]
    if kind == "bytes":
        return bytes(raw)
    if kind == "string":
        return str(raw, "utf-8", "replace")
    raise ValueError(f"not a scalar kind: {kind}")


def _unpack_packed(kind: str, raw: memoryview) -> list:
    if kind == "float":
        return list(struct.unpack(f"<{len(raw) // 4}f", raw))
    if kind == "double":
        return list(struct.unpack(f"<{len(raw) // 8}d", raw))
    out = []
    pos = 0
    n = len(raw)
    while pos < n:
        v, pos = read_varint(raw, pos)
        if kind in ("int32", "int64"):
            v = _zigzag_signed(v)
        elif kind == "bool":
            v = bool(v)
        out.append(v)
    return out


def decode(buf: bytes | memoryview, fields: tuple[Field, ...], registry: dict) -> dict:
    """Decode a message body into a {field_name: value} dict.

    - repeated fields decode to lists (packed or unpacked on the wire)
    - `bytes` fields are returned as `memoryview` slices when large, so big
      ONNX `raw_data` blobs are zero-copy views into the mmap'd file
    - unknown field numbers are skipped
    """
    if isinstance(buf, (bytes, bytearray)):
        buf = memoryview(buf)
    by_num = {f.num: f for f in fields}
    out: dict[str, Any] = {}
    for f in fields:
        if f.repeated:
            out[f.name] = []
    for fnum, wt, raw, _ in iter_fields(buf):
        f = by_num.get(fnum)
        if f is None:
            continue
        expected_wt = _WIRE_TYPE[f.kind]
        if wt != expected_wt and not (
            f.repeated and wt == _LEN and f.kind in _PACKABLE
        ):
            # wire type contradicts the schema (corrupt or type-confused
            # field): skip rather than mis-parse
            continue
        if f.kind == "message":
            sub = decode(raw, registry[f.msg], registry)
            sub["__type__"] = f.msg
            if f.repeated:
                out[f.name].append(sub)
            else:
                out[f.name] = sub
        elif f.repeated and wt == _LEN and f.kind in _PACKABLE:
            out[f.name].extend(_unpack_packed(f.kind, raw))
        elif f.repeated:
            out[f.name].append(_convert_scalar(f.kind, wt, raw))
        elif f.kind == "bytes" and len(raw) > 256:
            out[f.name] = raw  # zero-copy memoryview for large blobs
        else:
            out[f.name] = _convert_scalar(f.kind, wt, raw)
    return out


# ---------------------------------------------------------------------------
# Encoding (used by the graph builder, an onnx.helper analog)


def write_varint(out: bytearray, v: int) -> None:
    if v < 0:
        v += 1 << 64
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _encode_scalar(out: bytearray, kind: str, num: int, v: Any) -> None:
    wt = _WIRE_TYPE[kind]
    write_varint(out, (num << 3) | wt)
    if wt == _VARINT:
        write_varint(out, int(v))
    elif kind == "float":
        out += struct.pack("<f", v)
    elif kind == "double":
        out += struct.pack("<d", v)
    else:  # bytes / string / message payload
        data = v.encode("utf-8") if isinstance(v, str) else bytes(v)
        write_varint(out, len(data))
        out += data


def encode(msg: dict, fields: tuple[Field, ...], registry: dict) -> bytes:
    out = bytearray()
    for f in fields:
        v = msg.get(f.name)
        if v is None or (f.repeated and not v):
            continue
        vals = v if f.repeated else [v]
        if f.repeated and f.kind in _PACKABLE and f.kind != "bool":
            # packed encoding for repeated scalars
            payload = bytearray()
            for item in vals:
                if f.kind == "float":
                    payload += struct.pack("<f", item)
                elif f.kind == "double":
                    payload += struct.pack("<d", item)
                else:
                    write_varint(payload, int(item))
            write_varint(out, (f.num << 3) | _LEN)
            write_varint(out, len(payload))
            out += payload
        elif f.kind == "message":
            for item in vals:
                body = encode(item, registry[f.msg], registry)
                write_varint(out, (f.num << 3) | _LEN)
                write_varint(out, len(body))
                out += body
        else:
            for item in vals:
                _encode_scalar(out, f.kind, f.num, item)
    return bytes(out)
