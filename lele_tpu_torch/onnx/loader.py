"""ONNX model loading: file → decoded graph → numpy weight arrays.

The port's copy of lele_tpu/onnx/loader.py: `DTYPE_MAP`, `NP_TO_ONNX`,
`tensor_to_array` and `OnnxModel` (`load` maps the file, `from_bytes`
decodes bytes in memory). Initializers stay zero-copy views of the mapped
file until a value is materialized.

- External data (`data_location` EXTERNAL): the tensor's bytes come from a
  side file next to the model (`location`, `offset`, `length`), mapped once
  a file and validated against its inode, size and mtime. `OnnxModel.
  base_dir` is the model's directory; `base_dir_scope` makes it the
  fallback for bare TensorProtos (Constant attributes) while a graph is
  traced. Every rejection is JAX's: no `location`, a path that escapes the
  model directory, a missing file, a length mismatch, a range past the end.
- 4-bit tensors (uint4 21, int4 22): two values a byte, low nibble first,
  unpacked to uint8 / int8 in an `Int4Array` that keeps the ONNX type.
- fp8 tensors (17-20): ml_dtypes' float8 arrays where ml_dtypes is
  installed, as the JAX package has them; elsewhere (the card machine has
  no ml_dtypes) the uint8 bits in an `Fp8Bits` array that keeps the ONNX
  type. Either becomes a torch `float8_*` tensor on the device
  (`to_torch`), as bf16 does.
- STRING tensors (8): object arrays of str (host values only).
"""

from __future__ import annotations

import contextlib
import mmap
from pathlib import Path

import numpy as np
import torch

from . import schema
from .schema import Proto

try:  # bf16 / fp8 where ml_dtypes is installed; their bit patterns otherwise
    import ml_dtypes

    _BF16 = np.dtype(ml_dtypes.bfloat16)
    _FP8: dict[int, np.dtype] = {
        17: np.dtype(ml_dtypes.float8_e4m3fn),
        18: np.dtype(ml_dtypes.float8_e4m3fnuz),
        19: np.dtype(ml_dtypes.float8_e5m2),
        20: np.dtype(ml_dtypes.float8_e5m2fnuz),
    }
except ImportError:  # pragma: no cover
    _BF16 = np.dtype(np.uint16)
    _FP8 = {}

# fp8 ONNX types → torch dtypes (the device's form of both fp8 storages)
FP8_TORCH = {17: torch.float8_e4m3fn, 18: torch.float8_e4m3fnuz,
             19: torch.float8_e5m2, 20: torch.float8_e5m2fnuz}
_FP8_NAMES = {"float8_e4m3fn": 17, "float8_e4m3fnuz": 18, "float8_e5m2": 19,
              "float8_e5m2fnuz": 20}

# 4-bit types (opset 21): raw_data packs two elements a byte, low nibble
# first; data_type → signed
_INT4_TYPES = {21: False, 22: True}

# TensorProto.DataType → numpy dtype (public ONNX enum)
DTYPE_MAP: dict[int, np.dtype] = {
    1: np.dtype(np.float32),
    2: np.dtype(np.uint8),
    3: np.dtype(np.int8),
    4: np.dtype(np.uint16),
    5: np.dtype(np.int16),
    6: np.dtype(np.int32),
    7: np.dtype(np.int64),
    9: np.dtype(np.bool_),
    10: np.dtype(np.float16),
    11: np.dtype(np.float64),
    12: np.dtype(np.uint32),
    13: np.dtype(np.uint64),
    16: _BF16,
    **_FP8,  # 17-20 where ml_dtypes is installed
}

NP_TO_ONNX: dict[np.dtype, int] = {v: k for k, v in reversed(DTYPE_MAP.items())}

# open maps of side files by real path, with the (inode, size, mtime) they
# were mapped at: a side file rewritten in place is mapped anew. Entries
# live as long as the process, so the views into them stay valid
_EXTERNAL_MMAPS: dict[str, tuple[tuple, mmap.mmap]] = {}

# the fallback model directory for bare TensorProtos (Constant attributes,
# the SAN-M matcher's static lookups); the tracer pushes the model's
# directory around its graph walk
_BASE_DIR_STACK: list[str] = []


class _Typed(np.ndarray):
    """An ndarray that keeps the ONNX data_type its storage stands for."""

    onnx_dtype: int | None = None

    def __array_finalize__(self, obj):
        self.onnx_dtype = getattr(obj, "onnx_dtype", None)


class Int4Array(_Typed):
    """Values that came from a 4-bit TensorProto: stored as int8 / uint8,
    with the 4-bit ONNX type (21 uint4, 22 int4) in `onnx_dtype`, since the
    value range is 4-bit."""


class Fp8Bits(_Typed):
    """The uint8 bits of an fp8 TensorProto where ml_dtypes is absent, with
    its ONNX type (17-20) in `onnx_dtype`. `to_torch` reinterprets them as
    the matching torch float8 dtype."""


def fp8_type(a) -> int | None:
    """The ONNX fp8 type (17-20) of a host array in either fp8 storage, or
    None."""
    if isinstance(a, Fp8Bits):
        return a.onnx_dtype
    return _FP8_NAMES.get(getattr(getattr(a, "dtype", None), "name", ""))


def to_torch(a: np.ndarray) -> torch.Tensor:
    """A host array as a CPU tensor in a writable C-ordered copy (a
    transposed array's copy too: a kernel wrapper's `.contiguous()` would
    otherwise copy the weight again at every call); bf16 and fp8 (either
    storage) by their bits."""
    a = np.asarray(a) if not isinstance(a, Fp8Bits) else a
    name = a.dtype.name
    f8 = fp8_type(a)
    c = np.array(a, order="C")
    if f8 is not None:
        return torch.from_numpy(c.view(np.uint8)).view(FP8_TORCH[f8])
    if name == "bfloat16":
        return torch.from_numpy(c.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(c)


def from_torch(t: torch.Tensor) -> np.ndarray:
    """A CPU tensor as a host array; bf16 and fp8 in their numpy storage
    (ml_dtypes' types, or their bits where it is absent)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy().view(_BF16)
    f8 = next((k for k, v in FP8_TORCH.items() if v == t.dtype), None)
    if f8 is None:
        return t.numpy()
    bits = t.view(torch.uint8).numpy()
    if f8 in DTYPE_MAP:
        return bits.view(DTYPE_MAP[f8])
    out = bits.view(Fp8Bits)
    out.onnx_dtype = f8
    return out


@contextlib.contextmanager
def base_dir_scope(base_dir: str | Path | None):
    """Make `base_dir` the fallback for external-data resolution inside."""
    if base_dir is None:
        yield
        return
    _BASE_DIR_STACK.append(str(base_dir))
    try:
        yield
    finally:
        _BASE_DIR_STACK.pop()


def _external_mmap(path: Path) -> mmap.mmap:
    key = str(path.resolve())
    st = path.stat()
    sig = (st.st_ino, st.st_size, st.st_mtime_ns)
    cached = _EXTERNAL_MMAPS.get(key)
    if cached is not None and cached[0] == sig:
        return cached[1]
    with open(path, "rb") as f:
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
    # a stale entry is not closed: models loaded earlier may still hold
    # views into it
    _EXTERNAL_MMAPS[key] = (sig, mm)
    return mm


def _resolve_base_dir(t: Proto, base_dir):
    if base_dir is None and _BASE_DIR_STACK:
        base_dir = _BASE_DIR_STACK[-1]
    if base_dir is None:
        raise ValueError(
            f"tensor {t.name!r} uses external data (data_location=EXTERNAL) but no "
            "model directory is known — load via OnnxModel.load(path) so the side "
            "file can be resolved, or consolidate the model (onnx.save with "
            "save_as_external_data=False)")
    return base_dir


def _load_external(t: Proto, np_dtype: np.dtype | None, dims: list[int],
                   base_dir: str | Path) -> np.ndarray:
    """The bytes of a data_location=EXTERNAL tensor from its side file
    (`location` relative to the model's directory; `offset` and `length`
    optional decimal strings). np_dtype None is 4-bit storage: the packed
    uint8 bytes come back."""
    info = {e.key: e.value for e in t.external_data}
    loc = info.get("location", "")
    if not loc:
        raise ValueError(f"external tensor {t.name!r} has no `location` entry")
    rel = Path(loc)
    if rel.is_absolute() or ".." in rel.parts:
        raise ValueError(f"external tensor {t.name!r} location {loc!r} escapes the "
                         "model directory (absolute paths and '..' are rejected)")
    path = Path(base_dir) / rel
    if not path.exists():
        raise FileNotFoundError(f"external data file {str(path)!r} for tensor "
                                f"{t.name!r} not found — the side file must sit next "
                                "to the .onnx model")
    n = int(np.prod(dims)) if dims else 1
    if np_dtype is None:  # 4-bit: two elements a byte, padded up
        n = (n + 1) // 2
        np_dtype = np.dtype(np.uint8)
    nbytes = n * np_dtype.itemsize
    offset = int(info.get("offset", "0") or "0")
    length = int(info["length"]) if info.get("length") else nbytes
    if length != nbytes:
        raise ValueError(f"external tensor {t.name!r}: recorded length {length} != "
                         f"expected {nbytes} bytes for shape {dims} dtype {np_dtype}")
    mm = _external_mmap(path)
    if offset < 0 or offset + length > len(mm):
        raise ValueError(f"external tensor {t.name!r}: range [{offset}, "
                         f"{offset + length}) exceeds side file {str(path)!r} "
                         f"({len(mm)} bytes)")
    return np.frombuffer(mm, dtype=np_dtype, count=n, offset=offset)


def _load_int4(t: Proto, base_dir) -> np.ndarray:
    """Unpack a 4-bit tensor (uint4 21, int4 22): two elements a byte, low
    nibble first, the last byte zero-padded for an odd count. Values come
    back as uint8 / int8 in an `Int4Array`."""
    signed = _INT4_TYPES[int(t.data_type)]
    dims = [int(d) for d in t.dims]
    n = int(np.prod(dims)) if dims else 1
    if int(t.data_location) == 1:
        packed = np.asarray(_load_external(t, None, dims, _resolve_base_dir(t, base_dir)))
    else:
        raw = t.raw_data
        if isinstance(raw, memoryview):
            raw = bytes(raw)
        if len(raw) < (n + 1) // 2:
            raise ValueError(f"int4 tensor {t.name!r}: raw_data {len(raw)} bytes < "
                             f"{(n + 1) // 2} needed for {n} elements")
        packed = np.frombuffer(raw, dtype=np.uint8, count=(n + 1) // 2)
    vals = np.empty(packed.size * 2, np.uint8)
    vals[0::2] = packed & 0x0F
    vals[1::2] = packed >> 4
    vals = vals[:n]
    if signed:
        v = vals.astype(np.int8)
        v = np.where(v > 7, v - 16, v).astype(np.int8)
    else:
        v = vals
    v = (v.reshape(dims) if dims else v.reshape(())).view(Int4Array)
    v.onnx_dtype = int(t.data_type)
    return v


def tensor_to_array(t: Proto, base_dir: str | Path | None = None) -> np.ndarray:
    """Materialize a TensorProto as a numpy array: any numeric type, 4-bit
    (`Int4Array`), fp8, and STRING as an object array of str. An external
    tensor resolves against `base_dir`, else the innermost
    `base_dir_scope`."""
    dt = int(t.data_type)
    dims = [int(d) for d in t.dims]
    if dt == 8:  # STRING
        vals = [(bytes(s) if isinstance(s, memoryview) else s).decode("utf-8")
                for s in t.string_data]
        arr = np.empty(len(vals), dtype=object)
        arr[:] = vals
        return arr.reshape(dims) if dims else arr.reshape(())
    if dt in _INT4_TYPES:
        return _load_int4(t, base_dir)
    bits = dt in FP8_TORCH and dt not in DTYPE_MAP
    np_dtype = np.dtype(np.uint8) if bits else DTYPE_MAP.get(dt)
    if np_dtype is None:
        raise ValueError(f"unsupported ONNX data_type {dt} for tensor {t.name!r}")
    if int(t.data_location) == 1:
        arr = _load_external(t, np_dtype, dims, _resolve_base_dir(t, base_dir))
    else:
        arr = _inline_payload(t, dt, np_dtype, dims)
    arr = arr.reshape(dims) if dims else arr.reshape(())
    if bits:
        arr = arr.view(Fp8Bits)
        arr.onnx_dtype = dt
    return arr


def _inline_payload(t: Proto, dt: int, np_dtype: np.dtype, dims: list[int]) -> np.ndarray:
    raw = t.raw_data
    if raw:
        arr = np.frombuffer(raw, dtype=np_dtype)
    elif t.float_data and dt in (1, 16, 10):
        arr = np.asarray(t.float_data, dtype=np.float32).astype(np_dtype)
    elif t.int32_data and dt in (2, 3, 4, 5, 6, 9, 10, 16):
        a = np.asarray(t.int32_data, dtype=np.int32)
        if dt == 10:  # f16 stored bit-packed in int32_data
            arr = a.astype(np.uint16).view(np.float16)
        elif dt == 16:
            arr = a.astype(np.uint16).view(_BF16)
        else:
            arr = a.astype(np_dtype)
    elif t.int64_data and dt == 7:
        arr = np.asarray(t.int64_data, dtype=np.int64)
    elif t.double_data and dt == 11:
        arr = np.asarray(t.double_data, dtype=np.float64)
    elif t.uint64_data and dt in (12, 13):
        arr = np.asarray(t.uint64_data, dtype=np.uint64).astype(np_dtype)
    else:
        n = int(np.prod(dims)) if dims else 0
        if n > 0:
            # zeros here would compile and run a garbage model silently
            raise ValueError(f"tensor {t.name!r} ({dims}, data_type {dt}) carries "
                             "no recognized payload")
        arr = np.zeros(n, dtype=np_dtype)
    return arr


class OnnxModel:
    """A decoded ONNX model with initializer lookup."""

    def __init__(self, model: Proto, path: str | None = None,
                 base_dir: str | Path | None = None):
        self.model = model
        self.path = path
        self._base_dir = str(base_dir) if base_dir is not None else None
        self.graph: Proto = model.graph
        if self.graph is None:
            raise ValueError("ONNX model has no graph (corrupt or empty file)")
        self.initializers: dict[str, Proto] = {
            t.name: t for t in self.graph.initializer
        }
        self.opset: int = max(
            [int(o.version) for o in model.opset_import if o.domain in ("", "ai.onnx")],
            default=17,
        )

    @classmethod
    def load(cls, path: str | Path) -> "OnnxModel":
        path = str(path)
        with open(path, "rb") as f:
            # the mapping keeps large raw_data blobs zero-copy until used
            buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
            model = schema.decode_model(memoryview(buf))
        return cls(model, path=path)

    @classmethod
    def from_bytes(cls, data: bytes, base_dir: str | Path | None = None) -> "OnnxModel":
        return cls(schema.decode_model(data), base_dir=base_dir)

    @property
    def base_dir(self) -> str | None:
        """The directory external-data tensors resolve against: the one given,
        else the model file's."""
        if self._base_dir is not None:
            return self._base_dir
        return str(Path(self.path).parent) if self.path else None

    def initializer_array(self, name: str) -> np.ndarray | None:
        t = self.initializers.get(name)
        return tensor_to_array(t, self.base_dir) if t is not None else None

    def find_constant_node_tensor(self, name: str) -> Proto | None:
        """The TensorProto behind a Constant node's output, if one makes it."""
        for node in self.graph.node:
            if node.op_type == "Constant" and name in node.output:
                for attr in node.attribute:
                    if attr.name == "value":
                        return attr.t
        return None

    def input_names(self) -> list[str]:
        """Graph inputs that are not initializers (the runtime inputs)."""
        return [
            vi.name for vi in self.graph.input if vi.name not in self.initializers
        ]

    def output_names(self) -> list[str]:
        return [vi.name for vi in self.graph.output]

    def input_info(self) -> list[tuple[str, int, list[int | str]]]:
        """[(name, onnx_dtype, dims)] with dim_param strings for dynamic dims."""
        out = []
        for vi in self.graph.input:
            if vi.name in self.initializers:
                continue
            tt = vi.type.tensor_type if vi.type else None
            if tt is None:
                out.append((vi.name, 1, []))
                continue
            dims: list[int | str] = []
            if tt.shape is not None:
                for d in tt.shape.dim:
                    dims.append(d.dim_param if d.has("dim_param") else int(d.dim_value))
            out.append((vi.name, int(tt.elem_type) or 1, dims))
        return out
