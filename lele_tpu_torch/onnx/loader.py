"""ONNX model loading: file → decoded graph → numpy weight arrays.

The port's copy of what it needs from lele_tpu/onnx/loader.py: `DTYPE_MAP`,
`NP_TO_ONNX`, `tensor_to_array` and `OnnxModel` (`load` maps the file,
`from_bytes` decodes bytes in memory). Initializers stay zero-copy views of
the mapped file until a value is materialized. Not carried over yet:
external-data side files, 4-bit tensors and string tensors (each raises).
"""

from __future__ import annotations

import mmap
from pathlib import Path

import numpy as np

from . import schema
from .schema import Proto

try:  # bf16 where ml_dtypes is installed; its bit pattern otherwise
    import ml_dtypes

    _BF16 = np.dtype(ml_dtypes.bfloat16)
except ImportError:  # pragma: no cover
    _BF16 = np.dtype(np.uint16)

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
}

NP_TO_ONNX: dict[np.dtype, int] = {v: k for k, v in reversed(DTYPE_MAP.items())}


def tensor_to_array(t: Proto) -> np.ndarray:
    """Materialize a TensorProto as a numpy array (numeric dtypes)."""
    dt = int(t.data_type)
    if int(t.data_location) == 1:
        raise ValueError(f"tensor {t.name!r} uses external data, which the "
                         "port's loader does not read yet")
    np_dtype = DTYPE_MAP.get(dt)
    if np_dtype is None:
        raise ValueError(f"unsupported ONNX data_type {dt} for tensor {t.name!r}")
    dims = [int(d) for d in t.dims]
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
    return arr.reshape(dims) if dims else arr.reshape(())


class OnnxModel:
    """A decoded ONNX model with initializer lookup."""

    def __init__(self, model: Proto, path: str | None = None):
        self.model = model
        self.path = path
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
    def from_bytes(cls, data: bytes) -> "OnnxModel":
        return cls(schema.decode_model(data))

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
