"""ONNX substrate of the port: wire codec, schema, loader, graph builder and
the synthetic SAN-M int8 graph (counterpart of lele_tpu.onnx)."""

from .loader import DTYPE_MAP, NP_TO_ONNX, OnnxModel, bind_inputs, tensor_to_array  # noqa: F401
from .schema import Proto  # noqa: F401
