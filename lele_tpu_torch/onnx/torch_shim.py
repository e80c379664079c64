"""`onnx`-module stand-in for `torch.onnx.export` (counterpart of
lele_tpu/onnx/torch_shim.py).

PyTorch's TorchScript ONNX exporter serializes the ModelProto itself (in
C++), but imports the `onnx` package for a post-pass that scans the graph
for onnxscript functions (`_add_onnxscript_fn` in torch/onnx). Without the
package, export fails, though nothing of it is needed for standard aten
graphs.

`install()` registers a minimal stand-in built on the port's own protobuf
schema (onnx/schema.py): `load_model_from_string` decodes the bytes (the
post-pass walks `.graph.node[*].attribute[*].g`, which `Proto` answers) and
`SerializeToString` returns the original bytes untouched. With it,
`torch.onnx.export(..., dynamo=False)` works, and its file feeds straight
into `lele_tpu_torch.compiler.compile_model`.
"""

from __future__ import annotations

import sys
import types


class _ModelShim:
    def __init__(self, data: bytes):
        from . import schema

        self._bytes = bytes(data)
        self._model = schema.decode_model(self._bytes)
        self.functions: list = []

    @property
    def graph(self):
        return self._model.graph

    def SerializeToString(self) -> bytes:
        if self.functions:
            raise NotImplementedError(
                "onnxscript custom functions require the real onnx package")
        return self._bytes


def install(force: bool = False) -> bool:
    """Register the stand-in as `onnx` where the real package is absent
    (`force` replaces a stand-in already registered). Returns True: the
    stand-in or the real package is importable afterwards."""
    mod = sys.modules.get("onnx")
    if mod is not None and (not force or getattr(mod, "__file__", None)):
        return True  # registered already; the real package is never replaced
    if mod is None:
        try:  # the real package, where there is one
            import onnx  # noqa: F401

            return True
        except ImportError:
            pass
    import importlib.machinery

    mod = types.ModuleType("onnx")
    mod.__version__ = "0.0.0+lele_tpu_torch_shim"
    # a spec, so that importlib.util.find_spec("onnx") finds it
    mod.__spec__ = importlib.machinery.ModuleSpec("onnx", loader=None)
    mod.load_model_from_string = _ModelShim
    mod.load_from_string = _ModelShim
    mod.ModelProto = _ModelShim
    sys.modules["onnx"] = mod
    return True
