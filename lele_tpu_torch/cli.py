"""lele_gen-equivalent CLI of the port: compile an ONNX model into a
deployable artifact (the counterpart of lele_tpu/cli.py).

    python -m lele_tpu_torch.cli <model.onnx> <out_dir> [ClassName] [options]

writes

    <Class>.py                 generated model wrapper (load + forward)
    <Class>_weights.bin/.json  flat deduped weights blob + manifest (the JAX
                               package's format, compiler/weights.py)
    <model>.onnx               the graph the wrapper traces
    <Class>.pt2                with --aot: the model's torch.export program
                               (compiler/aot.py; params as inputs)
    <Class>.xc/                with --xc: the AOT bundle (runtime/artifact.py):
                               the program, the kernel libraries it launches
                               and a manifest pinned to the compiling torch,
                               CUDA and card

The blob holds exactly the compiled model's params: the graph's hoisted
initializers and what the trace derived from them (shifted int8 weights,
column sums, the SAN-M stacks packed for their kernel), so it carries what
the kernels read. The generated wrapper re-traces the ONNX at import,
checks that the blob holds exactly the names, shapes and dtypes of the
model's params (raising on any difference), copies each blob tensor into its
param in place (the trace's steps hold the params by identity) and captures
the CUDA graph on those weights (`CompiledModel.compile()`). Where
`<Class>.xc/` exists, the wrapper first checks its manifest against this
process and checkout; if it holds, it hands the bundle's kernel libraries
to the build (nothing is compiled), builds the model from the bundle's
program and signature on the blob's params without tracing the graph, and
sets `aot_loaded`; on a mismatch it traces the graph as without the bundle.
It points the kernel build directory at `$LELE_CACHE_DIR` where that is set
(runtime/cache.enable_cache) and runs at the `PRECISION` the build recorded
(`--precision`, else config.matmul_precision: "highest").

Everything runs on the card unless `--device cpu` (or device="cpu") is
given.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
from pathlib import Path

import numpy as np
import torch


def sanitize_name(name: str) -> str:
    """Identifier-safe class name."""
    out = "".join(c if c.isalnum() else "_" for c in name)
    if not out or out[0].isdigit():
        out = "M_" + out
    return out


_WRAPPER_TEMPLATE = '''"""Generated by lele_tpu_torch.cli — model wrapper for {class_name}.

Traces the ONNX graph on the card (or on `device`), loads the weights blob
into the compiled model's params in place and captures its CUDA graph.
Usage:
    from {class_name} import {class_name}
    model = {class_name}()                # device=None: the card
    outputs = model.forward(**inputs)     # numpy in, numpy out
"""

from pathlib import Path

_HERE = Path(__file__).resolve().parent


class {class_name}:
    INPUT_SHAPES = {input_shapes!r}
    OUTPUT_NAMES = {output_names!r}
    PRECISION = {precision!r}  # the matmul precision the build validated
    STRICT = {strict!r}
    # device=None is the card (lele_tpu_torch.default_device(), which raises
    # where there is none); "cpu" runs the kernels' plain versions

    def __init__(self, weights_prefix=None, onnx_path=None, device=None):
        from lele_tpu_torch.cli import load_aot_model, load_blob_into
        from lele_tpu_torch.compiler import compile_model
        from lele_tpu_torch.compiler.weights import load_weights
        from lele_tpu_torch.runtime import enable_cache
        from lele_tpu_torch.runtime.artifact import AotMismatch

        enable_cache()
        prefix = weights_prefix or str(_HERE / ({class_name!r} + "_weights"))
        self._cm = None
        self.aot_loaded = False
        if (_HERE / ({class_name!r} + ".xc")).exists():
            try:  # the saved program: no trace, no kernel build (cold start)
                self._cm = load_aot_model(_HERE / {class_name!r}, prefix, device)
                self.aot_loaded = True
            except AotMismatch:
                pass  # made for another torch, CUDA, card or source: trace
        if self._cm is None:
            onnx_path = onnx_path or str(_HERE / {onnx_name!r})
            self._cm = compile_model(onnx_path, input_shapes=self.INPUT_SHAPES,
                                     strict=self.STRICT, device=device,
                                     precision=self.PRECISION)
            load_blob_into(self._cm, load_weights(prefix))
        self._cm.compile()

    def forward(self, *args, **kwargs):
        return self._cm.run_np(*args, **kwargs)

    __call__ = forward
'''


def load_blob_into(cm, blob: dict[str, torch.Tensor]) -> None:
    """Copy each blob tensor into the compiled model's param of its name, in
    place. Raises ValueError unless the blob holds exactly the params'
    names, shapes and dtypes."""
    params = cm.params
    missing = sorted(set(params) - set(blob))
    extra = sorted(set(blob) - set(params))
    if missing or extra:
        raise ValueError(f"weights blob does not match the compiled model: missing "
                         f"{missing[:8]}{'...' if len(missing) > 8 else ''}, unexpected "
                         f"{extra[:8]}{'...' if len(extra) > 8 else ''}")
    for name, p in params.items():
        t = blob[name]
        if tuple(t.shape) != tuple(p.shape) or t.dtype != p.dtype:
            raise ValueError(f"weights blob entry {name!r} is {t.dtype} {tuple(t.shape)}; "
                             f"the compiled model's param is {p.dtype} {tuple(p.shape)}")
    with torch.inference_mode():
        for name, p in params.items():
            p.copy_(blob[name])


def load_aot_model(path_prefix, weights_prefix, device=None):
    """The compiled model of `<path_prefix>.xc/` on the blob's params, built
    without the graph (CompiledModel.from_aot); raises
    runtime.artifact.AotMismatch where the bundle was made for another
    torch, CUDA, card, kernel source or device than `device`'s (the card by
    default)."""
    from . import default_device
    from .runtime.artifact import AotMismatch, check_aot_bundle, load_flat
    from .runtime.engine import CompiledModel

    manifest = check_aot_bundle(path_prefix)
    want = torch.device(device) if device is not None else default_device()
    if (manifest["device"] == "cpu") != (want.type == "cpu"):
        raise AotMismatch(f"{path_prefix}.xc runs on {manifest['device']}, not on {want}")
    return CompiledModel.from_aot(path_prefix, load_flat(weights_prefix, want), manifest)


def compile_to_dir(
    onnx_path: str,
    out_dir: str,
    class_name: str | None = None,
    input_shapes: dict | None = None,
    dim_values: dict | None = None,
    aot: bool = False,
    xc: bool = False,
    strict: bool = False,
    quantize_weights: bool = False,
    device: torch.device | str | None = None,
    precision: str | None = None,
) -> Path:
    """Compile `onnx_path` on `device` (the card by default) at `precision`
    (None: config.matmul_precision) and write the wrapper, the blob and a
    copy of the graph to `out_dir`, with `aot` the program (<Class>.pt2)
    and with `xc` the AOT bundle (<Class>.xc/); → the wrapper's path."""
    from .compiler import compile_model
    from .compiler.weights import save_weights
    from .config import config
    from .onnx import OnnxModel

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    model = OnnxModel.load(onnx_path)
    cls = sanitize_name(class_name or Path(onnx_path).stem.title().replace("_", ""))
    # burn the build's numerics into the artifact: the wrapper runs at the
    # precision this build validated
    precision = precision or config.matmul_precision
    cm = compile_model(model, input_shapes=input_shapes, dim_values=dim_values,
                       strict=strict, device=device, precision=precision)
    _print_stats(cm)
    save_weights(out / f"{cls}_weights", cm.params, quantize=quantize_weights)
    onnx_name = Path(onnx_path).name
    dest_onnx = out / onnx_name
    if Path(onnx_path).resolve() != dest_onnx.resolve():
        shutil.copyfile(onnx_path, dest_onnx)
    (out / f"{cls}.py").write_text(_WRAPPER_TEMPLATE.format(
        class_name=cls,
        input_shapes={n: list(cm.input_specs[n][0]) for n in cm.input_order},
        output_names=list(cm.output_names),
        onnx_name=onnx_name,
        precision=precision,
        strict=strict,
    ))
    if aot:
        from .compiler.aot import export_model

        export_model(cm, out / f"{cls}.pt2")
    if xc:
        cm.save_aot(out / cls)
    return out / f"{cls}.py"


def _parse_kv_shapes(items: list[str]) -> dict:
    out = {}
    for item in items:
        name, _, dims = item.partition("=")
        out[name] = tuple(int(d) for d in dims.split(",") if d)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="lele_tpu_torch.cli",
        description="Compile an ONNX model to an artifact of the PyTorch/CUDA port "
        "(lele_gen analog)",
    )
    ap.add_argument("model", help="path to .onnx file")
    ap.add_argument("out_dir", help="output directory")
    ap.add_argument("class_name", nargs="?", default=None)
    ap.add_argument("--shape", action="append", default=[], metavar="NAME=D0,D1,...",
                    help="pin an input's shape (repeatable)")
    ap.add_argument("--dim", action="append", default=[], metavar="PARAM=N",
                    help="pin a named dynamic dim (repeatable)")
    ap.add_argument("--aot", action="store_true",
                    help="also export the model's torch.export program (<Class>.pt2)")
    ap.add_argument("--xc", action="store_true",
                    help="also save the AOT bundle (<Class>.xc/: the program and its "
                         "kernel libraries; cold start with no trace and no build, "
                         "pinned to the compiling torch, CUDA and card)")
    ap.add_argument("--strict", action="store_true",
                    help="fail on unsupported ops instead of warning")
    ap.add_argument("--quantize-weights", action="store_true",
                    help="store rank-2+ float weights as int8 + scale "
                         "(~4x smaller artifact)")
    ap.add_argument("--quantize-dynamic", action="store_true",
                    help="rewrite float MatMul/Gemm (initializer weights) "
                         "to DynamicQuantizeLinear+MatMulInteger int8 form "
                         "before compiling (onnxruntime quantize_dynamic "
                         "analog); also writes the quantized .onnx")
    ap.add_argument("--quantize-static", action="append", default=[],
                    metavar="CALIB.npz",
                    help="QDQ-format static quantization (onnxruntime "
                         "quantize_static analog), calibrated on the device: "
                         "each npz holds one calibration batch keyed by input "
                         "name (repeatable); writes the quantized .onnx")
    ap.add_argument("--precision", choices=["default", "high", "highest"], default=None,
                    help="matmul precision: 'highest' = IEEE f32 products (the default), "
                         "'high' = TF32, 'default' = the fastest the card has for f32 "
                         "operands (TF32: torch's CUDA backend has no bf16 pass)")
    ap.add_argument("--device", default=None,
                    help="torch device to compile on (default: the card)")
    args = ap.parse_args(argv)

    if args.precision:
        from .config import config

        config.matmul_precision = args.precision
    dims = {}
    for item in args.dim:
        k, _, v = item.partition("=")
        dims[k] = int(v)
    if args.quantize_dynamic and args.quantize_static:
        print("error: --quantize-dynamic and --quantize-static are "
              "mutually exclusive", file=sys.stderr)
        return 1
    model_path = args.model
    if args.quantize_dynamic or args.quantize_static:
        stem = os.path.splitext(os.path.basename(args.model))[0]
        os.makedirs(args.out_dir, exist_ok=True)
        try:
            if args.quantize_dynamic:
                from .onnx.quantize import quantize_dynamic_file

                qpath = os.path.join(args.out_dir, f"{stem}.int8.onnx")
                quantize_dynamic_file(args.model, qpath)
            else:
                from .onnx.quantize import quantize_static

                batches = []
                for npz in args.quantize_static:
                    with np.load(npz) as z:
                        batches.append({k: z[k] for k in z.files})
                qpath = os.path.join(args.out_dir, f"{stem}.qdq.onnx")
                with open(args.model, "rb") as f:
                    qdata = quantize_static(
                        f.read(), batches,
                        base_dir=os.path.dirname(os.path.abspath(args.model)),
                        device=args.device)
                with open(qpath, "wb") as f:
                    f.write(qdata)
        except FileNotFoundError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        print(f"wrote {qpath}")
        model_path = qpath
    try:
        path = compile_to_dir(
            model_path, args.out_dir, args.class_name,
            input_shapes=_parse_kv_shapes(args.shape) or None,
            dim_values=dims or None,
            aot=args.aot,
            xc=args.xc,
            strict=args.strict,
            quantize_weights=args.quantize_weights,
            device=args.device,
        )
    except FileNotFoundError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    print(f"wrote {path}")
    return 0


def _print_stats(cm):
    s = getattr(cm, "stats", {})
    if s:
        print(
            f"compiled {s['n_nodes']} nodes ({s['n_folded']} folded at trace "
            f"time), {s['n_params']} params, "
            f"{s['param_bytes'] / 1e6:.1f} MB weights"
        )


if __name__ == "__main__":
    sys.exit(main())
