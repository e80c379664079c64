"""The port's AOT layer against the JAX package's (compiler/aot.py,
runtime/artifact.py's bundle, CompiledModel.lower/save_aot/use_aot, the
CLI's --aot and --xc) and the registered kernel ops (kernels/_library.py).

- JAX's tests/test_aot.py:30: an exported toy graph reloaded and called
  with JAX's signature, held to JAX's `load_exported` at 1e-5;
- `.pt2` round trips of the SenseVoice and YOLO fixtures, a MatMulNBits
  graph and a GRU graph: the compiled model's bits, and the program holding
  the `lele_tpu_torch::` op of each kernel its tape reaches (recorded by a
  dispatch mode while the tape replays);
- new params at load change the output (the program carries no weights);
- a loaded program (`.pt2`, `.xc`, `from_aot`, `load_aot_bundle`) runs at
  the precision saved with it, whatever torch's flags are at the call;
- a dynamic If and a program over a mesh are refused, naming the cause;
- JAX's tests/test_artifact.py:93 and tests/test_build_cli.py:97 in fresh
  subprocesses (the bundle saved in one, loaded in another; the wrapper
  takes the bundle there, `aot_loaded`, and builds no kernel);
- `torch.library.opcheck` on each of the 12 ops on the CPU;
- the build cache (runtime/cache.enable_cache) and the library hand-off.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from lele_tpu_torch import kernels as K
from lele_tpu_torch.compiler import compile_model
from lele_tpu_torch.compiler.aot import export_model, load_exported, program_ops
from lele_tpu_torch.kernels import _build
from lele_tpu_torch.onnx import builder as ob
from lele_tpu_torch.runtime.artifact import AotMismatch
from lele_tpu_torch.runtime.engine import CompiledModel

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "fixtures"


def _toy():
    rng = np.random.default_rng(21)
    w = rng.standard_normal((8, 300)).astype(np.float32)
    b = rng.standard_normal((300,)).astype(np.float32)
    bs = ob.build_model_bytes(
        [ob.node("MatMul", ["x", "w"], ["mm"]), ob.node("Add", ["mm", "b"], ["ab"]),
         ob.node("Relu", ["ab"], ["y"])],
        inputs=[ob.value_info("x", 1, [3, 8])], outputs=[ob.value_info("y", 1, [3, 300])],
        initializers=[ob.tensor_from_array(w, "w"), ob.tensor_from_array(b, "b")])
    return bs, w, b, rng.standard_normal((3, 8)).astype(np.float32)


def test_aot_roundtrip(tmp_path):
    """tests/test_aot.py:30 on the port, held to JAX's reloaded export."""
    from lele_tpu.compiler import compile_model as j_compile
    from lele_tpu.compiler.aot import export_model as j_export
    from lele_tpu.compiler.aot import load_exported as j_load
    from lele_tpu.onnx import OnnxModel as JOnnxModel

    bs, w, b, x = _toy()
    cm = compile_model(bs, device="cpu")
    (want,) = cm.run_np(x)
    path = export_model(cm, tmp_path / "m")
    assert path.name == "m.pt2" and path.stat().st_size > 0
    outs = load_exported(path)(cm.params, (), (torch.from_numpy(x),))
    got = outs[0].numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, np.maximum(x @ w + b, 0), atol=1e-4)
    jcm = j_compile(JOnnxModel.from_bytes(bs))
    j_export(jcm, tmp_path / "m.shlo")
    import jax.numpy as jnp

    (jgot,) = j_load(tmp_path / "m.shlo")(jcm.params, (), (jnp.asarray(x),))
    np.testing.assert_allclose(got, np.asarray(jgot), rtol=1e-5, atol=1e-5)


class _OpLog(TorchDispatchMode):
    """The registered kernel ops called while it is on."""

    def __init__(self):
        super().__init__()
        self.ops = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        ns, _, name = func.name().partition("::")
        if ns == "lele_tpu_torch":
            self.ops.add(name.split(".")[0])
        return func(*args, **(kwargs or {}))


def _sensevoice():
    rng = np.random.default_rng(0)
    feeds = {"speech": rng.standard_normal((1, 36, 560)).astype(np.float32),
             "speech_lengths": np.array([30]), "language": np.array([0], np.int32),
             "textnorm": np.array([1], np.int32)}
    return compile_model(str(FIXTURES / "sensevoice.onnx"), dim_values={"T": 36},
                         device="cpu"), feeds, {"sanm_stack_dql"}


def _yolo():
    x = np.load(FIXTURES / "yolo26_input.npy").astype(np.float32)
    cm = compile_model(str(FIXTURES / "yolo26.onnx"), device="cpu",
                       input_shapes={"images": x.shape})
    return cm, {cm.input_order[0]: x}, set()


def _nbits():
    from test_torch_port_nbits import _graph

    bs, a = _graph(np.random.default_rng(3))
    return compile_model(bs, device="cpu"), {"a": a}, {"w4_gemm"}


def _gru():
    from test_torch_port_gru import _gru_graph

    bs, feeds = _gru_graph(S=6, B=2, I=4, H=5, lbr=1)
    return compile_model(bs, device="cpu"), feeds, {"gru_seq"}


ROUND_TRIPS = {"sensevoice": _sensevoice, "yolo26": _yolo, "matmul_nbits": _nbits,
               "gru": _gru}


def _ordered(cm, feeds):
    return [torch.as_tensor(np.asarray(feeds[n])).to(cm._dtypes[n]) for n in cm.input_order]


@pytest.mark.parametrize("case", list(ROUND_TRIPS))
def test_pt2_round_trip_gives_the_compiled_bits(case, tmp_path):
    cm, feeds, kernels = ROUND_TRIPS[case]()
    log = _OpLog()
    with log:
        want = cm.run_np(**feeds)
    assert log.ops == kernels, log.ops
    path = export_model(cm, tmp_path / case)
    call = load_exported(path)
    assert set(program_ops(call.program)) == kernels
    got = call(cm.params, (), _ordered(cm, feeds))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.from_numpy(w).dtype
        np.testing.assert_array_equal(g.numpy(), w)


def test_new_params_at_load_change_the_output(tmp_path):
    cm, feeds, _ = _sensevoice()
    want = cm.run_np(**feeds)[0]
    call = load_exported(export_model(cm, tmp_path / "sv"))
    halved = {k: v * 0.5 if v.is_floating_point() else v for k, v in cm.params.items()}
    got = call(halved, (), _ordered(cm, feeds))[0].numpy()
    assert not np.array_equal(got, want)
    # the same change through the traced tape gives the program's bits
    with torch.inference_mode():
        for v in cm.params.values():
            if v.is_floating_point():
                v.mul_(0.5)
    np.testing.assert_array_equal(cm.run_np(**feeds)[0], got)


def test_lower_refuses_a_dynamic_if():
    cm = compile_model(str(FIXTURES / "silero.onnx"), device="cpu")  # sr an input
    assert not cm.stats["capturable"]
    with pytest.raises(ValueError, match=r"reads the host.*tape step \d+: If"):
        cm.lower()


def test_lower_refuses_a_program_over_a_mesh(tmp_path):
    from lele_tpu_torch.parallel import init_distributed, make_mesh

    mw = np.arange(12, dtype=np.float32).reshape(3, 4)
    mbs = ob.build_model_bytes(
        [ob.node("MatMul", ["x", "w"], ["y"])], inputs=[ob.value_info("x", 1, [2, 3])],
        outputs=[ob.value_info("y", 1, [2, 4])], initializers=[ob.tensor_from_array(mw, "w")])
    init_distributed(0, 1, f"file://{tmp_path}/rv", "cpu")
    try:
        cm = compile_model(mbs, mesh=make_mesh(1), param_rules=lambda n, s: (None, "model"))
        np.testing.assert_array_equal(cm.run_np(np.ones((2, 3), np.float32))[0],
                                      np.ones((2, 3)) @ mw)
        with pytest.raises(ValueError, match="over a mesh"):
            cm.lower()
    finally:
        torch.distributed.destroy_process_group()


def _run(code: str, tmp_path, env=None):
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=300, env={**os.environ, **(env or {})})
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout


def test_aot_bundle_fresh_process(tmp_path):
    """tests/test_artifact.py:93: a bundle of a function of (params, x)
    saved in one fresh process and loaded (program and params) in another;
    the output is JAX's tanh(x @ w) on the same weights."""
    import jax.numpy as jnp

    head = f"import sys; sys.path.insert(0, {str(REPO)!r})\nimport numpy as np, torch\n"
    _run(head + f"""
from lele_tpu_torch.runtime.artifact import export_program, save_aot_bundle
params = {{"w": torch.from_numpy(np.random.default_rng(1).standard_normal((16, 16))
                                   .astype(np.float32))}}
x = torch.from_numpy(np.random.default_rng(2).standard_normal((4, 16)).astype(np.float32))
prog = export_program(lambda p, x: torch.tanh(x @ p["w"]), params, x)
save_aot_bundle({str(tmp_path / "m")!r}, prog, params)
""", tmp_path)
    out = _run(head + f"""
from lele_tpu_torch.kernels import _build
from lele_tpu_torch.runtime.artifact import load_aot_bundle
fn, params = load_aot_bundle({str(tmp_path / "m")!r})
x = torch.from_numpy(np.random.default_rng(2).standard_normal((4, 16)).astype(np.float32))
np.save({str(tmp_path / "y.npy")!r}, fn(params, x).numpy())
print("AOT_OK", _build.BUILT)
""", tmp_path)
    assert "AOT_OK []" in out
    w = np.random.default_rng(1).standard_normal((16, 16)).astype(np.float32)
    x = np.random.default_rng(2).standard_normal((4, 16)).astype(np.float32)
    np.testing.assert_allclose(np.load(tmp_path / "y.npy"),
                               np.asarray(jnp.tanh(jnp.asarray(x) @ jnp.asarray(w))),
                               rtol=1e-6, atol=1e-6)


def _write_toy_onnx(path: Path):
    rng = np.random.default_rng(0)
    w = rng.standard_normal((8, 300)).astype(np.float32)
    path.write_bytes(ob.build_model_bytes(
        [ob.node("MatMul", ["x", "w"], ["mm"]), ob.node("Relu", ["mm"], ["y"])],
        inputs=[ob.value_info("x", 1, [2, 8])], outputs=[ob.value_info("y", 1, [2, 300])],
        initializers=[ob.tensor_from_array(w, "w")]))
    return w


def test_cli_xc_bundle_wrapper(tmp_path):
    """tests/test_build_cli.py:97: --xc writes the bundle and the generated
    wrapper prefers it: in a fresh process it reports `aot_loaded`, builds
    no kernel and gives the traced model's bits (and JAX's formula at
    1e-4); with a manifest made for another torch it traces instead."""
    from lele_tpu_torch.cli import compile_to_dir

    onnx_path = tmp_path / "xc_model.onnx"
    w = _write_toy_onnx(onnx_path)
    out = tmp_path / "gen_xc"
    compile_to_dir(str(onnx_path), str(out), "PortXcModel", aot=True, xc=True, device="cpu")
    assert (out / "PortXcModel.xc" / "program.pt2").exists()
    assert (out / "PortXcModel.pt2").exists()
    manifest = json.loads((out / "PortXcModel.xc" / "manifest.json").read_text())
    assert manifest["device"] == "cpu" and manifest["libraries"] == {}
    assert manifest["torch"] == torch.__version__
    x = np.random.default_rng(3).standard_normal((2, 8)).astype(np.float32)
    (want,) = compile_model(str(onnx_path), device="cpu").run_np(x)
    code = f"""
import sys; sys.path.insert(0, {str(REPO)!r}); sys.path.insert(0, {str(out)!r})
import numpy as np
from PortXcModel import PortXcModel
from lele_tpu_torch.kernels import _build
m = PortXcModel(device="cpu")
x = np.random.default_rng(3).standard_normal((2, 8)).astype(np.float32)
(y,) = m.forward(x)
np.save({str(out / "sub_y.npy")!r}, y)
print("XC", m.aot_loaded, _build.BUILT, m._cm.stats.get("aot"))
"""
    stdout = _run(code, tmp_path, env={"LELE_CACHE_DIR": str(tmp_path / "cache")})
    assert "XC True [] True" in stdout, stdout
    assert (tmp_path / "cache").is_dir()
    y = np.load(out / "sub_y.npy")
    np.testing.assert_array_equal(y, want)
    np.testing.assert_allclose(y, np.maximum(x @ w, 0), atol=1e-4)
    manifest["torch"] = "0.0.0"
    (out / "PortXcModel.xc" / "manifest.json").write_text(json.dumps(manifest))
    stdout = _run(code, tmp_path)
    assert "XC False" in stdout, stdout
    np.testing.assert_array_equal(np.load(out / "sub_y.npy"), want)


def test_use_aot_and_from_aot_give_the_traced_bits(tmp_path):
    cm, feeds, _ = _sensevoice()
    want = cm.run_np(**feeds)
    cm.save_aot(tmp_path / "sv")
    built = CompiledModel.from_aot(tmp_path / "sv", dict(cm.params))
    assert built.input_order == cm.input_order and built.output_names == cm.output_names
    for g, w in zip(built.run_np(**feeds), want):
        np.testing.assert_array_equal(g, w)
    cm.use_aot(tmp_path / "sv")
    assert cm.stats["aot"] and cm.lower() is cm._tape.program
    for g, w in zip(cm.run_np(**feeds), want):
        np.testing.assert_array_equal(g, w)
    other, _, _ = _gru()
    with pytest.raises(AotMismatch, match="model differs"):
        other.use_aot(tmp_path / "sv")
    with pytest.raises(ValueError, match="params"):
        CompiledModel.from_aot(tmp_path / "sv", {"w": torch.zeros(1)})


def _conv_matmul():
    rng = np.random.default_rng(23)
    w = (rng.standard_normal((16, 8, 3, 3)) * 0.2).astype(np.float32)
    m = (rng.standard_normal((12, 10)) * 0.3).astype(np.float32)
    bs = ob.build_model_bytes(
        [ob.node("Conv", ["x", "w"], ["c"], pads=[1, 1, 1, 1]), ob.node("MatMul", ["c", "m"], ["y"])],
        inputs=[ob.value_info("x", 1, [2, 8, 12, 12])],
        outputs=[ob.value_info("y", 1, [2, 16, 12, 10])],
        initializers=[ob.tensor_from_array(w, "w"), ob.tensor_from_array(m, "m")])
    return bs, rng.standard_normal((2, 8, 12, 12)).astype(np.float32)


class _FlagLog(TorchDispatchMode):
    """torch's (cuBLAS, cuDNN) TF32 flags at each op called while it is on."""

    def __init__(self):
        super().__init__()
        self.seen = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.seen.add((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))
        return func(*args, **(kwargs or {}))


def _flags():
    return torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32


@pytest.mark.parametrize("route", ["pt2", "xc_bundle", "from_aot", "exported_fn_bundle"])
@pytest.mark.parametrize("precision", ["highest", "high"])
def test_a_loaded_program_runs_at_its_saved_precision(route, precision, tmp_path):
    """A program does not hold its precision (its products read torch's TF32
    flags when they run), so it is saved beside it and every loaded call
    runs at it, whatever torch's flags and config.matmul_precision are
    then; the output is JAX's at that precision."""
    from lele_tpu.compiler import compile_model as j_compile
    from lele_tpu.onnx import OnnxModel as JOnnxModel
    from lele_tpu_torch.config import PRECISION_FLAGS, config, precision_scope
    from lele_tpu_torch.runtime.artifact import (export_program, load_aot_bundle,
                                                 save_aot_bundle)

    bs, x = _conv_matmul()
    other = "high" if precision == "highest" else "highest"
    xt = torch.from_numpy(x)
    p0, flags0 = config.matmul_precision, _flags()
    try:
        # a model that pins none runs at the process's precision at its export
        config.matmul_precision = precision
        cm = compile_model(bs, device="cpu", precision=None if route == "from_aot" else precision)
        want = cm.run_np(x)
        if route == "pt2":
            call = load_exported(export_model(cm, tmp_path / "m"))
            run = lambda: call(cm.params, (), (xt,))  # noqa: E731
        elif route == "xc_bundle":
            cm.save_aot(tmp_path / "m")
            fn, _ = load_aot_bundle(tmp_path / "m", params=False)
            run = lambda: fn(dict(cm.params), (), (xt,))  # noqa: E731
        elif route == "from_aot":
            cm.save_aot(tmp_path / "m")
            built = CompiledModel.from_aot(tmp_path / "m", dict(cm.params))
            assert built.precision == precision
            inputs = [built._prep("x", x)]
            run = lambda: built._walk(inputs)  # noqa: E731
        else:
            params = {"w": cm.params["w"], "m": cm.params["m"]}

            def fn(p, v):
                y = torch.nn.functional.conv2d(v, p["w"], padding=1)
                return y @ p["m"]

            with precision_scope(precision):
                prog = export_program(fn, params, xt)
            save_aot_bundle(tmp_path / "m", prog, params)
            call, loaded = load_aot_bundle(tmp_path / "m")
            run = lambda: [call(loaded, xt)]  # noqa: E731
        manifest = tmp_path / "m.xc" / "manifest.json"
        if manifest.exists():
            assert json.loads(manifest.read_text())["precision"] == precision
        config.matmul_precision = other
        sentinel = tuple(not f for f in PRECISION_FLAGS[precision])
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = sentinel
        log = _FlagLog()
        with log:
            got = run()
        assert log.seen == {PRECISION_FLAGS[precision]}
        assert _flags() == sentinel
    finally:
        config.matmul_precision = p0
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags0
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    (jwant,) = j_compile(JOnnxModel.from_bytes(bs), precision=precision).run_np(x)
    np.testing.assert_allclose(want[0], np.asarray(jwant), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", sorted(K.KERNEL_WRAPPERS))
def test_registered_op_passes_opcheck(name):
    op = getattr(torch.ops.lele_tpu_torch, name).default
    args = K.op_samples("cpu")[name]
    res = torch.library.opcheck(op, args)
    assert set(res.values()) == {"SUCCESS"}, res


def test_every_wrapper_is_a_registered_op():
    assert sorted(K.KERNEL_WRAPPERS) == sorted(K.OP_STEMS)
    for name in K.KERNEL_WRAPPERS:
        for key in ("CPU", "CUDA"):
            assert torch._C._dispatch_has_kernel_for_dispatch_key(f"lele_tpu_torch::{name}",
                                                                  key), (name, key)
    assert set(K.OP_STEMS.values()) == set(_build.sources())


def test_enable_cache_points_the_build_dir(tmp_path, monkeypatch):
    from lele_tpu_torch.runtime import enable_cache

    before = _build.BUILD_DIR
    try:
        assert enable_cache(tmp_path / "a") == str(tmp_path / "a")
        assert _build.BUILD_DIR == tmp_path / "a" and (tmp_path / "a").is_dir()
        monkeypatch.setenv("LELE_CACHE_DIR", str(tmp_path / "b"))
        assert enable_cache() == str(tmp_path / "b") and _build.BUILD_DIR == tmp_path / "b"
        monkeypatch.delenv("LELE_CACHE_DIR")
        assert enable_cache() == str(_build.DEFAULT_BUILD_DIR)
        assert _build.library_path("w8_gemm").parent == _build.DEFAULT_BUILD_DIR
    finally:
        _build.BUILD_DIR = before


def test_provide_takes_only_this_checkouts_libraries(tmp_path):
    stale = tmp_path / "libw8_gemm-000000000000.so"
    stale.write_bytes(b"")
    with pytest.raises(ValueError, match="not a library of this checkout"):
        _build.provide({"w8_gemm": stale})
    assert _build.library_path("w8_gemm") == _build.BUILD_DIR / _build.lib_name("w8_gemm")
