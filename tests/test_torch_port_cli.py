"""The port's CLI (lele_tpu_torch/cli.py), generated wrapper and build tool
(lele_tpu_torch/build_tool.py) against the JAX package's: JAX's
tests/test_build_cli.py cases run on the port (its `--xc` case is in
tests/test_torch_port_aot.py), every wrapper held to the port's `compile_model` of the same
graph bit for bit and, for float graphs, to JAX's wrapper within 1e-5 of
max(1, max|ref|); the quantized graphs the CLI writes are JAX's bytes
(`--quantize-dynamic`) or JAX's graph node for node (`--quantize-static`,
whose calibrated scales agree within 1e-5).

Generated wrappers load by file spec under a module name of their own, so
`sys.modules` never hands back a wrapper of the JAX package's tests.
"""

import importlib.util
import io
import json
import subprocess
import sys
from contextlib import redirect_stderr
from pathlib import Path

import numpy as np
import pytest
import torch

from lele_tpu_torch.cli import compile_to_dir, load_blob_into, main, sanitize_name
from lele_tpu_torch.compiler import compile_model
from lele_tpu_torch.compiler.weights import load_weights, save_weights
from lele_tpu_torch.onnx import builder as ob
from lele_tpu_torch.onnx import schema

REPO = Path(__file__).resolve().parents[1]
JAX_REL = 1e-5


def _write_toy_onnx(path: Path):
    rng = np.random.default_rng(0)
    w = rng.standard_normal((8, 300)).astype(np.float32)
    path.write_bytes(ob.build_model_bytes(
        [ob.node("MatMul", ["x", "w"], ["mm"]), ob.node("Relu", ["mm"], ["y"])],
        inputs=[ob.value_info("x", 1, [2, 8])],
        outputs=[ob.value_info("y", 1, [2, 300])],
        initializers=[ob.tensor_from_array(w, "w")]))
    return w


def _load(wrapper: Path):
    spec = importlib.util.spec_from_file_location(f"port_wrapper_{wrapper.stem}", wrapper)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return getattr(mod, wrapper.stem)


def _port_ref(onnx_path, x, **kw):
    """The port's compile_model of the same file: the wrapper's oracle."""
    return compile_model(str(onnx_path), device="cpu", **kw).run_np(x)


def _jax_wrapper(onnx_path, out, cls, x, **kw):
    from lele_tpu.cli import compile_to_dir as j_compile_to_dir

    with redirect_stderr(io.StringIO()):
        j_compile_to_dir(str(onnx_path), str(out), cls, **kw)
        return _load(out / f"{cls}.py")().forward(x)


def _hold_jax(got, want):
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= JAX_REL * max(1.0, float(np.abs(w).max()))


def _same_outputs(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


# -- JAX's CLI cases ------------------------------------------------------------


def test_cli_compile_and_generated_wrapper(tmp_path):
    onnx_path = tmp_path / "toy_model.onnx"
    w = _write_toy_onnx(onnx_path)
    out = tmp_path / "gen"
    wrapper = compile_to_dir(str(onnx_path), str(out), "PortToyModel", device="cpu")
    assert wrapper.name == "PortToyModel.py"
    assert (out / "PortToyModel_weights.bin").exists()
    assert (out / "PortToyModel_weights.json").exists()
    assert (out / "toy_model.onnx").read_bytes() == onnx_path.read_bytes()
    cls = _load(wrapper)
    assert cls.INPUT_SHAPES == {"x": [2, 8]} and cls.OUTPUT_NAMES == ["y"]
    assert cls.STRICT is False
    model = cls(device="cpu")
    x = np.random.default_rng(2).standard_normal((2, 8)).astype(np.float32)
    got = model.forward(x)
    np.testing.assert_allclose(got[0], np.maximum(x @ w, 0), atol=1e-4)
    _same_outputs(got, _port_ref(onnx_path, x))
    _hold_jax(got, _jax_wrapper(onnx_path, tmp_path / "jgen", "JaxRefToyModel", x))


def test_cli_refuses_xc_aot_and_lower_precision(tmp_path, capsys):
    """What the CLI still refuses of these flags: a precision JAX's CLI does
    not know, as argparse refuses it there (exit code 2), with nothing
    written. (The name dates from when the port's CLI refused --xc, --aot
    and every precision below "highest"; it takes them now:
    test_cli_takes_xc_aot_and_each_precision.)"""
    from lele_tpu.cli import main as j_main

    onnx_path = tmp_path / "xc_model.onnx"
    _write_toy_onnx(onnx_path)
    out = tmp_path / "gen_xc"
    for argv, m in ((["--precision", "low"], main), (["--precision", "low"], j_main)):
        with pytest.raises(SystemExit) as e:
            m([str(onnx_path), str(out), *argv])
        assert e.value.code == 2
    assert not out.exists()


def test_cli_takes_xc_aot_and_each_precision(tmp_path):
    """JAX's --xc case: --xc, --aot and every --precision of JAX's CLI are
    taken (exit code 0; the program, the bundle and the wrapper's PRECISION
    written)."""
    from lele_tpu_torch.config import config

    onnx_path = tmp_path / "xc_model.onnx"
    _write_toy_onnx(onnx_path)
    out = tmp_path / "gen_xc"
    try:
        for flags, prec in ((["--xc"], "highest"), (["--aot"], "highest"),
                            (["--precision", "default"], "default"),
                            (["--precision", "high"], "high")):
            config.matmul_precision = "highest"
            assert main([str(onnx_path), str(out), "PortXc", "--device", "cpu", *flags]) == 0
            assert _load(out / "PortXc.py").PRECISION == prec
    finally:
        config.matmul_precision = "highest"
    assert (out / "PortXc.pt2").exists() and (out / "PortXc.xc" / "program.pt2").exists()


def test_cli_main_errors(tmp_path):
    from lele_tpu.cli import main as j_main

    assert main(["/nonexistent/model.onnx", str(tmp_path), "--device", "cpu"]) == 2
    assert j_main(["/nonexistent/model.onnx", str(tmp_path)]) == 2
    bad = tmp_path / "dyn.onnx"
    bad.write_bytes(ob.build_model_bytes([ob.node("Relu", ["x"], ["y"])],
                                         [ob.value_info("x", 1, ["N", 4])],
                                         [ob.value_info("y", 1, ["N", 4])]))
    assert main([str(bad), str(tmp_path / "g"), "--device", "cpu"]) == 1  # unpinned dim
    assert main([str(bad), str(tmp_path / "g"), "PortDyn", "--device", "cpu",
                 "--dim", "N=3"]) == 0
    assert _load(tmp_path / "g" / "PortDyn.py").INPUT_SHAPES == {"x": [3, 4]}
    assert main([str(bad), str(tmp_path / "g"), "PortDyn2", "--device", "cpu",
                 "--shape", "x=5,4"]) == 0
    assert _load(tmp_path / "g" / "PortDyn2.py").INPUT_SHAPES == {"x": [5, 4]}


def test_cli_quantize_dynamic_flag(tmp_path):
    """--quantize-dynamic writes JAX's quantized bytes next to the artifact,
    and the wrapper gives the port's compile of them bit for bit, within
    the JAX test's 0.15 of relu(x @ w) (u8 activation noise)."""
    from lele_tpu.onnx.quantize import quantize_dynamic_file as j_quantize_file

    onnx_path = tmp_path / "toy_model.onnx"
    w = _write_toy_onnx(onnx_path)
    out = tmp_path / "gen"
    assert main([str(onnx_path), str(out), "PortToyQ", "--quantize-dynamic",
                 "--device", "cpu"]) == 0
    qpath = out / "toy_model.int8.onnx"
    j_quantize_file(str(onnx_path), str(tmp_path / "j.int8.onnx"))
    assert qpath.read_bytes() == (tmp_path / "j.int8.onnx").read_bytes()
    ops = [n.op_type for n in schema.decode_model(qpath.read_bytes()).graph.node]
    assert "MatMulInteger" in ops and "MatMul" not in ops
    x = np.random.default_rng(5).standard_normal((2, 8)).astype(np.float32)
    got = _load(out / "PortToyQ.py")(device="cpu").forward(x)
    _same_outputs(got, _port_ref(qpath, x))
    np.testing.assert_allclose(got[0], np.maximum(x @ w, 0), atol=0.15)


def test_cli_quantize_static_flag(tmp_path):
    """--quantize-static CALIB.npz: the QDQ graph JAX's quantize_static makes
    of the same calibration, node for node; the wrapper gives the port's
    compile of it bit for bit and relu(x @ w) within the JAX test's mean
    error 0.1; the two quantize flags exclude each other (exit 1)."""
    sys.path.insert(0, str(REPO / "tests"))
    from test_torch_port_quantize_static import _same_qdq_graph

    from lele_tpu.onnx.quantize import quantize_static as j_quantize_static

    onnx_path = tmp_path / "toy_model.onnx"
    w = _write_toy_onnx(onnx_path)
    rng = np.random.default_rng(11)
    calib = tmp_path / "calib.npz"
    xc = rng.standard_normal((2, 8)).astype(np.float32)
    np.savez(calib, x=xc)
    out = tmp_path / "gen"
    assert main([str(onnx_path), str(out), "PortToyS", "--quantize-static", str(calib),
                 "--device", "cpu"]) == 0
    qpath = out / "toy_model.qdq.onnx"
    ops = [n.op_type for n in schema.decode_model(qpath.read_bytes()).graph.node]
    assert "QuantizeLinear" in ops and "MatMul" in ops
    _same_qdq_graph(qpath.read_bytes(), j_quantize_static(onnx_path.read_bytes(), [{"x": xc}]))
    assert main([str(onnx_path), str(out), "PortToyS", "--quantize-static", str(calib),
                 "--quantize-dynamic", "--device", "cpu"]) == 1
    x = np.random.default_rng(12).standard_normal((2, 8)).astype(np.float32)
    got = _load(out / "PortToyS.py")(device="cpu").forward(x)
    _same_outputs(got, _port_ref(qpath, x))
    assert np.abs(got[0] - np.maximum(x @ w, 0)).mean() < 0.1


def test_cli_quantize_weights_flag(tmp_path):
    onnx_path = tmp_path / "m.onnx"
    w = _write_toy_onnx(onnx_path)
    compile_to_dir(str(onnx_path), str(tmp_path / "g"), "PortQ", quantize_weights=True,
                   device="cpu")
    man = json.loads((tmp_path / "g/PortQ_weights.json").read_text())
    assert any("dequant_scale" in e for e in man["tensors"].values())
    x = np.random.default_rng(2).standard_normal((2, 8)).astype(np.float32)
    (y,) = _load(tmp_path / "g" / "PortQ.py")(device="cpu").forward(x)
    np.testing.assert_allclose(y, np.maximum(x @ w, 0), atol=0.1)
    assert not np.array_equal(y, _port_ref(onnx_path, x)[0])  # the int8 weights took


def test_cli_sanitize_name():
    assert sanitize_name("yolo26n-seg") == "yolo26n_seg"
    assert sanitize_name("2fast") == "M_2fast"


# -- the wrapper's in-place load ----------------------------------------------------


def test_wrapper_loads_the_blob_in_place(tmp_path):
    """A blob with the weight doubled doubles the output (x @ 2w = 2 (x @ w)
    exactly): the wrapper copies the blob into the traced params."""
    onnx_path = tmp_path / "toy_model.onnx"
    w = _write_toy_onnx(onnx_path)
    out = tmp_path / "gen"
    compile_to_dir(str(onnx_path), str(out), "PortScaled", device="cpu")
    cls = _load(out / "PortScaled.py")
    x = np.random.default_rng(3).standard_normal((2, 8)).astype(np.float32)
    (y,) = cls(device="cpu").forward(x)
    prefix = out / "PortScaled_weights"
    blob = load_weights(prefix)
    assert list(blob) == ["w"] and np.array_equal(blob["w"].numpy(), w)
    save_weights(tmp_path / "doubled", {"w": blob["w"] * 2})
    (y2,) = cls(weights_prefix=str(tmp_path / "doubled"), device="cpu").forward(x)
    np.testing.assert_array_equal(y2, 2 * y)


def test_wrapper_refuses_a_blob_that_does_not_match(tmp_path):
    onnx_path = tmp_path / "toy_model.onnx"
    w = _write_toy_onnx(onnx_path)
    cm = compile_model(str(onnx_path), device="cpu")
    t = torch.from_numpy(w)
    for blob, msg in (({}, "missing"), ({"w": t, "extra": t}, "unexpected"),
                      ({"w": t[:4]}, "param is"), ({"w": t.double()}, "param is")):
        with pytest.raises(ValueError, match=msg):
            load_blob_into(cm, blob)
    save_weights(tmp_path / "bad", {"w": w[:, :10]})
    compile_to_dir(str(onnx_path), str(tmp_path / "g"), "PortBad", device="cpu")
    with pytest.raises(ValueError, match="'w' is torch.float32 \\(8, 10\\)"):
        _load(tmp_path / "g" / "PortBad.py")(weights_prefix=str(tmp_path / "bad"), device="cpu")


def test_wrapper_of_the_int8_sanm_graph(tmp_path):
    """The phase-38 graph at a small size: the blob holds the params the
    trace derived (the fused SAN-M stack, the DQL head's shifted weight and
    column sums), and the wrapper gives compile_model's outputs bit for bit."""
    from lele_tpu_torch.onnx.synth import build_sanm_int8_model

    p = tmp_path / "sanm.onnx"
    p.write_bytes(build_sanm_int8_model(L=2, d=64, h=2, ffn=96, vocab=40, int8_head=True))
    assert main([str(p), str(tmp_path / "g"), "PortSanm", "--dim", "T=16",
                 "--device", "cpu"]) == 0
    cm = compile_model(str(p), dim_values={"T": 16}, device="cpu")
    hits = cm.stats["pattern_hits"]
    assert hits["sanm_fused_layers"] == 2 and hits["dql_matmul_dataflow"] == 1
    blob = load_weights(tmp_path / "g" / "PortSanm_weights")
    assert list(blob) == list(cm.params)
    assert any("::sanm" in k for k in blob) and any("colsum" in k for k in blob)
    rng = np.random.default_rng(4)
    inputs = {"speech": rng.standard_normal((1, 16, 560)).astype(np.float32),
              "speech_lengths": np.array([14], np.int64), "language": np.array([3], np.int32),
              "textnorm": np.array([0], np.int32)}
    _same_outputs(_load(tmp_path / "g" / "PortSanm.py")(device="cpu").forward(**inputs),
                  cm.run_np(**inputs))


# -- the build tool (JAX's cases) -------------------------------------------------


def test_build_tool_quantize_dynamic(tmp_path):
    from lele_tpu_torch.build_tool import build_model

    onnx_path = tmp_path / "toy.onnx"
    w = _write_toy_onnx(onnx_path)
    (tmp_path / "model.toml").write_text(
        '[model]\nsource = "local"\npath = "toy.onnx"\n'
        '[codegen]\nclass_name = "PortToyDyn"\nquantize = "dynamic"\n')
    wrapper = build_model(tmp_path / "model.toml", tmp_path / "gen", device="cpu")
    assert wrapper.name == "PortToyDyn.py"
    qpath = tmp_path / "gen" / "toy.int8.onnx"
    ops = [n.op_type for n in schema.decode_model(qpath.read_bytes()).graph.node]
    assert "MatMulInteger" in ops and "MatMul" not in ops
    x = np.random.default_rng(9).standard_normal((2, 8)).astype(np.float32)
    got = _load(wrapper)(device="cpu").forward(x)
    _same_outputs(got, _port_ref(qpath, x))
    np.testing.assert_allclose(got[0], np.maximum(x @ w, 0), atol=0.15)


def test_build_tool_local_source(tmp_path):
    from lele_tpu_torch.build_tool import build_model

    _write_toy_onnx(tmp_path / "m.onnx")
    (tmp_path / "model.toml").write_text(
        '[model]\nsource = "local"\npath = "m.onnx"\n[codegen]\nclass_name = "PortLocalToy"\n')
    out = build_model(tmp_path / "model.toml", tmp_path / "gen", device="cpu")
    assert out.name == "PortLocalToy.py"
    assert "STUB" not in out.read_text()
    m1 = out.stat().st_mtime
    out2 = build_model(tmp_path / "model.toml", tmp_path / "gen", device="cpu")
    assert out2.stat().st_mtime == m1  # staleness check: not regenerated


def test_build_tool_stub_on_download_failure(tmp_path, monkeypatch):
    (tmp_path / "model.toml").write_text(
        '[model]\nsource = "hf-hub"\nrepo = "nobody/nonexistent"\n'
        'files = ["model.onnx"]\n[codegen]\nclass_name = "PortGhost"\n')
    monkeypatch.setenv("LELE_MODEL_CACHE", str(tmp_path / "cache"))
    monkeypatch.setenv("HF_ENDPOINT", "http://127.0.0.1:1")  # refused at once, locally
    from lele_tpu_torch.build_tool import build_model

    out = build_model(tmp_path / "model.toml", tmp_path / "gen", device="cpu")
    assert out.exists() and "STUB" in out.read_text()
    with pytest.raises(RuntimeError, match="PortGhost is a stub: URLError"):
        _load(out)()


def test_stub_reason_is_jax_sanitized_line(tmp_path):
    from lele_tpu.build_tool import generate_stub as j_stub
    from lele_tpu_torch.build_tool import generate_stub

    reason = 'OSError: line one\n  "two"\\three\tfour'
    port = generate_stub(tmp_path / "p", "PortStub", reason).read_text()
    jax = j_stub(tmp_path / "j", "PortStub", reason).read_text()
    line = next(s for s in jax.splitlines() if s.startswith("Reason:"))
    assert line == "Reason: OSError: line one 'two'/three four"
    assert line in port.splitlines()
    with pytest.raises(RuntimeError, match="/three four"):
        _load(tmp_path / "p" / "PortStub.py")()


def test_build_tool_skip_env(tmp_path, monkeypatch):
    from lele_tpu_torch.build_tool import build_model

    monkeypatch.setenv("LELE_SKIP_MODEL_GEN", "1")
    (tmp_path / "model.toml").write_text(
        '[model]\nsource = "local"\npath = "nope.onnx"\n[codegen]\nclass_name = "Skipped"\n')
    assert not build_model(tmp_path / "model.toml", tmp_path / "gen").exists()


def test_force_regen_env(tmp_path, monkeypatch):
    from lele_tpu_torch.build_tool import force_regenerate, need_regenerate

    monkeypatch.delenv("LELE_FORCE_REGENERATE", raising=False)
    monkeypatch.delenv("LELE_FORCE_REGEN", raising=False)
    assert not force_regenerate()
    monkeypatch.setenv("LELE_FORCE_REGEN", "1")
    assert force_regenerate()
    assert need_regenerate(tmp_path / "x", tmp_path / "y")


def test_model_toml_files_array_of_tables_schema(tmp_path):
    from lele_tpu.build_tool import ModelConfig as JConfig
    from lele_tpu_torch.build_tool import ModelConfig

    (tmp_path / "model.toml").write_text(
        '[model]\nsource = "hf-hub"\nrepo = "org/repo"\nrevision = "v1"\n\n'
        '[[model.files]]\nfile = "onnx/a.onnx"\ndest = "a.onnx"\n\n'
        '[[model.files]]\nfile = "b.json"\n\n'
        '[codegen]\nclass_name = "X"\nmodel_file = "a.onnx"\n'
        'custom_methods = ["m1"]\n')
    cfg = ModelConfig.load(tmp_path / "model.toml")
    assert cfg.revision == "v1"
    assert cfg.files[0] == {"file": "onnx/a.onnx", "dest": "a.onnx"}
    assert cfg.files[1] == {"file": "b.json", "dest": "b.json"}
    assert cfg.custom_methods == ["m1"]
    assert vars(cfg) == vars(JConfig.load(tmp_path / "model.toml"))


@pytest.mark.parametrize("name", ["sensevoice", "silero", "supertonic", "supertonic3",
                                  "yolo26", "yolo26n_seg"])
def test_repo_example_tomls_parse(name):
    from lele_tpu.build_tool import ModelConfig as JConfig
    from lele_tpu_torch.build_tool import ModelConfig

    path = REPO / "examples" / name / "model.toml"
    assert ModelConfig.load(path).class_name
    assert vars(ModelConfig.load(path)) == vars(JConfig.load(path))


def test_entry_points_run_as_modules(tmp_path):
    """`python -m` of the CLI, the build tool and the server (its --help),
    as one fresh interpreter running each module as __main__."""
    onnx_path = tmp_path / "toy_model.onnx"
    _write_toy_onnx(onnx_path)
    (tmp_path / "model.toml").write_text(
        '[model]\nsource = "local"\npath = "toy_model.onnx"\n'
        '[codegen]\nclass_name = "PortBuilt"\n')
    code = (
        "import runpy, sys\n"
        "def run(mod, *argv):\n"
        "    sys.argv = [mod, *argv]\n"
        "    try:\n"
        "        runpy.run_module(mod, run_name='__main__')\n"
        "    except SystemExit as e:\n"
        "        assert not e.code, (mod, e.code)\n"
        f"run('lele_tpu_torch.cli', {str(onnx_path)!r}, {str(tmp_path / 'cli')!r}, 'PortCli',"
        " '--device', 'cpu')\n"
        f"run('lele_tpu_torch.build_tool', {str(tmp_path / 'model.toml')!r},"
        f" {str(tmp_path / 'bt')!r}, '--device', 'cpu')\n"
        "run('lele_tpu_torch.server', '--help')\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0 and res.stdout.strip().endswith("ok"), res.stderr
    assert "wrote" in res.stdout and "generated" in res.stdout and "--tiny" in res.stdout
    assert (tmp_path / "cli" / "PortCli.py").exists()
    assert "STUB" not in (tmp_path / "bt" / "PortBuilt.py").read_text()
