"""The port's config.py and `--precision` against the JAX package's
lele_tpu/config.py, compile_model(precision=) and CLI.

- `Config` holds JAX's fields that have a meaning in the port, with JAX's
  defaults (`index_dtype`, `float64_as`, `use_pallas_rnn` and
  `compute_dtype` are left out: ROADMAP §3);
- `strict` and `rng_seed` are read where JAX reads them, and act as JAX's
  do;
- `compile_model(precision=)` for each value against JAX's at the f32
  tolerance (the CPU stays f32 at every precision, as XLA:CPU does);
- a model's walk runs at its precision, and torch's TF32 flags are the
  same after its call, its replay and its export as before, also with
  walks at two precisions on two threads;
- the CLI's `--precision` is carried into the generated wrapper.
"""

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from lele_tpu.compiler import compile_model as j_compile
from lele_tpu.config import Config as JConfig
from lele_tpu.config import config as jconfig
from lele_tpu.onnx import OnnxModel as JOnnxModel
from lele_tpu_torch import config as pconfig
from lele_tpu_torch.compiler import compile_model
from lele_tpu_torch.config import Config, config, current_precision, precision_scope
from lele_tpu_torch.onnx import builder as ob

REPO = Path(__file__).resolve().parents[1]
PRECISIONS = ("default", "high", "highest")
F32_TOL = 1e-5


@pytest.fixture
def restore_config():
    j0, p0 = dataclasses.asdict(jconfig), dataclasses.asdict(config)
    yield
    for k, v in j0.items():
        setattr(jconfig, k, v)
    for k, v in p0.items():
        setattr(config, k, v)


def _close(got, want, tol=F32_TOL):
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(1.0, float(np.abs(want).max()))


def test_config_fields_are_jaxs_with_a_meaning():
    port = {f.name: f.default for f in dataclasses.fields(Config)}
    jax = {f.name: f.default for f in dataclasses.fields(JConfig)}
    assert set(jax) - set(port) == {"index_dtype", "float64_as", "use_pallas_rnn",
                                    "compute_dtype"}
    assert port == {k: jax[k] for k in port}
    assert config.matmul_precision == "highest" and current_precision() == "highest"


def test_strict_is_read_from_the_config(restore_config, capsys):
    data = ob.build_model_bytes(
        [ob.node("Relu", ["x"], ["r"]), ob.node("NoSuchOp", ["r"], ["y"])],
        inputs=[ob.value_info("x", 1, [2, 3])], outputs=[ob.value_info("y", 1, [2, 3])])
    compile_model(data, device="cpu")
    j_compile(JOnnxModel.from_bytes(data))
    config.strict = jconfig.strict = True
    with pytest.raises(NotImplementedError, match="NoSuchOp"):
        compile_model(data, device="cpu")
    with pytest.raises(Exception, match="NoSuchOp"):
        j_compile(JOnnxModel.from_bytes(data))
    compile_model(data, device="cpu", strict=False)  # an argument still wins
    assert "NoSuchOp" in capsys.readouterr().err


def _random_graph():
    return ob.build_model_bytes(
        [ob.node("RandomNormal", [], ["y"], shape=[4096], dtype=1, mean=0.5, scale=2.0)],
        inputs=[], outputs=[ob.value_info("y", 1, [4096])])


def test_rng_seed_roots_the_random_ops_as_in_jax(restore_config):
    data = _random_graph()

    def draws(seed):
        config.rng_seed = jconfig.rng_seed = seed
        return (compile_model(data, device="cpu").run_np()[0],
                np.asarray(j_compile(JOnnxModel.from_bytes(data)).run_np()[0]))

    (p0, j0), (p0b, j0b), (p5, j5) = draws(0), draws(0), draws(5)
    np.testing.assert_array_equal(p0, p0b)
    np.testing.assert_array_equal(j0, j0b)
    assert not np.array_equal(p0, p5) and not np.array_equal(j0, j5)
    for x in (p0, p5, j0, j5):  # the same stream properties, not the same bits
        assert abs(x.mean() - 0.5) < 0.1 and abs(x.std() - 2.0) < 0.1



def _matmul_graph():
    rng = np.random.default_rng(7)
    w = rng.standard_normal((64, 96)).astype(np.float32)
    b = rng.standard_normal((96,)).astype(np.float32)
    data = ob.build_model_bytes(
        [ob.node("MatMul", ["x", "w"], ["mm"]), ob.node("Add", ["mm", "b"], ["ab"]),
         ob.node("Relu", ["ab"], ["y"])],
        inputs=[ob.value_info("x", 1, [5, 64])], outputs=[ob.value_info("y", 1, [5, 96])],
        initializers=[ob.tensor_from_array(w, "w"), ob.tensor_from_array(b, "b")])
    return data, {"x": rng.standard_normal((5, 64)).astype(np.float32)}


def _conv_graph():
    rng = np.random.default_rng(8)
    w = (rng.standard_normal((16, 8, 3, 3)) * 0.2).astype(np.float32)
    data = ob.build_model_bytes(
        [ob.node("Conv", ["x", "w"], ["c"], pads=[1, 1, 1, 1]), ob.node("Relu", ["c"], ["y"])],
        inputs=[ob.value_info("x", 1, [2, 8, 12, 12])],
        outputs=[ob.value_info("y", 1, [2, 16, 12, 12])],
        initializers=[ob.tensor_from_array(w, "w")])
    return data, {"x": rng.standard_normal((2, 8, 12, 12)).astype(np.float32)}


GRAPHS = {"matmul": _matmul_graph, "conv": _conv_graph}


@pytest.mark.parametrize("graph", list(GRAPHS))
@pytest.mark.parametrize("precision", PRECISIONS)
def test_compile_model_precision_matches_jax(graph, precision):
    data, feeds = GRAPHS[graph]()
    cm = compile_model(data, device="cpu", precision=precision)
    assert cm.precision == precision
    got = cm.run_np(**feeds)
    want = j_compile(JOnnxModel.from_bytes(data), precision=precision).run_np(**feeds)
    for g, w in zip(got, want):
        _close(g, np.asarray(w))
    # the CPU stays f32: every precision gives the highest's bits
    np.testing.assert_array_equal(
        got[0], compile_model(data, device="cpu", precision="highest").run_np(**feeds)[0])


@pytest.mark.parametrize("precision", PRECISIONS + (None,))
def test_a_walk_runs_at_its_precision_and_restores_torchs_flags(precision, restore_config):
    data, feeds = _matmul_graph()
    seen = []

    def relu(ctx, x):
        seen.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
                     current_precision()))
        return torch.relu(x)

    config.matmul_precision = "high"  # what a program that pins none runs at
    want_p = precision or "high"
    cm = compile_model(data, device="cpu", precision=precision, overrides={"Relu": relu})
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    sentinel = (not flags[0], not flags[1])
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = sentinel
    try:
        seen.clear()
        for run in (lambda: cm(**feeds), lambda: cm.replay(**feeds), cm.compile, cm.lower):
            run()
            assert (torch.backends.cuda.matmul.allow_tf32,
                    torch.backends.cudnn.allow_tf32) == sentinel
        assert seen and set(seen) == {(*pconfig.PRECISION_FLAGS[want_p], want_p)}
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def test_walks_on_two_threads_each_run_at_their_precision(restore_config):
    """torch's TF32 flags are process-wide: two threads walking models at
    two precisions each see their own precision's flags throughout the
    walk, and the flags are the first ones after both (the scope holds
    runtime.graphs.CARD_LOCK)."""
    import threading
    import time

    data, feeds = _matmul_graph()
    seen = {"highest": set(), "high": set()}

    def relu(ctx, x):
        p = current_precision()
        time.sleep(1e-3)  # hand the GIL over mid-walk
        seen[p].add((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
                     current_precision()))
        return torch.relu(x)

    models = {p: compile_model(data, device="cpu", precision=p, overrides={"Relu": relu})
              for p in seen}
    for p in seen:
        seen[p].clear()
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    errors = []

    def drive(p):
        try:
            for _ in range(40):
                models[p].replay(**feeds)
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=drive, args=(p,)) for p in seen]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    for p in seen:
        assert seen[p] == {(*pconfig.PRECISION_FLAGS[p], p)}, (p, seen[p])
    assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == flags


def test_precision_scopes_nest_and_unknown_values_are_refused():
    assert current_precision() == config.matmul_precision
    with precision_scope("high"):
        assert pconfig.cudnn_tf32() and current_precision() == "high"
        with precision_scope("highest"):
            assert not pconfig.cudnn_tf32() and not torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32 and current_precision() == "high"
    assert current_precision() == config.matmul_precision
    with pytest.raises(ValueError, match="precision"):
        compile_model(_matmul_graph()[0], device="cpu", precision="low")
    with pytest.raises(ValueError, match="precision"):
        with precision_scope("medium"):
            pass


def _load(wrapper: Path):
    spec = importlib.util.spec_from_file_location(f"port_prec_{wrapper.stem}", wrapper)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return getattr(mod, wrapper.stem)


@pytest.mark.parametrize("precision", PRECISIONS)
def test_cli_precision_is_carried_into_the_wrapper(precision, tmp_path, restore_config):
    import io
    from contextlib import redirect_stderr

    from lele_tpu.cli import main as j_main
    from lele_tpu_torch.cli import main

    data, feeds = _matmul_graph()
    onnx_path = tmp_path / "prec.onnx"
    onnx_path.write_bytes(data)
    cls = f"PortPrec{precision.title()}"
    assert main([str(onnx_path), str(tmp_path / "p"), cls, "--device", "cpu",
                 "--precision", precision]) == 0
    wrapper = _load(tmp_path / "p" / f"{cls}.py")
    assert wrapper.PRECISION == precision
    m = wrapper(device="cpu")
    assert m._cm.precision == precision
    got = m.forward(**feeds)
    with redirect_stderr(io.StringIO()):
        assert j_main([str(onnx_path), str(tmp_path / "j"), f"Jax{cls}",
                       "--precision", precision]) in (0, None)
    jw = _load(tmp_path / "j" / f"Jax{cls}.py")
    assert jw.PRECISION == precision
    for g, w in zip(got, jw().forward(**feeds)):
        _close(g, np.asarray(w))


def test_yolo_bf16_route_pins_default_as_jax():
    from lele_tpu_torch.models.checkpoints import YoloOnnx

    path = REPO / "fixtures" / "yolo26.onnx"
    assert YoloOnnx(path, compute="bfloat16", device="cpu").cm.precision == "default"
    assert YoloOnnx(path, device="cpu").cm.precision is None
