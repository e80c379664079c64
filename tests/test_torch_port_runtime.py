"""The port's runtime helpers against the JAX package's: MicroBatcher (JAX's
six tests/test_batcher.py cases, and a stress case), WavBatchLoader and
utils/wav.read_wav, utils/timing, models/common.count_params,
compiler/debug (profile_nodes, reference_eval, print_breakdown) and
models/onnx_import. Tolerances: decoded audio, timing stats and counts are
exact; reference_eval within 1e-5 of max(1, max|ref|) of JAX's.
"""

import sys
import threading
import time

import jax
import numpy as np
import pytest

from lele_tpu.onnx import OnnxModel as JOnnxModel
from lele_tpu.onnx import builder as jb
from lele_tpu_torch.onnx import OnnxModel
from lele_tpu_torch.onnx import builder as ob
from lele_tpu_torch.runtime.batcher import MicroBatcher
from lele_tpu_torch.utils.wav import encode_wav

JOIN_S = 30.0


def _run_threads(threads):
    for t in threads:
        t.start()
    for t in threads:
        t.join(JOIN_S)
    assert not any(t.is_alive() for t in threads)


# -- JAX's tests/test_batcher.py, on the port's MicroBatcher ---------------------


def test_concurrent_submissions_coalesce():
    def process(items):
        time.sleep(0.01)  # emulate device work
        return [x * 10 for x in items]

    b = MicroBatcher(process, max_batch=8, window_ms=40.0)
    results = {}

    def worker(i):
        results[i] = b.submit(i)

    _run_threads([threading.Thread(target=worker, args=(i,)) for i in range(8)])
    assert results == {i: i * 10 for i in range(8)}
    assert len(b.batch_sizes) < 8
    assert sum(b.batch_sizes) == 8
    b.close()


def test_max_batch_respected():
    seen = []

    def process(items):
        seen.append(len(items))
        return list(items)

    b = MicroBatcher(process, max_batch=3, window_ms=50.0)
    _run_threads([threading.Thread(target=b.submit, args=(i,)) for i in range(7)])
    assert max(seen) <= 3
    assert sum(seen) == 7
    b.close()


def test_single_submit_returns_after_window():
    b = MicroBatcher(lambda xs: [x + 1 for x in xs], max_batch=4, window_ms=5.0)
    t0 = time.perf_counter()
    assert b.submit(41) == 42
    assert time.perf_counter() - t0 < 2.0
    b.close()


def test_error_propagates_to_every_waiter():
    def process(items):
        raise ValueError("boom")

    b = MicroBatcher(process, max_batch=4, window_ms=10.0)
    errors = []

    def worker(i):
        try:
            b.submit(i)
        except ValueError as e:
            errors.append(str(e))

    _run_threads([threading.Thread(target=worker, args=(i,)) for i in range(3)])
    assert errors == ["boom"] * 3
    b.close()


def test_sequential_reuse_after_idle():
    b = MicroBatcher(lambda xs: [x * 2 for x in xs], max_batch=2, window_ms=2.0)
    assert b.submit(1) == 2
    time.sleep(0.05)  # let the worker retire
    assert b.submit(3) == 6  # a fresh worker spins up
    b.close()


def test_closed_batcher_rejects():
    b = MicroBatcher(lambda xs: xs, max_batch=2, window_ms=2.0)
    b.close()
    with pytest.raises(RuntimeError):
        b.submit(1)


def test_batcher_stress_every_submitter_gets_its_own_result():
    """More submitters than cores, a short switch interval and a window that
    retires the worker between bursts: no submission is lost, duplicated or
    answered with another's result."""
    b = MicroBatcher(lambda xs: [x * 3 for x in xs], max_batch=5, window_ms=0.5)
    results: dict = {}
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def worker(i):
            for j in range(5):
                results[(i, j)] = b.submit((i, j))
                if j == 2:
                    time.sleep(0.002)

        _run_threads([threading.Thread(target=worker, args=(i,)) for i in range(32)])
    finally:
        sys.setswitchinterval(old)
    assert results == {(i, j): (i, j) * 3 for i in range(32) for j in range(5)}
    assert sum(b.batch_sizes) == 160 and max(b.batch_sizes) <= 5
    b.close()


# -- WAV loading ----------------------------------------------------------------


@pytest.fixture
def no_native(monkeypatch):
    """JAX's decoders without its native toolchain: its pure-Python parser,
    the path the port mirrors."""
    import lele_tpu.runtime.native as native

    monkeypatch.setattr(native, "get_native", lambda: None)


def _wav_files(tmp_path, n):
    rng = np.random.default_rng(4)
    paths = []
    for i in range(n):
        pcm = (rng.standard_normal(800 + 97 * i) * 0.2).astype(np.float32)
        p = tmp_path / f"a{i}.wav"
        p.write_bytes(encode_wav(pcm, 16000 if i % 2 else 8000))
        paths.append(p)
    return paths


def test_read_wav_equals_jax(tmp_path, no_native):
    import struct

    from lele_tpu.utils.wav import read_wav as jread
    from lele_tpu_torch.utils.wav import read_wav

    paths = _wav_files(tmp_path, 2)
    pcm24 = np.random.default_rng(5).integers(-2**23, 2**23, 600).astype("<i4")
    raw = b"".join(int(v).to_bytes(3, "little", signed=True) for v in pcm24)
    hdr = (b"RIFF" + struct.pack("<I", 36 + len(raw)) + b"WAVE" + b"fmt "
           + struct.pack("<IHHIIHH", 16, 1, 2, 22050, 22050 * 6, 6, 24)
           + b"data" + struct.pack("<I", len(raw)))
    (tmp_path / "s24.wav").write_bytes(hdr + raw)
    for p in paths + [tmp_path / "s24.wav"]:
        (x, sr), (y, sr_j) = read_wav(p), jread(p)
        assert sr == sr_j and x.dtype == y.dtype == np.float32
        np.testing.assert_array_equal(x, y)


def test_wav_batch_loader_equals_jax(tmp_path, no_native):
    from lele_tpu.runtime.dataloader import WavBatchLoader as JLoader
    from lele_tpu_torch.runtime.dataloader import WavBatchLoader, decode_wav_files

    paths = _wav_files(tmp_path, 7)
    loader = WavBatchLoader(paths, batch_size=3)
    assert len(loader) == len(JLoader(paths, batch_size=3)) == 3
    got, want = list(loader), list(JLoader(paths, batch_size=3))
    assert [len(b) for b in got] == [3, 3, 1]
    for bg, bw in zip(got, want):
        for (x, sr), (y, sr_j) in zip(bg, bw):
            assert sr == sr_j
            np.testing.assert_array_equal(x, y)
    assert [sr for _, sr in decode_wav_files(paths[:2])] == [8000, 16000]


def test_wav_batch_loader_early_abandon_releases_producer(tmp_path):
    from lele_tpu_torch.runtime.dataloader import WavBatchLoader

    paths = _wav_files(tmp_path, 12)
    before = threading.active_count()
    it = iter(WavBatchLoader(paths, batch_size=2, prefetch=1))
    first = next(it)
    assert len(first) == 2
    it.close()  # the consumer walks away with the queue full
    deadline = time.monotonic() + JOIN_S
    while threading.active_count() > before and time.monotonic() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before


def test_wav_batch_loader_raises_decode_error_in_consumer(tmp_path):
    from lele_tpu_torch.runtime.dataloader import WavBatchLoader

    paths = _wav_files(tmp_path, 2) + [tmp_path / "missing.wav"]
    with pytest.raises(FileNotFoundError):
        list(WavBatchLoader(paths, batch_size=2))


# -- timing and counting ----------------------------------------------------------


def test_bench_stats_and_scope_timer_equal_jax(capsys):
    from lele_tpu.utils.timing import bench_stats as jstats
    from lele_tpu_torch.utils.timing import ScopeTimer, bench_stats

    times = list(np.random.default_rng(6).random(17))
    assert bench_stats(times) == jstats(times)
    t = ScopeTimer()
    with t.scope("a"):
        pass
    with t.scope("b"):
        time.sleep(0.001)
    with t.scope("a"):
        pass
    t.print_scope()
    out = capsys.readouterr().out.splitlines()
    assert [line.split(":")[0] for line in out] == ["[STAGE] a", "[STAGE] b", "[STAGE] total"]


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    import json

    import torch

    from lele_tpu_torch.utils.timing import profile_trace

    path = tmp_path / "trace.json"
    with profile_trace(str(path)) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert "traceEvents" in json.loads(path.read_text())
    assert any("mm" in e.key for e in prof.key_averages())


def test_count_params_equals_jax():
    from lele_tpu.models import SenseVoiceConfig as JConfig
    from lele_tpu.models import SenseVoiceModel as JModel
    from lele_tpu.models.common import count_params as jcount
    from lele_tpu_torch.models import SenseVoiceConfig, SenseVoiceModel
    from lele_tpu_torch.models.common import count_params
    from lele_tpu_torch.params import from_numpy_tree

    small = dict(n_layers=2, d_model=32, n_heads=2, ffn_dim=48, vocab_size=30)
    jm = JModel(JConfig(**small))
    jm.init(0)
    pm = SenseVoiceModel(SenseVoiceConfig(**small), device="cpu")
    pm.init(0)
    assert count_params(pm.params) == jcount(jm.params) > 0
    tree = jax.tree.map(np.asarray, jm.params)
    assert count_params(from_numpy_tree(tree)) == count_params(tree) == jcount(jm.params)
    assert count_params({"a": None, "b": [np.zeros((2, 3))]}) == 6


# -- compiler/debug ---------------------------------------------------------------


def _graphs():
    """(name, graph bytes, inputs): the toy MatMul, a Log with -1 and 0 (non-
    finite outputs), and a small SAN-M int8 encoder (many op types)."""
    from lele_tpu_torch.onnx.synth import build_sanm_int8_model

    rng = np.random.default_rng(7)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    toy = ob.build_model_bytes([ob.node("MatMul", ["x", "w"], ["y"])],
                               [ob.value_info("x", 1, [2, 4])], [ob.value_info("y", 1, [2, 6])],
                               [ob.tensor_from_array(w, "w")])
    log = ob.build_model_bytes([ob.node("Log", ["x"], ["y"])], [ob.value_info("x", 1, [3])],
                               [ob.value_info("y", 1, [3])])
    sanm = build_sanm_int8_model(L=1, d=32, h=2, ffn=48, vocab=20, int8_head=True)
    T = 12
    sanm_in = {"speech": rng.standard_normal((1, T, 560)).astype(np.float32),
               "speech_lengths": np.array([T - 2], np.int64),
               "language": np.array([3], np.int32), "textnorm": np.array([0], np.int32)}
    return [("toy", toy, {"x": rng.standard_normal((2, 4)).astype(np.float32)}),
            ("log", log, {"x": np.array([-1.0, 0.0, 1.0], np.float32)}),
            ("sanm", sanm, sanm_in)]


@pytest.mark.parametrize("case", _graphs(), ids=lambda c: c[0])
def test_profile_nodes_equals_jax(case):
    from lele_tpu.compiler.debug import profile_nodes as jprofile
    from lele_tpu_torch.compiler.debug import profile_nodes

    _, bs, inputs = case
    got = profile_nodes(OnnxModel.from_bytes(bs), inputs, device="cpu")
    want = jprofile(JOnnxModel.from_bytes(bs), inputs)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert (g["index"], g["op_type"], g["name"]) == (w["index"], w["op_type"], w["name"])
        assert g["out_shapes"] == w["out_shapes"], (g, w)
        assert g["nonfinite"] == w["nonfinite"], (g, w)
        assert g["ms"] >= 0.0
    if case[0] == "log":
        assert got[0]["nonfinite"]


def test_profile_nodes_breakdown(capsys):
    from lele_tpu_torch.compiler.debug import print_breakdown, profile_nodes

    _, bs, inputs = _graphs()[0]
    recs = profile_nodes(OnnxModel.from_bytes(bs), inputs, device="cpu")
    assert [r["op_type"] for r in recs] == ["MatMul"]
    assert recs[0]["out_shapes"] == [(2, 6)] and not recs[0]["nonfinite"]
    print_breakdown(recs)
    assert "MatMul" in capsys.readouterr().out
    _, bs, inputs = _graphs()[1]
    print_breakdown(profile_nodes(OnnxModel.from_bytes(bs), inputs, warmup=False, device="cpu"))
    assert "NONFINITE output at node #0 Log" in capsys.readouterr().out


def test_profile_nodes_external_constants(tmp_path):
    """A Constant attribute's side file resolves through the model's base_dir."""
    from lele_tpu.compiler.debug import profile_nodes as jprofile
    from lele_tpu_torch.compiler.debug import profile_nodes

    c = np.full((2, 3), 4.0, np.float32)
    (tmp_path / "c.bin").write_bytes(c.tobytes())
    bs = jb.build_model_bytes(
        [jb.node("Constant", [], ["c"], value=jb.tensor_external(c, "", "c.bin", 0)),
         jb.node("Add", ["x", "c"], ["y"])],
        inputs=[jb.value_info("x", 1, [2, 3])], outputs=[jb.value_info("y", 1, [2, 3])])
    p = tmp_path / "m.onnx"
    p.write_bytes(bs)
    x = {"x": np.ones((2, 3), np.float32)}
    got = profile_nodes(OnnxModel.load(p), x, device="cpu")
    want = jprofile(JOnnxModel.load(p), x)
    assert [(r["op_type"], r["out_shapes"]) for r in got] == \
        [(r["op_type"], r["out_shapes"]) for r in want]
    assert any(r["op_type"] == "Add" for r in got)


@pytest.mark.parametrize("case", _graphs(), ids=lambda c: c[0])
def test_reference_eval_equals_jax(case):
    from lele_tpu.compiler.debug import reference_eval as jref
    from lele_tpu_torch.compiler.debug import reference_eval

    _, bs, inputs = case
    got = reference_eval(OnnxModel.from_bytes(bs), inputs, device="cpu")
    want = jref(JOnnxModel.from_bytes(bs), inputs)
    assert list(got) == list(want)
    for k in want:
        g, w = np.asarray(got[k], np.float64), np.asarray(want[k], np.float64)
        assert g.shape == w.shape
        ok = np.isfinite(w)
        assert np.array_equal(np.isfinite(g), ok)
        assert np.abs(g[ok] - w[ok]).max(initial=0.0) <= 1e-5 * max(1.0, np.abs(w[ok]).max(
            initial=0.0))


# -- models/onnx_import -------------------------------------------------------------


def test_import_weights_equals_jax():
    from lele_tpu.models.onnx_import import import_weights as jimport
    from lele_tpu.models.onnx_import import transpose2d as jt
    from lele_tpu_torch.models.onnx_import import import_weights, transpose2d

    rng = np.random.default_rng(8)
    w0, w1 = (rng.standard_normal((6, 4)).astype(np.float32) for _ in range(2))
    b = rng.standard_normal(6).astype(np.float32)
    bs = ob.build_model_bytes(
        [ob.node("Constant", [], ["cb"], value=ob.tensor_from_array(b, "")),
         ob.node("Gemm", ["x", "w0", "cb"], ["h"], transB=1),
         ob.node("Gemm", ["h", "w1"], ["y"], transB=0)],
        [ob.value_info("x", 1, [2, 4])], [ob.value_info("y", 1, [2, 4])],
        [ob.tensor_from_array(w0, "w0"), ob.tensor_from_array(w1.T.copy(), "w1")])
    mapping = {"layers/0/w": ("w0", transpose2d), "layers/0/b": "cb",
               "layers/1/w": "w1", "head/scale": "cb"}
    got = import_weights(OnnxModel.from_bytes(bs), mapping)
    want = jimport(JOnnxModel.from_bytes(bs), {**mapping, "layers/0/w": ("w0", jt)})
    assert jax.tree.structure(got) == jax.tree.structure(want)
    assert isinstance(got["layers"], list) and len(got["layers"]) == 2
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    with pytest.raises(KeyError):
        import_weights(OnnxModel.from_bytes(bs), {"x": "nope"})
    assert import_weights(OnnxModel.from_bytes(bs), {"x": "nope"}, strict=False) == {}
