"""The JAX op tests replayed through the port (ROADMAP §1.1.1's harness).

Every test of tests/test_op_battery.py, test_op_battery2.py and
test_kernel_accuracy.py that builds its graphs through tests/optest.py runs
here once more, with optest's `run_op` and `run_graph` swapped for a
replay: each graph's bytes go through JAX's compile_model and the port's
(device="cpu", the same strictness), the port's outputs go back to the JAX
test, whose own assertions then hold the port to their oracles, and every
port output is held to JAX's at the test's own tolerance (the largest
`tol` it hands assert_close; optest's 1e-5 where it names none). The
other JAX op-test files replay through this file's `replay_case`
(test_torch_port_ops_tensor.py, _nn.py, _fuzz.py).

A graph that stops on a strict-mode refusal of an op of a later set
(`LATER`, empty since every set is ported) runs on JAX's outputs instead
and is recorded: the case then asserts that every refusal it met is of
such an op. A graph with a Random op (`RANDOM_OPS`) is held to JAX's shapes only:
the streams hold the properties JAX's tests assert, not threefry's bits
(ROADMAP §3 "Known"). `KNOWN` lists each case whose port outputs differ from JAX's
past the tolerance, with its measured gap and why; ROADMAP §3 lists them
too.
"""

import importlib
import inspect
import io
import re
import sys
from contextlib import redirect_stderr
from pathlib import Path

import numpy as np
import pytest

from lele_tpu.compiler import compile_model as j_compile
from lele_tpu.onnx import builder as jb
from lele_tpu.onnx.loader import OnnxModel as JOnnxModel
from lele_tpu_torch.compiler import compile_model

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tests"))
import optest  # noqa: E402

# the op names the port has not ported yet: none (every ai.onnx and
# com.microsoft emitter of the JAX package is ported)
LATER: frozenset = frozenset()

# ops whose draws the port takes from its own stream (ROADMAP §3 "Known")
RANDOM_OPS = ("RandomNormal", "RandomNormalLike", "RandomUniform", "RandomUniformLike",
              "Bernoulli", "Multinomial")

TOL = 1e-5  # tests/optest.py assert_close

# case id → (the largest port-vs-JAX gap measured, why): ROADMAP §3 "Known"
KNOWN: dict[str, tuple[float, str]] = {}


class Replay:
    """One JAX test's graphs through both packages (see the module doc)."""

    def __init__(self):
        self.pairs: list[tuple[list, list, bool]] = []  # (port, JAX, has a Random op)
        self.deferred: set[str] = set()
        self.problems: list[str] = []
        self.tols: list[float] = []

    def run(self, bs: bytes, inputs: dict, strict: bool, op_types) -> list:
        j_err = p_err = None
        try:
            with redirect_stderr(io.StringIO()):
                want = j_compile(JOnnxModel.from_bytes(bs), strict=strict).run_np(**inputs)
        except Exception as e:  # the JAX test may expect it (pytest.raises)
            j_err = e
        try:
            with redirect_stderr(io.StringIO()):
                got = compile_model(bs, device="cpu", strict=strict).run_np(**inputs)
        except Exception as e:
            m = re.search(r"unsupported op (?:\S+::)?(\w+)", str(e))
            if isinstance(e, NotImplementedError) and m and m.group(1) in LATER:
                self.deferred.add(m.group(1))
                if j_err is not None:
                    raise j_err
                return want
            p_err = e
        if p_err is not None:
            if j_err is None:
                self.problems.append(f"the port raised where JAX ran: {p_err!r}")
            raise p_err  # both raised: the JAX test's pytest.raises checks the port's
        if j_err is not None:
            self.problems.append(f"the port ran where JAX raised {j_err!r}")
            raise j_err
        self.pairs.append((got, want, any(t in RANDOM_OPS for t in op_types)))
        return got

    def run_op(self, op_type, inputs, n_outputs=1, initializers=None, opset=17,
               input_names=None, strict=True, **attrs):
        """tests/optest.py:run_op's graph, replayed."""
        initializers = initializers or {}
        in_names = input_names or list(inputs) + list(initializers)
        out_names = [f"out{i}" for i in range(n_outputs)]
        bs = jb.build_model_bytes(
            [jb.node(op_type, in_names, out_names, **attrs)],
            inputs=[jb.vi_from_array(k, v) for k, v in inputs.items()],
            outputs=[jb.value_info(o, 1, []) for o in out_names],
            initializers=[jb.tensor_from_array(v, k) for k, v in initializers.items()],
            opset=opset)
        return self.run(bs, inputs, strict, [op_type])

    def run_graph(self, nodes, inputs, output_names, initializers=None, opset=17,
                  strict=True):
        """tests/optest.py:run_graph's graph, replayed."""
        initializers = initializers or {}
        bs = jb.build_model_bytes(
            nodes,
            inputs=[jb.vi_from_array(k, v) for k, v in inputs.items()],
            outputs=[jb.value_info(o, 1, []) for o in output_names],
            initializers=[jb.tensor_from_array(v, k) for k, v in initializers.items()],
            opset=opset)
        return self.run(bs, inputs, strict, [n["op_type"] for n in nodes])

    def assert_close(self, got, want, tol=1e-5):
        self.tols.append(float(tol))
        optest.assert_close(got, want, tol)

    def gap(self) -> float:
        """The largest port-vs-JAX difference over every compared output."""
        worst = 0.0
        for got, want, random in self.pairs:
            assert len(got) == len(want)
            for g, w in zip(got, want):
                g, w = np.asarray(g), np.asarray(w)
                assert g.shape == w.shape, (g.shape, w.shape)
                if random or not g.size:
                    continue
                g, w = g.astype(np.float64), w.astype(np.float64)
                assert np.array_equal(np.isnan(g), np.isnan(w)), "NaN positions differ"
                fin = ~np.isnan(g)
                if fin.any():
                    assert np.array_equal(g[fin & np.isinf(g)], w[fin & np.isinf(g)])
                    d = np.abs(np.where(np.isinf(g), 0.0, g - w)[fin])
                    worst = max(worst, float(d.max()))
        return worst


def cases(module_names, patch_names=("run_op", "run_graph", "assert_close")):
    """pytest params of every test function of the named JAX test modules
    that builds a graph through optest (parametrised ones once per
    parameter set)."""
    out = []
    for mod_name in module_names:
        mod = importlib.import_module(mod_name)
        for name, fn in vars(mod).items():
            if not (name.startswith("test_") and inspect.isfunction(fn)):
                continue
            src = inspect.getsource(fn)
            if "run_op(" not in src and "run_graph(" not in src:
                continue
            grids = [m for m in getattr(fn, "pytestmark", []) if m.name == "parametrize"]
            if not grids:
                out.append(pytest.param(mod_name, name, {}, id=f"{mod_name}::{name}"))
                continue
            # stacked grids: every combination, the innermost (last applied) first
            combos = [()]
            for grid in reversed(grids):
                argnames = [a.strip() for a in grid.args[0].split(",")]
                combos = [c + tuple(zip(argnames, v if len(argnames) > 1 else (v,)))
                          for c in combos for v in grid.args[1]]
            for combo in combos:
                vals = [v for _, v in combo]
                out.append(pytest.param(mod_name, name, dict(combo),
                                        id=f"{mod_name}::{name}[{'-'.join(map(str, vals))}]"))
    return out


def replay_case(monkeypatch, mod_name, fn_name, kwargs, known=KNOWN):
    """Run one JAX test on the port's outputs and hold them to JAX's."""
    mod = importlib.import_module(mod_name)
    rep = Replay()
    for attr in ("run_op", "run_graph", "assert_close"):
        if hasattr(mod, attr):
            monkeypatch.setattr(mod, attr, getattr(rep, attr))
    monkeypatch.setattr(optest, "run_op", rep.run_op)  # tests importing it late
    monkeypatch.setattr(optest, "run_graph", rep.run_graph)
    getattr(mod, fn_name)(**kwargs)
    assert not rep.problems, rep.problems
    assert rep.deferred <= LATER, rep.deferred
    tol = max([TOL] + rep.tols)
    gap = rep.gap()
    case = f"{mod_name}::{fn_name}" + (f"[{'-'.join(map(str, kwargs.values()))}]"
                                       if kwargs else "")
    if case in known:
        bound, why = known[case]
        assert gap <= bound, (case, gap, why)
    else:
        assert gap <= tol, f"port vs JAX max|d| {gap:.3e} > {tol:g}"
    return rep


@pytest.mark.parametrize("mod_name,fn_name,kwargs", cases(
    ["test_op_battery", "test_op_battery2", "test_kernel_accuracy"]))
def test_replays_jax_op_test(monkeypatch, mod_name, fn_name, kwargs):
    replay_case(monkeypatch, mod_name, fn_name, kwargs)
