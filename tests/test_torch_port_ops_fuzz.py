"""The JAX graph fuzzer's op families replayed through the port:
tests/test_graph_fuzz_families.py's g_unary, g_reduce, g_slice_pad,
g_gather_scatter, g_topk_argmax, g_conv_pool and g_softmax_norm, each
drawn with g_binary as a feeder over a few seeds and opsets. Each random
graph goes through both packages' compile_model on the same bytes; the
port's outputs go to the fuzzer's own oracle check and are held to JAX's at
the fuzzer's tolerance, atol 2e-4 and rtol 2e-4
(test_torch_port_ops_battery.py says how).

The fuzzer's oracle for a reversed Slice with a nonzero start
(tests/test_graph_fuzz_families.py:322-333) expects x[en-1:st-1:-1], while
its graph slices to the axis's start (ends = -2**31); both packages give
the graph's answer. A case that meets it checks that the failing output is
that Slice's and that the port still gives JAX's outputs (ROADMAP §3
"Known")."""

import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
import test_graph_fuzz_families as fz  # noqa: E402
from test_torch_port_ops_battery import Replay  # noqa: E402

FAMILIES = ("g_unary", "g_reduce", "g_slice_pad", "g_gather_scatter", "g_topk_argmax",
            "g_conv_pool", "g_softmax_norm")
OPSETS = (11, 13, 18)
ATOL = RTOL = 2e-4  # tests/test_graph_fuzz_families.py:980-983
SEEDS = (0, 1)


@pytest.mark.parametrize("opset", OPSETS)
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("family", FAMILIES)
def test_fuzz_family_matches_jax(monkeypatch, family, seed, opset):
    rep = Replay()
    monkeypatch.setattr(fz, "run_graph", rep.run_graph)
    try:
        fz._run_trial(31000 + 100 * seed + opset, opset,
                      gens=[getattr(fz, family), fz.g_binary])
    except AssertionError as e:
        assert family == "g_slice_pad" and "_slice" in str(e).split("output=")[1], e
    assert rep.pairs and not rep.deferred and not rep.problems
    for got, want, _ in rep.pairs:
        for g, w in zip(got, want):
            np.testing.assert_allclose(np.asarray(g, np.float64), np.asarray(w, np.float64),
                                       atol=ATOL, rtol=RTOL)
