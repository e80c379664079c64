"""The JAX tensor-op, data-dependent-shape and spec-fix tests replayed
through the port: tests/test_tensor_ops.py, test_dynshape_fold_ops.py and
test_op_spec_fixes.py, each graph through both packages' compile_model on
the same bytes, the port's outputs handed to the JAX test's own
assertions and held to JAX's at the test's tolerance
(test_torch_port_ops_battery.py says how). No graph stops on a later
set's op any more: the six that did (DFT, the windows, MelWeightMatrix, the
string ops) replay in full."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_port_ops_battery import cases, replay_case  # noqa: E402


@pytest.mark.parametrize("mod_name,fn_name,kwargs", cases(
    ["test_tensor_ops", "test_dynshape_fold_ops", "test_op_spec_fixes"]))
def test_replays_jax_op_test(monkeypatch, mod_name, fn_name, kwargs):
    rep = replay_case(monkeypatch, mod_name, fn_name, kwargs)
    assert not rep.deferred, rep.deferred
