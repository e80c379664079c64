"""The com.microsoft varlen ops through the port (ROADMAP §1.1.5):
RemovePadding, RestorePadding, PackedAttention and PackedMultiHeadAttention.

Every test of tests/test_packed_ops.py is replayed (test_torch_port_ops_
battery.py says how): each graph through both packages' compile_model on the
same bytes, the port's outputs handed to the JAX test's own numpy oracles
(compaction order, cumulated lengths, zero-filled padding, the padded-batch
attention at every real token) and held to JAX's at the test's tolerance.
Beside them, chip_smoke phase 40's packed BERT stack at a small width: the
port against JAX, and against the same stack without packing on its valid
rows, with padding rows zero.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

from lele_tpu.compiler import compile_model as j_compile
from lele_tpu.onnx.loader import OnnxModel as JOnnxModel
from lele_tpu_torch.compiler import compile_model

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tests"))
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402
from test_torch_port_ops_battery import cases, replay_case  # noqa: E402

PACKED = cases(["test_packed_ops"])


@pytest.mark.parametrize("mod_name,fn_name,kwargs", PACKED)
def test_replays_jax_packed_test(monkeypatch, mod_name, fn_name, kwargs):
    replay_case(monkeypatch, mod_name, fn_name, kwargs)


def test_every_packed_test_replays():
    assert len(PACKED) == 5


@pytest.mark.parametrize("b,s,seed", [(3, 16, 0), (2, 24, 1)])
def test_packed_bert_stack_matches_jax_and_the_padded_stack(b, s, seed):
    """Phase 40 (d)'s stack (RemovePadding, PackedAttention and the MLP a
    layer, RestorePadding) at 2 layers, d 64, 4 heads: the port against JAX
    at 1e-5 of max|ref| (the JAX op tests' tolerance), and against the
    padded stack on the valid rows; padding rows are zero."""
    packed, padded, feeds = cs.packed_bert_models(b, s, layers=2, d=64, heads=4, ffn=128,
                                                  seed=seed)
    got = compile_model(packed, device="cpu", strict=True).run_np(**feeds)[0]
    want = j_compile(JOnnxModel.from_bytes(packed), strict=True).run_np(**feeds)[0]
    ref = compile_model(padded, device="cpu", strict=True).run_np(**feeds)[0]
    scale = float(np.abs(want).max())
    assert np.abs(got - want).max() <= 1e-5 * scale
    valid = np.arange(s)[None, :] < feeds["lens"][:, None]
    assert not valid.all() and valid.any(1).all()
    assert np.abs(got[valid] - ref[valid]).max() <= cs.PACKED_REL * scale
    assert (got[~valid] == 0).all()
