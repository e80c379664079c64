"""The port's compiled Supertonic path against the JAX package's: the seven
emitters the four fixture graphs add (Constant, ConstantOfShape, Expand,
Where, Tanh, Softplus, and the 1-D ConvTranspose in its padding forms), then
`SupertonicOnnx` on fixtures/supertonic_{dp,te,ve,voc}.onnx.

Each emitter runs the same node as the JAX emitter on the same numpy inputs
(seeded), through the helpers of tests/test_torch_port_silero_onnx.py:
floats to 1e-5 of the largest magnitude, everything else exactly. The
fixture graphs are held to their torch outputs in supertonic_io.npz at atol
2e-4, the JAX package's gate (tests/test_fixture_e2e.py), and the whole
synth to JAX's `synthesize_latent` at the same seed at atol 1e-3 (both take
numpy's noise; five flow steps and the vocoder compound f32 summation-order
differences).
"""

from pathlib import Path

import numpy as np
import pytest
import torch
from test_torch_port_silero_onnx import _assert_close, _run_both

from lele_tpu.models.checkpoints import SupertonicOnnx as JSupertonicOnnx
from lele_tpu_torch.models import SupertonicOnnx

FIXTURES = Path(__file__).resolve().parent.parent / "fixtures"
FIXTURE_ATOL = 2e-4
SYNTH_ATOL = 1e-3
_RNG = np.random.default_rng(2029)


def _f32(*shape, scale=1.0):
    return (_RNG.standard_normal(shape) * scale).astype(np.float32)


def _case(op, inputs, n_out=1, **attrs):
    return (op, inputs, n_out, attrs)


EMITTER_CASES = {
    "Tanh": _case("Tanh", [_f32(2, 7, 5, scale=2.0)]),
    "Softplus": _case("Softplus", [_f32(3, 40, scale=30.0)]),  # both tails
    "Constant_tensor": _case("Constant", [], value=_f32(2, 3)),
    "Constant_float": _case("Constant", [], value_float=1.5),
    "Constant_ints": _case("Constant", [], value_ints=[3, -1, 4]),
    "ConstantOfShape": _case("ConstantOfShape", [np.asarray([2, 3], np.int64)]),
    "ConstantOfShape_value": _case("ConstantOfShape", [np.asarray([4, 1, 2], np.int64)],
                                   value=np.asarray([7], np.int64)),
    "Expand": _case("Expand", [_f32(1, 3, 1), np.asarray([2, 1, 4], np.int64)]),
    "Expand_rank_up": _case("Expand", [_f32(3), np.asarray([2, 1, 3], np.int64)]),
    "Where_bool": _case("Where", [_RNG.random((3, 4)) > 0.5, _f32(3, 4), _f32(1, 4)]),
    "Where_float_cond": _case("Where", [(_RNG.random((2, 5)) > 0.3).astype(np.float32),
                                        _f32(2, 5), _f32(2, 5)]),
    # the vocoder's x4 level, and the other ways a 1-D ConvTranspose pads
    "ConvTranspose_x4": _case("ConvTranspose", [_f32(1, 16, 9), _f32(16, 8, 8, scale=0.2),
                                                _f32(8)], strides=[4], pads=[2, 2]),
    "ConvTranspose_plain": _case("ConvTranspose", [_f32(2, 3, 5), _f32(3, 4, 3)]),
    "ConvTranspose_same_upper": _case("ConvTranspose", [_f32(1, 4, 6), _f32(4, 2, 5)],
                                      strides=[2], auto_pad="SAME_UPPER"),
    "ConvTranspose_same_lower": _case("ConvTranspose", [_f32(1, 4, 6), _f32(4, 2, 5)],
                                      strides=[2], auto_pad="SAME_LOWER"),
    "ConvTranspose_output_shape": _case("ConvTranspose", [_f32(1, 2, 5), _f32(2, 3, 4)],
                                        strides=[3], output_shape=[16]),
    "ConvTranspose_output_padding": _case("ConvTranspose", [_f32(1, 2, 5), _f32(2, 3, 4)],
                                          strides=[3], output_padding=[2], pads=[1, 0]),
    "ConvTranspose_group_dilation": _case("ConvTranspose", [_f32(1, 4, 7), _f32(4, 3, 3)],
                                          group=2, dilations=[2], strides=[2], pads=[1, 1]),
}


@pytest.mark.parametrize("case", list(EMITTER_CASES))
def test_emitter_matches_jax(case):
    for g, w in zip(*_run_both(*EMITTER_CASES[case])):
        _assert_close(g, w)


@pytest.fixture(scope="module")
def io():
    return dict(np.load(FIXTURES / "supertonic_io.npz"))


@pytest.fixture(scope="module")
def port():
    return SupertonicOnnx(FIXTURES, device="cpu")


def test_submodels_match_fixture_outputs(io, port):
    (dur,) = port.dp.run_np(io["ids"], io["style"], io["mask"])
    (emb,) = port.te.run_np(io["ids"], io["style"], io["mask"])
    (v,) = port.ve.run_np(io["xt"], io["text_emb"], io["style"], io["t_step"])
    (wave,) = port.voc.run_np(io["xt"])
    for got, key in ((dur, "durations"), (emb, "te_out"), (v, "v"), (wave, "wave")):
        assert got.shape == io[key].shape
        np.testing.assert_allclose(got, io[key], atol=FIXTURE_ATOL)
    assert all(cm.device == torch.device("cpu") for cm in (port.dp, port.te, port.ve, port.voc))


@pytest.mark.parametrize("seed", [0, 3])
def test_synthesize_matches_jax(io, port, seed):
    jst = JSupertonicOnnx(FIXTURES)
    n = io["xt"].shape[-1]
    args = (io["ids"].astype(np.int64), io["style"], io["mask"])
    want_dur, want = jst.synthesize_latent(*args, latent_len=n, seed=seed)
    dur, wave = port.synthesize_latent(*args, latent_len=n, seed=seed)
    dur_h, wave_h = port.synthesize_latent_hostloop(*args, latent_len=n, seed=seed)
    assert wave.shape == want.shape == io["wave"].shape and np.isfinite(wave).all()
    np.testing.assert_allclose(wave, want, atol=SYNTH_ATOL)
    np.testing.assert_allclose(dur, want_dur, atol=FIXTURE_ATOL)
    # the device loop and the host loop are the same arithmetic
    np.testing.assert_allclose(wave, wave_h, atol=1e-6)
    np.testing.assert_array_equal(dur, dur_h)
    _, want_h = jst.synthesize_latent_hostloop(*args, latent_len=n, seed=seed)
    np.testing.assert_allclose(wave_h, want_h, atol=SYNTH_ATOL)


def test_missing_model_file_names_both_spellings(tmp_path):
    with pytest.raises(FileNotFoundError, match="duration_predictor.onnx"):
        SupertonicOnnx(tmp_path, device="cpu")


def test_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        SupertonicOnnx(FIXTURES)
