"""The port's GRU slice against the JAX package's, at a small size.

- Kernel 9's plain version (`gru_seq_plain`) against `gru_seq_pallas` in
  interpret mode and `gru_seq_reference`, both `linear_before_reset` forms.
- The GRU emitter against JAX's on the same ONNX bytes, both compiled: the
  three directions, layout 0 and 1, bias or none, an initial state, both
  forms, one step, ragged lengths (static and a dynamic input). The port
  runs a direction without ragged lengths through the `gru_seq` wrapper (its
  plain version on the CPU), JAX its scan; a ragged one runs the masked loop
  on both sides. The weights are laid out once, at trace time.
- The RNN emitter (no kernel) against JAX's: three activations, three
  directions, ragged lengths.

Inputs are made with numpy from a seed. Everything is f32 and only the
order of f32 sums differs, so results agree to 1e-5 of the reference's
largest magnitude (kernel 9: atol 1e-5, tests/test_pallas_parity.py:90-101).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lele_tpu.compiler import compile_model as j_compile
from lele_tpu.kernels.gru import gru_seq_pallas, gru_seq_reference
from lele_tpu.onnx import builder as jb
from lele_tpu.onnx.loader import OnnxModel as JOnnxModel
from lele_tpu_torch import kernels as K
from lele_tpu_torch.compiler import compile_model
from lele_tpu_torch.onnx import builder as ob
from lele_tpu_torch.ops import nn_ops

TOL = 1e-5
KERNEL_ATOL = 1e-5


def _assert_close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (got.shape, want.shape)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


@pytest.mark.parametrize("lbr", [True, False], ids=["lbr", "no_lbr"])
@pytest.mark.parametrize("B", [1, 3])
def test_gru_seq_plain_matches_pallas_and_reference(lbr, B):
    rng = np.random.default_rng(7 + B)
    S, H = 19, 32
    xp = (rng.standard_normal((S, B, 3 * H)) * 0.4).astype(np.float32)
    rh = (rng.standard_normal((H, 3 * H)) * 0.4).astype(np.float32)
    rb = (rng.standard_normal((3 * H,)) * 0.1).astype(np.float32)
    h0 = (rng.standard_normal((B, H)) * 0.5).astype(np.float32)
    args = [jnp.asarray(v) for v in (xp, rh, rb, h0)]
    want_p = gru_seq_pallas(*args, lbr, interpret=True)
    want_r = gru_seq_reference(*args, lbr)
    got = K.gru_seq_plain(*(torch.from_numpy(v) for v in (xp, rh, rb, h0)), lbr)
    for want in (want_p, want_r):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=KERNEL_ATOL)


def test_gru_seq_wrapper_takes_plain_on_cpu():
    rng = np.random.default_rng(3)
    args = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in ((5, 2, 12), (4, 12), (12,), (2, 4))]
    K.reset_launch_counts()
    for lbr in (True, False):
        for g, w in zip(K.gru_seq(*args, lbr), K.gru_seq_plain(*args, lbr)):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert K.launch_counts()["gru_seq"] == 0
    assert K.gru.kernel_takes(1024) and not K.gru.kernel_takes(1025)
    with pytest.raises(ValueError, match="rh"):
        K.gru_seq(args[0], args[1][:, :9], args[2], args[3])


# -- the GRU emitter, compiled, against JAX's -----------------------------------


def _gru_graph(S, B, I, H, D=1, bias=True, init=False, lbr=0, layout=0, lens=None,
               dyn_lens=False, direction="forward", seed=0, op="GRU", **attrs):
    """ONNX bytes of one GRU (or RNN) node with random weights, and its
    inputs: x (and, with dyn_lens, the lengths) as graph inputs."""
    rng = np.random.default_rng(seed)
    ng = 3 if op == "GRU" else 1
    x = rng.standard_normal((B, S, I) if layout else (S, B, I)).astype(np.float32)
    inits = {"w": (rng.standard_normal((D, ng * H, I)) * 0.4).astype(np.float32),
             "r": (rng.standard_normal((D, ng * H, H)) * 0.4).astype(np.float32)}
    names = ["x", "w", "r", "", "", ""]
    if bias:
        inits["b"] = (rng.standard_normal((D, 2 * ng * H)) * 0.2).astype(np.float32)
        names[3] = "b"
    feeds = {"x": x}
    if lens is not None:
        names[4] = "sl"
        if dyn_lens:
            feeds["sl"] = np.asarray(lens, np.int32)
        else:
            inits["sl"] = np.asarray(lens, np.int32)
    if init:
        inits["h0"] = (rng.standard_normal((B, D, H) if layout else (D, B, H)) * 0.5
                       ).astype(np.float32)
        names[5] = "h0"
    while names[-1] == "":
        names.pop()
    if D == 2:
        direction = "bidirectional"
    if op == "GRU":
        attrs["linear_before_reset"] = lbr
    data = jb.build_model_bytes(
        [jb.node(op, names, ["y", "yh"], hidden_size=H, layout=layout, direction=direction,
                 **attrs)],
        inputs=[jb.value_info(n, 1 if n == "x" else 6, list(v.shape)) for n, v in feeds.items()],
        outputs=[jb.value_info(n, 1, []) for n in ("y", "yh")],
        initializers=[jb.tensor_from_array(v, n) for n, v in inits.items()])
    return data, feeds


GRU_CASES = {  # tests/test_nn_ops.py:560-633 and the emitter's options
    "forward": dict(S=6, B=2, I=4, H=5),
    "forward_lbr": dict(S=6, B=2, I=4, H=5, lbr=1),
    "reverse_initial_state": dict(S=5, B=3, I=3, H=4, init=True, direction="reverse"),
    "bidirectional_lbr": dict(S=5, B=2, I=3, H=4, D=2, lbr=1),
    "bidirectional_no_bias": dict(S=5, B=2, I=3, H=4, D=2, bias=False),
    "layout_1_bidirectional_state": dict(S=5, B=3, I=4, H=6, D=2, init=True, layout=1),
    "layout_1_lbr": dict(S=4, B=2, I=3, H=5, layout=1, lbr=1),
    "one_step_no_bias": dict(S=1, B=1, I=2, H=3, bias=False),
    "full_lengths": dict(S=4, B=2, I=3, H=4, lens=[4, 4]),
    "ragged": dict(S=6, B=3, I=4, H=5, lens=[6, 3, 1]),
    "ragged_reverse_lbr": dict(S=5, B=2, I=3, H=4, lens=[5, 2], direction="reverse", lbr=1),
    "ragged_bidirectional": dict(S=5, B=2, I=3, H=4, D=2, lens=[3, 5], init=True),
    "ragged_dynamic_input": dict(S=5, B=2, I=3, H=4, lens=[5, 2], dyn_lens=True),
    "silero_width": dict(S=7, B=1, I=128, H=128, init=True),
}


@pytest.mark.parametrize("case", list(GRU_CASES))
def test_gru_compiled_matches_jax_and_hoists_prepared_weights(case):
    kw = GRU_CASES[case]
    data, feeds = _gru_graph(**kw, seed=len(case))
    want = j_compile(JOnnxModel.from_bytes(data)).run_np(**feeds)
    cm = compile_model(data, device="cpu")
    routes = dict(nn_ops.RNN_ROUTES)
    got = cm.run_np(**feeds)
    for g, w in zip(got, want):
        _assert_close(g, w)
    moved = {k: nn_ops.RNN_ROUTES[k] - routes[k] for k in routes}
    n_dir = 2 if kw.get("D") == 2 else 1
    lens = kw.get("lens")
    kernel_route = lens is None or (not kw.get("dyn_lens") and all(v == kw["S"] for v in lens))
    assert moved == ({"lstm_seq": 0, "gru_seq": n_dir, "loop": 0} if kernel_route
                     else {"lstm_seq": 0, "gru_seq": 0, "loop": n_dir})
    assert cm.stats["n_steps"] == 1
    tags = {k.split("#")[1] for k in cm.params if "#" in k}
    assert tags == ({"gru_wx", "gru_rh", "gru_wb", "gru_rb"} if kw.get("bias", True)
                    else {"gru_wx", "gru_rh", "gru_rb"})
    rh = next(v for k, v in cm.params.items() if k.endswith("#gru_rh"))
    assert tuple(rh.shape) == (n_dir, kw["H"], 3 * kw["H"])  # R transposed, once


@pytest.mark.parametrize("case", ["forward", "bidirectional_lbr", "ragged_reverse_lbr",
                                  "layout_1_bidirectional_state"])
def test_gru_plain_override_equals_the_emitter(case):
    data, feeds = _gru_graph(**GRU_CASES[case], seed=3)
    got = compile_model(data, device="cpu", overrides={"GRU": nn_ops.gru_plain})
    want = compile_model(data, device="cpu")
    for g, w in zip(got.run_np(**feeds), want.run_np(**feeds)):
        np.testing.assert_array_equal(g, w)


def test_gru_ignores_activations_and_clip_as_jax():
    """JAX's GRU ignores `activations` and `clip` (lele_tpu/ops/nn_ops.py:
    700-789); the port does the same, so both give the default cell."""
    kw = dict(S=4, B=2, I=3, H=4)
    data, feeds = _gru_graph(**kw, seed=9, activations=["Relu", "Relu"], clip=0.1)
    plain, _ = _gru_graph(**kw, seed=9)
    want = j_compile(JOnnxModel.from_bytes(data)).run_np(**feeds)
    got = compile_model(data, device="cpu").run_np(**feeds)
    ref = compile_model(plain, device="cpu").run_np(**feeds)
    for g, w, r in zip(got, want, ref):
        _assert_close(g, w)
        np.testing.assert_array_equal(g, r)


def test_port_gru_builder_writes_the_same_bytes():
    args = (["x", "w", "r"], ["y", "yh"])
    a = ob.build_model_bytes([ob.node("GRU", *args, hidden_size=4, linear_before_reset=1)],
                             inputs=[ob.value_info("x", 1, [2, 1, 3])],
                             outputs=[ob.value_info("y", 1, [])])
    b = jb.build_model_bytes([jb.node("GRU", *args, hidden_size=4, linear_before_reset=1)],
                             inputs=[jb.value_info("x", 1, [2, 1, 3])],
                             outputs=[jb.value_info("y", 1, [])])
    assert a == b


# -- the RNN emitter -------------------------------------------------------------


RNN_CASES = {
    "tanh_forward": dict(S=6, B=2, I=4, H=5),
    "relu_reverse_state": dict(S=5, B=2, I=3, H=4, init=True, direction="reverse",
                               activations=["Relu"]),
    "sigmoid_bidirectional": dict(S=5, B=3, I=3, H=4, D=2, activations=["Sigmoid", "Tanh"]),
    "layout_1_no_bias": dict(S=4, B=2, I=3, H=5, layout=1, bias=False),
    "ragged": dict(S=6, B=3, I=4, H=5, lens=[6, 3, 1]),
    "ragged_bidirectional_relu": dict(S=5, B=2, I=3, H=4, D=2, lens=[2, 5],
                                      activations=["Relu", "Sigmoid"]),
}


@pytest.mark.parametrize("case", list(RNN_CASES))
def test_rnn_compiled_matches_jax(case):
    data, feeds = _gru_graph(**RNN_CASES[case], seed=11 + len(case), op="RNN")
    want = j_compile(JOnnxModel.from_bytes(data)).run_np(**feeds)
    routes = dict(nn_ops.RNN_ROUTES)
    got = compile_model(data, device="cpu", strict=True).run_np(**feeds)
    for g, w in zip(got, want):
        _assert_close(g, w)
    assert nn_ops.RNN_ROUTES == routes  # no kernel, no count
