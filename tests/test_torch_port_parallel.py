"""The port's parallel layer (lele_tpu_torch/parallel, train.shard_batch)
against tests/test_sharding.py's cases and dryrun_multichip's first leg.

JAX runs those on 8 virtual CPU devices (conftest.py); torch on the CPU has
one device, so the port runs each leg as 8 gloo processes, spawned once for
all of them (tests/torch_port_legs.py), each process holding only its
shards. Every sharded result is held to the port's one-process step and to
JAX's on the same weights (JAX's init, carried over as numpy) and batches:
the loss at the JAX test's rtol 2e-4, every gradient leaf (the shards made
whole) at GRAD_REL of its max |grad|, and the params after the step at the
JAX test's atol 2e-4.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lele_tpu.models import SenseVoiceConfig as JConfig
from lele_tpu.models import init_sensevoice as jinit
from lele_tpu.models import sensevoice_encode as jencode
from lele_tpu.train import ctc_loss_fn as jloss_fn
from lele_tpu.train import make_train_step as jmake_train_step
from lele_tpu_torch.models import SenseVoiceConfig, sensevoice_encode
from lele_tpu_torch.parallel import mesh_axes, sensevoice_param_rules
from lele_tpu_torch.parallel.mesh import AXES, AXES3, mesh_shape
from lele_tpu_torch.parallel.sharding import (
    _tree_paths,
    param_spec_tree,
    placed_spec,
)
from lele_tpu_torch.params import from_numpy_tree
from lele_tpu_torch.train import make_train_step
from lele_tpu_torch.train.trainer import value_and_grad

import torch_port_legs as legs

LOSS_RTOL = 2e-4  # tests/test_sharding.py's
PARAM_ATOL = 2e-4
# each leaf's max|d| over its max|grad|, as test_torch_port_train (measured
# on the legs, every rank: at most 4.8e-6 against JAX, 3.3e-6 against the
# port's one process)
GRAD_REL = 2e-5
# a reference gradient below NOISE_REL of its leaf's max |grad| is rounding
# noise (the key third of qkv/b: 0 in exact arithmetic, as a softmax ignores
# a constant added to every score of a query, and ~1e-9 in f32); Adam
# divides each gradient by its own size, so such an element moves by lr
# either way in each run
NOISE_REL = 1e-6
SMALL = dict(n_layers=1, d_model=32, ffn_dim=64, vocab_size=32, n_heads=2, dtype="float32")
MOE = dict(SMALL, n_experts=4)
DRYRUN = dict(n_layers=2, d_model=64, ffn_dim=128, vocab_size=64, n_heads=2,
              dtype="float32", n_experts=4)
TP = dict(SMALL, n_layers=2)


def _batch(seed, B, T, L, vocab):
    rng = np.random.default_rng(seed)
    return {
        "feats": rng.standard_normal((B, T, 560)).astype(np.float32),
        "feat_mask": np.ones((B, T), np.float32),
        "labels": rng.integers(1, vocab, (B, L)).astype(np.int32),
        "label_mask": np.ones((B, L), np.float32),
    }


def _params(kw):
    return jax.tree.map(np.asarray, jinit(jax.random.PRNGKey(0), JConfig(**kw)))


def _jax_step(kw, params, batch, lr):
    """(loss, params after one step, the gradients of the step)."""
    _, grads = jax.value_and_grad(jloss_fn)(params, batch, JConfig(**kw))
    tx, step = jmake_train_step(JConfig(**kw), lr=lr)
    p = jax.tree.map(jnp.asarray, params)
    p, _, loss = step(p, tx.init(p), batch)
    return (float(loss), {k: np.asarray(v) for k, v in _tree_paths(p)},
            {k: np.asarray(v) for k, v in _tree_paths(grads)})


def _port_step(kw, params, batch, lr):
    cfg = SenseVoiceConfig(**kw)
    _, grads = value_and_grad(from_numpy_tree(params), batch, cfg)
    tx, step = make_train_step(cfg, lr=lr)
    p = from_numpy_tree(params)
    p, _, loss = step(p, tx.init(p), batch)
    return (float(loss), {k: v.numpy() for k, v in _tree_paths(p)},
            {k: g.numpy() for (k, _), g in zip(_tree_paths(p), grads)})


@pytest.fixture(scope="module")
def legs_run(tmp_path_factory):
    """Inputs, the one-process references (JAX and the port), and every
    leg's results from one spawn of 8 ranks."""
    small, moe, dry, tp = _params(SMALL), _params(MOE), _params(DRYRUN), _params(TP)
    rng = np.random.default_rng(4)
    tp_feats = rng.standard_normal((2, 10, 560)).astype(np.float32)
    payload = {
        "small": {"cfg": SMALL, "params": small, "batch_dp": _batch(0, 4, 12, 4, 32),
                  "batch_sp": _batch(2, 2, 24, 4, 32)},
        "moe": {"cfg": MOE, "params": moe, "batch": _batch(9, 4, 12, 4, 32)},
        "dryrun": {"cfg": DRYRUN, "params": dry, "batch": _batch(0, 2, 24, 6, 64)},
        "tp": {"cfg": TP, "params": tp, "feats": tp_feats, "mask": np.ones((2, 10), np.float32)},
    }
    ranks = legs.run_ranks(legs.all_legs, 8, tmp_path_factory.mktemp("legs"), payload)
    refs = {
        "dp_tp": (SMALL, small, payload["small"]["batch_dp"], 1e-3),
        "moe": (MOE, moe, payload["moe"]["batch"], 1e-3),
        "dp_sp_tp": (SMALL, small, payload["small"]["batch_sp"], 1e-3),
        "dryrun_remat0": (DRYRUN, dry, payload["dryrun"]["batch"], 1e-4),
    }
    jax_ref = {k: _jax_step(*v) for k, v in refs.items()}
    port_ref = {k: _port_step(*v) for k, v in refs.items()}
    return payload, ranks, jax_ref, port_ref


def test_make_mesh_factoring(legs_run):
    assert mesh_shape(8) == {"data": 2, "model": 4}
    assert mesh_shape(8, model=2) == {"data": 4, "model": 2}
    assert mesh_shape(1) == {"data": 1, "model": 1}
    assert mesh_shape(8, seq=2, model=2) == {"data": 2, "seq": 2, "model": 2}
    with pytest.raises(AssertionError):
        mesh_shape(8, data=3, model=2)
    assert mesh_axes() == AXES and AXES3 == ("data", "seq", "model")
    _, ranks, _, _ = legs_run
    for r in ranks:  # the DeviceMesh each rank built
        assert r["mesh8"] == {"data": 2, "model": 4}
        assert r["mesh8_model2"] == {"data": 4, "model": 2}
        assert r["mesh8_seq2"] == {"data": 2, "seq": 2, "model": 2}
        assert r["bad_mesh"] == "AssertionError"


def test_param_rules():
    assert sensevoice_param_rules("layers/0/qkv/w") == (None, "model")
    assert sensevoice_param_rules("layers/7/ffn2/w") == ("model", None)
    assert sensevoice_param_rules("layers/3/norm1/g") == ()
    assert sensevoice_param_rules("embed/w") == ()
    # JAX's leniency: vocab 25,055 does not divide over model = 2
    assert placed_spec(sensevoice_param_rules("ctc/w"), (512, 25055), {"model": 2}) == ()
    assert placed_spec(sensevoice_param_rules("ctc/w"), (512, 25056), {"model": 2}) == \
        (None, "model")


def test_shard_params_places_on_mesh(legs_run):
    _, ranks, _, _ = legs_run
    for r in ranks:
        # column-parallel: each model-shard holds half the output features
        assert r["placed"]["qkv"] == (32, 96 // 2)
        assert r["placed"]["norm1"] == (32,)
        assert r["placed"]["layers_is_list"]
        # dp_put: batch 4 over data = 4, batch 3 (not divisible) replicated
        assert r["dp_put"] == ((1, 3), (3, 2))
        assert r["placements"] == ("[Shard(dim=0), Replicate()]", "[Replicate(), Replicate()]")


def test_spec_tree_matches_structure():
    params = _params(dict(SMALL, n_layers=2))
    specs = param_spec_tree(params)
    is_spec = lambda x: isinstance(x, tuple)  # noqa: E731
    assert jax.tree.structure(specs, is_leaf=is_spec) == jax.tree.structure(params)


def _check_step(legs_run, name, lr):
    """The leg's loss, gradients and params after its step, against the
    port's one-process step and JAX's. The loss at LOSS_RTOL on every rank
    (each holds the global loss); every rank's gradient leaves, made whole,
    at GRAD_REL of the leaf's max |grad|; qkv/w at PARAM_ATOL (the JAX
    test's check); every other element at PARAM_ATOL unless its reference
    gradient is rounding noise (below NOISE_REL of its leaf's max), and
    those within 2·lr (measured: the others at most 1.5e-5, on the moe
    leg; one rounding-level element of embed/w 9.2e-4 off, its gradient
    2e-7 of the leaf's max, on the dp x tp leg)."""
    _, ranks, jax_ref, port_ref = legs_run
    got = ranks[0][name]
    for loss, params, grads in (port_ref[name], jax_ref[name]):
        for r in ranks:
            np.testing.assert_allclose(r[name]["loss"], loss, rtol=LOSS_RTOL)
            assert set(r[name]["grads"]) == set(grads)
            for k, want in grads.items():
                scale = max(np.abs(want).max(), 1e-30)
                assert np.abs(r[name]["grads"][k] - want).max() <= GRAD_REL * scale, k
        np.testing.assert_allclose(got["params"]["layers/0/qkv/w"], params["layers/0/qkv/w"],
                                   atol=PARAM_ATOL)
        for k, want in params.items():
            d = np.abs(got["params"][k] - want)
            g = np.abs(jax_ref[name][2][k])
            noise = g < NOISE_REL * g.max()
            assert d[~noise].max(initial=0.0) <= PARAM_ATOL, (k, d[~noise].max())
            assert d.max() <= 2 * lr, (k, d.max())


def _really_sharded(local: dict, params: dict, rules_axis: int):
    """Every leaf the rules split holds 1/rules_axis of its elements here."""
    params = dict(_tree_paths(params))
    for path, shape in local.items():
        full = params[path].size
        split = placed_spec(sensevoice_param_rules(path), params[path].shape,
                            {"model": rules_axis}) != ()
        assert int(np.prod(shape)) == (full // rules_axis if split else full), path


def test_sharded_train_step_runs_and_matches_single_device(legs_run):
    payload, ranks, _, _ = legs_run
    _check_step(legs_run, "dp_tp", 1e-3)
    for r in ranks:
        _really_sharded(r["dp_tp"]["local"], payload["small"]["params"], 2)
        assert r["dp_tp"]["mu_local"] == r["dp_tp"]["local"]  # moments as the params
        assert r["dp_tp"]["feats_local"] == (1, 12, 560)  # batch 4 over data = 4


def test_3d_mesh_with_sequence_parallelism(legs_run):
    _, ranks, _, _ = legs_run
    _check_step(legs_run, "dp_sp_tp", 1e-3)
    for r in ranks:  # feats really sharded over seq: T/2 frames a rank
        assert r["dp_sp_tp"]["feats_local"] == (1, 12, 560)


def test_moe_expert_parallel_train_step(legs_run):
    _, ranks, _, _ = legs_run
    _check_step(legs_run, "moe", 1e-3)
    for r in ranks:  # experts really sharded: each model-shard holds E/2 experts
        assert r["moe"]["w1_local"][0] == 2


def test_dryrun_multichip_first_leg_matches_jax(legs_run):
    """2 x 2 x 2 with 4 experts at dryrun_multichip's lr: JAX's loss
    (13.8813, MULTICHIP_r05.json) and params on the same weights; with
    remat the same loss and params."""
    payload, ranks, _, _ = legs_run
    _check_step(legs_run, "dryrun_remat0", 1e-4)
    np.testing.assert_allclose(ranks[0]["dryrun_remat0"]["loss"], 13.8813, atol=1e-4)
    a, b = ranks[0]["dryrun_remat0"], ranks[0]["dryrun_remat1"]
    assert a["loss"] == b["loss"]
    for k in a["params"]:
        np.testing.assert_array_equal(a["params"][k], b["params"][k], err_msg=k)
    for r in ranks:
        _really_sharded(r["dryrun_remat0"]["local"], payload["dryrun"]["params"], 2)


def test_tensor_parallel_inference_matches_single_device(legs_run):
    payload, ranks, _, _ = legs_run
    tp = payload["tp"]
    want = np.asarray(jax.jit(lambda p, f, m: jencode(p, f, m, JConfig(**TP)))(
        tp["params"], tp["feats"], tp["mask"]))
    with torch.no_grad():
        one = sensevoice_encode(from_numpy_tree(tp["params"]), torch.from_numpy(tp["feats"]),
                                torch.from_numpy(tp["mask"]), SenseVoiceConfig(**TP)).numpy()
    for r in ranks:  # model = 4: qkv [32, 96] a quarter a rank
        assert r["tp4"]["qkv_local"] == (32, 24)
        np.testing.assert_allclose(r["tp4"]["logits"], want, atol=PARAM_ATOL)
        np.testing.assert_allclose(r["tp4"]["logits"], one, atol=PARAM_ATOL)
