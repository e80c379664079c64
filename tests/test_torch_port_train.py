"""The port's training (lele_tpu_torch/train, remat) against lele_tpu's on
the same weights and batches.

Weights come from the JAX package's init (torch cannot reproduce
jax.random) through params.from_numpy_tree; batches are numpy from a seed.
JAX's CTC is optax.ctc_loss and its optimizer optax.adamw; the port has
its own copies of both (the card machine has neither package).
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from lele_tpu.models import SenseVoiceConfig as JConfig
from lele_tpu.models import init_sensevoice as jinit
from lele_tpu.train import ctc_loss_fn as jloss_fn
from lele_tpu.train import make_train_step as jmake_train_step
from lele_tpu_torch.models import SenseVoiceConfig
from lele_tpu_torch.parallel.sharding import _tree_paths
from lele_tpu_torch.params import from_numpy_tree, from_optax_adamw_state, tree_leaves
from lele_tpu_torch.train import (
    TrainState,
    ctc_loss,
    ctc_loss_fn,
    ctc_train_step,
    make_train_step,
)
from lele_tpu_torch.train.checkpoint import latest_step, restore_train_state, save_train_state
from lele_tpu_torch.train.trainer import AdamW, _as_batch, value_and_grad

# dryrun_multichip's config (__graft_entry__.py:45-48)
DRYRUN = dict(n_layers=2, d_model=64, ffn_dim=128, vocab_size=64, n_heads=2,
              dtype="float32", n_experts=4)
LOSS_RTOL = 1e-5  # the loss against JAX's (measured: at most 5.0e-7 relative)
# each leaf's max|d| over its max|grad| (measured: at most 6.7e-6 at the
# dryrun config, with and without experts, full and ragged masks)
GRAD_REL = 2e-5
# AdamW on the same gradients (measured max|d|: params 3.0e-8, mu 1.5e-8,
# nu 9.3e-10)
ADAM_ATOL = 1e-6
# After one step from the same state, an element whose reference gradient
# is rounding noise (below NOISE_REL of its leaf's max |grad|) moves by lr
# either way in each package, as Adam divides each gradient by its own size:
# the key third of qkv/b has gradient 0 in exact arithmetic (a softmax
# ignores a constant added to every score of a query) and ~1e-9 in f32.
# Every other element is held to STEP_ATOL. Measured at lr 1e-3 on the
# dryrun config, each step from optax's state: at most 5.0e-6 (the
# rounding-level ones up to 1.1e-3); mu at most 9.5e-6 of its leaf's max,
# held to GRAD_REL, and nu, which holds g² and so twice the gradient's
# relative gap, 1.5e-5, held to 2·GRAD_REL. Run free, the two trajectories part where a rounding-level
# element moved (embed/w's moves every frame's features), so over 3 free
# steps the losses are held to LOSS_RTOL and every element to lr x steps.
NOISE_REL = 1e-6
STEP_ATOL = 1e-5
# bf16 compute (2 layers, d 64, ragged masks): measured loss 5.1e-6
# relative, gradients 5.1e-3 of a leaf's max|grad| (the two packages round
# the backward's products to bf16 in other places)
BF16_LOSS_RTOL = 1e-4
BF16_GRAD_REL = 2e-2


def _batch(cfg_kw, B=2, T=24, L=6, seed=0):
    """dryrun_multichip's batch shapes (B 2, T 24, L 6) from a seed."""
    rng = np.random.default_rng(seed)
    return {
        "feats": rng.standard_normal((B, T, 560)).astype(np.float32),
        "feat_mask": np.ones((B, T), np.float32),
        "labels": rng.integers(1, cfg_kw["vocab_size"], (B, L)).astype(np.int32),
        "label_mask": np.ones((B, L), np.float32),
    }


def _ragged(batch):
    b = {k: v.copy() for k, v in batch.items()}
    b["feat_mask"][1, 17:] = 0.0
    b["label_mask"][1, 4:] = 0.0
    return b


def _impossible(batch):
    """Sequence 0 has 6 labels and 3 frames: no alignment exists."""
    b = {k: v.copy() for k, v in batch.items()}
    b["feat_mask"][0, 3:] = 0.0
    return b


BATCHES = {"full": lambda b: b, "ragged": _ragged, "impossible": _impossible}


def _jax_params(cfg_kw, seed=0):
    return jax.tree.map(np.asarray, jinit(jax.random.PRNGKey(seed), JConfig(**cfg_kw)))


def _by_path(tree) -> dict:
    return {p: np.asarray(v) for p, v in _tree_paths(tree)}


def _port_grads(params_np, batch, cfg_kw):
    tp = from_numpy_tree(params_np)
    loss, grads = value_and_grad(tp, batch, SenseVoiceConfig(**cfg_kw))
    return float(loss), {p: g.numpy() for (p, _), g in zip(_tree_paths(tp), grads)}


@pytest.fixture(scope="module")
def dryrun_params():
    return _jax_params(DRYRUN)


@pytest.mark.parametrize("kind", list(BATCHES))
def test_ctc_loss_fn_matches_jax(dryrun_params, kind):
    batch = BATCHES[kind](_batch(DRYRUN))
    want = float(jloss_fn(dryrun_params, batch, JConfig(**DRYRUN)))
    got = float(ctc_loss_fn(from_numpy_tree(dryrun_params), _as_batch(batch, "cpu"),
                            SenseVoiceConfig(**DRYRUN)))
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert np.isfinite(got)
    if kind == "impossible":  # optax's log_epsilon, not F.ctc_loss's inf
        assert got > 1e5 / batch["label_mask"].sum() * 0.9


@pytest.mark.parametrize("kind", list(BATCHES))
def test_ctc_loss_per_sequence_matches_optax(kind):
    """The recursion alone, on the same log-probs and paddings."""
    batch = BATCHES[kind](_batch(DRYRUN))
    rng = np.random.default_rng(7)
    logits = rng.standard_normal((2, 24, 64)).astype(np.float32) * 3
    want = np.asarray(optax.ctc_loss(logits, 1.0 - batch["feat_mask"], batch["labels"],
                                     1.0 - batch["label_mask"]))
    got = ctc_loss(torch.from_numpy(logits), torch.from_numpy(1.0 - batch["feat_mask"]),
                   torch.from_numpy(batch["labels"]).long(),
                   torch.from_numpy(1.0 - batch["label_mask"])).numpy()
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    if kind == "impossible":
        assert 0.9e5 < got[0] < 1.1e5
        inf = torch.nn.functional.ctc_loss(
            torch.log_softmax(torch.from_numpy(logits), -1).transpose(0, 1),
            torch.from_numpy(batch["labels"]).long(), torch.tensor([3, 24]),
            torch.tensor([6, 6]), reduction="none")
        assert torch.isinf(inf[0])  # what the library loss would have given


@pytest.mark.parametrize("n_experts", [0, 4])
@pytest.mark.parametrize("kind", ["full", "ragged"])
def test_grads_match_jax_on_every_leaf(n_experts, kind):
    kw = dict(DRYRUN, n_experts=n_experts)
    params = _jax_params(kw)
    batch = BATCHES[kind](_batch(kw))
    jl, jg = jax.value_and_grad(jloss_fn)(params, batch, JConfig(**kw))
    jg = _by_path(jax.tree.map(np.asarray, jg))
    loss, grads = _port_grads(params, batch, kw)
    np.testing.assert_allclose(loss, float(jl), rtol=LOSS_RTOL)
    assert set(grads) == set(jg)
    for path, g in grads.items():
        scale = max(np.abs(jg[path]).max(), 1e-30)
        assert np.abs(g - jg[path]).max() <= GRAD_REL * scale, path


def test_adamw_matches_optax_on_the_same_grads(dryrun_params):
    """optax.adamw(1e-3) and the port's AdamW(1e-3), 3 updates on the same
    random gradients: params, both moments and the count."""
    rng = np.random.default_rng(3)
    grads = [jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 10.0 ** rng.uniform(-6, 0)
                                     ).astype(np.float32), dryrun_params) for _ in range(3)]
    tx = optax.adamw(1e-3)
    jp = jax.tree.map(jnp.asarray, dryrun_params)
    jo = tx.init(jp)
    port = AdamW(1e-3)
    tp = from_numpy_tree(dryrun_params)
    to = port.init(tp)
    for g in grads:
        u, jo = tx.update(jax.tree.map(jnp.asarray, g), jo, jp)
        jp = optax.apply_updates(jp, u)
        port.update(tree_leaves(from_numpy_tree(g)), to, tp)
    for got, want in ((tp, jp), (to["mu"], jo[0].mu), (to["nu"], jo[0].nu)):
        want = _by_path(jax.tree.map(np.asarray, want))
        for path, t in _tree_paths(got):
            np.testing.assert_allclose(t.numpy(), want[path], atol=ADAM_ATOL, rtol=1e-6,
                                       err_msg=path)
    assert int(to["count"]) == int(jo[0].count) == 3


def _jax_grads(params, batch, cfg_kw) -> dict:
    _, grads = jax.value_and_grad(jloss_fn)(params, batch, JConfig(**cfg_kw))
    return _by_path(jax.tree.map(np.asarray, grads))


def _hold_step(got_params, got_opt, want_params, want_opt, ref_grads, lr):
    """One step from the same state: every param element within STEP_ATOL
    unless its reference gradient is rounding noise, those within 2·lr; mu
    within GRAD_REL and nu within 2·GRAD_REL of each leaf's max."""
    want = _by_path(jax.tree.map(np.asarray, want_params))
    for path, t in _tree_paths(got_params):
        d = np.abs(t.numpy() - want[path])
        g = np.abs(ref_grads[path])
        noise = g < NOISE_REL * g.max()
        assert d[~noise].max(initial=0.0) <= STEP_ATOL, (path, d[~noise].max())
        assert d.max() <= 2 * lr, (path, d.max())
    for name, moment, rel in (("mu", want_opt[0].mu, GRAD_REL),
                              ("nu", want_opt[0].nu, 2 * GRAD_REL)):
        want = _by_path(jax.tree.map(np.asarray, moment))
        for path, t in _tree_paths(got_opt[name]):
            scale = max(np.abs(want[path]).max(), 1e-30)
            assert np.abs(t.numpy() - want[path]).max() <= rel * scale, (name, path)
    assert int(got_opt["count"]) == int(want_opt[0].count)


def _carried(jp, jo):
    """JAX's params and optax state carried into the port."""
    return (from_numpy_tree(jax.tree.map(np.asarray, jp)),
            from_optax_adamw_state(jax.tree.map(np.asarray, jo)))


def test_three_train_steps_match_optax(dryrun_params):
    """3 steps at lr 1e-3. Each step from optax's state (params and adamw
    state carried across) against optax's step, element by element; the
    port's own loop, in place, against optax's: the loss of every step and
    every element within lr x steps."""
    batch = _batch(DRYRUN)
    tx, jstep = jmake_train_step(JConfig(**DRYRUN), lr=1e-3)
    jp = jax.tree.map(jnp.asarray, dryrun_params)
    jo = tx.init(jp)
    ttx, tstep = make_train_step(SenseVoiceConfig(**DRYRUN), lr=1e-3)
    tp = from_numpy_tree(dryrun_params)
    to = ttx.init(tp)
    for _ in range(3):
        grads = _jax_grads(jp, batch, DRYRUN)
        cp, co = _carried(jp, jo)
        tstep(cp, co, batch)
        jp, jo, jl = jstep(jp, jo, batch)
        _hold_step(cp, co, jp, jo, grads, 1e-3)
        tp2, to2, tl = tstep(tp, to, batch)
        assert tp2 is tp and to2 is to  # updated in place, as JAX donates
        np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    want = _by_path(jax.tree.map(np.asarray, jp))
    for path, t in _tree_paths(tp):
        assert np.abs(t.numpy() - want[path]).max() <= 3e-3, path
    assert int(to["count"]) == 3


def test_optax_state_carries_into_the_port(dryrun_params):
    """JAX's step 1, its params and adamw state carried across
    (params.from_optax_adamw_state), then the port's step 2 = JAX's step 2."""
    batch, batch2 = _batch(DRYRUN), _batch(DRYRUN, seed=1)
    tx, jstep = jmake_train_step(JConfig(**DRYRUN), lr=1e-3)
    jp = jax.tree.map(jnp.asarray, dryrun_params)
    jp, jo, _ = jstep(jp, tx.init(jp), batch)
    tp, to = _carried(jp, jo)
    assert to["count"].shape == () and int(to["count"]) == 1
    grads = _jax_grads(jp, batch2, DRYRUN)
    _, tstep = make_train_step(SenseVoiceConfig(**DRYRUN), lr=1e-3)
    tp, to, tl = tstep(tp, to, batch2)
    jp, jo, jl = jstep(jp, jo, batch2)
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    _hold_step(tp, to, jp, jo, grads, 1e-3)


def test_remat_forward_and_grad_match():
    """tests/test_models.py:395 with gradients: remat changes neither the
    loss nor any gradient (the port's checkpointed blocks recompute the
    same bits), and both match JAX's remat loss."""
    kw = dict(n_layers=2, d_model=32, ffn_dim=64, vocab_size=40, n_heads=2, dtype="float32")
    params = _jax_params(kw)
    rng = np.random.default_rng(0)
    batch = {
        "feats": rng.standard_normal((2, 10, 560)).astype(np.float32),
        "feat_mask": np.ones((2, 10), np.float32),
        "labels": rng.integers(1, 40, (2, 3)).astype(np.int32),
        "label_mask": np.ones((2, 3), np.float32),
    }
    loss, grads = _port_grads(params, batch, kw)
    loss_r, grads_r = _port_grads(params, batch, dict(kw, remat=True))
    assert loss == loss_r
    for path in grads:
        np.testing.assert_array_equal(grads_r[path], grads[path], err_msg=path)
    jl = jloss_fn(params, batch, JConfig(**kw, remat=True))
    np.testing.assert_allclose(loss_r, float(jl), rtol=LOSS_RTOL)
    _, step = make_train_step(SenseVoiceConfig(**kw, remat=True), lr=1e-3)
    tx, step0 = make_train_step(SenseVoiceConfig(**kw), lr=1e-3)
    a, b = from_numpy_tree(params), from_numpy_tree(params)
    step(a, tx.init(a), batch)
    step0(b, tx.init(b), batch)
    for (path, x), (_, y) in zip(_tree_paths(a), _tree_paths(b)):
        assert torch.equal(x, y), path


def test_train_checkpoint_roundtrip(tmp_path):
    """tests/test_sharding.py:171 on one process: params, moments and step
    restored exactly, and the next step the same bits as continuing."""
    kw = dict(n_layers=1, d_model=32, ffn_dim=64, vocab_size=32, n_heads=2, dtype="float32")
    cfg = SenseVoiceConfig(**kw)
    rng = np.random.default_rng(5)
    batch = {
        "feats": rng.standard_normal((2, 10, 560)).astype(np.float32),
        "feat_mask": np.ones((2, 10), np.float32),
        "labels": rng.integers(1, 32, (2, 3)).astype(np.int32),
        "label_mask": np.ones((2, 3), np.float32),
    }
    params = from_numpy_tree(_jax_params(kw))
    tx, step = make_train_step(cfg, lr=1e-3)
    opt = tx.init(params)
    params, opt, _ = step(params, opt, batch)
    save_train_state(tmp_path, params, opt, 1)
    assert latest_step(tmp_path) == 1

    fresh_p = from_numpy_tree(_jax_params(kw, seed=1))
    fresh_o = tx.init(fresh_p)
    rp, ro, rstep = restore_train_state(tmp_path, fresh_p, fresh_o)
    assert rstep == 1
    for (path, x), (_, y) in zip(_tree_paths({"p": rp, "o": ro}),
                                 _tree_paths({"p": params, "o": opt})):
        assert x.dtype == y.dtype and torch.equal(x, y), path
    p1, o1, l1 = step(params, opt, batch)
    p2, o2, l2 = step(rp, ro, batch)
    assert float(l1) == float(l2)
    for (path, x), (_, y) in zip(_tree_paths({"p": p1, "o": o1}),
                                 _tree_paths({"p": p2, "o": o2})):
        assert torch.equal(x, y), path
    save_train_state(tmp_path, p1, o1, 2)
    assert latest_step(tmp_path) == 2
    with pytest.raises(FileNotFoundError):
        restore_train_state(tmp_path / "none", fresh_p, fresh_o)


def test_ctc_train_step_wraps_the_same_body(dryrun_params):
    batch = _batch(DRYRUN)
    cfg = SenseVoiceConfig(**DRYRUN)
    tx, step = make_train_step(cfg, lr=1e-3)
    a, b = from_numpy_tree(dryrun_params), from_numpy_tree(dryrun_params)
    state, loss = ctc_train_step(TrainState(a, tx.init(a)), batch, cfg, tx)
    _, _, loss2 = step(b, tx.init(b), batch)
    assert state.step == 1 and float(loss) == float(loss2)
    for (path, x), (_, y) in zip(_tree_paths(state.params), _tree_paths(b)):
        assert torch.equal(x, y), path


def test_bf16_compute_matches_jax():
    kw = dict(n_layers=2, d_model=64, ffn_dim=128, vocab_size=64, n_heads=2,
              dtype="bfloat16")
    params = _jax_params(kw)
    batch = _ragged(_batch(kw))
    jl, jg = jax.value_and_grad(jloss_fn)(params, batch, JConfig(**kw))
    jg = _by_path(jax.tree.map(np.asarray, jg))
    loss, grads = _port_grads(params, batch, kw)
    np.testing.assert_allclose(loss, float(jl), rtol=BF16_LOSS_RTOL)
    for path, g in grads.items():
        scale = max(np.abs(jg[path]).max(), 1e-30)
        assert np.abs(g - jg[path]).max() <= BF16_GRAD_REL * scale, path
