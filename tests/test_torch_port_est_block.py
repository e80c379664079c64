"""Kernel 10's module (lele_tpu_torch/kernels/est_block.py) against the TPU
kernel it replaces, `estimator_blocks_pallas`, run in interpret mode: the
plain version, the wrapper's CPU route, the weight stacking and the stated
range. A last case needs the card and skips without one.

Shapes follow tests/test_est_block.py: D 256, 4 heads, F 512, 2 layers (4
blocks), inputs from numpy seeds. Tolerance of the plain version against
the TPU kernel: one bf16 step at the largest magnitude, 2^-8 · max|want|.
Both round the same operands to bf16, but an f32 sum taken in another order
can round one of them to the neighbouring bf16 value, which the next
product carries (measured up to 1.6e-3 · max|want| at these shapes). The
kernel against the plain version on a card: the same bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lele_tpu.kernels import est_block as jest
from lele_tpu.models.supertonic import SupertonicConfig as JaxConfig
from lele_tpu.models.supertonic import _init_attn_block
from lele_tpu_torch.kernels import KERNEL_WRAPPERS, est_block
from lele_tpu_torch.models.supertonic import SupertonicConfig
from lele_tpu_torch.params import from_numpy_tree

D, FFN, HEADS, LAYERS = 256, 512, 4, 2
BF16_STEP = 2.0 ** -8


def _blocks(seed, n_layers=LAYERS, d=D, ffn=FFN):
    ks = jax.random.split(jax.random.PRNGKey(seed), n_layers)
    return [{"self": _init_attn_block(jax.random.fold_in(k, 0), d, ffn),
             "cross": _init_attn_block(jax.random.fold_in(k, 1), d, ffn)} for k in ks]


def _stacked(blocks, device="cpu"):
    return est_block.stack_est_blocks(from_numpy_tree(jax.tree.map(np.asarray, blocks), device))


def _inputs(T, Tk, seed=0, lm_tail=5, tm_tail=3):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((T, D)) * 0.3).astype(np.float32)
    text = (rng.standard_normal((Tk, D)) * 0.3).astype(np.float32)
    lm = np.ones((T,), np.float32)
    lm[T - lm_tail:] = 0.0
    tm = np.ones((Tk,), np.float32)
    tm[Tk - tm_tail:] = 0.0
    return x, text, lm, tm


def _torch(*arrays, device="cpu"):
    return [torch.from_numpy(a).to(device) for a in arrays]


def _within_a_bf16_step(got, want):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=BF16_STEP * np.abs(want).max())


@pytest.mark.parametrize("T,Tk,tails", [(48, 19, (5, 3)), (32, 32, (5, 3)), (32, 32, (0, 0)),
                                        (17, 40, (16, 39)), (24, 1, (0, 0)), (24, 1, (3, 0)),
                                        (29, 19, (0, 18))],
                         ids=["48x19", "32x32", "32x32_unmasked", "17x40_one_valid_row",
                              "24x1", "24x1_latent_tail", "29x19_one_text_row"])
def test_plain_matches_tpu_kernel(T, Tk, tails):
    blocks = _blocks(1)
    x, text, lm, tm = _inputs(T, Tk, 0, *tails)
    want = jest.estimator_blocks_pallas(jnp.asarray(x), jnp.asarray(text), jnp.asarray(lm),
                                        jnp.asarray(tm), blocks, HEADS, interpret=True)
    got = est_block.estimator_blocks_plain(*_torch(x, text, lm, tm), _stacked(blocks), HEADS)
    _within_a_bf16_step(got, want)
    assert np.corrcoef(got.numpy().ravel(), np.asarray(want).ravel())[0, 1] > 0.99999


def test_masked_tail_does_not_leak():
    """Zeros on the latent mask's tail leave the valid rows as a shorter run
    of the same rows gives them (tests/test_est_block.py's check)."""
    blocks = _stacked(_blocks(2, n_layers=1))
    T, Tv, Tk = 32, 24, 16
    x, text, _, _ = _inputs(T, Tk, 1, 0, 0)
    x[Tv:] = 0.0
    lm = np.zeros((T,), np.float32)
    lm[:Tv] = 1.0
    tm = np.ones((Tk,), np.float32)
    a = est_block.estimator_blocks_plain(*_torch(x, text, lm, tm), blocks, HEADS)
    b = est_block.estimator_blocks_plain(*_torch(x[:Tv], text, lm[:Tv], tm), blocks, HEADS)
    np.testing.assert_allclose(a[:Tv].numpy(), b.numpy(), rtol=1e-5, atol=1e-5)


def test_stacking_matches_tpu_kernel_order():
    blocks = _blocks(3)
    want = jax.tree.map(np.asarray, jest._stack_est_blocks(blocks))
    got = _stacked(blocks)
    assert got.keys() == want.keys()
    for name in want:
        for leaf in want[name]:
            t = got[name][leaf]
            assert t.is_contiguous() and t.shape == want[name][leaf].shape
            if leaf == "w":
                assert t.dtype == torch.bfloat16
                ref = torch.from_numpy(np.array(want[name][leaf])).to(torch.bfloat16)
                assert torch.equal(t, ref)
            else:
                assert t.dtype == torch.float32
                np.testing.assert_array_equal(t.numpy(), want[name][leaf])


def test_wrapper_takes_the_plain_version_on_the_cpu():
    stacked = _stacked(_blocks(4, n_layers=1))
    args = _torch(*_inputs(37, 19, 2))
    before = est_block.estimator_blocks.launches
    got = est_block.estimator_blocks(*args, stacked, HEADS)
    assert torch.equal(got, est_block.estimator_blocks_plain(*args, stacked, HEADS))
    assert est_block.estimator_blocks.launches == before  # no kernel ran
    assert KERNEL_WRAPPERS["est_block"] is est_block.estimator_blocks
    with pytest.raises(ValueError, match="not on a CUDA card"):
        est_block.estimator_blocks_kernel(*args, stacked, HEADS)


@pytest.mark.parametrize("bad", ["text_width", "mask_len", "odd_blocks"])
def test_wrapper_rejects_bad_shapes(bad):
    stacked = _stacked(_blocks(5, n_layers=1))
    x, text, lm, tm = _torch(*_inputs(16, 8, 3))
    if bad == "text_width":
        text = text[:, :128]
    elif bad == "mask_len":
        lm = lm[:-1]
    else:
        stacked = {k: {leaf: v[:1] for leaf, v in sub.items()} for k, sub in stacked.items()}
    with pytest.raises(ValueError, match="estimator_blocks"):
        est_block.estimator_blocks(x, text, lm, tm, stacked, HEADS)


def test_kernel_range_covers_every_configuration():
    """tts.json, the default config, the test configs and every latent and
    token bucket; not a head dim or width the kernel has no form for."""
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "examples" / "supertonic" / "tts.json"
    for cfg in (SupertonicConfig.from_json(path), SupertonicConfig(),
                SupertonicConfig(d_text=64, n_heads=2, ffn_mult=2)):
        d, f = cfg.d_text, cfg.d_text * cfg.ffn_mult
        for T in (1, 37, *cfg.latent_buckets, 1024):
            for Tk in (1, 19, *cfg.token_buckets):
                assert est_block.kernel_takes(T, Tk, d, cfg.n_heads, f), (T, Tk, d)
    jcfg = JaxConfig()
    assert est_block.kernel_takes(1024, 320, jcfg.d_text, jcfg.n_heads,
                                  jcfg.d_text * jcfg.ffn_mult)
    assert est_block.kernel_takes(48, 19, D, HEADS, FFN)
    for T, Tk, d, h, f in ((0, 5, 256, 4, 1024), (5, 0, 256, 4, 1024), (8, 8, 192, 4, 1024),
                           (8, 8, 256, 3, 1024), (8, 8, 256, 1, 1024), (8, 8, 256, 4, 1000)):
        assert not est_block.kernel_takes(T, Tk, d, h, f)


@pytest.mark.cuda
@pytest.mark.parametrize("T,Tk", [(1024, 320), (37, 19)])
def test_kernel_matches_plain_on_the_card(T, Tk):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: kernel 10 is CUDA C++ (csrc/est_block.cu) "
                    "with no CPU form; chip_smoke.py runs this check on the card")
    stacked = _stacked(_blocks(6, n_layers=4, ffn=1024), "cuda")
    args = _torch(*_inputs(T, Tk, 4), device="cuda")
    want = est_block.estimator_blocks_plain(*args, stacked, HEADS)
    before = est_block.estimator_blocks.launches
    got = est_block.estimator_blocks(*args, stacked, HEADS)
    torch.cuda.synchronize()
    assert est_block.estimator_blocks.launches == before + 1
    _within_a_bf16_step(got, want.cpu().numpy())


def test_kernel_entry_checks_the_range_first():
    """A head dim the kernel does not compile is refused before the device
    is looked at; within the range, a CPU tensor is refused (the wrapper,
    not the kernel entry, takes the plain version)."""
    stacked = _stacked(_blocks(6, n_layers=1))
    args = _torch(*_inputs(16, 8, 4))
    with pytest.raises(ValueError, match="outside the kernel's range"):
        est_block.estimator_blocks_kernel(*args, stacked, 16)  # head dim 16
    with pytest.raises(ValueError, match="not on a CUDA card"):
        est_block.estimator_blocks_kernel(*args, stacked, HEADS)
