"""Kernel 12's route: the port's flash attention against the JAX package's.

- `flash_attention_plain` (the kernel's plain version, which the wrapper runs
  for a CPU tensor) against JAX's einsum path and an f64 oracle, at
  flash-eligible shapes: causal with a float mask, a float mask, a bool mask
  with a fully masked row (no causal: there JAX's two routes differ, the
  einsum path averaging over every key), GQA, and the mask-scaling regression of
  scripts/flash_attention_tpu.py:72-115 (a float mask times 2 at D 128).
  Off the TPU JAX declines its flash route, so its Attention emitter runs
  the einsum path: the reference for the port's flash route. Gates: the
  plain version within JAX's own Attention tolerance of the einsum path
  (rtol 2e-5, atol 2e-6), and its error against the f64 oracle within
  3 x max(the einsum path's, 1e-6), the TPU script's kernel gate.
- The port's Attention emitter on the same ONNX bytes as JAX's: an eligible
  node takes the flash route (`ATTENTION_ROUTES`), and agrees with JAX's.
- `kernel_takes` against JAX's gate (`_flash_attention_maybe` with its TPU
  test patched true and the library kernel stubbed) over a grid of shapes
  and attributes.
- The wrapper takes the plain version for any CPU tensor and counts no
  launch; the kernel entry refuses a CPU tensor.
- The kernel's exact skipping of masked key tiles, through its plain
  counterpart `skippable_tiles`: setting the bias of every tile it marks to
  -inf leaves `flash_attention_plain` bit-equal (the prefill, chunked
  prefill, bool with a fully masked row, and 2 x randn masks), and it never
  marks a tile of a q tile that holds a fully masked row; at the pair
  granularity it counts the 0 entries of a 0 / -1e9 mask.
- The kernel's 3xTF32 products, emulated (TF32 rounding by bit masks on the
  f32 view): within chip_smoke.FLASH_REL of the plain version at two of
  chip_smoke.FLASH_SHAPES scaled to Lq <= 256, where one TF32 product is not.
- On a card (marked `cuda`, skipped here): the kernel against its plain
  version.
"""

import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lele_tpu.compiler import compile_model as j_compile
from lele_tpu.onnx.loader import OnnxModel as JOnnxModel
from lele_tpu.ops import attention_ops as j_att
from lele_tpu_torch import kernels as K
from lele_tpu_torch.compiler import compile_model
from lele_tpu_torch.onnx import builder as ob
from lele_tpu_torch.onnx.synth import attn23_step_feeds
from lele_tpu_torch.ops import attention_ops

fa = sys.modules[K.flash_attention.__module__]  # the module, which its wrapper shadows
ATT = dict(rtol=2e-5, atol=2e-6)


def _case(name, seed=0):
    """(q, k, v, mask or None, attrs) of one eligible case, numpy f32."""
    rng = np.random.default_rng(seed)
    B, H, KVH, Lq, Lk, D = {"causal": (1, 2, 2, 128, 128, 16),
                            "float_mask": (2, 2, 2, 128, 256, 32),
                            "bool_mask": (1, 2, 2, 128, 128, 24),
                            "gqa": (1, 4, 2, 128, 256, 16),
                            "mask_scaling": (1, 4, 4, 256, 256, 128)}[name]
    q = rng.standard_normal((B, H, Lq, D)).astype(np.float32)
    k = rng.standard_normal((B, KVH, Lk, D)).astype(np.float32)
    v = rng.standard_normal((B, KVH, Lk, D)).astype(np.float32)
    mask, attrs = None, {}
    if name == "causal":  # with a float mask: the kernel adds both
        attrs["is_causal"] = 1
        mask = rng.standard_normal((Lq, Lk)).astype(np.float32)
    elif name in ("float_mask", "mask_scaling"):
        mask = (rng.standard_normal((B, 1, Lq, Lk)) * 2).astype(np.float32)
    elif name == "bool_mask":
        mask = rng.random((B, 1, Lq, Lk)) > 0.3
        mask[0, 0, 5] = False  # a fully masked row: the uniform average of v
    elif name == "gqa":
        mask = np.where(np.arange(Lk)[None, :] <= np.arange(Lq)[:, None] + 100, 0.0,
                        -1e9).astype(np.float32)[None, None]
    return q, k, v, mask, attrs


def _graph(q, k, v, mask, attrs):
    names = ["q", "k", "v"] + (["m"] if mask is not None else [])
    arrays = dict(zip(names, (q, k, v, mask)))
    bs = ob.build_model_bytes(
        [ob.node("Attention", names, ["y"], **attrs)],
        inputs=[ob.value_info(n, ob.NP_TO_ONNX[a.dtype], list(a.shape))
                for n, a in arrays.items()],
        outputs=[ob.value_info("y", 1, [])], opset=23)
    return bs, arrays


def _oracle(q, k, v, mask, causal):
    """f64 attention. A False entry of a bool mask weighs nothing, and a row
    with no True entry averages v uniformly: what -1e9 gives in f32, where
    it swallows every score."""
    rep = q.shape[1] // k.shape[1]
    kd = np.repeat(k.astype(np.float64), rep, 1)
    vd = np.repeat(v.astype(np.float64), rep, 1)
    s = q.astype(np.float64) @ kd.transpose(0, 1, 3, 2) / np.sqrt(q.shape[-1])
    if mask is not None:
        s = np.where(mask, s, -1e300) if mask.dtype == bool else s + mask.astype(np.float64)
    if causal:
        s = np.where(np.tril(np.ones(s.shape[-2:], bool)), s, -np.inf)
    w = np.exp(s - s.max(-1, keepdims=True))
    return (w / w.sum(-1, keepdims=True)) @ vd


@pytest.mark.parametrize("name", ["causal", "float_mask", "bool_mask", "gqa", "mask_scaling"])
def test_plain_matches_jax_einsum_path_and_f64_oracle(name):
    q, k, v, mask, attrs = _case(name, seed=len(name))
    bs, arrays = _graph(q, k, v, mask, attrs)
    want = j_compile(JOnnxModel.from_bytes(bs), strict=True).run_np(**arrays)[0]
    tm = None if mask is None else torch.from_numpy(mask)
    got = K.flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                  tm, bool(attrs.get("is_causal")),
                                  1.0 / np.sqrt(q.shape[-1])).numpy()
    np.testing.assert_allclose(got, want, **ATT)
    exact = _oracle(q, k, v, mask, attrs.get("is_causal"))
    mag = np.abs(exact).max()
    e_plain = np.abs(got - exact).max() / mag
    e_jax = np.abs(want - exact).max() / mag
    assert e_plain < 2e-2 and e_plain < 3 * max(e_jax, 1e-6), (e_plain, e_jax)

    # the port's emitter on the same bytes takes the flash route
    before = dict(attention_ops.ATTENTION_ROUTES)
    cm = compile_model(bs, device="cpu", strict=True)
    out = cm.run_np(**arrays)[0]
    assert attention_ops.ATTENTION_ROUTES["flash_attn"] == before["flash_attn"] + 2  # trace, run
    assert attention_ops.ATTENTION_ROUTES["einsum"] == before["einsum"]
    np.testing.assert_allclose(out, want, **ATT)


def test_mask_is_added_after_scaling():
    """The regression of scripts/flash_attention_tpu.py:72-115: a mask scaled
    as the library TPU kernel's bias (before the softmax scale) would move
    the result far past the tolerance."""
    q, k, v, mask, _ = _case("mask_scaling", seed=1)
    t = [torch.from_numpy(a) for a in (q, k, v, mask)]
    scale = 1.0 / np.sqrt(q.shape[-1])
    got = K.flash_attention_plain(*t, False, scale).numpy()
    wrong = K.flash_attention_plain(t[0], t[1], t[2], t[3] / scale, False, scale).numpy()
    exact = _oracle(q, k, v, mask, False)
    assert np.abs(got - exact).max() < 1e-5 * np.abs(exact).max()
    assert np.abs(wrong - exact).max() > 1e-1 * np.abs(exact).max()


def _jax_gate(monkeypatch, q_shape, k_shape, mask, causal, scale, softcap, n_out, mode):
    """Whether JAX's `_flash_attention_maybe` routes a node to the library
    kernel, with its TPU test patched true and the kernel stubbed."""
    import jax.experimental.pallas.ops.tpu.flash_attention as lib

    calls = []

    def stub(q, k, v, ab=None, **kw):
        calls.append(1)
        return q

    monkeypatch.setattr(lib, "flash_attention", stub)
    monkeypatch.setattr(jax, "devices", lambda *a: [SimpleNamespace(platform="tpu")])
    q = jnp.zeros(q_shape, jnp.float32)
    k = jnp.zeros(k_shape, jnp.float32)
    m = None if mask is None else jnp.zeros((1, 1, q_shape[2], k_shape[2]), mask)
    out = j_att._flash_attention_maybe(None, q, k, k, m, causal, scale, softcap, n_out, mode)
    assert (out is not None) == bool(calls)
    return out is not None


def test_kernel_takes_agrees_with_jax_gate(monkeypatch):
    seen = {True: 0, False: 0}
    for lq in (64, 128, 200, 256, 384):
        for lk in (128, 192, 256):
            for d in (8, 12, 16, 24, 96, 264):
                for causal in (False, True):
                    for mask in (None, jnp.float32, jnp.bool_):
                        for scale in ((0.125, 0.0) if mask is not None else (0.125,)):
                            args = ((1, 2, lq, d), (1, 2, lk, d), mask, causal, scale, 0.0, 1, 0)
                            want = _jax_gate(monkeypatch, *args)
                            got = fa.kernel_takes(args[0], args[1], is_causal=causal,
                                                  has_mask=mask is not None, scale=scale)
                            assert got == want, args
                            seen[got] += 1
    for softcap, n_out, mode in ((5.0, 1, 0), (0.0, 4, 0), (0.0, 3, 0), (0.0, 1, 2),
                                 (0.0, 2, 0), (0.0, 4, 3)):
        args = ((1, 2, 128, 64), (1, 2, 256, 64), jnp.float32, False, 0.125, softcap, n_out,
                mode)
        want = _jax_gate(monkeypatch, *args)
        assert fa.kernel_takes(args[0], args[1], is_causal=False, has_mask=True, scale=0.125,
                               softcap=softcap, n_out=n_out, mode=mode) == want, args
    assert seen[True] > 20 and seen[False] > 200, seen


def test_wrapper_takes_plain_on_cpu_and_counts_no_launch():
    rng = np.random.default_rng(3)
    K.reset_launch_counts()
    for (B, H, KVH, Lq, Lk, D), causal in (((1, 4, 2, 128, 256, 16), False),
                                           ((2, 2, 2, 5, 5, 6), True),  # outside the gate
                                           ((1, 2, 1, 7, 3, 12), False)):
        q = torch.from_numpy(rng.standard_normal((B, H, Lq, D)).astype(np.float32))
        k = torch.from_numpy(rng.standard_normal((B, KVH, Lk, D)).astype(np.float32))
        v = torch.from_numpy(rng.standard_normal((B, KVH, Lk, D)).astype(np.float32))
        mask = torch.from_numpy(rng.random((Lq, Lk)) > 0.2)
        for m in (None, mask, mask.float() * 3):
            torch.testing.assert_close(K.flash_attention(q, k, v, m, causal, 0.3),
                                       K.flash_attention_plain(q, k, v, m, causal, 0.3),
                                       rtol=0, atol=0)
    assert K.launch_counts()["flash_attn"] == 0
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_kernel(q, k, v)
    with pytest.raises(ValueError, match="k "):
        K.flash_attention(q, k[:, :, :, :4], v)


FLASH_REL = 1e-5  # chip_smoke.FLASH_REL: kernel 12 against its plain version


def _skip_case(kind, seed=0):
    """(q, k, v, mask, causal) at a small size, the masks of the card's
    skip checks: a prefill from slot 0, a chunk from slot 128, a bool mask
    with a fully masked row beside dead key tiles, 2 x randn (causal)."""
    rng = np.random.default_rng(seed)
    B, H, KVH, Lq, Lk, D = {"prefill": (1, 2, 2, 256, 512, 32),
                            "chunked": (1, 4, 2, 128, 512, 32),
                            "bool_empty_row": (2, 2, 2, 256, 256, 16),
                            "randn": (1, 2, 2, 256, 256, 24)}[kind]
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((B, H, Lq, D), (B, KVH, Lk, D), (B, KVH, Lk, D)))
    causal = kind == "randn"
    if kind in ("prefill", "chunked"):
        start = 0 if kind == "prefill" else 128
        mask = torch.from_numpy(attn23_step_feeds(np.zeros((B, Lq), np.int64), start,
                                                  Lk)["mask"])
    elif kind == "bool_empty_row":
        m = rng.random((B, 1, Lq, Lk)) > 0.3
        m[..., 128:] &= np.arange(Lq)[:, None] < 64  # key tiles 2-3 dead past q tile 0
        m[0, 0, 3] = False  # a fully masked row in q tile 0
        m[1, 0, 70] = False  # and one in q tile 1, whose key tiles 2-3 are dead
        mask = torch.from_numpy(m)
    else:
        mask = torch.from_numpy(2 * rng.standard_normal((B, 1, Lq, Lk)).astype(np.float32))
    return q, k, v, mask, causal


@pytest.mark.parametrize("kind", ["prefill", "chunked", "bool_empty_row", "randn"])
def test_skipped_tiles_change_no_bit(kind):
    q, k, v, mask, causal = _skip_case(kind)
    B, H, Lq, _ = q.shape
    Lk = k.shape[2]
    dead = fa.skippable_tiles(q, k, mask, causal)
    assert dead.shape == (B, H, Lq // 64, Lk // 64)
    bias = fa.mask_bias(mask, (B, H, Lq, Lk))
    gone = bias.masked_fill(dead.repeat_interleave(64, 2).repeat_interleave(64, 3),
                            float("-inf"))
    want = fa.flash_attention_plain(q, k, v, bias, causal)
    got = fa.flash_attention_plain(q, k, v, gone, causal)
    assert torch.equal(got, want)
    if kind in ("prefill", "chunked", "bool_empty_row"):
        assert dead.any()  # the test has something to skip
    else:
        assert not dead.any()  # 2 x randn never reaches 104 below a row's max
    if kind == "bool_empty_row":  # q tiles with a fully masked row skip nothing
        assert not dead[0, :, 0].any() and not dead[1, :, 1].any()
        assert dead[0, :, 1:, 2:].all() and dead[1, :, 2:, 2:].all()
    if kind == "prefill":  # from slot 0, key tiles past a q tile's last row
        nq, nk = dead.shape[2:]
        later = torch.arange(nk)[None, :] > torch.arange(nq)[:, None]
        assert torch.equal(dead[0, 0], later)


def test_pair_test_counts_the_live_entries_of_a_prefill_mask():
    q, k, v, mask, _ = _skip_case("chunked", seed=2)
    dead = fa.skippable_tiles(q, k, mask, False, tile=1)
    live = (mask == 0).expand(dead.shape)
    assert torch.equal(~dead, live)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: round the f32 mantissa to 10 bits, ties away from 0."""
    bits = x.view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _product(a: torch.Tensor, b: torch.Tensor, terms: int) -> torch.Tensor:
    """a @ b with TF32 operands: one product, or 3xTF32 (lo.hi + hi.lo, then
    hi.hi, sums in f32) as the kernel's mma.sync calls."""
    ah, bh = _tf32(a), _tf32(b)
    if terms == 1:
        return ah @ bh
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh


def _emulated(q, k, v, mask, causal, scale, terms):
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    rep = H // k.shape[1]
    kf, vf = k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1)
    s = _product(q, kf.transpose(-1, -2), terms) * scale
    if mask is not None:
        s = s + fa.mask_bias(mask, (B, H, Lq, Lk))
    if causal:
        s = s.masked_fill(~torch.ones((Lq, Lk), dtype=torch.bool).tril(), float("-inf"))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    return _product(p, vf, terms) / p.sum(-1, keepdim=True)


# chip_smoke.FLASH_SHAPES' TPU-script causal shape (B 2, H 8, L 2,048, D 128)
# and the Phi-3 prefill (H 32, Lq 1,920 over 4,096 slots, D 96, its mask),
# scaled to Lq <= 256
@pytest.mark.parametrize("B,H,KVH,Lq,Lk,D,causal,kind",
                         [(1, 2, 2, 256, 256, 128, True, None),
                          (1, 2, 2, 256, 512, 96, False, "prefill")])
def test_3xtf32_emulation_keeps_the_f32_gate(B, H, KVH, Lq, Lk, D, causal, kind):
    rng = np.random.default_rng(D)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((B, H, Lq, D), (B, KVH, Lk, D), (B, KVH, Lk, D)))
    mask = None
    if kind == "prefill":
        mask = torch.from_numpy(attn23_step_feeds(np.zeros((B, Lq), np.int64), 0, Lk)["mask"])
    scale = 1.0 / np.sqrt(D)
    ref = fa.flash_attention_plain(q, k, v, mask, causal, scale)
    gate = FLASH_REL * ref.abs().max().item()
    three = (_emulated(q, k, v, mask, causal, scale, 3) - ref).abs().max().item()
    one = (_emulated(q, k, v, mask, causal, scale, 1) - ref).abs().max().item()
    assert three <= gate, (three, gate)
    assert one > gate, (one, gate)  # why the kernel takes three products


@pytest.mark.cuda
@pytest.mark.parametrize("shape,causal,masked", [((2, 8, 8, 256, 256, 128), True, False),
                                                  ((1, 32, 8, 128, 384, 96), False, True),
                                                  ((1, 2, 2, 128, 128, 264), False, True)])
def test_kernel_matches_plain_on_the_card(shape, causal, masked):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: kernel 12 is CUDA C++ (csrc/flash_attn.cu) with no "
                    "CPU form; chip_smoke.py runs this check on the card")
    B, H, KVH, Lq, Lk, D = shape
    gen = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn((B, H, Lq, D), generator=gen, device="cuda")
    k = torch.randn((B, KVH, Lk, D), generator=gen, device="cuda")
    v = torch.randn((B, KVH, Lk, D), generator=gen, device="cuda")
    mask = (torch.rand((B, 1, Lq, Lk), generator=gen, device="cuda") > 0.3) if masked else None
    if masked:
        mask[0, 0, 3] = False
    want = K.flash_attention_plain(q, k, v, mask, causal)
    before = K.flash_attention.launches
    got = K.flash_attention(q, k, v, mask, causal)
    torch.cuda.synchronize()
    assert K.flash_attention.launches == before + 1
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()
