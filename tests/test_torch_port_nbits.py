"""com.microsoft::MatMulNBits in the port against the JAX package, on the same
ONNX bytes.

- The emitter (the port's `patterns=[]`) against JAX's emitter
  (`LELE_NBITS_PALLAS=0`): zero points absent, packed and plain, bias,
  batched leading dims, bits 8, g_idx, a ceil-padded K.
- The `matmul_nbits_w4` pattern against JAX's (`LELE_NBITS_PALLAS=1`, its
  default bf16 route), with equal `pattern_hits`; and under JAX's TPU routing
  (`_on_tpu` True, `w4_matmul_pallas` in interpret mode), where both sides
  compute the same group-accumulator form.
- The geometries JAX's pattern declines, the port declines too.
"""

import importlib

import numpy as np
import pytest
import torch

import lele_tpu.kernels.quant_matmul as jqm
import lele_tpu.kernels.w4_matmul as jw4
from lele_tpu.compiler import compile_model as jcompile
from lele_tpu.onnx import OnnxModel
from lele_tpu.onnx import builder as ob
from lele_tpu_torch.compiler import compile_model
from lele_tpu_torch.onnx import builder as tob
from lele_tpu_torch.ops.registry import lookup_op

M, K, N, BLK = 4, 512, 384, 64
# the emitters: both dequantise in f32 and multiply in f32 (JAX at HIGHEST),
# the gate of tests/test_matmul_nbits_fusion.py:185
EMIT_ATOL = 2e-4
# the bf16 route against JAX's (tests/test_matmul_nbits_fusion.py:161-165):
# JAX's CPU route rounds q·s to bf16, the port's form scales exact f32 sums
BF16_RELNORM = 5e-3
# under JAX's TPU routing both run the group-accumulator form: only the f32
# summation order differs
TPU_ROUTE_REL = 1e-5


def _graph(rng, zp_mode="none", bias=False, lead=(), k=K, blk=BLK, bits=4, g_idx=False,
           builder=ob):
    """MatMulNBits bytes with random blobs, and a matching activation."""
    kb = -(-k // blk)
    per_byte = 2 if bits == 4 else 1
    b = rng.integers(0, 256, (N, kb, blk // per_byte), dtype=np.uint8)
    sc = (rng.random((N, kb)).astype(np.float32) * 0.05 + 0.01)
    ins = ["a", "b", "sc"]
    inits = [builder.tensor_from_array(b, "b"), builder.tensor_from_array(sc, "sc")]
    if zp_mode == "packed":
        ins.append("zp")
        inits.append(builder.tensor_from_array(
            rng.integers(0, 256, (N, (kb + 1) // 2), dtype=np.uint8), "zp"))
    elif zp_mode == "plain":
        ins.append("zp")
        hi = 16 if bits == 4 else 256
        inits.append(builder.tensor_from_array(
            rng.integers(0, hi, (N, kb), dtype=np.uint8), "zp"))
    if g_idx or bias:
        ins += [""] * (4 - len(ins))
        if g_idx:
            ins.append("g")
            inits.append(builder.tensor_from_array(
                rng.permutation(np.arange(k) // blk).astype(np.int32), "g"))
        else:
            ins.append("")
    if bias:
        ins.append("bias")
        inits.append(builder.tensor_from_array(
            rng.standard_normal(N).astype(np.float32), "bias"))
    shape = list(lead) + [M, k]
    node = builder.node("MatMulNBits", ins, ["y"], domain="com.microsoft", K=k, N=N,
                        bits=bits, block_size=blk)
    bs = builder.build_model_bytes([node], inputs=[builder.value_info("a", 1, shape)],
                                   outputs=[builder.value_info("y", 1, shape[:-1] + [N])],
                                   initializers=inits)
    return bs, rng.standard_normal(shape).astype(np.float32)


def _jax(monkeypatch, bs, a, pallas: str):
    monkeypatch.setenv("LELE_NBITS_PALLAS", pallas)
    monkeypatch.delenv("LELE_NBITS_F32", raising=False)
    cm = jcompile(OnnxModel.from_bytes(bs), strict=True)
    return cm.run_np(a=a)[0], cm.stats.get("pattern_hits", {})


def _port(bs, a, patterns=None):
    cm = compile_model(bs, strict=True, patterns=patterns, device="cpu")
    return cm.run_np(a=a)[0], cm.stats["pattern_hits"], cm


def _relnorm(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-9))


def test_matmul_nbits_is_keyed_on_its_domain():
    assert lookup_op("com.microsoft", "MatMulNBits") is not None
    assert lookup_op("", "MatMulNBits") is None
    assert lookup_op("com.example", "MatMulNBits") is None
    assert lookup_op("ai.onnx", "MatMul") is lookup_op("", "MatMul") is not None


def test_port_builder_writes_the_same_bytes():
    bs, _ = _graph(np.random.default_rng(0), "packed", True)
    tbs, _ = _graph(np.random.default_rng(0), "packed", True, builder=tob)
    assert tbs == bs


@pytest.mark.parametrize("zp_mode,bias,lead", [
    ("none", False, ()),
    ("none", True, (2, 3)),
    ("packed", False, ()),
    ("packed", True, ()),
    ("plain", False, (2,)),
    ("plain", True, ()),
])
def test_emitter_matches_jax_emitter(monkeypatch, zp_mode, bias, lead):
    rng = np.random.default_rng(len(zp_mode) * 7 + bias + len(lead))
    bs, a = _graph(rng, zp_mode, bias, lead)
    want, _ = _jax(monkeypatch, bs, a, "0")
    got, hits, _ = _port(bs, a, patterns=[])
    assert not hits and got.shape == want.shape == tuple(lead) + (M, N)
    np.testing.assert_allclose(got, want, atol=EMIT_ATOL, rtol=EMIT_ATOL)


@pytest.mark.parametrize("case", ["bits8", "bits8_plain_zp", "g_idx", "g_idx_zp",
                                  "ceil_padded_k"])
def test_emitter_other_forms_match_jax(monkeypatch, case):
    rng = np.random.default_rng(11)
    kw = {"bits8": dict(bits=8), "bits8_plain_zp": dict(bits=8, zp_mode="plain"),
          "g_idx": dict(g_idx=True), "g_idx_zp": dict(g_idx=True, zp_mode="plain"),
          "ceil_padded_k": dict(k=480, zp_mode="packed", bias=True)}[case]
    bs, a = _graph(rng, **kw)
    want, jhits = _jax(monkeypatch, bs, a, "1")  # the pattern declines each form
    got, hits, _ = _port(bs, a)
    assert not jhits.get("matmul_nbits_w4") and not hits.get("matmul_nbits_w4")
    np.testing.assert_allclose(got, want, atol=EMIT_ATOL, rtol=EMIT_ATOL)


@pytest.mark.parametrize("zp_mode,bias,lead,blk", [
    ("none", False, (), BLK),
    ("packed", True, (), BLK),
    ("plain", False, (2,), BLK),
    ("packed", True, (), 32),
    ("none", False, (), 128),
])
def test_pattern_matches_jax_pattern(monkeypatch, zp_mode, bias, lead, blk):
    """JAX's default bf16 route, on the CPU (its jnp dequantise-then-dot),
    at its own rel-norm gate; equal pattern hits (two a node on both sides:
    the pattern and the walk each count it); the repacked planes ride as
    int8 at 0.5 byte a weight; the port's fused and per-op paths agree."""
    rng = np.random.default_rng(100 + blk + len(lead) + bias)
    bs, a = _graph(rng, zp_mode, bias, lead, blk=blk)
    want, jhits = _jax(monkeypatch, bs, a, "1")
    got, hits, cm = _port(bs, a)
    assert hits == jhits and hits["matmul_nbits_w4"] == 2, (hits, jhits)
    assert _relnorm(got, want) < BF16_RELNORM
    assert any(t.dtype == torch.int8 and t.numel() == N * K // 2
               for t in cm.params.values())
    per_op, _, _ = _port(bs, a, patterns=[])
    assert _relnorm(got, per_op) < BF16_RELNORM


@pytest.mark.parametrize("zp_mode,bias", [("none", False), ("packed", True)])
def test_pattern_matches_jax_tpu_routing(monkeypatch, zp_mode, bias):
    rng = np.random.default_rng(7 + bias)
    bs, a = _graph(rng, zp_mode, bias)
    calls = []
    real = jw4.w4_matmul_pallas
    monkeypatch.setattr(jqm, "_on_tpu", lambda: True)
    monkeypatch.setattr(jw4, "_on_tpu", lambda: True)
    monkeypatch.setattr(jw4, "w4_matmul_pallas",
                        lambda *x, **k: (calls.append(1), real(*x, **{**k, "interpret": True}))[1])
    want, _ = _jax(monkeypatch, bs, a, "1")
    got, _, _ = _port(bs, a)
    assert calls
    assert np.abs(got - want).max() <= TPU_ROUTE_REL * np.abs(want).max()


def test_pattern_declines_odd_geometry_as_jax(monkeypatch):
    """K = 96 with block 32: K is not a multiple of 2·block
    (tests/test_matmul_nbits_fusion.py:190-216); both keep the emitter."""
    rng = np.random.default_rng(3)
    bs, a = _graph(rng, k=96, blk=32)
    want, jhits = _jax(monkeypatch, bs, a, "1")
    got, hits, _ = _port(bs, a)
    assert not jhits.get("matmul_nbits_w4") and not hits.get("matmul_nbits_w4")
    np.testing.assert_allclose(got, want, atol=EMIT_ATOL, rtol=EMIT_ATOL)


def test_pattern_routes_through_the_w4_gemm_wrapper(monkeypatch):
    """On the CPU the wrapper takes its plain version and counts no launch;
    the traced step calls it once a node a request."""
    W4 = importlib.import_module("lele_tpu_torch.kernels.w4_matmul")
    seen = []
    real = W4.w4_matmul
    monkeypatch.setattr(W4, "w4_matmul", lambda *x: (seen.append(x[3]), real(*x))[1])
    bs, a = _graph(np.random.default_rng(5), "packed", True, blk=32)
    cm = compile_model(bs, strict=True, device="cpu")
    n_trace = len(seen)
    cm.run_np(a=a)
    cm.run_np(a=a)
    assert n_trace == 1 and seen == [32] * 3 and real.launches == 0


# -- kernel 7 at every group and K (the TPU kernel's range) --------------------

# tests/test_w4.py:73: f32 forms agree to the summation order; a bf16 x may
# differ by the bf16 rounding of q·s between the two sides' forms
W4_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.fixture
def jax_w4_tpu_routing(monkeypatch):
    """JAX's TPU routing of `w4_matmul` on the CPU: `_on_tpu` True and its
    Pallas kernel in interpret mode. Records which shapes reached it."""
    seen = []
    real = jw4.w4_matmul_pallas
    monkeypatch.setattr(jqm, "_on_tpu", lambda: True)
    monkeypatch.setattr(jw4, "_on_tpu", lambda: True)
    monkeypatch.setattr(jw4, "w4_matmul_pallas", lambda *x, **k: (
        seen.append(x[3] if len(x) > 3 else k["group"]),
        real(*x, **{**k, "interpret": True}))[1])
    return seen


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,group,pallas", [(512, 8, True), (768, 24, True),
                                            (1040, 8, False)])
def test_w4_matmul_plain_at_small_groups_matches_jax_routing(jax_w4_tpu_routing, dtype, k,
                                                              group, pallas):
    """Groups 8 and 24 pass JAX's tile test (its Pallas group form; the
    port's group form in k-steps of 8), K = 1040 has no tile dividing
    K/2 = 520 (JAX's `_w4_matmul_jnp`; the port's dequantised-tile form)."""
    import jax.numpy as jnp

    W4 = importlib.import_module("lele_tpu_torch.kernels.w4_matmul")
    rng = np.random.default_rng(k + group)
    x = jnp.asarray(rng.standard_normal((5, k)), dtype)
    w = rng.standard_normal((k, 96)).astype(np.float32) * 0.1
    packed, scales = jw4.quantize_weight_int4(w, group=group)
    want = np.asarray(jw4.w4_matmul(x, packed, scales, group=group))
    assert bool(jax_w4_tpu_routing) == pallas == W4.group_acc_form(k, group)
    assert W4.kernel_supports(k, group)
    args = [torch.from_numpy(np.array(v.astype(jnp.float32) if v.dtype == jnp.bfloat16
                                        else v)) for v in (x, packed, scales)]
    if dtype == "bfloat16":
        args[0] = args[0].to(torch.bfloat16)
    got = W4.w4_matmul_plain(*args, group).numpy()
    tol = W4_TOL[dtype]
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * 10)
    # the same form on both sides: only the f32 summation order differs
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_w4_matmul_indexed_entry_equals_row_by_row():
    """The expert-indexed entry (QMoE decode): row r against stack idx[r],
    the same numbers as one product a row."""
    W4 = importlib.import_module("lele_tpu_torch.kernels.w4_matmul")
    gen = torch.Generator().manual_seed(0)
    E, Kd, N, R = 5, 96, 40, 6
    packed = torch.randint(-128, 128, (E, Kd // 2, N), generator=gen, dtype=torch.int8)
    scales = torch.rand((E, Kd // 16, N), generator=gen) * 0.1 + 1e-3
    idx = torch.tensor([4, 0, 4, 2, 1, 3], dtype=torch.int32)
    for dt in (torch.float32, torch.bfloat16):
        x = torch.randn((R, Kd), generator=gen).to(dt)
        got = W4.w4_matmul(x, packed, scales, 16, idx)
        for r in range(R):
            e = int(idx[r])
            want = W4.w4_matmul_plain(x[r:r + 1], packed[e], scales[e], 16)
            torch.testing.assert_close(got[r:r + 1], want, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="idx"):
        W4.w4_matmul(x, packed, scales, 16, idx[:3])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows", [2, 8])
@pytest.mark.parametrize("k,n", [(128, 224), (224, 128)], ids=["fc1", "fc2"])
def test_w4_matmul_indexed_entry_matches_pallas_row_by_row(dtype, rows, k, n):
    """The expert-indexed entry at a decode step's rows·k slots (R = 2: one
    row, top-2; R = 8: four rows), at MOE_DECODE's form cut to small widths
    (8 experts, hidden 128, inter 224; the group `_qmoe_group` picks): row r
    against `w4_matmul_pallas(interpret=True)` on stack idx[r], to the f32
    summation order (TPU_ROUTE_REL)."""
    import jax.numpy as jnp

    from lele_tpu_torch.compiler.patterns import _qmoe_group

    W4 = importlib.import_module("lele_tpu_torch.kernels.w4_matmul")
    rng = np.random.default_rng(rows + k)
    e, group = 8, _qmoe_group(k)
    packed = rng.integers(-128, 128, (e, k // 2, n), dtype=np.int8)
    scales = (rng.random((e, k // group, n)) * 0.01 + 1e-3).astype(np.float32)
    idx = rng.integers(0, e, rows).astype(np.int32)
    x = jnp.asarray(rng.standard_normal((rows, k)), dtype)
    xt = torch.from_numpy(np.array(x.astype(jnp.float32)))
    if dtype == "bfloat16":
        xt = xt.to(torch.bfloat16)
    got = W4.w4_matmul(xt, torch.from_numpy(packed), torch.from_numpy(scales), group,
                       torch.from_numpy(idx)).numpy()
    assert got.shape == (rows, n) and W4.group_acc_form(k, group)
    for r in range(rows):
        want = np.asarray(jw4.w4_matmul_pallas(x[r:r + 1], packed[idx[r]], scales[idx[r]], group,
                                               tn=128, tk=k // 2, interpret=True))
        np.testing.assert_allclose(got[r:r + 1], want, rtol=TPU_ROUTE_REL,
                                   atol=TPU_ROUTE_REL * np.abs(want).max())


@pytest.mark.parametrize("k,blk", [(1040, 8), (768, 24)])
def test_pattern_at_small_blocks_matches_jax_pattern(monkeypatch, k, blk):
    """Blocks 8 (K = 1040) and 24 (K = 768): JAX's pattern takes both, and so
    does the port's; kernel 7 takes them on the card (no raise). On the CPU
    JAX's route is its jnp dequantise-then-dot: the port's dequantised-tile
    form at K = 1040 is the same form; at block 24 the group form differs by
    the bf16 rounding of q·s (JAX's rel-norm gate)."""
    rng = np.random.default_rng(k + blk)
    bs, a = _graph(rng, "packed", True, k=k, blk=blk)
    want, jhits = _jax(monkeypatch, bs, a, "1")
    got, hits, _ = _port(bs, a)
    assert hits == jhits and hits["matmul_nbits_w4"] == 2, (hits, jhits)
    assert _relnorm(got, want) < (TPU_ROUTE_REL if blk == 8 else BF16_RELNORM)
    per_op, _, _ = _port(bs, a, patterns=[])
    assert _relnorm(got, per_op) < BF16_RELNORM


@pytest.mark.parametrize("k,blk", [(1040, 8), (768, 24)])
def test_pattern_at_small_blocks_matches_jax_tpu_routing(jax_w4_tpu_routing, monkeypatch, k,
                                                         blk):
    """Under JAX's TPU routing block 24 reaches its Pallas group form and
    block 8 at K = 1040 its jnp path; the port takes the same forms."""
    rng = np.random.default_rng(k * blk)
    bs, a = _graph(rng, "none", False, k=k, blk=blk)
    want, _ = _jax(monkeypatch, bs, a, "1")
    got, _, _ = _port(bs, a)
    assert bool(jax_w4_tpu_routing) == (blk == 24)
    assert np.abs(got - want).max() <= TPU_ROUTE_REL * np.abs(want).max()
