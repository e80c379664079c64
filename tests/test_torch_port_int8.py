"""Kernel 11 (the exact int8 GEMM) and the MatMulInteger emitter of the port
against lele_tpu's, on integer operands made with numpy from seeds.

The JAX side runs `pallas_int8_matmul` in interpret mode and its
MatMulInteger emitter on the CPU; the port on the CPU takes the plain
version (the exact float64 product). Every comparison is exact: the sums
are integers on both sides.
"""

import subprocess
import sys
import zlib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lele_tpu.kernels.quant_matmul import pallas_int8_matmul
from lele_tpu.ops.quant_ops import matmul_integer as j_matmul_integer
from lele_tpu_torch import kernels as K
from lele_tpu_torch.compiler import compile_model
from lele_tpu_torch.onnx import builder as ob
from lele_tpu_torch.ops import quant_ops

REPO = Path(__file__).resolve().parent.parent


def _i8(rng, shape, lo=-128, hi=127):
    return rng.integers(lo, hi, shape).astype(np.int8)


# (M, K, N, (tm, tn, tk)): JAX's two shapes with their tiles
# (tests/test_pallas_parity.py:21-40), M = 1, a K that is not a multiple of
# 32, and the dynamic-int8 linears' widths at a few rows
CASES = [
    (64, 128, 96, (32, 32, 64)),
    (50, 70, 30, (32, 16, 32)),
    (1, 96, 40, (128, 512, 512)),
    (37, 100, 48, (32, 16, 32)),
    (9, 512, 1536, (128, 512, 512)),
    (9, 2048, 512, (128, 512, 512)),
    # the M = 21 request's [2048 -> 512] linear, which the card splits over
    # a cluster of 8; N not a multiple of the card's 64-column strip
    (21, 2048, 512, (128, 512, 512)),
    (21, 512, 200, (32, 128, 512)),
    (5, 2048, 100, (32, 128, 512)),
]


@pytest.mark.parametrize("m,k,n,tiles", CASES)
def test_int8_matmul_equals_pallas_int8_matmul(m, k, n, tiles):
    """Exact (int32) against the TPU kernel in interpret mode; operands
    draw from [-128, 127), as JAX's tests do."""
    rng = np.random.default_rng(m * 1000 + k + n)
    a, b = _i8(rng, (m, k)), _i8(rng, (k, n))
    tm, tn, tk = tiles
    want = np.asarray(pallas_int8_matmul(jnp.asarray(a), jnp.asarray(b), tm=tm, tn=tn,
                                         tk=tk, interpret=True))
    got = K.int8_matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32 and tuple(got.shape) == (m, n)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("fill", [-128, 127], ids=["min", "max"])
def test_int8_matmul_extremes(fill):
    """All −128 (or 127) operands: the largest sums, |K·128·128| < 2^31."""
    m, k, n = 33, 4096, 17
    a = np.full((m, k), fill, np.int8)
    b = np.full((k, n), -128, np.int8)
    want = np.asarray(pallas_int8_matmul(jnp.asarray(a), jnp.asarray(b), tm=32, tn=16,
                                         tk=512, interpret=True))
    got = K.int8_matmul(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0, 0] == k * fill * -128


def test_int8_matmul_counts_no_launch_on_cpu_and_kernel_refuses_cpu():
    a = torch.zeros((4, 8), dtype=torch.int8)
    b = torch.zeros((8, 3), dtype=torch.int8)
    before = K.int8_matmul.launches
    K.int8_matmul(a, b)
    assert K.int8_matmul.launches == before
    assert K.launch_counts()["int8_gemm"] == before
    with pytest.raises(ValueError, match="CUDA"):
        K.quant_matmul.int8_matmul_kernel(a, b)
    with pytest.raises(TypeError):
        K.int8_matmul(a.to(torch.uint8), b)


def _operand(rng, dtype, shape):
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max + 1, shape).astype(dtype)


def _zp(rng, dtype, kind, n):
    if kind == "none":
        return None
    info = np.iinfo(dtype)
    if kind == "scalar":
        return np.asarray(rng.integers(info.min, info.max + 1), dtype)
    return rng.integers(info.min, info.max + 1, (n,)).astype(dtype)


MIXES = [(np.uint8, np.uint8), (np.uint8, np.int8), (np.int8, np.uint8), (np.int8, np.int8)]
ZPS = [("none", "none"), ("scalar", "scalar"), ("row", "col"), ("scalar", "col"),
       ("row", "none")]


@pytest.mark.parametrize("adt,bdt", MIXES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("azp_kind,bzp_kind", ZPS, ids=lambda k: k)
def test_matmul_integer_emitter_equals_jax(adt, bdt, azp_kind, bzp_kind):
    """The emitter (the CPU's float64 route) and the kernel route's i8
    algebra through the plain product, each against the JAX emitter,
    exactly: u8/i8 mixes with absent, scalar, per-row [M] and per-column
    [N] zero points."""
    rng = np.random.default_rng(zlib.crc32(f"{adt}{bdt}{azp_kind}{bzp_kind}".encode()))
    m, k, n = 7, 45, 11
    a, b = _operand(rng, adt, (m, k)), _operand(rng, bdt, (k, n))
    azp, bzp = _zp(rng, adt, azp_kind, m), _zp(rng, bdt, bzp_kind, n)
    want = np.asarray(j_matmul_integer(
        None, a, b, None if azp is None else jnp.asarray(azp),
        None if bzp is None else jnp.asarray(bzp)))
    t = [None if v is None else torch.from_numpy(np.asarray(v)) for v in (a, b, azp, bzp)]
    got = quant_ops.matmul_integer(None, *t)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    alg = quant_ops.matmul_integer_i8(*t, product=K.int8_matmul_plain)
    np.testing.assert_array_equal(alg.numpy(), want)


@pytest.mark.parametrize("a_shape,b_shape", [((2, 3, 5, 40), (40, 6)),
                                             ((2, 5, 40), (2, 40, 6)),
                                             ((3, 1, 5, 40), (2, 40, 6)),
                                             ((40,), (40, 6)),
                                             ((5, 40), (40,))])
def test_kernel_route_shapes_equal_float64_emitter(a_shape, b_shape):
    """A's leading dims flatten into rows when B is 2-D; a batched B takes
    one product per broadcast batch entry; 1-D operands follow matmul."""
    rng = np.random.default_rng(len(a_shape) * 10 + len(b_shape))
    a = torch.from_numpy(_operand(rng, np.uint8, a_shape))
    b = torch.from_numpy(_operand(rng, np.int8, b_shape))
    azp, bzp = torch.tensor(131, dtype=torch.uint8), torch.tensor(-3, dtype=torch.int8)
    calls = []

    def product(x, w):
        calls.append(x.shape)
        return K.int8_matmul_plain(x, w)

    got = quant_ops.matmul_integer_i8(a, b, azp, bzp, product=product)
    want = quant_ops.matmul_integer_plain(None, a, b, azp, bzp)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    batch = int(np.prod(np.broadcast_shapes(a_shape[:-2], b_shape[:-2]))) \
        if len(b_shape) > 2 else 1
    assert len(calls) == batch


def test_compiled_matmul_integer_graph_default_and_override_agree():
    """A DynamicQuantizeLinear → MatMulInteger graph compiled with the
    default emitter and with the float64 override: identical int32 sums."""
    rng = np.random.default_rng(11)
    w = _operand(rng, np.uint8, (48, 20))
    nodes = [ob.node("DynamicQuantizeLinear", ["x"], ["xq", "xs", "xz"]),
             ob.node("MatMulInteger", ["xq", "w", "xz", "wz"], ["y"])]
    bs = ob.build_model_bytes(
        nodes, [ob.value_info("x", 1, [2, 9, 48])], [ob.value_info("y", 6, [2, 9, 20])],
        [ob.tensor_from_array(w, "w"), ob.tensor_from_array(np.asarray(119, np.uint8), "wz")])
    x = rng.standard_normal((2, 9, 48)).astype(np.float32)
    got = compile_model(bs, device="cpu", strict=True).run_np(x=x)[0]
    ref = compile_model(bs, device="cpu", strict=True,
                        overrides={"MatMulInteger": quant_ops.matmul_integer_plain}
                        ).run_np(x=x)[0]
    assert got.dtype == np.int32 and got.shape == (2, 9, 20)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(171, 512, 2048), (50, 70, 30), (1, 2048, 512)])
def test_kernel_matches_plain_on_the_card(m, k, n):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: kernel 11 is CUDA C++ (csrc/int8_gemm.cu) with no "
                    "CPU form; chip_smoke.py runs this check on the card")
    rng = np.random.default_rng(m + k + n)
    a = torch.from_numpy(_i8(rng, (m, k), hi=128)).cuda()
    b = torch.from_numpy(_i8(rng, (k, n), hi=128)).cuda()
    torch.testing.assert_close(K.int8_matmul(a, b), K.int8_matmul_plain(a, b), rtol=0, atol=0)


def test_int8_module_imports_without_nvcc():
    code = (
        "import sys; sys.modules['triton'] = None; sys.modules['jax'] = None\n"
        "from lele_tpu_torch.kernels import quant_matmul as q\n"
        "from lele_tpu_torch.kernels import _build\n"
        "assert q._i8_fn is None and q._dq_ws_fn is None and not _build._libs\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120, env={"PATH": "/nonexistent",
                                                      "PYTHONPATH": str(REPO)})
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
