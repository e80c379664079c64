"""The plain versions of the port's kernels against the JAX TPU kernels.

The JAX side runs its Pallas kernels in interpret mode on the CPU (as
tests/test_pallas_parity.py does) and its jnp references. Inputs are made
with numpy from a seed and weights are converted through
lele_tpu_torch.params. On the CPU every wrapper takes its plain version; the
CUDA kernels themselves are held against these plain versions on the card
by chip_smoke.py.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lele_tpu.kernels.quant_matmul import _w8_matmul_jnp, w8_matmul_pallas
from lele_tpu.kernels.sanm_block import sanm_layer_w8_pallas, sanm_stack_w8_pallas
from lele_tpu.models import SenseVoiceConfig as JConfig
from lele_tpu.models import init_sensevoice as jinit
from lele_tpu.models import prepare_w8_params as jprepare
from lele_tpu.models import stack_layer_params as jstack
from lele_tpu.models.common import cast_big_params as jcast
from lele_tpu.models.sensevoice import prepare_w4_params as jprepare4
from lele_tpu.models.sensevoice import sanm_block as jsanm_block
from lele_tpu_torch import kernels as K
from lele_tpu_torch.params import from_numpy_tree

REPO = Path(__file__).resolve().parent.parent
# the w8 GEMM's products are exact in f32 on both sides (bf16 x int8, or
# f32 x int8 at HIGHEST); only the summation order differs
GEMM_RTOL = 1e-5
# the bounds of tests/test_pallas_parity.py::test_fused_sanm_layer_matches_block
LAYER_RTOL = 2e-2


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("m,k,n", [(23, 70, 45), (16, 64, 128), (5, 130, 33), (69, 128, 96),
                                   (130, 256, 72)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_w8_matmul_plain_matches_pallas_and_jnp(m, k, n, dtype):
    rng = np.random.default_rng(m * k + n)
    x = rng.standard_normal((m, k)).astype(np.float32)
    wq = rng.integers(-127, 128, (k, n)).astype(np.int8)
    ws = (rng.random(n) * 1e-2 + 1e-3).astype(np.float32)
    xj = jnp.asarray(x).astype(dtype)
    want_pallas = np.asarray(w8_matmul_pallas(xj, jnp.asarray(wq), jnp.asarray(ws),
                                              tn=128, tk=64, interpret=True))
    want_jnp = np.asarray(_w8_matmul_jnp(xj, jnp.asarray(wq), jnp.asarray(ws)))
    got = K.w8_matmul_plain(from_numpy_tree(np.asarray(xj)), torch.from_numpy(wq),
                            torch.from_numpy(ws)).numpy()
    assert got.shape == (m, n) and got.dtype == np.float32
    for want in (want_pallas, want_jnp):
        np.testing.assert_allclose(got, want, rtol=GEMM_RTOL,
                                   atol=GEMM_RTOL * np.abs(want).max())


@pytest.mark.parametrize("n", [16, 25055, 1003])
def test_pad_weight_rows_keeps_values_with_aligned_rows(n):
    """Kernel 2 loads a weight by TMA, which needs its rows 16-byte aligned:
    prepare_w8_params keeps an unaligned one (the CTC head's 25,055
    columns) as a view of padded rows, with the same values and products."""
    from lele_tpu_torch.kernels.quant_matmul import align_rows

    rng = np.random.default_rng(n)
    wq = torch.from_numpy(rng.integers(-127, 128, (9, n)).astype(np.int8))
    got = align_rows(wq)
    assert got.shape == wq.shape and torch.equal(got, wq)
    assert got.stride(1) == 1 and got.stride(0) % 16 == 0
    assert (got is wq) == (n % 16 == 0)
    x = torch.from_numpy(rng.standard_normal((5, 9)).astype(np.float32)).to(torch.bfloat16)
    ws = torch.from_numpy(rng.random(n).astype(np.float32))
    assert torch.equal(K.w8_matmul(x, got, ws), K.w8_matmul_plain(x, wq, ws))


@pytest.mark.parametrize("case", ["aligned", "k70", "base_off", "row_slice"])
def test_align_rows_copies_only_unaligned_rows(case):
    """Kernel 2's wrapper hands its bf16 operands through align_rows: rows
    that TMA can load are passed as they lie, others (K % 8 != 0, a base
    off 16 bytes) are copied into padded rows with the same values."""
    from lele_tpu_torch.kernels.quant_matmul import align_rows

    rng = np.random.default_rng(3)
    src = torch.from_numpy(rng.standard_normal((7, 70 if case == "k70" else 64))
                           .astype(np.float32)).to(torch.bfloat16)
    t = {"aligned": src, "k70": src, "base_off": src[:, 1:], "row_slice": src[1:]}[case]
    got = align_rows(t)
    assert got.shape == t.shape and torch.equal(got, t)
    assert got.stride(1) == 1 and got.stride(0) % 8 == 0 and got.data_ptr() % 16 == 0
    assert (got is t) == (case in ("aligned", "row_slice"))


def test_prepare_w8_params_pads_only_the_ctc_head():
    """The CTC head's weight (N % 16 != 0) is kept in 16-byte rows for
    kernel 2; every layer weight stays contiguous for the layer and stack
    kernels, whatever its width."""
    from lele_tpu_torch.models import SenseVoiceConfig, SenseVoiceModel, prepare_w8_params

    cfg = SenseVoiceConfig(n_layers=2, d_model=64, n_heads=2, ffn_dim=72, vocab_size=1003,
                           weight_int8=True)
    model = SenseVoiceModel(cfg, device="cpu")
    model.init(0)
    p = prepare_w8_params(model.params)
    head = p["ctc"]["wq8"]
    assert head.shape == (64, 1003) and head.stride() == (1008, 1)
    for lp in p["layers"]:
        for key in ("qkv", "out", "ffn1", "ffn2"):
            assert lp[key]["wq8"].is_contiguous()


def test_layer_pointers_give_each_layer_view():
    """The C entries' operands: a per-layer tree is L = 1 with every stride
    0; a stacked tree's leaves at pointer + i·stride are layer_view(i)'s."""
    from lele_tpu_torch.kernels.sanm_block import layer_pointers, layer_view
    from lele_tpu_torch.models import (
        SenseVoiceConfig,
        SenseVoiceModel,
        cast_big_params,
        prepare_w8_params,
        stack_layer_params,
    )

    cfg = SenseVoiceConfig(n_layers=3, d_model=64, n_heads=2, ffn_dim=96, vocab_size=16,
                           weight_int8=True)
    model = SenseVoiceModel(cfg, device="cpu")
    model.init(0)
    stacked = stack_layer_params(prepare_w8_params(cast_big_params(
        model.params, torch.bfloat16)))["layers_stacked"]
    cpu = torch.device("cpu")
    args = (cpu, cfg.d_model, cfg.fsmn_kernel, "w8", 0, "test")
    L, ts, F, ptrs, strides = layer_pointers(stacked, *args, stacked=True)
    assert (L, F, len(ts)) == (3, 96, 17)
    assert all(b > 0 for q, b in zip(ptrs, strides) if q is not None)
    for i in range(L):
        one, _, f1, p1, s1 = layer_pointers(layer_view(stacked, i), *args, stacked=False)
        assert (one, f1) == (1, 96) and s1 == [0] * 17
        assert p1 == [None if q is None else q + i * b for q, b in zip(ptrs, strides)]


def _layer_params(key, n_layers, bf16, n_heads=2):
    cfg = JConfig(n_layers=n_layers, d_model=256, ffn_dim=384, vocab_size=32,
                  n_heads=n_heads, dtype="float32", weight_int8=True, fused_block=False)
    params = jinit(jax.random.PRNGKey(key), cfg)
    if bf16:
        params = jcast(params, jnp.bfloat16)
    return cfg, jprepare(params)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32_params", "bf16_params"])
def test_sanm_layer_plain_matches_pallas_and_jnp_block(bf16):
    cfg, params = _layer_params(3, 1, bf16)
    lp = params["layers"][0]
    T = 23
    rng = np.random.default_rng(11)
    x = rng.standard_normal((T, cfg.d_model)).astype(np.float32) * 0.3
    mask = np.ones((T,), np.float32)
    mask[-4:] = 0.0  # the padded tail must not leak into valid rows
    valid = int(mask.sum())
    want_pallas = np.asarray(sanm_layer_w8_pallas(
        jnp.asarray(x), jnp.asarray(mask), lp, cfg.n_heads, cfg.fsmn_kernel,
        interpret=True))
    want_jnp = np.asarray(jsanm_block(lp, jnp.asarray(x)[None], jnp.asarray(mask)[None],
                                      cfg))[0]
    got = K.sanm_layer_w8_plain(torch.from_numpy(x), torch.from_numpy(mask),
                                from_numpy_tree(_np_tree(lp)), cfg.n_heads,
                                cfg.fsmn_kernel).numpy()
    for want in (want_pallas, want_jnp):
        np.testing.assert_allclose(
            got[:valid], want[:valid], rtol=LAYER_RTOL,
            atol=np.abs(want[:valid]).max() * LAYER_RTOL)


# T = 19, head dim 128 (d256 over 2 heads), 3 layers; then the stack kernel's
# tiling edges: one row, a ragged 32-row tile, a key tile and one more row;
# head dims 32 and 64 (8 and 4 heads); 1 and 3 layers. The last T // 6 rows
# are masked.
STACK_CASES = [(19, 128, 3)] + [(t, hd, n) for t in (1, 19, 65) for hd in (32, 64)
                                for n in (1, 3)]
STACK_IDS = [f"T{t}-hd{hd}-L{n}" for t, hd, n in STACK_CASES]


@pytest.mark.parametrize("T,hd,n_layers", STACK_CASES, ids=STACK_IDS)
def test_sanm_stack_plain_matches_pallas(T, hd, n_layers):
    cfg, params = _layer_params(4, n_layers, True, n_heads=256 // hd)
    stacked = jstack(params)["layers_stacked"]
    rng = np.random.default_rng(12)
    x = rng.standard_normal((T, cfg.d_model)).astype(np.float32) * 0.3
    mask = np.ones((T,), np.float32)
    mask[T - T // 6:] = 0.0
    valid = int(mask.sum())
    want = np.asarray(sanm_stack_w8_pallas(jnp.asarray(x), jnp.asarray(mask), stacked,
                                           cfg.n_heads, cfg.fsmn_kernel, interpret=True))
    got = K.sanm_stack_w8_plain(torch.from_numpy(x), torch.from_numpy(mask),
                                from_numpy_tree(_np_tree(stacked)), cfg.n_heads,
                                cfg.fsmn_kernel).numpy()
    np.testing.assert_allclose(got[:valid], want[:valid], rtol=LAYER_RTOL,
                               atol=np.abs(want[:valid]).max() * LAYER_RTOL)


def test_wrappers_take_plain_version_on_cpu_and_count_no_launch():
    cfg, params = _layer_params(5, 2, True)
    tp = from_numpy_tree(_np_tree(jstack(params)))
    st = tp["layers_stacked"]
    lp0 = K.sanm_block.layer_view(st, 0)
    rng = np.random.default_rng(13)
    x = torch.from_numpy(rng.standard_normal((9, cfg.d_model)).astype(np.float32))
    mask = torch.ones(9)
    K.reset_launch_counts()
    torch.testing.assert_close(K.w8_matmul(x, lp0["qkv"]["wq8"], lp0["qkv"]["ws8"]),
                               K.w8_matmul_plain(x, lp0["qkv"]["wq8"], lp0["qkv"]["ws8"]),
                               rtol=0, atol=0)
    torch.testing.assert_close(
        K.sanm_layer_w8(x, mask, lp0, cfg.n_heads, cfg.fsmn_kernel),
        K.sanm_layer_w8_plain(x, mask, lp0, cfg.n_heads, cfg.fsmn_kernel), rtol=0, atol=0)
    for tree in (st, K.sanm_block.tree_map(lambda a: a[:1], st)):  # L = 2 and L = 1
        torch.testing.assert_close(
            K.sanm_stack_w8(x, mask, tree, cfg.n_heads, cfg.fsmn_kernel),
            K.sanm_stack_w8_plain(x, mask, tree, cfg.n_heads, cfg.fsmn_kernel), rtol=0, atol=0)
    wq = lp0["qkv"]["wq8"]
    colsum = wq.to(torch.int32).sum(0, dtype=torch.int32)
    _, a_scale, a_zp = K.dynamic_quantize_u8(x)
    torch.testing.assert_close(
        K.fused_dq_matmul(x, wq, colsum, a_scale, a_zp, 0.01),
        K.fused_dq_matmul_plain(x, wq, colsum, a_scale, a_zp, 0.01), rtol=0, atol=0)
    D, F = cfg.d_model, st["ffn1"]["wq8"].shape[-1]
    dql = {key: {"wq": st[key]["wq8"], "colsum": st[key]["wq8"].to(torch.int32).sum(
                     1, keepdim=True, dtype=torch.int32),
                 "ws": torch.full((2, 1, n), 1e-3), "b": torch.zeros((2, 1, n))}
           for key, n in (("qkv", 3 * D), ("out", D), ("ffn1", F), ("ffn2", D))}
    dql.update(norm1={"g": torch.ones((2, 1, D)), "b": torch.zeros((2, 1, D))},
               norm2={"g": torch.ones((2, 1, D)), "b": torch.zeros((2, 1, D))},
               fsmn=st["fsmn"]["w"].float().contiguous())
    bias, vmask = torch.zeros((2, 9)), torch.ones((2, 9))
    torch.testing.assert_close(
        K.sanm_stack_dql(x, bias, vmask, dql, cfg.n_heads, cfg.fsmn_kernel, 5),
        K.sanm_stack_dql_plain(x, bias, vmask, dql, cfg.n_heads, cfg.fsmn_kernel, 5),
        rtol=0, atol=0)
    packed, scales = K.quantize_weight_int4(torch.randn((D, 3 * D)), 128)
    stacks, stack_scales = packed[None].repeat(3, 1, 1), scales[None].repeat(3, 1, 1)
    idx = torch.tensor([2, 0, 1, 1, 0, 2, 2, 1, 0], dtype=torch.int32)
    for xx in (x, x.to(torch.bfloat16)):
        torch.testing.assert_close(K.w4_matmul(xx, packed, scales, 128),
                                   K.w4_matmul_plain(xx, packed, scales, 128), rtol=0, atol=0)
        torch.testing.assert_close(K.w4_matmul(xx, stacks, stack_scales, 128, idx),
                                   K.w4_matmul_plain(xx, stacks, stack_scales, 128, idx),
                                   rtol=0, atol=0)
    g_args = (torch.randn((7, 2, 3 * 16)), torch.randn((16, 3 * 16)) * 0.2,
              torch.randn((3 * 16,)), torch.zeros((2, 16)))
    for lbr in (True, False):
        for g, w in zip(K.gru_seq(*g_args, lbr), K.gru_seq_plain(*g_args, lbr)):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
    cfg4 = JConfig(n_layers=2, d_model=256, ffn_dim=512, vocab_size=32, n_heads=2,
                   weight_int4=True)
    st4 = from_numpy_tree(_np_tree(jstack(jprepare4(jinit(jax.random.PRNGKey(6), cfg4)))))
    st4 = st4["layers_stacked"]
    for tree in (st4, K.sanm_block.tree_map(lambda a: a[:1], st4)):  # L = 2 and L = 1
        torch.testing.assert_close(
            K.sanm_stack_w4(x, mask, tree, cfg.n_heads, cfg.fsmn_kernel),
            K.sanm_stack_w4_plain(x, mask, tree, cfg.n_heads, cfg.fsmn_kernel), rtol=0, atol=0)
    blk = {name: {"w": torch.randn((i, o)) * 0.1, "b": torch.zeros((o,))}
           for name, i, o in (("q", 64, 64), ("kv", 64, 128), ("out", 64, 64),
                              ("ffn1", 64, 128), ("ffn2", 128, 64))}
    blk.update(norm1={"g": torch.ones(64), "b": torch.zeros(64)},
               norm2={"g": torch.ones(64), "b": torch.zeros(64)})
    est = K.stack_est_blocks([{"self": blk, "cross": blk}])
    e_args = (torch.randn((9, 64)), torch.randn((5, 64)), torch.ones(9), torch.ones(5), est, 2)
    torch.testing.assert_close(K.estimator_blocks(*e_args), K.estimator_blocks_plain(*e_args),
                               rtol=0, atol=0)
    qa, ka = torch.randn((1, 4, 128, 16)), torch.randn((1, 2, 256, 16))
    amask = torch.rand((128, 256)) > 0.2
    torch.testing.assert_close(K.flash_attention(qa, ka, ka * 0.5, amask, False, 0.25),
                               K.flash_attention_plain(qa, ka, ka * 0.5, amask, False, 0.25),
                               rtol=0, atol=0)
    assert K.launch_counts() == {name: 0 for name in K.KERNEL_WRAPPERS}
    assert set(K.KERNEL_WRAPPERS) == {"w8_gemm", "sanm_layer_w8", "sanm_stack_w8",
                                      "dq_gemm", "sanm_stack_dql", "lstm_seq",
                                      "w4_gemm", "sanm_stack_w4", "gru_seq", "est_block",
                                      "flash_attn", "int8_gemm"}


def test_kernel_entry_refuses_a_cpu_tensor():
    """The kernel path never quietly takes the plain version."""
    x = torch.zeros((4, 8))
    with pytest.raises(ValueError, match="CUDA"):
        K.quant_matmul.w8_matmul_kernel(x, torch.zeros((8, 3), dtype=torch.int8),
                                        torch.ones(3))
    w4 = sys.modules[K.w4_matmul.__module__]
    with pytest.raises(ValueError, match="CUDA"):
        w4.w4_matmul_kernel(torch.zeros((4, 32)), torch.zeros((16, 3), dtype=torch.int8),
                            torch.ones((2, 3)), 16)
    with pytest.raises(ValueError, match="CUDA"):  # the expert-indexed entry
        w4.w4_matmul_kernel(torch.zeros((4, 32)), torch.zeros((2, 16, 3), dtype=torch.int8),
                            torch.ones((2, 2, 3)), 16, torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        K.gru.gru_seq_kernel(torch.zeros((3, 1, 12)), torch.zeros((4, 12)), torch.zeros(12),
                             torch.zeros((1, 4)))
    for fmt in ("w8", "w4"):
        with pytest.raises(ValueError, match="CUDA"):
            K.sanm_block._launch_stack(torch.zeros((4, 256)), torch.ones(4), {}, 2, 11, fmt,
                                       128)
    with pytest.raises(ValueError, match="CUDA"):
        K.sanm_block._launch_layer(torch.zeros((4, 256)), torch.ones(4), {}, 2, 11)


def test_kernel_modules_import_without_nvcc_or_triton():
    code = (
        "import sys; sys.modules['triton'] = None; sys.modules['jax'] = None\n"
        "import lele_tpu_torch.kernels as K\n"
        "from lele_tpu_torch.kernels import _build\n"
        "assert not _build._libs\n"
        "assert K.launch_counts() == {n: 0 for n in ('w8_gemm', 'sanm_layer_w8',\n"
        "    'sanm_stack_w8', 'dq_gemm', 'sanm_stack_dql', 'lstm_seq', 'w4_gemm',\n"
        "    'sanm_stack_w4', 'gru_seq', 'est_block', 'flash_attn', 'int8_gemm')}\n"
        "assert all(sys.modules['lele_tpu_torch.kernels.' + m]._fn is None\n"
        "           for m in ('gru', 'lstm', 'w4_matmul', 'est_block', 'flash_attention'))\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120, env={"PATH": "/nonexistent",
                                                      "PYTHONPATH": str(REPO)})
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
