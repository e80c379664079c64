"""int8 GEMMs: counterpart of lele_tpu/kernels/quant_matmul.py.

Weight-only int8 (w8a16): `w8_matmul` replaces `w8_matmul_pallas`
(lele_tpu/kernels/quant_matmul.py:267).
The kernel is csrc/w8_gemm.cu: bf16 x on the warpgroup MMA (`wgmma`, f32
sums; design and bounds in csrc/w8_wgmma.cuh: a producer warp's TMA ring of
K tiles, the int8 tile widened in registers into wgmma's A operand, y^T =
W^T x^T, K split by a cluster where tiles are few), f32 x as true f32 FMA
(csrc/w8_gemm.cuh); the per-output-channel scale is applied in the
epilogue. The bf16 form loads x and the weight by TMA, which needs rows
16-byte aligned: the wrapper passes such operands as they lie, of any row
stride, and copies others into padded rows (`align_rows`: how
prepare_w8_params keeps the CTC head's 25,055 columns, so the main path
copies nothing); it returns an N % 4 != 0 output as the [M, N] view of rows
padded to 16 bytes. The f32 form reads weight rows of any stride too. On
the main path it is the CTC head, [T,
512] x [512, 25055]; on the batch, long-form and MoE paths also every layer
linear (201 launches a batch or long-form request). JAX's default there is
its jnp dequant-dot; the port launches the kernel.

Dynamic-quantized int8 (a8w8, exact ONNX DynamicQuantizeLinear semantics):
`fused_dq_matmul` replaces `fused_dq_matmul_pallas`
(lele_tpu/kernels/quant_matmul.py:142). The kernel is csrc/dq_gemm.cu
(design and bounds in csrc/dq_gemm.cuh): x f32 is quantized once to u8
codes shifted to i8 (a pass over x into a scratch buffer the wrapper
allocates), multiplied on the int8 tensor cores (`mma.sync` m16n8k32, s32
sums, exact) by blocks that each stream one 64-column strip of the weight
once for every row up to 256 (where N and K are both at most 512, by the
tile form `dq_gemm_mma`), and the epilogue subtracts
(zp−128)·colsum and scales by a_scale·w_scale. a_scale and a_zp are device
scalars the kernel reads through pointers, so no linear waits on the host.
Quantization divides by the scale, as ONNX and the JAX package's jnp path
do (`_fused_dq_matmul_jnp`); the Pallas kernel multiplies by the reciprocal,
which lands one step off at rounding boundaries. On the compiled main path
it is the CTC head, [T, 512] x [512, 25055].

`w_scale` is a host float (the compiled graph's constant) or a device
tensor of 1 or N values (a dynamic-int8 linear's per-tensor scale, which
goes to the kernel through a pointer, broadcast to [N], so no linear waits
on the host for it).

Exact int8 product (i8 × i8 → i32): `int8_matmul` replaces
`pallas_int8_matmul` (lele_tpu/kernels/quant_matmul.py:355). The kernel is
csrc/int8_gemm.cu, kernel 5's strip core (csrc/dq_gemm.cuh) with the raw
int32 store for its epilogue and no quantize pass: 64-row blocks by
64-column weight strips, the K tiles by TMA where rows are 16-byte aligned
(cp.async otherwise), a cluster splitting K where the blocks are few, one
launch a call. On the main path it is the product of SenseVoice's
dynamic-int8 linears (`quantized=True`) and of the MatMulInteger emitter,
where JAX runs a plain XLA int8 dot.

Each wrapper calls its registered op (kernels/_library.py:
`lele_tpu_torch::w8_gemm`, `::dq_gemm`, `::int8_gemm`), which takes the
plain version only for a CPU tensor; for a CUDA tensor it launches the
kernel or raises. `w8_matmul.launches`, `fused_dq_matmul.launches` and
`int8_matmul.launches` count launches.
"""

from __future__ import annotations

import torch

from . import _build, _library

_STEM = "w8_gemm"
_AMODE = {torch.float32: 0, torch.bfloat16: 1}
_fn = None
_DQ_STEM = "dq_gemm"
_dq_fn = None
_dq_ws_fn = None
_I8_STEM = "int8_gemm"
_i8_fn = None


def quantize_weight_int8(w: torch.Tensor, axis: int = 0):
    """Per-output-channel symmetric int8 quantisation of a [K, N] weight
    (reduce over `axis`): returns (wq int8, scale f32 [N])."""
    w = w.float()
    amax = w.abs().amax(dim=axis, keepdim=True)
    scale = torch.where(amax == 0, torch.ones_like(amax), amax / 127.0)
    wq = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return wq, scale.reshape(-1)


def align_rows(t: torch.Tensor) -> torch.Tensor:
    """t [R, C] itself where its rows are contiguous, start 16-byte aligned
    and lie a multiple of 16 bytes apart (what kernel 2's TMA loads need);
    else a copy into zero-padded rows of the next multiple of 16 bytes, as
    an [R, C] view with the same values."""
    R, C = t.shape
    e = t.element_size()
    if (t.stride(1) == 1 and t.stride(0) >= C and t.stride(0) * e % 16 == 0
            and t.data_ptr() % 16 == 0):
        return t
    padded = torch.zeros((R, -(-C * e // 16) * 16 // e), dtype=t.dtype, device=t.device)
    padded[:, :C] = t
    return padded[:, :C]


def w8_matmul_plain(x: torch.Tensor, wq: torch.Tensor, w_scale: torch.Tensor) -> torch.Tensor:
    """x [M, K] bf16/f32 @ int8 wq [K, N], × w_scale [N] → f32 [M, N].

    One float32 product: bf16 and int8 values are exact in float32, so this
    is "bf16 operands, f32 accumulate" for bf16 x and full f32 for f32 x
    (needs allow_tf32 off on a card)."""
    return (x.float() @ wq.float()) * w_scale.float().reshape(1, -1)


def _check(x, wq, w_scale):
    if x.dim() != 2 or wq.dim() != 2 or x.shape[1] != wq.shape[0]:
        raise ValueError(f"w8_matmul: shapes {tuple(x.shape)} @ {tuple(wq.shape)}")
    if x.dtype not in _AMODE or wq.dtype != torch.int8 or w_scale.dtype != torch.float32:
        raise TypeError(f"w8_matmul: dtypes {x.dtype}, {wq.dtype}, {w_scale.dtype}")
    if w_scale.numel() != wq.shape[1]:
        raise ValueError("w8_matmul: one scale per output channel")
    for t in (x, wq, w_scale):
        if t.device != x.device:
            raise ValueError("w8_matmul: tensors on different devices")


def w8_matmul_kernel(x: torch.Tensor, wq: torch.Tensor, w_scale: torch.Tensor) -> torch.Tensor:
    """Launch csrc/w8_gemm.cu on x's card and stream."""
    global _fn
    if not x.is_cuda:
        raise ValueError(f"w8_matmul_kernel: x lies on {x.device}, not on a CUDA card")
    _check(x, wq, w_scale)
    if _fn is None:
        P, I = _build.P, _build.I
        _fn = _build.bind(_STEM, "w8_gemm", [P, I, I, P, I, P, P, I, I, I, I, P])
    w_scale = w_scale.contiguous()
    bf16 = x.dtype == torch.bfloat16
    if bf16:  # TMA's rows, of any 16-byte stride
        x, wq = align_rows(x), align_rows(wq)
    else:  # weight rows of any stride
        x = x.contiguous()
        if wq.stride(1) != 1 or wq.stride(0) < wq.shape[1]:
            wq = wq.contiguous()
    M, K = x.shape
    N = wq.shape[1]
    # and writes rows padded to 16 bytes (the [M, N] view is returned), so
    # an N % 4 != 0 output (the CTC head) is stored 16 bytes a lane
    ldy = -(-N // 4) * 4 if bf16 else N
    y = torch.empty((M, ldy), dtype=torch.float32, device=x.device)[:, :N]
    if y.numel() == 0:
        return y
    if K == 0:
        return y.zero_()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = _fn(x.data_ptr(), x.stride(0), _AMODE[x.dtype], wq.data_ptr(), wq.stride(0),
               w_scale.data_ptr(), y.data_ptr(), ldy, M, K, N, stream)
    _build.check(_STEM, "w8_gemm", code)
    w8_matmul.launches += 1
    return y


def w8_matmul(x: torch.Tensor, wq: torch.Tensor, w_scale: torch.Tensor) -> torch.Tensor:
    """x [M, K] bf16/f32, wq int8 [K, N], w_scale f32 [N] → f32 [M, N]."""
    return _W8_OP(x, wq, w_scale)


def _w8_fake(x, wq, w_scale):
    # the launch stores bf16 x's output in rows padded to 16 bytes
    N = wq.shape[1]
    ld = -(-N // 4) * 4 if x.is_cuda and x.dtype == torch.bfloat16 else N
    return x.new_empty((x.shape[0], ld), dtype=torch.float32)[:, :N]


_W8_OP = _library.register("w8_gemm", "(Tensor x, Tensor wq, Tensor w_scale) -> Tensor",
                           w8_matmul_plain, w8_matmul_kernel, _w8_fake)
w8_matmul.launches = 0


# ---------------------------------------------------------------------------
# dynamic-quantized int8 GEMM (kernel: csrc/dq_gemm.cu)


def dql_scale_zp(x: torch.Tensor):
    """ONNX DynamicQuantizeLinear's scale and zero point of x, as f32
    device scalars: min and max clamped to include 0, scale = range / 255,
    zp = round_half_even(clip(-min / scale, 0, 255)) (scale 1 for an
    all-zero x)."""
    x = x.to(torch.float32)
    x_min = torch.clamp(x.min(), max=0.0)
    x_max = torch.clamp(x.max(), min=0.0)
    # a device divisor: on a card torch divides by a host scalar as a
    # multiplication by its reciprocal, which is not the IEEE quotient
    scale = (x_max - x_min) / torch.full_like(x_max, 255.0)
    safe = torch.where(scale == 0, torch.ones_like(scale), scale)
    zp = torch.round(torch.clamp(-x_min / safe, 0.0, 255.0))
    return scale, zp


def dql_quantize(x: torch.Tensor, scale: torch.Tensor, zp: torch.Tensor) -> torch.Tensor:
    """u8 codes of x as f32: clip(round_half_even(x / scale) + zp, 0, 255),
    by division, as ONNX specifies."""
    safe = torch.where(scale == 0, torch.ones_like(scale), scale)
    return torch.clamp(torch.round(x.to(torch.float32) / safe) + zp, 0.0, 255.0)


def dynamic_quantize_u8(x: torch.Tensor):
    """ONNX DynamicQuantizeLinear: (q f32 in [0, 255], scale, zp f32), as
    lele_tpu/kernels/quant_matmul.py:dynamic_quantize_u8."""
    scale, zp = dql_scale_zp(x)
    return dql_quantize(x, scale, zp), scale, zp


def fused_dq_matmul_plain(x: torch.Tensor, wq: torch.Tensor, w_colsum: torch.Tensor,
                          a_scale: torch.Tensor, a_zp: torch.Tensor,
                          w_scale: float | torch.Tensor) -> torch.Tensor:
    """((q(x) − 128) @ wq − (zp − 128)·colsum) · (a_scale·w_scale), f32 [M, N].

    The int32 sum is formed as an exact float64 product (|sum| < 2^53), then
    rounded to f32 once, as the int32 → f32 cast rounds it."""
    ai = dql_quantize(x, a_scale, a_zp).to(torch.float64) - 128.0
    acc = ai @ wq.to(torch.float64)
    acc = acc - (a_zp.to(torch.float64) - 128.0) * w_colsum.reshape(1, -1).to(torch.float64)
    return acc.to(torch.float32) * (a_scale * w_scale)


def _dq_check(x, wq, w_colsum, a_scale, a_zp, w_scale):
    if x.dim() != 2 or wq.dim() != 2 or x.shape[1] != wq.shape[0]:
        raise ValueError(f"fused_dq_matmul: shapes {tuple(x.shape)} @ {tuple(wq.shape)}")
    if (x.dtype != torch.float32 or wq.dtype != torch.int8
            or w_colsum.dtype != torch.int32):
        raise TypeError(f"fused_dq_matmul: dtypes {x.dtype}, {wq.dtype}, {w_colsum.dtype}")
    if w_colsum.numel() != wq.shape[1]:
        raise ValueError("fused_dq_matmul: one column sum per output channel")
    for t in (a_scale, a_zp):
        if t.numel() != 1 or t.dtype != torch.float32:
            raise ValueError("fused_dq_matmul: a_scale and a_zp are f32 scalars")
    for t in (wq, w_colsum, a_scale, a_zp):
        if t.device != x.device:
            raise ValueError("fused_dq_matmul: tensors on different devices")
    if isinstance(w_scale, torch.Tensor):
        if (w_scale.dtype != torch.float32 or w_scale.numel() not in (1, wq.shape[1])
                or w_scale.device != x.device):
            raise ValueError("fused_dq_matmul: a tensor w_scale is f32 on x's device, "
                             "1 or N values")


def fused_dq_matmul_kernel(x, wq, w_colsum, a_scale, a_zp, w_scale: float | torch.Tensor):
    """Launch csrc/dq_gemm.cu on x's card and stream."""
    global _dq_fn, _dq_ws_fn
    if not x.is_cuda:
        raise ValueError(f"fused_dq_matmul_kernel: x lies on {x.device}, not on a CUDA card")
    _dq_check(x, wq, w_colsum, a_scale, a_zp, w_scale)
    P, I, F = _build.P, _build.I, _build.F
    x, wq, w_colsum = x.contiguous(), wq.contiguous(), w_colsum.contiguous()
    a_scale, a_zp = a_scale.contiguous(), a_zp.contiguous()
    M, K = x.shape
    N = wq.shape[1]
    y = torch.empty((M, N), dtype=torch.float32, device=x.device)
    # scratch for the codes of x, rows 16-byte aligned (csrc: dq_codes_stride)
    codes = torch.empty((M, -(-K // 16) * 16), dtype=torch.int8, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if isinstance(w_scale, torch.Tensor):
        if _dq_ws_fn is None:
            _dq_ws_fn = _build.bind(_DQ_STEM, "dq_gemm_ws", [P, P, P, P, P, P, P, P, I, I, I, P])
        ws = w_scale.reshape(-1).expand(N).contiguous()
        code = _dq_ws_fn(x.data_ptr(), wq.data_ptr(), w_colsum.data_ptr(), a_scale.data_ptr(),
                         a_zp.data_ptr(), ws.data_ptr(), y.data_ptr(), codes.data_ptr(),
                         M, K, N, stream)
    else:
        if _dq_fn is None:
            _dq_fn = _build.bind(_DQ_STEM, "dq_gemm", [P, P, P, P, P, F, P, P, I, I, I, P])
        code = _dq_fn(x.data_ptr(), wq.data_ptr(), w_colsum.data_ptr(), a_scale.data_ptr(),
                      a_zp.data_ptr(), float(w_scale), y.data_ptr(), codes.data_ptr(),
                      M, K, N, stream)
    _build.check(_DQ_STEM, "dq_gemm", code)
    fused_dq_matmul.launches += 1
    return y


def fused_dq_matmul(x: torch.Tensor, wq: torch.Tensor, w_colsum: torch.Tensor,
                    a_scale: torch.Tensor, a_zp: torch.Tensor,
                    w_scale: float | torch.Tensor) -> torch.Tensor:
    """x f32 [M, K], wq i8 [K, N] (u8 weights pre-shifted by −128), w_colsum
    i32 [N], a_scale and a_zp f32 device scalars (from `dql_scale_zp`),
    w_scale a float or an f32 tensor of 1 or N values → f32 [M, N]."""
    if isinstance(w_scale, torch.Tensor):
        return _DQ_OP(x, wq, w_colsum, a_scale, a_zp, w_scale, 0.0)
    return _DQ_OP(x, wq, w_colsum, a_scale, a_zp, None, float(w_scale))


# the op takes w_scale as a tensor (w_scale_t) or, where that is None, a float


def _dq_plain(x, wq, w_colsum, a_scale, a_zp, w_scale_t, w_scale_f):
    w_scale = w_scale_f if w_scale_t is None else w_scale_t
    _dq_check(x, wq, w_colsum, a_scale, a_zp, w_scale)
    return fused_dq_matmul_plain(x, wq, w_colsum, a_scale, a_zp, w_scale)


def _dq_launch(x, wq, w_colsum, a_scale, a_zp, w_scale_t, w_scale_f):
    return fused_dq_matmul_kernel(x, wq, w_colsum, a_scale, a_zp,
                                  w_scale_f if w_scale_t is None else w_scale_t)


def _dq_fake(x, wq, *_):
    return x.new_empty((x.shape[0], wq.shape[1]), dtype=torch.float32)


_DQ_OP = _library.register(
    "dq_gemm", "(Tensor x, Tensor wq, Tensor w_colsum, Tensor a_scale, Tensor a_zp, "
    "Tensor? w_scale_t, float w_scale_f) -> Tensor", _dq_plain, _dq_launch, _dq_fake)
fused_dq_matmul.launches = 0


# ---------------------------------------------------------------------------
# exact int8 GEMM (kernel: csrc/int8_gemm.cu)


def int8_matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a i8 [M, K] @ b i8 [K, N] → i32 [M, N]: the exact float64 product
    (every |partial sum| < 2^53, ops/quant_ops.py), rounded to int32. One
    function for both devices: a card has no integer matmul."""
    return torch.round(a.to(torch.float64) @ b.to(torch.float64)).to(torch.int32)


def _i8_check(a, b):
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"int8_matmul: shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError(f"int8_matmul: dtypes {a.dtype}, {b.dtype}")
    if b.device != a.device:
        raise ValueError("int8_matmul: tensors on different devices")


def int8_matmul_kernel(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch csrc/int8_gemm.cu on a's card and stream."""
    global _i8_fn
    if not a.is_cuda:
        raise ValueError(f"int8_matmul_kernel: a lies on {a.device}, not on a CUDA card")
    _i8_check(a, b)
    if _i8_fn is None:
        P, I = _build.P, _build.I
        _i8_fn = _build.bind(_I8_STEM, "int8_gemm", [P, P, P, I, I, I, P])
    a, b = a.contiguous(), b.contiguous()
    M, K = a.shape
    N = b.shape[1]
    c = torch.empty((M, N), dtype=torch.int32, device=a.device)
    if c.numel() == 0:
        return c
    if K == 0:
        return c.zero_()
    stream = torch.cuda.current_stream(a.device).cuda_stream
    code = _i8_fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), M, K, N, stream)
    _build.check(_I8_STEM, "int8_gemm", code)
    int8_matmul.launches += 1
    return c


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a i8 [M, K] @ b i8 [K, N] → i32 [M, N], exact."""
    return _I8_OP(a, b)


def _i8_plain(a, b):
    _i8_check(a, b)
    return int8_matmul_plain(a, b)


_I8_OP = _library.register(
    "int8_gemm", "(Tensor a, Tensor b) -> Tensor", _i8_plain, int8_matmul_kernel,
    lambda a, b: a.new_empty((a.shape[0], b.shape[1]), dtype=torch.int32))
int8_matmul.launches = 0
