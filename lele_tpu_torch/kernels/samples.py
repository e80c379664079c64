"""Arguments for each registered kernel op at a small shape that both its
routes take (the plain version on the CPU, the launch on a card): what
`torch.library.opcheck` runs each op on, in the tests and in chip_smoke.py.

`op_samples(device, seed)` → {op name: the op's positional arguments}, the
raw op arguments (trees as the ops' leaf lists), drawn from a seeded
generator on the CPU and moved to `device`.
"""

from __future__ import annotations

import torch

from .est_block import _LEAVES as _EST_LEAVES
from .quant_matmul import dql_scale_zp
from .sanm_block import _DQL_GROUPS, _DQL_LIN, _flat

# layer widths: head dim 32 (2 heads), D 64, F 128, 5 FSMN taps, 2 layers, 8 rows
_T, _D, _H, _F, _K, _L = 8, 64, 2, 128, 5, 2


def op_samples(device: torch.device | str = "cpu", seed: int = 0) -> dict[str, tuple]:
    g = torch.Generator().manual_seed(seed)

    def f32(*shape, scale=1.0):
        return torch.randn(shape, generator=g) * scale

    def i8(*shape):
        return torch.randint(-127, 128, shape, generator=g, dtype=torch.int8)

    def pos(*shape):
        return torch.rand(shape, generator=g) * 0.02 + 0.005

    def sanm_tree(lead: tuple, fmt: str, group: int = 16):
        def lin(k, n):
            if fmt == "w8":
                return {"wq8": i8(*lead, k, n), "ws8": pos(*lead, n), "b": f32(*lead, n, scale=0.1)}
            return {"wq4": i8(*lead, k // 2, n), "ws4": pos(*lead, k // group, n),
                    "b": f32(*lead, n, scale=0.1)}

        def norm():
            return {"g": 1.0 + f32(*lead, _D, scale=0.1), "b": f32(*lead, _D, scale=0.1)}

        return {"norm1": norm(), "qkv": lin(_D, 3 * _D), "fsmn": {"w": f32(*lead, _K, _D, scale=0.2)},
                "out": lin(_D, _D), "norm2": norm(), "ffn1": lin(_D, _F), "ffn2": lin(_F, _D)}

    x = f32(_T, _D)
    mask = torch.ones(_T)
    mask[-2:] = 0.0
    out = {
        "w8_gemm": (f32(4, _D).to(torch.bfloat16), i8(_D, 50), pos(50)),
        "sanm_layer_w8": (x, mask, _flat(sanm_tree((), "w8"), "w8"), _H, _K),
        "sanm_stack_w8": (x, mask, _flat(sanm_tree((_L,), "w8"), "w8"), _H, _K),
        "sanm_stack_w4": (x, mask, _flat(sanm_tree((_L,), "w4"), "w4"), _H, _K, 16),
        "int8_gemm": (i8(_T, _D), i8(_D, 32)),
        "lstm_seq": (f32(5, 2, 32), f32(8, 32, scale=0.3), f32(2, 8), f32(2, 8)),
        "w4_gemm": (f32(4, _D).to(torch.bfloat16), i8(_D // 2, 48), pos(_D // 16, 48), 16,
                    None),
        "gru_seq": (f32(5, 2, 24), f32(8, 24, scale=0.3), f32(24, scale=0.1), f32(2, 8), True),
        "flash_attn": (f32(1, 2, 128, 32), f32(1, 1, 128, 32), f32(1, 1, 128, 32), None, True,
                       None),
    }
    xd = f32(_T, _D)
    wq = i8(_D, 32)
    a_scale, a_zp = dql_scale_zp(xd)
    out["dq_gemm"] = (xd, wq, wq.to(torch.int32).sum(0, dtype=torch.int32), a_scale.reshape(1), a_zp.reshape(1),
                      pos(1), 0.0)
    dims = {"qkv": (_D, 3 * _D), "out": (_D, _D), "ffn1": (_D, _F), "ffn2": (_F, _D)}
    dql = []
    for key in _DQL_GROUPS:
        k, n = dims[key]
        w = i8(_L, k, n)
        parts = {"wq": w, "colsum": w.to(torch.int32).sum(1, keepdim=True, dtype=torch.int32),
                 "ws": pos(_L, 1, n), "b": f32(_L, 1, n, scale=0.1)}
        dql += [parts[name] for name in _DQL_LIN]
    dql += [1.0 + f32(_L, 1, _D, scale=0.1), f32(_L, 1, _D, scale=0.1)] * 2
    dql.append(f32(_L, _K, _D, scale=0.2))
    bias = torch.zeros(_L, _T)
    bias[:, -2:] = -1e4
    out["sanm_stack_dql"] = (xd, bias, mask.expand(_L, _T).contiguous(), dql, _H, _K, 2, 1e-5,
                             1e-5, None)
    tk, est_d = 6, 64
    est = {"norm1": {"g": 1.0 + f32(2, est_d, scale=0.1), "b": f32(2, est_d, scale=0.1)},
           "q": {"w": f32(2, est_d, est_d, scale=0.1), "b": f32(2, est_d, scale=0.1)},
           "kv": {"w": f32(2, est_d, 2 * est_d, scale=0.1), "b": f32(2, 2 * est_d, scale=0.1)},
           "out": {"w": f32(2, est_d, est_d, scale=0.1), "b": f32(2, est_d, scale=0.1)},
           "norm2": {"g": 1.0 + f32(2, est_d, scale=0.1), "b": f32(2, est_d, scale=0.1)},
           "ffn1": {"w": f32(2, est_d, _F, scale=0.1), "b": f32(2, _F, scale=0.1)},
           "ffn2": {"w": f32(2, _F, est_d, scale=0.1), "b": f32(2, est_d, scale=0.1)}}
    est_leaves = [est[n][leaf].to(torch.bfloat16) if leaf == "w" else est[n][leaf]
                  for n, leaf in _EST_LEAVES]
    out["est_block"] = (f32(_T, est_d), f32(tk, est_d), mask, torch.ones(tk), est_leaves, _H)

    def move(a):
        if isinstance(a, torch.Tensor):
            return a.to(device)
        if isinstance(a, list):
            return [move(t) for t in a]
        return a

    return {name: tuple(move(a) for a in args) for name, args in out.items()}
